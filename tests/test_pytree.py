"""The local pytree dataclass helper (greb_tpu/_pytree.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from greb_tpu._pytree import pytree_dataclass, static_field


@pytree_dataclass
class _Pair:
    a: jax.Array
    b: jax.Array
    tag: str = static_field(default="x")


def test_replace_returns_modified_copy():
    p = _Pair(a=jnp.zeros(2), b=jnp.ones(2))
    q = p.replace(b=jnp.full(2, 3.0), tag="y")
    assert q.tag == "y" and p.tag == "x"
    np.testing.assert_array_equal(np.asarray(q.b), [3.0, 3.0])
    assert q.a is p.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_flatten_roundtrip_static_field_is_not_a_leaf():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones(()), tag="t")
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2 and not any(isinstance(x, str) for x in leaves)
    back = jax.tree.unflatten(treedef, leaves)
    assert back.tag == "t"
    np.testing.assert_array_equal(np.asarray(back.a), [0.0, 1.0, 2.0])
    # the static field keys the structure: jit retraces when it changes
    f = jax.jit(lambda p: p.a * 2 if p.tag == "t" else p.a)
    np.testing.assert_array_equal(np.asarray(f(p)), [0.0, 2.0, 4.0])
    np.testing.assert_array_equal(np.asarray(f(p.replace(tag="u"))),
                                  [0.0, 1.0, 2.0])
    assert jax.tree.structure(p) != jax.tree.structure(p.replace(tag="u"))


def test_class_replace_is_kept():
    """A class that defines its own replace (PhysicsParams casts to f32)
    keeps it."""
    from greb_tpu.config import PhysicsParams
    p = PhysicsParams.default().replace(kappa=7e5)
    assert p.kappa.dtype == np.float32 and float(p.kappa) == 7e5
