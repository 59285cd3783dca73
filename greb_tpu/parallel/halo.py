"""Halo exchange over a latitude-sharded device mesh.

The stencils reach ±2 rows in latitude (advection meridional upwind,
src/greb.f90:771-779) and ±3 columns in longitude.  The domain
decomposition shards LATITUDE only: all zonal stencils — including the
sequential polar sub-cycles — are then shard-local, and one width-2
``lax.ppermute`` halo exchange per circulation substep covers every
meridional dependency.  (Sharding longitude would force a halo exchange
inside each polar sub-iteration; lat-sharding is the layout that keeps the
inter-device traffic at one neighbour shift per substep.)

``ppermute`` leaves non-received halos as zeros, which is exactly the
reference's one-sided pole boundary treatment (dropped neighbour terms).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def halo_exchange_lat(x: jax.Array, width: int, axis_name: str,
                      axis_size: int) -> jax.Array:
    """(..., R, X) -> (..., R+2w, X) with neighbour rows over ``axis_name``.

    Shard i receives its top halo (rows preceding its first row) from shard
    i-1 and its bottom halo from shard i+1; the outermost shards receive
    zeros (physical pole boundary).
    """
    if axis_size == 1:
        pad = [(0, 0)] * (x.ndim - 2) + [(width, width), (0, 0)]
        return jnp.pad(x, pad)
    up_perm = [(i, i + 1) for i in range(axis_size - 1)]     # send northward
    down_perm = [(i + 1, i) for i in range(axis_size - 1)]   # send southward
    top_halo = lax.ppermute(x[..., -width:, :], axis_name, up_perm)
    bot_halo = lax.ppermute(x[..., :width, :], axis_name, down_perm)
    return jnp.concatenate([top_halo, x, bot_halo], axis=-2)


def halo_exchange_lat_cyclic(x: jax.Array, width: int, axis_name: str,
                             axis_size: int) -> jax.Array:
    """``halo_exchange_lat`` written as a full cyclic permutation whose
    wrapped-around halos are zeroed: the form ``vmap`` can batch (it becomes
    indexing along the mapped axis), so the sharded program can run on one
    device as a reference for the exchange."""
    n = axis_size
    i = lax.axis_index(axis_name)
    top = lax.ppermute(x[..., -width:, :], axis_name,
                       [(j, (j + 1) % n) for j in range(n)])
    bot = lax.ppermute(x[..., :width, :], axis_name,
                       [((j + 1) % n, j) for j in range(n)])
    top = jnp.where(i > 0, top, jnp.zeros_like(top))
    bot = jnp.where(i < n - 1, bot, jnp.zeros_like(bot))
    return jnp.concatenate([top, x, bot], axis=-2)


def make_sharded_extend(axis_name: str, axis_size: int):
    """An ``Extend`` callable (see ops.stencils) backed by ppermute."""
    return functools.partial(halo_exchange_lat, axis_name=axis_name,
                             axis_size=axis_size)
