"""Frozen dataclasses registered as JAX pytrees.

Every field is a traced leaf unless declared with ``static_field``; static
fields belong to the tree's structure (they key the jit cache and must be
hashable).  ``.replace(**changes)`` returns a modified copy.
"""
from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field that is part of the pytree structure, not a leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Decorator: frozen dataclass + pytree registration + ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    if "replace" not in cls.__dict__:
        cls.replace = dataclasses.replace
    return cls
