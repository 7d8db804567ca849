"""Frozen dataclasses registered as JAX pytrees.

``PyTreeNode`` subclasses become frozen dataclasses whose fields are pytree
children, except fields declared with :func:`static_field`, which are
static metadata (hashable, part of the jit cache key). ``replace`` returns
an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree's leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


class PyTreeNode:
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        jax.tree_util.register_dataclass(cls)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
