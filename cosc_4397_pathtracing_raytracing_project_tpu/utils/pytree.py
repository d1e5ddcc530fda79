"""Frozen dataclass pytrees.

``class Foo(PyTreeNode)`` turns ``Foo`` into a frozen dataclass registered
with ``jax.tree_util.register_dataclass``: every field is a pytree child
(traced under ``jit``) unless declared with ``field(static=True)``, which
makes it part of the tree structure (hashed into the jit cache key, never
traced) — the place for shapes, counts and resolutions.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """``dataclasses.field`` with a ``static`` marker (see module docstring)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["static"] = static
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Base class: subclasses become frozen, jax-registered dataclasses."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields if not f.metadata.get("static")],
            meta_fields=[f.name for f in fields if f.metadata.get("static")],
        )

    def replace(self, **changes):
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **changes)
