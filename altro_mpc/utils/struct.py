"""Frozen dataclasses that are JAX pytrees.

The interface is the small subset of ``flax.struct`` this package uses:

- ``@dataclass`` makes a frozen dataclass, registers it as a pytree and
  adds ``.replace(**changes)``;
- ``field(pytree_node=False, ...)`` marks a static field: it is part of the
  tree structure (hashed, compared, baked into compiled programs) and is
  not a leaf;
- any other ``field(...)`` keyword goes to ``dataclasses.field``.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["static"] = not pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass registered with ``jax.tree_util``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if not f.metadata.get("static", False)]
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
