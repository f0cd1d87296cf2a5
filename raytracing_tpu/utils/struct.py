"""Frozen pytree dataclasses: ``@struct.dataclass`` and ``struct.field``.

Fields are pytree leaves unless declared ``struct.field(pytree_node=False)``,
which makes them static metadata (part of the tree structure, so a jitted
function retraces when they change).  Built on
``jax.tree_util.register_dataclass``.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", {}), pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = lambda self, **updates: dataclasses.replace(self, **updates)
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
