"""Frozen dataclasses that are JAX pytrees.

`@dataclass` turns a class into a frozen dataclass registered with
`jax.tree_util.register_dataclass`: fields are pytree children unless
declared with `field(pytree_node=False)`, which makes them static metadata
(part of the treedef, hashed by `jit`).  Instances get `.replace(**kw)`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T")


def field(pytree_node: bool = True, **kwargs: Any) -> Any:
    """`dataclasses.field`; `pytree_node=False` marks a static field."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls: type[T]) -> type[T]:
    """Frozen dataclass + pytree registration + `.replace`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **updates: dataclasses.replace(self, **updates)
    return cls
