"""A string-keyed registry whose values are given directly or as
``"module:attr"`` paths loaded at first use (port of
``imitation_tpu/util/registry.py``)."""

from __future__ import annotations

import importlib
from typing import Dict, Generic, Iterable, Optional, TypeVar

T = TypeVar("T")


def load_attr(name: str):
    """The attribute ``attr`` of module ``module`` named by ``"module:attr"``."""
    module_name, attr_name = name.split(":")
    return getattr(importlib.import_module(module_name), attr_name)


class Registry(Generic[T]):
    """String-keyed registry with optional lazy loading."""

    def __init__(self):
        self._values: Dict[str, T] = {}
        self._indirect: Dict[str, str] = {}

    def get(self, key: str) -> T:
        if key not in self._values and key not in self._indirect:
            raise KeyError(f"Key '{key}' is not registered.")
        if key not in self._values:
            self._values[key] = load_attr(self._indirect[key])
        return self._values[key]

    def keys(self) -> Iterable[str]:
        return set(self._values.keys()) | set(self._indirect.keys())

    def register(self, key: str, *, value: Optional[T] = None, indirect: Optional[str] = None) -> None:
        if key in self._values or key in self._indirect:
            raise KeyError(f"Duplicate registration for '{key}'")
        if (value is None) == (indirect is None):
            raise ValueError("Must provide exactly one of `value` and `indirect`.")
        if value is not None:
            self._values[key] = value
        else:
            self._indirect[key] = indirect
