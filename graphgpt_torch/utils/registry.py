"""Decorator registry: a copy of `graphgpt_tpu/utils/registry.py`."""

from __future__ import annotations

from typing import Callable, Dict


class Register:
    def __init__(self):
        self._map: Dict[str, Callable] = {}

    def __call__(self, *names: str):
        def deco(fn):
            for name in names:
                self._map[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._map:
            raise KeyError(f"{name!r} not registered; have {sorted(self._map)}")
        return self._map[name]

    def build(self, name: str, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def keys(self):
        return self._map.keys()
