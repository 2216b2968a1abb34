"""Component registries, jax-free: the port's copy of
:mod:`ucod_dpl_tpu.utils.registry`.  Dataset classes register by name and a
config's ``type`` key resolves through :data:`DATASETS`."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._map: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        def deco(obj):
            key = name or obj.__name__
            if key in self._map and self._map[key] is not obj:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._map[key] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(f"{name!r} not found in registry {self.name}; available: {sorted(self._map)}")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def keys(self):
        return self._map.keys()


DATASETS = Registry("datasets")
