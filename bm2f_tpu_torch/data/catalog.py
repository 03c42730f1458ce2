"""Dataset and metadata registries — the framework's replacement for
detectron2's DatasetCatalog/MetadataCatalog (used throughout the reference's
data/datasets/register_*.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}
        self._cache: Dict[str, List[dict]] = {}
        self.allow_overwrite = False  # set by force re-registration

    def register(self, name: str, fn: Callable[[], List[dict]]):
        if name in self._registry and not self.allow_overwrite:
            raise KeyError(f"dataset {name!r} already registered")
        self._registry[name] = fn
        self._cache.pop(name, None)

    def get(self, name: str) -> List[dict]:
        # loaders parse large jsons AND populate MetadataCatalog as a side
        # effect — cache so eval paths that need both the dicts and the
        # metadata do the work once
        if name not in self._cache:
            self._cache[name] = self._registry[name]()
        return self._cache[name]

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name)
        self._cache.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class _Metadata:
    """Attribute bag; write-once like detectron2's Metadata."""

    def __init__(self, name: str):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_d", {})

    def __getattr__(self, k):
        d = object.__getattribute__(self, "_d")
        if k in d:
            return d[k]
        raise AttributeError(f"metadata {self.name!r} has no attribute {k!r}")

    def __setattr__(self, k, v):
        self._d[k] = v

    def set(self, **kwargs):
        self._d.update(kwargs)
        return self

    def get(self, k, default=None):
        return self._d.get(k, default)

    def as_dict(self):
        return dict(self._d)


class _MetadataCatalog:
    def __init__(self):
        self._metas: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._metas:
            self._metas[name] = _Metadata(name)
        return self._metas[name]

    def list(self):
        return sorted(self._metas)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
