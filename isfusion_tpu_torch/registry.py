"""Registry + config-driven builders.

Preserves the mmdet3d-style public surface (string ``type`` keys in python
dict configs) used throughout the reference (`mmdet3d/models/builder.py:18-102`)
while staying framework-agnostic: registered objects may be ``torch.nn.Module``
classes, plain classes, or functions. A copy of the JAX package's registry,
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class map with decorator-based registration."""

    def __init__(self, name: str, parent: Optional["Registry"] = None):
        self._name = name
        self._module_dict: Dict[str, Any] = {}
        self._parent = parent

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Any:
        if key in self._module_dict:
            return self._module_dict[key]
        if self._parent is not None:
            return self._parent.get(key)
        return None

    def register_module(self, name: Optional[str] = None, module: Any = None,
                        force: bool = False) -> Callable:
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool) -> None:
        names = [name] if isinstance(name, str) else (name or [module.__name__])
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} already registered in {self._name}")
            self._module_dict[n] = module

    def build(self, cfg: dict, **default_args) -> Any:
        return build_from_cfg(cfg, self, default_args or None)


def _stringify_keys(obj: Any) -> Any:
    """Recursively turn non-str dict keys into str.

    The reference's ``region_drop_info`` uses int keys (config `:20-23`);
    stringifying keeps config dicts uniform for the modules built here.
    """
    if isinstance(obj, dict):
        return {str(k) if not isinstance(k, str) else k: _stringify_keys(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_stringify_keys(v) for v in obj)
    return obj


def build_from_cfg(cfg: dict, registry: Registry,
                   default_args: Optional[dict] = None) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg-without-type, **default_args)``."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = _stringify_keys(dict(cfg))
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {registry.name}; "
                           f"known: {sorted(registry.module_dict)}")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    return obj_cls(**args)


# The registries of the model types the port builds.
MODELS = Registry("models")
BACKBONES = Registry("backbones", parent=MODELS)
NECKS = Registry("necks", parent=MODELS)
HEADS = Registry("heads", parent=MODELS)
DETECTORS = Registry("detectors", parent=MODELS)
VOXEL_ENCODERS = Registry("voxel_encoders", parent=MODELS)
MIDDLE_ENCODERS = Registry("middle_encoders", parent=MODELS)
FUSION_LAYERS = Registry("fusion_layers", parent=MODELS)
BBOX_CODERS = Registry("bbox_coders")
# The data side: datasets, their pipeline transforms and the GT-paste
# samplers.
DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
OBJECT_SAMPLERS = Registry("object_samplers")
