"""Python-dict config system with ``_base_`` inheritance (a copy of the JAX
package's loader, so the port imports nothing of that package).

Mirrors the mmcv ``Config.fromfile`` surface used by the reference
(`configs/isfusion/isfusion_0075voxel.py` is a plain python module of dicts;
other configs use ``_base_`` lists). Implemented fresh: configs are executed
as python modules, merged recursively, and exposed with attribute access.
"""
from __future__ import annotations

import copy
import importlib.util
import os
import sys
from typing import Any, Dict, List, Optional, Union

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


class ConfigDict(dict):
    """A dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            wrapped = [ConfigDict._wrap(v) for v in value]
            return type(value)(wrapped) if isinstance(value, tuple) else wrapped
        return value


def _exec_pyfile(path: str) -> Dict[str, Any]:
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"_cfg_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
        return {k: v for k, v in vars(mod).items() if not k.startswith("__")}
    finally:
        sys.modules.pop(spec.name, None)


def _merge_into(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``new`` into ``base`` (new wins; _delete_ resets).
    A dict of integer keys ('4') merges into the items of a list."""
    out = dict(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), list) and v and \
                all(str(i).isdigit() for i in v):
            items = list(out[k])
            for i, sub in v.items():
                cur = items[int(i)]
                items[int(i)] = _merge_into(cur, sub) if isinstance(
                    sub, dict) and isinstance(cur, dict) else sub
            out[k] = items
        elif (isinstance(v, dict) and k in out and isinstance(out[k], dict)
                and not v.pop(DELETE_KEY, False)):
            out[k] = _merge_into(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = v
    return out


class Config:
    """Resolved config with attribute + item access, mmcv-compatible surface."""

    def __init__(self, cfg_dict: Optional[dict] = None,
                 filename: Optional[str] = None):
        cfg_dict = cfg_dict or {}
        object.__setattr__(self, "_cfg_dict", ConfigDict._wrap(cfg_dict))
        object.__setattr__(self, "_filename", filename)

    @staticmethod
    def fromfile(filename: str) -> "Config":
        cfg_dict = Config._load_with_bases(filename)
        return Config(cfg_dict, filename=filename)

    @staticmethod
    def _load_with_bases(filename: str) -> Dict[str, Any]:
        cfg = _exec_pyfile(filename)
        bases: Union[str, List[str]] = cfg.pop(BASE_KEY, [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        cfg_dir = os.path.dirname(os.path.abspath(filename))
        for b in bases:
            merged = _merge_into(merged, Config._load_with_bases(
                os.path.join(cfg_dir, b)))
        return _merge_into(merged, cfg)

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    @property
    def text(self) -> str:
        return repr(self._cfg_dict)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._cfg_dict[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._cfg_dict[key] = ConfigDict._wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._cfg_dict

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self._cfg_dict)), self._filename)

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """CLI override: ``{'model.head.num_classes': 3}`` style dotted keys
        (the reference's ``--cfg-options`` DictAction, `tools/train.py:59-69`);
        an integer part indexes a list
        (``data.train.dataset.pipeline.4.db_sampler.info_path``)."""
        nested: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = nested
            parts = full_key.split(".")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        merged = _merge_into(dict(self._cfg_dict), nested)
        object.__setattr__(self, "_cfg_dict", ConfigDict._wrap(merged))

    def dump(self, path: str) -> None:
        import pprint
        with open(path, "w") as f:
            f.write(pprint.pformat(dict(self._cfg_dict), width=100))

    def __repr__(self) -> str:
        return f"Config(file={self._filename}): {self._cfg_dict!r}"
