"""Hierarchical configuration node (a copy of ``fami_pose_tpu/config/node.py``).

A from-scratch replacement for the yacs ``CfgNode`` surface
the reference framework exposes (see reference ``posetimation/config/my_custom.py:15-30``
for the ``_BASE_`` inheritance contract and ``posetimation/config/config.py:14-53``
for merge semantics). Supports:

  * attribute-style access (``cfg.MODEL.NUM_JOINTS``)
  * YAML loading with ``_BASE_`` file inheritance (relative to the child file)
  * ``merge_from_file`` / ``merge_from_list`` (dotted-path CLI overrides)
  * ``freeze`` / ``defrost`` / ``clone`` / ``dump``
  * ``new_allowed`` sub-trees (e.g. ``MODEL.EXTRA``) that accept unknown keys
"""

from __future__ import annotations

import copy
import io
import os
from typing import Any

import yaml

_VALID_SCALARS = (int, float, bool, str, type(None))
BASE_KEY = "_BASE_"


class CfgNode(dict):
    """A dict with attribute access, immutability, and YAML merge support."""

    __IMMUTABLE = "__cfg_immutable__"
    __NEW_ALLOWED = "__cfg_new_allowed__"

    def __init__(self, init_dict: dict | None = None, new_allowed: bool = False):
        super().__init__()
        self.__dict__[CfgNode.__IMMUTABLE] = False
        self.__dict__[CfgNode.__NEW_ALLOWED] = new_allowed
        if init_dict:
            for k, v in init_dict.items():
                self[k] = _cfg_from_value(v, new_allowed=new_allowed)

    # -- attribute interface -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        # yacs semantics: direct sets on an unfrozen node may add new keys
        # (defaults construction relies on this); unknown-key rejection is
        # the *merge* path's job (_merge_into checks NEW_ALLOWED there).
        if self.__dict__[CfgNode.__IMMUTABLE]:
            raise AttributeError(f"CfgNode is frozen; cannot set key {name!r}")
        super().__setitem__(name, value)

    # -- mutability -----------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.__IMMUTABLE]

    def is_new_allowed(self) -> bool:
        return self.__dict__[CfgNode.__NEW_ALLOWED]

    def _set_immutable(self, flag: bool) -> None:
        self.__dict__[CfgNode.__IMMUTABLE] = flag
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        node = CfgNode(new_allowed=self.__dict__[CfgNode.__NEW_ALLOWED])
        for k, v in self.items():
            node[k] = copy.deepcopy(v, memo)
        node.__dict__[CfgNode.__IMMUTABLE] = False
        return node

    # -- merging ---------------------------------------------------------------
    def merge_from_file(self, cfg_filename: str) -> None:
        """Merge a YAML file, honouring recursive ``_BASE_`` inheritance."""
        loaded = _load_yaml_with_base(cfg_filename)
        self.merge_from_other_cfg(CfgNode._from_plain(loaded))

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_list(self, opts: list) -> None:
        """Merge dotted-path overrides: ``["TRAIN.LR", 0.001, ...]``."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for full_key, value in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node = self
            for sub in keys[:-1]:
                if sub not in node:
                    raise KeyError(f"Unknown config key: {full_key}")
                node = node[sub]
            leaf = keys[-1]
            if leaf not in node and not node.is_new_allowed():
                raise KeyError(f"Unknown config key: {full_key}")
            old = node.get(leaf, None)
            node[leaf] = _coerce_value(value, old, full_key)

    # -- serialization -----------------------------------------------------------
    def dump(self) -> str:
        return yaml.safe_dump(self._to_plain(), sort_keys=True)

    def _to_plain(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v._to_plain() if isinstance(v, CfgNode) else v
        return out

    @staticmethod
    def _from_plain(d: dict) -> "CfgNode":
        node = CfgNode(new_allowed=True)
        for k, v in d.items():
            node[k] = CfgNode._from_plain(v) if isinstance(v, dict) else v
        return node

    def __str__(self) -> str:
        def _indent(text: str, n: int) -> str:
            pad = " " * n
            return "\n".join(pad + line if line else line for line in text.split("\n"))

        lines = []
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.append(_indent(str(v), 2))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"CfgNode({super().__repr__()})"


def _cfg_from_value(v: Any, new_allowed: bool = False) -> Any:
    if isinstance(v, CfgNode):
        return v
    if isinstance(v, dict):
        return CfgNode(v, new_allowed=new_allowed)
    return v


def _load_yaml_with_base(filename: str) -> dict:
    with io.open(filename, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}
    if BASE_KEY in cfg:
        base_rel = cfg.pop(BASE_KEY)
        base_path = base_rel
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(filename), base_rel)
        base = _load_yaml_with_base(base_path)
        _merge_plain(cfg, base)
        return base
    return cfg


def _merge_plain(src: dict, dst: dict) -> None:
    """Merge plain dict ``src`` into ``dst`` in place (src wins)."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_plain(v, dst[k])
        else:
            dst[k] = v


def _merge_into(src: "CfgNode", dst: "CfgNode", key_path: list) -> None:
    if dst.is_frozen():
        raise AttributeError("Cannot merge into a frozen CfgNode")
    for k, v in src.items():
        full = ".".join(key_path + [k])
        if isinstance(v, CfgNode) and isinstance(dst.get(k), CfgNode):
            _merge_into(v, dst[k], key_path + [k])
        elif k in dst:
            dst[k] = _coerce_value(
                v._to_plain() if isinstance(v, CfgNode) else v, dst[k], full
            )
        elif dst.is_new_allowed():
            dst[k] = v
        else:
            raise KeyError(f"Unknown config key: {full}")


def _coerce_value(new: Any, old: Any, full_key: str) -> Any:
    """Type-check a replacement value against the default, with the standard
    yacs-style leniencies (str parsing for CLI opts, list<->tuple, int->float)."""
    if old is None or new is None:
        return new
    if isinstance(new, str) and not isinstance(old, str):
        parsed = _parse_literal(new)
        if parsed is not new:
            new = parsed
    if isinstance(old, tuple) and isinstance(new, list):
        new = tuple(new)
    elif isinstance(old, list) and isinstance(new, tuple):
        new = list(new)
    if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
        new = float(new)
    if isinstance(old, _VALID_SCALARS) and not isinstance(old, type(new)):
        # bool is a subclass of int; treat them as distinct
        if not (isinstance(old, bool) == isinstance(new, bool) and isinstance(new, type(old))):
            raise ValueError(
                f"Type mismatch for {full_key}: cannot replace "
                f"{type(old).__name__} with {type(new).__name__} ({new!r})"
            )
    return new


def _parse_literal(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s
