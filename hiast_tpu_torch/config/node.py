"""A small, strict, freezable config tree.

Replaces the reference's yacs ``CfgNode`` (reference:
code/utils/default_config.py) with a dependency-free equivalent that keeps
the semantics the reference relies on:

- attribute access (``cfg.train.lr``),
- strict schema: merging a key that does not exist in the defaults is an
  error (catches config typos),
- type coercion on merge (int -> float where the default is float),
- ``freeze()`` making the tree immutable,
- export as plain dicts (``to_dict``; the trainers write it as JSON).
"""
from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping


class ConfigNode:
    __slots__ = ("_fields", "_frozen")

    def __init__(self, fields: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_fields", {})
        object.__setattr__(self, "_frozen", False)
        if fields:
            for k, v in fields.items():
                self._fields[k] = ConfigNode(v) if isinstance(v, Mapping) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self._fields[name]
        except KeyError:
            raise AttributeError(f"config has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        if self._frozen:
            raise AttributeError(f"config is frozen; cannot set {name!r}")
        if isinstance(value, Mapping):
            value = ConfigNode(value)
        self._fields[name] = value

    def __getitem__(self, name: str) -> Any:
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def keys(self):
        return self._fields.keys()

    def items(self):
        return self._fields.items()

    # -- merging -------------------------------------------------------------
    def merge_from_dict(self, other: Mapping[str, Any], _path: str = "") -> None:
        if self._frozen:
            raise AttributeError("config is frozen; cannot merge")
        for key, value in other.items():
            full = f"{_path}{key}"
            if key not in self._fields:
                raise KeyError(f"unknown config key {full!r}")
            current = self._fields[key]
            if isinstance(current, ConfigNode):
                if not isinstance(value, Mapping):
                    raise TypeError(f"{full!r} is a section, got leaf {value!r}")
                current.merge_from_dict(value, _path=full + ".")
            else:
                self._fields[key] = _coerce(current, value, full)

    def merge_from_list(self, opts: list) -> None:
        """Merge from a flat ['a.b.c', value, ...] list (CLI overrides)."""
        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            *parents, leaf = key.split(".")
            for p in parents:
                node = getattr(node, p)
            if leaf not in node._fields:
                raise KeyError(f"unknown config key {key!r}")
            current = node._fields[leaf]
            if isinstance(value, str):
                value = _parse_literal(value)
            node._fields[leaf] = _coerce(current, value, key)

    # -- freezing / export ----------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for v in self._fields.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def clone(self) -> "ConfigNode":
        return ConfigNode(self.to_dict())

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._fields.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"


# Keys whose default is a scalar bool but which ALSO accept a homogeneous
# list of bools. The generic tree stays schema-agnostic: schema.py registers
# its polymorphic keys here (currently only the per-stage fused-attention
# mix, ``runtime.fused_attention: [true, true, true, false]``).
BOOL_OR_BOOL_LIST_KEYS: set = set()


def _coerce(current: Any, value: Any, path: str) -> Any:
    """Coerce ``value`` to be type-compatible with the default ``current``."""
    if current is None or value is None:
        return value
    if path in BOOL_OR_BOOL_LIST_KEYS:
        # accept bool or list-of-bool in EITHER direction (a later overlay
        # may set a plain bool over an earlier per-stage list, or vice versa)
        if isinstance(value, bool):
            return value
        if isinstance(value, (list, tuple)) and all(
            isinstance(v, bool) for v in value
        ):
            return list(value)
        raise TypeError(
            f"{path!r}: expected bool or a list of bools, got {value!r}"
        )
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"{path!r}: expected bool, got {value!r}")
    if isinstance(current, float) and isinstance(value, (int, float)):
        return float(value)
    if isinstance(current, float) and isinstance(value, str):
        # YAML 1.1 parses '3e-6' (no dot) as a string; accept numeric strings.
        try:
            return float(value)
        except ValueError:
            pass
    if isinstance(current, int) and isinstance(value, int):
        return value
    if isinstance(current, str) and isinstance(value, str):
        return value
    if isinstance(current, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if type(current) is type(value):
        return value
    raise TypeError(
        f"{path!r}: cannot replace default {current!r} ({type(current).__name__}) "
        f"with {value!r} ({type(value).__name__})"
    )


def _parse_literal(text: str) -> Any:
    import ast

    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return text
