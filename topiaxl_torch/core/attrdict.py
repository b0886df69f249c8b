"""Attribute-style nested dict used as the config container.

Plays the role of the reference's OmegaConf DictConfig + dva/attr_dict.py,
but is a plain-Python, dependency-free container.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping


class AttrDict(dict):
    """A dict whose items are also attributes. Nested dicts are wrapped lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, key: str) -> Any:
        value = dict.__getitem__(self, key)
        if isinstance(value, dict) and not isinstance(value, AttrDict):
            value = AttrDict(value)
            dict.__setitem__(self, key, value)
        return value

    def get(self, key: str, default: Any = None) -> Any:
        if key in self:
            return self[key]
        return default

    @classmethod
    def from_nested(cls, data: Mapping[str, Any]) -> "AttrDict":
        out = cls()
        for k, v in data.items():
            if isinstance(v, Mapping):
                out[k] = cls.from_nested(v)
            elif isinstance(v, list):
                out[k] = [cls.from_nested(x) if isinstance(x, Mapping) else x for x in v]
            else:
                out[k] = v
        return out

    def to_dict(self) -> dict:
        out = {}
        for k in self:
            v = self[k]
            if isinstance(v, AttrDict):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, AttrDict) else x for x in v]
            else:
                out[k] = v
        return out

    def select(self, dotted: str, default: Any = None) -> Any:
        """Look up a dotted path like ``model.generator.depth``."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part] if not isinstance(node, AttrDict) else node[part]
            else:
                return default
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: AttrDict = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = AttrDict()
                node[part] = nxt
            node = node[part]
        node[parts[-1]] = value

    def iter_leaves(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        for k in self:
            v = self[k]
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, AttrDict):
                yield from v.iter_leaves(path)
            else:
                yield path, v
