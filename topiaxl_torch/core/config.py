"""YAML config loading with ``${...}`` interpolation, dotlist overrides, and a
factory registry.

Mirrors the behaviour of the reference stack (OmegaConf YAML load + CLI merge,
``inference.py:382-387``, and reflection-based object construction,
``dva/io.py:23-29``) so reference configs such as
``configs/inference_dit.yml`` parse unmodified — but object construction goes
through an explicit registry instead of arbitrary ``class_name`` reflection.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict

import yaml

from .attrdict import AttrDict

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def _interp_value(value: Any, root: AttrDict) -> Any:
    if isinstance(value, str):
        m = _INTERP_RE.fullmatch(value.strip())
        if m:  # whole-string interpolation keeps the referee's type
            ref = root.select(m.group(1))
            if ref is None:
                raise KeyError(f"config interpolation '{value}' not found")
            return _interp_value(ref, root)
        # partial interpolation -> string substitution
        def sub(match: re.Match) -> str:
            ref = root.select(match.group(1))
            if ref is None:
                raise KeyError(f"config interpolation '{match.group(0)}' not found")
            return str(_interp_value(ref, root))

        return _INTERP_RE.sub(sub, value)
    return value


def resolve(cfg: AttrDict, root: AttrDict | None = None) -> AttrDict:
    """Recursively resolve ``${a.b.c}`` interpolations against the root config."""
    root = cfg if root is None else root
    out = AttrDict()
    for k in cfg:
        v = cfg[k]
        if isinstance(v, AttrDict):
            out[k] = resolve(v, root)
        elif isinstance(v, list):
            out[k] = [
                resolve(x, root) if isinstance(x, AttrDict) else _interp_value(x, root)
                for x in v
            ]
        else:
            out[k] = _interp_value(v, root)
    return out


def _parse_scalar(text: str) -> Any:
    return yaml.safe_load(text)


def load_config(path: str, overrides: list[str] | None = None) -> AttrDict:
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    cfg = AttrDict.from_nested(raw or {})
    if overrides:
        cfg = merge_dotlist(cfg, overrides)
    return resolve(cfg)


def merge_dotlist(cfg: AttrDict, dotlist: list[str]) -> AttrDict:
    """Merge ``a.b.c=value`` CLI overrides on top of a config."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not of the form key=value")
        key, _, val = item.partition("=")
        cfg.set_dotted(key.strip(), _parse_scalar(val))
    return cfg


# ---------------------------------------------------------------------------
# Factory registry (replaces dva/io.py:23-29 reflection)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(*names: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Register a factory under one or more names.

    Names include the reference's dotted class paths (e.g.
    ``models.dit_crossattn.DiT``) so reference YAMLs work verbatim, plus our
    own short names (e.g. ``dit``).
    """

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        for n in names:
            _REGISTRY[n] = fn
        return fn

    return deco


def registry_names() -> list[str]:
    return sorted(_REGISTRY)


def build(cfg: AttrDict, **extra: Any) -> Any:
    """Instantiate the object named by ``cfg.class_name`` with remaining keys
    as kwargs (the reference's load_from_config contract, dva/io.py:23-29)."""
    if "class_name" not in cfg:
        raise ValueError("config node has no class_name")
    name = cfg["class_name"]
    if name not in _REGISTRY:
        raise KeyError(f"'{name}' is not registered; known: {registry_names()}")
    kwargs = {k: cfg[k] for k in cfg if k != "class_name"}
    kwargs.update(extra)
    return _REGISTRY[name](**kwargs)
