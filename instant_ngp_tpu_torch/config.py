"""Network-config JSON loading with `parent` inheritance and // comments.

Counterpart of instant_ngp_tpu/config.py: a child config deep-merges on
top of its parent (parent paths are relative to the child's directory),
and configs may carry // and /* */ comments.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Optional

CONFIG_SEARCH_PATHS = [
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                 "configs"),
]


def strip_json_comments(text: str) -> str:
    """Remove // line comments and /* */ block comments outside strings."""
    out = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
        elif c == '"':
            in_str = True
            out.append(c)
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def loads_json(text: str) -> Any:
    return json.loads(strip_json_comments(text))


def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return loads_json(f.read())


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]
               ) -> Dict[str, Any]:
    """Recursively merge `override` on top of `base` (override wins)."""
    result = copy.deepcopy(base)
    for k, v in override.items():
        if k in result and isinstance(result[k], dict) \
                and isinstance(v, dict):
            result[k] = deep_merge(result[k], v)
        else:
            result[k] = copy.deepcopy(v)
    return result


def load_network_config(path: str, _seen=None) -> Dict[str, Any]:
    """Load a network config, resolving `parent` chains (the `parent` key
    is removed from the result). Cyclic chains raise ValueError."""
    abspath = os.path.abspath(path)
    seen = _seen or set()
    if abspath in seen:
        raise ValueError(f"cyclic `parent` chain involving {abspath}")
    seen = seen | {abspath}
    cfg = load_json(path)
    if not isinstance(cfg, dict):
        raise ValueError(f"network config must be a JSON object: {path}")
    parent = cfg.pop("parent", None)
    if parent is not None:
        parent_cfg = load_network_config(
            os.path.join(os.path.dirname(abspath), parent), seen)
        cfg = deep_merge(parent_cfg, cfg)
    return cfg


def find_network_config(name: str, mode: Optional[str] = None) -> str:
    """Locate a config by name: the literal path, then <root>/<name> and
    <root>/<mode>/<name>, each with and without a .json suffix."""
    candidates = []
    names = [name] if name.endswith(".json") else [name + ".json", name]
    for nm in names:
        candidates.append(nm)
        for root in CONFIG_SEARCH_PATHS:
            candidates.append(os.path.join(root, nm))
            if mode:
                candidates.append(os.path.join(root, mode, nm))
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"network config {name!r} not found (mode={mode}, "
        f"tried {len(candidates)} paths)")
