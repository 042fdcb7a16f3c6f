"""Config/flag registry: the port's copy of ``coherence_tpu.utils.flags``
(one place for the reference's scattered booleans, overridable from the
environment as ``COHERENCE_<NAME>``), trimmed to the flags the port reads."""

from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define(name: str, default, doc: str = ""):
    env = os.environ.get(f"COHERENCE_{name.upper()}")
    if env is not None:
        if isinstance(default, bool):
            val = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            val = int(env)
        elif isinstance(default, float):
            val = float(env)
        else:
            val = env
    else:
        val = default
    _REGISTRY[name] = val
    return val


def get(name: str):
    return _REGISTRY[name]


def set_flag(name: str, value):
    _REGISTRY[name] = value


def all_flags() -> Dict[str, Any]:
    return dict(_REGISTRY)


debug_spritecheck = define(
    "debug_spritecheck", False, "verify raster invariants on every major op"
)
cachemaxsize = define("cachemaxsize", 100 * 1024 * 1024, "coherence cache bytes")
batch_group_raster = define(
    "batch_group_raster",
    True,
    "rasterize a group's members together per bucket group, then fold them in one call "
    "(fastframe.group_sprite_batched), instead of the per-member render_scene fold",
)
