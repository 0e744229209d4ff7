"""The serving engine's config knobs.

A copy of the four `ray_tpu/_private/config.py` entries the paged
engine reads, with the same defaults and the same `RAY_TPU_<NAME>`
environment overrides, so one environment configures both packages.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

_ENV_PREFIX = "RAY_TPU_"

# name -> (type, default)
_ENTRIES: Dict[str, Tuple[type, Any]] = {
    # Paged-KV serving: tokens per KV block.
    "kv_block_size": (int, 16),
    # Usable blocks in the shared pool; 0 = auto
    # (num_slots * ceil(max_len / kv_block_size)).
    "kv_num_blocks": (int, 0),
    # Keep retired requests' full prompt blocks in a radix tree.
    "prefix_cache_enabled": (bool, True),
    # How cached refcount-0 prefix blocks are reclaimed (only 'lru').
    "kv_eviction_policy": (str, "lru"),
}


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class _Config:
    """Attribute access to the knobs: `config.kv_block_size`."""

    def get(self, name: str) -> Any:
        type_, default = _ENTRIES[name]
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is None:
            return default
        return _parse_bool(env) if type_ is bool else type_(env)

    def __getattr__(self, name: str) -> Any:
        if name not in _ENTRIES:
            raise AttributeError(name)
        return self.get(name)


config = _Config()
