"""Resource-leak ledger: the subset the serving engine calls.

A copy of the hooks of `ray_tpu/devtools/leaksan.py` that
`serve/llm.py` uses — `register` / `discharge` for KV blocks and
`track_thread` / `discharge_thread` for the engine loops — gated on the
same `RAY_TPU_LEAKSAN=1` environment flag, read at import.  Anything
registered and not yet discharged is live; `live_counts()` reports it.
The JAX package's report files, anomaly records, metrics and CLI are
not ported.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

ENV_FLAG = "RAY_TPU_LEAKSAN"

# Hot-path gate: hooks bail when the sanitizer is off.
_ENABLED = os.environ.get(ENV_FLAG, "").strip().lower() in (
    "1", "true", "yes", "on")

_state_lock = threading.Lock()
_live: Dict[tuple, str] = {}            # (kind, key) -> detail


def enable_for_testing() -> None:
    global _ENABLED
    _ENABLED = True


def disable_for_testing() -> None:
    global _ENABLED
    _ENABLED = False


def register(kind: str, key: Any, detail: str = "") -> None:
    """A resource of `kind` identified by hashable `key` came alive."""
    if not _ENABLED:
        return
    with _state_lock:
        _live[(kind, key)] = detail


def discharge(kind: str, key: Any) -> None:
    """The resource was released."""
    if not _ENABLED:
        return
    with _state_lock:
        _live.pop((kind, key), None)


def track_thread(t: threading.Thread, detail: str = "") -> None:
    """Register a long-lived service thread the owner promises to join."""
    register("thread", t.ident or id(t), detail=detail or t.name)


def discharge_thread(t: threading.Thread) -> None:
    discharge("thread", t.ident or id(t))


def live_counts() -> Dict[str, int]:
    with _state_lock:
        out: Dict[str, int] = {}
        for kind, _ in _live:
            out[kind] = out.get(kind, 0) + 1
        return out


def reset() -> None:
    with _state_lock:
        _live.clear()
