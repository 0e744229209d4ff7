"""Resilient GPU probing for hardware captures.

The port's copy of `ray_tpu/util/hwprobe.py`.  The probe runs in a
*subprocess*: a card that fails to initialise (driver fault, a card
held by another process, a hung context creation) cannot poison or hang
the caller, which only touches CUDA once a probe succeeded.  The probe
imports torch and reports ``platform`` "gpu", ``device_kind``
(``torch.cuda.get_device_name(0)``) and ``n_devices``; a host without a
usable CUDA device fails the probe.

The probe is skipped only when the caller asks for the CPU
(``wait_for_backend(device="cpu")``), never because no GPU was found.

Mirrors the reference's release-log discipline
(reference ``release/release_logs/<version>/``): every successful
hardware capture is also recorded, under the port's own
``release_logs/last_good_torch/`` (gitignored), so a failed capture can
emit the last-good number with provenance instead of dying with a
traceback.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

_PROBE_SRC = (
    "import json, sys, torch\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit('no CUDA device: torch.cuda.is_available() is False')\n"
    "print(json.dumps({'platform': 'gpu',"
    " 'device_kind': torch.cuda.get_device_name(0),"
    " 'n_devices': torch.cuda.device_count()}))\n"
)

LAST_GOOD_DIR = os.path.join("release_logs", "last_good_torch")


def probe(timeout_s: float = 90.0) -> Dict[str, Any]:
    """One subprocess probe of the CUDA device.

    Returns ``{"ok": True, "platform": "gpu", "device_kind": ...,
    "n_devices": ...}`` or ``{"ok": False, "error": <last line of
    stderr / 'timeout'>}``.  The parent process never touches CUDA, so
    a failed or hung initialisation cannot take it down.
    """
    try:
        out = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"probe timeout after {timeout_s:.0f}s"}
    if out.returncode == 0 and out.stdout.strip():
        try:
            info = json.loads(out.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            return {"ok": False, "error": f"unparseable probe: {out.stdout[-200:]}"}
        return {"ok": True, **info}
    err_lines = [l for l in out.stderr.strip().splitlines() if l.strip()]
    return {"ok": False, "error": err_lines[-1] if err_lines else f"rc={out.returncode}"}


def wait_for_backend(attempts: Optional[int] = None,
                     probe_timeout_s: Optional[float] = None,
                     delays: Optional[list] = None,
                     device: Optional[str] = None) -> Dict[str, Any]:
    """Bounded retry with backoff around the device probe.

    Defaults: 5 attempts, worst case ~13 minutes (5 x 90 s probe
    timeouts + 20/45/90/180 s sleeps between them).  Env overrides
    ``HW_PROBE_ATTEMPTS`` / ``HW_PROBE_TIMEOUT_S`` let the caller
    tighten or extend the window.  Returns the last probe result, plus
    ``attempts``/``elapsed_s`` and the per-attempt error log on failure.
    ``device="cpu"`` (the caller asks for the CPU, as the tests do)
    skips the probe.
    """
    if device is not None and str(device).strip().lower() == "cpu":
        return {"ok": True, "platform": "cpu", "device_kind": "cpu",
                "n_devices": None, "attempts": 0, "elapsed_s": 0.0,
                "skipped_probe": True}
    if attempts is None:
        attempts = int(os.environ.get("HW_PROBE_ATTEMPTS", "5"))
    if probe_timeout_s is None:
        probe_timeout_s = float(os.environ.get("HW_PROBE_TIMEOUT_S", "90"))
    delays = delays if delays is not None else [20, 45, 90, 180]
    t0 = time.time()
    log = []
    for i in range(attempts):
        r = probe(probe_timeout_s)
        if r["ok"]:
            r["attempts"] = i + 1
            r["elapsed_s"] = round(time.time() - t0, 1)
            return r
        log.append(r["error"])
        if i < attempts - 1:
            time.sleep(delays[min(i, len(delays) - 1)])
    return {"ok": False, "attempts": attempts,
            "elapsed_s": round(time.time() - t0, 1),
            "error": (f"backend unavailable after {attempts} attempts over "
                      f"{(time.time() - t0) / 60:.1f} min"),
            "attempt_errors": log}


def lg_name(prefix: str, model: str, default_model: str) -> str:
    """Canonical last-good record name for a bench config (one helper
    for every bench script, so the naming scheme can never drift
    between them and orphan a last-good history)."""
    if model == default_model:
        return prefix
    return f"{prefix}_{model.replace('-', '')}"


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def record_last_good(name: str, payload: Dict[str, Any]) -> None:
    """Persist a successful hardware capture under LAST_GOOD_DIR."""
    d = os.path.join(repo_root(), LAST_GOOD_DIR)
    os.makedirs(d, exist_ok=True)
    rec = dict(payload)
    rec["_captured_unix"] = int(time.time())
    with open(os.path.join(d, f"{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def load_last_good(name: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(repo_root(), LAST_GOOD_DIR, f"{name}.json")
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (ValueError, OSError):
        return None


def stale_record(name: str, failure: Dict[str, Any],
                 provenance_hint: str) -> Dict[str, Any]:
    """Build the structured failure line bench emits when the backend
    never comes up: the last-good number, marked stale, plus the
    failure diagnostics — never a bare traceback."""
    last = load_last_good(name)
    out: Dict[str, Any] = {
        "stale": True,
        "backend_error": failure.get("error"),
        "probe_attempts": failure.get("attempts"),
        "probe_elapsed_s": failure.get("elapsed_s"),
    }
    if last is not None:
        out.update({k: v for k, v in last.items() if not k.startswith("_")})
        out["stale"] = True
        out["provenance"] = (
            f"last-good hardware capture ({LAST_GOOD_DIR}/{name}.json,"
            f" unix {last.get('_captured_unix')}); {provenance_hint}")
    else:
        out.update({"metric": name, "value": None, "unit": "unavailable",
                    "vs_baseline": None,
                    "provenance": f"no last-good record; {provenance_hint}"})
    return out


def ensure_backend(lg_name: str, hint: str,
                   device: Optional[str] = None) -> Dict[str, Any]:
    """Shared bench entry: wait for the backend or emit-stale-and-exit.

    On success returns the probe info.  On failure prints the bench
    script's one JSON result line (the last-good number marked stale,
    with the probe diagnostics) and exits 0 — the capture is never a
    bare traceback.
    """
    pr = wait_for_backend(device=device)
    if not pr["ok"]:
        print(json.dumps(stale_record(lg_name, pr, hint)))
        sys.exit(0)
    return pr
