"""Builds the port's CUDA kernels on first use.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library
with a plain C interface, `ray_tpu_torch/_build/lib<name>.<hash>.so`,
loaded with ctypes.  The hash covers the source, the headers in `csrc/`
and the flags, so an edited source rebuilds and an unchanged one loads
the library already built.  `build()` starts one nvcc per source, all at
once, and waits for them.  `on_device` and `raw_stream` give a wrapper
the device and stream to launch on at little host cost.  Nothing here
runs at import: the CPU tests import every module on a machine without
nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the port's CUDA kernels build with it")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: every `csrc/*.cu`) that have
    no up-to-date library, one nvcc process each, in parallel.  Returns
    {name: seconds} for the ones compiled; raises with nvcc's output on
    a failure.  The compiler's resource report (-Xptxas -v) is kept
    beside each library as `.log`."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, target)
    took: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        took[name] = time.time() - t0
        target.with_suffix(".log").write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed (exit {proc.returncode}):"
                          f"\n{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
            continue
        for stale in BUILD_DIR.glob(f"lib{name}.*.so"):
            stale.unlink()
        os.replace(tmp, target)               # atomic: readers never
    if failed:                                # see a partial library
        raise RuntimeError("\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built if needed (once per
    process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def on_device(index: int):
    """A context that makes CUDA device `index` current for a launch; a
    no-op when it already is (no device switch on the common path)."""
    import torch
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def raw_stream(index: int) -> int:
    """PyTorch's current stream on device `index` as a cudaStream_t
    handle, read without building a `torch.cuda.Stream` object (several
    microseconds of host time a call)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)
