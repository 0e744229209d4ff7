"""Filesystem layer for Dataset IO: URI-scheme-dispatched filesystems.

Reference: python/ray/data/read_api.py + data/datasource/ resolve paths
through fsspec/pyarrow filesystems so `s3://` / `gs://` / `memory://`
URIs work everywhere a local path does.  Here the same role is played
by a thin resolver over fsspec (in the image) with a local fallback, so
the read/write paths in dataset.py never touch `open()`/`glob` directly
and cloud filesystems plug in by installing their fsspec driver (s3fs,
gcsfs) — no ray_tpu_torch change needed.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Any, List, Tuple


def _has_scheme(path: str) -> bool:
    # windows drive letters aside (not a target platform), anything
    # with "<scheme>://" is a URL for fsspec.
    return "://" in path


def resolve(path: str) -> Tuple[Any, str]:
    """(filesystem, path-without-protocol) for a path or URI."""
    if _has_scheme(path):
        import fsspec
        return fsspec.core.url_to_fs(path)
    return _LocalFs(), path


def expand(paths, exts: Tuple[str, ...]) -> List[str]:
    """Expand files/dirs/globs (local or URI) into a sorted file list.
    URI results keep their protocol so downstream open() re-resolves."""
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        fs, rel = resolve(p)
        proto = p.split("://", 1)[0] + "://" if _has_scheme(p) else ""

        def keep(f: str) -> str:
            return proto + f if proto and "://" not in f else f

        if fs.isdir(rel):
            if exts is None:
                # Untyped listing (read_binary_files): one detailed ls
                # filters directories without a per-file stat RPC.
                infos = fs.ls(rel.rstrip("/"), detail=True)
                out.extend(sorted(
                    keep(i["name"]) for i in infos
                    if i.get("type") != "directory"))
            else:
                for ext in exts:
                    pat = rel.rstrip("/") + f"/*{ext}"
                    out.extend(sorted(keep(f) for f in fs.glob(pat)))
        elif any(ch in rel for ch in "*?["):
            out.extend(sorted(keep(f) for f in fs.glob(rel)))
        else:
            if not fs.exists(rel):
                raise FileNotFoundError(p)
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths}")
    return out


def open_file(path: str, mode: str = "rb"):
    fs, rel = resolve(path)
    if "w" in mode:
        parent = rel.rsplit("/", 1)[0] if "/" in rel else ""
        if parent:
            try:
                fs.makedirs(parent, exist_ok=True)
            except Exception:
                pass
    return fs.open(rel, mode)


class _LocalFs:
    """Minimal local filesystem with the fsspec methods the resolver
    uses — keeps plain paths working even without fsspec."""

    def isdir(self, p: str) -> bool:
        return os.path.isdir(p)

    def exists(self, p: str) -> bool:
        return os.path.exists(p)

    def glob(self, pat: str) -> List[str]:
        return globlib.glob(pat)

    def ls(self, p: str, detail: bool = False):
        names = [os.path.join(p, e) for e in os.listdir(p)]
        if not detail:
            return names
        return [{"name": n,
                 "type": "directory" if os.path.isdir(n) else "file"}
                for n in names]

    def makedirs(self, p: str, exist_ok: bool = True) -> None:
        os.makedirs(p, exist_ok=exist_ok)

    def open(self, p: str, mode: str = "rb"):
        return open(p, mode)
