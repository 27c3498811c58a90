"""File IO over local paths.

Counterpart of euler_tpu/utils/io.py (reference: euler/common/file_io.h:34
with posix local_file_io.cc): the same functions for local paths. A
``scheme://`` path raises, as the reference does where fsspec is not
installed; the port never routes through fsspec.
"""
from __future__ import annotations

import glob as _glob
import os
import re
from typing import IO, List

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path: str) -> bool:
    return bool(_SCHEME_RE.match(str(path)))


def _local(path: str) -> str:
    if is_remote(path):
        raise ImportError(
            f"remote path {path!r}: the port reads and writes local paths "
            f"only; copy the files to local disk")
    return path


def open_file(path: str, mode: str = "rb") -> IO:
    """Open a local file; parents are created for writes."""
    _local(path)
    if any(m in mode for m in "wax"):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
    return open(path, mode)


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def listdir(path: str) -> List[str]:
    return os.listdir(_local(path))


def glob(pattern: str) -> List[str]:
    return sorted(_glob.glob(_local(pattern)))


def makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def join(base: str, *parts: str) -> str:
    if is_remote(base):
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(base, *parts)
