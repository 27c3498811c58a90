"""Build a native source into a shared library under build/euler_tpu_torch/,
and launch the kernels of the CUDA ones.

The library's file name carries a hash of the source, the compile command
and each file the source names in a quoted ``#include "..."`` found
beside it (one level deep: the includes of those files are not followed),
so a changed source or header builds anew and an unchanged one is reused.

Each build writes a private temporary file and ``os.replace``s it into
place, so processes that race on a first build (pytest-xdist workers)
never load a half-written library.

Every kernel wrapper of ``ops`` dispatches and launches the same way
(``kernel_device``, ``launch``): a CPU tensor goes to its plain version,
a CUDA tensor to its kernel, on the device's current stream, and any
other device raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

import torch

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "euler_tpu_torch")
#: nvcc flags of every CUDA source of the port: Hopper's sm_90a, a plain
#: C interface (no PyTorch headers), position-independent
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_QUOTED_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_digest(src: str, cmd: Sequence[str]) -> str:
    """16 hex digits over the source, the command and the quoted includes
    found beside the source; a source without such includes hashes as its
    text and the command alone."""
    with open(src, "rb") as f:
        text = f.read()
    h = hashlib.sha256(text + "\0".join(cmd).encode())
    here = os.path.dirname(os.path.abspath(src))
    for name in _QUOTED_INCLUDE.findall(text):
        path = os.path.join(here, name.decode())
        if os.path.isfile(path):
            with open(path, "rb") as f:
                h.update(b"\0" + name + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_shared_library(src: str, stem: str, cmd: Sequence[str],
                         timeout: float = 600.0) -> str:
    """Compile ``src`` with ``cmd + [src, "-o", out]``; return the path.

    Raises ``subprocess.CalledProcessError`` (with the compiler's output
    in ``stderr``) or ``OSError`` when the build fails.
    """
    out = os.path.join(BUILD_DIR, f"lib{stem}-{source_digest(src, cmd)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(list(cmd) + [src, "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=timeout)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on the PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_cuda_library(name: str) -> str:
    """Build ``csrc/<name>.cu`` of the package with nvcc; return the path."""
    src = os.path.join(PACKAGE_DIR, "csrc", f"{name}.cu")
    return build_shared_library(src, name, [nvcc()] + NVCC_FLAGS)


_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load_cuda_library(name: str, functions: Dict[str, List]) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built (first call, or after the source changed)
    and loaded with ctypes, each C function named in ``functions`` given
    those argument types and an int result; later calls return the same
    handle. Raises if nvcc fails."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_cuda_library(name))
            for fn, argtypes in functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def kernel_device(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); raises on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")
    return x.device.type == "cuda"


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Calls the library's ``fn`` with ``args`` and the device's current
    stream; raises if the launch failed (a non-zero return code)."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
