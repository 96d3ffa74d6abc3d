"""Build and load the hand-written CUDA kernels (csrc/*.cu) through ctypes.

At first use `load()` compiles csrc/pair_ops.cu with nvcc into a shared
library with a plain C interface, under adaptive_sph_torch/_build/ (listed in
.gitignore), keyed by a hash of the source and the flags, and loads it with
ctypes. Nothing is downloaded and no prebuilt kernel package is used. A build
failure raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "pair_ops.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None  # wall time of the nvcc run in this process (None: cached or not built)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (PATH or "
                       "/usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"asph_pair_ops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the hashed library is missing; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """The loaded kernel library with its C signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.asph_pair_count.argtypes = [vp, vp, i32, i32, i32, vp, f32, vp, vp]
    lib.asph_pair_count.restype = i32
    lib.asph_pair_fill.argtypes = [vp, vp, i32, i32, i32, vp, f32, i32, f32, i32, vp, vp,
                                   vp, vp, i64, vp, vp]
    lib.asph_pair_fill.restype = i32
    lib.asph_pair_matvec.argtypes = [vp, vp, vp, i32, i64, i32, vp, vp, i32, vp, vp, vp]
    lib.asph_pair_matvec.restype = i32
    lib.asph_pair_visc.argtypes = [vp, vp, vp, i32, i64, i32, vp, vp, vp, vp]
    lib.asph_pair_visc.restype = i32
    lib.asph_error_string.argtypes = [i32]
    lib.asph_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(code: int, what: str):
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        msg = load().asph_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
