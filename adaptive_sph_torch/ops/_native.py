"""Build and load the hand-written CUDA kernels (csrc/*.cu) through ctypes.

Every source under csrc/ goes into one shared library with a plain C
interface, under adaptive_sph_torch/_build/ (listed in .gitignore), keyed by a
hash of the sources, the shared headers and the flags. At first use `build()`
starts one nvcc per source, all at once, to compile the objects, then links
them into the library; `load()` loads it with ctypes and declares its C
signatures. Nothing is downloaded and no prebuilt kernel package is used. A
build failure raises with nvcc's stderr. ptxas's resource report of every
kernel (registers, spills) is kept beside the library; `resources()` parses
it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "pair_ops.cu", _PKG / "csrc" / "pair_sweep.cu",
           _PKG / "csrc" / "pair_jacobi.cu", _PKG / "csrc" / "pair_probe.cu")
HEADERS = (_PKG / "csrc" / "tile_walk.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_seconds = None  # wall time of this process's nvcc runs (None: cached or not built)


class SweepParams(ctypes.Structure):
    """By-value scalars of a pair sweep (struct SweepParams in csrc/pair_sweep.cu)."""

    _fields_ = [("inv_rest", ctypes.c_float), ("cone_thr", ctypes.c_float),
                ("max_dist", ctypes.c_float), ("mass_base", ctypes.c_float),
                ("merge", ctypes.c_int), ("allow_optimal", ctypes.c_int),
                ("allow_size_difference", ctypes.c_int), ("allow_too_small", ctypes.c_int),
                ("visc", ctypes.c_float), ("max_range", ctypes.c_float),
                ("inv_pi", ctypes.c_float)]


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"asph_kernels_{h.hexdigest()[:16]}.so"


def report_path() -> Path:
    """ptxas's resource report of the library's kernels (written by build())."""
    return library_path().with_suffix(".ptxas.txt")


def _run(procs):
    """Wait for every (cmd, Popen); raise with the stderr of those that
    failed, else return their stderr joined."""
    failed, errs = [], []
    for cmd, proc in procs:
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(errs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def build() -> Path:
    """Compile the library if its hashed file is missing: one nvcc per source
    in parallel, then one link; returns its path. A file lock in the build
    directory lets one process build while the others wait for its library."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                _compile(path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def _compile(path: Path):
    global build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}.tmp"
    objs = [path.with_name(f"{path.stem}_{src.stem}.{tag}.o") for src in SOURCES]
    report = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)])
                   for src, o in zip(SOURCES, objs)])
    report_path().write_text(report)
    tmp = path.with_suffix(f".{tag}")
    _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])])
    for o in objs:
        o.unlink()
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0


def resources() -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from ptxas's report of the built library."""
    out, name = {}, None
    for line in report_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def _declare(lib):
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.asph_pair_pieces.argtypes = []
    lib.asph_pair_split_min.argtypes = []
    lib.asph_pair_count.argtypes = [vp, vp, i32, i32, i32, vp, i32, f32, vp, vp, vp]
    lib.asph_pair_fill.argtypes = [vp, vp, i32, i32, i32, vp, i32, i32, f32, f32, i32, vp, vp,
                                   vp, vp, vp, i64, vp, vp]
    lib.asph_pair_matvec.argtypes = [vp, vp, vp, i32, i64, i32, vp, vp, i32, vp, vp, i32, i32,
                                     vp]
    lib.asph_pair_matvec_scalar.argtypes = [vp, vp, vp, i32, i32, vp, i32, vp, vp, i32, vp, vp,
                                            i32, i32, vp]
    lib.asph_pair_matvec_probe.argtypes = [vp, vp, vp, i32, i64, i32, vp, vp, i32, i32, vp, vp,
                                           i32, i32, vp]
    lib.asph_pair_matvec_scalar_probe.argtypes = [vp, vp, vp, i32, i32, vp, i32, vp, vp, i32,
                                                  i32, vp, vp, i32, i32, vp]
    lib.asph_block_sweep.argtypes = [vp, vp, i32, i32, vp, vp, vp, vp, f32, vp, vp]
    lib.asph_window_sum_setup.argtypes = []
    lib.asph_window_sum.argtypes = [vp, vp, i32, i32, vp, vp]
    lib.asph_pair_stream_setup.argtypes = [i32, vp]
    lib.asph_pair_stream.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp]
    lib.asph_pair_visc.argtypes = [vp, vp, vp, i32, i64, i32, vp, vp, vp, i32, i32, vp]
    lib.asph_pair_visc_scalar.argtypes = [vp, vp, vp, i32, i32, vp, i32, vp, vp, vp, i32, i32,
                                          vp]
    lib.asph_stream_shape.argtypes = [vp]
    lib.asph_stream_shape.restype = None
    lib.asph_pair_sweep.argtypes = [i32, vp, vp, i32, i32, i32, vp, vp, i32, f32,
                                    SweepParams, vp, i32, vp]
    solve = [vp, vp, vp, i32, i64, i32, vp, vp, vp, i32, i64, vp, vp, f32, i32, i32]
    lib.asph_pair_jacobi.argtypes = solve + [i32, i32, i32, vp]
    lib.asph_pair_hybrid.argtypes = solve + [i32, vp]
    lib.asph_solve_shape.argtypes = [vp]
    lib.asph_solve_shape.restype = None
    lib.asph_solve_device.argtypes = [vp, vp]
    for fn in ("asph_pair_pieces", "asph_pair_split_min", "asph_pair_count", "asph_pair_fill",
               "asph_pair_matvec", "asph_pair_matvec_scalar",
               "asph_pair_visc", "asph_pair_visc_scalar", "asph_pair_sweep", "asph_pair_jacobi",
               "asph_pair_hybrid", "asph_solve_device", "asph_pair_matvec_probe",
               "asph_pair_matvec_scalar_probe",
               "asph_block_sweep", "asph_window_sum_setup", "asph_window_sum",
               "asph_pair_stream_setup",
               "asph_pair_stream"):
        getattr(lib, fn).restype = i32
    lib.asph_error_string.argtypes = [i32]
    lib.asph_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library, built if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def check(code: int, what: str):
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        msg = load().asph_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
