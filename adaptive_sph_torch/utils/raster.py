"""ctypes wrapper of the port's host rasterizer (csrc/rasterizer.cpp).

Counterpart of adaptive_sph_tpu/utils/raster.py. The library is built by g++
at first use into adaptive_sph_torch/_build/ (listed in .gitignore), keyed by
a hash of the source and the flags, as ops/_native.py builds the CUDA
library. A failed build raises with g++'s stderr: there is no second
rasterizer. The image is an (H, W, 3) float32 canvas in [0, 1], origin at the
top left; world (x, y) maps to pixel (W/2 + x scale, H/2 - y scale).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rasterizer.cpp"
BUILD_DIR = _PKG / "_build"
# the JAX package's native/Makefile flags, so both builds compute the same pixels
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"rasterizer_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if its hashed file is missing; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the rasterizer did not build ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.draw_circles.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, ctypes.c_long, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float]
        lib.draw_circles.restype = None
        lib.draw_lines.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_long, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float]
        lib.draw_lines.restype = None
        _lib = lib
    return _lib


def _check_canvas(img):
    if img.dtype != np.float32 or img.ndim != 3 or img.shape[2] != 3 or \
            not img.flags["C_CONTIGUOUS"]:
        raise ValueError(f"canvas must be a C-contiguous (H, W, 3) float32 array, got "
                         f"{img.dtype} {img.shape}")


def new_canvas(width: int, height: int, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    img = np.empty((height, width, 3), np.float32)
    img[:] = color
    return img


def draw_circles(img, pos, radius, rgb, scale, border_frac=0.1, border=(0.0, 0.0, 0.0)):
    """Filled circles with a border stroke of border_frac * r, in the given
    order (later circles paint over earlier ones)."""
    _check_canvas(img)
    pos = np.ascontiguousarray(pos, np.float32).reshape(-1, 2)
    radius = np.ascontiguousarray(radius, np.float32).reshape(-1)
    rgb = np.ascontiguousarray(rgb, np.float32).reshape(-1, 3)
    if not len(pos) == len(radius) == len(rgb):
        raise ValueError(f"draw_circles: {len(pos)} positions, {len(radius)} radii, "
                         f"{len(rgb)} colours")
    H, W, _ = img.shape
    load().draw_circles(img, W, H, pos, radius, rgb, len(pos), float(scale),
                        float(border_frac), *border)
    return img


def draw_lines(img, segs, scale, width_world, color=(0.0, 0.0, 0.0)):
    """Line segments (n, 4) [x0, y0, x1, y1] in world units, width_world wide."""
    _check_canvas(img)
    segs = np.ascontiguousarray(segs, np.float32).reshape(-1, 4)
    H, W, _ = img.shape
    load().draw_lines(img, W, H, segs, len(segs), float(scale), float(width_world), *color)
    return img


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
