"""The yardstick's peaks and the operations and bytes of the pair kernels,
computed from shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
limit): HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.
A kernel's least time is the larger of its bytes over the bandwidth and its
operations over the float32 rate; each input byte is counted read once and
each output byte written once, whatever the kernel reads again.

The pair list's shapes: C rows (the capacity), P pairs inside the radius
(the step's `num_pairs`).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float32 operations per pair inside the radius: K1's mega walk (r^2, the
# pair smoothing length, the kernel gradient, the weights, the viscosity
# factor and the prep sums), K2's two products per pair and row component,
# K3's viscosity product
PAIR_BUILD_OPS = 40
PAIR_MATVEC_OPS = 4
PAIR_VISC_OPS = 6


def least_time(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def classic_mode(params: dict) -> bool:
    """K1's classic branch (the resident solver or Winchenbach2020); else the
    mega branch."""
    return bool(params.get("resident_solver")) or \
        params.get("operator_discretization") == "Winchenbach2020"


def weight_bytes(params: dict) -> int:
    return 2 if params.get("weight_cache_bf16") else 4


def pair_build_bytes(C: int, P: int, params: dict) -> int:
    """K1 `pair_build`: reads the sorted table (C x 6 float32 [x, y, h, m,
    vx, vy]; classic: 7 with rho), writes the row pointers, the columns,
    the two weight rows, the two viscosity rows (mega branch with a
    viscosity) and the float32 prep rows (4; classic 8)."""
    classic = classic_mode(params)
    wb = weight_bytes(params)
    visc = (not classic) and float(params.get("viscosity", 0.0)) != 0.0
    table = C * (7 if classic else 6) * 4
    out = (C + 1) * 4 + P * 4 + 2 * P * wb + (2 * P * wb if visc else 0)
    out += (8 if classic else 4) * C * 4
    return table + out


def pair_build_ops(P: int) -> int:
    return PAIR_BUILD_OPS * P


def pair_matvec_bytes(C: int, P: int, params: dict) -> int:
    """K2 `pair_matvec`, one launch: reads the row pointers, the columns and
    the two weight rows, and three float32 vectors of C in all (accel: one
    in, two out; div: two in, one out)."""
    return (C + 1) * 4 + P * 4 + 2 * P * weight_bytes(params) + 3 * C * 4


def pair_matvec_ops(P: int) -> int:
    return PAIR_MATVEC_OPS * P


def pair_visc_ops(P: int) -> int:
    return PAIR_VISC_OPS * P
