"""pair_build_roofline (pair kernels): K1 `pair_build` (csrc/pair_ops.cu
pair_build_kernel, its count and fill passes) against its roofline, in %:
the least time of every call of the traced steps (benchlib/roofline.py:
bytes read once and written once from C, num_pairs and the weight dtype, or
the float32 operations, the larger) over the kernel's device time."""

from benchlib import roofline
from benchlib.trace import kernel_seconds


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    _, secs = kernel_seconds(t["kernels"], "pair_build_kernel")
    least = sum(r.get("pair_build", 0) * roofline.least_time(
        roofline.pair_build_bytes(r["capacity"], r["num_pairs"], ctx.params),
        roofline.pair_build_ops(r["num_pairs"]))
        for r in t["steps"] if "num_pairs" in r)
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
