"""pair_matvec_roofline (pair kernels): K2 `pair_matvec` (csrc/pair_ops.cu
pair_matvec_kernel, the streamed solves' products) against its roofline, in
%: the least time of every launch of the traced steps (benchlib/
roofline.py: the list read once, three vectors of C read or written, or the
float32 operations, the larger) over the kernel's device time."""

from benchlib import roofline
from benchlib.trace import kernel_seconds


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    _, secs = kernel_seconds(t["kernels"], "pair_matvec_kernel")
    least = sum(r.get("pair_matvec", 0) * roofline.least_time(
        roofline.pair_matvec_bytes(r["capacity"], r["num_pairs"], ctx.params),
        roofline.pair_matvec_ops(r["num_pairs"]))
        for r in t["steps"] if "num_pairs" in r)
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
