"""step_ms_p95.host (runner, host clock): the 95th percentile of the wall
time of every step in the measured window, in ms. Each step ends in the
program's one diagnostics read, which waits for the card. The host paces the
step in every cell, and the tail moves with the solves' sweep counts along
the episode, so it is a per-layer reading and not an end-to-end metric."""

import numpy as np


def read(ctx):
    if not ctx.steps:
        return None
    return float(np.percentile([s["wall_s"] for s in ctx.steps], 95)) * 1e3
