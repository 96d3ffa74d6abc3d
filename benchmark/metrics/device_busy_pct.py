"""device_busy_pct (device): the seconds in which an operation ran on the
card, over the traced steps' wall time, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * t["busy_s"] / t["window_s"]
