"""device_ms_per_step (device): the seconds in which an operation ran on the
card, per traced step, in ms."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0 or not t["steps"]:
        return None
    return 1e3 * t["busy_s"] / len(t["steps"])
