"""launches_per_step (tile step): device kernels (copies and fills left out)
per traced step."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["steps"] or not ctx.trace["kernel_count"]:
        return None
    return ctx.trace["kernel_count"] / len(ctx.trace["steps"])
