"""host_syncs_per_step (runner): host calls that wait for the card (stream,
device and event synchronisations, those under blocking device-to-host
copies included) per traced step."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["steps"]:
        return None
    return ctx.trace["syncs"] / len(ctx.trace["steps"])
