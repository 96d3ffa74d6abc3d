"""updates_per_s (end to end, host clock): the live particles of every step
completed in the measured window, summed, over the window's wall time
(restores included): particle updates per second."""


def read(ctx):
    done = [s for s in ctx.steps if not s["failed"] and "particle_count" in s]
    if not done or ctx.window_s <= 0:
        return None
    return sum(s["particle_count"] for s in done) / ctx.window_s
