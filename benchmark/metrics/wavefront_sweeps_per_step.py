"""wavefront_sweeps_per_step (level estimation): the EmptyAngle wavefront's
sweeps per step, the mean over the window's completed steps; nothing where
the step estimates no levels."""


def read(ctx):
    done = [s for s in ctx.steps if not s["failed"] and "wavefront_sweeps" in s]
    if not done:
        return None
    return sum(s["wavefront_sweeps"] for s in done) / len(done)
