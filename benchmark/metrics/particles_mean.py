"""particles_mean (adaptivity): live particles after each step, the mean over
the window's completed steps. A change that raises updates_per_s by carrying
more particles shows here."""


def read(ctx):
    done = [s for s in ctx.steps if not s["failed"] and "particle_count" in s]
    if not done:
        return None
    return sum(s["particle_count"] for s in done) / len(done)
