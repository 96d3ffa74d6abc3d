"""solver_iters_per_step (streamed solves): density plus divergence Jacobi
iterations per step, the mean over the window's completed steps."""


def read(ctx):
    done = [s for s in ctx.steps if not s["failed"] and "particle_count" in s]
    if not done:
        return None
    return sum(s.get("density_iterations", 0) + s.get("div_iterations", 0)
               for s in done) / len(done)
