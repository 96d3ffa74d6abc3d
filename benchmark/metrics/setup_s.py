"""setup_s (end to end, host clock): from the process's start to the first
timed step: imports, the kernel library, the simulation built, the warm
episode."""


def read(ctx):
    return ctx.setup_s
