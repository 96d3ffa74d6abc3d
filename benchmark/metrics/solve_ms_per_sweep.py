"""solve_ms_per_sweep (streamed solves, program span): host ms in the solver
spans (density-solver, div-solver, hybrid-solvers: the solves with their
sources) over their sweeps (the solves' iteration counts), over the traced
steps: the cost of one sweep of a solve, its launches and its exit read."""

from benchlib.program_records import ms, traced


SOLVERS = ("density-solver", "div-solver", "hybrid-solvers")


def read(ctx):
    recs = traced(ctx)
    if recs is None:
        return None
    total = sum(ms(s) for r in recs for s in r["spans"] if s["name"] in SOLVERS)
    sweeps = sum(r["sweeps"].get(k, 0) for r in recs for k in SOLVERS)
    if not sweeps:
        return None
    return total / sweeps
