"""diag_wait_ms_per_step (runner, program span): host ms per traced step in the
span "diag-read", the step's one diagnostics transfer, which waits for the
card to finish the step: how far the card runs behind the host."""

from benchlib.program_records import ms, per_step, traced


def read(ctx):
    recs = traced(ctx)
    if recs is None:
        return None
    times = [ms(s) for r in recs for s in r["spans"] if s["name"] == "diag-read"]
    if not times:
        return None
    return per_step(recs, sum(times))
