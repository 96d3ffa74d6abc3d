"""adaptivity_ms_per_step (adaptivity, program span): host ms per traced step
in the span "adaptivity" (share, then merge or split, with their partner
matching on the tile layout); nothing where the step does not resample."""

from benchlib.program_records import ms, per_step, traced


def read(ctx):
    recs = traced(ctx)
    if recs is None:
        return None
    times = [ms(s) for r in recs for s in r["spans"] if s["name"] == "adaptivity"]
    if not times:
        return None
    return per_step(recs, sum(times))
