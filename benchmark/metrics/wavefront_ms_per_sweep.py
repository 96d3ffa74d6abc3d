"""wavefront_ms_per_sweep (level estimation, program span): host ms in the
level-estimation spans (detection, the EmptyAngle wavefront, the smoothing)
over the wavefront's sweeps, over the traced steps; nothing where the step
estimates no levels."""

from benchlib.program_records import ms, traced


def read(ctx):
    recs = traced(ctx)
    if recs is None:
        return None
    total = sum(ms(s) for r in recs for s in r["spans"] if s["name"] == "level-estimation")
    sweeps = sum(r["sweeps"].get("level-estimation", 0) for r in recs)
    if not sweeps:
        return None
    return total / sweeps
