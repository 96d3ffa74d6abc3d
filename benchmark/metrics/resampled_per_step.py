"""resampled_per_step (adaptivity, program counter): resampling events per
traced step: the particles that shared mass, plus the merges and splits
(merge_or_split_count where both are on), from the step's diagnostics as the
program's step records keep them; nothing where the step does not resample."""

from benchlib.program_records import per_step, traced


def read(ctx):
    recs = traced(ctx)
    if recs is None or not any(r["resampling"] for r in recs):
        return None
    return per_step(recs, sum(sum(r["resampling"].values()) for r in recs))
