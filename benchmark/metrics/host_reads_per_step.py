"""host_reads_per_step (runner, program counter): the program's blocking
device-to-host reads per traced step, summed over their sites
(adaptive_sph_torch.spans.reads, counted at the line that reads: the
diagnostics, each solve's and each wavefront sweep's exit test, K1's pair
count and the rest). Beside host_syncs_per_step, which counts the same waits
in the device trace, it names where they are made."""

from benchlib.program_records import per_step, traced


def read(ctx):
    recs = traced(ctx)
    if recs is None:
        return None
    return per_step(recs, sum(sum(r["reads"].values()) for r in recs))
