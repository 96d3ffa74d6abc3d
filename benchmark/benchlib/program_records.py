"""The program's own step records (adaptive_sph_torch.spans.records) of the
traced steps, for the readers of its spans and counters."""


def traced(ctx):
    """The records of the traced steps: a traced row's step number is its
    episode_step + 1. None without the trace, or where the program has no
    spans (a commit before adaptive_sph_torch.spans)."""
    if ctx.trace is None or not ctx.trace["steps"]:
        return None
    try:
        from adaptive_sph_torch import spans
    except ImportError:
        return None
    want = {r["episode_step"] + 1 for r in ctx.trace["steps"]}
    return [r for r in spans.records if r["step"] in want] or None


def ms(span) -> float:
    """A recorded span's host milliseconds."""
    return (span["t1"] - span["t0"]) * 1e-6


def per_step(recs, total: float) -> float:
    """total over the traced steps the records cover (the two-phase step
    closes two records of one step number)."""
    return total / len({r["step"] for r in recs})
