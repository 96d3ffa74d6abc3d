"""tile_step_ms_per_step (tile step, program span): host ms per traced step in
the span "tile-step" (the physics half of the step) less its solver and
level-estimation children: the layout, the boundary terms, K1 and the rest of
the step's fixed launches."""

from benchlib.program_records import ms, per_step, traced


LEFT_OUT = ("density-solver", "div-solver", "hybrid-solvers", "level-estimation")


def read(ctx):
    recs = traced(ctx)
    if recs is None:
        return None
    total, seen = 0.0, False
    for r in recs:
        sp = r["spans"]
        for s in sp:
            if s["name"] == "tile-step":
                seen = True
                total += ms(s)
            elif (s["name"] in LEFT_OUT and s["parent"] is not None
                  and sp[s["parent"]]["name"] == "tile-step"):
                total -= ms(s)
    if not seen:
        return None
    return per_step(recs, total)
