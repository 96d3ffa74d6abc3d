"""Per-stage profiling (`profile_stages`): the reference's section names into `.stat`.

Counterpart of adaptive_sph_tpu/utils/profiling.py. The reference times the
sections of simulation.rs (simulation-step, neighborhood, level-estimation,
div-solver, density-solver, adaptivity); the JAX package, whose step is one
fused program without an in-step timer, estimates them from knockout
variants and scan differentials. The port runs its step eagerly, and its
step records the spans of adaptive_sph_torch/spans.py where the work
happens: `profile_sections(sim)` runs `iters` steps of `sim.step_fn` as
built, from the simulation's current state (results discarded, the state
stays), under `spans.enable()`, and records the per-step means of the
sections into `sim.counters`, so that `write_statistics` prints them:

  simulation-step(profiled)  the whole step (adaptivity included); on a
                             CUDA device it ends in one synchronise, so it
                             holds the step's device tail
  neighborhood               the sorted layout: build_tiles, sort_fields,
                             window_meta (tile_step.step_geometry)
  adaptivity                 share / merge / split (when any is on)
  level-estimation           level estimation and smoothing (when active)
  div-solver                 the divergence solve with its source
                             (HybridDFSPH, OnlyDivergence)
  density-solver             the density solve with its source (all but
                             OnlyDivergence)

The section times are the host's: a span ends when the host has issued its
work, and the card may still run it after (nothing synchronises inside the
step but its own reads). The resident HybridDFSPH launch runs both solves
and the step between them at once; its span (hybrid-solvers) is split
between div-solver and density-solver in proportion to their iteration
counts, as the reference's estimate charges each solve its iterations.
Sections are attributed, not nested: simulation-step(profiled) also holds
what none of them covers.

On the list backend only simulation-step(profiled) is recorded, as the
reference records only it on a backend other than the tiles.
"""

from __future__ import annotations

import time

from .. import spans
from ..utils.params import PressureSolverMethod

ITERS = 16


def section_names(params, backend: str = "tiles") -> list:
    """The sections profile_sections records for `params` on `backend`,
    under the reference's conditions."""
    if backend != "tiles":
        return ["simulation-step(profiled)"]
    names = ["simulation-step(profiled)", "neighborhood"]
    if params.splitting or params.merging or params.sharing:
        names.append("adaptivity")
    if params.level_estimation_active():
        names.append("level-estimation")
    method = params.pressure_solver_method
    if method in (PressureSolverMethod.HybridDFSPH, PressureSolverMethod.OnlyDivergence):
        names.append("div-solver")
    if method != PressureSolverMethod.OnlyDivergence:
        names.append("density-solver")
    return names


def profile_sections(sim, iters: int = ITERS) -> dict:
    """Time the reference's sections over `iters` steps from sim's current
    state (after one untimed step) and record their per-step means into
    sim.counters. Returns {section name: mean seconds per step}."""
    import torch

    sync = torch.cuda.synchronize if sim.device.type == "cuda" else (lambda: None)
    step = sim.step_fn
    k = sim.step_number + 1
    step(sim.state, k)
    sync()
    names = section_names(sim.params, sim.backend)
    totals = dict.fromkeys(names, 0.0)
    with spans.enable():
        for _ in range(iters):
            spans.open_step(k)
            t0 = time.perf_counter()
            try:
                _, diag = step(sim.state, k)
                sync()
                total = time.perf_counter() - t0
            finally:
                rec = spans.close_step()
            spans.records.pop()  # a discarded step: no record of the simulation's
            sec = {"simulation-step(profiled)": total}
            for s in rec["spans"]:
                sec[s["name"]] = sec.get(s["name"], 0.0) + (s["t1"] - s["t0"]) * 1e-9
            both = sec.pop("hybrid-solvers", None)
            if both is not None:
                div, den = int(diag["div_iterations"]), int(diag["density_iterations"])
                share = div / max(div + den, 1)
                sec["div-solver"] = sec.get("div-solver", 0.0) + both * share
                sec["density-solver"] = sec.get("density-solver", 0.0) + both * (1.0 - share)
            for name in names:
                totals[name] += sec.get(name, 0.0)
    out = {name: t / iters for name, t in totals.items()}
    for name, seconds in out.items():
        sim.counters.add_time(name, seconds)
    return out
