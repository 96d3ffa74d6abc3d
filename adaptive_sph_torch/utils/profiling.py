"""Per-stage profiling (`profile_stages`): the reference's section names into `.stat`.

Counterpart of adaptive_sph_tpu/utils/profiling.py. The reference times the
sections of simulation.rs (simulation-step, neighborhood, level-estimation,
div-solver, density-solver, adaptivity); the JAX package, whose step is one
fused program without an in-step timer, estimates them from knockout
variants and scan differentials. The port runs its step eagerly, so it
times the sections inside the step itself: `profile_sections(sim)` runs
`iters` steps from the simulation's current state (results discarded, the
state stays) through a step built with a `timing.SectionTimer`, which
synchronises the card before each section and times it with CUDA events
(the host clock on the CPU), and records the per-step means into
`sim.counters`, so that `write_statistics` prints them:

  simulation-step(profiled)  the whole step (adaptivity included)
  neighborhood               the sorted layout: build_tiles, sort_fields,
                             window_meta (tile_step.step_geometry)
  adaptivity                 share / merge / split (when any is on)
  level-estimation           level estimation and smoothing (when active)
  div-solver                 the divergence solve with its source
                             (HybridDFSPH, OnlyDivergence)
  density-solver             the density solve with its source (all but
                             OnlyDivergence)

The resident HybridDFSPH launch runs both solves and the step between them
at once; its time is split between div-solver and density-solver in
proportion to their iteration counts, as the reference's estimate charges
each solve its iterations. Sections are attributed, not nested:
simulation-step(profiled) also holds what none of them covers.

On the list backend only simulation-step(profiled) is recorded, as the
reference records only it on a backend other than the tiles.
"""

from __future__ import annotations

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
    from ..models.simulation import make_step_fn
    from ..timing import SectionTimer

    timer = SectionTimer(sim.device)
    if sim.backend == "tiles":
        step = make_step_fn(sim.params, sim.boundary_handler, sim.tile_cfg, sim.split_patterns,
                            timer=timer)
    else:
        step = sim.step_fn
    k = sim.step_number + 1
    step(sim.state, k)
    totals = {}
    for _ in range(iters):
        timer.seconds = {}
        with timer.section("simulation-step(profiled)"):
            _, diag = step(sim.state, k)
        sec = dict(timer.seconds)
        both = sec.pop("hybrid-solvers", None)
        if both is not None:
            div, den = int(diag["div_iterations"]), int(diag["density_iterations"])
            share = div / max(div + den, 1)
            sec["div-solver"] = sec.get("div-solver", 0.0) + both * share
            sec["density-solver"] = sec.get("density-solver", 0.0) + both * (1.0 - share)
        for name in section_names(sim.params, sim.backend):
            totals[name] = totals.get(name, 0.0) + sec.get(name, 0.0)
    out = {name: t / iters for name, t in totals.items()}
    for name, seconds in out.items():
        sim.counters.add_time(name, seconds)
    return out
