"""The comparison that decides `correct`.

At the steps a run keeps (the window's first step, from the initial state,
and a sample drawn from the seed), the reference (benchmark/reference) works
the step out again from the program's own state before it; the program's
state after it is judged against the reference's, particle by particle,
matched by position both ways: each of the program's particles is looked up
among the reference's, and each of the reference's among the program's, so
that a particle the program dropped or made up is far from any twin. The
initial state itself is held against the reference's own lattice with the
same jitter.

The numbers, each the largest over the kept steps:

- start_gap: the initial state's positions, velocities and masses against
  the reference's (exact: the same lattice and the same jitter);
- census_gap: alive particles, program against reference (share, merge and
  split decisions);
- mass_gap: total alive mass, relative (the resampling's bookkeeping);
- particle_mass_gap: each matched particle's mass, relative;
- pos_gap: each matched particle's position gap over its radius
  sqrt(m / (pi rho0)), the larger of the two directions;
- vel_gap: each matched particle's velocity gap over the reference's
  largest speed;
- rho_gap: each matched particle's density, relative;
- dt_gap: the step's dt, relative (advection and the CFL dt);
- level_gap (where level estimation runs): each matched particle's level
  gap over the reference's largest level;
- iters_gap: the sweeps by which a solve of the program stopped apart from
  the reference's; where it is not 0 the reference works the step again
  with the program's sweep counts, and the gaps above are of that step;
- early_sweeps: the sweeps by which a solve of the program stopped before
  the reference's own exit test, where the program stopped below the
  iteration cap: the reference's residual at the program's stopping sweep
  was still above the tolerance the configuration states.

A cell's limits file names the numbers that decide `correct`; the others
are printed as readings.
"""

from __future__ import annotations

import math

import numpy as np

FIELDS_COMPARED = ("position", "velocity", "mass", "density", "level", "alive")


def host_state(st) -> dict:
    """The fields the comparison reads, as numpy arrays."""
    return {k: getattr(st, k).detach().cpu().numpy() for k in FIELDS_COMPARED}


def start_gap(port: dict, ref: dict) -> float:
    if not np.array_equal(port["alive"], ref["alive"]):
        return math.inf
    a = ref["alive"]
    return float(max(np.abs(port[k][a].astype(np.float64) - ref[k][a]).max(initial=0.0)
                     for k in ("position", "velocity", "mass")))


def step_gaps(port: dict, ref: dict, port_dt: float, ref_dt: float, rest_density: float,
              levels: bool) -> dict:
    from scipy.spatial import cKDTree

    pa, ra = port["alive"], ref["alive"]
    out = {"census_gap": float(abs(int(pa.sum()) - int(ra.sum())))}
    rm = ref["mass"][ra].astype(np.float64)
    pm = port["mass"][pa].astype(np.float64)
    out["mass_gap"] = float(abs(pm.sum() - rm.sum()) / rm.sum())
    rpos = ref["position"][ra].astype(np.float64)
    ppos = port["position"][pa].astype(np.float64)
    dist, j = cKDTree(rpos).query(ppos, k=1)
    radius = np.sqrt(rm / (math.pi * rest_density))
    back = cKDTree(ppos).query(rpos, k=1)[0] if len(ppos) else np.full(len(rpos), np.inf)
    out["pos_gap"] = float(max((dist / radius[j]).max(initial=0.0),
                               (back / radius).max(initial=0.0)))
    rv = ref["velocity"][ra].astype(np.float64)
    vmax = float(np.sqrt((rv * rv).sum(1)).max(initial=0.0))
    dv = port["velocity"][pa].astype(np.float64) - rv[j]
    out["vel_gap"] = float(np.sqrt((dv * dv).sum(1)).max(initial=0.0) / max(vmax, 1e-30))
    out["particle_mass_gap"] = float(np.abs(pm / rm[j] - 1.0).max(initial=0.0))
    rr = ref["density"][ra].astype(np.float64)
    out["rho_gap"] = float(np.abs(port["density"][pa] / rr[j] - 1.0).max(initial=0.0))
    out["dt_gap"] = float(abs(port_dt / ref_dt - 1.0)) if ref_dt else math.inf
    if levels:
        rl = ref["level"][ra].astype(np.float64)
        lmax = float(np.abs(rl).max(initial=0.0))
        out["level_gap"] = float(np.abs(port["level"][pa] - rl[j]).max(initial=0.0)
                                 / max(lmax, 1e-30))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(rows: list) -> dict:
    """The largest of each number over the kept steps."""
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number the cell's limits name, beside its
    limit (the cell's limits file says which numbers separate the program
    from its control; the others are readings only). A limit whose number
    is missing, or no limits at all, is not correct."""
    checks, ok = {}, bool(limits)
    for k in sorted(limits):
        v, lim = numbers.get(k), limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        if v is None or lim is None or not (v <= lim):
            ok = False
    return ok, checks
