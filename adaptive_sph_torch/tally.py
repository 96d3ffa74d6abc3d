"""The scenario gates' rule over per-step diagnostics.

Counterpart of scripts/scenario_gates.py:152-226 and :291-292, rule for
rule. Every solve is held to the reference's contract (simulation.rs:
1453-1478): converge, or stop at the iteration cap. `SolveTally` counts the
solves of a run; `gate_ok` is the pass rule over a run's record. The gates
(`adaptive_sph_torch.gates`) and the slab runner (`multichip.run_slab`)
both count with it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MASS_DRIFT_MAX = 1e-3
TOL_MARGIN = 1.0001  # a solve counts as over its tolerance above this multiple
DT_MIN = 1e-9


class SolveTally:
    """The gates' rule over per-step diagnostics (scripts/scenario_gates.py
    rule for rule): `add(d, t)` takes one call's diagnostics, each value a
    number (one step) or a per-step sequence (a chunk).

    cap: the iteration cap (params.max_iters); tol_den / tol_div: the density
    and divergence tolerances, None where the scenario holds none (onlydiv
    has no density solve). A solve over TOL_MARGIN x its tolerance counts as
    a violation when it stopped below the cap and as capped at the cap; NaN
    averages (the reference's normal-set average when every pressure clamps)
    are skipped."""

    def __init__(self, cap: int, rest_density: float, tol_den: Optional[float],
                 tol_div: Optional[float]):
        self.cap = int(cap)
        self.rest_density = float(rest_density)
        self.tol_den, self.tol_div = tol_den, tol_div
        self.steps = 0
        self.den_errs, self.div_errs, self.den_errs_all, self.den_max_all = [], [], [], []
        self.den_iters, self.div_iters, self.dts = [], [], []
        self.viol = {"den": 0, "div": 0}
        self.capped = {"den": 0, "div": 0}
        self.dt_collapse_t = None

    def add(self, d: dict, t: float = 0.0) -> bool:
        """Tally one call's steps; t is the simulated time after them. Returns
        False, and tallies nothing more of the call, when dt collapsed: the
        run stops there and dt_collapse_t holds t."""
        def arr(key, dtype=np.float64):
            return np.atleast_1d(np.asarray(d[key], dtype))

        dt = arr("dt")
        self.steps += len(dt)
        if not np.all(np.isfinite(dt)) or float(dt.min()) < DT_MIN:
            self.dt_collapse_t = float(np.nanmax([0.0, float(t)]))
            return False
        if "density_avg_error" in d:
            vals = np.abs(arr("density_avg_error"))
            it = arr("density_iterations", np.int64) if "density_iterations" in d else \
                np.zeros(len(vals), np.int64)
            m = ~np.isnan(vals)
            if m.any():
                self.den_errs.append(vals[m].max())
                if self.tol_den is not None:
                    self._count("den", vals[m] / self.rest_density > self.tol_den * TOL_MARGIN,
                                it[m])
        if "density_avg_error_all" in d:
            # the unclamped residual over every alive non-singular particle:
            # observable when the reference's normal-set average is NaN
            self.den_errs_all.append(np.abs(arr("density_avg_error_all")).max())
            self.den_max_all.append(np.abs(arr("density_max_error_all")).max())
        if "div_avg_error" in d:
            vals = np.abs(arr("div_avg_error"))
            it = arr("div_iterations", np.int64) if "div_iterations" in d else \
                np.zeros(len(vals), np.int64)
            m = ~np.isnan(vals)
            if m.any():
                self.div_errs.append((vals[m] * dt[m]).max())
                if self.tol_div is not None:
                    # |avg| < tol / dt per divergence solve, as err x dt < tol
                    self._count("div", vals[m] * dt[m] > self.tol_div * TOL_MARGIN, it[m])
        for key, store in (("density_iterations", self.den_iters),
                           ("div_iterations", self.div_iters)):
            if key in d:
                store.extend(np.atleast_1d(np.asarray(d[key])).tolist())
        self.dts.extend(dt.tolist())
        return True

    def _count(self, kind: str, over, it):
        at_cap = it >= self.cap
        self.viol[kind] += int((over & ~at_cap).sum())
        self.capped[kind] += int((over & at_cap).sum())

    def summary(self) -> dict:
        """The record's solver keys."""
        rd = self.rest_density

        def top(xs, scale=1.0):
            return max(xs) / scale if xs else None

        def avg(xs):
            return float(np.mean(xs)) if xs else None

        return {
            "max_avg_density_error_rel": top(self.den_errs, rd),
            "max_avg_density_error_all_rel": top(self.den_errs_all, rd),
            "max_density_error_all_rel": top(self.den_max_all, rd),
            "tol_density": self.tol_den,
            "density_tol_violations": self.viol["den"],
            "max_avg_div_error_times_dt": top(self.div_errs),
            "tol_divergence": self.tol_div,
            "div_tol_violations": self.viol["div"],
            "capped_density_solves": self.capped["den"],
            "capped_div_solves": self.capped["div"],
            "max_iters_cap": self.cap,
            "max_density_iters": int(max(self.den_iters)) if self.den_iters else None,
            "max_div_iters": int(max(self.div_iters)) if self.div_iters else None,
            "avg_density_iters": avg(self.den_iters),
            "avg_div_iters": avg(self.div_iters),
            "avg_dt": avg(self.dts),
            "min_dt": min(self.dts) if self.dts else None,
        }


def gate_ok(out: dict) -> bool:
    """The reference script's pass rule over a record."""
    return bool(out["contained"] and out["mass_drift"] < MASS_DRIFT_MAX
                and out["density_tol_violations"] == 0 and out["div_tol_violations"] == 0
                and out["dt_collapse_t"] is None)
