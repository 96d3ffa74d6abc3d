"""The reference's solver contract, per step (a copy of the rule of the port's
tally.SolveTally, itself scripts/scenario_gates.py's): every solve converges
or stops at the iteration cap. A solve whose average error stops above
TOL_MARGIN x its tolerance below the cap is a violation, and its step counts
as failed; one that stops at the cap is counted apart as capped. A solve
whose average error the step leaves out of its diagnostics is a violation;
a NaN average (every pressure clamped) is skipped; a dt that is not finite
or below DT_MIN is a collapse and fails the step."""

from __future__ import annotations

import math

TOL_MARGIN = 1.0001
DT_MIN = 1e-9


def tolerances(params: dict) -> tuple:
    """(density, divergence) tolerances of the parameters' solver, None where
    the solver holds none."""
    method = params.get("pressure_solver_method", "HybridDFSPH")
    if method == "HybridDFSPH":
        return (float(params["hybrid_dfsph_max_avg_density_error"]),
                float(params["hybrid_dfsph_max_avg_divergence_error"]))
    if method in ("IISPH", "IISPH2"):
        return float(params["iisph_max_avg_density_error"]), None
    if method == "OnlyDivergence":
        return None, float(params["hybrid_dfsph_max_avg_divergence_error"])
    raise ValueError(f"pressure_solver_method {method!r}")


def judge(diag: dict, params: dict) -> tuple:
    """(violations, capped) of one step's diagnostics."""
    dt = float(diag.get("dt", float("nan")))
    if not math.isfinite(dt) or dt < DT_MIN:
        return 1, 0
    cap = int(params["max_iters"])
    rho0 = float(params.get("rest_density", 1.0))
    tol_den, tol_div = tolerances(params)
    viol = capped = 0
    for err_key, it_key, tol, scale in (
            ("density_avg_error", "density_iterations", tol_den, 1.0 / rho0),
            ("div_avg_error", "div_iterations", tol_div, dt)):
        if tol is None:
            continue
        if err_key not in diag:
            viol += 1
            continue
        err = float(diag[err_key])
        if math.isnan(err):
            continue
        if abs(err) * scale > tol * TOL_MARGIN:
            if int(diag.get(it_key, 0)) >= cap:
                capped += 1
            else:
                viol += 1
    return viol, capped
