"""Hold each package's check_aii terms against float64 on the constrained stress run.

check_aii compares two float32 computations of the same quantity per
particle: a_ii assembled from the pair walk's gradient sums, and a_ii_real,
the brute-force divergence of the acceleration a unit self pressure gives
(a separate pair sweep). In exact arithmetic they are equal, so the check's
deviation max |a_ii_real - a_ii| is rounding alone. This script measures how
far each package's two terms are from float64 at the same states.

Runs the JAX package on the CPU (its Pallas sweeps in interpret mode, as its
own tests run them) on `adaptive_sph_torch.stress.sweep_mode_runs()`'s
"stress_checked_constrained" run. At each witness step it takes JAX's state
before the step, runs JAX's step and the port's step on the CPU (the port's
step is not taken, JAX's state goes on) and captures from both: the sorted [x, y, h, mass], rho, the boundary
vector G, a_ii and a_ii_real. `aii_terms_f64` recomputes both terms in
float64 from each package's own float32 inputs over the port's pair list.

Writes tests/data/torch_port_aii_witness.npz, one entry per witness step
(`step`), each in units of 1/512 (one float32 step of a_ii for |a_ii| in
[2^14, 2^15), this scene's range), for p in (jax, port):

  p_dev      : the package's deviation max |a_ii_real - a_ii| (alive particles)
  p_err_aii  : max |a_ii - a_ii (float64)|
  p_err_real : max |a_ii_real - a_ii_real (float64)|
  p_err_dev  : max |(a_ii_real - a_ii) - (the same in float64)|
  p_mean_aii, p_mean_real : the mean of the two errors
  dev_f64    : the float64 deviation (port's inputs), and aii_max: max |a_ii|

`chip_smoke.py` 4g runs `port_witness` on the card at the same steps of its
own trajectory and holds the port's errors against JAX's from this file.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_aii_witness.py

(~6 min on the CPU.)
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_aii_witness.npz")
RUN = "stress_checked_constrained"
UNIT = 1.0 / 512.0  # one float32 step of a_ii in [2^14, 2^15)
WITNESS_FROM, WITNESS_TO = 121, 140  # the steps where the drift record peaks


def aii_terms_f64(x, y, h, m, rho, Gx, Gy, row, col, params, bt_kind: str, pscale: float):
    """a_ii and a_ii_real in float64 from float32 inputs (torch tensors on one
    device): the gradient sums and the brute-force divergence over the pairs
    (row, col), the same formulas as models/tile_step.py's check_aii."""
    import torch

    from adaptive_sph_torch.models import grid_physics as gp
    from adaptive_sph_torch.models import tile_physics as tp
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.ops.sweeps import PairCtx
    from adaptive_sph_torch.utils.params import OperatorDiscretization

    d = lambda t: t.double()  # noqa: E731
    x, y, h, m, rho, Gx, Gy = map(d, (x, y, h, m, rho, Gx, Gy))
    C = x.shape[0]
    row, col = row.long(), col.long()
    zero = torch.zeros_like(x)
    flat = torch.stack([x, y, h, m, zero, zero], dim=1)
    qi, cj, t = pair_ops._pair_terms(flat, row, col, pscale, 0.0, False, False)

    def rsum(v):
        return torch.zeros(C, dtype=torch.float64, device=x.device).index_add_(0, qi, v)

    s1x, s1y, s1sq = rsum(t["wx"]), rsum(t["wy"]), rsum(t["t2"])
    w2020 = params.operator_discretization == OperatorDiscretization.Winchenbach2020
    if w2020:
        inv = 1.0 / torch.clamp(rho[cj], min=1e-30)
        s2x, s2y, s2sq = rsum(t["wx"] * inv), rsum(t["wy"] * inv), rsum(t["t2"] * inv)
    else:
        s2x = s2y = s2sq = zero
    aii = gp.assemble_aii_1d(s1x, s1y, s1sq, s2x, s2y, s2sq, {"rho": rho, "mass": m},
                             Gx, Gy, bt_kind, params)
    rr2 = torch.clamp(rho * rho, min=1e-30)
    bux, buy = gp.boundary_accel_slots_1d(Gx, Gy, torch.ones_like(rho), rho, bt_kind, params)
    ax, ay = -s1x / rr2 + bux, -s1y / rr2 + buy
    dx, dy = x[qi] - x[cj], y[qi] - y[cj]
    ctx = PairCtx(dx, dy, dx * dx + dy * dy, torch.clamp(0.5 * (h[qi] + h[cj]), min=1e-6))
    q = {"mass": m[qi], "rho": rho[qi], "ax": ax[qi], "ay": ay[qi]}
    c = {"mass": m[cj], "rho": rho[cj], "ax": ax[cj], "ay": ay[cj]}
    fluid_div = rsum(tp.check_aii_op(w2020).emit(q, c, ctx)[0])
    if not w2020:
        fluid_div = fluid_div / torch.clamp(rho, min=1e-30)
    real = fluid_div + gp.boundary_div_slots_1d(Gx, Gy, ax, ay, rho, bt_kind, params)
    return aii, real


def summarize(rec: dict, aii64, real64, alive) -> dict:
    """The errors of one package's float32 terms against float64, in 1/512."""
    aii = rec["aii"].double()
    real = rec["real"].double()
    a = alive
    dev = (real - aii).abs()[a]
    err_aii = (aii - aii64).abs()[a]
    err_real = (real - real64).abs()[a]
    err_dev = ((real - aii) - (real64 - aii64)).abs()[a]
    return {"dev": float(dev.max()) / UNIT, "err_aii": float(err_aii.max()) / UNIT,
            "err_real": float(err_real.max()) / UNIT, "err_dev": float(err_dev.max()) / UNIT,
            "mean_aii": float(err_aii.mean()) / UNIT, "mean_real": float(err_real.mean()) / UNIT}


@contextlib.contextmanager
def port_capture():
    """Records the port's check_aii terms of each step: the pair list, the
    sorted statics, rho, G, a_ii and a_ii_real (the last step's, in rec)."""
    from adaptive_sph_torch.models import grid_physics as gp
    from adaptive_sph_torch.models import tile_step
    from adaptive_sph_torch.ops import pair_ops

    rec = {}
    orig = (pair_ops.pair_build, tile_step.pair_sweep, gp.assemble_aii_1d,
            gp.boundary_div_slots_1d)

    def pair_build(*a, **k):
        csr = orig[0](*a, **k)
        rec["row_ptr"], rec["col"] = csr.row_ptr, csr.col
        return csr

    def pair_sweep(cell_starts, wm, statics, dyn, op, scale, tq):
        out = orig[1](cell_starts, wm, statics, dyn, op, scale, tq)
        if op.name.startswith("check_aii"):
            rec["statics"], rec["check"], rec["check_dyn"] = statics, out[:, 0], dyn
            rec["after_check"] = True
        return out

    def assemble(s1x, s1y, s1sq, s2x, s2y, s2sq, sf, Gx, Gy, bt_kind, params):
        out = orig[2](s1x, s1y, s1sq, s2x, s2y, s2sq, sf, Gx, Gy, bt_kind, params)
        rec.update(aii=out, rho=sf["rho"], Gx=Gx, Gy=Gy, bt_kind=bt_kind, after_check=False)
        return out

    def bdiv(Gx, Gy, qx, qy, rho, bt_kind, params):
        out = orig[3](Gx, Gy, qx, qy, rho, bt_kind, params)
        if rec.get("after_check"):
            rec["bdiv"], rec["after_check"] = out, False
        return out

    pair_ops.pair_build, tile_step.pair_sweep = pair_build, pair_sweep
    gp.assemble_aii_1d, gp.boundary_div_slots_1d = assemble, bdiv
    try:
        yield rec
    finally:
        (pair_ops.pair_build, tile_step.pair_sweep, gp.assemble_aii_1d,
         gp.boundary_div_slots_1d) = orig


def finish_port_record(rec: dict, params, pscale: float) -> dict:
    """The port's captured step as [x, y, h, mass], rho, G, a_ii, a_ii_real,
    the pair list and the alive mask, all tensors on the step's device."""
    import torch

    from adaptive_sph_torch.utils.params import OperatorDiscretization

    st = rec["statics"]
    rho = rec["rho"]
    fluid_div = rec["check"]
    if params.operator_discretization != OperatorDiscretization.Winchenbach2020:
        fluid_div = fluid_div / torch.clamp(rho, min=1e-30)
    counts = (rec["row_ptr"][1:] - rec["row_ptr"][:-1]).long()
    row = torch.repeat_interleave(torch.arange(st.shape[0], device=st.device), counts)
    return {"x": st[:, 0], "y": st[:, 1], "h": st[:, 2], "m": st[:, 3], "rho": rho,
            "Gx": rec["Gx"], "Gy": rec["Gy"], "aii": rec["aii"], "real": fluid_div + rec["bdiv"],
            "row": row, "col": rec["col"], "alive": st[:, 2] > 0.0,
            "bt_kind": rec["bt_kind"], "pscale": pscale}


def port_witness(rec: dict, params) -> tuple:
    """(the port's errors against float64 in 1/512, the float64 deviation) of a
    finished record (finish_port_record)."""
    aii64, real64 = aii_terms_f64(rec["x"], rec["y"], rec["h"], rec["m"], rec["rho"],
                                  rec["Gx"], rec["Gy"], rec["row"], rec["col"], params,
                                  rec["bt_kind"], rec["pscale"])
    a = rec["alive"]
    return summarize(rec, aii64, real64, a), float((real64 - aii64).abs()[a].max()) / UNIT


def jax_capture(rec: dict):
    """Patches the JAX package's tile step (before its first trace) so that
    every step hands its check_aii terms to rec through host callbacks."""
    import jax

    from adaptive_sph_tpu.models import grid_physics as jgp
    from adaptive_sph_tpu.models import tile_step as jts

    run_sweep, assemble, bdiv = jts.run_sweep, jgp.assemble_aii_1d, jgp.boundary_div_slots_1d
    traced = {"after_check": False}

    def put(name):
        def f(*vals):
            rec[name] = [np.asarray(v) for v in vals]
        return f

    def sweep_hook(cfg, bins, statics, dyn, op, scale, interpret=None, wmeta=None):
        out = run_sweep(cfg, bins, statics, dyn, op, scale, interpret=interpret, wmeta=wmeta)
        if op.name == "check_aii":
            jax.debug.callback(put("check"), statics, out[:, 0], ordered=True)
            traced["after_check"] = True
        return out

    def assemble_hook(s1x, s1y, s1sq, s2x, s2y, s2sq, sf, Gx, Gy, bt_kind, params):
        out = assemble(s1x, s1y, s1sq, s2x, s2y, s2sq, sf, Gx, Gy, bt_kind, params)
        jax.debug.callback(put("aii"), out, sf["rho"], Gx, Gy, ordered=True)
        return out

    def bdiv_hook(Gx, Gy, qx, qy, rho, bt_kind, params):
        out = bdiv(Gx, Gy, qx, qy, rho, bt_kind, params)
        if traced["after_check"]:
            traced["after_check"] = False
            jax.debug.callback(put("bdiv"), out, ordered=True)
        return out

    jts.run_sweep, jgp.assemble_aii_1d, jgp.boundary_div_slots_1d = (
        sweep_hook, assemble_hook, bdiv_hook)


def jax_record(rec: dict, params):
    """JAX's captured step as torch tensors on the CPU, keyed as
    finish_port_record's (a_ii_real rounded exactly as JAX's: one division
    and one addition of captured float32 values)."""
    import torch

    from adaptive_sph_torch.utils.params import OperatorDiscretization

    st, check = rec["check"]
    aii, rho, Gx, Gy = rec["aii"]
    (bd,) = rec["bdiv"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    st, check, aii, rho, Gx, Gy, bd = map(t, (st, check, aii, rho, Gx, Gy, bd))
    if params.operator_discretization != OperatorDiscretization.Winchenbach2020:
        check = check / torch.clamp(rho, min=1e-30)
    return {"x": st[:, 0], "y": st[:, 1], "h": st[:, 2], "m": st[:, 3], "rho": rho,
            "Gx": Gx, "Gy": Gy, "aii": aii, "real": check + bd, "alive": st[:, 2] > 0.0}


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch
    from torch_port_sweep_modes_ref import jax_simulation

    from adaptive_sph_torch import convert
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.models.tile_step import physics_scale
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import sweep_mode_runs

    params, scene, capacity, _ = sweep_mode_runs()[RUN]
    jrec = {}
    jax_capture(jrec)
    jsim = jax_simulation(params, scene, capacity)
    psim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                             device="cpu", counters_enabled=False)
    pscale = float(physics_scale(psim.params))
    out = {}
    t0 = time.perf_counter()
    for step in range(1, WITNESS_TO + 1):
        if step >= WITNESS_FROM:
            jst = jsim.state
            psim.state = convert.state_from_numpy(
                {k: np.asarray(getattr(jst, k)) for k in convert.FIELDS}, device="cpu")
            with port_capture() as prec:
                _, pdiag = psim.step_fn(psim.state, step)
            prec = finish_port_record(prec, psim.params, pscale)
        d = jsim.step()
        print(f"step {step}: JAX aii deviation {float(d['aii_deviation']):.6g} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        if step < WITNESS_FROM:
            continue
        jr = jax_record(jrec, psim.params)
        same = all(torch.equal(jr[k], prec[k].cpu()) for k in ("x", "y", "h", "m"))
        if not same:
            raise AssertionError(f"step {step}: the packages' sorted [x, y, h, mass] differ; "
                                 "the port's pair list does not apply to JAX's inputs")
        jdev = float((jr["real"] - jr["aii"]).abs()[jr["alive"]].max())
        if jdev != float(d["aii_deviation"]):
            raise AssertionError(f"step {step}: captured JAX deviation {jdev} against its "
                                 f"step's {float(d['aii_deviation'])}")
        pdev = float((prec["real"] - prec["aii"]).abs()[prec["alive"]].max())
        if pdev != float(pdiag["aii_deviation"]):
            raise AssertionError(f"step {step}: captured port deviation {pdev} against its "
                                 f"step's {float(pdiag['aii_deviation'])}")
        ps, dev64 = port_witness(prec, psim.params)
        pairs = {k: prec[k].cpu() for k in ("row", "col")}
        aii64, real64 = aii_terms_f64(jr["x"], jr["y"], jr["h"], jr["m"], jr["rho"], jr["Gx"],
                                      jr["Gy"], pairs["row"], pairs["col"], psim.params,
                                      prec["bt_kind"], pscale)
        js = summarize(jr, aii64, real64, jr["alive"])
        rows = {"step": step, "dev_f64": dev64,
                "aii_max": float(aii64.abs()[jr["alive"]].max())}
        rows.update({f"jax_{k}": v for k, v in js.items()})
        rows.update({f"port_{k}": v for k, v in ps.items()})
        for k, v in rows.items():
            out.setdefault(k, []).append(v)
        print("  " + ", ".join(f"{k} {v:.4g}" for k, v in rows.items()), flush=True)
    arrays = {k: np.asarray(v, np.int32 if k == "step" else np.float64) for k, v in out.items()}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}")
    for p in ("jax", "port"):
        print(f"{p}: max over the steps (1/512): " + ", ".join(
            f"{k} {arrays[f'{p}_{k}'].max():.4g}" for k in
            ("dev", "err_aii", "err_real", "err_dev", "mean_aii", "mean_real")))


if __name__ == "__main__":
    main()
