"""Whether the stress scene's dt dip at the t ~ 0.72 s impact, under Jacobi
momentum 0.9, is the card's fault or the trajectory's.

The gates' `stress` scenario (`adaptive_sph_torch.gates`, momentum 0.9) runs
on the card to T0, just before the impact; its state there is the common
start of these runs, each stepped to T1:

  card      the run itself, continued;
  reload    the card again from the state copied to the host and back (a
            control: must equal `card` step for step, so the state is whole);
  cpu       the port's plain versions on the CPU from the same state
            (at most CPU_STEPS steps, the plain versions being slow);
  ulp{k}    the card from the state with every alive position coordinate
            moved by one float32 step, up or down by a seeded sign (seed k).

Per run: steps, the minimum dt and its time, the steps with dt below 1e-5,
the iterations. Against `card`: both minimum dts over the steps both took,
the first step whose dt or iteration counts differ, and over the first
COMPARE_STEPS steps the largest relative dt and kinetic-energy differences
and the positions' row by row (rows reorder once the runs part, so this one
means something only until then).

`cpu` dipping as `card` does from the same state clears the card's kernels;
how far the `ulp{k}` dips spread shows how much of the depth is the
trajectory's.

    python scripts/torch_port_stress_witness.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

T0, T1 = 0.712, 0.745  # s: the card's run of the gates dips at t ~ 0.719
ULP_RUNS = 2
CPU_STEPS = 300
CARD_STEPS = 8000
COMPARE_STEPS = 64
SMALL_DT = 1e-5


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build(device, capacity=None):
    from adaptive_sph_torch import gates
    from adaptive_sph_torch.runner import create_simulation

    params, scene, _, _ = gates.scenario("stress", 0.9)
    return create_simulation(params, scene, capacity=capacity, counters_enabled=False,
                             device=device, backend="tiles")


def from_state(arrays, device):
    from adaptive_sph_torch.convert import state_from_numpy

    sim = build(device, capacity=arrays["position"].shape[0])
    sim.load_state(state_from_numpy(arrays, device=device))
    return sim


def kinetic(sim):
    st = sim.state
    a = st.alive
    return float((0.5 * st.mass[a].double() * (st.velocity[a].double() ** 2).sum(1)).sum())


def run_window(name, sim, t1, max_steps, keep=0, against=None):
    """Step sim to t1 (at most max_steps): per-step dt, iterations, kinetic
    energy; the first `keep` steps' positions; against another run's kept
    positions, the row-by-row largest |dx| per step."""
    rec = {"dt": [], "density_iterations": [], "div_iterations": [], "kinetic": [], "t": []}
    kept, dx = [], []
    t0 = time.perf_counter()
    while sim.time < t1 and len(rec["dt"]) < max_steps:
        d = sim.step()
        for k in ("dt", "density_iterations", "div_iterations"):
            rec[k].append(d[k])
        rec["kinetic"].append(kinetic(sim))
        rec["t"].append(sim.time)
        k = len(rec["dt"])
        if k <= keep or (against is not None and k <= len(against)):
            pos = sim.state.position.detach().cpu().numpy().copy()
            if k <= keep:
                kept.append(pos)
            if against is not None and k <= len(against):
                alive = sim.state.alive.cpu().numpy()
                dx.append(float(np.abs(pos[alive] - against[k - 1][alive]).max()))
        if k % 256 == 0:
            log(f"  [{name}] t={sim.time:.5f} steps={k} dt={d['dt']:.3e} "
                f"wall={time.perf_counter() - t0:.0f}s")
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    return rec, kept, dx


def summary(rec):
    dt = np.asarray(rec["dt"])
    i = int(np.argmin(dt))
    return {"steps": len(dt), "t_end": rec["t"][-1], "min_dt": float(dt[i]),
            "t_min_dt": rec["t"][i], "steps_below_1e-5": int((dt < SMALL_DT).sum()),
            "max_density_iters": int(max(rec["density_iterations"])),
            "max_div_iters": int(max(rec["div_iterations"])),
            "avg_div_iters": float(np.mean(rec["div_iterations"])),
            "wall_s": rec["wall_s"], "ms_per_step": rec["wall_s"] / len(dt) * 1000}


def parting(rec, ref, dx, compare_steps):
    """Where rec parts from ref, and how far apart they are early on."""
    n = min(len(rec["dt"]), len(ref["dt"]))

    def first(key):
        a, b = np.asarray(rec[key][:n]), np.asarray(ref[key][:n])
        idx = np.nonzero(a != b)[0]
        return int(idx[0]) + 1 if len(idx) else None

    m = min(n, compare_steps)
    rel = lambda a, b: np.abs(np.asarray(a[:m]) - np.asarray(b[:m])) / np.abs(np.asarray(b[:m]))
    return {"steps_compared": n,
            # the dips over the same steps, this run's and the card's
            "min_dt": float(min(rec["dt"][:n])), "card_min_dt": float(min(ref["dt"][:n])),
            "first_dt_differs": first("dt"),
            "first_density_iters_differ": first("density_iterations"),
            "first_div_iters_differ": first("div_iterations"),
            "max_rel_dt_diff_early": float(rel(rec["dt"], ref["dt"]).max()),
            "max_rel_kinetic_diff_early": float(rel(rec["kinetic"], ref["kinetic"]).max()),
            "max_abs_dx_rows_early": dx[:m],
            "rel_dt_diff_by_step": [float(x) for x in rel(rec["dt"], ref["dt"])]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON here (after every run)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    from adaptive_sph_torch.convert import state_to_numpy
    from adaptive_sph_torch.gates import device_label

    out = {"scenario": "stress", "jacobi_momentum": 0.9, "t0": T0, "t1": T1,
           "device": device_label(torch.device("cuda")),
           "cpu_threads": torch.get_num_threads(), "runs": {}, "against_card": {}}

    def save():
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
            with open(a.out, "w") as f:
                json.dump(out, f, indent=1)

    sim = build("cuda")
    lead, _, _ = run_window("to t0", sim, T0, 10**9)
    out["lead"] = summary(lead)
    arrays = state_to_numpy(sim.state)
    out["state_at_t0"] = {"t": sim.time, "steps": len(lead["dt"]), "n": sim.num_fluid_particles,
                          "capacity": sim.state.capacity}
    log(f"state at t = {sim.time:.5f} after {len(lead['dt'])} steps")

    card, kept, _ = run_window("card", sim, T1, CARD_STEPS, keep=COMPARE_STEPS)
    out["runs"]["card"] = summary(card)
    save()
    runs = [("reload", "cuda", None)] + [(f"ulp{k}", "cuda", k) for k in range(1, ULP_RUNS + 1)]
    runs.append(("cpu", "cpu", None))
    for name, device, seed in runs:
        arr = dict(arrays)
        if seed is not None:
            pos = torch.from_numpy(arrays["position"].copy())
            sign = torch.from_numpy(np.random.default_rng(seed).choice(
                np.float32([-1.0, 1.0]), pos.shape))
            moved = torch.nextafter(pos, sign * torch.tensor(float("inf")))
            alive = torch.from_numpy(arrays["alive"])[:, None]
            arr["position"] = torch.where(alive, moved, pos).numpy()
        run_sim = from_state(arr, device)
        steps = CPU_STEPS if name == "cpu" else CARD_STEPS
        rec, _, dx = run_window(name, run_sim, T1, steps, against=kept)
        out["runs"][name] = summary(rec)
        out["against_card"][name] = parting(rec, card, dx, COMPARE_STEPS)
        log(f"{name}: {json.dumps(out['runs'][name])}")
        del run_sim
        save()
    print(json.dumps({k: v for k, v in out.items() if k != "against_card"}, indent=1))
    for name, p in out["against_card"].items():
        print(name, json.dumps({k: v for k, v in p.items() if k != "rel_dt_diff_by_step"}))
    save()


if __name__ == "__main__":
    main(sys.argv[1:])
