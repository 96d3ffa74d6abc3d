"""Write the JAX reference trajectories of the clique / patch-major layout for the PyTorch port.

Runs the JAX package on the CPU through `create_simulation(backend="tiles")`
under ASPH_CLIQUE=1 for every run of `adaptive_sph_torch.stress.clique_runs()`:

  stress_clique   : the stress scene with the parity options, 5 steps;
  touching_clique : the touching two-size scene, 10 steps;
  touching_nxcap1 : the same under ASPH_NX_CAP=1 (the reference falls back
                    to the packed layout on its first step),

and writes tests/data/torch_port_clique_ref.npz, keys "<run>/<name>":

  per step : n, capacity, patch (the runner's patch side after the step),
             clique_disabled, dt, div_iterations, density_iterations
  position, velocity, density, mass, h : the alive particles after the
             last step, in the state's order

chip_smoke.py holds the port's runs on the GPU (phase C2) to this file (the
GPU machine has no JAX); tests/test_torch_clique_step.py holds the touching
scene's first steps on the CPU against JAX directly.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_clique_ref.py [--only RUN ...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_clique_ref.npz")
PER_STEP = {
    "n": np.int32, "capacity": np.int32, "patch": np.int32, "clique_disabled": np.int32,
    "dt": np.float32, "div_iterations": np.int32, "density_iterations": np.int32,
}
STATE = ("position", "velocity", "density", "mass", "h")


def reference_run(params, scene: dict, capacity, steps: int, env: dict):
    """(alive state arrays, per-step diag arrays) of the JAX run under
    ASPH_CLIQUE=1 and `env` (both set before the step is first traced)."""
    from adaptive_sph_torch import convert
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation
    from adaptive_sph_tpu.utils import params as j_params

    saved = {k: os.environ.get(k) for k in ("ASPH_CLIQUE", *env)}
    os.environ.update({"ASPH_CLIQUE": "1", **env})
    try:
        sim = create_simulation(j_params.params_from_dict(convert.params_to_dict(params)),
                                j_scene.scene_from_dict(scene), capacity=capacity,
                                backend="tiles")
        per_step = {k: [] for k in PER_STEP}
        for _ in range(steps):
            d = sim.step()
            d = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity,
                 "patch": sim.tile_cfg.patch, "clique_disabled": int(sim.clique_disabled)}
            for name in PER_STEP:
                per_step[name].append(np.asarray(d.get(name, 0)).item())
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    alive = np.asarray(sim.state.alive)
    state = {name: np.asarray(getattr(sim.state, name))[alive] for name in STATE}
    return state, {name: np.asarray(v, PER_STEP[name]) for name, v in per_step.items()}


def main():
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.stress import clique_runs

    runs = clique_runs()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(runs), default=None,
                    help="regenerate these runs and keep the file's others")
    args = ap.parse_args()
    out = {}
    if args.only and os.path.exists(OUT):
        old = np.load(OUT)
        out = {k: old[k] for k in old.files if k.split("/")[0] not in args.only}
    for name, (params, scene, capacity, steps, env) in runs.items():
        if args.only and name not in args.only:
            continue
        t0 = time.perf_counter()
        state, per_step = reference_run(params, scene, capacity, steps, env)
        for k, v in {**per_step, **state}.items():
            out[f"{name}/{k}"] = v
        print(f"{name}: {steps} steps in {time.perf_counter() - t0:.1f} s, n = "
              f"{per_step['n'].tolist()}, capacity {per_step['capacity'].tolist()}, patch "
              f"{per_step['patch'].tolist()}, clique_disabled "
              f"{per_step['clique_disabled'].tolist()}, iterations "
              f"{per_step['div_iterations'].tolist()} / {per_step['density_iterations'].tolist()}",
              flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B)")


if __name__ == "__main__":
    main()
