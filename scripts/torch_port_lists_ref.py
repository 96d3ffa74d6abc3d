"""Write the JAX reference trajectories of the list backend for the PyTorch port.

Runs the JAX package on the CPU through `create_simulation(backend="auto")`,
which takes its neighbour-list backend for these runs (levels after
advection without the extended range), for every run of
`adaptive_sph_torch.stress.list_runs()`:

  surface_centerdiff, surface_emptyangle : configs/media/surface-detection.yaml
      entries 1 and 2 with the extended range off (scene-ratio2to1, n =
      1,035), stepped until the time reaches stress.LIST_EXPORT_TIME, as the
      image export steps them;
  dambreak : the default dam break with levels after advection and the
      extended range off, stress.LIST_DAMBREAK_STEPS steps.

and writes tests/data/torch_port_lists_ref.npz, keys "<run>/<name>":

  per step : n, capacity, dt, div_iterations, density_iterations, shares,
             merge_or_split_count, split_deferred, mass_conservation_error
             (0 where the step has none)
  position, velocity, density, mass, level, stash, has_level,
  flag_is_fluid_surface, flag_insufficient_neighs : the alive particles after
             the last step

chip_smoke.py holds the port's runs on the GPU (phases L1, L2) to this file
(the GPU machine has no JAX); tests/test_torch_lists_step.py holds them on
the CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_lists_ref.py   # ~1 min
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_lists_ref.npz")
PER_STEP = {
    "n": np.int32, "capacity": np.int32, "dt": np.float32, "div_iterations": np.int32,
    "density_iterations": np.int32, "shares": np.int32, "merge_or_split_count": np.int32,
    "split_deferred": np.int32, "mass_conservation_error": np.float32,
}
STATE = ("position", "velocity", "density", "mass", "level", "stash", "has_level",
         "flag_is_fluid_surface", "flag_insufficient_neighs")


def reference_run(params, scene: dict, steps, t_end):
    """(alive state arrays, per-step diag arrays) of the JAX list run."""
    from adaptive_sph_torch import convert
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation
    from adaptive_sph_tpu.utils import params as j_params

    sim = create_simulation(j_params.params_from_dict(convert.params_to_dict(params)),
                            j_scene.scene_from_dict(scene))
    if sim.backend != "lists":
        raise AssertionError(f"the JAX package took backend {sim.backend!r}")
    per_step = {k: [] for k in PER_STEP}
    k = 0
    while (k < steps) if steps is not None else (sim.time < t_end):
        d = sim.step()
        d = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
        for name in PER_STEP:
            per_step[name].append(np.asarray(d.get(name, 0)).item())
        k += 1
    alive = np.asarray(sim.state.alive)
    state = {name: np.asarray(getattr(sim.state, name))[alive] for name in STATE}
    return state, {name: np.asarray(v, PER_STEP[name]) for name, v in per_step.items()}


def main():
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.stress import list_runs

    out = {}
    for name, (params, scene, steps, t_end) in list_runs().items():
        state, per_step = reference_run(params, scene, steps, t_end)
        for k, v in {**per_step, **state}.items():
            out[f"{name}/{k}"] = v
        print(f"{name}: {len(per_step['n'])} steps, n = {per_step['n'][-1]}, "
              f"capacity {per_step['capacity'][-1]}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B)")


if __name__ == "__main__":
    main()
