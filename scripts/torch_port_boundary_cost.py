"""The cost of configs/media/boundary-handling.yaml's two entries on the PyTorch port.

The file's entries differ only in the boundary: entry 1 is the box as four
planes (AnalyticOverestimate), entry 2 the box as one polygon
(AnalyticUnderestimate). On the card (the default):

    python scripts/torch_port_boundary_cost.py [--steps 50]

runs each entry through `run -p` (adaptive_sph_torch.cli; a copy of its
configuration with `profile_stages: true`, written to a temporary
directory) for --steps steps, which prints one line per step (n, dt,
iterations) and the statistics with the per-section times; then, per entry,
the wall time per step of that run and the time of one boundary update
(`update_after_advect`, the SDF probes and gradients, and the solver terms)
on the final state, synchronised, the median of 21.

On the CPU, with the JAX package:

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_boundary_cost.py --jax-steps 6

runs entry 2 through both packages side by side and prints, per step, the
census, both solves' iteration counts and the populated grid levels of each.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIST = "configs/media/boundary-handling.yaml"
ENTRIES = {1: "AnalyticOverestimate (four planes)", 2: "AnalyticUnderestimate (one polygon)"}


def entry(index: int):
    """(params, scene dict) of the list's entry `index` (1-based)."""
    from adaptive_sph_torch.stress import media_run

    return media_run(LIST, index - 1)


def boundary_update_ms(sim, reps: int = 21) -> float:
    """Median ms of one boundary update of `sim`'s handler on its state."""
    import torch

    from adaptive_sph_torch.models import boundary as bnd

    st = sim.state
    h = torch.clamp(st.h, min=1e-6)

    def once():
        bt = sim.boundary_handler.update_after_advect(st.position, h, sim.params)
        bnd.solver_terms(bt, st.position, h, sim.params)

    times = []
    for _ in range(reps + 1):
        if st.position.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        once()
        if st.position.is_cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def on_card(steps: int):
    import torch
    import yaml

    from adaptive_sph_torch import cli, convert
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import card

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device (or --jax-steps on the CPU)")
    print(card(), flush=True)
    tmp = tempfile.mkdtemp(prefix="asph_boundary_cost_")
    for index, label in ENTRIES.items():
        params, scene = entry(index)
        cfg, scn = os.path.join(tmp, f"config{index}.yaml"), os.path.join(tmp, f"scene{index}.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump({**convert.params_to_dict(params), "profile_stages": True}, f)
        with open(scn, "w") as f:
            yaml.safe_dump(scene, f)
        print(f"== entry {index}: {label}, run -p --max-steps {steps}", flush=True)
        t0 = time.perf_counter()
        cli.main(["run", cfg, scn, "-p", "--max-steps", str(steps), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sim = create_simulation(params, scene_mod.scene_from_dict(scene), device="cuda",
                                counters_enabled=False)
        for _ in range(steps):
            sim.step()
        print(f"entry {index} ({label}): {wall:.1f} s for the run (its {steps} steps, the "
              f"profiled sections' 16 steps and the set-up), n={sim.num_fluid_particles} "
              f"after {steps} steps, one boundary update {boundary_update_ms(sim):.3f} ms",
              flush=True)


def against_jax(steps: int):
    from adaptive_sph_torch import convert
    from adaptive_sph_torch.models import scene as t_scene
    from adaptive_sph_torch.runner import create_simulation as t_create
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation as j_create
    from adaptive_sph_tpu.utils import params as j_params

    params, scene = entry(2)
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                  j_scene.scene_from_dict(scene))
    ts = t_create(params, t_scene.scene_from_dict(scene), device="cpu")
    print(f"entry 2 ({ENTRIES[2]}): JAX n={js.num_fluid_particles}, port "
          f"n={ts.num_fluid_particles}", flush=True)
    for k in range(1, steps + 1):
        dj, dt_ = js.step(), ts.step()

        def its(d):
            return (int(d.get("div_iterations", -1)), int(d.get("density_iterations", -1)))

        print(f"step {k}: n {js.num_fluid_particles} / {ts.num_fluid_particles}, (div, density) "
              f"iterations {its(dj)} / {its(dt_)}, populated levels {js.tile_cfg.populated} / "
              f"{ts.tile_cfg.populated}, capacity {js.state.capacity} / {ts.state.capacity}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--jax-steps", type=int, default=0,
                    help="compare entry 2 with the JAX package on the CPU over this many steps")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.jax_steps:
        against_jax(args.jax_steps)
    else:
        on_card(args.steps)


if __name__ == "__main__":
    main()
