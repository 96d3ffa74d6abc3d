"""Command line of the port: `python -m adaptive_sph_torch run <config> <scene>`.

Counterpart of the `run` subcommand of adaptive_sph_tpu/cli.py with its
options --max-seconds, --max-steps, --overwrite-config-file and -p
(statistics), plus --device (default cuda; without a CUDA device only
--device cpu runs). Prints INIT <n> FLUID PARTICLES, one line per step and,
with -p, the counters in the reference's .stat format. VTK, PNG, web,
checkpoint and live-tuning options are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="adaptive_sph_torch",
                                     description="adaptive SPH, PyTorch + CUDA port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="run a simulation with the given config and scene")
    p_run.add_argument("simulation_config")
    p_run.add_argument("scene_config")
    p_run.add_argument("--max-seconds", "-s", type=float, default=None,
                       help="stop at this simulated time")
    p_run.add_argument("--max-steps", type=int, default=10**9)
    p_run.add_argument("--overwrite-config-file", "-c", default=None)
    p_run.add_argument("--statistics-enabled", "-p", action="store_true")
    p_run.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return cmd_run(args)


def cmd_run(args):
    from .models import scene as scene_mod
    from .runner import SimulationFailed, create_simulation
    from .utils import stats as stats_mod
    from .utils.params import load_params

    params = load_params(args.simulation_config, overwrite_path=args.overwrite_config_file)
    scene = scene_mod.load_scene(args.scene_config)
    sim = create_simulation(params, scene, counters_enabled=True, device=args.device)
    print(f"INIT {sim.num_fluid_particles} FLUID PARTICLES")
    step = 0
    try:
        while step < args.max_steps:
            diag = sim.step()
            step += 1
            print(f"step {step:05d} t={sim.time:.4f}s dt={diag['dt'] * 1000:.3f}ms "
                  f"n={sim.num_fluid_particles} div-iters={diag['div_iterations']} "
                  f"density-iters={diag['density_iterations']}")
            if args.max_seconds is not None and sim.time >= args.max_seconds:
                break
    except SimulationFailed as e:
        print(f"SIMULATION FAILED: {e}", file=sys.stderr)
        return 2
    finally:
        if args.statistics_enabled:
            print(stats_mod.write_statistics(sim.counters), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
