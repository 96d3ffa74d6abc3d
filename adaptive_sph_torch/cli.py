"""Command line of the port: `python -m adaptive_sph_torch run|image|generate-split-patterns ...`.

Counterpart of adaptive_sph_tpu/cli.py's three subcommands, with --device on
each (default cuda; without a CUDA device only --device cpu runs):

  run <config> <scene> [--max-seconds S] [--max-steps N]
      [--overwrite-config-file F] [-p] [--statistics-path F]
      [--vtk-dir DIR] [--vtk-every K] [--snapshot-png F]
      [--web-dir DIR] [--web-every K] [--checkpoint F.npz] [--resume F.npz]
      [--watch-config F]
  image <export-list.yaml>[,<more>] [...]
  generate-split-patterns [out.yaml] [--max-children N] [--svg-dir DIR]

`run` prints INIT <n> FLUID PARTICLES, one line per step and, with -p, the
counters in the reference's .stat format (with `profile_stages: true` in the
config, after the run's steps, the reference's per-section times,
utils/profiling.py). `image` writes each entry's png_file next to its export
list and prints one line per entry. `generate-split-patterns` writes the
patterns for 2..N children (default 60) in the reference's YAML schema and
prints one line per pattern with its attempts and seconds.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


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
    p_run.add_argument("--statistics-path", "-w", default=None,
                       help="with -p, also write the statistics to this file")
    p_run.add_argument("--vtk-dir", default=None, help="export VTK snapshots to this dir")
    p_run.add_argument("--vtk-every", type=int, default=1)
    p_run.add_argument("--snapshot-png", default=None, help="render the final state to PNG")
    p_run.add_argument("--web-dir", default=None,
                       help="export a browser viewer (HTML + frames)")
    p_run.add_argument("--web-every", type=int, default=2)
    p_run.add_argument("--checkpoint", default=None, help="save the final state to this .npz")
    p_run.add_argument("--resume", default=None, help="resume from a .npz checkpoint")
    p_run.add_argument("--watch-config", default=None,
                       help="poll this overwrite-config YAML every step and apply its "
                            "changes to the running simulation")
    p_run.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p_img = sub.add_parser("image", help="offline image / video export")
    p_img.add_argument("export_configs", nargs="+")
    p_img.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p_gen = sub.add_parser("generate-split-patterns", help="precompute split patterns")
    p_gen.add_argument("output_yaml", nargs="?", default="./split-patterns.yaml")
    p_gen.add_argument("--max-children", type=int, default=60)
    p_gen.add_argument("--svg-dir", default=None, help="also write one debug SVG per pattern")
    p_gen.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.cmd == "image":
        return cmd_image(args)
    if args.cmd == "generate-split-patterns":
        return cmd_generate_split_patterns(args)
    return cmd_run(args)


def cmd_generate_split_patterns(args):
    from .utils.split_patterns import export_pattern_svg, generate_split_patterns, save_patterns

    def log(n, attempts, seconds):
        print(f"pattern {n}: {attempts} attempts, {seconds:.2f} s "
              f"({seconds / attempts:.2f} s per attempt)", flush=True)

    patterns = generate_split_patterns(args.max_children, device=args.device, log=log)
    save_patterns(patterns, args.output_yaml)
    print(f"Wrote {len(patterns)} patterns to {args.output_yaml}")
    if args.svg_dir:
        os.makedirs(args.svg_dir, exist_ok=True)
        for p in patterns:
            export_pattern_svg(p, os.path.join(args.svg_dir, f"split-{len(p['pos_s'])}.svg"))
        print(f"Wrote {len(patterns)} SVGs to {args.svg_dir}")
    return 0


def cmd_image(args):
    from .utils.animation import export_simulation_images

    # comma-separated lists count as several
    paths = [p for arg in args.export_configs for p in arg.split(",")]
    for r in export_simulation_images(paths, device=args.device):
        print(f"wrote {r.png_file}: {r.steps} steps, {r.frames} frames, n={r.n}, "
              f"{r.step_seconds * 1e3 / max(r.steps, 1):.3f} ms/step, "
              f"{r.render_seconds * 1e3 / max(r.frames, 1):.1f} ms per frame rendered")
    return 0


def _watched_params(args, mtime):
    """(params, mtime) when the watched file changed since mtime (a file that
    does not parse keeps the old parameters), else (None, mtime)."""
    import yaml

    from .utils.params import load_params

    m = os.path.getmtime(args.watch_config) if os.path.exists(args.watch_config) else 0.0
    if m == mtime:
        return None, mtime
    try:
        with open(args.watch_config) as f:
            edits = yaml.safe_load(f) or {}
        # the whole layer stack: the config, --overwrite-config-file, then the edits
        return load_params(args.simulation_config, overwrite_path=args.overwrite_config_file,
                           update_attributes=edits), m
    except (OSError, yaml.YAMLError, TypeError, ValueError, KeyError) as e:
        print(f"live params reload failed (keeping old): {e}", file=sys.stderr)
        return None, m


def cmd_run(args):
    from .models import scene as scene_mod
    from .ops.kernels import PI
    from .runner import SimulationFailed, create_simulation
    from .utils import stats as stats_mod
    from .utils.colors import VisualizationParams, colors_for_particles
    from .utils.params import load_params
    from .utils.render import boundary_segments
    from .utils.snapshot import take_snapshot

    params = load_params(args.simulation_config, overwrite_path=args.overwrite_config_file)
    scene = scene_mod.load_scene(args.scene_config)
    sim = create_simulation(params, scene, counters_enabled=True, device=args.device)
    print(f"INIT {sim.num_fluid_particles} FLUID PARTICLES")

    if args.resume:
        from .runner import pad_state_to
        from .utils.checkpoint import load_state

        # at the checkpoint's own capacity (a run may have grown it), at
        # least the scene's
        state = load_state(args.resume, device=sim.device)
        if state.capacity < sim.state.capacity:
            state = pad_state_to(state, sim.state.capacity)
        sim.load_state(state)
        print(f"resumed from {args.resume} at t={sim.time:.4f}s n={sim.num_fluid_particles}")

    vtk = web = None
    if args.vtk_dir:
        from .utils.vtk import VtkExporter

        vtk = VtkExporter(args.vtk_dir, "adaptive-sph-torch")
    if args.web_dir:
        from .utils.web_export import WebExporter

        web = WebExporter(args.web_dir, scene_width=2.0)
        web.set_boundary_segments(boundary_segments(sim.boundary_handler))
    watch_mtime = None
    if args.watch_config:
        watch_mtime = (os.path.getmtime(args.watch_config)
                       if os.path.exists(args.watch_config) else 0.0)

    step = 0
    try:
        while step < args.max_steps:
            if args.watch_config:
                new_params, watch_mtime = _watched_params(args, watch_mtime)
                if new_params is not None:
                    sim.update_params(new_params)
                    print(f"live params reloaded from {args.watch_config}")
            diag = sim.step()
            step += 1
            line = (f"step {step:05d} t={sim.time:.4f}s dt={float(diag['dt']) * 1000:.3f}ms "
                    f"n={sim.num_fluid_particles}")
            # each solver sets only the counts of the solves it runs
            if "div_iterations" in diag:
                line += f" div-iters={int(diag['div_iterations'])}"
            if "density_iterations" in diag:
                line += f" density-iters={int(diag['density_iterations'])}"
            print(line)
            if vtk is not None and step % args.vtk_every == 0:
                vtk.add_snapshot(sim.time, take_snapshot(sim.state),
                                 boundary_segments(sim.boundary_handler))
            if web is not None and step % args.web_every == 0:
                snap = take_snapshot(sim.state, sim.params)
                colors = colors_for_particles(snap, sim.params, VisualizationParams())
                # float32 volumes, as the reference computes them
                radii = np.sqrt(snap["mass"] / sim.params.rest_density / PI)
                web.add_frame(sim.time, snap["position"], radii, (colors * 255).astype("uint8"))
            if args.max_seconds is not None and sim.time >= args.max_seconds:
                break
    except SimulationFailed as e:
        print(f"SIMULATION FAILED: {e}", file=sys.stderr)
        return 2
    finally:
        if web is not None:
            web.finalize()
            print(f"web viewer written to {args.web_dir}/index.html")
        if args.checkpoint:
            from .utils.checkpoint import save_state

            save_state(args.checkpoint, sim.state)
        if args.statistics_enabled:
            if sim.params.profile_stages:
                from .utils.profiling import profile_sections

                profile_sections(sim)
            s = stats_mod.write_statistics(sim.counters)
            print(s, end="")
            if args.statistics_path:
                with open(args.statistics_path, "w") as f:
                    f.write(s)
        if args.snapshot_png:
            from .utils.render import render2d, save_png

            snap = take_snapshot(sim.state, sim.params)
            colors = colors_for_particles(snap, sim.params, VisualizationParams())
            save_png(render2d(snap["position"], snap["mass"], sim.params.rest_density, colors,
                              sim.boundary_handler), args.snapshot_png)
    return 0


if __name__ == "__main__":
    sys.exit(main())
