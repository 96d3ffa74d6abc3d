"""Offline image and video export: the `image` subcommand.

Counterpart of adaptive_sph_tpu/utils/animation.py. Each entry of an export
list (a YAML list, e.g. configs/media/*.yaml) layers `update_attributes` on
its `config_path`, builds its scene, runs the simulation to `time` and writes
`png_file` next to the list: one PNG, or with `video_start_time` a video of
frames at `video_fps` x `video_speed`. Paths in the list are relative to the
list's directory.

On the tile backend, frames of a video and every export with resampling run
the two-phase step (`Simulation.step_physics`, the frames of the step's
window, then `Simulation.step_adaptivity`), so the census never changes
inside an interpolation window; frame positions are interpolated linearly
between the start-of-step positions (`pos_prev`, in the step's output order)
and the step's result. Both phases run under the runner's overflow, growth
and panic checks. The list backend keeps the fused step, as the reference's
does, and interpolates a frame only when the step left the census alone (no
share, merge or split, the same count): it keeps the particle order, so the
start-of-step positions line up with the result.

The video is an mp4 through imageio's libx264 writer; where imageio or the
encoder is missing, the frames are written as numbered PNGs into
`<png_file without extension>-frames/`.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import yaml

from ..models import scene as scene_mod
from ..runner import create_simulation
from . import render as render_mod
from . import stats as stats_mod
from .colors import (
    VisualizationParams,
    VisualizedAttribute,
    colors_for_particles,
    get_color_map,
    get_color_map_for_pressure,
)
from .params import load_params
from .snapshot import take_snapshot


@dataclasses.dataclass
class ExportRun:
    """What one entry of an export list did."""

    png_file: str  # the path written (the PNG, the video, or its frames' stem)
    steps: int  # physics steps taken
    frames: int  # images rendered
    adaptivity_steps: int  # two-phase resampling steps between frames
    step_seconds: float  # wall time in the steps (both phases)
    render_seconds: float  # wall time in snapshots, colours and render2d
    n: int  # particles at the end
    position: np.ndarray  # (n, 2) final positions of the alive particles
    counters: stats_mod.Counters  # the simulation's counters (the .stat file's source)


def export_simulation_images(config_paths: list, device="cuda") -> list:
    """Runs every entry of every export list; returns their ExportRuns."""
    runs = []
    for config_path in config_paths:
        config_path = os.path.abspath(config_path)
        base_dir = os.path.dirname(config_path)
        with open(config_path) as f:
            export_configs = yaml.safe_load(f)
        for cfg in export_configs:
            runs.append(_export_one(cfg, base_dir, device))
    return runs


def _export_one(cfg: dict, base_dir: str, device) -> ExportRun:
    params = load_params(os.path.join(base_dir, cfg["config_path"]),
                         update_attributes=cfg.get("update_attributes") or {})
    if cfg.get("scene") is not None:
        scene = scene_mod.scene_from_dict(cfg["scene"])
    elif cfg.get("scene_file"):
        scene = scene_mod.load_scene(os.path.join(base_dir, cfg["scene_file"]))
    else:
        raise ValueError("expected either 'scene' or 'scene_file'")

    viz_dict = dict(cfg.get("visualization_params") or {})
    # some export lists carry `visualized_attribute` at the entry's top level
    # (an older schema); it counts where visualization_params has none
    if "visualized_attribute" in cfg and "visualized_attribute" not in viz_dict:
        viz_dict["visualized_attribute"] = cfg["visualized_attribute"]
    viz = VisualizationParams.from_dict(viz_dict)
    if viz.visualized_attribute == VisualizedAttribute.Distance or viz.show_flag_is_fluid_surface:
        params = params.replace(force_level_estimation=True)
    if viz.visualized_attribute in (VisualizedAttribute.ConstantField,
                                    VisualizedAttribute.NeighborCount):
        params = params.replace(force_diagnostic_fields=True)
    sim = create_simulation(params, scene, device=device)

    target_time = float(cfg["time"])
    video = None
    if cfg.get("video_start_time") is not None:
        video = dict(start=float(cfg["video_start_time"]), end=target_time,
                     fps=float(cfg.get("video_fps") or 60.0),
                     speed=float(cfg.get("video_speed") or 1.0))
    time_for_next_export = video["start"] if video else target_time
    img_w = int(cfg.get("image_width") or 2000)
    img_h = int(cfg.get("image_height") or 2000)
    zoom_out = float(cfg.get("zoom_out") or 1.04)
    out_path = os.path.join(base_dir, cfg["png_file"])
    frames = []
    resampling = sim.params.splitting or sim.params.merging or sim.params.sharing
    two_phase = sim.backend == "tiles" and (resampling or video is not None)
    steps = adaptivity_steps = 0
    step_s = render_s = 0.0

    done = False
    while not done:
        time_before = sim.time
        t0 = time.perf_counter()
        identity_stable = True
        if two_phase:
            diag = sim.step_physics()
            pos_before = diag["pos_prev"]
        else:
            # the fused step: without frames, or on the list backend
            if video is not None:
                pos_before, n_before = sim.state.position, sim.num_fluid_particles
            diag = sim.step()
            if video is not None:
                identity_stable = sim.num_fluid_particles == n_before and not any(
                    diag.get(k, 0) for k in ("merge_or_split_count", "merges", "splits",
                                             "shares"))
        step_s += time.perf_counter() - t0
        steps += 1

        if cfg.get("panic_on_end") and sim.time > target_time:
            raise RuntimeError(">>>>>>>>>>>> REACHED END BEFORE EXPORT <<<<<<<<<<<<")

        while time_for_next_export <= sim.time:
            t0 = time.perf_counter()
            snap = take_snapshot(sim.state, sim.params)
            legend = None
            max_pressure = None
            if viz.visualized_attribute == VisualizedAttribute.Pressure:
                max_pressure = float(snap["pressure"].max()) * 0.9
            if not cfg.get("no_legend"):
                if viz.visualized_attribute == VisualizedAttribute.Pressure:
                    cm = get_color_map_for_pressure(float(snap["pressure"].max()))
                else:
                    cm = get_color_map(viz.visualized_attribute, sim.params)
                if cm is not None:
                    legend = dict(color_map=cm, text_right=bool(cfg.get("legend_text_right")),
                                  only_min_max=bool(cfg.get("legend_only_min_max")))

            positions = snap["position"]
            if video is not None and sim.time > time_before and identity_stable:
                # linear interpolation across the step, whose census is
                # unchanged inside its window
                interp = (time_for_next_export - time_before) / (sim.time - time_before)
                interp = float(np.clip(interp, 0.0, 1.0))
                full = interp * sim.state.position + (1.0 - interp) * pos_before
                positions = full[sim.state.alive].cpu().numpy()

            colors = colors_for_particles(snap, sim.params, viz, max_pressure)
            img = render_mod.render2d(positions, snap["mass"], sim.params.rest_density, colors,
                                      sim.boundary_handler, img_w, img_h, legend,
                                      cfg.get("title"), zoom_out)
            render_s += time.perf_counter() - t0
            frames.append(img)
            if video is not None:
                time_for_next_export += 1.0 / video["fps"] * video["speed"]
                if sim.time > video["end"]:
                    out_path = _write_video(frames, out_path, video["fps"])
                    done = True
                    break
            else:
                render_mod.save_png(img, out_path)
                done = True
                break

        if two_phase and not done:
            # resample only after the step's frames
            t0 = time.perf_counter()
            sim.step_adaptivity(diag["dt"])
            step_s += time.perf_counter() - t0
            adaptivity_steps += 1

    if cfg.get("output_stats"):
        with open(os.path.join(base_dir, cfg["png_file"] + ".stat"), "w") as f:
            f.write(stats_mod.write_statistics(sim.counters))
    alive = sim.state.alive
    return ExportRun(png_file=out_path, steps=steps, frames=len(frames),
                     adaptivity_steps=adaptivity_steps, step_seconds=step_s,
                     render_seconds=render_s, n=sim.num_fluid_particles,
                     position=sim.state.position[alive].cpu().numpy(), counters=sim.counters)


def _write_video(frames: list, path: str, fps: float) -> str:
    """The frames as an mp4 at `path` through imageio's libx264 writer, or,
    where imageio or the encoder is missing, as numbered PNGs in
    `<path without extension>-frames/`; returns what was written."""
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames, fps=int(round(fps)), codec="libx264", quality=8)
        return path
    except (ImportError, RuntimeError, OSError, ValueError):
        base, _ = os.path.splitext(path)
        os.makedirs(base + "-frames", exist_ok=True)
        for i, fr in enumerate(frames):
            render_mod.save_png(fr, os.path.join(base + "-frames", f"file-{i:06d}.png"))
        return base + "-frames"
