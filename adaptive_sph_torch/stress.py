"""The ratio-stress-test configuration of bench.py, and a profiler for its step.

`stress_scene()` and `stress_params(bench)` rebuild bench.py's scene (n =
11,835, 50:1 radius ratio) and parameters for the port. bench=False gives the
parity options (f32 pair weights, cold-start solves, momentum 0); bench=True
the bench options (bf16 pair storage, warm start, momentum 0.9).

    python -m adaptive_sph_torch.stress [--bench] [--steps 20] [--trace OUT.json]

profiles the step on a CUDA GPU: warm-up, then `--steps` steps under
torch.profiler; prints ms/step (host clock, synchronised), the device-busy
share of that wall time and the kernels by total device time.
"""

from __future__ import annotations

import argparse
import subprocess
import time

from .models import scene as scene_mod
from .utils.params import SimulationParams


def stress_scene():
    return scene_mod.scene_from_dict({
        "boundary": {"type": "box", "width": 2, "height": 2},
        "blocks": [
            {"pos": [0.4, -0.5], "size": [0.55, 1.4], "spacing": 0.4,
             "volume_fill_ratio": 0.93, "velocity": [0, 0]},
            {"pos": [-0.95, -0.5], "size": [0.55, 1.4], "spacing": 0.008,
             "volume_fill_ratio": 0.93, "velocity": [0, 0]},
        ],
    })


def stress_params(bench: bool) -> SimulationParams:
    return SimulationParams(
        merging=False, sharing=False, splitting=False, max_iters=200,
        hybrid_dfsph_max_avg_density_error=0.001,
        hybrid_dfsph_max_avg_divergence_error=0.0001,
        hybrid_dfsph_factor=1000000.0, cfl_factor=0.3, max_dt=0.003,
        warm_start_pressure=bench, weight_cache_bf16=bench,
        jacobi_momentum=0.9 if bench else 0.0,
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", action="store_true", help="bench options instead of parity")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .runner import create_simulation

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sim = create_simulation(stress_params(args.bench), stress_scene(), device="cuda",
                            counters_enabled=False)
    for _ in range(10):
        sim.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        diags = sim.step_chunk(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{'bench' if args.bench else 'parity'}: {wall / args.steps * 1e3:.4f} ms/step "
          f"(profiled), device busy {dev_us / 1e3 / (wall * 1e3):.3f} of wall, "
          f"div iters {diags['div_iterations']}, density iters {diags['density_iterations']}")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
