"""Device times of the default dam break's pair sweeps and of the steps
that run the port's tile walk (K1 pair_build, pair_sweep), on one CUDA GPU.

    python scripts/torch_port_walk_times.py [--root DIR] [--out FILE]

`--root DIR` imports adaptive_sph_torch from DIR (a checkout of another
commit, with its own kernels), so two commits can be measured in one
call on one card, in turns: parent, change, change, parent. Prints the
card's name and power limit, one line per measurement and, last, one JSON
object of them all (also written to FILE with --out).

Measured (torch.profiler device time per call, the mean of 20 calls; the
walks on the stress layouts, K1 in each mode and the DENSITY sweep, are
timed by chip_smoke.py phase 2f):
  - the nine pair_sweep ops of the default dam break's first step, on the
    inputs that step gives them;
  - the stress x1 step (parity options): ms/step over 30 steps after 10
    warm-up steps (host clock, synchronised), then device ms/step over 10
    profiled steps; the same on the resident (classic) branch;
  - the default dam break: ms/step over its first 100 steps, then 10
    profiled steps: device ms/step and pair_sweep's share of it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adaptive_sph_torch.models import adaptivity, scene, tile_step
    from adaptive_sph_torch.ops import sweeps
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.utils.params import load_params

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_walk_times: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(f"package: {root}", flush=True)
    out = {"card": card, "root": root}

    def put(key, value):
        out[key] = value
        print(f"{key}: {value:.4f} ms", flush=True)

    # the dam break's first-step sweeps, on the inputs that step gives them
    config = os.path.join(root, "configs", "default-config.yaml")
    scene_file = os.path.join(root, "configs", "default-scene.yaml")
    sim = create_simulation(load_params(config), scene.load_scene(scene_file), device="cuda",
                            counters_enabled=False)
    captured = {}
    real = sweeps.pair_sweep

    def spy(*a):
        captured.setdefault(a[4].name, tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real(*a)

    tile_step.pair_sweep = adaptivity.pair_sweep = spy
    try:
        sim.step()
    finally:
        tile_step.pair_sweep = adaptivity.pair_sweep = real
    for name, a in sorted(captured.items()):
        put(f"dam-break pair_sweep {name}", device_ms(lambda a=a: real(*a), 20, "pair_sweep_kernel"))
    del sim
    torch.cuda.empty_cache()

    def profiled(sim, steps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sim.step_chunk(steps)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in ev)
        sweep = sum(e.self_device_time_total for e in ev if "pair_sweep_kernel" in e.key)
        return total / 1e3 / steps, sweep / max(total, 1e-30)

    for tag, p in (("stress x1 parity", stress_params()),
                   ("stress x1 resident", stress_params(resident=True))):
        sim = create_simulation(p, stress_scene(), device="cuda", counters_enabled=False)
        sim.step_chunk(10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step_chunk(30)
        torch.cuda.synchronize()
        put(f"{tag} ms/step", (time.perf_counter() - t0) / 30 * 1e3)
        put(f"{tag} device ms/step", profiled(sim, 10)[0])
        del sim
        torch.cuda.empty_cache()

    sim = create_simulation(load_params(config), scene.load_scene(scene_file), device="cuda",
                            counters_enabled=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step_chunk(100)
    torch.cuda.synchronize()
    put("dam break ms/step (steps 1-100)", (time.perf_counter() - t0) / 100 * 1e3)
    dev, share = profiled(sim, 10)
    put("dam break device ms/step (steps 101-110)", dev)
    out["dam break pair_sweep share of device time"] = share
    print(f"dam break pair_sweep share of device time: {share:.4f}", flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
