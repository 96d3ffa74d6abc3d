"""Where the window's long steps go, in one process on the card.

    python3 benchmark/tools/stalls.py --workload <cell> --seed <n> --seconds <s> \
        [--threads N] [--over-ms 150] [--out FILE]

Builds the cell and runs its warm episodes as a run does (benchlib/
harness.py), then steps episode after episode for --seconds, the collector
off as in the window. Per step it records the wall time, the main thread's
CPU time and context switches (getrusage), and the caching allocator's
cudaMalloc and retry counts; a watchdog thread samples the main thread's
Python stack every 10 ms while a step has lasted longer than --over-ms.
Prints the slowest steps with their place in the episode and their samples,
and the mean step time by the step's index in the episode; --out writes
every step's record as JSON. --threads overrides the configuration's
host_threads.
"""

import argparse
import gc
import json
import os
import resource
import sys
import threading
import time
import traceback
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.append(str(HERE.parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--over-ms", type=float, default=150.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from benchlib.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    threads = args.threads or spec.config(cell["config"])["assumed"]["host_threads"]
    os.environ["OMP_NUM_THREADS"] = str(threads)

    import torch

    from benchlib import harness

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.set_num_threads(threads)
    c = harness.setup(spec, args.workload, args.seed, "cuda")
    eps = c.eps
    eps.warm_up()
    torch.cuda.synchronize()

    main_id = threading.get_ident()
    cur = {"i": None, "t0": 0.0}
    samples = {}
    done = threading.Event()
    over = args.over_ms * 1e-3

    def watch():
        while not done.wait(0.01):
            i, t0 = cur["i"], cur["t0"]
            if i is None or time.perf_counter() - t0 < over:
                continue
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            stack = traceback.extract_stack(frame)[-6:]
            key = " < ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}"
                             for f in reversed(stack))
            samples.setdefault(i, Counter())[key] += 1

    def alloc():
        s = torch.cuda.memory_stats()
        return s.get("segment.all.allocated", 0), s.get("num_alloc_retries", 0)

    dog = threading.Thread(target=watch, daemon=True)
    dog.start()
    rows = []
    eps.restore()
    gc.collect()
    gc.disable()
    t_w0 = time.perf_counter()
    while time.perf_counter() < t_w0 + args.seconds:
        ep, k = eps.episodes, eps.ep_step if eps.ep_step < eps.E else 0
        r0 = resource.getrusage(resource.RUSAGE_THREAD)
        a0 = alloc()
        cur["t0"] = time.perf_counter()
        cur["i"] = len(rows)
        _, _, d, failed = eps.step()
        t1 = time.perf_counter()
        cur["i"] = None
        r1 = resource.getrusage(resource.RUSAGE_THREAD)
        a1 = alloc()
        rows.append({"at_s": cur["t0"] - t_w0, "wall_ms": (t1 - cur["t0"]) * 1e3,
                     "cpu_ms": (r1.ru_utime + r1.ru_stime - r0.ru_utime - r0.ru_stime) * 1e3,
                     "invol_switches": r1.ru_nivcsw - r0.ru_nivcsw,
                     "vol_switches": r1.ru_nvcsw - r0.ru_nvcsw,
                     "cuda_mallocs": a1[0] - a0[0], "alloc_retries": a1[1] - a0[1],
                     "episode": ep, "episode_step": k, "failed": failed,
                     "sweeps": (d or {}).get("density_iterations", 0)
                     + (d or {}).get("div_iterations", 0),
                     "wavefront": (d or {}).get("wavefront_sweeps", 0),
                     "n": (d or {}).get("particle_count", 0)})
    done.set()
    gc.enable()
    window = time.perf_counter() - t_w0
    walls = sorted(r["wall_ms"] for r in rows)
    p50 = walls[len(walls) // 2]
    print(f"{args.workload} seed {args.seed} threads {threads}: {len(rows)} steps in "
          f"{window:.3f} s, p50 {p50:.2f} ms, max {walls[-1]:.2f} ms, "
          f"{sum(w > 5 * p50 for w in walls)} steps over 5x p50", file=sys.stderr)
    slow = sorted(range(len(rows)), key=lambda i: -rows[i]["wall_ms"])[:15]
    for i in slow:
        r = rows[i]
        print(f"step {i}: {json.dumps(r)}", file=sys.stderr)
        for key, n in samples.get(i, Counter()).most_common(3):
            print(f"    {n} x {key}", file=sys.stderr)
    by = {}
    for r in rows:
        b = r["episode_step"]
        b = "0" if b == 0 else "1-7" if b < 8 else "8-63" if b < 64 else "64+"
        by.setdefault(b, []).append(r["wall_ms"])
    print("mean ms by episode step: " + ", ".join(
        f"{b} {sum(v) / len(v):.2f} ({len(v)})" for b, v in sorted(by.items())), file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "seed": args.seed,
                                              "threads": threads, "window_s": window,
                                              "steps": rows,
                                              "samples": {str(k): dict(v)
                                                          for k, v in samples.items()}}))


if __name__ == "__main__":
    main()
