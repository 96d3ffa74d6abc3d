"""Readings for the limits of `correct`, in one process on the card.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 21 22 23] [--seconds 4] [--trace-first] [--out FILE]

Runs the cell (benchlib/harness.py) once per seed with the program as the
configuration states it, and once per control seed with the program's own
lower precision switched on (`weight_cache_bf16`: bf16 pair storage), each
with a short window, and prints every run's numbers compared, its metrics
and its counts as one JSON line; --out also writes them all to FILE. The
lower reading of a number is the largest over the program's seeds, its
upper reading the smallest over the control's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.append(str(HERE.parent.parent))

CONTROL = {"weight_cache_bf16": True}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--trace-first", action="store_true", help="trace the first program run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from benchlib import harness

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    rows = []
    runs = [(s, None) for s in args.seeds] + [(s, CONTROL) for s in args.control_seeds]
    for i, (seed, over) in enumerate(runs):
        t0 = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, args.trace_first and i == 0,
                          overrides=over, t_start=t0)
        row = {"workload": args.workload, "seed": seed, "control": over is not None,
               "numbers": out["readings"],
               "attempted": out["attempted"], "failed": out["failed"],
               "metrics": {k: m["value"] for k, m in out["metrics"].items()},
               "device": out["device"], "breakdown": out.get("breakdown"),
               "run_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    prog = [r for r in rows if not r["control"]]
    ctrl = [r for r in rows if r["control"]]
    for name in sorted({k for r in rows for k in r["numbers"]}):
        lo = max((r["numbers"].get(name) or 0.0 for r in prog), default=None)
        hi = min((r["numbers"].get(name) for r in ctrl if r["numbers"].get(name) is not None),
                 default=None)
        print(f"{name}: program's largest {lo!r}, control's smallest {hi!r}", file=sys.stderr)


if __name__ == "__main__":
    main()
