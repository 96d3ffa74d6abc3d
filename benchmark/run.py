"""The benchmark of adaptive_sph_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Runs one cell of BENCHMARK.json on the card
(benchlib/harness.py): set-up, the warm episode, the measured window,
with --trace 1 the traced steps, then the comparison with the plain
reference. Prints the card, the shapes and the timings on standard error,
each number that decides `correct` beside its limit as the last lines
there, and one JSON line as the last line of standard output. Without a
CUDA device, or with fewer than the cell asks for, it exits with 2 and
prints no result; if a module of JAX or of the JAX package is loaded once
the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path.append(str(ROOT))  # the program, after the benchmark's own modules

    from benchlib.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    # the configuration's host threads, before numpy and torch start their pools
    threads = spec.config(cell["config"])["assumed"]["host_threads"]
    os.environ["OMP_NUM_THREADS"] = str(int(threads))

    from benchlib import harness
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec,
                          t_start=T_START)
    except Exception:  # noqa: BLE001 - any failure of the run means no result
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or of the JAX package are loaded: {', '.join(bad)}")
        return 3
    out.pop("readings", None)  # logged above; `checks` is the line's last key
    out = _finite(out)
    for name, c in out["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
