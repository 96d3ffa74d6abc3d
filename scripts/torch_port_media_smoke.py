"""Smoke-run every export list of configs/media/ through the port's image export.

The port's counterpart of scripts/smoke_media.py: each entry of each export
list goes through adaptive_sph_torch.utils.animation with its time clipped to
--time (a video starting at 0 at 30 fps), a 160 x 160 image, and its
png_file moved into a temporary directory, so nothing is written beside the
lists. Prints one OK / FAIL line per entry (steps, particles, seconds) and
exits non-zero if any entry failed.

    python scripts/torch_port_media_smoke.py [--time 0.02] [--only NAME ...] [--device cpu]

(On the card ~2 min; on the CPU tens of minutes.)
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile
import time

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEDIA = os.path.join(ROOT, "configs", "media")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", type=float, default=0.02)
    ap.add_argument("--only", nargs="*", default=None, help="lists whose name contains one of these")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.utils import animation

    failures, n_ok = [], 0
    with tempfile.TemporaryDirectory() as out_dir:
        for path in sorted(glob.glob(os.path.join(MEDIA, "*.yaml"))):
            name = os.path.basename(path)
            if args.only and not any(o in name for o in args.only):
                continue
            with open(path) as f:
                entries = yaml.safe_load(f)
            if not isinstance(entries, list):
                continue  # a scene file, read by the lists
            for i, cfg in enumerate(entries):
                cfg = dict(cfg)
                if float(cfg["time"]) > args.time:
                    cfg.pop("panic_on_end", None)  # the clipped run ends before its window
                cfg["time"] = min(float(cfg["time"]), args.time)
                if cfg.get("video_start_time") is not None:
                    cfg["video_start_time"] = 0.0
                    cfg["video_fps"] = 30.0
                cfg["image_width"] = cfg["image_height"] = 160
                cfg["png_file"] = os.path.join(out_dir, f"{name}-{i}-" +
                                               os.path.basename(str(cfg["png_file"])))
                t0 = time.perf_counter()
                try:
                    r = animation._export_one(cfg, MEDIA, args.device)
                except Exception as e:  # noqa: BLE001  (one line per entry, then the summary)
                    failures.append((name, i, repr(e)))
                    print(f"FAIL {name}[{i}]: {e!r}", flush=True)
                    continue
                n_ok += 1
                print(f"OK   {name}[{i}]: {r.steps} steps, n = {r.n}, {r.frames} frames, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{n_ok} entries ran, {len(failures)} failed")
    for f in failures:
        print("  ", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
