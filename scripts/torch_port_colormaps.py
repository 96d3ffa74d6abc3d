"""Write the port's viridis / inferno colour tables from matplotlib.

The JAX package samples matplotlib's viridis and inferno at 32 evenly spaced
stops when it colours particles (adaptive_sph_tpu/utils/colors.py
`_mpl_map`). The port runs where matplotlib may be missing, so it keeps the
same 32 RGB stops as constants in adaptive_sph_torch/utils/colormap_tables.py,
which this script writes (tests/test_torch_render.py holds them against
matplotlib):

    python scripts/torch_port_colormaps.py
"""

from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "adaptive_sph_torch", "utils", "colormap_tables.py")
STOPS = 32


def samples(name: str, n: int = STOPS) -> list:
    """The RGB of matplotlib's map `name` at n evenly spaced stops in [0, 1],
    as the JAX package samples it."""
    from matplotlib import colormaps

    cmap = colormaps[name]
    return [tuple(float(c) for c in cmap(float(t))[:3]) for t in np.linspace(0.0, 1.0, n)]


def main():
    lines = ['"""matplotlib\'s viridis and inferno at 32 evenly spaced stops in [0, 1] (RGB).',
             "",
             "Written by scripts/torch_port_colormaps.py; do not edit.",
             '"""', ""]
    for name in ("viridis", "inferno"):
        lines.append(f"{name.upper()} = (")
        lines += [f"    ({r!r}, {g!r}, {b!r})," for r, g, b in samples(name)]
        lines += [")", ""]
    with open(OUT, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
