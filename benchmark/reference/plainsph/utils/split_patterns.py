"""Split patterns: loading the table the splitter places children by
(data/split-patterns.yaml beside this package).

Schema: a YAML list whose entry k holds the pattern for k + 2 children,
{"pos_s": [[x, y], ...], "mass_s": [...], "h_s": [...]}, positions in units
of the parent's radius.
"""

from __future__ import annotations

import os

import numpy as np
import yaml

DEFAULT_PATTERN_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "data", "split-patterns.yaml")


def load_patterns_yaml(path: str) -> list:
    with open(path) as f:
        raw = yaml.safe_load(f)
    for i, p in enumerate(raw):
        if len(p["pos_s"]) != i + 2:
            raise ValueError(f"{path}: pattern {i} has {len(p['pos_s'])} children, "
                             f"expected {i + 2} (the list must start at 2 children)")
    return raw


def to_padded_table(patterns: list):
    """(P, MAXC, 2) float32 positions, zero-padded, and (P,) int32 child counts,
    both numpy; row k places k + 2 children."""
    P = len(patterns)
    maxc = max(len(p["pos_s"]) for p in patterns)
    pos = np.zeros((P, maxc, 2), np.float32)
    counts = np.zeros((P,), np.int32)
    for k, p in enumerate(patterns):
        n = len(p["pos_s"])
        pos[k, :n] = np.asarray(p["pos_s"], np.float32)
        counts[k] = n
    return pos, counts


def load_default_patterns(path: str = None):
    """The split-pattern table of `path`, else the packaged default."""
    return to_padded_table(load_patterns_yaml(path or DEFAULT_PATTERN_PATH))
