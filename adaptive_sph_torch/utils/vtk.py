"""VTK legacy PolyData export for ParaView.

The port's own copy of adaptive_sph_tpu/utils/vtk.py (the files are byte for
byte the same): a `.vtk.series` index plus one legacy VTK file per snapshot
carrying positions, vertices, boundary lines, and the per-particle point data
(density, density errors, pressure, mass, aii, h, source term, velocity,
pressure_accel, flags, neighbor count).
"""

from __future__ import annotations

import json
import os

import numpy as np


class VtkExporter:
    def __init__(self, directory: str, name: str):
        self.directory = directory
        self.name = name
        self.entries = []
        os.makedirs(directory, exist_ok=True)

    def add_snapshot(self, time: float, snapshot: dict, boundary_segments: np.ndarray = None):
        idx = len(self.entries)
        fname = f"{self.name}-{idx:06d}.vtk"
        write_vtk_file(os.path.join(self.directory, fname), snapshot, boundary_segments)
        self.entries.append({"name": fname, "time": float(time)})
        series = {"file-series-version": "1.0", "files": self.entries}
        with open(os.path.join(self.directory, f"{self.name}.vtk.series"), "w") as f:
            json.dump(series, f, indent=1)


def write_vtk_file(path: str, snapshot: dict, boundary_segments: np.ndarray = None):
    pos = np.asarray(snapshot["position"], np.float32)
    n = pos.shape[0]
    segs = (
        np.asarray(boundary_segments, np.float32).reshape(-1, 4)
        if boundary_segments is not None and len(boundary_segments)
        else np.zeros((0, 4), np.float32)
    )
    ns = len(segs)

    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nadaptive-sph-tpu snapshot\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {n + 2 * ns} float\n")
        for p in pos:
            f.write(f"{p[0]} {p[1]} 0\n")
        for s in segs:
            f.write(f"{s[0]} {s[1]} 0\n{s[2]} {s[3]} 0\n")

        f.write(f"VERTICES {n} {2 * n}\n")
        for i in range(n):
            f.write(f"1 {i}\n")
        if ns:
            f.write(f"LINES {ns} {3 * ns}\n")
            for k in range(ns):
                f.write(f"2 {n + 2 * k} {n + 2 * k + 1}\n")

        scalar_fields = [
            ("density", "density"),
            ("density_error", "density-error"),
            ("pressure", "pressure"),
            ("mass", "mass"),
            ("aii", "aii"),
            ("h", "h"),
            ("ppe_source_term", "source-term"),
            ("level", "surface-distance"),
            ("constant_field", "constant-field"),
        ]
        vector_fields = [("velocity", "velocity"), ("pressure_accel", "pressure-accel")]
        int_fields = [
            ("neighbor_count", "neighbor-count"),
            ("size_class", "size-class"),
            ("flag_is_fluid_surface", "is-fluid-surface"),
        ]

        f.write(f"POINT_DATA {n + 2 * ns}\n")
        pad = 2 * ns
        for key, label in scalar_fields:
            if key not in snapshot:
                continue
            a = np.asarray(snapshot[key], np.float32)
            f.write(f"SCALARS {label} float 1\nLOOKUP_TABLE default\n")
            for v in a:
                f.write(f"{v}\n")
            for _ in range(pad):
                f.write("0\n")
        for key, label in int_fields:
            if key not in snapshot:
                continue
            a = np.asarray(snapshot[key]).astype(np.int32)
            f.write(f"SCALARS {label} int 1\nLOOKUP_TABLE default\n")
            for v in a:
                f.write(f"{v}\n")
            for _ in range(pad):
                f.write("0\n")
        for key, label in vector_fields:
            if key not in snapshot:
                continue
            a = np.asarray(snapshot[key], np.float32)
            f.write(f"VECTORS {label} float\n")
            for v in a:
                f.write(f"{v[0]} {v[1]} 0\n")
            for _ in range(pad):
                f.write("0 0 0\n")
