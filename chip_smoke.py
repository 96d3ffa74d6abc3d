#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py                # all phases (one GPU)
    python3 chip_smoke.py --kernels-only # build + kernel-vs-plain checks only

Phases (any failure raises; the exit code is then non-zero):
  1. the card's name and power limit (nvidia-smi) and the nvcc build of the
     kernels from adaptive_sph_torch/csrc/ (one nvcc per source, in parallel, linked into one library);
     ptxas's registers per thread of every tile-walk kernel instance (K1,
     pair_sweep) and their spill bytes, which may not exceed SPILL_STORE_MAX
     / SPILL_LOAD_MAX in any instance; the launch shapes that ops/jacobi.py
     and ops/pair_ops.py mirror (SOLVE_*; STREAM_K, STREAM_SHAPES) against
     the library's, and the registers of every K2 / K3 instance, none of
     which may spill;
  2. K1-K3 against their plain PyTorch versions on the same CUDA tensors, at
     the stress scene's first-step shapes: max error, median times (CUDA
     events; profiled device times), the bound of each from this run's pairs
     inside the radius (the tested candidates outside it are not counted),
     and for K2 the time (events and device) of a CSR sparse-times-dense
     product computing the same function; each line with K2 / K3's grid, G
     and K (and which of its two shapes the list takes); then K2 and K3 on
     the synthetic lists of
     jacobi.synthetic_streams (rows of 0-300 pairs, C = 1, 7 and 1,000, f32
     and bf16; an all-empty list of 14,336 rows: exact zeros), each launched
     twice, the second launch bit-identical;
     then K1 in classic mode on the first-step inputs of the resident
     hybrid stress path (captured from that step; seeded velocities):
     structure equal, the 8 prep rows within 1e-5;
  2b. pair_sweep against its plain version for each of the nine sweep ops,
     on the inputs the default dam break's first step gives them (captured
     from that step; C = 3,072, 8 populated levels), and for the DENSITY op
     on the resident hybrid stress path's first step: counts and maxima
     equal, sums within 1e-5 of the column max, medians, tested pairs;
     then the viscosity sweep after the divergence solve (ApproxLaplace and
     WCSPH) and IISPH2's Omega sweep on the layouts of the dam break's and
     the resident stress path's first steps (seeded densities and
     velocities), sums within 1e-5 of the column max, medians, bounds;
  2c. the whole-solve kernels pair_jacobi and pair_hybrid against their plain
     versions on the impact scene's solves that iterate (hybrid and
     OnlyDivergence step 4: 60 divergence sweeps, the cap; IISPH step 5: 23),
     on the first-step solves of the three resident stress paths (hybrid
     f32, hybrid bf16 weights, IISPH), as the step gave them and with a
     compressive density source and tolerances 0 (every solve to the cap of
     20 sweeps), and in each of their four variants on synthetic lists
     (jacobi.synthetic_inputs, 20 sweeps): rows of 0-300 pairs (f32, bf16)
     and the largest capacity the resident gate admits (89,600 rows f32,
     92,416 bf16), each launched twice: iteration counts equal, outputs
     within 1e-5 of their max, the second launch bit-identical, with the
     grid and shared memory per block; then timed on the hybrid and IISPH
     stress inputs, per solve and per sweep (events and profiled device
     time), beside their bound. The Winchenbach2020 mode (w2020) likewise:
     two more synthetic variants, the impact scene's w2020 solves (hybrid
     and OnlyDivergence step 4, 54 sweeps; IISPH step 5, 24), the first-step
     solves of the resident Winchenbach2020 hybrid and IISPH2 (WCSPH, 1 /
     Omega source) stress runs as given and to the cap, each launched twice
     and timed per solve and sweep; an empty list's sweep in both modes;
  2g. K1 with the WCSPH viscosity (mega with its stream, two rows and
     scalar-g; classic with the inline rows) against its plain version at
     the stress scene's first-step shapes (seeded velocities), f32 and bf16
     storage: pair structure bit for bit, prep rows within 1e-5 of the
     column max, stored entries within 1e-5 (4e-3 in bf16); medians,
     profiled device times, bounds;
  2d. K1's scalar-g mode (ASPH_SCALAR_BLOCKS=1) and its streams K2s
     pair_matvec_scalar and K3s pair_visc_scalar, and K1's weights-only mode
     pair_weights, against their plain versions at the stress scene's
     first-step shapes (seeded velocities), f32 and bf16 storage: in f32 K2s
     equals K2 on the same pairs bit for bit and the weights-only w equals
     mega mode's w; K3s within 1e-5; bf16 scalars within 4e-3; medians,
     bounds, and for K2s K2's time and K2's library call on the same pairs;
     K2s / K3s and K2 / K3 also by their profiled device time; K2s and K3s
     on the synthetic lists as K2 and K3 in phase 2;
  2f. K1 in its five step modes (mega f32 and bf16, scalar-g, classic,
     weights-only) and the DENSITY sweep against their plain versions on the
     stress scene's first-step layouts at x1 and x4 (pair structure bit for
     bit, values within tolerance), with the largest and median tile's
     candidates and each one's device time at x1 and x4 and their ratio;
     the DENSITY sweep also with the split tiles' rows dead, then alone;
  2e. the probe kernels of adaptive_sph_torch.probe against their plain
     versions on the same CUDA tensors: block_sweep at the four sizes of
     scripts/proto_pallas.py (1e-5 of max), window_sum at proto_v8.py's
     size (bit for bit), pair_stream at the (grp, nbuf) of
     matvec_probe.py (zeros, and each block's XOR fold of the words it landed
     equal to the fold of the same bytes of the list; whole and with a
     ragged tail), the K2 probe's three variants in both modes and
     the K2s probe at wh 32-256 on the stress first step's lists, f32 and
     bf16 (1e-5 of max; base equal to K2 and every wh to K2s bit for bit);
     medians, profiled device times, bounds and library calls (the sparse
     CSR product for the matvecs, torch.sum for the stream, a conv1d for
     the window sum);
  3. 10 steps of the stress scene (parity options) against the JAX reference
     trajectory in tests/data/torch_port_stress_ref.npz;
  3b. 10 steps of the default dam break against
     tests/data/torch_port_dambreak_ref.npz: per-step census, capacity,
     resampling counts, dt and iteration counts equal, then the state;
  3c. the resident trajectories against tests/data/torch_port_resident_ref.npz:
     10 steps of the stress scene's resident hybrid and IISPH paths, 6 steps
     of the impact scene for HybridDFSPH, IISPH and OnlyDivergence;
     iteration counts equal at every step, then the state;
  3d. 10 steps of the stress scene (parity options) with ASPH_SCALAR_BLOCKS=1
     against tests/data/torch_port_scalar_ref.npz (JAX's scalar-g path);
  3e. every run of adaptive_sph_torch.stress.solver_runs (Winchenbach2020
     hybrid streamed and resident, IISPH2 with WCSPH resident, WCSPH with
     the non-pressure step after the divergence solve, the impact scene's
     three Winchenbach2020 solvers, the media configuration) against
     tests/data/torch_port_solvers_ref.npz: launch counts set to 0 just
     before each run and read just after (its kernels and modes must have
     launched, no plain version may have run), per-step iteration and
     negative-a_ii counts equal, then the state (the media configuration,
     chaotic by design: its per-step counts over 200 steps);
  4. timed stress runs (parity and bench options) through create_simulation
     -> Simulation.step; the launch counts are set to 0 just before the
     bench-options run and read just after: K1-K3 must have launched;
     after each run, 10 more steps under torch.profiler count the host
     synchronisations per step and the device-busy share;
  4c. the same for the three resident stress paths (hybrid parity, hybrid
     bench options with momentum 0, IISPH) and, for comparison, IISPH on the
     streamed path; launch counts set to 0 just before each run and read
     just after: pair_hybrid must have launched on both hybrid paths,
     pair_jacobi on the IISPH path;
  4d. timed scalar-g stress runs (ASPH_SCALAR_BLOCKS=1, parity and bench
     options) with their profiled windows: K1, K2s and K3s must have
     launched, K2 and K3 not;
  4e. timed stress_w2020_hybrid (the classic branch with streamed solves)
     and stress_iisph2_wcsph_resident with their profiled windows;
  4b. the timed default dam break, 300 steps through create_simulation (the
     launch counts set to 0 just before, read just after: all four kernels
     must have launched; the census of its CSR lists, pairs per live row
     mean, p99 and max), then 20 steps through
     adaptive_sph_torch.cli.main(["run", ..., "--max-steps", "20"]);
  5. adaptive_sph_torch.timing.main(["1"]) in this process: its stage table
     at x1; the weights-only walk must have launched;
  6. adaptive_sph_torch.probe.main([]) in this process (every variant at
     x1, bf16 storage; the launch counts set to 0 just before and read just
     after): all five probe kernels must have launched.
Output: a JSON object with one entry per kernel and one per ported mode
("kernel:mode": K1's WCSPH viscosity, the visc and omega sweeps, the
Winchenbach2020 solves; launches counted over phase 3e's runs), then the
card's name and power limit (nvidia-smi), then, last, {"ok": true,
"device": {...}}. Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_stress_ref.npz")
SCALAR_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_scalar_ref.npz")
RESIDENT_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_resident_ref.npz")
DAMBREAK_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_dambreak_ref.npz")
SOLVER_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_solvers_ref.npz")
CONFIG = os.path.join(ROOT, "configs", "default-config.yaml")
SCENE = os.path.join(ROOT, "configs", "default-scene.yaml")

SOURCES = {
    "pair_build": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_matvec": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_visc": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_sweep": "adaptive_sph_torch/csrc/pair_sweep.cu",
    "pair_jacobi": "adaptive_sph_torch/csrc/pair_jacobi.cu",
    "pair_hybrid": "adaptive_sph_torch/csrc/pair_jacobi.cu",
    "pair_weights": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_matvec_scalar": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_visc_scalar": "adaptive_sph_torch/csrc/pair_ops.cu",
    "block_sweep": "adaptive_sph_torch/csrc/pair_probe.cu",
    "window_sum": "adaptive_sph_torch/csrc/pair_probe.cu",
    "pair_stream": "adaptive_sph_torch/csrc/pair_probe.cu",
    "pair_matvec_probe": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_matvec_scalar_probe": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_build:wcsph": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_sweep:visc": "adaptive_sph_torch/csrc/pair_sweep.cu",
    "pair_sweep:omega": "adaptive_sph_torch/csrc/pair_sweep.cu",
    "pair_jacobi:w2020": "adaptive_sph_torch/csrc/pair_jacobi.cu",
    "pair_hybrid:w2020": "adaptive_sph_torch/csrc/pair_jacobi.cu",
}
REPLACES = {
    "pair_build": "adaptive_sph_tpu/ops/pallas_matvec.py:786",
    "pair_matvec": "adaptive_sph_tpu/ops/pallas_matvec.py:253",
    "pair_visc": "adaptive_sph_tpu/ops/pallas_matvec.py:666",
    "pair_sweep": "adaptive_sph_tpu/ops/pallas_sweeps.py:120",
    "pair_jacobi": "adaptive_sph_tpu/ops/pallas_jacobi.py:398",
    "pair_hybrid": "adaptive_sph_tpu/ops/pallas_jacobi.py:502",
    "pair_weights": "adaptive_sph_tpu/ops/pallas_matvec.py:101",
    "pair_matvec_scalar": "adaptive_sph_tpu/ops/pallas_matvec.py:504",
    "pair_visc_scalar": "adaptive_sph_tpu/ops/pallas_matvec.py:592",
    "block_sweep": "scripts/proto_pallas.py:94",
    "window_sum": "scripts/proto_v8.py:74",
    "pair_stream": "scripts/matvec_probe.py:195",
    "pair_matvec_probe": "scripts/matvec_probe.py:237",
    "pair_matvec_scalar_probe": "scripts/matvec_probe2.py:169",
    # the modes of four of them (K1's WCSPH viscosity, :948-965; the visc and
    # omega SweepOps, models/tile_physics.py:121, :175; the Winchenbach2020
    # divergence of both solves, pallas_jacobi.py:243-298)
    "pair_build:wcsph": "adaptive_sph_tpu/ops/pallas_matvec.py:786",
    "pair_sweep:visc": "adaptive_sph_tpu/ops/pallas_sweeps.py:120",
    "pair_sweep:omega": "adaptive_sph_tpu/ops/pallas_sweeps.py:120",
    "pair_jacobi:w2020": "adaptive_sph_tpu/ops/pallas_jacobi.py:398",
    "pair_hybrid:w2020": "adaptive_sph_tpu/ops/pallas_jacobi.py:502",
}
PROBE_KERNELS = ("block_sweep", "window_sum", "pair_stream", "pair_matvec_probe",
                 "pair_matvec_scalar_probe")
# the kernels each timed path must launch
DAMBREAK_KERNELS = ("pair_build", "pair_matvec", "pair_visc", "pair_sweep")
# the least time the card could take: bytes at the HBM rate, float32
# operations at the non-tensor-core float32 peak (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations of each pair inside the radius, the only pairs the
# function needs: the geometry (h_ij, dx, dy, r2, radius test) and the
# kernel's terms (sqrt and divisions counted as one each). Candidates of the
# tile walk outside the radius are overhead of the layout, not work the
# output needs, and are not counted.
OPS_PAIR_GEOM = 12
OPS_K1_PAIR = 45
OPS_K1_VISC = 12
OPS_K1_WCSPH = 14  # the WCSPH stream factor or inline rows
OPS_K1_CLASSIC = 25  # the s2 sums (7) and the inline viscosity (18)
OPS_K1_WEIGHTS = 25  # the weights-only walk: OPS_K1_PAIR less the density and prep sums
# the sweeps of the solver surface (phase_solver_sweeps), not the dam break's
SOLVER_SWEEPS = ("visc_laplace", "visc_wcsph", "omega")
OPS_SWEEP_EMIT = {"count": 1, "normal": 35, "cone": 12, "wavefront": 4, "smooth": 40,
                  "adapt_cnt0": 12, "adapt_cnt1": 16, "adapt_claim": 18, "adapt_partner": 18,
                  "density": 16, "visc_laplace": 40, "visc_wcsph": 40, "omega": 30}
# one walk of a whole solve over one pair: two products and two sums (a
# Jacobi iteration is two walks: 8 operations per pair)
OPS_SOLVE_WALK = 4
TOL_SOLVE = 1e-5  # relative to max |plain| after up to 60 sweeps
# a row that is rounding noise: the kernel's distance from a float64 solve
# over the plain version's (solve_agreement)
F64_RATIO = 1.5
CAP_SWEEPS = 20  # the cap of the stress and synthetic solves run with their tolerances set to 0
# row lengths of the synthetic whole-solve lists, repeated over the rows:
# empty rows, one pair, the stress scene's longest row (13), rows longer than
# a row's lanes (40, 300) and the stress scene's typical 9-12 pairs
LONG_ROWS = (0, 1, 13, 40, 300, 9, 11, 12, 10, 13)
# the variants held on them: (kernel, wrapper, flags)
SYNTHETIC_KINDS = (
    ("pair_jacobi", "jacobi_solve", dict(density_type=True, write_perr=True, src_from_div=True)),
    ("pair_jacobi", "jacobi_solve", dict(density_type=False, write_perr=False,
                                         src_from_div=False)),
    ("pair_hybrid", "hybrid_solve", dict(den_with_div=True)),
    ("pair_hybrid", "hybrid_solve", dict(den_with_div=False)),
    # the Winchenbach2020 divergence, with the mirrored boundary pressure
    ("pair_jacobi", "jacobi_solve", dict(density_type=True, write_perr=True, src_from_div=True,
                                         w2020=True, mp=1e-6)),
    ("pair_hybrid", "hybrid_solve", dict(den_with_div=True, w2020=True, mp=1e-6)),
)
# the Winchenbach2020 solves of the impact scene that iterate: (method, step,
# the iterations of its first solve)
W2020_IMPACT = (("HybridDFSPH", 4, 54), ("IISPH", 5, 24), ("OnlyDivergence", 4, 54))
# row lengths of the synthetic K2 / K3 / K2s / K3s lists (jacobi.synthetic_streams),
# repeated over the rows: 300 pairs first (C = 1 holds it alone), empty rows,
# rows shorter than a segment of lanes, the stress scene's (13) and the dam
# break's (23) longest rows, rows longer than a segment's pairs in flight
STREAM_ROWS = (300, 0, 1, 3, 13, 23, 40, 12, 13, 11)
STREAM_SIZES = (1, 7, 1000)  # C below a block's rows and not a multiple of them
TOL_F32 = 1e-5   # relative to max |plain|: only the summation order differs
TOL_BF16 = 4e-3  # stored bf16 entries: one bf16 half-ulp where f32 inputs differ in the last bit
# the most spill bytes ptxas may report for any tile-walk instance: the
# largest it reports for sm_90a (the DENSITY sweep's 32 B stored, 48 B
# loaded), none of them inside the per-candidate loop
SPILL_STORE_MAX = 32
SPILL_LOAD_MAX = 48
STEPS_TRAJ = 10
STEPS_TIMED = 100
STEPS_DAMBREAK = 300
STEPS_CLI = 20
WARMUP = 10
STEPS_PROFILED = 10


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps):
    """Median milliseconds of fn() between CUDA events, after one warm-up call."""
    from adaptive_sph_torch.timing import median_ms

    return median_ms(fn, reps)


def rel_err(got, want):
    """(max |got - want|, that over max |want|) in float64."""
    got = got.double()
    want = want.double()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def phase_header():
    import torch
    from adaptive_sph_torch.ops import _native, jacobi, pair_ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _native.load()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s (parallel nvcc "
        f"{_native.build_seconds if _native.build_seconds is not None else 'cached'} s), "
        f"flags {' '.join(_native.NVCC_FLAGS)}")
    # the tile walk's instances (K1's modes and passes, the sweep ops): ptxas's
    # registers per thread and spill bytes
    walks = {k: v for k, v in _native.resources().items()
             if "pair_build_kernel" in k or "pair_sweep_kernel" in k}
    if not walks:
        raise AssertionError("ptxas's report lists no tile-walk kernel")
    for name, (regs, st, ld) in sorted(walks.items()):
        short = re.search(r"(pair_\w+_kernel)I(.*?)EEv", name)
        log(f"ptxas {short.group(1)}<{short.group(2)}>: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    spilled = sum(1 for _, st, ld in walks.values() if st or ld)
    regs = [r for r, _, _ in walks.values()]
    log(f"tile walk: {len(walks)} kernel instances, {min(regs)}-{max(regs)} registers, "
        f"{spilled} with spill stores")
    over = [n for n, (_, st, ld) in walks.items() if st > SPILL_STORE_MAX or ld > SPILL_LOAD_MAX]
    if over:
        raise AssertionError(f"tile-walk instances spill more than {SPILL_STORE_MAX} B stored / "
                             f"{SPILL_LOAD_MAX} B loaded: {over}")
    # the split of long rows that pair_ops.walk_plan mirrors
    lib = _native.load()
    split = (lib.asph_pair_pieces(), lib.asph_pair_split_min())
    if split != (pair_ops.WALK_PIECES, pair_ops.WALK_SPLIT_MIN):
        raise AssertionError(f"the kernels split rows as {split}, pair_ops.walk_plan as "
                             f"{(pair_ops.WALK_PIECES, pair_ops.WALK_SPLIT_MIN)}")
    # the whole-solve kernels' launch shape that ops/jacobi.py mirrors to size
    # the grid and the shared memory, and their registers
    shape = (ctypes.c_int * 6)()
    lib.asph_solve_shape(shape)
    want = (jacobi.SOLVE_THREADS, jacobi.SOLVE_G, jacobi.SOLVE_BLOCKS_PER_SM, jacobi.SOLVE_COLS,
            jacobi.SOLVE_COLS_W2020, jacobi._SOLVE_FIXED_WORDS)
    if tuple(shape) != want:
        raise AssertionError(f"the solve kernels' shape is {tuple(shape)}, ops/jacobi.py's {want}")
    solves = {k: v for k, v in _native.resources().items()
              if "pair_jacobi_kernel" in k or "pair_hybrid_kernel" in k}
    for name, (regs, st, ld) in sorted(solves.items()):
        short = re.search(r"(pair_\w+_kernel)I(.*?)EEv", name)
        log(f"ptxas {short.group(1)}<{short.group(2)}>: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    log(f"solve kernels: {jacobi.SOLVE_THREADS} threads per block, {jacobi.SOLVE_BLOCKS_PER_SM} "
        f"per SM, {jacobi.SOLVE_G} lanes per row")
    # the pair-list products' launch shapes that ops/pair_ops.py mirrors to
    # choose a shape and size the grid, and every K2 / K3 instance's
    # registers; none may spill
    shape = (ctypes.c_int * 7)()
    lib.asph_stream_shape(shape)
    want = (pair_ops.STREAM_K, *pair_ops.STREAM_SHAPES[0], *pair_ops.STREAM_SHAPES[1])
    if tuple(shape) != want:
        raise AssertionError(f"K2 / K3's launch shapes are {tuple(shape)}, ops/pair_ops.py's "
                             f"{want}")
    streams = {k: v for k, v in _native.resources().items()
               if "pair_matvec_kernel" in k or "pair_visc_kernel" in k}
    if not streams:
        raise AssertionError("ptxas's report lists no K2 / K3 kernel")
    for name, (regs, st, ld) in sorted(streams.items()):
        short = re.search(r"(pair_\w+_kernel)I(.*?)EEv", name)
        log(f"ptxas {short.group(1)}<{short.group(2)}>: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    spilled = [n for n, (_, st, ld) in streams.items() if st or ld]
    if spilled:
        raise AssertionError(f"K2 / K3 instances spill: {spilled}")
    regs = [r for r, _, _ in streams.values()]
    log(f"K2 / K3: {len(streams)} kernel instances, {min(regs)}-{max(regs)} registers, no "
        f"spills; {pair_ops.STREAM_K} pairs in flight per lane; (G lanes per row, threads, "
        f"blocks per SM): small lists {pair_ops.STREAM_SHAPES[0]}, large lists "
        f"{pair_ops.STREAM_SHAPES[1]}")
    return smi


def stream_shape(C):
    """The K2 / K3 launch over C rows on this card, for the logs."""
    import torch
    from adaptive_sph_torch.ops import pair_ops

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape, grid = pair_ops.stream_launch(C, sms)
    G, threads, _ = pair_ops.STREAM_SHAPES[shape]
    return (f"{('small', 'large')[shape]}-list shape, grid {grid} x {threads} threads, G {G}, "
            f"K {pair_ops.STREAM_K}")


def phase_synthetic_streams(scalar: bool):
    """K2 and K3 (K2s and K3s with `scalar`) against their plain versions on
    the synthetic lists of jacobi.synthetic_streams: rows of 0-300 pairs at
    each C of STREAM_SIZES, f32 and bf16 storage, each launched twice
    (within TOL_F32 of the largest row sum of |term|, jacobi.stream_scales:
    only the summation order differs and a 300-pair row's terms cancel; the
    second launch bit-identical), and on an all-empty list of 14,336 rows
    (exact zeros: every output slot written)."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import jacobi, pair_ops
    from adaptive_sph_torch.timing import device_ms

    dev = torch.device("cuda")
    names = ("pair_matvec_scalar", "pair_visc_scalar") if scalar else ("pair_matvec",
                                                                        "pair_visc")

    def calls(two, sc, rho, D, ref):
        lst = sc if scalar else two
        mv, vi = (getattr(pair_ops, n + ("_ref" if ref else "")) for n in names)
        return {f"{names[0]} accel": lambda: mv(lst, D["u"], 2),
                f"{names[0]} div": lambda: (mv(lst, (D["tx"], D["ty"]), 1),),
                names[1]: lambda: vi(lst, rho)}

    worst = 0.0
    for C in STREAM_SIZES + (14336,):
        for wdtype in (torch.float32, torch.bfloat16):
            lengths = np.resize(STREAM_ROWS, C) if C != 14336 else np.zeros(C, np.int64)
            two, sc, rho = jacobi.synthetic_streams(lengths, C, wdtype, dev)
            rng = np.random.default_rng(C)
            D = {k: torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev)
                 for k in ("u", "tx", "ty")}
            ks, rs = calls(two, sc, rho, D, False), calls(two, sc, rho, D, True)
            scales = jacobi.stream_scales(sc if scalar else two, D["u"], D["tx"], D["ty"], rho)
            for name, fk in ks.items():
                got, again, want = fk(), fk(), rs[name]()
                torch.cuda.synchronize()
                scale = scales["visc" if "visc" in name else name.split()[1]]
                for g, a, w in zip(got, again, want):
                    if not torch.equal(g, a):
                        raise AssertionError(f"{name} synthetic C={C} {wdtype}: a second launch "
                                             f"differs")
                    if C == 14336 and not bool((g == 0).all()):
                        raise AssertionError(f"{name} on an empty list of {C} rows: not all 0")
                    e = rel_err(g, w)[0]
                    worst = max(worst, e)
                    if not e <= TOL_F32 * scale:
                        raise AssertionError(f"{name} synthetic C={C} {wdtype}: max abs err "
                                             f"{e:.3e} > {TOL_F32:g} x {scale:.3e} (the largest "
                                             f"row sum of |term|)")
            if C == 1000 and wdtype == torch.float32:
                for name, fk in ks.items():
                    log(f"{name} synthetic C={C} ({int(lengths.sum())} pairs, {stream_shape(C)}): "
                        f"kernel {time_ms(fk, 200):.4f} ms (device {device_ms(fk, 20):.4f} ms)")
    log(f"{' / '.join(names)} on synthetic lists (rows of {sorted(set(STREAM_ROWS))} pairs; C "
        f"{', '.join(map(str, STREAM_SIZES))}; f32 and bf16) and an all-empty list of 14336 "
        f"rows: within {TOL_F32:g} of the largest row sum of |term| (max abs err "
        f"{worst:.3e}), second launches "
        f"bit-identical, empty rows exactly 0")
    return worst


def bound_ms(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations") for moving nbytes and doing ops."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pair_census(cell_starts, wm, statics, scale, tq):
    """(tested pairs, pairs inside the radius) of one tile walk."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops.numerics import fma
    from adaptive_sph_torch.ops.pair_ops import walk_pairs

    tested = inside = 0
    s32 = float(np.float32(scale))
    for qi, cj in walk_pairs(cell_starts, wm, statics[:, 2] > 0.0, tq):
        sq, sc = statics[qi], statics[cj]
        h_ij = torch.clamp(0.5 * (sq[:, 2] + sc[:, 2]), min=1e-6)
        dx, dy = sq[:, 0] - sc[:, 0], sq[:, 1] - sc[:, 1]
        rad = s32 * h_ij
        tested += qi.numel()
        inside += int(((fma(dx, dx, dy * dy) < rad * rad) & (sc[:, 2] > 0)).sum())
    return tested, inside


def phase_kernels():
    """Each kernel vs its plain version on the stress scene's first-step inputs."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models.tile_step import physics_scale, step_geometry
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene
    from adaptive_sph_torch.timing import device_ms

    dev = torch.device("cuda")
    results = {}
    for bench in (False, True):
        tag = "bf16" if bench else "f32"
        params = stress_params(bench)
        sim = create_simulation(params, stress_scene(), device=dev, counters_enabled=False)
        tcfg = sim.tile_cfg
        _, bins, cols, wm = step_geometry(sim.state, sim.params, tcfg)
        wdtype = torch.bfloat16 if bench else torch.float32
        # the first step starts at rest, which would zero every viscosity
        # factor: give the live particles seeded velocities for this check
        rng = np.random.default_rng(7)
        C = tcfg.capacity
        flat = cols["flat"].clone()
        live = (flat[:, 2] > 0).float()[:, None]
        flat[:, 4:6] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(dev) * live
        args = (bins.cell_starts, wm, flat, tcfg.tq, float(physics_scale(sim.params)),
                float(sim.params.viscosity), True, wdtype)
        k = pair_ops.pair_build(*args)
        r = pair_ops.pair_build_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(k.row_ptr, r.row_ptr) or not torch.equal(k.col, r.col):
            nd = int((k.row_ptr != r.row_ptr).sum())
            raise AssertionError(f"K1 pair_build [{tag}]: pair structure differs from the "
                                 f"plain version ({nd} row pointers differ, "
                                 f"{k.num_pairs} vs {r.num_pairs} pairs)")
        tol_w = TOL_BF16 if bench else TOL_F32
        errs = {}
        for name, got, want, tol in (
                ("w", k.w, r.w, tol_w), ("s", k.s, r.s, tol_w),
                ("prep", k.prep, r.prep, TOL_F32)):
            for row in range(got.shape[0]):
                e, rel = rel_err(got[row], want[row])
                errs[f"{name}{row}"] = (e, rel)
                if not rel < tol:
                    raise AssertionError(f"K1 pair_build [{tag}] {name}[{row}]: max rel err "
                                         f"{rel:.3e} >= {tol:g}")
        k1_abs = max(e for e, _ in errs.values())
        k1_rel = max(rel for _, rel in errs.values())
        t_k1 = time_ms(lambda: pair_ops.pair_build(*args), 20)
        d_k1 = device_ms(lambda: pair_ops.pair_build(*args), 5)
        t_k1r = time_ms(lambda: pair_ops.pair_build_ref(*args), 5)
        C = tcfg.capacity
        P = k.num_pairs
        tested, _ = pair_census(bins.cell_starts, wm, flat[:, 0:4].contiguous(),
                                physics_scale(sim.params), tcfg.tq)
        wb = 2 if bench else 4
        b_k1 = bound_ms(C * 24 + (C + 1) * 4 + P * (4 + 4 * wb) + C * 16,
                        P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_VISC))
        log(f"K1 pair_build [{tag}]: {P} pairs of {tested} tested, structure equal, max abs err "
            f"{k1_abs:.3e}, max rel err {k1_rel:.3e} (tol {tol_w:g} stored, {TOL_F32:g} sums); "
            f"kernel {t_k1:.4f} ms (device {d_k1:.4f} ms, count and fill passes), plain "
            f"{t_k1r:.4f} ms, bound {b_k1[0]:.4f} ms ({b_k1[1]})")

        # K2 / K3 on the kernel-built list; the plain versions read the same
        # stored entries, so f32 accumulation order is the only difference
        alive = live[:, 0]
        u = torch.from_numpy(rng.uniform(0, 10, C).astype(np.float32)).to(dev) * alive
        tx = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
        ty = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
        rho = torch.from_numpy(rng.uniform(0.8, 1.2, C).astype(np.float32)).to(dev)
        checks = {
            "pair_matvec_accel": (lambda: pair_ops.pair_matvec(k, u, 2),
                                  lambda: pair_ops.pair_matvec_ref(k, u, 2)),
            "pair_matvec_div": (lambda: (pair_ops.pair_matvec(k, (tx, ty), 1),),
                                lambda: (pair_ops.pair_matvec_ref(k, (tx, ty), 1),)),
            "pair_visc": (lambda: pair_ops.pair_visc(k, rho),
                          lambda: pair_ops.pair_visc_ref(k, rho)),
        }
        a2 = csr_product(k, C)
        lib = a2 @ u[:, None]
        torch.cuda.synchronize()
        e_lib, _ = rel_err(lib[:, 0], torch.cat(pair_ops.pair_matvec_ref(k, u, 2)))
        t_lib = time_ms(lambda: a2 @ u[:, None], 200)
        d_lib = device_ms(lambda: a2 @ u[:, None], 50)
        log(f"K2 library yardstick (torch.sparse_csr_tensor @ dense, both rows) [{tag}]: "
            f"{t_lib:.4f} ms (device {d_lib:.4f} ms, every kernel of the call), max abs diff "
            f"to the plain version {e_lib:.3e}")
        b_k2 = bound_ms((C + 1) * 4 + P * (4 + 2 * wb) + C * 4 + 2 * C * 4, 4 * P)
        b_k3 = bound_ms((C + 1) * 4 + P * (4 + 2 * wb) + C * 4 + 2 * C * 4, 7 * P)
        out = {"pair_build": (k1_abs, t_k1, t_k1r, b_k1, None)}
        for name, (fk, fr) in checks.items():
            got, want = fk(), fr()
            torch.cuda.synchronize()
            worst_abs = worst_rel = 0.0
            for g, w in zip(got, want):
                e, rel = rel_err(g, w)
                worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
            if not worst_rel < TOL_F32:
                raise AssertionError(f"{name} [{tag}]: max rel err {worst_rel:.3e} >= {TOL_F32:g}")
            tk = time_ms(fk, 200)
            dk = device_ms(fk, 50)
            tr = time_ms(fr, 50)
            bnd = b_k3 if name == "pair_visc" else b_k2
            out[name] = (worst_abs, tk, tr, bnd, t_lib if name == "pair_matvec_accel" else None)
            lib = (f"; library device {d_lib:.4f} ms, kernel/library {dk / d_lib:.3f}"
                   if name == "pair_matvec_accel" and d_lib > 0 else "")
            log(f"{name} [{tag}] ({stream_shape(C)}): max abs err {worst_abs:.3e}, max rel err "
                f"{worst_rel:.3e} (tol {TOL_F32:g}); kernel {tk:.4f} ms (device {dk:.4f} ms), "
                f"plain {tr:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}){lib}")
        results[tag] = out
        del sim, k, r
        torch.cuda.empty_cache()
    e = phase_synthetic_streams(scalar=False)
    for name in ("pair_matvec_accel", "pair_visc"):
        f32 = results["f32"][name]
        results["f32"][name] = (max(f32[0], e), *f32[1:])
    return results


@contextlib.contextmanager
def scalar_blocks():
    """ASPH_SCALAR_BLOCKS=1 inside the block: the step stores one scalar per
    pair (K1's scalar-g mode) and streams it through K2s / K3s."""
    old = os.environ.get("ASPH_SCALAR_BLOCKS")
    os.environ["ASPH_SCALAR_BLOCKS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["ASPH_SCALAR_BLOCKS"]
        else:
            os.environ["ASPH_SCALAR_BLOCKS"] = old


def phase_scalar_kernels():
    """K1's scalar-g and weights-only modes, K2s and K3s against their plain
    versions at the stress scene's first-step shapes (seeded velocities), in
    float32 and bfloat16 storage. In float32 K2s must equal K2 on the two-row
    list of the same pairs bit for bit, and the weights-only w mega mode's w."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models.tile_step import physics_scale, step_geometry
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene
    from adaptive_sph_torch.timing import device_ms

    dev = torch.device("cuda")
    out = {}
    for bench in (False, True):
        tag = "bf16" if bench else "f32"
        sim = create_simulation(stress_params(bench), stress_scene(), device=dev,
                                counters_enabled=False)
        tcfg = sim.tile_cfg
        _, bins, cols, wm = step_geometry(sim.state, sim.params, tcfg)
        wdtype = torch.bfloat16 if bench else torch.float32
        wb = 2 if bench else 4
        rng = np.random.default_rng(7)
        C = tcfg.capacity
        flat = cols["flat"].clone()
        live = (flat[:, 2] > 0).float()[:, None]
        flat[:, 4:6] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(dev) * live
        scale = float(physics_scale(sim.params))
        args = (bins.cell_starts, wm, flat, tcfg.tq, scale, float(sim.params.viscosity), True,
                wdtype)
        k = pair_ops.pair_build(*args, scalar=True)
        r = pair_ops.pair_build_ref(*args, scalar=True)
        two = pair_ops.pair_build(*args)
        torch.cuda.synchronize()
        if not (torch.equal(k.row_ptr, r.row_ptr) and torch.equal(k.col, r.col)
                and torch.equal(k.col, two.col)):
            raise AssertionError(f"K1 scalar mode [{tag}]: pair structure differs")
        tol_w = TOL_BF16 if bench else TOL_F32
        k1_abs = 0.0
        for name, got, want, tol in (("g", k.g, r.g, tol_w), ("sg", k.sg, r.sg, tol_w),
                                     *((f"prep{i}", k.prep[i], r.prep[i], TOL_F32)
                                       for i in range(4))):
            e, rel = rel_err(got, want)
            k1_abs = max(k1_abs, e)
            if not rel < tol:
                raise AssertionError(f"K1 scalar mode [{tag}] {name}: max rel err {rel:.3e} >= "
                                     f"{tol:g}")
        P = k.num_pairs
        t_k1 = time_ms(lambda: pair_ops.pair_build(*args, scalar=True), 20)
        t_k1r = time_ms(lambda: pair_ops.pair_build_ref(*args, scalar=True), 5)
        b_k1 = bound_ms(C * 24 + (C + 1) * 4 + P * (4 + 2 * wb) + C * 16,
                        P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_VISC))
        log(f"K1 pair_build scalar-g mode [{tag}]: {P} pairs, structure equal, g, sg and prep "
            f"within tolerance (max abs err {k1_abs:.3e}); kernel {t_k1:.4f} ms, plain "
            f"{t_k1r:.4f} ms, bound {b_k1[0]:.4f} ms ({b_k1[1]})")

        alive = live[:, 0]
        u = torch.from_numpy(rng.uniform(0, 10, C).astype(np.float32)).to(dev) * alive
        tx = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
        ty = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
        rho = torch.from_numpy(rng.uniform(0.8, 1.2, C).astype(np.float32)).to(dev)
        # K2s / K3s read the same stored scalars as their plain versions, so
        # only the float32 summation order differs, in either storage type
        streams = {
            "pair_matvec_scalar accel": (lambda: pair_ops.pair_matvec_scalar(k, u, 2),
                                         lambda: pair_ops.pair_matvec_scalar_ref(k, u, 2),
                                         lambda: pair_ops.pair_matvec(two, u, 2)),
            "pair_matvec_scalar div": (
                lambda: (pair_ops.pair_matvec_scalar(k, (tx, ty), 1),),
                lambda: (pair_ops.pair_matvec_scalar_ref(k, (tx, ty), 1),),
                lambda: (pair_ops.pair_matvec(two, (tx, ty), 1),)),
            "pair_visc_scalar": (lambda: pair_ops.pair_visc_scalar(k, rho),
                                 lambda: pair_ops.pair_visc_scalar_ref(k, rho),
                                 lambda: pair_ops.pair_visc(two, rho)),
        }
        a2 = csr_product(two, C)
        t_lib = time_ms(lambda: a2 @ u[:, None], 200)
        d_lib = device_ms(lambda: a2 @ u[:, None], 50)
        # bytes: row_ptr, col and one scalar per pair, x and y of the table,
        # the operands and the outputs; operations: the rebuilt wx, wy (2
        # subtractions, 2 products) and the stream's own products and sums
        b_k2s = bound_ms((C + 1) * 4 + P * (4 + wb) + 8 * C + C * 4 + 2 * C * 4, 8 * P)
        b_k3s = bound_ms((C + 1) * 4 + P * (4 + wb) + 8 * C + C * 4 + 2 * C * 4, 11 * P)
        res = {}
        for name, (fk, fr, f2) in streams.items():
            got, want, legacy = fk(), fr(), f2()
            torch.cuda.synchronize()
            worst = (0.0, 0.0)
            for g, w, l2 in zip(got, want, legacy):
                e, rel = rel_err(g, w)
                worst = (max(worst[0], e), max(worst[1], rel))
                if not bench and name != "pair_visc_scalar" and not torch.equal(g, l2):
                    raise AssertionError(f"{name} [f32]: K2s differs from K2 on the same pairs "
                                         f"(max abs diff {rel_err(g, l2)[0]:.3e}); must be equal")
            if not worst[1] < TOL_F32:
                raise AssertionError(f"{name} [{tag}]: max rel err {worst[1]:.3e} >= {TOL_F32:g}")
            tk, tr, t2 = time_ms(fk, 200), time_ms(fr, 50), time_ms(f2, 200)
            # the kernels' own durations: event times of one ~30 us launch
            # also hold the wrapper's host cost
            dk, d2 = device_ms(fk, 50), device_ms(f2, 50)
            bnd = b_k3s if name == "pair_visc_scalar" else b_k2s
            res[name] = (worst[0], tk, tr, bnd, None if name == "pair_visc_scalar" else t_lib)
            same = " (bit for bit equal to K2)" if not bench and name != "pair_visc_scalar" else ""
            log(f"{name} [{tag}] ({stream_shape(C)}): max abs err {worst[0]:.3e}, max rel err "
                f"{worst[1]:.3e} (tol {TOL_F32:g}){same}; kernel {tk:.4f} ms (device "
                f"{dk:.4f} ms), plain {tr:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); two-row "
                f"{'K3' if 'visc' in name else 'K2'} on the same pairs {t2:.4f} ms (device "
                f"{d2:.4f} ms), library (sparse CSR @ dense) {t_lib:.4f} ms (device "
                f"{d_lib:.4f} ms)")
        if not bench:
            # the weights-only walk: the (C, 4) table, float32 w, no prep sums
            st = flat[:, 0:4].contiguous()
            wl = pair_ops.pair_weights(bins.cell_starts, wm, st, tcfg.tq, scale)
            wr = pair_ops.pair_weights_ref(bins.cell_starts, wm, st, tcfg.tq, scale)
            torch.cuda.synchronize()
            if not (torch.equal(wl.row_ptr, wr.row_ptr) and torch.equal(wl.col, wr.col)):
                raise AssertionError("pair_weights: pair structure differs from the plain version")
            if not (torch.equal(wl.col, two.col) and torch.equal(wl.w, two.w)):
                raise AssertionError("pair_weights: w differs from mega mode's w (must be equal)")
            e, rel = rel_err(wl.w, wr.w)
            if not rel < TOL_F32:
                raise AssertionError(f"pair_weights: max rel err {rel:.3e} >= {TOL_F32:g}")
            tk = time_ms(lambda: pair_ops.pair_weights(bins.cell_starts, wm, st, tcfg.tq, scale),
                         20)
            tr = time_ms(lambda: pair_ops.pair_weights_ref(bins.cell_starts, wm, st, tcfg.tq,
                                                           scale), 5)
            bnd = bound_ms(C * 16 + bins.cell_starts.numel() * 4 + wm.numel() * 4
                           + (C + 1) * 4 + P * (4 + 8), P * (OPS_PAIR_GEOM + OPS_K1_WEIGHTS))
            res["pair_weights"] = (e, tk, tr, bnd, None)
            log(f"pair_weights (K1 weights-only) [f32]: {wl.num_pairs} pairs, structure equal, "
                f"w bit for bit mega mode's w, max abs err {e:.3e}, max rel err {rel:.3e} (tol "
                f"{TOL_F32:g}); kernel {tk:.4f} ms, plain {tr:.4f} ms, bound {bnd[0]:.5f} ms "
                f"({bnd[1]})")
        res["pair_build"] = k1_abs
        out[tag] = res
        del sim, k, r, two
        torch.cuda.empty_cache()
    e = phase_synthetic_streams(scalar=True)
    for name in ("pair_matvec_scalar accel", "pair_visc_scalar"):
        f32 = out["f32"][name]
        out["f32"][name] = (max(f32[0], e), *f32[1:])
    return out


def csr_product(csr, C):
    """The library yardstick of K2-like streams: one CSR sparse-times-dense
    product with the x and y weight rows stacked into a (2C, C) matrix."""
    import torch

    P = csr.num_pairs
    rp2 = torch.cat([csr.row_ptr, csr.row_ptr[1:] + P])
    return torch.sparse_csr_tensor(rp2, torch.cat([csr.col, csr.col]), csr.w.float().reshape(-1),
                                   size=(2 * C, C))


def phase_probe_kernels():
    """The five probe kernels against their plain versions on the same CUDA
    tensors at the probe's shapes; returns {kernel: (max abs err, ms, plain
    ms, bound, library ms)} for the JSON line (block_sweep at its largest
    size, pair_stream over the f32 w at grp 8 nbuf 4, the K2 probe base in
    accel mode on the f32 list, the K2s probe at wh 128 in accel mode)."""
    import torch
    from adaptive_sph_torch import probe
    from adaptive_sph_torch.ops import pair_ops, probes
    from adaptive_sph_torch.timing import device_ms

    out = {}
    worst = 0.0
    for E, NT in probe.SWEEP_SIZES:
        a = probe.sweep_inputs(E, NT)
        got, want = probes.block_sweep(*a), probes.block_sweep_ref(*a)
        torch.cuda.synchronize()
        e, rel = rel_err(got, want)
        if not rel < TOL_F32:
            raise AssertionError(f"block_sweep E={E} NT={NT}: max rel err {rel:.3e} >= {TOL_F32:g}")
        worst = max(worst, e)
        b = bound_ms(*probe.sweep_cost(*a[:6]))
        tk, tr = time_ms(lambda: probes.block_sweep(*a), 50), time_ms(lambda: probes.block_sweep_ref(*a), 5)
        dk = device_ms(lambda: probes.block_sweep(*a), 20, "block_sweep_kernel")
        out["block_sweep"] = (worst, tk, tr, b, None)
        log(f"block_sweep E={E} NT={NT} C={a[1].shape[0]}: max abs err {e:.3e}, max rel err "
            f"{rel:.3e} (tol {TOL_F32:g}); kernel {tk:.4f} ms (device {dk:.4f} ms), plain "
            f"{tr:.4f} ms, bound {b[0]:.5f} ms ({b[1]}); library: none (no one call sums a "
            f"masked kernel over a work list)")

    v, an = probe.window_inputs()
    got, want = probes.window_sum(v, an), probes.window_sum_ref(v, an)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"window_sum differs from the plain version (max abs diff "
                             f"{rel_err(got, want)[0]:.3e}); must be equal")
    # the library call: one conv1d of v with the anchors' count vector
    L = v.shape[0] - probe.WINDOW_WIDTH + 1
    ind = torch.zeros(L, device=v.device).index_add_(0, an.long(), torch.ones_like(an, dtype=torch.float32))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib = torch.nn.functional.conv1d(v.view(1, 1, -1), ind.view(1, 1, -1))[0, 0]
        t_lib = time_ms(lambda: torch.nn.functional.conv1d(v.view(1, 1, -1), ind.view(1, 1, -1)), 50)
    torch.cuda.synchronize()
    b = bound_ms(*probe.window_cost(v, an))
    tk, tr = time_ms(lambda: probes.window_sum(v, an), 200), time_ms(lambda: probes.window_sum_ref(v, an), 20)
    dk = device_ms(lambda: probes.window_sum(v, an), 20, "window_sum_kernel")
    out["window_sum"] = (0.0, tk, tr, b, t_lib)
    log(f"window_sum C={v.shape[0]} anchors={an.numel()}: bit for bit equal to the plain version; "
        f"kernel {tk:.4f} ms (device {dk:.4f} ms), plain {tr:.4f} ms, bound {b[0]:.5f} ms "
        f"({b[1]}); library (conv1d with the anchor counts) {t_lib:.4f} ms, max abs diff "
        f"{rel_err(lib, want)[0]:.3e}")

    worst = {"pair_matvec_probe": 0.0, "pair_matvec_scalar_probe": 0.0}
    for f32 in (True, False):
        tag = "f32" if f32 else "bf16"
        d = probe.stress_lists(f32=f32)
        two, sc, C = d["two"], d["scalar"], d["C"]
        P = two.num_pairs
        w = two.w
        for grp, nbuf in ((8, 4), (32, 4), (1, 8), (8, 8)):
            for n in (w.numel() - 3, w.numel()):  # a ragged tail, then the whole list
                z, nbytes, folds = probes.pair_stream(w, n, grp, nbuf)
                torch.cuda.synchronize()
                if z.shape != (8, 128) or z.any():
                    raise AssertionError(f"pair_stream [{tag}] grp={grp} nbuf={nbuf} n={n}: not "
                                         f"(8, 128) zeros")
                want = probes.stream_folds(w, n, grp, folds.numel())
                if not torch.equal(folds, want) or not want.any():
                    raise AssertionError(f"pair_stream [{tag}] grp={grp} nbuf={nbuf} n={n}: the "
                                         f"blocks' folds of what landed differ from the list's "
                                         f"({int((folds != want).sum())} of {folds.numel()})")
            fk = (lambda g=grp, n=nbuf: probes.pair_stream(w, w.numel(), g, n))
            tk, dk = time_ms(fk, 200), device_ms(fk, 20, "pair_stream_kernel")
            b = bound_ms(nbytes + 8 * 128 * 4 + 4 * folds.numel(), 0)
            rate = f"{nbytes / (dk * 1e6):.1f} GB/s" if dk > 0 else "rate not measured"
            msg = (f"pair_stream [{tag}] grp={grp} nbuf={nbuf} over w ({nbytes} B, {folds.numel()} "
                   f"blocks): zeros, folds equal, also with a ragged tail; kernel "
                   f"{tk:.4f} ms (device {dk:.4f} ms, {rate}), bound {b[0]:.5f} ms ({b[1]})")
            if f32 and (grp, nbuf) == (8, 4):
                t_lib = time_ms(lambda: w.sum(), 200)
                d_lib = device_ms(lambda: w.sum(), 20)
                tr = time_ms(lambda: probes.pair_stream_ref(w, w.numel(), grp, nbuf,
                                                            folds.numel()), 200)
                out["pair_stream"] = (0.0, tk, tr, b, t_lib)
                msg += (f", plain {tr:.4f} ms, library (torch.sum over w) {t_lib:.4f} ms "
                        f"(device {d_lib:.4f} ms)")
            log(msg)

        lib = csr_product(two, C)
        t_lib = time_ms(lambda: lib @ d["u"][:, None], 200)
        for k_out, t in ((2, d["u"]), (1, (d["tx"], d["ty"]))):
            mode = "accel" if k_out == 2 else "div"
            k2 = pair_ops.pair_matvec(two, t, k_out)
            k2s = pair_ops.pair_matvec_scalar(sc, t, k_out)
            for variant in probes.VARIANTS:
                fk = (lambda v=variant: probes.pair_matvec_probe(two, t, k_out, v))
                fr = (lambda v=variant: probes.pair_matvec_probe_ref(two, t, k_out, v))
                got, want = fk(), fr()
                torch.cuda.synchronize()
                got, want = (got, want) if k_out == 2 else ((got,), (want,))
                e = max(rel_err(g, r)[0] for g, r in zip(got, want))
                rel = max(rel_err(g, r)[1] for g, r in zip(got, want))
                if not rel < TOL_F32:
                    raise AssertionError(f"pair_matvec_probe {variant} {mode} [{tag}]: max rel err "
                                         f"{rel:.3e} >= {TOL_F32:g}")
                same = ""
                if variant == "base":
                    if not all(torch.equal(g, k) for g, k in
                               zip(got, k2 if k_out == 2 else (k2,))):
                        raise AssertionError(f"pair_matvec_probe base {mode} [{tag}]: differs from "
                                             f"K2 (must be equal bit for bit)")
                    same = ", bit for bit K2"
                worst["pair_matvec_probe"] = max(worst["pair_matvec_probe"], e)
                tk, dk = time_ms(fk, 200), device_ms(fk, 20, "pair_matvec_kernel")
                b = bound_ms(*probe.matvec_cost(two, k_out, variant))
                msg = (f"pair_matvec_probe {variant} {mode} [{tag}]: max abs err {e:.3e}, max rel "
                       f"err {rel:.3e} (tol {TOL_F32:g}){same}; kernel {tk:.4f} ms (device "
                       f"{dk:.4f} ms), bound {b[0]:.5f} ms ({b[1]})")
                if f32 and variant == "base" and k_out == 2:
                    tr = time_ms(fr, 50)
                    out["pair_matvec_probe"] = (e, tk, tr, b, t_lib)
                    msg += f", plain {tr:.4f} ms, library (sparse CSR @ dense) {t_lib:.4f} ms"
                log(msg)
            for wh in probes.WINDOW_HEIGHTS:
                fk = (lambda h=wh: probes.pair_matvec_scalar_probe(sc, t, k_out, h))
                fr = (lambda h=wh: probes.pair_matvec_scalar_probe_ref(sc, t, k_out, h))
                got, want = fk(), fr()
                torch.cuda.synchronize()
                got, want, ks = ((got, want, k2s) if k_out == 2
                                 else ((got,), (want,), (k2s,)))
                e = max(rel_err(g, r)[0] for g, r in zip(got, want))
                rel = max(rel_err(g, r)[1] for g, r in zip(got, want))
                if not rel < TOL_F32:
                    raise AssertionError(f"pair_matvec_scalar_probe wh={wh} {mode} [{tag}]: max "
                                         f"rel err {rel:.3e} >= {TOL_F32:g}")
                if not all(torch.equal(g, k) for g, k in zip(got, ks)):
                    raise AssertionError(f"pair_matvec_scalar_probe wh={wh} {mode} [{tag}]: "
                                         f"differs from K2s (must be equal bit for bit)")
                worst["pair_matvec_scalar_probe"] = max(worst["pair_matvec_scalar_probe"], e)
                tk, dk = time_ms(fk, 200), device_ms(fk, 20, "pair_matvec_kernel")
                b = bound_ms(*probe.matvec_cost(sc, k_out))
                msg = (f"pair_matvec_scalar_probe wh={wh} {mode} [{tag}]: max abs err {e:.3e}, "
                       f"max rel err {rel:.3e} (tol {TOL_F32:g}), bit for bit K2s; kernel "
                       f"{tk:.4f} ms (device {dk:.4f} ms), bound {b[0]:.5f} ms ({b[1]})")
                if f32 and wh == 128 and k_out == 2:
                    tr = time_ms(fr, 50)
                    out["pair_matvec_scalar_probe"] = (e, tk, tr, b, t_lib)
                    msg += (f", plain {tr:.4f} ms, library (sparse CSR @ dense on the two-row "
                            f"list) {t_lib:.4f} ms")
                log(msg)
        del d, two, sc, lib
        torch.cuda.empty_cache()
    for name in ("pair_matvec_probe", "pair_matvec_scalar_probe"):
        out[name] = (worst[name], *out[name][1:])
    return out


def phase_walk_layouts():
    """K1 in each mode and the DENSITY sweep against their plain versions on
    the stress scene's first-step layouts at x1 and x4 (parity options,
    seeded velocities): pair structure equal bit for bit, values within
    tolerance; the candidates of the largest and the median query tile, and
    each kernel's profiled device time at x1 and x4 with their ratio (the
    coarse tile's rows walk the whole scene, so a walk that they pace grows
    4x from x1 to x4). Returns {name: {replicas: device ms}}."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import tile_physics as tp
    from adaptive_sph_torch.models.tile_step import physics_scale, step_geometry
    from adaptive_sph_torch.ops import pair_ops, sweeps
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene
    from adaptive_sph_torch.timing import device_ms

    dev_ms = {}
    for replicas in (1, 4):
        sim = create_simulation(stress_params(), stress_scene(replicas), device="cuda",
                                counters_enabled=False)
        tcfg, params = sim.tile_cfg, sim.params
        _, bins, cols, wm = step_geometry(sim.state, params, tcfg)
        C, tq = tcfg.capacity, tcfg.tq
        rng = np.random.default_rng(7)
        flat = cols["flat"].clone()
        live = (flat[:, 2] > 0).float()[:, None]
        flat[:, 4:6] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(
            flat.device) * live
        cs = bins.cell_starts
        cand = pair_ops.tile_candidates(cs, wm, C // tq)
        split = int((pair_ops.walk_plan(cs, wm, C // tq)[:, 1] < cand).sum())
        top = int(cand.argmax())
        live_top = int((flat[top * tq:(top + 1) * tq, 2] > 0).sum())
        scale = float(physics_scale(params))
        st = flat[:, 0:4].contiguous()
        dens = sweeps.pair_sweep(cs, wm, st, None, tp.DENSITY_OP, scale, tq)[:, 0]
        rho = torch.where(flat[:, 2] > 0, dens, torch.ones_like(dens))
        cand_tab = torch.cat([flat[:, 0:4], rho[:, None], flat[:, 4:6]], 1).contiguous()
        visc = float(params.viscosity)
        modes = {
            "mega f32": (lambda: pair_ops.pair_build(cs, wm, flat, tq, scale, visc, True),
                         lambda: pair_ops.pair_build_ref(cs, wm, flat, tq, scale, visc, True),
                         TOL_F32),
            "mega bf16": (lambda: pair_ops.pair_build(cs, wm, flat, tq, scale, visc, True,
                                                      torch.bfloat16),
                          lambda: pair_ops.pair_build_ref(cs, wm, flat, tq, scale, visc, True,
                                                          torch.bfloat16), TOL_BF16),
            "scalar-g f32": (lambda: pair_ops.pair_build(cs, wm, flat, tq, scale, visc, True,
                                                         scalar=True),
                             lambda: pair_ops.pair_build_ref(cs, wm, flat, tq, scale, visc, True,
                                                             scalar=True), TOL_F32),
            "classic f32": (lambda: pair_ops.pair_build(cs, wm, cand_tab, tq, scale, visc, False,
                                                        classic=True),
                            lambda: pair_ops.pair_build_ref(cs, wm, cand_tab, tq, scale, visc,
                                                            False, classic=True), TOL_F32),
            "weights-only": (lambda: pair_ops.pair_weights(cs, wm, st, tq, scale),
                             lambda: pair_ops.pair_weights_ref(cs, wm, st, tq, scale), TOL_F32),
        }
        log(f"walk layout x{replicas}: C = {C}, tq = {tq}, {C // tq} tiles, candidates per tile "
            f"median {float(cand.float().median()):.0f}, max {int(cand[top])} (tile {top}, "
            f"{live_top} live queries); {split} tiles' rows split in "
            f"{pair_ops.WALK_PIECES} pieces (more than {pair_ops.WALK_SPLIT_MIN} candidates)")
        for name, (fk, fr, tol) in modes.items():
            k, r = fk(), fr()
            torch.cuda.synchronize()
            if not (torch.equal(k.row_ptr, r.row_ptr) and torch.equal(k.col, r.col)):
                raise AssertionError(f"K1 {name} x{replicas}: pair structure differs from the "
                                     f"plain version")
            worst = 0.0
            for field in ("w", "s", "g", "sg", "prep"):
                got, want = getattr(k, field), getattr(r, field)
                if got is None:
                    continue
                rows = got.reshape(-1, got.shape[-1])
                for i in range(rows.shape[0]):
                    e, rel = rel_err(rows[i], want.reshape(rows.shape)[i])
                    lim = TOL_F32 if field == "prep" else tol
                    if not rel < lim:
                        raise AssertionError(f"K1 {name} x{replicas} {field}[{i}]: max rel err "
                                             f"{rel:.3e} >= {lim:g}")
                    worst = max(worst, rel)
            d = device_ms(fk, 5)
            dev_ms.setdefault(f"K1 {name}", {})[replicas] = d
            log(f"K1 {name} x{replicas}: {k.num_pairs} pairs, structure equal, max rel err "
                f"{worst:.3e}; device {d:.4f} ms (count and fill passes)")
        got = sweeps.pair_sweep(cs, wm, st, None, tp.DENSITY_OP, scale, tq)
        want = sweeps.pair_sweep_ref(cs, wm, st, None, tp.DENSITY_OP, scale, tq)
        torch.cuda.synchronize()
        e, rel = rel_err(got, want)
        if not rel < TOL_F32:
            raise AssertionError(f"pair_sweep density x{replicas}: max rel err {rel:.3e}")
        d = device_ms(lambda: sweeps.pair_sweep(cs, wm, st, None, tp.DENSITY_OP, scale, tq), 20,
                      "pair_sweep_kernel")
        dev_ms.setdefault("pair_sweep density", {})[replicas] = d
        log(f"pair_sweep density x{replicas}: max rel err {rel:.3e}; device {d:.4f} ms")
        # which rows set the time: the split tiles' rows (the coarse tile's)
        # dead, then alone; h = 0 also drops them as candidates
        long_rows = (cand > pair_ops.WALK_SPLIT_MIN).repeat_interleave(tq)
        for tag, dead in (("split tiles' rows dead", long_rows),
                          ("only the split tiles' rows live", ~long_rows)):
            s = st.clone()
            s[dead, 2] = 0.0
            d = device_ms(lambda s=s: sweeps.pair_sweep(cs, wm, s, None, tp.DENSITY_OP, scale, tq),
                          20, "pair_sweep_kernel")
            log(f"pair_sweep density x{replicas}, {tag}: device {d:.4f} ms")
        del sim
        torch.cuda.empty_cache()
    for name, t in dev_ms.items():
        ratio = f"{t[4] / t[1]:.2f}" if t[1] > 0 else "not measured"
        log(f"{name}: device x1 {t[1]:.4f} ms, x4 {t[4]:.4f} ms, x4/x1 {ratio}")
    return dev_ms


def capture_step(sim):
    """One sim.step() with spies on the kernel wrappers the step calls;
    returns {wrapper name: [(args, kwargs), ...]} in call order."""
    from adaptive_sph_torch.models import tile_step
    from adaptive_sph_torch.ops import jacobi, pair_ops

    targets = ((pair_ops, "pair_build"), (tile_step, "pair_sweep"), (jacobi, "jacobi_solve"),
               (jacobi, "hybrid_solve"))
    real = {name: getattr(mod, name) for mod, name in targets}
    calls = {}

    def spy(name):
        def f(*a, **k):
            calls.setdefault(name, []).append((a, k))
            return real[name](*a, **k)
        return f

    try:
        for mod, name in targets:
            setattr(mod, name, spy(name))
        sim.step()
    finally:
        for mod, name in targets:
            setattr(mod, name, real[name])
    return calls


def capture_resident_inputs():
    """The first-step kernel inputs of the resident stress paths: hybrid
    (parity options), hybrid (bench options: bf16 weights) and IISPH."""
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene

    out = {}
    for tag, bench, iisph in (("hybrid", False, False), ("hybrid_bench", True, False),
                              ("iisph", False, True)):
        sim = create_simulation(stress_params(bench=bench, resident=True, iisph=iisph),
                                stress_scene(), device="cuda", counters_enabled=False)
        out[tag] = capture_step(sim)
    return out


def phase_classic(calls):
    """K1 in classic mode vs its plain version on the resident hybrid stress
    path's first-step inputs."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.timing import device_ms

    (cs, wm, cand, tq, scale, visc, stream, wdtype), kw = calls["pair_build"][0]
    if not kw.get("classic") or stream:
        raise AssertionError("the resident path's pair walk is not K1's classic mode")
    # the first step starts at rest, which would zero every viscosity term:
    # give the live particles seeded velocities for this check
    rng = np.random.default_rng(7)
    C = cand.shape[0]
    cand = cand.clone()
    live = (cand[:, 2] > 0).float()[:, None]
    cand[:, 5:7] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(
        cand.device) * live
    args = (cs, wm, cand, tq, scale, visc, False, wdtype)
    k = pair_ops.pair_build(*args, classic=True)
    r = pair_ops.pair_build_ref(*args, classic=True)
    torch.cuda.synchronize()
    if not torch.equal(k.row_ptr, r.row_ptr) or not torch.equal(k.col, r.col):
        raise AssertionError("K1 classic mode: pair structure differs from the plain version")
    worst_abs = worst_rel = 0.0
    for name, got, want in (("w", k.w, r.w), ("prep", k.prep, r.prep)):
        for row in range(got.shape[0]):
            e, rel = rel_err(got[row], want[row])
            if not rel < TOL_F32:
                raise AssertionError(f"K1 classic mode {name}[{row}]: max rel err {rel:.3e} >= "
                                     f"{TOL_F32:g}")
            worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
    t_k = time_ms(lambda: pair_ops.pair_build(*args, classic=True), 20)
    d_k = device_ms(lambda: pair_ops.pair_build(*args, classic=True), 5)
    t_r = time_ms(lambda: pair_ops.pair_build_ref(*args, classic=True), 5)
    P = k.num_pairs
    b = bound_ms(C * 28 + (C + 1) * 4 + P * (4 + 2 * 4) + C * 32,
                 P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_CLASSIC))
    log(f"K1 pair_build classic mode [f32] (the resident hybrid stress path's first step, "
        f"seeded velocities): {P} pairs, structure equal, 8 prep rows, max abs err "
        f"{worst_abs:.3e}, max rel err {worst_rel:.3e} (tol {TOL_F32:g}); kernel {t_k:.4f} ms "
        f"(device {d_k:.4f} ms), plain {t_r:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    return worst_abs, t_k, t_r, b


def phase_sweeps(resident_calls):
    """pair_sweep vs its plain version for the nine ops, on the inputs the
    default dam break's first step hands them (captured from that step), and
    for DENSITY on the resident hybrid stress path's first step."""
    import torch
    from adaptive_sph_torch.models import adaptivity, scene, tile_step
    from adaptive_sph_torch.ops import sweeps
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.utils.params import load_params

    sim = create_simulation(load_params(CONFIG), scene.load_scene(SCENE), device="cuda",
                            counters_enabled=False)
    C, levels = sim.state.capacity, len(sim.tile_cfg.populated)
    captured = {}
    real = sweeps.pair_sweep

    def spy(cell_starts, wm, statics, dyn, op, scale, tq):
        if op.name not in captured:
            captured[op.name] = (cell_starts.clone(), wm.clone(), statics.clone(),
                                 None if dyn is None else dyn.clone(), op, scale, tq)
        return real(cell_starts, wm, statics, dyn, op, scale, tq)

    tile_step.pair_sweep = adaptivity.pair_sweep = spy
    try:
        sim.step()
    finally:
        tile_step.pair_sweep = adaptivity.pair_sweep = real
    torch.cuda.synchronize()
    want = [k for k in OPS_SWEEP_EMIT if k not in ("density", *SOLVER_SWEEPS)]
    if sorted(captured) != sorted(want):
        raise AssertionError(f"the first step ran the sweeps {sorted(captured)}, expected {want}")
    log(f"pair_sweep inputs: the default dam break's first step, C = {C}, {levels} populated "
        f"levels; density: the resident hybrid stress path's first step")
    dens = [a for a, _ in resident_calls["pair_sweep"] if a[4].name == "density"]
    if len(dens) != 1:
        raise AssertionError(f"the resident step ran {len(dens)} density sweeps, expected 1")
    captured["density"] = dens[0]
    per_op, dev_ms = {}, {}
    for name in want + ["density"]:
        cs, wm, st, dyn, op, scale, tq = captured[name]
        got = sweeps.pair_sweep(cs, wm, st, dyn, op, scale, tq)
        ref = sweeps.pair_sweep_ref(cs, wm, st, dyn, op, scale, tq)
        torch.cuda.synchronize()
        g, r = got.double(), ref.double()
        err = float((g - r).abs().max())
        if op.reduce == "max" or name in ("count", "adapt_cnt0", "adapt_cnt1"):
            if not torch.equal(got, ref):
                raise AssertionError(f"pair_sweep {name}: {int((got != ref).sum())} values "
                                     f"differ from the plain version (must be equal)")
            tol_txt = "equal"
        else:
            rel = float(((g - r).abs() / (r.abs().amax(0, keepdim=True) + 1e-30)).max())
            if not rel < TOL_F32:
                raise AssertionError(f"pair_sweep {name}: rel err {rel:.3e} >= {TOL_F32:g}")
            tol_txt = f"rel err {rel:.3e} (tol {TOL_F32:g} of the column max)"
        tested, inside = pair_census(cs, wm, st, scale, tq)
        D = 0 if dyn is None else dyn.shape[1]
        Cs = st.shape[0]
        if name != "density" and Cs != C:
            raise AssertionError(f"pair_sweep {name}: captured at C = {Cs}, not {C}")
        b = bound_ms(Cs * 16 + Cs * D * 4 + Cs * op.n_out * 4 + cs.numel() * 4 + wm.numel() * 4,
                     inside * (OPS_PAIR_GEOM + OPS_SWEEP_EMIT[name]))
        tk = time_ms(lambda: sweeps.pair_sweep(cs, wm, st, dyn, op, scale, tq), 50)
        dk = device_ms(lambda: sweeps.pair_sweep(cs, wm, st, dyn, op, scale, tq), 20,
                       "pair_sweep_kernel")
        tr = time_ms(lambda: sweeps.pair_sweep_ref(cs, wm, st, dyn, op, scale, tq), 5)
        per_op[name] = (err, tk, tr, b)
        dev_ms[name] = dk
        log(f"pair_sweep {name}: {tested} tested pairs, {inside} inside the radius "
            f"(scale {scale:.6g}); {tol_txt}, max abs err {err:.3e}; kernel {tk:.4f} ms "
            f"(device {dk:.4f} ms), plain {tr:.4f} ms, bound {b[0]:.5f} ms ({b[1]})")
    err = max(v[0] for v in per_op.values())
    tk = sum(v[1] for v in per_op.values())
    tr = sum(v[2] for v in per_op.values())
    tb = sum(v[3][0] for v in per_op.values())
    by = "bytes" if sum(v[3][1] == "bytes" for v in per_op.values()) > len(per_op) / 2 \
        else "operations"
    log(f"pair_sweep, one launch of each of the ten ops: kernel {tk:.4f} ms (device "
        f"{sum(dev_ms.values()):.4f} ms), plain {tr:.4f} ms, bound {tb:.5f} ms")
    inputs = {"the default dam break's first step": captured["count"][:3] + (captured["count"][6],),
              "the resident hybrid stress path's first step": dens[0][:3] + (dens[0][6],)}
    del sim
    torch.cuda.empty_cache()
    return (err, tk, tr, (tb, by)), inputs


def solve_walks(name, stats, kw):
    """Pair walks of one whole-solve launch: two per sweep (accel, div), the
    final accel of each solve, and the in-kernel source walks."""
    from adaptive_sph_torch.ops import jacobi

    def sweeps(off):
        return int(stats[off + jacobi.S_ITERS]) + 1

    if name == "jacobi_solve":
        return 2 * sweeps(0) + 1 + int(kw["src_from_div"]), sweeps(0)
    n = sweeps(0) + sweeps(8)
    return 2 * n + 2 + 1 + int(kw["den_with_div"]), n


def solve_bound(name, a, kw, stats):
    """Bound of one whole-solve launch: its inputs and outputs moved once, and
    OPS_SOLVE_WALK float32 operations per pair per walk."""
    csr, table, _ = a
    C, P = table.shape[1], csr.num_pairs
    wb = csr.w.element_size()
    if name == "jacobi_solve":
        rows_in, rows_out = 13 + 3 * int(kw["src_from_div"]), 5
    else:
        rows_in, rows_out = 16, 8
    if kw.get("w2020"):
        rows_in, rows_out = rows_in + 2, rows_out + 2
    walks, _ = solve_walks(name, stats, kw)
    nbytes = (rows_in + rows_out) * C * 4 + (C + 1) * 4 + P * (4 + 2 * wb) + 16 + stats.numel() * 4
    return bound_ms(nbytes, walks * OPS_SOLVE_WALK * P)


def solve_agreement(name, m, st, m_ref, st_ref, exact=None):
    """(iterations, max abs err, max rel err) of a whole-solve kernel against
    its plain version; raises unless the iteration counts are equal and every
    output row is within TOL_SOLVE of its max.

    exact: the output of a float64 solve of the same inputs (solve_f64), for
    an input where a row's own max is rounding noise (a first step at rest:
    the x velocity after the divergence solve answers the divergence
    source's rounding noise). There a row beyond TOL_SOLVE of the plain
    version passes only if the kernel lies no further than F64_RATIO times
    the plain version's distance from the float64 solution, both relative
    to that row's own max; every other row keeps TOL_SOLVE."""
    from adaptive_sph_torch.ops import jacobi

    offs = (8, 0) if name == "hybrid_solve" else (0,)
    its = [int(st[o + jacobi.S_ITERS]) for o in offs]
    its_ref = [int(st_ref[o + jacobi.S_ITERS]) for o in offs]
    if its != its_ref:
        raise AssertionError(f"{name}: iterations {its}, plain {its_ref}")
    rows = [jacobi.M_P, jacobi.M_AX, jacobi.M_AY, jacobi.M_PERR, jacobi.M_SRC, jacobi.M_TX,
            jacobi.M_TY]
    if name == "hybrid_solve":
        rows += [jacobi.M_VX, jacobi.M_VY, jacobi.M_PDIV]
    worst_abs = worst_rel = 0.0
    for row in rows:
        e, rel = rel_err(m[row], m_ref[row])
        if not rel < TOL_SOLVE:
            if exact is None:
                raise AssertionError(f"{name} (iterations {its}) M row {row}: max rel err "
                                     f"{rel:.3e} >= {TOL_SOLVE:g}")
            ek = rel_err(m[row], exact[row])[1]
            ep = rel_err(m_ref[row], exact[row])[1]
            if not ek <= F64_RATIO * ep:
                raise AssertionError(f"{name} (iterations {its}) M row {row}: max rel err "
                                     f"{rel:.3e} >= {TOL_SOLVE:g} of the plain version, and "
                                     f"{ek:.3e} from the float64 solve against the plain "
                                     f"version's {ep:.3e}")
            log(f"{name} M row {row}: max rel err {rel:.3e} of the plain version; from the "
                f"float64 solve kernel {ek:.3e}, plain {ep:.3e} (ratio {ek / ep:.3f}, limit "
                f"{F64_RATIO:g})")
            worst_abs = max(worst_abs, e)
            continue
        worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
    return its, worst_abs, worst_rel


def solve_f64(name, a, kw):
    """M of the plain version of a whole solve in float64 (weights as stored)."""
    from adaptive_sph_torch.ops import jacobi

    csr, table, scal = a
    m, _ = getattr(jacobi, name + "_ref")(csr, table.double(), scal.double(), **kw)
    return m


def phase_solves(resident_calls):
    """pair_jacobi and pair_hybrid vs their plain versions on the impact
    scene's iterating solves, on the resident stress paths' first-step
    solves (also run to a cap) and on synthetic lists (long rows, the gate's
    largest capacity), then timed on the stress solves."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import jacobi
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import IMPACT_CAPACITY, impact_params, impact_scene
    from adaptive_sph_torch.utils.params import PressureSolverMethod as M

    errs = {"pair_jacobi": 0.0, "pair_hybrid": 0.0}
    for method, step, expect in ((M.HybridDFSPH, 4, 60), (M.OnlyDivergence, 4, 60),
                                 (M.IISPH, 5, 23)):
        sim = create_simulation(impact_params(method), impact_scene(), capacity=IMPACT_CAPACITY,
                                device="cuda", counters_enabled=False)
        for _ in range(step - 1):
            sim.step()
        calls = capture_step(sim)
        name = "hybrid_solve" if method == M.HybridDFSPH else "jacobi_solve"
        kernel = "pair_hybrid" if name == "hybrid_solve" else "pair_jacobi"
        a, kw = calls[name][0]
        m, st = getattr(jacobi, name)(*a, **kw)
        m_ref, st_ref = getattr(jacobi, name + "_ref")(*a, **kw)
        torch.cuda.synchronize()
        its, worst_abs, worst_rel = solve_agreement(name, m, st, m_ref, st_ref)
        if its[0] != expect:
            raise AssertionError(f"{kernel} on the impact scene ({method.value}, step {step}): "
                                 f"iterations {its}, expected {expect} first")
        errs[kernel] = max(errs[kernel], worst_abs)
        # at C = 1,024 the walks are short: the time per sweep is mostly the
        # two grid syncs and the exit test
        tk = time_ms(lambda: getattr(jacobi, name)(*a, **kw), 20)
        dk = device_ms(lambda: getattr(jacobi, name)(*a, **kw), 20, kernel)
        _, sweeps = solve_walks(name, st, kw)
        log(f"{kernel} vs plain, impact scene {method.value} step {step}: iterations {its} "
            f"equal, max abs err {worst_abs:.3e}, max rel err {worst_rel:.3e} (tol {TOL_SOLVE:g} "
            f"of each output's max); kernel {tk:.4f} ms (device {dk:.4f} ms), {sweeps} sweeps, "
            f"{tk / sweeps * 1e3:.2f} us per sweep (device {dk / sweeps * 1e3:.2f} us)")
        del sim

    # the main paths' own solves: C = 14,336 rows of at most 13 pairs (10.6 on
    # average), about 109 rows per block, and the bf16 instances on the bench
    # options. Each as the step gave it (2-3 sweeps), then run to a cap of
    # CAP_SWEEPS. Kernel and plain read the same stored weights (bf16 too)
    # and sum in float32: the summation order is the only difference.
    out = {}
    for kernel, tag, name in (("pair_hybrid", "hybrid", "hybrid_solve"),
                              ("pair_hybrid", "hybrid_bench", "hybrid_solve"),
                              ("pair_jacobi", "iisph", "jacobi_solve")):
        a, kw = resident_calls[tag][name][0]
        csr, table, scal = a
        # at rest the density sources are negative and every pressure clamps
        # (no normal row, so the solve stops at 2 sweeps whatever its
        # tolerance): the capped run takes |src0| + max |src0|, a compression
        # everywhere, so every solve runs its CAP_SWEEPS on normal rows
        capped = table.clone()
        src0 = capped[jacobi.T_SRC].abs()
        capped[jacobi.T_SRC] = src0 + src0.max()
        capped_scal = scal.clone()
        if name == "hybrid_solve":
            capped_scal[1:3] = 0.0
        else:
            capped_scal[1] = 0.0
        capped_kw = {**kw, "max_iters": CAP_SWEEPS}
        for what, ta, sa, skw in (
                ("as the step gave it", table, scal, kw),
                (f"source |src0| + max |src0|, tolerances 0, cap {CAP_SWEEPS}", capped,
                 capped_scal, capped_kw)):
            m, st = getattr(jacobi, name)(csr, ta, sa, **skw)
            m_ref, st_ref = getattr(jacobi, name + "_ref")(csr, ta, sa, **skw)
            torch.cuda.synchronize()
            its, worst_abs, worst_rel = solve_agreement(name, m, st, m_ref, st_ref)
            if ta is capped and any(i != CAP_SWEEPS for i in its):
                raise AssertionError(f"{kernel} [{tag}, {what}]: iterations {its}, expected the cap")
            errs[kernel] = max(errs[kernel], worst_abs)
            log(f"{kernel} vs plain, resident {tag} stress path's first step ({what}; weights "
                f"{csr.w.dtype}): iterations {its} equal, max abs err {worst_abs:.3e}, max rel "
                f"err {worst_rel:.3e} (tol {TOL_SOLVE:g} of each output's max)")
    # synthetic lists (jacobi.synthetic_inputs, tolerances 0, CAP_SWEEPS
    # sweeps): rows of 0-300 pairs, longer than a row's G lanes, and the
    # largest capacity the resident gate admits (tq 128), where a block's
    # shared memory is largest; every variant of both kernels
    gate = {}
    for wdtype in (torch.float32, torch.bfloat16):
        C = 128
        while jacobi.resident_supported(C + 128, 128, wdtype):
            C += 128
        gate[wdtype] = C
    lists = [("rows of 0-300 pairs", np.resize(LONG_ROWS, 1000), torch.float32),
             ("rows of 0-300 pairs", np.resize(LONG_ROWS, 1000), torch.bfloat16)]
    lists += [("the gate's largest capacity, rows of 8-13 pairs",
               np.random.default_rng(C).integers(8, 14, C), wdtype)
              for wdtype, C in gate.items()]
    for what, lengths, wdtype in lists:
        for kernel, name, kw in SYNTHETIC_KINDS:
            csr, table, scal = jacobi.synthetic_inputs(lengths, len(lengths), wdtype, "cuda",
                                                       hybrid=name == "hybrid_solve")
            kw = dict({"mp": 0.0, **kw}, max_iters=CAP_SWEEPS)
            m, st = getattr(jacobi, name)(csr, table, scal, **kw)
            m_ref, st_ref = getattr(jacobi, name + "_ref")(csr, table, scal, **kw)
            torch.cuda.synchronize()
            its, worst_abs, worst_rel = solve_agreement(name, m, st, m_ref, st_ref)
            if any(i != CAP_SWEEPS for i in its):
                raise AssertionError(f"{kernel} [{what}]: iterations {its}, expected the cap")
            m2, st2 = getattr(jacobi, name)(csr, table, scal, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(m2, m) and torch.equal(st2.nan_to_num(), st.nan_to_num())):
                raise AssertionError(f"{kernel} [{what}]: a second launch differs")
            errs[kernel] = max(errs[kernel], worst_abs)
            C = len(lengths)
            grid = int(st[jacobi.S_GRID])
            log(f"{kernel} vs plain, synthetic {what} (C = {C}, {csr.num_pairs} pairs, weights "
                f"{wdtype}, {', '.join(f'{k}={v}' for k, v in kw.items())}): iterations {its} "
                f"equal, max abs err {worst_abs:.3e}, max rel err {worst_rel:.3e} (tol "
                f"{TOL_SOLVE:g} of each output's max); a second launch bit-identical; grid "
                f"{grid} blocks, {jacobi.solve_smem_bytes(C, grid, kw.get('w2020', False))} B "
                f"of shared memory each")

    for kernel, tag, name in (("pair_hybrid", "hybrid", "hybrid_solve"),
                              ("pair_jacobi", "iisph", "jacobi_solve")):
        a, kw = resident_calls[tag][name][0]
        _, st = getattr(jacobi, name)(*a, **kw)
        tk = time_ms(lambda: getattr(jacobi, name)(*a, **kw), 20)
        dk = device_ms(lambda: getattr(jacobi, name)(*a, **kw), 20, kernel)
        tr = time_ms(lambda: getattr(jacobi, name + "_ref")(*a, **kw), 3)
        walks, sweeps = solve_walks(name, st, kw)
        b = solve_bound(name, a, kw, st)
        out[kernel] = (errs[kernel], tk, tr, b, None)
        C, grid = a[1].shape[1], int(st[jacobi.S_GRID])
        log(f"{kernel} on the resident {tag} stress path's first step (C = {C}, "
            f"{a[0].num_pairs} pairs; grid {grid} x {jacobi.SOLVE_THREADS} threads, "
            f"{jacobi.SOLVE_G} lanes per row, "
            f"{jacobi.solve_smem_bytes(C, grid, kw.get('w2020', False))} B of shared memory per "
            f"block): {sweeps} sweeps, {walks} pair walks; kernel {tk:.4f} ms per "
            f"solve (device {dk:.4f} ms), {tk / sweeps:.4f} ms per sweep (device "
            f"{dk / sweeps:.4f} ms); plain {tr:.4f} ms; bound {b[0]:.5f} ms ({b[1]})")
    torch.cuda.empty_cache()
    return out


def phase_wcsph_build():
    """K1 with the WCSPH viscosity against its plain version at the stress
    scene's first-step shapes (seeded velocities): the mega walk with its
    stream (two rows, and scalar-g) and the classic walk (rho from the
    DENSITY sweep), f32 and bf16 storage. Pair structure equal bit for bit,
    prep rows within TOL_F32 of the column max, stored entries within
    TOL_F32 (TOL_BF16 in bf16)."""
    import dataclasses

    import numpy as np
    import torch
    from adaptive_sph_torch.models import tile_physics as tp
    from adaptive_sph_torch.models.tile_step import physics_scale, step_geometry
    from adaptive_sph_torch.ops import pair_ops, sweeps
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.utils.params import ViscosityType

    dev = torch.device("cuda")
    out = {}
    for bench in (False, True):
        tag = "bf16" if bench else "f32"
        params = dataclasses.replace(stress_params(bench), viscosity_type=ViscosityType.WCSPH)
        sim = create_simulation(params, stress_scene(), device=dev, counters_enabled=False)
        tcfg = sim.tile_cfg
        _, bins, cols, wm = step_geometry(sim.state, sim.params, tcfg)
        wdtype = torch.bfloat16 if bench else torch.float32
        wb = 2 if bench else 4
        rng = np.random.default_rng(7)
        C = tcfg.capacity
        flat = cols["flat"].clone()
        live = (flat[:, 2] > 0).float()[:, None]
        seeded = rng.normal(0, 0.4, (C, 2)).astype(np.float32)
        flat[:, 4:6] = torch.from_numpy(seeded).to(dev) * live
        scale = float(physics_scale(sim.params))
        rho = sweeps.pair_sweep(bins.cell_starts, wm, flat[:, 0:4].contiguous(), None,
                                tp.DENSITY_OP, scale, tcfg.tq)[:, 0]
        rho = torch.where(live[:, 0] > 0, rho, torch.ones_like(rho))
        cand = torch.cat([flat[:, 0:4], rho[:, None], flat[:, 4:6]], 1).contiguous()
        nu = float(params.viscosity)
        for mode in ("mega", "scalar", "classic"):
            classic = mode == "classic"
            args = (bins.cell_starts, wm, cand if classic else flat, tcfg.tq, scale, nu,
                    not classic, wdtype)
            kw = dict(classic=classic, scalar=mode == "scalar", wcsph=True)
            k = pair_ops.pair_build(*args, **kw)
            r = pair_ops.pair_build_ref(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(k.row_ptr, r.row_ptr) and torch.equal(k.col, r.col)):
                raise AssertionError(f"K1 WCSPH {mode} [{tag}]: pair structure differs from the "
                                     f"plain version")
            tol_w = TOL_BF16 if bench else TOL_F32
            stored = {"mega": ("w", "s"), "scalar": ("g", "sg"), "classic": ("w",)}[mode]
            worst_abs = worst_rel = 0.0
            checks = [(n, getattr(k, n), getattr(r, n), tol_w) for n in stored]
            checks.append(("prep", k.prep, r.prep, TOL_F32))
            for name, got, want, tol in checks:
                rows = got if got.dim() == 2 else got[None]
                wants = want if want.dim() == 2 else want[None]
                for row in range(rows.shape[0]):
                    e, rel = rel_err(rows[row], wants[row])
                    if not rel < tol:
                        raise AssertionError(f"K1 WCSPH {mode} [{tag}] {name}[{row}]: max rel "
                                             f"err {rel:.3e} >= {tol:g}")
                    worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
            signal = r.prep[6:8] if classic else getattr(r, stored[-1]).float()
            if float(signal.abs().max()) <= 0:
                raise AssertionError(f"K1 WCSPH {mode} [{tag}]: the viscosity terms are all zero")
            tk = time_ms(lambda: pair_ops.pair_build(*args, **kw), 20)
            dk = device_ms(lambda: pair_ops.pair_build(*args, **kw), 5)
            tr = time_ms(lambda: pair_ops.pair_build_ref(*args, **kw), 3)
            P = k.num_pairs
            if classic:
                b = bound_ms(C * 28 + (C + 1) * 4 + P * (4 + 2 * wb) + C * 32,
                             P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_CLASSIC))
            else:
                per_pair = 4 + (2 if mode == "scalar" else 4) * wb
                b = bound_ms(C * 24 + (C + 1) * 4 + P * per_pair + C * 16,
                             P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_WCSPH))
            log(f"K1 pair_build WCSPH {mode} [{tag}] (the stress scene's first step, seeded "
                f"velocities): {P} pairs, structure equal, max abs err {worst_abs:.3e}, max rel "
                f"err {worst_rel:.3e} (tol {tol_w:g} stored, {TOL_F32:g} prep rows); kernel "
                f"{tk:.4f} ms (device {dk:.4f} ms), plain {tr:.4f} ms, bound {b[0]:.4f} ms "
                f"({b[1]})")
            out[mode, tag] = (worst_abs, tk, tr, b, None)
        del sim
        torch.cuda.empty_cache()
    # the kernels line: the mega walk with its stream in f32, and its own error
    return out["mega", "f32"]


def phase_solver_sweeps(inputs):
    """The visc (ApproxLaplace, WCSPH) and omega sweeps against their plain
    versions on the layouts of the default dam break's and the resident
    stress path's first steps (seeded densities and velocities): sums within
    TOL_F32 of the column max."""
    import dataclasses

    import numpy as np
    import torch
    from adaptive_sph_torch.models import tile_physics as tp
    from adaptive_sph_torch.ops import sweeps
    from adaptive_sph_torch.stress import stress_params
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.utils.params import ViscosityType

    p = stress_params()
    ops = {"visc_laplace": tp.visc_op(p),
           "visc_wcsph": tp.visc_op(dataclasses.replace(p, viscosity_type=ViscosityType.WCSPH)),
           "omega": tp.OMEGA_OP}
    scale = 2.0
    out = {}
    for where, (cs, wm, st, tq) in inputs.items():
        C = st.shape[0]
        rng = np.random.default_rng(5)
        dyn = torch.from_numpy(np.stack([rng.uniform(950.0, 1050.0, C), rng.normal(0, 0.5, C),
                                         rng.normal(0, 0.5, C)], 1).astype(np.float32)).cuda()
        tested, inside = pair_census(cs, wm, st, scale, tq)
        for name, op in ops.items():
            d = dyn if op.dyn_names else None
            got = sweeps.pair_sweep(cs, wm, st, d, op, scale, tq)
            ref = sweeps.pair_sweep_ref(cs, wm, st, d, op, scale, tq)
            torch.cuda.synchronize()
            g, r = got.double(), ref.double()
            err = float((g - r).abs().max())
            rel = float(((g - r).abs() / (r.abs().amax(0, keepdim=True) + 1e-30)).max())
            if not rel < TOL_F32 or float(r.abs().max()) <= 0:
                raise AssertionError(f"pair_sweep {name} on {where}: rel err {rel:.3e} (tol "
                                     f"{TOL_F32:g}), max |plain| {float(r.abs().max()):.3e}")
            D = 0 if d is None else d.shape[1]
            b = bound_ms(C * 16 + C * D * 4 + C * op.n_out * 4 + cs.numel() * 4 + wm.numel() * 4,
                         inside * (OPS_PAIR_GEOM + OPS_SWEEP_EMIT[name]))
            tk = time_ms(lambda: sweeps.pair_sweep(cs, wm, st, d, op, scale, tq), 50)
            dk = device_ms(lambda: sweeps.pair_sweep(cs, wm, st, d, op, scale, tq), 20,
                           "pair_sweep_kernel")
            tr = time_ms(lambda: sweeps.pair_sweep_ref(cs, wm, st, d, op, scale, tq), 3)
            log(f"pair_sweep {name} on {where} (C = {C}): {tested} tested pairs, {inside} "
                f"inside the radius; rel err {rel:.3e} (tol {TOL_F32:g} of the column max), max "
                f"abs err {err:.3e}; kernel {tk:.4f} ms (device {dk:.4f} ms), plain {tr:.4f} "
                f"ms, bound {b[0]:.5f} ms ({b[1]})")
            key = "omega" if name == "omega" else "visc"
            prev = out.get(key)
            # the kernels line: the stress step's launch (the main path's shape)
            out[key] = (max(err, prev[0]) if prev else err, tk, tr, b, None)
    return out


def phase_w2020_solves(solver_calls):
    """pair_jacobi / pair_hybrid in the Winchenbach2020 mode (and pair_jacobi
    with IISPH2's 1 / Omega source) against their plain versions: on the
    impact scene's iterating solves and on the resident stress paths' first
    steps (as the step gave them, and to a cap of CAP_SWEEPS with tolerances
    0), each launched twice (iteration counts equal, outputs within
    TOL_SOLVE of their max, the second launch bit-identical); then timed per
    solve and per sweep, and an empty list's sweep in both modes (the grid
    syncs and the exit test alone)."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import jacobi
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import IMPACT_CAPACITY, impact_params, impact_scene
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.utils.params import OperatorDiscretization, PressureSolverMethod

    def check(what, kernel, name, a, kw, expect=None, exact=False):
        m, st = getattr(jacobi, name)(*a, **kw)
        m2, st2 = getattr(jacobi, name)(*a, **kw)
        m_ref, st_ref = getattr(jacobi, name + "_ref")(*a, **kw)
        m64 = solve_f64(name, a, kw) if exact else None
        torch.cuda.synchronize()
        its, worst_abs, worst_rel = solve_agreement(name, m, st, m_ref, st_ref, m64)
        if expect is not None and its[0] != expect:
            raise AssertionError(f"{kernel} [{what}]: iterations {its}, expected {expect} first")
        if not (torch.equal(m2, m) and torch.equal(st2.nan_to_num(), st.nan_to_num())):
            raise AssertionError(f"{kernel} [{what}]: a second launch differs")
        tk = time_ms(lambda: getattr(jacobi, name)(*a, **kw), 20)
        dk = device_ms(lambda: getattr(jacobi, name)(*a, **kw), 20, kernel)
        walks, sweeps = solve_walks(name, st, kw)
        C, grid = a[1].shape[1], int(st[jacobi.S_GRID])
        log(f"{kernel} vs plain, {what} (C = {C}, {a[0].num_pairs} pairs, weights "
            f"{a[0].w.dtype}, w2020 {kw.get('w2020', False)}): iterations {its} equal, max abs "
            f"err {worst_abs:.3e}, max rel err {worst_rel:.3e} (tol {TOL_SOLVE:g}); a second "
            f"launch bit-identical; grid {grid} blocks, "
            f"{jacobi.solve_smem_bytes(C, max(grid, 1), kw.get('w2020', False))} B of shared "
            f"memory each; kernel "
            f"{tk:.4f} ms per solve (device {dk:.4f} ms), {sweeps} sweeps, "
            f"{dk / sweeps * 1e3:.2f} us per sweep on the device")
        return worst_abs, tk, dk, st

    errs = {"pair_jacobi": 0.0, "pair_hybrid": 0.0}
    out = {}
    M = PressureSolverMethod
    W2020 = OperatorDiscretization.Winchenbach2020
    for method, step, expect in W2020_IMPACT:
        sim = create_simulation(
            impact_params(M(method), operator_discretization=W2020),
            impact_scene(), capacity=IMPACT_CAPACITY, device="cuda", counters_enabled=False)
        for _ in range(step - 1):
            sim.step()
        calls = capture_step(sim)
        name = "hybrid_solve" if method == "HybridDFSPH" else "jacobi_solve"
        kernel = "pair_hybrid" if name == "hybrid_solve" else "pair_jacobi"
        a, kw = calls[name][0]
        if not kw.get("w2020"):
            raise AssertionError(f"the impact scene's Winchenbach2020 step ran {name} without "
                                 f"w2020")
        e, tk, dk, st = check(f"impact scene, Winchenbach2020 {method} step {step}", kernel, name,
                              a, kw, expect)
        errs[kernel] = max(errs[kernel], e)
        if method == "IISPH":
            tr = time_ms(lambda: jacobi.jacobi_solve_ref(*a, **kw), 3)
            out["pair_jacobi:w2020"] = (tk, tr, solve_bound(name, a, kw, st))
        del sim
    for run, name in (("stress_w2020_hybrid_resident", "hybrid_solve"),
                      ("stress_iisph2_wcsph_resident", "jacobi_solve")):
        kernel = "pair_hybrid" if name == "hybrid_solve" else "pair_jacobi"
        a, kw = solver_calls[run][name][0]
        csr, table, scal = a
        # at rest the hybrid's post-divergence x velocity is the response to
        # the divergence source's rounding noise: its rows are also held to a
        # float64 solve (solve_agreement), here and to the cap below
        hybrid = name == "hybrid_solve"
        e, tk, dk, st = check(f"{run}'s first step as the step gave it", kernel, name, a, kw,
                              exact=hybrid)
        # the kernels line's w2020 entries take the w2020 launches' errors only
        errs[kernel] = max(errs[kernel], e if kw.get("w2020") else 0.0)
        if hybrid:
            tr = time_ms(lambda: jacobi.hybrid_solve_ref(*a, **kw), 3)
            out["pair_hybrid:w2020"] = (tk, tr, solve_bound(name, a, kw, st))
        capped = table.clone()
        src0 = capped[jacobi.T_SRC].abs()
        capped[jacobi.T_SRC] = src0 + src0.max()
        cscal = scal.clone()
        cscal[1:3 if hybrid else 2] = 0.0
        e, *_ = check(f"{run}'s first step, source |src0| + max |src0|, tolerances 0, cap "
                      f"{CAP_SWEEPS}", kernel, name, (csr, capped, cscal),
                      {**kw, "max_iters": CAP_SWEEPS}, CAP_SWEEPS, exact=hybrid)
        errs[kernel] = max(errs[kernel], e if kw.get("w2020") else 0.0)
    # an empty list of 8,192 rows: a sweep is its two grid syncs and the exit test
    for w2020 in (False, True):
        csr, table, scal = jacobi.synthetic_inputs(np.zeros(8192, np.int64), 8192,
                                                   torch.float32, "cuda")
        kw = dict(density_type=False, write_perr=False, src_from_div=False, max_iters=200,
                  mp=0.0, w2020=w2020)
        _, st = jacobi.jacobi_solve(csr, table, scal, **kw)
        dk = device_ms(lambda: jacobi.jacobi_solve(csr, table, scal, **kw), 10, "pair_jacobi")
        sweeps = int(st[jacobi.S_ITERS]) + 1
        log(f"pair_jacobi on an empty list of 8,192 rows, w2020 {w2020}: {sweeps} sweeps, device "
            f"{dk:.4f} ms per solve, {dk / sweeps * 1e3:.3f} us per sweep")
    torch.cuda.empty_cache()
    return {k: (errs[k.split(":")[0]], *v, None) for k, v in out.items()}


def capture_solver_inputs():
    """The first-step kernel inputs of the resident stress runs of
    stress.solver_runs (Winchenbach2020 hybrid; IISPH2 with WCSPH)."""
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import solver_runs

    runs = solver_runs()
    out = {}
    for run in ("stress_w2020_hybrid_resident", "stress_iisph2_wcsph_resident"):
        params, scene, capacity, _ = runs[run]
        sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                                device="cuda", counters_enabled=False)
        out[run] = capture_step(sim)
    return out


# the kernels (and modes) each run of stress.solver_runs must launch, and
# those it must not
SOLVER_RUN_KERNELS = {
    "stress_w2020_hybrid": (("pair_build", "pair_sweep", "pair_matvec"),
                            ("pair_hybrid", "pair_jacobi", "pair_visc")),
    "stress_w2020_hybrid_resident": (("pair_build", "pair_sweep", "pair_hybrid:w2020"),
                                     ("pair_matvec", "pair_jacobi")),
    "stress_iisph2_wcsph_resident": (("pair_build:wcsph", "pair_sweep:omega", "pair_jacobi",
                                      "pair_matvec"), ("pair_jacobi:w2020", "pair_hybrid")),
    "stress_wcsph_visc_after_div": (("pair_build", "pair_sweep:visc", "pair_matvec"),
                                    ("pair_build:wcsph", "pair_visc", "pair_hybrid")),
    "impact_w2020_hybrid": (("pair_hybrid:w2020",), ("pair_matvec",)),
    "impact_w2020_iisph": (("pair_jacobi:w2020",), ("pair_hybrid",)),
    "impact_w2020_only_divergence": (("pair_jacobi:w2020",), ("pair_hybrid",)),
    "winchenbach_instabilities": (("pair_build", "pair_sweep", "pair_matvec"),
                                  ("pair_jacobi", "pair_hybrid")),
}


@contextlib.contextmanager
def count_plain_calls():
    """{name: calls} of the kernels' plain versions while the block runs (on
    CUDA tensors the wrappers never call them)."""
    from adaptive_sph_torch.ops import jacobi, pair_ops, sweeps

    targets = [(pair_ops, n) for n in ("pair_build_ref", "pair_matvec_ref", "pair_visc_ref",
                                       "pair_matvec_scalar_ref", "pair_visc_scalar_ref",
                                       "pair_weights_ref")]
    targets += [(sweeps, "pair_sweep_ref"), (jacobi, "jacobi_solve_ref"),
                (jacobi, "hybrid_solve_ref")]
    calls = {n: 0 for _, n in targets}
    real = {n: getattr(m, n) for m, n in targets}

    def spy(name):
        def f(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return f

    try:
        for m, n in targets:
            setattr(m, n, spy(n))
        yield calls
    finally:
        for m, n in targets:
            setattr(m, n, real[n])


def phase_solver_trajectories():
    """Every run of stress.solver_runs on the GPU against
    tests/data/torch_port_solvers_ref.npz: the launch counts set to 0 just
    before each run and read just after (its kernels and modes must have
    launched, no plain version may have run); per-step iteration and
    negative-a_ii counts equal, dt within 1e-4; then the matched state
    (positions 2e-5, density rtol 2e-5, velocity 2e-4; resident runs'
    pressure rtol 5e-3 / atol 1e-2). The media configuration is chaotic by
    design (stress.MEDIA_STEPS): it is held to its per-step counts and its
    census, its state only logged. Returns the launches summed over the
    runs."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import solver_runs

    ref = np.load(SOLVER_FIXTURE)
    total = {}
    per_step_keys = ("div_iterations", "density_iterations", "negative_aii")
    for run, (params, scene, capacity, steps) in solver_runs().items():
        sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                                device="cuda", counters_enabled=False)
        recs = {k: [] for k in per_step_keys}
        dts = []
        with count_plain_calls() as plain:
            pair_ops.reset_launches()
            for _ in range(steps):
                d = sim.step()
                for k in per_step_keys:
                    recs[k].append(int(d.get(k, -1)))
                dts.append(d["dt"])
            torch.cuda.synchronize()
            launches = dict(pair_ops.launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        required, absent = SOLVER_RUN_KERNELS[run]
        bad = [f"{k} {v} != {ref[f'{run}__{k}'].tolist()}" for k, v in recs.items()
               if v != ref[f"{run}__{k}"].tolist()]
        ddt = float(np.abs(np.asarray(dts) / ref[f"{run}__dt"] - 1.0).max())
        if ddt >= 1e-4:
            bad.append(f"dt rel err {ddt:.3e}")
        bad += [f"{k} never launched" for k in required if launches[k] <= 0]
        bad += [f"{k} launched {launches[k]} times" for k in absent if launches[k] != 0]
        if any(plain.values()):
            bad.append(f"plain versions ran: {plain}")
        st = sim.state
        a = st.alive.cpu().numpy()
        got = {k: getattr(st, k).cpu().numpy()[a] for k in ("position", "velocity", "density",
                                                              "pressure")}
        want = {k: ref[f"{run}__{k}"] for k in got}
        if len(got["position"]) != len(want["position"]):
            raise AssertionError(f"{run}: particle count differs from the reference")
        finite = all(np.isfinite(v).all() for v in got.values())
        media = run == "winchenbach_instabilities"
        j = match_by_position(got["position"], want["position"]) if not media else None
        if media:
            from scipy.spatial import cKDTree

            _, j = cKDTree(want["position"]).query(got["position"], k=1)
        dx = float(np.abs(got["position"] - want["position"][j]).max())
        drho = float(np.abs(got["density"] / want["density"][j] - 1).max())
        dv = float(np.abs(got["velocity"] - want["velocity"][j]).max())
        pw = want["pressure"][j]
        dp = float(np.abs(got["pressure"] - pw).max())
        p_ok = bool((np.abs(got["pressure"] - pw) <= 1e-2 + 5e-3 * np.abs(pw)).all())
        mode_counts = {k: v for k, v in launches.items() if v and (":" in k or k in required)}
        log(f"solver run {run} vs JAX ({steps} steps, n={len(got['position'])}): div iterations "
            f"{recs['div_iterations'][:12]}{'...' if steps > 12 else ''}, density iterations "
            f"{recs['density_iterations'][:12]}{'...' if steps > 12 else ''}, negative a_ii "
            f"{sum(recs['negative_aii'])} in all; max |dx| {dx:.3e} (tol 2e-5), rel drho "
            f"{drho:.3e} (2e-5), |dv| {dv:.3e} (2e-4), |dp| {dp:.3e}, rel ddt {ddt:.3e} (1e-4)"
            f"{'; state logged only (chaotic configuration)' if media else ''}; launches "
            f"{mode_counts}; plain-version calls {sum(plain.values())}")
        if not finite:
            bad.append("non-finite state")
        if not media and not (dx < 2e-5 and drho < 2e-5 and dv < 2e-4):
            bad.append("state beyond tolerance")
        if params.resident_solver and not p_ok:
            bad.append("pressure beyond tolerance")
        if bad:
            raise AssertionError(f"solver run {run}: " + "; ".join(bad))
        del sim
    torch.cuda.empty_cache()
    return total


def phase_resident_trajectories():
    """The resident runs on the GPU against the JAX fixture: iteration counts
    equal at every step, dt within 1e-4, then the matched state."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import resident_runs

    ref = np.load(RESIDENT_FIXTURE)
    for run, (params, scene, capacity, steps) in resident_runs().items():
        sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                                device="cuda", counters_enabled=False)
        its = {"div_iterations": [], "density_iterations": []}
        dts = []
        for _ in range(steps):
            d = sim.step()
            for k in its:
                its[k].append(int(d.get(k, -1)))
            dts.append(d["dt"])
        bad = [f"{k} {v} != {ref[f'{run}__{k}'].tolist()}" for k, v in its.items()
               if v != ref[f"{run}__{k}"].tolist()]
        ddt = float(np.abs(np.asarray(dts) / ref[f"{run}__dt"] - 1.0).max())
        if ddt >= 1e-4:
            bad.append(f"dt rel err {ddt:.3e}")
        st = sim.state
        a = st.alive.cpu().numpy()
        got = {k: getattr(st, k).cpu().numpy()[a] for k in ("position", "velocity", "density",
                                                              "pressure")}
        want = {k: ref[f"{run}__{k}"] for k in got}
        if len(got["position"]) != len(want["position"]):
            raise AssertionError(f"resident {run}: particle count differs from the reference")
        j = match_by_position(got["position"], want["position"])
        dx = float(np.abs(got["position"] - want["position"][j]).max())
        drho = float(np.abs(got["density"] / want["density"][j] - 1).max())
        dv = float(np.abs(got["velocity"] - want["velocity"][j]).max())
        pw = want["pressure"][j]
        dp = float(np.abs(got["pressure"] - pw).max())
        p_ok = bool((np.abs(got["pressure"] - pw) <= 1e-2 + 5e-3 * np.abs(pw)).all())
        log(f"resident {run} vs JAX ({steps} steps, n={len(j)}): div iterations "
            f"{its['div_iterations']}, density iterations {its['density_iterations']}; max |dx| "
            f"{dx:.3e} (tol 2e-5), rel drho {drho:.3e} (2e-5), |dv| {dv:.3e} (2e-4), |dp| "
            f"{dp:.3e} (rtol 5e-3, atol 1e-2), rel ddt {ddt:.3e} (1e-4)")
        if not (dx < 2e-5 and drho < 2e-5 and dv < 2e-4 and p_ok):
            bad.append("state beyond tolerance")
        if bad:
            raise AssertionError(f"resident {run}: " + "; ".join(bad))
        del sim
    torch.cuda.empty_cache()


def match_by_position(pa, pb):
    """Index j with pb[j] nearest to pa; asserts a bijection."""
    import numpy as np
    from scipy.spatial import cKDTree

    _, j = cKDTree(pb).query(pa, k=1)
    if not (np.sort(j) == np.arange(len(pb))).all():
        raise AssertionError("position match is not a bijection")
    return j


def phase_trajectory(fixture=FIXTURE, tag="trajectory"):
    """10 parity steps on the GPU against a JAX reference fixture."""
    import numpy as np
    import torch
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene

    ref = np.load(fixture)
    sim = create_simulation(stress_params(False), stress_scene(), device="cuda",
                            counters_enabled=False)
    div_it, den_it, dts = [], [], []
    for _ in range(STEPS_TRAJ):
        d = sim.step()
        div_it.append(d["div_iterations"])
        den_it.append(d["density_iterations"])
        dts.append(d["dt"])
    st = sim.state
    alive = st.alive.cpu().numpy()
    pos = st.position.cpu().numpy()[alive]
    vel = st.velocity.cpu().numpy()[alive]
    rho = st.density.cpu().numpy()[alive]
    if len(pos) != len(ref["position"]):
        raise AssertionError(f"particle count {len(pos)} != reference {len(ref['position'])}")
    j = match_by_position(pos, ref["position"])
    dpos = float(np.abs(pos - ref["position"][j]).max())
    drho = float(np.abs(rho / ref["density"][j] - 1.0).max())
    dvel = float(np.abs(vel - ref["velocity"][j]).max())
    ddt = float(np.abs(np.asarray(dts, np.float32) - ref["dt"]).max())
    log(f"{tag} vs JAX ({STEPS_TRAJ} steps, n={len(pos)}): max |dx| {dpos:.3e} (tol 2e-5), "
        f"max rel drho {drho:.3e} (tol 2e-5), max |dv| {dvel:.3e} (tol 2e-4), max |ddt| {ddt:.3e}")
    log(f"  div iterations {div_it} (JAX {ref['div_iterations'].tolist()}), density iterations "
        f"{den_it} (JAX {ref['density_iterations'].tolist()})")
    if not (dpos < 2e-5 and drho < 2e-5 and dvel < 2e-4):
        raise AssertionError(f"{tag} differs from the JAX reference beyond tolerance")
    if div_it != ref["div_iterations"].tolist() or den_it != ref["density_iterations"].tolist():
        raise AssertionError(f"{tag}: solver iteration counts differ from the JAX reference")
    del sim
    torch.cuda.empty_cache()


def phase_dambreak_trajectory():
    """10 steps of the default dam break on the GPU against the JAX fixture:
    per-step census and counts equal, then the matched state."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import scene
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.utils.params import load_params

    ref = np.load(DAMBREAK_FIXTURE)
    sim = create_simulation(load_params(CONFIG), scene.load_scene(SCENE), device="cuda",
                            counters_enabled=False)
    ints = ("n", "capacity", "div_iterations", "density_iterations", "shares",
            "merge_or_split_count", "split_deferred")
    for k in range(len(ref["n"])):
        d = sim.step()
        d = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
        bad = [f"{x} {d[x]} != {int(ref[x][k])}" for x in ints if int(d[x]) != int(ref[x][k])]
        if np.float32(d["dt"]) != ref["dt"][k]:
            bad.append(f"dt {d['dt']} != {ref['dt'][k]}")
        if bad:
            raise AssertionError(f"dam break step {k + 1}: " + "; ".join(bad))
    st = sim.state
    a = st.alive.cpu().numpy()
    got = {x: getattr(st, x).cpu().numpy()[a] for x in ("position", "velocity", "density",
                                                        "mass", "level")}
    if len(got["position"]) != len(ref["position"]):
        raise AssertionError("dam break particle count differs from the reference")
    j = match_by_position(ref["position"], got["position"])
    dev = {"dx": float(np.abs(got["position"][j] - ref["position"]).max()),
           "drho_rel": float(np.abs(got["density"][j] / ref["density"] - 1).max()),
           "dv": float(np.abs(got["velocity"][j] - ref["velocity"]).max()),
           "dm_rel": float(np.abs(got["mass"][j] / ref["mass"] - 1).max()),
           "dlevel": float(np.abs(got["level"][j] - ref["level"]).max())}
    log(f"dam break vs JAX ({len(ref['n'])} steps, n {ref['n'].tolist()}): census, capacity, "
        f"resampling counts, dt and iterations equal at every step; max |dx| {dev['dx']:.3e} "
        f"(tol 2e-5), rel drho {dev['drho_rel']:.3e} (2e-5), |dv| {dev['dv']:.3e} (2e-4), "
        f"rel dm {dev['dm_rel']:.3e} (1e-5), |dlevel| {dev['dlevel']:.3e} (2e-5)")
    if not (dev["dx"] < 2e-5 and dev["drho_rel"] < 2e-5 and dev["dv"] < 2e-4
            and dev["dm_rel"] < 1e-5 and dev["dlevel"] < 2e-5):
        raise AssertionError("dam break state differs from the JAX reference beyond tolerance")
    del sim
    torch.cuda.empty_cache()


def timed_dambreak():
    """The default dam break through create_simulation (timed), then through
    the CLI entry point; returns the launch counts of the timed run."""
    import numpy as np
    import torch
    from adaptive_sph_torch import cli
    from adaptive_sph_torch.models import scene
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.utils.params import load_params

    params = load_params(CONFIG)
    sim = create_simulation(params, scene.load_scene(SCENE), device="cuda")
    n0, cap0 = sim.num_fluid_particles, sim.state.capacity
    # the census of the step's CSR lists: each K1 call's row pointers and
    # its table's h column (live rows: h > 0), kept as references and read
    # after the run, so the spy adds no device work or host read
    lists, real = [], pair_ops.pair_build

    def spy(cell_starts, wm, flat, *a, **k):
        csr = real(cell_starts, wm, flat, *a, **k)
        lists.append((csr.row_ptr, flat[:, 2]))
        return csr

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair_ops.reset_launches()
    pair_ops.pair_build = spy
    try:
        t0 = time.perf_counter()
        diags = sim.step_chunk(STEPS_DAMBREAK)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
    finally:
        pair_ops.pair_build = real
    launches = dict(pair_ops.launches)
    per_row = torch.cat([(rp[1:] - rp[:-1])[h > 0].float() for rp, h in lists])
    slots = np.asarray([h.numel() for _, h in lists])
    live = np.asarray([int((h > 0).sum()) for _, h in lists])
    log(f"dam break CSR rows over {len(lists)} steps' lists: pairs per live row mean "
        f"{float(per_row.mean()):.2f}, p99 {float(torch.quantile(per_row, 0.99)):.0f}, max "
        f"{int(per_row.max())}; live rows {live.min()}-{live.max()} of {slots.min()}-"
        f"{slots.max()} slots")
    del lists
    st = sim.state
    alive = st.alive
    for name in ("position", "velocity", "density", "mass", "level"):
        if not bool(torch.isfinite(getattr(st, name)[alive]).all()):
            raise AssertionError(f"non-finite {name} after the timed dam break")
    if max(diags["mass_conservation_error"]) >= 0.005:
        raise AssertionError("mass not conserved in the timed dam break")
    counts = np.asarray(diags["particle_count"], np.float64)
    growths = sim.counters.values.get("capacity-growth", [])
    log(f"timed dam break: {STEPS_DAMBREAK} steps, {el / STEPS_DAMBREAK * 1e3:.4f} ms/step, "
        f"{counts.sum() / el:.1f} particle updates/s, n {n0} -> {sim.num_fluid_particles} "
        f"(mean {counts.mean():.1f}), capacity {cap0} -> {st.capacity} "
        f"({len(growths)} growths), t = {sim.time:.4f} s, wavefront sweeps/step "
        f"{np.mean(diags['wavefront_sweeps']):.2f}, pair_sweep launches/step "
        f"{launches['pair_sweep'] / STEPS_DAMBREAK:.2f}, mean div / density iters "
        f"{np.mean(diags['div_iterations']):.2f} / {np.mean(diags['density_iterations']):.2f}, "
        f"pairs/step {np.mean(diags['num_pairs']):.1f}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches {launches}")
    del sim
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = cli.main(["run", CONFIG, SCENE, "--max-steps", str(STEPS_CLI)])
    if rc != 0:
        raise AssertionError(f"adaptive_sph_torch.cli run returned {rc}")
    log(f"cli run: {STEPS_CLI} steps on the default device in {time.perf_counter() - t0:.2f} s")
    return launches


def timed_path(params, tag: str, required=(), absent=()):
    """100 timed steps after 10 warm-up steps (the launch counts set to 0
    just before the timed run and read just after; `required` kernels must
    have launched, `absent` ones not), then STEPS_PROFILED steps under
    torch.profiler for the host synchronisations per step and the
    device-busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_scene
    from adaptive_sph_torch.utils.params import PressureSolverMethod

    sim = create_simulation(params, stress_scene(), device="cuda", counters_enabled=False)
    n = sim.num_fluid_particles
    for _ in range(WARMUP):
        sim.step()
    torch.cuda.synchronize()
    pair_ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    diags = sim.step_chunk(STEPS_TIMED)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    launches = dict(pair_ops.launches)
    st = sim.state
    alive = st.alive
    for name in ("position", "velocity", "density", "pressure"):
        v = getattr(st, name)[alive]
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {name} after the timed run")
    # every density solve ends inside its tolerance unless it ran to max_iters
    # (NaN: no unclamped particle, trivially converged)
    iisph = params.pressure_solver_method in (PressureSolverMethod.IISPH,
                                              PressureSolverMethod.IISPH2)
    tol_den = (params.iisph_max_avg_density_error if iisph
               else params.hybrid_dfsph_max_avg_density_error) * params.rest_density
    errs = np.asarray(diags["density_avg_error"], np.float64)
    capped = np.asarray(diags["density_iterations"]) >= params.max_iters
    above = np.isfinite(errs) & (np.abs(errs) >= tol_den) & ~capped
    if above.any():
        raise AssertionError(f"{int(above.sum())} density solves exited above their tolerance")
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {tag} path: {missing}")
    stray = [k for k in absent if launches[k] != 0]
    if stray:
        raise AssertionError(f"kernels launched on the {tag} path that must not be: {stray}")
    ms = el / STEPS_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step_chunk(STEPS_PROFILED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    syncs = sum(e.count for e in events if "Synchronize" in e.key) / STEPS_PROFILED
    div = f"{np.mean(diags['div_iterations']):.2f}" if "div_iterations" in diags else "-"
    log(f"timed {tag}: {STEPS_TIMED} steps, {ms:.4f} ms/step, {n * STEPS_TIMED / el:.1f} "
        f"updates/s (n={n}), mean div iters {div}, mean density iters "
        f"{np.mean(diags['density_iterations']):.2f}, pairs/step "
        f"{int(np.mean(diags['num_pairs']))}, peak mem {peak:.1f} MiB, launches {launches}; "
        f"{STEPS_PROFILED} profiled steps: {syncs:.1f} host synchronisations per step, device "
        f"busy {dev_us / 1e3 / (wall * 1e3):.3f} of wall, {dev_us / 1e3 / STEPS_PROFILED:.4f} ms "
        f"device time per step")
    del sim
    torch.cuda.empty_cache()
    return launches


def phase_timing():
    """adaptive_sph_torch.timing.main at x1, in this process (it prints its
    stage table); the launch counts are set to 0 just before and read just
    after: the weights-only walk must have launched."""
    from adaptive_sph_torch import timing
    from adaptive_sph_torch.ops import pair_ops

    pair_ops.reset_launches()
    stages = timing.main(["1"])
    launches = dict(pair_ops.launches)
    if launches["pair_weights"] <= 0:
        raise AssertionError("adaptive_sph_torch.timing never launched pair_weights")
    log(f"timing x1: {len(stages)} stages timed, launches {launches}")
    return launches


def phase_probe():
    """adaptive_sph_torch.probe.main at x1, in this process (it prints its
    table); the launch counts are set to 0 just before and read just after:
    all five probe kernels must have launched."""
    from adaptive_sph_torch import probe
    from adaptive_sph_torch.ops import pair_ops

    pair_ops.reset_launches()
    lines = probe.main([])
    launches = dict(pair_ops.launches)
    missing = [k for k in PROBE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"adaptive_sph_torch.probe never launched {missing}")
    log(f"probe x1: {len(lines)} lines, launches {launches}")
    return launches


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.stress import solver_runs, stress_params

    smi = phase_header()
    kres = phase_kernels()
    resident_calls = capture_resident_inputs()
    classic = phase_classic(resident_calls["hybrid"])
    sweep_res, sweep_inputs = phase_sweeps(resident_calls["hybrid"])
    solver_sweeps = phase_solver_sweeps(sweep_inputs)
    del sweep_inputs
    solves = phase_solves(resident_calls)
    del resident_calls
    solver_calls = capture_solver_inputs()
    w2020 = phase_w2020_solves(solver_calls)
    del solver_calls
    wcsph = phase_wcsph_build()
    scalar = phase_scalar_kernels()
    phase_walk_layouts()
    probe_kernels = phase_probe_kernels()
    if "--kernels-only" in argv:
        return 0
    phase_trajectory()
    phase_dambreak_trajectory()
    phase_resident_trajectories()
    solver_launches = phase_solver_trajectories()
    with scalar_blocks():
        phase_trajectory(SCALAR_FIXTURE, "scalar-g trajectory")
    timed_path(stress_params(), "parity (f32, cold, momentum 0)")
    timed_path(stress_params(bench=True), "bench (bf16, warm start, momentum 0.9)",
               ("pair_build", "pair_matvec", "pair_visc"))
    hybrid = timed_path(stress_params(resident=True), "resident hybrid parity (f32, cold)",
                        ("pair_build", "pair_sweep", "pair_hybrid"))
    timed_path(stress_params(bench=True, resident=True),
               "resident hybrid bench (bf16, warm start, momentum 0)", ("pair_hybrid",))
    iisph = timed_path(stress_params(resident=True, iisph=True), "resident IISPH (f32, cold)",
                       ("pair_build", "pair_sweep", "pair_jacobi"))
    timed_path(stress_params(iisph=True), "streamed IISPH (f32, cold)",
               ("pair_build", "pair_matvec", "pair_visc"))
    scalar_kernels = ("pair_build", "pair_matvec_scalar", "pair_visc_scalar")
    with scalar_blocks():
        scalar_run = timed_path(stress_params(), "scalar-g parity (f32, cold, momentum 0)",
                                scalar_kernels, ("pair_matvec", "pair_visc"))
        timed_path(stress_params(bench=True), "scalar-g bench (bf16, warm start, momentum 0.9)",
                   scalar_kernels, ("pair_matvec", "pair_visc"))
    runs = solver_runs()
    timed_path(runs["stress_w2020_hybrid"][0],
               "Winchenbach2020 hybrid, classic branch, streamed solves (f32, cold)",
               ("pair_build", "pair_sweep", "pair_matvec"), ("pair_hybrid", "pair_visc"))
    timed_path(runs["stress_iisph2_wcsph_resident"][0],
               "resident IISPH2 with WCSPH viscosity (f32, cold)",
               ("pair_build:wcsph", "pair_sweep:omega", "pair_jacobi"), ("pair_hybrid",))
    launches = timed_dambreak()
    missing = [k for k in DAMBREAK_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the dam-break path: {missing}")
    timing_run = phase_timing()
    probe_run = phase_probe()
    launches = {**launches, "pair_hybrid": hybrid["pair_hybrid"],
                "pair_jacobi": iisph["pair_jacobi"],
                "pair_matvec_scalar": scalar_run["pair_matvec_scalar"],
                "pair_visc_scalar": scalar_run["pair_visc_scalar"],
                "pair_weights": timing_run["pair_weights"],
                **{k: probe_run[k] for k in PROBE_KERNELS},
                **{k: solver_launches[k] for k in pair_ops.MODE_KEYS}}

    f32 = kres["f32"]
    k1 = f32["pair_build"]
    s32 = scalar["f32"]
    rows = {"pair_build": (max(k1[0], classic[0], s32["pair_build"]), *k1[1:]),
            "pair_matvec": f32["pair_matvec_accel"],
            "pair_visc": f32["pair_visc"], "pair_sweep": (*sweep_res, None), **solves,
            "pair_weights": s32["pair_weights"],
            "pair_matvec_scalar": s32["pair_matvec_scalar accel"],
            "pair_visc_scalar": s32["pair_visc_scalar"], **probe_kernels,
            "pair_build:wcsph": wcsph, "pair_sweep:visc": solver_sweeps["visc"],
            "pair_sweep:omega": solver_sweeps["omega"], **w2020}
    entries = []
    for name, (err, ms, plain, bnd, lib) in rows.items():
        if name == "pair_matvec":
            err = max(err, f32["pair_matvec_div"][0])
        if name == "pair_matvec_scalar":
            err = max(err, s32["pair_matvec_scalar div"][0])
        entries.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": lib})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
