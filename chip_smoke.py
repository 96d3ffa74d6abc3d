#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py                # all phases (one GPU)
    python3 chip_smoke.py --kernels-only # build + kernel-vs-plain checks only
    python3 chip_smoke.py --slab-only    # build + the slab phases S1-S2 only
    python3 chip_smoke.py --lists-only   # build + the list phases L1-L4 only
    python3 chip_smoke.py --nowcache-only  # build + the sweep-only phases N1-N4 only
    python3 chip_smoke.py --grid-only    # build + the dense grid engine's phases G1-G3 only
    python3 chip_smoke.py --clique-only  # build + the clique layout's phases C1-C3 only
    python3 chip_smoke.py --gates-only   # build + the scenario gates' phase H1 only

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
  2h. the pair sweep's last modes (stress.sweep_mode_runs: h_w_sum, h_vw_sum,
     constant_field, the range-limited cone_range and wavefront_range,
     centerdiff, fringe_count, check_aii and check_aii_w2020) against their
     plain versions: on the input each one's main path gives it (captured
     from the first step of every sweep-mode run; timed: medians, profiled
     device time, plain version, bound) and with seeded inputs on the
     stress x1 and the scene-ratio2to1 first-step layouts; counts and maxima
     equal, sums within 1e-5 of the column max;
  2e. the probe kernels of adaptive_sph_torch.probe against their plain
     versions on the same CUDA tensors: block_sweep at the four sizes of
     scripts/proto_pallas.py and on a skewed list (skewed_sweep_inputs: a
     305-item tile, empty tiles, empty and whole-chunk ranges; 1e-5 of max,
     tiles without items 0, a second launch bit-identical), window_sum at
     proto_v8.py's size, on misaligned anchors and on 200 anchors (its ring)
     at widths 300 and 301 (bit for bit, a second launch bit-identical; its
     empty launch beside its bound), pair_stream at the (grp, nbuf) of
     matvec_probe.py over the stress first step's w at x1 and x4, f32 and
     bf16 (zeros, and each block's XOR fold of the words it landed equal to
     the fold of the same bytes of the list; whole and with a ragged tail),
     the K2 probe's three variants in both modes and the K2s probe at wh
     32-256 on the stress first step's lists, f32 and bf16 (1e-5 of max;
     base equal to K2 and every wh to K2s bit for bit); ptxas's registers of
     the csrc/pair_probe.cu kernels; medians, profiled device times, bounds
     and library calls (the sparse CSR product for the matvecs, torch.sum
     for the stream, a conv1d for the window sum); beside each bound the
     kernel's empty launch and block_sweep's special-function floor at the
     SM clock nvidia-smi reports under load;
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
  3f. every run of adaptive_sph_torch.stress.sweep_mode_runs (h from the
     particle distribution, the diagnostic fields, both stash variants,
     CenterDiff after advection, the neighbourhood constraint, check_aii
     in both discretizations, check_neighborhood) against
     tests/data/torch_port_sweep_modes_ref.npz: launch counts set to 0 just
     before each run and read just after (its new sweep modes must have
     launched, the others not, no plain version may have run); per-step
     iteration counts and mismatches equal, check_aii's deviation within
     2e-3 and below 0.01, then the state and the fields the modes write
     (flags and neighbour counts exactly);
  N1-N4. (after 3f) the sweep-only tile step (ASPH_NO_WCACHE=1, set by a
     context manager around each phase and restored after it: no pair list,
     every pair sum a pair_sweep):
  N1. its seven functors (prep with the ApproxLaplace, WCSPH and XSPH
     viscosities, aii_sums, accel, div, div_w2020) against their plain
     versions on the first-step inputs of stress.nowcache_runs' stress runs
     (captured from those steps; prep_xsph on the parity run's prep input),
     and with those steps' densities and seeded velocities, pressures or
     operands (the first step starts at rest, its pressures all 0):
     sums within 1e-5 of the column max, a second launch bit-identical,
     medians (CUDA events, profiled device time), plain version, tested
     pairs and pairs inside the radius, the bound;
  N2. every run of stress.nowcache_runs against
     tests/data/torch_port_nowcache_ref.npz: launch counts set to 0 just
     before each run and read just after (its modes must have launched, no
     K1 / K2 / K3 / pair_jacobi / pair_hybrid, no plain version); per-step
     iteration, negative-a_ii, census and capacity counts equal, dt within
     1e-4, then the matched state (positions 2e-5, density rtol 2e-5,
     velocity 2e-4, mass rtol 1e-5);
  N3. the parity and bench options and the WCSPH viscosity after the
     divergence solve on this branch through timed_path (ms/step, host
     syncs per step, device-busy share; the four new modes launched over
     the three, no K1 / K2 / K3 / pair_jacobi / pair_hybrid);
  N4. S1's uniform and impact scenes on 2 gloo ranks sharing the card under
     the variable against the one-device run under it: S1's tolerances,
     equal iterations, every rank's prep, accel and div sweeps launched and
     no K1;
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
  4f. timed media_constant_field and stress_checked_constrained (100 steps
     each) with their profiled windows; their new sweep modes must have
     launched; before them, 4g: stress_checked_constrained's check_aii
     deviation over 140 steps from its initial state against JAX's per step
     (tests/data/torch_port_aii_drift_ref.npz; within JAX's own spread
     under 1-ulp initial positions plus half a float32 step of a_ii), and
     at steps 121-140 both a_ii terms against float64, no further from it
     than JAX's (tests/data/torch_port_aii_witness.npz) plus the same
     headroom;
  4b. the timed default dam break, 300 steps through create_simulation (the
     launch counts set to 0 just before, read just after: all four kernels
     must have launched; the census of its CSR lists, pairs per live row
     mean, p99 and max), then 20 steps through
     adaptive_sph_torch.cli.main(["run", ..., "--max-steps", "20"]);
  5. adaptive_sph_torch.timing.main(["1"]) in this process: its stage table
     at x1; the weights-only walk must have launched;
  6. adaptive_sph_torch.probe.main([]) in this process (every variant at
     x1, bf16 storage; the launch counts set to 0 just before and read just
     after): all five probe kernels must have launched;
  7. the image export of configs/media/ratio-stress-test.yaml entry 1 with
     its time cut from 0.8 s to IMAGE_TIME (n = 11,835, a 2000 x 2000 PNG
     with legend and title; the stress scene's long horizon is H1's
     PARITY_RUNS_TORCH.json record)
     through adaptive_sph_torch.utils.animation.export_simulation_images (the
     `image` command's function) from a copy of the list in a temporary
     directory: launch counts set to 0 just before, read just after (K1-K3
     must have launched), the PNG's size, the .stat file, 10 steps under
     torch.profiler; configs/media/ratio-stress-test.png left untouched;
  8. configs/media/video-default.yaml entry 1 with its time cut to 0.1 s
     through adaptive_sph_torch.cli.main(["image", ...]): the two-phase
     step, the frames the export rule gives, resampling between the frames,
     capacity growth where splits were deferred;
  8b. configs/media/motivation-images.yaml entry 1 (ten populated grid
     levels) cut to 0.008 s at 320 x 320;
  9. `run` with every option on the default dam break (20 steps), then a
     straight 21-step run against one resumed from the 20-step checkpoint;
  A1. (after 2e) the particle (Akinci) boundary's kernels against their
     plain versions on the first-step inputs of configs/media/
     motivation-video.yaml's "Uniform SPH" entry with the particle boundary
     (motivation-scene2, n = 33,750, 1,000 boundary particles): K1 mega, K2
     and K3 on the streamed HybridDFSPH step (seeded velocities and
     operands), the DENSITY sweep and pair_jacobi on the resident IISPH
     step, pair_hybrid on the resident HybridDFSPH step, the two solves
     also on the Akinci dam break's first step and to the cap (a row
     beyond 1e-5 of the plain version is held against a float64 solve,
     the kernel's and the plain version's distances each the median over
     9 orders of every row's pairs); each launched twice, the second
     bit-identical; timed beside the plain version and the bound;
  A2. (after 3f) every run of stress.akinci_runs against
     tests/data/torch_port_akinci_ref.npz: the dam break streamed and
     resident (10 steps), scene2 at full width (3 steps); launch counts set
     to 0 just before each run and read just after, iteration counts equal,
     then the state;
  A3. (after 4f) scene2 with the particle boundary timed, AKINCI_TIMED_STEPS
     steps each streamed hybrid, resident hybrid and resident IISPH, with the
     profiled window; the boundary search's own time;
  A4. (after 9) `run -p` with profile_stages on the default dam break: every
     section the reference records is present and positive;
  A5. generate-split-patterns --max-children GEN_MAX_CHILDREN on the card:
     the patterns' properties, attempts and seconds.
  S1. the slab decomposition (parallel/tile_sharding.py through
     adaptive_sph_torch.multichip.run_ranks: gloo ranks sharing this card,
     one process each) on tests/test_multichip.py's scene (a 1.2 x 0.6
     block at 0.03): uniform HybridDFSPH with warm start, 6 steps, and
     adaptive sizes with EmptyAngle levels (no resampling), 4 steps; and on
     stress.py's impact scene (144 particles thrown at the floor, solves of
     up to 60 sweeps), 8 steps; each on 2 and 4 ranks against the port's
     one-device run on the card
     (positions atol 5e-5, velocity 5e-4, density rtol 1e-4, levels atol
     1e-6; on 2 ranks equal iteration counts); and the same scene with
     share / merge / split (test_multichip.py's adaptive parameters), 6
     steps, held by invariants: resampling events on both runs, every
     step's mass conservation error < 1e-5, the mass within 1e-5 of the
     initial and of the one device's, the census, the count within 15% of
     the one device's; every rank must have launched pair_build,
     pair_matvec, pair_visc and pair_sweep (counts set to 0 just before
     each run, read just after); then K1, K2, K3 and the sweeps against
     their plain versions on rank 0's first-step slab inputs (2 ranks,
     levels), timed, a check beside S2's;
  S2. scripts/multichip_longrun.py's scene at its default spacing 0.0075
     (51,200 particles, adaptive HybridDFSPH with share / merge / split) on 4
     gloo ranks sharing this card for SOAK_STEPS steps, the last
     SOAK_PROFILED under torch.profiler on every rank: the script's
     invariants every SOAK_CHECK_EVERY steps (mass drift < 5e-3, census,
     containment), no solve above its tolerance before the cap, at least
     one reshard (forced before the last SOAK_CHECK_EVERY steps if none
     happened, every field of every particle kept exactly, the last steps
     run on the new slabs); per rank ms/step, exchanges, reductions and
     host syncs per rank-step, strip bytes and the device-busy share; all
     four kernels launched on every rank; then K1, K2, K3 and every sweep
     of rank 0's first step of this run (its levels and its matching)
     against their plain versions on those inputs, timed.
  L1-L4. the neighbour-list backend (backend="lists", plain torch: its
     steps must launch no kernel of pair_ops' count and call no plain
     version of one; its tensors on the card; ms/step, host syncs and
     device time per step from a profiled window; a second run
     bit-identical), against tests/data/torch_port_lists_ref.npz
     (scripts/torch_port_lists_ref.py):
  L1. surface-detection.yaml entries 1 (CenterDiff) and 2 (EmptyAngle) with
     levels after advection over the stale pairs (the setting the tile engine
     refuses), through the image entry point on a copy of the list, time
     clipped to stress.LIST_EXPORT_TIME: steps and positions against the
     fixture, then the same run through create_simulation: every step's
     counts and the state (positions atol 2e-5, density rtol 2e-5, velocity
     atol 2e-4, mass rtol 1e-6, levels atol 2e-5, flags and stash equal);
  L2. the default dam break with the same setting (share / merge / split,
     capacity growth), 10 steps against the fixture (mass rtol 1e-5);
  L3. the stress scene at full width (n = 11,835) on backend="lists"
     against the tile step over LIST_STRESS_STEPS steps, matched by position
     (positions atol 2e-5, density rtol 2e-5);
  L4. the particle-sharded list step (parallel/sharding.py) on 2 and 4 gloo
     ranks sharing the card, the dam break of L2 at capacity
     LIST_SHARDED_CAPACITY, against the one-device list run: the gathered
     state equal, field for field.
  G1-G3. the dense grid engine (backend="grid", plain torch: its steps must
     launch no kernel of pair_ops' count and call no plain version of one;
     its state on the card), the runs of stress.grid_runs() against
     tests/data/torch_port_grid_ref.npz (scripts/torch_port_grid_ref.py):
     every step's iteration and resampling counts and census equal, dt
     within 1e-5; at the end, matched by position, positions atol 2e-5,
     density rtol 2e-5, velocity atol 2e-4, mass rtol 1e-6 (1e-5 on G2),
     levels atol 2e-5, flags and stash equal; peak device memory of each run:
  G1. numerics.fma (torch.addcmul on the card) against the float64 form on
     2^21 seeded lanes: every lane equal (one rounding); the stress scene
     (n = 11,835, parity options; 2 populated levels of a 7-level ladder,
     finest grid 128 x 128, 24 slots per cell), 5 steps; the tile step from
     the same start beside it (|dx|, density rel);
  G2. the default dam break without resampling (10 steps) and the two-size
     dam with share / merge / split (stress.GRID_ADAPTIVE_SCENE, 3 steps);
  G3. the stress scene on "grid" timed: GRID_TIMED steps after GRID_WARMUP
     (host clock, synchronised), then GRID_PROFILED steps under
     torch.profiler (host syncs, device time, busy share), peak memory; the
     tile step's ms/step in the same run.
  C1-C3. the clique / patch-major layout (ASPH_CLIQUE=1, set and restored
     by `clique_env`):
  C1. the first step of the touching scene (stress.TOUCHING_SCENE, 300
     cross-level pairs) and of the stress scene (none: an empty list) with
     spies on K1 and K3: K1 over the cross_only windows against its plain
     version (structure equal, rows within TOL_F32 of their max), K2 accel /
     div and K3 on its list (a second launch bit-identical), times and
     bounds; pair_sweep's DENSITY and visc sweeps over the touching scene's
     patch-row windows (padding slots walked and masked), the visc input
     captured from CLIQUE_SWEEP_STEPS steps with the non-pressure step after
     the divergence solve (pair_sweep's launches counted over them);
  C2. the runs of stress.clique_runs() against
     tests/data/torch_port_clique_ref.npz (scripts/torch_port_clique_ref.py):
     every step's iteration counts equal, dt within 1e-4, capacity, patch 4
     throughout, no clique overflow, K1-K3 launched, no plain version; at the
     end, matched by position, positions atol 2e-5, density rtol 2e-5,
     velocity atol 2e-4 (under ASPH_NX_CAP=1 the reference fell back to the
     packed layout; the port has no cross budget and stays); the stress
     scene on the clique layout against the packed one;
  C3. the stress scene under ASPH_CLIQUE=1, parity and bench options,
     CLIQUE_TIMED steps after CLIQUE_WARMUP, then CLIQUE_PROFILED profiled
     (host syncs, busy share), peak memory, the packed step the same way in
     the same run; the device times of clique_build, clique_visc and one
     Jacobi sweep's same-level products;
  H1. the scenario gates (adaptive_sph_torch/gates.py): every run of
     tests/data/torch_port_gates_ref.json, by its spec, against it (the JAX
     package's own scripts/scenario_gates.py at the start,
     scripts/torch_port_gates_ref.py): steps, n_final, the per-step dt
     (rtol 2e-5) and iteration counts equal; then the short gates of
     GATES_SHORT, which must pass (no violation, contained, mass drift
     < 1e-3, no dt collapse): the stress scene at momentum 0.9 to 0.3 s
     (two 64-step chunks), the dam break to 0.1 s, a few dozen steps of
     resampling, onlydiv and motivation; launch counts set to 0 just before
     the short gates and read just after (K1-K3 and pair_sweep must have
     launched).
Output: a JSON object with one entry per kernel and one per ported mode
("kernel:mode": K1's WCSPH viscosity, the visc and omega sweeps, the
Winchenbach2020 solves, launches counted over phase 3e's runs; the pair
sweep's last modes, launches counted over phase 3f's runs; the sweep-only
step's prep, aii_sums, accel and div, launches counted over N2's runs) and
one per
kernel of the particle boundary's paths ("kernel@akinci": A1's inputs,
launches counted over A3's timed scene2 runs) and one per kernel of the
slab step ("kernel@slab": S2's rank-0 first-step inputs, launches summed
over S2's ranks) and one per kernel of the clique path ("pair_build:clique_cross",
"pair_matvec:clique_cross", "pair_visc:clique_cross": C1's touching inputs,
launches counted over C2's touching run; "pair_sweep:patch": the visc sweep
over the patch rows, launches over C1's run with the non-pressure step
after the divergence solve),
then the card's name and power limit (nvidia-smi), then, last, {"ok": true,
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
SWEEP_MODES_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_sweep_modes_ref.npz")
DRIFT_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_aii_drift_ref.npz")
AKINCI_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_akinci_ref.npz")
CONFIG = os.path.join(ROOT, "configs", "default-config.yaml")
SCENE = os.path.join(ROOT, "configs", "default-scene.yaml")
MEDIA = os.path.join(ROOT, "configs", "media")
# the export lists driven through the image entry point, each from a copy in a
# temporary directory (an export writes its png_file beside its list)
IMAGE_LIST = os.path.join(MEDIA, "ratio-stress-test.yaml")  # entry 1 as it stands
VIDEO_LIST = os.path.join(MEDIA, "video-default.yaml")  # entry 1, time cut to VIDEO_TIME
VIDEO_TIME = 0.1  # s of the entry's 3 s: 60 fps x 0.25 speed gives 24-25 frames
IMAGE_PROFILED_FROM = 100  # the image run's steps 101-110 under torch.profiler
IMAGE_TIME = 0.3  # s of the entry's 0.8 s (the gates run the scene to 1 s, H1 and the record)
# check_aii's two a_ii terms against float64 (scripts/torch_port_aii_witness.py):
# the port's largest error on the card, per key, within JAX's plus WITNESS_HEADROOM
# (in steps of 1/512); the per-step deviation within JAX's own 1-ulp spread plus
# the same headroom
WITNESS_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_aii_witness.npz")
WITNESS_KEYS = ("err_aii", "err_real", "err_dev", "mean_aii", "mean_real")
WITNESS_HEADROOM = 0.5
# a step resumed from a checkpoint against the straight run's (matched by position)
RESUME_ATOL = {"position": 2e-5, "velocity": 2e-4, "mass": 1e-7, "h": 2e-5}

# the pair sweep's last modes (functors of TPU kernel #7), each counted under
# "pair_sweep:<name>" in pair_ops.launches
MODE_SWEEPS = ("h_w_sum", "h_vw_sum", "constant_field", "cone_range", "wavefront_range",
               "centerdiff", "fringe_count", "check_aii", "check_aii_w2020")
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
    **{"pair_sweep:" + k: "adaptive_sph_torch/csrc/pair_sweep.cu"
       for k in (*MODE_SWEEPS, "prep", "aii_sums", "accel", "div")},
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
    # the last modes of run_sweep: the SweepOps of models/tile_physics.py
    # (h_w_sum_op :283, h_vw_sum_op :287, constant_field_op :56, cone_op and
    # wavefront_op with _range_ok :207, :252, centerdiff_op :239,
    # fringe_count_op :224, check_aii_op :154), each its own kernel body
    **{"pair_sweep:" + k: "adaptive_sph_tpu/ops/pallas_sweeps.py:120" for k in MODE_SWEEPS},
    # the sweep-only step's SweepOps (models/tile_physics.py: prep_op :90,
    # aii_sums_op :110, accel_op :129, div_op :142)
    **{"pair_sweep:" + k: "adaptive_sph_tpu/ops/pallas_sweeps.py:120"
       for k in ("prep", "aii_sums", "accel", "div")},
}
# the kernels of the particle (Akinci) boundary's paths, held against their
# plain versions on those paths' own first-step inputs (phase_akinci_kernels)
AKINCI_KERNELS = ("pair_build", "pair_matvec", "pair_visc", "pair_sweep", "pair_jacobi",
                  "pair_hybrid")
SOURCES.update({k + "@akinci": SOURCES[k] for k in AKINCI_KERNELS})
REPLACES.update({k + "@akinci": REPLACES[k] for k in AKINCI_KERNELS})
# the kernels of the slab-decomposed step (phases S1-S2), checked on rank 0's
# first-step slab inputs
SLAB_KERNELS = ("pair_build", "pair_matvec", "pair_visc", "pair_sweep")
SOURCES.update({k + "@slab": SOURCES[k] for k in SLAB_KERNELS})
REPLACES.update({k + "@slab": REPLACES[k] for k in SLAB_KERNELS})
# tests/test_multichip.py's slab scene and its two configurations (S1)
SLAB_SCENE = {"boundary": {"type": "box", "width": 2.0, "height": 2.0},
              "blocks": [{"pos": [-0.95, -0.5], "size": [1.2, 0.6], "spacing": 0.03,
                          "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}
# run -> (parameters, scene, capacity, steps); "impact": stress.py's impact
# scene, whose solves iterate (up to their cap of 60)
SLAB_RUNS = {
    "uniform": ({"particle_sizes": "Uniform", "pressure_solver_method": "HybridDFSPH",
                 "init_boundary_handler": "AnalyticOverestimate",
                 "level_estimation_method": "None", "merging": False, "sharing": False,
                 "splitting": False, "max_iters": 50, "warm_start_pressure": True},
                SLAB_SCENE, 2048, 6),
    "levels": ({"particle_sizes": "Adaptive", "pressure_solver_method": "HybridDFSPH",
                "init_boundary_handler": "AnalyticOverestimate",
                "level_estimation_method": "EmptyAngle", "merging": False, "sharing": False,
                "splitting": False, "particle_radius_base": 0.03, "particle_radius_fine": 0.008,
                "maximum_surface_distance": 0.25, "warm_start_pressure": True, "max_iters": 50,
                "force_level_estimation": True}, SLAB_SCENE, 2048, 4),
    # tests/test_multichip.py's _ADAPT_PARAMS: share / merge / split on the slabs
    "resampling": ({"particle_sizes": "Adaptive", "pressure_solver_method": "HybridDFSPH",
                    "init_boundary_handler": "AnalyticOverestimate",
                    "level_estimation_method": "EmptyAngle", "merging": True, "sharing": True,
                    "splitting": True, "particle_radius_base": 0.03,
                    "particle_radius_fine": 0.008, "maximum_surface_distance": 0.25,
                    "warm_start_pressure": True, "max_iters": 50}, SLAB_SCENE, 4096, 6),
    "impact": ({"particle_sizes": "Uniform", "pressure_solver_method": "HybridDFSPH",
                "merging": False, "sharing": False, "splitting": False, "max_iters": 60},
               {"boundary": {"type": "box", "width": 2, "height": 2},
                "blocks": [{"pos": [0.4, -0.9], "size": [0.55, 1.0], "spacing": 0.06,
                            "volume_fill_ratio": 0.93, "velocity": [3.0, -3.0]}]}, 1024, 8),
}
SLAB_RANKS = (2, 4)
# runs held to the one-device run by invariants (slab-local matching pairs
# particles differently), not by trajectory
SLAB_INVARIANT_RUNS = ("resampling",)
SLAB_ATOL = {"position": 5e-5, "velocity": 5e-4, "level": 1e-6}
SLAB_DENSITY_RTOL = 1e-4
SOAK_SPACING = 0.0075  # scripts/multichip_longrun.py's default: 51,200 particles
# the soak's depth: 30 of the long-run script's 200 steps, so that the whole
# script, with the grid engine's phases G1-G3 and the clique phases C1-C3,
# keeps a margin under its limit on a slow host (1,079 s with 100 steps and
# no C1-C3 on one)
SOAK_STEPS = 30
SOAK_PROFILED = 3  # torch.profiler slows a step 3-4x (1,400 host syncs per rank-step)
SOAK_CHECK_EVERY = 10
SOAK_RANKS = 4
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
                  "density": 16, "visc_laplace": 40, "visc_wcsph": 40, "omega": 30,
                  "h_w_sum": 15, "h_vw_sum": 17, "constant_field": 18, "cone_range": 18,
                  "wavefront_range": 10, "centerdiff": 24, "fringe_count": 5, "check_aii": 26,
                  "check_aii_w2020": 28, "prep_laplace": 58, "prep_wcsph": 60, "prep_xsph": 33,
                  "aii_sums": 33, "accel": 31, "div": 27, "div_w2020": 29}
# the mode keys each run of stress.sweep_mode_runs must launch (the other
# keys of MODE_SWEEPS it must not)
SWEEP_MODE_RUN_KERNELS = {
    "media_constant_field": ("h_w_sum", "constant_field"),
    "media_neighbor_numbers": ("h_w_sum", "constant_field"),
    "media_surface_distance_first": ("h_w_sum",),
    "media_surface_distance_middle": ("h_w_sum",),
    "media_surface_detection_centerdiff": ("centerdiff",),
    "ratio2to1_from_distribution": ("h_w_sum", "cone_range", "wavefront_range"),
    "ratio2to1_from_distribution2": ("h_vw_sum", "cone_range", "wavefront_range"),
    "stress_checked_constrained": ("fringe_count", "check_aii"),
    "two_size_constrained": ("fringe_count", "check_aii"),
    "impact_w2020_check_aii": ("check_aii_w2020",),
}
# the fields of the sweep-mode runs held against their fixture: relative,
# absolute and exact tolerances
SWEEP_MODE_REL = {"density": 2e-5, "h": 2e-5, "h_next": 2e-5}
SWEEP_MODE_ABS = {"position": 2e-5, "velocity": 2e-4, "level": 2e-5, "stash": 2e-5,
                  "constant_field": 2e-5}
SWEEP_MODE_EXACT = ("neighbor_count", "flag_is_fluid_surface", "flag_insufficient_neighs",
                    "flag_neighborhood_reduced")
AII_DEVIATION_TOL = 2e-3  # check_aii's deviation: a max of differences of a_ii, a few ulps
# the sweep-only step (ASPH_NO_WCACHE=1): its fixture, its four modes of the
# pair sweep and the functors behind them (the sweep op names)
NOWCACHE_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_nowcache_ref.npz")
NOWCACHE_MODES = {"prep": ("prep_laplace", "prep_wcsph", "prep_xsph"),
                  "aii_sums": ("aii_sums",), "accel": ("accel",), "div": ("div", "div_w2020")}
# the modes each run of stress.nowcache_runs must launch
NOWCACHE_RUN_MODES = {
    "stress_nowcache_hybrid": ("prep", "accel", "div"),
    "stress_nowcache_w2020_resident": ("prep", "accel", "div"),
    "stress_nowcache_wcsph_after_div": ("aii_sums", "accel", "div", "visc"),
    "stress_nowcache_iisph2_wcsph": ("prep", "accel", "div", "omega"),
    "dambreak_nowcache": ("prep", "accel", "div"),
    "impact_nowcache_resident": ("prep", "accel", "div"),
}
# the kernels the branch never launches
NOWCACHE_ABSENT = ("pair_build", "pair_matvec", "pair_visc", "pair_jacobi", "pair_hybrid",
                   "pair_matvec_scalar", "pair_visc_scalar")
NOWCACHE_PER_STEP = ("div_iterations", "density_iterations", "negative_aii", "n", "capacity")
# one walk of a whole solve over one pair: two products and two sums (a
# Jacobi iteration is two walks: 8 operations per pair)
OPS_SOLVE_WALK = 4
TOL_SOLVE = 1e-5  # relative to max |plain| after up to 60 sweeps
# a row that is rounding noise: the kernel's distance from a float64 solve
# over the plain version's, each the median over SOLVE_ORDERS orders of the
# pairs within each row (solve_agreement)
F64_RATIO = 1.5
# the list's own order and SOLVE_ORDERS - 1 seeded shuffles of each row's
# pairs: a float32 sum's rounding depends on its order, and a row made of
# cancelling terms (a first step's lattice) carries that into a solve's
# last digits
SOLVE_ORDERS = 9
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
AKINCI_TIMED_STEPS = 50
# the kernels each run of stress.akinci_runs must launch
AKINCI_RUN_KERNELS = {"dam_hybrid": ("pair_build", "pair_matvec", "pair_visc"),
                      "dam_iisph_resident": ("pair_build", "pair_sweep", "pair_jacobi"),
                      "scene2_hybrid": ("pair_build", "pair_matvec", "pair_visc")}
GEN_MAX_CHILDREN = 4  # generate-split-patterns: the patterns for 2-4 children
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


@contextlib.contextmanager
def sweep_only():
    """ASPH_NO_WCACHE=1 inside the block: the tile step keeps no pair list and
    runs every pair sum as a pair_sweep."""
    old = os.environ.get("ASPH_NO_WCACHE")
    os.environ["ASPH_NO_WCACHE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["ASPH_NO_WCACHE"]
        else:
            os.environ["ASPH_NO_WCACHE"] = old


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


def skewed_sweep_inputs(E=16384, NT=3072, long_items=300, seed=1):
    """A block-sweep work list at the probe's largest size, skewed: tile 5
    holds long_items items (split over its block's warps in pieces of more
    than 32), a run of tiles holds none, and a fifth of the items each have
    an empty column range, the whole chunk, a range past both ends of the
    chunk, one outside it, or a part of it."""
    import numpy as np
    import torch
    from adaptive_sph_torch import probe
    from adaptive_sph_torch.ops.probes import WK

    q, c, _, ck, _, _, scale = probe.sweep_inputs(E, NT, seed=seed)
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, NT, E)
    tiles[:long_items] = 5
    tiles[(tiles >= 40) & (tiles < 80)] = 39
    c0 = ck.cpu().numpy().astype(np.int64) * WK
    kind = np.arange(E) % 5
    lo = c0 + rng.integers(0, WK, E)
    hi = lo + rng.integers(0, WK, E)
    lo[kind == 1], hi[kind == 1] = c0[kind == 1] + 9, c0[kind == 1] + 9
    lo[kind == 2], hi[kind == 2] = c0[kind == 2], c0[kind == 2] + WK
    lo[kind == 3], hi[kind == 3] = c0[kind == 3] - 100, c0[kind == 3] + 200
    lo[kind == 4], hi[kind == 4] = c0[kind == 4] + WK, c0[kind == 4] + 2 * WK
    order = np.argsort(tiles, kind="stable")

    def dev(a):
        return torch.from_numpy(a[order].astype(np.int32)).to(q.device)

    return q, c, dev(tiles), dev(c0 // WK), dev(lo), dev(hi), scale


def sm_clock_mhz(fn, seconds=1.0):
    """The SM clock nvidia-smi reports (median of samples every 50 ms) while
    fn runs in a loop for about `seconds`; the sampler is stopped after."""
    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples, _ = smi.communicate()
    mhz = sorted(float(v) for v in samples.split() if v.strip().replace(".", "").isdigit())
    if not mhz:
        raise AssertionError("nvidia-smi reported no SM clock")
    return mhz[len(mhz) // 2]


def probe_registers():
    """ptxas's registers and spill bytes of the probe kernels of csrc/pair_probe.cu."""
    from adaptive_sph_torch.ops import _native

    regs = {}
    for name, (r, st, ld) in _native.resources().items():
        m = re.search(r"(block_sweep_kernel|window_sum_kernel|pair_stream_kernelILi\d+)", name)
        if m:
            regs[m.group(1).replace("ILi", "<") + (">" if "ILi" in m.group(1) else "")] = (r, st, ld)
    return regs


def check_pair_streams(tag, w, library):
    """pair_stream over w at each (grp, nbuf) of matvec_probe.py: zeros, and
    each block's fold of what it landed equal to stream_folds, whole and with
    a ragged tail (n - 3 elements: a byte count that is no multiple of 16);
    timed over the whole list beside its bound and its empty launch (n = 0).
    With `library`: also the plain version and torch.sum over w at grp 8
    nbuf 4, returned as {"pair_stream": (max abs err, ms, plain ms, bound,
    library ms)} for the JSON line."""
    import torch
    from adaptive_sph_torch.ops import probes
    from adaptive_sph_torch.timing import device_ms

    out = {}
    d_empty = device_ms(lambda: probes.pair_stream(w, 0), 20, "pair_stream_kernel")
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
        stages = -(-nbytes // (grp * probes.CHUNK_BYTES))
        msg = (f"pair_stream [{tag}] grp={grp} nbuf={nbuf} over w ({nbytes} B, {stages} stages "
               f"on {folds.numel()} blocks, {nbuf * grp} KB in flight per block): zeros, folds "
               f"equal, also with a ragged tail; kernel {tk:.4f} ms (device {dk:.5f} ms, {rate}), "
               f"bound {b[0]:.5f} ms ({b[1]}), empty launch {d_empty:.5f} ms, special-function "
               f"floor none (no special-function operations)")
        if library and (grp, nbuf) == (8, 4):
            t_lib = time_ms(lambda: w.sum(), 200)
            d_lib = device_ms(lambda: w.sum(), 20)
            tr = time_ms(lambda: probes.pair_stream_ref(w, w.numel(), grp, nbuf,
                                                        folds.numel()), 200)
            out["pair_stream"] = (0.0, tk, tr, b, t_lib)
            msg += (f", plain {tr:.4f} ms, library (torch.sum over w) {t_lib:.4f} ms "
                    f"(device {d_lib:.5f} ms)")
        log(msg)
    return out


def window_sets(seed=2):
    """window_sum's three input sets beyond the probe's own: (tag, v,
    anchors, width). Misaligned: 64 anchors none of which is a multiple of 4
    (every window by 4-byte copies), and 64 at any offset (a mix of 4- and
    16-byte copies); ring: 200
    anchors (four stages of 64, the ring turning over) at a ragged width of
    300 columns (three blocks, 44 in the last); ragged: 200 anchors at 301
    columns (the last block's 45-column rows take the 4-byte copies)."""
    import numpy as np
    import torch
    from adaptive_sph_torch import probe

    rng = np.random.default_rng(seed)
    C = probe.WINDOW_C
    v = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).cuda()
    odd = rng.integers(0, (C - 512) // 4, size=64) * 4 + rng.integers(1, 4, size=64)
    mixed = rng.integers(0, C - 512, size=64)
    many = rng.integers(0, C - 512, size=200)
    many[::3] = many[::3] // 8 * 8  # a third of them 16-byte aligned
    as_t = [torch.from_numpy(a.astype(np.int32)).cuda() for a in (odd, mixed, many)]
    return [("misaligned, 64 anchors", v, as_t[0], 128), ("mixed, 64 anchors", v, as_t[1], 128),
            ("ring, 200 anchors, width 300", v, as_t[2], 300),
            ("ring, 200 anchors, width 301", v, as_t[2], 301)]


def check_window_sum():
    """window_sum against its plain version, bit for bit: the probe's inputs
    (proto_v8.py's size), then window_sets; a second launch bit-identical.
    Logs the device time beside the empty launch (no anchors) and the
    bound; returns (0.0, ms, plain ms, bound, library ms) at the probe's
    size."""
    import torch
    from adaptive_sph_torch import probe
    from adaptive_sph_torch.ops import probes
    from adaptive_sph_torch.timing import device_ms

    v, an = probe.window_inputs()
    sets = [(f"probe C={v.shape[0]} anchors={an.numel()}", v, an, probe.WINDOW_WIDTH)]
    for tag, vv, a, width in sets + window_sets():
        got, want = probes.window_sum(vv, a, width), probes.window_sum_ref(vv, a, width)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"window_sum {tag} differs from the plain version (max abs "
                                 f"diff {rel_err(got, want)[0]:.3e}); must be equal")
        if not torch.equal(probes.window_sum(vv, a, width), got):
            raise AssertionError(f"window_sum {tag}: a second launch differs")
        b = bound_ms(*probe.window_cost(vv, a, width))
        dk = device_ms(lambda: probes.window_sum(vv, a, width), 20, "window_sum_kernel")
        log(f"window_sum {tag}: bit for bit equal to the plain version, a second launch "
            f"bit-identical; device {dk:.5f} ms, bound {b[0]:.6f} ms ({b[1]})")
    none = an[:0]
    if probes.window_sum(v, none).any():
        raise AssertionError("window_sum with no anchors: not all zeros")
    d_empty = device_ms(lambda: probes.window_sum(v, none), 20, "window_sum_kernel")
    # the library call: one conv1d of v with the anchors' count vector
    L = v.shape[0] - probe.WINDOW_WIDTH + 1
    ind = torch.zeros(L, device=v.device).index_add_(0, an.long(), torch.ones_like(an, dtype=torch.float32))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib = torch.nn.functional.conv1d(v.view(1, 1, -1), ind.view(1, 1, -1))[0, 0]
        t_lib = time_ms(lambda: torch.nn.functional.conv1d(v.view(1, 1, -1), ind.view(1, 1, -1)), 50)
    torch.cuda.synchronize()
    want = probes.window_sum_ref(v, an)
    b = bound_ms(*probe.window_cost(v, an))
    tk, tr = time_ms(lambda: probes.window_sum(v, an), 200), time_ms(lambda: probes.window_sum_ref(v, an), 20)
    dk = device_ms(lambda: probes.window_sum(v, an), 20, "window_sum_kernel")
    log(f"window_sum C={v.shape[0]} anchors={an.numel()}: kernel {tk:.4f} ms (device {dk:.5f} "
        f"ms), empty launch (no anchors) device {d_empty:.5f} ms, plain {tr:.4f} ms, bound "
        f"{b[0]:.6f} ms ({b[1]}); library (conv1d with the anchor counts) {t_lib:.4f} ms, max "
        f"abs diff {rel_err(lib, want)[0]:.3e}")
    return (0.0, tk, tr, b, t_lib)


def phase_probe_kernels():
    """The five probe kernels against their plain versions on the same CUDA
    tensors at the probe's shapes; returns {kernel: (max abs err, ms, plain
    ms, bound, library ms)} for the JSON line (block_sweep at its largest
    size, pair_stream over the f32 w at grp 8 nbuf 4, the K2 probe base in
    accel mode on the f32 list, the K2s probe at wh 128 in accel mode).
    Beside each bound: the kernel's empty launch (its device time on an
    empty input) and, for block_sweep, the special-function floor."""
    import torch
    from adaptive_sph_torch import probe
    from adaptive_sph_torch.ops import pair_ops, probes
    from adaptive_sph_torch.timing import device_ms

    for name, (regs, st, ld) in sorted(probe_registers().items()):
        log(f"ptxas {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    worst = 0.0
    empty = probe.sweep_inputs(0, probe.SWEEP_SIZES[-1][1])
    d_empty = device_ms(lambda: probes.block_sweep(*empty), 20, "block_sweep_kernel")
    if probes.block_sweep(*empty).any():
        raise AssertionError("block_sweep on an empty list: not all zeros")
    largest = probe.sweep_inputs(*probe.SWEEP_SIZES[-1])
    mhz = sm_clock_mhz(lambda: probes.block_sweep(*largest))
    log(f"block_sweep: SM clock under load {mhz:g} MHz (nvidia-smi); empty launch (no items, NT = "
        f"{probe.SWEEP_SIZES[-1][1]}) device {d_empty:.5f} ms")
    for tag, a in [(f"E={E} NT={NT}", probe.sweep_inputs(E, NT)) for E, NT in probe.SWEEP_SIZES] + [
            ("skewed E=16384 NT=3072", skewed_sweep_inputs())]:
        got, want = probes.block_sweep(*a), probes.block_sweep_ref(*a)
        torch.cuda.synchronize()
        e, rel = rel_err(got, want)
        if not rel < TOL_F32:
            raise AssertionError(f"block_sweep {tag}: max rel err {rel:.3e} >= {TOL_F32:g}")
        counts = torch.bincount(a[2].long(), minlength=a[0].shape[0] // probes.TQ)
        if bool((got.view(-1, probes.TQ)[counts == 0] != 0).any()):
            raise AssertionError(f"block_sweep {tag}: a tile with no item is not 0")
        if not torch.equal(probes.block_sweep(*a), got):
            raise AssertionError(f"block_sweep {tag}: a second launch differs")
        worst = max(worst, e)
        b = bound_ms(*probe.sweep_cost(*a[:6]))
        pairs = probe.sweep_pairs(*a[3:6])
        sfu = probe.SFU_SWEEP_PAIR * pairs / (16 * sms * mhz * 1e6) * 1e3
        tk, tr = time_ms(lambda: probes.block_sweep(*a), 50), time_ms(lambda: probes.block_sweep_ref(*a), 5)
        dk = device_ms(lambda: probes.block_sweep(*a), 20, "block_sweep_kernel")
        if tag == f"E={probe.SWEEP_SIZES[-1][0]} NT={probe.SWEEP_SIZES[-1][1]}":
            out["block_sweep"] = (worst, tk, tr, b, None)
        log(f"block_sweep {tag} C={a[1].shape[0]}: max abs err {e:.3e}, max rel err {rel:.3e} "
            f"(tol {TOL_F32:g}), empty tiles 0, a second launch bit-identical; longest tile "
            f"{int(counts.max())} items, {int((counts == 0).sum())} tiles without; {pairs} pairs "
            f"in range; kernel {tk:.4f} ms (device {dk:.5f} ms), plain {tr:.4f} ms, bound "
            f"{b[0]:.5f} ms ({b[1]}), special-function floor {sfu:.5f} ms ({probe.SFU_SWEEP_PAIR} "
            f"per pair, 16 per clock per SM at {mhz:g} MHz), empty launch {d_empty:.5f} ms; "
            f"library: none (no one call sums a masked kernel over a work list)")
    out["block_sweep"] = (worst, *out["block_sweep"][1:])

    out["window_sum"] = check_window_sum()

    worst = {"pair_matvec_probe": 0.0, "pair_matvec_scalar_probe": 0.0}
    for f32 in (True, False):
        tag = "f32" if f32 else "bf16"
        d = probe.stress_lists(f32=f32)
        two, sc, C = d["two"], d["scalar"], d["C"]
        out.update(check_pair_streams(f"x1 {tag}", two.w, f32))

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
    d = probe.stress_lists(replicas=4, f32=True)
    for key in ("w", "wbf16"):
        check_pair_streams(f"x4 {d[key].dtype}".replace("torch.", ""), d[key], False)
    del d
    torch.cuda.empty_cache()
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
               (jacobi, "hybrid_solve"), (pair_ops, "pair_matvec"), (pair_ops, "pair_visc"))
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
    sweep_only = [n for names in NOWCACHE_MODES.values() for n in names]
    want = [k for k in OPS_SWEEP_EMIT
            if k not in ("density", *SOLVER_SWEEPS, *MODE_SWEEPS, *sweep_only)]
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


def solve_agreement(name, m, st, m_ref, st_ref, inputs=None):
    """(iterations, max abs err, max rel err) of a whole-solve kernel against
    its plain version; raises unless the iteration counts are equal and every
    output row is within TOL_SOLVE of its max.

    inputs: the solve's (args, kwargs), for an input where a row's own max is
    rounding noise (a first step at rest: the x velocity after the divergence
    solve answers the divergence source's rounding noise) or where many
    capped sweeps carry the rounding of sums that cancel into the last
    digits. There a row beyond TOL_SOLVE of the plain version passes only if
    the kernel lies no further from a float64 solve (solve_f64) than
    F64_RATIO times the plain version, both relative to that row's own max
    and each the median over the same SOLVE_ORDERS orders of the pairs
    (solve_orders): one order's distance is one draw from a spread of several
    times its median, and on the GPU the plain version's atomic sums draw a
    new order on every call. Every other row keeps TOL_SOLVE."""
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
    orders = None
    for row in rows:
        e, rel = rel_err(m[row], m_ref[row])
        if not rel < TOL_SOLVE:
            if inputs is None:
                raise AssertionError(f"{name} (iterations {its}) M row {row}: max rel err "
                                     f"{rel:.3e} >= {TOL_SOLVE:g}")
            if orders is None:
                orders = solve_orders(name, *inputs, rows)
            ek, ep = orders[row]
            mk, mp = sorted(ek)[len(ek) // 2], sorted(ep)[len(ep) // 2]
            span = (f"kernel {mk:.3e} (own order {ek[0]:.3e}, {min(ek):.3e}-{max(ek):.3e}), "
                    f"plain {mp:.3e} ({min(ep):.3e}-{max(ep):.3e})")
            if not mk <= F64_RATIO * mp:
                raise AssertionError(f"{name} (iterations {its}) M row {row}: max rel err "
                                     f"{rel:.3e} >= {TOL_SOLVE:g} of the plain version, and "
                                     f"from the float64 solve, medians over {SOLVE_ORDERS} "
                                     f"pair orders: {span}")
            log(f"{name} M row {row}: max rel err {rel:.3e} of the plain version; from the "
                f"float64 solve, medians over {SOLVE_ORDERS} pair orders: {span} (ratio "
                f"{mk / max(mp, 1e-300):.3f}, limit {F64_RATIO:g})")
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


def shuffled_pairs(csr, seed):
    """csr with the pairs of each row in an order drawn from `seed` (0: as
    given); a whole solve reads only row_ptr, col and w."""
    import torch
    from adaptive_sph_torch.ops.pair_ops import PairCSR

    if seed == 0:
        return csr
    rp = csr.row_ptr.long().cpu()
    row = torch.repeat_interleave(torch.arange(rp.numel() - 1), rp.diff())
    g = torch.Generator().manual_seed(seed)
    key = row.double() + 0.5 * torch.rand(row.numel(), generator=g, dtype=torch.float64)
    o = torch.argsort(key).to(csr.col.device)
    return PairCSR(csr.row_ptr, csr.col[o].contiguous(), csr.w[:, o].contiguous(), None, None)


def solve_orders(name, a, kw, rows):
    """{row: (kernel's, plain version's distances)}: each M row's max
    distance from the float64 solve over its max, for SOLVE_ORDERS orders of
    the pairs (shuffled_pairs), the list's own order first. The kernel runs
    on the GPU; the plain version on the CPU, whose sums follow the list's
    order, so that both lists are reproducible."""
    import torch
    from adaptive_sph_torch.ops import jacobi

    csr, table, scal = a
    exact = solve_f64(name, a, kw).cpu()
    out = {row: ([], []) for row in rows}
    t_cpu, s_cpu = table.cpu(), scal.cpu()
    for seed in range(SOLVE_ORDERS):
        c = shuffled_pairs(csr, seed)
        mk, _ = getattr(jacobi, name)(c, table, scal, **kw)
        c_cpu = type(c)(c.row_ptr.cpu(), c.col.cpu(), c.w.cpu(), None, None)
        mp, _ = getattr(jacobi, name + "_ref")(c_cpu, t_cpu, s_cpu, **kw)
        mk = mk.cpu()
        for row in rows:
            out[row][0].append(rel_err(mk[row], exact[row])[1])
            out[row][1].append(rel_err(mp[row], exact[row])[1])
    torch.cuda.synchronize()
    return out


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
        torch.cuda.synchronize()
        its, worst_abs, worst_rel = solve_agreement(name, m, st, m_ref, st_ref,
                                                    (a, kw) if exact else None)
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


def capture_mode_sweep_inputs():
    """The first step of every run of stress.sweep_mode_runs on the GPU, with
    a spy on the step's pair sweeps: the first call of each new sweep mode
    ({mode: (run, (cell_starts, wm, statics, dyn, op, scale, tq))}) and the
    first-step layouts of the constrained stress run and the
    FromDistribution run on scene-ratio2to1 ({name: (cell_starts, wm,
    statics, tq)})."""
    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.models import tile_step
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import sweep_mode_runs

    calls, layouts = {}, {}
    real = tile_step.pair_sweep
    for run, (params, scene, capacity, _) in sweep_mode_runs().items():
        def spy(cell_starts, wm, statics, dyn, op, scale, tq, run=run):
            key = op.name if op.name in MODE_SWEEPS else None
            if key and key not in calls:
                calls[key] = (run, (cell_starts.clone(), wm.clone(), statics.clone(),
                                    None if dyn is None else dyn.clone(), op, scale, tq))
            if run not in layouts:
                layouts[run] = (cell_starts.clone(), wm.clone(), statics.clone(), tq)
            return real(cell_starts, wm, statics, dyn, op, scale, tq)

        sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                                device="cuda", counters_enabled=False)
        tile_step.pair_sweep = spy
        try:
            sim.step()
        finally:
            tile_step.pair_sweep = real
        del sim
    torch.cuda.synchronize()
    missing = [k for k in MODE_SWEEPS if k not in calls]
    if missing:
        raise AssertionError(f"the sweep-mode runs' first steps never ran {missing}")
    return calls, {"the stress x1 first step": layouts["stress_checked_constrained"],
                   "the scene-ratio2to1 first step": layouts["ratio2to1_from_distribution"]}


def mode_sweep_dyn(name, statics, seed):
    """Seeded dyn channels (C, D) on statics' device for a new sweep mode, or
    None: densities, unit normals, levels with a third of them known,
    fringe thresholds across -2h..2h, or (rho, a_x, a_y)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    C = statics.shape[0]
    if name in ("h_w_sum", "h_vw_sum", "centerdiff"):
        return None
    if name == "constant_field":
        d = rng.uniform(0.8, 1.2, (C, 1))
    elif name == "cone_range":
        ang = rng.uniform(0, 2 * np.pi, C)
        d = np.stack([np.cos(ang), np.sin(ang)], 1)
    elif name == "wavefront_range":
        d = np.stack([-rng.uniform(0, 0.2, C), rng.uniform(size=C) < 0.3], 1)
    elif name == "fringe_count":
        d = rng.uniform(-2.0, 2.0, (C, 1)) * statics[:, 2:3].cpu().numpy()
    else:
        d = np.stack([rng.uniform(0.8, 1.2, C), rng.normal(0, 1e3, C), rng.normal(0, 1e3, C)], 1)
    return torch.from_numpy(d.astype(np.float32)).to(statics.device)


def phase_mode_sweeps(calls, layouts):
    """Each new sweep mode against its plain version: on the input its main
    path's first step gave it (timed: CUDA events, profiled device time,
    plain version, bound), and with seeded inputs on the stress x1 and the
    scene-ratio2to1 first-step layouts (range ops and CenterDiff at the
    extended range where the layout was built for it, else 2 h). Counts and
    maxima equal, sums within TOL_F32 of the column max. Returns {"pair_sweep:
    <mode>": (max abs err, ms, plain ms, (bound ms, bound by), None)}."""
    import torch
    from adaptive_sph_torch.ops import sweeps
    from adaptive_sph_torch.timing import device_ms

    out = {}
    for name in MODE_SWEEPS:
        run, (cs, wm, st, dyn, op, scale, tq) = calls[name]
        cases = [(f"{run}, step 1", cs, wm, st, dyn, scale, tq)]
        for where, (lcs, lwm, lst, ltq) in layouts.items():
            ext = op.name in ("cone_range", "wavefront_range", "centerdiff") and \
                "ratio" in where
            cases.append((f"{where}, seeded", lcs, lwm, lst, mode_sweep_dyn(name, lst, 7),
                          scale if ext else 2.0, ltq))
        err_max = 0.0
        for k, (where, cs_, wm_, st_, dyn_, scale_, tq_) in enumerate(cases):
            got = sweeps.pair_sweep(cs_, wm_, st_, dyn_, op, scale_, tq_)
            ref = sweeps.pair_sweep_ref(cs_, wm_, st_, dyn_, op, scale_, tq_)
            torch.cuda.synchronize()
            g, r = got.double(), ref.double()
            err = float((g - r).abs().max())
            err_max = max(err_max, err)
            if op.reduce == "max" or name == "fringe_count":
                if not torch.equal(got, ref):
                    raise AssertionError(f"pair_sweep {name} on {where}: "
                                         f"{int((got != ref).sum())} values differ (must be "
                                         f"equal)")
                tol_txt = "equal"
            else:
                rel = float(((g - r).abs() / (r.abs().amax(0, keepdim=True) + 1e-30)).max())
                if not rel < TOL_F32 or float(r.abs().max()) <= 0:
                    raise AssertionError(f"pair_sweep {name} on {where}: rel err {rel:.3e} "
                                         f"(tol {TOL_F32:g}), max |plain| {float(r.abs().max())}")
                tol_txt = f"rel err {rel:.3e} (tol {TOL_F32:g} of the column max)"
            tested, inside = pair_census(cs_, wm_, st_, scale_, tq_)
            C = st_.shape[0]
            D = 0 if dyn_ is None else dyn_.numel() // C
            b = bound_ms(C * 16 + C * D * 4 + C * op.n_out * 4 + cs_.numel() * 4
                         + wm_.numel() * 4, inside * (OPS_PAIR_GEOM + OPS_SWEEP_EMIT[name]))
            tk = time_ms(lambda: sweeps.pair_sweep(cs_, wm_, st_, dyn_, op, scale_, tq_), 30)
            dk = device_ms(lambda: sweeps.pair_sweep(cs_, wm_, st_, dyn_, op, scale_, tq_), 20,
                           "pair_sweep_kernel")
            tr = time_ms(lambda: sweeps.pair_sweep_ref(cs_, wm_, st_, dyn_, op, scale_, tq_), 3)
            log(f"pair_sweep:{name} on {where} (C = {C}, scale {scale_:.6g}): {tested} tested "
                f"pairs, {inside} inside the radius; {tol_txt}, max abs err {err:.3e}; kernel "
                f"{tk:.4f} ms (device {dk:.4f} ms), plain {tr:.4f} ms, bound {b[0]:.5f} ms "
                f"({b[1]})")
            if k == 0:  # the kernels line: the main path's input
                main = (tk, tr, b)
        out["pair_sweep:" + name] = (err_max, *main, None)
    # check_neighborhood's brute-force count (plain torch, not a kernel) on
    # the stress x1 first step, beside the COUNT sweep it checks
    from adaptive_sph_torch.models import debug_checks
    from adaptive_sph_torch.models.tile_physics import COUNT_OP

    cs, wm, st, tq = layouts["the stress x1 first step"]
    live = st[:, 2] > 0
    ref = debug_checks.bruteforce_neighbor_count(st[:, 0:2], st[:, 2], live, 2.0)
    got = sweeps.pair_sweep(cs, wm, st, None, COUNT_OP, 2.0, tq)[:, 0].to(torch.int32)
    if not torch.equal(torch.where(live, got, torch.zeros_like(got)), ref):
        raise AssertionError("the COUNT sweep differs from the brute-force count")

    def brute():
        return debug_checks.bruteforce_neighbor_count(st[:, 0:2], st[:, 2], live, 2.0)

    log(f"check_neighborhood's brute-force count on the stress x1 first step (C = "
        f"{st.shape[0]}): equal to the COUNT sweep; {time_ms(brute, 5):.4f} ms (device "
        f"{device_ms(brute, 5):.4f} ms)")
    return out


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


def run_sweep_mode(run):
    """One run of stress.sweep_mode_runs on the GPU: (per-step records, the
    alive particles' fields, launches, plain-version calls); the launch
    counts are set to 0 just before the run and read just after."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import sweep_mode_runs

    params, scene, capacity, steps = sweep_mode_runs()[run]
    sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                            device="cuda", counters_enabled=False)
    recs = {k: [] for k in ("dt", "div_iterations", "density_iterations",
                            "neighborhood_check_mismatch", "aii_deviation")}
    with count_plain_calls() as plain:
        pair_ops.reset_launches()
        for _ in range(steps):
            d = sim.step()
            for k in recs:
                recs[k].append(d.get(k, -1))
        torch.cuda.synchronize()
        launches = dict(pair_ops.launches)
    st = sim.state
    a = st.alive.cpu().numpy()
    got = {k: getattr(st, k).cpu().numpy()[a].astype(np.float32)
           for k in ("position", "velocity", "density", *SWEEP_MODE_REL, *SWEEP_MODE_ABS,
                     *SWEEP_MODE_EXACT) if k not in ("position", "velocity", "density")}
    got.update({k: getattr(st, k).cpu().numpy()[a] for k in ("position", "velocity", "density")})
    return recs, got, launches, dict(plain)


def check_sweep_mode_run(run, recs, got, ref):
    """(what differs from the fixture, one log line's numbers)."""
    import numpy as np

    bad = []
    for k in ("div_iterations", "density_iterations", "neighborhood_check_mismatch"):
        if [int(v) for v in recs[k]] != ref[f"{run}__{k}"].tolist():
            bad.append(f"{k} {[int(v) for v in recs[k]]} != {ref[f'{run}__{k}'].tolist()}")
    ddt = float(np.abs(np.asarray(recs["dt"]) / ref[f"{run}__dt"] - 1.0).max())
    if ddt >= 1e-4:
        bad.append(f"dt rel err {ddt:.3e}")
    aii, aii_ref = np.asarray(recs["aii_deviation"], np.float64), ref[f"{run}__aii_deviation"]
    daii = float(np.abs(aii - aii_ref).max())
    if (aii_ref >= 0).any() and not (daii <= AII_DEVIATION_TOL and (aii < 0.01).all()):
        bad.append(f"aii_deviation {aii.tolist()} vs {aii_ref.tolist()}")
    if len(got["position"]) != len(ref[f"{run}__position"]):
        return bad + [f"census {len(got['position'])} != {len(ref[f'{run}__position'])}"], {}
    j = match_by_position(ref[f"{run}__position"], got["position"])
    errs = {}
    for k, tol in SWEEP_MODE_REL.items():
        w = ref[f"{run}__{k}"].astype(np.float64)
        errs[k] = float((np.abs(got[k][j] - w) / np.maximum(np.abs(w), 1e-30)).max())
        if not errs[k] < tol:
            bad.append(f"{k} rel err {errs[k]:.3e} (tol {tol:g})")
    for k, tol in SWEEP_MODE_ABS.items():
        errs[k] = float(np.abs(got[k][j] - ref[f"{run}__{k}"]).max())
        if not errs[k] < tol:
            bad.append(f"{k} abs err {errs[k]:.3e} (tol {tol:g})")
    for k in SWEEP_MODE_EXACT:
        errs[k] = int((got[k][j] != ref[f"{run}__{k}"]).sum())
        if errs[k]:
            bad.append(f"{k}: {errs[k]} particles differ")
    if not all(np.isfinite(v).all() for v in got.values()):
        bad.append("non-finite state")
    errs["aii_deviation"] = daii
    errs["dt"] = ddt
    return bad, errs


def phase_sweep_mode_trajectories():
    """Every run of stress.sweep_mode_runs on the GPU against
    tests/data/torch_port_sweep_modes_ref.npz: the launch counts set to 0 just
    before each run and read just after (its new sweep modes must have
    launched, the other new modes not, no plain version may have run);
    per-step iteration counts and check_neighborhood's mismatch equal, dt
    within 1e-4, check_aii's deviation within AII_DEVIATION_TOL and below
    the 0.01 gate; then the matched state and the fields these modes write
    (SWEEP_MODE_REL / _ABS / _EXACT: the flags, neighbour counts and the
    constrained set exactly). Returns ({run: launches}, {run: steps})."""
    import numpy as np
    import torch
    from adaptive_sph_torch.stress import sweep_mode_runs

    ref = np.load(SWEEP_MODES_FIXTURE)
    per_run, steps_of = {}, {}
    for run, (_, _, _, steps) in sweep_mode_runs().items():
        recs, got, launches, plain = run_sweep_mode(run)
        bad, errs = check_sweep_mode_run(run, recs, got, ref)
        required = SWEEP_MODE_RUN_KERNELS[run]
        bad += [f"pair_sweep:{k} never launched" for k in required
                if launches[f"pair_sweep:{k}"] <= 0]
        bad += [f"pair_sweep:{k} launched {launches[f'pair_sweep:{k}']} times"
                for k in MODE_SWEEPS if k not in required and launches[f"pair_sweep:{k}"]]
        if any(plain.values()):
            bad.append(f"plain versions ran: {plain}")
        per_run[run], steps_of[run] = launches, steps
        modes = {k: v for k, v in launches.items() if v and k.startswith("pair_sweep:")}
        log(f"sweep-mode run {run} vs JAX ({steps} steps, n={len(got['position'])}): div "
            f"iterations {[int(v) for v in recs['div_iterations']]}, density iterations "
            f"{[int(v) for v in recs['density_iterations']]}, reduced "
            f"{int(got['flag_neighborhood_reduced'].sum())}, surface "
            f"{int(got['flag_is_fluid_surface'].sum())}; errors "
            + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in errs.items())
            + f"; launches {modes} (pair_sweep {launches['pair_sweep']}); plain-version calls "
            f"{sum(plain.values())}")
        if bad:
            raise AssertionError(f"sweep-mode run {run}: " + "; ".join(bad))
        torch.cuda.empty_cache()
    return per_run, steps_of


def capture_nowcache_inputs():
    """The first step of each stress run of stress.nowcache_runs under
    ASPH_NO_WCACHE=1 with a spy on the step's pair sweeps: {sweep op name:
    (run, (cell_starts, wm, statics, dyn, op, scale, tq))}, each new
    functor's last call in the first run that calls it (a cold solve's first
    accel sweep sees p = 0); prep_xsph takes the parity run's prep input."""
    import dataclasses

    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.models import tile_physics as tp
    from adaptive_sph_torch.models import tile_step
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import nowcache_runs
    from adaptive_sph_torch.utils.params import ViscosityType

    names = {n for ns in NOWCACHE_MODES.values() for n in ns}
    calls = {}
    real = tile_step.pair_sweep
    with sweep_only():
        for run, (params, scene, capacity, _) in nowcache_runs().items():
            if not run.startswith("stress"):
                continue

            def spy(cell_starts, wm, statics, dyn, op, scale, tq, run=run):
                if op.name in names and calls.get(op.name, (run,))[0] == run:
                    d = dyn if dyn.ndim == 2 else dyn[:, None]  # (C, D)
                    calls[op.name] = (run, (cell_starts.clone(), wm.clone(), statics.clone(),
                                            d.contiguous().clone(), op, scale, tq))
                return real(cell_starts, wm, statics, dyn, op, scale, tq)

            sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                                    device="cuda", counters_enabled=False)
            tile_step.pair_sweep = spy
            try:
                sim.step()
            finally:
                tile_step.pair_sweep = real
            del sim
    torch.cuda.synchronize()
    run, (cs, wm, st, dyn, op, scale, tq) = calls["prep_laplace"]
    xsph = dataclasses.replace(nowcache_runs()[run][0], viscosity_type=ViscosityType.XSPH,
                               viscosity=0.0)
    calls["prep_xsph"] = (run, (cs, wm, st, dyn, tp.prep_op(xsph), scale, tq))
    missing = sorted(names - set(calls))
    if missing:
        raise AssertionError(f"the sweep-only stress runs' first steps never ran {missing}")
    return calls


def phase_nowcache_kernels():
    """N1: each functor of the sweep-only step against its plain version on
    its first-step input, and with the step's densities and seeded
    velocities, pressures or divergence operands (the first step starts at
    rest with every pressure clamped to 0, so its accel and div inputs give
    zeros and its viscosity columns too): sums within
    TOL_F32 of the column max, a second launch bit-identical; timed (CUDA
    events, profiled device time, plain version) beside the bound. Returns
    the kernels line's rows {"pair_sweep:<mode>": (max abs err, ms, plain
    ms, (bound ms, bound by), None)}: the times of each mode's main-path
    functor (prep_laplace, aii_sums, accel, div) on its last input, the
    error over all of the mode's functors and inputs."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import sweeps
    from adaptive_sph_torch.timing import device_ms

    calls = capture_nowcache_inputs()
    res = {}
    for name, (run, (cs, wm, st, dyn, op, scale, tq)) in sorted(calls.items()):
        C, D = dyn.shape
        cases = [("step 1", dyn)]
        if D > 1:  # the step's densities, seeded velocities / pressures
            rng = np.random.default_rng(7)
            seeded = (rng.uniform(0.0, 2e3, (C, 1)) if name == "accel"
                      else rng.normal(0.0, 0.4, (C, D - 1))).astype(np.float32)
            cases.append((f"step 1, seeded {', '.join(op.dyn_names[1:])}", torch.cat(
                [dyn[:, :1], torch.from_numpy(seeded).to(dyn.device)], dim=1).contiguous()))
        err = top = 0.0
        for where, d in cases:
            got = sweeps.pair_sweep(cs, wm, st, d, op, scale, tq)
            again = sweeps.pair_sweep(cs, wm, st, d, op, scale, tq)
            ref = sweeps.pair_sweep_ref(cs, wm, st, d, op, scale, tq)
            torch.cuda.synchronize()
            g, r = got.double(), ref.double()
            err = max(err, float((g - r).abs().max()))
            top = max(top, float(r.abs().max()))
            rel = float(((g - r).abs() / (r.abs().amax(0, keepdim=True) + 1e-30)).max())
            if not rel < TOL_F32:
                raise AssertionError(f"N1 pair_sweep {name} on {run}, {where}: rel err {rel:.3e} "
                                     f"(tol {TOL_F32:g})")
            if not torch.equal(got, again):
                raise AssertionError(f"N1 pair_sweep {name} on {run}, {where}: a second launch "
                                     f"differs")
            tested, inside = pair_census(cs, wm, st, scale, tq)
            b = bound_ms(C * 16 + d.numel() * 4 + C * op.n_out * 4 + cs.numel() * 4
                         + wm.numel() * 4, inside * (OPS_PAIR_GEOM + OPS_SWEEP_EMIT[name]))
            tk = time_ms(lambda: sweeps.pair_sweep(cs, wm, st, d, op, scale, tq), 30)
            dk = device_ms(lambda: sweeps.pair_sweep(cs, wm, st, d, op, scale, tq), 20,
                           "pair_sweep_kernel")
            tr = time_ms(lambda: sweeps.pair_sweep_ref(cs, wm, st, d, op, scale, tq), 3)
            log(f"N1 pair_sweep {name} on {run}, {where} (C = {C}, {op.n_out} sums over "
                f"{d.shape[1]} dyn channels): {tested} tested pairs, {inside} inside the radius; "
                f"rel err {rel:.3e} (tol {TOL_F32:g} of the column max), max abs err "
                f"{float((g - r).abs().max()):.3e}, max |plain| {float(r.abs().max()):.3e}, "
                f"second launch bit-identical; kernel {tk:.4f} ms (device {dk:.4f} ms), plain "
                f"{tr:.4f} ms, bound {b[0]:.5f} ms ({b[1]})")
        if not top > 0.0:
            raise AssertionError(f"N1 pair_sweep {name} on {run}: every output is 0")
        res[name] = (err, tk, tr, b)
    rows = {}
    for mode, names in NOWCACHE_MODES.items():
        err, tk, tr, b = res[names[0]]  # the mode's main-path functor
        rows["pair_sweep:" + mode] = (max(res[n][0] for n in names), tk, tr, b, None)
    return rows


def run_nowcache(run):
    """One run of stress.nowcache_runs on the GPU under ASPH_NO_WCACHE=1:
    (per-step records, the alive particles' fields, launches, plain-version
    calls); the launch counts are set to 0 just before the run and read just
    after."""
    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import nowcache_runs

    params, scene, capacity, steps = nowcache_runs()[run]
    recs = {k: [] for k in ("dt", *NOWCACHE_PER_STEP)}
    with sweep_only():
        sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                                device="cuda", counters_enabled=False)
        with count_plain_calls() as plain:
            pair_ops.reset_launches()
            for _ in range(steps):
                d = {**sim.step(), "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
                for k in recs:
                    recs[k].append(d.get(k, -1))
            torch.cuda.synchronize()
            launches = dict(pair_ops.launches)
    st = sim.state
    a = st.alive.cpu().numpy()
    got = {k: getattr(st, k).cpu().numpy()[a] for k in ("position", "velocity", "density",
                                                          "pressure", "mass")}
    return recs, got, launches, dict(plain)


def phase_nowcache_trajectories():
    """N2: every run of stress.nowcache_runs against its JAX fixture: its
    modes launched, no K1 / K2 / K3 / whole-solve kernel, no plain version;
    per-step counts equal, dt within 1e-4; the matched state (positions
    2e-5, density rtol 2e-5, velocity 2e-4, mass rtol 1e-5). Returns the
    launches summed over the runs."""
    import numpy as np
    import torch
    from adaptive_sph_torch.stress import nowcache_runs

    ref = np.load(NOWCACHE_FIXTURE)
    total = {}
    for run, (_, _, _, steps) in nowcache_runs().items():
        t0 = time.perf_counter()
        recs, got, launches, plain = run_nowcache(run)
        wall = time.perf_counter() - t0
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        bad = [f"{k} {[int(x) for x in recs[k]]} != {ref[f'{run}__{k}'].tolist()}"
               for k in NOWCACHE_PER_STEP if [int(x) for x in recs[k]] != ref[f"{run}__{k}"].tolist()]
        ddt = float(np.abs(np.asarray(recs["dt"], np.float64) / ref[f"{run}__dt"] - 1.0).max())
        if ddt >= 1e-4:
            bad.append(f"dt rel err {ddt:.3e}")
        bad += [f"pair_sweep:{m} never launched" for m in NOWCACHE_RUN_MODES[run]
                if launches[f"pair_sweep:{m}"] <= 0]
        bad += [f"{k} launched {launches[k]} times" for k in NOWCACHE_ABSENT if launches[k]]
        if any(plain.values()):
            bad.append(f"plain versions ran: {plain}")
        if len(got["position"]) != len(ref[f"{run}__position"]):
            raise AssertionError(f"N2 {run}: census {len(got['position'])} != "
                                 f"{len(ref[f'{run}__position'])}; " + "; ".join(bad))
        j = match_by_position(ref[f"{run}__position"], got["position"])
        errs = {"dx": float(np.abs(got["position"][j] - ref[f"{run}__position"]).max()),
                "drho_rel": float(np.abs(got["density"][j] / ref[f"{run}__density"] - 1).max()),
                "dv": float(np.abs(got["velocity"][j] - ref[f"{run}__velocity"]).max()),
                "dm_rel": float(np.abs(got["mass"][j] / ref[f"{run}__mass"] - 1).max())}
        if not (errs["dx"] < 2e-5 and errs["drho_rel"] < 2e-5 and errs["dv"] < 2e-4
                and errs["dm_rel"] < 1e-5):
            bad.append(f"state beyond tolerance: {errs}")
        if not all(np.isfinite(v).all() for v in got.values()):
            bad.append("non-finite state")
        modes = {k: v for k, v in launches.items() if v and k.startswith("pair_sweep")}
        log(f"N2 sweep-only run {run} vs JAX ({steps} steps, n={len(got['position'])}, capacity "
            f"{recs['capacity'][-1]}): div iterations {[int(x) for x in recs['div_iterations']]}, "
            f"density iterations {[int(x) for x in recs['density_iterations']]}, negative a_ii "
            f"{sum(int(x) for x in recs['negative_aii'])} in all; max |dx| {errs['dx']:.3e} "
            f"(tol 2e-5), rel drho {errs['drho_rel']:.3e} (2e-5), |dv| {errs['dv']:.3e} (2e-4), "
            f"rel dm {errs['dm_rel']:.3e} (1e-5), rel ddt {ddt:.3e} (1e-4); launches {modes}; "
            f"plain-version calls {sum(plain.values())}; {wall:.1f} s")
        if bad:
            raise AssertionError(f"N2 sweep-only run {run}: " + "; ".join(bad))
        torch.cuda.empty_cache()
    return total


def phase_nowcache_timed():
    """N3: the sweep-only branch timed through timed_path (parity and bench
    options, and the WCSPH viscosity after the divergence solve, which runs
    aii_sums): no K1 / K2 / K3 / whole-solve kernel; the four new modes
    launched over the three paths."""
    from adaptive_sph_torch.stress import nowcache_runs, stress_params

    modes = ("pair_sweep:prep", "pair_sweep:accel", "pair_sweep:div")
    total = {}
    with sweep_only():
        for params, tag, required in (
                (stress_params(), "sweep-only parity (f32, cold, momentum 0)", modes),
                (stress_params(bench=True), "sweep-only bench (warm start, momentum 0.9)", modes),
                (nowcache_runs()["stress_nowcache_wcsph_after_div"][0],
                 "sweep-only WCSPH viscosity after the divergence solve (f32, cold)",
                 ("pair_sweep:aii_sums", "pair_sweep:visc", "pair_sweep:accel",
                  "pair_sweep:div"))):
            launches = timed_path(params, tag, required, NOWCACHE_ABSENT)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    missing = [m for m in NOWCACHE_MODES if total["pair_sweep:" + m] <= 0]
    if missing:
        raise AssertionError(f"N3: modes never launched on the timed sweep-only paths: {missing}")


def phase_nowcache_slab():
    """N4: S1's uniform and impact scenes on 2 gloo ranks sharing the card
    under ASPH_NO_WCACHE=1 (the spawned ranks inherit it) against the one
    device under it: S1's tolerances, equal iterations, every rank's prep,
    accel and div sweeps launched and no K1."""
    import numpy as np
    import torch
    from adaptive_sph_torch import convert
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.multichip import SlabJob, run_ranks
    from adaptive_sph_torch.parallel.tile_sharding import gather_alive
    from adaptive_sph_torch.runner import create_simulation

    with sweep_only():
        for tag in ("uniform", "impact"):
            pdict, scene_d, capacity, steps = SLAB_RUNS[tag]
            one = create_simulation(convert.params_from_dict(pdict),
                                    scene_mod.scene_from_dict(scene_d), capacity=capacity,
                                    device="cuda", counters_enabled=False)
            one_diags = [one.step() for _ in range(steps)]
            ref = gather_alive(one.state)
            t0 = time.perf_counter()
            res = run_ranks(SlabJob(params=pdict, scene=scene_d, steps=steps, capacity=capacity),
                            2, "gloo", "cuda")
            wall = time.perf_counter() - t0
            got = gather_alive(res["final"])
            its = [(d["div_iterations"], d["density_iterations"]) for d in res["diags"]]
            its1 = [(d["div_iterations"], d["density_iterations"]) for d in one_diags]
            if got["position"].shape != ref["position"].shape:
                raise AssertionError(f"N4 {tag}: {len(got['position'])} particles, one device "
                                     f"{len(ref['position'])}")
            errs = {k: float(np.abs(got[k] - ref[k]).max()) for k in ("position", "velocity")}
            rel_d = float(np.max(np.abs(got["density"] - ref["density"]) / np.abs(ref["density"])))
            bad = [k for k, e in errs.items() if not e <= SLAB_ATOL[k]]
            if not rel_d <= SLAB_DENSITY_RTOL:
                bad.append(f"density rel {rel_d:.3e}")
            if its != its1:
                bad.append(f"iterations {its} / one device {its1}")
            for r, rr in enumerate(res["ranks"]):
                lc = rr["launches"]
                bad += [f"rank {r}: pair_sweep:{m} never launched" for m in ("prep", "accel", "div")
                        if lc["pair_sweep:" + m] <= 0]
                if lc["pair_build"]:
                    bad.append(f"rank {r}: pair_build launched {lc['pair_build']} times")
            per_rank = "; ".join(
                f"rank {r}: " + " ".join(f"{k} {rr['launches'][k]}" for k in (
                    "pair_sweep", "pair_sweep:prep", "pair_sweep:accel", "pair_sweep:div"))
                + f", {1e3 * float(np.mean(rr['step_s'])):.2f} ms/step"
                for r, rr in enumerate(res["ranks"]))
            log(f"N4 sweep-only slab {tag} on 2 gloo ranks sharing the card, {steps} steps: max |d| "
                f"vs one device position {errs['position']:.3e}, velocity {errs['velocity']:.3e}, "
                f"density rel {rel_d:.3e}; iterations {its}; {per_rank}; {wall:.1f} s with the "
                f"spawn")
            if bad:
                raise AssertionError(f"N4 {tag}: " + "; ".join(bad))
            del one
    torch.cuda.empty_cache()


def phase_nowcache():
    """N1-N4. Returns (the kernels line's rows of the four modes, their
    launches over N2's runs)."""
    t0 = time.perf_counter()
    rows = phase_nowcache_kernels()
    t1 = time.perf_counter()
    launches = phase_nowcache_trajectories()
    t2 = time.perf_counter()
    phase_nowcache_timed()
    t3 = time.perf_counter()
    phase_nowcache_slab()
    log(f"sweep-only phases: N1 {t1 - t0:.1f} s, N2 {t2 - t1:.1f} s, N3 {t3 - t2:.1f} s, N4 "
        f"{time.perf_counter() - t3:.1f} s")
    if "ASPH_NO_WCACHE" in os.environ:
        raise AssertionError("ASPH_NO_WCACHE leaked out of the sweep-only phases")
    return rows, {"pair_sweep:" + m: launches["pair_sweep:" + m] for m in NOWCACHE_MODES}


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


def timed_path(params, tag: str, required=(), absent=(), scene=None, steps=STEPS_TIMED):
    """`steps` (100) timed steps after 10 warm-up steps (the launch counts set to 0
    just before the timed run and read just after; `required` kernels must
    have launched, `absent` ones not), then STEPS_PROFILED steps under
    torch.profiler for the host synchronisations per step and the
    device-busy share. scene: a scene dict (default: the stress scene)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptive_sph_torch import spans
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_scene
    from adaptive_sph_torch.utils.params import PressureSolverMethod

    sim = create_simulation(params, stress_scene() if scene is None
                            else scene_mod.scene_from_dict(scene), device="cuda",
                            counters_enabled=False)
    n = sim.num_fluid_particles
    for _ in range(WARMUP):
        sim.step()
    torch.cuda.synchronize()
    pair_ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    diags = sim.step_chunk(steps)
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
    ms = el / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step_chunk(STEPS_PROFILED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in spans.device_ops(events))
    syncs = sum(e.count for e in events if "Synchronize" in e.key) / STEPS_PROFILED
    div = f"{np.mean(diags['div_iterations']):.2f}" if "div_iterations" in diags else "-"
    log(f"timed {tag}: {steps} steps, {ms:.4f} ms/step, {n * steps / el:.1f} "
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


def phase_aii_drift():
    """check_aii's deviation on the constrained, checked stress run
    (stress.sweep_mode_runs' stress_checked_constrained) over DRIFT_STEPS
    steps from its initial state, against JAX's per step
    (tests/data/torch_port_aii_drift_ref.npz, scripts/torch_port_aii_drift_ref.py),
    and at the witness steps (scripts/torch_port_aii_witness.py) the port's
    two a_ii terms against float64. Logs each step's deviation in steps of
    1/512 and the witness's errors beside JAX's. Fails where the port's terms
    are further from float64 than JAX's (tests/data/torch_port_aii_witness.npz)
    plus WITNESS_HEADROOM, where a step's deviation differs from JAX's by more
    than JAX's own 1-ulp spread plus WITNESS_HEADROOM, or where it reaches the
    0.01 gate (the runner raises there). Returns (the port's, JAX's) largest
    deviation."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.models.tile_step import physics_scale
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import DRIFT_STEPS, sweep_mode_runs

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_port_aii_witness as wit

    ref = np.load(DRIFT_FIXTURE)
    jw = np.load(WITNESS_FIXTURE)
    params, scene, capacity, _ = sweep_mode_runs()["stress_checked_constrained"]
    sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                            device="cuda", counters_enabled=False)
    pscale = float(physics_scale(sim.params))
    got, errs = [], {}
    for step in range(1, DRIFT_STEPS + 1):
        if wit.WITNESS_FROM <= step <= wit.WITNESS_TO:
            with wit.port_capture() as rec:
                d = sim.step()
            e, _ = wit.port_witness(wit.finish_port_record(rec, sim.params, pscale), sim.params)
            for k, v in e.items():
                errs.setdefault(k, []).append(v)
        else:
            d = sim.step()
        got.append(d["aii_deviation"])
    got = np.asarray(got, np.float64)
    want = ref["aii_deviation"].astype(np.float64)[:DRIFT_STEPS]
    d = np.abs(got - want)
    log(f"check_aii drift, stress_checked_constrained, {DRIFT_STEPS} steps vs JAX: port max "
        f"{got.max():.6g} (step {int(got.argmax()) + 1}), JAX max {want.max():.6g} (step "
        f"{int(want.argmax()) + 1}), JAX with 1-ulp initial positions max "
        f"{float(ref['aii_deviation_1ulp'].max()):.6g}; steps where the port's is larger "
        f"{int((got > want).sum())}, smaller {int((got < want).sum())}, equal "
        f"{int((got == want).sum())}; largest difference {d.max():.6g} at step "
        f"{int(d.argmax()) + 1}; mean port {got.mean():.6g}, JAX {want.mean():.6g}")
    q = wit.UNIT
    log("check_aii drift per step, in steps of 1/512, port / JAX / JAX 1-ulp: "
        + " ".join(f"{int(round(a / q))}/{int(round(b / q))}/{int(round(c / q))}" for a, b, c in
                   zip(got, want, ref["aii_deviation_1ulp"][:DRIFT_STEPS])))
    bad = []
    for k in WITNESS_KEYS:
        port, jax = max(errs[k]), float(jw[f"jax_{k}"].max())
        log(f"check_aii witness, steps {wit.WITNESS_FROM}-{wit.WITNESS_TO}, {k} (1/512): "
            f"port on the card {port:.4g} (port on the CPU "
            f"{float(jw[f'port_{k}'].max()):.4g}), JAX {jax:.4g}")
        if not port <= jax + WITNESS_HEADROOM:
            bad.append(f"{k} {port:.4g} > JAX's {jax:.4g} + {WITNESS_HEADROOM}")
    # per step: within what rounding alone leaves between two JAX runs (the
    # drift record's run from 1-ulp-moved positions) plus the headroom
    spread = np.abs(ref["aii_deviation_1ulp"].astype(np.float64)[:DRIFT_STEPS] - want)
    tol = float(spread.max()) + WITNESS_HEADROOM * q
    log(f"check_aii drift: largest per-step difference from JAX {d.max() / q:.4g} / 512 "
        f"(JAX against its 1-ulp run {spread.max() / q:.4g} / 512; tol {tol / q:.4g} / 512)")
    if not d.max() <= tol:
        bad.append(f"per-step difference {d.max():.6g} at step {int(d.argmax()) + 1} > {tol:.6g}")
    if bad:
        raise AssertionError("check_aii against JAX: " + "; ".join(bad))
    if not (got < 0.01).all():
        raise AssertionError(f"check_aii's deviation reached the 0.01 gate: {got.max():.6g}")
    del sim
    torch.cuda.empty_cache()
    return got.max(), want.max()


def export_entry_copy(src: str, index: int, out_dir: str, **changes) -> str:
    """Entry `index` of the export list `src` (with `changes`) as a one-entry
    list in out_dir, its config_path and scene_file absolute paths into the
    checkout: the export then writes into out_dir, never beside `src`."""
    import yaml

    with open(src) as f:
        entry = dict(yaml.safe_load(f)[index])
    for k in ("config_path", "scene_file"):
        if entry.get(k):
            entry[k] = os.path.normpath(os.path.join(os.path.dirname(src), entry[k]))
    entry.update(changes)
    path = os.path.join(out_dir, os.path.basename(src))
    with open(path, "w") as f:
        yaml.safe_dump([entry], f)
    return path


@contextlib.contextmanager
def profiled_steps(first: int, count: int, out: dict):
    """torch.profiler over steps first + 1 .. first + count of the
    simulations run inside (Simulation.step and step_physics wrapped; an
    adaptivity phase between them falls inside the window); out gets the
    window's steps, wall seconds, device seconds and host synchronisations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptive_sph_torch import runner, spans

    real = {k: getattr(runner.Simulation, k) for k in ("step", "step_physics")}
    st = {"n": 0, "prof": None, "t0": 0.0}

    def close():
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - st["t0"]
        st["prof"].__exit__(None, None, None)
        events = st["prof"].key_averages()
        out["device"] = sum(e.self_device_time_total for e in spans.device_ops(events)) / 1e6
        out["syncs"] = sum(e.count for e in events if "Synchronize" in e.key)
        out["steps"] = st["n"] - first
        st["prof"] = None

    def wrap(fn):
        def stepped(self, *a, **k):
            if st["n"] == first:
                torch.cuda.synchronize()
                st["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                st["prof"].__enter__()
                st["t0"] = time.perf_counter()
            d = fn(self, *a, **k)
            st["n"] += 1
            if st["n"] == first + count and st["prof"] is not None:
                close()
            return d
        return stepped

    for k, fn in real.items():
        setattr(runner.Simulation, k, wrap(fn))
    try:
        yield
    finally:
        for k, fn in real.items():
            setattr(runner.Simulation, k, fn)
        if st["prof"] is not None:
            close()


def file_digest(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def png_size(path: str):
    from PIL import Image

    with Image.open(path) as im:
        im.load()
        return im.size


def phase_image_export():
    """configs/media/ratio-stress-test.yaml entry 1 cut to IMAGE_TIME (n =
    11,835, HybridDFSPH, 50:1 radii, a 2000 x 2000 PNG with legend and title)
    through the image entry point (animation.export_simulation_images, what
    `python -m adaptive_sph_torch image` runs), from a copy of the list in a
    temporary directory with output_stats on; launch counts set to 0 just before, read just
    after (K1-K3 must have launched); the PNG decodes at 2000 x 2000, the
    .stat file holds one particle count per step; steps IMAGE_PROFILED_FROM
    + 1 .. + 10 under torch.profiler; the repository's own PNG of the entry
    is left untouched. Returns the launch counts."""
    import tempfile

    import numpy as np
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.utils import animation

    kept = os.path.join(MEDIA, "ratio-stress-test.png")
    digest = file_digest(kept)
    prof = {}
    with tempfile.TemporaryDirectory() as tmp:
        # output_stats on: the entry writes no .stat file of its own
        path = export_entry_copy(IMAGE_LIST, 0, tmp, output_stats=True, time=IMAGE_TIME)
        pair_ops.reset_launches()
        t0 = time.perf_counter()
        with profiled_steps(IMAGE_PROFILED_FROM, STEPS_PROFILED, prof):
            (r,) = animation.export_simulation_images([path])
        wall = time.perf_counter() - t0
        launches = dict(pair_ops.launches)
        size = png_size(r.png_file)
        with open(r.png_file + ".stat") as f:
            stat = f.read()
        png_bytes = os.path.getsize(r.png_file)
    bad = []
    if size != (2000, 2000):
        bad.append(f"PNG is {size}, not 2000 x 2000")
    if "simulation-time" not in stat or "density-iterations" not in stat:
        bad.append("the .stat file lacks its keys")
    counted = len(r.counters.values["particle-count"])
    if counted != r.steps or r.steps < 1:
        bad.append(f"{r.steps} steps but {counted} counted")
    if r.n != 11835 or not np.isfinite(r.position).all():
        bad.append(f"n = {r.n} (11,835 expected) or non-finite positions")
    bad += [f"{k} never launched" for k in ("pair_build", "pair_matvec", "pair_visc")
            if launches[k] <= 0]
    if prof.get("steps") != STEPS_PROFILED:
        bad.append(f"the profiled window holds {prof.get('steps')} steps")
    if file_digest(kept) != digest:
        bad.append(f"{kept} changed")
    if bad:
        raise AssertionError("image export: " + "; ".join(bad))
    log(f"image export ratio-stress-test.yaml entry 1: {r.steps} steps to t = {IMAGE_TIME} s, "
        f"{r.step_seconds / r.steps * 1e3:.4f} ms/step, render {r.render_seconds * 1e3:.1f} ms "
        f"per frame ({r.frames} frame, {png_bytes} B PNG 2000 x 2000), {wall:.1f} s in all; "
        f"steps {IMAGE_PROFILED_FROM + 1}-{IMAGE_PROFILED_FROM + STEPS_PROFILED} profiled: "
        f"device busy {prof['device'] / prof['wall']:.3f} of wall, "
        f"{prof['device'] / STEPS_PROFILED * 1e3:.4f} ms device time and "
        f"{prof['syncs'] / STEPS_PROFILED:.1f} host synchronisations per step; mean div / "
        f"density iters {np.mean(r.counters.values['div-iterations']):.2f} / "
        f"{np.mean(r.counters.values['density-iterations']):.2f}; launches {launches}")
    return launches


def phase_video_export():
    """configs/media/video-default.yaml entry 1 (the default dam break with
    resampling and capacity growth) with its time cut to VIDEO_TIME, through
    `adaptive_sph_torch.cli.main(["image", ...])` from a copy of the list:
    the two-phase step with Simulation.step_adaptivity spied on. The frames
    the export rule gives for the run's step times (24 or 25; an mp4, or
    numbered PNGs where imageio or its encoder is missing), each decoding at
    2000 x 2000; an adaptivity step between every
    two physics steps, resampling counted in them; the capacity grown where
    splits were deferred; the dam break's kernels launched."""
    import contextlib as cl
    import io
    import tempfile

    from adaptive_sph_torch import cli, runner
    from adaptive_sph_torch.ops import pair_ops

    real = runner.Simulation.step_adaptivity
    seen = []

    def spy(self, dt):
        cap = self.state.capacity
        d = real(self, dt)
        seen.append((d, cap, self.state.capacity, self.num_fluid_particles, self.time))
        return d

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        path = export_entry_copy(VIDEO_LIST, 0, tmp, time=VIDEO_TIME)
        pair_ops.reset_launches()
        runner.Simulation.step_adaptivity = spy
        try:
            t0 = time.perf_counter()
            with cl.redirect_stdout(out):
                rc = cli.main(["image", path])
            wall = time.perf_counter() - t0
        finally:
            runner.Simulation.step_adaptivity = real
        launches = dict(pair_ops.launches)
        frames_dir = os.path.join(tmp, "video-default-frames")
        mp4 = os.path.join(tmp, "video-default.mp4")
        if os.path.exists(mp4):
            written, sizes = f"mp4 {os.path.getsize(mp4)} B", set()
        else:
            names = sorted(os.listdir(frames_dir))
            sizes = {png_size(os.path.join(frames_dir, n)) for n in names}
            written = f"{len(names)} PNG frames"
    line = out.getvalue().strip().splitlines()[-1]
    m = re.search(r": (\d+) steps, (\d+) frames, n=(\d+), ([\d.]+) ms/step, ([\d.]+) ms per frame",
                  line)
    bad = []
    if rc != 0 or m is None:
        bad.append(f"cli image returned {rc}: {line!r}")
    steps, frames = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
    # the exporter's rule: every export time up to the start of the last step,
    # then the first one past it, which ends the video
    t_prev, te, want = seen[-1][4] if seen else 0.0, 0.0, 1
    while te <= t_prev:
        want, te = want + 1, te + 1.0 / 60.0 * 0.25
    if frames != want or (sizes and sizes != {(2000, 2000)}):
        bad.append(f"{frames} frames of {sizes} ({want} of 2000 x 2000 expected)")
    if not sizes and "mp4" not in written:
        bad.append("neither an mp4 nor frames")
    if "PNG frames" in written and int(written.split()[0]) != frames:
        bad.append(f"{written} on disk for {frames} frames")
    if len(seen) != steps - 1:
        bad.append(f"{len(seen)} adaptivity steps between {steps} physics steps")
    resampled = sum(d.get("shares", 0) + d.get("merge_or_split_count", 0) for d, *_ in seen)
    if resampled <= 0:
        bad.append("no particle resampled between frames")
    deferred = sum(d.get("split_deferred", 0) for d, *_ in seen)
    caps = [c for _, c0, c1, _, _ in seen for c in (c0, c1)]
    if deferred and not max(caps) > min(caps):
        bad.append(f"{deferred} splits deferred but the capacity never grew ({caps})")
    bad += [f"{k} never launched" for k in DAMBREAK_KERNELS if launches[k] <= 0]
    if bad:
        raise AssertionError("video export: " + "; ".join(bad))
    log(f"video export video-default.yaml entry 1, time cut to {VIDEO_TIME} s: {steps} physics "
        f"and {len(seen)} adaptivity steps, {frames} frames ({written}), n 1035 -> "
        f"{seen[-1][3]}, capacity {min(caps)} -> {max(caps)} ({deferred} splits deferred), "
        f"{resampled} particles resampled; {m.group(4)} ms/step, {m.group(5)} ms per frame "
        f"rendered, {wall:.1f} s in all; launches {launches}")


def phase_ten_levels():
    """configs/media/motivation-images.yaml entry 1 (n = 33,750, radii from
    0.002 to 0.7: ten populated grid levels, where the reference's tile
    backend stops at eight) with its time cut to 0.008 s and a 320 x 320
    image, through animation.export_simulation_images from a copy of the
    list: the walk kernels over ten levels' windows, resampling and growth;
    finite positions, K1-K3 and the sweeps launched."""
    import tempfile

    import numpy as np
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.utils import animation

    with tempfile.TemporaryDirectory() as tmp:
        path = export_entry_copy(os.path.join(MEDIA, "motivation-images.yaml"), 0, tmp,
                                 time=0.008, image_width=320, image_height=320)
        pair_ops.reset_launches()
        t0 = time.perf_counter()
        (r,) = animation.export_simulation_images([path])
        wall = time.perf_counter() - t0
        launches = dict(pair_ops.launches)
        size = png_size(r.png_file)
    bad = [f"{k} never launched" for k in DAMBREAK_KERNELS if launches[k] <= 0]
    if size != (320, 320) or not np.isfinite(r.position).all() or r.steps < 1:
        bad.append(f"PNG {size}, {r.steps} steps, finite {np.isfinite(r.position).all()}")
    if bad:
        raise AssertionError("ten-level export: " + "; ".join(bad))
    log(f"ten-level export motivation-images.yaml entry 1, time cut to 0.008 s: {r.steps} steps, "
        f"n 33750 -> {r.n}, {r.step_seconds / r.steps * 1e3:.2f} ms/step, {wall:.1f} s in all; "
        f"capacity growths {r.counters.values.get('capacity-growth', [])}")


def phase_run_options():
    """`adaptive_sph_torch.cli.main(["run", ...])` on the default dam break
    with every option of the reference's run: 20 steps with -p,
    --statistics-path, --vtk-dir / --vtk-every 5, --snapshot-png, --web-dir /
    --web-every 5, --watch-config (a file that does not change) and
    --checkpoint; its files checked. Then a straight 21-step run and a run
    resumed from the 20-step checkpoint for one step: their checkpoints hold
    the same census, clock and step count, and the same particles (matched
    by position) within RESUME_ATOL."""
    import json as js
    import tempfile

    import numpy as np
    from adaptive_sph_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        def j(*p):
            return os.path.join(tmp, *p)

        with open(j("watch.yaml"), "w") as f:
            f.write("{}\n")
        t0 = time.perf_counter()
        rc = cli.main(["run", CONFIG, SCENE, "--max-steps", "20", "-p", "--statistics-path",
                       j("run.stat"), "--vtk-dir", j("vtk"), "--vtk-every", "5",
                       "--snapshot-png", j("final.png"), "--web-dir", j("web"), "--web-every",
                       "5", "--watch-config", j("watch.yaml"), "--checkpoint", j("ck20.npz")])
        wall = time.perf_counter() - t0
        bad = [] if rc == 0 else [f"run returned {rc}"]
        with open(j("vtk", "adaptive-sph-torch.vtk.series")) as f:
            series = js.load(f)["files"]
        with open(j("web", "meta.json")) as f:
            web = js.load(f)["frames"]
        if len(series) != 4 or len(web) != 4:
            bad.append(f"{len(series)} VTK snapshots and {len(web)} web frames (4 each expected)")
        if png_size(j("final.png")) != (2000, 2000):
            bad.append("the snapshot PNG is not 2000 x 2000")
        with open(j("run.stat")) as f:
            if "simulation-step" not in f.read():
                bad.append("the statistics file lacks simulation-step")
        for name in ("index.html", web[-1]["file"] if web else "?"):
            if not os.path.exists(j("web", name)):
                bad.append(f"web/{name} missing")
        rc2 = cli.main(["run", CONFIG, SCENE, "--max-steps", "21", "--checkpoint", j("ck21.npz")])
        rc3 = cli.main(["run", CONFIG, SCENE, "--resume", j("ck20.npz"), "--max-steps", "1",
                        "--checkpoint", j("ck21r.npz")])
        if rc2 or rc3:
            bad.append(f"the straight and resumed runs returned {rc2}, {rc3}")
        a, b = dict(np.load(j("ck21.npz"))), dict(np.load(j("ck21r.npz")))
    for k in ("n", "step_number", "time"):
        if a[k] != b[k]:
            bad.append(f"{k}: straight {a[k]}, resumed {b[k]}")
    err = {}
    if a["n"] == b["n"]:
        n = int(a["n"])
        idx = match_by_position(a["position"][:n], b["position"][:n])
        for k in ("position", "velocity", "mass", "h"):
            err[k] = float(np.abs(a[k][:n] - b[k][:n][idx]).max())
            if not err[k] <= RESUME_ATOL[k]:
                bad.append(f"{k} differs by {err[k]:.3e} (tol {RESUME_ATOL[k]:g})")
    if bad:
        raise AssertionError("run options: " + "; ".join(bad))
    log(f"run with every option, 20 steps of the default dam break in {wall:.1f} s: "
        f"{len(series)} VTK snapshots, {len(web)} web frames, a 2000 x 2000 snapshot PNG, "
        f"statistics and a checkpoint; resumed step 21 against the straight run's: n "
        f"{int(a['n'])}, t {float(a['time']):.6g}, max abs diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))


def akinci_params(run="scene2_hybrid", **changes):
    """(params, scene dict) of a run of stress.akinci_runs with `changes`."""
    import dataclasses

    from adaptive_sph_torch.stress import akinci_runs

    params, scene, _, _ = akinci_runs()[run]
    return dataclasses.replace(params, **changes), scene


def akinci_first_step(run, **changes):
    """The first-step kernel inputs of an Akinci run (stress.akinci_runs) with
    `changes`, captured from that step, and its capacity."""
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.runner import create_simulation

    params, scene = akinci_params(run, **changes)
    sim = create_simulation(params, scene_mod.scene_from_dict(scene), device="cuda",
                            counters_enabled=False)
    return capture_step(sim), sim.state.capacity


def second_launch_equal(fn, first):
    """fn() again, its tensors (or a CSR list's) bit-identical to first's."""
    import torch

    def parts(x):
        if hasattr(x, "row_ptr"):
            return [x.row_ptr, x.col, x.w, x.s, x.prep]
        return list(x) if isinstance(x, (tuple, list)) else [x]

    again = fn()
    torch.cuda.synchronize()
    return all(torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b in
               zip(parts(again), parts(first)) if a is not None)


def phase_akinci_kernels():
    """The kernels of the particle (Akinci) boundary's paths against their
    plain versions on the first-step inputs of motivation-scene2 at full width
    (stress.akinci_runs' scene2_hybrid, n = 33,750, 1,000 boundary
    particles): K1 mega, K2 and K3 on the streamed HybridDFSPH step; the
    DENSITY sweep and pair_jacobi on the resident IISPH step; pair_hybrid on
    the resident HybridDFSPH step; the two solves also on the Akinci dam
    break's first step (stress.akinci_dam_scene, where the fluid touches the
    boundary particles) and to a cap of CAP_SWEEPS with a compressive
    source. Each launched twice, the second bit-identical; timed beside its
    plain version and its bound. Returns the kernels line's rows."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import jacobi, pair_ops, sweeps
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.utils.params import PressureSolverMethod as M

    rows = {}
    calls, C = akinci_first_step("scene2_hybrid")
    (cs, wm, flat, tq, scale, nu, stream, wdtype), kw = calls["pair_build"][0]
    dev = flat.device
    if not stream or kw.get("classic"):
        raise AssertionError("the streamed Akinci step's walk is not K1's mega mode with its "
                             "viscosity stream")
    # the first step starts at rest, which would zero every viscosity factor:
    # give the live particles seeded velocities for this check
    rng = np.random.default_rng(13)
    flat = flat.clone()
    live = (flat[:, 2] > 0).float()[:, None]
    flat[:, 4:6] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(dev) * live
    args = (cs, wm, flat, tq, scale, nu, True, wdtype)
    k = pair_ops.pair_build(*args, **kw)
    r = pair_ops.pair_build_ref(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(k.row_ptr, r.row_ptr) or not torch.equal(k.col, r.col):
        raise AssertionError("K1 pair_build [Akinci scene2]: pair structure differs from the "
                             "plain version")
    worst_abs = worst_rel = 0.0
    for name, got, want in (("w", k.w, r.w), ("s", k.s, r.s), ("prep", k.prep, r.prep)):
        for row in range(got.shape[0]):
            e, rel = rel_err(got[row], want[row])
            if not rel < TOL_F32:
                raise AssertionError(f"K1 pair_build [Akinci scene2] {name}[{row}]: max rel err "
                                     f"{rel:.3e} >= {TOL_F32:g}")
            worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
    if not second_launch_equal(lambda: pair_ops.pair_build(*args, **kw), k):
        raise AssertionError("K1 pair_build [Akinci scene2]: a second launch differs")
    P = k.num_pairs
    t_k = time_ms(lambda: pair_ops.pair_build(*args, **kw), 20)
    d_k = device_ms(lambda: pair_ops.pair_build(*args, **kw), 5)
    t_r = time_ms(lambda: pair_ops.pair_build_ref(*args, **kw), 3)
    b = bound_ms(C * 24 + (C + 1) * 4 + P * (4 + 4 * 4) + C * 16,
                 P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_VISC))
    rows["pair_build@akinci"] = (worst_abs, t_k, t_r, b, None)
    log(f"Akinci K1 pair_build (scene2 streamed hybrid first step, C = {C}, seeded "
        f"velocities): {P} pairs, structure equal, max abs err {worst_abs:.3e}, max rel err "
        f"{worst_rel:.3e} (tol {TOL_F32:g}); a second launch bit-identical; kernel {t_k:.4f} ms "
        f"(device {d_k:.4f} ms), plain {t_r:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")

    # K2 / K3 on that list with seeded operands (the first solve's pressures
    # are zero)
    alive = live[:, 0]
    u = torch.from_numpy(rng.uniform(0, 10, C).astype(np.float32)).to(dev) * alive
    tx = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
    ty = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
    rho = torch.from_numpy(rng.uniform(0.8, 1.2, C).astype(np.float32)).to(dev)
    if not (calls.get("pair_matvec") and calls.get("pair_visc")):
        raise AssertionError("the streamed Akinci step launched no K2 / K3")
    a2 = csr_product(k, C)
    t_lib = time_ms(lambda: a2 @ u[:, None], 200)
    d_lib = device_ms(lambda: a2 @ u[:, None], 50)
    b_k2 = bound_ms((C + 1) * 4 + P * (4 + 2 * 4) + C * 4 + 2 * C * 4, 4 * P)
    b_k3 = bound_ms((C + 1) * 4 + P * (4 + 2 * 4) + C * 4 + 2 * C * 4, 7 * P)
    for name, fk, fr, bnd, lib in (
            ("pair_matvec", lambda: pair_ops.pair_matvec(k, u, 2),
             lambda: pair_ops.pair_matvec_ref(k, u, 2), b_k2, t_lib),
            ("pair_matvec div", lambda: (pair_ops.pair_matvec(k, (tx, ty), 1),),
             lambda: (pair_ops.pair_matvec_ref(k, (tx, ty), 1),), b_k2, None),
            ("pair_visc", lambda: pair_ops.pair_visc(k, rho),
             lambda: pair_ops.pair_visc_ref(k, rho), b_k3, None)):
        got, want = fk(), fr()
        torch.cuda.synchronize()
        e_abs = e_rel = 0.0
        for g, w in zip(got, want):
            e, rel = rel_err(g, w)
            e_abs, e_rel = max(e_abs, e), max(e_rel, rel)
        if not e_rel < TOL_F32:
            raise AssertionError(f"Akinci {name}: max rel err {e_rel:.3e} >= {TOL_F32:g}")
        if not second_launch_equal(fk, got):
            raise AssertionError(f"Akinci {name}: a second launch differs")
        tk, dk, tr = time_ms(fk, 200), device_ms(fk, 50), time_ms(fr, 20)
        key = name.split()[0] + "@akinci"
        prev = rows.get(key)
        rows[key] = prev if prev else (e_abs, tk, tr, bnd, lib)
        if prev:
            rows[key] = (max(prev[0], e_abs), *prev[1:])
        extra = (f"; library (sparse CSR product) {t_lib:.4f} ms (device {d_lib:.4f} ms)"
                 if lib is not None else "")
        log(f"Akinci {name} ({stream_shape(C)}): max abs err {e_abs:.3e}, max rel err "
            f"{e_rel:.3e} (tol {TOL_F32:g}); a second launch bit-identical; kernel {tk:.4f} ms "
            f"(device {dk:.4f} ms), plain {tr:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}){extra}")
    del calls, k, r, a2
    torch.cuda.empty_cache()

    # the resident steps: DENSITY and pair_jacobi (IISPH), pair_hybrid (hybrid)
    solves = {"pair_jacobi": [], "pair_hybrid": []}
    for run, label in (("scene2_hybrid", "scene2"), ("dam_hybrid", "dam break")):
        for method, name in ((M.IISPH, "jacobi_solve"), (M.HybridDFSPH, "hybrid_solve")):
            calls, C = akinci_first_step(run, pressure_solver_method=method,
                                         resident_solver=True)
            if name not in calls:
                raise AssertionError(f"the resident {method.value} Akinci step ({label}) ran no "
                                     f"{name}")
            solves["pair_jacobi" if name == "jacobi_solve" else "pair_hybrid"].append(
                (label, calls[name][0]))
            if run == "scene2_hybrid" and method == M.IISPH:
                dens = [a for a, _ in calls["pair_sweep"] if a[4].name == "density"]
                if len(dens) != 1:
                    raise AssertionError(f"the resident Akinci step ran {len(dens)} density "
                                         f"sweeps, expected 1")
                dcs, dwm, dst, ddyn, op, dscale, dtq = dens[0]
                fk = lambda: sweeps.pair_sweep(dcs, dwm, dst, ddyn, op, dscale, dtq)  # noqa: E731
                fr = lambda: sweeps.pair_sweep_ref(dcs, dwm, dst, ddyn, op, dscale, dtq)  # noqa
                got, want = fk(), fr()
                torch.cuda.synchronize()
                e, rel = rel_err(got, want)
                if not rel < TOL_F32:
                    raise AssertionError(f"Akinci pair_sweep density: rel err {rel:.3e}")
                if not second_launch_equal(fk, got):
                    raise AssertionError("Akinci pair_sweep density: a second launch differs")
                tested, inside = pair_census(dcs, dwm, dst, dscale, dtq)
                Cs = dst.shape[0]
                b = bound_ms(Cs * 16 + Cs * 4 + dcs.numel() * 4 + dwm.numel() * 4,
                             inside * (OPS_PAIR_GEOM + OPS_SWEEP_EMIT["density"]))
                tk = time_ms(fk, 50)
                dk = device_ms(fk, 20, "pair_sweep_kernel")
                tr = time_ms(fr, 3)
                rows["pair_sweep@akinci"] = (e, tk, tr, b, None)
                log(f"Akinci pair_sweep density (scene2 resident IISPH first step, C = {Cs}): "
                    f"{tested} tested pairs, {inside} inside the radius; max abs err {e:.3e}, "
                    f"rel err {rel:.3e} (tol {TOL_F32:g}); a second launch bit-identical; "
                    f"kernel {tk:.4f} ms (device {dk:.4f} ms), plain {tr:.4f} ms, bound "
                    f"{b[0]:.5f} ms ({b[1]})")
            del calls
            torch.cuda.empty_cache()
    for kernel, cases in solves.items():
        name = "jacobi_solve" if kernel == "pair_jacobi" else "hybrid_solve"
        worst = 0.0
        for label, (a, kw) in cases:
            csr, table, scal = a
            capped = table.clone()
            src0 = capped[jacobi.T_SRC].abs()
            capped[jacobi.T_SRC] = src0 + src0.max()
            capped_scal = scal.clone()
            if name == "hybrid_solve":
                capped_scal[1:3] = 0.0
            else:
                capped_scal[1] = 0.0
            for what, ta, sa, skw in (
                    ("as the step gave it", table, scal, kw),
                    (f"source |src0| + max |src0|, tolerances 0, cap {CAP_SWEEPS}", capped,
                     capped_scal, {**kw, "max_iters": CAP_SWEEPS})):
                fk = lambda: getattr(jacobi, name)(csr, ta, sa, **skw)  # noqa: E731
                m, st = fk()
                m_ref, st_ref = getattr(jacobi, name + "_ref")(csr, ta, sa, **skw)
                torch.cuda.synchronize()
                its, e_abs, e_rel = solve_agreement(name, m, st, m_ref, st_ref,
                                                    ((csr, ta, sa), skw))
                if ta is capped and any(i != CAP_SWEEPS for i in its):
                    raise AssertionError(f"Akinci {kernel} [{label}, {what}]: iterations {its}, "
                                         f"expected the cap")
                if not second_launch_equal(fk, (m, st)):
                    raise AssertionError(f"Akinci {kernel} [{label}, {what}]: a second launch "
                                         f"differs")
                worst = max(worst, e_abs)
                gmax = float(ta[jacobi.T_GXP].abs().max())
                log(f"Akinci {kernel} vs plain, resident {label} first step ({what}; C = "
                    f"{table.shape[1]}, {csr.num_pairs} pairs, max |G| {gmax:.4g}, mp "
                    f"{skw['mp']:g}): iterations {its} equal, max abs err {e_abs:.3e}, max rel "
                    f"err {e_rel:.3e} (tol {TOL_SOLVE:g}); a second launch bit-identical")
        label, (a, kw) = cases[0]
        _, st = getattr(jacobi, name)(*a, **kw)
        tk = time_ms(lambda: getattr(jacobi, name)(*a, **kw), 20)
        dk = device_ms(lambda: getattr(jacobi, name)(*a, **kw), 20, kernel)
        tr = time_ms(lambda: getattr(jacobi, name + "_ref")(*a, **kw), 3)
        walks, sw = solve_walks(name, st, kw)
        b = solve_bound(name, a, kw, st)
        rows[kernel + "@akinci"] = (worst, tk, tr, b, None)
        log(f"Akinci {kernel} on the resident {label} first step: {sw} sweeps, {walks} pair "
            f"walks; kernel {tk:.4f} ms per solve (device {dk:.4f} ms), plain {tr:.4f} ms, "
            f"bound {b[0]:.5f} ms ({b[1]})")
    torch.cuda.empty_cache()
    return rows


def phase_akinci_trajectories():
    """Every run of stress.akinci_runs on the GPU against
    tests/data/torch_port_akinci_ref.npz (the Akinci dam break streamed and
    resident, 10 steps each; motivation-scene2 at full width, 3 steps): the
    launch counts set to 0 just before each run and read just after (its
    kernels must have launched, no plain version may have run); iteration
    counts equal at every step, dt within 1e-4; then the matched state
    (positions 2e-5, density rtol 2e-5, velocity 2e-4; the resident run's
    pressure rtol 5e-3 / atol 1e-2)."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import akinci_runs

    ref = np.load(AKINCI_FIXTURE)
    for run, (params, scene, capacity, steps) in akinci_runs().items():
        sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                                device="cuda", counters_enabled=False)
        its = {"div_iterations": [], "density_iterations": []}
        dts = []
        with count_plain_calls() as plain:
            pair_ops.reset_launches()
            for _ in range(steps):
                d = sim.step()
                for k in its:
                    its[k].append(int(d.get(k, -1)))
                dts.append(d["dt"])
            torch.cuda.synchronize()
            launches = dict(pair_ops.launches)
        bad = [f"{k} {v} != {ref[f'{run}__{k}'].tolist()}" for k, v in its.items()
               if v != ref[f"{run}__{k}"].tolist()]
        ddt = float(np.abs(np.asarray(dts) / ref[f"{run}__dt"] - 1.0).max())
        if ddt >= 1e-4:
            bad.append(f"dt rel err {ddt:.3e}")
        bad += [f"{k} never launched" for k in AKINCI_RUN_KERNELS[run] if launches[k] <= 0]
        if any(plain.values()):
            bad.append(f"plain versions ran: {plain}")
        st = sim.state
        a = st.alive.cpu().numpy()
        got = {k: getattr(st, k).cpu().numpy()[a] for k in ("position", "velocity", "density",
                                                              "pressure")}
        want = {k: ref[f"{run}__{k}"] for k in got}
        if len(got["position"]) != len(want["position"]):
            raise AssertionError(f"Akinci {run}: particle count differs from the reference")
        j = match_by_position(got["position"], want["position"])
        dx = float(np.abs(got["position"] - want["position"][j]).max())
        drho = float(np.abs(got["density"] / want["density"][j] - 1).max())
        dv = float(np.abs(got["velocity"] - want["velocity"][j]).max())
        pw = want["pressure"][j]
        dp = float(np.abs(got["pressure"] - pw).max())
        p_ok = bool((np.abs(got["pressure"] - pw) <= 1e-2 + 5e-3 * np.abs(pw)).all())
        bt = sim.boundary_handler.update_after_advect(st.position, torch.clamp(st.h, min=1e-6),
                                                      sim.params)
        near = int((bt.bmask.any(1) & st.alive).sum())
        log(f"Akinci {run} vs JAX ({steps} steps, n={len(j)}, "
            f"{sim.boundary_handler.static.positions.shape[0]} boundary particles, {near} fluid "
            f"particles with a boundary neighbour at the end): div iterations "
            f"{its['div_iterations']}, density iterations {its['density_iterations']}; max |dx| "
            f"{dx:.3e} (tol 2e-5), rel drho {drho:.3e} (2e-5), |dv| {dv:.3e} (2e-4), |dp| "
            f"{dp:.3e}, rel ddt {ddt:.3e} (1e-4); launches "
            f"{ {k: v for k, v in launches.items() if v} }; plain-version calls "
            f"{sum(plain.values())}")
        if not (dx < 2e-5 and drho < 2e-5 and dv < 2e-4):
            bad.append("state beyond tolerance")
        if params.resident_solver and not p_ok:
            bad.append("pressure beyond tolerance")
        if bad:
            raise AssertionError(f"Akinci run {run}: " + "; ".join(bad))
        del sim
    torch.cuda.empty_cache()


def phase_akinci_timed():
    """motivation-scene2 with the particle boundary at full width, timed
    (stress.akinci_runs' scene2_hybrid: streamed HybridDFSPH; with the
    resident solver, HybridDFSPH and IISPH), AKINCI_TIMED_STEPS steps each
    after the warm-up, with the profiled window; then the boundary terms of
    the first state by themselves (the neighbour search against the boundary
    particles, G, the density term): events and device time. Returns the
    launches of the three runs."""
    import torch
    from adaptive_sph_torch.models import boundary as bnd
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.models.tile_step import step_geometry
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.utils.params import PressureSolverMethod as M

    out = {}
    for tag, changes, required, absent in (
            ("streamed hybrid", {}, ("pair_build", "pair_matvec", "pair_visc"),
             ("pair_jacobi", "pair_hybrid")),
            ("resident hybrid", {"resident_solver": True},
             ("pair_build", "pair_sweep", "pair_hybrid"), ("pair_jacobi", "pair_visc")),
            ("resident IISPH", {"resident_solver": True, "pressure_solver_method": M.IISPH},
             ("pair_build", "pair_sweep", "pair_jacobi"), ("pair_hybrid", "pair_visc"))):
        params, scene = akinci_params("scene2_hybrid", **changes)
        out[tag] = timed_path(params, f"Akinci motivation-scene2 {tag} (f32, cold)", required,
                              absent, scene=scene, steps=AKINCI_TIMED_STEPS)
    params, scene = akinci_params("scene2_hybrid")
    sim = create_simulation(params, scene_mod.scene_from_dict(scene), device="cuda",
                            counters_enabled=False)
    _, _, cols, _ = step_geometry(sim.state, sim.params, sim.tile_cfg)
    pos_s = cols["pos"].contiguous()
    h_s = torch.clamp(cols["h_raw"], min=1e-6)
    handler = sim.boundary_handler

    def search():
        return handler.update_after_advect(pos_s, h_s, sim.params)

    def terms():
        bt = search()
        return (bnd.solver_terms(bt, pos_s, h_s, sim.params).G,
                bnd.density_boundary_term(bt, pos_s, h_s, sim.params))

    for name, fn in (("boundary neighbour search (update_after_advect)", search),
                     ("boundary terms (search, G, density term)", terms)):
        log(f"Akinci {name}, scene2 first state (C = {sim.state.capacity}, "
            f"{handler.static.positions.shape[0]} boundary particles): {time_ms(fn, 21):.4f} ms "
            f"events, {device_ms(fn, 5):.4f} ms device")
    del sim
    torch.cuda.empty_cache()
    return out


def phase_run_profile():
    """`run -p` with profile_stages on the default dam break (20 steps)
    through adaptive_sph_torch.cli.main: every section the reference records
    for the configuration appears in the .stat file with a positive time."""
    import tempfile

    import yaml
    from adaptive_sph_torch import cli
    from adaptive_sph_torch.utils.params import load_params
    from adaptive_sph_torch.utils.profiling import section_names

    with tempfile.TemporaryDirectory() as tmp:
        with open(CONFIG) as f:
            config = yaml.safe_load(f)
        config["profile_stages"] = True
        cfg, stat = os.path.join(tmp, "config.yaml"), os.path.join(tmp, "run.stat")
        with open(cfg, "w") as f:
            yaml.safe_dump(config, f)
        t0 = time.perf_counter()
        rc = cli.main(["run", cfg, SCENE, "--max-steps", str(STEPS_CLI), "-p",
                       "--statistics-path", stat])
        el = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"run -p with profile_stages returned {rc}")
        with open(stat) as f:
            text = f.read()
        want = section_names(load_params(cfg))
    times = {}
    for line in text.splitlines():
        m = re.match(r"^(\S+): avg:([0-9.eE+-]+)ms$", line)
        if m:
            times[m.group(1)] = float(m.group(2))
    bad = [name for name in want if not times.get(name, 0.0) > 0.0]
    if bad:
        raise AssertionError(f"run -p: sections missing or not positive: {bad}")
    log(f"run -p with profile_stages (default dam break, {STEPS_CLI} steps, {el:.2f} s): "
        + ", ".join(f"{name} {times[name]:.4f} ms" for name in want))


def phase_split_patterns():
    """`generate-split-patterns --max-children GEN_MAX_CHILDREN` on the card
    through adaptive_sph_torch.cli.main: the patterns for 2..N children in
    the reference's schema, each with the reference's properties (its count,
    the parent's mass, children inside the parent's support), with the
    attempts and seconds of each."""
    import contextlib as ctx
    import io
    import tempfile

    import numpy as np
    from adaptive_sph_torch import cli
    from adaptive_sph_torch.ops import kernels
    from adaptive_sph_torch.utils.split_patterns import load_patterns_yaml

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "split-patterns.yaml")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with ctx.redirect_stdout(buf):
            rc = cli.main(["generate-split-patterns", out, "--max-children",
                           str(GEN_MAX_CHILDREN)])
        el = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            log(f"generate-split-patterns: {line}")
        if rc != 0:
            raise AssertionError(f"generate-split-patterns returned {rc}")
        patterns = load_patterns_yaml(out)
    parent = float(kernels.radius_to_sphere_volume(1.0, 2))
    h = float(kernels.smoothing_length_from_mass(parent, 1.0, 2))
    if len(patterns) != GEN_MAX_CHILDREN - 1:
        raise AssertionError(f"generate-split-patterns wrote {len(patterns)} patterns")
    for k, p in enumerate(patterns):
        n = k + 2
        r = np.linalg.norm(np.asarray(p["pos_s"], np.float64), axis=1)
        if not (len(p["pos_s"]) == n and abs(sum(p["mass_s"]) - parent) < 1e-6 * parent
                and float(r.max()) < 2.0 * h):
            raise AssertionError(f"split pattern {n}: properties do not hold")
    log(f"generate-split-patterns --max-children {GEN_MAX_CHILDREN}: {len(patterns)} patterns "
        f"in {el:.2f} s, each with its count, the parent's mass and its children inside 2h")


def slab_sweep_op(params, saved):
    """The pair-sweep op of the slab step (level estimation, the matching in
    either mode) with the captured name and parameters."""
    from adaptive_sph_torch.models import adaptivity
    from adaptive_sph_torch.models import tile_physics as tp

    ops = [tp.COUNT_OP, tp.DENSITY_OP, tp.normal_op(params), tp.cone_op(params),
           tp.wavefront_op(params), tp.SMOOTH_OP]
    for mode in ("merge", "share"):
        ops += list(adaptivity._adapt_ops(params, mode)[0].values())
    name, prm = saved
    found = [op for op in ops if op.name == name and op.params == prm]
    if len(found) != 1:
        raise AssertionError(f"the slab step's sweep {name} {prm}: {len(found)} matching ops")
    return found[0]


def slab_params(pdict, scene_d):
    """The parameters a slab run's ranks step with (create_simulation's
    h for uniform sizes)."""
    from adaptive_sph_torch import convert
    from adaptive_sph_torch.utils import params as params_mod

    block = scene_d["blocks"][0]
    return params_mod.init_h_for_uniform(convert.params_from_dict(pdict), block["spacing"],
                                         block["volume_fill_ratio"])


def check_slab_resampling(tag, ranks, res, one, one_diags):
    """A resampling slab run against the one-device run by invariants (the
    matching is slab-local, so the two runs pair particles differently):
    events on both, every step's mass conservation error < 1e-5 and no
    overflow, the total mass within 1e-5 of the initial and of the one
    device's, the census (n equals the alive rows) and the particle count
    within 15% of the one device's (tests/test_multichip.py's band)."""
    import numpy as np

    events = sum(d["merge_or_split_count"] + d["shares"] for d in res["diags"])
    events1 = sum(int(d.get("merge_or_split_count", 0)) + int(d.get("shares", 0))
                  for d in one_diags)
    bad = [(k, d["mass_conservation_error"], d["shard_overflow"])
           for k, d in enumerate(res["diags"])
           if not (d["mass_conservation_error"] < 1e-5 and d["shard_overflow"] == 0)]
    fin = res["final"]
    mass = float(np.sum(fin["mass"][fin["alive"]].astype(np.float64)))
    st1 = one.state
    mass1 = float(st1.mass[st1.alive].double().sum())
    n, n1 = int(fin["alive"].sum()), int(st1.alive.sum())
    drift, vs_one = abs(mass - res["mass0"]) / res["mass0"], abs(mass - mass1) / mass1
    if not (events > 0 and events1 > 0) or bad or not (drift < 1e-5 and vs_one < 1e-5) \
            or int(fin["n"]) != n or not abs(n - n1) / n1 < 0.15:
        raise AssertionError(f"S1 {tag} on {ranks} ranks: events {events} (one device {events1}), "
                             f"steps off {bad}, mass drift {drift:.3e}, against one device "
                             f"{vs_one:.3e}, census n {int(fin['n'])} alive {n}, one device {n1}")
    return (f"resampling events {events} (one device {events1}), mass drift {drift:.2e}, "
            f"against one device {vs_one:.2e}, n {res['n0']} -> {n} (one device {n1})")


def phase_slab_parity():
    """S1: the slab-decomposed step on 2 and 4 gloo ranks sharing the card
    against the one-device run, every rank's launches, and the kernels on
    rank 0's first-step inputs of the small levels run (the kernels line's
    rows come from S2)."""
    import tempfile

    import numpy as np
    import torch
    from adaptive_sph_torch import convert
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.multichip import RunHooks, SlabJob, run_ranks
    from adaptive_sph_torch.parallel.tile_sharding import gather_alive
    from adaptive_sph_torch.runner import create_simulation

    tmp = tempfile.mkdtemp(prefix="asph_slab_capture_")
    capture = os.path.join(tmp, "first_step.pt")
    counts = {}
    for tag, (pdict, scene_d, capacity, steps) in SLAB_RUNS.items():
        one = create_simulation(convert.params_from_dict(pdict), scene_mod.scene_from_dict(scene_d),
                                capacity=capacity, device="cuda", counters_enabled=False)
        one_diags = [one.step() for _ in range(steps)]
        ref = gather_alive(one.state)
        for ranks in SLAB_RANKS:
            t0 = time.perf_counter()
            job = SlabJob(params=pdict, scene=scene_d, steps=steps, capacity=capacity)
            hooks = RunHooks(capture=capture) if (tag, ranks) == ("levels", 2) else None
            res = run_ranks(job, ranks, "gloo", "cuda", hooks)
            wall = time.perf_counter() - t0
            its = [(d["div_iterations"], d["density_iterations"]) for d in res["diags"]]
            its1 = [(d["div_iterations"], d["density_iterations"]) for d in one_diags]
            if tag in SLAB_INVARIANT_RUNS:
                held = check_slab_resampling(tag, ranks, res, one, one_diags)
            else:
                got = gather_alive(res["final"])
                if got["position"].shape != ref["position"].shape:
                    raise AssertionError(f"S1 {tag} on {ranks} ranks: {len(got['position'])} "
                                         f"particles, one device {len(ref['position'])}")
                errs = {k: float(np.abs(got[k] - ref[k]).max()) for k in SLAB_ATOL}
                rel_d = float(np.max(np.abs(got["density"] - ref["density"])
                                     / np.abs(ref["density"])))
                bad = [k for k, e in errs.items() if not e <= SLAB_ATOL[k]]
                # 2 ranks: a psum of two floats does not depend on the order
                if bad or not rel_d <= SLAB_DENSITY_RTOL or (ranks == 2 and its != its1):
                    raise AssertionError(f"S1 {tag} on {ranks} ranks against one device: {errs}, "
                                         f"density rel {rel_d:.3e}, iterations {its} / {its1}")
                held = (f"max |d| vs one device position {errs['position']:.3e}, velocity "
                        f"{errs['velocity']:.3e}, level {errs['level']:.3e}, density rel "
                        f"{rel_d:.3e}")
            for r, rr in enumerate(res["ranks"]):
                c = counts.setdefault((ranks, r), {k: 0 for k in SLAB_KERNELS})
                for k in SLAB_KERNELS:
                    c[k] += rr["launches"][k]
            per_rank = "; ".join(
                f"rank {r}: " + " ".join(f"{k} {rr['launches'][k]}" for k in SLAB_KERNELS)
                + f", {rr['comm']['exchanges'] / steps:.1f} exchanges and "
                f"{rr['comm']['reductions'] / steps:.1f} reductions per step, "
                f"{1e3 * float(np.mean(rr['step_s'])):.2f} ms/step"
                for r, rr in enumerate(res["ranks"]))
            log(f"S1 slab {tag} on {ranks} gloo ranks sharing the card, {steps} steps "
                f"(c_dev {res['scfg'].c_dev}, strip {res['scfg'].strip}): {held}; iterations "
                f"{its} (one device {its1}); {per_rank}; {wall:.1f} s with the spawn")
    missing = [(key, k) for key, c in counts.items() for k in SLAB_KERNELS if c[k] <= 0]
    if missing:
        raise AssertionError(f"S1: kernels a rank never launched ((ranks, rank), kernel): "
                             f"{missing}")
    pdict, scene_d = SLAB_RUNS["levels"][:2]
    slab_kernel_rows(capture, slab_params(pdict, scene_d), "S1 (levels, 2 ranks)")
    os.remove(capture)
    os.rmdir(tmp)
    torch.cuda.empty_cache()


def slab_kernel_rows(capture: str, params, tag: str):
    """K1 (seeded velocities), K2 and K3 (seeded operands on K1's list) and
    each captured sweep against their plain versions on rank 0's first-step
    slab inputs; the kernels line's rows (the sweeps' times summed over the
    ops). tag: the run, in the log."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import pair_ops, sweeps
    from adaptive_sph_torch.timing import device_ms

    calls = torch.load(capture, map_location="cuda:0", weights_only=False)
    missing = [k for k in ("pair_build", "pair_matvec:accel", "pair_matvec:div", "pair_visc")
               if k not in calls]
    if missing or not any(k.startswith("pair_sweep:") for k in calls):
        raise AssertionError(f"{tag}: rank 0's first slab step did not call "
                             f"{missing or 'pair_sweep'}")
    (cs, wm, flat, tq, scale, nu, stream, wdtype), kw = calls["pair_build"]
    if not stream or kw.get("classic"):
        raise AssertionError(f"{tag}: the slab step's walk is not K1's mega mode with its stream")
    dev = flat.device
    C = flat.shape[0]
    rng = np.random.default_rng(17)
    flat = flat.clone()
    live = (flat[:, 2] > 0).float()[:, None]
    flat[:, 4:6] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(dev) * live
    args = (cs, wm, flat, tq, scale, nu, True, wdtype)
    k = pair_ops.pair_build(*args, **kw)
    r = pair_ops.pair_build_ref(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(k.row_ptr, r.row_ptr) or not torch.equal(k.col, r.col):
        raise AssertionError(f"{tag} K1 pair_build [slab rank 0]: pair structure differs from plain")
    worst_abs = 0.0
    for name, got, want in (("w", k.w, r.w), ("s", k.s, r.s), ("prep", k.prep, r.prep)):
        for row in range(got.shape[0]):
            e, rel = rel_err(got[row], want[row])
            if not rel < TOL_F32:
                raise AssertionError(f"{tag} K1 pair_build [slab rank 0] {name}[{row}]: max rel err "
                                     f"{rel:.3e} >= {TOL_F32:g}")
            worst_abs = max(worst_abs, e)
    P = k.num_pairs
    rows = {}
    t_k = time_ms(lambda: pair_ops.pair_build(*args, **kw), 20)
    d_k = device_ms(lambda: pair_ops.pair_build(*args, **kw), 5)
    t_r = time_ms(lambda: pair_ops.pair_build_ref(*args, **kw), 3)
    b = bound_ms(C * 24 + (C + 1) * 4 + P * (4 + 4 * 4) + C * 16,
                 P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_VISC))
    rows["pair_build@slab"] = (worst_abs, t_k, t_r, b, None)
    log(f"{tag} K1 pair_build (slab rank 0 first step, C = {C}, seeded velocities): {P} pairs, "
        f"structure equal, max abs err {worst_abs:.3e} (rel tol {TOL_F32:g}); kernel "
        f"{t_k:.4f} ms (device {d_k:.4f} ms), plain {t_r:.4f} ms, bound {b[0]:.5f} ms ({b[1]})")

    alive = live[:, 0]
    u = torch.from_numpy(rng.uniform(0, 10, C).astype(np.float32)).to(dev) * alive
    tx = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
    ty = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
    rho = torch.from_numpy(rng.uniform(0.8, 1.2, C).astype(np.float32)).to(dev)
    a2 = csr_product(k, C)
    t_lib = time_ms(lambda: a2 @ u[:, None], 200)
    b_k2 = bound_ms((C + 1) * 4 + P * (4 + 2 * 4) + C * 4 + 2 * C * 4, 4 * P)
    b_k3 = bound_ms((C + 1) * 4 + P * (4 + 2 * 4) + C * 4 + 2 * C * 4, 7 * P)
    for name, fk, fr, bnd, lib in (
            ("pair_matvec", lambda: pair_ops.pair_matvec(k, u, 2),
             lambda: pair_ops.pair_matvec_ref(k, u, 2), b_k2, t_lib),
            ("pair_matvec div", lambda: (pair_ops.pair_matvec(k, (tx, ty), 1),),
             lambda: (pair_ops.pair_matvec_ref(k, (tx, ty), 1),), b_k2, None),
            ("pair_visc", lambda: pair_ops.pair_visc(k, rho),
             lambda: pair_ops.pair_visc_ref(k, rho), b_k3, None)):
        got, want = fk(), fr()
        torch.cuda.synchronize()
        e_abs = e_rel = 0.0
        for g, w in zip(got, want):
            e, rel = rel_err(g, w)
            e_abs, e_rel = max(e_abs, e), max(e_rel, rel)
        if not e_rel < TOL_F32:
            raise AssertionError(f"{tag} {name} [slab rank 0]: max rel err {e_rel:.3e}")
        tk, dk, tr = time_ms(fk, 200), device_ms(fk, 50), time_ms(fr, 20)
        key = name.split()[0] + "@slab"
        prev = rows.get(key)
        rows[key] = (max(prev[0], e_abs), *prev[1:]) if prev else (e_abs, tk, tr, bnd, lib)
        extra = f"; library (sparse CSR product) {t_lib:.4f} ms" if lib is not None else ""
        log(f"{tag} {name} (slab rank 0 list, {stream_shape(C)}): max abs err {e_abs:.3e}, max "
            f"rel err {e_rel:.3e} (tol {TOL_F32:g}); kernel {tk:.4f} ms (device {dk:.4f} ms), "
            f"plain {tr:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}){extra}")

    worst = tk_sum = tr_sum = bytes_sum = ops_sum = 0.0
    for key, (a, _) in sorted(calls.items()):
        if not key.startswith("pair_sweep:"):
            continue
        scs, swm, sst, sdyn, saved, sscale, stq = a
        op = slab_sweep_op(params, saved)
        opname = op.name
        label = opname + ({0: " (share)", 1: " (merge)"}.get(op.params.get("merge"), "")
                          if opname.startswith("adapt_") else "")
        fk = lambda: sweeps.pair_sweep(scs, swm, sst, sdyn, op, sscale, stq)  # noqa: E731
        fr = lambda: sweeps.pair_sweep_ref(scs, swm, sst, sdyn, op, sscale, stq)  # noqa: E731
        got, want = fk(), fr()
        torch.cuda.synchronize()
        e, rel = rel_err(got, want)
        if not rel < TOL_F32:
            raise AssertionError(f"{tag} pair_sweep {label} [slab rank 0]: rel err {rel:.3e}")
        tested, inside = pair_census(scs, swm, sst, sscale, stq)
        Cs = sst.shape[0]
        nb = Cs * 16 + (0 if sdyn is None else sdyn.numel() * 4) + Cs * 4 * op.n_out + \
            scs.numel() * 4 + swm.numel() * 4
        no = inside * (OPS_PAIR_GEOM + OPS_SWEEP_EMIT[opname])
        tk, tr = time_ms(fk, 50), time_ms(fr, 3)
        dk = device_ms(fk, 20, "pair_sweep_kernel")
        worst, tk_sum, tr_sum = max(worst, e), tk_sum + tk, tr_sum + tr
        bytes_sum, ops_sum = bytes_sum + nb, ops_sum + no
        log(f"{tag} pair_sweep {label} (slab rank 0 first step, C = {Cs}): {tested} tested pairs, "
            f"{inside} inside the radius; max abs err {e:.3e}, rel {rel:.3e}; kernel {tk:.4f} "
            f"ms (device {dk:.4f} ms), plain {tr:.4f} ms")
    b = bound_ms(bytes_sum, ops_sum)
    rows["pair_sweep@slab"] = (worst, tk_sum, tr_sum, b, None)
    log(f"{tag} pair_sweep, the {sum(k.startswith('pair_sweep:') for k in calls)} ops of rank 0's "
        f"first slab step: kernel {tk_sum:.4f} ms in all, plain {tr_sum:.4f} ms, bound "
        f"{b[0]:.5f} ms ({b[1]})")
    return rows


def phase_slab_soak():
    """S2: scripts/multichip_longrun.py's scene at full width on SOAK_RANKS
    gloo ranks sharing the card, then the four kernels against their plain
    versions on rank 0's first-step inputs of this run; returns each
    kernel's launches summed over the ranks and the kernels line's rows."""
    import tempfile

    from adaptive_sph_torch.multichip import RunHooks, longrun_job, run_ranks, summary

    job = longrun_job(SOAK_SPACING, SOAK_STEPS, SOAK_CHECK_EVERY, SOAK_PROFILED)
    tmp = tempfile.mkdtemp(prefix="asph_soak_capture_")
    capture = os.path.join(tmp, "first_step.pt")
    t0 = time.perf_counter()
    res = run_ranks(job, SOAK_RANKS, "gloo", "cuda", RunHooks(capture=capture))
    wall = time.perf_counter() - t0
    s = summary(res, SOAK_RANKS, "gloo", "cuda")
    if s["n_initial"] < 50_000:
        raise AssertionError(f"S2: {s['n_initial']} particles, the soak needs >= 50,000")
    if res["n_reshards"] < 1 and not res["forced_reshard"]:
        raise AssertionError("S2: no reshard")
    if any(s["tol_violations"].values()):
        raise AssertionError(f"S2: solves above their tolerance: {s['tol_violations']}")
    for c in res["checks"]:
        log(f"S2 step {c['step']}/{SOAK_STEPS} t={c['t']:.4f} n={c['n']} reshards="
            f"{c['reshards']} mass drift {c['mass_drift']:.2e} wall {c['wall_s']:.1f} s")
    for row in s["per_rank"]:
        if not all(row["launches"][k] > 0 for k in SLAB_KERNELS):
            raise AssertionError(f"S2 rank {row['rank']} launched {row['launches']}")
        log(f"S2 rank {row['rank']}: {row['ms_per_step']:.2f} ms/step over the timed steps, "
            f"{row['exchanges_per_step']:.1f} exchanges and {row['reductions_per_step']:.1f} "
            f"reductions per step, {row['bytes_sent_per_step'] / 1e6:.3f} MB of strips sent per "
            f"step; profiled {SOAK_PROFILED} steps: {row['profiled_ms_per_step']:.2f} ms/step, "
            f"{row['syncs_per_step']:.1f} host syncs per step, device busy {row['busy']:.3f}; "
            f"launches {row['launches']}")
    events = sum(d.get("merge_or_split_count", 0) + d.get("shares", 0) for d in res["diags"])
    waves = [d.get("wavefront_sweeps", 0) for d in res["diags"]]
    its = [(d["div_iterations"], d["density_iterations"]) for d in res["diags"]]
    log(f"S2 soak: n {s['n_initial']} -> {s['n_final']}, {s['steps']} steps to t = "
        f"{s['t_end']:.4f}, reshards {s['reshards']} (forced {s['forced_reshard']}), mass drift "
        f"<= {s['mass_drift']:.2e}, resampling events {events}, wavefront sweeps per step "
        f"{min(waves)}-{max(waves)}, solver iterations (div, density) max "
        f"{max(i for i, _ in its)} / {max(j for _, j in its)}, c_dev {s['c_dev']}, strip "
        f"{s['strip']}; run {s['wall_s']:.1f} s, {wall:.1f} s with the spawn")
    log("S2 summary " + json.dumps(s))
    rows = slab_kernel_rows(capture, slab_params(job.params, job.scene), "S2")
    os.remove(capture)
    os.rmdir(tmp)
    return {k: sum(row["launches"][k] for row in s["per_rank"]) for k in SLAB_KERNELS}, rows


# the list backend's phases L1-L4: the stale-pair setting and backend="lists"
LIST_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_lists_ref.npz")
LIST_STATE = ("position", "velocity", "density", "mass", "level", "stash", "has_level",
              "flag_is_fluid_surface", "flag_insufficient_neighs")
LIST_DIAG = ("n", "capacity", "div_iterations", "density_iterations", "shares",
             "merge_or_split_count", "split_deferred")
LIST_STRESS_STEPS = 10
LIST_SHARDED_RANKS = (2, 4)
LIST_SHARDED_STEPS = 5  # the last two under torch.profiler
LIST_SHARDED_CAPACITY = 8192  # the dam break's first split step needs 6,144 rows


def arrays_equal(a, b) -> bool:
    """Equal shapes and values, NaN equal to NaN."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc" and b.dtype.kind in "fc")


def list_alive_state(st) -> dict:
    import numpy as np

    a = st.alive.cpu().numpy()
    return {k: np.asarray(getattr(st, k).cpu().numpy())[a] for k in LIST_STATE}


def hold_list_state(tag: str, got: dict, ref: dict, mass_rtol: float) -> str:
    """got matched to ref by position; the trajectory tolerances, flags,
    has_level and stash exactly. Returns the log text."""
    import numpy as np

    if len(got["position"]) != len(ref["position"]):
        raise AssertionError(f"{tag}: {len(got['position'])} particles, reference "
                             f"{len(ref['position'])}")
    j = match_by_position(ref["position"], got["position"])
    got = {k: v[j] for k, v in got.items()}
    dev = {"dx": float(np.abs(got["position"] - ref["position"]).max()),
           "drho_rel": float(np.abs(got["density"] / ref["density"] - 1.0).max()),
           "dv": float(np.abs(got["velocity"] - ref["velocity"]).max()),
           "dm_rel": float(np.abs(got["mass"] / ref["mass"] - 1.0).max()),
           "dlevel": float(np.abs(got["level"] - ref["level"]).max())}
    flags = [k for k in ("stash", "has_level", "flag_is_fluid_surface",
                         "flag_insufficient_neighs") if not np.array_equal(got[k], ref[k])]
    if flags or not (dev["dx"] < 2e-5 and dev["drho_rel"] < 2e-5 and dev["dv"] < 2e-4
                     and dev["dm_rel"] < mass_rtol and dev["dlevel"] < 2e-5):
        raise AssertionError(f"{tag}: {dev}, unequal {flags}")
    return (f"|dx| {dev['dx']:.3e} (2e-5), rel drho {dev['drho_rel']:.3e} (2e-5), |dv| "
            f"{dev['dv']:.3e} (2e-4), rel dm {dev['dm_rel']:.3e} ({mass_rtol:g}), |dlevel| "
            f"{dev['dlevel']:.3e} (2e-5), flags and stash equal")


@contextlib.contextmanager
def no_tile_work(tag: str):
    """The block may launch no kernel of pair_ops' count and call no plain
    version of one (the list and grid steps are plain torch)."""
    from adaptive_sph_torch.ops import pair_ops

    before = dict(pair_ops.launches)
    with count_plain_calls() as plain:
        yield
    launched = {k: v - before[k] for k, v in pair_ops.launches.items() if v != before[k]}
    called = {k: v for k, v in plain.items() if v}
    if launched or called:
        raise AssertionError(f"{tag}: the step launched {launched} and called the plain "
                             f"versions {called}")


def on_cuda(tag: str, sim, backend: str = "lists"):
    bad = [k for k in ("position", "velocity", "density", "mass", "alive")
           if getattr(sim.state, k).device.type != "cuda"]
    if bad or sim.backend != backend:
        raise AssertionError(f"{tag}: backend {sim.backend}, not on the card: {bad}")


def list_run_steps(tag: str, run: str, ref, steps: int, prof=None):
    """The list run `run` of stress.list_runs on the card for `steps` steps,
    each step's counts held to the fixture's (ref None: none); returns the
    simulation and its per-step seconds."""
    import numpy as np
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import list_runs

    params, scene_d, _, _ = list_runs()[run]
    sim = create_simulation(params, scene_mod.scene_from_dict(scene_d), device="cuda",
                            counters_enabled=False)
    on_cuda(tag, sim)
    secs = []
    ctx = profiled_steps(1, steps - 2, prof) if prof is not None else contextlib.nullcontext()
    with no_tile_work(tag), ctx:
        for k in range(steps):
            t0 = time.perf_counter()
            d = sim.step()
            secs.append(time.perf_counter() - t0)
            if ref is None:
                continue
            got = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
            diff = {n: (got.get(n, 0), int(ref[f"{run}/{n}"][k])) for n in LIST_DIAG
                    if int(got.get(n, 0)) != int(ref[f"{run}/{n}"][k])}
            if diff or np.float32(got["dt"]) != ref[f"{run}/dt"][k]:
                raise AssertionError(f"{tag} step {k + 1}: {diff}, dt {got['dt']} / "
                                     f"{ref[f'{run}/dt'][k]}")
    on_cuda(tag, sim)
    return sim, secs


def log_list_timing(tag: str, secs, prof: dict):
    import numpy as np

    n = prof["steps"]
    log(f"{tag}: {1e3 * float(np.median(secs[1:])):.4f} ms/step (median of steps 2-"
        f"{len(secs)}, host clock); steps 2-{1 + n} profiled: {prof['syncs'] / n:.1f} host "
        f"syncs and {1e3 * prof['device'] / n:.4f} ms device time per step, device busy "
        f"{prof['device'] / prof['wall']:.3f}")


def phase_list_exports():
    """L1: surface-detection.yaml entries 1 (CenterDiff) and 2 (EmptyAngle),
    levels after advection over the stale pairs (stress.list_export_attributes),
    through the image entry point on a copy of the list in a temporary
    directory, time clipped to stress.LIST_EXPORT_TIME; the steps and the
    final positions against the fixture; then the same run through
    create_simulation: its positions bit-identical to the export's, every
    step's counts and the state against the fixture; no tile kernel."""
    import tempfile

    import numpy as np
    import torch
    import yaml
    from adaptive_sph_torch.stress import (LIST_EXPORT_TIME, SURFACE_DETECTION,
                                           list_export_attributes)
    from adaptive_sph_torch.utils import animation

    ref = np.load(LIST_FIXTURE)
    src = os.path.join(ROOT, SURFACE_DETECTION)
    with open(src) as f:
        entries = yaml.safe_load(f)
    for entry, run in ((0, "surface_centerdiff"), (1, "surface_emptyangle")):
        tag = f"L1 {run} (surface-detection.yaml entry {entry + 1})"
        attrs = {**entries[entry]["update_attributes"], **list_export_attributes(entry)}
        prof = {}
        with tempfile.TemporaryDirectory() as tmp:
            path = export_entry_copy(src, entry, tmp, time=LIST_EXPORT_TIME,
                                     update_attributes=attrs, image_width=400, image_height=400)
            with no_tile_work(tag), profiled_steps(1, 6, prof):
                (r,) = animation.export_simulation_images([path])
            size = png_size(r.png_file)
        steps = len(ref[f"{run}/n"])
        if r.steps != steps or size != (400, 400):
            raise AssertionError(f"{tag}: {r.steps} steps (fixture {steps}), PNG {size}")
        sim, secs = list_run_steps(tag, run, ref, steps)
        got = list_alive_state(sim.state)
        if not np.array_equal(got["position"], r.position):
            raise AssertionError(f"{tag}: the second run's positions differ from the export's")
        held = hold_list_state(tag, got, {k: ref[f"{run}/{k}"] for k in LIST_STATE}, 1e-6)
        n = prof["steps"]
        log(f"{tag}: image export {r.steps} steps to t = {LIST_EXPORT_TIME} "
            f"({r.step_seconds / r.steps * 1e3:.4f} ms/step with the first step's set-up), render "
            f"{r.render_seconds * 1e3:.1f} ms; its steps 2-7 profiled: "
            f"{1e3 * prof['wall'] / n:.4f} ms/step, {prof['syncs'] / n:.1f} "
            f"host syncs and {1e3 * prof['device'] / n:.4f} ms device time per step, "
            f"device busy {prof['device'] / prof['wall']:.3f}; the second run "
            f"{1e3 * float(np.median(secs[1:])):.4f} ms/step (median of steps 2-{steps}), "
            f"bit-identical; vs fixture: {held}")
        del sim
    torch.cuda.empty_cache()


def phase_list_dambreak():
    """L2: the default dam break with levels after advection over the stale
    pairs (share / merge / split, capacity growth 3,072 -> 6,144), 10 steps
    against the fixture: every step's counts, then the state; a second run
    bit-identical; no tile kernel; steps 2-9 profiled."""
    import numpy as np
    import torch
    from adaptive_sph_torch import convert

    ref = np.load(LIST_FIXTURE)
    steps = len(ref["dambreak/n"])
    prof = {}
    sim, secs = list_run_steps("L2 dam break", "dambreak", ref, steps, prof)
    again, _ = list_run_steps("L2 dam break (second run)", "dambreak", ref, steps)
    first = convert.state_to_numpy(sim.state)
    second = convert.state_to_numpy(again.state)
    unequal = [k for k in first if not arrays_equal(first[k], second[k])]
    if unequal:
        raise AssertionError(f"L2: a second run differs in {unequal}")
    held = hold_list_state("L2 dam break", list_alive_state(sim.state),
                           {k: ref[f"dambreak/{k}"] for k in LIST_STATE}, 1e-5)
    log_list_timing(f"L2 dam break, lists, n {sim.num_fluid_particles}, capacity "
                    f"{sim.state.capacity}", secs, prof)
    log(f"L2 dam break vs fixture ({steps} steps, counts equal each step): {held}; a second "
        "run bit-identical")
    del sim, again
    torch.cuda.empty_cache()


def phase_list_stress():
    """L3: the stress scene at full width (n = 11,835, stress_params()) on
    backend="lists" against the tile step, LIST_STRESS_STEPS steps each,
    matched by position: positions atol 2e-5, density rtol 2e-5 (the
    reference's own _diff_vs_lists at full width); a second list run
    bit-identical; the list runs launch no tile kernel; steps 2-9 profiled."""
    import numpy as np
    import torch
    from adaptive_sph_torch import convert
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene

    out = {}
    prof = {}
    for backend in ("tiles", "lists", "lists"):
        sim = create_simulation(stress_params(), stress_scene(), device="cuda",
                                counters_enabled=False, backend=backend)
        tag = f"L3 stress {backend}"
        if backend == "lists":
            on_cuda(tag, sim)
        ctx = no_tile_work(tag) if backend == "lists" else contextlib.nullcontext()
        pctx = (profiled_steps(1, LIST_STRESS_STEPS - 2, prof)
                if backend == "lists" and "lists" not in out else contextlib.nullcontext())
        secs, iters = [], []
        with ctx, pctx:
            for _ in range(LIST_STRESS_STEPS):
                t0 = time.perf_counter()
                d = sim.step()
                secs.append(time.perf_counter() - t0)
                iters.append((d["div_iterations"], d["density_iterations"]))
        key = backend if backend not in out else "lists2"
        out[key] = (convert.state_to_numpy(sim.state), secs, iters, sim.state.capacity,
                    sim.ncfg)
        del sim
        torch.cuda.empty_cache()
    a, b = out["tiles"][0], out["lists"][0]
    unequal = [k for k in b if not arrays_equal(b[k], out["lists2"][0][k])]
    if unequal:
        raise AssertionError(f"L3: a second list run differs in {unequal}")
    pa, pb = a["position"][a["alive"]], b["position"][b["alive"]]
    if len(pa) != len(pb):
        raise AssertionError(f"L3: {len(pa)} particles on tiles, {len(pb)} on lists")
    j = match_by_position(pa, pb)
    dx = float(np.abs(pa - pb[j]).max())
    drho = float(np.abs(a["density"][a["alive"]] / b["density"][b["alive"]][j] - 1.0).max())
    if not (dx < 2e-5 and drho < 2e-5):
        raise AssertionError(f"L3: tiles vs lists |dx| {dx:.3e}, rel drho {drho:.3e}")
    log_list_timing(f"L3 stress, lists (n {len(pb)}, capacity {out['lists'][3]}, "
                    f"{out['lists'][4]})", out["lists"][1], prof)
    log(f"L3 stress tiles vs lists over {LIST_STRESS_STEPS} steps: |dx| {dx:.3e} (2e-5), rel "
        f"drho {drho:.3e} (2e-5); iterations tiles {out['tiles'][2]}, lists {out['lists'][2]}; "
        f"tiles {1e3 * float(np.median(out['tiles'][1][1:])):.4f} ms/step; a second list run "
        "bit-identical")


def phase_list_sharded():
    """L4: the particle-sharded list step (parallel/sharding.py through
    multichip.run_ranks) on 2 and 4 gloo ranks sharing the card, the dam
    break of L2 at capacity LIST_SHARDED_CAPACITY for LIST_SHARDED_STEPS
    steps (the last two profiled on every rank), against the one-device list
    run at that capacity: the gathered state equal, field for field; no
    rank launches a tile kernel."""
    import numpy as np
    import torch
    from adaptive_sph_torch import convert
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.multichip import run_ranks
    from adaptive_sph_torch.parallel.sharding import ShardedListJob
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import list_runs

    params, scene_d, _, _ = list_runs()["dambreak"]
    one = create_simulation(params, scene_mod.scene_from_dict(scene_d), device="cuda",
                            capacity=LIST_SHARDED_CAPACITY, counters_enabled=False)
    on_cuda("L4 one device", one)
    with no_tile_work("L4 one device"):
        one_diags = [one.step() for _ in range(LIST_SHARDED_STEPS)]
    ref = convert.state_to_numpy(one.state)
    del one
    torch.cuda.empty_cache()
    for ranks in LIST_SHARDED_RANKS:
        job = ShardedListJob(params=convert.params_to_dict(params), scene=scene_d,
                             steps=LIST_SHARDED_STEPS, capacity=LIST_SHARDED_CAPACITY,
                             profile_steps=2)
        t0 = time.perf_counter()
        res = run_ranks(job, ranks, "gloo", "cuda")
        wall = time.perf_counter() - t0
        unequal = [k for k in ref if not arrays_equal(res["final"][k], ref[k])]
        counts = [(d["shares"], d["merge_or_split_count"]) for d in res["diags"]]
        if unequal or counts != [(d["shares"], d["merge_or_split_count"]) for d in one_diags]:
            raise AssertionError(f"L4 on {ranks} ranks: unequal {unequal}, counts {counts}")
        launched = [(r, k) for r, rr in enumerate(res["ranks"])
                    for k, v in rr["launches"].items() if v]
        if launched:
            raise AssertionError(f"L4 on {ranks} ranks: tile kernels launched {launched}")
        # the profiled window's wall holds the profiler's start on every rank
        per_rank = "; ".join(
            f"rank {r}: {1e3 * float(np.median(rr['step_s'][1:])):.2f} ms/step (steps 2-"
            f"{len(rr['step_s'])}), the profiled steps "
            f"{rr['profile']['syncs'] / rr['profile']['steps']:.1f} host syncs and "
            f"{1e3 * rr['profile']['device_s'] / rr['profile']['steps']:.4f} ms device time "
            "per step" for r, rr in enumerate(res["ranks"]))
        log(f"L4 particle-sharded dam break on {ranks} gloo ranks sharing the card, "
            f"{LIST_SHARDED_STEPS} steps, capacity {LIST_SHARDED_CAPACITY}: the gathered state "
            f"equal to one device's, counts {counts}; {per_rank}; {wall:.1f} s with the spawn")


def phase_lists():
    """L1-L4, timed."""
    t0 = time.perf_counter()
    phase_list_exports()
    phase_list_dambreak()
    phase_list_stress()
    phase_list_sharded()
    log(f"L1-L4 (the list backend): {time.perf_counter() - t0:.1f} s")

GRID_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_grid_ref.npz")
GRID_WARMUP = 3
GRID_TIMED = 10  # cut from 20 for the clique phases' time
GRID_PROFILED = 5


def grid_run_steps(tag: str, run: str, ref, steps: int):
    """The grid run `run` of stress.grid_runs on the card for `steps` steps,
    each step's counts held to the fixture's (ref None: none); returns the
    simulation, its per-step seconds and its peak device memory (MiB)."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import grid_runs

    params, scene_d, capacity, _ = grid_runs()[run]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim = create_simulation(params, scene_mod.scene_from_dict(scene_d), capacity=capacity,
                            device="cuda", counters_enabled=False, backend="grid")
    on_cuda(tag, sim, "grid")
    secs = []
    with no_tile_work(tag):
        for k in range(steps):
            t0 = time.perf_counter()
            d = sim.step()
            secs.append(time.perf_counter() - t0)
            if ref is None:
                continue
            got = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
            diff = {n: (got.get(n, 0), int(ref[f"{run}/{n}"][k])) for n in LIST_DIAG
                    if int(got.get(n, 0)) != int(ref[f"{run}/{n}"][k])}
            dt_ref = float(ref[f"{run}/dt"][k])
            if diff or not abs(got["dt"] - dt_ref) <= 1e-5 * dt_ref:
                raise AssertionError(f"{tag} step {k + 1}: {diff}, dt {got['dt']} / {dt_ref}")
    torch.cuda.synchronize()
    on_cuda(tag, sim, "grid")
    if ref is not None:
        # the configuration after the last step (capacity growth rebuilds it)
        want = (int(ref[f"{run}/mpc"]), tuple(int(x) for x in ref[f"{run}/populated"]))
        if (sim.grid_cfg.mpc, sim.grid_cfg.populated) != want:
            raise AssertionError(f"{tag}: grid (mpc, populated) "
                                 f"{(sim.grid_cfg.mpc, sim.grid_cfg.populated)}, JAX's {want}")
    return sim, secs, torch.cuda.max_memory_allocated() / 2**20


def grid_fixture_run(tag: str, run: str, mass_rtol: float):
    """A grid run against its fixture record; returns (simulation, log text)."""
    import numpy as np

    ref = np.load(GRID_FIXTURE)
    steps = len(ref[f"{run}/n"])
    sim, secs, peak = grid_run_steps(tag, run, ref, steps)
    held = hold_list_state(tag, list_alive_state(sim.state),
                           {k: ref[f"{run}/{k}"] for k in LIST_STATE}, mass_rtol)
    iters = list(zip(ref[f"{run}/div_iterations"].tolist(),
                     ref[f"{run}/density_iterations"].tolist()))
    return sim, (f"{tag}: {steps} steps, n {sim.num_fluid_particles}, capacity "
                 f"{sim.state.capacity}, {sim.grid_cfg.levels} levels (populated "
                 f"{sim.grid_cfg.populated}), finest {sim.grid_cfg.ny0} x {sim.grid_cfg.nx0}, "
                 f"mpc {sim.grid_cfg.mpc}; (div, density) iterations {iters} equal at every "
                 f"step; {1e3 * float(np.median(secs[1:])):.2f} ms/step (median of steps "
                 f"2-{steps}, first {1e3 * secs[0]:.1f} ms); peak memory {peak:.1f} MiB; vs "
                 f"fixture: {held}")


def phase_grid_stress():
    """G1: the stress scene on the grid engine against the fixture, then the
    tile step from the same start: |dx| and density rel, matched by position."""
    import numpy as np
    import torch
    from adaptive_sph_torch import convert
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import GRID_STRESS_STEPS, stress_params, stress_scene

    # numerics.fma (the cubic spline's pieces, r^2, the dot products) is
    # torch.addcmul on the card: it must round once, as the float64 form does
    from adaptive_sph_torch.ops.numerics import fma

    gen = torch.Generator(device="cuda").manual_seed(17)
    a, b, c = (torch.randn(1 << 20, device="cuda", generator=gen) for _ in range(3))
    want = (a.double() * b.double() + c.double()).float()
    unfused = int(torch.sum(fma(a, b, c) != want)) + int(
        torch.sum(fma(6.0, a, 1.0) != (a.double() * 6.0 + 1.0).float()))
    if unfused:
        raise AssertionError(f"G1: numerics.fma rounds apart from a fused multiply-add in "
                             f"{unfused} of {2 << 20} lanes")
    log(f"G1 numerics.fma on the card: one rounding in all {2 << 20} lanes")
    sim, text = grid_fixture_run("G1 stress grid", "stress_grid", 1e-6)
    log(text)
    g = convert.state_to_numpy(sim.state)
    del sim
    torch.cuda.empty_cache()
    tiles = create_simulation(stress_params(), stress_scene(), device="cuda",
                              counters_enabled=False)
    for _ in range(GRID_STRESS_STEPS):
        tiles.step()
    t = convert.state_to_numpy(tiles.state)
    del tiles
    torch.cuda.empty_cache()
    pg, pt = g["position"][g["alive"]], t["position"][t["alive"]]
    j = match_by_position(pg, pt)
    dx = float(np.abs(pg - pt[j]).max())
    drho = float(np.abs(g["density"][g["alive"]] / t["density"][t["alive"]][j] - 1.0).max())
    log(f"G1 stress grid vs tiles after {GRID_STRESS_STEPS} steps from the same start: |dx| "
        f"{dx:.3e}, rel drho {drho:.3e}")


def phase_grid_small():
    """G2: the dam break without resampling and the two-size dam with
    resampling on the grid engine against the fixture."""
    import torch

    for run, tag, mass_rtol in (("dambreak_grid", "G2 dam break grid (no resampling)", 1e-5),
                                ("adaptive_grid", "G2 two-size dam grid (resampling)", 1e-5)):
        sim, text = grid_fixture_run(tag, run, mass_rtol)
        log(text)
        del sim
        torch.cuda.empty_cache()


def phase_grid_timed():
    """G3: the stress scene on the grid engine timed, then profiled; the tile
    step's ms/step beside it."""
    import numpy as np
    import torch
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene

    out = {}
    for backend in ("grid", "tiles"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sim = create_simulation(stress_params(), stress_scene(), device="cuda",
                                counters_enabled=False, backend=backend)
        tag = f"G3 stress {backend}"
        ctx = no_tile_work(tag) if backend == "grid" else contextlib.nullcontext()
        prof = {}
        with ctx:
            for _ in range(GRID_WARMUP):
                sim.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRID_TIMED):
                sim.step()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / GRID_TIMED
            if backend == "grid":
                with profiled_steps(0, GRID_PROFILED, prof):
                    for _ in range(GRID_PROFILED):
                        sim.step()
                on_cuda(tag, sim, "grid")
        out[backend] = (ms, torch.cuda.max_memory_allocated() / 2**20, prof)
        del sim
        torch.cuda.empty_cache()
    ms, peak, prof = out["grid"]
    n = prof["steps"]
    log(f"G3 stress grid: {ms:.2f} ms/step ({GRID_TIMED} steps after {GRID_WARMUP}, host clock, "
        f"synchronised); {GRID_PROFILED} profiled steps: {prof['syncs'] / n:.1f} host syncs and "
        f"{1e3 * prof['device'] / n:.3f} ms device time per step, device busy "
        f"{prof['device'] / prof['wall']:.3f}; peak memory {peak:.1f} MiB; tiles "
        f"{out['tiles'][0]:.2f} ms/step, peak {out['tiles'][1]:.1f} MiB")


def phase_grid():
    """G1-G3, timed."""
    t0 = time.perf_counter()
    phase_grid_stress()
    phase_grid_small()
    phase_grid_timed()
    log(f"G1-G3 (the dense grid engine): {time.perf_counter() - t0:.1f} s")



# the clique / patch-major layout (ASPH_CLIQUE=1): phases C1-C3
CLIQUE_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_clique_ref.npz")
# the kernels line's rows of the clique path: K1-K3 on its cross-level list
# (K1 over the cross_only windows), pair_sweep over its patch-row windows
CLIQUE_ROWS = {"pair_build:clique_cross": "pair_build", "pair_matvec:clique_cross": "pair_matvec",
               "pair_visc:clique_cross": "pair_visc", "pair_sweep:patch": "pair_sweep"}
SOURCES.update({k: SOURCES[v] for k, v in CLIQUE_ROWS.items()})
REPLACES.update({k: REPLACES[v] for k, v in CLIQUE_ROWS.items()})
CLIQUE_KERNELS = ("pair_build", "pair_matvec", "pair_visc")  # every clique run launches these
CLIQUE_WARMUP = 3
CLIQUE_TIMED = 20
CLIQUE_PROFILED = 5
CLIQUE_SWEEP_STEPS = 2  # C1's run with the non-pressure step after the divergence solve


@contextlib.contextmanager
def clique_env(**extra):
    """ASPH_CLIQUE=1 (and `extra`) inside the block, the old values after."""
    keys = {"ASPH_CLIQUE": "1", **extra}
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def clique_sim(params, scene_d, capacity=None):
    from adaptive_sph_torch.models import scene as scene_mod
    from adaptive_sph_torch.runner import create_simulation

    return create_simulation(params, scene_mod.scene_from_dict(scene_d), capacity=capacity,
                             device="cuda", counters_enabled=False)


def capture_clique_step(run):
    """The first step of a run of stress.clique_runs under ASPH_CLIQUE=1 with
    spies on K1 and K3: (tcfg, bins, cols, wm, K1's arguments, the density
    K3 read), K1's being those of its walk over the cross_only windows and
    the layout the step's own (step_geometry on the first state)."""
    from adaptive_sph_torch.models.tile_step import step_geometry
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.stress import clique_runs

    params, scene_d, capacity, _, _ = clique_runs()[run]
    got = {}
    real = {k: getattr(pair_ops, k) for k in ("pair_build", "pair_visc")}

    def build(*a, **k):
        got["k1"] = (tuple(x.clone() if hasattr(x, "clone") else x for x in a), dict(k))
        return real["pair_build"](*a, **k)

    def visc(csr, rho):
        got["rho"] = rho.clone()
        return real["pair_visc"](csr, rho)

    with clique_env():
        sim = clique_sim(params, scene_d, capacity)
        tcfg = sim.tile_cfg
        if tcfg.patch != 4:
            raise AssertionError(f"C1 {run}: patch side {tcfg.patch}, not 4")
        _, bins, cols, wm = step_geometry(sim.state, sim.params, tcfg)
        pair_ops.pair_build, pair_ops.pair_visc = build, visc
        try:
            sim.step()
        finally:
            pair_ops.pair_build, pair_ops.pair_visc = real["pair_build"], real["pair_visc"]
    if "k1" not in got or "rho" not in got:
        raise AssertionError(f"C1 {run}: the first step launched no K1 or no K3")
    return tcfg, bins, cols, wm, got["k1"], got["rho"]


def clique_list_checks(run, k1, rho, timed: bool):
    """K1 over the cross_only windows and K2 / K3 on its list against their
    plain versions (velocities seeded: the first step starts at rest). With
    `timed`, the kernels line's rows of the three; else their times logged."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.timing import device_ms

    (cs, wm_x, flat, tq, scale, nu, visc, wdtype), kw = k1
    dev = flat.device
    C = flat.shape[0]
    rng = np.random.default_rng(11)
    live = (flat[:, 2] > 0).float()
    flat = flat.clone()
    flat[:, 4:6] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(dev) * \
        live[:, None]
    args = (cs, wm_x, flat, tq, scale, nu, visc, wdtype)
    k = pair_ops.pair_build(*args, **kw)
    r = pair_ops.pair_build_ref(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(k.row_ptr, r.row_ptr) or not torch.equal(k.col, r.col):
        raise AssertionError(f"C1 {run} K1 cross_only: the pair structure differs from the plain "
                             f"version ({k.num_pairs} vs {r.num_pairs} pairs)")
    P = k.num_pairs
    err = 0.0
    for name, got, want, tol in (("w", k.w, r.w, TOL_F32), ("s", k.s, r.s, TOL_F32),
                                 ("prep", k.prep, r.prep, TOL_F32)):
        if got is None:
            continue
        for row in range(got.shape[0]):
            e, rel = rel_err(got[row], want[row])
            err = max(err, e)
            if not rel < tol:
                raise AssertionError(f"C1 {run} K1 cross_only {name}[{row}]: rel err {rel:.3e}")
    u = torch.from_numpy(rng.uniform(0, 10, C).astype(np.float32)).to(dev) * live
    tx = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * live
    ty = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * live
    checks = {"pair_matvec": (lambda: pair_ops.pair_matvec(k, u, 2),
                              lambda: pair_ops.pair_matvec_ref(k, u, 2)),
              "pair_matvec div": (lambda: (pair_ops.pair_matvec(k, (tx, ty), 1),),
                                  lambda: (pair_ops.pair_matvec_ref(k, (tx, ty), 1),)),
              "pair_visc": (lambda: pair_ops.pair_visc(k, rho),
                            lambda: pair_ops.pair_visc_ref(k, rho))}
    errs = {"pair_build": err}
    for name, (fk, fr) in checks.items():
        got, want = fk(), fr()
        again = fk()
        torch.cuda.synchronize()
        worst = 0.0
        for g, w, g2 in zip(got, want, again):
            e, rel = rel_err(g, w)
            worst = max(worst, e)
            if not rel < TOL_F32 or (P == 0 and bool(g.any())):
                raise AssertionError(f"C1 {run} {name} on the cross list ({P} pairs): rel err "
                                     f"{rel:.3e}")
            if not torch.equal(g, g2):
                raise AssertionError(f"C1 {run} {name}: a second launch differs")
        errs[name] = worst
    wb = 2 if wdtype == torch.bfloat16 else 4
    b_k1 = bound_ms(C * 24 + (C + 1) * 4 + P * (4 + 4 * wb) + C * 16,
                    P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_VISC))
    b_k2 = bound_ms((C + 1) * 4 + P * (4 + 2 * wb) + C * 4 + 2 * C * 4, 4 * P)
    b_k3 = bound_ms((C + 1) * 4 + P * (4 + 2 * wb) + C * 4 + 2 * C * 4, 7 * P)
    tested, _ = pair_census(cs, wm_x, flat[:, 0:4].contiguous(), scale, tq)
    times = {}
    for name, fk, fr, reps in (("pair_build", lambda: pair_ops.pair_build(*args, **kw),
                                lambda: pair_ops.pair_build_ref(*args, **kw), 20),
                               ("pair_matvec", checks["pair_matvec"][0], checks["pair_matvec"][1],
                                200),
                               ("pair_visc", checks["pair_visc"][0], checks["pair_visc"][1], 200)):
        times[name] = (time_ms(fk, reps), device_ms(fk, max(5, reps // 4)),
                       time_ms(fr, max(3, reps // 10)))
    lib = None
    if P:
        a2 = csr_product(k, C)
        lib = time_ms(lambda: a2 @ u[:, None], 200)
    log(f"C1 {run}: K1 over the cross_only windows (C = {C}, {tested} tested pairs, {P} "
        f"cross-level pairs): structure equal, max abs err {err:.3e} (tol {TOL_F32:g} of the row "
        f"max); K2 accel / div and K3 on the list: max abs err {errs['pair_matvec']:.3e} / "
        f"{errs['pair_matvec div']:.3e} / {errs['pair_visc']:.3e}, second launches "
        f"bit-identical; " + "; ".join(
            f"{n} {t[0]:.4f} ms (device {t[1]:.4f} ms), plain {t[2]:.4f} ms" for n, t in
            times.items()) + f"; bounds K1 {b_k1[0]:.5f} ms ({b_k1[1]}), K2 {b_k2[0]:.5f}, K3 "
        f"{b_k3[0]:.5f}; library (CSR sparse x dense) "
        + ("none: empty list" if lib is None else f"{lib:.4f} ms"))
    if not timed:
        return None
    return {"pair_build:clique_cross": (errs["pair_build"], *times["pair_build"][::2], b_k1, None),
            "pair_matvec:clique_cross": (max(errs["pair_matvec"], errs["pair_matvec div"]),
                                         *times["pair_matvec"][::2], b_k2, lib),
            "pair_visc:clique_cross": (errs["pair_visc"], *times["pair_visc"][::2], b_k3, None)}


def clique_sweep_run():
    """The touching scene under ASPH_CLIQUE=1 with the non-pressure step
    after the divergence solve, CLIQUE_SWEEP_STEPS steps: its viscosity is a
    pair_sweep over the patch-row windows. Returns (launches of the run, the
    first visc sweep's arguments); the counts set to 0 just before the run
    and read just after, no plain version called."""
    import torch
    from adaptive_sph_torch.models import tile_step
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.stress import clique_runs

    params, scene_d, capacity, _, _ = clique_runs()["touching_clique"]
    params = params.replace(hybrid_dfsph_non_pressure_accel_before_divergence_free=False)
    got = {}
    real = tile_step.pair_sweep

    def spy(cell_starts, wm, statics, dyn, op, scale, tq):
        if op.name.startswith("visc") and "visc" not in got:
            got["visc"] = (cell_starts.clone(), wm.clone(), statics.clone(),
                           dyn.contiguous().clone(), op, scale, tq)
        return real(cell_starts, wm, statics, dyn, op, scale, tq)

    with clique_env():
        sim = clique_sim(params, scene_d, capacity)
        tile_step.pair_sweep = spy
        try:
            with count_plain_calls() as plain:
                pair_ops.reset_launches()
                for _ in range(CLIQUE_SWEEP_STEPS):
                    sim.step()
                torch.cuda.synchronize()
                launches = dict(pair_ops.launches)
        finally:
            tile_step.pair_sweep = real
    if sim.tile_cfg.patch != 4 or "visc" not in got or launches["pair_sweep"] <= 0:
        raise AssertionError(f"C1 visc sweep run: patch {sim.tile_cfg.patch}, launches {launches}")
    if any(plain.values()):
        raise AssertionError(f"C1 visc sweep run: plain versions ran: {plain}")
    return launches, got["visc"]


def clique_sweep_checks(tcfg, bins, cols, wm, visc_args):
    """pair_sweep over the patch-row windows against its plain version: the
    DENSITY sweep on the touching scene's first-step layout, the visc sweep
    on its captured input with seeded velocities (a first step is at rest).
    Returns the kernels line's row (the visc sweep's times)."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import tile_physics as tp
    from adaptive_sph_torch.ops import sweeps
    from adaptive_sph_torch.timing import device_ms

    st = cols["flat"][:, 0:4].contiguous()
    cs_v, wm_v, st_v, dyn_v, op_v, scale, tq = visc_args
    C = st_v.shape[0]
    rng = np.random.default_rng(13)
    live = (st_v[:, 2] > 0).float()[:, None]
    dyn_v = torch.cat([dyn_v[:, :1], torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(
        np.float32)).to(st_v.device) * live], dim=1).contiguous()
    cases = (("density", (bins.cell_starts, wm, st, None, tp.DENSITY_OP, scale, tcfg.tq)),
             ("visc_laplace", (cs_v, wm_v, st_v, dyn_v, op_v, scale, tq)))
    err = 0.0
    for name, a in cases:
        got = sweeps.pair_sweep(*a)
        again = sweeps.pair_sweep(*a)
        ref = sweeps.pair_sweep_ref(*a)
        torch.cuda.synchronize()
        g, r = got.double(), ref.double()
        rel = float(((g - r).abs() / (r.abs().amax(0, keepdim=True) + 1e-30)).max())
        err = max(err, float((g - r).abs().max()))
        if not rel < TOL_F32 or not torch.equal(got, again) or not float(r.abs().max()) > 0:
            raise AssertionError(f"C1 pair_sweep {name} over the patch rows: rel err {rel:.3e}")
        cs_, wm_, st_, d_ = a[0], a[1], a[2], a[3]
        tested, inside = pair_census(cs_, wm_, st_, scale, tcfg.tq)
        b = bound_ms(C * 16 + (0 if d_ is None else d_.numel() * 4) + C * a[4].n_out * 4
                     + cs_.numel() * 4 + wm_.numel() * 4,
                     inside * (OPS_PAIR_GEOM + OPS_SWEEP_EMIT[name]))
        tk = time_ms(lambda: sweeps.pair_sweep(*a), 30)
        dk = device_ms(lambda: sweeps.pair_sweep(*a), 20, "pair_sweep_kernel")
        tr = time_ms(lambda: sweeps.pair_sweep_ref(*a), 3)
        log(f"C1 pair_sweep {name} over the patch-row windows (C = {C}): {tested} tested pairs "
            f"(padding slots included), {inside} inside the radius; rel err {rel:.3e} (tol "
            f"{TOL_F32:g} of the column max), second launch bit-identical; kernel {tk:.4f} ms "
            f"(device {dk:.4f} ms), plain {tr:.4f} ms, bound {b[0]:.5f} ms ({b[1]})")
    return {"pair_sweep:patch": (err, tk, tr, b, None)}


def phase_clique_kernels():
    """C1: the kernels on the clique path's first-step inputs of the touching
    scene (cross-level pairs) and the stress scene (none: an empty list)
    against their plain versions, and pair_sweep over the patch-row windows.
    Returns (the kernels line's clique rows, pair_sweep's launches)."""
    rows = {}
    for run in ("touching_clique", "stress_clique"):
        tcfg, bins, cols, wm, k1, rho = capture_clique_step(run)
        timed = run == "touching_clique"
        out = clique_list_checks(run, k1, rho, timed)
        if timed:
            rows.update(out)
            launches, visc_args = clique_sweep_run()
            rows.update(clique_sweep_checks(tcfg, bins, cols, wm, visc_args))
    return rows, launches


def run_clique(run, env_extra=None, clique=True):
    """One run of stress.clique_runs on the card: (per-step records, the alive
    state, launches, plain calls, the simulation); the counts set to 0 just
    before the steps and read just after."""
    import torch
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.stress import clique_runs

    params, scene_d, capacity, steps, env = clique_runs()[run]
    ctx = clique_env(**env) if clique else contextlib.nullcontext()
    recs = {k: [] for k in ("dt", "div_iterations", "density_iterations", "clique_overflow",
                            "num_pairs", "capacity", "patch")}
    with ctx:
        sim = clique_sim(params, scene_d, capacity)
        with count_plain_calls() as plain:
            pair_ops.reset_launches()
            for _ in range(steps):
                d = {**sim.step(), "capacity": sim.state.capacity, "patch": sim.tile_cfg.patch}
                for k in recs:
                    recs[k].append(d.get(k, 0))
            torch.cuda.synchronize()
            launches = dict(pair_ops.launches)
    st = sim.state
    a = st.alive.cpu().numpy()
    got = {k: getattr(st, k).cpu().numpy()[a] for k in ("position", "velocity", "density")}
    return recs, got, launches, dict(plain), sim


def clique_state_errs(got, ref_pos, ref_rho, ref_vel):
    import numpy as np

    j = match_by_position(ref_pos, got["position"])
    return {"dx": float(np.abs(got["position"][j] - ref_pos).max()),
            "drho_rel": float(np.abs(got["density"][j] / ref_rho - 1).max()),
            "dv": float(np.abs(got["velocity"][j] - ref_vel).max())}


def clique_state_ok(errs) -> bool:
    return errs["dx"] < 2e-5 and errs["drho_rel"] < 2e-5 and errs["dv"] < 2e-4


def phase_clique_trajectories():
    """C2: every run of stress.clique_runs against its JAX fixture (under
    ASPH_NX_CAP=1 the reference fell back to the packed layout, the port
    stays on the clique layout): iteration counts equal at every step, dt
    within 1e-4, capacity equal, patch 4 throughout, no clique overflow,
    K1-K3 launched, no plain version called; matched by position, positions
    2e-5, density rtol 2e-5, velocity 2e-4. Then the stress scene on the
    clique layout against the packed one on the card. Returns the touching
    run's launches."""
    import numpy as np
    import torch
    from adaptive_sph_torch.stress import clique_runs

    ref = np.load(CLIQUE_FIXTURE)
    out = {}
    for run in clique_runs():
        t0 = time.perf_counter()
        recs, got, launches, plain, sim = run_clique(run)
        wall = time.perf_counter() - t0
        out[run] = (recs, got, launches)
        bad = [f"{k} {recs[k]} != {ref[f'{run}/{k}'].tolist()}"
               for k in ("div_iterations", "density_iterations")
               if recs[k] != ref[f"{run}/{k}"].tolist()]
        ddt = float(np.abs(np.asarray(recs["dt"], np.float64) / ref[f"{run}/dt"] - 1.0).max())
        if ddt >= 1e-4:
            bad.append(f"dt rel err {ddt:.3e}")
        if recs["capacity"][-1] != int(ref[f"{run}/capacity"][-1]):
            bad.append(f"capacity {recs['capacity']}")
        if set(recs["patch"]) != {4} or sim.clique_disabled or any(recs["clique_overflow"]):
            bad.append(f"patch {recs['patch']}, clique overflow {recs['clique_overflow']}")
        bad += [f"{k} never launched" for k in CLIQUE_KERNELS if launches[k] <= 0]
        if any(plain.values()):
            bad.append(f"plain versions ran: {plain}")
        cross = recs["num_pairs"]
        if (run == "stress_clique") != (max(cross) == 0):
            bad.append(f"cross-level pairs per step {cross}")
        errs = clique_state_errs(got, ref[f"{run}/position"], ref[f"{run}/density"],
                                 ref[f"{run}/velocity"])
        if not clique_state_ok(errs):
            bad.append(f"state beyond tolerance: {errs}")
        fell = ref[f"{run}/clique_disabled"].tolist()
        log(f"C2 clique run {run} vs JAX ({len(recs['dt'])} steps, n={len(got['position'])}, "
            f"capacity {recs['capacity'][-1]}, patch {recs['patch'][-1]}; the reference's "
            f"clique_disabled per step {fell}): div iterations {recs['div_iterations']}, density "
            f"iterations {recs['density_iterations']}; cross-level pairs per step {cross}; max "
            f"|dx| {errs['dx']:.3e} (tol 2e-5), rel drho {errs['drho_rel']:.3e} (2e-5), |dv| "
            f"{errs['dv']:.3e} (2e-4), rel ddt {ddt:.3e} (1e-4); launches "
            f"{ {k: launches[k] for k in (*CLIQUE_KERNELS, 'pair_sweep')} }; plain-version calls "
            f"{sum(plain.values())}; {wall:.1f} s")
        if bad:
            raise AssertionError(f"C2 clique run {run}: " + "; ".join(bad))
        del sim
        torch.cuda.empty_cache()
    recs_c, got_c, _ = out["stress_clique"]
    recs_p, got_p, launches_p, _, sim_p = run_clique("stress_clique", clique=False)
    errs = clique_state_errs(got_p, got_c["position"], got_c["density"], got_c["velocity"])
    its = [(a, b) for a, b in zip(recs_c["density_iterations"], recs_p["density_iterations"])]
    log(f"C2 stress scene, clique against packed layout on the card ({len(recs_p['dt'])} steps, "
        f"packed patch {sim_p.tile_cfg.patch}, capacity {recs_p['capacity'][-1]} against "
        f"{recs_c['capacity'][-1]}): density iterations (clique, packed) {its}; max |dx| "
        f"{errs['dx']:.3e}, rel drho {errs['drho_rel']:.3e}, |dv| {errs['dv']:.3e}")
    if not clique_state_ok(errs) or recs_c["div_iterations"] != recs_p["div_iterations"] or \
            recs_c["density_iterations"] != recs_p["density_iterations"] or sim_p.tile_cfg.patch:
        raise AssertionError(f"C2 stress clique against packed: {errs}, iterations {its}")
    del sim_p
    torch.cuda.empty_cache()
    return out["touching_clique"][2]


def phase_clique_timed():
    """C3: the stress scene timed under ASPH_CLIQUE=1 with the parity and the
    bench options, CLIQUE_TIMED steps after CLIQUE_WARMUP (host clock,
    synchronised), then CLIQUE_PROFILED steps under torch.profiler (host
    syncs, device busy share), peak memory; the packed tile step the same
    way in the same run. K1-K3 must launch on both, no plain version on
    either. Then the device times of clique_build, clique_visc and one
    Jacobi sweep's same-level products (halo gathers and four batched
    products) on the clique run's last layout."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptive_sph_torch import spans
    from adaptive_sph_torch.models.tile_step import physics_scale, step_geometry
    from adaptive_sph_torch.ops import cliques, pair_ops
    from adaptive_sph_torch.ops.tiles import build_halo
    from adaptive_sph_torch.stress import STRESS_SCENE, stress_params
    from adaptive_sph_torch.timing import device_ms

    for bench in (False, True):
        tag = "bench (bf16, warm start, momentum 0.9)" if bench else "parity (f32, cold)"
        res = {}
        for clique in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with clique_env() if clique else contextlib.nullcontext():
                sim = clique_sim(stress_params(bench), STRESS_SCENE)
                if sim.tile_cfg.patch != (4 if clique else 0):
                    raise AssertionError(f"C3 {tag}: patch side {sim.tile_cfg.patch}")
                for _ in range(CLIQUE_WARMUP):
                    sim.step()
                torch.cuda.synchronize()
                with count_plain_calls() as plain:
                    pair_ops.reset_launches()
                    t0 = time.perf_counter()
                    diags = sim.step_chunk(CLIQUE_TIMED)
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t0) / CLIQUE_TIMED
                    launches = dict(pair_ops.launches)
                peak = torch.cuda.max_memory_allocated() / 2**20
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    sim.step_chunk(CLIQUE_PROFILED)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            events = prof.key_averages()
            dev_s = sum(e.self_device_time_total for e in spans.device_ops(events)) / 1e6
            syncs = sum(e.count for e in events if "Synchronize" in e.key) / CLIQUE_PROFILED
            missing = [k for k in CLIQUE_KERNELS if launches[k] <= 0]
            if missing or any(plain.values()):
                raise AssertionError(f"C3 {tag} clique={clique}: never launched {missing}, plain "
                                     f"calls {plain}")
            st = sim.state
            for name in ("position", "velocity", "density"):
                if not bool(torch.isfinite(getattr(st, name)[st.alive]).all()):
                    raise AssertionError(f"C3 {tag}: non-finite {name}")
            layout = "clique" if clique else "packed"
            res[layout] = ms
            log(f"C3 stress {layout} {tag}: {ms:.4f} ms/step ({CLIQUE_TIMED} steps after "
                f"{CLIQUE_WARMUP}), mean div / density iterations "
                f"{np.mean(diags['div_iterations']):.2f} / "
                f"{np.mean(diags['density_iterations']):.2f}, peak mem {peak:.1f} MiB, launches "
                f"{ {k: launches[k] for k in (*CLIQUE_KERNELS, 'pair_sweep')} }; "
                f"{CLIQUE_PROFILED} profiled steps: {syncs:.1f} host syncs per step, device busy "
                f"{dev_s / wall:.3f} of wall, {1e3 * dev_s / CLIQUE_PROFILED:.4f} ms device time "
                f"per step")
            if clique:
                tcfg = sim.tile_cfg
                _, bins, cols, wm = step_geometry(sim.state, sim.params, tcfg)
                stc = cols["flat"][:, 0:4].contiguous()
                hs, ovf = build_halo(tcfg, bins, stc)
                scale = float(physics_scale(sim.params))
                wdtype = torch.bfloat16 if bench else torch.float32
                C = tcfg.capacity
                rng = np.random.default_rng(5)
                vx, vy, u, tx, ty = (torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).cuda()
                                     for _ in range(5))
                rho = torch.full((C,), float(sim.params.rest_density), device="cuda")
                out = cliques.clique_build(hs, stc, scale, wdtype)
                op = cliques.CliqueOperator(wx=out[0], wy=out[1], halo_src=hs)
                d_build = device_ms(lambda: cliques.clique_build(hs, stc, scale, wdtype), 5)
                d_visc = device_ms(lambda: cliques.clique_visc(hs, stc, vx, vy, rho, scale,
                                                               "laplace", 0.01), 5)
                d_sweep = device_ms(lambda: (op.matvec2(u), op.matvec_div(tx, ty)), 20)
                log(f"C3 stress clique {tag}, device times on the last layout (C = {C}, "
                    f"{C // 128} patch rows, halo overflow {int(ovf)}): clique_build "
                    f"{d_build:.4f} ms, clique_visc {d_visc:.4f} ms, one Jacobi sweep's "
                    f"same-level products (halo gathers, four batched products) {d_sweep:.4f} ms")
                del out, op
            del sim
            torch.cuda.empty_cache()
        log(f"C3 stress {tag}: clique {res['clique']:.4f} ms/step against packed "
            f"{res['packed']:.4f} ms/step, ratio {res['clique'] / res['packed']:.3f}")


def phase_clique():
    """C1-C3, timed. Returns (the kernels line's clique rows, their launches:
    K1-K3 over C2's touching run, pair_sweep over C1's visc sweep run)."""
    t0 = time.perf_counter()
    rows, sweep_launches = phase_clique_kernels()
    t1 = time.perf_counter()
    touching = phase_clique_trajectories()
    t2 = time.perf_counter()
    phase_clique_timed()
    log(f"clique phases: C1 {t1 - t0:.1f} s, C2 {t2 - t1:.1f} s, C3 "
        f"{time.perf_counter() - t2:.1f} s")
    if "ASPH_CLIQUE" in os.environ:
        raise AssertionError("ASPH_CLIQUE leaked out of the clique phases")
    launches = {k: touching[v] for k, v in CLIQUE_ROWS.items() if v != "pair_sweep"}
    launches["pair_sweep:patch"] = sweep_launches["pair_sweep"]
    bad = [k for k, v in launches.items() if v <= 0]
    if bad:
        raise AssertionError(f"clique rows never launched on their runs: {bad}")
    return rows, launches


# the scenario gates' phase H1
GATES_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_gates_ref.json")
# the short gates that must pass: run -> (scenario, t_end, momentum)
GATES_SHORT = {"stress_momentum": ("stress", 0.3, 0.9), "dam": ("dam", 0.1, 0.0),
               "resampling": ("resampling", 0.06, 0.0), "onlydiv": ("onlydiv", 0.15, 0.0),
               "motivation": ("motivation", 0.05, 0.0)}
GATES_KERNELS = ("pair_build", "pair_matvec", "pair_visc", "pair_sweep")


def phase_gates():
    """H1: the gates' short runs against the JAX fixture, then the short
    gates (see the module docstring)."""
    import numpy as np
    from adaptive_sph_torch import gates
    from adaptive_sph_torch.ops import pair_ops

    t0 = time.perf_counter()
    with open(GATES_FIXTURE) as f:
        fixture = json.load(f)
    bad = []
    for run, ref in fixture.items():
        spec = ref["spec"]
        got, ok, tally = gates.run_scenario(spec["scenario"], spec["t_end"], chunk=spec["chunk"],
                                            momentum=spec["momentum"], device="cuda", log=log)
        want, per = ref["record"], ref["per_step"]
        diffs = [k for k in ("steps", "n_final", "capped_density_solves", "capped_div_solves")
                 if got[k] != want[k]]
        if tally.den_iters != per.get("density_iterations", []):
            diffs.append(f"density iterations {tally.den_iters} != "
                         f"{per.get('density_iterations')}")
        if tally.div_iters != per.get("div_iterations", []):
            diffs.append(f"div iterations {tally.div_iters} != {per.get('div_iterations')}")
        if not np.allclose(tally.dts, per["dt"], rtol=2e-5, atol=0.0):
            diffs.append(f"dt {tally.dts} != {per['dt']}")
        if not ok:
            diffs.append("the gate failed")
        if diffs:
            bad.append(f"{run}: " + "; ".join(map(str, diffs)))
        log(f"H1 {run} against the JAX gates: {got['steps']} steps to t = {got['t_end']:.4f}, "
            f"n {got['n_initial']} -> {got['n_final']}, iterations (density, div) "
            f"{tally.den_iters} / {tally.div_iters}, mass drift {got['mass_drift']:.3e} "
            f"(JAX {want['mass_drift']:.3e}), {'equal' if not diffs else 'DIFFERENT'}")
    t1 = time.perf_counter()
    pair_ops.reset_launches()
    for run, (name, t_end, momentum) in GATES_SHORT.items():
        got, ok, _ = gates.run_scenario(name, t_end, momentum=momentum, device="cuda", log=log)
        log(f"H1 short gate {run}: {'PASS' if ok else 'FAIL'}, {got['steps']} steps to t = "
            f"{got['t_end']:.4f}, n {got['n_initial']} -> {got['n_final']} (capacity "
            f"{got['capacity_final']}), {got['ms_per_step']:.2f} ms/step, mass drift "
            f"{got['mass_drift']:.3e}, excess {got['max_boundary_excess']:.4f}, violations "
            f"{got['density_tol_violations']} / {got['div_tol_violations']}, capped "
            f"{got['capped_density_solves']} / {got['capped_div_solves']}, iterations max "
            f"{got['max_density_iters']} / {got['max_div_iters']}, pairs {got['k1_pairs']}")
        if not ok:
            bad.append(f"short gate {run} failed: {json.dumps(got)}")
    launches = {k: pair_ops.launches[k] for k in GATES_KERNELS}
    bad += [f"{k} never launched on the short gates" for k, v in launches.items() if v <= 0]
    log(f"gates phase: H1 fixture runs {t1 - t0:.1f} s, short gates "
        f"{time.perf_counter() - t1:.1f} s; launches {launches}")
    if bad:
        raise AssertionError("H1: " + " | ".join(bad))


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.stress import solver_runs, stress_params, sweep_mode_runs

    t_start = time.perf_counter()
    smi = phase_header()
    if "--slab-only" in argv:
        phase_slab_parity()
        phase_slab_soak()
        return 0
    if "--lists-only" in argv:
        phase_lists()
        return 0
    if "--nowcache-only" in argv:
        phase_nowcache()
        return 0
    if "--grid-only" in argv:
        phase_grid()
        return 0
    if "--clique-only" in argv:
        phase_clique()
        return 0
    if "--gates-only" in argv:
        phase_gates()
        return 0
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
    mode_calls, mode_layouts = capture_mode_sweep_inputs()
    mode_rows = phase_mode_sweeps(mode_calls, mode_layouts)
    del mode_calls, mode_layouts
    wcsph = phase_wcsph_build()
    scalar = phase_scalar_kernels()
    phase_walk_layouts()
    probe_kernels = phase_probe_kernels()
    akinci_rows = phase_akinci_kernels()
    if "--kernels-only" in argv:
        return 0
    phase_trajectory()
    phase_dambreak_trajectory()
    phase_resident_trajectories()
    solver_launches = phase_solver_trajectories()
    mode_runs, mode_steps = phase_sweep_mode_trajectories()
    nowcache_rows, nowcache_launches = phase_nowcache()
    phase_akinci_trajectories()
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
    mode_runs_all = sweep_mode_runs()
    media = mode_runs_all["media_constant_field"]
    timed_path(media[0], "media constant field (FromDistributionClamped1, diagnostic fields, "
               "scene-ratio2to1)", tuple("pair_sweep:" + k for k in
                                         SWEEP_MODE_RUN_KERNELS["media_constant_field"]),
               scene=media[1])
    phase_aii_drift()
    timed_path(mode_runs_all["stress_checked_constrained"][0],
               "stress, neighbourhood constraint, check_aii, check_neighborhood (f32, cold)",
               tuple("pair_sweep:" + k for k in
                     SWEEP_MODE_RUN_KERNELS["stress_checked_constrained"]))
    akinci_timed = phase_akinci_timed()
    launches = timed_dambreak()
    missing = [k for k in DAMBREAK_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the dam-break path: {missing}")
    timing_run = phase_timing()
    probe_run = phase_probe()
    phase_image_export()
    phase_video_export()
    phase_ten_levels()
    phase_run_options()
    phase_run_profile()
    phase_split_patterns()
    phase_slab_parity()
    slab_launches, slab_rows = phase_slab_soak()
    phase_lists()
    phase_grid()
    clique_rows, clique_launches = phase_clique()
    phase_gates()
    launches = {**launches, **clique_launches, "pair_hybrid": hybrid["pair_hybrid"],
                "pair_jacobi": iisph["pair_jacobi"],
                "pair_matvec_scalar": scalar_run["pair_matvec_scalar"],
                "pair_visc_scalar": scalar_run["pair_visc_scalar"],
                "pair_weights": timing_run["pair_weights"],
                **{k: probe_run[k] for k in PROBE_KERNELS},
                **{k: solver_launches[k] for k in pair_ops.MODE_KEYS}, **nowcache_launches}
    # the new sweep modes: launches summed over the sweep-mode runs
    for k in MODE_SWEEPS:
        key = "pair_sweep:" + k
        launches[key] = sum(v[key] for v in mode_runs.values())
        per_step = {run: v[key] / mode_steps[run] for run, v in mode_runs.items() if v[key]}
        log(f"{key}: {launches[key]} launches over the sweep-mode runs; per step "
            + ", ".join(f"{run} {n:.1f}" for run, n in per_step.items()))

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
            "pair_sweep:omega": solver_sweeps["omega"], **w2020, **mode_rows, **akinci_rows,
            **slab_rows, **nowcache_rows, **clique_rows}
    for kernel in SLAB_KERNELS:
        launches[kernel + "@slab"] = slab_launches[kernel]
    # the Akinci rows' launches: the timed scene2 run whose path launches each
    for kernel, tag in (("pair_build", "streamed hybrid"), ("pair_matvec", "streamed hybrid"),
                        ("pair_visc", "streamed hybrid"), ("pair_sweep", "resident IISPH"),
                        ("pair_jacobi", "resident IISPH"), ("pair_hybrid", "resident hybrid")):
        launches[kernel + "@akinci"] = akinci_timed[tag][kernel]
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
    log(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
