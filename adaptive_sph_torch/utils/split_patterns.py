"""Split patterns: generating, storing and loading the table the splitter places children by.

Counterpart of adaptive_sph_tpu/utils/split_patterns.py. The port keeps its
own byte-identical copy of the default table in
adaptive_sph_torch/data/split-patterns.yaml.

Generation (`python -m adaptive_sph_torch generate-split-patterns`): for n
children, a hex lattice of neighbours at the mass that gives rest density
(`generate_tetrahedral_point_set`, `find_optimal_mass`), then gradient
descent on the density-error objective E = sum_n m_n tau_n^2 + sum_s m_s
tau_s^2 (`_objective`), its gradient by torch.autograd, 40,000 steps of
0.01 in chunks of 200 with one host read per chunk, from random starts in a
disc of radius 0.6; an attempt is dropped when two children pair up or one
runs away (checked after 1,000 steps), and the next one starts from the
generator seeded n * 1000 + retry. The starts come from torch's generator
of the run's device, so a table generated here differs from the JAX
package's in its random stream, not in its properties.

Schema: a YAML list whose entry k holds the pattern for k + 2 children,
{"pos_s": [[x, y], ...], "mass_s": [...], "h_s": [...]}, positions in units
of the parent's radius.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import yaml

from ..models.state import resolve_device
from ..ops import kernels
from ..ops.numerics import sqrt

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
    """The split-pattern table of `path`, else of the file that
    ASPH_SPLIT_PATTERNS names, else the packaged default."""
    return to_padded_table(load_patterns_yaml(
        path or os.environ.get("ASPH_SPLIT_PATTERNS", DEFAULT_PATTERN_PATH)))


def save_patterns(patterns: list, path: str):
    with open(path, "w") as f:
        yaml.safe_dump(patterns, f)


def generate_tetrahedral_point_set(distance: float, bound: float) -> np.ndarray:
    """Hex lattice covering [-bound, bound]^2 with one point at the origin
    (float64)."""
    pts = []
    hrow = np.sqrt(3.0) * 0.5
    rmin = int(np.ceil(-bound / hrow))
    rmax = int(np.floor(bound / hrow))
    for row in range(rmin, rmax + 1):
        y = hrow * row
        cshift = 0.0 if row % 2 == 0 else distance / 2.0
        cmin = int(np.ceil((-bound - cshift) / distance))
        cmax = int(np.floor((bound - cshift) / distance))
        for col in range(cmin, cmax + 1):
            pts.append((cshift + col * distance, y))
    return np.asarray(pts, dtype=np.float64)


def find_optimal_mass(initial_mass: float, rest_density: float, positions: np.ndarray) -> float:
    """Halving search for the lattice mass that gives rest density at the
    origin (40 halvings; a mass at or below zero counts as density 0)."""
    mass = initial_mass
    mass_update = initial_mass
    max_distance = np.max(np.linalg.norm(positions, axis=-1))
    for _ in range(40):
        if mass <= 0.0:
            density = 0.0
        else:
            h = float(kernels.smoothing_length_from_mass(mass, rest_density, 2))
            if not h < max_distance:
                raise ValueError("find_optimal_mass: the lattice is smaller than the support")
            r = np.linalg.norm(positions, axis=-1)
            # q = r / 2h in float64, rounded to float32 as the reference rounds it
            q = (r / (2.0 * h)).astype(np.float32)
            density = float(np.sum(mass * np.asarray(kernels.kernel_w_np(q, h), np.float64)))
        if abs(density - rest_density) < 1e-6:
            return mass
        mass += -mass_update if density > rest_density else mass_update
        mass_update *= 0.5
    raise RuntimeError("find_optimal_mass: too many iterations")


def _kernel_w(r, h):
    """The 2D cubic W(r, h) on tensors, each operation rounded on its own (the
    optimiser's objective: fewer launches than ops.kernels.kernel_w's
    contracted spline, which matches the pair walks bit for bit)."""
    q = r / (2.0 * h)
    v = 1.0 - q
    inner = 6.0 * (q * q * q - q * q) + 1.0
    outer = 2.0 * v * v * v
    w = torch.where(q < 0.5, inner, torch.where(q < 1.0, outer, torch.zeros_like(q)))
    return (10.0 / (7.0 * math.pi)) / (h * h) * w


def _objective(pos_s, mass_s, h_s, pos_n, mass_n, h_n, pos_o, mass_o, h_o, rho_o):
    """(E, (tau_n, tau_s)): tau_n the density change each lattice neighbour
    feels when the parent at pos_o is replaced by the children, tau_s the
    density error at each child, E = sum_n m_n tau_n^2 + sum_s m_s tau_s^2.
    The neighbour-child and child-child kernels come from one (N + S, S)
    matrix; the child-neighbour one is its transpose (W is symmetric)."""
    N = pos_n.shape[0]
    xa, ha = torch.cat([pos_n, pos_s]), torch.cat([h_n, h_s])
    d = xa[:, None, :] - pos_s[None, :, :]
    w = _kernel_w(sqrt(torch.sum(d * d, -1) + 1e-30), 0.5 * (ha[:, None] + h_s[None, :]))
    w_ns, w_ss = w[:N], w[N:]
    dno = pos_n - pos_o
    w_no = _kernel_w(sqrt(torch.sum(dno * dno, -1)), 0.5 * (h_n + h_o))
    tau_n = -mass_o * w_no + torch.sum(mass_s[None, :] * w_ns, dim=1)
    tau_s = (-rho_o + torch.sum(mass_s[None, :] * w_ss, dim=1)
             + torch.sum(mass_n[:, None] * w_ns, dim=0))
    return torch.sum(mass_n * tau_n ** 2) + torch.sum(mass_s * tau_s ** 2), (tau_n, tau_s)


RUNNING, VALID, PAIRING, RUNAWAY = 0, 1, 2, 3
STATUS_NAMES = {VALID: "valid", PAIRING: "pairing", RUNAWAY: "runaway"}


def make_pattern_optimizer(s_count: int, pos_n: np.ndarray, mass: float, h: float,
                           rest_density: float, neighbors_distance: float,
                           max_iters: int = 40000, check_every: int = 200, device="cuda"):
    """run(seed) -> (positions (s_count, 2) numpy, "valid" | "pairing" |
    "runaway"): one attempt from a random start. run.attempt(ps0) runs one
    from the given (s_count, 2) start (a tensor on the device)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    child_mass = mass / s_count
    child_h = float(kernels.smoothing_length_from_mass(child_mass, 1.0, 2))
    mass_s = torch.full((s_count,), child_mass, **f32)
    h_s = torch.full((s_count,), child_h, **f32)
    mass_n = torch.full((pos_n.shape[0],), mass, **f32)
    h_n = torch.full((pos_n.shape[0],), h, **f32)
    pos_nt = torch.as_tensor(np.asarray(pos_n, np.float32), device=device)
    pos_o = torch.zeros(2, **f32)

    # the density at the original particle
    r_on = sqrt(torch.sum(pos_nt * pos_nt, -1))
    rho_o = mass * kernels.kernel_w(0.0, h, 2) + torch.sum(
        mass_n * _kernel_w(r_on, 0.5 * (h_n + h)))

    def grad(ps):
        ps = ps.detach().requires_grad_(True)
        e = _objective(ps, mass_s, h_s, pos_nt, mass_n, h_n, pos_o, mass, h, rho_o)[0]
        return torch.autograd.grad(e, ps)[0]

    min_req_dist = 0.1 * float(kernels.sphere_volume_to_radius(child_mass / rest_density, 2))
    eye = torch.eye(s_count, **f32) * 1e9

    def chunk_eager(ps):
        for _ in range(check_every):
            ps = ps - 0.01 * grad(ps)
        return ps

    chunk = chunk_eager
    if device.type == "cuda":
        # a chunk is some hundred launches of tiny arrays per step: on the card
        # it replays as one captured graph (the same kernels, one launch)
        ps_in = torch.zeros((s_count, 2), **f32)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            chunk_eager(ps_in)  # warm-up before the capture
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ps_out = chunk_eager(ps_in)
        # the graph reads these by address: they live as long as it does
        inputs = (mass_s, h_s, pos_nt, mass_n, h_n, pos_o, rho_o, ps_in)

        def chunk(ps):
            inputs[-1].copy_(ps)
            graph.replay()
            return ps_out.clone()

    def attempt(ps0):
        ps, it, status = ps0.to(**f32), 0, RUNNING
        while status == RUNNING and it < max_iters:
            ps = chunk(ps)
            it += check_every
            d = ps[:, None, :] - ps[None, :, :]
            paired = torch.min(torch.sum(d * d, -1) + eye) < min_req_dist ** 2
            runaway = torch.max(torch.sum(ps * ps, -1)) > (neighbors_distance * 0.99) ** 2
            if it > 1000:
                # the one host read of the chunk
                paired, runaway = torch.stack([paired, runaway]).tolist()
                status = PAIRING if paired else RUNAWAY if runaway else RUNNING
        return ps.detach(), VALID if status == RUNNING else status

    def run(seed: int):
        # a uniform start in the disc of radius 0.6
        gen = torch.Generator(device=device).manual_seed(seed)
        angle = torch.rand(s_count, generator=gen, **f32) * (2.0 * math.pi)
        dist = torch.sqrt(torch.rand(s_count, generator=gen, **f32)) * 0.6
        ps, status = attempt(torch.stack([torch.cos(angle), torch.sin(angle)], -1)
                             * dist[:, None])
        return ps.cpu().numpy(), STATUS_NAMES[status]

    run.attempt = attempt
    return run


def precalculate_split_pattern(num_children: int, rest_density: float = 1.0,
                               max_retries: int = 300, device="cuda"):
    """The pattern for num_children: the lattice mass, the lattice rescaled
    to a parent of radius 1 (origin dropped), then attempts until one is
    valid. Returns {"mass_s", "pos_s", "h_s"} and the number of attempts."""
    bound = (2.0 * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
             * float(kernels.smoothing_length_from_volume(
                 kernels.radius_to_sphere_volume(1.0, 2), 2)))
    neighbors_distance = 1.0
    pos_n = generate_tetrahedral_point_set(neighbors_distance, bound)
    mass = find_optimal_mass(1.0, rest_density, pos_n)

    # rescale so that the particle radius is 1
    r = float(kernels.sphere_volume_to_radius(mass / rest_density, 2))
    pos_n = pos_n / r
    neighbors_distance /= r
    mass = float(kernels.radius_to_sphere_volume(1.0, 2)) * rest_density
    h = float(kernels.smoothing_length_from_mass(mass, rest_density, 2))

    # the origin point becomes the split particle
    norms = np.linalg.norm(pos_n, axis=-1)
    origin = int(np.argmin(norms))
    if not norms[origin] < 1e-9:
        raise RuntimeError("the lattice has no point at the origin")
    pos_n = np.delete(pos_n, origin, axis=0)

    run = make_pattern_optimizer(num_children, pos_n, mass, h, rest_density,
                                 neighbors_distance, device=device)
    for retry in range(max_retries):
        pos_s, status = run(seed=num_children * 1000 + retry)
        if status == "valid":
            child_mass = mass / num_children
            child_h = float(kernels.smoothing_length_from_mass(child_mass, 1.0, 2))
            return {"mass_s": [child_mass] * num_children,
                    "pos_s": [[float(x), float(y)] for x, y in pos_s],
                    "h_s": [child_h] * num_children}, retry + 1
    raise RuntimeError(f"no valid split pattern found num_children={num_children}")


def generate_split_patterns(max_num_children: int, device="cuda", log=None):
    """Patterns for 2..max_num_children children (entry k: k + 2). log(n,
    attempts, seconds) is called after each pattern."""
    import time

    out = []
    for n in range(2, max_num_children + 1):
        t0 = time.perf_counter()
        pattern, attempts = precalculate_split_pattern(n, device=device)
        out.append(pattern)
        if log is not None:
            log(n, attempts, time.perf_counter() - t0)
    return out


def export_pattern_svg(pattern: dict, path: str, size: int = 512):
    """Debug SVG of one split pattern: the parent particle (radius-1 outline,
    its kernel support dashed) and the filled child circles at their physical
    radii."""
    pos = pattern["pos_s"]
    n = len(pos)
    child_r = float(kernels.sphere_volume_to_radius(
        kernels.radius_to_sphere_volume(1.0, 2) / n, 2))
    h = float(kernels.smoothing_length_from_mass(
        float(kernels.radius_to_sphere_volume(1.0, 2)) / 1.0, 1.0, 2))
    support = 2.0 * h  # the parent's kernel support radius
    half = support * 1.1
    s = size / (2 * half)

    def cx(v):
        return (v + half) * s

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" '
        f'viewBox="0 0 {size} {size}">',
        f'<rect width="{size}" height="{size}" fill="white"/>',
        f'<circle cx="{cx(0):.2f}" cy="{cx(0):.2f}" r="{support*s:.2f}" '
        'fill="none" stroke="#999" stroke-dasharray="6,4" stroke-width="1.5"/>',
        f'<circle cx="{cx(0):.2f}" cy="{cx(0):.2f}" r="{1.0*s:.2f}" '
        'fill="none" stroke="#333" stroke-width="2"/>',
    ]
    for k, (x, y) in enumerate(pos):
        hue = int(360 * k / max(n, 1))
        parts.append(
            f'<circle cx="{cx(float(x)):.2f}" cy="{cx(float(y)):.2f}" '
            f'r="{child_r*s:.2f}" fill="hsl({hue},70%,60%)" fill-opacity="0.75" '
            'stroke="#222" stroke-width="1"/>')
    dist = [math.hypot(float(x), float(y)) for x, y in pos]
    parts.append(
        f'<text x="8" y="{size-10}" font-family="monospace" font-size="14">'
        f'n={n} r_child={child_r:.3f} max|x|={max(dist):.3f}</text>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
