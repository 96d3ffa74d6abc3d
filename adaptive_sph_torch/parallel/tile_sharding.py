"""Slab decomposition of the tile step over torch.distributed.

Counterpart of adaptive_sph_tpu/parallel/tile_sharding.py. The domain is cut
into vertical slabs along x, one per rank (one process each); a rank owns the
particles whose start-of-step x lies in its slab and runs the one-device step
(models/tile_step.py) on [its particles | the strip received from the left |
the strip received from the right]:

  - one full-payload strip exchange per step: each rank packs the particles
    within `halo_w` of its slab edges into fixed (strip, F) buffers and sends
    them to its neighbours. Received particles inside the receiver's slab are
    adopted (the old owner keeps them one more step as ghosts), the rest are
    ghosts. A particle received from the left whose x lies beyond the right
    edge (it crossed more than one slab) is relayed: owned for one step and
    forwarded at the next exchange.
  - values that change inside the step (density, pressure, the divergence
    operands, levels, advected positions) refresh the ghost rows from their
    owners (`HaloHooks.make_refresher`), two strip exchanges per solver
    iteration;
  - reductions (CFL dt, the solves' convergence statistics, counters) are
    psum / pmin / pmax over the ranks, so every rank takes the same decision
    at every host read that decides whether another collective runs.

The edge ranks receive zeros where they have no neighbour, as `ppermute`
gives the reference, and own the outside half-planes. Resampling runs
slab-locally between the step and the retention compaction: donors and
receivers are owned rows, split children join the owned set.

`SlabComm` carries the exchanges and reductions over a process group whose
backend the caller names: "nccl" (one card per rank, device tensors) or
"gloo" (ranks on the CPU, or several ranks sharing one card: gloo takes CPU
tensors only, so a CUDA rank stages every message through pinned host
buffers). Nothing picks a backend or a device on its own.

`SlabSimulation` is the per-rank driver: a step that overflowed a strip or a
slab, or whose particles outgrew the halo, is discarded; the ranks
all-gather their rows, recompute the same `make_slab_config` (1.5x the
headroom after an overflow, up to 16) and retry, at most 3 times.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..models import adaptivity as adapt
from ..models.state import FIELDS, FluidState
from ..models.tile_step import max_scale, single_step_tiles
from ..ops import kernels
from ..ops.grid import GridConfig
from ..ops.tiles import TileConfig
from ..runner import _read_diag
from ..utils.params import ParticleSizes, SimulationParams

# full-payload columns exchanged once per step (everything the step reads)
_PAYLOAD = (
    "mass", "position", "velocity", "h", "h_next", "omega", "level",
    "has_level", "size_class", "pressure", "pressure_div",
)
GROUP_TIMEOUT_S = 300  # a collective that one rank never reaches fails after this


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SlabConfig:
    """Static geometry of the slab decomposition (the reference's, field by
    field; `tcfg` keeps the global origin, `rank_tcfg` gives a rank's)."""

    ndev: int
    c_dev: int  # owned-particle capacity per rank
    strip: int  # halo strip buffer size (particles per direction)
    halo_w: float  # halo width (>= max search radius + migration margin)
    edges: tuple  # (ndev + 1,) slab boundaries along x
    oy: float  # global grid origin y
    tcfg: TileConfig  # per-rank tile config (capacity == c_dev + 2 * strip)

    @property
    def c_loc(self) -> int:
        return self.c_dev + 2 * self.strip

    def edges32(self, rank: int):
        """The rank's slab edges as float32 values (the reference's traced edges)."""
        e = np.asarray(self.edges, np.float32)
        return e[rank], e[rank + 1]

    def rank_tcfg(self, rank: int) -> TileConfig:
        """The rank's tile config: its local grid starts halo_w + 2 cell0 left
        of its slab, in float32 as the reference computes the traced origin."""
        x_lo, _ = self.edges32(rank)
        ox = np.float32(x_lo - np.float32(self.halo_w + 2 * self.tcfg.cell0))
        return dataclasses.replace(self.tcfg, origin=(float(ox), _f32(self.oy)))


def _host(state) -> dict:
    """numpy arrays of a FluidState or a dict of them."""
    return convert.state_to_numpy(state) if isinstance(state, FluidState) else state


def _h_from_mass32(mass, rest_density):
    """h = ETA sqrt(m / rho0 / pi) in float32, op by op as the reference's
    host code computes it."""
    v = np.asarray(mass, np.float32) / rest_density
    return kernels.ETA * np.sqrt(v / kernels.PI)


def make_slab_config(params: SimulationParams, gcfg: GridConfig, state, ndev: int,
                     tq: int = 32, headroom: float = 2.0) -> SlabConfig:
    """The slab decomposition of the current global state (a FluidState or a
    dict of numpy "position", "mass", "alive"): count-balanced edges clipped
    so that every slab stays at least 1.02 halo widths wide, capacities with
    `headroom` x margin, and the local tile config. Equal to the reference's
    on the same state, bit for bit."""
    host = _host(state)
    alive = np.asarray(host["alive"])
    xs = np.sort(np.asarray(host["position"])[alive, 0])
    n = len(xs)
    x0 = gcfg.origin[0]
    x1 = gcfg.origin[0] + gcfg.nx0 * gcfg.cell0

    if params.particle_sizes == ParticleSizes.Uniform:
        h_max = float(params.h)
    else:
        h_max = float(np.max(_h_from_mass32(np.asarray(host["mass"])[alive],
                                            params.rest_density)))
    mscale = float(max_scale(params))
    halo_w = mscale * h_max * 1.25

    if (x1 - x0) < ndev * halo_w * 1.02:
        raise ValueError(
            f"domain width {x1 - x0:.4f} < {ndev} x halo width {halo_w:.4f}: one-hop halo "
            f"exchange needs every slab at least one interaction radius wide; use fewer "
            f"ranks for this scene (max ~{max(1, int((x1 - x0) / (halo_w * 1.02)))})")
    qs = [float(xs[min(int(n * k / ndev), n - 1)]) for k in range(1, ndev)]
    edges_l = [x0]
    for d, q in enumerate(qs):
        hi_room = x1 - (ndev - 1 - d) * halo_w * 1.02
        edges_l.append(min(max(q, edges_l[-1] + halo_w * 1.02), hi_room))
    edges_l.append(x1)
    edges = tuple(edges_l)

    counts, strips = [], []
    for d in range(ndev):
        lo, hi = edges[d], edges[d + 1]
        counts.append(int(np.sum((xs >= lo) & (xs < hi))))
        strips.append(int(np.sum((xs >= lo) & (xs < lo + halo_w))))
        strips.append(int(np.sum((xs < hi) & (xs >= hi - halo_w))))
    c_dev = max(64, ((int(max(counts) * headroom) + 16 * tq + 63) // 64) * 64)
    strip = max(64, ((int(max(strips) * headroom * 1.25) + 8 * tq + 63) // 64) * 64)
    c_loc = c_dev + 2 * strip

    # local grid: the widest slab plus a halo on both sides, dims divisible
    # for the level ladder
    div = 1 << (gcfg.levels - 1)
    slab_w = max(edges[d + 1] - edges[d] for d in range(ndev))
    nx_loc = int(np.ceil((slab_w + 2 * halo_w) / gcfg.cell0)) + 2
    nx_loc = ((nx_loc + div - 1) // div) * div
    gcfg_loc = dataclasses.replace(gcfg, nx0=nx_loc, capacity=c_loc, nx_raw=0, ny_raw=0)
    tcfg = TileConfig.from_grid(gcfg_loc, mscale, tq=tq)
    return SlabConfig(ndev=ndev, c_dev=c_dev, strip=strip, halo_w=float(halo_w), edges=edges,
                      oy=float(gcfg.origin[1]), tcfg=tcfg)


def shard_spatially(state, scfg: SlabConfig) -> dict:
    """Global state -> slab-blocked numpy arrays of ndev * c_dev rows: rank
    d's alive particles, in their order, at the front of block d. Per-step
    scalars (n, time, step_number) are kept."""
    host = _host(state)
    ndev, c_dev = scfg.ndev, scfg.c_dev
    alive = np.asarray(host["alive"])
    x = np.asarray(host["position"])[:, 0]
    slab = np.clip(np.searchsorted(np.asarray(scfg.edges[1:-1]), x, side="right"), 0, ndev - 1)
    sels = [alive & (slab == d) for d in range(ndev)]
    for d, sel in enumerate(sels):
        cnt = int(sel.sum())
        if cnt > c_dev:
            raise ValueError(f"slab {d}: {cnt} particles > c_dev {c_dev}")

    out = {}
    for k in FIELDS:
        a = np.asarray(host[k])
        if a.ndim == 0:
            out[k] = a
            continue
        b = np.zeros((ndev * c_dev,) + a.shape[1:], a.dtype)
        for d, sel in enumerate(sels):
            b[d * c_dev: d * c_dev + int(sel.sum())] = a[sel]
        out[k] = b
    amask = np.zeros(ndev * c_dev, bool)
    for d, sel in enumerate(sels):
        amask[d * c_dev: d * c_dev + int(sel.sum())] = True
    out["alive"] = amask
    return out


def local_state(blocked: dict, scfg: SlabConfig, rank: int, device) -> FluidState:
    """Rank `rank`'s block of slab-blocked arrays as a FluidState on `device`."""
    lo, hi = rank * scfg.c_dev, (rank + 1) * scfg.c_dev
    return convert.state_from_numpy(
        {k: (a if a.ndim == 0 else a[lo:hi]) for k, a in
         ((k, np.asarray(blocked[k])) for k in FIELDS)}, device)


def gather_alive(state) -> dict:
    """Alive particles' position, velocity, density, pressure, mass and
    level sorted by (x, y), for comparisons (a FluidState or numpy arrays)."""
    host = _host(state)
    alive = np.asarray(host["alive"])
    pos = np.asarray(host["position"])[alive]
    order = np.lexsort((pos[:, 1], pos[:, 0]))
    out = {"position": pos[order]}
    for name in ("velocity", "density", "pressure", "mass", "level"):
        out[name] = np.asarray(host[name])[alive][order]
    return out


def _pack_strip(mask, payload, S: int):
    """Pack masked rows into a fixed (S, F) buffer; returns (buf, idx,
    overflow): idx the packed rows' indices (C where a slot is empty)."""
    C, F = payload.shape
    dev = payload.device
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    tgt = torch.where(mask & (pos < S), pos, S).long()
    buf = torch.zeros((S + 1, F), dtype=payload.dtype, device=dev)
    buf[tgt] = torch.where(mask[:, None], payload, torch.zeros_like(payload))
    idx = torch.full((S + 1,), C, dtype=torch.int32, device=dev)
    idx[tgt] = torch.arange(C, dtype=torch.int32, device=dev)
    overflow = torch.clamp(torch.sum(mask.to(torch.int32)) - S, min=0)
    return buf[:S], idx[:S], overflow


def _payload_matrix(state: FluidState):
    cols = [getattr(state, name).to(torch.float32) for name in _PAYLOAD]
    cols.append(state.alive.to(torch.float32))
    return torch.cat([c[:, None] if c.ndim == 1 else c for c in cols], dim=1)


def _payload_fields(buf) -> dict:
    out, c = {}, 0
    for name in _PAYLOAD:
        k = 2 if name in ("position", "velocity") else 1
        v = buf[:, c:c + k]
        out[name] = v if k == 2 else v[:, 0]
        c += k
    out["alive"] = buf[:, c] > 0.5
    return out


class SlabComm:
    """One rank's exchanges and reductions over the default process group.

    exchange(to_left, to_right) -> (from_left, from_right): to_left goes to
    rank - 1, to_right to rank + 1; an edge rank receives zeros where it has
    no neighbour. psum / pmin / pmax reduce a tensor elementwise over the
    ranks. `stats` counts exchanges, reductions and the bytes this rank sent."""

    def __init__(self, rank: int, world: int, backend: str, device):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
        device = torch.device(device)
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the nccl backend takes CUDA devices (one card per rank)")
        self.rank, self.world, self.backend, self.device = rank, world, backend, device
        # gloo moves CPU tensors only: a CUDA rank stages through pinned buffers
        self.staged = backend == "gloo" and device.type == "cuda"
        self.stats = {"exchanges": 0, "reductions": 0, "bytes": 0}

    @classmethod
    def init(cls, rank: int, world: int, backend: str, device, init_method: str,
             timeout_s: float = GROUP_TIMEOUT_S) -> "SlabComm":
        """Join the process group (`init_method`: a file:// or tcp:// rendezvous)
        and return this rank's communicator. A failed init raises."""
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
        comm = cls(rank, world, backend, device)
        comm.barrier()
        return comm

    def _wire(self, t):
        """t as the backend sends it: a pinned host copy on a staged rank."""
        t = t.contiguous()
        if not self.staged:
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def _empty_wire(self, like):
        if not self.staged:
            return torch.zeros_like(like)
        return torch.zeros(like.shape, dtype=like.dtype, pin_memory=True)

    def _back(self, t):
        return t.to(self.device) if self.staged else t

    def exchange(self, to_left, to_right):
        self.stats["exchanges"] += 1
        sl, sr = self._wire(to_left), self._wire(to_right)
        fl, fr = self._empty_wire(sr), self._empty_wire(sl)
        ops = []
        if self.rank > 0:
            ops += [dist.P2POp(dist.isend, sl, self.rank - 1),
                    dist.P2POp(dist.irecv, fl, self.rank - 1)]
            self.stats["bytes"] += sl.numel() * sl.element_size()
        if self.rank < self.world - 1:
            ops += [dist.P2POp(dist.isend, sr, self.rank + 1),
                    dist.P2POp(dist.irecv, fr, self.rank + 1)]
            self.stats["bytes"] += sr.numel() * sr.element_size()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._back(fl), self._back(fr)

    def _reduce(self, x, op):
        self.stats["reductions"] += 1
        t = self._wire(x.reshape(-1)) if self.staged else x.reshape(-1).clone()
        dist.all_reduce(t, op=op)
        return self._back(t).reshape(x.shape)

    def psum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x):
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x) -> list:
        """Every rank's x (same shape on every rank), in rank order."""
        t = self._wire(x)
        out = [self._empty_wire(t) for _ in range(self.world)]
        dist.all_gather(out, t)
        return [self._back(o) for o in out]

    def barrier(self):
        dist.barrier()


class HaloHooks:
    """A rank's hooks into the one-device step (`single_step_tiles(halo=)`):
    the owned rows (working-set order), the collectives and the ghost-row
    refresh of the step's sorted layout."""

    def __init__(self, scfg: SlabConfig, comm: SlabComm, owned, sendL_idx, sendR_idx):
        self.scfg = scfg
        self.comm = comm
        self.owned = owned  # (C_loc,) bool, working-set order
        self.sendL_idx = sendL_idx  # (S,) working-set rows of my left strip (C_loc = none)
        self.sendR_idx = sendR_idx

    def psum(self, x):
        return self.comm.psum(x)

    def pmin(self, x):
        return self.comm.pmin(x)

    def pmax(self, x):
        return self.comm.pmax(x)

    def make_refresher(self, bins):
        """refresh(vals): sorted (C,) or (C, k) values with the ghost rows
        replaced by their owners' values: my strips' rows gathered, exchanged,
        and scattered into the ghost rows (working-set rows [c_dev, c_dev + S)
        from the left owner, [c_dev + S, c_dev + 2 S) from the right)."""
        scfg = self.scfg
        C, S = scfg.c_loc, scfg.strip
        pp = bins.pp
        dev = pp.device

        def slots(idx):
            s = pp[torch.clamp(idx, max=C - 1).long()]
            return torch.where(idx < C, s, torch.full_like(s, C))

        sl, sr = slots(self.sendL_idx), slots(self.sendR_idx)
        okl, okr = (sl < C)[:, None], (sr < C)[:, None]
        gl, gr = torch.clamp(sl, max=C - 1).long(), torch.clamp(sr, max=C - 1).long()
        ar = torch.arange(S, device=dev)
        ghost_l = pp[scfg.c_dev + ar].long()  # C (dead) lands on the dropped row
        ghost_r = pp[scfg.c_dev + S + ar].long()

        def refresh(vals):
            squeeze = vals.ndim == 1
            v = vals[:, None] if squeeze else vals
            zero = torch.zeros((), dtype=v.dtype, device=dev)
            vl = torch.where(okl, v[gl], zero)
            vr = torch.where(okr, v[gr], zero)
            from_l, from_r = self.comm.exchange(vl, vr)
            out = torch.cat([v, v[:1]])
            out[ghost_l] = from_l
            out[ghost_r] = from_r
            out = out[:C]
            return out[:, 0] if squeeze else out

        return refresh


def _resampling(params: SimulationParams) -> bool:
    return params.particle_sizes == ParticleSizes.Adaptive and (
        params.merging or params.sharing or params.splitting)


def slab_step(local: FluidState, params: SimulationParams, scfg: SlabConfig, comm: SlabComm,
              boundary_handler, step_number: int, split_patterns=None):
    """One step of rank comm.rank's slab: (new local state of c_dev rows,
    diag). step_number: the host's count of steps once this one is done
    (its parity picks merge or split). The diagnostics the driver reads are
    reduced over the ranks: neighbor_overflow, shard_overflow, relay_count,
    halo_h_max, the solves' statistics and the resampling counters."""
    rank, ndev = comm.rank, scfg.ndev
    S, c_dev = scfg.strip, scfg.c_dev
    dev = local.device
    x_lo, x_hi = scfg.edges32(rank)
    hw = np.float32(scfg.halo_w)
    x = local.position[:, 0]
    al = local.alive

    payload = _payload_matrix(local)
    mask_l = al & (x < float(np.float32(x_lo + hw)))
    mask_r = al & (x >= float(np.float32(x_hi - hw)))
    buf_l, idx_l, ov_l = _pack_strip(mask_l, payload, S)
    buf_r, idx_r, ov_r = _pack_strip(mask_r, payload, S)
    recv_l, recv_r = comm.exchange(buf_l, buf_r)
    f_l, f_r = _payload_fields(recv_l), _payload_fields(recv_r)

    def cat(name, v):
        if v.ndim == 0:
            return v
        if name == "alive" or name in _PAYLOAD:
            return torch.cat([v, f_l[name].to(v.dtype), f_r[name].to(v.dtype)])
        return torch.cat([v, torch.zeros((2 * S,) + tuple(v.shape[1:]), dtype=v.dtype,
                                         device=dev)])

    w = FluidState(**{k: cat(k, getattr(local, k)) for k in FIELDS})
    xw = w.position[:, 0]
    # the edge ranks own the outside half-planes, so that a particle pushed
    # past the domain is never dropped
    owned = w.alive
    if rank > 0:
        owned = owned & (xw >= float(x_lo))
    if rank < ndev - 1:
        owned = owned & (xw < float(x_hi))
    # relay: a ghost that crossed more than one slab in a step lies beyond my
    # far edge; its owner never saw it and the sender drops it, so I keep it
    # one step and forward it at the next exchange
    row = torch.arange(scfg.c_loc, device=dev)
    from_left = (row >= c_dev) & (row < c_dev + S)
    from_right = row >= c_dev + S
    relay = w.alive & ((from_left & (xw >= float(x_hi))) | (from_right & (xw < float(x_lo))))
    owned = owned | relay
    halo = HaloHooks(scfg, comm, owned, idx_l, idx_r)
    tcfg = scfg.rank_tcfg(rank)
    new_w, dt, diag = single_step_tiles(w, params, tcfg, boundary_handler, halo=halo)
    # the step returns its sorted order; the ownership in that order rides the diag
    keep_owned = diag.pop("_owned_sorted")
    if _resampling(params):
        def partner_fn(st, cls, mode):
            return adapt.find_partners_tiles(st, tcfg, cls, dt, params, mode, owned=keep_owned)

        new_w, adiag = adapt.single_step_adaptivity(new_w, dt, params, split_patterns,
                                                    partner_fn, step_number, owned=keep_owned,
                                                    psum=halo.psum)
        keep_owned = adiag.pop("_owned_after")
        diag.update(adiag)

    # retention compaction of the kept rows into c_dev
    keep = keep_owned & new_w.alive
    pos = torch.cumsum(keep.to(torch.int32), 0) - 1
    tgt = torch.where(keep & (pos < c_dev), pos, c_dev).long()
    kept = torch.sum(keep.to(torch.int32))

    def compact(a):
        if a.ndim == 0:
            return a
        out = torch.zeros((c_dev + 1,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        k = keep.reshape(keep.shape + (1,) * (a.ndim - 1))
        out[tgt] = torch.where(k, a, torch.zeros((), dtype=a.dtype, device=dev))
        return out[:c_dev]

    new_local = FluidState(**{k: compact(getattr(new_w, k)) for k in FIELDS})
    counts = comm.psum(torch.stack([
        kept.to(torch.int64), (ov_l + ov_r + torch.clamp(kept - c_dev, min=0)).to(torch.int64),
        torch.sum(relay).to(torch.int64)]))
    new_local = new_local.replace(n=counts[0].to(torch.int32), time=new_w.time,
                                  step_number=new_w.step_number)
    diag["shard_overflow"] = counts[1]
    diag["relay_count"] = counts[2]
    # adaptivity can coarsen particles until their radius outgrows the halo
    diag["halo_h_max"] = comm.pmax(torch.max(torch.where(keep, new_w.h,
                                                         torch.zeros_like(new_w.h))))
    return new_local, diag


def _pack_rows(state: FluidState):
    """Every per-particle field of `state` as one (C, K) int32 matrix
    (float32 bit patterns, bools and ints as values) and the layout."""
    cols, layout = [], []
    for k in FIELDS:
        a = getattr(state, k)
        if a.ndim == 0:
            continue
        a2 = a[:, None] if a.ndim == 1 else a
        if a2.dtype == torch.float32:
            a2 = a2.contiguous().view(torch.int32)
        else:
            a2 = a2.to(torch.int32)
        layout.append((k, a.ndim, a2.shape[1], a.dtype))
        cols.append(a2)
    return torch.cat(cols, dim=1), layout


def _unpack_rows(mat: np.ndarray, layout) -> dict:
    out, c = {}, 0
    for k, ndim, w, dtype in layout:
        v = mat[:, c:c + w]
        c += w
        if dtype == torch.float32:
            v = v.view(np.float32)
        elif dtype == torch.bool:
            v = v != 0
        v = np.ascontiguousarray(v)
        out[k] = v[:, 0] if ndim == 1 else v
    return out


def gather_blocked(local: FluidState, comm: SlabComm) -> dict:
    """Every rank's rows in rank order as slab-blocked numpy arrays (ndev *
    c_dev rows, the reference's global layout), on every rank; the scalars
    (equal on every rank) from this rank's state."""
    mat, layout = _pack_rows(local)
    parts = [p.cpu().numpy() for p in comm.all_gather(mat)]
    out = _unpack_rows(np.concatenate(parts, axis=0), layout)
    for k in FIELDS:
        a = getattr(local, k)
        if a.ndim == 0:
            out[k] = a.cpu().numpy()
    return out


class SlabSimulation:
    """One rank's driver of the slab-decomposed step, with the reference's
    discard-reshard-retry: a step whose diagnostics report a strip or slab
    overflow, a row or level overflow, or a halo outgrown by coarsened
    particles is discarded (the carried state never advanced); the ranks
    all-gather the rows, recompute the same edges and capacities
    (`make_slab_config`, 1.5x the headroom after an overflow, up to 16),
    reshard and retry, at most 3 times.

    state: the global initial state (a FluidState or numpy arrays), the same
    on every rank; scfg: a given decomposition of it (else computed)."""

    def __init__(self, params: SimulationParams, gcfg: GridConfig, boundary_handler, state,
                 comm: SlabComm, tq: int = 16, split_patterns=None, scfg: SlabConfig = None):
        self.params = params
        self.gcfg = gcfg
        self.boundary_handler = boundary_handler
        self.comm = comm
        self.tq = tq
        self.split_patterns = split_patterns
        self.n_reshards = 0
        self.headroom = 2.0
        host = _host(state)
        self.scfg = scfg if scfg is not None else make_slab_config(
            params, gcfg, host, comm.world, tq=tq)
        if self.scfg.ndev != comm.world:
            raise ValueError(f"a decomposition into {self.scfg.ndev} slabs on {comm.world} ranks")
        self.local = local_state(shard_spatially(host, self.scfg), self.scfg, comm.rank,
                                 comm.device)
        self.step_number = int(np.asarray(host["step_number"]))

    @property
    def time(self) -> float:
        return float(self.local.time)

    def gather(self) -> dict:
        """The global state as slab-blocked numpy arrays (every rank)."""
        return gather_blocked(self.local, self.comm)

    def reshard(self):
        """Recompute edges and capacities from the current state and reshard."""
        blocked = self.gather()
        self.scfg = make_slab_config(self.params, self.gcfg, blocked, self.comm.world,
                                     tq=self.tq, headroom=self.headroom)
        self.local = local_state(shard_spatially(blocked, self.scfg), self.scfg,
                                 self.comm.rank, self.comm.device)
        self.n_reshards += 1

    def step(self, _retries: int = 3) -> dict:
        new_local, diag = slab_step(self.local, self.params, self.scfg, self.comm,
                                    self.boundary_handler, self.step_number + 1,
                                    self.split_patterns)
        d = _read_diag(diag)  # every value the decision reads is reduced over the ranks
        halo_ok = d["halo_h_max"] * float(max_scale(self.params)) <= self.scfg.halo_w
        ro, co, lo = d["neighbor_overflow"]
        wo = d.get("wcache_overflow", 0)
        blown = d["shard_overflow"] > 0 or ro > 0 or co > 0 or wo > 0
        if blown or not halo_ok or lo > 0:
            if _retries <= 0:
                raise RuntimeError(f"slab step failed after reshards: shard_overflow="
                                   f"{d['shard_overflow']} rows={ro} cells={co} levels={lo} "
                                   f"wcache={wo} halo_ok={halo_ok}")
            if blown:
                self.headroom = min(self.headroom * 1.5, 16.0)
            self.reshard()
            return self.step(_retries=_retries - 1)
        self.local = new_local
        self.step_number += 1
        return d
