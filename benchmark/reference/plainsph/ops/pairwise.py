"""Symmetric pair sums and maxima over the list backend's forward rows.

Counterpart of adaptive_sph_tpu/ops/pairwise.py. Each sweep gathers the
(C, K) forward rows, reduces them row by row, and adds the reversed
contribution of every cross-level edge to its larger particle. The reversed
side is a segmented reduction over the edges sorted by target
(`Neighborhood.bwd_perm`): `torch.segment_reduce` sums each target's edges in
their sorted order, so the result does not depend on a scatter's order and a
second run is bit-identical (an atomic `index_add_` on the card would not
be).

Values are a tensor or a dict of tensors (the reference's pytrees); edge
functions take the dicts of both endpoints, (C, 1, ...) for the row particle
and (C, K, ...) for the neighbour.
"""

from __future__ import annotations

import torch

from .neighbors import Neighborhood


def tree_map(fn, *trees):
    """fn over the leaves of a tensor or a dict of tensors."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def gather(values, nb: Neighborhood):
    """A tree of (C, ...) tensors gathered to (C, K, ...) along the rows."""
    return tree_map(lambda a: a[nb.idx], values)


def _expand_i(values):
    return tree_map(lambda a: a[:, None] if a.ndim == 1 else a[:, None, :], values)


def _masked(m, e, fill=0.0):
    m = m.reshape(m.shape + (1,) * (e.ndim - m.ndim))
    return torch.where(m, e, torch.full_like(e, fill))


def segment_reduce(nb: Neighborhood, e, reduce: str = "sum", fill: float = 0.0):
    """The cross edges' values of e (C, K, ...) reduced into their targets
    (C, ...): a sum, or a maximum at least `fill`."""
    C, K = nb.idx.shape
    e = e.expand((C, K) + tuple(e.shape[2:])) if e.shape[:2] != (C, K) else e
    flat = e.reshape((C * K,) + tuple(e.shape[2:]))
    out_shape = (C,) + tuple(e.shape[2:])
    if nb.n_cross == 0:
        return torch.full(out_shape, fill, dtype=e.dtype, device=e.device)
    permuted = flat[nb.bwd_perm[:nb.n_cross]]
    if reduce == "sum":
        return torch.segment_reduce(permuted, "sum", lengths=nb.bwd_len, axis=0, unsafe=True)
    return torch.segment_reduce(permuted, "max", lengths=nb.bwd_len, axis=0, unsafe=True,
                                initial=fill)


def reduce_edges(nb: Neighborhood, fwd, bwd):
    """Masked row sums of the forward contributions (to the row particle)
    plus the reversed ones summed into the cross edges' targets; fwd / bwd
    are trees of (C, K, ...) contributions, bwd the same edge seen from its
    neighbour."""
    total = tree_map(lambda e: torch.sum(_masked(nb.mask, e), dim=1), fwd)
    scattered = tree_map(lambda e: segment_reduce(nb, e), bwd)
    return tree_map(lambda t, s: t + s, total, scattered)


def sym_sum(nb: Neighborhood, values, edge_fn):
    """Symmetric neighbour sum, self edge included: edge_fn(vi, vj) gives
    the contribution (tree of (C, K, ...)) of each edge to its first
    argument's particle; it must be finite on the self edge."""
    vj = gather(values, nb)
    vi = _expand_i(values)
    return reduce_edges(nb, edge_fn(vi, vj), edge_fn(vj, vi))


def sym_max(nb: Neighborhood, values, edge_fn, fill: float):
    """Symmetric neighbour maximum of a scalar edge quantity; masked slots
    count as `fill`."""
    vj = gather(values, nb)
    vi = _expand_i(values)
    total = torch.max(_masked(nb.mask, edge_fn(vi, vj), fill), dim=1).values
    return torch.maximum(total, segment_reduce(nb, edge_fn(vj, vi), "max", fill))
