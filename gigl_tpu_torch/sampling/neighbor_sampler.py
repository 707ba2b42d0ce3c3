"""On-device layerwise neighbor sampling over CSR -> dense fanout blocks.

Port of ``gigl_tpu/sampling/neighbor_sampler.py``. For each frontier node,
``fanout`` neighbor slots are drawn from the CSR adjacency with a
counter-based hash keyed by (seed, node, hop, slot). The uniform method:
nodes with degree <= fanout take all their neighbors in slot order, larger
degrees sample with replacement. The weighted and top-k methods score the
node's first ``weight_window`` CSR slots by their edge weights (plus Gumbel
noise from the same hash for ``weighted``) and take the ``fanout`` best.
Every draw is bit-equal to the reference.

Kernel K1 ``sample_uniform`` (``csrc/sample_uniform.cu``) replaces
``counter_rng_uniform`` + ``uniform_offsets`` + ``sample_neighbors``: one
CUDA thread per (node, slot). :func:`_sample_uniform_plain` is its plain
PyTorch twin, used for CPU tensors only; its row-offset mode is the
owner-side draw of the partitioned graph's routed sampling
(``parallel/feature_lookup.py``). Kernel K1b ``uniform_ids`` (the
same source) is the batch-shared random-negative draw of
``sample_nalp_batch``, with :func:`_uniform_ids_plain` as its twin.

Kernel K19 ``sample_weighted`` (``csrc/sample_weighted.cu``) replaces
``weighted_offsets`` + ``sample_neighbors`` for ``weighted`` / ``top_k``:
one warp per frontier node, the window's keys in registers, ``fanout``
rounds of a warp arg-max (ties to the lower slot, as ``lax.top_k``); it
has K1's row-offset mode. :func:`_sample_weighted_plain` is its twin
(:func:`weighted_offsets` in float32 and a stable descending sort). The
hash runs in the twins in int64
masked to 32 bits (PyTorch's CPU ``uint32`` lacks ``>>`` and ``%``), with
each multiply split into 16-bit halves so nothing relies on signed
overflow.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from gigl_tpu_torch.graph.csr import CSR
from gigl_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32-style integer finalizer on uint32 values held in int64."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_rng_uniform(
    node_ids: torch.Tensor, seed: int, hop: int, num_slots: int
) -> torch.Tensor:
    """Deterministic uniform uint32 per (seed, node, hop, slot), as int64
    values in [0, 2**32): [..., num_slots]. Seeds and hops wrap mod 2**32."""
    nodes = node_ids.to(torch.int64) & _M32
    const = ((int(seed) & _M32) * 0x85EBCA6B
             + (int(hop) & _M32) * 0xC2B2AE35) & _M32
    base = (_mul32(nodes, 0x9E3779B9) + const) & _M32
    slots = torch.arange(num_slots, dtype=torch.int64, device=node_ids.device)
    return _mix32(base[..., None] ^ _mix32(slots + 0x27220A95))


def uniform_offsets(
    deg: torch.Tensor, node_ids: torch.Tensor, seed: int, hop: int,
    fanout: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node CSR slice offsets [..., fanout] int32 and validity mask."""
    deg = deg.to(torch.int64)
    slot_iota = torch.arange(fanout, dtype=torch.int64, device=deg.device)
    bits = counter_rng_uniform(node_ids, seed, hop, fanout)
    rand_off = bits % deg.clamp(min=1)[..., None]
    take_all = (deg <= fanout)[..., None]
    offsets = torch.where(
        take_all,
        torch.minimum(slot_iota, (deg - 1).clamp(min=0)[..., None]),
        rand_off)
    mask = torch.where(take_all, slot_iota < deg[..., None],
                       (deg > 0)[..., None])
    return offsets.to(torch.int32), mask


WEIGHTED_METHODS = {"weighted": 1, "top_k": 2}   # K19's method codes
MAX_WEIGHT_WINDOW = 1024     # K19 holds the window in registers (32 a lane)
_F32_MIN = torch.finfo(torch.float32).min


def weighted_scores(logw: torch.Tensor, bits: torch.Tensor,
                    valid: torch.Tensor, method: str) -> torch.Tensor:
    """weighted_offsets' window scores in float32: ``logw`` for
    ``top_k``; for ``weighted`` ``logw - log(-log(u))`` with ``u =
    (float32(bits) + 0.5) / 2**32`` (``bits`` int64 in [0, 2**32); bits >=
    2**32 - 128 round u to 1.0 and score +inf); invalid slots score
    finfo(float32).min."""
    if method == "top_k":
        return torch.where(valid, logw, _F32_MIN)
    if method != "weighted":
        raise ValueError(f"Unknown weighted method {method!r}")
    u = (bits.to(torch.float32) + 0.5) / 4294967296.0
    return torch.where(valid, logw - torch.log(-torch.log(u)), _F32_MIN)


def window_scores(
    edge_weights: torch.Tensor, start: torch.Tensor, deg: torch.Tensor,
    node_ids: torch.Tensor, seed: int, hop: int, method: str,
    window: int = 128,
) -> torch.Tensor:
    """The [..., window] float32 scores of each node's first ``window`` CSR
    slots: slot j reads ``edge_weights[clip(start + min(j, deg - 1), 0,
    len - 1)]`` (see :func:`weighted_scores`)."""
    deg = deg.to(torch.int64)
    win = torch.arange(int(window), dtype=torch.int64, device=deg.device)
    valid = win < deg[..., None]
    slots = start.to(torch.int64)[..., None] + torch.minimum(
        win, (deg - 1).clamp(min=0)[..., None])
    w = edge_weights[slots.clamp(0, edge_weights.shape[0] - 1)]
    logw = torch.log(torch.clamp(w.to(torch.float32), min=1e-30))
    bits = (counter_rng_uniform(node_ids, seed, hop, int(window))
            if method == "weighted" else None)
    return weighted_scores(logw, bits, valid, method)


def weighted_offsets(
    edge_weights: torch.Tensor, start: torch.Tensor, deg: torch.Tensor,
    node_ids: torch.Tensor, seed: int, hop: int, fanout: int, method: str,
    window: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted / top-k draw over each node's first ``window`` CSR slots
    (rows need not be sorted): per-node offsets [..., fanout] int32 and the
    validity mask. The ``fanout`` best :func:`window_scores` are taken in
    descending order with ties to the lower slot, as ``lax.top_k`` orders
    them (a slot whose weight is NaN ranks last)."""
    if not 0 < int(fanout) <= int(window):
        raise ValueError(f"fanout {fanout} must lie in [1, window {window}]")
    deg = deg.to(torch.int64)
    scores = window_scores(edge_weights, start, deg, node_ids, seed, hop,
                           method, window)
    # lax.top_k orders by the floats' total order, and the reference's CPU
    # log turns any NaN weight into a NEGATIVE NaN (0xFFFFFFFF): such a
    # slot ranks below every other one, invalid slots included. No other
    # score can be -inf (log-weights are >= log(1e-30)), so NaN -> -inf
    # and a stable descending sort order the window as lax.top_k does.
    scores = torch.where(torch.isnan(scores), float("-inf"), scores)
    top = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[..., :int(fanout)]
    offsets = torch.minimum(top, (deg - 1).clamp(min=0)[..., None])
    slot_iota = torch.arange(int(fanout), dtype=torch.int64,
                             device=deg.device)
    mask = slot_iota < deg.clamp(max=int(fanout))[..., None]
    return offsets.to(torch.int32), mask


@dataclass
class DeviceCSR:
    """CSR adjacency resident on a device (int32 ``indptr`` / ``indices``),
    with optional per-slot fp32 ``edge_weights`` for the weighted and
    top-k draws."""

    indptr: torch.Tensor  # [N+1] int32
    indices: torch.Tensor  # [E] int32
    edge_weights: Optional[torch.Tensor] = None  # [E] f32

    @classmethod
    def from_csr(cls, csr: CSR, device: torch.device,
                 edge_weights=None) -> "DeviceCSR":
        def put(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int32)

        weights = None
        if edge_weights is not None:
            weights = torch.as_tensor(edge_weights).to(
                device=device, dtype=torch.float32).contiguous()
        return cls(indptr=put(csr.indptr), indices=put(csr.indices),
                   edge_weights=weights)

    @property
    def num_anchor_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def _sample_uniform_plain(
    indptr: torch.Tensor, indices: torch.Tensor, frontier: torch.Tensor,
    fanout: int, seed: int, hop: int, row_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K1 (sample_neighbors, method="uniform"; with
    ``row_offset``, the owner-side draw of routed_sample_neighbors)."""
    f = frontier.to(torch.int64)
    if row_offset is not None:
        f = (f - int(row_offset)).clamp(0, indptr.shape[0] - 2)
    start = indptr[f].to(torch.int64)
    deg = indptr[f + 1].to(torch.int64) - start
    offsets, mask = uniform_offsets(deg, frontier, seed, hop, fanout)
    edge_slots = (start[..., None] + offsets).clamp(0, indices.shape[0] - 1)
    nbr = torch.where(mask, indices[edge_slots], 0).to(torch.int32)
    return nbr, mask, edge_slots.to(torch.int32)


def sample_uniform(
    indptr: torch.Tensor, indices: torch.Tensor, frontier: torch.Tensor,
    fanout: int, seed: int, hop: int, row_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: ``fanout`` uniform draws per frontier node ([...] int32).

    Returns (neighbor ids [..., fanout] int32, mask bool, CSR edge slots
    int32). Frontier ids must lie in [0, N). With ``row_offset`` (the
    row-offset mode) the CSR is one shard's row block: a frontier holds
    global ids, node v reads local row clip(v - row_offset, 0, rows - 1)
    and its draw stays keyed by v. CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if frontier.device.type == "cpu":
        return _sample_uniform_plain(indptr, indices, frontier, fanout,
                                     seed, hop, row_offset)
    flat = frontier.reshape(-1).contiguous()
    device = _build.require_cuda("sample_uniform", flat, indptr, indices)
    for t in (indptr, indices, flat):
        if t.dtype != torch.int32:
            raise ValueError(f"sample_uniform: expected int32, got {t.dtype}")
    m = flat.shape[0]
    ids = torch.empty((m, fanout), dtype=torch.int32, device=flat.device)
    mask = torch.empty((m, fanout), dtype=torch.bool, device=flat.device)
    slots = torch.empty((m, fanout), dtype=torch.int32, device=flat.device)
    _build.launch(
        "sample_uniform", "gigl_sample_uniform", device,
        indptr.data_ptr(), indices.data_ptr(), indices.shape[0],
        flat.data_ptr(), m, int(fanout), int(seed) & _M32, int(hop) & _M32,
        int(row_offset is not None), int(row_offset or 0),
        indptr.shape[0] - 1, ids.data_ptr(), mask.data_ptr(),
        slots.data_ptr())
    shape = tuple(frontier.shape) + (fanout,)
    return ids.reshape(shape), mask.reshape(shape), slots.reshape(shape)


def _sample_weighted_plain(
    indptr: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor,
    frontier: torch.Tensor, fanout: int, window: int, method: str,
    seed: int, hop: int, row_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K19 (sample_neighbors, method="weighted" /
    "top_k"; with ``row_offset``, the owner-side weighted draw)."""
    f = frontier.to(torch.int64)
    if row_offset is not None:
        f = (f - int(row_offset)).clamp(0, indptr.shape[0] - 2)
    start = indptr[f].to(torch.int64)
    deg = indptr[f + 1].to(torch.int64) - start
    offsets, mask = weighted_offsets(weights, start, deg, frontier, seed,
                                     hop, fanout, method, window)
    edge_slots = (start[..., None] + offsets).clamp(0, indices.shape[0] - 1)
    nbr = torch.where(mask, indices[edge_slots], 0).to(torch.int32)
    return nbr, mask, edge_slots.to(torch.int32)


def sample_weighted(
    indptr: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor,
    frontier: torch.Tensor, fanout: int, window: int, method: str,
    seed: int, hop: int, row_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K19: ``fanout`` weighted (Gumbel top-k) or top-k draws per frontier
    node ([...] int32) over its first ``window`` CSR slots, ``weights``
    [E] fp32 in slot order.

    Returns (neighbor ids [..., fanout] int32, mask bool, CSR edge slots
    int32), as K1. ``row_offset`` is K1's row-offset mode. CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if method not in WEIGHTED_METHODS:
        raise ValueError(f"Unknown weighted method {method!r}")
    if not 0 < int(fanout) <= int(window):
        raise ValueError(f"sample_weighted: fanout {fanout} must lie in "
                         f"[1, window {window}]")
    if frontier.device.type == "cpu":
        return _sample_weighted_plain(indptr, indices, weights, frontier,
                                      int(fanout), int(window), method,
                                      seed, hop, row_offset)
    if int(window) > MAX_WEIGHT_WINDOW:
        raise ValueError(f"sample_weighted: window {window} exceeds the "
                         f"kernel's {MAX_WEIGHT_WINDOW}")
    flat = frontier.reshape(-1).contiguous()
    device = _build.require_cuda("sample_weighted", flat, indptr, indices,
                                 weights)
    for t in (indptr, indices, flat):
        if t.dtype != torch.int32:
            raise ValueError(f"sample_weighted: expected int32, got {t.dtype}")
    if weights.dtype != torch.float32:
        raise ValueError("sample_weighted: weights must be f32")
    m = flat.shape[0]
    ids = torch.empty((m, fanout), dtype=torch.int32, device=flat.device)
    mask = torch.empty((m, fanout), dtype=torch.bool, device=flat.device)
    slots = torch.empty((m, fanout), dtype=torch.int32, device=flat.device)
    _build.launch(
        "sample_weighted", "gigl_sample_weighted", device,
        indptr.data_ptr(), indices.data_ptr(), indices.shape[0],
        weights.data_ptr(), weights.shape[0], flat.data_ptr(), m,
        int(fanout), int(window), WEIGHTED_METHODS[method],
        int(seed) & _M32, int(hop) & _M32, int(row_offset is not None),
        int(row_offset or 0), indptr.shape[0] - 1, ids.data_ptr(),
        mask.data_ptr(), slots.data_ptr())
    shape = tuple(frontier.shape) + (int(fanout),)
    return ids.reshape(shape), mask.reshape(shape), slots.reshape(shape)


def _uniform_ids_plain(count: int, seed: int, hop: int, num_nodes: int,
                       device: torch.device) -> torch.Tensor:
    """Plain PyTorch twin of K1b: the batch-shared random-negative draw of
    ``sample_nalp_batch`` (counter_rng_uniform of ids 0..count-1, slot 0,
    mod num_nodes)."""
    ids = torch.arange(count, dtype=torch.int64, device=device)
    bits = counter_rng_uniform(ids, seed, hop, 1)[:, 0]
    return (bits % int(num_nodes)).to(torch.int32)


def uniform_ids(count: int, seed: int, hop: int, num_nodes: int,
                device: torch.device) -> torch.Tensor:
    """K1b: ``count`` uniform node ids in [0, num_nodes), int32, one per
    counter i = 0..count-1 (hash(i, seed, hop, slot 0) % num_nodes). On
    the CPU the plain version runs; on a CUDA device the kernel launches
    (or raises), as a dependent launch that hashes while the kernel ahead
    of it on the stream finishes; a count of 0 launches nothing."""
    device = torch.device(device)
    if device.type == "cpu":
        return _uniform_ids_plain(count, seed, hop, num_nodes, device)
    if device.type != "cuda":
        raise ValueError(f"uniform_ids: unsupported device {device}")
    if not 0 < int(num_nodes) <= _M32:
        raise ValueError(f"uniform_ids: num_nodes {num_nodes} out of range")
    out = torch.empty((int(count),), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    _build.launch("uniform_ids", "gigl_uniform_ids", out.device, int(count),
                  int(seed) & _M32, int(hop) & _M32, int(num_nodes),
                  out.data_ptr())
    return out


def sample_neighbors(
    csr: DeviceCSR,
    frontier: torch.Tensor,
    fanout: int,
    *,
    seed: int,
    hop: int,
    method: str = "uniform",
    weight_window: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample ``fanout`` neighbor slots for each frontier node: uniform
    (K1), or weighted / top-k over the node's first ``weight_window`` CSR
    slots (K19; needs ``csr.edge_weights``).

    Returns (neighbor_ids [..., fanout], mask [..., fanout], edge_slots);
    padded slots point at the node's first slot and are masked out."""
    if method == "uniform":
        return sample_uniform(csr.indptr, csr.indices, frontier, int(fanout),
                              seed, hop)
    if method not in WEIGHTED_METHODS:
        raise ValueError(f"Unknown sampling method {method!r}")
    if csr.edge_weights is None:
        raise ValueError(f"method={method!r} requires edge_weights")
    return sample_weighted(csr.indptr, csr.indices, csr.edge_weights,
                           frontier, int(fanout), int(weight_window), method,
                           seed, hop)


@dataclass
class SampledBlocks:
    """A k-hop sampled neighborhood tree with static shapes.

    node_ids[0] = roots [B]; node_ids[l] = [B, K1, ..., Kl]; masks[l] marks
    valid slots (a slot is valid only if its parent was); edge_slots[l]
    indexes the CSR adjacency rows used (None for roots and table hops).
    """

    node_ids: List[torch.Tensor]
    masks: List[torch.Tensor]
    edge_slots: List[Optional[torch.Tensor]]


def sample_blocks(
    csr: DeviceCSR,
    roots: torch.Tensor,
    fanouts: Sequence[int],
    *,
    seed: int = 0,
    method: str = "uniform",
) -> SampledBlocks:
    """Layerwise-sample a fanout tree from ``roots`` ([B] int32)."""
    node_ids = [roots.to(torch.int32)]
    masks = [torch.ones(roots.shape, dtype=torch.bool, device=roots.device)]
    edge_slots: List[Optional[torch.Tensor]] = [None]
    frontier, parent_mask = node_ids[0], masks[0]
    for hop, k in enumerate(fanouts, start=1):
        nbr, m, es = sample_neighbors(csr, frontier, int(k), seed=seed,
                                      hop=hop, method=method)
        m = m & parent_mask[..., None]
        nbr = torch.where(m, nbr, 0)
        node_ids.append(nbr)
        masks.append(m)
        edge_slots.append(es)
        frontier, parent_mask = nbr, m
    return SampledBlocks(node_ids=node_ids, masks=masks, edge_slots=edge_slots)
