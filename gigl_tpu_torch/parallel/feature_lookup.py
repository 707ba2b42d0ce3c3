"""Routed per-id lookups across a range-sharded table or graph (port of
``gigl_tpu/parallel/feature_lookup.py``: ``request_capacity``,
``_route_requests``, ``_unroute``, ``routed_gather`` and
``routed_sample_neighbors``, uniform, weighted and top-k, with the drawn
edges' label-edge rows).

The table (feature rows, or per-node CSR adjacency) is range-partitioned
over the shards of a :class:`~gigl_tpu_torch.parallel.mesh.Mesh`: global
row r lives on shard r // rows at local row r % rows. A lookup of arbitrary
global ids is one all_to_all round trip:

  1. bucket each shard's requested ids by owner shard (K15),
  2. ``all_to_all`` the request buckets (each shard receives the ids it
     owns),
  3. answer locally: a row gather (K3) or the owner-side neighbor draw
     (K1, or K19 for weighted / top-k draws over the shard's edge weights,
     in their row-offset mode, keyed by the global id),
  4. ``all_to_all`` the answers back and read each request's row at its
     bucket coordinates (K16). A draw with ``local_edge_feats`` also
     answers each drawn edge's feature row (K3 over the draw's CSR slots)
     and sends the [P, C, fanout, De] rows back the same way.

Steps 1–2 are :func:`send_requests` and step 4 :func:`receive_answers`, so
that a caller can answer step 3 off the card (the streamed-partitioned
tier's host gather).

Shapes are static: each shard sends at most ``capacity`` requests to each
peer; requests beyond it are dropped (``ok`` False, rows zero-filled), the
analog of an RPC timeout that the trainers count as overflow.

Kernels (``csrc/route.cu``): K15 ``route_requests`` (the counting-sort
bucketing, bit-equal to :func:`_route_requests_plain`) and K16
``unroute_rows`` (bit-equal to :func:`_unroute_plain`); the twins run for
CPU tensors only. A quantized partitioned graph's bit-packed int8 rows
(``ops/quantized.py``) route with ``routed_gather(decode=(D, Dc))``: the
owner side gathers the packed rows (K3, its byte mode at widths that are
not a multiple of 4), and K16's int8 mode (:func:`unroute_rows_q8`)
decodes each answer into fp32 features, cache and degree in the unroute
pass; one shard gathers and decodes with K12's packed-row mode. The functions take the mesh and every shard's tensors
as per-shard lists (entry p is shard p's), since a routed lookup needs
every shard's requests at once; the answering side takes its ``shard``
index explicitly.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.gather import gather_rows
from gigl_tpu_torch.ops.quantized import (
    decode_packed_rows,
    gather_packed_rows_q8,
    packed_row_bytes,
)
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.sampling.neighbor_sampler import (
    sample_uniform,
    sample_weighted,
)

MAX_SHARDS = 32  # K15 keeps its counts per owner shard for 32 owners


def request_capacity(num_requests: int, num_shards: int,
                     factor: float = 2.0) -> int:
    """Per-(src, dst) shard bucket capacity: factor x the balanced load,
    rounded up to a multiple of 8."""
    base = int(math.ceil(num_requests / max(num_shards, 1) * factor))
    return max(8, ((base + 7) // 8) * 8)


def _route_requests_plain(ids: torch.Tensor, rows: int, num_shards: int,
                          capacity: int):
    """Plain twin of K15, the reference's one-hot cumsum for each request
    vector: ids [G] or [S, G] int32 -> (req [P, C] or [S, P, C] int32;
    owner, pos int32 and ok bool, shaped as ids)."""
    lead = tuple(ids.shape[:-1])
    s = math.prod(lead)
    flat = ids.reshape(s, ids.shape[-1])
    owner = torch.div(flat.to(torch.int64), int(rows),
                      rounding_mode="floor").clamp(0, num_shards - 1)
    onehot = owner[..., None] == torch.arange(num_shards, device=ids.device)
    counts = torch.cumsum(onehot.to(torch.int32), dim=1)
    pos = counts.gather(2, owner[..., None])[..., 0] - 1
    ok = pos < capacity
    # (owner, pos) is distinct for every kept request; dropped ones write
    # to one spare cell past the vector's table (no host sync: the twin is
    # timed in CUDA graphs too)
    cells = torch.where(ok, owner * capacity + pos, num_shards * capacity)
    req = torch.zeros((s, num_shards * capacity + 1), dtype=torch.int32,
                      device=ids.device)
    req.scatter_(1, cells, flat.to(torch.int32))
    return (req[:, :-1].reshape(lead + (num_shards, capacity)),
            *(t_.reshape(ids.shape) for t_ in (
                owner.to(torch.int32), pos.to(torch.int32), ok)))


def route_requests(ids: torch.Tensor, rows: int, num_shards: int,
                   capacity: int):
    """K15: bucket each request vector by owner shard clip(id // rows, 0,
    P - 1), first come first served. ``ids`` is one vector [G] or S of them
    [S, G] (int32), all bucketed in one call. Returns (req [P, C] int32,
    zero where unused; owner, pos int32 and ok = pos < C bool, [G]), with a
    leading S for [S, G]. CPU tensors take the plain twin."""
    if ids.device.type == "cpu":
        return _route_requests_plain(ids, rows, num_shards, capacity)
    ids = ids.contiguous()
    device = _build.require_cuda("route_requests", ids)
    if ids.dtype != torch.int32 or ids.dim() not in (1, 2):
        raise ValueError("route_requests: ids must be int32 [G] or [S, G]")
    if not 1 <= num_shards <= MAX_SHARDS:
        raise ValueError(f"route_requests: {num_shards} shards; K15 takes "
                         f"1 to {MAX_SHARDS}")
    if rows < 1 or capacity < 1:
        raise ValueError("route_requests: rows and capacity must be >= 1")
    s, g = (1,) + tuple(ids.shape) if ids.dim() == 1 else tuple(ids.shape)
    lead = tuple(ids.shape[:-1])
    req = torch.empty(lead + (num_shards, capacity), dtype=torch.int32,
                      device=device)
    owner = torch.empty(ids.shape, dtype=torch.int32, device=device)
    pos = torch.empty(ids.shape, dtype=torch.int32, device=device)
    ok = torch.empty(ids.shape, dtype=torch.bool, device=device)
    tiles = _build.library().gigl_route_tiles(g)
    scratch = torch.empty((s * tiles * num_shards,), dtype=torch.int32,
                          device=device)
    if s:
        _build.launch("route_requests", "gigl_route_requests", device,
                      ids.data_ptr(), s, g, int(rows), int(num_shards),
                      int(capacity), req.data_ptr(), owner.data_ptr(),
                      pos.data_ptr(), ok.data_ptr(), scratch.data_ptr())
    return req, owner, pos, ok


def _unroute_plain(back: torch.Tensor, owner: torch.Tensor,
                   pos: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Plain twin of K16: back[owner, min(pos, C - 1)], zero where not
    ``ok``."""
    out = back[owner.to(torch.int64),
               pos.clamp(max=back.shape[1] - 1).to(torch.int64)]
    keep = ok.reshape(ok.shape + (1,) * (out.dim() - 1))
    return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def unroute_rows(back: torch.Tensor, owner: torch.Tensor, pos: torch.Tensor,
                 ok: torch.Tensor) -> torch.Tensor:
    """K16: each request's answer row ``back[owner, min(pos, C - 1)]``
    ([P, C, ...] answers of a 2- or 4-byte type) in request order, zero
    where the request overflowed. CPU tensors take the plain twin."""
    if back.device.type == "cpu":
        return _unroute_plain(back, owner, pos, ok)
    back = back.contiguous()
    device = _build.require_cuda("unroute_rows", back, owner, pos, ok)
    g = owner.shape[0]
    if (owner.dtype != torch.int32 or pos.dtype != torch.int32
            or ok.dtype != torch.bool or pos.shape != (g,)
            or ok.shape != (g,) or back.dim() < 2):
        raise ValueError("unroute_rows: back [P, C, ...]; owner, pos int32 "
                         "and ok bool, all [G]")
    esize = back.element_size()
    if esize not in (2, 4):
        raise ValueError(f"unroute_rows: {back.dtype} rows not supported "
                         "(2- or 4-byte types)")
    tail = tuple(back.shape[2:])
    row_bytes = math.prod(tail) * esize
    out = torch.empty((g,) + tail, dtype=back.dtype, device=device)
    word = 16 if row_bytes % 16 == 0 and back.data_ptr() % 16 == 0 else (
        4 if row_bytes % 4 == 0 else 2)
    _build.launch("unroute_rows", "gigl_unroute_rows", device,
                  back.data_ptr(), back.shape[1], row_bytes, word,
                  owner.data_ptr(), pos.data_ptr(), ok.data_ptr(), g,
                  out.data_ptr())
    return out


def _unroute_q8_plain(back: torch.Tensor, owner: torch.Tensor,
                      pos: torch.Tensor, ok: torch.Tensor, feat_dim: int,
                      cache_dim: int = 0):
    """Plain twin of K16's int8 mode: :func:`_unroute_plain`, then
    ``decode_packed_rows`` (a dropped request's zero row decodes to 0)."""
    return decode_packed_rows(_unroute_plain(back, owner, pos, ok), feat_dim,
                              cache_dim)


def unroute_rows_q8(back: torch.Tensor, owner: torch.Tensor,
                    pos: torch.Tensor, ok: torch.Tensor, feat_dim: int,
                    cache_dim: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """K16's int8 mode: each request's bit-packed int8 answer row
    ``back[owner, min(pos, C - 1)]`` ([P, C, W], W = D + 8 or D + Dc + 12)
    decoded in the same pass -> (features [G, D], degrees [G], cache [G,
    Dc] or None), fp32, zero where the request overflowed; the packed [G,
    W] rows are never written. CPU tensors take the plain twin."""
    if back.device.type == "cpu":
        return _unroute_q8_plain(back, owner, pos, ok, feat_dim, cache_dim)
    back = back.contiguous()
    device = _build.require_cuda("unroute_rows", back, owner, pos, ok)
    d, dc = int(feat_dim), int(cache_dim)
    g = owner.shape[0]
    if (back.dtype != torch.int8 or back.dim() != 3
            or back.shape[2] != packed_row_bytes(d, dc) or d < 1
            or owner.dtype != torch.int32 or pos.dtype != torch.int32
            or ok.dtype != torch.bool or pos.shape != (g,)
            or ok.shape != (g,)):
        raise ValueError(f"unroute_rows_q8: back int8 [P, C, "
                         f"{packed_row_bytes(d, dc)}]; owner, pos int32 and "
                         "ok bool, all [G]")
    feats = torch.empty((g, d), dtype=torch.float32, device=device)
    degs = torch.empty((g,), dtype=torch.float32, device=device)
    cache = (torch.empty((g, dc), dtype=torch.float32, device=device)
             if dc else None)
    _build.launch("unroute_rows", "gigl_unroute_rows_q8", device,
                  back.data_ptr(), back.shape[1], back.shape[2], d, dc,
                  owner.data_ptr(), pos.data_ptr(), ok.data_ptr(), g,
                  feats.data_ptr(), _build.ptr(cache), degs.data_ptr())
    _build.launches["unroute_rows_q8"] += 1
    return feats, degs, cache


def _capacity(g: int, num_shards: int, capacity: Optional[int],
              factor: float) -> int:
    if capacity is None:
        capacity = request_capacity(g, num_shards, factor)
    return min(capacity, g) if g > 0 else capacity


def send_requests(mesh: Mesh, global_ids: Sequence[torch.Tensor],
                  rows: int, capacity: int):
    """The front half of a routed lookup: every shard's [G] requests
    bucketed by owner (K15, one call for the [P, G] stack of them, ``capacity``
    slots a bucket as given) and exchanged by the request all_to_all.
    Returns (recv [P, C] per shard — the ids each shard owns and was asked
    for, zero in unused slots —, and each shard's (owner, pos, ok))."""
    req, owner, pos, ok = route_requests(
        torch.stack([ids.to(torch.int32) for ids in global_ids]), rows,
        mesh.num_shards, capacity)
    recv = mesh.all_to_all(list(req))
    return recv, list(zip(owner, pos, ok))


def receive_answers(mesh: Mesh, answers: Sequence[torch.Tensor], coords,
                    decode: Optional[Tuple[int, int]] = None) -> list:
    """The back half of a routed lookup: each owner's answers [P, C, ...]
    to its ``recv`` sent back by the answer all_to_all, and every shard's
    answer rows put in request order by K16 (zero where a request
    overflowed; K16's int8 mode decodes bit-packed rows with ``decode=(D,
    Dc)``). ``coords``: :func:`send_requests`' per-shard (owner, pos, ok)."""
    back = mesh.all_to_all(answers)
    if decode is not None:
        return [unroute_rows_q8(b, *c, *decode) for b, c in zip(back, coords)]
    return [unroute_rows(b, *c) for b, c in zip(back, coords)]


def _route_all(mesh: Mesh, global_ids: Sequence[torch.Tensor], rows: int,
               capacity: Optional[int], factor: float):
    """:func:`send_requests` at the capacity of ``factor`` (or the one
    given), at most G."""
    g = global_ids[0].shape[0]
    if any(ids.shape != (g,) for ids in global_ids):
        raise ValueError("routed lookups: every shard's request vector must "
                         f"be [G] with one G, got "
                         f"{[tuple(ids.shape) for ids in global_ids]}")
    return send_requests(mesh, global_ids, rows,
                         _capacity(g, mesh.num_shards, capacity, factor))


def answer_gather(shard: int, local_table: torch.Tensor,
                  recv: torch.Tensor) -> torch.Tensor:
    """Shard ``shard``'s answers to its requests ``recv`` [P, C] global
    ids: its own rows (K3 over the [P * C] rows; rows of any byte width,
    such as bit-packed int8 rows), [P, C, W]."""
    rows = local_table.shape[0]
    local = (recv - shard * rows).clamp(0, rows - 1).to(torch.int32)
    vals, _ = gather_rows(local_table, local.reshape(-1))
    return vals.reshape(tuple(recv.shape) + tuple(local_table.shape[1:]))


def routed_gather(
    mesh: Mesh,
    local_tables: Sequence[torch.Tensor],
    global_ids: Sequence[torch.Tensor],
    *,
    capacity: Optional[int] = None,
    capacity_factor: float = 2.0,
    decode: Optional[Tuple[int, int]] = None,
) -> Tuple[list, List[torch.Tensor]]:
    """Rows of a range-sharded table by GLOBAL row id, for every shard.

    ``local_tables[p]`` is shard p's [rows, W] block; ``global_ids[p]`` its
    [G] int32 request vector (each shard requests its own set; every shard
    the same G). Returns per shard (values [G, W], ok [G] bool); ``ok`` is
    False only for requests dropped by bucket overflow (rows zero-filled).
    With ``decode=(D, Dc)`` the tables hold bit-packed int8 rows and each
    shard's value is (features [G, D], degrees [G], cache [G, Dc] or None),
    fp32, decoded in the unroute pass (K16's int8 mode): the reference's
    ``split_rows`` of the gathered rows.

    One shard takes the reference's closed form: one K3 gather of the
    clipped ids (K12's packed-row mode with ``decode``)."""
    p = mesh.num_shards
    rows = local_tables[0].shape[0]
    if p == 1:
        ids = global_ids[0].to(torch.int32).clamp(0, rows - 1)
        ok = [torch.ones(ids.shape, dtype=torch.bool, device=ids.device)]
        if decode is not None:
            return [gather_packed_rows_q8(local_tables[0], ids, *decode)], ok
        return [gather_rows(local_tables[0], ids)[0]], ok
    recv, coords = _route_all(mesh, global_ids, rows, capacity,
                              capacity_factor)
    answers = [answer_gather(q, local_tables[q], recv[q]) for q in range(p)]
    return (receive_answers(mesh, answers, coords, decode),
            [c[2] for c in coords])


def owner_draw(local_indptr: torch.Tensor, local_indices: torch.Tensor,
               recv: torch.Tensor, fanout: int, row_offset: int, seed: int,
               hop: int, method: str = "uniform",
               local_weights: Optional[torch.Tensor] = None,
               weight_window: int = 128):
    """A shard's owner-side draw for global ids ``recv``: K1, or K19 over
    the shard's ``local_weights`` [E_pad] for weighted / top-k, in their
    row-offset mode, keyed by the global id, so the draw is the replicated
    sampler's. Returns (ids, mask, edge slots), each [..., fanout]."""
    if method == "uniform":
        return sample_uniform(local_indptr, local_indices, recv, int(fanout),
                              seed, hop, row_offset=int(row_offset))
    return sample_weighted(local_indptr, local_indices, local_weights, recv,
                           int(fanout), int(weight_window), method, seed, hop,
                           row_offset=int(row_offset))


def answer_draw(local_indptr: torch.Tensor, local_indices: torch.Tensor,
                recv: torch.Tensor, fanout: int, row_offset: int, seed: int,
                hop: int, method: str = "uniform",
                local_weights: Optional[torch.Tensor] = None,
                weight_window: int = 128) -> torch.Tensor:
    """A shard's answers to its draw requests ``recv`` (global ids): the
    packed [..., fanout] int32 neighbor ids of :func:`owner_draw`, -1 in
    invalid slots."""
    nbr, mask, _ = owner_draw(local_indptr, local_indices, recv, fanout,
                              row_offset, seed, hop, method, local_weights,
                              weight_window)
    return torch.where(mask, nbr, -1)


def answer_edge_rows(local_edge_feats: torch.Tensor, slots: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """A shard's drawn edges' rows: ``local_edge_feats`` [E_pad, De] at the
    draw's CSR ``slots`` [..., fanout] (K3), zero where ``mask`` is False,
    [..., fanout, De]."""
    rows, _ = gather_rows(local_edge_feats, slots.reshape(-1))
    rows = rows.reshape(tuple(slots.shape) + (local_edge_feats.shape[1],))
    return torch.where(mask[..., None], rows, 0.0)


def routed_sample_neighbors(
    mesh: Mesh,
    local_indptr: Sequence[torch.Tensor],
    local_indices: Sequence[torch.Tensor],
    global_ids: Sequence[torch.Tensor],
    fanout: int,
    *,
    seed: int = 0,
    hop: int = 1,
    capacity: Optional[int] = None,
    capacity_factor: float = 2.0,
    method: str = "uniform",
    local_weights: Optional[Sequence[torch.Tensor]] = None,
    weight_window: int = 128,
    local_edge_feats: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[List[torch.Tensor], ...]:
    """``fanout`` neighbor draws per frontier node over a row-sharded CSR,
    for every shard.

    Shard p holds the CSR of global nodes [p * rows, (p + 1) * rows) as a
    local ``local_indptr[p]`` [rows + 1] / ``local_indices[p]`` [E_pad]
    pair (indices are GLOBAL neighbor ids) and, for ``method`` "weighted" /
    "top_k", its CSR-slot-aligned ``local_weights[p]`` [E_pad]. Frontier
    ids route to their owner, which draws with the replicated sampler's
    counter RNG (K1's or K19's row-offset mode, keyed by the global id),
    and the drawn ids route back.

    Returns per shard (neighbor ids [G, fanout] int32, mask [G, fanout]
    bool, ok [G] bool); a dropped request's mask row is all False. With
    ``local_edge_feats`` (shard p's [E_pad, De] fp32 edge rows in CSR slot
    order, the label edges' features) the owner also gathers each drawn
    edge's row (K3, zero where the slot is masked), the rows ride a second
    all_to_all and K16 puts them back in request order: a 4-tuple with the
    rows [G, fanout, De] per shard (zero for a dropped request)."""
    if method != "uniform" and local_weights is None:
        raise ValueError(f"method={method!r} requires local_weights")
    if method == "uniform":
        local_weights = None
    p = mesh.num_shards
    rows = local_indptr[0].shape[0] - 1
    with_rows = local_edge_feats is not None

    def weights(q):
        return None if local_weights is None else local_weights[q]

    if p == 1:
        # the closed form: the owner-side draw on the raw request vector
        ids = global_ids[0].to(torch.int32)
        nbr, mask, slots = owner_draw(local_indptr[0], local_indices[0], ids,
                                      fanout, 0, seed, hop, method,
                                      weights(0), weight_window)
        out = ([nbr], [mask], [torch.ones(ids.shape, dtype=torch.bool,
                                          device=ids.device)])
        if with_rows:
            out += ([answer_edge_rows(local_edge_feats[0], slots, mask)],)
        return out
    recv, coords = _route_all(mesh, global_ids, rows, capacity,
                              capacity_factor)
    packed, edge_rows = [], []
    for q in range(p):
        nbr, mask, slots = owner_draw(local_indptr[q], local_indices[q],
                                      recv[q], fanout, q * rows, seed, hop,
                                      method, weights(q), weight_window)
        packed.append(torch.where(mask, nbr, -1))
        if with_rows:
            edge_rows.append(answer_edge_rows(local_edge_feats[q], slots,
                                              mask))
    back = mesh.all_to_all(packed)
    nbrs, masks, oks = [], [], []
    for s in range(p):
        out = unroute_rows(back[s], *coords[s])
        ok = coords[s][2]
        m = (out >= 0) & ok[:, None]
        nbrs.append(torch.where(m, out, 0))
        masks.append(m)
        oks.append(ok)
    if not with_rows:
        return nbrs, masks, oks
    # a masked slot's row is zero on the owner, a dropped request's in K16
    return nbrs, masks, oks, receive_answers(mesh, edge_rows, coords)
