"""Ring-pipelined halo exchange: an edge-partitioned SpMM over a mesh of
shards (port of ``gigl_tpu/parallel/halo.py``: ``RingSchedule``,
``build_ring_schedule``, ``put_ring_schedule``, ``ring_spmm`` and
``ring_sharded_aggregate``).

Node rows are RANGE-partitioned over the P shards of a
:class:`~gigl_tpu_torch.parallel.mesh.Mesh`: shard s owns rows
``[s * per, (s + 1) * per)`` of the padded ``[P * per, D]`` table (one
tensor on the single controller; a shard's rows are a view of it). Edges
live with their destination's shard. At ring step k shard s holds the
feature block of shard ``(s + k) % P`` and applies its bucket ``(s, k)``:
the edges whose source lies in that block, accumulated into its own rows;
then the blocks rotate down the ring (``Mesh.ppermute(shift=-1)``). P
steps visit every block: a full SpMM in which each block crosses each link
once. On one device the rotation moves no bytes (the views change hands).

Kernel (``csrc/ring_spmm.cu``): K18 ``ring_spmm``, one launch per
non-empty bucket and ring step, over the bucket's edges sorted by
destination (forward: ``acc[d] += sum_e w_e * blk[src_e]``) or, transposed
in the backward, sorted by source (``grad_blk[src_e] += w_e * g[d_e]``).
The ``mean`` reduce folds ``inv_deg[dst]`` into each edge's weight once,
when the schedule is placed, so one weighted sum serves both reduces in
both directions; rows without in-edges stay exactly 0. The plain twin
(:func:`_ring_spmm_bucket_plain`, ``index_add_`` over the same sorted
edges) runs for CPU tensors only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.parallel.partition import shard_features_rowwise

@dataclass
class RingSchedule:
    """Static per-(shard, ring-step) edge buckets for :func:`ring_spmm`, as
    the reference pads them.

    src_local: [P, P, E_max] offset of the edge's source row within the
        feature block held at that step (``src % per``).
    dst_local: [P, P, E_max] offset of the edge's destination within the
        shard's own rows (``dst % per``).
    weight:    [P, P, E_max] float32 edge weight; 0.0 marks padding slots.
    inv_deg:   [P, per] 1/max(in_degree, 1) per owned row (for mean).
    counts:    [P, P] real edges of each bucket (the rest is padding).
    """

    src_local: np.ndarray
    dst_local: np.ndarray
    weight: np.ndarray
    inv_deg: np.ndarray
    per: int
    num_nodes: int
    num_shards: int
    counts: np.ndarray

    @property
    def padded_num_nodes(self) -> int:
        return self.per * self.num_shards


def build_ring_schedule(
    edges: np.ndarray,
    num_nodes: int,
    num_shards: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
) -> RingSchedule:
    """Bucket edges by (dst-owner shard, ring step) and pad to a static size.

    Ring step of an edge (src, dst) is ``(src_owner - dst_owner) % P``: the
    step at which the dst's shard holds the block containing src.
    """
    if edges.ndim != 2 or edges.shape[0] != 2:
        raise ValueError(f"edges must be [2, E], got {edges.shape}")
    p = int(num_shards)
    per = -(-num_nodes // p)
    src = np.asarray(edges[0], dtype=np.int64)
    dst = np.asarray(edges[1], dtype=np.int64)
    w = (np.ones(src.shape, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))

    src_owner = src // per
    dst_owner = dst // per
    step = (src_owner - dst_owner) % p
    bucket = dst_owner * p + step  # flat [P*P] bucket id
    order = np.argsort(bucket, kind="stable")
    src, dst, w, bucket = src[order], dst[order], w[order], bucket[order]
    counts = np.bincount(bucket, minlength=p * p)
    e_max = max(int(counts.max()) if counts.size else 0, 1)

    src_l = np.zeros((p * p, e_max), np.int32)
    dst_l = np.zeros((p * p, e_max), np.int32)
    w_pad = np.zeros((p * p, e_max), np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for b in range(p * p):
        lo, hi = offsets[b], offsets[b + 1]
        n = hi - lo
        src_l[b, :n] = (src[lo:hi] % per).astype(np.int32)
        dst_l[b, :n] = (dst[lo:hi] % per).astype(np.int32)
        w_pad[b, :n] = w[lo:hi]

    deg = np.zeros(p * per, np.float32)
    np.add.at(deg, dst, 1.0)
    inv_deg = (1.0 / np.maximum(deg, 1.0)).reshape(p, per)

    return RingSchedule(
        src_local=src_l.reshape(p, p, e_max),
        dst_local=dst_l.reshape(p, p, e_max),
        weight=w_pad.reshape(p, p, e_max),
        inv_deg=inv_deg,
        per=per,
        num_nodes=num_nodes,
        num_shards=p,
        counts=counts.reshape(p, p),
    )


@dataclass
class PlacedRingSchedule:
    """A :class:`RingSchedule` on the mesh's device: the reference's four
    arrays and K18's two indexes, built once over each bucket's real edges
    (``fwd``: sorted stably by destination, for the forward; ``bwd``: by
    source, for the transposed backward). ``fwd[reduce][b]`` is bucket b's
    (ptr [per + 1] int32 relative to the bucket, row, col [E_b] int32, w
    [E_b] fp32): row the sort key, col the other endpoint, w the edge's
    weight (``mean``: times the destination's 1 / deg, in fp32)."""

    src_local: torch.Tensor
    dst_local: torch.Tensor
    weight: torch.Tensor
    inv_deg: torch.Tensor
    per: int
    num_shards: int
    counts: list                      # [P * P] host ints
    fwd: dict                         # reduce -> [P * P] bucket tuples
    bwd: dict


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _bucket_index(rows: np.ndarray, cols: np.ndarray, weights: dict,
                  bucket: np.ndarray, counts: np.ndarray, per: int,
                  device: torch.device) -> dict:
    """{reduce: [(ptr, row, col, w) per bucket]} over the bucket-major real
    edges, each bucket's sorted stably by ``rows``."""
    nb = counts.shape[0]
    key = bucket * per + rows
    order = np.argsort(key, kind="stable")
    ptr = np.zeros(nb * per + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=nb * per), out=ptr[1:])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    starts = np.arange(nb)[:, None] * per + np.arange(per + 1)[None, :]
    rel = (ptr[starts] - offsets[:nb, None]).astype(np.int32)
    ptr_t = _to(rel, device)
    row_t = _to(rows[order].astype(np.int32), device)
    col_t = _to(cols[order].astype(np.int32), device)
    spans = list(enumerate(zip(offsets[:-1].tolist(), offsets[1:].tolist())))
    out = {}
    for reduce, w in weights.items():
        w_t = _to(w[order], device)
        out[reduce] = [(ptr_t[b], row_t[lo:hi], col_t[lo:hi], w_t[lo:hi])
                       for b, (lo, hi) in spans]
    return out


def put_ring_schedule(sched: RingSchedule, mesh: Mesh) -> PlacedRingSchedule:
    """Move the schedule to the mesh's device and build K18's two indexes
    over each bucket's real edges (its padding slots left out)."""
    p, per = sched.num_shards, sched.per
    if mesh.num_shards != p:
        raise ValueError(f"schedule for {p} shards on a mesh of "
                         f"{mesh.num_shards}")
    counts = np.asarray(sched.counts).reshape(-1).astype(np.int64)
    real = np.arange(sched.src_local.shape[-1])[None, :] < counts[:, None]
    bucket = np.nonzero(real)[0]                   # bucket-major order
    src = sched.src_local.reshape(p * p, -1)[real].astype(np.int64)
    dst = sched.dst_local.reshape(p * p, -1)[real].astype(np.int64)
    w = sched.weight.reshape(p * p, -1)[real]
    # mean: the destination's 1/deg folded into the weight (fp32 product)
    idg = np.asarray(sched.inv_deg, np.float32)[bucket // p, dst]
    weights = {"sum": w, "mean": (w * idg).astype(np.float32)}
    device = mesh.device
    return PlacedRingSchedule(
        src_local=_to(sched.src_local, device),
        dst_local=_to(sched.dst_local, device),
        weight=_to(sched.weight, device), inv_deg=_to(sched.inv_deg, device),
        per=per, num_shards=p, counts=counts.tolist(),
        fwd=_bucket_index(dst, src, weights, bucket, counts, per, device),
        bwd=_bucket_index(src, dst, weights, bucket, counts, per, device))


def _ring_spmm_bucket_plain(x: torch.Tensor, acc: torch.Tensor,
                            ptr: torch.Tensor, row: torch.Tensor,
                            col: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """Plain twin of K18: ``acc[row_e] += w_e * x[col_e]`` over the
    bucket's row-sorted edges, in place; returns ``acc``."""
    del ptr
    return acc.index_add_(0, row.long(), x[col.long()] * w[:, None])


def ring_spmm_bucket(x: torch.Tensor, acc: torch.Tensor, ptr: torch.Tensor,
                     row: torch.Tensor, col: torch.Tensor, w: torch.Tensor
                     ) -> torch.Tensor:
    """K18: one bucket of one ring step, in place: for every row r of
    ``acc`` ([rows, D] fp32), ``acc[r] += sum_{e in ptr[r]:ptr[r + 1]}
    w_e * x[col_e]`` over the bucket's edges sorted by ``row`` (``ptr``
    [rows + 1] int32 into ``col`` / ``w``). Returns ``acc``. Launches
    nothing for an empty bucket. CPU tensors take the plain twin."""
    if acc.device.type == "cpu":
        return _ring_spmm_bucket_plain(x, acc, ptr, row, col, w)
    device = _build.require_cuda("ring_spmm", x, acc, ptr, col, w)
    rows, d = acc.shape
    if (x.dtype != torch.float32 or acc.dtype != torch.float32
            or w.dtype != torch.float32 or ptr.dtype != torch.int32
            or col.dtype != torch.int32 or x.dim() != 2
            or x.shape[1] != d or ptr.shape != (rows + 1,)
            or w.shape != col.shape):
        raise ValueError("ring_spmm: x [M, D] and acc [rows, D] fp32, ptr "
                         "[rows + 1] and col [E] int32, w [E] fp32")
    if col.numel() == 0 or rows == 0 or d == 0:
        return acc
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0
              and acc.data_ptr() % 16 == 0)
    _build.launch("ring_spmm", "gigl_ring_spmm", device, x.data_ptr(),
                  ptr.data_ptr(), col.data_ptr(), w.data_ptr(),
                  acc.data_ptr(), rows, d, vec)
    return acc


def _blocks(t: torch.Tensor, p: int, per: int) -> list:
    return [t[q * per:(q + 1) * per] for q in range(p)]


class RingSpmm(torch.autograd.Function):
    """The whole ring over all shards and steps. Forward: P steps, shard s
    applying bucket (s, k) to the block it holds into its own rows, the
    blocks rotating down the ring between steps. Backward, the transposed
    ring in reverse step order: shard s applies bucket (s, k) transposed,
    its cotangent rows into the gradient of the block it held at step k,
    and those gradient blocks rotate up the ring, each arriving at its
    owner after step 0."""

    @staticmethod
    def forward(ctx, x, placed: PlacedRingSchedule, mesh: Mesh,
                reduce: str):
        p, per = placed.num_shards, placed.per
        out = torch.zeros_like(x)
        held = _blocks(x, p, per)      # shard s holds block (s + k) % P
        accs = _blocks(out, p, per)
        for k in range(p):
            for s in range(p):
                b = s * p + k
                if placed.counts[b]:
                    ring_spmm_bucket(held[s], accs[s],
                                     *placed.fwd[reduce][b])
            if k + 1 < p:
                held = mesh.ppermute(held, shift=-1)
        ctx.placed, ctx.mesh, ctx.reduce = placed, mesh, reduce
        return out

    @staticmethod
    def backward(ctx, g):
        placed, mesh, reduce = ctx.placed, ctx.mesh, ctx.reduce
        p, per = placed.num_shards, placed.per
        g = g.contiguous()
        gx = torch.zeros_like(g)
        cot = _blocks(g, p, per)
        grads = _blocks(gx, p, per)
        held = [grads[(s + p - 1) % p] for s in range(p)]
        for k in reversed(range(p)):
            for s in range(p):
                b = s * p + k
                if placed.counts[b]:
                    ring_spmm_bucket(cot[s], held[s],
                                     *placed.bwd[reduce][b])
            if k > 0:
                held = mesh.ppermute(held, shift=1)
        return gx, None, None, None


def ring_spmm(x: torch.Tensor, placed: PlacedRingSchedule, mesh: Mesh, *,
              reduce: str = "sum") -> torch.Tensor:
    """Edge-partitioned SpMM with a ring over the mesh.

    x: [P * per, D] row-sharded table (see ``shard_features_rowwise``).
    Returns [P * per, D], identically sharded: out[d] = reduce over
    in-edges (s, d) of weight * x[s] (``mean``: divided by max(in-degree,
    1)). Differentiable in ``x``."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"ring_spmm reduce must be sum|mean, got {reduce!r}")
    want = (placed.num_shards * placed.per,)
    if x.dim() != 2 or tuple(x.shape[:1]) != want:
        raise ValueError(f"ring_spmm: x must be [{want[0]}, D], got "
                         f"{tuple(x.shape)}")
    return RingSpmm.apply(x.contiguous(), placed, mesh, reduce)


def ring_sharded_aggregate(
    edges: np.ndarray,
    features,
    num_nodes: int,
    mesh: Mesh,
    *,
    reduce: str = "sum",
    edge_weight: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor],
           RingSchedule]:
    """Build and place the schedule, shard the feature table, run the ring
    SpMM: ([num_nodes, D] result, a closure that re-runs on new
    [P * per, D] tables of the same shape, the host schedule)."""
    sched = build_ring_schedule(edges, num_nodes, mesh.num_shards,
                                edge_weight=edge_weight)
    placed = put_ring_schedule(sched, mesh)
    x = shard_features_rowwise(np.asarray(features), mesh)

    def run(xs: torch.Tensor) -> torch.Tensor:
        return ring_spmm(xs, placed, mesh, reduce=reduce)

    out = run(x)
    return out[:num_nodes], run, sched
