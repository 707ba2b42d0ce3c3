"""On-device layerwise neighbor sampling over CSR -> dense fanout blocks.

Port of ``gigl_tpu/sampling/neighbor_sampler.py`` (uniform method). For
each frontier node, ``fanout`` neighbor slots are drawn from the CSR
adjacency with a counter-based hash keyed by (seed, node, hop, slot): nodes
with degree <= fanout take all their neighbors in slot order, larger
degrees sample with replacement. The draw is bit-equal to the reference.

Kernel K1 ``sample_uniform`` (``csrc/sample_uniform.cu``) replaces
``counter_rng_uniform`` + ``uniform_offsets`` + ``sample_neighbors``: one
CUDA thread per (node, slot). :func:`_sample_uniform_plain` is its plain
PyTorch twin, used for CPU tensors only. The hash runs there in int64
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


@dataclass
class DeviceCSR:
    """CSR adjacency resident on a device (int32 ``indptr`` / ``indices``)."""

    indptr: torch.Tensor  # [N+1] int32
    indices: torch.Tensor  # [E] int32

    @classmethod
    def from_csr(cls, csr: CSR, device: torch.device) -> "DeviceCSR":
        def put(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int32)

        return cls(indptr=put(csr.indptr), indices=put(csr.indices))

    @property
    def num_anchor_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def _sample_uniform_plain(
    indptr: torch.Tensor, indices: torch.Tensor, frontier: torch.Tensor,
    fanout: int, seed: int, hop: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K1 (sample_neighbors, method="uniform")."""
    f = frontier.to(torch.int64)
    start = indptr[f].to(torch.int64)
    deg = indptr[f + 1].to(torch.int64) - start
    offsets, mask = uniform_offsets(deg, frontier, seed, hop, fanout)
    edge_slots = (start[..., None] + offsets).clamp(0, indices.shape[0] - 1)
    nbr = torch.where(mask, indices[edge_slots], 0).to(torch.int32)
    return nbr, mask, edge_slots.to(torch.int32)


def sample_uniform(
    indptr: torch.Tensor, indices: torch.Tensor, frontier: torch.Tensor,
    fanout: int, seed: int, hop: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: ``fanout`` uniform draws per frontier node ([...] int32).

    Returns (neighbor ids [..., fanout] int32, mask bool, CSR edge slots
    int32). Frontier ids must lie in [0, N). CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if frontier.device.type == "cpu":
        return _sample_uniform_plain(indptr, indices, frontier, fanout,
                                     seed, hop)
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
        ids.data_ptr(), mask.data_ptr(), slots.data_ptr())
    shape = tuple(frontier.shape) + (fanout,)
    return ids.reshape(shape), mask.reshape(shape), slots.reshape(shape)


def sample_neighbors(
    csr: DeviceCSR,
    frontier: torch.Tensor,
    fanout: int,
    *,
    seed: int,
    hop: int,
    method: str = "uniform",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample ``fanout`` neighbor slots for each frontier node.

    Returns (neighbor_ids [..., fanout], mask [..., fanout], edge_slots);
    padded slots point at the node's first slot and are masked out."""
    if method != "uniform":
        raise NotImplementedError(
            f"sampling method {method!r} is not ported yet "
            "(gigl_tpu.sampling.neighbor_sampler.weighted_offsets)")
    return sample_uniform(csr.indptr, csr.indices, frontier, int(fanout),
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
