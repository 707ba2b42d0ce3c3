"""A single-controller mesh of shards on one device (the port's counterpart
of ``gigl_tpu/parallel/mesh.py`` ``make_mesh`` over a virtual mesh).

The JAX package runs its partitioned trainers as one program over a
``jax.sharding.Mesh`` under ``shard_map``: every shard holds its own block
of the graph and the shards meet only in XLA's collectives. The port keeps
that design with one controller driving P shards on one device: a shard's
state is its own tensors, held in per-shard lists (entry p is shard p's),
and each collective is a copy or a sum across those lists:

- ``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)`` -> :meth:`Mesh.all_to_all`:
  ``out[q][p] = in[p][q]`` (each input split into P blocks on axis 0),
  one stacking copy per shard;
- ``jax.lax.ppermute(x, axis, [(i, i + shift mod P)])`` ->
  :meth:`Mesh.ppermute`: ``out[(i + shift) % P] = in[i]``, no copy (the
  tensors change hands); the retrieval ring shifts up (+1), the halo ring
  down (-1);
- ``jax.lax.psum`` / ``pmean`` -> :meth:`Mesh.psum` / :meth:`Mesh.pmean`:
  one sum over the shards (fixed order, shard 0 first), which every
  shard's entry shares (tensors are never written in place);
- ``jax.lax.all_gather(x, axis, axis=0, tiled=True)`` ->
  :meth:`Mesh.all_gather`: one concatenation, shared by every shard.

Every collective is differentiable through PyTorch's autograd, so a
cotangent returns to the shard that owns the tensor as the transposed JAX
collective sends it (``ppermute``'s transpose is the reverse shift,
``all_gather``'s a sum-scatter). There is no ``put_replicated``: one
controller on one device holds one parameter set. :attr:`Mesh.a2a_bytes`
counts the bytes every all_to_all copied since the last
:meth:`Mesh.reset_counts`; a shard's block destined for itself is counted
too (on P cards it would not cross a link).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device


class Mesh:
    """``num_shards`` shards along one axis, all on ``device`` (built by
    :func:`make_mesh`)."""

    def __init__(self, num_shards: int, device: DeviceLike = None):
        if int(num_shards) < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.device = resolve_device(device)
        self.a2a_bytes = 0
        self.a2a_calls = 0

    def reset_counts(self) -> None:
        self.a2a_bytes = 0
        self.a2a_calls = 0

    def _check(self, xs: Sequence[torch.Tensor], what: str) -> None:
        if len(xs) != self.num_shards:
            raise ValueError(f"{what}: {len(xs)} per-shard tensors for "
                             f"{self.num_shards} shards")

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Tiled all_to_all on axis 0: shard p's ``xs[p]`` ([P * C, ...] or
        [P, C, ...]) is cut into P blocks; shard q receives block q of every
        shard, in shard order, in the input's shape."""
        self._check(xs, "all_to_all")
        p = self.num_shards
        if any(x.shape[0] % p for x in xs):
            raise ValueError(f"all_to_all: axis 0 not a multiple of {p}")
        split = [x.reshape((p, -1) + tuple(x.shape[1:])) for x in xs]
        out = [torch.stack([s[q] for s in split]).reshape(xs[q].shape)
               for q in range(p)]
        self.a2a_bytes += sum(x.numel() * x.element_size() for x in xs)
        self.a2a_calls += 1
        return out

    def ppermute(self, xs: Sequence, shift: int = 1) -> list:
        """Shard i's entry moves to shard (i + shift) mod P (a ring's
        rotation: +1 the retrieval ring's, -1 the halo ring's); entries may
        be any per-shard values."""
        self._check(xs, "ppermute")
        p = self.num_shards
        return [xs[(q - shift) % p] for q in range(p)]

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the shards, shard 0 first; every entry is that one
        tensor."""
        self._check(xs, "psum")
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return [total] * self.num_shards

    def pmean(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [self.psum(xs)[0] / self.num_shards] * self.num_shards

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Tiled all_gather on axis 0: the concatenation in shard order,
        shared by every shard."""
        self._check(xs, "all_gather")
        return [torch.cat(list(xs))] * self.num_shards


def make_mesh(num_shards: int, device: DeviceLike = None) -> Mesh:
    """A mesh of ``num_shards`` shards on ``device`` (CUDA unless given;
    raises without it): the entry point, as the reference's ``make_mesh``."""
    return Mesh(num_shards, device)
