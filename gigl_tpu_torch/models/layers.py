"""Dense layers in a compute type, normalization, activation, dropout and
the encoder's auxiliary layers (port of ``gigl_tpu/models/layers.py``:
``l2_normalize``, ``FeatureEmbeddingLayer``, ``DCNCross``,
``JumpingKnowledge``; flax ``nn.BatchNorm`` and ``nn.Dropout``;
``jax.nn.leaky_relu``).

Parameters are fp32 and keep flax's names, so ``convert.params_from_flax``
maps a reference tree one to one: ``BatchNorm``'s ``scale`` / ``bias``
and its ``mean`` / ``var`` buffers (flax's ``batch_stats``), the
embedding tables ``embed_col{col}.embedding``, the cross layers
``cross_{i}``, and ``JumpingKnowledge``'s ``proj``, ``att`` and LSTM cells
(input kernels ``ii`` / ``if`` / ``ig`` / ``io`` without bias, hidden
kernels ``hi`` / ``hf`` / ``hg`` / ``ho`` with one).

Where a flax module takes no ``dtype`` (``Embed``, the LSTM cells, JK's
``att`` Dense) it computes in the promotion of its input and its fp32
parameters, so a bf16 input gives fp32 there; the port does the same.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """x / sqrt(max(sum(x^2), eps)) along ``dim``."""
    return x * torch.rsqrt(
        torch.clamp((x * x).sum(dim=dim, keepdim=True), min=eps))


def leaky_relu(z: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(z >= 0, z, slope * z)``. Its
    derivative at exactly 0 is 1, as JAX's (``F.leaky_relu``'s is the
    slope there), the convention the port's attention kernels share."""
    return torch.where(z >= 0, z, negative_slope * z)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate), the keep mask drawn from ``generator`` (its bits differ
    from flax's); the identity in eval mode or at rate 0."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = (u >= rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``lin(x)`` computed in ``dtype`` from fp32 parameters."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _dense_f32(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A flax ``Dense`` without ``dtype``: input and fp32 parameters
    promoted together, so fp32 for an fp32 or bf16 input."""
    return F.linear(x.float(), lin.weight, lin.bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (momentum 0.99, epsilon
    1e-5). ``forward(x, train)``: in train mode the statistics of ``x``
    over every leading row (reduced in fp32, the variance the fast
    ``E[x^2] - E[x]^2`` clipped at 0, differentiable) normalise it, and the
    running ``mean`` / ``var`` buffers move by ``momentum * old + (1 -
    momentum) * new`` with that biased variance; in eval mode the buffers
    normalise it. The mode is the ``train`` argument, never
    ``nn.Module.training``. ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in fp32, returned in ``dtype``."""

    def __init__(self, dim: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            rows = xf.reshape(-1, xf.shape[-1])
            mean = rows.mean(0)
            var = torch.clamp((rows * rows).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)
        return (y + self.bias).to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed`` without ``dtype``: rows of the fp32 table
    ``embedding`` [V, D]."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()]


class FeatureEmbeddingLayer(nn.Module):
    """Embed selected categorical feature columns: ``vocab_specs`` is
    ``((col, (V, D)), ...)``. Each embedded column is truncated to int32 and
    clipped to [0, V - 1]; the output is ``[passthrough || embeddings]``
    along the last axis (fp32 when a table's rows join bf16 passthrough
    columns, as flax promotes the concatenation)."""

    def __init__(self, vocab_specs: Sequence[Tuple[int, Tuple[int, int]]]):
        super().__init__()
        self.vocab_specs = tuple((int(c), (int(v), int(d)))
                                 for c, (v, d) in vocab_specs)
        for col, (v, d) in self.vocab_specs:
            self.add_module(f"embed_col{col}", Embed(v, d))

    @property
    def embedded_cols(self) -> List[int]:
        return [col for col, _ in self.vocab_specs]

    def out_dim(self, in_dim: int) -> int:
        emb = sum(d for _, (_, d) in self.vocab_specs)
        return in_dim - len(self.vocab_specs) + emb

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cols = set(self.embedded_cols)
        keep = [i for i in range(x.shape[-1]) if i not in cols]
        parts = [x[..., keep]] if keep else []
        for col, (v, _) in self.vocab_specs:
            ids = torch.clamp(x[..., col].to(torch.int32), 0, v - 1)
            parts.append(getattr(self, f"embed_col{col}")(ids))
        return torch.cat(parts, dim=-1)     # promotes, as flax's concatenate


class DCNCross(nn.Module):
    """DCN-v2 cross network: ``x_{l+1} = x0 * cross_l(x_l) + x_l``, each
    layer a Dense computed in ``dtype``."""

    def __init__(self, dim: int, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        for i in range(num_layers):
            self.add_module(f"cross_{i}", nn.Linear(dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        for i in range(self.num_layers):
            x = x0 * linear(getattr(self, f"cross_{i}"), x, self.dtype) + x
        return x


_GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell`` (no ``dtype``: fp32 from its fp32
    carry and parameters): ``i, f, o = sigmoid(i{k}(x) + h{k}(h))``, ``g =
    tanh(ig(x) + hg(h))``, ``c' = f c + i g``, ``h' = o tanh(c')``; the
    input kernels ``i{k}`` have no bias, the hidden ``h{k}`` one."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.features = features
        for k in _GATES:
            self.add_module(f"i{k}", nn.Linear(in_dim, features, bias=False))
            self.add_module(f"h{k}", nn.Linear(features, features))

    def recurrent(self) -> List[nn.Linear]:
        """The hidden kernels (flax initialises them orthogonal)."""
        return [getattr(self, f"h{k}") for k in _GATES]

    def forward(self, carry, x):
        c, h = carry
        pre = {k: _dense_f32(getattr(self, f"h{k}"), h)
               + _dense_f32(getattr(self, f"i{k}"), x) for k in _GATES}
        c = torch.sigmoid(pre["f"]) * c + torch.sigmoid(pre["i"]) * torch.tanh(
            pre["g"])
        h = torch.sigmoid(pre["o"]) * torch.tanh(c)
        return (c, h), h

    def scan(self, xs: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """``nn.RNN`` over axis -2 of ``xs`` [..., L, Din] from a zero
        carry; ``reverse`` runs last to first and keeps the outputs in the
        input's order (``keep_order=True``)."""
        lead, steps = xs.shape[:-2], xs.shape[-2]
        zero = torch.zeros(lead + (self.features,), dtype=torch.float32,
                           device=xs.device)
        carry, outs = (zero, zero), [None] * steps
        order = range(steps - 1, -1, -1) if reverse else range(steps)
        for t in order:
            carry, outs[t] = self(carry, xs[..., t, :])
        return torch.stack(outs, dim=-2)


class JumpingKnowledge(nn.Module):
    """Combine per-layer representations [..., in_dim] (one per layer):
    ``cat``, ``max`` or ``lstm`` (PyG's: a bidirectional LSTM over the
    layer axis, ``att`` scores from both directions, a softmax over layers
    and the weighted sum, in fp32), then ``proj`` to ``out_dim`` in
    ``dtype`` when given."""

    def __init__(self, mode: str, in_dim: int, num_layers: int,
                 out_dim: Optional[int] = None,
                 lstm_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("cat", "max", "lstm"):
            raise ValueError(f"Unknown JK mode {mode!r}")
        self.mode = mode
        self.dtype = dtype
        width = in_dim * num_layers if mode == "cat" else in_dim
        if mode == "lstm":
            d = lstm_dim or in_dim
            self.lstm_fwd = LSTMCell(in_dim, d)
            self.lstm_bwd = LSTMCell(in_dim, d)
            self.att = nn.Linear(2 * d, 1)
        self.proj = (nn.Linear(width, out_dim) if out_dim is not None
                     else None)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        if self.mode == "cat":
            out = torch.cat(list(xs), dim=-1)
        elif self.mode == "max":
            out = torch.stack(list(xs), dim=0).amax(0)
        else:
            h = torch.stack(list(xs), dim=-2)                  # [..., L, D]
            both = torch.cat([self.lstm_fwd.scan(h),
                              self.lstm_bwd.scan(h, reverse=True)], dim=-1)
            alpha = torch.softmax(_dense_f32(self.att, both)[..., 0], dim=-1)
            out = (alpha[..., None] * h.float()).sum(-2)
        if self.proj is not None:
            out = linear(self.proj, out, self.dtype)
        return out
