"""Parity of K10b ``sddmm_bwd_coef`` (gigl_tpu_torch.ops.segment; its
plain twin runs for CPU tensors) with ``jax.vjp`` of the reference's
scaled score, ``gigl_tpu.ops.segment.sddmm(...) * scale``, taken at the
unscaled scores: the cotangent of the scores is ``g * scale`` and that of
the scale ``sum_e g * raw``, at every head count the kernel takes (1-16,
powers of two in 16-byte pieces on the card, the rest an edge a thread)
and edge counts of none, one, three and more, fp32 and bf16 g.

Tolerances: the coefficients are one fp32 multiply on both sides,
bit-equal. The scale's cotangent is a sum of E signed terms that can
nearly cancel, so it is held within 1e-6 of sum_e |g * raw| per head (an
fp64 sum's error is far below; fp32 sums in any order stay within ~1e-7
of it), not relative to the result itself.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.ops import segment as ref
from gigl_tpu_torch.ops import segment as seg

torch.set_num_threads(1)

N_DST, N_SRC, DK = 40, 30, 8


def _case(e, heads, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_SRC, e).astype(np.int32)
    dst = rng.integers(0, N_DST, e).astype(np.int32)
    q = rng.normal(size=(N_DST, heads, DK)).astype(np.float32)
    k = rng.normal(size=(N_SRC, heads, DK)).astype(np.float32)
    g = rng.normal(size=(e, heads)).astype(np.float32)
    scale = (rng.random(heads) + 0.5).astype(np.float32)
    return src, dst, q, k, g, scale


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("e", [0, 1, 3, 1001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sddmm_bwd_coef_matches_jax_vjp(heads, e, dtype):
    src, dst, q, k, g, scale = _case(e, heads, seed=heads * 10_000 + e)
    g = torch.from_numpy(g).to(dtype)
    gj = jnp.asarray(g.float().numpy())
    raw_j = ref.sddmm(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(q),
                      jnp.asarray(k))
    _, vjp = jax.vjp(lambda x, s: x * s, raw_j, jnp.asarray(scale))
    want_coef, want_ds = (np.asarray(t) for t in vjp(gj))
    raw = torch.from_numpy(np.array(raw_j))
    coef, dscale = seg.sddmm_bwd_coef(g, torch.from_numpy(scale), raw)
    assert coef.dtype == torch.float32 and coef.shape == (e, heads)
    np.testing.assert_array_equal(coef.numpy(), want_coef)
    prod = g.double().numpy() * np.asarray(raw_j, np.float64)
    bound = 1e-6 * np.abs(prod).sum(0)
    assert dscale.shape == (heads,)
    assert np.all(np.abs(dscale.double().numpy() - prod.sum(0)) <= bound)
    assert np.all(np.abs(want_ds.astype(np.float64) - prod.sum(0)) <= bound)
    # without the scale's cotangent, and without a scale
    only, none = seg.sddmm_bwd_coef(g, torch.from_numpy(scale))
    assert none is None and torch.equal(only, coef)
    plain, _ = seg.sddmm_bwd_coef(g)
    assert torch.equal(plain, g.float())
