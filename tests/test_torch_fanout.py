"""Parity of the port's masked fanout reductions (gigl_tpu_torch.ops.fanout)
with the JAX reference (gigl_tpu.ops.fanout), including rows with no valid
slot (which reduce to 0).

fp32: both sides sum <= K fp32 values in different orders — rtol/atol
1e-6. bf16: the reference reduces in bf16 while the port accumulates in
fp32 and rounds once, so they differ by up to a couple of bf16 ulps of the
row's values: atol 2e-2 relative to the largest |value| (bf16 keeps 8
significant bits, an ulp is 2**-7 of the value).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gigl_tpu.ops import fanout as ref
from gigl_tpu_torch.ops import fanout as port

torch.set_num_threads(1)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(m=64, k=5, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k, d)).astype(np.float32)
    mask = rng.random((m, k)) < 0.6
    mask[:4] = False          # rows with no valid slot
    mask[4] = True            # a full row
    return x, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["mean", "sum", "max"])
def test_masked_reduce_matches(op, dtype):
    x, mask = _inputs()
    jx = jnp.asarray(x).astype(JAX_DTYPES[dtype])
    want = getattr(ref, f"masked_{op}")(jx, jnp.asarray(mask))
    want = np.asarray(want.astype(jnp.float32))
    got = getattr(port, f"masked_{op}")(
        torch.from_numpy(x).to(TORCH_DTYPES[dtype]), torch.from_numpy(mask))
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (64, 16)
    got = got.float().numpy()
    np.testing.assert_array_equal(got[:4], 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("reduce", ["mean", "sum", "max"])
def test_fanout_aggregate_matches(reduce):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    idx = rng.integers(0, 40, (30, 6)).astype(np.int32)
    mask = rng.random((30, 6)) < 0.7
    w = rng.random((30, 6)).astype(np.float32)
    want = ref.fanout_aggregate(jnp.asarray(x), jnp.asarray(idx),
                                jnp.asarray(mask), reduce=reduce,
                                edge_weight=jnp.asarray(w))
    got = port.fanout_aggregate(torch.from_numpy(x), torch.from_numpy(idx),
                                torch.from_numpy(mask), reduce=reduce,
                                edge_weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        port.gather_neighbors(torch.from_numpy(x), torch.from_numpy(idx)),
        np.asarray(ref.gather_neighbors(jnp.asarray(x), jnp.asarray(idx))))


def test_unknown_reduce_rejected():
    x, mask = _inputs()
    with pytest.raises(ValueError, match="Unknown reduce"):
        port.masked_reduce(torch.from_numpy(x), torch.from_numpy(mask), "min")
