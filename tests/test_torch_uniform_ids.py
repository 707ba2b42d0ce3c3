"""K1b's plain twin (gigl_tpu_torch.sampling.neighbor_sampler.
_uniform_ids_plain, what ``uniform_ids`` runs on the CPU) against the
reference's own expression for the batch-shared random negatives
(gigl_tpu/training/dataset.py:295-298), at the edges: counts 0, 1, 5 and
513, node counts 1, 2, 2**31 - 1, 2**31 + 11 and 2**32 - 1 (ids past
2**31 wrap to negative int32, as ``astype(jnp.int32)`` wraps them; about
half of them at 2**32 - 1), hops next to the
2**32 wrap, seeds made with numpy. Integer work: every case is bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigl_tpu.sampling.neighbor_sampler import counter_rng_uniform
from gigl_tpu_torch.sampling.neighbor_sampler import (
    _uniform_ids_plain,
    uniform_ids,
)

SEEDS = np.random.default_rng(23).integers(0, 2**32, 4, dtype=np.uint64)


def _reference(count, seed, hop, n):
    bits = counter_rng_uniform(jnp.arange(count, dtype=jnp.int32), seed,
                               hop, 1)[:, 0]
    return np.asarray((bits % jnp.uint32(n)).astype(jnp.int32))


@pytest.mark.parametrize("count", [0, 1, 5, 513])
@pytest.mark.parametrize("n", [1, 2, 2**31 - 1, 2**31 + 11, 2**32 - 1])
@pytest.mark.parametrize("hop", [2**32 - 1, 2**32 - 2])
def test_uniform_ids_plain_matches_the_reference(count, n, hop):
    seed = int(SEEDS[(count + n) % len(SEEDS)])
    want = _reference(count, seed, hop, n)
    got = _uniform_ids_plain(count, seed, hop, n, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.shape == (count,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        uniform_ids(count, seed, hop, n, "cpu").numpy(), want)
    if n == 2**32 - 1 and count == 513:
        assert (got < 0).any()             # ids past 2**31 wrapped


@pytest.mark.parametrize("seed", [int(s) for s in SEEDS])
def test_uniform_ids_hop_of_a_step_past_the_wrap(seed):
    """3_000_017 + step past 2**32 wraps: the twin takes the hop mod
    2**32, which is what the reference sees for that hop."""
    step = 2**32 - 3_000_017 + 6
    got = _uniform_ids_plain(64, seed, 3_000_017 + step, 100_000, "cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  _reference(64, seed, 6, 100_000))
