"""Parity of the port's neighbor sampler (gigl_tpu_torch.sampling) with the
JAX reference (gigl_tpu.sampling.neighbor_sampler).

Draws are integer outputs, so they must be BIT-EQUAL: the counter hash,
the uniform offsets, and sample_neighbors / sample_blocks ids, masks and
edge slots — including isolated nodes, deg <= fanout, deg > fanout, and
node ids, seeds and hops whose products wrap mod 2**32. The port runs its
plain PyTorch versions here (CPU tensors).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gigl_tpu.graph.csr import build_csr as jax_build_csr
from gigl_tpu.sampling import neighbor_sampler as ref
from gigl_tpu_torch.graph.csr import build_csr
from gigl_tpu_torch.sampling import neighbor_sampler as port

torch.set_num_threads(1)

N, E = 500, 4000
ISOLATED = (7, 13, 499)


def _coo(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    keep = ~np.isin(dst, ISOLATED)
    # a few hubs so deg > fanout and deg <= fanout both occur
    hub_src = rng.integers(0, N, 300)
    src = np.concatenate([src[keep], hub_src])
    dst = np.concatenate([dst[keep], np.full(300, 3)])
    return src, dst


def _csrs(seed=0):
    src, dst = _coo(seed)
    jc = ref.DeviceCSR.from_csr(jax_build_csr(src, dst, num_anchor_nodes=N,
                                              num_neighbor_nodes=N))
    pc = port.DeviceCSR.from_csr(build_csr(src, dst, num_anchor_nodes=N,
                                           num_neighbor_nodes=N),
                                 torch.device("cpu"))
    return jc, pc


@pytest.mark.parametrize("seed,hop", [
    (0, 1), (12345, 2), (2**32 - 1, 7), (2**31 + 17, 2**32 - 3),
    (1_299_709, 1_000_003),
])
def test_counter_rng_uniform_bit_equal(seed, hop):
    ids = np.array([0, 1, 2, 499, 2**31 - 1, -1, -(2**31), 123456789],
                   np.int32)
    want = np.asarray(ref.counter_rng_uniform(jnp.asarray(ids), seed, hop, 9))
    got = port.counter_rng_uniform(torch.from_numpy(ids), seed, hop, 9)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_mix32_bit_equal_on_extremes():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF],
                 np.uint32)
    want = np.asarray(ref._mix32(jnp.asarray(x)))
    got = port._mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("fanout", [1, 4, 15, 40])
def test_uniform_offsets_bit_equal(fanout):
    rng = np.random.default_rng(fanout)
    deg = np.concatenate([[0, 1, fanout, fanout + 1],
                          rng.integers(0, 3 * fanout + 2, 60)]).astype(np.int32)
    ids = rng.integers(0, 2**31 - 1, deg.shape[0]).astype(np.int32)
    wo, wm = ref.uniform_offsets(jnp.asarray(deg), jnp.asarray(ids), 99, 2,
                                 fanout)
    go, gm = port.uniform_offsets(torch.from_numpy(deg),
                                  torch.from_numpy(ids), 99, 2, fanout)
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("fanout,seed,hop", [
    (3, 0, 1), (10, 0, 2), (15, 7, 1), (40, 2**32 - 5, 2**31 + 1),
])
def test_sample_neighbors_bit_equal(fanout, seed, hop):
    jc, pc = _csrs()
    frontier = np.array(list(range(N)) + [3, 7, 3], np.int32)
    wi, wm, ws = ref.sample_neighbors(jc, jnp.asarray(frontier), fanout,
                                      seed=seed, hop=hop)
    gi, gm, gs = port.sample_neighbors(pc, torch.from_numpy(frontier), fanout,
                                       seed=seed, hop=hop)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # the cases the test is meant to cover all occur
    deg = np.diff(np.asarray(jc.indptr))[frontier]
    assert (deg == 0).any() and (deg > fanout).any() and \
        ((deg > 0) & (deg <= fanout)).any()
    assert not gm.numpy()[frontier == 7].any()


@pytest.mark.parametrize("fanouts,seed", [((4, 3), 0), ((15, 10), 3),
                                          ((2, 2, 2), 11)])
def test_sample_blocks_bit_equal(fanouts, seed):
    jc, pc = _csrs(1)
    roots = np.array([0, 7, 3, 100, 250, 499, 13, 42], np.int32)
    want = ref.sample_blocks(jc, jnp.asarray(roots), fanouts, seed=seed)
    got = port.sample_blocks(pc, torch.from_numpy(roots), fanouts, seed=seed)
    assert len(got.node_ids) == len(want.node_ids) == len(fanouts) + 1
    for level in range(len(fanouts) + 1):
        np.testing.assert_array_equal(got.node_ids[level].numpy(),
                                      np.asarray(want.node_ids[level]))
        np.testing.assert_array_equal(got.masks[level].numpy(),
                                      np.asarray(want.masks[level]))
    for level in range(1, len(fanouts) + 1):
        np.testing.assert_array_equal(got.edge_slots[level].numpy(),
                                      np.asarray(want.edge_slots[level]))


def test_weighted_methods_raise_not_implemented():
    _, pc = _csrs()
    with pytest.raises(NotImplementedError, match="weighted_offsets"):
        port.sample_neighbors(pc, torch.arange(4, dtype=torch.int32), 3,
                              seed=0, hop=1, method="top_k")
