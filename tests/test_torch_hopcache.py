"""Parity of the port's tabularized tables (gigl_tpu_torch.ops.hopcache and
DeviceGraph.with_neighbor_cache / the tabularized expansion and fused
hydration) with the JAX reference.

Sample tables, packed -1 tables, tabularized expansions and the fused
table's feature half are integer or copied outputs: BIT-EQUAL. The
aggregate table is an fp32 sum over <= fanout rows whose order differs
from XLA's reduction, so it is held at rtol 1e-5 (atol 1e-6 for sums that
cancel to ~0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.ops import hopcache as ref
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.ops import hopcache as port
from gigl_tpu_torch.training.dataset import DeviceGraph

torch.set_num_threads(1)

N, E, D = 500, 4000, 16


def _graphs(seed=0, isolated=(7, 13)):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    keep = ~(np.isin(src, isolated) | np.isin(dst, isolated))
    src, dst = src[keep], dst[keep]
    x = rng.normal(size=(N, D)).astype(np.float32)
    jg = JaxDeviceGraph.from_hetero(JaxHeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N, node_features=x))
    pg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N, node_features=x), device="cpu")
    return jg, pg


@pytest.mark.parametrize("fanout,seed,hop_key", [(4, 0, 1), (15, 3, 1),
                                                 (3, 2**31 - 2, 2)])
def test_build_sample_table_bit_equal(fanout, seed, hop_key):
    jg, pg = _graphs()
    wi, wm = ref.build_sample_table(jg.message_csr, fanout=fanout, seed=seed,
                                    hop_key=hop_key)
    gi, gm = port.build_sample_table(pg.message_csr, fanout=fanout, seed=seed,
                                     hop_key=hop_key)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("agg", ["mean", "sum", "gcn"])
@pytest.mark.parametrize("fanout,hop_key", [(3, 2), (10, 2), (40, 1)])
def test_build_neighbor_cache_matches(agg, fanout, hop_key):
    jg, pg = _graphs()
    want = np.asarray(ref.build_neighbor_cache(
        jg.message_csr, jg.node_features, fanout=fanout, seed=5,
        hop_key=hop_key, agg=agg, degrees=jg.degrees))
    got = port.build_neighbor_cache(
        pg.message_csr, pg.node_features, fanout=fanout, seed=5,
        hop_key=hop_key, agg=agg, degrees=pg.degrees).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[[7, 13]], 0.0)  # isolated nodes


@pytest.mark.parametrize("fanouts", [(4, 3), (15, 10), (2, 3, 4)])
def test_with_neighbor_cache_tables(fanouts):
    jg, pg = _graphs(1)
    kw = dict(fanout=fanouts[-1], seed=1_299_709, hop_key=len(fanouts),
              agg="mean", table_fanouts=fanouts[:-1], fuse_features=True)
    jc = jg.with_neighbor_cache(**kw)
    pc = pg.with_neighbor_cache(**kw)
    assert sorted(pc.sample_tables) == sorted(jc.sample_tables)
    for k, table in jc.sample_tables.items():
        np.testing.assert_array_equal(pc.sample_tables[k].numpy(),
                                      np.asarray(table))
        assert (pc.sample_tables[k].numpy()[[7, 13]] == -1).all()
    fused_w, fused_g = np.asarray(jc.fused_table), pc.fused_table.numpy()
    np.testing.assert_array_equal(fused_g[:, :D], fused_w[:, :D])
    np.testing.assert_allclose(fused_g[:, D:], fused_w[:, D:], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(pc.nbr_cache.numpy(), fused_g[:, D:])

    roots = np.array([0, 7, 1, 2, 13, 499, 250, 3], np.int32)
    wb = jc.sample_hop_blocks_tabularized(jnp.asarray(roots), fanouts[:-1])
    gb = pc.sample_hop_blocks_tabularized(torch.from_numpy(roots),
                                          fanouts[:-1])
    for level in range(len(fanouts)):
        np.testing.assert_array_equal(gb.node_ids[level].numpy(),
                                      np.asarray(wb.node_ids[level]))
        np.testing.assert_array_equal(gb.masks[level].numpy(),
                                      np.asarray(wb.masks[level]))
    wf, wm, wd, wc = jc.hydrate_fused(wb)
    gf, gm, gd, gc = pc.hydrate_fused(gb)
    wcc = jc.hydrate_cached(wb)
    gcc = pc.hydrate_cached(gb)
    for level in range(len(fanouts)):
        np.testing.assert_array_equal(gf[level].numpy(), np.asarray(wf[level]))
        np.testing.assert_array_equal(gd[level].numpy(), np.asarray(wd[level]))
        np.testing.assert_array_equal(gc[level].numpy(),
                                      pc.nbr_cache.numpy()[gb.node_ids[level]])
        np.testing.assert_allclose(gc[level].numpy(), np.asarray(wc[level]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(gcc[level].numpy(), gc[level].numpy())
        np.testing.assert_allclose(gcc[level].numpy(), np.asarray(wcc[level]),
                                   rtol=1e-5, atol=1e-6)


def test_unfused_cache_and_live_hydrate_match():
    jg, pg = _graphs(2)
    jc = jg.with_neighbor_cache(fanout=3, seed=0, hop_key=2)
    pc = pg.with_neighbor_cache(fanout=3, seed=0, hop_key=2)
    assert pc.fused_table is None and pc.sample_tables is None
    np.testing.assert_allclose(pc.nbr_cache.numpy(), np.asarray(jc.nbr_cache),
                               rtol=1e-5, atol=1e-6)
    roots = np.arange(0, N, 37, dtype=np.int32)
    wb = jg.sample_hop_blocks(jnp.asarray(roots), (4, 3), seed=9)
    gb = pg.sample_hop_blocks(torch.from_numpy(roots), (4, 3), seed=9)
    wf, _, wd = jg.hydrate(wb)
    gf, _, gd = pg.hydrate(gb)
    for level in range(3):
        np.testing.assert_array_equal(gf[level].numpy(), np.asarray(wf[level]))
        np.testing.assert_array_equal(gd[level].numpy(), np.asarray(wd[level]))


def test_cache_validation_errors():
    _, pg = _graphs()
    with pytest.raises(ValueError, match="agg"):
        port.build_neighbor_cache(pg.message_csr, pg.node_features, fanout=3,
                                  agg="max")
    with pytest.raises(ValueError, match="degrees"):
        port.build_neighbor_cache(pg.message_csr, pg.node_features, fanout=3,
                                  agg="gcn")
    with pytest.raises(NotImplementedError):
        pg.with_neighbor_cache(fanout=3, quantize=True)
    with pytest.raises(ValueError, match="no sample table"):
        pg.with_neighbor_cache(fanout=3, table_fanouts=(4,)) \
            .sample_hop_blocks_tabularized(torch.zeros(2, dtype=torch.int32),
                                           (5,))
