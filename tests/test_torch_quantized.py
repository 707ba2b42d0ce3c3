"""Int8 quantized tables of the port (gigl_tpu_torch.ops.quantized, K12's
plain twin; K2's int8 mode; DeviceGraph.from_hetero(quantize_features=True)
and with_neighbor_cache(quantize=True)) against the JAX reference
(gigl_tpu.ops.quantized), on the CPU where every kernel runs its twin, and
the paths over them: the NALP fit loop with the count-min sketch,
run_inference and a node-classification step.

Tolerances: the quantized rows and scales, built by the same numpy recipe,
are BIT-EQUAL, and so are the dequantizing gathers (one fp32 multiply, one
rounding to fp32 or bf16). The neighbor cache over int8 features sums the
same dequantized rows in another order: within 1e-6 absolute plus 1e-6
relative (measured up to 9.5e-7 absolute, the sum mode's entries of ~10).
The port's own quantized cache is quantized from that fp32 table, so an
entry next to a rounding boundary may land one int8 step away: at most 1
apart (measured 0 here), scales within 1e-6 relative. So the trajectories and
the serving path carry the reference's quantized tables across
(``quantized_table_from_jax``) and hold losses to 1e-5 relative and
embeddings to 1e-5 of their scale; the sketch is bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.data.mocking import cora_like
from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.inference.inferencer import (
    InferenceConfig as JaxInferenceConfig,
    run_inference as jax_run_inference,
)
from gigl_tpu.losses.losses import cross_entropy_loss as ref_ce
from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.ops import hopcache as ref_hopcache
from gigl_tpu.ops import quantized as ref_q
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu.training.trainer import (
    NodeClassificationTrainer as JaxNCTrainer,
    NodeClassificationTrainerConfig as JaxNCConfig,
)
from gigl_tpu_torch.convert import params_from_flax, quantized_table_from_jax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.inference.inferencer import InferenceConfig, run_inference
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.ops import hopcache, quantized
from gigl_tpu_torch.ops.quantized import (
    QuantizedTable,
    gather_rows_q8,
    gather_rows_q8_many,
)
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.trainer import (
    NodeClassificationTrainer,
    NodeClassificationTrainerConfig,
)
from tests.test_torch_cms import B, N, _arrays, cms_pair

torch.set_num_threads(1)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _x(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(
        0.01, 10.0, (n, 1)).astype(np.float32)
    x[3] = 0.0                                 # an all-zero row: scale 1e-12/127
    x[4, 0] = 1e-30                            # a tiny one
    return x


@pytest.mark.parametrize("d", [8, 6])
def test_quantize_bit_equal(d):
    """D = 8: the reference packs int32 lanes; D = 6: it keeps int8."""
    x = _x(50, d)
    want = ref_q.QuantizedTable.quantize(x)
    assert want.packed == (d % 4 == 0)
    got = QuantizedTable.quantize(x, device="cpu")
    assert got.q.dtype == torch.int8 and got.q.shape == (50, d)
    assert got.scale.dtype == torch.float32 and got.scale.shape == (50, 1)
    q_ref = np.ascontiguousarray(np.asarray(want.q)).view(np.int8)
    np.testing.assert_array_equal(got.q.numpy(), q_ref.reshape(50, d))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.shape == want.shape and got.dim == d
    assert got.nbytes == 50 * d + 50 * 4
    moved = quantized_table_from_jax(np.asarray(want.q),
                                     np.asarray(want.scale), d, device="cpu")
    assert torch.equal(moved.q, got.q) and torch.equal(moved.scale,
                                                       got.scale)


@pytest.mark.parametrize("d", [8, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(17,), (4, 5), (2, 3, 4)])
def test_getitem_bit_equal(d, dtype, shape):
    x = _x(40, d, seed=1)
    want_t = ref_q.QuantizedTable.quantize(x, out_dtype=JAX_DTYPES[dtype])
    got_t = QuantizedTable.quantize(x, out_dtype=TORCH_DTYPES[dtype],
                                    device="cpu")
    idx = np.random.default_rng(2).integers(0, 40, shape).astype(np.int32)
    want = np.asarray(want_t[jnp.asarray(idx)].astype(jnp.float32))
    got = got_t[idx]
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == shape + (d,)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gather_rows_q8_with_row_values():
    """K12's twin gathers the degree alongside, as K3's rows mode does."""
    t = QuantizedTable.quantize(_x(30, 8), device="cpu")
    deg = torch.arange(30, dtype=torch.float32) * 0.5
    ids = torch.tensor([[3, 29], [0, 3]], dtype=torch.int32)
    rows, vals = gather_rows_q8(t.q, t.scale, ids, torch.float32, deg)
    assert torch.equal(rows, t[ids]) and torch.equal(vals, deg[ids.long()])
    assert gather_rows_q8(t.q, t.scale, ids)[1] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [1, 2, 5, 8])
def test_gather_rows_q8_many_bit_equal(count, dtype):
    """K12's segmented call (its twin on the CPU) gives each gather's rows
    and row values as the one-gather call and the reference's
    ``__getitem__`` give them: widths 4, 12, 128 and 130 in turn, the row
    values on every other gather, gather 1 empty (where there is one)."""
    rng = np.random.default_rng(count)
    parts, refs = [], []
    deg = torch.from_numpy(rng.random(40).astype(np.float32))
    for k in range(count):
        d = (4, 12, 128, 130)[k % 4]
        x = _x(40, d, seed=k)
        refs.append(ref_q.QuantizedTable.quantize(
            x, out_dtype=JAX_DTYPES[dtype]))
        t = QuantizedTable.quantize(x, out_dtype=TORCH_DTYPES[dtype],
                                    device="cpu")
        shape = (0,) if k == 1 else (3, int(rng.integers(1, 9)))
        ids = torch.from_numpy(rng.integers(0, 40, shape).astype(np.int32))
        parts.append((t, ids, deg if k % 2 == 0 else None))
    got = QuantizedTable.gather_many(parts)
    assert len(got) == count
    for (t, ids, rv), ref, (rows, vals) in zip(parts, refs, got):
        want_rows, want_vals = gather_rows_q8(t.q, t.scale, ids,
                                              t.out_dtype, rv)
        assert rows.dtype == t.out_dtype
        assert rows.shape == tuple(ids.shape) + (t.dim,)
        assert torch.equal(rows, want_rows)
        assert (vals is None) == (rv is None)
        if rv is not None:
            assert torch.equal(vals, want_vals)
            assert torch.equal(vals, rv[ids.long()])
        want = np.asarray(ref[jnp.asarray(ids.numpy())].astype(jnp.float32))
        np.testing.assert_array_equal(rows.float().numpy(), want)


def _cached_graph():
    """The port's graph over int8 features with its own int8 cache and a
    sample table for the first hop."""
    _, pg = _graphs()
    return pg.with_neighbor_cache(fanout=3, hop_key=2, table_fanouts=(4,),
                                  quantize=True)


@pytest.mark.parametrize("tabularized", [True, False])
def test_hydrate_with_cache_equals_hydrate_and_hydrate_cached(tabularized):
    """The one-call hydrate of both int8 tables gives what ``hydrate`` and
    ``hydrate_cached`` give, bit for bit, at every level."""
    g = _cached_graph()
    roots = torch.arange(0, 90, 3, dtype=torch.int32)
    blocks = (g.sample_hop_blocks_tabularized(roots, (4,)) if tabularized
              else g.sample_hop_blocks(roots, (4, 3), seed=5))
    feats, masks, degs, cached = g.hydrate_with_cache(blocks)
    want_f, want_m, want_d = g.hydrate(blocks)
    want_c = g.hydrate_cached(blocks)
    assert len(feats) == len(cached) == len(blocks.node_ids)
    assert masks is blocks.masks and want_m is blocks.masks
    for a, b in zip(feats + degs + cached, want_f + want_d + want_c):
        assert torch.equal(a, b)
    assert torch.equal(cached[1], g.nbr_cache[blocks.node_ids[1]])


def test_one_k12_call_per_encode_chain(monkeypatch):
    """Over int8 features and an int8 cache, an encode chain hydrates
    every level of both tables through one segmented K12 call (one
    launch on the card): one call an ``encode_batch``, one per encode
    chain of a training step (anchors, positives, random negatives), and
    no one-gather call."""
    calls = []
    many = quantized.gather_rows_q8_many

    def spy(segments):
        calls.append(len(segments))
        return many(segments)

    monkeypatch.setattr(quantized, "gather_rows_q8_many", spy)
    monkeypatch.setattr(quantized, "gather_rows_q8", None)
    _, _, pt, ps = cms_pair(quantize_features=True, quantize_cache=True)
    levels = len(pt.cfg.fanouts)     # the cached hop's tree: L - 1 hops
    pt.encode_batch(np.arange(7, dtype=np.int32))
    assert calls == [2 * levels]
    calls.clear()
    pt.train_step(ps, np.arange(B, dtype=np.int32))
    assert calls == [2 * levels] * 3


def _graphs(quantize_features=True):
    src, dst, x = _arrays()
    jg = JaxDeviceGraph.from_hetero(
        JaxHeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                   node_features=x),
        quantize_features=quantize_features)
    pg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                node_features=x),
        quantize_features=quantize_features, device="cpu")
    return jg, pg


@pytest.mark.parametrize("agg", ["mean", "sum", "gcn"])
def test_build_neighbor_cache_over_int8_features(agg):
    jg, pg = _graphs()
    assert isinstance(pg.node_features, QuantizedTable)
    np.testing.assert_array_equal(
        pg.node_features.q.numpy(),
        np.asarray(jg.node_features.q).view(np.int8).reshape(N, -1))
    want = np.asarray(ref_hopcache.build_neighbor_cache(
        jg.message_csr, jg.node_features, fanout=5, seed=4, hop_key=2,
        agg=agg, degrees=jg.degrees))
    got = hopcache.build_neighbor_cache(
        pg.message_csr, pg.node_features, fanout=5, seed=4, hop_key=2,
        agg=agg, degrees=pg.degrees)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_own_quantized_cache_within_one_step():
    """with_neighbor_cache(quantize=True): K2's fp32 table quantized on the
    host; each int8 entry at most one step from the reference's."""
    jg, pg = _graphs()
    kw = dict(fanout=3, seed=5, hop_key=2, agg="mean", table_fanouts=(4,),
              quantize=True)
    want = jg.with_neighbor_cache(**kw).nbr_cache
    got = pg.with_neighbor_cache(**kw).nbr_cache
    assert isinstance(got, QuantizedTable) and got.shape == (N, 16)
    q_ref = np.asarray(want.q).view(np.int8).reshape(N, -1).astype(np.int32)
    assert np.abs(got.q.numpy().astype(np.int32) - q_ref).max() <= 1
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6, atol=0)
    # hydration of the quantized cache: the dequantized rows (K12's twin)
    ids = torch.tensor([1, 2, 9], dtype=torch.int32)
    blocks = pg.sample_hop_blocks(ids, (4,), seed=1)
    cached = pg.with_neighbor_cache(**kw).hydrate_cached(blocks)
    assert [c.shape for c in cached] == [(3, 16), (3, 4, 16)]
    assert torch.equal(cached[0], got[ids])


def test_fuse_features_needs_unquantized_tables():
    jg, pg = _graphs()
    with pytest.raises(ValueError, match="unquantized cache"):
        jg.with_neighbor_cache(fanout=3, quantize=True, fuse_features=True)
    with pytest.raises(ValueError, match="unquantized cache"):
        pg.with_neighbor_cache(fanout=3, quantize=True, fuse_features=True)
    with pytest.raises(ValueError, match="unquantized features"):
        pg.with_neighbor_cache(fanout=3, fuse_features=True)


def test_fit_threads_the_sketch():
    """Two epochs of fit with the sketch over int8 features: every step's
    candidates counted (bit-equal to the reference's sketch), the same
    validation cadence and metrics."""
    jt, js, pt, ps = cms_pair(quantize_features=True)
    anchors = np.arange(N)
    kw = dict(batch_size=B, num_epochs=2, val_every_n_batches=4,
              num_val_batches=2, early_stop_patience=10, log_every=0)
    js, want = jt.fit(js, anchors, anchors[:96], **kw)
    ps, got = pt.fit(ps, anchors, anchors[:96], **kw)
    steps = 2 * (N // B)
    assert int(ps.cms.total) == int(js.cms.total) == steps * 2 * B
    np.testing.assert_array_equal(ps.cms.table.numpy(),
                                  np.asarray(js.cms.table))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


class _Sink:
    def __init__(self):
        self.ids, self.embs = [], []

    def add_embeddings(self, ids, emb):
        self.ids.append(np.asarray(ids))
        self.embs.append(np.asarray(emb, np.float32))

    def flush(self):
        pass


class _JaxInferencer:
    def __init__(self, trainer, params):
        self.trainer, self.params = trainer, params

    def infer_batch(self, ids):
        return self.trainer.encode_batch(self.params, ids)


def test_run_inference_on_quantized_graph_matches():
    """The trained tables' serving path: int8 features and cache (the
    reference's, carried across), every node embedded."""
    jt, js, pt, ps = cms_pair(quantize_features=True, quantize_cache=True)
    jsink, psink = _Sink(), _Sink()
    jax_run_inference(_JaxInferencer(jt, js.params), N, jsink,
                      JaxInferenceConfig(batch_size=64))
    run_inference(pt, N, psink, InferenceConfig(batch_size=64),
                  device="cpu")
    for a, b in zip(jsink.ids, psink.ids):
        np.testing.assert_array_equal(a, b)
    want, got = np.concatenate(jsink.embs), np.concatenate(psink.embs)
    assert got.shape == (N, 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_node_classification_step_on_quantized_graph_matches():
    """One NodeClassificationTrainer step (GraphSAGE) over int8 features:
    the loss and every gradient."""
    jg = cora_like(num_nodes=300, num_classes=4, dim=16, avg_degree=6,
                   seed=3)
    nt = jg.metadata.node_types[0]
    coo = jg.edges[jg.metadata.edge_types[0]]
    pg = HeteroGraph.homogeneous(
        coo[0], coo[1], num_nodes=300,
        node_features=np.asarray(jg.node_features[nt]),
        node_labels=jg.node_labels[nt])
    cfg = dict(fanouts=(4, 3), seed=2)
    jt = JaxNCTrainer(JaxGNNEncoder(hid_dim=16, out_dim=4),
                      JaxDeviceGraph.from_hetero(jg, quantize_features=True),
                      JaxNCConfig(**cfg), optimizer_args={"learning_rate":
                                                          "0.01"})
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=32)
    pt = NodeClassificationTrainer(
        GNNEncoder(16, 16, 4),
        DeviceGraph.from_hetero(pg, quantize_features=True, device="cpu"),
        NodeClassificationTrainerConfig(**cfg),
        optimizer_args={"learning_rate": "0.01"}, device="cpu")
    assert isinstance(pt.graph.node_features, QuantizedTable)
    params = jax.tree_util.tree_map(np.asarray, js.params)
    pt.init_state(params=params_from_flax(params))
    nodes = np.random.default_rng(1).integers(0, 300, 32).astype(np.int32)
    def jax_loss(g, p):
        s, c = ref_ce(jt._forward(g, p, jnp.asarray(nodes), True),
                      g.node_labels[nodes])
        return s / jnp.maximum(c.astype(jnp.float32), 1.0)

    jloss, jgrad = jax.jit(jax.value_and_grad(jax_loss, argnums=1))(
        jt.graph, js.params)
    loss = pt.loss(nodes)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    for name, p in pt.model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
