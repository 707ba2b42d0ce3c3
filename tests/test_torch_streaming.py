"""The port's out-of-core trainer (gigl_tpu_torch/training/streaming.py,
its host engine gigl_tpu_torch/native and gigl_tpu_torch/utils/cast.py)
against the JAX reference's StreamingNALPTrainer and against the port's
device-resident NALPTrainer in tabularized mode, on the CPU.

The cases mirror tests/test_streaming.py: the counter RNG and the host
fanout draw, the engine's fused expand-and-gather against the numpy tree,
the sample tables and the hop-cache aggregate, six-step losses (retrieval
and margin), hard negatives, the label-edge scorer, memmapped features and
evaluate, bf16 streaming, and ``mesh=``.

Tolerances:
- integer draws, sample tables, the engine's gathers and the bf16 cast:
  bit-equal;
- the hop-cache aggregate: within 1e-5 (fp32 sums of the same rows in
  another order: the host's numpy sum against K2's twin and the
  reference's);
- losses against the JAX streamed trainer: 2e-4 relative and absolute (the
  reference test's bound: two frameworks' fp32 matmuls and Adam); against
  the port's device-resident trainer: 1e-6 relative (the same arithmetic
  on the same rows; measured bit-equal);
- bf16 streaming against fp32 streaming: 5e-2 relative and absolute (the
  reference test's bound: the streamed rows rounded to bf16 once).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.models.link_prediction import (
    EdgeFeatureScorer as JaxEdgeFeatureScorer,
    LinkPredictionDecoder as JaxDecoder,
    LinkPredictionGNN as JaxLPGNN,
)
from gigl_tpu.training import streaming as ref_streaming
from gigl_tpu.training.trainer import NALPTrainerConfig as JaxConfig
from gigl_tpu.utils.cast import to_bfloat16 as ref_to_bfloat16
from gigl_tpu_torch import native
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    EdgeFeatureScorer,
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.sampling.neighbor_sampler import (
    counter_rng_uniform,
    sample_neighbors,
)
from gigl_tpu_torch.training import streaming
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.trainer import NALPTrainer, NALPTrainerConfig
from gigl_tpu_torch.utils.cast import stream_cast_from_str, to_bfloat16

torch.set_num_threads(1)

N, E, D, HID, OUT = 600, 6000, 12, 16, 8
FANOUTS = (5, 4)
OPT = {"learning_rate": "1e-2"}
B, K = 16, 6


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    return src, dst, rng.normal(size=(N, D)).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _anchors(k=K, b=B):
    return (np.arange(b * k).reshape(k, b) % N).astype(np.int32)


def _setup(loss_type="retrieval", hard=False, edge_feats=False,
           features=None, stream_dtype=None):
    """The JAX streamed trainer and its first params, the port's streamed
    trainer and the port's device-resident tabularized trainer, both with
    the JAX params."""
    src, dst, x = _arrays()
    feats = x if features is None else features
    edges = np.stack([src, dst])
    rng = np.random.default_rng(9)
    extra, store_extra = {}, {}
    if hard:
        hard_edges = np.stack([rng.integers(0, N, 3000),
                               rng.integers(0, N, 3000)])
        extra["hard_neg_edges"] = store_extra["hard_neg_edges"] = hard_edges
    if edge_feats:
        sup_ef = np.random.default_rng(4).normal(size=(E, 3)).astype(
            np.float32)
        extra["supervision_edge_features"] = sup_ef
        store_extra["supervision_edge_features"] = sup_ef
    kw = dict(fanouts=FANOUTS, num_random_negs=64, loss_type=loss_type,
              num_hard_negs=3 if hard else 0, cached_hop=True)
    jstore = ref_streaming.HostGraphStore.build(
        message_edges=edges, supervision_edges=edges, features=x,
        num_nodes=N, fanouts=FANOUTS, seed=0, **store_extra)
    jmodel = JaxLPGNN(
        encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT, num_layers=2,
                              conv="graphsage"), decoder=JaxDecoder(),
        edge_scorer=JaxEdgeFeatureScorer(hidden_dim=8) if edge_feats
        else None)
    jt = ref_streaming.StreamingNALPTrainer(jmodel, jstore, JaxConfig(**kw),
                                            optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    params = params_from_flax(_np(js.params))

    def model():
        return LinkPredictionGNN(
            GNNEncoder(D, HID, OUT, num_layers=2, conv="graphsage"),
            LinkPredictionDecoder(),
            EdgeFeatureScorer(3, 8) if edge_feats else None)

    store = streaming.HostGraphStore.build(
        message_edges=edges, supervision_edges=edges, features=feats,
        num_nodes=N, fanouts=FANOUTS, seed=0, **store_extra)
    st = streaming.StreamingNALPTrainer(
        model(), store, NALPTrainerConfig(**kw), optimizer_args=OPT,
        stream_dtype=stream_dtype, device="cpu")
    ss = st.init_state(params=params)
    dg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                node_features=x),
        supervision_edges=edges, device="cpu", **extra)
    dt = NALPTrainer(model(), dg, NALPTrainerConfig(**kw),
                     optimizer_args=OPT, device="cpu")
    ds = dt.init_state(params=params)
    return jt, js, st, ss, dt, ds


# -- the RNG, the draws, the engine -------------------------------------------
def test_counter_rng_bit_equal():
    """The numpy mirror against the port's device sampler's RNG (K1's
    twin) and the reference's numpy mirror."""
    ids = np.arange(257, dtype=np.int32)
    host = streaming.np_counter_rng_uniform(ids, seed=42, hop=7,
                                            num_slots=5)
    dev = counter_rng_uniform(torch.from_numpy(ids), 42, 7, 5).numpy()
    np.testing.assert_array_equal(host.astype(np.int64), dev)
    np.testing.assert_array_equal(
        host, ref_streaming.np_counter_rng_uniform(ids, seed=42, hop=7,
                                                   num_slots=5))


@pytest.mark.parametrize("fanout,hop", [(6, 3), (1, 1), (40, 2**31 + 5)])
def test_sample_fanout_bit_equal(fanout, hop):
    """np_sample_fanout and the engine's sample_fanout against the port's
    device sampler (K1's twin) and the reference's mirror: ids, masks and
    CSR slots bit-equal, over every node (isolated ones included)."""
    src, dst, x = _arrays()
    dg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N, node_features=x), device="cpu")
    indptr = dg.message_csr.indptr.numpy().astype(np.int64)
    indices = dg.message_csr.indices.numpy().astype(np.int32)
    roots = np.arange(N, dtype=np.int32)
    d_nbr, d_mask, _ = sample_neighbors(dg.message_csr,
                                        torch.from_numpy(roots), fanout,
                                        seed=11, hop=hop)
    nbr, mask, slots = streaming.np_sample_fanout(
        indptr, indices, roots, fanout, seed=11, hop=hop, return_slots=True)
    e_nbr, e_mask, e_slots = native.sample_fanout(indptr, indices, roots,
                                                  fanout, seed=11, hop=hop)
    r_nbr, r_mask = ref_streaming.np_sample_fanout(indptr, indices, roots,
                                                   fanout, seed=11, hop=hop)
    for a, b_ in ((nbr, d_nbr.numpy()), (mask, d_mask.numpy()),
                  (e_nbr, nbr), (e_mask, mask), (e_slots, slots),
                  (r_nbr, nbr), (r_mask, mask)):
        np.testing.assert_array_equal(a, b_)


def test_engine_gather_and_cast():
    """The engine's gather against numpy indexing (an index out of range
    raises), and the bf16 cast bit-equal to the reference's (NaN, +-inf,
    +-0, ties)."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, (4, 9))
    np.testing.assert_array_equal(native.gather_f32(table, idx), table[idx])
    with pytest.raises(IndexError, match="out of range"):
        native.gather_f32(table, np.array([3, 50]))
    x = (rng.normal(size=4096) * 1e3).astype(np.float32)
    x[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0 + 2.0 ** -8]
    np.testing.assert_array_equal(to_bfloat16(x),
                                  ref_to_bfloat16(x).view(np.uint16))
    tdt, ndt, cast = stream_cast_from_str("bfloat16")
    assert tdt == torch.bfloat16 and ndt == np.uint16
    out = np.empty(x.shape, np.int16)
    cast(x, out=out.view(np.uint16))
    back = torch.from_numpy(out).view(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(back[6:], torch.from_numpy(x[6:]).to(
        torch.bfloat16).float().numpy())
    with pytest.raises(ValueError, match="stream dtype"):
        stream_cast_from_str("float16")
    # the engine's bf16 rows (cast in its gather pass) are the same bits
    tab = x[:4096].reshape(512, 8)
    ids = rng.integers(0, 512, 300).astype(np.int32)
    _, _, f16, a16, d = native.expand_gather(
        ids, None, None, None, tab, tab[::-1].copy(), np.arange(
            512, dtype=np.float32), bf16=True)
    np.testing.assert_array_equal(f16, to_bfloat16(tab[ids]))
    np.testing.assert_array_equal(a16, to_bfloat16(tab[::-1][ids]))
    np.testing.assert_array_equal(d, ids.astype(np.float32))


def test_expand_gather_matches_numpy_tree():
    """The streamed trees (one engine call a level) equal the numpy
    assembly (np_tree) and the reference's engine assembly, bit for bit,
    for all four groups of a batch with hard negatives."""
    jt, _, st, _, _, _ = _setup(hard=True)
    batch = st.prepare_batch(_anchors()[0], 3)
    want_b = jt.prepare_batch(_anchors()[0], 3)
    for g in ("q", "pos", "rand", "hard"):
        got = getattr(batch, g)
        roots = {"q": batch.ids.anchors, "pos": batch.ids.pos,
                 "rand": batch.ids.random_neg, "hard": batch.ids.hard_neg}[g]
        want = streaming.np_tree(st.store, roots, FANOUTS[:-1])
        ref = getattr(want_b, g)
        for field in ("feats", "cached", "masks", "degs"):
            for lv, (a, b_, r) in enumerate(zip(getattr(got, field),
                                                getattr(want, field),
                                                getattr(ref, field))):
                np.testing.assert_array_equal(a, b_, err_msg=f"{g} {field}")
                np.testing.assert_array_equal(a, r, err_msg=f"{g} {field}")
    for name in ("anchors", "pos", "pos_mask", "hard_neg", "hard_neg_mask",
                 "random_neg"):
        np.testing.assert_array_equal(getattr(batch.ids, name),
                                      np.asarray(getattr(want_b.ids, name)))


def test_expand_gather_out_of_range_raises():
    feats = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="out of range"):
        native.expand_gather(np.array([9], np.int32), None, None, None,
                             feats, feats, np.zeros(4, np.float32))
    ids_t = np.full((4, 2), 7, np.int32)
    with pytest.raises(ValueError, match="out of range"):
        native.expand_gather(np.array([1], np.int32), None, ids_t,
                             np.ones((4, 2), bool), feats, feats,
                             np.zeros(4, np.float32))


def test_sample_tables_and_agg_match():
    """The store's frozen tables bit-equal to the device-resident
    tabularized tables (packed -1 = invalid) and to the reference store's;
    the hop-cache aggregate within 1e-5 of K2's twin and of the
    reference's."""
    jt, _, st, _, dt, _ = _setup()
    packed = dt.graph.sample_tables[5].numpy()
    ids_t, mask_t = st.store.sample_tables[5]
    r_ids, r_mask = jt.store.sample_tables[5]
    np.testing.assert_array_equal(packed >= 0, mask_t)
    np.testing.assert_array_equal(np.where(packed >= 0, packed, 0),
                                  np.where(mask_t, ids_t, 0))
    np.testing.assert_array_equal(ids_t, r_ids)
    np.testing.assert_array_equal(mask_t, r_mask)
    np.testing.assert_allclose(st.store.agg.array, dt.graph.nbr_cache.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.store.agg.array, jt.store.agg._np,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(st.store.degrees, jt.store.degrees)


# -- training -------------------------------------------------------------------
@pytest.mark.parametrize("loss_type", ["retrieval", "margin"])
def test_losses_match_jax_and_device_resident(loss_type):
    """Six steps through the ring (prefetch 2) from the JAX params: the
    losses against the reference's streamed trainer (2e-4) and against
    the port's device-resident tabularized trainer (1e-6 relative)."""
    jt, js, st, ss, dt, ds = _setup(loss_type)
    anchors = _anchors()
    _, want = jt.run_steps(js, anchors, jax.random.PRNGKey(7))
    _, got = st.run_steps(ss, anchors)
    _, dev = dt.train_steps(ds, anchors)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, dev.numpy(), rtol=1e-6)


def test_hard_negatives_stream_with_device_parity():
    """Streamed hard negatives (3 a row, hop 2_000_003 + step on the
    hard-negative CSR): the losses of the reference and of the
    device-resident trainer; a store without hard_neg_edges is refused."""
    jt, js, st, ss, dt, ds = _setup(hard=True)
    anchors = _anchors(4)
    _, want = jt.run_steps(js, anchors, jax.random.PRNGKey(7))
    _, got = st.run_steps(ss, anchors, prefetch=1)
    _, dev = dt.train_steps(ds, anchors)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, dev.numpy(), rtol=1e-6)
    plain = dataclasses.replace(st.store, hard_neg_indptr=None,
                                hard_neg_indices=None)
    with pytest.raises(ValueError, match="hard_neg_edges"):
        streaming.StreamingNALPTrainer(st.model, plain, st.cfg,
                                       device="cpu")


def test_label_edge_scorer_streams_with_parity():
    """The positives' label-edge rows (CSR slot order, zero at padded
    draws) streamed with the batch, through the scorer: the losses of the
    reference and of the device-resident trainer."""
    jt, js, st, ss, dt, ds = _setup(edge_feats=True)
    anchors = _anchors(4)
    _, want = jt.run_steps(js, anchors, jax.random.PRNGKey(7))
    _, got = st.run_steps(ss, anchors)
    _, dev = dt.train_steps(ds, anchors)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, dev.numpy(), rtol=1e-6)


def test_mmap_features_train_step_and_evaluate(tmp_path):
    """Features in an np.memmap on disk (read in place, not copied): the
    same losses as from RAM, train_step over a prepared batch equal to
    the ring's first step, and evaluate against the reference's."""
    src, dst, x = _arrays()
    path = tmp_path / "feats.bin"
    x.tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=x.shape)
    jt, js, st, ss, _, _ = _setup(features=mm)
    assert isinstance(st.store.features.array, np.memmap) or isinstance(
        st.store.features.array.base, np.memmap)
    anchors = _anchors(3)
    p0 = jax.tree_util.tree_map(jnp.copy, js.params)   # run_steps donates
    _, want = jt.run_steps(js, anchors, jax.random.PRNGKey(7))
    first = {k: v.clone() for k, v in st.model.state_dict().items()}
    _, got = st.run_steps(ss, anchors)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    st.model.load_state_dict(first)
    s0 = st.init_state(params=first)
    _, one = st.train_step(s0, st.prepare_batch(anchors[0], 0))
    assert float(one) == got[0]
    st.model.load_state_dict(first)
    got_m = st.evaluate(anchors[:2])
    want_m = jt.evaluate(p0, anchors[:2])
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert abs(got_m[k] - want_m[k]) <= 1e-6, k


def test_bf16_streaming_close_to_fp32():
    """stream_dtype="bfloat16": the rows cross as bf16 bit patterns (an
    int16 buffer viewed as bfloat16 on the device); four steps within 5e-2
    of the fp32 stream's losses, and the batch's rows bit-equal to the
    fp32 rows cast once."""
    _, _, st, ss, _, _ = _setup()
    first = {k: v.clone() for k, v in st.model.state_dict().items()}
    anchors = _anchors(4)
    _, l32 = st.run_steps(ss, anchors)
    bf = streaming.StreamingNALPTrainer(
        st.model, st.store, st.cfg, optimizer_args=OPT,
        stream_dtype="bfloat16", device="cpu")
    sb = bf.init_state(params=first)
    _, lbf = bf.run_steps(sb, anchors)
    np.testing.assert_allclose(lbf, l32, rtol=5e-2, atol=5e-2)
    b32, b16 = (t.prepare_batch(anchors[0], 0) for t in (st, bf))
    for a, b_ in zip(b32.q.feats + b32.q.cached, b16.q.feats + b16.q.cached):
        assert b_.dtype == np.int16
        np.testing.assert_array_equal(b_.view(np.uint16), to_bfloat16(a))


def test_mesh_is_not_ported():
    _, _, st, _, _, _ = _setup()
    with pytest.raises(NotImplementedError, match="A16"):
        streaming.StreamingNALPTrainer(st.model, st.store, st.cfg,
                                       mesh=object(), device="cpu")


def test_store_keeps_node_labels_and_refuses_stray_hard_features():
    src, dst, x = _arrays()
    edges = np.stack([src, dst])
    labels = np.arange(N) % 5
    store = streaming.HostGraphStore.build(
        message_edges=edges, supervision_edges=edges, features=x,
        num_nodes=N, fanouts=FANOUTS, node_labels=labels)
    assert store.node_labels.dtype == np.int32
    np.testing.assert_array_equal(store.node_labels, labels)
    with pytest.raises(ValueError, match="needs hard_neg_edges"):
        streaming.HostGraphStore.build(
            message_edges=edges, supervision_edges=edges, features=x,
            num_nodes=N, fanouts=FANOUTS,
            hard_neg_edge_features=np.zeros((3, 2), np.float32))


def test_entry_points_default_to_cuda():
    """device=None runs on CUDA and raises without it."""
    _, _, st, _, _, _ = _setup()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            streaming.StreamingNALPTrainer(st.model, st.store, st.cfg)


def test_ring_with_many_workers_matches_sequential_steps():
    """More fill workers than cores over a ring of 7 slots, with a short
    thread switch interval: the same losses as the steps run one batch at
    a time (prefetch 0), bit for bit — a slot refilled before its step
    read it would change them."""
    import os
    import sys

    _, _, st, _, _, _ = _setup()
    first = {k: v.clone() for k, v in st.model.state_dict().items()}
    anchors = _anchors(12)
    _, seq = st.run_steps(st.init_state(params=first), anchors, prefetch=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, par = st.run_steps(st.init_state(params=first), anchors,
                              prefetch=max(6, (os.cpu_count() or 1) + 1))
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(par, seq)
