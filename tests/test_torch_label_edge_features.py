"""Parity of the port's label-edge features and edge-featured sampled
training (gigl_tpu_torch: ``DeviceGraph`` / ``HeteroDeviceGraph`` label
edge tables and draws, ``EdgeFeatureScorer``, the scorer's terms in
``nalp_loss_from_embeddings``, ``NALPTrainer`` over an edge-featured graph)
and of SimpleHGN's block form on K7 with its per-slot logit bias, with the
JAX reference on the CPU, where every kernel runs its plain twin.

Tolerances: draws, tables and hydrated rows bit-equal; fp32 20-step loss
trajectories within 1e-3 relative (the NALP trajectories' bound,
tests/test_torch_training.py: the same math drifting through Adam); fp32
first-step gradients within 1e-4 of each parameter's scale (floored at
1e-1 of the largest for the candidate type's last bias, zero by symmetry,
as tests/test_torch_hetero_training.py does); SimpleHGN's block form
(forward and every gradient) within 1e-5 of the scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as RefHeteroGraph
from gigl_tpu.models import hetero_convs as ref_hconvs
from gigl_tpu.models.encoders import GNNEncoder as RefGNNEncoder
from gigl_tpu.models.hetero_encoders import HeteroGNNEncoder as RefEncoder
from gigl_tpu.models.link_prediction import (
    EdgeFeatureScorer as RefScorer,
    HeteroLinkPredictionGNN as RefHeteroLP,
    LinkPredictionDecoder as RefDecoder,
    LinkPredictionGNN as RefLPGNN,
)
from gigl_tpu.training.dataset import DeviceGraph as RefDeviceGraph
from gigl_tpu.training.hetero_dataset import (
    HeteroDeviceGraph as RefHeteroDeviceGraph,
)
from gigl_tpu.training.hetero_trainer import (
    HeteroNALPTrainer as RefHeteroTrainer,
    HeteroNALPTrainerConfig as RefHeteroTrainerConfig,
)
from gigl_tpu.training.trainer import (
    NALPTrainer as RefTrainer,
    NALPTrainerConfig as RefTrainerConfig,
)
from gigl_tpu.types.graph import EdgeType as RefEdgeType
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models import hetero_convs
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.hetero_encoders import HeteroGNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    EdgeFeatureScorer,
    HeteroLinkPredictionGNN,
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
from gigl_tpu_torch.training.hetero_trainer import (
    HeteroNALPTrainer,
    HeteroNALPTrainerConfig,
)
from gigl_tpu_torch.training.trainer import NALPTrainer, NALPTrainerConfig
from gigl_tpu_torch.types.graph import EdgeType
from tests.test_torch_hetero_training import (
    DBLP_CFG,
    DBLP_OPT,
    DIMS,
    EDGE_TYPES,
    NODE_TYPES,
    WRITES,
    _dblp_graphs,
    _yaml_paths,
)

torch.set_num_threads(1)

N, E, D, DE, DS, HID, OUT, B = 300, 2400, 12, 4, 3, 16, 8, 32
FANOUTS = (4, 3)
OPT = {"learning_rate": "0.01"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _arrays(seed=0):
    """A graph with message-edge features, its supervision edges (the
    message edges, with their own label features; anchors 5 and 77 have
    none) and hard negatives with theirs."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    keep = ~np.isin(dst, (5, 77))
    src, dst = src[keep], dst[keep]
    hard = np.stack([rng.integers(0, N, 700), rng.integers(0, N, 700)])
    return dict(
        src=src, dst=dst, x=rng.normal(size=(N, D)).astype(np.float32),
        ea=rng.normal(size=(len(src), DE)).astype(np.float32),
        sup_ef=rng.normal(size=(len(src), DS)).astype(np.float32),
        hard=hard, hard_ef=rng.normal(size=(700, DS)).astype(np.float32))


def _graphs(seed=0):
    a = _arrays(seed)
    kw = dict(supervision_edges=np.stack([a["src"], a["dst"]]),
              hard_neg_edges=a["hard"],
              supervision_edge_features=a["sup_ef"],
              hard_neg_edge_features=a["hard_ef"])
    jg = RefDeviceGraph.from_hetero(RefHeteroGraph.homogeneous(
        a["src"], a["dst"], num_nodes=N, node_features=a["x"],
        edge_features=a["ea"]), **kw)
    pg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        a["src"], a["dst"], num_nodes=N, node_features=a["x"],
        edge_features=a["ea"]), device="cpu", **kw)
    return jg, pg


# -- tables and draws ----------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 3])
def test_label_edge_draws_bit_equal(step):
    """The label tables in CSR slot order and each step's drawn positives
    and hard negatives with their features, bit-equal (padded draws read
    their anchor's first slot, as the reference's do)."""
    jg, pg = _graphs()
    for name in ("sup_edge_features", "hard_neg_edge_features",
                 "edge_features"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    anchors = np.random.default_rng(1).integers(0, N, B).astype(np.int32)
    anchors[:2] = (5, 77)
    kw = dict(num_positives=2, num_hard_negs=3, num_random_negs=16, seed=4,
              step=step)
    want = jg.sample_nalp_batch(jnp.asarray(anchors), **kw)
    got = pg.sample_nalp_batch(torch.from_numpy(anchors), **kw)
    for name in ("pos", "pos_mask", "hard_neg", "hard_neg_mask",
                 "random_neg", "pos_edge_feats", "hard_neg_edge_feats"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.pos_edge_feats.shape == (B, 2, DS)


def _typed_graphs():
    port_g, ref_g, edges, hard = _dblp_graphs()
    paths, ref_paths = _yaml_paths()
    rng = np.random.default_rng(2)
    sup_ef = rng.normal(size=(edges[WRITES].shape[1], DS)).astype(np.float32)
    hard_ef = rng.normal(size=(hard.shape[1], DS)).astype(np.float32)
    sup = dict(supervision_edges=edges[WRITES], hard_neg_edges=hard,
               supervision_anchor="dst", supervision_edge_features=sup_ef,
               hard_neg_edge_features=hard_ef)
    rdg = RefHeteroDeviceGraph.from_hetero(
        ref_g, ref_paths, supervision_edge_type=RefEdgeType.from_str(WRITES),
        **sup)
    dg = HeteroDeviceGraph.from_hetero(
        port_g, paths, supervision_edge_type=EdgeType.from_str(WRITES),
        device="cpu", **sup)
    return rdg, dg, ref_paths, paths


@pytest.mark.parametrize("step", [0, 5])
def test_typed_label_edge_draws_bit_equal(step):
    """The typed draws with their label features (the rows of padded
    draws zeroed, ``hetero_dataset.py:310-312``) and the typed batch."""
    rdg, dg, _, _ = _typed_graphs()
    np.testing.assert_array_equal(dg.sup_edge_features.numpy(),
                                  np.asarray(rdg.sup_edge_features))
    anchors = np.array([3, 7, 0, 11, 79, 3, 40], np.int32)
    ja, ta = jnp.asarray(anchors), torch.from_numpy(anchors)
    for jf, tf, k in (("sample_positives_with_feats",
                       "sample_positives_with_feats", 2),
                      ("sample_hard_negatives_with_feats",
                       "sample_hard_negatives_with_feats", 3)):
        want = getattr(rdg, jf)(ja, k, seed=4, step=step)
        got = getattr(dg, tf)(ta, k, seed=4, step=step)
        for w, t in zip(want, got):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    batch = dg.sample_nalp_batch(ta, "author", num_positives=2,
                                 num_hard_negs=3, num_random_negs=8, seed=4,
                                 step=step)
    want = rdg.sample_positives_with_feats(ja, 2, seed=4, step=step)[2]
    np.testing.assert_array_equal(batch.pos_edge_feats.numpy(),
                                  np.asarray(want))
    assert not batch.pos_edge_feats[~batch.pos_mask].any()


# -- the scorer ---------------------------------------------------------------------
def test_edge_feature_scorer_and_decode_match_jax():
    rng = np.random.default_rng(3)
    ef = rng.normal(size=(6, 4, DS)).astype(np.float32)
    q, c = (rng.normal(size=(6, 4, OUT)).astype(np.float32) for _ in "qc")
    ref = RefLPGNN(encoder=RefGNNEncoder(hid_dim=HID, out_dim=OUT),
                   decoder=RefDecoder(), edge_scorer=RefScorer(hidden_dim=8))
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(c),
                      jnp.asarray(ef), method="decode")
    model = LinkPredictionGNN(GNNEncoder(D, HID, OUT),
                              LinkPredictionDecoder(),
                              EdgeFeatureScorer(DS, hidden_dim=8))
    # a decode-only init holds the scorer alone (no encoder subtree)
    sd = params_from_flax({"encoder": {}, **_np(params["params"])})
    assert set(sd) == {"edge_scorer.e0.weight", "edge_scorer.e0.bias",
                       "edge_scorer.e1.weight", "edge_scorer.e1.bias"}
    model.load_state_dict(sd, strict=False)
    with torch.no_grad():
        got = model.decode(*(torch.from_numpy(a) for a in (q, c, ef)))
        score = model.edge_score(torch.from_numpy(ef))
        plain = model.decode(torch.from_numpy(q), torch.from_numpy(c))
    want = ref.apply(params, q, c, ef, method="decode")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref.apply(
        params, ef, method="edge_score")), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(plain.numpy(), (q * c).sum(-1), rtol=1e-5)
    with pytest.raises(ValueError, match="without an edge_scorer"):
        LinkPredictionGNN(GNNEncoder(D, HID, OUT),
                          LinkPredictionDecoder()).edge_score(
            torch.from_numpy(ef))


# -- homogeneous NALP training with edges and the scorer -----------------------------
@functools.lru_cache(maxsize=None)
def _ref_trainer(loss_type):
    """The reference trainer over the edge-featured graph (EdgeAttrGAT,
    edge_dim, the scorer) and its initial params (cached: its jitted
    steps compile once). The reference's ``init_state`` traces the
    encoder without edge features, which leaves ``edge_in_proj`` and
    ``lin_edge`` out of the tree, so the params come from ``warmup`` over
    a hydrated batch with its edge rows."""
    jg, pg = _graphs()
    cfg = dict(fanouts=FANOUTS, num_positives=2, num_hard_negs=1,
               num_random_negs=B, loss_type=loss_type, seed=3,
               eval_ks=(1, 10))
    model = RefLPGNN(
        encoder=RefGNNEncoder(hid_dim=HID, out_dim=OUT, conv="edge_attr_gat",
                              conv_kwargs={"heads": 2}, edge_dim=DE),
        decoder=RefDecoder(), edge_scorer=RefScorer(hidden_dim=8))
    jt = RefTrainer(model, jg, RefTrainerConfig(**cfg), optimizer_args=OPT)
    blocks = jg.sample_hop_blocks(jnp.zeros((B,), jnp.int32), FANOUTS)
    feats, masks, _ = jg.hydrate(blocks)
    params = model.init(jax.random.PRNGKey(0), feats, masks,
                        jg.hydrate_edges(blocks),
                        label_edge_feats=jnp.zeros((1, DS)),
                        method="warmup")
    return jt, _np(params), pg, cfg


def _nalp_pair(loss_type):
    jt, params, pg, cfg = _ref_trainer(loss_type)
    js = jt.init_state(None, B, params=jax.tree_util.tree_map(jnp.asarray,
                                                              params))
    model = LinkPredictionGNN(
        GNNEncoder(D, HID, OUT, conv="edge_attr_gat",
                   conv_kwargs={"heads": 2}, edge_dim=DE),
        LinkPredictionDecoder(), EdgeFeatureScorer(DS, hidden_dim=8))
    pt = NALPTrainer(model, pg, NALPTrainerConfig(**cfg), optimizer_args=OPT,
                     device="cpu")
    ps = pt.init_state(params=params_from_flax(params))
    return jt, js, pt, ps


def _anchors(k, seed=1):
    return np.random.default_rng(seed).integers(0, N, (k, B)).astype(
        np.int32)


@pytest.mark.parametrize("loss_type", ["retrieval", "margin"])
def test_nalp_trajectory_with_edges_and_scorer_matches_jax(loss_type):
    """20 fp32 steps of the live, uncached path: the message edges' rows
    hydrated per hop (K3), EdgeAttrGAT's blocks, the label-edge terms on
    the positives and the hard negatives."""
    jt, js, pt, ps = _nalp_pair(loss_type)
    akb = _anchors(20)
    js, want = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
    assert np.isfinite(want).all() and want[-5:].mean() < want[:5].mean()
    val = _anchors(2, seed=9)
    assert pt.evaluate(val) == pytest.approx(
        jt.evaluate(js.params, val), rel=1e-4, abs=1e-6)


def _grads_close(model, want, tol):
    """Each gradient within ``tol`` of its scale, floored at 1e-1 of the
    largest (a gradient zero by symmetry is rounding noise)."""
    assert {n for n, _ in model.named_parameters()} == set(want)
    floor = 1e-1 * max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None, name
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(p.grad.float().numpy() - w).max())
        assert err <= tol * scale, (name, err, scale)


def test_nalp_first_step_gradients_with_edges_match_jax():
    """Every gradient of one retrieval step, edge_in_proj's, each layer's
    lin_edge and the scorer's included."""
    jt, js, pt, _ = _nalp_pair("retrieval")
    anchors = _anchors(1)[0]
    jb = jt.graph.sample_nalp_batch(jnp.asarray(anchors), num_positives=2,
                                    num_hard_negs=1, num_random_negs=B,
                                    seed=3, step=0)
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(jt.graph, p, jb, None, None), has_aux=True))(
            js.params)
    want = params_from_flax(_np(jgrad))
    assert {"encoder.edge_in_proj.weight", "edge_scorer.e0.weight",
            "encoder.convs.0.lin_edge.weight"} <= set(want)
    loss = pt.loss(pt.sample_batch(anchors, 0))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    _grads_close(pt.model, want, 1e-4)


# -- typed training with the scorer -----------------------------------------------------
@functools.lru_cache(maxsize=None)
def _typed_ref(conv):
    rdg, dg, ref_paths, paths = _typed_graphs()
    kw = {"heads": 2}
    ref_model = RefHeteroLP(
        encoder=RefEncoder(hid_dim=16, out_dim=8, num_layers=2, conv=conv,
                           node_types=NODE_TYPES, edge_types=EDGE_TYPES,
                           **kw),
        decoder=RefDecoder(), edge_scorer=RefScorer(hidden_dim=8))
    cfg = {**DBLP_CFG, "num_hard_negs": 1}
    rt = RefHeteroTrainer(ref_model, rdg, ref_paths,
                          RefHeteroTrainerConfig(**cfg),
                          optimizer_args=DBLP_OPT)
    params = _np(rt.init_state(jax.random.PRNGKey(1), batch_size=16).params)
    return rt, params, dg, paths, cfg


def _typed_pair(conv):
    rt, params, dg, paths, cfg = _typed_ref(conv)
    model = HeteroLinkPredictionGNN(
        HeteroGNNEncoder(16, 8, NODE_TYPES, EDGE_TYPES, DIMS, conv=conv,
                         heads=2),
        LinkPredictionDecoder(), EdgeFeatureScorer(DS, hidden_dim=8))
    pt = HeteroNALPTrainer(model, dg, paths, HeteroNALPTrainerConfig(**cfg),
                           optimizer_args=DBLP_OPT, device="cpu")
    ps = pt.init_state(params=params_from_flax(params))
    js = rt.init_state(None, 16, params=jax.tree_util.tree_map(jnp.asarray,
                                                               params))
    return rt, js, pt, ps


@pytest.mark.parametrize("conv", ["hgt", "simple_hgn"])
def test_typed_trajectory_with_scorer_matches_jax(conv):
    """20 fp32 steps of typed NALP training with label-edge features on
    the author-writes-paper supervision edges and the scorer: HGT (K7's
    Transformer mode) and SimpleHGN (K7's GAT mode with the per-slot
    relation bias, backward K7b)."""
    rt, js, pt, ps = _typed_pair(conv)
    akb = np.random.default_rng(4).integers(0, 80, (20, 16)).astype(np.int32)
    js, want = rt.train_steps(js, akb, jax.random.PRNGKey(3))
    ps, got = pt.train_steps(ps, akb)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
    assert np.isfinite(want).all() and want[-5:].mean() < want[:5].mean()
    batches = [np.arange(16, dtype=np.int32), np.arange(16, 32,
                                                        dtype=np.int32)]
    got_m, want_m = pt.evaluate(batches), rt.evaluate(js.params, batches)
    assert got_m == pytest.approx(want_m, rel=1e-4, abs=1e-6)


# -- SimpleHGN's block form on K7 with the relation bias ------------------------------
def test_simple_hgn_block_matches_jax_with_empty_rows_and_relations():
    """One SimpleHGN layer's block form: a paper row set with three child
    relations, rows with no valid slot anywhere, and one relation with no
    valid slot at all (the reference masks with finfo.min and a plain
    softmax; K7 gives such rows 0, as the reference's mask does). Forward
    and every gradient (the relation bias's through edge_emb, w_rel and
    att_rel) within 1e-5 of the scale."""
    rng = np.random.default_rng(5)
    m, hid, heads = 10, 16, 2
    ref = ref_hconvs.SimpleHGNConv(out_dim=hid, node_types=NODE_TYPES,
                                   edge_types=EDGE_TYPES, heads=heads)
    x_dst = rng.normal(size=(m, hid)).astype(np.float32)
    kids = [(rng.normal(size=(m, k, hid)).astype(np.float32),
             rng.random((m, k)) < 0.6, et, nt)
            for k, et, nt in ((5, WRITES, "author"), (4, EDGE_TYPES[2],
                                                     "paper"),
                              (3, EDGE_TYPES[1], "author"))]
    for x_, mk, _, _ in kids:
        mk[:2] = False                     # rows 0, 1: no valid slot
    kids[2][1][:] = False                  # a relation with no valid slot

    def jf(p, x, a, b, c):
        return ref.apply(p, x, "paper", [
            (a, kids[0][1], kids[0][2], kids[0][3]),
            (b, kids[1][1], kids[1][2], kids[1][3]),
            (c, kids[2][1], kids[2][2], kids[2][3])])

    params = jax.tree_util.tree_map(np.asarray, ref.init(
        jax.random.PRNGKey(2), jnp.asarray(x_dst), "paper",
        [(jnp.asarray(k[0]), k[1], k[2], k[3]) for k in kids]))
    # a relation term of a size that matters (flax draws edge_emb at 0.02)
    params["params"]["edge_emb"] = rng.normal(
        size=params["params"]["edge_emb"].shape).astype(np.float32)
    cot = rng.normal(size=(m, hid)).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, c, *a):
        out, vjp = jax.vjp(jf, p, *a)
        return out, vjp(c)

    want, wg = fwd_bwd(params, jnp.asarray(cot), jnp.asarray(x_dst),
                       *(jnp.asarray(k[0]) for k in kids))
    conv = hetero_convs.SimpleHGNConv(hid, hid, NODE_TYPES, EDGE_TYPES,
                                      heads=heads)
    sd = {k[len("convs.0."):]: v for k, v in params_from_flax(
        {"in_author": {"kernel": np.zeros((1, 1))},
         "conv_0": _np(params["params"])}).items() if k.startswith("convs")}
    conv.load_state_dict(sd)
    tx = torch.from_numpy(x_dst).requires_grad_()
    tk = [torch.from_numpy(k[0]).requires_grad_() for k in kids]
    got = conv(tx, "paper", [(t, torch.from_numpy(k[1]), k[2], k[3])
                             for t, k in zip(tk, kids)])
    w = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    got.backward(torch.from_numpy(cot))
    gp = {k[len("convs.0."):]: v for k, v in params_from_flax(
        {"in_author": {"kernel": np.zeros((1, 1))},
         "conv_0": _np(wg[0]["params"])}).items() if k.startswith("convs")}
    for name, p in conv.named_parameters():
        ref_g = gp[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref_g, rtol=0,
                                   atol=1e-5 * np.abs(ref_g).max(),
                                   err_msg=name)
    for t, r in zip([tx] + tk, wg[1:]):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
    assert not tk[2].grad.any()            # the empty relation's rows
