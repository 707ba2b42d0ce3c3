"""The port's label-edge features over the PARTITIONED graph (routed draws
that carry the drawn edges' rows, ``PartitionedGraph.build`` with
``sup_edge_feats`` / ``hard_edge_feats``, ``ring_own_block_edge_bias`` and
the ring loss with the own-block bias, ``PartitionedNALPTrainer`` with an
``EdgeFeatureScorer``) against the JAX reference on the virtual CPU mesh,
on the CPU, where K1, K3, K15, K16 and K17's bias mode run their plain
twins. The toy: 256 nodes, 2,048 edges, D 16, 3 label-edge features a
supervision and hard-negative edge, fanouts (5, 3), GraphSAGE hidden 32,
out 16, an EdgeFeatureScorer of hidden 8, batch 64, 2 positives and 2 hard
negatives an anchor, 64 random negatives, capacity factor 8.

Tolerances: the routed draws with their edge rows, the sharded label-edge
tables and the overflow counts BIT-EQUAL (the rows are copies); the dense
own-block bias within 1e-6 of its scale (the scorer's fp32 matmuls); the
ring loss with the bias per shard within 1e-6 relative and its gradients
(queries, every candidate block, the positive and hard-negative terms)
within 1e-5 of each gradient's scale; 3-step fp32 trajectories of the
partitioned trainer within 1e-5 relative (the same math, sums in another
order, through Adam); the ring step's loss and every gradient, the
scorer's included, against the reference's replicated trainer's full-batch
step within 1e-5 relative (loss) and 1e-4 of each gradient's scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.losses.sharded_retrieval import (
    ring_own_block_edge_bias as jax_own_block_bias,
    ring_retrieval_loss as jax_ring_loss,
)
from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.models.link_prediction import (
    EdgeFeatureScorer as JaxScorer,
    LinkPredictionDecoder as JaxDecoder,
    LinkPredictionGNN as JaxLPGNN,
)
from gigl_tpu.parallel import feature_lookup as ref_fl
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu.training.dataset import (
    DeviceGraph as JaxDeviceGraph,
    NALPBatch as JaxNALPBatch,
)
from gigl_tpu.training.dist_sampled import (
    PartitionedGraph as JaxPartitionedGraph,
    PartitionedNALPTrainer as JaxPartitionedNALPTrainer,
    _shard_csr as jax_shard_csr,
)
from gigl_tpu.training.trainer import (
    NALPTrainer as JaxNALPTrainer,
    NALPTrainerConfig as JaxConfig,
)
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.losses import sharded_retrieval as sr
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    EdgeFeatureScorer,
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.parallel import feature_lookup as fl
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.training.dataset import DeviceGraph, NALPBatch
from gigl_tpu_torch.training.dist_sampled import (
    PartitionedGraph,
    PartitionedNALPTrainer,
    _shard_csr,
)
from gigl_tpu_torch.training.trainer import NALPTrainerConfig

torch.set_num_threads(1)

AXIS = "data"
N, E, D, DE, HID, OUT, B, R = 256, 2048, 16, 3, 32, 16, 64, 64
FANOUTS = (5, 3)
OPT = {"learning_rate": "0.01"}
STEPS = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- routed draws with the edge rows -------------------------------------------------
def _csr(n, e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    dst[:40] = 3                              # a hub past the fanout
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    return np.cumsum(indptr).astype(np.int32), src[order].astype(np.int32)


def _routed_pair(num_shards, de, capacity=None, fanout=4):
    """(reference, port) outputs of one routed draw with edge rows."""
    n, seed, hop = 8 * 30, 13, 1_000_003 + 2
    indptr, indices = _csr(n, 1500, seed=num_shards + de)
    feats = np.random.default_rng(de).normal(
        size=(len(indices), de)).astype(np.float32)
    rows = n // num_shards
    ip, ix, ef = _shard_csr(indptr, indices, num_shards, rows, weights=feats)
    frontier = np.random.default_rng(1).integers(
        0, n, num_shards * 40).astype(np.int32)
    frontier[:30] = 3 if capacity else frontier[:30]  # skew one owner
    mesh = jax_make_mesh(num_shards, axes=(AXIS,))
    blk = NamedSharding(mesh, P(AXIS, None))
    fn = jax.jit(jax.shard_map(
        lambda a, b, c, f: ref_fl.routed_sample_neighbors(
            a[0], b[0], f, fanout, axis=AXIS, seed=seed, hop=hop,
            capacity=capacity, local_edge_feats=c[0]),
        mesh=mesh, in_specs=(P(AXIS, None), P(AXIS, None),
                             P(AXIS, None, None), P(AXIS)),
        out_specs=(P(AXIS),) * 4, check_vma=False))
    want = [np.asarray(x) for x in fn(
        jax.device_put(ip, blk), jax.device_put(ix, blk),
        jax.device_put(ef, NamedSharding(mesh, P(AXIS, None, None))),
        jax.device_put(frontier, NamedSharding(mesh, P(AXIS))))]
    got = fl.routed_sample_neighbors(
        Mesh(num_shards, "cpu"), list(torch.from_numpy(ip)),
        list(torch.from_numpy(ix)),
        list(torch.from_numpy(frontier).reshape(num_shards, -1)), fanout,
        seed=seed, hop=hop, capacity=capacity,
        local_edge_feats=list(torch.from_numpy(ef)))
    return want, [torch.cat(x).numpy() for x in got], (indptr, indices,
                                                         feats, frontier)


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("de", [8, 3])
def test_routed_edge_rows_bit_equal(num_shards, de):
    """ids, mask, ok and the [G, fanout, De] edge rows bit-equal to the
    reference's routed draw, and each valid row the drawn edge's own row
    of the global table."""
    want, got, (indptr, indices, feats, frontier) = _routed_pair(
        num_shards, de)
    assert len(got) == 4 and got[3].shape == (len(frontier), 4, de)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    nbr, mask, ok, rows = got
    assert ok.all() and (rows[~mask] == 0).all()
    starts = indptr[frontier]
    for i in range(0, len(frontier), 7):
        for k in np.nonzero(mask[i])[0]:
            slots = np.arange(starts[i], indptr[frontier[i] + 1])
            hit = slots[indices[slots] == nbr[i, k]]
            assert any(np.array_equal(rows[i, k], feats[s]) for s in hit)


def test_routed_edge_rows_overflow_bit_equal():
    """A capacity too small for a skewed frontier: the same requests
    dropped, their rows zero, the rest bit-equal."""
    want, got, _ = _routed_pair(4, 3, capacity=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[2].all() and (got[3][~got[2]] == 0).all()


# -- the partitioned graph's label-edge tables --------------------------------------
def _arrays(n=N, e=E, seed=11):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = ~np.isin(dst, (5, 77))        # two anchors without positives
    src, dst = src[keep], dst[keep]
    hard = np.stack([rng.integers(0, n, 900), rng.integers(0, n, 900)])
    return dict(src=src, dst=dst,
                x=rng.normal(size=(n, D)).astype(np.float32), hard=hard,
                sup_ef=rng.normal(size=(len(src), DE)).astype(np.float32),
                hard_ef=rng.normal(size=(900, DE)).astype(np.float32))


def _graphs(n=N, e=E):
    a = _arrays(n, e)
    kw = dict(supervision_edges=np.stack([a["src"], a["dst"]]),
              hard_neg_edges=a["hard"],
              supervision_edge_features=a["sup_ef"],
              hard_neg_edge_features=a["hard_ef"])
    jdg = JaxDeviceGraph.from_hetero(JaxHeteroGraph.homogeneous(
        src=a["src"], dst=a["dst"], num_nodes=n, node_features=a["x"]), **kw)
    dg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=a["src"], dst=a["dst"], num_nodes=n, node_features=a["x"]),
        device="cpu", **kw)
    return jdg, dg


@pytest.mark.parametrize("n", [N, 250], ids=["even", "uneven"])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_partitioned_label_edge_tables_bit_equal(n, quantize):
    jdg, dg = _graphs(n, 8 * n)
    want = JaxPartitionedGraph.build(jdg, jax_make_mesh(4),
                                     quantize_features=quantize)
    got = PartitionedGraph.build(dg, Mesh(4, "cpu"),
                                 quantize_features=quantize)
    for name in ("sup_edge_feats", "hard_edge_feats"):
        g, w = torch.stack(getattr(got, name)).numpy(), np.asarray(
            getattr(want, name))
        assert g.shape == w.shape and g.shape[-1] == DE and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("sup_indptr", "sup_indices", "hard_indptr", "hard_indices"):
        np.testing.assert_array_equal(
            torch.stack(getattr(got, name)).numpy(),
            np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(torch.cat(got.feat_deg).numpy(),
                                  np.asarray(want.feat_deg))


def test_shard_csr_edge_rows_bit_equal():
    a = _arrays()
    order = np.argsort(a["dst"], kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(a["dst"],
                                                        minlength=N))])
    got = _shard_csr(indptr, a["src"][order], 4, N // 4,
                     weights=a["sup_ef"][order])
    want = jax_shard_csr(indptr, a["src"][order], 4, N // 4,
                         weights=a["sup_ef"][order])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- the own-block bias and the ring loss with it ------------------------------------
def _jax_batch(pos, hard, pos_ef, hard_ef):
    b = pos.shape[0]
    return JaxNALPBatch(
        anchors=jnp.zeros((b,), jnp.int32), pos=jnp.asarray(pos),
        pos_mask=jnp.ones(pos.shape, bool), hard_neg=jnp.asarray(hard),
        hard_neg_mask=jnp.ones(hard.shape, bool),
        random_neg=jnp.zeros((4,), jnp.int32),
        pos_edge_feats=None if pos_ef is None else jnp.asarray(pos_ef),
        hard_neg_edge_feats=None if hard_ef is None else jnp.asarray(hard_ef))


def _port_batch(pos, hard, pos_ef, hard_ef):
    b = pos.shape[0]
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    return NALPBatch(
        anchors=torch.zeros((b,), dtype=torch.int32), pos=t(pos),
        pos_mask=torch.ones(pos.shape, dtype=torch.bool), hard_neg=t(hard),
        hard_neg_mask=torch.ones(hard.shape, dtype=torch.bool),
        random_neg=torch.zeros((4,), dtype=torch.int32),
        pos_edge_feats=t(pos_ef), hard_neg_edge_feats=t(hard_ef))


@pytest.mark.parametrize("p,h", [(1, 0), (1, 2), (2, 1), (3, 2)])
@pytest.mark.parametrize("which", ["both", "pos", "hard"])
def test_own_block_edge_bias_matches_jax(p, h, which):
    """The reference's dense [Ql, Cl] matrix against the port's bias
    (its dense form, as the twins add it), through the scorer."""
    b, cl = 5, 5 * p + 5 * h + 7
    rng = np.random.default_rng(10 * p + h)
    pos = rng.integers(0, 50, (b, p)).astype(np.int32)
    hard = rng.integers(0, 50, (b, h)).astype(np.int32)
    pos_ef = rng.normal(size=(b, p, DE)).astype(np.float32)
    hard_ef = rng.normal(size=(b, h, DE)).astype(np.float32)
    if which == "pos":
        hard_ef = None
    elif which == "hard":
        pos_ef = None
    scorer = EdgeFeatureScorer(DE, hidden_dim=8)
    jparams = JaxScorer(hidden_dim=8).init(jax.random.PRNGKey(p + h),
                                           jnp.zeros((1, DE)))
    leaves = _np(jparams)["params"]
    with torch.no_grad():
        for name in ("e0", "e1"):
            layer = getattr(scorer, name)
            layer.weight.copy_(torch.tensor(leaves[name]["kernel"].T))
            layer.bias.copy_(torch.tensor(leaves[name]["bias"]))
    want = jax_own_block_bias(
        lambda ef: JaxScorer(hidden_dim=8).apply(jparams, ef),
        _jax_batch(pos, hard, pos_ef, hard_ef), cl)
    got = sr.ring_own_block_edge_bias(scorer, _port_batch(pos, hard, pos_ef,
                                                           hard_ef))
    if which == "hard" and h == 0:
        assert want is not None and got is None
        assert not np.asarray(want).any()
        return
    assert (got.e_pos is None) == (pos_ef is None)
    assert (got.e_hard is None) == (hard_ef is None or h == 0)
    dense = got.dense(b * p, cl).detach().numpy()
    w = np.asarray(want)
    np.testing.assert_allclose(dense, w, rtol=0,
                               atol=1e-6 * max(np.abs(w).max(), 1.0))
    assert ((dense != 0) == (w != 0)).all()


QL_B, QL_P, QL_H, RL = 4, 2, 2, 5     # anchors, positives, hard, random


def _ring_case(num_shards, seed=0):
    rng = np.random.default_rng(seed)
    ps, ql, nh = num_shards, QL_B * QL_P, QL_B * QL_H
    cl = ql + nh + RL
    aid = rng.integers(0, 60, (ps, QL_B)).astype(np.int32)
    pos = rng.integers(0, 60, (ps, ql)).astype(np.int32)
    cand_ids = np.concatenate([pos, rng.integers(0, 60, (ps, nh + RL))],
                              1).astype(np.int32)
    qids = np.repeat(aid, QL_P, axis=1)
    pos_qids = np.concatenate([qids, np.full((ps, nh + RL), -1)], 1).astype(
        np.int32)
    qmask = rng.random((ps, ql)) < 0.85
    cmask = np.concatenate([qmask, rng.random((ps, nh)) < 0.8,
                            np.ones((ps, RL), bool)], 1)
    return dict(q=rng.normal(size=(ps, ql, 8)).astype(np.float32),
                cand=rng.normal(size=(ps, cl, 8)).astype(np.float32),
                qids=qids, pos_ids=pos, cand_ids=cand_ids, pos_qids=pos_qids,
                qmask=qmask, cmask=cmask,
                e_pos=rng.normal(size=(ps, ql)).astype(np.float32),
                e_hard=rng.normal(size=(ps, nh)).astype(np.float32))


def _jax_ring_bias(c, temperature):
    ps = c["q"].shape[0]
    mesh = jax_make_mesh(ps, axes=(AXIS,))
    sh = NamedSharding(mesh, P(AXIS))
    cl = c["cand"].shape[1]

    def body(q_l, c_l, ep_l, eh_l, ci_l, pq_l, cm_l, qi_l, opi_l, qm_l):
        batch = _jax_batch(np.zeros((QL_B, QL_P), np.int32),
                           np.zeros((QL_B, QL_H), np.int32), None, None)
        batch = batch._replace(
            pos=jnp.zeros((QL_B, QL_P), jnp.int32),
            pos_edge_feats=ep_l[0].reshape(QL_B, QL_P, 1),
            hard_neg_edge_feats=eh_l[0].reshape(QL_B, QL_H, 1))
        bias = jax_own_block_bias(lambda ef: ef[:, 0], batch, cl)
        s, n = jax_ring_loss(
            q_l[0], c_l[0], axis=AXIS, temperature=temperature,
            query_ids=qi_l[0], own_pos_ids=opi_l[0],
            candidate_ids=ci_l[0], pos_col_query_ids=pq_l[0],
            candidate_mask=cm_l[0], query_mask=qm_l[0],
            own_block_bias=bias)
        return s[None], n[None]

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS),) * 10,
                       out_specs=(P(AXIS), P(AXIS)), check_vma=False)
    args = [jax.device_put(c[k], sh) for k in (
        "q", "cand", "e_pos", "e_hard", "cand_ids", "pos_qids", "cmask",
        "qids", "pos_ids", "qmask")]
    s, n = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: fn(*a, *args[4:])[0].sum(),
                             argnums=(0, 1, 2, 3)))(*args[:4])
    return np.asarray(s), np.asarray(n), [np.asarray(g) for g in grads]


def _port_ring_bias(c, temperature):
    ps = c["q"].shape[0]
    mesh = Mesh(ps, "cpu")
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    leaves = {k: [t[k][s].clone().requires_grad_() for s in range(ps)]
              for k in ("q", "cand", "e_pos", "e_hard")}
    cols = [sr.RingColumns(ids=t["cand_ids"][s], pos_qids=t["pos_qids"][s],
                           mask=t["cmask"][s]) for s in range(ps)]
    cand_views = sr.ring_blocks(mesh, leaves["cand"])
    col_views = sr.ring_blocks(mesh, cols)
    sums, counts = [], []
    for s in range(ps):
        ce, n = sr.ring_retrieval_loss(
            leaves["q"][s], cand_views[s], col_views[s],
            temperature=temperature, query_ids=t["qids"][s],
            own_pos_ids=t["pos_ids"][s], query_mask=t["qmask"][s],
            own_block_bias=sr.OwnBlockBias(leaves["e_pos"][s],
                                           leaves["e_hard"][s], QL_P, QL_H))
        sums.append(ce)
        counts.append(n)
    torch.stack(sums).sum().backward()
    return (torch.stack(sums).detach().numpy(), torch.stack(counts).numpy(),
            [torch.stack([x.grad for x in leaves[k]]).numpy()
             for k in ("q", "cand", "e_pos", "e_hard")])


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("temperature", [0.07, None], ids=["t007", "t1"])
def test_ring_loss_with_bias_matches_jax(num_shards, temperature):
    c = _ring_case(num_shards, seed=num_shards)
    ws, wn, wg = _jax_ring_bias(c, temperature)
    gs, gn, gg = _port_ring_bias(c, temperature)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)
    for name, got, want in zip(("q", "cand", "e_pos", "e_hard"), gg, wg):
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_bias_twins_keep_the_plain_twins_elsewhere():
    """With zero terms the bias twins equal the plain twins bit for bit;
    off the own block (P > 1) a bias changes nothing."""
    c = _ring_case(4, seed=9)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    rows = sr.RingRows(temperature=0.07, label_cols=torch.arange(
        QL_B * QL_P, dtype=torch.int32), query_ids=t["qids"][0],
        own_pos_ids=t["pos_ids"][0])
    cols = sr.stack_columns([sr.RingColumns(
        ids=t["cand_ids"][s], pos_qids=t["pos_qids"][s], mask=t["cmask"][s])
        for s in range(4)])
    scores = torch.stack([t["q"][0] @ t["cand"][s].T for s in range(4)])
    zero = sr.OwnBlockBias(torch.zeros_like(t["e_pos"][0]),
                           torch.zeros_like(t["e_hard"][0]), QL_P, QL_H)
    bias = sr.OwnBlockBias(t["e_pos"][0], t["e_hard"][0], QL_P, QL_H)
    fresh = lambda: [torch.full((QL_B * QL_P,), sr.FMIN),  # noqa: E731
                     torch.zeros(QL_B * QL_P), torch.zeros(QL_B * QL_P)]
    a, z = fresh(), fresh()
    sr.ring_fold(scores, rows, cols, True, *a)
    sr.ring_fold(scores, rows, cols, True, *z, bias=zero)
    for x, y in zip(a, z):
        assert torch.equal(x, y)
    lse = torch.log(a[1]) + a[0]
    g = torch.rand(QL_B * QL_P)
    ds = sr.ring_block_bwd(scores, rows, cols, True, lse, g)
    ds_b, de_pos, de_hard = sr.ring_block_bwd(scores, rows, cols, True, lse,
                                              g, bias)
    assert torch.equal(ds[1:], ds_b[1:])
    assert torch.equal(de_pos, torch.diagonal(ds_b[0]))
    assert de_hard.shape == (QL_B * QL_H,)


# -- the partitioned trainer with the scorer -----------------------------------------
def _model():
    return LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder(),
                             EdgeFeatureScorer(DE, hidden_dim=8))


def _jax_model():
    return JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT,
                                          dropout=0.0),
                    decoder=JaxDecoder(), edge_scorer=JaxScorer(hidden_dim=8))


def _cfg(**cfg):
    kw = dict(fanouts=FANOUTS, num_positives=2, num_hard_negs=2,
              num_random_negs=R, eval_ks=(1, 10), seed=3)
    kw.update(cfg)
    return kw


def _pair(num_shards=4, quantize=False, **cfg):
    kw = _cfg(**cfg)
    jdg, dg = _graphs()
    jm, mesh = jax_make_mesh(num_shards), Mesh(num_shards, "cpu")
    jt = JaxPartitionedNALPTrainer(
        _jax_model(), JaxPartitionedGraph.build(
            jdg, jm, quantize_features=quantize), jm, JaxConfig(**kw),
        optimizer_args=OPT, capacity_factor=8.0, overflow_policy="silent")
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    pt = PartitionedNALPTrainer(
        _model(), PartitionedGraph.build(dg, mesh,
                                         quantize_features=quantize),
        mesh, NALPTrainerConfig(**kw), optimizer_args=OPT,
        capacity_factor=8.0, overflow_policy="silent")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    return jt, js, pt, ps, dg


CONFIGS = {
    "live_per_shard": dict(),
    "live_ring": dict(global_candidate_pool=True),
    "cached_per_shard": dict(cached_hop=True),
    "cached_ring": dict(cached_hop=True, global_candidate_pool=True),
    "int8_per_shard": dict(quantize=True),
    "int8_cached_ring": dict(quantize=True, cached_hop=True,
                             global_candidate_pool=True),
    "one_shard_ring": dict(num_shards=1, global_candidate_pool=True),
    "margin": dict(loss_type="margin"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trajectory_with_label_edges_matches_jax(name):
    """3 steps of both partitioned trainers from the same params over the
    edge-featured graph, the scorer's terms in the loss."""
    jt, js, pt, ps, _ = _pair(**CONFIGS[name])
    assert pt.pg.sup_edge_feats is not None
    akb = np.random.default_rng(1).integers(0, N, (STEPS, B)).astype(
        np.int32)
    js, want = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    want = np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert pt.overflow_total == 0 == jt.overflow_total
    if name == "live_per_shard":
        val = [np.arange(64, dtype=np.int32)]
        got_m, want_m = pt.evaluate(val, step=2), jt.evaluate(js.params, val,
                                                              step=2)
        for k in want_m:
            assert abs(got_m[k] - want_m[k]) <= 1e-6, k


@pytest.mark.parametrize("step", [0, 3])
def test_batch_edge_rows_are_the_replicated_draws(step):
    """The partitioned batch's positives, hard negatives and their label
    rows against the replicated DeviceGraph's batch at the same step: ids
    and masks bit-equal, the rows bit-equal at valid slots and zero at
    padded ones (the replicated draw reads the anchor's first slot
    there)."""
    _, dg = _graphs()
    mesh = Mesh(4, "cpu")
    pt = PartitionedNALPTrainer(_model(), PartitionedGraph.build(dg, mesh),
                                mesh, NALPTrainerConfig(**_cfg()),
                                capacity_factor=8.0)
    anchors = (np.arange(B, dtype=np.int32) * 5) % N
    batches, ovf = pt._make_batches(pt._split(torch.from_numpy(anchors)),
                                    step)
    assert int(ovf) == 0
    ref = dg.sample_nalp_batch(torch.from_numpy(anchors), num_positives=2,
                               num_hard_negs=2, num_random_negs=R, seed=3,
                               step=step)
    for ids, mask, rows, r_ids, r_mask, r_rows in (
            ("pos", "pos_mask", "pos_edge_feats", ref.pos, ref.pos_mask,
             ref.pos_edge_feats),
            ("hard_neg", "hard_neg_mask", "hard_neg_edge_feats",
             ref.hard_neg, ref.hard_neg_mask, ref.hard_neg_edge_feats)):
        got_ids = torch.cat([getattr(b, ids) for b in batches])
        got_mask = torch.cat([getattr(b, mask) for b in batches])
        got_rows = torch.cat([getattr(b, rows) for b in batches])
        assert torch.equal(got_ids, r_ids) and torch.equal(got_mask, r_mask)
        assert torch.equal(got_rows[got_mask], r_rows[r_mask])
        assert not got_rows[~got_mask].any()
    assert (~ref.pos_mask).any()          # anchors 5 and 77: no positives


def test_ring_step_with_scorer_is_the_full_batch_step():
    """The ring's global pool with the own-block bias: a 4-shard step's
    loss and every gradient (the scorer's included) against the
    reference's replicated trainer's full-batch step from the same
    params."""
    jt_p, js, pt, _, _ = _pair(global_candidate_pool=True)
    params = _np(js.params)
    jdg, _ = _graphs()
    jt = JaxNALPTrainer(_jax_model(), jdg, JaxConfig(**_cfg()),
                        optimizer_args=OPT)
    anchors = (np.arange(B, dtype=np.int32) * 5) % N
    jb = jdg.sample_nalp_batch(jnp.asarray(anchors), num_positives=2,
                               num_hard_negs=2, num_random_negs=R, seed=3,
                               step=0)
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(jdg, p, jb, None, None), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    want = params_from_flax(_np(jgrad))
    loss, _, ovf = pt.loss_and_sketch(anchors, 0)
    loss.backward()
    assert int(ovf) == 0
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    assert {"edge_scorer.e0.weight", "edge_scorer.e1.bias"} <= set(want)
    floor = 1e-1 * max(float(w.abs().max()) for w in want.values())
    for name, p in pt.model.named_parameters():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)
