"""The port's typed NALP training (gigl_tpu_torch.training.hetero_trainer,
hetero_dataset's draws) and the typed paths' gradients and bf16 numbers
against the JAX reference, on the CPU where every kernel runs its plain
twin.

Two configurations:

- milestone 4 of ``examples/baseline_milestones.py:145-198``: the mocked
  bipartite user / item graph (64 users, 48 items, 8 features), RGCN with 2
  bases, hidden 32, out 16, users anchored, items as candidates, 48 random
  negatives, retrieval loss at temperature 0.1, Adam 0.01, batch 32;
- the DBLP yaml's shape (``examples/configs/dblp_hetero_nalp_task_config
  .yaml``) at a small size: 40 authors (6 features), 80 papers (10),
  writes / rev_writes / cites, HGT with 2 heads, hidden 16, out 8, papers
  anchored on ``author-writes-paper``'s dst, authors as candidates, the
  yaml's message-passing paths, 1 positive, no hard negatives (the draws
  test takes 2 from a hard-negative CSR), 24 random negatives, batch 16,
  Adam 1e-3.

Tolerances: the draws bit-equal. fp32 losses over 20 steps within 1e-5
relative (the same sums in another order, through Adam; milestone 4's
within 1e-4, see its test). One step's gradients within 3e-5 of each
parameter's largest entry (fp32 sums over every tree entry; RGCN's input
bias reads 1.03e-5), floored at 1e-1 of the model's largest gradient: a
gradient that is zero by symmetry is rounding noise. encode_full's
gradients within 1e-5. MRR and
hits@k within 1e-5 relative (the same ranks).
bf16 against the reference in bf16 (ROADMAP C5): see ``BF16_TOL``.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from gigl_tpu.config.task_config import SamplingOp as RefSamplingOp
from gigl_tpu.data.mocking import BIPARTITE_TOY_GRAPH_LP, get_mocked_graph
from gigl_tpu.graph.csr import HeteroGraph as RefHeteroGraph
from gigl_tpu.models.hetero_encoders import HeteroGNNEncoder as RefEncoder
from gigl_tpu.models.link_prediction import (
    HeteroLinkPredictionGNN as RefHeteroLP,
)
from gigl_tpu.models.link_prediction import (
    LinkPredictionDecoder as RefDecoder,
)
from gigl_tpu.sampling.hetero_sampler import resolve_path as ref_resolve
from gigl_tpu.training.hetero_dataset import (
    HeteroDeviceGraph as RefHeteroDeviceGraph,
)
from gigl_tpu.training.hetero_trainer import (
    HeteroNALPTrainer as RefTrainer,
)
from gigl_tpu.training.hetero_trainer import (
    HeteroNALPTrainerConfig as RefTrainerConfig,
)
from gigl_tpu.types.graph import EdgeType as RefEdgeType
from gigl_tpu.types.graph import GraphMetadata as RefGraphMetadata
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models.hetero_encoders import HeteroGNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    HeteroLinkPredictionGNN,
    LinkPredictionDecoder,
)
from gigl_tpu_torch.sampling.hetero_sampler import SamplingOp, resolve_path
from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
from gigl_tpu_torch.training.hetero_trainer import (
    HeteroNALPTrainer,
    HeteroNALPTrainerConfig,
)
from gigl_tpu_torch.types.graph import EdgeType, GraphMetadata

torch.set_num_threads(1)

# -- milestone 4 (RGCN, user / item) ---------------------------------------------
BUYS, REV_BUYS = "user-buys-item", "item-rev_buys-user"
M4_OPS = {"user": (("u1", REV_BUYS, 5, ()), ("u2", BUYS, 3, ("u1",))),
          "item": (("i1", BUYS, 5, ()), ("i2", REV_BUYS, 3, ("i1",)))}
M4_CFG = dict(anchor_node_type="user", candidate_node_type="item",
              num_random_negs=48, loss_type="retrieval", temperature=0.1)
M4_OPT = {"learning_rate": "0.01"}
# -- DBLP-shaped (HGT, author / paper) -------------------------------------------
A, P = 40, 80
DIMS = {"author": 6, "paper": 10}
WRITES, REV, CITES = ("author-writes-paper", "paper-rev_writes-author",
                      "paper-cites-paper")
EDGE_TYPES = (WRITES, REV, CITES)
NODE_TYPES = ("author", "paper")
YAML = (Path(__file__).resolve().parent.parent / "examples" / "configs"
        / "dblp_hetero_nalp_task_config.yaml")
DBLP_CFG = dict(anchor_node_type="paper", candidate_node_type="author",
                num_random_negs=24, num_hard_negs=0, loss_type="retrieval",
                temperature=0.07, eval_ks=(1, 5, 10), seed=2)
DBLP_OPT = {"learning_rate": "1e-3"}
# bf16 against the reference in bf16 (ROADMAP C5), as a share of the
# output's largest entry. Readings (``JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_hetero_training.py``): HGT up to 9.4e-3, RGCN up to
# 4.0e-3, about one bf16 ulp (2**-7 = 7.8e-3): the port's kernels sum in
# fp32 and round once where the reference rounds every step in bf16.
BF16_TOL = {"hgt": 2e-2, "rgcn": 2e-2}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fresh(rt, params, batch_size):
    """A new reference TrainState from cached numpy params (its steps
    donate their state)."""
    return rt.init_state(None, batch_size, params=jax.tree_util.tree_map(
        jnp.asarray, params))


@functools.lru_cache(maxsize=None)
def _m4_ref():
    """The milestone's reference trainer (cached, so its jitted steps
    compile once), its initial params, and the port's graph and paths."""
    ref_g = get_mocked_graph(BIPARTITE_TOY_GRAPH_LP)
    edges = {str(et): np.asarray(coo) for et, coo in ref_g.edges.items()}
    port_g = HeteroGraph(
        metadata=GraphMetadata(("user", "item"), (BUYS, REV_BUYS)),
        num_nodes=dict(ref_g.num_nodes),
        edges={EdgeType.from_str(k): v for k, v in edges.items()},
        node_features={nt: np.asarray(ref_g.node_features[nt])
                       for nt in ("user", "item")})
    paths = {nt: resolve_path(nt, [SamplingOp(n, et, k, parents)
                                   for n, et, k, parents in ops])
             for nt, ops in M4_OPS.items()}
    ref_paths = {nt: ref_resolve(nt, [RefSamplingOp(
        op_name=n, edge_type=RefEdgeType.from_str(et),
        num_nodes_to_sample=k, input_op_names=parents,
        sampling_direction="INCOMING") for n, et, k, parents in ops])
        for nt, ops in M4_OPS.items()}
    buys = RefEdgeType.from_str(BUYS)
    rdg = RefHeteroDeviceGraph.from_hetero(
        ref_g, ref_paths, supervision_edge_type=buys,
        supervision_edges=ref_g.edges[buys], supervision_anchor="src")
    dg = HeteroDeviceGraph.from_hetero(
        port_g, paths, supervision_edge_type=EdgeType.from_str(BUYS),
        supervision_edges=edges[BUYS], supervision_anchor="src",
        device="cpu")
    ref_model = RefHeteroLP(encoder=RefEncoder(
        hid_dim=32, out_dim=16, num_layers=2, conv="rgcn", num_bases=2,
        node_types=("user", "item"), edge_types=(BUYS, REV_BUYS)),
        decoder=RefDecoder())
    rt = RefTrainer(ref_model, rdg, ref_paths, RefTrainerConfig(**M4_CFG),
                    optimizer_args=M4_OPT)
    params = _np(rt.init_state(jax.random.PRNGKey(0), batch_size=32).params)
    return rt, params, dg, paths


def _m4():
    """The milestone's trainers (reference and port) from the same
    params."""
    rt, params, dg, paths = _m4_ref()
    model = HeteroLinkPredictionGNN(HeteroGNNEncoder(
        32, 16, ("user", "item"), (BUYS, REV_BUYS),
        {"user": 8, "item": 8}, conv="rgcn", num_bases=2),
        LinkPredictionDecoder())
    pt = HeteroNALPTrainer(model, dg, paths, HeteroNALPTrainerConfig(
        **M4_CFG), optimizer_args=M4_OPT, device="cpu")
    ps = pt.init_state(params=params_from_flax(params))
    return rt, _fresh(rt, params, 32), pt, ps


def _dblp_arrays(seed=0):
    rng = np.random.default_rng(seed)
    w_src = rng.integers(1, A, 200)               # author 0 writes nothing
    w_dst = rng.integers(0, P, 200)
    c_src = np.concatenate([rng.integers(0, P, 300), rng.integers(0, P, 60)])
    c_dst = np.concatenate([rng.integers(0, P, 300), np.full(60, 3)])
    c_src, c_dst = c_src[c_dst != 7], c_dst[c_dst != 7]  # paper 7: no
    w_src, w_dst = w_src[w_dst != 7], w_dst[w_dst != 7]  # in-edge
    edges = {WRITES: np.stack([w_src, w_dst]),
             REV: np.stack([w_dst, w_src]),
             CITES: np.stack([c_src, c_dst])}
    feats = {nt: (3.0 * rng.normal(size=(n, DIMS[nt]))).astype(np.float32)
             for nt, n in (("author", A), ("paper", P))}
    hard = np.stack([rng.integers(0, A, 150), rng.integers(0, P, 150)])
    return edges, feats, hard


def _dblp_graphs():
    edges, feats, hard = _dblp_arrays()
    port = HeteroGraph(
        metadata=GraphMetadata(NODE_TYPES, EDGE_TYPES),
        num_nodes={"author": A, "paper": P},
        edges={EdgeType.from_str(k): v for k, v in edges.items()},
        node_features=dict(feats))
    ref = RefHeteroGraph(
        metadata=RefGraphMetadata(NODE_TYPES, EDGE_TYPES),
        num_nodes={"author": A, "paper": P},
        edges={RefEdgeType.from_str(k): v for k, v in edges.items()})
    for nt, f in feats.items():
        ref.node_features[nt] = f
    return port, ref, edges, hard


def _yaml_paths():
    mpp = yaml.safe_load(YAML.read_text())["dataset"]["sampling"][
        "message_passing_paths"]
    port, ref = {}, {}
    for nt, ops in mpp.items():
        kw = [dict(op_name=o["op_name"], edge_type=o["edge_type"],
                   num_nodes_to_sample=o["num_nodes_to_sample"],
                   input_op_names=tuple(o["input_op_names"]),
                   sampling_method=o["sampling_method"],
                   sampling_direction=o["sampling_direction"]) for o in ops]
        port[nt] = resolve_path(nt, [SamplingOp(**k) for k in kw])
        ref[nt] = ref_resolve(nt, [RefSamplingOp(**k) for k in kw])
    return port, ref


@functools.lru_cache(maxsize=None)
def _dblp_ref(conv="hgt", dtype="float32"):
    """The DBLP-shaped reference trainer (cached, so its jitted steps
    compile once), its initial params (fp32, the same in every compute
    type), and the port's graph and paths."""
    port_g, ref_g, edges, hard = _dblp_graphs()
    paths, ref_paths = _yaml_paths()
    sup = dict(supervision_edges=edges[WRITES], hard_neg_edges=hard,
               supervision_anchor="dst")
    rdg = RefHeteroDeviceGraph.from_hetero(
        ref_g, ref_paths, supervision_edge_type=RefEdgeType.from_str(WRITES),
        **sup)
    dg = HeteroDeviceGraph.from_hetero(
        port_g, paths, supervision_edge_type=EdgeType.from_str(WRITES),
        device="cpu", **sup)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ref_model = RefHeteroLP(encoder=RefEncoder(
        hid_dim=16, out_dim=8, num_layers=2, conv=conv,
        node_types=NODE_TYPES, edge_types=EDGE_TYPES, dtype=jdt,
        **_conv_kw(conv)), decoder=RefDecoder())
    rt = RefTrainer(ref_model, rdg, ref_paths, RefTrainerConfig(**DBLP_CFG),
                    optimizer_args=DBLP_OPT)
    if dtype != "float32":
        return rt, _dblp_ref(conv)[1], dg, paths
    params = _np(rt.init_state(jax.random.PRNGKey(1), batch_size=16).params)
    return rt, params, dg, paths


def _conv_kw(conv):
    return dict(num_bases=2) if conv == "rgcn" else dict(heads=2)


def _dblp(conv="hgt", dtype="float32", tabularized=False):
    """The DBLP-shaped trainers (reference and port) from the same
    params (the reference's without its tables: the tabularized path is
    the port's alone here)."""
    rt, params, dg, paths = _dblp_ref(conv, dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    model = HeteroLinkPredictionGNN(HeteroGNNEncoder(
        16, 8, NODE_TYPES, EDGE_TYPES, DIMS, conv=conv, dtype=tdt,
        **_conv_kw(conv)), LinkPredictionDecoder())
    pt = HeteroNALPTrainer(model, dg, paths, HeteroNALPTrainerConfig(
        **DBLP_CFG, tabularized=tabularized), optimizer_args=DBLP_OPT,
        device="cpu")
    ps = pt.init_state(params=params_from_flax(params))
    return rt, _fresh(rt, params, 16), pt, ps


def _grads_close(model, want, tol):
    """Every parameter's gradient within ``tol`` of its scale, floored at
    1e-1 of the model's largest: a gradient that is zero by symmetry is
    rounding noise (the last layer's bias of the candidate type: the
    retrieval loss does not change when every candidate shifts by one
    vector; HGT's reads 1.3e-6 against a largest gradient of 5.4)."""
    names = {n for n, _ in model.named_parameters()}
    assert names == set(want)
    floor = 1e-1 * max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None, name
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(p.grad.float().numpy() - w).max())
        assert err <= tol * scale, (name, err, scale)


# -- draws ------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 5])
def test_typed_draws_bit_equal(step):
    rt, _, pt, _ = _dblp()
    anchors = np.array([3, 7, 0, 11, 79, 3, 40], np.int32)
    rg, g = rt.graph, pt.graph
    ja, ta = jnp.asarray(anchors), torch.from_numpy(anchors)
    pairs = [
        (jax.jit(lambda g_, a: g_.sample_positives(a, 2, seed=4, step=step))(
            rg, ja), g.sample_positives(ta, 2, seed=4, step=step)),
        (jax.jit(lambda g_, a: g_.sample_hard_negatives(
            a, 3, seed=4, step=step))(rg, ja),
         g.sample_hard_negatives(ta, 3, seed=4, step=step)),
        ((jax.jit(lambda g_: g_.sample_random_negatives(
            24, "author", seed=4, step=step))(rg),),
         (g.sample_random_negatives(24, "author", seed=4, step=step),))]
    for want, got in pairs:
        for w, t in zip(want, got):
            assert t.dtype == (torch.bool if np.asarray(w).dtype == bool
                               else torch.int32)
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    _, _, none = g.sample_positives_with_feats(ta, 2, seed=4, step=step)
    assert none is None
    hard, mask, none = g.sample_hard_negatives_with_feats(ta, 0, seed=4,
                                                          step=step)
    assert hard.shape == (7, 0) and mask.shape == (7, 0) and none is None
    want = jax.jit(lambda g_, a: rt._sample_batch(
        g_, a, num_hard_negs=2, seed=2, step=step))(rg, ja)
    got = pt.sample_batch(anchors, step, num_hard_negs=2)
    for name in ("anchors", "pos", "pos_mask", "hard_neg", "hard_neg_mask",
                 "random_neg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert not got.pos_mask.numpy()[anchors == 7].any()   # no author


# -- trajectories ---------------------------------------------------------------
def _trajectory(rt, js, pt, ps, akb, rtol):
    js, want = rt.train_steps(js, akb, jax.random.PRNGKey(3))
    ps, got = pt.train_steps(ps, akb)
    assert ps.step == len(akb) and got.shape == (len(akb),)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)
    assert np.isfinite(want).all() and want[-5:].mean() < want[:5].mean()
    return js, ps


def test_milestone4_rgcn_trajectory_matches_jax():
    """Adam at lr 0.01 on losses near 160 (temperature 0.1) amplifies the
    first step's fp32 sum-order differences (gradients within 6e-6 of their
    scale): the 20 losses sit up to 5.6e-5 relative apart, so 1e-4 here."""
    rt, js, pt, ps = _m4()
    akb = np.random.default_rng(5).integers(0, 64, (20, 32)).astype(np.int32)
    _trajectory(rt, js, pt, ps, akb, rtol=1e-4)


def test_dblp_hgt_trajectory_and_evaluate_match_jax():
    """20 steps, then MRR and hits@k over 4 eval batches of the trained
    weights."""
    rt, js, pt, ps = _dblp()
    akb = np.random.default_rng(6).integers(0, P, (20, 16)).astype(np.int32)
    js, ps = _trajectory(rt, js, pt, ps, akb, rtol=1e-5)
    batches = list(np.random.default_rng(8).integers(0, P, (4, 16)))
    want = rt.evaluate(js.params, batches, step=2)
    got = pt.evaluate(batches, step=2)
    assert got.keys() == want.keys() and "hits@10" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


@pytest.mark.parametrize("conv", ["hgt", "rgcn"])
def test_first_step_gradients_match_jax(conv):
    """Every parameter's gradient through the block form: HGT's prior gets
    its gradient through the reassociated logit (its relation's keys scaled
    by it before K7), summed over the block's slots."""
    rt, js, pt, _ = _dblp(conv)
    anchors = np.arange(16, dtype=np.int32) * 5
    jb = rt._sample_batch(rt.graph, jnp.asarray(anchors), num_hard_negs=0,
                          seed=2, step=0)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: rt._loss(rt.graph, p, jb, None)))(js.params)
    want = params_from_flax(_np(jgrad))
    loss = pt.loss(pt.sample_batch(anchors, 0))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    _grads_close(pt.model, want, 3e-5)
    if conv == "hgt":
        prior = pt.model.encoder.convs[0]._get("prior", WRITES)
        assert float(prior.grad.abs().max()) > 0


def test_fit_runs_and_matches_jax():
    """fit: two epochs of the milestone's loop with a validation every 2
    steps (tabularized off); the same early stop, the same metrics."""
    rt, js, pt, ps = _m4()
    users = np.arange(64)
    kw = dict(batch_size=32, num_epochs=2, val_every_n_batches=2,
              num_val_batches=2, log_every=100)
    _, want = rt.fit(js, users, users, **kw)
    ps, got = pt.fit(ps, users, users, **kw)
    assert ps.step == 4 and got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


def test_tabularized_fit_keeps_the_reference_tables():
    """fit on the tabularized path. The reference's refresh_tables re-runs
    with_sample_tables, which keeps every table it already has, so an
    epoch's refresh draws nothing new (ROADMAP C6); the port does the
    same."""
    _, _, pt, ps = _dblp(tabularized=True)
    before = {k: v.clone() for k, v in pt.graph.sample_tables.items()}
    ps, metrics = pt.fit(ps, np.arange(P), np.arange(P), batch_size=16,
                         num_epochs=2, val_every_n_batches=3,
                         num_val_batches=2, log_every=0)
    assert ps.step == 10 and 0.0 <= metrics["mrr"] <= 1.0
    assert sorted(before) == sorted(pt.graph.sample_tables)
    for k, v in before.items():
        assert torch.equal(v, pt.graph.sample_tables[k]), k


def test_label_edge_features_raise():
    """Typed label-edge features are ported (the draws carry them,
    tests/test_torch_label_edge_features.py holds them and the scorer to
    JAX); what still raises, as in the reference: features without their
    edges, and ``edge_score`` on a model without a scorer."""
    port_g, _, edges, _ = _dblp_graphs()
    paths, _ = _yaml_paths()
    feats = np.arange(edges[WRITES].shape[1] * 2, dtype=np.float32).reshape(
        -1, 2)
    dg = HeteroDeviceGraph.from_hetero(
        port_g, paths, supervision_edge_type=EdgeType.from_str(WRITES),
        supervision_edges=edges[WRITES], supervision_edge_features=feats,
        device="cpu")
    pos, mask, ef = dg.sample_positives_with_feats(
        torch.arange(8, dtype=torch.int32), 2, seed=0, step=0)
    assert ef.shape == (8, 2, 2)
    assert bool((ef[~mask] == 0).all())
    with pytest.raises(ValueError, match="needs supervision_edges"):
        HeteroDeviceGraph.from_hetero(
            port_g, paths, supervision_edge_type=EdgeType.from_str(WRITES),
            supervision_edge_features=feats, device="cpu")
    model = HeteroLinkPredictionGNN(
        HeteroGNNEncoder(16, 8, NODE_TYPES, EDGE_TYPES, DIMS),
        LinkPredictionDecoder())
    with pytest.raises(ValueError, match="without an edge_scorer"):
        model.edge_score(torch.zeros(1, 2))


# -- encode_full's gradients (the prior as K10's scale) ---------------------------
def _full_inputs(edges, feats):
    port = ({nt: torch.from_numpy(f) for nt, f in feats.items()},
            {et: tuple(torch.from_numpy(r.astype(np.int32)) for r in coo)
             for et, coo in edges.items()}, {"author": A, "paper": P})
    ref = ({nt: jnp.asarray(f) for nt, f in feats.items()},
           {et: tuple(jnp.asarray(r, jnp.int32) for r in coo)
            for et, coo in edges.items()}, {"author": A, "paper": P})
    return port, ref


def test_encode_full_gradients_match_jax_prior_included():
    """HGT's prior is K10's scale in the coo form: its gradient (K10b's
    per-head sum), and every other parameter's, against jax.grad of the
    reference's encode_full."""
    edges, feats, _ = _dblp_arrays()
    rt, _, pt, _ = _dblp()
    ref, enc = rt.model.encoder, pt.model.encoder
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, _dblp_ref()[1]["params"]["encoder"])}
    (pf, pe, pn), (rf, re_, rn) = _full_inputs(edges, feats)
    cot = {nt: np.random.default_rng(9).normal(size=(n, 8)).astype(
        np.float32) for nt, n in pn.items()}

    def f(p):
        out = ref.apply(p, rf, re_, rn, method="encode_full")
        return sum((out[nt] * cot[nt]).sum() for nt in NODE_TYPES)

    want = params_from_flax(_np(jax.jit(jax.grad(f))(params)))
    out = enc.encode_full(pf, pe, pn)
    sum((out[nt] * torch.from_numpy(cot[nt])).sum()
        for nt in NODE_TYPES).backward()
    _grads_close(enc, want, 1e-5)
    priors = [n for n, _ in enc.named_parameters() if ".prior_" in n]
    assert len(priors) == 6
    for n, p in enc.named_parameters():
        if n in priors:
            assert float(p.grad.abs().max()) > 0, n


# -- bf16 (ROADMAP C5) ------------------------------------------------------------
def bf16_errors(conv):
    """encode_full (every node) and encode_batch (every paper and author)
    in bf16, the port against the reference in bf16, from the same fp32
    params: the max error over the output's largest entry, per path."""
    edges, feats, _ = _dblp_arrays()
    rt, _, pt, _ = _dblp(conv, "bfloat16")
    lp = jax.tree_util.tree_map(jnp.asarray, _dblp_ref(conv, "bfloat16")[1])
    enc_params = {"params": lp["params"]["encoder"]}
    (pf, pe, pn), (rf, re_, rn) = _full_inputs(edges, feats)
    want = jax.jit(lambda p: rt.model.encoder.apply(
        p, rf, re_, rn, method="encode_full"))(enc_params)
    with torch.inference_mode():
        got = pt.model.encoder.encode_full(pf, pe, pn)
    errs = {}
    for nt in NODE_TYPES:
        w = np.asarray(want[nt], np.float32)
        g = got[nt].float().numpy()
        assert np.isfinite(g).all() and g.shape == w.shape
        errs[f"full_{nt}"] = float(np.abs(g - w).max() / np.abs(w).max())
    for nt, n in (("paper", P), ("author", A)):
        ids = np.arange(n, dtype=np.int32)
        w = np.asarray(rt.encode_batch(lp, ids, nt), np.float32)
        g = pt.encode_batch(ids, nt).float().numpy()
        assert np.isfinite(g).all() and g.shape == w.shape
        errs[f"batch_{nt}"] = float(np.abs(g - w).max() / np.abs(w).max())
    return errs


@pytest.mark.parametrize("conv", ["hgt", "rgcn"])
def test_bf16_typed_paths_match_jax(conv):
    errs = bf16_errors(conv)
    for path, err in errs.items():
        assert err <= BF16_TOL[conv], (path, err)


if __name__ == "__main__":
    # The readings behind BF16_TOL:
    #     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hetero_training.py
    for conv_ in ("hgt", "rgcn"):
        print(conv_, bf16_errors(conv_), flush=True)
