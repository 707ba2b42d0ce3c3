"""The count-min sketch and the logQ correction of the port
(gigl_tpu_torch.losses.count_min_sketch, retrieval_loss's
candidate_sampling_probability, NALPTrainer(use_cms_correction=True))
against the JAX reference, on the CPU, where K13 / K14 / K5 run their
plain twins.

Tolerances: the hash buckets, the sketch's table and total, the estimates
and the probabilities (one IEEE division of the same integers) are
BIT-EQUAL. The corrected retrieval loss: fp32 within 1e-5 relative and its
gradient within 1e-5 of the gradient's scale (sums in another order; the
log of p is XLA's and PyTorch's log, which may differ by an ulp). bf16:
the port subtracts the log term rounded to bf16 (as the reference's
``.astype(dtype)`` rounds it) from the fp32 scores / T and rounds dS once;
the reference also rounds scores / T and the corrected logit to bf16,
which at the logits a clamped p = 1e-10 makes (~30, where a bf16 ulp is
0.125-0.25) moves a cell's softmax by up to ~25%. So the bf16 case is held
to the same computation in fp32 (the reference's, from the same bf16
scores): the loss within 2e-2 relative (as tests/test_torch_losses.py
holds bf16), dS within 2e-2 of its scale (measured 5.6e-3) and no farther
from it than the reference's own bf16 dS is (measured 3.3e-2). The 20-step fp32 training trajectories with the sketch
on, over quantized and unquantized tables: within 1e-5 relative (the
reference's tables carried across, tests/test_torch_quantized.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.losses import count_min_sketch as ref_cms
from gigl_tpu.losses import losses as ref_losses
from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.models.link_prediction import (
    LinkPredictionDecoder as JaxDecoder,
    LinkPredictionGNN as JaxLPGNN,
)
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu.training.trainer import (
    NALPTrainer as JaxNALPTrainer,
    NALPTrainerConfig as JaxNALPTrainerConfig,
)
from gigl_tpu_torch.convert import (
    cms_from_jax,
    params_from_flax,
    quantized_table_from_jax,
)
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.losses import count_min_sketch as cms
from gigl_tpu_torch.losses import losses as port_losses
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.trainer import NALPTrainer, NALPTrainerConfig

torch.set_num_threads(1)

N, E, D, HID, OUT, B = 400, 3200, 16, 32, 16, 48
FANOUTS = (4, 3)
OPT = {"learning_rate": "0.01"}
EDGE_IDS = np.array([0, 1, 2**31 - 1, 2**31 - 2, 2**31 - 8, 12345,
                     2**30 + 7, 77, 77, 2**31 - 1], np.int32)


def _ids(seed, n=300, hi=1000):
    """Ids with duplicates, and the largest int32 ids."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, hi, n).astype(np.int32),
                           EDGE_IDS])


@pytest.mark.parametrize("depth,width", [(5, 2048), (3, 2047), (1, 7),
                                         (4, 1)])
def test_hash_buckets_bit_equal(depth, width):
    ids = _ids(0)
    want = np.asarray(ref_cms._cms_hash(jnp.asarray(ids), depth, width))
    got = cms._cms_hash_plain(torch.from_numpy(ids), depth, width)
    assert got.shape == (depth, ids.shape[0])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth,width", [(5, 2048), (3, 2047)])
def test_cms_add_bit_equal_over_batches(depth, width):
    """Three batches with duplicates: the table and total after each; the
    input sketch is never written."""
    want = ref_cms.cms_init(depth, width)
    got = cms.cms_init(depth, width, device="cpu")
    for k in range(3):
        ids = _ids(k + 1, n=200 + 37 * k, hi=300)
        want = ref_cms.cms_add(want, jnp.asarray(ids))
        before = got.table.clone()
        nxt = cms.cms_add(got, torch.from_numpy(ids))
        assert torch.equal(got.table, before)       # functional
        got = nxt
        np.testing.assert_array_equal(got.table.numpy(),
                                      np.asarray(want.table))
        assert got.total.dtype == torch.int32 and got.total.shape == ()
        assert int(got.total) == int(want.total)
    assert int(got.table.sum()) == depth * int(got.total)


def test_cms_estimate_and_probability_bit_equal():
    want = ref_cms.cms_init(5, 2047)
    for k in range(3):
        want = ref_cms.cms_add(want, jnp.asarray(_ids(k, hi=400)))
    got = cms_from_jax(np.asarray(want.table), np.asarray(want.total),
                       device="cpu")
    query = _ids(9, hi=600).reshape(31, 10)      # seen and unseen ids
    est = cms.cms_estimate(got, torch.from_numpy(query))
    assert est.dtype == torch.int32 and est.shape == query.shape
    np.testing.assert_array_equal(
        est.numpy(), np.asarray(ref_cms.cms_estimate(want,
                                                     jnp.asarray(query))))
    prob = cms.cms_sampling_probability(got, torch.from_numpy(query))
    assert prob.dtype == torch.float32
    np.testing.assert_array_equal(
        prob.numpy(), np.asarray(ref_cms.cms_sampling_probability(
            want, jnp.asarray(query))))
    # an empty sketch: total clamped to 1, every probability 0
    empty = cms.cms_init(device="cpu")
    assert not cms.cms_sampling_probability(
        empty, torch.from_numpy(query)).any()


def _logq_case(seed=3, q=16, c=48):
    rng = np.random.default_rng(seed)
    scores = (rng.normal(size=(q, c)) * 0.5).astype(np.float32)
    prob = (rng.integers(0, 9, c) / 37.0).astype(np.float32)
    prob[[1, 5, 40]] = 0.0                            # clamped to 1e-10
    cmask = rng.random(c) < 0.75
    qmask = rng.random(q) < 0.8
    qmask &= cmask[:q]
    kw = {"temperature": 0.07,
          "query_ids": rng.integers(0, 6, q).astype(np.int32),
          "candidate_ids": rng.integers(0, 10, c).astype(np.int32),
          "remove_accidental_hits": True, "query_mask": qmask,
          "candidate_mask": cmask, "candidate_sampling_probability": prob}
    return scores, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retrieval_loss_logq_matches_jax(dtype):
    """Forward and jax.vjp backward, with p = 0 entries and masked
    columns."""
    scores, kw = _logq_case()
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}

    def f(s):
        loss, count = ref_losses.retrieval_loss(s, **jkw)
        return loss.astype(jnp.float32), count

    def ref_vjp(s):
        out, vjp, count = jax.vjp(f, s, has_aux=True)
        return float(out), int(count), np.asarray(
            vjp(jnp.float32(1.0))[0].astype(jnp.float32))

    s_j = jnp.asarray(scores).astype(jdt)
    want, wcount, wgrad = ref_vjp(s_j)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    s = torch.from_numpy(scores).to(tdt).requires_grad_()
    got, gcount = port_losses.retrieval_loss(s, **tkw)
    (ggrad,) = torch.autograd.grad(got, s)
    ggrad = ggrad.float().numpy()
    assert int(gcount) == wcount
    if dtype == "float32":
        assert abs(float(got.detach()) - want) <= 1e-5 * abs(want)
        np.testing.assert_allclose(ggrad, wgrad, rtol=0,
                                   atol=1e-5 * np.abs(wgrad).max())
    else:
        exact, _, egrad = ref_vjp(s_j.astype(jnp.float32))
        scale = np.abs(egrad).max()
        assert abs(float(got.detach()) - exact) <= 2e-2 * abs(exact)
        assert abs(float(got.detach()) - want) <= 2e-2 * abs(want)
        port_err = np.abs(ggrad - egrad).max()
        assert port_err <= 2e-2 * scale
        assert port_err <= np.abs(wgrad - egrad).max()
    np.testing.assert_array_equal(ggrad[:, ~kw["candidate_mask"]], 0.0)
    # the correction moves the loss: the same scores without it differ
    del tkw["candidate_sampling_probability"]
    plain, _ = port_losses.retrieval_loss(s.detach(), **tkw)
    assert abs(float(plain) - float(got.detach())) > 1e-3 * abs(float(plain))


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    keep = ~np.isin(dst, (5, 77))   # two anchors without positives
    return src[keep], dst[keep], rng.normal(size=(N, D)).astype(np.float32)


def cms_pair(quantize_features=False, quantize_cache=False, **cfg):
    """A JAX and a port NALPTrainer with the sketch on, on the same graph
    and params; the port's quantized tables are the reference's, carried
    across (bit-equal: the port's own quantized cache may sit an int8 step
    away, see tests/test_torch_quantized.py)."""
    src, dst, x = _arrays()
    kw = dict(fanouts=FANOUTS, num_random_negs=B, cached_hop=True, seed=3,
              eval_ks=(1, 10), use_cms_correction=True,
              quantize_cache=quantize_cache)
    kw.update(cfg)
    jg = JaxDeviceGraph.from_hetero(
        JaxHeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                   node_features=x),
        supervision_edges=np.stack([src, dst]),
        quantize_features=quantize_features)
    jt = JaxNALPTrainer(
        JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT),
                 decoder=JaxDecoder()), jg, JaxNALPTrainerConfig(**kw),
        optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    pg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                node_features=x),
        supervision_edges=np.stack([src, dst]),
        quantize_features=quantize_features, device="cpu")
    pt = NALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder()),
        pg, NALPTrainerConfig(**kw), optimizer_args=OPT, device="cpu")
    carry(jt.graph, pt)
    ps = pt.init_state(params=params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    return jt, js, pt, ps


def carry(jgraph, pt):
    """The reference graph's quantized tables into the port trainer."""
    repl = {}
    for name in ("node_features", "nbr_cache"):
        t = getattr(jgraph, name)
        if hasattr(t, "scale"):
            repl[name] = quantized_table_from_jax(
                np.asarray(t.q), np.asarray(t.scale), t.dim, device="cpu")
    pt.graph = dataclasses.replace(pt.graph, **repl)


@pytest.mark.parametrize("quantize_features,quantize_cache", [
    (False, False), (False, True), (True, False), (True, True)])
def test_cms_train_trajectory_matches_jax(quantize_features, quantize_cache):
    """20 fp32 steps with the logQ correction; then the sketch, bit-equal:
    every step counts its B positives and B random negatives."""
    jt, js, pt, ps = cms_pair(quantize_features, quantize_cache)
    akb = np.random.default_rng(1).integers(0, N, (20, B))
    js, want = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert np.isfinite(want).all() and want[-5:].mean() < want[:5].mean()
    assert ps.step == 20 and int(ps.cms.total) == 20 * 2 * B
    np.testing.assert_array_equal(ps.cms.table.numpy(),
                                  np.asarray(js.cms.table))
    assert int(ps.cms.total) == int(js.cms.total)


def test_first_step_loss_with_the_sketch_matches_jax():
    """The corrected loss of one batch from a mid-run sketch (the
    reference's, carried across), and the loss without the correction
    differs."""
    jt, js, pt, ps = cms_pair()
    akb = np.random.default_rng(2).integers(0, N, (3, B))
    js, _ = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    sketch = cms_from_jax(np.asarray(js.cms.table), np.asarray(js.cms.total),
                          device="cpu")
    anchors = akb[-1]
    jb = jt.graph.sample_nalp_batch(jnp.asarray(anchors, jnp.int32),
                                    num_positives=1, num_random_negs=B,
                                    seed=3, step=5)
    jloss, jsketch = jax.jit(
        lambda g, p, b, c: jt._loss(g, p, b, c, None))(
            jt.graph, js.params, jb, js.cms)
    pt.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    batch = pt.graph.sample_nalp_batch(torch.as_tensor(anchors),
                                       num_positives=1, num_random_negs=B,
                                       seed=3, step=5)
    loss, new = pt.loss_and_sketch(batch, sketch)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    np.testing.assert_array_equal(new.table.numpy(),
                                  np.asarray(jsketch.table))
    assert torch.equal(pt.loss_and_sketch(batch, sketch)[0], loss)
    assert abs(float(pt.loss(batch).detach()) - float(jloss)) > 1e-4 * abs(
        float(jloss))
