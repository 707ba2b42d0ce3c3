"""The port's NALP training slice (gigl_tpu_torch.training) against the JAX
reference: batches, optimizers, the loss trajectory, gradients, evaluation
and the fit loop, at a small size (N=500, fanouts (4, 3), B=R=64, hidden
32) on the CPU, where every kernel runs its plain twin.

Tolerances: integer draws and batches are bit-equal. fp32 losses over 20
steps within 1e-3 relative (measured ~1e-5: the same math, sums in another
order, drifting through Adam). fp32 first-step gradients within 1e-4 of
each parameter's gradient scale (measured ~3e-6). bf16 gradients within
6e-2 of the scale: the reference runs the loss and its gradient in bf16,
the port accumulates the loss in fp32 (measured up to 3e-2, a few bf16
ulps). One optimizer update within 1e-6.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.models.link_prediction import (
    LinkPredictionDecoder as JaxDecoder,
    LinkPredictionGNN as JaxLPGNN,
)
from gigl_tpu.training.dataset import (
    AnchorBatchIterator as JaxAnchorBatchIterator,
    DeviceGraph as JaxDeviceGraph,
)
from gigl_tpu.training.trainer import (
    NALPTrainer as JaxNALPTrainer,
    NALPTrainerConfig as JaxNALPTrainerConfig,
    make_optimizer as jax_make_optimizer,
)
from gigl_tpu_torch.convert import adam_state_from_optax, params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.training.dataset import AnchorBatchIterator, DeviceGraph
from gigl_tpu_torch.training.trainer import (
    NALPTrainer,
    NALPTrainerConfig,
    clip_by_global_norm_,
    make_optimizer,
)

torch.set_num_threads(1)

N, E, D, HID, OUT, B = 500, 4000, 16, 32, 16, 64
FANOUTS = (4, 3)
OPT = {"learning_rate": "0.01"}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    keep = ~np.isin(dst, (5, 77))   # two anchors without positives
    hard = np.stack([rng.integers(0, N, 900), rng.integers(0, N, 900)])
    return (src[keep], dst[keep], rng.normal(size=(N, D)).astype(np.float32),
            hard)


def _pair(jdt=jnp.float32, tdt=torch.float32, hard=False, **cfg):
    """A JAX and a port NALPTrainer on the same graph and params."""
    src, dst, x, hard_edges = _arrays()
    kw = dict(fanouts=FANOUTS, num_random_negs=B, cached_hop=True,
              fused_cache=True, seed=3, eval_ks=(1, 10))
    kw.update(cfg)
    extra = {"hard_neg_edges": hard_edges} if hard else {}
    jg = JaxDeviceGraph.from_hetero(
        JaxHeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                   node_features=x),
        supervision_edges=np.stack([src, dst]), **extra)
    jt = JaxNALPTrainer(
        JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT, dtype=jdt),
                 decoder=JaxDecoder()), jg, JaxNALPTrainerConfig(**kw),
        optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    pg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                node_features=x),
        supervision_edges=np.stack([src, dst]), device="cpu", **extra)
    pt = NALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT, dtype=tdt),
                          LinkPredictionDecoder()),
        pg, NALPTrainerConfig(**kw), optimizer_args=OPT, device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    return jt, js, pt, ps


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _anchors(k, seed=1):
    return np.random.default_rng(seed).integers(0, N, (k, B))


@pytest.mark.parametrize("step", [0, 1, 7])
def test_sample_nalp_batch_bit_equal(step):
    jt, _, pt, _ = _pair(hard=True)
    anchors = _anchors(1)[0]
    kw = dict(num_positives=2, num_hard_negs=3, num_random_negs=B, seed=5,
              step=step)
    want = jt.graph.sample_nalp_batch(jnp.asarray(anchors, jnp.int32), **kw)
    got = pt.graph.sample_nalp_batch(torch.as_tensor(anchors), **kw)
    for name in ("anchors", "pos", "pos_mask", "hard_neg", "hard_neg_mask",
                 "random_neg"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert not got.pos_mask.numpy()[np.isin(anchors, (5, 77))].any()


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_anchor_batch_iterator_bit_equal(drop_remainder):
    ids = np.arange(3, 203)
    a = JaxAnchorBatchIterator(ids, 48, seed=4, drop_remainder=drop_remainder)
    b = AnchorBatchIterator(ids, 48, seed=4, drop_remainder=drop_remainder)
    assert a.num_batches() == b.num_batches()
    for epoch in (0, 3):
        want, got = list(a.epoch(epoch)), list(b.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("args", [
    {"optimizer": "adam"},
    {"optimizer": "adamw", "weight_decay": "0.05"},
    {"optimizer": "sgd", "momentum": "0.8"},
    {"optimizer": "adam", "grad_clip_norm": "0.5"},
], ids=["adam", "adamw", "sgd", "adam_clip"])
def test_optimizer_updates_match_optax(args):
    """Two updates from the same params and gradients."""
    rng = np.random.default_rng(6)
    args = dict(args, learning_rate="0.01")
    params = {"a": rng.normal(size=(8, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    tx = jax_make_optimizer(args)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, clip = make_optimizer(args, tp.values())
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        if clip > 0:
            clip_by_global_norm_(tp.values(), clip)
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loss_type", ["retrieval", "margin", "softmax"])
def test_train_trajectory_matches_jax_f32(loss_type):
    jt, js, pt, ps = _pair(loss_type=loss_type)
    akb = _anchors(20)
    _, want = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    assert ps.step == 20 and got.shape == (20,)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
    assert np.isfinite(want).all() and want[-5:].mean() < want[:5].mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_step_gradients_match(dtype):
    """Every parameter's gradient, both linears of convs.0 included: part
    of theirs flows back through layer 2's masked mean (K4b), so a missing
    or wrong reduce backward shows here."""
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 1e-4),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 6e-2)}[dtype]
    jt, js, pt, _ = _pair(jdt, tdt)
    anchors = _anchors(1)[0]
    jb = jt.graph.sample_nalp_batch(jnp.asarray(anchors, jnp.int32),
                                    num_positives=1, num_random_negs=B,
                                    seed=3, step=0)
    (jloss, _), jgrad = jax.value_and_grad(
        lambda p: jt._loss(jt.graph, p, jb, None, None), has_aux=True)(
            js.params)
    want = params_from_flax(_np(jgrad))
    loss = pt.loss(pt.sample_batch(anchors, 0))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= tol * abs(float(jloss))
    names = [n for n, _ in pt.model.named_parameters()]
    assert {"encoder.convs.0.lin_self.weight",
            "encoder.convs.0.lin_nbr.weight"} <= set(names) == set(want)
    for name, p in pt.model.named_parameters():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.float().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=name)


def test_evaluate_matches_jax():
    jt, js, pt, ps = _pair()
    akb = _anchors(3)
    js, _ = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    pt.train_steps(ps, akb)
    batches = list(_anchors(3, seed=2))
    want = jt.evaluate(js.params, batches, step=4)
    got = pt.evaluate(batches, step=4)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


class _Log:
    def __init__(self):
        self.rows = []

    def log(self, step, **scalars):
        self.rows.append((step, scalars))


def test_fit_early_stop_matches_jax():
    jt, js, pt, ps = _pair()
    anchors = np.arange(N)
    kw = dict(batch_size=B, num_epochs=3, val_every_n_batches=2,
              num_val_batches=2, early_stop_patience=1, log_every=0)
    jlog, plog = _Log(), _Log()
    _, want = jt.fit(js, anchors, anchors[:150], scalar_logger=jlog, **kw)
    _, got = pt.fit(ps, anchors, anchors[:150], scalar_logger=plog, **kw)
    jevals = [s for s, r in jlog.rows if "mrr" in r]
    pevals = [s for s, r in plog.rows if "mrr" in r]
    assert pevals == jevals and 0 < len(jevals) < 9   # stopped early
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


def test_adam_state_from_optax_resumes_mid_run():
    jt, js, pt, _ = _pair()
    akb = _anchors(5)
    js, _ = jt.train_steps(js, akb[:3], jax.random.PRNGKey(1))
    params, opt_state = _np(js.params), _np(js.opt_state)  # before donation
    _, want = jt.train_steps(js, akb[3:], jax.random.PRNGKey(2))
    ps = pt.init_state(params=params_from_flax(params))
    opt = ps.optimizer
    opt.load_state_dict({"state": adam_state_from_optax(opt_state, pt.model),
                         "param_groups": opt.state_dict()["param_groups"]})
    ps = ps._replace(step=3)
    _, got = pt.train_steps(ps, akb[3:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_init_params_is_flax_lecun_normal():
    """flax's Dense default: a normal truncated at +-2 sigma, rescaled so
    its std is 1/sqrt(fan_in): no |w| * sqrt(fan_in) above 2/0.8796."""
    g = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=np.arange(10), dst=np.arange(10)[::-1], num_nodes=10,
        node_features=np.zeros((10, 256), np.float32)), device="cpu")
    t = NALPTrainer(LinkPredictionGNN(GNNEncoder(256, 64, 128, num_layers=1),
                                      LinkPredictionDecoder()),
                    g, NALPTrainerConfig(fanouts=(3,)), device="cpu")
    t.init_params(0)
    w = t.model.encoder.convs[0].lin_self.weight.detach().numpy()
    assert w.shape == (128, 256)
    assert np.abs(w).max() * math.sqrt(256) <= 2.28
    assert abs(w.std() * math.sqrt(256) - 1.0) <= 0.03
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    state = t.init_state(0, batch_size=B)
    assert state.step == 0 and isinstance(state.optimizer, torch.optim.Adam)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_train_mode_dropout():
    enc = GNNEncoder(D, HID, OUT, dropout=0.5)
    rng = np.random.default_rng(7)
    feats = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for s in ((6, D), (6, 4, D))]
    masks = [torch.ones(6, dtype=torch.bool),
             torch.ones((6, 4), dtype=torch.bool)]
    cached = [torch.zeros_like(f) for f in feats]
    eval_out = enc(feats, masks, cached_agg=cached)
    with pytest.raises(ValueError, match="Generator"):
        enc(feats, masks, train=True, cached_agg=cached)
    a, b = (enc(feats, masks, train=True, cached_agg=cached,
                generator=torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, eval_out)
    enc.dropout = 0.0   # rate 0 is the identity, in train mode too
    assert torch.equal(enc(feats, masks, train=True, cached_agg=cached),
                       eval_out)


def test_unported_training_options_raise():
    _, _, pt, ps = _pair()
    with pytest.raises(NotImplementedError, match="A11"):
        pt.fit(ps, np.arange(N), np.arange(64), batch_size=B,
               checkpoint_dir="ckpt")
    # the logQ correction is ported (tests/test_torch_cms.py): the state
    # carries an empty sketch
    cms = NALPTrainer(pt.model, pt.graph,
                      NALPTrainerConfig(fanouts=FANOUTS,
                                        use_cms_correction=True),
                      device="cpu").init_state(0).cms
    assert cms.table.shape == (5, 2048) and int(cms.total) == 0
