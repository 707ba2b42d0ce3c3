"""The port's encoder and decoder options against the JAX reference: batch
norm, activation before norm, jumping knowledge (cat, max, lstm), the
final linear layer, the feature embedding and the DCN cross layers, on
the sampled block (live and cached), ELL and COO paths, with flax params
(and batch_stats) converted by params_from_flax; encoder_from_config; the
train steps' refusal of batch norm; the mlp and hadamard_mlp decoders
and a 20-step NALP trajectory with hadamard_mlp. Small sizes (widths
6-8, B 16, fanouts (3, 2)) on the CPU, where the kernels run their plain
twins.

Tolerances: fp32 outputs, batch statistics and gradients within 1e-5 of
the output's (gradient's) scale (the same math summed in another order;
measured ~1e-6); a gradient that is zero by the batch statistics (a conv
bias just before batch norm) within 1e-6 of the largest gradient
(measured 1.1e-7). bf16 outputs within 3e-2 of the scale: the reference
rounds each Dense output and the batch norm's input to bf16 where the
port's GEMMs accumulate in fp32 (measured up to ~1.5e-2, a bf16 ulp at
the scale's exponent); bf16 running statistics within 4e-3 of their scale: the batch mean and
mean square of bf16 rows that differ here and there by an ulp (2**-8
relative; measured 1.7e-3). The 20-step fp32 trajectory
within 1e-3 relative, as tests/test_torch_training.py's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.graph.csr import build_csr as ref_build_csr
from gigl_tpu.models import encoders as ref_enc
from gigl_tpu.models import layers as ref_layers
from gigl_tpu.models import link_prediction as ref_lp
from gigl_tpu.ops import ell as ref_ell
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu.training.trainer import (
    NALPTrainer as JaxNALPTrainer,
    NALPTrainerConfig as JaxNALPTrainerConfig,
)
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph, build_csr
from gigl_tpu_torch.models import encoders, layers, link_prediction
from gigl_tpu_torch.ops.ell import EllGraph
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.full_batch import (
    FullBatchTrainer,
    full_batch_data_from_graph,
)
from gigl_tpu_torch.training.trainer import (
    NALPTrainer,
    NALPTrainerConfig,
    NodeClassificationTrainer,
    NodeClassificationTrainerConfig,
)

torch.set_num_threads(1)

B, K1, K2, DIN, HID, OUT = 16, 3, 2, 6, 8, 5
VOCAB = ((0, (7, 3)),)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# option sets: (options, with the feature embedding)
CASES = {
    "bn_cat_linear_emb_dcn": (dict(batchnorm=True, jk_mode="cat",
                                   linear_layer=True,
                                   feature_interaction_layers=2), True),
    "bn_lstm_act_before": (dict(batchnorm=True, jk_mode="lstm",
                                activation_before_norm=True), False),
    "max_linear": (dict(jk_mode="max", linear_layer=True), False),
    "bn_no_jk_dcn": (dict(batchnorm=True, feature_interaction_layers=1),
                     False),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=1e-5):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _ids_column(rng, shape):
    """Categorical ids as the features carry them: in range, past the
    vocabulary, negative and fractional."""
    return rng.choice([0.0, 2.0, 6.0, 6.9, 9.0, 40.0, -3.0, -0.7, 3.5],
                      size=shape)


def _tree(seed=0, cached=False):
    rng = np.random.default_rng(seed)
    levels = [(B,), (B, K1)] + ([] if cached else [(B, K1, K2)])
    feats = [rng.normal(size=s + (DIN,)).astype(np.float32) for s in levels]
    for f in feats:
        f[..., 0] = _ids_column(rng, f.shape[:-1])
    masks = [np.ones((B,), bool)] + [rng.random(s) < 0.7 for s in levels[1:]]
    masks[1][:2] = False
    for i in range(2, len(masks)):
        masks[i] &= masks[i - 1][..., None]
    aggs = [rng.normal(size=s + (DIN,)).astype(np.float32) for s in levels]
    return feats, masks, aggs


def _perturbed(variables, seed=3):
    """The reference's init (as numpy) with batch norm's scale, bias and
    statistics (and every other 1-D leaf) moved off their trivial
    values."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        noise = 0.3 * rng.normal(size=a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return a + np.abs(noise)
        return a + noise

    return jax.tree_util.tree_map_with_path(move, variables)


def _pair(case, dtype="float32", conv="graphsage", cached=False,
          method=None, args=None):
    """A reference GNNEncoder with perturbed variables and the port's
    encoder loaded from them."""
    jdt, tdt = DTYPES[dtype]
    opts, emb = CASES[case]
    jenc = ref_enc.GNNEncoder(
        hid_dim=HID, out_dim=OUT, conv=conv, dtype=jdt,
        feature_embedding=(ref_layers.FeatureEmbeddingLayer(
            vocab_specs=VOCAB) if emb else None), **opts)
    if method is None:
        feats, masks, aggs = _tree(cached=cached)
        # jit: one compile instead of an eager one per op
        variables = jax.jit(jenc.init)(
            jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats],
            [jnp.asarray(m) for m in masks],
            cached_agg=[jnp.asarray(a) for a in aggs] if cached else None)
    else:
        variables = jax.jit(lambda k, *a: jenc.init(k, *a, method=method),
                            static_argnums=(4,) if method == "encode_coo"
                            else ())(jax.random.PRNGKey(0), *args)
    variables = _perturbed(variables)
    penc = encoders.GNNEncoder(
        DIN, HID, OUT, conv=conv, dtype=tdt,
        feature_embedding=(layers.FeatureEmbeddingLayer(VOCAB) if emb
                           else None), **opts)
    penc.load_state_dict(params_from_flax(variables))
    return jenc, variables, penc


def _stats_close(penc, stats, tol):
    for i in range(len(penc.bns)):
        for k in ("mean", "var"):
            _close(getattr(penc.bns[i], k), stats[f"bn_{i}"][k], tol)


@pytest.mark.parametrize("case,dtype", [
    ("bn_cat_linear_emb_dcn", "float32"), ("bn_cat_linear_emb_dcn",
                                           "bfloat16"),
    ("bn_lstm_act_before", "float32"), ("bn_lstm_act_before", "bfloat16"),
    ("max_linear", "float32"), ("bn_no_jk_dcn", "float32")])
def test_block_forward_and_batch_stats(case, dtype):
    """Eval from the carried statistics, train mode's output and updated
    statistics (two calls in a row, as apply(mutable=["batch_stats"])
    chains them), then eval from the updated ones."""
    tol, stol = (1e-5, 1e-5) if dtype == "float32" else (3e-2, 4e-3)
    jenc, v, penc = _pair(case, dtype)
    feats, masks, _ = _tree(seed=1)
    jf, jm = [jnp.asarray(f) for f in feats], [jnp.asarray(m) for m in masks]
    tf, tm = [torch.from_numpy(f) for f in feats], [torch.from_numpy(m)
                                                     for m in masks]
    evaluate = jax.jit(lambda v_: jenc.apply(v_, jf, jm))
    train = jax.jit(lambda v_: jenc.apply(v_, jf, jm, train=True,
                                          mutable=["batch_stats"]))
    with torch.no_grad():
        _close(penc(tf, tm), evaluate(v), tol)
        stats = v
        for _ in range(2):
            want, upd = train(stats)
            stats = {**stats, **_np(upd)}
            _close(penc(tf, tm, train=True), want, tol)
        _stats_close(penc, stats.get("batch_stats", {}), stol)
        _close(penc(tf, tm), evaluate(stats), tol)
    assert (len(penc.bns) == (2 if penc.jk is not None else 1)
            if CASES[case][0].get("batchnorm") else not len(penc.bns))


def _grads(jloss, v, penc, ploss):
    """value_and_grad of the reference against the port's backward."""
    (want_l, stats), jg = jax.value_and_grad(jloss, has_aux=True)(
        v["params"])
    loss = ploss()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-5)
    want = params_from_flax({"params": _np(jg)})
    # a bias just before batch norm has no gradient in train mode (the
    # batch mean takes it out): rounding noise on both sides, held to the
    # largest gradient's scale
    floor = max(float(np.abs(g).max()) for g in want.values())
    for n, p in penc.named_parameters():
        assert p.grad is not None, n
        g = p.grad.numpy()
        np.testing.assert_allclose(g, want[n].numpy(), rtol=0, atol=1e-5 * max(
            float(want[n].abs().max()), 0.1 * floor), err_msg=n)
    return stats


@pytest.mark.parametrize("case", ["bn_cat_linear_emb_dcn",
                                  "bn_lstm_act_before"])
def test_block_gradients_match_value_and_grad(case):
    """One train-mode step's gradients (through batch norm's batch
    statistics) against jax.value_and_grad."""
    jenc, v, penc = _pair(case)
    feats, masks, _ = _tree(seed=2)
    jf, jm = [jnp.asarray(f) for f in feats], [jnp.asarray(m) for m in masks]
    w = np.random.default_rng(5).normal(size=(B, OUT)).astype(np.float32)

    def jloss(p):
        out, upd = jenc.apply({**v, "params": p}, jf, jm, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out * w), upd

    stats = _grads(jax.jit(jloss), v, penc, lambda: (penc(
        [torch.from_numpy(f) for f in feats],
        [torch.from_numpy(m) for m in masks], train=True)
        * torch.from_numpy(w)).sum())
    _stats_close(penc, _np(stats)["batch_stats"], 1e-5)


def test_cached_block_options_and_refusal():
    """The cached path with batch norm, JK and the final linear (forward,
    train statistics, gradients); a feature embedding or DCN refused on
    both packages with the reference's message."""
    jenc, v, penc = _pair("bn_lstm_act_before", cached=True)
    feats, masks, aggs = _tree(seed=3, cached=True)
    jf, jm, ja = ([jnp.asarray(a) for a in t] for t in (feats, masks, aggs))
    tf, tm, ta = ([torch.from_numpy(a) for a in t]
                  for t in (feats, masks, aggs))
    with torch.no_grad():
        _close(penc(tf, tm, cached_agg=ta),
               jenc.apply(v, jf, jm, cached_agg=ja))
    w = np.random.default_rng(6).normal(size=(B, OUT)).astype(np.float32)

    def jloss(p):
        out, upd = jenc.apply({**v, "params": p}, jf, jm, train=True,
                              cached_agg=ja, mutable=["batch_stats"])
        return jnp.sum(out * w), upd

    stats = _grads(jax.jit(jloss), v, penc, lambda: (penc(
        tf, tm, train=True, cached_agg=ta) * torch.from_numpy(w)).sum())
    _stats_close(penc, _np(stats)["batch_stats"], 1e-5)
    jbad, vbad, pbad = _pair("bn_cat_linear_emb_dcn")
    with pytest.raises(ValueError, match="incompatible with feature_embed"):
        jbad.apply(vbad, jf, jm, cached_agg=ja)
    with pytest.raises(ValueError, match="incompatible with feature_embed"):
        pbad(tf, tm, cached_agg=ta)


def _full_graph(seed=0, n=60, e=300):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, DIN)).astype(np.float32)
    x[:, 0] = _ids_column(rng, (n,))
    return src, dst, x, n


@pytest.mark.parametrize("path,case", [
    ("ell", "bn_cat_linear_emb_dcn"), ("ell", "bn_lstm_act_before"),
    ("coo", "bn_cat_linear_emb_dcn"), ("coo", "bn_lstm_act_before")])
def test_full_graph_paths_match_jax(path, case):
    """encode_ell and encode_coo with the options: eval forward, the
    train-mode statistics over the N rows, gradients."""
    src, dst, x, n = _full_graph()
    jx = jnp.asarray(x)
    if path == "ell":
        jg = ref_ell.EllGraph.from_csr(ref_build_csr(src, dst,
                                                     num_anchor_nodes=n))
        args, method = (jx, jg), "encode_ell"
        tg = EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=n),
                               device="cpu")

        def port(enc, train=False):
            return enc.encode_ell(torch.from_numpy(x), tg, train=train)
    else:
        args = (jx, jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
                n)
        method = "encode_coo"
        ts, td = (torch.as_tensor(a, dtype=torch.int32) for a in (src, dst))

        def port(enc, train=False):
            return enc.encode_coo(torch.from_numpy(x), ts, td, n,
                                  train=train)
    jenc, v, penc = _pair(case, method=method, args=args)
    with torch.no_grad():
        _close(port(penc), jax.jit(
            lambda v_: jenc.apply(v_, *args, method=method))(v))
    w = np.random.default_rng(7).normal(size=(n, OUT)).astype(np.float32)

    def jloss(p):
        out, upd = jenc.apply({**v, "params": p}, *args, train=True,
                              method=method, mutable=["batch_stats"])
        return jnp.sum(out * w), upd

    stats = _grads(jax.jit(jloss), v, penc, lambda: (
        port(penc, True) * torch.from_numpy(w)).sum())
    _stats_close(penc, _np(stats)["batch_stats"], 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_embedding_ids(dtype):
    """Ids past the vocabulary, negative and fractional: truncated to
    int32 and clipped, as the reference does; bf16 ids rounded first; the
    output fp32 when the tables join bf16 columns."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(40, 5)).astype(np.float32)
    x[:, 1] = _ids_column(rng, (40,))
    x[:, 3] = rng.choice([0.0, 1.0, 4.99, 5.0, 120.0, -1.0], size=40)
    x[0, 3] = 9.96     # rounds to 10 in bf16, then clipped
    specs = ((1, (7, 3)), (3, (5, 2)))
    jl = ref_layers.FeatureEmbeddingLayer(vocab_specs=specs)
    xj = jnp.asarray(x).astype(jdt)
    v = _np(jl.init(jax.random.PRNGKey(1), xj))
    pl = layers.FeatureEmbeddingLayer(specs)
    pl.load_state_dict({f"{t}.embedding": torch.tensor(lv["embedding"])
                        for t, lv in v["params"].items()})
    want = jl.apply(v, xj)
    got = pl(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert pl.out_dim(5) == jl.out_dim(5) == 8
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_encoder_from_config_matches_reference():
    """The string-map parser: the same keys, defaults and options."""
    args = {"hid_dim": "8", "out_dim": "5", "num_layers": "3",
            "conv": "gin", "batchnorm": "true", "linear_layer": "1",
            "jk_mode": "max", "dropout": "0.25", "use_bf16": "yes",
            "should_l2_normalize_embedding_layer_output": "True"}
    want = ref_enc.encoder_from_config(args)
    got = encoders.encoder_from_config(args, in_dim=DIN)
    assert (got.num_layers, got.out_dim, got.conv, got.dropout,
            got.jk_mode, got.l2_normalize_output, got.dtype) == (
        want.num_layers, want.out_dim, want.conv, want.dropout,
        want.jk_mode, want.l2_normalize_output, torch.bfloat16)
    assert len(got.bns) == 3 and got.final_linear is not None
    assert want.batchnorm and want.linear_layer and want.dtype == jnp.bfloat16
    default = encoders.encoder_from_config({}, in_dim=DIN)
    assert (default.out_dim, default.num_layers, default.jk, len(
        default.bns), default.final_linear, default.dtype) == (
        128, 2, None, 0, None, torch.float32)
    heads = encoders.encoder_from_config({"conv": "gat", "num_heads": "2"},
                                         in_dim=DIN)
    assert heads.convs[0].heads == 2


def _labelled_graph(n=80, e=500, seed=9):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    g = HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=n,
        node_features=rng.normal(size=(n, DIN)).astype(np.float32),
        node_labels=rng.integers(0, OUT, n))
    return src, dst, g


def test_train_steps_refuse_batch_norm_as_the_reference_raises():
    """The reference's train step applies the model without mutable
    batch_stats, which raises; the port's train steps refuse a batch-norm
    encoder, while evaluation and inference run from the running
    statistics."""
    jenc, v, _ = _pair("bn_no_jk_dcn")
    feats, masks, _ = _tree()
    with pytest.raises(Exception, match="batch_stats"):
        jenc.apply(v, [jnp.asarray(f) for f in feats],
                   [jnp.asarray(m) for m in masks], train=True)
    src, dst, g = _labelled_graph()
    dg = DeviceGraph.from_hetero(g, supervision_edges=np.stack([src, dst]),
                                 device="cpu")

    def bn_encoder(out=OUT):
        return encoders.GNNEncoder(DIN, HID, out, batchnorm=True)

    nc = NodeClassificationTrainer(bn_encoder(), dg,
                                   NodeClassificationTrainerConfig(
                                       fanouts=(3, 2)), device="cpu")
    state = nc.init_state(0)
    with pytest.raises(ValueError, match="batch-norm encoder"):
        nc.train_step(state, np.arange(8))
    assert 0.0 <= nc.evaluate(np.arange(20), 8) <= 1.0
    nalp = NALPTrainer(link_prediction.LinkPredictionGNN(
        bn_encoder(), link_prediction.LinkPredictionDecoder()), dg,
        NALPTrainerConfig(fanouts=(3, 2), num_random_negs=8), device="cpu")
    state = nalp.init_state(0)
    with pytest.raises(ValueError, match="batch-norm encoder"):
        nalp.train_step(state, np.arange(8))
    assert nalp.encode_batch(np.arange(8)).shape == (8, OUT)
    fb = FullBatchTrainer(bn_encoder(), full_batch_data_from_graph(
        g, device="cpu"), device="cpu")
    state = fb.init_state(0)
    with pytest.raises(ValueError, match="batch-norm encoder"):
        fb.train_step(state)


@pytest.mark.parametrize("decoder,dtype", [
    ("mlp", "float32"), ("hadamard_mlp", "float32"),
    ("hadamard_mlp", "bfloat16")])
def test_mlp_decoders_match_jax(decoder, dtype):
    """forward (broadcast q [4, 1, D] against c [1, 6, D]) and
    all_pairs, the parameters mlp0 / mlp1 converted from the reference's
    decoder tree."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(10)
    q = rng.normal(size=(4, OUT)).astype(np.float32)
    c = rng.normal(size=(6, OUT)).astype(np.float32)
    jd = ref_lp.LinkPredictionDecoder(decoder_type=decoder, hidden_dim=16,
                                      dtype=jdt)
    qj, cj = jnp.asarray(q).astype(jdt), jnp.asarray(c).astype(jdt)
    v = _np(jd.init(jax.random.PRNGKey(2), qj[:, None], cj[None]))
    v = _perturbed(v)
    pd = link_prediction.LinkPredictionDecoder(decoder, hidden_dim=16,
                                               dtype=tdt, in_dim=OUT)
    sd = params_from_flax({"params": {"encoder": {}, "decoder": v["params"]}})
    pd.load_state_dict({k[len("decoder."):]: t for k, t in sd.items()})
    qt, ct = torch.from_numpy(q).to(tdt), torch.from_numpy(c).to(tdt)
    tol = 1e-5 if dtype == "float32" else 3e-2
    with torch.no_grad():
        _close(pd(qt[:, None], ct[None]), jd.apply(v, qj[:, None], cj[None]),
               tol)
        got = pd.all_pairs(qt, ct)
        assert got.shape == (4, 6)
        _close(got, jd.apply(v, qj, cj, method="all_pairs"), tol)
    with pytest.raises(ValueError, match="in_dim"):
        link_prediction.LinkPredictionDecoder("mlp")


def test_hadamard_mlp_nalp_trajectory_matches_jax():
    """20 NALP steps (live draws, retrieval loss) with the hadamard_mlp
    decoder and a JK encoder with the final linear layer, from the
    reference's params."""
    n, b = 120, 16
    src, dst, g = _labelled_graph(n=n, e=900, seed=11)
    x = np.asarray(g.node_features[g.metadata.node_types[0]])
    opt = {"learning_rate": "0.01"}
    kw = dict(fanouts=(3, 2), num_random_negs=b, seed=3, eval_ks=(1,))
    jg = JaxDeviceGraph.from_hetero(
        JaxHeteroGraph.homogeneous(src=src, dst=dst, num_nodes=n,
                                   node_features=x),
        supervision_edges=np.stack([src, dst]))
    opts = dict(jk_mode="cat", linear_layer=True)
    jt = JaxNALPTrainer(
        ref_lp.LinkPredictionGNN(
            encoder=ref_enc.GNNEncoder(hid_dim=HID, out_dim=OUT, **opts),
            decoder=ref_lp.LinkPredictionDecoder(
                decoder_type="hadamard_mlp", hidden_dim=16)),
        jg, JaxNALPTrainerConfig(**kw), optimizer_args=opt)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=b)
    pg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=n,
                                node_features=x),
        supervision_edges=np.stack([src, dst]), device="cpu")
    pt = NALPTrainer(
        link_prediction.LinkPredictionGNN(
            encoders.GNNEncoder(DIN, HID, OUT, **opts),
            link_prediction.LinkPredictionDecoder(
                "hadamard_mlp", hidden_dim=16, in_dim=OUT)),
        pg, NALPTrainerConfig(**kw), optimizer_args=opt, device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    akb = np.random.default_rng(12).integers(0, n, (20, b))
    _, want = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
    assert np.isfinite(want).all() and want[-5:].mean() < want[:5].mean()


def test_init_and_unknown_trees_of_the_new_modules():
    """init_params gives the new modules flax's initialisers (batch norm 1
    / 0 and statistics 0 / 1; the embedding's variance scaling; the LSTM's
    orthogonal hidden kernels); params_from_flax refuses an unknown name
    in every new subtree."""
    from gigl_tpu_torch.models.init import init_params

    enc = encoders.GNNEncoder(
        DIN, 64, OUT, batchnorm=True, jk_mode="lstm", linear_layer=True,
        feature_interaction_layers=1,
        feature_embedding=layers.FeatureEmbeddingLayer(((0, (4000, 64)),)))
    with torch.no_grad():
        for bn in enc.bns:
            bn.scale.fill_(3.0)
            bn.var.fill_(5.0)
    init_params(enc, seed=1)
    for bn in enc.bns:
        assert (bn.scale == 1).all() and (bn.bias == 0).all()
        assert (bn.mean == 0).all() and (bn.var == 1).all()
    table = enc.feature_embedding.embed_col0.embedding.detach()
    assert abs(float(table.std()) - (1 / 64) ** 0.5) < 0.01
    assert float(table.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.8796 + 1e-6
    cell = enc.jk.lstm_fwd
    for k in ("i", "f", "g", "o"):
        w = getattr(cell, f"h{k}").weight.detach()
        torch.testing.assert_close(w @ w.T, torch.eye(64), atol=1e-5,
                                   rtol=0)
        assert (getattr(cell, f"h{k}").bias == 0).all()
        assert getattr(cell, f"i{k}").bias is None
    lin = enc.jk.lstm_fwd.ii.weight.detach()
    assert abs(float(lin.std()) - (1 / 64) ** 0.5) < 0.01
    for bad in ({"jk": {"lstm": {}}}, {"dcn": {"cross": {}}},
                {"feature_embedding": {"col0": {}}},
                {"bn_0": {"gamma": np.ones(2)}},
                {"jk": {"OptimizedLSTMCell_0": {"hx": {}}}}):
        with pytest.raises(ValueError, match="unsupported"):
            params_from_flax({"params": bad})
    with pytest.raises(ValueError, match="unsupported"):
        params_from_flax({"params": {"encoder": {}, "decoder": {"mlp2": {}}}})
    with pytest.raises(ValueError, match="unsupported"):
        params_from_flax({"params": {"encoder": {}, "head": {"fc9": {}}}})
    with pytest.raises(ValueError, match="unsupported"):
        params_from_flax({"params": {"proj": {"fc3": {}}}})


def test_partitioned_trainer_with_options_matches_jax():
    """The partitioned trainer (4 shards of a CPU mesh, the per-shard
    pool) with a JK-cat encoder, the final linear and the hadamard_mlp
    decoder: 3 steps against the reference's (1e-5 relative, as
    tests/test_torch_dist_sampled.py's); the global candidate pool refuses
    an MLP decoder (its ring folds inner products, K17)."""
    from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from gigl_tpu.training.dist_sampled import (
        PartitionedGraph as JaxPartitionedGraph,
        PartitionedNALPTrainer as JaxPartitionedNALPTrainer,
    )
    from gigl_tpu_torch.parallel.mesh import Mesh
    from gigl_tpu_torch.training.dist_sampled import (
        PartitionedGraph,
        PartitionedNALPTrainer,
    )

    n, b = 200, 32
    src, dst, g = _labelled_graph(n=n, e=1600, seed=13)
    x = np.asarray(g.node_features[g.metadata.node_types[0]])
    opts = dict(jk_mode="cat", linear_layer=True)
    kw = dict(fanouts=(3, 2), num_random_negs=b, eval_ks=(1,))
    jdg = JaxDeviceGraph.from_hetero(
        JaxHeteroGraph.homogeneous(src=src, dst=dst, num_nodes=n,
                                   node_features=x),
        supervision_edges=np.stack([src, dst]))
    jm = jax_make_mesh(4)
    jt = JaxPartitionedNALPTrainer(
        ref_lp.LinkPredictionGNN(
            encoder=ref_enc.GNNEncoder(hid_dim=HID, out_dim=OUT, **opts),
            decoder=ref_lp.LinkPredictionDecoder(
                decoder_type="hadamard_mlp", hidden_dim=16)),
        JaxPartitionedGraph.build(jdg, jm), jm, JaxNALPTrainerConfig(**kw),
        optimizer_args={"learning_rate": "0.01"}, capacity_factor=8.0,
        overflow_policy="silent")
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=b)
    dg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=n,
                                node_features=x),
        supervision_edges=np.stack([src, dst]), device="cpu")
    mesh = Mesh(4, "cpu")

    def port(**cfg):
        return PartitionedNALPTrainer(
            link_prediction.LinkPredictionGNN(
                encoders.GNNEncoder(DIN, HID, OUT, **opts),
                link_prediction.LinkPredictionDecoder(
                    "hadamard_mlp", hidden_dim=16, in_dim=OUT)),
            PartitionedGraph.build(dg, mesh), mesh,
            NALPTrainerConfig(**kw, **cfg),
            optimizer_args={"learning_rate": "0.01"}, capacity_factor=8.0,
            overflow_policy="silent")

    pt = port()
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    akb = np.random.default_rng(14).integers(0, n, (3, b)).astype(np.int32)
    _, want = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    ring = port(global_candidate_pool=True)
    state = ring.init_state(0)
    with pytest.raises(NotImplementedError, match="MLP decoder"):
        ring.train_step(state, akb[0])
