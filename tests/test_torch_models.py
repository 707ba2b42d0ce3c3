"""Parity of the port's models (gigl_tpu_torch.models) with the JAX
reference's flax modules, with flax params converted by
gigl_tpu_torch.convert.params_from_flax.

fp32: the same products summed in another order — rtol = atol = 1e-5.
bf16: both compute in bf16 from fp32 params, but the reference rounds every
intermediate (each Dense output, the bias add, the sum of the two linears,
the bf16 masked mean) where the port's GEMMs accumulate in fp32 and its
masked mean rounds once. bf16 keeps 8 significant bits (ulp 2**-8 of the
value), and a few such roundings through two layers stay within 3% of the
output's scale: atol = 3e-2 * max|reference|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.models import convs as ref_convs
from gigl_tpu.models import encoders as ref_enc
from gigl_tpu.models import layers as ref_layers
from gigl_tpu.models import link_prediction as ref_lp
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.models import convs, encoders, layers, link_prediction

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, K1, K2, DIN, HID, OUT = 64, 4, 3, 16, 32, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, dtype):
    got = got.float().detach().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())


def _tree(seed=0, cached=False):
    rng = np.random.default_rng(seed)
    levels = [(B,), (B, K1)] + ([] if cached else [(B, K1, K2)])
    feats = [rng.normal(size=s + (DIN,)).astype(np.float32) for s in levels]
    masks = [np.ones((B,), bool)] + [rng.random(s) < 0.7 for s in levels[1:]]
    masks[1][:3] = False  # roots with no valid neighbor
    for i in range(2, len(masks)):
        masks[i] &= masks[i - 1][..., None]
    aggs = [rng.normal(size=s + (DIN,)).astype(np.float32) for s in levels]
    return feats, masks, aggs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["block", "block_cached"])
def test_sage_conv(path, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, DIN)).astype(np.float32)
    nbr = rng.normal(size=(B, K1, DIN)).astype(np.float32)
    agg = rng.normal(size=(B, DIN)).astype(np.float32)
    mask = rng.random((B, K1)) < 0.6
    mask[:2] = False
    jconv = ref_convs.SAGEConv(out_dim=OUT, dtype=jdt)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(nbr), jnp.asarray(mask))
    sd = params_from_flax({"conv_0": _np(params["params"])})
    conv = convs.SAGEConv(DIN, OUT, dtype=tdt)
    conv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    xj = jnp.asarray(x).astype(jdt)
    if path == "block":
        want = jconv.apply(params, xj, jnp.asarray(nbr).astype(jdt),
                           jnp.asarray(mask))
        got = conv.block(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(nbr).to(tdt), torch.from_numpy(mask))
    else:
        want = jconv.apply(params, xj, jnp.asarray(agg), method="block_cached")
        got = conv.block_cached(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(agg))
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("l2", [False, True])
def test_gnn_encoder(cached, dtype, l2):
    jdt, tdt = DTYPES[dtype]
    feats, masks, aggs = _tree(2, cached)
    jenc = ref_enc.GNNEncoder(hid_dim=HID, out_dim=OUT, num_layers=2,
                              l2_normalize_output=l2, dtype=jdt)
    jf = [jnp.asarray(f) for f in feats]
    jm = [jnp.asarray(m) for m in masks]
    ja = [jnp.asarray(a) for a in aggs] if cached else None
    params = jenc.init(jax.random.PRNGKey(3), jf, jm, cached_agg=ja)
    want = jenc.apply(params, jf, jm, cached_agg=ja)
    enc = encoders.GNNEncoder(DIN, HID, OUT, num_layers=2,
                              l2_normalize_output=l2, dtype=tdt)
    enc.load_state_dict(params_from_flax(_np(params)))
    got = enc([torch.from_numpy(f) for f in feats],
              [torch.from_numpy(m) for m in masks],
              cached_agg=[torch.from_numpy(a) for a in aggs] if cached
              else None)
    assert got.shape == (B, OUT)
    _close(got, want, dtype)


def test_link_prediction_gnn_and_decoders():
    feats, masks, aggs = _tree(4, cached=True)
    jf = [jnp.asarray(f) for f in feats]
    jm = [jnp.asarray(m) for m in masks]
    ja = [jnp.asarray(a) for a in aggs]
    rng = np.random.default_rng(5)
    q = rng.normal(size=(6, OUT)).astype(np.float32)
    c = rng.normal(size=(9, OUT)).astype(np.float32)
    for kind in ("inner_product", "cosine"):
        jm_ = ref_lp.LinkPredictionGNN(
            encoder=ref_enc.GNNEncoder(hid_dim=HID, out_dim=OUT),
            decoder=ref_lp.LinkPredictionDecoder(decoder_type=kind))
        params = jm_.init(jax.random.PRNGKey(0), jf, jm, cached_agg=ja)
        model = link_prediction.LinkPredictionGNN(
            encoders.GNNEncoder(DIN, HID, OUT),
            link_prediction.LinkPredictionDecoder(kind))
        model.load_state_dict(params_from_flax(_np(params)))
        _close(model([torch.from_numpy(f) for f in feats],
                     [torch.from_numpy(m) for m in masks],
                     cached_agg=[torch.from_numpy(a) for a in aggs]),
               jm_.apply(params, jf, jm, cached_agg=ja), "float32")
        tq, tc = torch.from_numpy(q), torch.from_numpy(c)
        _close(model.decode_all_pairs(tq, tc),
               jm_.apply(params, jnp.asarray(q), jnp.asarray(c),
                         method="decode_all_pairs"), "float32")
        _close(model.decode(tq[:, None, :], tc[None, :, :]),
               jm_.apply(params, jnp.asarray(q)[:, None, :],
                         jnp.asarray(c)[None, :, :], method="decode"),
               "float32")


def test_l2_normalize_matches():
    x = np.random.default_rng(6).normal(size=(10, 7)).astype(np.float32)
    x[3] = 0.0
    _close(layers.l2_normalize(torch.from_numpy(x)),
           ref_layers.l2_normalize(jnp.asarray(x)), "float32")


def test_cached_agg_kind_and_encoder_options():
    for conv, kw in (("graphsage", None), ("graphsage", {"aggr": "sum"}),
                     ("gcn", None), ("gin", None)):
        assert encoders.cached_agg_kind(conv, kw) == \
            ref_enc.cached_agg_kind(conv, kw)
    assert encoders.CACHEABLE_CONVS == ref_enc.CACHEABLE_CONVS
    with pytest.raises(ValueError, match="not hop-cacheable"):
        encoders.cached_agg_kind("gat")
    # GINE is ported (tests/test_torch_edge_features.py)
    assert all(isinstance(c, convs.GINEConv) for c in encoders.GNNEncoder(
        DIN, DIN, OUT, conv="gine").convs)
    # jumping knowledge, batch norm, the mlp decoder and a bn_0 tree, each
    # against the reference (every path and option:
    # tests/test_torch_encoder_options.py)
    feats, masks, _ = _tree()
    jf, jm = [jnp.asarray(f) for f in feats], [jnp.asarray(m) for m in masks]
    tf = [torch.from_numpy(f) for f in feats]
    tm = [torch.from_numpy(m) for m in masks]
    for opts in ({"jk_mode": "cat"}, {"batchnorm": True}):
        jenc = ref_enc.GNNEncoder(hid_dim=HID, out_dim=OUT, **opts)
        variables = _np(jax.jit(jenc.init)(jax.random.PRNGKey(0), jf, jm))
        enc = encoders.GNNEncoder(DIN, HID, OUT, **opts)
        enc.load_state_dict(params_from_flax(variables))
        with torch.no_grad():
            _close(enc(tf, tm), jenc.apply(variables, jf, jm), "float32")
    rng = np.random.default_rng(7)
    q = rng.normal(size=(5, OUT)).astype(np.float32)
    c = rng.normal(size=(7, OUT)).astype(np.float32)
    jd = ref_lp.LinkPredictionDecoder(decoder_type="mlp", hidden_dim=16)
    dv = _np(jd.init(jax.random.PRNGKey(1), jnp.asarray(q)[:, None],
                     jnp.asarray(c)[None]))
    dec = link_prediction.LinkPredictionDecoder("mlp", hidden_dim=16,
                                                in_dim=OUT)
    dec.load_state_dict({f"{k}.{'weight' if n == 'kernel' else n}":
                         torch.tensor(a.T if n == "kernel" else a)
                         for k, lv in dv["params"].items()
                         for n, a in lv.items()})
    with torch.no_grad():
        _close(dec.all_pairs(torch.from_numpy(q), torch.from_numpy(c)),
               jd.apply(dv, jnp.asarray(q), jnp.asarray(c),
                        method="all_pairs"), "float32")
    bn = {"scale": np.full(HID, 2.0, np.float32),
          "bias": np.full(HID, 0.5, np.float32)}
    stats = {"mean": np.full(HID, 0.25, np.float32),
             "var": np.full(HID, 4.0, np.float32)}
    sd = params_from_flax({"params": {"encoder": {"bn_0": bn}},
                           "batch_stats": {"encoder": {"bn_0": stats}}})
    assert {k: float(v[0]) for k, v in sd.items()} == {
        "encoder.bns.0.scale": 2.0, "encoder.bns.0.bias": 0.5,
        "encoder.bns.0.mean": 0.25, "encoder.bns.0.var": 4.0}
    with pytest.raises(ValueError, match="unsupported"):
        params_from_flax({"params": {"encoder": {"bn_x": {}}}})
