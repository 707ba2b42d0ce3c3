"""Parity of the port's GCN, GIN, GAT, GATv2 and Transformer convs
(gigl_tpu_torch.models.convs) and masked_softmax with the JAX reference, on
dense fanout blocks, forward and (GAT, Transformer: K7b's twin) backward;
what stays forward-only; sampled attention training; the port's weight
init for the new parameters.

fp32: the same products summed in another order — within 1e-4 of the
output's largest entry (the attention convs also project the [N*K, D]
table before reading its rows, where the reference projects the block).
bf16 (GAT): the reference rounds each Dense output to bf16, the port's
kernels accumulate in fp32 and round once — within 2e-2 of the largest
entry. masked_softmax: fp32 rtol/atol 1e-6, bf16 one ulp (1e-2).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.models import convs as ref_convs
from gigl_tpu.models import encoders as ref_enc
from gigl_tpu.ops import fanout as ref_fanout
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph, build_csr
from gigl_tpu_torch.models import convs, encoders
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.models.link_prediction import (
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.ops import attention, ell, ell_aggregate, fanout
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.trainer import NALPTrainer, NALPTrainerConfig

torch.set_num_threads(1)

B, K, DIN, OUT, HEADS = 48, 6, 16, 8, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, dtype):
    got = got.float().detach().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _block(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, DIN)).astype(np.float32)
    nbr = rng.normal(size=(B, K, DIN)).astype(np.float32)
    mask = rng.random((B, K)) < 0.6
    mask[:3] = False          # rows with no valid slot
    mask[3] = True
    dst_deg = rng.integers(0, 30, B).astype(np.float32)
    nbr_deg = rng.integers(0, 30, (B, K)).astype(np.float32)
    agg = rng.normal(size=(B, DIN)).astype(np.float32)
    return x, nbr, mask, dst_deg, nbr_deg, agg


def _pair(conv, kw, dtype):
    jdt, tdt = DTYPES[dtype]
    ref_cls = {"gcn": ref_convs.GCNConv, "gin": ref_convs.GINConv,
               "gat": ref_convs.GATConv,
               "transformer": ref_convs.TransformerConv}[conv]
    port_cls = {"gcn": convs.GCNConv, "gin": convs.GINConv,
                "gat": convs.GATConv,
                "transformer": convs.TransformerConv}[conv]
    x, nbr, mask, *_ = _block()
    jconv = ref_cls(out_dim=OUT, dtype=jdt, **kw)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(nbr), jnp.asarray(mask))
    sd = params_from_flax({"conv_0": _np(params["params"])})
    port = port_cls(DIN, OUT, dtype=tdt, **kw)
    port.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    return jconv, params, port


BLOCK_CASES = [
    ("gcn", {}, "float32", False), ("gcn", {}, "float32", True),
    ("gin", {}, "float32", False), ("gin", {"train_eps": False}, "float32",
                                    False),
    ("gat", {"heads": HEADS}, "float32", False),
    ("gat", {"heads": HEADS, "v2": True}, "float32", False),
    ("gat", {"heads": HEADS, "concat_heads": False}, "float32", False),
    ("gat", {"heads": HEADS}, "bfloat16", False),
    ("transformer", {"heads": HEADS}, "float32", False)]


@pytest.mark.parametrize("conv,kw,dtype,with_degrees", BLOCK_CASES)
def test_dense_block_matches_jax(conv, kw, dtype, with_degrees):
    jdt, tdt = DTYPES[dtype]
    jconv, params, port = _pair(conv, kw, dtype)
    x, nbr, mask, dst_deg, nbr_deg, _ = _block()
    jd = (jnp.asarray(dst_deg), jnp.asarray(nbr_deg)) if with_degrees \
        else None
    td = (torch.from_numpy(dst_deg), torch.from_numpy(nbr_deg)) \
        if with_degrees else None
    want = jconv.apply(params, jnp.asarray(x).astype(jdt),
                       jnp.asarray(nbr).astype(jdt), jnp.asarray(mask), None,
                       jd)
    with torch.no_grad():
        got = port.block(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(nbr).to(tdt),
                         torch.from_numpy(mask), None, td)
    _close(got, want, dtype)


@pytest.mark.parametrize("conv", ["gcn", "gin"])
def test_block_cached_matches_jax(conv):
    jconv, params, port = _pair(conv, {}, "float32")
    x, _, _, dst_deg, _, agg = _block(1)
    want = jconv.apply(params, jnp.asarray(x), jnp.asarray(agg),
                       jnp.asarray(dst_deg), method="block_cached")
    with torch.no_grad():
        got = port.block_cached(torch.from_numpy(x), torch.from_numpy(agg),
                                torch.from_numpy(dst_deg))
    _close(got, want, "float32")


@pytest.mark.parametrize("conv", ["gcn", "gat", "transformer"])
def test_sampled_encoder_matches_jax(conv):
    """The sampled dense-block encoder path (no cache) with the new convs,
    GCN with hop degrees."""
    rng = np.random.default_rng(2)
    levels = [(B,), (B, 4), (B, 4, 3)]
    feats = [rng.normal(size=s + (DIN,)).astype(np.float32) for s in levels]
    masks = [np.ones((B,), bool)] + [rng.random(s) < 0.7 for s in levels[1:]]
    masks[2] &= masks[1][..., None]
    degs = [rng.integers(0, 9, s).astype(np.float32) for s in levels]
    kw = {"heads": HEADS} if conv != "gcn" else {}
    jenc = ref_enc.GNNEncoder(hid_dim=16, out_dim=OUT, conv=conv,
                              conv_kwargs=kw)
    jf, jm = [jnp.asarray(f) for f in feats], [jnp.asarray(m) for m in masks]
    jdg = [jnp.asarray(d) for d in degs]
    params = jenc.init(jax.random.PRNGKey(0), jf, jm, hop_degrees=jdg)
    want = jenc.apply(params, jf, jm, hop_degrees=jdg)
    enc = encoders.GNNEncoder(DIN, 16, OUT, conv=conv, conv_kwargs=kw)
    enc.load_state_dict(params_from_flax(_np(params)))
    with torch.no_grad():
        got = enc([torch.from_numpy(f) for f in feats],
                  [torch.from_numpy(m) for m in masks],
                  hop_degrees=[torch.from_numpy(d) for d in degs])
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_softmax_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(20, 3, 9)) * 4).astype(np.float32)
    mask = rng.random((20, 1, 9)) < 0.5
    mask[:2] = False
    want = np.asarray(ref_fanout.masked_softmax(
        jnp.asarray(logits).astype(jdt), jnp.asarray(mask)).astype(
            jnp.float32))
    got = fanout.masked_softmax(torch.from_numpy(logits).to(tdt),
                                torch.from_numpy(mask))
    assert got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_array_equal(got[:2], 0.0)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # No gradient through the max: the Jacobian of softmax, as JAX's.
    lt = torch.from_numpy(logits).requires_grad_()
    g = torch.from_numpy(rng.normal(size=logits.shape).astype(np.float32))
    (gl,) = torch.autograd.grad(fanout.masked_softmax(
        lt, torch.from_numpy(mask)), lt, g)
    _, vjp = jax.vjp(lambda a: ref_fanout.masked_softmax(
        a, jnp.asarray(mask)), jnp.asarray(logits))
    np.testing.assert_allclose(gl.numpy(), np.asarray(vjp(jnp.asarray(
        g.numpy()))[0]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["mean", "sum", "max", "gcn"])
def test_ell_aggregate_plain_matches_reference_ops(op):
    """K6's twin against the reference's gather + masked reduce (GCN: the
    weighted sum of GCNConv.block with degrees)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(30, 8)).astype(np.float32)
    nbr = rng.integers(0, 30, (12, 5)).astype(np.int32)
    mask = rng.random((12, 5)) < 0.6
    mask[0] = False
    deg = rng.integers(0, 9, 30).astype(np.float32)
    feats = jnp.asarray(x)[nbr]
    if op == "gcn":
        w = jax.lax.rsqrt(jnp.asarray(deg[:12]) + 1.0)[:, None] * \
            jax.lax.rsqrt(jnp.asarray(deg)[nbr] + 1.0)
        want = ref_fanout.masked_sum(feats * w[..., None], jnp.asarray(mask))
    else:
        want = getattr(ref_fanout, f"masked_{op}")(feats, jnp.asarray(mask))
    got = ell_aggregate._ell_aggregate_plain(
        torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(mask),
        op, torch.from_numpy(deg[:12]), torch.from_numpy(deg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_kernel_wrappers_backward_raises():
    """The backward wrappers (K6b, K7b) raise on a mode they do not take and
    on inputs a mode needs but was not given; the ELL max backward (K6b with
    tie counts) trains."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(10, 8)).astype(np.float32))
    nbr = torch.from_numpy(rng.integers(0, 10, (4, 3)).astype(np.int32))
    mask = torch.ones((4, 3), dtype=torch.bool)
    src, dst = rng.integers(0, 10, 30), rng.integers(0, 10, 30)
    tell = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=10),
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        ell_aggregate.ell_transpose_aggregate(x, tell, "min")
    with pytest.raises(ValueError, match="rows2 and table"):
        ell_aggregate.ell_transpose_aggregate(x, tell, "max")
    with pytest.raises(ValueError, match="weighted takes wt"):
        ell_aggregate.ell_transpose_aggregate(x, tell, "weighted")
    with pytest.raises(ValueError, match="Unknown attention mode"):
        attention.fanout_attention_bwd(x[:4], x[:4], x, x, nbr, mask, x[:4],
                                       None, "gatv3", 2)
    xg = x.clone().requires_grad_()
    ell_aggregate.ell_aggregate_graph(xg, tell, "max").sum().backward()
    assert xg.grad is not None and xg.grad.abs().sum() > 0


def _sampled_trainer(conv, seed=6):
    rng = np.random.default_rng(seed)
    n = 60
    src, dst = rng.integers(0, n, 400), rng.integers(0, n, 400)
    g = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=n,
        node_features=rng.normal(size=(n, DIN)).astype(np.float32)),
        supervision_edges=np.stack([src, dst]), device="cpu")
    model = LinkPredictionGNN(encoders.GNNEncoder(
        DIN, 16, OUT, conv=conv, conv_kwargs={"heads": HEADS}),
        LinkPredictionDecoder())
    t = NALPTrainer(model, g, NALPTrainerConfig(fanouts=(3, 2),
                                                num_random_negs=8),
                    optimizer_args={"learning_rate": "0.01"}, device="cpu")
    return t, t.init_state(0), rng


def test_sampled_attention_train_step_trains():
    """A sampled GAT, GATv2 and Transformer step trains through K7b."""
    for conv in ("gat", "gatv2", "transformer"):
        t, state, rng = _sampled_trainer(conv)
        assert t.encode_batch(np.arange(8)).shape == (8, OUT)
        before = [p.detach().clone() for p in t.model.parameters()]
        state, loss = t.train_step(state, rng.integers(0, 60, 8))
        assert state.step == 1 and torch.isfinite(loss)
        assert all(not torch.equal(a, p.detach())
                   for a, p in zip(before, t.model.parameters())), conv


BLOCK_GRAD_CASES = [("gat", {"heads": HEADS}, "float32"),
                    ("gat", {"heads": HEADS, "concat_heads": False},
                     "float32"),
                    ("gat", {"heads": 4}, "float32"),
                    ("gat", {"heads": HEADS, "v2": True}, "float32"),
                    ("gat", {"heads": HEADS, "v2": True}, "bfloat16"),
                    ("transformer", {"heads": HEADS}, "float32"),
                    ("gat", {"heads": HEADS}, "bfloat16"),
                    ("transformer", {"heads": HEADS}, "bfloat16")]


@pytest.mark.parametrize("conv,kw,dtype", BLOCK_GRAD_CASES)
def test_attention_block_backward_matches_jax(conv, kw, dtype):
    """K7b's twin (identity layout) through the dense block: the gradients
    of x_dst, the neighbor block and every parameter against jax.vjp of
    GATConv.block (v1, v2) / TransformerConv.block, with rows of no valid
    slot.
    fp32 within 1e-5 of each gradient's scale; bf16 within 2e-2. The
    Transformer's key bias has a zero gradient by symmetry (it shifts every
    slot's logit alike): in bf16 both sides hold rounding noise of up to
    ~0.1 of the largest gradient, so it is held to 1/4 of that there."""
    jdt, tdt = DTYPES[dtype]
    jconv, params, port = _pair(conv, kw, dtype)
    x, nbr, mask, *_ = _block(7)
    g = np.random.default_rng(8).normal(size=(B, OUT)).astype(np.float32)

    def f(p, xd, nb):
        return jconv.apply(p, xd, nb, jnp.asarray(mask))

    want_out, vjp = jax.vjp(f, params, jnp.asarray(x).astype(jdt),
                            jnp.asarray(nbr).astype(jdt))
    wp, wx, wn = vjp(jnp.asarray(g).astype(want_out.dtype))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    nt = torch.from_numpy(nbr).to(tdt).requires_grad_()
    out = port.block(xt, nt, torch.from_numpy(mask))
    _close(out, want_out, dtype)
    out.backward(torch.from_numpy(g).to(tdt))
    tol = 1e-5 if dtype == "float32" else 2e-2
    want = {"x_dst": wx, "nbr": wn,
            **{k[len("convs.0."):]: v for k, v in params_from_flax(
                {"conv_0": _np(wp["params"])}).items()}}
    got = {"x_dst": xt.grad, "nbr": nt.grad,
           **{k: p.grad for k, p in port.named_parameters()}}
    assert set(got) == set(want)
    floor = 1e-2 * max(float(np.abs(np.asarray(
        jnp.asarray(w).astype(jnp.float32))).max()) for w in want.values())
    for name, w in want.items():
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        assert got[name] is not None, name
        atol = tol * max(np.abs(w).max(), floor)
        if name == "lin_k.bias" and dtype == "bfloat16":
            atol = 0.25 * floor / 1e-2
        np.testing.assert_allclose(got[name].float().numpy(), w, rtol=0,
                                   atol=atol, err_msg=name)
    assert not nt.grad[~torch.from_numpy(mask)].any()   # masked slots: 0


def test_init_params_covers_attention_and_eps():
    for conv in ("gat", "gatv2", "gin", "transformer", "gcn"):
        kw = {"heads": 4} if conv in ("gat", "gatv2", "transformer") else {}
        enc = encoders.GNNEncoder(DIN, 64, OUT, conv=conv, conv_kwargs=kw)
        with torch.no_grad():
            for p in enc.parameters():
                p.fill_(7.0)
        init_params(enc, 3)
        again = encoders.GNNEncoder(DIN, 64, OUT, conv=conv, conv_kwargs=kw)
        init_params(again, 3)
        for (name, p), q in zip(enc.named_parameters(), again.parameters()):
            p = p.detach()
            assert torch.equal(p, q), name
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bias", "eps"):
                assert not p.any(), name
            elif leaf.startswith("att"):
                limit = math.sqrt(6.0 / sum(p.shape))
                assert float(p.abs().max()) <= limit
                assert float(p.abs().max()) > 0.5 * limit, name
            else:
                fan_in = p.shape[1]
                assert float(p.abs().max()) * math.sqrt(fan_in) <= 2.28, name


def test_unsupported_trees_raise():
    with pytest.raises(ValueError, match="unsupported conv parameter"):
        params_from_flax({"conv_0": {"lin_other": {"kernel": np.zeros((2, 2))}}})
    with pytest.raises(ValueError, match="unsupported conv parameter"):
        params_from_flax({"conv_0": {"mlp": {"dense": {}}}})
