"""The COO per-edge terms of the port (gigl_tpu_torch) against the JAX
reference, on the CPU, where every segment kernel runs its plain twin
inside the port's ``autograd.Function``s: GINE (``relu(x[src] + e)``, K8's
gine mode; backward K8b's gine gate and K11's COO form), EdgeAttrGAT and
the Transformer with edge rows (``ops/coo_edges.py``: K8's add mode, K10's
key addend; backward K11's COO form), GATv2's ``coo`` (K10's gatv2 mode;
backward K8b's and K8's gatv2 modes), ``GNNEncoder.encode_coo(edge_attr=)``
over the graph in its destination walk order (``ops/segment.py``
``coo_walk``), ``FullBatchTrainer(build_ell=False)`` with edge features,
and ROADMAP C12 (LeakyReLU's derivative at exactly 0, JAX's 1) in the GAT
and SimpleHGN ``coo`` forms.

The graph is ``tests/test_torch_coo.py``'s (160 nodes, hubs of in-degree
30 and out-degree 50, isolated nodes and sinks) with a seeded [E, 3] edge
table.

Tolerances: fp32, the same sums in another order. Forward outputs within
1e-5 of the output's scale; every gradient (parameters, ``edge_in_proj``'s
and ``lin_edge``'s included, the node features and the raw edge rows)
within 1e-5 of its largest entry (a gradient that is zero by symmetry, the
Transformer's key bias, against 1e-2 of the model's largest gradient);
training losses within 1e-5 relative; integer tables bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as RefHeteroGraph
from gigl_tpu.losses.losses import cross_entropy_loss as ref_ce
from gigl_tpu.models import convs as ref_convs
from gigl_tpu.models.encoders import GNNEncoder as RefGNNEncoder
from gigl_tpu.ops import segment as ref_seg
from gigl_tpu.training import full_batch as ref_fb
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models import convs
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.ops import coo_edges
from gigl_tpu_torch.ops.ell import EllGraph
from gigl_tpu_torch.ops.segment import SegmentIndex, coo_spmm, coo_walk
from gigl_tpu_torch.training import full_batch as fb
from tests.test_torch_coo import DIN, HID, N, _arrays

torch.set_num_threads(1)

DE, OUT, HEADS, C = 3, 8, 2, 6
OPT = {"learning_rate": "0.01"}
EDGE_CONVS = ["gine", "edge_attr_gat", "transformer", "gatv2"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _edges(seed=0):
    src, dst, x, labels = _arrays(seed)
    ea = np.random.default_rng(seed + 11).normal(
        size=(len(src), DE)).astype(np.float32)
    return src, dst, x, labels, ea


def _t32(a):
    return torch.as_tensor(np.asarray(a).astype(np.int32))


def _close(got, want, tol=1e-5, scale=None, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _params_close(module, want, prefix=""):
    """Every parameter's gradient against the flax-converted ``want``."""
    names = {n for n, _ in module.named_parameters()}
    want = {k[len(prefix):]: v for k, v in want.items()
            if k.startswith(prefix)}
    assert names == set(want), (names, set(want))
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for name, p in module.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None, name
        _close(p.grad, w, 1e-5, max(np.abs(w).max(), floor), name)


# -- the walk view ---------------------------------------------------------------
def test_coo_walk_relabels_the_graph_in_walk_order():
    """The walk-ordered graph lists the same edges, each destination's
    contiguous and in its original order; its destination index's order is
    the identity, and its source index lists each source's edges by their
    destination-walk rank (the edge position K8b reads), the same edges as
    the original source index's. The walk is kept on the index for the
    index's own source ids and built anew for another tensor."""
    src, dst, *_ = _edges()
    idx = SegmentIndex.from_ids(dst, N, "cpu", gather=src)
    sidx = SegmentIndex.from_ids(src, N, "cpu", gather=dst)
    w = coo_walk(idx, idx.gather)
    assert coo_walk(idx, idx.gather) is w        # kept on the index
    other = coo_walk(idx, idx.gather.clone())    # other ids: built anew
    assert other is not w and idx.walk is w
    assert all(torch.equal(a, b) for a, b in (
        (other.src, w.src), (other.dst, w.dst), (other.rank, w.rank),
        (other.src_index.order, w.src_index.order)))
    perm, rank = w.perm.numpy(), w.rank.numpy()
    np.testing.assert_array_equal(perm, np.argsort(dst, kind="stable"))
    np.testing.assert_array_equal(rank[perm], np.arange(len(src)))
    np.testing.assert_array_equal(w.src.numpy(), src[perm])
    np.testing.assert_array_equal(w.dst.numpy(), dst[perm])
    np.testing.assert_array_equal(w.index.order.numpy(),
                                  np.arange(len(src)))
    np.testing.assert_array_equal(w.index.ptr.numpy(), idx.ptr.numpy())
    order_w = w.src_index.order.numpy()
    np.testing.assert_array_equal(order_w, np.argsort(src[perm],
                                                      kind="stable"))
    np.testing.assert_array_equal(w.src_index.ptr.numpy(), sidx.ptr.numpy())
    ptr = sidx.ptr.numpy()
    for s in range(N):
        lo, hi = ptr[s], ptr[s + 1]
        np.testing.assert_array_equal(
            order_w[lo:hi], np.sort(rank[sidx.order.numpy()[lo:hi]]))
    np.testing.assert_array_equal(w.src_index.gathered.numpy(),
                                  dst[perm][order_w])
    assert w.index.gather is w.src and w.src_index.gather is w.dst


# -- the ops ---------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["add", "gine"])
@pytest.mark.parametrize("walk", [False, True])
def test_coo_spmm_edge_rows_match_jax(mode, walk):
    """coo_spmm with edge rows, per-head weights in the add mode: the
    output and the cotangents of x, the weights and the edge rows against
    jax.vjp of the reference's gather, add (relu) and segment_sum, over
    the edges in their own order or in walk order."""
    src, dst, *_ = _edges()
    rng = np.random.default_rng(5)
    e, h, dh = len(src), 2, 4
    x = rng.normal(size=(N, h, dh)).astype(np.float32)
    ea = rng.normal(size=(e, h, dh)).astype(np.float32)
    w = rng.random((e, h)).astype(np.float32) if mode == "add" else None
    ts, td = _t32(src), _t32(dst)
    idx = SegmentIndex.from_ids(td, N, gather=ts)
    sidx = SegmentIndex.from_ids(ts, N, gather=td)
    perm = np.arange(e)
    if walk:
        wv = coo_walk(idx, idx.gather)
        perm = wv.perm.numpy()
        ts, td, idx, sidx = wv.src, wv.dst, wv.index, wv.src_index

    def ref(x_, ea_, w_):
        m = x_[jnp.asarray(src)] + ea_
        m = jax.nn.relu(m) if mode == "gine" else m * w_[..., None]
        return ref_seg.segment_sum(m, jnp.asarray(dst), N)

    want, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(ea),
                        jnp.asarray(w if w is not None else np.ones((e, h),
                                                                    np.float32)))
    tx = torch.from_numpy(x).requires_grad_()
    tea = torch.from_numpy(ea[perm]).requires_grad_()
    tw = None if w is None else torch.from_numpy(w[perm]).requires_grad_()
    got = coo_spmm(ts, td, tx, N, edge_weight=tw, index=idx, src_index=sidx,
                   edge_rows=tea, edge_mode=mode)
    _close(got, want)
    cot = rng.normal(size=want.shape).astype(np.float32)
    dx, dea, dw = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    _close(tx.grad, dx, what="dx")
    _close(tea.grad, np.asarray(dea)[perm], what="d edge rows")
    if tw is not None:
        _close(tw.grad, np.asarray(dw)[perm], what="d weights")


def test_gatv2_scores_match_jax():
    """K10's gatv2 mode and its backward (K8b's and K8's gatv2 modes): the
    logits and the cotangents of hs, hd and att against jax.vjp, over
    zero rows too (a pre-activation of exactly 0: leaky' is 1 there)."""
    src, dst, *_ = _edges()
    rng = np.random.default_rng(6)
    h, dh = 2, 4
    hs = rng.normal(size=(N, h, dh)).astype(np.float32)
    hd = rng.normal(size=(N, h, dh)).astype(np.float32)
    hs[:20] = 0.0
    hd[:20] = 0.0
    att = rng.normal(size=(h, dh)).astype(np.float32)

    def ref(hs_, hd_, att_):
        z = jax.nn.leaky_relu(hs_[jnp.asarray(src)] + hd_[jnp.asarray(dst)],
                              0.2)
        return jnp.einsum("ehd,hd->eh", z, att_)

    want, vjp = jax.vjp(ref, *map(jnp.asarray, (hs, hd, att)))
    t = [torch.from_numpy(a).requires_grad_() for a in (hs, hd, att)]
    got = coo_edges.gatv2_scores(_t32(src), _t32(dst), *t,
                                 negative_slope=0.2)
    _close(got, want)
    cot = rng.normal(size=want.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    for tt, w, what in zip(t, vjp(jnp.asarray(cot)), ("hs", "hd", "att")):
        _close(tt.grad, w, what=what)


# -- each conv's coo form ------------------------------------------------------------
def _ref_conv(conv):
    if conv == "gine":
        return ref_convs.GINEConv(out_dim=OUT)
    if conv == "transformer":
        return ref_convs.TransformerConv(out_dim=OUT, heads=HEADS,
                                         use_edge_attr=True)
    return ref_convs.GATConv(out_dim=OUT, heads=HEADS, v2=conv == "gatv2",
                             use_edge_attr=conv == "edge_attr_gat")


def _port_conv(conv, din, de):
    if conv == "gine":
        return convs.GINEConv(din, OUT)
    if conv == "transformer":
        return convs.TransformerConv(din, OUT, heads=HEADS,
                                     use_edge_attr=True, edge_dim=de)
    return convs.GATConv(din, OUT, heads=HEADS, v2=conv == "gatv2",
                         use_edge_attr=conv == "edge_attr_gat", edge_dim=de)


def _conv_case(conv, zero_rows=0, gine_zeros=False, seed=0):
    """The reference conv, its params and the port's conv with them, and
    the inputs: x [N, din], the edges and their rows (GINE's as wide as x;
    none for GATv2)."""
    src, dst, x, _, ea = _edges(seed)
    din = DIN
    if conv == "gine":
        ea = np.random.default_rng(seed + 3).normal(
            size=(len(src), din)).astype(np.float32)
    x = x.copy()
    x[:zero_rows] = 0.0
    if gine_zeros:   # x[src] + e exactly 0 on every even edge
        ea[::2] = -x[src[::2]]
    ea = None if conv == "gatv2" else ea
    jconv = _ref_conv(conv)
    args = (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), N)
    params = jconv.init(jax.random.PRNGKey(seed + 1), jnp.asarray(x), *args,
                        None if ea is None else jnp.asarray(ea),
                        method="coo")
    tconv = _port_conv(conv, din, None if ea is None else ea.shape[1])
    sd = {k[len("convs.0."):]: v for k, v in params_from_flax(
        {"conv_0": _np(params["params"])}).items()}
    tconv.load_state_dict(sd)
    return jconv, params, tconv, (src, dst, x, ea, args)


def _conv_matches(conv, **kw):
    jconv, params, tconv, (src, dst, x, ea, args) = _conv_case(conv, **kw)

    def f(p, x_, ea_):
        return jconv.apply(p, x_, *args, ea_, method="coo")

    want, vjp = jax.vjp(f, params, jnp.asarray(x),
                        None if ea is None else jnp.asarray(ea))
    tx = torch.from_numpy(x).requires_grad_()
    tea = None if ea is None else torch.from_numpy(ea).requires_grad_()
    got = tconv.coo(tx, _t32(src), _t32(dst), N, tea)
    _close(got, want, what="forward")
    cot = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    gp, gx, gea = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    _params_close(tconv, params_from_flax({"conv_0": _np(gp["params"])}),
                  "convs.0.")
    _close(tx.grad, gx, what="dx")
    if ea is not None:
        _close(tea.grad, gea, what="d edge rows")


@pytest.mark.parametrize("conv", EDGE_CONVS)
def test_conv_coo_with_edges_matches_jax(conv):
    """Each conv's coo form (GINE, EdgeAttrGAT and the Transformer with
    their edge rows, GATv2): the output and the gradients of every
    parameter (lin_edge's included), the node rows and the edge rows
    against jax.vjp."""
    _conv_matches(conv)


def test_gine_coo_gate_at_exact_zero_matches_jax():
    """GINE with edge rows chosen so that x[src] + e is exactly 0 on half
    the edges: jax.nn.relu's derivative there is 0, and K8b's gine gate and
    K11's are strict."""
    _conv_matches("gine", gine_zeros=True)


def test_gatv2_coo_over_zero_feature_rows_matches_jax():
    """GATv2 over 20 zero feature rows (ROADMAP C12's case): edges between
    them have a pre-activation of exactly 0, where JAX's leaky' is 1."""
    _conv_matches("gatv2", zero_rows=20)


def test_gatv2_coo_with_edge_rows_raises():
    """GATv2 with edge rows (ROADMAP B6b) raised here until its coo form
    had the edge row inside K10's, K8's and K11's GATv2 modes; it now runs
    and matches the reference's coo form (its output, within 1e-5 of the
    scale; tests/test_torch_gatv2_edges.py holds the gradients), while a
    GATv2 that reads no edge rows ignores them."""
    src, dst, x, _, ea = _edges()
    args = (torch.from_numpy(x), _t32(src), _t32(dst), N,
            torch.from_numpy(ea))
    jconv = ref_convs.GATConv(out_dim=OUT, heads=HEADS, v2=True,
                              use_edge_attr=True)
    jargs = (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), N,
             jnp.asarray(ea))
    params = jconv.init(jax.random.PRNGKey(2), jnp.asarray(x), *jargs,
                        method="coo")
    v2 = convs.GATConv(DIN, OUT, heads=HEADS, v2=True, use_edge_attr=True,
                       edge_dim=DE)
    v2.load_state_dict({k[len("convs.0."):]: v for k, v in params_from_flax(
        {"conv_0": _np(params["params"])}).items()})
    with torch.no_grad():
        _close(v2.coo(*args), jconv.apply(params, jnp.asarray(x), *jargs,
                                          method="coo"), what="forward")
    plain = convs.GATConv(DIN, OUT, heads=HEADS, v2=True)
    with torch.no_grad():
        assert torch.equal(plain.coo(*args), plain.coo(*args[:4]))


@pytest.mark.parametrize("conv", ["gat", "edge_attr_gat"])
def test_gat_coo_zero_rows_input_gradient_matches_jax_grad(conv):
    """ROADMAP C12: GATConv.coo took its logit's LeakyReLU with
    F.leaky_relu, whose derivative at exactly 0 is the slope; JAX's is 1.
    40 nodes, 200 random edges, rows 0-19 of x zero, one layer of 2 heads
    of 4: jax.grad of sum(out * w) in x, within 1e-5 of its scale."""
    rng = np.random.default_rng(12)
    n, e = 40, 200
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, DIN)).astype(np.float32)
    x[:20] = 0.0
    ea = np.zeros((e, DE), np.float32) if conv == "edge_attr_gat" else None
    jconv = ref_convs.GATConv(out_dim=OUT, heads=HEADS,
                              use_edge_attr=conv == "edge_attr_gat")
    args = (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), n)
    jea = None if ea is None else jnp.asarray(ea)
    params = jconv.init(jax.random.PRNGKey(3), jnp.asarray(x), *args, jea,
                        method="coo")
    tconv = convs.GATConv(DIN, OUT, heads=HEADS,
                          use_edge_attr=conv == "edge_attr_gat",
                          edge_dim=None if ea is None else DE)
    tconv.load_state_dict({k[len("convs.0."):]: v for k, v in
                           params_from_flax({"conv_0": _np(
                               params["params"])}).items()})
    wts = rng.normal(size=(n, OUT)).astype(np.float32)
    want = jax.grad(lambda x_: (jconv.apply(params, x_, *args, jea,
                                            method="coo") * wts).sum())(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tconv.coo(tx, _t32(src), _t32(dst), n,
                    None if ea is None else torch.from_numpy(ea))
    (out * torch.from_numpy(wts)).sum().backward()
    assert np.abs(np.asarray(want)[:20]).max() > 0
    _close(tx.grad, want, what="dx")


def test_simple_hgn_coo_zero_rows_input_gradient_matches_jax_grad():
    """ROADMAP C12 in SimpleHGNConv.coo (its logit's LeakyReLU): typed
    rows of width 16 (its projection is shared by the types) with 20 zero
    paper rows and 10 zero author rows, and ``att_rel`` zero, so that an
    edge between zero rows has a logit of exactly 0; the output and the
    inputs' cotangent against jax.vjp of the reference's coo form."""
    from gigl_tpu.models import hetero_convs as ref_hconvs
    from gigl_tpu_torch.models import hetero_convs
    from tests.test_torch_hetero import (
        EDGE_TYPES,
        NODE_TYPES,
        _full_inputs,
        _graphs,
        _ref_full_inputs,
    )
    port_g, ref_g = _graphs()
    _, edges, nn_ = _full_inputs(port_g)
    _, redges, _ = _ref_full_inputs(ref_g)
    rng = np.random.default_rng(13)
    h = {nt: rng.normal(size=(n, 16)).astype(np.float32)
         for nt, n in nn_.items()}
    h["paper"][:20] = 0.0
    h["author"][:10] = 0.0
    ref = ref_hconvs.SimpleHGNConv(out_dim=8, heads=2, node_types=NODE_TYPES,
                                   edge_types=EDGE_TYPES)
    jh = {nt: jnp.asarray(v) for nt, v in h.items()}
    params = ref.init(jax.random.PRNGKey(5), jh, redges, nn_, method="coo")
    params = {"params": {**params["params"], "att_rel": jnp.zeros_like(
        params["params"]["att_rel"])}}
    mine = hetero_convs.SimpleHGNConv(16, 8, NODE_TYPES, EDGE_TYPES,
                                      heads=2)
    from gigl_tpu_torch.convert import _typed
    mine.load_state_dict(_typed(_np(params["params"]), ""))
    want, vjp = jax.vjp(lambda h_: ref.apply(params, h_, redges, nn_,
                                             method="coo"), jh)
    cot = {nt: rng.normal(size=np.shape(want[nt])).astype(np.float32)
           for nt in NODE_TYPES}
    (dh,) = vjp({nt: jnp.asarray(c) for nt, c in cot.items()})
    ht = {nt: torch.from_numpy(v).requires_grad_() for nt, v in h.items()}
    got = mine.coo(ht, edges, nn_)
    torch.autograd.backward([got[nt] for nt in NODE_TYPES],
                            [torch.from_numpy(cot[nt]) for nt in NODE_TYPES])
    for nt in NODE_TYPES:
        _close(got[nt], want[nt], what=f"forward {nt}")
        _close(ht[nt].grad, dh[nt], what=f"d {nt}")


# -- encode_coo and the trainer -------------------------------------------------------
def _enc_kw(conv):
    kw = {} if conv == "gine" else {"heads": HEADS}
    if conv == "transformer":
        kw["use_edge_attr"] = True
    return kw


def _enc_case(conv, seed=0):
    src, dst, x, labels, ea = _edges(seed)
    din = HID if conv == "gine" else DIN   # GINE adds edge rows to x
    x = np.random.default_rng(seed + 4).normal(size=(N, din)).astype(
        np.float32)
    jenc = RefGNNEncoder(hid_dim=HID, out_dim=C, num_layers=2, conv=conv,
                         conv_kwargs=_enc_kw(conv), edge_dim=DE)
    args = (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), N)
    params = jenc.init(jax.random.PRNGKey(seed), jnp.asarray(x), *args,
                       jnp.asarray(ea), method="encode_coo")
    enc = GNNEncoder(din, HID, C, num_layers=2, conv=conv,
                     conv_kwargs=_enc_kw(conv), edge_dim=DE)
    enc.load_state_dict(params_from_flax(_np(params)))
    return jenc, params, enc, (src, dst, x, labels, ea, args)


@pytest.mark.parametrize("conv", EDGE_CONVS)
def test_encode_coo_with_edges_matches_jax(conv):
    """Two layers through edge_in_proj over the walk-ordered graph: the
    embeddings and the gradients of every parameter (edge_in_proj's and
    lin_edge's included), the node features and the raw edge rows (in COO
    order) against jax.vjp of the reference's encode_coo."""
    jenc, params, enc, (src, dst, x, _, ea, args) = _enc_case(conv)
    want, vjp = jax.vjp(lambda p, x_, ea_: jenc.apply(
        p, x_, *args, ea_, method="encode_coo"), params, jnp.asarray(x),
        jnp.asarray(ea))
    tx = torch.from_numpy(x).requires_grad_()
    tea = torch.from_numpy(ea).requires_grad_()
    got = enc.encode_coo(tx, _t32(src), _t32(dst), N, tea)
    _close(got, want, what="forward")
    cot = np.random.default_rng(7).normal(size=want.shape).astype(np.float32)
    gp, gx, gea = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    wp = params_from_flax(_np(gp))
    if conv == "gatv2":   # edge_in_proj is made for edge convs only
        assert tea.grad is None and "edge_in_proj.weight" not in wp
    else:
        assert "edge_in_proj.weight" in wp
        _close(tea.grad, gea, what="d edge_attr")
    assert any("lin_edge" in k for k in wp) == (conv in ("edge_attr_gat",
                                                         "transformer"))
    _params_close(enc, wp)
    _close(tx.grad, gx, what="dx")


def _trainers(conv):
    jenc, params, enc, (src, dst, x, labels, ea, _) = _enc_case(conv)
    jdata = ref_fb.full_batch_data_from_graph(RefHeteroGraph.homogeneous(
        src, dst, num_nodes=N, node_features=x, node_labels=labels),
        build_ell=False)._replace(edge_attr=jnp.asarray(ea))
    pdata = dataclasses.replace(fb.full_batch_data_from_graph(
        HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x,
                                node_labels=labels),
        build_ell=False, device="cpu"), edge_attr=torch.from_numpy(ea))
    jt = ref_fb.FullBatchTrainer(jenc, jdata, optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), params=params)
    pt = fb.FullBatchTrainer(enc, pdata, optimizer_args=OPT, device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(params)))
    return jt, js, pt, ps


@pytest.mark.parametrize("conv", EDGE_CONVS)
def test_full_batch_coo_step_with_edges_matches_jax(conv):
    """One FullBatchTrainer(build_ell=False) step over edge features: the
    loss, and every parameter's gradient against jax.value_and_grad of the
    reference's step loss."""
    jt, js, pt, ps = _trainers(conv)
    d = jt.data

    def loss_fn(p):
        logits = jt._forward(d, p, False)
        s, c = ref_ce(logits, d.labels, mask=d.train_mask)
        return s / jnp.maximum(c.astype(jnp.float32), 1.0)

    jloss, jgrad = jax.value_and_grad(loss_fn)(js.params)
    loss = pt.loss()
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _params_close(pt.encoder, params_from_flax(_np(jgrad)))
    assert pt.data.index.walk is not None or conv == "gatv2"


@pytest.mark.parametrize("conv", EDGE_CONVS)
def test_full_batch_coo_trajectory_with_edges_matches_jax(conv):
    """20 Adam steps (lr 0.01) over the COO edges with edge features: the
    losses within 1e-5 relative, and the same accuracies after them."""
    jt, js, pt, ps = _trainers(conv)
    want, got = [], []
    for _ in range(20):
        js, loss = jt._train_step(jt.data, js, jax.random.PRNGKey(1))
        want.append(float(loss))
        ps, loss = pt.train_step(ps)
        got.append(float(loss))
    assert ps.step == 20
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[-1] < want[0]
    for split in ("train", "val", "test"):
        assert pt.accuracy(split) == jt.accuracy(js.params, split), split


@pytest.mark.parametrize("conv", EDGE_CONVS)
def test_coo_and_ell_paths_agree_with_edges(conv):
    """The port's two exact full-graph paths over the same edge-featured
    graph: encode_coo (the walk-ordered COO graph, K8-K11's COO forms) and
    encode_ell (the degree buckets, K6 / K7 and K11), and their gradients
    in x and the edge rows."""
    _, _, enc, (src, dst, x, _, ea, _) = _enc_case(conv)
    g = HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x)
    ell = EllGraph.from_csr(g.csr(g.metadata.edge_types[0], anchor="dst"),
                            device="cpu")
    outs = []
    for path in ("coo", "ell"):
        tx = torch.from_numpy(x).requires_grad_()
        tea = torch.from_numpy(ea).requires_grad_()
        out = (enc.encode_coo(tx, _t32(src), _t32(dst), N, tea)
               if path == "coo" else enc.encode_ell(tx, ell, tea))
        out.square().sum().backward()
        outs.append((out, tx.grad, tea.grad))
    (a, ax, aea), (b, bx, bea) = outs
    _close(a, b.detach().numpy(), what="forward")
    _close(ax, bx.numpy(), what="dx")
    if conv == "gatv2":
        assert aea is None and bea is None
    else:
        _close(aea, bea.numpy(), what="d edge_attr")
