"""GATv2 with edge rows (``GATConv(v2=True, use_edge_attr=True)``) in the
port (gigl_tpu_torch) against the JAX reference, on the CPU, where every
kernel runs its plain twin: the dense block form (K7 / K7b over the block
with the edge rows added), the ELL form (K7 with its edge addend, K7b, K11's
gatv2 mode for the edge table and K6b's sum of that table over
``EllGraph.t_edge`` for the key table) and the COO form (K10's gatv2 mode
with the edge row, K9, K8's add mode; backward K10 with the addend, K9b,
K11's gatv2 mode, K8b's sum of its table along the source walk, K8's
gatv2 destination walk with the edge rows). Then the encoder built as the
reference builds it (``conv="gatv2", conv_kwargs={"use_edge_attr":
True}``: no ``edge_in_proj``, ``lin_edge`` reads the raw edge rows),
``encode_ell`` / ``encode_coo`` / ``run_full_graph_inference``, one
``FullBatchTrainer`` step over ELL and over COO, and ROADMAP C12's case
(pre-activations of exactly 0, where JAX's leaky' is 1).

The graph is ``tests/test_torch_edge_features.py``'s: 200 nodes, ~1,500
random edges with 5 features each, three isolated nodes, a hub of
in-degree 40.

Tolerances:
- fp32: the same sums in another order. Forwards within 1e-5 of the
  output's largest entry; every gradient (parameters, node rows, edge
  rows) within 1e-5 of its own largest entry (1e-4 through the two-layer
  encoder and the trainer step, as the other encode tests hold them); the
  step's loss within 1e-5 relative. The key table's gradient is the edge
  table's summed by source (``d ks[j] = sum_{e: src e = j} d he[e]``,
  exactly), where the reference sums the gathered rows' cotangent by
  source: the same terms, rounded once each.
- bf16: the reference adds ``hs + he`` and then ``+ hd`` in bf16 and
  rounds every Dense output, where the port's kernels add in fp32 and
  round once, so a pre-activation near 0 can take the other side of the
  leaky on one side only. Forwards within 2e-2 of the output's scale;
  gradients against the reference's bf16 ones within 8e-2 of each one's
  scale. Measured: up to 5.7e-2 (``lin_dst``'s gradient in the ELL form,
  a sum over every node that cancels); the reference's own bf16 gradient
  of it sits 7.0e-2 from its fp32 one in the COO form, the port's 5.8e-2.
- integer tables (``t_edge``): bit-equal to their definition.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as RefHeteroGraph
from gigl_tpu.inference.inferencer import (
    run_full_graph_inference as ref_run_full_graph_inference,
)
from gigl_tpu.losses.losses import cross_entropy_loss as ref_ce
from gigl_tpu.models import convs as ref_convs
from gigl_tpu.models.encoders import GNNEncoder as RefGNNEncoder
from gigl_tpu.ops import ell as ref_ell
from gigl_tpu.ops import segment as ref_seg
from gigl_tpu.training import full_batch as ref_fb
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.inference.inferencer import run_full_graph_inference
from gigl_tpu_torch.models import convs
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.ops import coo_edges, ell, segment
from gigl_tpu_torch.ops.ell_aggregate import ell_edge_rows_sum
from gigl_tpu_torch.training import full_batch as fb
from tests.test_torch_edge_features import (
    DE,
    DIN,
    DTYPES,
    HEADS,
    HID,
    N,
    OUT,
    _close,
    _ells,
    _graph,
    _grads_close,
    _np,
)

torch.set_num_threads(1)

C = 6
OPT = {"learning_rate": "0.01"}
KW = {"heads": HEADS, "use_edge_attr": True}


def _t32(a):
    return torch.as_tensor(np.asarray(a).astype(np.int32))


def _tols(dtype):
    """(forward, gradient) tolerances over the scale (module docstring)."""
    return (1e-5, 1e-5) if dtype == "float32" else (2e-2, 8e-2)


def _conv_pair(dtype, seed=3):
    jdt, tdt = DTYPES[dtype]
    jconv = ref_convs.GATConv(out_dim=OUT, v2=True, dtype=jdt, **KW)
    rng = np.random.default_rng(seed)
    params = jconv.init(
        jax.random.PRNGKey(seed + 1),
        jnp.asarray(rng.normal(size=(3, DIN)), jnp.float32),
        jnp.asarray(rng.normal(size=(3, 2, DIN)), jnp.float32),
        jnp.ones((3, 2), bool),
        jnp.asarray(rng.normal(size=(3, 2, DE)), jnp.float32))
    tconv = convs.GATConv(DIN, OUT, v2=True, dtype=tdt, edge_dim=DE, **KW)
    tconv.load_state_dict({k[len("convs.0."):]: v for k, v in
                           params_from_flax({"conv_0": _np(
                               params["params"])}).items()})
    return jconv, params, tconv


def _form_fns(form, src, dst, mask=None):
    """(reference fn of (conv, params, *inputs), port fn of (conv,
    *inputs)) for one form."""
    if form == "block":
        def jfn(conv_, p, x_dst, nbr, ea_):
            return conv_.apply(p, x_dst, nbr, mask, ea_)

        def tfn(conv_, x_dst, nbr, ea_):
            return conv_.block(x_dst, nbr, torch.from_numpy(mask), ea_)
        return jfn, tfn
    if form == "ell":
        jell, tell = _ells(src, dst)

        def jfn(conv_, p, x_p, ea_):
            return conv_.apply(p, x_p, jell, ea_, method=lambda m, *a:
                               ref_ell.ell_layer(m, *a))

        def tfn(conv_, x_p, ea_):
            return conv_.ell(x_p, tell, ea_)
        return jfn, tfn
    args = (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), N)

    def jfn(conv_, p, x, ea_):
        return conv_.apply(p, x, *args, ea_, method="coo")

    def tfn(conv_, x, ea_):
        return conv_.coo(x, _t32(src), _t32(dst), N, ea_)
    return jfn, tfn


def _inputs(form, src, zero_rows=0, seed=5):
    rng = np.random.default_rng(seed)
    if form == "block":
        n, k = 40, 6
        mask = rng.random((n, k)) < 0.7
        mask[:3] = False                     # rows with no valid slot
        jin = (rng.normal(size=(n, DIN)).astype(np.float32),
               rng.normal(size=(n, k, DIN)).astype(np.float32),
               rng.normal(size=(n, k, DE)).astype(np.float32))
        return jin, mask, n
    x = rng.normal(size=(N, DIN)).astype(np.float32)
    ea = rng.normal(size=(len(src), DE)).astype(np.float32)
    if zero_rows:
        x[:zero_rows] = 0.0
        ea[:] = np.where(np.asarray(src)[:, None] < zero_rows, 0.0, ea)
    return (x, ea), None, N


def _check_conv(form, dtype, zero_rows=0):
    jdt, tdt = DTYPES[dtype]
    ftol, gtol = _tols(dtype)
    jconv, params, tconv = _conv_pair(dtype)
    src, dst, _ = _graph()
    jin, mask, n_out = _inputs(form, src, zero_rows)
    jfn, tfn = _form_fns(form, src, dst, mask)
    cot = np.random.default_rng(6).normal(size=(n_out, OUT)).astype(
        np.float32)

    @jax.jit
    def fwd_bwd(p, c, *a):
        out, vjp = jax.vjp(lambda p_, *a_: jfn(jconv, p_, *a_), p, *a)
        return out, vjp(c.astype(out.dtype))

    want, wgrads = fwd_bwd(params, jnp.asarray(cot),
                           *(jnp.asarray(a).astype(jdt) for a in jin))
    tin = [torch.from_numpy(a).to(tdt).requires_grad_() for a in jin]
    got = tfn(tconv, *tin)
    assert got.dtype == tdt
    _close(got, want, ftol, "forward")
    got.backward(torch.from_numpy(cot).to(tdt))
    _grads_close(tconv, wgrads[0], gtol)
    for t, w, what in zip(tin, wgrads[1:], ("x", "nbr", "edge_attr")[
            -len(tin):]):
        _close(t.grad, w, gtol, f"d {what}")
    return tin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["block", "ell", "coo"])
def test_gatv2_edges_conv_matches_jax(form, dtype):
    """One GATConv(v2=True, use_edge_attr=True) layer in each form: the
    output and the gradients of every parameter (att and lin_edge's
    included), the node rows and the edge rows, against jax.vjp of the
    reference in the same dtype."""
    _check_conv(form, dtype)


@pytest.mark.parametrize("form", ["ell", "coo"])
def test_gatv2_edges_over_zero_rows_match_jax(form):
    """ROADMAP C12's case with edge rows: the first 20 node rows and the
    edge rows of their out-edges are zero, so the edges between them have
    pre-activations of exactly 0 (hs + he + hd = 0), where JAX's leaky'
    is 1: K11's gate, K8's destination walk and K7b's must take 1 there."""
    tin = _check_conv(form, "float32", zero_rows=20)
    assert np.abs(tin[0].grad[:20].numpy()).max() > 0


# -- the ops -------------------------------------------------------------------
def test_t_edge_is_the_composed_edge_of_each_transpose_slot():
    """EllGraph.t_edge = ent_edge[t_nbr] under t_mask, -1 elsewhere, and
    every COO edge appears once across the transpose buckets."""
    src, dst, _ = _graph()
    _, tell = _ells(src, dst)
    seen = []
    for t_nbr, t_mask, t_edge in zip(tell.t_nbr, tell.t_mask, tell.t_edge):
        want = np.where(t_mask.numpy(),
                        tell.ent_edge.numpy()[t_nbr.numpy()], -1)
        np.testing.assert_array_equal(t_edge.numpy(), want)
        seen.append(t_edge.numpy()[t_mask.numpy()])
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(len(src)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_rows_summed_by_source_match_segment_sum(dtype):
    """K6b's sum over t_edge (ELL, x_p order) and K8b's sum along the
    source walk (COO): a per-edge table summed into its edges' source
    rows, against the reference's segment_sum by source (fp32 sums, one
    rounding: within one rounding of the output type)."""
    jdt, tdt = DTYPES[dtype]
    src, dst, _ = _graph()
    _, tell = _ells(src, dst)
    rows = np.random.default_rng(7).normal(size=(len(src), 8)).astype(
        np.float32)
    rows_t = torch.from_numpy(rows).to(tdt)
    want = np.asarray(ref_seg.segment_sum(
        jnp.asarray(rows_t.float().numpy()), jnp.asarray(src), N))
    tol = 1e-6 if dtype == "float32" else 4e-3
    got_coo = segment.edge_rows_by_source(rows_t, _t32(src), N)
    assert got_coo.dtype == tdt
    _close(got_coo, want, tol, "coo")
    got_ell = ell_edge_rows_sum(rows_t, tell)
    assert got_ell.dtype == tdt
    _close(got_ell, want[tell.perm.numpy()], tol, "ell (x_p order)")


def _gatv2_edge_inputs(seed=8, zero=False):
    src, dst, _ = _graph()
    rng = np.random.default_rng(seed)
    h, dh = 2, 4
    hs = rng.normal(size=(N, h, dh)).astype(np.float32)
    hd = rng.normal(size=(N, h, dh)).astype(np.float32)
    he = rng.normal(size=(len(src), h * dh)).astype(np.float32)
    att = rng.normal(size=(h, dh)).astype(np.float32)
    if zero:
        hs[:20] = hd[:20] = 0.0
        he[src < 20] = 0.0
    return src, dst, hs, hd, he, att


@pytest.mark.parametrize("zero", [False, True])
def test_coo_gatv2_edges_op_matches_jax(zero):
    """coo_gatv2_edges: the output and the cotangents of hs, hd, he and att
    against jax.vjp of the reference's arithmetic (gather, add, leaky,
    segment_softmax, segment_sum)."""
    src, dst, hs, hd, he, att = _gatv2_edge_inputs(zero=zero)
    e, (h, dh) = len(src), att.shape

    def ref(hs_, hd_, he_, att_):
        k = hs_[jnp.asarray(src)] + he_.reshape(e, h, dh)
        z = jax.nn.leaky_relu(k + hd_[jnp.asarray(dst)], 0.2)
        alpha = ref_seg.segment_softmax(jnp.einsum("ehd,hd->eh", z, att_),
                                        jnp.asarray(dst), N)
        return ref_seg.segment_sum((alpha[..., None] * k).reshape(e, -1),
                                   jnp.asarray(dst), N)

    want, vjp = jax.vjp(ref, *map(jnp.asarray, (hs, hd, he, att)))
    t = [torch.from_numpy(a).requires_grad_() for a in (hs, hd, he, att)]
    got = coo_edges.coo_gatv2_edges(_t32(src), _t32(dst), *t,
                                    negative_slope=0.2)
    _close(got, want, 1e-5, "forward")
    cot = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    for tt, w, what in zip(t, vjp(jnp.asarray(cot)),
                           ("hs", "hd", "he", "att")):
        _close(tt.grad, w, 1e-5, what)


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_edge_grad_gatv2_twin_formula(layout):
    """K11's gatv2 mode (ELL and COO forms): alpha * g[dst] + coef * att *
    leaky'((x[src] + ea) + xd[dst]) per edge, against the formula written
    out in numpy over the COO edges."""
    src, dst, hs, hd, he, att = _gatv2_edge_inputs(seed=10, zero=True)
    e, (h, dh) = len(src), att.shape
    rng = np.random.default_rng(11)
    g = rng.normal(size=(N, h * dh)).astype(np.float32)
    alpha = rng.random((e, h)).astype(np.float32)
    coef = rng.normal(size=(e, h)).astype(np.float32)
    z = hs.reshape(N, -1)[src] + he + hd.reshape(N, -1)[dst]
    want = (np.repeat(alpha, dh, 1) * g[dst] + np.repeat(coef, dh, 1)
            * att.reshape(-1) * np.where(z >= 0, 1.0, 0.2))
    x, xd = torch.from_numpy(hs.reshape(N, -1)), torch.from_numpy(
        hd.reshape(N, -1))
    kw = dict(x=x, ea=torch.from_numpy(he), vec=torch.from_numpy(
        att.reshape(-1)), heads=h, negative_slope=0.2)
    if layout == "coo":
        got = ell.coo_edge_grad(torch.from_numpy(g), _t32(src), _t32(dst),
                                None, "gatv2", alpha=torch.from_numpy(alpha),
                                coef=torch.from_numpy(coef), xd=xd, **kw)
    else:
        _, tell = _ells(src, dst)
        perm, rank = tell.perm.numpy(), tell.rank.numpy()
        p = tell.edge_pos.numpy()
        pa = np.zeros((tell.ent_row.shape[0], h), np.float32)
        pc = np.zeros_like(pa)
        pa[p], pc[p] = alpha, coef
        kw["x"], kw["ea"] = x[perm], kw["ea"]
        got = ell.ell_edge_grad(torch.from_numpy(g[perm]), tell, "gatv2",
                                alpha=torch.from_numpy(pa),
                                coef=torch.from_numpy(pc), xd=xd[perm], **kw)
        assert (rank[src] == tell.ent_src.numpy()[p]).all()
    _close(got, want, 1e-6, layout)


# -- the encoder, the inferencer and the trainer ------------------------------------
def _encoders(seed=0):
    src, dst, ea = _graph()
    x = np.random.default_rng(seed).normal(size=(N, DIN)).astype(np.float32)
    jenc = RefGNNEncoder(hid_dim=HID, out_dim=OUT, num_layers=2,
                         conv="gatv2", conv_kwargs=KW, edge_dim=DE)
    jell, tell = _ells(src, dst)
    params = jax.jit(lambda k, x_, e, a: jenc.init(
        k, x_, e, a, method="encode_ell"))(
            jax.random.PRNGKey(seed), jnp.asarray(x), jell, jnp.asarray(ea))
    enc = GNNEncoder(DIN, HID, OUT, num_layers=2, conv="gatv2",
                     conv_kwargs=KW, edge_dim=DE)
    enc.load_state_dict(params_from_flax(_np(params)))
    return jenc, params, enc, (src, dst, x, ea, jell, tell)


@pytest.mark.parametrize("path", ["ell", "coo"])
def test_gatv2_edges_encoder_matches_jax(path):
    """Two GATv2 layers with lin_edge over the raw edge rows (the encoder
    builds no edge_in_proj for GATv2, as the reference's): encode_ell /
    encode_coo, the embeddings and every gradient (lin_edge's, the node
    features' and the raw edge rows') against jax.vjp of the reference's
    encode_ell / encode_coo."""
    jenc, params, enc, (src, dst, x, ea, jell, tell) = _encoders()
    names = {n for n, _ in enc.named_parameters()}
    assert "edge_in_proj.weight" not in names
    assert {"convs.0.lin_edge.weight", "convs.1.lin_edge.weight"} <= names
    args = (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), N)
    if path == "ell":
        def f(p, x_, ea_):
            return jenc.apply(p, x_, jell, ea_, method="encode_ell")
    else:
        def f(p, x_, ea_):
            return jenc.apply(p, x_, *args, ea_, method="encode_coo")
    want, vjp = jax.jit(lambda p, x_, ea_: jax.vjp(f, p, x_, ea_))(
        params, jnp.asarray(x), jnp.asarray(ea))
    tx = torch.from_numpy(x).requires_grad_()
    tea = torch.from_numpy(ea).requires_grad_()
    if path == "ell":
        got = enc.encode_ell(tx, tell, tea)
    else:
        got = enc.encode_coo(tx, _t32(src), _t32(dst), N, tea)
    _close(got, want, 1e-4, "forward")
    cot = np.random.default_rng(6).normal(size=want.shape).astype(np.float32)
    gp, gx, gea = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    wp = params_from_flax(_np(gp))
    largest = max(float(w.abs().max()) for w in wp.values())
    for name, p in enc.named_parameters():
        scale = max(float(wp[name].abs().max()), 1e-2 * largest)
        np.testing.assert_allclose(p.grad.numpy(), wp[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    _close(tx.grad, gx, 1e-4, "d x")
    _close(tea.grad, gea, 1e-4, "d edge_attr")


def test_run_full_graph_inference_with_gatv2_edges():
    """run_full_graph_inference(edge_attr=) over GATv2 with edge rows: the
    exported ids and embeddings against the reference's inferencer."""
    jenc, params, enc, (src, dst, x, ea, _, _) = _encoders(seed=1)

    class Sink:
        def __init__(self):
            self.ids, self.embs = [], []

        def add_embeddings(self, ids, emb):
            self.ids.append(np.asarray(ids))
            self.embs.append(np.asarray(emb, np.float32))

        def flush(self):
            pass

    ref_sink, sink = Sink(), Sink()
    ref_run_full_graph_inference(
        jenc, params, RefHeteroGraph.homogeneous(src, dst, num_nodes=N,
                                                 node_features=x),
        ref_sink, edge_attr=jnp.asarray(ea), export_batch=64)
    n = run_full_graph_inference(
        enc, params_from_flax(_np(params)),
        HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x),
        sink, edge_attr=ea, export_batch=64, device="cpu")
    assert n == N
    np.testing.assert_array_equal(np.concatenate(sink.ids),
                                  np.concatenate(ref_sink.ids))
    _close(np.concatenate(sink.embs), np.concatenate(ref_sink.embs), 1e-4)


def _trainers(build_ell):
    src, dst, ea = _graph()
    rng = np.random.default_rng(12)
    x = rng.normal(size=(N, DIN)).astype(np.float32)
    labels = rng.integers(0, C, N)
    jenc = RefGNNEncoder(hid_dim=HID, out_dim=C, num_layers=2, conv="gatv2",
                         conv_kwargs=KW, edge_dim=DE)
    args = (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), N)
    params = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x), *args,
                       jnp.asarray(ea), method="encode_coo")
    enc = GNNEncoder(DIN, HID, C, num_layers=2, conv="gatv2",
                     conv_kwargs=KW, edge_dim=DE)
    enc.load_state_dict(params_from_flax(_np(params)))
    jdata = ref_fb.full_batch_data_from_graph(RefHeteroGraph.homogeneous(
        src, dst, num_nodes=N, node_features=x, node_labels=labels),
        build_ell=build_ell)._replace(edge_attr=jnp.asarray(ea))
    pdata = dataclasses.replace(fb.full_batch_data_from_graph(
        HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x,
                                node_labels=labels),
        build_ell=build_ell, device="cpu"), edge_attr=torch.from_numpy(ea))
    jt = ref_fb.FullBatchTrainer(jenc, jdata, optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), params=params)
    pt = fb.FullBatchTrainer(enc, pdata, optimizer_args=OPT, device="cpu")
    return jt, js, pt


@pytest.mark.parametrize("build_ell", [True, False])
def test_gatv2_edges_full_batch_step_matches_jax(build_ell):
    """One FullBatchTrainer step over ELL (build_ell=True) and over COO
    edges, GATv2 with edge rows: the loss within 1e-5 relative and every
    parameter's gradient within 1e-4 of its scale, against
    jax.value_and_grad of the reference's step loss."""
    jt, js, pt = _trainers(build_ell)
    d = jt.data

    def loss_fn(p):
        logits = jt._forward(d, p, False)
        s, c = ref_ce(logits, d.labels, mask=d.train_mask)
        return s / jnp.maximum(c.astype(jnp.float32), 1.0)

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(js.params)
    loss = pt.loss()
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    wp = params_from_flax(_np(jgrad))
    largest = max(float(w.abs().max()) for w in wp.values())
    for name, p in pt.encoder.named_parameters():
        scale = max(float(wp[name].abs().max()), 1e-2 * largest)
        np.testing.assert_allclose(p.grad.numpy(), wp[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
