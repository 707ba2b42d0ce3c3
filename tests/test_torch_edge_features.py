"""Parity of the port's edge features (gigl_tpu_torch: GINE, EdgeAttrGAT and
the Transformer with ``lin_edge`` on the dense-block and ELL paths, K11
``ell_edge_grad`` and the ``gine`` modes of K6 / K6b) with the JAX
reference, on the CPU where every kernel runs its plain twin.

The graph: 200 nodes, ~1,500 random directed edges with 5 features each,
three isolated nodes and one hub of in-degree 40 (ELL buckets of widths 4
to 64, all-masked rows in bucket 0). Params come from JAX through
params_from_flax; inputs are made with numpy from a seed.

Tolerances:
- integer tables and the hydrated edge rows: bit-equal;
- fp32: the same sums in another order, within 1e-5 of each output's (or
  gradient's) largest entry (1e-4 through a two-layer encoder, as
  tests/test_torch_ell.py holds encode_ell);
- bf16: the reference adds ``nbr + edge_attr`` and ``hs + he`` in bf16
  before the relu or the logit and rounds every Dense output, where the
  port's kernels add in fp32 and round once. Forwards within 2e-2 of the
  output's largest entry, and so are the gradients against the
  reference's bf16 gradients (measured up to 1.5e-2), except GINE's ELL
  form: there the sum ``x_j + e_ij`` is rounded once in the port and
  twice in the reference, so a sum near 0 can take the other side of the
  relu gate (K6's, or the MLP's behind it) on one side only, which moves
  one row's share of a gradient. Measured: up to 1.9e-1 of the scale (the
  edge rows' gradient), held to 2.5e-1; its fp32 gradients are held to
  1e-5 like every other;
- 20-step fp32 full-batch trajectories: 1e-4 relative (the existing
  full-batch trajectories' bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as RefHeteroGraph
from gigl_tpu.graph.csr import build_csr as ref_build_csr
from gigl_tpu.inference.inferencer import (
    run_full_graph_inference as ref_run_full_graph_inference,
)
from gigl_tpu.models import convs as ref_convs
from gigl_tpu.models.encoders import GNNEncoder as RefGNNEncoder
from gigl_tpu.ops import ell as ref_ell
from gigl_tpu.ops.fanout import masked_sum as ref_masked_sum
from gigl_tpu.training import full_batch as ref_fb
from gigl_tpu.training.dataset import DeviceGraph as RefDeviceGraph
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph, build_csr
from gigl_tpu_torch.inference.inferencer import run_full_graph_inference
from gigl_tpu_torch.models import convs
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.ops import ell
from gigl_tpu_torch.ops.ell_aggregate import (
    ell_aggregate_graph,
    ell_transpose_aggregate,
)
from gigl_tpu_torch.training import full_batch as fb
from gigl_tpu_torch.training.dataset import DeviceGraph

torch.set_num_threads(1)

N, DIN, HID, OUT, HEADS, DE = 200, 12, 16, 8, 2, 5
ISOLATED = (3, 77, 199)
HUB = 5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 1500)
    dst = rng.integers(0, N, 1500)
    keep = ~(np.isin(src, ISOLATED) | np.isin(dst, ISOLATED) | (dst == HUB))
    hub_src = rng.choice([v for v in range(N) if v not in ISOLATED], 40,
                         replace=False)
    src = np.concatenate([src[keep], hub_src])
    dst = np.concatenate([dst[keep], np.full(40, HUB)])
    ea = rng.normal(size=(len(src), DE)).astype(np.float32)
    return src, dst, ea


def _ells(src, dst, widths=None):
    return (ref_ell.EllGraph.from_csr(ref_build_csr(
                src, dst, num_anchor_nodes=N, num_neighbor_nodes=N),
                widths=widths),
            ell.EllGraph.from_csr(build_csr(
                src, dst, num_anchor_nodes=N, num_neighbor_nodes=N),
                widths=widths, device="cpu"))


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.detach().float().numpy()


def _close(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# -- the tables -----------------------------------------------------------------
@pytest.mark.parametrize("widths", [None, (4, 8, 16, 64)])
def test_entry_tables_bit_equal(widths):
    """ent_src / ent_edge: the reference's nbr / edge_slots flattened in
    entry order; edge_pos a permutation onto the valid entries."""
    src, dst, _ = _graph()
    jell, tell = _ells(src, dst, widths)
    flat = [np.concatenate([np.asarray(t).reshape(-1) for t in tables])
            for tables in (jell.nbr, jell.edge_slots, jell.mask)]
    np.testing.assert_array_equal(tell.ent_src.numpy(), flat[0])
    np.testing.assert_array_equal(tell.ent_edge.numpy(), flat[1])
    np.testing.assert_array_equal(tell.ent_mask.numpy(), flat[2])
    pos = tell.edge_pos.numpy()
    np.testing.assert_array_equal(pos, np.asarray(jell.edge_pos))
    assert flat[2][pos].all() and len(set(pos.tolist())) == len(src)
    np.testing.assert_array_equal(flat[1][pos], np.arange(len(src)))


def _graph_of(kind):
    """The edge sets K11's validity table is checked on: the module's graph,
    a hub of in-degree 3,000 (a width-4096 bucket), repeated edges and
    self-loops beside isolated nodes, and no edges."""
    src, dst, _ = _graph()
    if kind == "hub":
        rng = np.random.default_rng(11)
        src = np.concatenate([src, rng.integers(0, N, 3000)])
        dst = np.concatenate([dst, np.full(3000, HUB)])
    elif kind == "multi":
        src = np.concatenate([src, [7, 7, 7, 9, 9, 10]])
        dst = np.concatenate([dst, [8, 8, 8, 9, 9, 10]])
    elif kind == "edgeless":
        src = dst = np.zeros((0,), np.int64)
    return src, dst


@pytest.mark.parametrize("kind", ["random", "hub", "multi", "edgeless"])
def test_entry_validity_table(kind):
    """ent_mask, the flat table K11 reads to skip padding entries: the
    port's per-bucket masks flattened and the reference's, bit for bit
    (the reference builds no edgeless EllGraph, whose entries are all
    padding); edge_pos[ent_edge[p]] == p exactly on the valid entries; the
    valid entries are the edges, each once."""
    src, dst = _graph_of(kind)
    if kind == "edgeless":   # the reference's from_csr needs an edge
        tell = ell.EllGraph.from_csr(build_csr(
            src, dst, num_anchor_nodes=N, num_neighbor_nodes=N),
            device="cpu")
        jmask = np.zeros(tell.ent_row.shape[0], bool)
    else:
        jell, tell = _ells(src, dst)
        jmask = np.concatenate([np.asarray(m).reshape(-1)
                                for m in jell.mask])
    if kind == "hub":
        assert tell.widths[-1] == 4096
    valid = tell.ent_mask.numpy()
    assert tell.ent_mask.dtype == torch.bool
    assert valid.shape == (tell.ent_row.shape[0],)
    np.testing.assert_array_equal(valid, torch.cat(
        [m.reshape(-1) for m in tell.mask]).numpy())
    np.testing.assert_array_equal(valid, jmask)
    ent_edge, pos = tell.ent_edge.numpy(), tell.edge_pos.numpy()
    p = np.arange(len(valid))
    if len(src):
        np.testing.assert_array_equal(pos[ent_edge] == p, valid)
    assert int(valid.sum()) == len(src)
    np.testing.assert_array_equal(np.sort(ent_edge[valid]),
                                  np.arange(len(src)))
    np.testing.assert_array_equal(np.sort(pos), p[valid])


# -- K6 / K6b gine and K11 against jax.vjp of the reference's ops -----------------
def _ref_gine_agg(x_p, ea, jell):
    """The reference's ell_gather + ell_gather_edges + GINEConv.block's
    masked sum of relu(nbr + ea), per bucket, concatenated."""
    nbr = ref_ell.ell_gather(x_p, jell.nbr, jell.mask, jell.t_nbr,
                             jell.t_mask, jell.t_rank)
    eab = ref_ell.ell_gather_edges(ea, jell.edge_slots, jell.mask,
                                   jell.edge_pos)
    return jnp.concatenate([
        ref_masked_sum(jax.nn.relu(nbr[b] + eab[b]), jell.mask[b])
        for b in range(len(jell.widths))
        if jell.boundaries[b + 1] > jell.boundaries[b]], axis=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gine_modes_match_jax_vjp(dtype):
    jdt, tdt = DTYPES[dtype]
    src, dst, _ = _graph()
    jell, tell = _ells(src, dst)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, HID)).astype(np.float32)
    ea = rng.normal(size=(len(src), HID)).astype(np.float32)
    g = rng.normal(size=(N, HID)).astype(np.float32)
    jx, jea = (jnp.asarray(a).astype(jdt) for a in (x, ea))
    want, vjp = jax.vjp(lambda a, b: _ref_gine_agg(a, b, jell), jx, jea)
    want_dx, want_dea = vjp(jnp.asarray(g).astype(jdt))
    tx, tea = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, ea))
    got = ell_aggregate_graph(tx, tell, "gine", ea=tea)
    tg = torch.from_numpy(g).to(tdt)
    got.backward(tg)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got, want, tol, "forward")
    _close(tx.grad, want_dx, tol, "d x_p")
    _close(tea.grad, want_dea, tol, "d edge_attr")
    # the wrappers called directly, as the autograd node calls them
    _close(ell_transpose_aggregate(tg, tell, "gine", table=tx.detach(),
                                   ea=tea.detach()), want_dx, tol)
    _close(ell.ell_edge_grad(tg, tell, "gine", x=tx.detach(),
                             ea=tea.detach()), want_dea, tol)


@pytest.mark.parametrize("mode", ["gat", "transformer"])
def test_edge_grad_matches_jax_vjp_of_ell_gather_edges(mode):
    """K11's twin: the per-entry terms alpha * g[row] + coef * (att_src |
    the query row), masked and permuted by edge_pos, against jax.vjp of
    ell_gather_edges fed the same terms as its block cotangents."""
    src, dst, _ = _graph()
    jell, tell = _ells(src, dst)
    rng = np.random.default_rng(2)
    p_total = tell.ent_row.shape[0]
    d = HEADS * 4
    g = rng.normal(size=(N, d)).astype(np.float32)
    xd = rng.normal(size=(N, d)).astype(np.float32)
    vec = rng.normal(size=(d,)).astype(np.float32)
    alpha = rng.random((p_total, HEADS)).astype(np.float32)
    coef = rng.normal(size=(p_total, HEADS)).astype(np.float32)
    row = tell.ent_row.numpy()
    other = vec[None, :] if mode == "gat" else xd[row]
    terms = (np.repeat(alpha, 4, 1) * g[row] + np.repeat(coef, 4, 1) * other)
    blocks = tuple(jnp.asarray(terms[o:o1].reshape(
                       (hi - lo, w, d)))
                   for o, o1, lo, hi, w in zip(
                       tell.ent_off, tell.ent_off[1:], tell.boundaries,
                       tell.boundaries[1:], tell.widths))
    ea0 = jnp.zeros((len(src), d))
    _, vjp = jax.vjp(lambda e: ref_ell.ell_gather_edges(
        e, jell.edge_slots, jell.mask, jell.edge_pos), ea0)
    (want,) = vjp(blocks)
    got = ell.ell_edge_grad(
        torch.from_numpy(g), tell, mode, alpha=torch.from_numpy(alpha),
        coef=torch.from_numpy(coef),
        vec=torch.from_numpy(vec) if mode == "gat" else None,
        xd=torch.from_numpy(xd) if mode == "transformer" else None,
        heads=HEADS)
    _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="missing"):
        ell.ell_edge_grad(torch.from_numpy(g), tell, mode)


def test_edgeless_graph():
    """No edges: K6 gine gives relu-free zeros, K11 an empty table."""
    src = dst = np.zeros((0,), np.int64)
    tell = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N,
                                           num_neighbor_nodes=N),
                                 device="cpu")
    x = torch.randn(N, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    ea = torch.zeros((0, 8), requires_grad=True)
    out = ell_aggregate_graph(x, tell, "gine", ea=ea)
    assert out.shape == (N, 8) and not out.detach().any()
    out.sum().backward()
    assert not x.grad.any() and ea.grad.shape == (0, 8)


# -- each edge conv, block and ELL forms ---------------------------------------------
CONVS = {"gine": (ref_convs.GINEConv, convs.GINEConv, {}),
         "edge_attr_gat": (ref_convs.GATConv, convs.GATConv,
                           {"heads": HEADS, "use_edge_attr": True}),
         "transformer": (ref_convs.TransformerConv, convs.TransformerConv,
                         {"heads": HEADS, "use_edge_attr": True})}


def _conv_pair(conv, dtype, din, de):
    jcls, tcls, kw = CONVS[conv]
    jdt, tdt = DTYPES[dtype]
    jconv = jcls(out_dim=OUT, dtype=jdt, **kw)
    rng = np.random.default_rng(3)
    params = jconv.init(
        jax.random.PRNGKey(4), jnp.asarray(rng.normal(size=(3, din)),
                                           jnp.float32),
        jnp.asarray(rng.normal(size=(3, 2, din)), jnp.float32),
        jnp.ones((3, 2), bool),
        jnp.asarray(rng.normal(size=(3, 2, de)), jnp.float32))
    extra = {} if conv == "gine" else {"edge_dim": de}
    tconv = tcls(din, OUT, dtype=tdt, **kw, **extra)
    sd = {k[len("convs.0."):]: v for k, v in params_from_flax(
        {"conv_0": _np(params["params"])}).items()}
    tconv.load_state_dict(sd)
    return jconv, params, tconv


def _grads_close(tconv, gparams, tol, symmetric=(), bf16=False):
    """Each parameter's gradient within ``tol`` of its own scale; one
    named in ``symmetric`` is zero by symmetry, so rounding noise on both
    sides: in fp32 held to ``tol`` of 1e-2 of the largest gradient, in
    bf16 (where the reference's own noise reaches 1.3e-1 of the largest)
    only to lie below 1e-1 of the largest."""
    want = {k[len("convs.0."):]: v for k, v in params_from_flax(
        {"conv_0": _np(gparams["params"])}).items()}
    assert set(want) == {n for n, _ in tconv.named_parameters()}
    largest = max(float(w.abs().max()) for w in want.values())
    for name, p in tconv.named_parameters():
        w = want[name].numpy()
        if name in symmetric and bf16:
            assert float(p.grad.abs().max()) <= 1e-1 * largest, name
            continue
        scale = max(float(np.abs(w).max()),
                    1e-2 * largest if name in symmetric else 0.0)
        np.testing.assert_allclose(_f32(p.grad), w, rtol=0, atol=tol * scale,
                                   err_msg=name)


def _tols(dtype, conv, form):
    """(forward, gradient) tolerances over the scale (module docstring)."""
    if dtype == "float32":
        return 1e-5, 1e-5
    return 2e-2, (2.5e-1 if (conv, form) == ("gine", "ell") else 2e-2)


EDGE_CASES = [(c, f, d) for c in CONVS for f in ("block", "ell")
              for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("conv,form,dtype", EDGE_CASES)
def test_edge_conv_matches_jax(conv, form, dtype):
    """Forward and every gradient (params, node rows, edge rows) of one
    edge conv, each dtype against the reference in the same dtype. The
    Transformer's lin_k.bias is zero by symmetry (a shift of all of a
    destination's logits): see ``_grads_close``."""
    jdt, tdt = DTYPES[dtype]
    ftol, gtol = _tols(dtype, conv, form)
    din = HID if conv == "gine" else DIN
    de = din if conv == "gine" else DE
    jconv, params, tconv = _conv_pair(conv, dtype, din, de)
    rng = np.random.default_rng(5)
    src, dst, ea = _graph()
    if conv == "gine":
        ea = rng.normal(size=(len(src), din)).astype(np.float32)
    if form == "block":
        n, k = 40, 6
        args = [rng.normal(size=(n, din)).astype(np.float32),
                rng.normal(size=(n, k, din)).astype(np.float32),
                rng.random((n, k)) < 0.7,
                rng.normal(size=(n, k, de)).astype(np.float32)]
        args[2][:3] = False                # rows with no valid slot

        def jfn(conv_, p, x_dst, nbr, ea_):
            return conv_.apply(p, x_dst, nbr, args[2], ea_)

        jin = (args[0], args[1], args[3])

        def tfn(conv_, x_dst, nbr, ea_):
            return conv_.block(x_dst, nbr, torch.from_numpy(args[2]), ea_)
    else:
        jell, tell = _ells(src, dst)

        def jfn(conv_, p, x_p, ea_):
            return conv_.apply(p, x_p, jell, ea_, method=lambda m, *a:
                               ref_ell.ell_layer(m, *a))

        jin = (rng.normal(size=(N, din)).astype(np.float32), ea)

        def tfn(conv_, x_p, ea_):
            return conv_.ell(x_p, tell, ea_)

    n_out = N if form == "ell" else args[0].shape[0]
    cot = rng.normal(size=(n_out, OUT)).astype(np.float32)

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
    _grads_close(tconv, wgrads[0], gtol,
                 symmetric=("lin_k.bias",) if conv == "transformer" else (),
                 bf16=dtype == "bfloat16")
    for t, w, what in zip(tin, wgrads[1:], ("x", "nbr", "edge_attr")[
            -len(tin):] if form == "block" else ("x_p", "edge_attr")):
        _close(t.grad, w, gtol, f"d {what}")


def test_gine_width_rule_raises():
    """GINE adds the edge rows to the node rows: the widths must agree
    (the encoder projects the edge rows to hid_dim, so layer 1 needs
    in_dim == hid_dim), as in the reference."""
    src, dst, _ = _graph()
    _, tell = _ells(src, dst)
    conv = convs.GINEConv(DIN, OUT)
    with pytest.raises(ValueError, match="incompatible"):
        conv.ell(torch.zeros(N, DIN), tell, torch.zeros(len(src), HID))
    with pytest.raises(ValueError, match="incompatible"):
        conv.block(torch.zeros(4, DIN), torch.zeros(4, 3, DIN),
                   torch.ones(4, 3, dtype=torch.bool),
                   torch.zeros(4, 3, HID))
    enc = GNNEncoder(DIN, HID, OUT, conv="gine", edge_dim=DE)
    with pytest.raises(ValueError, match="incompatible"):
        enc.encode_ell(torch.zeros(N, DIN), tell, torch.zeros(len(src), DE))


# -- the encoder and the inferencer ------------------------------------------------
ENC_CASES = [("gine", {}, "float32"), ("edge_attr_gat", {}, "float32"),
             ("transformer", {"use_edge_attr": True}, "float32"),
             ("transformer", {}, "float32"),
             ("edge_attr_gat", {}, "bfloat16")]


def _encoders(conv, kw, dtype, seed=0):
    jdt, tdt = DTYPES[dtype]
    kw = {**kw, **({} if conv == "gine" else {"heads": HEADS})}
    din = HID if conv == "gine" else DIN
    src, dst, ea = _graph()
    x = np.random.default_rng(seed).normal(size=(N, din)).astype(np.float32)
    jell, tell = _ells(src, dst)
    jenc = RefGNNEncoder(hid_dim=HID, out_dim=OUT, num_layers=2, conv=conv,
                         conv_kwargs=kw, edge_dim=DE, dtype=jdt)
    params = jax.jit(lambda k, x_, e, a: jenc.init(
        k, x_, e, a, method="encode_ell"))(
            jax.random.PRNGKey(seed), jnp.asarray(x), jell, jnp.asarray(ea))
    enc = GNNEncoder(din, HID, OUT, num_layers=2, conv=conv, conv_kwargs=kw,
                     edge_dim=DE, dtype=tdt)
    enc.load_state_dict(params_from_flax(_np(params)))
    return jenc, params, enc, (src, dst, x, ea, jell, tell)


@pytest.mark.parametrize("conv,kw,dtype", ENC_CASES)
def test_encode_ell_with_edges_matches_jax(conv, kw, dtype):
    """Two layers with edge_in_proj: the embeddings and, in fp32, every
    gradient (edge_in_proj's and the raw edge rows' included). With
    conv="transformer" and no use_edge_attr, edge_in_proj exists (as in
    flax) but no conv reads it."""
    jenc, params, enc, (src, dst, x, ea, jell, tell) = _encoders(conv, kw,
                                                                 dtype)
    names = {n for n, _ in enc.named_parameters()}
    assert "edge_in_proj.weight" in names
    assert any("lin_edge" in n for n in names) == (conv != "gine" and (
        conv == "edge_attr_gat" or kw.get("use_edge_attr", False)))

    def f(p, x_, ea_):
        return jenc.apply(p, x_, jell, ea_, method="encode_ell")

    want, vjp = jax.jit(lambda p, x_, ea_: jax.vjp(f, p, x_, ea_))(
        params, jnp.asarray(x), jnp.asarray(ea))
    tx = torch.from_numpy(x).requires_grad_()
    tea = torch.from_numpy(ea).requires_grad_()
    got = enc.encode_ell(tx, tell, tea)
    if dtype == "bfloat16":
        _close(got, want, 2e-2, "forward")
        return
    _close(got, want, 1e-4, "forward")
    cot = np.random.default_rng(6).normal(size=want.shape).astype(np.float32)
    gp, gx, gea = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    wp = params_from_flax(_np(gp))
    largest = max(float(w.abs().max()) for w in wp.values())
    for name, p in enc.named_parameters():
        if p.grad is None:                 # an edge_in_proj no conv reads
            assert conv == "transformer" and not wp[name].any()
            continue
        scale = max(float(wp[name].abs().max()), 1e-2 * largest)
        np.testing.assert_allclose(p.grad.numpy(), wp[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    _close(tx.grad, gx, 1e-4, "d x")
    if conv == "transformer" and not kw:
        assert tea.grad is None
    else:
        _close(tea.grad, gea, 1e-4, "d edge_attr")


def test_run_full_graph_inference_with_edges_matches_jax():
    jenc, params, enc, (src, dst, x, ea, _, _) = _encoders(
        "edge_attr_gat", {}, "float32", seed=1)

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


# -- the sampled path's edge rows ----------------------------------------------------
def test_hydrate_edges_bit_equal():
    """DeviceGraph keeps the edge features in CSR slot order; the sampled
    tree's per-hop edge rows are the drawn slots' rows, bit-equal."""
    src, dst, ea = _graph()
    x = np.random.default_rng(7).normal(size=(N, DIN)).astype(np.float32)
    jg = RefDeviceGraph.from_hetero(RefHeteroGraph.homogeneous(
        src, dst, num_nodes=N, node_features=x, edge_features=ea))
    pg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src, dst, num_nodes=N, node_features=x, edge_features=ea),
        device="cpu")
    np.testing.assert_array_equal(pg.edge_features.numpy(),
                                  np.asarray(jg.edge_features))
    roots = np.arange(0, N, 3, dtype=np.int32)
    jb = jg.sample_hop_blocks(jnp.asarray(roots), (5, 3), seed=2)
    pb = pg.sample_hop_blocks(torch.from_numpy(roots), (5, 3), seed=2)
    want, got = jg.hydrate_edges(jb), pg.hydrate_edges(pb)
    assert got[0] is None and want[0] is None and len(got) == 3
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert dataclasses.replace(pg, edge_features=None).hydrate_edges(
        pb) is None


# -- full-batch training ---------------------------------------------------------------
@pytest.mark.parametrize("conv", ["gine", "edge_attr_gat"])
def test_full_batch_trajectory_with_edges_matches_jax(conv):
    """FullBatchTrainer over the ELL tables with FullBatchData.edge_attr:
    20 fp32 steps (Adam 1e-2) against the reference's."""
    src, dst, ea = _graph()
    rng = np.random.default_rng(8)
    din = HID if conv == "gine" else DIN
    x = rng.normal(size=(N, din)).astype(np.float32)
    labels = rng.integers(0, 4, N)
    jdata = ref_fb.full_batch_data_from_graph(RefHeteroGraph.homogeneous(
        src, dst, num_nodes=N, node_features=x,
        node_labels=labels))._replace(edge_attr=jnp.asarray(ea))
    pdata = dataclasses.replace(fb.full_batch_data_from_graph(
        HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x,
                                node_labels=labels), device="cpu"),
        edge_attr=torch.from_numpy(ea))
    kw = {} if conv == "gine" else {"heads": HEADS}
    opt = {"learning_rate": "0.01"}
    jt = ref_fb.FullBatchTrainer(
        RefGNNEncoder(hid_dim=HID, out_dim=4, num_layers=2, conv=conv,
                      conv_kwargs=kw, edge_dim=DE), jdata,
        optimizer_args=opt)
    js = jt.init_state(jax.random.PRNGKey(0))
    pt = fb.FullBatchTrainer(
        GNNEncoder(din, HID, 4, num_layers=2, conv=conv, conv_kwargs=kw,
                   edge_dim=DE), pdata, optimizer_args=opt, device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    want, got = [], []
    for _ in range(20):
        js, loss = jt._train_step(jt.data, js, jax.random.PRNGKey(1))
        want.append(float(loss))
        ps, loss = pt.train_step(ps)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[-1] < want[0]
    assert pt.accuracy("val") == jt.accuracy(js.params, "val")


def test_init_params_covers_the_edge_layers():
    """init_params draws edge_in_proj, lin_edge, GINE's MLP and the
    scorer as flax's Dense does (lecun-normal weights, zero biases) and
    zeros GINE's eps; the state dict keys are the converter's."""
    from gigl_tpu_torch.models.init import init_params
    from gigl_tpu_torch.models.link_prediction import (
        EdgeFeatureScorer,
        LinkPredictionDecoder,
        LinkPredictionGNN,
    )

    for conv, kw in (("gine", {}), ("edge_attr_gat", {"heads": HEADS}),
                     ("transformer", {"heads": HEADS,
                                      "use_edge_attr": True})):
        model = LinkPredictionGNN(
            GNNEncoder(HID, HID, OUT, conv=conv, conv_kwargs=kw,
                       edge_dim=DE), LinkPredictionDecoder(),
            EdgeFeatureScorer(DE, 32))
        init_params(model, 3)
        names = dict(model.named_parameters())
        assert "encoder.edge_in_proj.weight" in names
        assert "edge_scorer.e0.weight" in names
        assert any(".lin_edge." in n for n in names) == (conv != "gine")
        for name, p in names.items():
            if name.endswith("bias") or name.endswith("eps"):
                assert not p.any(), name
            elif name.endswith("weight"):
                std = float(p.std())
                fan_in = p.shape[1]
                assert 0.5 < std * fan_in ** 0.5 < 1.5, (name, std)
