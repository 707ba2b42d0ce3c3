"""Parity of the port's exact full-graph path (gigl_tpu_torch.ops.ell,
GNNEncoder.encode_ell, run_full_graph_inference) with the JAX reference.

The graph: 200 nodes, ~1,500 random directed edges, three isolated nodes
(no in- or out-edges) and one hub of in-degree 40, so the ELL tables have
buckets of widths 4 to 64 and all-masked rows in bucket 0. Params come
from JAX through params_from_flax.

- Every EllGraph table and static tuple: bit-equal.
- fp32 encodes: the same sums in another order, within 1e-4 of the
  output's largest entry.
- bf16 encodes (graphsage, gat): the reference rounds every intermediate
  to bf16 (each Dense output, its bf16 masked reductions), where the port's
  GEMMs and kernels accumulate in fp32 and round once; a few bf16 ulps
  (2**-8 relative) through two layers: within 2e-2 of the largest entry.
- The backward: K6b's twin (``ell_transpose_aggregate``) and
  ``ell_aggregate_graph``'s gradient against ``jax.vjp`` of the reference's
  ``ell_gather`` + masked reduce (its scatter-free custom VJP), mean / sum /
  gcn / max (ties shared), fp32 within 1e-5 of the scale; the weighted mode against a plain
  ``index_add_`` of the weighted entry rows; the permute-gathers of
  ``encode_ell`` (ROADMAP C3) against ``jax.vjp`` of ``x[perm]``.
- K6's plain twin over the whole graph (one call, the flat entry tables
  walked up to each row's count ``deg_p``) against the per-bucket twin
  (the bucket's ``nbr`` / ``mask``): bit-equal, every mode, fp32 and bf16,
  with an empty bucket, degree-0 rows and a width-8192 hub bucket; and
  against the reference's ``ell_layer`` with each conv's reduce as its
  block (masked mean / sum / max, GCN's degree weights, GINE's relu of the
  row plus its edge row): fp32 within 1e-6 of the output's scale, bf16
  within one bf16 rounding of the reference computed in fp32 on the same
  bf16 inputs (2**-8 of each value, plus 1e-6 of the scale). Every bucket
  mask ``from_csr`` builds is the left-packed prefix of its rows'
  in-degrees, and a table whose mask is not one is refused.
- The attention layers (GAT, GATv2, Transformer) at 4 heads of 4 values,
  the full-batch GAT step's layer-2 split: the output and every gradient
  against ``jax.vjp`` of the reference's ``encode_ell``, fp32 within 1e-5
  of each output's scale.
"""

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
from gigl_tpu.models.encoders import GNNEncoder as RefGNNEncoder
from gigl_tpu.ops import ell as ref_ell
from gigl_tpu.ops import fanout as ref_fanout
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph, build_csr
from gigl_tpu_torch.inference.inferencer import run_full_graph_inference
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.ops import ell
from gigl_tpu_torch.ops.ell_aggregate import (
    _ell_aggregate_fwd,
    _ell_aggregate_graph_plain,
    _ell_aggregate_plain,
    _tie_count_plain,
    ell_aggregate_graph,
    ell_transpose_aggregate,
)
from gigl_tpu_torch.ops.gather import permute_rows

torch.set_num_threads(1)

N, DIN, HID, OUT, HEADS = 200, 12, 16, 8, 2
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
    x = rng.normal(size=(N, DIN)).astype(np.float32)
    return src, dst, x


def _conv_kwargs(conv):
    return {"heads": HEADS} if conv in ("gat", "gatv2", "transformer") else {}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("widths", [None, (4, 8, 16, 64), (4, 64)])
def test_ell_tables_bit_equal(widths):
    src, dst, _ = _graph()
    ref = ref_ell.EllGraph.from_csr(
        ref_build_csr(src, dst, num_anchor_nodes=N, num_neighbor_nodes=N),
        widths=widths)
    got = ell.EllGraph.from_csr(
        build_csr(src, dst, num_anchor_nodes=N, num_neighbor_nodes=N),
        widths=widths, device="cpu")
    assert got.boundaries == ref.boundaries and got.widths == ref.widths
    assert got.t_boundaries == ref.t_boundaries
    assert got.t_widths == ref.t_widths
    for name in ("perm", "rank", "deg_p", "t_rank", "edge_pos"):
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.device.type == "cpu" and str(g.dtype)[6:] == str(r.dtype)
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    for name in ("nbr", "mask", "edge_slots", "t_nbr", "t_mask"):
        gs, rs = getattr(got, name), getattr(ref, name)
        assert len(gs) == len(rs)
        for g, r in zip(gs, rs):
            r = np.asarray(r)
            assert str(g.dtype)[6:] == str(r.dtype)
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    if widths is None:
        assert got.widths == (4, 8, 16, 32, 64)
        # isolated nodes are all-masked rows of bucket 0
        rows = got.rank[list(ISOLATED)].numpy()
        assert (rows < got.boundaries[1]).all()
        assert not got.mask[0][rows].any()


@pytest.mark.parametrize("widths", [None, (4, 8, 16, 64), (4, 64)])
def test_ell_t_row_is_ent_row_composed_in_walk_order(widths):
    """t_row, the table K6b walks: per transpose bucket, the destination
    row of each slot's flat entry (``ent_row[t_nbr]``, from the
    reference's own tables) where ``t_mask`` holds and -1 elsewhere; every
    source's valid slots name exactly the destinations of its out-edges,
    in permuted space."""
    src, dst, _ = _graph()
    ref = ref_ell.EllGraph.from_csr(
        ref_build_csr(src, dst, num_anchor_nodes=N, num_neighbor_nodes=N),
        widths=widths)
    got = ell.EllGraph.from_csr(
        build_csr(src, dst, num_anchor_nodes=N, num_neighbor_nodes=N),
        widths=widths, device="cpu")
    bounds = np.asarray(ref.boundaries)
    ent_row = np.repeat(np.arange(N), np.repeat(np.asarray(ref.widths),
                                                np.diff(bounds)))
    np.testing.assert_array_equal(got.ent_row.numpy(), ent_row)
    assert len(got.t_row) == len(ref.t_nbr)
    for t_row, t_nbr, t_mask in zip(got.t_row, ref.t_nbr, ref.t_mask):
        t_nbr, t_mask = np.asarray(t_nbr), np.asarray(t_mask)
        assert t_row.dtype == torch.int32 and t_row.shape == t_nbr.shape
        np.testing.assert_array_equal(
            t_row.numpy(), np.where(t_mask, ent_row[t_nbr], -1))
    rank, t_bounds = np.asarray(ref.rank), np.asarray(ref.t_boundaries)
    t_perm = got.t_perm.numpy()
    for i in range(N):
        b = int(np.searchsorted(t_bounds, i, side="right")) - 1
        slots = got.t_row[b][i - t_bounds[b]].numpy()
        want = rank[dst[rank[src] == t_perm[i]]]
        np.testing.assert_array_equal(np.sort(slots[slots >= 0]),
                                      np.sort(want))


@pytest.mark.parametrize("deg,want", [
    (0, (4,)), (1, (4,)), (4, (4,)), (5, (4, 8)), (47, (4, 8, 16, 32, 64)),
    (5000, (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192))])
def test_default_widths(deg, want):
    assert ell.default_widths(deg) == want == ref_ell.default_widths(deg)


def test_from_csr_rejects_what_the_reference_rejects():
    src, dst, _ = _graph()
    csr = build_csr(src, dst, num_anchor_nodes=N)
    with pytest.raises(ValueError, match="max degree"):
        ell.EllGraph.from_csr(csr, widths=(4, 8), device="cpu")
    with pytest.raises(ValueError, match="ascending"):
        ell.EllGraph.from_csr(csr, widths=(64, 4), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ell.EllGraph.from_csr(csr)


def _k6_case(kind, seed=0):
    """(src, dst, n, widths) of a K6 test graph: ``module`` (_graph:
    buckets 4 to 64, isolated rows), ``empty_bucket`` (the same with a
    width-32 bucket that holds no row, degree-0 rows in bucket 0) or
    ``hub8192`` (60 nodes, one of in-degree 5,000)."""
    if kind == "hub8192":
        rng = np.random.default_rng(seed)
        src = np.concatenate([rng.integers(0, 60, 300),
                              rng.integers(0, 60, 5000)])
        dst = np.concatenate([rng.integers(0, 60, 300), np.full(5000, 9)])
        return src, dst, 60, None
    src, dst, _ = _graph(seed)
    return src, dst, N, (4, 8, 16, 32, 64) if kind == "module" else \
        (4, 8, 16, 24, 32, 64, 128)


@pytest.mark.parametrize("kind", ["module", "empty_bucket", "hub8192"])
@pytest.mark.parametrize("seed", [0, 1])
def test_from_csr_masks_are_left_packed_prefixes(kind, seed):
    src, dst, n, widths = _k6_case(kind, seed)
    g = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=n),
                              widths=widths, device="cpu")
    for b, mk in enumerate(g.mask):
        deg = g.deg_p[g.boundaries[b]:g.boundaries[b + 1]]
        assert torch.equal(mk, torch.arange(mk.shape[1])[None, :]
                           < deg[:, None])
    assert int(g.deg_p.sum()) == len(src)


def test_prefix_check_refuses_a_mask_that_is_not_a_prefix():
    """A hand-made table: a valid slot after a masked one, then row sums
    that are not the in-degrees."""
    mask = np.array([[True, True, False, False],
                     [True, False, True, False]])
    deg = np.array([2.0, 2.0], np.float32)
    with pytest.raises(ValueError, match="left-packed prefix"):
        ell._check_prefix_masks([mask], deg, (0, 2))
    mask[1] = (True, True, False, False)
    ell._check_prefix_masks([mask], deg, (0, 2))         # now a prefix
    with pytest.raises(ValueError, match="left-packed prefix"):
        ell._check_prefix_masks([mask], np.array([2.0, 3.0]), (0, 2))


class _RefReduce:
    """A conv for the reference's ``ell_layer`` whose block is one conv's
    reduce alone (convs.py: SAGE's masked mean / sum / max, GCNConv.block's
    degree weights, GINEConv.block's relu of row plus edge row)."""

    def __init__(self, op):
        self.op = op

    def block(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        if self.op == "gcn":
            dst_deg, nbr_deg = degrees
            w = jax.lax.rsqrt(dst_deg + 1.0)[:, None] * jax.lax.rsqrt(
                nbr_deg + 1.0)
            return ref_fanout.masked_sum(nbr * w[..., None], mask)
        if self.op == "gine":
            nbr = jax.nn.relu(nbr if edge_attr is None else nbr + edge_attr)
            return ref_fanout.masked_sum(nbr, mask)
        return getattr(ref_fanout, f"masked_{self.op}")(nbr, mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["mean", "sum", "max", "gcn", "gine",
                                "gine_edges"])
@pytest.mark.parametrize("kind", ["module", "empty_bucket", "hub8192"])
def test_k6_graph_twin_matches_per_bucket_twin_and_jax(dtype, op, kind):
    src, dst, n, widths = _k6_case(kind)
    g = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=n),
                              widths=widths, device="cpu")
    if kind == "empty_bucket":
        assert any(hi == lo for lo, hi in zip(g.boundaries,
                                              g.boundaries[1:]))
    rng = np.random.default_rng(3)
    tdt = DTYPES[dtype][1]
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)).to(tdt)
    ea = torch.from_numpy(rng.normal(size=(len(src), 8)).astype(
        np.float32)).to(tdt) if op == "gine_edges" else None
    mode = "gine" if op == "gine_edges" else op
    got = _ell_aggregate_fwd(x, g, mode, ea=ea)
    assert torch.equal(got, _ell_aggregate_graph_plain(x, g, mode, ea))
    parts = []
    for b in range(len(g.widths)):
        lo, hi = g.boundaries[b], g.boundaries[b + 1]
        if hi > lo:
            parts.append(_ell_aggregate_plain(
                x, g.nbr[b], g.mask[b], mode, g.deg_p[lo:hi], g.deg_p, ea,
                None if ea is None else g.edge_slots[b]))
    assert torch.equal(got, torch.cat(parts))
    lo, hi = g.boundaries[1] // 2, n - 3
    assert torch.equal(_ell_aggregate_fwd(x, g, mode, ea=ea, rows=(lo, hi)),
                       got[lo:hi])
    assert not got[g.deg_p == 0].any()
    jg = ref_ell.EllGraph.from_csr(
        ref_build_csr(src, dst, num_anchor_nodes=n, num_neighbor_nodes=n),
        widths=widths)
    want = np.asarray(jax.jit(
        lambda x_, e_: ref_ell.ell_layer(_RefReduce(mode), x_, jg, e_,
                                         with_degrees=mode == "gcn"))(
        jnp.asarray(x.float().numpy()),
        None if ea is None else jnp.asarray(ea.float().numpy())))
    got = got.float().numpy()
    scale = np.abs(want).max()
    tol = 1e-6 * scale + (0 if dtype == "float32" else 2.0 ** -8 * np.abs(
        want))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


CASES = [("graphsage", {"aggr": "mean"}, "float32"),
         ("graphsage", {"aggr": "sum"}, "float32"),
         ("graphsage", {"aggr": "max"}, "float32"),
         ("gcn", {}, "float32"), ("gin", {}, "float32"),
         ("gat", {}, "float32"), ("gatv2", {}, "float32"),
         ("transformer", {}, "float32"),
         ("graphsage", {"aggr": "mean"}, "bfloat16"),
         ("gat", {}, "bfloat16")]


def _encoders(conv, kw, dtype, l2=False, seed=0):
    jdt, tdt = DTYPES[dtype]
    kw = {**kw, **_conv_kwargs(conv)}
    src, dst, x = _graph()
    jell = ref_ell.EllGraph.from_csr(ref_build_csr(src, dst,
                                                   num_anchor_nodes=N))
    jenc = RefGNNEncoder(hid_dim=HID, out_dim=OUT, num_layers=2, conv=conv,
                         conv_kwargs=kw, l2_normalize_output=l2, dtype=jdt)
    # jit (here and below): one compile instead of an eager one per op
    params = jax.jit(lambda k, x_, e: jenc.init(k, x_, e, method="encode_ell")
                     )(jax.random.PRNGKey(seed), jnp.asarray(x), jell)
    enc = GNNEncoder(DIN, HID, OUT, num_layers=2, conv=conv, conv_kwargs=kw,
                     l2_normalize_output=l2, dtype=tdt)
    enc.load_state_dict(params_from_flax(_np(params)))
    return jenc, params, enc, (src, dst, x, jell)


@pytest.mark.parametrize("conv,kw,dtype", CASES)
def test_encode_ell_matches_jax(conv, kw, dtype):
    jenc, params, enc, (src, dst, x, jell) = _encoders(conv, kw, dtype)
    want = jax.jit(lambda p, x_, e: jenc.apply(p, x_, e, method="encode_ell")
                   )(params, jnp.asarray(x), jell)
    tell = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N),
                                 device="cpu")
    with torch.inference_mode():
        got = enc.encode_ell(torch.from_numpy(x), tell)
    assert got.shape == (N, OUT) and got.dtype == DTYPES[dtype][1]
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("conv,dtype,l2", [
    ("graphsage", "float32", True), ("gat", "bfloat16", False),
    ("gcn", "float32", False)])
def test_run_full_graph_inference_matches_jax(conv, dtype, l2):
    jenc, params, enc, (src, dst, x, _) = _encoders(conv, {}, dtype, l2=l2,
                                                    seed=1)

    class Sink:
        def __init__(self):
            self.ids, self.embs, self.flushed = [], [], False

        def add_embeddings(self, ids, emb):
            self.ids.append(np.asarray(ids))
            self.embs.append(np.asarray(emb, np.float32))

        def flush(self):
            self.flushed = True

    ref_sink, sink = Sink(), Sink()
    n_ref = ref_run_full_graph_inference(
        jenc, params, RefHeteroGraph.homogeneous(src, dst, num_nodes=N,
                                                 node_features=x),
        ref_sink, export_batch=64)
    n = run_full_graph_inference(
        enc, params_from_flax(_np(params)),
        HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x),
        sink, export_batch=64, device="cpu")
    assert n == n_ref == N and sink.flushed
    assert len(sink.ids) == len(ref_sink.ids) == 4
    ids = np.concatenate(sink.ids)
    np.testing.assert_array_equal(ids, np.concatenate(ref_sink.ids))
    np.testing.assert_array_equal(np.sort(ids), np.arange(N))
    _close(np.concatenate(sink.embs), np.concatenate(ref_sink.embs), dtype)


def test_run_full_graph_inference_guards():
    src, dst, _ = _graph()
    g = HeteroGraph.homogeneous(src, dst, num_nodes=N)
    enc = GNNEncoder(1, HID, OUT)
    with pytest.raises(ValueError, match="no feature table"):
        run_full_graph_inference(enc, None, g, None, device="cpu")
    out = []

    class Sink:
        def add_embeddings(self, ids, emb):
            out.append(emb)

        def flush(self):
            pass

    assert run_full_graph_inference(enc, None, g, Sink(), device="cpu",
                                    allow_zero_features=True) == N
    assert np.concatenate(out).shape == (N, OUT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_full_graph_inference(enc, None, g, Sink(),
                                     allow_zero_features=True)


def test_edge_features_raise():
    """Edge features run on the ELL path (tests/test_torch_edge_features.py)
    and the COO path (tests/test_torch_coo_edges.py); the convs without
    edge features ignore them on both, as the reference's do. What still
    raises: a table of the wrong length, an edge conv built without
    ``edge_dim`` given edge rows. GATv2 with edge rows (ROADMAP B6b), which
    raised here until the ELL path had its gate's edge row, now runs and
    matches the reference's encode_ell (1e-4 of the output's scale, as
    every two-layer encode_ell here)."""
    src, dst, x = _graph()
    tell = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N),
                                 device="cpu")
    enc = GNNEncoder(DIN, HID, OUT)
    ea = torch.zeros((len(src), 4))
    with torch.inference_mode():
        np.testing.assert_array_equal(
            enc.encode_ell(torch.from_numpy(x), tell, ea).numpy(),
            enc.encode_ell(torch.from_numpy(x), tell).numpy())
    with pytest.raises(ValueError, match="rows for"):
        ell.ell_layer(enc.convs[0], torch.from_numpy(x), tell, ea[1:])
    for conv in ("gine", "edge_attr_gat"):
        assert len(GNNEncoder(DIN, HID, OUT, conv=conv).convs) == 2
    with pytest.raises(ValueError, match="without edge_dim"):
        GNNEncoder(DIN, HID, OUT, conv="edge_attr_gat").encode_ell(
            torch.from_numpy(x), tell, ea)
    v2 = GNNEncoder(DIN, HID, OUT, conv="gatv2", edge_dim=4,
                    conv_kwargs={"use_edge_attr": True})
    jv2 = RefGNNEncoder(hid_dim=HID, out_dim=OUT, num_layers=2, conv="gatv2",
                        conv_kwargs={"use_edge_attr": True}, edge_dim=4)
    jell = ref_ell.EllGraph.from_csr(ref_build_csr(
        src, dst, num_anchor_nodes=N, num_neighbor_nodes=N))
    eav = np.random.default_rng(4).normal(size=(len(src), 4)).astype(
        np.float32)
    params = jax.jit(lambda k, x_, e, a: jv2.init(
        k, x_, e, a, method="encode_ell"))(
            jax.random.PRNGKey(0), jnp.asarray(x), jell, jnp.asarray(eav))
    v2.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    want = np.asarray(jax.jit(lambda p, x_, e, a: jv2.apply(
        p, x_, e, a, method="encode_ell"))(params, jnp.asarray(x), jell,
                                           jnp.asarray(eav)))
    with torch.inference_mode():
        got = v2.encode_ell(torch.from_numpy(x), tell,
                            torch.from_numpy(eav)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    ts, td = (torch.as_tensor(a.astype(np.int32)) for a in (src, dst))
    with torch.inference_mode():   # the COO path ignores them as ELL does
        got = enc.encode_coo(torch.from_numpy(x), ts, td, N, ea)
        want = enc.encode_ell(torch.from_numpy(x), tell).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _ref_layer_agg(jell, op):
    """The reference's ell_gather + the conv's masked reduce, per bucket,
    concatenated: x_p [N, D] -> [N, D] (GCN: GCNConv.block's weights from
    the in-degrees, as ell_layer passes them)."""
    from gigl_tpu.ops import fanout as ref_fanout

    def f(x_p):
        feats = ref_ell.ell_gather(x_p, jell.nbr, jell.mask, jell.t_nbr,
                                   jell.t_mask, jell.t_rank)
        outs = []
        for b in range(len(jell.widths)):
            lo, hi = jell.boundaries[b], jell.boundaries[b + 1]
            if hi == lo:
                continue
            fb, mb = feats[b], jell.mask[b]
            if op == "gcn":
                w = (jax.lax.rsqrt(jell.deg_p[lo:hi] + 1.0)[:, None]
                     * jax.lax.rsqrt(jell.deg_p[jell.nbr[b]] + 1.0))
                outs.append(ref_fanout.masked_sum(fb * w[..., None], mb))
            else:
                outs.append(getattr(ref_fanout, f"masked_{op}")(fb, mb))
        return jnp.concatenate(outs, axis=0)
    return f


@pytest.mark.parametrize("op", ["mean", "sum", "gcn", "max"])
def test_ell_transpose_backward_matches_jax_vjp(op):
    src, dst, _ = _graph()
    jell = ref_ell.EllGraph.from_csr(ref_build_csr(src, dst,
                                                   num_anchor_nodes=N))
    tell = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N),
                                 device="cpu")
    assert len(tell.t_widths) >= 3 and tell.ent_row.shape[0] == \
        tell.ent_off[-1] == sum(int(m.numel()) for m in tell.mask)
    rng = np.random.default_rng(11)
    x_p = rng.normal(size=(N, 24)).astype(np.float32)
    if op == "max":      # a coarse grid: the max has ties to share among
        x_p = np.round(x_p * 2).astype(np.float32)
    g = rng.normal(size=(N, 24)).astype(np.float32)
    want_out, vjp = jax.vjp(jax.jit(_ref_layer_agg(jell, op)),
                            jnp.asarray(x_p))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    fwd = {}
    if op == "max":
        fwd = {"rows2": torch.from_numpy(np.array(want_out)),
               "table": torch.from_numpy(x_p)}
        assert int(_tie_count_plain(fwd["table"], tell,
                                    fwd["rows2"]).max()) > 1
    got = ell_transpose_aggregate(torch.from_numpy(g), tell, op, **fwd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # sources without out-edges (isolated nodes) get exactly 0
    assert not got[tell.rank[list(ISOLATED)].long()].any()
    xt = torch.from_numpy(x_p).requires_grad_()
    out = ell_aggregate_graph(xt, tell, op)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=1e-5 * np.abs(want_out).max())
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), got.numpy())


@pytest.mark.parametrize("op", ["weighted", "gatv2"])
def test_ell_transpose_weighted_matches_scatter(op):
    """The attention modes of the transpose walk: sum over the entries that
    read each row v of wt[p, h] * rows[dst(p)] + vec * wt2[p, h] (GATv2:
    times leaky'(table[v] + rows2[dst(p)]), slope 0.2)."""
    src, dst, _ = _graph()
    tell = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N),
                                 device="cpu")
    heads, dh = 3, 4
    p = tell.ent_row.shape[0]
    g = torch.Generator().manual_seed(0)
    rows, rows2, table = (torch.randn((N, heads * dh), generator=g)
                          for _ in range(3))
    wt, wt2 = (torch.randn((p, heads), generator=g) for _ in range(2))
    vec = torch.randn(heads * dh, generator=g)
    got = ell_transpose_aggregate(rows, tell, op, wt, wt2, vec, heads,
                                  rows2=rows2, table=table)
    nbr = torch.cat([nb.reshape(-1) for nb in tell.nbr]).long()
    valid = torch.cat([m.reshape(-1) for m in tell.mask])
    r = tell.ent_row.long()
    gate = torch.ones((p, heads * dh))
    if op == "gatv2":
        gate = torch.where(table[nbr] + rows2[r] >= 0, 1.0, 0.2)
    msg = (rows[r].reshape(p, heads, dh) * wt[..., None]
           + (vec * gate).reshape(p, heads, dh) * wt2[..., None]
           ).reshape(p, -1)
    want = torch.zeros_like(rows).index_add_(0, nbr[valid], msg[valid])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("conv", ["gat", "gatv2", "transformer"])
def test_encode_ell_attention_heads_4x4_match_jax_vjp(conv):
    """The attention convs' ELL layers at 4 heads of 4 values (the split of
    the full-batch GAT step's layer 2: 16 classes over 4 heads, the narrow
    heads the attention kernels' lane map packs 8 slots a warp for), both
    layers, fp32: the forward through the plain twins and every gradient
    of a seeded cotangent (the input's and each parameter's) against
    ``jax.vjp`` of the reference's ``encode_ell``, within 1e-5 of each
    output's scale (fp32 sums in another order; parameters whose gradient
    is zero by symmetry, the Transformer's key bias, are held to a floor
    of 1e-2 of the largest gradient)."""
    kw = {"heads": 4}
    src, dst, x = _graph()
    jell = ref_ell.EllGraph.from_csr(ref_build_csr(src, dst,
                                                   num_anchor_nodes=N))
    jenc = RefGNNEncoder(hid_dim=16, out_dim=16, num_layers=2, conv=conv,
                         conv_kwargs=kw)
    params = jax.jit(lambda k, x_, e: jenc.init(k, x_, e, method="encode_ell")
                     )(jax.random.PRNGKey(3), jnp.asarray(x), jell)
    enc = GNNEncoder(DIN, 16, 16, num_layers=2, conv=conv, conv_kwargs=kw)
    enc.load_state_dict(params_from_flax(_np(params)))
    assert all(c.heads == 4 and c.head_dim == 4
               for c in enc.convs), "both layers at 4 heads x 4 values"
    want, vjp = jax.vjp(jax.jit(lambda p, x_: jenc.apply(
        p, x_, jell, method="encode_ell")), params, jnp.asarray(x))
    g = np.random.default_rng(13).normal(size=(N, 16)).astype(np.float32)
    want_p, want_x = vjp(jnp.asarray(g))
    tell = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N),
                                 device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    got = enc.encode_ell(xt, tell)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5 * np.abs(want).max())
    got.backward(torch.from_numpy(g))
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(xt.grad.numpy(), want_x, rtol=0,
                               atol=1e-5 * np.abs(want_x).max())
    wp = params_from_flax(_np(want_p))
    assert {n for n, _ in enc.named_parameters()} == set(wp)
    floor = 1e-2 * max(float(w.abs().max()) for w in wp.values())
    for name, p in enc.named_parameters():
        w = wp[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=0,
            atol=1e-5 * max(float(np.abs(w).max()), floor), err_msg=name)


def test_encode_ell_permute_gathers_are_differentiable():
    """ROADMAP C3: the permute-gathers in and out of encode_ell carry the
    gradient (K3 through the inverse permutation) on the CPU twin as the
    kernel does on the card."""
    src, dst, x = _graph()
    tell = ell.EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N),
                                 device="cpu")
    jell = ref_ell.EllGraph.from_csr(ref_build_csr(src, dst,
                                                   num_anchor_nodes=N))
    g = np.random.default_rng(12).normal(size=(N, DIN)).astype(np.float32)
    for idx, inv, jidx in ((tell.perm, tell.rank, jell.perm),
                           (tell.rank, tell.perm, jell.rank)):
        xt = torch.from_numpy(x).requires_grad_()
        y = permute_rows(xt, idx, inv)
        assert y.grad_fn is not None
        y.backward(torch.from_numpy(g))
        _, vjp = jax.vjp(lambda a: a[jidx], jnp.asarray(x))
        np.testing.assert_array_equal(xt.grad.numpy(),
                                      np.asarray(vjp(jnp.asarray(g))[0]))
    enc = GNNEncoder(DIN, HID, OUT)
    out = enc.encode_ell(torch.from_numpy(x), tell)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for p in enc.parameters())
