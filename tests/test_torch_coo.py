"""The port's homogeneous COO path (each conv's ``coo`` form,
``GNNEncoder.encode_coo`` and ``FullBatchTrainer(build_ell=False)``,
gigl_tpu_torch) against the JAX reference, on the CPU where every segment
kernel (K8-K10 and their backward K8b-K10b) runs its plain twin inside the
port's ``autograd.Function``s.

The graph: 160 nodes, ~900 random directed edges, two isolated nodes, four
more without out-edges, a hub of in-degree 30 and one of out-degree 50, so
in- and out-degrees differ (GCN's ``coo`` normalises sources by their
out-degree, ROADMAP C2). 12 fp32 features, 6 labels, 2 layers, hidden 16
(attention: 2 heads of 8, then 2 heads of 3).

Tolerances: fp32, the same sums in another order. One step: the loss within
1e-5 relative; every parameter's gradient and the input features'
gradient within 1e-5 of its largest entry (a gradient that is zero by
symmetry, the Transformer's key bias, against 1e-2 of the model's largest
gradient). The forward within 1e-5 of the output's scale. 20 steps of Adam
(lr 0.01, dropout 0): the losses within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as RefHeteroGraph
from gigl_tpu.losses.losses import cross_entropy_loss as ref_ce
from gigl_tpu.models.encoders import GNNEncoder as RefGNNEncoder
from gigl_tpu.training import full_batch as ref_fb
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.ops import segment as seg
from gigl_tpu_torch.ops.segment import SegmentIndex
from gigl_tpu_torch.training import full_batch as fb

torch.set_num_threads(1)

N, DIN, HID, C, HEADS = 160, 12, 16, 6, 2
ISOLATED = (3, 77)
SINKS = (10, 11, 12, 13)              # in-edges only
IN_HUB, OUT_HUB = 5, 9
OPT = {"learning_rate": "0.01"}
CONVS = ["graphsage", "graphsage_sum", "graphsage_max", "gcn", "gin", "gine",
         "gat", "transformer"]


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 850)
    dst = rng.integers(0, N, 850)
    keep = ~(np.isin(src, ISOLATED + SINKS) | np.isin(dst, ISOLATED)
             | (dst == IN_HUB))
    others = [v for v in range(N) if v not in ISOLATED + SINKS]
    hub_in = rng.choice(others, 30, replace=False)
    hub_out = rng.choice([v for v in range(N) if v not in ISOLATED], 50,
                         replace=False)
    src = np.concatenate([src[keep], hub_in, np.full(50, OUT_HUB)])
    dst = np.concatenate([dst[keep], np.full(30, IN_HUB), hub_out])
    x = rng.normal(size=(N, DIN)).astype(np.float32)
    labels = rng.integers(0, C, N)
    return src, dst, x, labels


def _kw(conv):
    if conv in ("gat", "gatv2", "transformer"):
        return {"heads": HEADS}
    if conv.startswith("graphsage_"):
        return {"aggr": conv.split("_")[1]}
    return {}


def _name(conv):
    return "graphsage" if conv.startswith("graphsage") else conv


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(conv, cfg=None, num_layers=2, out=C, conv_kwargs=None):
    """A JAX and a port FullBatchTrainer over the COO edges, same params."""
    src, dst, x, labels = _arrays()
    kw = _kw(conv) if conv_kwargs is None else conv_kwargs
    jdata = ref_fb.full_batch_data_from_graph(
        RefHeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x,
                                   node_labels=labels), build_ell=False)
    pdata = fb.full_batch_data_from_graph(
        HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x,
                                node_labels=labels),
        build_ell=False, device="cpu")
    jenc = RefGNNEncoder(hid_dim=HID, out_dim=out, num_layers=num_layers,
                         conv=_name(conv), conv_kwargs=kw)
    jt = ref_fb.FullBatchTrainer(jenc, jdata, cfg, optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0))
    enc = GNNEncoder(DIN, HID, out, num_layers=num_layers, conv=_name(conv),
                     conv_kwargs=kw)
    pt = fb.FullBatchTrainer(enc, pdata, cfg, optimizer_args=OPT,
                             device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    return jt, js, pt, ps


def _close(got, want, tol, scale=None):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_full_batch_data_carries_both_indexes():
    _, pt, _ = _pair("graphsage")[1:]
    d = pt.data
    assert d.ell is None
    src, dst = d.src.numpy(), d.dst.numpy()
    for idx, ids in ((d.index, dst), (d.src_index, src)):
        assert idx.num_segments == N and idx.num_edges == len(ids)
        np.testing.assert_array_equal(idx.order.numpy(),
                                      np.argsort(ids, kind="stable"))
    deg_out = np.diff(d.src_index.ptr.numpy())
    assert deg_out[OUT_HUB] >= 50 and deg_out[list(SINKS)].sum() == 0
    assert np.diff(d.index.ptr.numpy())[IN_HUB] == 30


def test_graphsage_layer_coo_over_the_composed_index_matches_jax(
        monkeypatch):
    """One GraphSAGE layer end to end over full_batch_data_from_graph's
    indexes: the destination index holds the data's own src tensor and
    src[order] (K8's composed mode: every gathering K8 call is given that
    very tensor), and the source index the data's own dst tensor and
    dst[order] (K8b's); the logits, the loss, every parameter's and the
    input's gradient against the reference's."""
    jt, js, pt, _ = _pair("graphsage", num_layers=1)
    d = pt.data
    assert d.index.gather is d.src
    np.testing.assert_array_equal(
        d.index.gathered.numpy(), d.src.numpy()[d.index.order.numpy()])
    assert d.src_index.gather is d.dst
    np.testing.assert_array_equal(
        d.src_index.gathered.numpy(),
        d.dst.numpy()[d.src_index.order.numpy()])
    modes = []
    fwd = seg._segment_reduce_fwd

    def spy(x, ids, n, op="sum", src=None, weight=None, index=None):
        modes.append(seg.gather_mode(src, index))
        return fwd(x, ids, n, op, src, weight, index)

    monkeypatch.setattr(seg, "_segment_reduce_fwd", spy)
    _forward_and_gradients_match(jt, js, pt)
    assert modes and set(modes) == {"composed"}, modes


def _k8b_modes(monkeypatch):
    """Record gather_mode of every K8b call's segment ids over its source
    index (K8b reads the index's composed destinations for the ids it was
    built from)."""
    modes = []
    bwd = seg.segment_reduce_bwd

    def spy(g, ids, num_rows, **kw):
        if kw.get("src") is not None:
            modes.append(seg.gather_mode(ids, kw["src_index"]))
        return bwd(g, ids, num_rows, **kw)

    monkeypatch.setattr(seg, "segment_reduce_bwd", spy)
    return modes


@pytest.mark.parametrize("conv", ["graphsage", "gcn", "gat", "transformer"])
def test_coo_step_reads_the_composed_source_index(conv, monkeypatch):
    """A full-batch COO step over full_batch_data_from_graph's indexes:
    every K8b launch over the source walk (layer 2's aggregate, the
    attention convs' dk and the gathered attention terms) is given the
    data's own dst, the ids its source index was built from (the composed
    mode); the loss and every gradient still match the reference's."""
    jt, js, pt, _ = _pair(conv)
    modes = _k8b_modes(monkeypatch)
    _forward_and_gradients_match(jt, js, pt)
    assert modes and set(modes) == {"composed"}, modes


def test_encode_coo_without_indexes_builds_composed_ones(monkeypatch):
    """encode_coo given no indexes builds both on the host, each with the
    other side's ids: K8 and K8b run their composed modes, and the
    gradients equal those over full_batch_data_from_graph's indexes."""
    _, _, pt, _ = _pair("gat")
    d = pt.data
    modes = _k8b_modes(monkeypatch)
    grads = []
    for kw in ({}, {"index": d.index, "src_index": d.src_index}):
        x = d.x.clone().requires_grad_()
        pt.encoder.zero_grad()
        pt.encoder.encode_coo(x, d.src, d.dst, N, **kw).square().sum(
        ).backward()
        grads.append(x.grad)
    assert modes and set(modes) == {"composed"}, modes
    assert torch.equal(*grads)


@pytest.mark.parametrize("conv", CONVS)
def test_conv_coo_forward_and_gradients_match_jax(conv):
    """encode_coo's logits, then one step's loss and the gradients of every
    parameter and of the input features against jax.value_and_grad: layer
    2's backward runs K8b (and K9b, K10, K10b for the attention convs),
    and the input gradient runs layer 1's too."""
    _forward_and_gradients_match(*_pair(conv)[:3])


def _forward_and_gradients_match(jt, js, pt):
    """encode_coo's logits and one step's loss, parameter gradients and
    input gradient, the port (given both indexes) against the reference."""
    data = jt.data
    want_logits = jax.jit(lambda p: jt._forward(data, p, False))(js.params)
    _close(pt.logits(), want_logits, 1e-5)

    def loss_fn(p, x):
        logits = jt.encoder.apply(p, x, data.src, data.dst, N,
                                  method="encode_coo")
        s, c = ref_ce(logits, data.labels, mask=data.train_mask)
        return s / jnp.maximum(c.astype(jnp.float32), 1.0)

    jloss, (jgrad, jgx) = jax.jit(jax.value_and_grad(loss_fn, (0, 1)))(
        js.params, data.x)
    want = params_from_flax(_np(jgrad))
    d = pt.data
    x = d.x.clone().requires_grad_()
    logits = pt.encoder.encode_coo(x, d.src, d.dst, N, index=d.index,
                                   src_index=d.src_index)
    s, c = fb.cross_entropy_loss(logits, d.labels, mask=d.train_mask)
    loss = s / torch.clamp(c.float(), min=1.0)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    names = {n for n, _ in pt.encoder.named_parameters()}
    assert names == set(want)
    for name, p in pt.encoder.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None, name
        _close(p.grad, w, 1e-5, max(np.abs(w).max(), floor))
    _close(x.grad, jgx, 1e-5)


@pytest.mark.parametrize("heads,out", [(4, 16), (4, 256), (2, 6)])
def test_transformer_layer_coo_over_the_indexes_matches_jax(heads, out):
    """One TransformerConv layer end to end (K10 over the destination
    index, K9, K8; backward K10b, K8, K8b, K9b) on the edges in their
    random order, heads of 4, 64 and 3 values: the logits, the loss, every
    parameter's and the input's gradient against the reference's."""
    jt, js, pt, _ = _pair("transformer", num_layers=1, out=out,
                          conv_kwargs={"heads": heads})
    assert (np.diff(pt.data.dst.numpy()) < 0).any()          # not sorted
    _forward_and_gradients_match(jt, js, pt)


def test_gcn_coo_normalises_sources_by_out_degree():
    """ROADMAP C2: the coo form follows the reference's coo (the source's
    out-degree), which the ELL form does not; on this graph the two differ,
    and the coo form matches the reference's."""
    src, dst, x, _ = _arrays()
    enc = GNNEncoder(DIN, HID, C, num_layers=1, conv="gcn")
    ref = RefGNNEncoder(hid_dim=HID, out_dim=C, num_layers=1, conv="gcn")
    params = ref.init(jax.random.PRNGKey(2), jnp.asarray(x),
                      jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
                      N, method="encode_coo")
    enc.load_state_dict(params_from_flax(_np(params)))
    want = ref.apply(params, jnp.asarray(x), jnp.asarray(src, jnp.int32),
                     jnp.asarray(dst, jnp.int32), N, method="encode_coo")
    ts, td = (torch.as_tensor(a.astype(np.int32)) for a in (src, dst))
    with torch.no_grad():
        got = enc.encode_coo(torch.from_numpy(x), ts, td, N)
        from gigl_tpu_torch.ops.ell import EllGraph
        g = HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x)
        ell = EllGraph.from_csr(g.csr(g.metadata.edge_types[0],
                                      anchor="dst"), device="cpu")
        via_ell = enc.encode_ell(torch.from_numpy(x), ell)
    _close(got, want, 1e-5)
    assert float((via_ell - got).abs().max()) > 1e-2 * float(got.abs().max())


@pytest.mark.parametrize("conv", ["graphsage", "gcn", "gat", "transformer"])
def test_twenty_step_trajectory_matches_jax(conv):
    jt, js, pt, ps = _pair(conv)
    want = []
    for _ in range(20):
        js, loss = jt._train_step(jt.data, js, jax.random.PRNGKey(1))
        want.append(float(loss))
    got = []
    for _ in range(20):
        ps, loss = pt.train_step(ps)
        got.append(float(loss))
    assert ps.step == 20
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[-1] < want[0]
    for split in ("train", "val", "test"):
        assert pt.accuracy(split) == jt.accuracy(js.params, split), split


def test_fit_stops_where_jax_stops():
    cfg = fb.FullBatchTrainerConfig(num_epochs=40, eval_every=3,
                                    early_stop_patience=2)
    jt, js, pt, ps = _pair("graphsage", cfg=cfg)
    js, want = jt.fit(js)
    ps, got = pt.fit(ps)
    assert ps.step == int(js.step)
    assert got == want


def test_link_prediction_encode_coo_and_what_raises():
    src, dst, x, _ = _arrays()
    ts, td = (torch.as_tensor(a.astype(np.int32)) for a in (src, dst))
    enc = GNNEncoder(DIN, HID, C, conv="gat", conv_kwargs={"heads": 2})
    model = LinkPredictionGNN(enc, LinkPredictionDecoder())
    idx = SegmentIndex.from_ids(td, N)
    sidx = SegmentIndex.from_ids(ts, N)
    with torch.no_grad():
        a = model.encode_coo(torch.from_numpy(x), ts, td, N, index=idx,
                             src_index=sidx)
        b = enc.encode_coo(torch.from_numpy(x), ts, td, N)
    assert torch.equal(a, b) and a.shape == (N, C)
    # GATv2's coo form and a GAT given edge rows it does not read, against
    # the reference's encode_coo (tests/test_torch_coo_edges.py has the
    # edge convs)
    ea = np.random.default_rng(1).normal(size=(len(src), 2)).astype(
        np.float32)
    args = (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), N)
    for conv, edges in (("gatv2", None), ("gat", ea)):
        ref = RefGNNEncoder(hid_dim=HID, out_dim=C, conv=conv,
                            conv_kwargs={"heads": 2})
        jea = None if edges is None else jnp.asarray(edges)
        params = ref.init(jax.random.PRNGKey(4), jnp.asarray(x), *args, jea,
                          method="encode_coo")
        want = ref.apply(params, jnp.asarray(x), *args, jea,
                         method="encode_coo")
        mine = GNNEncoder(DIN, HID, C, conv=conv, conv_kwargs={"heads": 2})
        mine.load_state_dict(params_from_flax(_np(params)))
        with torch.no_grad():
            got = mine.encode_coo(torch.from_numpy(x), ts, td, N,
                                  None if edges is None
                                  else torch.from_numpy(edges))
        _close(got, want, 1e-5)
