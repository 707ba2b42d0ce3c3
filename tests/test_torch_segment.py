"""Parity of the port's COO segment ops (gigl_tpu_torch.ops.segment: the
plain twins of K8 segment_reduce, K9 segment_softmax and K10 sddmm, which
run for CPU tensors) with the JAX reference (gigl_tpu.ops.segment), and of
their backward: each op's ``autograd.Function`` on CPU tensors, whose
backward composes the twins of K8b, K9b, K10b (with K8 and K10), against
``jax.vjp`` of the reference.

The graph: 60 segments, 700 edges with unsorted ids, 8 empty segments and
one hub segment of degree 300. Tolerances:

- fp32: the same sums in another order, within 1e-6 of the output's
  largest entry;
- bf16 against the reference in bf16, segments of degree <= 16 only: the
  reference accumulates in bf16 (each partial sum rounded, so a degree-d
  sum is off by up to ~d/2 ulps of its partial sums) where the port sums in
  fp32 and rounds once: within 5e-2 of the largest entry;
- bf16 against the reference in fp32 on the same bf16 inputs, every
  segment: one rounding, within 2**-8 of the largest entry. The mean's count
  is rounded to bf16 first: a hub of degree 301 divides by 300;
- integer tables (the SegmentIndex) bit-equal to numpy's stable argsort;
- the backward, fp32: within 1e-5 of each cotangent's largest entry (max
  on data with ties: the cotangent shared among them, as jax.vjp shares
  it; empty segments pass nothing).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.ops import segment as ref
from gigl_tpu_torch.ops import segment as seg
from gigl_tpu_torch.ops.segment import SegmentIndex

torch.set_num_threads(1)

S, E, HUB, HUB_DEG, N_SRC = 60, 700, 7, 300, 90
EMPTY = (0, 3, 11, 12, 30, 41, 58, 59)
H, DK = 4, 8


def _ids(seed=0, e=E):
    rng = np.random.default_rng(seed)
    pool = np.array([s for s in range(S) if s not in EMPTY and s != HUB])
    ids = rng.choice(pool, e - HUB_DEG)
    ids = np.concatenate([ids, np.full(HUB_DEG, HUB)])
    return rng.permutation(ids).astype(np.int32)


def _data(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_segment_index_is_a_stable_sort():
    ids = _ids()
    idx = SegmentIndex.from_ids(ids, S, device="cpu")
    want = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(idx.order.numpy(), want)
    np.testing.assert_array_equal(
        idx.ptr.numpy(), np.concatenate([[0], np.cumsum(
            np.bincount(ids, minlength=S))]))
    assert idx.order.dtype == idx.ptr.dtype == torch.int32
    assert idx.num_edges == E and idx.num_segments == S
    for s in range(S):
        members = idx.order[idx.ptr[s]:idx.ptr[s + 1]].numpy()
        assert (ids[members] == s).all() and (np.diff(members) > 0).all()
    assert idx.ptr[HUB + 1] - idx.ptr[HUB] == HUB_DEG
    # from a tensor: built on the host, kept on the tensor's device
    idx_t = SegmentIndex.from_ids(torch.from_numpy(ids), S)
    assert torch.equal(idx_t.order, idx.order)
    empty = SegmentIndex.from_ids(np.zeros(0, np.int32), 5, device="cpu")
    assert empty.num_edges == 0 and empty.ptr.tolist() == [0] * 6
    with pytest.raises(ValueError, match="lie in"):
        SegmentIndex.from_ids(np.array([0, 5]), 5, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SegmentIndex.from_ids(ids, S)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean",
                                "segment_max"])
@pytest.mark.parametrize("shape", [(E,), (E, 12), (E, H, DK)])
def test_segment_reduce_matches_jax_fp32(fn, shape):
    ids, x = _ids(), _data(shape)
    want = getattr(ref, fn)(jnp.asarray(x), jnp.asarray(ids), S)
    got = getattr(seg, fn)(_t(x), _t(ids, torch.int32), S)
    _close(got, want, 1e-6)
    assert got.dtype == torch.float32
    # empty segments give 0
    assert not got[list(EMPTY)].any()


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean",
                                "segment_max"])
def test_segment_reduce_with_no_edges(fn):
    ids = np.zeros(0, np.int32)
    x = np.zeros((0, 6), np.float32)
    want = getattr(ref, fn)(jnp.asarray(x), jnp.asarray(ids), 4)
    got = getattr(seg, fn)(_t(x), _t(ids, torch.int32), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (4, 6) and not got.any()


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_coo_spmm_matches_jax(reduce, weighted):
    ids = _ids()
    src = np.random.default_rng(2).integers(0, N_SRC, E).astype(np.int32)
    x = _data((N_SRC, 16))
    w = np.random.default_rng(3).uniform(0.1, 2.0, E).astype(np.float32)
    kw = {"edge_weight": jnp.asarray(w)} if weighted else {}
    want = ref.coo_spmm(jnp.asarray(src), jnp.asarray(ids), jnp.asarray(x),
                        S, reduce=reduce, **kw)
    kw = {"edge_weight": _t(w)} if weighted else {}
    got = seg.coo_spmm(_t(src, torch.int32), _t(ids, torch.int32), _t(x), S,
                       reduce=reduce, **kw)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("layout", ["3d", "flat"])
def test_coo_spmm_per_head_weights(layout):
    """[E, H] weights (the port's extension): the reference's segment_sum of
    the per-head weighted messages, as HGTConv.coo computes them."""
    ids = _ids()
    src = np.random.default_rng(2).integers(0, N_SRC, E).astype(np.int32)
    x = _data((N_SRC, H, DK))
    w = np.random.default_rng(4).uniform(0.0, 1.0, (E, H)).astype(np.float32)
    want = ref.segment_sum(jnp.asarray(w)[..., None] * jnp.asarray(x)[src],
                           jnp.asarray(ids), S)
    xt = _t(x) if layout == "3d" else _t(x.reshape(N_SRC, H * DK))
    got = seg.coo_spmm(_t(src, torch.int32), _t(ids, torch.int32), xt, S,
                       edge_weight=_t(w))
    _close(got.reshape(S, H, DK), want, 1e-6)
    with pytest.raises(ValueError, match="reduce"):
        seg.coo_spmm(_t(src, torch.int32), _t(ids, torch.int32), xt, S,
                     reduce="median")


@pytest.mark.parametrize("shape", [(E,), (E, H)])
def test_segment_softmax_matches_jax(shape):
    ids = _ids()
    logits = _data(shape) * 3.0
    logits[5] = -np.inf          # one edge that can never be attended
    want = ref.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), S)
    got = seg.segment_softmax(_t(logits), _t(ids, torch.int32), S)
    _close(got, want, 1e-6)
    sums = seg.segment_sum(got, _t(ids, torch.int32), S)
    present = np.bincount(ids, minlength=S) > 0
    np.testing.assert_allclose(sums.numpy()[present], 1.0, rtol=1e-5)
    # a segment whose logits are all -inf gives 0 (the max becomes 0)
    lone = seg.segment_softmax(torch.tensor([-np.inf, 1.0]),
                               torch.tensor([0, 1]), 2)
    assert lone.tolist() == [0.0, 1.0]


@pytest.mark.parametrize("heads", [None, H])
@pytest.mark.parametrize("scaled", [False, True])
def test_sddmm_matches_jax(heads, scaled):
    rng = np.random.default_rng(5)
    src = rng.integers(0, N_SRC, E).astype(np.int32)
    dst = _ids()
    tail = (heads, DK) if heads else (DK * 2,)
    q, k = _data((S,) + tail, 6), _data((N_SRC,) + tail, 7)
    want = ref.sddmm(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(q),
                     jnp.asarray(k))
    scale = rng.uniform(0.5, 2.0, heads or 1).astype(np.float32)
    if scaled:
        want = want * (jnp.asarray(scale) if heads else scale[0])
    got = seg.sddmm(_t(src, torch.int32), _t(dst, torch.int32), _t(q), _t(k),
                    scale=_t(scale) if scaled else None)
    assert got.shape == ((E, heads) if heads else (E,))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean",
                                "segment_max", "segment_softmax"])
def test_bf16_matches_jax_on_small_segments(fn):
    ids = _ids()
    deg = np.bincount(ids, minlength=S)
    keep = deg[ids] <= 16                        # drop the hub's edges
    ids_s = ids[keep]
    x = _data((len(ids_s), H) if fn == "segment_softmax"
              else (len(ids_s), 16))
    want = getattr(ref, fn)(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(ids_s), S)
    got = getattr(seg, fn)(_t(x, torch.bfloat16), _t(ids_s, torch.int32), S)
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean",
                                "segment_max", "segment_softmax"])
def test_bf16_is_one_rounding_of_fp32(fn):
    ids = np.concatenate([_ids(), np.full(1, HUB, np.int32)])  # hub: 301
    shape = (len(ids), H) if fn == "segment_softmax" else (len(ids), 16)
    xb = torch.from_numpy(_data(shape)).to(torch.bfloat16)
    want = getattr(ref, fn)(jnp.asarray(xb.float().numpy()),
                            jnp.asarray(ids), S)
    if fn == "segment_mean":
        # the count rounded to bf16: 301 -> 300
        deg = np.bincount(ids, minlength=S)
        want = want * (deg / np.asarray(
            jnp.asarray(np.maximum(deg, 1), jnp.bfloat16), np.float32)
            .clip(min=1))[:, None]
    got = getattr(seg, fn)(xb, _t(ids, torch.int32), S)
    _close(got, want, 2.0 ** -8)


def test_twins_are_differentiable_like_jax():
    """The CPU twins carry gradients (the backward of the kernels is
    slice 6): coo_spmm with per-edge weights and segment_softmax, against
    jax.vjp, fp32 within 1e-5 of the scale."""
    ids = _ids()
    src = np.random.default_rng(2).integers(0, N_SRC, E).astype(np.int32)
    x, logits = _data((N_SRC, 16)), _data((E, H), 8)
    g_out, g_att = _data((S, 16), 9), _data((E, H), 10)

    def f_ref(x_, l_):
        a = ref.segment_softmax(l_, jnp.asarray(ids), S)
        m = ref.coo_spmm(jnp.asarray(src), jnp.asarray(ids), x_, S,
                         edge_weight=a[:, 0])
        return m, a

    (_, _), vjp = jax.vjp(f_ref, jnp.asarray(x), jnp.asarray(logits))
    dx_ref, dl_ref = vjp((jnp.asarray(g_out), jnp.asarray(g_att)))
    xt = _t(x).requires_grad_()
    lt = _t(logits).requires_grad_()
    it, st = _t(ids, torch.int32), _t(src, torch.int32)
    a = seg.segment_softmax(lt, it, S)
    m = seg.coo_spmm(st, it, xt, S, edge_weight=a[:, 0])
    torch.autograd.backward((m, a), (_t(g_out), _t(g_att)))
    _close(xt.grad, dx_ref, 1e-5)
    _close(lt.grad, dl_ref, 1e-5)


def test_wrappers_check_their_arguments():
    ids = _t(_ids(), torch.int32)
    with pytest.raises(ValueError, match="segment ids"):
        seg.segment_sum(torch.zeros(E - 1, 3), ids, S)
    with pytest.raises(ValueError, match="weight"):
        seg.coo_spmm(ids, ids, torch.zeros(S, 3), S,
                     edge_weight=torch.zeros(E - 1))
    with pytest.raises(ValueError, match="Unknown reduce"):
        seg.segment_reduce(torch.zeros(E, 3), ids, S, op="min")
    with pytest.raises(ValueError, match="scale"):
        seg.sddmm(ids, ids, torch.zeros(S, 2, 4), torch.zeros(S, 2, 4),
                  scale=torch.ones(3))


# -- the backward: each Function's composition against jax.vjp ------------------
def _vjp_close(f_ref, f_port, inputs, cot, names, tol=1e-5):
    """jax.vjp of ``f_ref`` against backward() through ``f_port`` at the
    same inputs (numpy) and output cotangent ``cot``; ``names`` are the
    Function's backward nodes that must appear."""
    want_out, vjp = jax.vjp(f_ref, *(jnp.asarray(a) for a in inputs))
    want = vjp(jnp.asarray(cot))
    ts = [_t(a).requires_grad_() for a in inputs]
    out = f_port(*ts)
    _close(out.detach(), want_out, 1e-6)
    assert any(n in out.grad_fn.name() for n in names), out.grad_fn.name()
    out.backward(_t(cot))
    for t, w in zip(ts, want):
        _close(t.grad, w, tol)


def _ties(shape, seed=1):
    """Data on a coarse grid: many exact ties within a segment."""
    return np.round(_data(shape, seed) * 1.5).astype(np.float32)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean",
                                "segment_max"])
def test_segment_reduce_backward_matches_jax_vjp(fn):
    """Rows per edge (no gather): K8b's row-gather mode."""
    ids = _ids()
    x = _ties((E, 12))
    cot = _data((S, 12), 11)
    _vjp_close(lambda x_: getattr(ref, fn)(x_, jnp.asarray(ids), S),
               lambda x_: getattr(seg, fn)(x_, _t(ids, torch.int32), S),
               [x], cot, ["SegmentReduce"])


@pytest.mark.parametrize("reduce,weights", [
    ("sum", None), ("sum", "e"), ("sum", "eh"), ("mean", None),
    ("mean", "e"), ("mean", "eh"), ("max", None)])
def test_coo_spmm_backward_matches_jax_vjp(reduce, weights):
    """The gather mode: K8b's walk of the source index for the rows, K10
    on (cotangent, rows) for the weights; [E, H] weights against the
    reference's segment reduce of the per-head weighted messages. max on
    data with ties (duplicate sources in a segment included)."""
    ids = _ids()
    src = np.random.default_rng(2).integers(0, N_SRC, E).astype(np.int32)
    x = _ties((N_SRC, H, DK)) if reduce == "max" else _data((N_SRC, H, DK))
    cot = _data((S, H, DK), 12)
    jsrc, jids, tsrc, tids = (jnp.asarray(src), jnp.asarray(ids),
                              _t(src, torch.int32), _t(ids, torch.int32))
    red = {"sum": ref.segment_sum, "mean": ref.segment_mean,
           "max": ref.segment_max}[reduce]
    if weights is None:
        _vjp_close(lambda x_: red(x_[jsrc], jids, S),
                   lambda x_: seg.coo_spmm(tsrc, tids, x_, S, reduce=reduce),
                   [x], cot, ["SegmentReduce"])
        return
    shape = (E,) if weights == "e" else (E, H)
    w = np.random.default_rng(3).uniform(0.1, 2.0, shape).astype(np.float32)

    def f_ref(x_, w_):
        w3 = w_[:, None, None] if weights == "e" else w_[..., None]
        return red(x_[jsrc] * w3, jids, S)

    _vjp_close(f_ref, lambda x_, w_: seg.coo_spmm(
        tsrc, tids, x_, S, edge_weight=w_, reduce=reduce), [x, w], cot,
        ["SegmentReduce"])


@pytest.mark.parametrize("shape", [(E,), (E, H)])
def test_segment_softmax_backward_matches_jax_vjp(shape):
    """K9b: alpha * (g - sum_seg(alpha * g)); the reference's segment max
    is not under a stop-gradient, and its terms cancel."""
    ids = _ids()
    logits = _data(shape) * 3.0
    _vjp_close(lambda l_: ref.segment_softmax(l_, jnp.asarray(ids), S),
               lambda l_: seg.segment_softmax(l_, _t(ids, torch.int32), S),
               [logits], _data(shape, 13), ["SegmentSoftmax"])


@pytest.mark.parametrize("heads", [None, H])
@pytest.mark.parametrize("scaled", [False, True])
def test_sddmm_backward_matches_jax_vjp(heads, scaled):
    """dq (K8 over the destination index), dk (K8b over the source index)
    and, with a scale, dscale (K10b's per-head sum) — the reference's
    scores times the scale."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, N_SRC, E).astype(np.int32)
    dst = _ids()
    tail = (heads, DK) if heads else (DK * 2,)
    q, k = _data((S,) + tail, 6), _data((N_SRC,) + tail, 7)
    cot = _data((E, heads) if heads else (E,), 14)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    ts, td = _t(src, torch.int32), _t(dst, torch.int32)
    if not scaled:
        _vjp_close(lambda q_, k_: ref.sddmm(js, jd, q_, k_),
                   lambda q_, k_: seg.sddmm(ts, td, q_, k_), [q, k], cot,
                   ["SDDMM"])
        return
    scale = rng.uniform(0.5, 2.0, heads or 1).astype(np.float32)
    _vjp_close(
        lambda q_, k_, s_: ref.sddmm(js, jd, q_, k_) * (s_ if heads
                                                       else s_[0]),
        lambda q_, k_, s_: seg.sddmm(ts, td, q_, k_, scale=s_),
        [q, k, scale], cot, ["SDDMM"])


# -- the destination walk: K10 and K8 given the SegmentIndex -------------------
# The edges in random order (not sorted by destination), 8 empty segments
# and a hub of 300 edges; the index is checked against the call's shape on
# every device and walked on the card. fp32 within 1e-5 of the scale.
@pytest.mark.parametrize("heads", [1, H])
@pytest.mark.parametrize("dk", [3, 4, 32, 64])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("with_index", [False, True])
def test_sddmm_over_the_index_matches_jax_vjp(heads, dk, scaled, with_index):
    """sddmm(..., index=SegmentIndex.from_ids(dst, S)) against
    gigl_tpu.ops.segment.sddmm (times the scale) and its jax.vjp: dq, dk
    and dscale."""
    rng = np.random.default_rng(20 + dk)
    src = rng.integers(0, N_SRC, E).astype(np.int32)
    dst = _ids(seed=dk)
    assert (np.diff(dst) < 0).any()               # not sorted
    q, k = _data((S, heads, dk), 21), _data((N_SRC, heads, dk), 22)
    cot = _data((E, heads), 23)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    ts, td = _t(src, torch.int32), _t(dst, torch.int32)
    kw = {}
    if with_index:
        kw = {"index": SegmentIndex.from_ids(dst, S, device="cpu"),
              "src_index": SegmentIndex.from_ids(src, N_SRC, device="cpu")}
    if not scaled:
        _vjp_close(lambda q_, k_: ref.sddmm(js, jd, q_, k_),
                   lambda q_, k_: seg.sddmm(ts, td, q_, k_, **kw), [q, k],
                   cot, ["SDDMM"])
        return
    scale = rng.uniform(0.5, 2.0, heads).astype(np.float32)
    _vjp_close(lambda q_, k_, s_: ref.sddmm(js, jd, q_, k_) * s_,
               lambda q_, k_, s_: seg.sddmm(ts, td, q_, k_, scale=s_, **kw),
               [q, k, scale], cot, ["SDDMM"])


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("weights", [None, "e", "eh"])
@pytest.mark.parametrize("gather", [False, True])
def test_segment_reduce_over_the_index_matches_jax(op, weights, gather):
    """segment_reduce / coo_spmm with the index (and, gathered, the source
    index) against segment_sum / segment_mean / segment_max of the
    reference's weighted messages (coo_spmm's for [E] weights); their
    jax.vjp too where the port differentiates (a weighted max has no
    weight gradient)."""
    ids = _ids(seed=5)
    idx = SegmentIndex.from_ids(ids, S, device="cpu")
    src = np.random.default_rng(24).integers(0, N_SRC, E).astype(np.int32)
    rows = N_SRC if gather else E
    x = _ties((rows, H, DK)) if op == "max" else _data((rows, H, DK), 25)
    cot = _data((S, H, DK), 26)
    red = {"sum": ref.segment_sum, "mean": ref.segment_mean,
           "max": ref.segment_max}[op]
    jsrc, jids = jnp.asarray(src), jnp.asarray(ids)
    tsrc, tids = _t(src, torch.int32), _t(ids, torch.int32)
    kw = {"index": idx}
    if gather:
        kw["src_index"] = SegmentIndex.from_ids(src, N_SRC, device="cpu")

    def port(x_, w_=None):
        if gather:
            return seg.coo_spmm(tsrc, tids, x_, S, edge_weight=w_,
                                reduce=op, **kw)
        return seg.segment_reduce(x_, tids, S, op=op, weight=w_, **kw)

    def messages(x_):
        return x_[jsrc] if gather else x_

    if weights is None:
        _vjp_close(lambda x_: red(messages(x_), jids, S), port, [x], cot,
                   ["SegmentReduce"])
        return
    shape = (E,) if weights == "e" else (E, H)
    w = np.random.default_rng(27).uniform(0.1, 2.0, shape).astype(np.float32)

    def f_ref(x_, w_):
        if gather and weights == "e":
            return ref.coo_spmm(jsrc, jids, x_, S, edge_weight=w_,
                                reduce=op)
        w3 = w_[:, None, None] if weights == "e" else w_[..., None]
        return red(messages(x_) * w3, jids, S)

    if op == "max":
        _close(port(_t(x), _t(w)), f_ref(jnp.asarray(x), jnp.asarray(w)),
               1e-5)
        return
    _vjp_close(f_ref, port, [x, w], cot, ["SegmentReduce"])


def test_a_given_index_must_match_the_call():
    """A SegmentIndex over other segments or edges raises on every device
    (the card walks it)."""
    ids = _t(_ids(), torch.int32)
    other = SegmentIndex.from_ids(_ids()[:-1], S, device="cpu")
    wide = SegmentIndex.from_ids(_ids(), S + 1, device="cpu")
    x = torch.zeros(S, H, DK)
    for bad in (other, wide):
        with pytest.raises(ValueError, match="index covers"):
            seg.sddmm(ids, ids, x, x, index=bad)
        with pytest.raises(ValueError, match="index covers"):
            seg.segment_sum(torch.zeros(E, 3), ids, S, index=bad)
        with pytest.raises(ValueError, match="index covers"):
            seg.coo_spmm(ids, ids, x, S, index=bad)


def test_gather_edges_backward_is_a_segment_sum():
    """A per-node table read per edge: the backward sums the edges'
    cotangent rows per node (K8 over the ids' index), as jax.vjp's
    scatter-add does."""
    src = np.random.default_rng(2).integers(0, N_SRC, E).astype(np.int32)
    table = _data((N_SRC, H))
    _vjp_close(lambda t_: t_[jnp.asarray(src)],
               lambda t_: seg.gather_edges(t_, _t(src, torch.int32)),
               [table], _data((E, H), 15), ["GatherEdges"])


def test_backward_wrappers_check_their_arguments():
    ids = _t(_ids(), torch.int32)
    g = torch.zeros(S, 4)
    with pytest.raises(ValueError, match="max needs"):
        seg.segment_reduce_bwd(g, ids, E, op="max")
    with pytest.raises(ValueError, match="edges for"):
        seg.segment_reduce_bwd(g, ids, E + 1)
    with pytest.raises(ValueError, match="alpha and g"):
        seg.segment_softmax_bwd(torch.zeros(E, 2), torch.zeros(E, 3), ids, S)
    with pytest.raises(ValueError, match="scale"):
        seg.sddmm_bwd_coef(torch.zeros(E, 2), torch.ones(3))
    x = torch.zeros(N_SRC, 4, requires_grad=True)
    w = torch.ones(E, requires_grad=True)
    out = seg.coo_spmm(ids, ids, x, S, edge_weight=w, reduce="max")
    with pytest.raises(NotImplementedError, match="max mode"):
        out.sum().backward()


@pytest.mark.parametrize("kind", ["tensor", "numpy", "int64"])
def test_segment_index_composes_its_gather(kind):
    """``from_ids(dst, S, gather=src)``: ``gathered`` is ``src[order]``
    (int32, each slot's row in walk order); a tensor on the index's device
    is kept as it is, so K8 can tell it by identity; numpy ids are moved
    to the device."""
    ids = _ids(seed=6)
    src = np.random.default_rng(30).integers(0, N_SRC, E)
    given = {"tensor": _t(src, torch.int32), "numpy": src,
             "int64": _t(src, torch.int64)}[kind]
    idx = SegmentIndex.from_ids(ids, S, device="cpu", gather=given)
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(idx.order.numpy(), order)
    assert idx.gathered.dtype == torch.int32
    np.testing.assert_array_equal(idx.gathered.numpy(), src[order])
    if kind == "numpy":
        np.testing.assert_array_equal(idx.gather.numpy(), src)
    else:
        assert idx.gather is given
    assert seg.gather_mode(idx.gather, idx) == "composed"
    plain = SegmentIndex.from_ids(ids, S, device="cpu")
    assert plain.gather is None and plain.gathered is None
    with pytest.raises(ValueError, match="gather"):
        SegmentIndex.from_ids(ids, S, device="cpu", gather=src[:-1])


@pytest.mark.parametrize("change", ["copy_", "setitem", "add_"])
def test_gather_changed_in_place_takes_the_chained_mode(change):
    """The index records its gather's version counter: the very tensor it
    was built from, changed in place afterwards, no longer matches
    ``gathered`` and takes K8's chained mode (order, then the new ids)."""
    ids = _ids(seed=8)
    src = np.random.default_rng(35).integers(0, N_SRC - 1, E)
    own = _t(src, torch.int32)
    idx = SegmentIndex.from_ids(ids, S, device="cpu", gather=own)
    assert seg.gather_mode(own, idx) == "composed"
    {"copy_": lambda: own.copy_(torch.flip(own, (0,))),
     "setitem": lambda: own.__setitem__(0, 1),
     "add_": lambda: own.add_(1)}[change]()
    assert seg.gather_mode(own, idx) == "chained"
    assert seg.gather_mode(None, idx) is None


def test_a_source_index_composes_the_destination_ids():
    """``from_ids(src, n, gather=dst)``, the source index K8b walks:
    ``gathered`` is ``dst[order_src]`` bit for bit (each slot's
    destination in walk order), ``gather`` the dst tensor itself, and K8b's
    mode for those ids composed, for a copy chained."""
    ids = _ids(seed=10)
    src = np.random.default_rng(37).integers(0, N_SRC, E).astype(np.int32)
    dst = _t(ids, torch.int32)
    sidx = SegmentIndex.from_ids(_t(src, torch.int32), N_SRC, device="cpu",
                                 gather=dst)
    order = np.argsort(src, kind="stable")
    np.testing.assert_array_equal(sidx.order.numpy(), order)
    assert sidx.gathered.dtype == torch.int32
    np.testing.assert_array_equal(sidx.gathered.numpy(), ids[order])
    assert sidx.gather is dst
    assert seg.gather_mode(dst, sidx) == "composed"
    assert seg.gather_mode(dst.clone(), sidx) == "chained"


@pytest.mark.parametrize("ids_of", ["k8_src", "k8b_segment_ids"])
def test_an_inference_gather_changed_in_place_takes_the_chained_mode(ids_of):
    """ROADMAP C10: under ``torch.inference_mode()`` the ids an index is
    built from are an inference tensor, which keeps no version counter.
    The index keeps its own copy of them, made outside inference mode: the
    caller's tensor, changed in place, takes the chained mode (the new ids,
    as the reference reads them), and the index's copy, changed in place
    even under inference mode, moves its counter and takes it too. K8's
    src over its destination index (C10's smallest case: segment 0 then
    sums x[1], not the stale x[3]) and K8b's segment ids over its source
    index alike; the results are the twin's on the new ids."""
    x = _t(np.arange(16, dtype=np.float32).reshape(4, 4))
    with torch.inference_mode():
        dst = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
        src = torch.tensor([3, 2, 1, 0], dtype=torch.int32)
        if ids_of == "k8_src":
            ids, idx = src, SegmentIndex.from_ids(dst, 3, gather=src)
        else:
            ids, idx = dst, SegmentIndex.from_ids(src, 4, gather=dst)
        assert ids.is_inference() and idx.gather is not ids
        assert not idx.gather.is_inference()
        assert torch.equal(idx.gather, ids)
        assert seg.gather_mode(idx.gather, idx) == "composed"
        assert seg.gather_mode(ids, idx) == "chained"
        stale = idx.gathered.clone()
        ids[0] = 1
        assert seg.gather_mode(ids, idx) == "chained"
        assert not torch.equal(idx.gathered, ids[idx.order.long()])
        assert torch.equal(idx.gathered, stale)
        idx.gather[0] = 1
        assert seg.gather_mode(idx.gather, idx) == "chained"
        if ids_of == "k8_src":
            got = seg.coo_spmm(src, dst, x, 3, index=idx)
            want = x[src.long()].new_zeros((3, 4)).index_add(
                0, dst.long(), x[src.long()])
            assert torch.equal(got[0], x[1])
        else:
            g = x[:3]
            got = seg.segment_reduce_bwd(g, dst, 4, src=src, src_index=idx)
            want = torch.zeros((4, 4)).index_add(0, src.long(),
                                                 g[dst.long()])
            assert torch.equal(got[3], g[1])
        assert torch.equal(got, want)


def test_an_index_built_for_a_call_composes_its_src():
    """A K8 call on the card given no index builds one with its src as
    the gather (``_index``), so it runs the composed mode; the index of a
    call without a src composes nothing."""
    ids = _ids(seed=9)
    src = np.random.default_rng(36).integers(0, N_SRC, E)
    own = _t(src, torch.int32)
    built = seg._index(_t(ids, torch.int32), S, None, E, own)
    assert built.gather is own and seg.gather_mode(own, built) == "composed"
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(built.gathered.numpy(), src[order])
    bare = seg._index(_t(ids, torch.int32), S, None, E)
    assert bare.gathered is None and seg.gather_mode(own, bare) == "chained"


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("weights", [None, "e", "eh"])
@pytest.mark.parametrize("which", ["own", "copy", "other"])
def test_coo_spmm_over_a_composed_index_matches_jax(op, weights, which):
    """coo_spmm given an index built with its gather: with that very src
    tensor (K8's composed mode), with a copy of it and with other source
    ids (the chained mode: K8 reads order, then src), against the
    reference's segment_sum / segment_mean / segment_max of the gathered,
    weighted messages (coo_spmm for [E] weights) and its jax.vjp where the
    port differentiates (a weighted max has no weight gradient)."""
    ids = _ids(seed=7)
    src = np.random.default_rng(31).integers(0, N_SRC, E).astype(np.int32)
    own = _t(src, torch.int32)
    idx = SegmentIndex.from_ids(ids, S, device="cpu", gather=own)
    if which == "other":
        src = np.random.default_rng(32).integers(0, N_SRC, E).astype(
            np.int32)
    tsrc = {"own": own, "copy": own.clone(), "other": _t(src, torch.int32)
            }[which]
    assert seg.gather_mode(tsrc, idx) == ("composed" if which == "own"
                                          else "chained")
    kw = {"index": idx,
          "src_index": SegmentIndex.from_ids(src, N_SRC, device="cpu")}
    x = _ties((N_SRC, H, DK)) if op == "max" else _data((N_SRC, H, DK), 33)
    cot = _data((S, H, DK), 34)
    red = {"sum": ref.segment_sum, "mean": ref.segment_mean,
           "max": ref.segment_max}[op]
    jsrc, jids, tids = jnp.asarray(src), jnp.asarray(ids), _t(ids,
                                                             torch.int32)

    def port(x_, w_=None):
        return seg.coo_spmm(tsrc, tids, x_, S, edge_weight=w_, reduce=op,
                            **kw)

    if weights is None:
        _vjp_close(lambda x_: red(x_[jsrc], jids, S), port, [x], cot,
                   ["SegmentReduce"])
        return
    shape = (E,) if weights == "e" else (E, H)
    w = np.random.default_rng(35).uniform(0.1, 2.0, shape).astype(np.float32)

    def f_ref(x_, w_):
        if weights == "e":
            return ref.coo_spmm(jsrc, jids, x_, S, edge_weight=w_, reduce=op)
        return red(x_[jsrc] * w_[..., None], jids, S)

    if op == "max":
        _close(port(_t(x), _t(w)), f_ref(jnp.asarray(x), jnp.asarray(w)),
               1e-5)
        return
    _vjp_close(f_ref, port, [x, w], cot, ["SegmentReduce"])


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_bf16_over_a_composed_index_is_one_rounding(op):
    """bf16 rows through a composed index: the reference's reduce in fp32
    of the same bf16 inputs, rounded once (2**-8 of the largest entry;
    the mean's count rounded to bf16 first, as the reference counts)."""
    ids = _ids(seed=8)
    src = np.random.default_rng(36).integers(0, N_SRC, E).astype(np.int32)
    own = _t(src, torch.int32)
    idx = SegmentIndex.from_ids(ids, S, device="cpu", gather=own)
    x = _t(_data((N_SRC, 12), 37), torch.bfloat16)
    got = seg.coo_spmm(own, _t(ids, torch.int32), x, S, reduce=op,
                       index=idx)
    assert got.dtype == torch.bfloat16
    xf = jnp.asarray(x.float().numpy())[jnp.asarray(src)]
    jids = jnp.asarray(ids)
    if op == "mean":
        cnt = np.bincount(ids, minlength=S).astype(np.float32)
        cnt = np.maximum(_t(cnt).to(torch.bfloat16).float().numpy(), 1.0)
        want = ref.segment_sum(xf, jids, S) / cnt[:, None]
    else:
        want = {"sum": ref.segment_sum, "max": ref.segment_max}[op](
            xf, jids, S)
    _close(got, want, 2.0 ** -8)
