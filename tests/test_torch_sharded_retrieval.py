"""The port's ring retrieval loss (gigl_tpu_torch.losses.sharded_retrieval)
against the JAX reference's ring_retrieval_loss on the virtual CPU mesh,
on the CPU, where K17's fold and backward run their plain twins.

K17's twins take a shard's P blocks at once ([P, Ql, Cl] scores, [P, Cl]
columns): they equal P one-block twins in ring order bit for bit, and
the [P, Ql, Cl] scores are each block's product's bits.

Tolerances: (ce_sum, count) per shard within 1e-6 relative in fp32 (the
same fold; the row sums and exps in another order); the gradients of the
queries and of every shard's candidate block against jax.grad through
shard_map (ppermute's transpose) within 1e-5 of each gradient's scale;
the sum over shards against the port's replicated retrieval_loss over the
assembled global score matrix within 1e-5 relative (a different
reduction: one logsumexp over the whole row).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gigl_tpu.losses.sharded_retrieval import (
    ring_retrieval_loss as jax_ring_loss,
)
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu_torch.losses import sharded_retrieval as sr
from gigl_tpu_torch.losses.losses import retrieval_loss
from gigl_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

AXIS = "data"
QL, RL, D = 6, 4, 8   # query rows and random negatives per shard


def _case(num_shards, seed=0, dups=True):
    """Per-shard arrays [P, ...]: queries, candidate blocks [own positives
    | own random slice] with their ids, positive query ids, masks and a
    logQ term."""
    rng = np.random.default_rng(seed)
    p, cl = num_shards, QL + RL
    q = rng.normal(size=(p, QL, D)).astype(np.float32)
    cand = rng.normal(size=(p, cl, D)).astype(np.float32)
    qids = rng.integers(0, p * QL // 2 if dups else 10 ** 6,
                        (p, QL)).astype(np.int32)
    pos_ids = rng.integers(0, 40, (p, QL)).astype(np.int32)
    cand_ids = np.concatenate(
        [pos_ids, rng.integers(0, 40, (p, RL)).astype(np.int32)], 1)
    pos_qids = np.concatenate([qids, np.full((p, RL), -1, np.int32)], 1)
    qmask = rng.random((p, QL)) < 0.85
    cmask = np.concatenate([qmask, np.ones((p, RL), bool)], 1)
    logq = np.log(np.clip(rng.integers(0, 6, (p, cl)) / 17.0, 1e-10,
                          None)).astype(np.float32)
    return dict(q=q, cand=cand, qids=qids, pos_ids=pos_ids,
                cand_ids=cand_ids, pos_qids=pos_qids, qmask=qmask,
                cmask=cmask, logq=logq)


def _jax_ring(c, temperature, use_logq, use_qmask, hits, grads=False):
    """Per-shard (ce_sum, count) from the reference, and with ``grads``
    the gradients of the summed ce over the queries and candidates."""
    p = c["q"].shape[0]
    mesh = jax_make_mesh(p, axes=(AXIS,))
    sh = NamedSharding(mesh, P(AXIS))

    def body(q_l, c_l, ci_l, pq_l, cm_l, lq_l, qi_l, opi_l, qm_l):
        s, n = jax_ring_loss(
            q_l[0], c_l[0], axis=AXIS, temperature=temperature,
            label_local_cols=jnp.arange(QL, dtype=jnp.int32),
            query_ids=qi_l[0], own_pos_ids=opi_l[0],
            candidate_ids=ci_l[0], pos_col_query_ids=pq_l[0],
            candidate_mask=cm_l[0],
            candidate_log_q=lq_l[0] if use_logq else None,
            query_mask=qm_l[0] if use_qmask else None,
            remove_accidental_hits=hits)
        return s[None], n[None]

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS),) * 9,
                       out_specs=(P(AXIS), P(AXIS)), check_vma=False)
    rest = [jax.device_put(c[k], sh) for k in (
        "cand_ids", "pos_qids", "cmask", "logq", "qids", "pos_ids",
        "qmask")]
    q, cand = jax.device_put(c["q"], sh), jax.device_put(c["cand"], sh)
    s, n = jax.jit(fn)(q, cand, *rest)
    if not grads:
        return np.asarray(s), np.asarray(n)
    gq, gc = jax.jit(jax.grad(lambda a, b: fn(a, b, *rest)[0].sum(),
                              argnums=(0, 1)))(q, cand)
    return np.asarray(s), np.asarray(n), np.asarray(gq), np.asarray(gc)


def _port_ring(c, temperature, use_logq, use_qmask, hits, grads=False):
    p = c["q"].shape[0]
    mesh = Mesh(p, "cpu")
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    q = [t["q"][s].clone().requires_grad_(grads) for s in range(p)]
    cand = [t["cand"][s].clone().requires_grad_(grads) for s in range(p)]
    cols = [sr.RingColumns(ids=t["cand_ids"][s], pos_qids=t["pos_qids"][s],
                           mask=t["cmask"][s],
                           log_q=t["logq"][s] if use_logq else None)
            for s in range(p)]
    cand_views = sr.ring_blocks(mesh, cand)
    col_views = sr.ring_blocks(mesh, cols)
    sums, counts = [], []
    for s in range(p):
        ce, n = sr.ring_retrieval_loss(
            q[s], cand_views[s], col_views[s], temperature=temperature,
            label_local_cols=torch.arange(QL, dtype=torch.int32),
            query_ids=t["qids"][s], own_pos_ids=t["pos_ids"][s],
            query_mask=t["qmask"][s] if use_qmask else None,
            remove_accidental_hits=hits)
        sums.append(ce)
        counts.append(n)
    if grads:
        torch.stack(sums).sum().backward()
        return (torch.stack(sums).detach().numpy(),
                torch.stack(counts).numpy(),
                torch.stack([x.grad for x in q]).numpy(),
                torch.stack([x.grad for x in cand]).numpy())
    return torch.stack(sums).numpy(), torch.stack(counts).numpy()


OPTIONS = [  # temperature, logQ, query mask, accidental hits
    (0.07, True, True, True), (None, False, False, True),
    (0.1, False, True, False), (None, True, False, False)]
OPTION_IDS = ["all", "plain", "qmask_nohits", "logq_only"]


@pytest.mark.parametrize("num_shards", [2, 4, 1])
@pytest.mark.parametrize("opts", OPTIONS, ids=OPTION_IDS)
def test_ring_loss_matches_jax(num_shards, opts):
    c = _case(num_shards, seed=num_shards)
    want_s, want_n = _jax_ring(c, *opts)
    got_s, got_n = _port_ring(c, *opts)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)


@pytest.mark.parametrize("dups", [True, False], ids=["dup_queries", "unique"])
def test_ring_loss_duplicate_queries(dups):
    c = _case(4, seed=7, dups=dups)
    assert (len(np.unique(c["qids"])) < c["qids"].size) == dups
    want_s, want_n = _jax_ring(c, 0.07, True, True, True)
    got_s, got_n = _port_ring(c, 0.07, True, True, True)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)


@pytest.mark.parametrize("opts", OPTIONS[:2], ids=OPTION_IDS[:2])
def test_ring_loss_gradients_match_jax(opts):
    """dq and every shard's dcand: autograd returns each block's
    cotangent to its owner, as ppermute's transpose does."""
    c = _case(4, seed=11)
    ws, wn, wgq, wgc = _jax_ring(c, *opts, grads=True)
    gs, gn, ggq, ggc = _port_ring(c, *opts, grads=True)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)
    for got, want in ((ggq, wgq), (ggc, wgc)):
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("opts", OPTIONS[:2], ids=OPTION_IDS[:2])
def test_ring_loss_gradients_match_jax_at_fewer_shards(num_shards, opts):
    """test_ring_loss_gradients_match_jax at P 1 and 2: one fold and one
    backward call a shard over its P blocks."""
    c = _case(num_shards, seed=12)
    ws, wn, wgq, wgc = _jax_ring(c, *opts, grads=True)
    gs, gn, ggq, ggc = _port_ring(c, *opts, grads=True)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)
    for got, want in ((ggq, wgq), (ggc, wgc)):
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("opts", OPTIONS, ids=OPTION_IDS)
def test_stacked_twins_equal_sequential_block_twins(num_shards, opts):
    """The fold and backward twins over [P, Ql, Cl] with [P, Cl] columns
    (the form K17 takes) equal P one-block twins in ring order, bit for
    bit."""
    temperature, use_logq, _, hits = opts
    c = _case(num_shards, seed=20 + num_shards)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    blocks = [sr.RingColumns(ids=t["cand_ids"][s], pos_qids=t["pos_qids"][s],
                             mask=t["cmask"][s],
                             log_q=t["logq"][s] if use_logq else None)
              for s in range(num_shards)]
    rows = sr.RingRows(temperature=temperature,
                       label_cols=torch.arange(QL, dtype=torch.int32),
                       query_ids=t["qids"][0],
                       own_pos_ids=t["pos_ids"][0] if hits else None)
    scores = torch.stack([t["q"][0] @ t["cand"][s].T
                          for s in range(num_shards)])
    stacked = sr.stack_columns(blocks)
    state = [torch.full((QL,), sr.FMIN), torch.zeros(QL), torch.zeros(QL)]
    one = [x.clone() for x in state]
    sr._ring_fold_plain(scores, rows, stacked, True, *state)
    for s, b in enumerate(blocks):
        sr._ring_fold_plain(scores[s], rows, b, s == 0, *one)
    for a, b in zip(state, one):
        assert torch.equal(a, b)
    lse = torch.log(state[1]) + state[0]
    g = torch.rand(QL, generator=torch.Generator().manual_seed(1))
    ds = sr._ring_block_bwd_plain(scores, rows, stacked, True, lse, g)
    assert ds.shape == scores.shape
    for s, b in enumerate(blocks):
        assert torch.equal(ds[s], sr._ring_block_bwd_plain(
            scores[s], rows, b, s == 0, lse, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cl", [10, 7])
def test_block_scores_are_the_per_block_products(dtype, cl):
    """The ring loss's [P, Ql, Cl] scores: block t the bits of
    ``(q @ c_t.T).float()`` (Cl 7: blocks off a 16-byte boundary)."""
    rng = np.random.default_rng(cl)
    q = torch.from_numpy(rng.normal(size=(QL, D)).astype(np.float32)).to(
        dtype)
    cands = [torch.from_numpy(rng.normal(size=(cl, D)).astype(
        np.float32)).to(dtype) for _ in range(3)]
    got = sr._block_scores(q, cands)
    assert got.shape == (3, QL, cl) and got.dtype == torch.float32
    for s, c in enumerate(cands):
        assert torch.equal(got[s], (q @ c.T).float())


def test_stack_columns_refuses_blocks_that_differ():
    ids = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="some blocks have mask"):
        sr.stack_columns([sr.RingColumns(ids, ids),
                          sr.RingColumns(ids, ids, mask=ids > 0)])
    with pytest.raises(ValueError, match="different widths"):
        sr.stack_columns([sr.RingColumns(ids, ids),
                          sr.RingColumns(ids[:3], ids[:3])])
    both = sr.stack_columns([sr.RingColumns(ids, ids),
                             sr.RingColumns(ids + 4, ids)])
    assert both.ids.shape == (2, 4) and both.mask is None


def test_ring_loss_equals_replicated_over_global_matrix():
    """The ring's sum over shards is the replicated retrieval loss over
    the assembled [P * Ql, P * Cl] score matrix (the full-batch
    contract)."""
    c = _case(4, seed=3)
    p = 4
    got_s, got_n = _port_ring(c, 0.07, True, True, True)
    # global columns: every shard's block in shard order; row r's label
    # is its own positive, column (shard * Cl + r % Ql)
    q = torch.from_numpy(c["q"].reshape(p * QL, D))
    cand = torch.from_numpy(c["cand"].reshape(-1, D))
    scores = q @ cand.T
    # the replicated loss labels the diagonal: reorder columns so each
    # row's own positive sits at column r
    pos_cols = np.array([s * (QL + RL) + r for s in range(p)
                         for r in range(QL)])
    rest = np.setdiff1d(np.arange(p * (QL + RL)), pos_cols)
    order = np.concatenate([pos_cols, rest])
    prob = np.exp(c["logq"].reshape(-1))[order]
    cids = c["cand_ids"].reshape(-1)[order]
    s, n = retrieval_loss(
        scores[:, order], temperature=0.07,
        candidate_sampling_probability=torch.from_numpy(prob),
        query_ids=torch.from_numpy(c["qids"].reshape(-1)),
        candidate_ids=torch.from_numpy(cids),
        remove_accidental_hits=True,
        query_mask=torch.from_numpy(c["qmask"].reshape(-1)),
        candidate_mask=torch.from_numpy(c["cmask"].reshape(-1)[order]))
    assert int(n) == int(got_n.sum())
    np.testing.assert_allclose(got_s.sum(), float(s), rtol=1e-5)


def test_fold_twin_fully_masked_row_and_foreign_block():
    """A row whose every column is masked folds to a finite (m, s) as the
    reference's guard keeps it, and a block folded as not-own adds no
    positive score."""
    c = _case(2, seed=5)
    t = {k: torch.from_numpy(v[0]) for k, v in c.items()}
    cols = sr.RingColumns(ids=t["cand_ids"], pos_qids=t["pos_qids"],
                          mask=torch.zeros(QL + RL, dtype=torch.bool))
    rows = sr.RingRows(temperature=0.07,
                       label_cols=torch.arange(QL, dtype=torch.int32),
                       query_ids=t["qids"], own_pos_ids=t["pos_ids"])
    scores = t["q"] @ t["cand"].T
    m = torch.full((QL,), sr.FMIN)
    s = torch.zeros(QL)
    pos = torch.zeros(QL)
    sr._ring_fold_plain(scores, rows, cols, False, m, s, pos)
    assert torch.isfinite(m).all() and torch.isfinite(s).all()
    assert (s == QL + RL).all() and (pos == 0).all()
    ds = sr._ring_block_bwd_plain(scores, rows, cols, True,
                                  torch.log(s) + m, torch.ones(QL))
    assert (ds == 0).all()


def test_ring_candidate_pool_layout():
    from gigl_tpu_torch.training.dataset import NALPBatch

    b, p_, h, r = 3, 2, 1, 4
    rng = np.random.default_rng(0)
    batch = NALPBatch(
        anchors=torch.tensor([5, 6, 7], dtype=torch.int32),
        pos=torch.from_numpy(rng.integers(0, 9, (b, p_)).astype(np.int32)),
        pos_mask=torch.from_numpy(rng.random((b, p_)) < 0.7),
        hard_neg=torch.from_numpy(rng.integers(0, 9, (b, h)).astype(
            np.int32)),
        hard_neg_mask=torch.ones((b, h), dtype=torch.bool),
        random_neg=torch.arange(8, dtype=torch.int32))
    pos = torch.randn(b, p_, D)
    hard = torch.randn(b, h, D)
    rand = torch.randn(r, D)
    cand, cols = sr.ring_candidate_pool(batch, pos, hard, rand,
                                        torch.arange(r, dtype=torch.int32))
    assert cand.shape == (b * p_ + b * h + r, D)
    assert torch.equal(cand[: b * p_], pos.reshape(-1, D))
    assert cols.pos_qids.tolist() == [5, 5, 6, 6, 7, 7] + [-1] * (b * h + r)
    assert torch.equal(cols.mask, torch.cat([
        batch.pos_mask.reshape(-1), batch.hard_neg_mask.reshape(-1),
        torch.ones(r, dtype=torch.bool)]))
    assert torch.equal(cols.ids[: b * p_], batch.pos.reshape(-1))
    assert cols.log_q is None


def test_own_block_bias_raises():
    """The own-block bias is ported (tests/test_torch_dist_label_edges.py)
    as an OwnBlockBias of the two score vectors: the reference's dense
    [Ql, Cl] matrix raises, and so do terms that do not fit the block."""
    q = torch.zeros((2, D))
    cols = sr.RingColumns(ids=None, pos_qids=torch.full((2,), -1,
                                                        dtype=torch.int32))
    with pytest.raises(TypeError, match="OwnBlockBias"):
        sr.ring_retrieval_loss(q, [q], [cols],
                               own_block_bias=torch.zeros((2, 2)))
    bias = sr.OwnBlockBias(torch.zeros(2), torch.zeros(2), 1, 1)
    with pytest.raises(ValueError, match="past the block"):  # Cl is 2
        sr.ring_retrieval_loss(q, [q], [cols], own_block_bias=bias)
    with pytest.raises(ValueError, match="anchors x 3 positives"):
        sr.ring_retrieval_loss(q, [q], [cols], own_block_bias=sr.OwnBlockBias(
            torch.zeros(2), None, 3, 0))


def test_ring_blocks_order_follows_ppermute():
    mesh = Mesh(4, "cpu")
    views = sr.ring_blocks(mesh, ["a", "b", "c", "d"])
    assert views[0] == ["a", "d", "c", "b"]
    assert views[2] == ["c", "b", "a", "d"]
