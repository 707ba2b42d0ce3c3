"""The port's ring halo exchange (gigl_tpu_torch.parallel.halo) and its
partition layer (gigl_tpu_torch.parallel.partition) against the JAX
reference's on the 8-device virtual CPU mesh, on the CPU, where K18
ring_spmm runs its plain twin.

Tolerances: the ring schedule (src_local, dst_local, weight, inv_deg, per,
padding included) and every partition book, partition and padded feature
table are BIT-EQUAL. ring_spmm against the reference's ring_spmm within
1e-5 of the output's scale (measured: sum 0, mean 1.6e-7 — the port folds
1/deg into each edge's weight, rounding sum((w / deg) x) where the
reference rounds (sum w x) / deg), and its input gradient against jax.grad
through shard_map within 1e-5 of the gradient's scale (measured 0);
against the port's coo_spmm within 1e-5 of the scale (sums in another
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.parallel import halo as jax_halo
from gigl_tpu.parallel import partition as jax_partition
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.segment import coo_spmm
from gigl_tpu_torch.parallel import halo, partition
from gigl_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

SCHEDULE_FIELDS = ("src_local", "dst_local", "weight", "inv_deg")


def _graph(n=203, e=2311, d=16, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.random(e).astype(np.float32)
    return edges, x, w


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("num_shards", [1, 3, 4, 8])
def test_build_ring_schedule_bit_equal(num_shards, weighted):
    edges, _, w = _graph()          # 203 nodes: not a multiple of 3, 4, 8
    kw = {"edge_weight": w} if weighted else {}
    want = jax_halo.build_ring_schedule(edges, 203, num_shards, **kw)
    got = halo.build_ring_schedule(edges, 203, num_shards, **kw)
    for f in SCHEDULE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.per, got.num_nodes, got.num_shards, got.padded_num_nodes) \
        == (want.per, want.num_nodes, want.num_shards,
            want.padded_num_nodes)
    # the counts: each bucket's real slots, every edge once
    assert got.counts.shape == (num_shards, num_shards)
    assert int(got.counts.sum()) == edges.shape[1]
    real = np.arange(got.weight.shape[-1]) < got.counts[..., None]
    assert not got.weight[~real].any()


@pytest.mark.parametrize("num_shards", [1, 4])
def test_placed_index_sorts_each_bucket_stably(num_shards):
    """K18's two indexes hold each bucket's real slots, sorted stably by
    destination (forward) and by source (backward), with row pointers
    over per rows; the mean weights are w / deg in fp32."""
    edges, _, w = _graph(seed=5)
    sched = halo.build_ring_schedule(edges, 203, num_shards, edge_weight=w)
    placed = halo.put_ring_schedule(sched, Mesh(num_shards, "cpu"))
    for f in SCHEDULE_FIELDS:
        assert np.array_equal(getattr(placed, f).numpy(), getattr(sched, f))
    p = num_shards
    for b in range(p * p):
        c = int(sched.counts.reshape(-1)[b])
        s_l = sched.src_local.reshape(p * p, -1)[b, :c]
        d_l = sched.dst_local.reshape(p * p, -1)[b, :c]
        w_b = sched.weight.reshape(p * p, -1)[b, :c]
        idg = sched.inv_deg[b // p][d_l]
        for index, rows, cols in ((placed.fwd, d_l, s_l),
                                  (placed.bwd, s_l, d_l)):
            order = np.argsort(rows, kind="stable")
            ptr, row, col, wt = index["sum"][b]
            assert np.array_equal(row.numpy(), rows[order])
            assert np.array_equal(col.numpy(), cols[order])
            assert np.array_equal(wt.numpy(), w_b[order])
            assert np.array_equal(index["mean"][b][3].numpy(),
                                  (w_b * idg)[order])
            want_ptr = np.concatenate(
                [[0], np.cumsum(np.bincount(rows, minlength=sched.per))])
            assert np.array_equal(ptr.numpy(), want_ptr)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("num_shards", [1, 4, 8])
def test_ring_spmm_matches_jax(num_shards, reduce):
    edges, x, _ = _graph()
    want, _, _ = jax_halo.ring_sharded_aggregate(
        edges, x, 203, jax_make_mesh(num_shards), reduce=reduce)
    got, _, _ = halo.ring_sharded_aggregate(
        edges, x, 203, Mesh(num_shards, "cpu"), reduce=reduce)
    assert got.shape == (203, 16)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_ring_spmm_matches_coo_spmm(reduce):
    edges, x, w = _graph(seed=2)
    kw = {"edge_weight": w} if reduce == "sum" else {}
    got, _, _ = halo.ring_sharded_aggregate(
        edges, x, 203, Mesh(4, "cpu"), reduce=reduce, **kw)
    t = torch.from_numpy(edges.astype(np.int32))
    want = coo_spmm(t[0], t[1], torch.from_numpy(x), 203, reduce=reduce,
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_ring_spmm_gradient_matches_jax(reduce, weighted):
    """d/dx of <ring_spmm(x), G> against jax.grad through shard_map (the
    transposed ring)."""
    edges, x, w = _graph(n=97, e=801, d=8, seed=3)
    kw = {"edge_weight": w} if weighted else {}
    p = 4
    jm = jax_make_mesh(p)
    sched = jax_halo.build_ring_schedule(edges, 97, p, **kw)
    placed = jax_halo.put_ring_schedule(sched, jm)
    xp = jax_partition.shard_features_rowwise(jnp.asarray(x), jm)
    g = np.random.default_rng(4).normal(
        size=(sched.padded_num_nodes, 8)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda z: jnp.sum(
        jax_halo.ring_spmm(z, placed, jm, reduce=reduce) * g)))(xp))
    mesh = Mesh(p, "cpu")
    tp = halo.put_ring_schedule(
        halo.build_ring_schedule(edges, 97, p, **kw), mesh)
    xt = partition.shard_features_rowwise(x, mesh).requires_grad_()
    (halo.ring_spmm(xt, tp, mesh, reduce=reduce)
     * torch.from_numpy(g)).sum().backward()
    assert _rel(xt.grad.numpy(), want) <= 1e-5


def test_isolated_nodes_and_empty_buckets():
    """Every edge into node 0: rows without in-edges stay exactly 0 (mean
    too), 63 of 64 buckets are empty and launch nothing."""
    n, d = 40, 4
    edges = np.array([[1, 2, 3], [0, 0, 0]])
    x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    for reduce in ("sum", "mean"):
        want, _, _ = jax_halo.ring_sharded_aggregate(
            edges, x, n, jax_make_mesh(8), reduce=reduce)
        _build.reset_launches()
        got, _, sched = halo.ring_sharded_aggregate(
            edges, x, n, Mesh(8, "cpu"), reduce=reduce)
        assert int((sched.counts > 0).sum()) == 1
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
        assert not got[1:].any()
        assert _build.launches["ring_spmm"] == 0   # twins on the CPU


def test_padding_slots_with_a_non_finite_held_row():
    """ROADMAP C8: where a held block's row 0 is not finite, the reference's
    padding slots add 0 * inf = NaN into row 0 of the holding shard
    (gigl_tpu/parallel/halo.py:173-174); K18's index has no padding slots,
    so the port's rows stay finite. Both outputs as they are: NaN exactly
    in row 0 of every shard with a padded bucket on the reference's side,
    every other row equal."""
    n, d, p = 40, 4, 8                          # per = 5
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, n, 120), rng.integers(0, n, 120)
    keep = src % 5 != 0          # no real edge reads a block's row 0
    edges = np.stack([src[keep], dst[keep]])
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[::5] = np.inf                             # row 0 of every block
    want, _, _ = jax_halo.ring_sharded_aggregate(
        edges, x, n, jax_make_mesh(p), reduce="sum")
    want = np.asarray(want)
    got, _, sched = halo.ring_sharded_aggregate(
        edges, x, n, Mesh(p, "cpu"), reduce="sum")
    got = got.numpy()
    padded = [s * 5 for s in range(p)
              if (sched.counts[s] < sched.counts.max()).any()]
    assert padded
    np.testing.assert_array_equal(
        np.nonzero(np.isnan(want).any(1))[0], padded)
    assert np.isnan(want[padded]).all()
    assert np.isfinite(got).all()
    rest = np.setdiff1d(np.arange(n), padded)
    assert _rel(got[rest], want[rest]) <= 1e-5


def test_ring_sharded_aggregate_reusable_closure():
    edges, x, w = _graph(n=97, e=801, d=8, seed=3)
    out, run, sched = halo.ring_sharded_aggregate(
        edges, x, 97, Mesh(8, "cpu"), reduce="sum", edge_weight=w)
    jout, jrun, _ = jax_halo.ring_sharded_aggregate(
        edges, x, 97, jax_make_mesh(8), reduce="sum", edge_weight=w)
    assert _rel(out.numpy(), np.asarray(jout)) <= 1e-5
    x2 = (x * 2.0 + 1.0).astype(np.float32)
    xs2 = partition.shard_features_rowwise(x2, Mesh(8, "cpu"))
    assert xs2.shape == (sched.padded_num_nodes, 8)
    want2 = np.asarray(jrun(jax_partition.shard_features_rowwise(
        jnp.asarray(x2), jax_make_mesh(8))))
    assert _rel(run(xs2).numpy(), want2) <= 1e-5


def test_bad_reduce_and_shapes_raise():
    edges, x, _ = _graph()
    with pytest.raises(ValueError, match="sum|mean"):
        halo.ring_sharded_aggregate(edges, x, 203, Mesh(4, "cpu"),
                                    reduce="max")
    mesh = Mesh(4, "cpu")
    placed = halo.put_ring_schedule(halo.build_ring_schedule(edges, 203, 4),
                                    mesh)
    with pytest.raises(ValueError, match="must be"):
        halo.ring_spmm(torch.zeros(203, 4), placed, mesh)
    with pytest.raises(ValueError, match="mesh"):
        halo.put_ring_schedule(halo.build_ring_schedule(edges, 203, 4),
                               Mesh(2, "cpu"))
    with pytest.raises(ValueError, match=r"\[2, E\]"):
        halo.build_ring_schedule(edges[0], 203, 4)


@pytest.mark.parametrize("shift", [1, -1, 3])
@pytest.mark.parametrize("num_shards", [1, 4, 5])
def test_mesh_ppermute_shift(num_shards, shift):
    """out[(i + shift) % P] = in[i]: +1 (the default) is the retrieval
    ring's rotation, -1 the halo ring's."""
    mesh = Mesh(num_shards, "cpu")
    xs = list(range(num_shards))
    got = mesh.ppermute(xs, shift=shift)
    for i in range(num_shards):
        assert got[(i + shift) % num_shards] == xs[i]
    if shift == 1:
        assert mesh.ppermute(xs) == got


@pytest.mark.parametrize("num_shards", [1, 3, 256, 257, 65536, 65537])
def test_minimal_uint_dtype_matches_jax(num_shards):
    assert partition.minimal_uint_dtype(num_shards) \
        is jax_partition.minimal_uint_dtype(num_shards)


@pytest.mark.parametrize("edge_dir", ["in", "out"])
@pytest.mark.parametrize("book", ["range", "hash"])
@pytest.mark.parametrize("num_shards", [3, 4])
def test_partition_graph_bit_equal(num_shards, book, edge_dir):
    edges, x, _ = _graph(seed=7)
    labels = np.random.default_rng(7).integers(0, 5, 203)
    kw = {}
    if book == "hash":
        h = (np.arange(203) * 2654435761) % 2**32
        kw = {"node_book": partition.PartitionBook.by_hash(h, num_shards)}
        jkw = {"node_book": jax_partition.PartitionBook.by_hash(
            h, num_shards)}
        assert np.array_equal(kw["node_book"].book, jkw["node_book"].book)
    else:
        jkw = {}
        jb = jax_partition.PartitionBook.by_range(203, num_shards)
        pb = partition.PartitionBook.by_range(203, num_shards)
        assert pb.book.dtype == jb.book.dtype
        assert np.array_equal(pb.book, jb.book)
        assert pb.num_ids == jb.num_ids == 203
        assert np.array_equal(pb.ids_of_shard(1), jb.ids_of_shard(1))
    got_book, got = partition.partition_graph(
        edges, 203, num_shards, node_features=x, node_labels=labels,
        edge_dir=edge_dir, **kw)
    want_book, want = jax_partition.partition_graph(
        edges, 203, num_shards, node_features=x, node_labels=labels,
        edge_dir=edge_dir, **jkw)
    assert np.array_equal(got_book.book, want_book.book)
    for a, b in zip(got, want):
        assert a.shard == b.shard
        for f in ("edges", "edge_ids", "node_ids", "node_features",
                  "node_labels"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("n", [203, 200])
def test_shard_features_rowwise_matches_jax(n):
    x = np.random.default_rng(1).normal(size=(n, 5)).astype(np.float32)
    want = np.asarray(jax_partition.shard_features_rowwise(
        jnp.asarray(x), jax_make_mesh(8)))
    got = partition.shard_features_rowwise(x, Mesh(8, "cpu"))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def test_partition_rejects_zero_shards():
    with pytest.raises(ValueError, match="positive"):
        partition.minimal_uint_dtype(0)
