"""The port's routed lookups (gigl_tpu_torch.parallel.feature_lookup) and
its single-controller mesh (gigl_tpu_torch.parallel.mesh) against the JAX
reference on the virtual CPU mesh, on the CPU, where K15 route_requests,
K16 unroute_rows, K1 (row-offset mode) and K3 run their plain twins.

Everything here is integer work or a copy, so every comparison is
BIT-EQUAL: the routing tables (req, owner, pos, ok; one vector, and S
vectors in one call, each against the reference's), the un-routed rows
(fp32, bf16 and int32, widths 1 to 132), the routed gather's values and
ok bits at 1, 2, 4 and 8 shards (the one-shard closed form and the routed
path at capacities from overflowing to one past every request), the routed draws (against the reference's routed draws and the
port's replicated sampler), the collectives (against jax.lax's under
shard_map) and the shared random-negative draw.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gigl_tpu.parallel import feature_lookup as ref_fl
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu.sampling.neighbor_sampler import counter_rng_uniform
from gigl_tpu_torch.parallel import feature_lookup as fl
from gigl_tpu_torch.parallel.mesh import Mesh, make_mesh
from gigl_tpu_torch.sampling.neighbor_sampler import (
    _sample_uniform_plain,
    sample_uniform,
    uniform_ids,
)
from gigl_tpu_torch.training.dist_sampled import _shard_csr

torch.set_num_threads(1)

AXIS = "data"


def _ids(g, hi, seed):
    """Request ids with duplicates, ids past the table (they clip to the
    last shard) and negative ids (they clip to shard 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, g).astype(np.int32)
    if g >= 6:
        ids[:3] = ids[3:6]                       # duplicates
        ids[-1], ids[-2] = hi + 17, -5           # past the end, negative
    return ids


ROUTE_CASES = [  # (G, rows per shard, capacity)
    (200, 40, 64), (200, 40, 16), (0, 40, 8), (1, 7, 8), (333, 13, 200)]


@pytest.mark.parametrize("num_shards", [2, 4, 8])
@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=["fits", "overflow", "empty", "one", "big_c"])
def test_route_requests_bit_equal(num_shards, case):
    g, rows, cap = case
    ids = _ids(g, num_shards * rows, seed=g + num_shards)
    want = ref_fl._route_requests(jnp.asarray(ids), rows, num_shards, cap)
    got = fl.route_requests(torch.from_numpy(ids), rows, num_shards, cap)
    for name, w, t in zip(("req", "owner", "pos", "ok"), want, got):
        w = np.asarray(w)
        assert t.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
    if case[2] == 16:
        assert not got[3].all()                 # overflow happened


@pytest.mark.parametrize("num_shards", [1, 2, 4, 32])
@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=["fits", "overflow", "empty", "one", "big_c"])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_route_requests_batched_bit_equal(s, num_shards, case):
    """S request vectors bucketed in one call ([S, G], as _route_all stacks
    every shard's): each vector's tables bit-equal to the reference's
    _route_requests of that vector alone."""
    g, rows, cap = case
    ids = np.stack([_ids(g, num_shards * rows, seed=g + num_shards + v)
                    for v in range(s)]).reshape(s, g)
    got = fl.route_requests(torch.from_numpy(ids), rows, num_shards, cap)
    assert got[0].shape == (s, num_shards, cap)
    for v in range(s):
        want = ref_fl._route_requests(jnp.asarray(ids[v]), rows, num_shards,
                                      cap)
        for name, w, t in zip(("req", "owner", "pos", "ok"), want, got):
            np.testing.assert_array_equal(t[v].numpy(), np.asarray(w),
                                          err_msg=f"{name} of vector {v}")


def test_routed_lookup_rejects_ragged_vectors():
    """Every shard's request vector is routed in one K15 call, so the
    vectors must have one length."""
    mesh = Mesh(2, "cpu")
    tables = [torch.zeros((4, 3))] * 2
    with pytest.raises(ValueError, match="one G"):
        fl.routed_gather(mesh, tables, [torch.zeros(5, dtype=torch.int32),
                                        torch.zeros(4, dtype=torch.int32)])


@pytest.mark.parametrize("width", [1, 10, 15, 129, 132])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_unroute_bit_equal(width, dtype):
    num_shards, rows, cap, g = 4, 30, 24, 90
    rng = np.random.default_rng(width)
    ids = _ids(g, num_shards * rows, seed=width)
    req, owner, pos, ok = ref_fl._route_requests(jnp.asarray(ids), rows,
                                                 num_shards, cap)
    back = rng.normal(size=(num_shards, cap, width)) * 100
    jdt = {"float32": jnp.float32, "int32": jnp.int32,
           "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "int32": torch.int32,
           "bfloat16": torch.bfloat16}[dtype]
    jback = jnp.asarray(back).astype(jdt)
    want, _ = ref_fl._unroute(jback, owner, pos, ok)
    tback = torch.from_numpy(np.array(jback.astype(
        jnp.float32 if dtype == "bfloat16" else jdt))).to(tdt)
    got = fl.unroute_rows(tback, *(torch.from_numpy(np.array(a))
                                   for a in (owner, pos, ok)))
    assert got.dtype == tdt and got.shape == (g, width)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert not np.asarray(ok).all()             # some rows zero-filled


def _jax_routed_gather(table, ids, num_shards, **kw):
    mesh = jax_make_mesh(num_shards, axes=(AXIS,))
    sh = NamedSharding(mesh, P(AXIS))
    fn = jax.jit(jax.shard_map(
        lambda t, i: ref_fl.routed_gather(t, i, axis=AXIS, **kw), mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)), out_specs=(P(AXIS), P(AXIS)),
        check_vma=False))
    v, ok = fn(jax.device_put(table, sh), jax.device_put(ids, sh))
    return np.asarray(v), np.asarray(ok)


def _port_routed_gather(table, ids, num_shards, **kw):
    mesh = Mesh(num_shards, "cpu")
    tables = list(torch.from_numpy(table).reshape(num_shards, -1,
                                                  table.shape[1]))
    req = list(torch.from_numpy(ids).reshape(num_shards, -1))
    vals, ok = fl.routed_gather(mesh, tables, req, **kw)
    return torch.cat(vals).numpy(), torch.cat(ok).numpy()


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", [{}, {"capacity_factor": 1.0},
                                {"capacity": 8}, {"capacity_factor": 8.0}],
                         ids=["default", "tight", "overflow", "roomy"])
def test_routed_gather_bit_equal(num_shards, kw):
    rows, width, g = 24, 129, 48
    rng = np.random.default_rng(num_shards)
    table = rng.normal(size=(num_shards * rows, width)).astype(np.float32)
    ids = np.concatenate([_ids(g, num_shards * rows, seed=s)
                          for s in range(num_shards)])
    want_v, want_ok = _jax_routed_gather(table, ids, num_shards, **kw)
    got_v, got_ok = _port_routed_gather(table, ids, num_shards, **kw)
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got_v, want_v)
    if num_shards > 1 and "capacity" in kw:
        assert not got_ok.all()
    if got_ok.all():
        np.testing.assert_array_equal(
            got_v, table[np.clip(ids, 0, num_shards * rows - 1)])


def _csr(n, e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    return np.cumsum(indptr).astype(np.int32), src[order].astype(np.int32)


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_routed_sample_neighbors_bit_equal(num_shards):
    """Against the reference's routed draw and the port's replicated
    sampler (the draw is keyed by global id on the owner)."""
    n, fanout, seed, hop = 8 * 30, 6, 13, 2
    indptr, indices = _csr(n, 1800, seed=num_shards)
    rows = n // num_shards
    ip, ix = _shard_csr(indptr, indices, num_shards, rows)
    frontier = np.random.default_rng(1).integers(
        0, n, num_shards * 40).astype(np.int32)
    mesh = jax_make_mesh(num_shards, axes=(AXIS,))
    blk = NamedSharding(mesh, P(AXIS, None))
    fn = jax.jit(jax.shard_map(
        lambda a, b, f: ref_fl.routed_sample_neighbors(
            a[0], b[0], f, fanout, axis=AXIS, seed=seed, hop=hop),
        mesh=mesh, in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)), check_vma=False))
    w_nbr, w_mask, w_ok = (np.asarray(x) for x in fn(
        jax.device_put(ip, blk), jax.device_put(ix, blk),
        jax.device_put(frontier, NamedSharding(mesh, P(AXIS)))))
    pm = Mesh(num_shards, "cpu")
    nbr, mask, ok = fl.routed_sample_neighbors(
        pm, list(torch.from_numpy(ip)), list(torch.from_numpy(ix)),
        list(torch.from_numpy(frontier).reshape(num_shards, -1)), fanout,
        seed=seed, hop=hop)
    got_nbr, got_mask = torch.cat(nbr).numpy(), torch.cat(mask).numpy()
    np.testing.assert_array_equal(torch.cat(ok).numpy(), w_ok)
    np.testing.assert_array_equal(got_mask, w_mask)
    np.testing.assert_array_equal(got_nbr, w_nbr)
    r_nbr, r_mask, _ = sample_uniform(
        torch.from_numpy(indptr), torch.from_numpy(indices),
        torch.from_numpy(frontier), fanout, seed, hop)
    np.testing.assert_array_equal(got_mask, r_mask.numpy())
    np.testing.assert_array_equal(got_nbr, r_nbr.numpy())


def test_k1_row_offset_mode_is_the_replicated_draw():
    """K1's row-offset twin over one shard's CSR block gives the global
    draw for that shard's ids, and clips foreign ids into the block."""
    n, num_shards = 120, 4
    indptr, indices = _csr(n, 900, seed=3)
    ip, ix = _shard_csr(indptr, indices, num_shards, n // num_shards)
    shard, rows = 2, n // num_shards
    own = torch.arange(shard * rows, (shard + 1) * rows, dtype=torch.int32)
    got = _sample_uniform_plain(torch.from_numpy(ip[shard]),
                                torch.from_numpy(ix[shard]), own, 5, 7, 3,
                                row_offset=shard * rows)
    want = _sample_uniform_plain(torch.from_numpy(indptr),
                                 torch.from_numpy(indices), own, 5, 7, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    foreign = torch.tensor([0, n - 1], dtype=torch.int32)
    clipped = _sample_uniform_plain(torch.from_numpy(ip[shard]),
                                    torch.from_numpy(ix[shard]), foreign, 5,
                                    7, 3, row_offset=shard * rows)
    assert clipped[0].shape == (2, 5)
    # offset 0 over the whole CSR is the plain mode
    ids = torch.arange(n, dtype=torch.int32)
    a = _sample_uniform_plain(torch.from_numpy(indptr),
                              torch.from_numpy(indices), ids, 4, 1, 1, 0)
    b = _sample_uniform_plain(torch.from_numpy(indptr),
                              torch.from_numpy(indices), ids, 4, 1, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("step", [0, 5])
def test_shared_random_negatives_bit_equal(step):
    """K1b reproduces the partitioned trainer's shared draw
    (dist_sampled.py:878-881)."""
    r, n, seed = 64, 1000, 3
    bits = counter_rng_uniform(jnp.arange(r, dtype=jnp.int32), seed=seed,
                               hop=3_000_017 + step, num_slots=1)[:, 0]
    want = np.asarray((bits % jnp.uint32(n)).astype(jnp.int32))
    got = uniform_ids(r, seed, 3_000_017 + step, n, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("args", [(1024, 8, 2.0), (3, 8, 2.0), (0, 4, 4.0),
                                  (63_744, 4, 4.0), (100, 1, 2.0)])
def test_request_capacity(args):
    assert fl.request_capacity(*args) == ref_fl.request_capacity(*args)


def _jax_collective(fn, x, num_shards):
    mesh = jax_make_mesh(num_shards, axes=(AXIS,))
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(AXIS),
                              out_specs=P(AXIS), check_vma=False))
    return np.asarray(f(jax.device_put(x, NamedSharding(mesh, P(AXIS)))))


@pytest.mark.parametrize("name", ["all_to_all", "ppermute", "psum",
                                  "all_gather"])
def test_mesh_collectives_match_jax(name):
    p = 4
    x = np.random.default_rng(0).normal(size=(p * p * 3, 2)).astype(
        np.float32)
    jfn = {"all_to_all": lambda a: jax.lax.all_to_all(a, AXIS, 0, 0,
                                                      tiled=True),
           "ppermute": lambda a: jax.lax.ppermute(
               a, AXIS, [(i, (i + 1) % p) for i in range(p)]),
           "psum": lambda a: jax.lax.psum(a, AXIS),
           "all_gather": lambda a: jax.lax.all_gather(a, AXIS, axis=0,
                                                      tiled=True)}[name]
    want = _jax_collective(jfn, x, p)
    mesh = Mesh(p, "cpu")
    got = torch.cat(getattr(mesh, name)(
        list(torch.from_numpy(x).reshape(p, -1, 2)))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if name == "all_to_all":
        assert mesh.a2a_bytes == x.nbytes and mesh.a2a_calls == 1


def test_mesh_all_gather_gradient_returns_to_owner():
    mesh = Mesh(3, "cpu")
    xs = [torch.full((2,), float(s), requires_grad=True) for s in range(3)]
    gathered = mesh.all_gather(xs)
    sum(g_.sum() * (s + 1) for s, g_ in enumerate(gathered)).backward()
    for x in xs:
        assert torch.equal(x.grad, torch.full((2,), 6.0))


def test_make_mesh_defaults_to_cuda():
    """No device means CUDA: without a card make_mesh raises."""
    if torch.cuda.is_available():
        assert make_mesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)
    assert make_mesh(2, "cpu").num_shards == 2
    with pytest.raises(ValueError):
        Mesh(0, "cpu")


@pytest.mark.parametrize("kw,match", [
    ({"method": "weighted"}, "A2"), ({"local_edge_feats": object()}, "A15")])
def test_routed_sample_unported_options_raise(kw, match):
    """Both options are ported now: the weighted owner-side draw (A2,
    tests/test_torch_weighted_sampling.py) without local weights raises the
    reference's own ValueError; label-edge rows (A15,
    tests/test_torch_dist_label_edges.py) make the draw a 4-tuple whose
    rows are the drawn edges' rows, zero where a slot is masked."""
    mesh = Mesh(2, "cpu")
    ip = [torch.tensor([0, 2, 3], dtype=torch.int32)] * 2
    ix = [torch.tensor([1, 3, 0], dtype=torch.int32)] * 2
    ids = [torch.tensor([0, 3], dtype=torch.int32)] * 2
    if "method" in kw:
        with pytest.raises(ValueError, match="requires local_weights"):
            fl.routed_sample_neighbors(mesh, ip, ix, ids, 2, **kw)
        return
    rows = [torch.arange(9, dtype=torch.float32).reshape(3, 3) + 10 * q
            for q in range(2)]
    nbr, mask, ok, ef = fl.routed_sample_neighbors(
        mesh, ip, ix, ids, 2, local_edge_feats=rows)
    for s in range(2):
        assert ef[s].shape == (2, 2, 3) and ok[s].all()
        assert not ef[s][~mask[s]].any()
        # node 0 (shard 0) has slots 0, 1; node 3 (shard 1, local row 1)
        # has slot 2 of shard 1's block
        assert mask[s][0].all() and mask[s][1].tolist() == [True, False]
        assert torch.equal(ef[s][1, 0], rows[1][2])
        assert {tuple(r.tolist()) for r in ef[s][0]} == {
            tuple(rows[0][0].tolist()), tuple(rows[0][1].tolist())}


def test_route_requests_shard_limit_on_cuda_only():
    """The plain twin takes any shard count; the kernel takes up to
    MAX_SHARDS (checked by the wrapper before any launch)."""
    ids = torch.arange(40, dtype=torch.int32)
    req, *_ = fl.route_requests(ids, 1, 40, 4)
    assert req.shape == (40, 4)
    assert fl.MAX_SHARDS == 32
