"""The port's weighted and top-k neighbor draws (K19's twin
``_sample_weighted_plain`` and K2's weighted mode's twin) against the JAX
reference's ``weighted_offsets`` / ``sample_neighbors(method=...)`` on the
CPU: the draw helpers, ``DeviceGraph.from_hetero(sampling_weight_index)``,
the sample tables and the aggregate cache, the routed owner-side draw at 1
and 4 shards, and the reference's own semantic checks
(``tests/test_sampling.py``) on the port.

Integer outputs (offsets, ids, masks, edge slots, tables, routed draws)
are BIT-EQUAL. The one admissible exception is a near-tie: float ``log``
may differ by an ulp between the two libraries, so a row may differ only
where the two scores that trade places lie within 2 ulp of each other in
the twin's own computation; :func:`_assert_draws_match` checks that for
every differing row and prints how many there are (none is expected at
these sizes). The aggregate caches are fp32 sums over <= fanout rows in
another order: rtol 1e-5, atol 1e-6, as tests/test_torch_hopcache.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.ops import hopcache as ref_hopcache
from gigl_tpu.parallel import feature_lookup as ref_fl
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu.sampling import neighbor_sampler as ref
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.ops import hopcache
from gigl_tpu_torch.parallel import feature_lookup as fl
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.sampling import neighbor_sampler as port
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.dist_sampled import _shard_csr

torch.set_num_threads(1)

N = 400
HUB, HUB_DEG = 3, 300          # one hub beyond the 128-slot window
ISOLATED = (6, 211)
AXIS = "data"


def _rows(seed=0):
    """(indptr, degrees) of N rows: degrees 0-40, a hub of 300, two
    isolated nodes."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 41, N)
    deg[HUB] = HUB_DEG
    deg[list(ISOLATED)] = 0
    return np.concatenate([[0], np.cumsum(deg)]).astype(np.int32), deg


def _weights(kind, e, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "continuous":
        return rng.random(e).astype(np.float32)
    if kind == "tied":      # integer counts with zeros and negatives
        return rng.integers(-2, 4, e).astype(np.float32)
    if kind == "nan":
        w = rng.random(e).astype(np.float32)
        w[rng.integers(0, e, 12)] = np.nan
        return w
    raise ValueError(kind)


def _twin_scores(w, start, deg, nodes, seed, hop, method, window):
    """The twin's own window scores (weighted_offsets' float32 steps)."""
    return port.window_scores(torch.as_tensor(w), torch.as_tensor(start),
                              torch.as_tensor(deg), torch.as_tensor(nodes),
                              seed, hop, method, window).numpy()


def _assert_draws_match(got_off, want_off, scores):
    """Offsets bit-equal but for near-ties: in a differing row, the first
    slots that trade places must score within 2 ulp of each other in the
    twin. Returns the rows that differ (printed)."""
    got_off, want_off = np.asarray(got_off), np.asarray(want_off)
    rows = np.nonzero((got_off != want_off).reshape(len(scores), -1)
                      .any(-1))[0]
    g2 = got_off.reshape(len(scores), -1)
    w2 = want_off.reshape(len(scores), -1)
    for r in rows:
        k = int(np.nonzero(g2[r] != w2[r])[0][0])
        a, b = scores[r, g2[r, k]], scores[r, w2[r, k]]
        assert np.isfinite(a) and abs(a - b) <= 2 * np.spacing(
            np.float32(max(abs(a), abs(b)))), (r, a, b)
    print(f"weighted draw: {len(rows)} of {len(scores)} rows differ by a "
          "near-tie")
    return rows


@pytest.mark.parametrize("window,fanout", [(128, 15), (128, 128), (8, 5),
                                           (8, 1)])
@pytest.mark.parametrize("kind", ["continuous", "tied", "nan"])
@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_weighted_offsets_bit_equal(method, kind, window, fanout):
    indptr, deg = _rows()
    w = _weights(kind, int(indptr[-1]))
    nodes = np.arange(N, dtype=np.int32)
    seed, hop = 2**32 - 5, 2**31 + 9
    fn = jax.jit(lambda w_, s_, d_, n_: ref.weighted_offsets(
        w_, s_, d_, n_, seed, hop, fanout, method, window=window))
    want_off, want_mask = fn(jnp.asarray(w), jnp.asarray(indptr[:-1]),
                             jnp.asarray(deg.astype(np.int32)),
                             jnp.asarray(nodes))
    got_off, got_mask = port.weighted_offsets(
        torch.from_numpy(w), torch.from_numpy(indptr[:-1]),
        torch.from_numpy(deg), torch.from_numpy(nodes), seed, hop, fanout,
        method, window)
    assert got_off.dtype == torch.int32 and got_mask.dtype == torch.bool
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    _assert_draws_match(got_off.numpy(), want_off, _twin_scores(
        w, indptr[:-1], deg, nodes, seed, hop, method, window))
    # deg < fanout: the first min(deg, fanout) slots valid, isolated none
    m = got_mask.numpy()
    np.testing.assert_array_equal(m.sum(-1), np.minimum(deg, fanout))
    assert not m[list(ISOLATED)].any()


# degrees at K19's key-register boundaries (32 slots a register)
EDGE_DEGREES = (0, 1, 31, 32, 33, 64, 65, 127, 128, 129)


@pytest.mark.parametrize("window,fanout", [(128, 15), (128, 33), (128, 128),
                                           (32, 32), (32, 1)])
@pytest.mark.parametrize("kind", ["special", "equal", "tied"])
@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_weighted_offsets_at_register_boundaries(method, kind, window,
                                                 fanout):
    """The twin against the reference at degrees 0, 1, 31-33, 64, 65,
    127-129 (each three times, so each under three Gumbel keys): weights
    with NaN, +inf and -inf entries (``special``), all equal, or tied
    integers with negatives; K19 takes its key registers and its closed
    form for the rounds past a node's valid slots from these degrees."""
    deg = np.repeat(np.array(EDGE_DEGREES), 3)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(indptr[-1])
    rng = np.random.default_rng(window + fanout)
    if kind == "equal":
        w = np.ones(e, np.float32)
    elif kind == "tied":
        w = rng.integers(-1, 3, e).astype(np.float32)
    else:
        w = rng.random(e).astype(np.float32)
        for value, count in ((np.nan, 25), (np.inf, 12), (-np.inf, 12)):
            w[rng.integers(0, e, count)] = value
    nodes = np.arange(len(deg), dtype=np.int32) * 7 + 3
    seed, hop = 11, 2
    fn = jax.jit(lambda w_, s_, d_, n_: ref.weighted_offsets(
        w_, s_, d_, n_, seed, hop, fanout, method, window=window))
    want_off, want_mask = fn(jnp.asarray(w), jnp.asarray(indptr[:-1]),
                             jnp.asarray(deg.astype(np.int32)),
                             jnp.asarray(nodes))
    got_off, got_mask = port.weighted_offsets(
        torch.from_numpy(w), torch.from_numpy(indptr[:-1]),
        torch.from_numpy(deg), torch.from_numpy(nodes), seed, hop, fanout,
        method, window)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    _assert_draws_match(got_off.numpy(), want_off, _twin_scores(
        w, indptr[:-1], deg, nodes, seed, hop, method, window))
    # past a node's valid slots: offset deg - 1 (0 without neighbors)
    off = got_off.numpy()
    for r, d in enumerate(deg):
        if d < fanout and not np.isnan(w[indptr[r]:indptr[r + 1]]).any():
            np.testing.assert_array_equal(off[r, d:], max(d - 1, 0))


@pytest.mark.parametrize("method", ["weighted", "top_k"])
@pytest.mark.parametrize("window", [128, 8])
def test_sample_neighbors_bit_equal(method, window):
    indptr, deg = _rows(2)
    e = int(indptr[-1])
    rng = np.random.default_rng(3)
    indices = rng.integers(0, N, e).astype(np.int32)
    w = _weights("tied", e, 4)
    jc = ref.DeviceCSR(jnp.asarray(indptr), jnp.asarray(indices),
                       edge_weights=jnp.asarray(w))
    pc = port.DeviceCSR(torch.from_numpy(indptr), torch.from_numpy(indices),
                        edge_weights=torch.from_numpy(w))
    frontier = rng.integers(0, N, (30, 7)).astype(np.int32)
    frontier[0, :3] = [HUB, ISOLATED[0], ISOLATED[1]]
    fanout = 6
    want = jax.jit(lambda c, f: ref.sample_neighbors(
        c, f, fanout, seed=11, hop=2, method=method, weight_window=window))(
            jc, jnp.asarray(frontier))
    got = port.sample_neighbors(pc, torch.from_numpy(frontier), fanout,
                                seed=11, hop=2, method=method,
                                weight_window=window)
    for g, wt in zip(got, want):
        assert tuple(g.shape) == frontier.shape + (fanout,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))
    assert not got[1][0, 1:3].any() and (got[0][0, 1:3] == 0).all()


@pytest.mark.parametrize("bits", [0, 2**32 - 129, 2**32 - 128, 2**32 - 1])
def test_weighted_scores_at_extreme_bits(bits):
    """u = (float32(bits) + 0.5) / 2**32: bits >= 2**32 - 128 round u to
    1.0, so -log(u) = -0.0 and the score is +inf in both packages."""
    logw = np.array([-0.5, 0.0, 3.0], np.float32)
    b = np.full(3, bits, np.uint32)
    u = (jnp.asarray(b).astype(jnp.float32) + 0.5) / 4294967296.0
    want = np.asarray(jnp.asarray(logw) - jnp.log(-jnp.log(u)))
    got = port.weighted_scores(torch.from_numpy(logw),
                               torch.from_numpy(b.astype(np.int64)),
                               torch.ones(3, dtype=torch.bool), "weighted")
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(want).all() == (bits >= 2**32 - 128)
    invalid = port.weighted_scores(torch.from_numpy(logw),
                                   torch.from_numpy(b.astype(np.int64)),
                                   torch.zeros(3, dtype=torch.bool),
                                   "weighted")
    assert (invalid.numpy() == np.finfo(np.float32).min).all()
    np.testing.assert_array_equal(port.weighted_scores(
        torch.from_numpy(logw), None, torch.ones(3, dtype=torch.bool),
        "top_k").numpy(), logw)


@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_two_inf_slots_and_nan_in_one_window(method):
    """Two +inf scores in one window tie to the lower slot; a NaN weight
    ranks below every other slot (the reference's CPU log turns it into a
    negative NaN, last in lax.top_k's total order), invalid ones included."""
    deg = np.array([10, 3, 12], np.int32)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    w = np.linspace(0.1, 0.9, int(indptr[-1])).astype(np.float32)
    w[[7, 2]] = np.inf                     # row 0: slots 2 and 7
    w[indptr[1] + 1] = np.nan              # row 1: slot 1 of 3
    w[indptr[2] + 4] = np.nan              # row 2: slot 4, beside an inf
    w[indptr[2] + 9] = np.inf
    nodes = np.arange(3, dtype=np.int32)
    want_off, want_mask = ref.weighted_offsets(
        jnp.asarray(w), jnp.asarray(indptr[:-1]), jnp.asarray(deg),
        jnp.asarray(nodes), 0, 1, 8, method, window=16)
    got_off, got_mask = port.weighted_offsets(
        torch.from_numpy(w), torch.from_numpy(indptr[:-1]),
        torch.from_numpy(deg), torch.from_numpy(nodes), 0, 1, 8, method, 16)
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert list(got_off.numpy()[0, :2]) == [2, 7]
    assert got_off.numpy()[2, 0] == 9
    # row 1 (degree 3): its two finite slots, then the invalid slots
    # (offsets clamped to deg - 1 = 2), the NaN slot only after them
    assert 1 not in got_off.numpy()[1, :7]


def _graph_arrays(seed=0, n=N, e=3000, de=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = ~np.isin(dst, ISOLATED)
    src = np.concatenate([src[keep], rng.integers(0, n, HUB_DEG)])
    dst = np.concatenate([dst[keep], np.full(HUB_DEG, HUB)])
    ef = rng.integers(0, 4, (len(src), de)).astype(np.float32)
    ef[:, 1] = rng.random(len(src))
    ef[:, 2] = np.arange(len(src))          # the edge's COO row
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return src, dst, ef, x


def _weighted_graphs(k=1, quantize=False, **kw):
    src, dst, ef, x = _graph_arrays(**kw)
    jg = JaxDeviceGraph.from_hetero(
        JaxHeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                   node_features=x, edge_features=ef),
        sampling_weight_index=k, quantize_features=quantize)
    pg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                node_features=x, edge_features=ef),
        sampling_weight_index=k, quantize_features=quantize, device="cpu")
    return jg, pg


@pytest.mark.parametrize("k", [0, 1])
def test_from_hetero_sorts_rows_by_weight(k):
    """Indices, edge ids (column 2 holds each edge's COO row), edge
    feature rows and weights move together; rows are sorted by descending
    weight, equal weights keeping CSR order (column 0 ties heavily)."""
    jg, pg = _weighted_graphs(k)
    np.testing.assert_array_equal(pg.message_csr.indptr.numpy(),
                                  np.asarray(jg.message_csr.indptr))
    np.testing.assert_array_equal(pg.message_csr.indices.numpy(),
                                  np.asarray(jg.message_csr.indices))
    np.testing.assert_array_equal(pg.message_csr.edge_weights.numpy(),
                                  np.asarray(jg.message_csr.edge_weights))
    np.testing.assert_array_equal(pg.edge_features.numpy(),
                                  np.asarray(jg.edge_features))
    np.testing.assert_array_equal(pg.edge_features[:, 2].numpy(),
                                  np.asarray(jg.message_csr.edge_ids))
    np.testing.assert_array_equal(pg.message_csr.edge_weights.numpy(),
                                  pg.edge_features[:, k].numpy())
    ip = pg.message_csr.indptr.numpy()
    w = pg.message_csr.edge_weights.numpy()
    eid = pg.edge_features[:, 2].numpy()
    for v in range(N):
        wv, ev = w[ip[v]: ip[v + 1]], eid[ip[v]: ip[v + 1]]
        assert (np.diff(wv) <= 0).all()
        ties = np.diff(wv) == 0
        assert (np.diff(ev)[ties] > 0).all()    # stable: CSR order kept


@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_sample_hop_blocks_and_sample_table_bit_equal(method):
    jg, pg = _weighted_graphs(0)
    roots = np.arange(0, N, 3).astype(np.int32)
    want = jax.jit(lambda g, r: g.sample_hop_blocks(
        r, (15, 4), seed=7, method=method))(jg, jnp.asarray(roots))
    got = pg.sample_hop_blocks(torch.from_numpy(roots), (15, 4), seed=7,
                               method=method)
    for g, w in zip(got.node_ids + got.masks + got.edge_slots[1:],
                    want.node_ids + want.masks + want.edge_slots[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for fanout, seed in ((15, 0), (10, 2**31 - 7)):
        wi, wm = ref_hopcache.build_sample_table(
            jg.message_csr, fanout=fanout, seed=seed, hop_key=1,
            method=method)
        gi, gm = hopcache.build_sample_table(
            pg.message_csr, fanout=fanout, seed=seed, hop_key=1,
            method=method)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    with pytest.raises(ValueError, match="edge_weights"):
        hopcache.build_sample_table(
            port.DeviceCSR(pg.message_csr.indptr, pg.message_csr.indices),
            fanout=3, method=method)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("agg", ["mean", "sum", "gcn"])
@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_build_neighbor_cache_weighted_matches(method, agg, quantize):
    jg, pg = _weighted_graphs(1, quantize=quantize)
    want = np.asarray(ref_hopcache.build_neighbor_cache(
        jg.message_csr, jg.node_features, fanout=10, seed=5, hop_key=2,
        agg=agg, degrees=jg.degrees, method=method))
    got = hopcache.build_neighbor_cache(
        pg.message_csr, pg.node_features, fanout=10, seed=5, hop_key=2,
        agg=agg, degrees=pg.degrees, method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[list(ISOLATED)], 0.0)
    with pytest.raises(ValueError, match="fanout"):
        hopcache.build_neighbor_cache(
            pg.message_csr, pg.node_features, fanout=129, agg=agg,
            degrees=pg.degrees, method=method)


def _routed(num_shards, method, frontier, fanout, seed, hop, window):
    indptr, _ = _rows(5)
    e = int(indptr[-1])
    rng = np.random.default_rng(6)
    indices = rng.integers(0, N, e).astype(np.int32)
    w = _weights("continuous", e, 7)
    rows = N // num_shards
    ip, ix, lw = _shard_csr(indptr, indices, num_shards, rows, weights=w)
    mesh = jax_make_mesh(num_shards, axes=(AXIS,))
    blk = NamedSharding(mesh, P(AXIS, None))
    fn = jax.jit(jax.shard_map(
        lambda a, b, c, f: ref_fl.routed_sample_neighbors(
            a[0], b[0], f, fanout, axis=AXIS, seed=seed, hop=hop,
            capacity_factor=4.0, method=method, local_weights=c[0],
            weight_window=window),
        mesh=mesh, in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None),
                             P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)), check_vma=False))
    want = [np.asarray(x) for x in fn(
        jax.device_put(ip, blk), jax.device_put(ix, blk),
        jax.device_put(lw, blk),
        jax.device_put(frontier, NamedSharding(mesh, P(AXIS))))]
    got = fl.routed_sample_neighbors(
        Mesh(num_shards, "cpu"), list(torch.from_numpy(ip)),
        list(torch.from_numpy(ix)),
        list(torch.from_numpy(frontier).reshape(num_shards, -1)), fanout,
        seed=seed, hop=hop, capacity_factor=4.0, method=method,
        local_weights=list(torch.from_numpy(lw)), weight_window=window)
    replicated = port.sample_weighted(
        torch.from_numpy(indptr), torch.from_numpy(indices),
        torch.from_numpy(w), torch.from_numpy(frontier), fanout, window,
        method, seed, hop)
    return want, [torch.cat(x).numpy() for x in got], replicated


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_routed_weighted_draw_bit_equal(num_shards, method):
    """Against the reference's routed draw under shard_map and the port's
    replicated draw (the owner's draw is keyed by the global id over the
    shard's own weights, clipped to its E_pad)."""
    frontier = np.random.default_rng(8).integers(0, N, 4 * 40).astype(
        np.int32)
    frontier[:3] = [HUB, ISOLATED[0], N - 1]
    want, got, repl = _routed(num_shards, method, frontier, 7, 13, 2, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].all()                                  # no overflow
    np.testing.assert_array_equal(got[0], repl[0].numpy())
    np.testing.assert_array_equal(got[1], repl[1].numpy())


# -- the reference's semantic checks (tests/test_sampling.py) on the port ----

def test_weighted_prefers_heavy_edges():
    from gigl_tpu_torch.graph.csr import build_csr

    csr = build_csr(np.arange(20), np.zeros(20, dtype=int),
                    num_anchor_nodes=1, num_neighbor_nodes=20)
    w = np.full(20, 1e-6, dtype=np.float32)
    w[3] = w[7] = 1000.0
    dev = port.DeviceCSR.from_csr(csr, torch.device("cpu"),
                                  edge_weights=w[csr.edge_ids])
    hits = 0
    for hop in range(50):
        nbr, mask, _ = port.sample_neighbors(
            dev, torch.tensor([0], dtype=torch.int32), 2, seed=0, hop=hop,
            method="weighted")
        hits += len(set(nbr[0][mask[0]].tolist()) & {3, 7})
    assert hits >= 95, hits


def test_top_k_exact():
    from gigl_tpu_torch.graph.csr import build_csr

    csr = build_csr(np.arange(10), np.zeros(10, dtype=int),
                    num_anchor_nodes=1, num_neighbor_nodes=10)
    w = np.arange(10, dtype=np.float32)
    dev = port.DeviceCSR.from_csr(csr, torch.device("cpu"),
                                  edge_weights=w[csr.edge_ids])
    nbr, mask, _ = port.sample_neighbors(
        dev, torch.tensor([0], dtype=torch.int32), 3, seed=0, hop=0,
        method="top_k")
    assert sorted(nbr[0][mask[0]].tolist()) == [7, 8, 9]


@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_top_k_finds_heavy_edge_beyond_window(method):
    """A hub whose heaviest in-edge is inserted last (slot > window in COO
    order): from_hetero's row sort brings it into the window."""
    hub_degree = 300
    n = hub_degree + 2
    src = np.arange(1, hub_degree + 1)
    dst = np.zeros(hub_degree, np.int64)
    w = np.linspace(1.0, 2.0, hub_degree).astype(np.float32)
    w[-1] = 1000.0
    g = HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=n,
        node_features=np.zeros((n, 4), np.float32),
        edge_features=w.reshape(-1, 1))
    dg = DeviceGraph.from_hetero(g, sampling_weight_index=0, device="cpu")
    nbr, mask, _ = port.sample_neighbors(
        dg.message_csr, torch.tensor([0], dtype=torch.int32), 3, seed=0,
        hop=1, method=method)
    assert mask[0].all() and hub_degree in nbr[0].tolist()
    if method == "top_k":
        assert nbr[0].tolist() == [hub_degree, hub_degree - 1,
                                   hub_degree - 2]
