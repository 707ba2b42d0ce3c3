"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs a GPU and skips
without one. Run them on a machine with a card (no JAX needed there):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m cuda tests/test_torch_cuda_kernels.py

Edge shapes beyond the flagship ones that chip_smoke.py checks: isolated
nodes, fanouts above a warp (40), rows narrower and wider than a warp's
16-byte pieces, 4-byte-only rows, strided tables, all-masked rows, a single
query, score rows that are not a multiple of 32 wide. Integer and copied
outputs must be bit-equal; fp32 sums rtol 1e-5 (order differs); bf16
reductions within 2e-2 of the row scale (one rounding vs another). The
masked-reduce backward does the twin's arithmetic (one fp32 division, one
rounding): fp32 rtol 1e-6, bf16 within one ulp of the gradient's scale.
The retrieval loss: loss_sum within 1e-5 relative (fp32 sums in another
order), dS within 1e-5 of its scale in fp32 and one bf16 ulp of its scale
in bf16 (each element rounded once from nearly equal fp32 values). K6
ell_aggregate over whole graphs in one launch (empty buckets, degree-0
rows, a 5,000-in-degree row in a width-8192 bucket, widths that are not
multiples of 4, entry tables and rows off a 16-byte boundary, one node;
every mode, gine with and without edge rows; a row range bit-equal to the
whole call's rows) and K7 fanout_attention (one row of width 4,
all-masked rows and an all-masked bucket, a hub row of degree 5,000 in a
width-8192 bucket, rows that are not 16-byte multiples, head dim 4 in the
W 4, 8 and 32 buckets, where a warp takes several slots or rows): fp32
rtol/atol 1e-5 of the output scale (sums and exps in another order), bf16
within 2e-2 of the output scale; K7 and K7b give the same bits on a repeat
run; K6's autograd.Function on the card against the CPU. K6b
ell_transpose_aggregate (every mode) and K7b fanout_attention_bwd (GAT,
GATv2 and Transformer, the ELL and the dense-block layout) against their twins on
graphs with a 5,000-out-degree hub (a width-8192 transpose bucket),
sources without out-edges, one-row and all-masked buckets, rows that are
not 16-byte multiples, head dim 4: the same tolerances. Then encode_ell's
gradients on the card against the CPU's (ROADMAP C3), and full-batch and
sampled node-classification steps on the card against the CPU. K8
segment_reduce (sum, mean, max; unweighted, [E] and [E, H] weights; gather
and per-edge rows; rows of 128, 64, 12 and 4 values), K9 segment_softmax
(H 1 and 4) and K10 sddmm (head dims 32, 128, 64, 8 and 3; scaled) on
segments with empty segments, degree-1 segments and a 10^4 hub: the same
tolerances (softmax, absolute: 5e-5 fp32, where the hub's 10^4-term
denominator is summed in another order; 2**-8 bf16), the same bits on a
repeat run. K8's composed mode (an index built with its gather) against
its chained mode (a copy of the gather) and per-edge rows, bit for bit,
over segments of 0, 1, 2, 3, 31, 33 and 5,000 edges and an odd edge
count, every op and weighting, fp32 and bf16, aligned and 4-byte-offset
tables; and K6b over ``EllGraph.t_row`` in all seven modes over transpose
buckets of every width from 4 to 8,192. Their backward against autograd through the plain twins: K8b
(sum, mean, max with ties; unweighted, [E] and [E, H] weights, whose
gradient is K10; gather and per-edge rows; an x that needs no gradient)
over a 10^4-edge source hub and empty segments, K9b (H 1 and 4) and the
sddmm backward (K10b, K8, K8b; head dims 32, 64, 3; the scale absent,
without and with grad), fp32 within 1e-5 of the scale (K9b 1e-4: the hub's
softmax), bf16 within 2e-2, the same bits on a repeat run. Then
encode_coo's gradients (SAGE, GAT, Transformer) and HGT's encode_full
gradients (its prior through K10b) on the card against the CPU, the typed
serving paths on the card against the CPU (exact full-graph HGT,
SimpleHGN and RGCN; sampled HGT, live and tabularized), fp32 within 1e-5
of the scale, and three typed training steps (HGT, RGCN) against the CPU.
Edge features: K6 / K6b in gine mode and K11 ell_edge_grad (gine, gat,
transformer; heads 1, 3, 4; widths 256, 128, 15, 12, 8, 6, 5; an edgeless
graph; ELL graphs with empty buckets, a width-4096 hub bucket, isolated
nodes, multi-edges and self-loops), K7 / K7b with the edge addend (ELL layout) and
with the per-slot logit bias (dense block, an all-masked relation), the
same tolerances (K11 gine bit-equal: a gated permutation); encode_ell's
gradients with edge features (GINE, EdgeAttrGAT, Transformer) and NALP /
typed SimpleHGN steps with the label-edge scorer on the card against the
CPU. Quantized tables and the count-min sketch: K12 gather_rows_q8 (D 6,
12, 16, 128 and 136: its one-, four- and eight-value pieces; fp32 and bf16
out; with the degrees) and K13 cms_add / K14 cms_estimate (widths 1 to
65536, depth 1 to 8, odd widths, ids up to 2**31 - 1 and negative, one id
repeated 1,024 times, empty and 65,536-id batches, a wrapping total)
bit-equal to their twins; K2 in its int8 mode within rtol 1e-5; K5 with
the logQ term (p = 0 included) at K5's tolerances; two NALP steps over int8
features and cache with the sketch on, on the card against the CPU (losses
and weights within 1e-4 relative, the sketch bit-equal). The ring halo
exchange: K18 ring_spmm's one-bucket launch (forward and transposed index)
against its twin at widths 256, 128, 7 (4-byte loads), 4 on a misaligned
base, 1 and 33, on a bucket of 9,000 edges, a hub bucket with every edge
on one row and 37 rows (not a multiple of 32): fp32 within 1e-5 of the
scale, the same bits on a repeat run; an empty bucket launches nothing;
the whole ring (P 1, 4, 5; sum and mean) and its gradient (ring_spmm's
autograd.Function) on the card against the CPU within 1e-5 of the scale,
P^2 launches each way; three sharded full-batch steps (GCN, GraphSAGE)
on the card against the CPU (losses and weights within 1e-4 relative).
The weighted and top-k draw: K19 sample_weighted bit-equal to its twin
(windows 8, 32, 128, 200 and 1024, fanout = window, all-invalid rows, a
hub beyond every window, tied weights, +inf and NaN weights, the
row-offset mode; degrees 0, 1, 31-33, 64, 65 and 127-129, where its live
key registers change, at fanouts 1 to 1024), its wrapper's refusals, and
K2's weighted mode (fp32 and int8 features) within rtol 1e-5, and bit for
bit against K19's draw summed in slot order (mean, sum). K12's segmented
launch (1 to 9 gathers, one empty; fp32 and bf16) bit-equal to its twin,
also replayed from a CUDA graph over new ids. K17 ring_retrieval folds a shard's
P blocks in one launch and differentiates them in another, bit-equal to
one-block launches in turn and within rtol 1e-5 of its twins (Cl up to
1,100, where a lane recomputes its values); the loss's [P, Ql, Cl] scores
are each block's product's bits. K4 masked_reduce at K 1, 15, 16, 17, 40 and
70 (its slots taken 16 at a time, its mask read 56 slots at a time), M not
a multiple of a block's rows, grids past what the card holds at once,
one-piece rows and a mask off an 8-byte boundary: bit-equal to the twin
where the values sit on a coarse grid (every fp32 sum exact, then one
division and one rounding on both sides). K4b masked_reduce_bwd at K4's
shapes and data, bit-equal to the twin. K2 build_neighbor_cache over fp32
rows of D 4-256 (a group of 4-32 lanes a node; one or two column chunks,
one to three slot chunks), bit-equal to the twin on a coarse grid, and
over int8 rows in 16- and 4-byte pieces; nodes of degree 0 get 0, a hub
past the fanout draws with replacement. K5's forward is one launch:
C under and not a multiple of a 16-byte word, C past a warp's 1,024
columns, Q not a multiple of a block's rows, every mask on and off, terms
off a 16-byte boundary (the scalar form); three repeat calls give the
same bits and leave the ticket counter at 0, and a CUDA graph of forward
and backward replays the eager calls' bits. The COO per-edge terms: K8's
add and gine modes and GATv2 destination walk, K8b's gine gate and GATv2
source walk, K10's key addend and GATv2 scores, K11's COO form (gine,
gat with and without its logit term, transformer) against their twins
(heads 4 x 64, 1 x 128, 4 x 3, 2 x 8 and 4 x 32 off a 16-byte boundary,
3 x 5: K10's modes in its walk and in its thread-per-head form;
empty segments, 1,000-edge hubs on both sides; the edges in their own and
in walk order; fp32 and bf16), bit-equal on a repeat run and between the
composed and chained modes; each new autograd.Function and encode_coo
with edge features (GINE, EdgeAttrGAT, Transformer, and GATv2) on the
card against the CPU within 1e-4 of the scale. The partitioned tier's
label edges: K17's own-block bias mode (fold and backward with the terms'
cotangents; Ql 39 with 3 positives and 2 hard negatives an anchor, no
hard negatives, one block, 512 and 1 rows; fp32 and bf16 embeddings)
against its twin (the state rtol 1e-5, dS and the cotangents within 1e-5
of their scale), bit-equal on a repeat run and replayed from a CUDA graph;
K16 carrying [fanout, De] edge rows (De 8 and 3) bit-equal; routed draws
with edge rows, three partitioned label-edge steps (per-shard pool and
ring) and three typed partitioned steps (HGT live and tabularized, RGCN)
on the card against the CPU (1e-4 relative; encode_batch 1e-5 of the
scale).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gigl_tpu_torch.graph.csr import HeteroGraph, build_csr
from gigl_tpu_torch.inference.inferencer import (
    InferenceConfig,
    run_full_graph_inference_hetero,
    run_inference,
)
from gigl_tpu_torch.models import convs
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.hetero_encoders import HeteroGNNEncoder
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.models.link_prediction import (
    EdgeFeatureScorer,
    HeteroLinkPredictionGNN,
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops import coo_edges
from gigl_tpu_torch.ops import ell as edge_ops
from gigl_tpu_torch.ops import segment as segment_ops
from gigl_tpu_torch.ops.attention import (
    _fanout_attention_bwd_plain,
    _fanout_attention_fwd,
    _fanout_attention_plain,
    fanout_attention_bwd,
)
from gigl_tpu_torch.ops.ell import EllGraph
from gigl_tpu_torch.ops.ell_aggregate import (
    MAX_SEGMENTS,
    _ell_aggregate_fwd,
    _ell_aggregate_graph_plain,
    _ell_transpose_plain,
    ell_aggregate_graph,
    ell_edge_rows_sum,
    ell_transpose_aggregate,
)
from gigl_tpu_torch.ops.fanout import (
    _masked_reduce_bwd_plain,
    _masked_reduce_plain,
    masked_reduce,
    masked_reduce_bwd,
)
from gigl_tpu_torch.ops.gather import (
    _expand_table_plain,
    _gather_rows_plain,
    expand_table,
    gather_rows,
)
from gigl_tpu_torch.ops.hopcache import (
    _neighbor_cache_plain,
    build_neighbor_cache,
)
from gigl_tpu_torch.losses import count_min_sketch as cms_ops
from gigl_tpu_torch.losses import sharded_retrieval
from gigl_tpu_torch.parallel import feature_lookup as fl
from gigl_tpu_torch.parallel import halo
from gigl_tpu_torch.parallel.partition import shard_features_rowwise
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.ops.quantized import (
    QuantizedTable,
    _gather_packed_rows_q8_plain,
    _gather_rows_q8_many_plain,
    _gather_rows_q8_plain,
    gather_packed_rows_q8,
    gather_rows_q8,
    gather_rows_q8_many,
)
from gigl_tpu_torch.ops.retrieval import (
    RetrievalMasks,
    _retrieval_bwd_plain,
    _retrieval_fwd_plain,
    forward_ticket,
    retrieval_bwd,
    retrieval_fwd,
)
from gigl_tpu_torch.ops.segment import (
    SegmentIndex,
    _sddmm_bwd_coef_plain,
    _sddmm_plain,
    _segment_reduce_bwd_plain,
    _segment_reduce_plain,
    _segment_softmax_bwd_plain,
    _segment_softmax_plain,
    sddmm,
    sddmm_bwd_coef,
    sddmm_bwd_ticket,
    segment_reduce,
    segment_reduce_bwd,
    segment_softmax,
    segment_softmax_bwd,
    segment_sum,
)
from gigl_tpu_torch.sampling.hetero_sampler import SamplingOp, resolve_path
from gigl_tpu_torch.sampling.neighbor_sampler import (
    DeviceCSR,
    _sample_uniform_plain,
    _sample_weighted_plain,
    _uniform_ids_plain,
    sample_uniform,
    sample_weighted,
    uniform_ids,
)
from gigl_tpu_torch.training import dist_sampled
from gigl_tpu_torch.training import sharded_full_batch as sfb
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.full_batch import (
    FullBatchTrainer,
    full_batch_data_from_graph,
)
from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
from gigl_tpu_torch.training.hetero_trainer import (
    HeteroNALPTrainer,
    HeteroNALPTrainerConfig,
)
from gigl_tpu_torch.training.trainer import (
    NALPTrainer,
    NALPTrainerConfig,
    NodeClassificationTrainer,
    NodeClassificationTrainerConfig,
)
from gigl_tpu_torch.types.graph import EdgeType, GraphMetadata

pytestmark = pytest.mark.cuda

N, E = 700, 9000
# The kernels a sampled NALP training step launches (not K6 / K7).
TRAINING_KERNELS = ("sample_uniform", "uniform_ids", "build_neighbor_cache",
                    "gather_rows", "masked_reduce", "masked_reduce_bwd",
                    "retrieval_loss")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _csr(dev, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    keep = ~np.isin(dst, (5, 6, 699))
    src = np.concatenate([src[keep], rng.integers(0, N, 200)])
    dst = np.concatenate([dst[keep], np.full(200, 11)])  # one hub
    return DeviceCSR.from_csr(build_csr(src, dst, num_anchor_nodes=N,
                                        num_neighbor_nodes=N), dev)


@pytest.mark.parametrize("fanout,seed,hop", [
    (1, 0, 1), (15, 0, 1), (10, 3, 2), (40, 2**32 - 1, 2**31 + 5)])
def test_sample_uniform_bit_equal(dev, fanout, seed, hop):
    csr = _csr(dev)
    frontier = torch.cat([torch.arange(N, dtype=torch.int32, device=dev),
                          torch.tensor([5, 11], dtype=torch.int32,
                                       device=dev)]).reshape(-1, 3)
    before = _build.launches["sample_uniform"]
    got = sample_uniform(csr.indptr, csr.indices, frontier, fanout, seed, hop)
    torch.cuda.synchronize()
    assert _build.launches["sample_uniform"] == before + 1
    want = _sample_uniform_plain(csr.indptr, csr.indices, frontier, fanout,
                                 seed, hop)
    for g, w in zip(got, want):
        assert g.shape == frontier.shape + (fanout,)
        assert torch.equal(g, w)


@pytest.mark.parametrize("agg", ["mean", "sum", "gcn"])
@pytest.mark.parametrize("fanout,dim", [(3, 16), (10, 128), (40, 160),
                                        (10, 256), (40, 256)])
def test_neighbor_cache_matches_plain(dev, agg, fanout, dim):
    csr = _csr(dev, 1)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N, dim), generator=g, device=dev)
    deg = torch.diff(csr.indptr).float()
    fused = torch.full((N, 2 * dim), float("nan"), device=dev)
    fused[:, :dim].copy_(x)
    out = build_neighbor_cache(csr, x, fanout=fanout, seed=7, hop_key=2,
                               agg=agg, degrees=deg, out=fused[:, dim:])
    want = torch.empty((N, dim), device=dev)
    _neighbor_cache_plain(csr, x, fanout, 7, 2, agg, deg, want)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(fused[:, :dim], x)         # left half untouched
    assert torch.equal(out[[5, 6, 699]], torch.zeros_like(out[:3]))


@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("fanout,dim", [(1, 4), (10, 128), (10, 256),
                                        (40, 128), (33, 256), (17, 132)])
def test_neighbor_cache_coarse_grid_bit_equal(dev, agg, fanout, dim):
    """Features on a coarse grid, so every fp32 sum is exact: K2 gives the
    twin's bits, with one column chunk or more (D 256: two of a warp; D
    132: a lane of the second) and one slot chunk or more (fanout 17, 33,
    40; a column chunk's partial sum kept in the output between them). Nodes
    of degree 0 (5, 6, 699) get 0; the hub (node 11, degree > 200) draws
    ``fanout`` slots with replacement."""
    csr = _csr(dev, 3)
    g = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn((N, dim), generator=g, device=dev) * 4).round() / 2
    before = _build.launches["build_neighbor_cache"]
    out = build_neighbor_cache(csr, x, fanout=fanout, seed=9, hop_key=1,
                               agg=agg)
    torch.cuda.synchronize()
    assert _build.launches["build_neighbor_cache"] == before + 1
    want = torch.empty((N, dim), device=dev)
    _neighbor_cache_plain(csr, x, fanout, 9, 1, agg, None, want)
    assert torch.equal(out, want)
    assert torch.equal(out[[5, 6, 699]], torch.zeros_like(out[:3]))
    assert int(csr.indptr[12] - csr.indptr[11]) > fanout
    assert bool(out[11].abs().sum() > 0)


def test_gather_rows_modes_bit_equal(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.randint(-1, N, (N, 15), generator=g, device=dev,
                          dtype=torch.int32)
    frontier = torch.randint(0, N, (33, 4), generator=g, device=dev,
                             dtype=torch.int32)
    parent = torch.rand((33, 4), generator=g, device=dev) < 0.7
    got = expand_table(table, frontier, parent)
    want = _expand_table_plain(table, frontier, parent)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    fused = torch.randn((N, 2 * 24), generator=g, device=dev)
    deg = torch.rand(N, generator=g, device=dev)
    ids = torch.randint(0, N, (50, 7), generator=g, device=dev,
                        dtype=torch.int32)
    for table_ in (fused, fused[:, 24:], fused[:, :6],
                   fused.to(torch.bfloat16)):
        rows, vals = gather_rows(table_, ids, deg)
        prow, pval = _gather_rows_plain(table_, ids, deg)
        assert torch.equal(rows, prow) and torch.equal(vals, pval)
    rows, vals = gather_rows(fused, ids)
    assert vals is None and torch.equal(rows, fused[ids.long()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mean", "sum", "max"])
@pytest.mark.parametrize("shape", [
    (40, 15, 256), (9, 3, 8), (64, 40, 32), (33, 1, 64), (7, 16, 128),
    (5, 17, 32), (13, 15, "piece"), (512, 15, 256), (9, 70, 16),
    (8192, 10, 128), (6000, 17, 128)])
@pytest.mark.parametrize("data", ["random", "grid", "grid_mask_at_3"])
def test_masked_reduce_matches_plain(dev, dtype, op, shape, data):
    """Random values within the tolerances; values on a coarse grid (ties
    for max, every fp32 sum exact) bit-equal to the twin, also with the
    mask's first byte off an 8-byte boundary. ``piece``: a row of one
    16-byte piece (bf16 D 8, fp32 D 4). The two large grids take the
    form with one slot row in flight on an H100."""
    m, k, d = shape
    if d == "piece":
        d = 128 // torch.finfo(dtype).bits
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((m, k, d), generator=g, device=dev)
    if data != "random":
        x = (x * 4).round() / 2
    x = x.to(dtype)
    mask = torch.rand((m, k), generator=g, device=dev) < 0.6
    mask[:2] = False
    if data == "grid_mask_at_3":
        mask = torch.cat([torch.zeros(3, dtype=torch.bool, device=dev),
                          mask.reshape(-1)])[3:].view(m, k)
        assert mask.data_ptr() % 8 == 3
    before = _build.launches["masked_reduce"]
    got = masked_reduce(x, mask, op)
    torch.cuda.synchronize()
    assert _build.launches["masked_reduce"] == before + 1
    want = _masked_reduce_plain(x, mask, op)
    assert got.dtype == dtype and got.shape == (m, d)
    assert torch.equal(got[:2], torch.zeros_like(got[:2]))
    if data != "random":
        assert torch.equal(got, want)
    elif dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale
    assert torch.equal(masked_reduce(x, mask, op), got)


_K1B_CASES = [(1, 7, 0), (512, 100_000, 3_000_017), (513, 1, 5),
              (4096, 2**31 + 11, 2**32 - 1)] + [
    (count, n, 2**32 - 1) for count in (0, 1, 3, 4, 5, 511, 512, 513, 65_537)
    for n in (1, 7, 100_000, 2**31 + 11, 2**32 - 1)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("count,n,step", _K1B_CASES)
def test_uniform_ids_bit_equal(dev, count, n, step, offset):
    """Counts around a thread's 4 ids and a block's 512 (the ragged tail
    stored a value at a time), n up to 2**32 - 1 (ids past 2**31 wrap to
    negative int32), the hop at the wrap; ``offset`` 1: the C entry given
    an output view 4 bytes off a 16-byte boundary (one store a value),
    the words around it untouched. A count of 0 launches nothing."""
    before = _build.launches["uniform_ids"]
    if offset:
        buf = torch.full((count + 2,), -7, dtype=torch.int32, device=dev)
        got = buf[offset:offset + count]
        ptr = buf.data_ptr() + 4 * offset   # an empty view's is 0
        assert ptr % 16 == 4
        _build.launch("uniform_ids", "gigl_uniform_ids", dev, count, 3,
                      step, n, ptr)
        torch.cuda.synchronize()
        assert int(buf[0]) == -7 and int(buf[-1]) == -7
    else:
        got = uniform_ids(count, 3, step, n, dev)
        torch.cuda.synchronize()
        assert _build.launches["uniform_ids"] == before + (count > 0)
    want = _uniform_ids_plain(count, 3, step, n, dev)
    assert got.dtype == torch.int32 and got.shape == (count,)
    assert torch.equal(got, want)


def test_uniform_ids_waits_before_its_stores_into_a_reused_buffer(dev):
    """K1b's blocks start before the kernel ahead of them ends (a
    dependent launch); its output takes the memory of a buffer that a long
    PyTorch kernel is still writing when it was freed (the same pointer,
    from the caching allocator). A store before the wait would be
    overwritten by that kernel's later stores."""
    for count in ((1 << 24) + 5, 1 << 22, 512):
        src = torch.full((count,), -1, dtype=torch.int32, device=dev)
        want = _uniform_ids_plain(count, 9, 3_000_017, 100_000, dev)
        torch.cuda.synchronize()
        for _ in range(3):
            buf = torch.empty(count, dtype=torch.int32, device=dev)
            ptr = buf.data_ptr()
            torch.add(src, 0, out=buf)           # still writing buf
            del buf
            got = uniform_ids(count, 9, 3_000_017, 100_000, dev)
            assert got.data_ptr() == ptr
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            del got


def test_uniform_ids_keeps_stream_order_behind_k1(dev):
    """K1 (which lets a dependent launch start early) over a large
    frontier, K1b right behind it, then a PyTorch kernel that reads K1's
    draw: the draw it reads is complete, bit-equal to the twin's, and so
    are K1b's ids."""
    csr = _csr(dev)
    frontier = torch.arange(1 << 20, dtype=torch.int32, device=dev) % N
    want = _sample_uniform_plain(csr.indptr, csr.indices, frontier, 15, 4, 1)
    want_ids = _uniform_ids_plain(512, 4, 3_000_017, N, dev)
    for _ in range(3):
        ids, mask, slots = sample_uniform(csr.indptr, csr.indices, frontier,
                                          15, 4, 1)
        rand = uniform_ids(512, 4, 3_000_017, N, dev)
        read = (ids.clone(), mask.clone(), slots.clone())
        torch.cuda.synchronize()
        for g, w in zip(read, want):
            assert torch.equal(g, w)
        assert torch.equal(rand, want_ids)


def test_k1_k1b_pair_graph_replay_matches_eager(dev):
    """K1's draw of the positives then K1b (the dependent launch), as a
    NALP step runs them, captured in one CUDA graph and replayed with new
    anchors copied into the captured buffer: every replay's draw and ids
    are the eager calls' bits."""
    csr = _csr(dev)
    rng = np.random.default_rng(23)
    anchors = torch.empty(512, dtype=torch.int32, device=dev)

    def pair():
        ids, mask, slots = sample_uniform(csr.indptr, csr.indices, anchors,
                                          1, 0, 1_000_003)
        return ids, mask, slots, uniform_ids(512, 0, 3_000_017, N, dev)

    anchors.copy_(torch.from_numpy(rng.integers(0, N, 512).astype(np.int32)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pair()
    for _ in range(2):
        anchors.copy_(torch.from_numpy(rng.integers(0, N, 512).astype(
            np.int32)))
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        eager = pair()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)
        assert torch.equal(captured[3], _uniform_ids_plain(
            512, 0, 3_000_017, N, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mean", "sum", "max"])
@pytest.mark.parametrize("shape", [
    (40, 15, 256), (9, 3, 8), (64, 40, 32), (33, 1, 64), (7, 16, 128),
    (5, 17, 32), (13, 15, "piece"), (512, 15, 256), (9, 70, 16),
    (8192, 10, 128), (6000, 17, 128)])
@pytest.mark.parametrize("data", ["random", "grid", "grid_mask_at_3"])
def test_masked_reduce_bwd_matches_plain(dev, dtype, op, shape, data):
    """K4's shapes: K 1, 16, 17 and 70 (two mask words; x read twice for
    max past 16 slots), one-piece rows (``piece``: bf16 D 8, fp32 D 4),
    the flagship block, grids past what the card holds at once in small
    blocks, and the mask's first byte off an 8-byte boundary. Values on a
    coarse grid (ties for max) give the twin's bits; so do random ones
    (one division and one rounding on both sides), held within the
    tolerances."""
    m, k, d = shape
    if d == "piece":
        d = 128 // torch.finfo(dtype).bits
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((m, k, d), generator=g, device=dev)
    if data != "random":   # a coarse grid: the max has ties to share
        x = (x * 2).round()
    x = x.to(dtype)
    mask = torch.rand((m, k), generator=g, device=dev) < 0.6
    mask[:2] = False
    if data == "grid_mask_at_3":
        mask = torch.cat([torch.zeros(3, dtype=torch.bool, device=dev),
                          mask.reshape(-1)])[3:].view(m, k)
        assert mask.data_ptr() % 8 == 3
    out = masked_reduce(x, mask, op)
    grad_out = torch.randn((m, d), generator=g, device=dev).to(dtype)
    before = _build.launches["masked_reduce_bwd"]
    got = masked_reduce_bwd(grad_out, mask, op, x, out)
    torch.cuda.synchronize()
    assert _build.launches["masked_reduce_bwd"] == before + 1
    want = _masked_reduce_bwd_plain(grad_out, mask, op, x, out)
    assert got.dtype == dtype and got.shape == (m, k, d)
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
    if data != "random":
        assert torch.equal(got, want)
    elif dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
        assert float((got.float() - want.float()).abs().max()) <= ulp
    # Through autograd: masked_reduce's backward is K4b.
    xg = x.clone().requires_grad_()
    (auto,) = torch.autograd.grad(masked_reduce(xg, mask, op), xg, grad_out)
    assert torch.equal(auto, got)


def _retrieval_inputs(dev, q, c, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = (torch.randn((q, c), generator=g, device=dev) * 0.5).to(dtype)
    qids = torch.randint(0, max(q // 2, 1), (q,), generator=g, device=dev,
                         dtype=torch.int32)
    cids = torch.randint(0, max(c // 3, 1), (c,), generator=g, device=dev,
                         dtype=torch.int32)
    cmask = torch.rand(c, generator=g, device=dev) < 0.8
    qmask = torch.rand(q, generator=g, device=dev) < 0.8
    qmask[:c] &= cmask[:q]   # a query whose positive column is masked is too
    return scores, RetrievalMasks(
        temperature=0.07, query_ids=qids, candidate_ids=cids,
        remove_accidental_hits=True, query_mask=qmask, candidate_mask=cmask)


def _offset_masks(masks):
    """The same masks, each optional [N] term a view that starts one
    element past its storage's start (off a 16-byte boundary)."""
    def shifted(t):
        if t is None:
            return None
        return torch.cat([t[:1], t])[1:]
    return dataclasses.replace(
        masks, query_ids=shifted(masks.query_ids),
        candidate_ids=shifted(masks.candidate_ids),
        query_mask=shifted(masks.query_mask),
        candidate_mask=shifted(masks.candidate_mask),
        candidate_sampling_probability=shifted(
            masks.candidate_sampling_probability))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,c,case", [
    (1, 1, "ids"), (1, 40, "ids"), (64, 64, "ids"), (50, 77, "ids"),
    (512, 1024, "ids"), (33, 70, "none"), (40, 20, "none"),
    (16, 48, "all_masked_row"), (5, 7, "ids"), (3, 6, "none"),
    (6, 12, "ids"), (9, 1500, "ids"), (7, 2056, "ids"), (37, 96, "cmask"),
    (30, 64, "qids"), (50, 77, "offset"), (512, 1024, "offset")])
def test_retrieval_loss_matches_plain(dev, dtype, q, c, case):
    """``cmask``: the masks without ids; ``qids``: query ids without the
    accidental hits; ``offset``: every term off a 16-byte boundary."""
    scores, masks = _retrieval_inputs(dev, q, c, dtype)
    if case == "none":
        masks = RetrievalMasks(temperature=0.5)
    elif case == "cmask":
        masks = RetrievalMasks(temperature=0.07,
                               query_mask=masks.query_mask,
                               candidate_mask=masks.candidate_mask)
    elif case == "qids":
        masks = RetrievalMasks(temperature=0.07, query_ids=masks.query_ids)
    elif case == "offset":
        masks = _offset_masks(masks)
        assert masks.candidate_ids.data_ptr() % 16 != 0
    elif case == "all_masked_row":
        # Row 0's candidates are all duplicates or masked; the row is a
        # padded query, as the trainer makes it.
        cmask = masks.candidate_mask.clone()
        cmask[0] = False
        qmask = masks.query_mask.clone()
        qmask[0] = False
        cids = masks.candidate_ids.clone()
        cids[:] = torch.where(cmask, cids[0], cids)
        masks = RetrievalMasks(
            temperature=0.07, query_ids=masks.query_ids, candidate_ids=cids,
            remove_accidental_hits=True, query_mask=qmask,
            candidate_mask=cmask)
    before = _build.launches["retrieval_loss"]
    loss, count, lse, ce = retrieval_fwd(scores, masks)
    gscale = torch.tensor(0.37, device=dev)
    ds = retrieval_bwd(scores, masks, lse, gscale)
    torch.cuda.synchronize()
    assert _build.launches["retrieval_loss"] == before + 2
    wloss, wcount, wlse, wce = _retrieval_fwd_plain(scores, masks)
    wds = _retrieval_bwd_plain(scores, masks, wlse, gscale)
    assert int(count) == int(wcount)
    assert abs(float(loss) - float(wloss)) <= 1e-5 * max(abs(float(wloss)),
                                                        1e-30)
    torch.testing.assert_close(ce, wce, rtol=1e-5, atol=1e-5)
    assert ds.dtype == dtype and ds.shape == (q, c)
    scale = float(wds.float().abs().max())
    tol = (1e-5 * scale if dtype == torch.float32 or scale == 0
           else 2.0 ** (np.floor(np.log2(scale)) - 7))
    assert float((ds.float() - wds.float()).abs().max()) <= tol
    # Three repeat calls: the same bits (fixed-order sums), and each leaves
    # the forward's ticket counter at 0.
    assert forward_ticket(dev) == 0
    for _ in range(3):
        again = retrieval_fwd(scores, masks)
        assert forward_ticket(dev) == 0
        for a, b in zip(again, (loss, count, lse, ce)):
            assert torch.equal(a, b)
        assert torch.equal(retrieval_bwd(scores, masks, again[2], gscale), ds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("logq", [False, True])
@pytest.mark.parametrize("q,c", [(512, 1024), (50, 77)])
def test_retrieval_loss_graph_replay_matches_eager(dev, dtype, logq, q, c):
    """K5's forward and backward captured in a CUDA graph (three of each,
    back to back), replayed twice: every replay's outputs are the eager
    calls' bits, and the ticket counter is 0 after each replay."""
    scores, masks = _retrieval_inputs(dev, q, c, dtype, seed=5)
    if logq:
        g = torch.Generator(device=dev).manual_seed(6)
        masks = dataclasses.replace(
            masks, candidate_sampling_probability=torch.rand(
                c, generator=g, device=dev) / 50)
    gscale = torch.tensor(0.37, device=dev)

    def step():
        outs = []
        for _ in range(3):
            loss, count, lse, ce = retrieval_fwd(scores, masks)
            outs.append((loss, count, lse, ce,
                         retrieval_bwd(scores, masks, lse, gscale)))
        return outs

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for _ in range(2):
        for outs in captured:
            for t in outs:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert forward_ticket(dev) == 0
        for got, want in zip(captured, eager):
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_wrappers_raise_on_what_kernels_do_not_take(dev):
    x = torch.randn((4, 3, 8), device=dev)
    mask = torch.ones((4, 3), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        masked_reduce(x[..., :6].contiguous(), mask, "mean")
    with pytest.raises(ValueError, match="contiguous"):
        masked_reduce(x.transpose(0, 1), mask.T, "mean")
    with pytest.raises(ValueError, match="int32"):
        gather_rows(x[:, 0], torch.zeros(2, dtype=torch.int64, device=dev))
    csr = _csr(dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        build_neighbor_cache(csr, torch.randn((N, 6), device=dev), fanout=3)
    with pytest.raises(ValueError, match="forward's x"):
        masked_reduce_bwd(x[:, 0], mask, "max")
    scores, masks = _retrieval_inputs(dev, 8, 16, torch.float32)
    with pytest.raises(ValueError, match="query_ids"):
        retrieval_fwd(scores, RetrievalMasks(
            query_ids=masks.query_ids.long()))
    with pytest.raises(ValueError, match="C >= Q"):
        retrieval_fwd(scores.T.contiguous(), RetrievalMasks(
            query_ids=torch.zeros(16, dtype=torch.int32, device=dev)))
    with pytest.raises(ValueError, match="out of range"):
        uniform_ids(4, 0, 0, 0, dev)


def _ell_inputs(dev, n, w, m, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, d), generator=g, device=dev).to(dtype)
    nbr = torch.randint(0, m, (n, w), generator=g, device=dev,
                        dtype=torch.int32)
    mask = torch.rand((n, w), generator=g, device=dev) < 0.7
    if n > 2:
        mask[1] = False                      # an all-masked row
        mask[2, : min(w, 5000)] = True       # a hub row (degree 5000 at 8192)
        mask[2, 5000:] = False
    nbr = torch.where(mask, nbr, 0)          # masked slots point at row 0
    deg = torch.randint(0, 60, (m,), generator=g, device=dev).float()
    return x, nbr, mask, deg


def _within(got, want, dtype, floor=1e-30):
    scale = max(float(want.float().abs().max()), floor)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)


def _k6_graph(dev, case, d, dtype, seed=0):
    """An ELL graph for K6, its input rows and an edge table: ``hub``
    (a 5,000-in-degree row in a width-8192 bucket, empty buckets between,
    degree-0 rows), ``random`` (3,000 nodes, 60,000 edges: buckets 4 to
    64), ``odd_widths`` (widths 3, 6, 13, 50: ids one at a time),
    ``misaligned`` (``random`` with its entry tables and x 4 bytes off a
    16-byte boundary: ids one at a time, one value a thread), ``one_row``
    (a single node with a self-loop) and ``many_buckets`` (widths 1 to 60,
    59 holding rows: more buckets than one launch's segment table, so two
    launches)."""
    rng = np.random.default_rng(seed)
    n, e = {"hub": (700, 6000), "one_row": (1, 1)}.get(case, (3000, 60000))
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if case == "many_buckets":                    # node v: in-degree v % 60
        n = 700
        dst = np.repeat(np.arange(n), np.arange(n) % 60)
        src = rng.integers(0, n, len(dst))
    if case == "hub":
        keep = (dst != 1) & (dst != 2)            # degree-0 rows
        src = np.concatenate([src[keep], rng.integers(0, n, 5000)])
        dst = np.concatenate([dst[keep], np.full(5000, 7)])
    widths = {"odd_widths": (3, 6, 13, 50),
              "many_buckets": tuple(range(1, 61))}.get(case)
    ell = EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=n),
                            widths=widths, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    ea = torch.randn((len(src), d), generator=g, device=dev).to(dtype)
    if case == "misaligned":
        def off(t):
            return torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(
                t.shape)
        ell = dataclasses.replace(ell, ent_src=off(ell.ent_src),
                                  ent_edge=off(ell.ent_edge))
        x, ea = off(x), off(ea)
        assert ell.ent_src.data_ptr() % 16 and x.data_ptr() % 16
    return ell, x, ea


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mean", "sum", "max", "gcn", "gine",
                                "gine_edges"])
@pytest.mark.parametrize("case,d", [("hub", 64), ("random", 256),
                                    ("odd_widths", 128), ("random", 12),
                                    ("misaligned", 128), ("one_row", 8),
                                    ("many_buckets", 16)])
def test_ell_aggregate_matches_plain(dev, dtype, op, case, d):
    """K6 over every bucket of a graph in one launch (one per
    MAX_SEGMENTS non-empty buckets past that many) against its plain
    twin; a range of rows across buckets gives the whole call's rows bit
    for bit; degree-0 rows give 0."""
    ell, x, ea = _k6_graph(dev, case, d, dtype)
    mode, ea = ("gine", ea) if op == "gine_edges" else (op, None)
    before = _build.launches["ell_aggregate"]
    got = _ell_aggregate_fwd(x, ell, mode, ea=ea)
    torch.cuda.synchronize()
    parts = sum(hi > lo for lo, hi in zip(ell.boundaries,
                                          ell.boundaries[1:]))
    assert parts > MAX_SEGMENTS if case == "many_buckets" else parts >= 1
    assert _build.launches["ell_aggregate"] == before + -(-parts
                                                          // MAX_SEGMENTS)
    want = _ell_aggregate_graph_plain(x, ell, mode, ea)
    assert got.dtype == dtype and got.shape == (ell.num_nodes, d)
    assert not got[ell.deg_p == 0].any()
    _within(got, want, dtype, floor=1.0)
    lo, hi = ell.boundaries[1] // 2, (ell.boundaries[-2]
                                      + ell.boundaries[-1] + 1) // 2
    part = _ell_aggregate_fwd(x, ell, mode, ea=ea, rows=(lo, hi))
    assert torch.equal(part, got[lo:hi])
    assert torch.equal(_ell_aggregate_fwd(x, ell, mode, ea=ea), got)


@pytest.mark.parametrize("op", ["mean", "sum", "max", "gcn", "gine",
                                "gine_edges"])
def test_ell_aggregate_graph_gradients_on_card_match_cpu(dev, op):
    """EllAggregateGraph (one K6 launch forward, K6b / K11 backward) on the
    card against the CPU: the output and the gradients of x and of the
    edge rows, fp32 within 1e-5 of each one's scale."""
    out = {}
    cpu = torch.device("cpu")
    _, x0, ea0 = _k6_graph(cpu, "hub", 16, torch.float32, seed=3)
    for device in (cpu, dev):
        ell = _k6_graph(device, "hub", 16, torch.float32, seed=3)[0]
        x = x0.to(device, copy=True).requires_grad_()
        ea = ea0.to(device, copy=True).requires_grad_() \
            if op == "gine_edges" else None
        mode = "gine" if op == "gine_edges" else op
        y = ell_aggregate_graph(x, ell, mode, ea=ea)
        w = torch.linspace(-1, 1, y.numel(), device=device).view(y.shape)
        (y * w).sum().backward()
        out[device.type] = [t.detach().cpu() for t in (
            y, x.grad, *(() if ea is None else (ea.grad,)))]
    for k, w in zip(out["cuda"], out["cpu"]):
        assert float((k - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["gat", "gatv2", "transformer"])
@pytest.mark.parametrize("n,w,m,heads,dh", [
    (1, 4, 50, 4, 64), (300, 32, 1000, 4, 32), (37, 64, 400, 4, 64),
    (5, 8192, 6000, 4, 32), (20, 100, 90, 3, 5),
    # head dim 4: 8 slots a warp (fp32; bf16 in 8-byte pieces), the W 4 and
    # W 8 buckets (several rows a warp), a width-8192 hub row, and a bucket
    # whose rows are all masked (n = 0 below marks it)
    (300, 32, 1000, 4, 4), (37, 4, 400, 4, 4), (37, 8, 400, 4, 4),
    (5, 8192, 6000, 4, 4), (0, 16, 100, 4, 4)])
def test_fanout_attention_matches_plain(dev, dtype, mode, n, w, m, heads,
                                        dh):
    all_masked = n == 0
    n = 24 if all_masked else n
    _, nbr, mask, _ = _ell_inputs(dev, n, w, m, 8, dtype)
    if all_masked:
        mask = torch.zeros_like(mask)
        nbr = torch.zeros_like(nbr)
    g = torch.Generator(device=dev).manual_seed(1)
    hd = heads * dh
    xd, ks, vs = (torch.randn(s, generator=g, device=dev).to(dtype)
                  for s in ((n, hd), (m, hd), (m, hd)))
    att, att2 = (torch.randn((heads, dh), generator=g, device=dev) * 0.3
                 for _ in range(2))
    atts = {"gat": (att, att2), "gatv2": (att, None),
            "transformer": (None, None)}[mode]
    flat = [None if a is None else a.reshape(-1) for a in atts]
    before = _build.launches["fanout_attention"]
    got = _fanout_attention_fwd(xd, ks, vs, nbr, mask, mode, heads, *flat,
                                0.2)
    torch.cuda.synchronize()
    assert _build.launches["fanout_attention"] == before + 1
    want = _fanout_attention_plain(xd, ks, vs, nbr, mask, mode, heads, *flat)
    assert got.dtype == dtype and got.shape == (n, hd)
    if n > 2:
        assert not got[1].any()
    if all_masked:
        assert not got.any()
    _within(got, want, dtype)


def test_full_graph_inference_on_card_matches_cpu(dev):
    """encode_ell on the card (K3, K6, K7) against the CPU's plain twins,
    fp32, for SAGE, GCN, GAT and Transformer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    src = np.concatenate([src, rng.integers(0, N, 300)])
    dst = np.concatenate([dst, np.full(300, 9)])            # a hub
    x = rng.normal(size=(N, 16)).astype(np.float32)
    csr = build_csr(src, dst, num_anchor_nodes=N)
    for conv in ("graphsage", "gcn", "gat", "transformer"):
        kw = {"heads": 4} if conv in ("gat", "transformer") else None
        out = {}
        for device in (dev, torch.device("cpu")):
            _build.reset_launches()
            enc = GNNEncoder(16, 32, 16, conv=conv, conv_kwargs=kw)
            init_params(enc, 0)
            enc.to(device)
            ell = EllGraph.from_csr(csr, device=device)
            with torch.inference_mode():
                out[device.type] = enc.encode_ell(
                    torch.from_numpy(x).to(device), ell).cpu()
            if device.type == "cuda":
                kern = ("fanout_attention" if conv in ("gat", "transformer")
                        else "ell_aggregate")
                assert _build.launches[kern] > 0 and \
                    _build.launches["gather_rows"] == 2, _build.launches
        torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                                   atol=1e-4)


def test_inference_on_card_matches_cpu(dev):
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    embs = {}
    for device in (dev, torch.device("cpu")):
        g = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
            src=src, dst=dst, num_nodes=N, node_features=x), device=device)
        model = LinkPredictionGNN(GNNEncoder(16, 32, 16),
                                  LinkPredictionDecoder())
        t = NALPTrainer(model, g, NALPTrainerConfig(
            fanouts=(4, 3), cached_hop=True, fused_cache=True), device=device)
        t.init_params(0)
        out = []

        class Sink:
            def add_embeddings(self, ids, emb):
                out.append(emb)

            def flush(self):
                pass

        run_inference(t, N, Sink(), InferenceConfig(batch_size=64),
                      device=device)
        embs[device.type] = np.concatenate(out)
    np.testing.assert_allclose(embs["cuda"], embs["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_two_train_steps_on_card_match_cpu(dev):
    """fp32 (full-precision matmuls): the same two steps from the same
    weights on the card and on the CPU, every kernel launched on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    anchors = rng.integers(0, N, (2, 64))
    out = {}
    for device in (dev, torch.device("cpu")):
        _build.reset_launches()
        g = DeviceGraph.from_hetero(
            HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                    node_features=x),
            supervision_edges=np.stack([src, dst]), device=device)
        t = NALPTrainer(LinkPredictionGNN(GNNEncoder(16, 32, 16),
                                          LinkPredictionDecoder()),
                        g, NALPTrainerConfig(fanouts=(4, 3), cached_hop=True,
                                             fused_cache=True,
                                             num_random_negs=64),
                        optimizer_args={"learning_rate": "0.01"},
                        device=device)
        state = t.init_state(0)
        state, losses = t.train_steps(state, anchors)
        out[device.type] = (losses.cpu(), {k: v.cpu() for k, v in
                                           t.model.state_dict().items()})
        if device.type == "cuda":
            assert all(_build.launches[k] > 0 for k in TRAINING_KERNELS), \
                _build.launches
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, rtol=1e-4, atol=1e-5)


def _hub_graph(n, seed=0, hub_out=5000):
    """A directed graph on n nodes: random edges, nodes 0..2 without
    out-edges (node 1 isolated), node 3 an out-hub of degree ``hub_out``
    (a transpose bucket of width 8192 at 5000)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, n, 6 * n)
    dst = rng.integers(0, n, 6 * n)
    keep = dst != 1
    hub = rng.choice(np.arange(n)[np.arange(n) != 1], min(hub_out, n - 1),
                     replace=False)
    return (np.concatenate([src[keep], np.full(len(hub), 3)]),
            np.concatenate([dst[keep], hub]))


def _ell(dev, n, seed=0, hub_out=5000):
    src, dst = _hub_graph(n, seed, hub_out)
    return EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=n), device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mean", "sum", "max", "gcn", "weighted",
                                "weighted_vec", "gatv2"])
@pytest.mark.parametrize("n,d,heads", [(6000, 128, 4), (6000, 12, 3),
                                       (700, 16, 4), (700, 256, 4)])
def test_ell_transpose_matches_plain(dev, dtype, op, n, d, heads):
    ell = _ell(dev, n, hub_out=5000 if n > 5000 else 400)
    assert max(ell.t_widths) >= (8192 if n > 5000 else 512)
    g = torch.Generator(device=dev).manual_seed(4)
    rows = torch.randn((n, d), generator=g, device=dev).to(dtype)
    p = ell.ent_row.shape[0]
    wt = wt2 = vec = rows2 = table = None
    if op in ("weighted", "weighted_vec", "gatv2"):
        wt = torch.randn((p, heads), generator=g, device=dev)
        if op != "weighted":
            wt2 = torch.randn((p, heads), generator=g, device=dev)
            vec = torch.randn(d, generator=g, device=dev)
        if op == "gatv2":
            rows2, table = (torch.randn((n, d), generator=g, device=dev)
                            .to(dtype) for _ in range(2))
    if op == "max":     # a coarse grid, so the max has ties; K6's max
        table = (torch.randn((n, d), generator=g, device=dev) * 2).round()
        table = table.to(dtype)
        rows2 = ell_aggregate_graph(table, ell, "max")
    mode = mode_of(op)
    before = _build.launches["ell_transpose_aggregate"]
    got = ell_transpose_aggregate(rows, ell, mode, wt, wt2, vec, heads,
                                  rows2=rows2, table=table)
    torch.cuda.synchronize()
    nonempty = sum(hi > lo for lo, hi in zip(ell.t_boundaries,
                                             ell.t_boundaries[1:]))
    if op == "max":     # the tie counts: one launch per forward bucket
        nonempty += sum(hi > lo for lo, hi in zip(ell.boundaries,
                                                  ell.boundaries[1:]))
    assert _build.launches["ell_transpose_aggregate"] == before + nonempty
    want = _ell_transpose_plain(rows, ell, mode, wt, wt2, vec, heads, rows2,
                                table)
    assert got.dtype == dtype and got.shape == (n, d)
    sinks = ell.rank[:3].long()               # no out-edges: exactly 0
    assert not got[sinks].any()
    _within(got, want, dtype)


def mode_of(op):
    """K6b's mode for a test case name."""
    return "weighted" if op.startswith("weighted") else op


def _attention_case(dev, dtype, mode, n, w, m, heads, dh, identity):
    _, nbr, mask, _ = _ell_inputs(dev, n, w, m, 8, dtype)
    if identity:
        nbr = torch.arange(n * w, dtype=torch.int32,
                           device=dev).reshape(n, w)
        m = n * w
    g = torch.Generator(device=dev).manual_seed(2)
    hd = heads * dh
    xd, ks, vs, gout = (torch.randn(s, generator=g, device=dev).to(dtype)
                        for s in ((n, hd), (m, hd), (m, hd), (n, hd)))
    if mode != "transformer":
        vs = ks
    att, att2 = (torch.randn(hd, generator=g, device=dev) * 0.3
                 for _ in range(2))
    att, att2 = {"gat": (att, att2), "gatv2": (att, None),
                 "transformer": (None, None)}[mode]
    stats = torch.empty((n, heads, 2), dtype=torch.float32, device=dev)
    out = _fanout_attention_fwd(xd, ks, vs, nbr, mask, mode, heads, att,
                                att2, 0.2, stats=stats)
    return xd, ks, vs, nbr, mask, gout, att, att2, out, stats


ATTENTION_BWD_SHAPES = [
    (identity, *shape)
    for identity in (False, True)
    for shape in ((1, 4, 50, 4, 64), (300, 32, 1000, 4, 64),
                  (300, 32, 1000, 4, 4), (5, 8192, 6000, 4, 16),
                  (20, 16, 90, 3, 5), (37, 4, 400, 4, 4))
    if not identity or shape[1] <= 64]     # a dense block is a fanout wide


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["gat", "gatv2", "transformer"])
@pytest.mark.parametrize("identity,n,w,m,heads,dh", ATTENTION_BWD_SHAPES)
def test_fanout_attention_bwd_matches_plain(dev, dtype, mode, identity, n,
                                            w, m, heads, dh):
    xd, ks, vs, nbr, mask, gout, att, att2, out, stats = _attention_case(
        dev, dtype, mode, n, w, m, heads, dh, identity)
    same = mode != "transformer"
    before = _build.launches["fanout_attention_bwd"]
    got = fanout_attention_bwd(gout, xd, ks, vs, nbr, mask, out, stats, mode,
                               heads, att, att2, 0.2, identity=identity,
                               same_table=same)
    torch.cuda.synchronize()
    assert _build.launches["fanout_attention_bwd"] == before + 1
    want = _fanout_attention_bwd_plain(gout, xd, ks, vs, nbr, mask, out,
                                       mode, heads, att, att2, 0.2, identity,
                                       same)
    assert got.d_xd.dtype == dtype
    if n > 2:
        assert not got.d_xd[1].any()          # an all-masked row
    for name in ("d_xd", "alpha", "coef", "d_ks", "d_vs", "d_att"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape, name
            # floored at 1, the size of the unit-normal inputs: a row with
            # one valid slot has d_logit = g·v - g·out = 0 exactly, which
            # the kernel's and the twin's sums leave at a few fp32 ulps
            _within(a, b, dtype, floor=1.0)
    if not identity:
        valid = mask.reshape(-1)
        assert not got.alpha[~valid].any() and not got.coef[~valid].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["gat", "gatv2", "transformer"])
@pytest.mark.parametrize("dh", [4, 64])
def test_fanout_attention_repeat_runs_are_bit_equal(dev, dtype, mode, dh):
    """K7 and K7b run twice on the same inputs give the same bits: out and
    stats, and K7b's d_xd, d_att and per-entry alpha / coef (the ELL
    layout) and d_ks (the dense-block layout). K7b's d_att sums per-warp
    partials in a fixed order, with no float atomics."""
    same = mode != "transformer"
    for identity in (False, True):
        xd, ks, vs, nbr, mask, gout, att, att2, out, stats = _attention_case(
            dev, dtype, mode, 300, 32, 1000, 4, dh, identity)
        out2 = torch.empty_like(out)
        stats2 = torch.empty_like(stats)
        _fanout_attention_fwd(xd, ks, vs, nbr, mask, mode, 4, att, att2, 0.2,
                              out=out2, stats=stats2)
        assert torch.equal(out, out2) and torch.equal(stats, stats2)
        a, b = (fanout_attention_bwd(gout, xd, ks, vs, nbr, mask, out,
                                     stats, mode, 4, att, att2, 0.2,
                                     identity=identity, same_table=same)
                for _ in range(2))
        torch.cuda.synchronize()
        for name in ("d_xd", "alpha", "coef", "d_ks", "d_att"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            assert x is None or torch.equal(x, y), name


def _small_graph(seed=5):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    src = np.concatenate([src, np.full(300, 9)])           # an out-hub
    dst = np.concatenate([dst, rng.integers(0, N, 300)])
    keep = ~np.isin(src, (1, 2))                           # no out-edges
    return (src[keep], dst[keep], rng.normal(size=(N, 16)).astype(np.float32),
            rng.integers(0, 6, N))


def test_encode_ell_gradients_on_card_match_cpu(dev):
    """ROADMAP C3: encode_ell on the card has a grad_fn and gives the CPU's
    parameter gradients (fp32), through K3 both ways, K6 / K6b or K7 / K7b
    / K6b; layer 1 of SAGE launches no K6b (its input needs no gradient)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, x, _ = _small_graph()
    csr = build_csr(src, dst, num_anchor_nodes=N)
    for conv, kw in (("graphsage", None), ("graphsage", {"aggr": "max"}),
                     ("gcn", None), ("gin", None), ("gat", {"heads": 4}),
                     ("gatv2", {"heads": 4}), ("transformer", {"heads": 4})):
        grads = {}
        for device in (dev, torch.device("cpu")):
            enc = GNNEncoder(16, 32, 8, conv=conv, conv_kwargs=kw)
            init_params(enc, 0)
            enc.to(device)
            ell = EllGraph.from_csr(csr, device=device)
            w = torch.from_numpy(np.random.default_rng(2).normal(
                size=(N, 8)).astype(np.float32)).to(device)
            _build.reset_launches()
            out = enc.encode_ell(torch.from_numpy(x).to(device), ell)
            assert out.grad_fn is not None, device
            (out * w).sum().backward()
            grads[device.type] = {k: p.grad.cpu()
                                  for k, p in enc.named_parameters()}
            if device.type == "cuda":
                nonempty = sum(hi > lo for lo, hi in zip(
                    ell.t_boundaries, ell.t_boundaries[1:]))
                if kw == {"aggr": "max"}:   # + tie counts per bucket
                    nonempty += sum(hi > lo for lo, hi in zip(
                        ell.boundaries, ell.boundaries[1:]))
                if conv in ("gat", "gatv2", "transformer"):
                    assert _build.launches["fanout_attention_bwd"] > 0
                else:      # once, for layer 2 only
                    assert _build.launches["ell_transpose_aggregate"] == \
                        nonempty, _build.launches
                assert _build.launches["gather_rows"] == 3  # 2 fwd + 1 bwd
        # a gradient that is 0 by symmetry (the Transformer's key bias) is
        # held to 1e-4 of 1e-2 of the model's largest gradient
        floor = 1e-2 * max(float(v.abs().max())
                           for v in grads["cpu"].values())
        for k, v in grads["cpu"].items():
            err = float((grads["cuda"][k] - v).abs().max())
            scale = max(float(v.abs().max()), floor)
            assert err <= 1e-4 * scale, (conv, k, err, scale)


def test_node_classification_steps_on_card_match_cpu(dev):
    """Three fp32 full-batch steps (SAGE, GAT) and three sampled NC steps
    (SAGE, GAT) on the card against the same steps on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, x, labels = _small_graph(6)
    graph = HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                    node_features=x, node_labels=labels)
    nodes = np.random.default_rng(1).integers(0, N, (3, 64))
    for conv, kw in (("graphsage", None), ("gat", {"heads": 4})):
        out = {}
        for device in (dev, torch.device("cpu")):
            data = full_batch_data_from_graph(graph, device=device)
            t = FullBatchTrainer(GNNEncoder(16, 32, 8, conv=conv,
                                            conv_kwargs=kw), data,
                                 optimizer_args={"learning_rate": "0.01"},
                                 device=device)
            st = t.init_state(0)
            fb_losses = []
            for _ in range(3):
                st, loss = t.train_step(st)
                fb_losses.append(float(loss))
            nc = NodeClassificationTrainer(
                GNNEncoder(16, 32, 8, conv=conv, conv_kwargs=kw),
                DeviceGraph.from_hetero(graph, device=device),
                NodeClassificationTrainerConfig(fanouts=(5, 3)),
                optimizer_args={"learning_rate": "0.01"}, device=device)
            st = nc.init_state(0)
            nc_losses = []
            for k in range(3):
                st, loss = nc.train_step(st, nodes[k])
                nc_losses.append(float(loss))
            out[device.type] = (fb_losses, nc_losses,
                                {k: v.cpu() for k, v in
                                 nc.model.state_dict().items()})
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
        for k, v in out["cpu"][2].items():
            torch.testing.assert_close(out["cuda"][2][k], v, rtol=1e-4,
                                       atol=1e-5)


def _segment_graph(dev, s=3000, e=20000, hub_deg=10_000, seed=0):
    """Segment ids on the card with 100 empty segments, 50 of degree 1 and
    one hub segment (5) of degree ``hub_deg``, shuffled; and the index."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, s - 150, e),
                          np.arange(s - 150, s - 100),
                          np.full(hub_deg, 5)])
    ids = torch.as_tensor(rng.permutation(ids).astype(np.int32), device=dev)
    return ids, SegmentIndex.from_ids(ids, s)


SEGMENT_CASES = [  # (C, heads of the weight, gather rows or per-edge data)
    (128, 0, True), (128, 1, True), (128, 4, True), (128, 4, False),
    (12, 3, True), (4, 1, False), (64, 2, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("c,w_heads,gather", SEGMENT_CASES)
def test_segment_reduce_matches_plain(dev, dtype, op, c, w_heads, gather):
    ids, index = _segment_graph(dev)
    s, e = index.num_segments, index.num_edges
    g = torch.Generator(device=dev).manual_seed(1)
    m = 5000 if gather else e
    x = torch.randn((m, c), generator=g, device=dev).to(dtype)
    src = (torch.randint(0, m, (e,), generator=g, device=dev,
                         dtype=torch.int32) if gather else None)
    w = None
    if w_heads:
        w = torch.rand((e, w_heads) if w_heads > 1 else (e,), generator=g,
                       device=dev)
    got = segment_reduce(x, ids, s, op=op, src=src, weight=w, index=index)
    want = _segment_reduce_plain(x, ids, s, op, src, w)
    assert got.dtype == dtype and got.shape == (s, c)
    _within(got, want, dtype)
    assert not got[s - 100:].any()                # empty segments give 0
    again = segment_reduce(x, ids, s, op=op, src=src, weight=w, index=index)
    assert torch.equal(got, again)                # no atomics: same bits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 4])
def test_segment_softmax_matches_plain(dev, dtype, heads):
    ids, index = _segment_graph(dev)
    s, e = index.num_segments, index.num_edges
    g = torch.Generator(device=dev).manual_seed(2)
    shape = (e,) if heads == 1 else (e, heads)
    logits = (torch.randn(shape, generator=g, device=dev) * 4).to(dtype)
    got = segment_softmax(logits, ids, s, index=index)
    want = _segment_softmax_plain(logits, ids, s)
    assert got.dtype == dtype and got.shape == shape
    # alpha <= 1; the hub's denominator sums 10^4 exps in fp32 in another
    # order (the twin: atomics), ~2e-5 relative apart
    tol = 5e-5 if dtype == torch.float32 else 2.0 ** -8
    err = (got.float() - want.float()).abs()
    worst = int(err.reshape(e, -1).amax(1).argmax())
    assert float(err.max()) <= tol, (
        float(err.max()), worst, int(ids[worst]), got[worst].tolist(),
        want[worst].tolist())
    assert torch.equal(got, segment_softmax(logits, ids, s, index=index))
    # no index: one is built on the host first, with the same result
    assert torch.equal(got, segment_softmax(logits, ids, s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dk", [(4, 32), (1, 128), (4, 3), (2, 64),
                                      (1, 8)])
@pytest.mark.parametrize("scaled", [False, True])
def test_sddmm_matches_plain(dev, dtype, heads, dk, scaled):
    ids, _ = _segment_graph(dev)
    e = ids.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((3000, heads, dk), generator=g, device=dev).to(dtype)
    k = torch.randn((4000, heads, dk), generator=g, device=dev).to(dtype)
    src = torch.randint(0, 4000, (e,), generator=g, device=dev,
                        dtype=torch.int32)
    scale = (torch.rand(heads, generator=g, device=dev) + 0.5
             if scaled else None)
    got = sddmm(src, ids, q, k, scale=scale)
    want = _sddmm_plain(src, ids, q, k, scale)
    assert got.dtype == dtype and got.shape == (e, heads)
    _within(got, want, dtype)
    flat = sddmm(src, ids, q[:, 0], k[:, 0])      # [N, D] -> [E]
    assert flat.shape == (e,)
    _within(flat, _sddmm_plain(src, ids, q[:, 0], k[:, 0]), dtype)


def _walk_graph(dev, seed=0):
    """Segment ids on the card, shuffled: segments 0-4 of 0, 1, 31, 33 and
    5,000 edges, 5-9 empty, the rest random; 19,076 edges (not a multiple
    of 32); and the index."""
    rng = np.random.default_rng(seed)
    s = 2000
    ids = np.concatenate([rng.integers(10, s, 14_011)]
                         + [np.full(d, seg) for seg, d in
                            enumerate((0, 1, 31, 33, 5000))])
    ids = torch.as_tensor(rng.permutation(ids).astype(np.int32), device=dev)
    return ids, SegmentIndex.from_ids(ids, s)


def _shifted(t, nbytes=4):
    """A copy of t whose storage starts ``nbytes`` past a 16-byte
    boundary (an unaligned table)."""
    n = t.numel() * t.element_size()
    raw = torch.empty(n + 32, dtype=torch.uint8, device=t.device)
    start = (-raw.data_ptr()) % 16 + nbytes
    out = raw[start:start + n].view(t.dtype).reshape(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == nbytes
    return out


WALK_HEADS = [(1, 3), (4, 3), (1, 4), (4, 4), (4, 8), (1, 32), (4, 32),
              (4, 64), (1, 128), (4, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dk", WALK_HEADS)
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
def test_sddmm_walk_matches_plain(dev, dtype, heads, dk, scaled, shifted):
    """K10 walks the destination index: each score lands at its edge's own
    position (edge order shuffled) over segments of 0, 1, 31, 33 and 5,000
    edges; Dh 3 in bf16 has no lane map (the scalar code); tables 4 bytes
    past a 16-byte boundary take 4-byte pieces. One launch, the same bits
    on a repeat launch."""
    ids, index = _walk_graph(dev)
    e, s = index.num_edges, index.num_segments
    g = torch.Generator(device=dev).manual_seed(14)
    q = torch.randn((s, heads, dk), generator=g, device=dev).to(dtype)
    k = torch.randn((3000, heads, dk), generator=g, device=dev).to(dtype)
    src = torch.randint(0, 3000, (e,), generator=g, device=dev,
                        dtype=torch.int32)
    scale = (torch.rand(heads, generator=g, device=dev) + 0.5
             if scaled else None)
    if shifted:
        q, k = _shifted(q), _shifted(k)
    before = _build.launches["sddmm"]
    got = sddmm(src, ids, q, k, scale=scale, index=index)
    torch.cuda.synchronize()
    assert _build.launches["sddmm"] == before + 1
    want = _sddmm_plain(src, ids, q, k, scale)
    assert got.dtype == dtype and got.shape == (e, heads)
    _within(got, want, dtype)
    assert torch.equal(got, sddmm(src, ids, q, k, scale=scale, index=index))


@pytest.mark.parametrize("heads,dk", [(4, 4), (4, 32), (4, 64)])
def test_sddmm_without_an_index_builds_one_only_to_walk(dev, monkeypatch,
                                                        heads, dk):
    """Without an index K10 builds one on the host only for rows it walks
    (512 bytes and more: 4 x 32 fp32 up); narrower rows run in edge order
    with no index. Either way the scores match the plain twin."""
    ids, index = _walk_graph(dev)
    e, s = index.num_edges, index.num_segments
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((s, heads, dk), generator=g, device=dev)
    k = torch.randn((3000, heads, dk), generator=g, device=dev)
    src = torch.randint(0, 3000, (e,), generator=g, device=dev,
                        dtype=torch.int32)
    builds = []
    from_ids = SegmentIndex.from_ids
    monkeypatch.setattr(SegmentIndex, "from_ids", staticmethod(
        lambda *a, **kw: builds.append(1) or from_ids(*a, **kw)))
    got = sddmm(src, ids, q, k)
    assert len(builds) == (1 if heads * dk * 4 >= 512 else 0)
    _within(got, _sddmm_plain(src, ids, q, k), torch.float32)


REDUCE_ROWS = [  # (weight columns (heads), values per column)
    (1, 3), (1, 4), (4, 4), (3, 4), (4, 8), (4, 32), (4, 64), (1, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("weights", ["none", "edge", "head"])
@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("heads,dk", REDUCE_ROWS)
def test_segment_reduce_over_the_index_matches_plain(dev, dtype, op, weights,
                                                     gather, heads, dk):
    """K8 over segments of 0, 1, 31, 33 and 5,000 edges in a
    shuffled edge order, every mode, weights none / [E] / [E, H], rows
    gathered or per edge, and (gathered rows) a table 4 bytes past a
    16-byte boundary; empty segments give 0. One launch, the same bits on
    a repeat launch."""
    ids, index = _walk_graph(dev)
    e, s = index.num_edges, index.num_segments
    g = torch.Generator(device=dev).manual_seed(15)
    m = 4000 if gather else e
    x = torch.randn((m, heads * dk), generator=g, device=dev)
    if op == "max":
        x = (x * 2).round()                               # ties
    x = x.to(dtype)
    src = None
    if gather:
        src = torch.randint(0, m, (e,), generator=g, device=dev,
                            dtype=torch.int32)
        x = _shifted(x)
    w = {"none": None,
         "edge": torch.rand((e,), generator=g, device=dev),
         "head": torch.rand((e, heads), generator=g, device=dev)}[weights]
    before = _build.launches["segment_reduce"]
    got = segment_reduce(x, ids, s, op=op, src=src, weight=w, index=index)
    torch.cuda.synchronize()
    assert _build.launches["segment_reduce"] == before + 1
    want = _segment_reduce_plain(x, ids, s, op, src, w)
    assert got.dtype == dtype and got.shape == (s, heads * dk)
    _within(got, want, dtype)
    assert not got[5:10].any()                     # empty segments give 0
    assert torch.equal(got, segment_reduce(x, ids, s, op=op, src=src,
                                           weight=w, index=index))


@pytest.mark.parametrize("heads,dk", [(4, 4), (4, 64), (1, 3)])
def test_sddmm_and_coo_spmm_gradients_on_card_match_cpu(dev, heads, dk):
    """The sddmm and the weighted coo_spmm backward (K10b, K8, K8b, K10 for
    the weights) on the card against the same functions on the CPU, whose
    backward composes the plain twins (fp32: 1e-5 of each gradient's
    scale), over the shuffled walk graph."""
    ids_d, index = _walk_graph(dev)
    e, s = index.num_edges, index.num_segments
    rng = np.random.default_rng(16)
    src_np = rng.integers(0, 3000, e).astype(np.int32)
    src_np[:5000] = 7                                    # a source hub
    arrays = {"q": rng.normal(size=(s, heads, dk)),
              "k": rng.normal(size=(3000, heads, dk)),
              "v": rng.normal(size=(3000, heads, dk)),
              "w": rng.random((e, heads)), "scale": rng.random(heads) + 0.5,
              "g_score": rng.normal(size=(e, heads)),
              "g_out": rng.normal(size=(s, heads, dk))}
    grads = {}
    for device in (dev, torch.device("cpu")):
        t = {k_: torch.tensor(a, dtype=torch.float32, device=device)
             .requires_grad_(not k_.startswith("g_"))
             for k_, a in arrays.items()}
        ids = ids_d.to(device)
        src = torch.as_tensor(src_np, device=device)
        idx = index if device == dev else None
        sidx = SegmentIndex.from_ids(src, 3000) if device == dev else None
        score = sddmm(src, ids, t["q"], t["k"], scale=t["scale"], index=idx,
                      src_index=sidx)
        out = segment_ops.coo_spmm(src, ids, t["v"], s, edge_weight=t["w"],
                                   index=idx, src_index=sidx)
        ((score * t["g_score"]).sum() + (out * t["g_out"]).sum()).backward()
        grads[device.type] = {k_: t[k_].grad.cpu() for k_ in
                              ("q", "k", "v", "w", "scale")}
    for k_, want in grads["cpu"].items():
        scale = float(want.abs().max())
        err = float((grads["cuda"][k_] - want).abs().max())
        assert err <= 1e-5 * scale, (k_, err, scale)


def test_segment_ops_on_card_are_forward_only(dev):
    """Formerly forward only: a CUDA input that requires grad now records
    the ops' autograd.Functions (their backward is K8b, K9b, K10b); a
    mismatched index still raises."""
    ids, index = _segment_graph(dev, e=500, hub_deg=10)
    s, e = index.num_segments, index.num_edges
    x = torch.randn((e, 8), device=dev, requires_grad=True)
    assert "SegmentReduce" in segment_sum(x, ids, s, index=index) \
        .grad_fn.name()
    assert "SegmentSoftmax" in segment_softmax(
        x[:, :2], ids, s, index=index).grad_fn.name()
    q = torch.randn((s, 8), device=dev, requires_grad=True)
    assert "SDDMM" in sddmm(ids, ids, q, q).grad_fn.name()
    with torch.no_grad():
        assert segment_sum(x, ids, s, index=index).grad_fn is None
    with pytest.raises(ValueError, match="index covers"):
        segment_sum(x.detach(), ids, s + 1, index=index)


def _grad_pair(fn, inputs, cot):
    """Gradients of ``fn`` at ``inputs`` (those with requires_grad) for the
    cotangent ``cot``."""
    out = fn(*inputs)
    out.backward(cot)
    return [None if t.grad is None else t.grad.clone() for t in inputs]


def _leaves(*tensors, grad=True):
    return [t.detach().clone().requires_grad_(grad and t.is_floating_point())
            for t in tensors]


BWD_CASES = [  # (C, heads of the weight (0: none), gather rows, x needs grad)
    (128, 0, True, True), (128, 1, True, True), (128, 4, True, True),
    (128, 4, True, False), (64, 4, False, True), (12, 3, True, True),
    (4, 1, False, True)]
# no conv trains a weighted max (its weight gradient raises)
BWD_OP_CASES = [(op,) + case for op in ("sum", "mean", "max")
                for case in BWD_CASES if op != "max" or not case[1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op,c,w_heads,gather,x_grad", BWD_OP_CASES)
def test_segment_reduce_bwd_matches_plain(dev, dtype, op, c, w_heads,
                                          gather, x_grad):
    """K8b (rows; max on data with ties) and K10 (weights, sum and mean)
    against autograd through the plain twin, on segments with 100 empty
    ones and a 10^4 hub, sources with a 10^4-edge hub too (gather mode);
    an x that needs no gradient launches no K8b. The same bits on a repeat
    run."""
    ids, index = _segment_graph(dev)
    s, e = index.num_segments, index.num_edges
    g = torch.Generator(device=dev).manual_seed(4)
    m = 5000 if gather else e
    x = torch.randn((m, c), generator=g, device=dev)
    if op == "max":
        x = (x * 2).round()                               # ties
    x = x.to(dtype)
    src = src_index = None
    if gather:
        src = torch.randint(0, m, (e,), generator=g, device=dev,
                            dtype=torch.int32)
        src[: 10_000] = 17                                # a source hub
        src_index = SegmentIndex.from_ids(src, m)
    w = None
    if w_heads:
        w = torch.rand((e, w_heads) if w_heads > 1 else (e,), generator=g,
                       device=dev)
    cot = torch.randn((s, c), generator=g, device=dev).to(dtype)

    def run(fn):
        xx = x.detach().clone().requires_grad_(x_grad)
        ww = None if w is None else w.detach().clone().requires_grad_()
        fn(xx, ww).backward(cot)
        return xx.grad, None if ww is None else ww.grad

    def kernels(x_, w_):
        return segment_reduce(x_, ids, s, op=op, src=src, weight=w_,
                              index=index, src_index=src_index)

    _build.reset_launches()
    got = run(kernels)
    assert (_build.launches["segment_reduce_bwd"] > 0) == x_grad
    assert (_build.launches["sddmm"] > 0) == (w is not None)
    want = run(lambda x_, w_: _segment_reduce_plain(x_, ids, s, op, src,
                                                     w_))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            _within(a, b, dtype)
    for a, b in zip(got, run(kernels)):          # no atomics: same bits
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 4])
def test_segment_softmax_bwd_matches_plain(dev, dtype, heads):
    """K9b against autograd through the plain twin (empty segments, the
    10^4 hub), the same bits on a repeat run."""
    ids, index = _segment_graph(dev)
    s, e = index.num_segments, index.num_edges
    g = torch.Generator(device=dev).manual_seed(5)
    shape = (e,) if heads == 1 else (e, heads)
    logits = (torch.randn(shape, generator=g, device=dev) * 4).to(dtype)
    cot = torch.randn(shape, generator=g, device=dev).to(dtype)
    _build.reset_launches()
    (got,) = _grad_pair(lambda l_: segment_softmax(l_, ids, s, index=index),
                        _leaves(logits), cot)
    assert _build.launches["segment_softmax_bwd"] == 1
    (want,) = _grad_pair(lambda l_: _segment_softmax_plain(l_, ids, s),
                         _leaves(logits), cot)
    # the hub's softmax itself sits ~2e-5 from the twin's (see above)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
    (again,) = _grad_pair(lambda l_: segment_softmax(l_, ids, s,
                                                     index=index),
                          _leaves(logits), cot)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dk", [(4, 32), (1, 64), (4, 3)])
@pytest.mark.parametrize("scale_grad", [None, False, True])
def test_sddmm_bwd_matches_plain(dev, dtype, heads, dk, scale_grad):
    """dq (K8), dk (K8b) and dscale (K10b; scale absent, without and with
    grad) against autograd through the plain twin, on the segment graph's
    destinations with a 10^4 source hub; the same bits on a repeat run."""
    ids, index = _segment_graph(dev)
    e = ids.shape[0]
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((3000, heads, dk), generator=g, device=dev).to(dtype)
    k = torch.randn((4000, heads, dk), generator=g, device=dev).to(dtype)
    src = torch.randint(0, 4000, (e,), generator=g, device=dev,
                        dtype=torch.int32)
    src[: 10_000] = 3
    src_index = SegmentIndex.from_ids(src, 4000)
    scale = None
    if scale_grad is not None:
        scale = (torch.rand(heads, generator=g, device=dev) + 0.5
                 ).requires_grad_(scale_grad)
    cot = torch.randn((e, heads), generator=g, device=dev).to(dtype)

    def run(fn):
        qq, kk = _leaves(q, k)
        sc = None if scale is None else scale.detach().clone() \
            .requires_grad_(bool(scale_grad))
        fn(qq, kk, sc).backward(cot)
        return qq.grad, kk.grad, None if sc is None else sc.grad

    _build.reset_launches()
    got = run(lambda q_, k_, s_: sddmm(src, ids, q_, k_, scale=s_,
                                       index=index, src_index=src_index))
    # unscaled, the coefficients are the cotangent itself: no K10b; with
    # the scale's cotangent still one launch
    assert _build.launches["sddmm_bwd"] == {None: 0, False: 1, True: 1}[
        scale_grad]
    assert _build.launches["segment_reduce"] == 1            # dq
    assert _build.launches["segment_reduce_bwd"] == 1        # dk
    want = run(lambda q_, k_, s_: _sddmm_plain(src, ids, q_, k_, s_))
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            _within(a, b, dtype if b.dtype == dtype else torch.float32)
    again = run(lambda q_, k_, s_: sddmm(src, ids, q_, k_, scale=s_,
                                         index=index, src_index=src_index))
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


def _k10b_inputs(dev, e, heads, dtype, offset, seed):
    """g and raw [E, H] of ``dtype`` (raw ~8x g's scale, as unscaled
    scores of 64-value heads are), as views ``offset`` values into their
    storage, and a scale [H] in [0.5, 1.5)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g, raw = ((torch.randn(e * heads + offset, generator=gen, device=dev)
               * s_).to(dtype)[offset:].view(e, heads) for s_ in (1.0, 8.0))
    scale = torch.rand(heads, generator=gen, device=dev) + 0.5
    return g, raw, scale


def _dscale_within(got, g, raw):
    """The scale's cotangent against an fp64 sum: within 1e-6 of
    sum_e |g * raw| per head. The sum of E signed terms can nearly cancel,
    so a bound relative to the result itself would mean nothing; fp32
    partials summed in a fixed tree over the grid stay ~1e-7 of the
    absolute sum (the CPU emulation of the source: 1.1e-7 at worst)."""
    prod = g.double() * raw.double()
    err = (got.double() - prod.sum(0)).abs()
    assert bool((err <= 1e-6 * prod.abs().sum(0)).all()), (err, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2, 4, 8, 16, 3])
@pytest.mark.parametrize("e", [0, 1, 3, 1_100_001])
def test_sddmm_bwd_coef_forms_match_plain(dev, dtype, heads, e):
    """K10b in every mode (scale or not, the scale's cotangent or not) and
    form (16-byte pieces; g and raw views at an odd offset, a value at a
    time; 3 heads, a thread an edge), E of none, one, three and an odd
    count past one wave of 16-byte pieces at H = 1: one launch a call,
    coef bit-equal to the twin's single multiply, dscale within 1e-6 of
    sum |g * raw| of an fp64 sum and bit-equal on a repeat run, the ticket
    back at 0."""
    for offset in (0, 1):
        g, raw, scale = _k10b_inputs(dev, e, heads, dtype, offset, seed=e)
        assert e == 0 or (g.data_ptr() % 16 == 0) == (offset == 0)
        for sc, rw in ((scale, None), (scale, raw), (None, raw), (None, None)):
            _build.reset_launches()
            coef, dscale = sddmm_bwd_coef(g, sc, rw)
            torch.cuda.synchronize()
            assert _build.launches["sddmm_bwd"] == (1 if e or rw is not None
                                                    else 0)
            want, _ = _sddmm_bwd_coef_plain(g, sc, rw)
            assert coef.shape == (e, heads) and coef.dtype == torch.float32
            assert torch.equal(coef, want)
            if rw is None:
                assert dscale is None
                continue
            assert dscale.shape == (heads,)
            _dscale_within(dscale, g, rw)
            coef2, dscale2 = sddmm_bwd_coef(g, sc, rw)
            assert torch.equal(dscale, dscale2) and torch.equal(coef, coef2)
            assert sddmm_bwd_ticket(dev) == 0


def test_sddmm_bwd_mixed_dtypes_match_plain(dev):
    """A bf16 g with fp32 unscaled scores: both read in fp32, as the twin
    reads them (raw is not rounded to g's type); coef bit-equal."""
    g, _, scale = _k10b_inputs(dev, 30_001, 4, torch.bfloat16, 0, seed=7)
    _, raw, _ = _k10b_inputs(dev, 30_001, 4, torch.float32, 0, seed=8)
    coef, dscale = sddmm_bwd_coef(g, scale, raw)
    want, _ = _sddmm_bwd_coef_plain(g, scale, raw)
    assert torch.equal(coef, want)
    _dscale_within(dscale, g, raw)


def test_sddmm_bwd_one_cuda_launch_by_the_profiler(dev):
    """The dscale mode is one device kernel (the first version ran two
    and a fill), counted by torch.profiler in a fresh recording."""
    from torch.autograd import DeviceType

    g, raw, scale = _k10b_inputs(dev, 100_003, 4, torch.float32, 0, seed=3)
    sddmm_bwd_coef(g, scale, raw)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        sddmm_bwd_coef(g, scale, raw)
        torch.cuda.synchronize()
    kernels = [e_.name for e_ in prof.events()
               if e_.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "sddmm_bwd" in kernels[0], kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sddmm_bwd_graph_replay_matches_eager(dev, dtype):
    """K10b's dscale mode (and its coefficients) captured in a CUDA graph,
    three calls back to back as two layers' backward and a repeat make
    them, replayed twice: every replay's outputs are the eager calls'
    bits, and the ticket counter is 0 after each replay."""
    inputs = [_k10b_inputs(dev, e, 4, dtype, 0, seed=e)
              for e in (2_000_003, 65_537, 2_000_003)]

    def step():
        return [sddmm_bwd_coef(g, scale, raw) for g, raw, scale in inputs]

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for _ in range(2):
        for outs in captured:
            for t in outs:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert sddmm_bwd_ticket(dev) == 0
        for got, want in zip(captured, eager):
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_encode_coo_gradients_on_card_match_cpu(dev):
    """encode_coo (GAT, Transformer; and SAGE, whose layer 1 launches no
    K8b) on the card: the parameter gradients of the CPU's computation
    (fp32), with K8b, K9b and K10b launched (and K3 for GAT's per-edge
    attention terms)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, x, _ = _small_graph()
    for conv, kw, kernels in (
            ("graphsage", None, ("segment_reduce", "segment_reduce_bwd")),
            ("gat", {"heads": 4}, ("gather_rows", "segment_reduce",
                                   "segment_reduce_bwd", "segment_softmax",
                                   "segment_softmax_bwd", "sddmm")),
            ("transformer", {"heads": 4}, (
                "sddmm", "segment_softmax", "segment_reduce",
                "segment_reduce_bwd", "segment_softmax_bwd", "sddmm_bwd"))):
        grads = {}
        for device in (dev, torch.device("cpu")):
            enc = GNNEncoder(16, 32, 8, conv=conv, conv_kwargs=kw)
            init_params(enc, 3)
            enc = enc.to(device)
            ts, td = (torch.as_tensor(a.astype(np.int32), device=device)
                      for a in (src, dst))
            idx, sidx = (SegmentIndex.from_ids(t, N) for t in (td, ts))
            _build.reset_launches()
            out = enc.encode_coo(torch.as_tensor(x, device=device), ts, td,
                                 N, index=idx, src_index=sidx)
            (out * torch.linspace(-1, 1, out.numel(), device=device)
             .reshape(out.shape)).sum().backward()
            if device.type == "cuda":
                for k in kernels:
                    assert _build.launches[k] > 0, (conv, k)
                if conv == "graphsage":     # layer 2 only: x needs no grad
                    assert _build.launches["segment_reduce_bwd"] == 1
            grads[device.type] = {n: p.grad.cpu()
                                  for n, p in enc.named_parameters()}
        floor = 1e-2 * max(float(v.abs().max())
                           for v in grads["cpu"].values())
        for n, v in grads["cpu"].items():
            err = float((grads["cuda"][n] - v).abs().max())
            assert err <= 1e-4 * max(float(v.abs().max()), floor), (conv, n)


@pytest.mark.parametrize("heads", [1, 3])
def test_gat_coo_bf16_odd_heads_gathers_on_k3(dev, heads, monkeypatch):
    """bf16 GAT at 1 and 3 heads: the [N, H] attention-term tables have
    rows of odd bf16 width, whose per-edge gathers still run K3 (padded to
    whole 4-byte words) and give the bits of PyTorch's indexing, in the
    output and in every gradient."""
    src, dst, x, _ = _small_graph()
    ts, td = (torch.as_tensor(a.astype(np.int32), device=dev)
              for a in (src, dst))
    idx, sidx = (SegmentIndex.from_ids(t, N) for t in (td, ts))
    xt = torch.as_tensor(x, device=dev)

    def run():
        enc = GNNEncoder(16, 24, 6, conv="gat", conv_kwargs={"heads": heads},
                         dtype=torch.bfloat16)
        init_params(enc, 3)
        enc = enc.to(dev)
        _build.reset_launches()
        out = enc.encode_coo(xt, ts, td, N, index=idx, src_index=sidx)
        (out.float() * torch.linspace(-1, 1, out.numel(), device=dev)
         .reshape(out.shape)).sum().backward()
        return out, {n: p.grad for n, p in enc.named_parameters()}

    got, got_g = run()
    assert _build.launches["gather_rows"] == 4  # 2 layers x (a_src, a_dst)
    monkeypatch.setattr(segment_ops, "_gather_edge_rows",
                        lambda t, i: t[i.long()])
    want, want_g = run()
    assert _build.launches["gather_rows"] == 0
    assert torch.equal(got, want)
    for n, g in want_g.items():
        assert torch.equal(got_g[n], g), n


def _typed_graph(seed=0):
    """A small typed graph of the DBLP configuration's shape: 300 authors,
    500 papers (features 12 and 20 wide), writes / rev_writes / cites, a
    paper cited 2,000 times, an author who writes nothing."""
    rng = np.random.default_rng(seed)
    a, p = 300, 500
    w_src, w_dst = rng.integers(1, a, 2000), rng.integers(0, p, 2000)
    c_src = rng.integers(0, p, 6000)
    c_dst = np.concatenate([rng.integers(0, p, 4000), np.full(2000, 3)])
    types = ("author-writes-paper", "paper-rev_writes-author",
             "paper-cites-paper")
    graph = HeteroGraph(
        metadata=GraphMetadata(("author", "paper"), types),
        num_nodes={"author": a, "paper": p},
        edges={EdgeType.from_str(types[0]): np.stack([w_src, w_dst]),
               EdgeType.from_str(types[1]): np.stack([w_dst, w_src]),
               EdgeType.from_str(types[2]): np.stack([c_src, c_dst])},
        node_features={"author": rng.normal(size=(a, 12)).astype(np.float32),
                       "paper": rng.normal(size=(p, 20)).astype(np.float32)})
    paths = {
        "paper": resolve_path("paper", [
            SamplingOp("authors", types[0], 10),
            SamplingOp("cited", types[2], 10),
            SamplingOp("coauthored", types[1], 5, ("authors",)),
            SamplingOp("cited_authors", types[0], 5, ("cited",))]),
        "author": resolve_path("author", [
            SamplingOp("papers", types[1], 10),
            SamplingOp("paper_authors", types[0], 5, ("papers",))])}
    return graph, paths, types


class _Rows:
    def __init__(self):
        self.parts = []

    def add_embeddings(self, ids, emb):
        self.parts.append((np.asarray(ids), np.asarray(emb)))

    def flush(self):
        pass

    def table(self):
        ids = np.concatenate([i for i, _ in self.parts])
        return np.concatenate([e for _, e in self.parts])[np.argsort(ids)]


def test_typed_inference_on_card_matches_cpu(dev):
    """run_full_graph_inference_hetero (HGT, SimpleHGN, RGCN with 2 bases)
    and HeteroNALPTrainer.encode_batch (HGT, live and tabularized) on the
    card against the CPU, fp32 within 1e-5 of the scale, with the kernels
    of each path launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    graph, paths, types = _typed_graph()
    dims = {"author": 12, "paper": 20}
    for conv, kw, kernels in (
            ("hgt", {}, ("sddmm", "segment_softmax", "segment_reduce")),
            ("simple_hgn", {}, ("segment_softmax", "segment_reduce")),
            ("rgcn", {"num_bases": 2}, ("segment_reduce",))):
        enc = HeteroGNNEncoder(32, 16, ("author", "paper"), types, dims,
                               conv=conv, heads=4, **kw)
        init_params(enc, 0)
        out = {}
        for device in (dev, torch.device("cpu")):
            sinks = {"author": _Rows(), "paper": _Rows()}
            _build.reset_launches()
            run_full_graph_inference_hetero(enc, None, graph, sinks,
                                            device=device)
            if device.type == "cuda":
                for k in kernels:
                    assert _build.launches[k] > 0, (conv, k)
            out[device.type] = {nt: s.table() for nt, s in sinks.items()}
        for nt in ("author", "paper"):
            want = out["cpu"][nt]
            np.testing.assert_allclose(out["cuda"][nt], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    for tabularized in (False, True):
        got = {}
        for device in (dev, torch.device("cpu")):
            model = HeteroLinkPredictionGNN(
                HeteroGNNEncoder(32, 16, ("author", "paper"), types, dims),
                LinkPredictionDecoder())
            tr = HeteroNALPTrainer(
                model, HeteroDeviceGraph.from_hetero(graph, paths,
                                                     device=device),
                paths, HeteroNALPTrainerConfig(
                    "paper", "author", tabularized=tabularized),
                device=device)
            tr.init_params(0)
            _build.reset_launches()
            got[device.type] = [tr.encode_batch(np.arange(n), nt).cpu()
                                for nt, n in (("paper", 500),
                                              ("author", 300))]
            if device.type == "cuda":
                for k in ("gather_rows", "fanout_attention") + (
                        () if tabularized else ("sample_uniform",)):
                    assert _build.launches[k] > 0, (tabularized, k)
        for g, w in zip(got["cuda"], got["cpu"]):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-5 * float(w.abs().max()))


def test_hgt_encode_full_prior_gradient_on_card_matches_cpu(dev):
    """HGT's prior is K10's scale in encode_full: on the card its gradient
    (K10b) and every other parameter's match the same computation on the
    CPU (fp32 within 1e-4 of the scale); no SegmentIndex is built inside
    the pass (the segments are given)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    graph, _, types = _typed_graph()
    dims = {"author": 12, "paper": 20}
    grads = {}
    for device in (dev, torch.device("cpu")):
        enc = HeteroGNNEncoder(32, 16, ("author", "paper"), types, dims,
                               heads=4)
        init_params(enc, 1)
        # priors away from 1, so they matter: the same draw on both devices
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for n, p in enc.named_parameters():
                if ".prior_" in n:
                    p.uniform_(0.5, 1.5, generator=gen)
        enc = enc.to(device)
        feats = {nt: torch.as_tensor(f, device=device)
                 for nt, f in graph.node_features.items()}
        edges = {str(et): tuple(torch.as_tensor(a.astype(np.int32),
                                                device=device) for a in coo)
                 for et, coo in graph.edges.items()}
        nn_ = {"author": 300, "paper": 500}
        segs = enc.segments(edges, nn_)
        _build.reset_launches()
        out = enc.encode_full(feats, edges, nn_, segments=segs)
        sum((o * torch.linspace(-1, 1, o.numel(), device=device)
             .reshape(o.shape)).sum() for o in out.values()).backward()
        if device.type == "cuda":
            for k in ("sddmm", "sddmm_bwd", "segment_softmax_bwd",
                      "segment_reduce_bwd"):
                assert _build.launches[k] > 0, k
        grads[device.type] = {n: p.grad.cpu()
                              for n, p in enc.named_parameters()}
    floor = 1e-2 * max(float(v.abs().max()) for v in grads["cpu"].values())
    priors = [n for n in grads["cpu"] if ".prior_" in n]
    assert len(priors) == 6
    for n, v in grads["cpu"].items():
        err = float((grads["cuda"][n] - v).abs().max())
        assert err <= 1e-4 * max(float(v.abs().max()), floor), (n, err)
        if n in priors:
            assert float(v.abs().max()) > 0, n


def test_typed_training_steps_on_card_match_cpu(dev):
    """Three typed NALP steps (HGT and RGCN with 2 bases, the DBLP paths)
    on the card against the same steps on the CPU: the losses within 1e-4
    relative, with K1, K1b, K3, K5 and K7 / K7b (HGT) or K4 / K4b (RGCN)
    launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    graph, paths, types = _typed_graph()
    dims = {"author": 12, "paper": 20}
    writes = EdgeType.from_str(types[0])
    anchors = np.random.default_rng(2).integers(0, 500, (3, 64))
    for conv, kernels in (("hgt", ("fanout_attention",
                                   "fanout_attention_bwd")),
                          ("rgcn", ("masked_reduce", "masked_reduce_bwd"))):
        losses = {}
        for device in (dev, torch.device("cpu")):
            model = HeteroLinkPredictionGNN(HeteroGNNEncoder(
                32, 16, ("author", "paper"), types, dims, conv=conv,
                heads=4, num_bases=2), LinkPredictionDecoder())
            tr = HeteroNALPTrainer(
                model, HeteroDeviceGraph.from_hetero(
                    graph, paths, supervision_edge_type=writes,
                    supervision_edges=graph.edges[writes], device=device),
                paths, HeteroNALPTrainerConfig("paper", "author",
                                               num_random_negs=64),
                device=device)
            st = tr.init_state(0)
            _build.reset_launches()
            st, got = tr.train_steps(st, anchors)
            if device.type == "cuda":
                for k in ("sample_uniform", "uniform_ids", "gather_rows",
                          "retrieval_loss") + kernels:
                    assert _build.launches[k] > 0, (conv, k)
            losses[device.type] = got.cpu().numpy()
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# -- edge features: K6 / K6b gine, K11, K7 / K7b edge addend and bias -------------
def _edge_case(dev, n_nodes, d, dtype, seed=7, edgeless=False):
    """An ELL graph with a 400-out-degree hub source and empty buckets
    (widths up to 256, in-degrees below 64), its input rows and an edge
    table (GINE's width)."""
    if edgeless:
        src = dst = np.zeros((0,), np.int64)
    else:
        src, dst = _hub_graph(n_nodes, seed, 400)
    ell = EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=n_nodes,
                                      num_neighbor_nodes=n_nodes),
                            widths=(4, 8, 16, 32, 64, 128, 256), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n_nodes, d), generator=g, device=dev).to(dtype)
    ea = torch.randn((len(src), d), generator=g, device=dev).to(dtype)
    return ell, x, ea, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 12, 5])
@pytest.mark.parametrize("with_edges", [True, False])
def test_ell_gine_forward_and_backward_match_plain(dev, dtype, d,
                                                   with_edges):
    """K6 gine over every bucket in one launch, K6b gine over the
    transpose walk and K11 gine, against their twins; odd widths take the
    one-element path."""
    ell, x, ea, g = _edge_case(dev, 700, d, dtype)
    assert any(hi == lo for lo, hi in zip(ell.boundaries,
                                          ell.boundaries[1:]))
    ea = ea if with_edges else None
    _build.reset_launches()
    got = _ell_aggregate_fwd(x, ell, "gine", ea=ea)
    want = _ell_aggregate_graph_plain(x, ell, "gine", ea)
    _within(got, want, dtype, floor=1.0)
    gout = torch.randn(x.shape, generator=g, device=dev).to(dtype)
    got = ell_transpose_aggregate(gout, ell, "gine", table=x, ea=ea)
    want = _ell_transpose_plain(gout, ell, "gine", table=x, ea=ea)
    _within(got, want, dtype, floor=1.0)
    assert not got[ell.rank[:3].long()].any()     # sources without out-edges
    if ea is not None:
        got = edge_ops.ell_edge_grad(gout, ell, "gine", x=x, ea=ea)
        want = edge_ops._ell_edge_grad_plain(gout, ell, "gine", x, ea)
        assert torch.equal(got, want)             # a permutation and a gate
        assert _build.launches["ell_edge_grad"] == 1
    torch.cuda.synchronize()
    assert _build.launches["ell_aggregate"] == 1     # every bucket at once


def _edge_grad_graph(dev, kind, seed=7):
    """K11's graphs: ``buckets`` (_edge_case's: empty buckets, widths up to
    256), ``hub`` (node 2 of in-degree 3,100: a width-4096 bucket whose row
    spans many of K11's entry chunks), ``multi`` (isolated nodes, repeated
    edges and self-loops) and ``edgeless``."""
    if kind == "buckets":
        return _edge_case(dev, 700, 8, torch.float32, seed)[0], 700
    rng = np.random.default_rng(seed)
    src, dst = _hub_graph(700, seed, 400)
    if kind == "hub":
        src = np.concatenate([src, rng.integers(0, 700, 3100)])
        dst = np.concatenate([dst, np.full(3100, 2)])
    elif kind == "multi":
        src = np.concatenate([src, [5, 5, 5, 9, 9, 11, 12]])
        dst = np.concatenate([dst, [6, 6, 6, 9, 9, 11, 12]])
    elif kind == "edgeless":
        src = dst = np.zeros((0,), np.int64)
    ell = EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=700,
                                      num_neighbor_nodes=700), device=dev)
    return ell, 700


@pytest.mark.parametrize("graph", ["buckets", "hub", "multi", "edgeless"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["gat", "transformer", "gine"])
@pytest.mark.parametrize("heads,dh", [(1, 8), (3, 5), (3, 2), (4, 64)])
def test_ell_edge_grad_matches_plain(dev, dtype, mode, heads, dh, graph):
    """K11 against its twin, every edge's row (so every row was written),
    one launch a call: the 16-byte path (D 8 and 256) and the scalar one
    (D 15; D 6 in bf16), gine bit-equal (a gated permutation)."""
    ell, n = _edge_grad_graph(dev, graph)
    if graph == "hub":
        assert ell.widths[-1] == 4096
    g = torch.Generator(device=dev).manual_seed(heads * dh)
    d, p = heads * dh, ell.ent_row.shape[0]
    gout, xd, x = (torch.randn((n, d), generator=g, device=dev).to(dtype)
                   for _ in range(3))
    ea = torch.randn((ell.num_edges, d), generator=g, device=dev).to(dtype)
    alpha = torch.rand((p, heads), generator=g, device=dev)
    coef = torch.randn((p, heads), generator=g, device=dev)
    vec = torch.randn(d, generator=g, device=dev)
    kw = {"gine": dict(x=x, ea=ea),
          "gat": dict(alpha=alpha, coef=coef, vec=vec, heads=heads),
          "transformer": dict(alpha=alpha, coef=coef, xd=xd,
                              heads=heads)}[mode]
    _build.reset_launches()
    got = edge_ops.ell_edge_grad(gout, ell, mode, **kw)
    torch.cuda.synchronize()
    assert _build.launches["ell_edge_grad"] == 1
    want = edge_ops._ell_edge_grad_plain(gout, ell, mode, **kw)
    assert got.shape == (ell.num_edges, d) and got.dtype == dtype
    if mode == "gine":
        assert torch.equal(got, want)
    elif ell.num_edges:
        _within(got, want, dtype)


def test_ell_edge_grad_edgeless_graph(dev):
    ell, x, ea, _ = _edge_case(dev, 50, 8, torch.float32, edgeless=True)
    _build.reset_launches()
    got = edge_ops.ell_edge_grad(x, ell, "gine", x=x, ea=ea)
    assert got.shape == (0, 8) and _build.launches["ell_edge_grad"] == 1
    out = ell_aggregate_graph(x, ell, "gine", ea=ea)
    assert not out.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["gat", "transformer"])
@pytest.mark.parametrize("heads,dh", [(1, 8), (3, 5), (4, 64), (4, 4)])
def test_fanout_attention_edge_addend_matches_plain(dev, dtype, mode, heads,
                                                    dh):
    """K7 and K7b (ELL layout) with the edge rows added to every slot's
    key and value, per bucket of an ELL graph with empty buckets."""
    hd = heads * dh
    ell, _, _, g = _edge_case(dev, 700, hd, dtype)
    xd, ks, vs, gout = (torch.randn((700, hd), generator=g, device=dev)
                        .to(dtype) for _ in range(4))
    he = torch.randn((ell.num_edges, hd), generator=g, device=dev).to(dtype)
    if mode == "gat":
        vs = ks
    att, att2 = (torch.randn(hd, generator=g, device=dev) * 0.3
                 for _ in range(2))
    att, att2 = (att, att2) if mode == "gat" else (None, None)
    for b in range(len(ell.widths)):
        lo, hi = ell.boundaries[b], ell.boundaries[b + 1]
        if hi == lo:
            continue
        nbr, mask, es = ell.nbr[b], ell.mask[b], ell.edge_slots[b]
        stats = torch.empty((hi - lo, heads, 2), device=dev)
        out = _fanout_attention_fwd(xd[lo:hi], ks, vs, nbr, mask, mode,
                                    heads, att, att2, 0.2, stats=stats,
                                    he=he, eidx=es)
        want = _fanout_attention_plain(xd[lo:hi], ks, vs, nbr, mask, mode,
                                       heads, att, att2, 0.2, he=he, eidx=es)
        _within(out, want, dtype, floor=1.0)
        got = fanout_attention_bwd(gout[lo:hi], xd[lo:hi], ks, vs, nbr, mask,
                                   out, stats, mode, heads, att, att2, 0.2,
                                   he=he, eidx=es)
        wb = _fanout_attention_bwd_plain(gout[lo:hi], xd[lo:hi], ks, vs, nbr,
                                         mask, out, mode, heads, att, att2,
                                         0.2, he=he, eidx=es)
        for name in ("d_xd", "alpha", "coef", "d_att"):
            a, w = getattr(got, name), getattr(wb, name)
            if a is not None:
                _within(a, w, dtype, floor=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dh", [(1, 8), (3, 5), (4, 32), (4, 4)])
def test_fanout_attention_block_bias_matches_plain(dev, dtype, heads, dh):
    """K7 / K7b's per-slot logit bias (SimpleHGN's relation term) in the
    dense-block layout, with all-masked rows and an all-masked column
    group: forward, d_xd, d_ks, d_att and the per-entry coefficient (the
    bias's cotangent)."""
    n, w, hd = 40, 12, heads * dh
    g = torch.Generator(device=dev).manual_seed(9)
    nbr = torch.arange(n * w, dtype=torch.int32, device=dev).reshape(n, w)
    mask = torch.rand((n, w), generator=g, device=dev) < 0.6
    mask[:2] = False
    mask[:, 8:] = False                      # a relation with no valid slot
    xd, gout = (torch.randn((n, hd), generator=g, device=dev).to(dtype)
                for _ in range(2))
    ks = torch.randn((n * w, hd), generator=g, device=dev).to(dtype)
    att, att2 = (torch.randn(hd, generator=g, device=dev) * 0.3
                 for _ in range(2))
    bias = torch.randn((w, heads), generator=g, device=dev)
    stats = torch.empty((n, heads, 2), device=dev)
    out = _fanout_attention_fwd(xd, ks, ks, nbr, mask, "gat", heads, att,
                                att2, 0.2, stats=stats, bias=bias)
    want = _fanout_attention_plain(xd, ks, ks, nbr, mask, "gat", heads, att,
                                   att2, 0.2, bias=bias)
    _within(out, want, dtype, floor=1.0)
    assert not out[:2].any()
    got = fanout_attention_bwd(gout, xd, ks, ks, nbr, mask, out, stats,
                               "gat", heads, att, att2, 0.2, identity=True,
                               same_table=True, bias=bias)
    wb = _fanout_attention_bwd_plain(gout, xd, ks, ks, nbr, mask, out, "gat",
                                     heads, att, att2, 0.2, True, True,
                                     bias=bias)
    for name in ("d_xd", "coef", "d_ks", "d_att"):
        _within(getattr(got, name), getattr(wb, name), dtype, floor=1.0)
    assert not got.coef.reshape(n, w, heads)[:, 8:].any()


def test_edge_featured_encode_ell_gradients_on_card_match_cpu(dev):
    """The new autograd paths on the card (ROADMAP C3's lesson): encode_ell
    with edge features for GINE, EdgeAttrGAT and the Transformer — every
    parameter's gradient (edge_in_proj's, lin_edge's) and the edge rows'
    against the CPU's, fp32, with K6 / K6b gine or K7 / K7b and K11
    launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, x, _ = _small_graph()
    ea = np.random.default_rng(3).normal(size=(len(src), 5)).astype(
        np.float32)
    csr = build_csr(src, dst, num_anchor_nodes=N)
    for conv, kw in (("gine", None), ("edge_attr_gat", {"heads": 4}),
                     ("transformer", {"heads": 4, "use_edge_attr": True})):
        grads = {}
        for device in (dev, torch.device("cpu")):
            enc = GNNEncoder(16, 16, 8, conv=conv, conv_kwargs=kw,
                             edge_dim=5)
            init_params(enc, 0)
            enc.to(device)
            ell = EllGraph.from_csr(csr, widths=(4, 8, 16, 32, 64, 128, 256,
                                                 512), device=device)
            tea = torch.from_numpy(ea).to(device).requires_grad_()
            w = torch.from_numpy(np.random.default_rng(2).normal(
                size=(N, 8)).astype(np.float32)).to(device)
            _build.reset_launches()
            out = enc.encode_ell(torch.from_numpy(x).to(device), ell, tea)
            assert out.grad_fn is not None
            (out * w).sum().backward()
            grads[device.type] = {k: p.grad.cpu()
                                  for k, p in enc.named_parameters()}
            grads[device.type]["edge_attr"] = tea.grad.cpu()
            if device.type == "cuda":
                names = (("ell_aggregate", "ell_transpose_aggregate")
                         if conv == "gine" else
                         ("fanout_attention", "fanout_attention_bwd"))
                for k in names + ("ell_edge_grad",):
                    assert _build.launches[k] > 0, (conv, k)
        floor = 1e-2 * max(float(v.abs().max())
                           for v in grads["cpu"].values())
        for k, v in grads["cpu"].items():
            err = float((grads["cuda"][k] - v).abs().max())
            scale = max(float(v.abs().max()), floor)
            assert err <= 1e-4 * scale, (conv, k, err, scale)


def test_label_edge_and_simple_hgn_steps_on_card_match_cpu(dev):
    """Three NALP steps with message-edge features (EdgeAttrGAT, live:
    K3 hydrates the edge rows) and the label-edge scorer, and three typed
    SimpleHGN steps with the scorer (K7 / K7b with the relation bias), on
    the card against the CPU: losses within 1e-4 relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, x, _ = _small_graph()
    rng = np.random.default_rng(4)
    ea = rng.normal(size=(len(src), 4)).astype(np.float32)
    sup_ef = rng.normal(size=(len(src), 3)).astype(np.float32)
    anchors = rng.integers(0, N, (3, 64))
    losses = {}
    for device in (dev, torch.device("cpu")):
        g = DeviceGraph.from_hetero(
            HeteroGraph.homogeneous(src, dst, num_nodes=N, node_features=x,
                                    edge_features=ea),
            supervision_edges=np.stack([src, dst]),
            supervision_edge_features=sup_ef, device=device)
        model = LinkPredictionGNN(
            GNNEncoder(16, 32, 16, conv="edge_attr_gat",
                       conv_kwargs={"heads": 4}, edge_dim=4),
            LinkPredictionDecoder(), EdgeFeatureScorer(3, 8))
        tr = NALPTrainer(model, g, NALPTrainerConfig(fanouts=(5, 3),
                                                     num_random_negs=64),
                         device=device)
        st = tr.init_state(0)
        _build.reset_launches()
        st, got = tr.train_steps(st, anchors)
        if device.type == "cuda":
            for k in ("sample_uniform", "gather_rows", "fanout_attention",
                      "fanout_attention_bwd", "retrieval_loss"):
                assert _build.launches[k] > 0, k
        losses[device.type] = got.cpu().numpy()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    graph, paths, types = _typed_graph()
    writes = EdgeType.from_str(types[0])
    n_writes = graph.edges[writes].shape[1]
    feats = rng.normal(size=(n_writes, 3)).astype(np.float32)
    typed_anchors = rng.integers(0, 500, (3, 64))
    for device in (dev, torch.device("cpu")):
        model = HeteroLinkPredictionGNN(HeteroGNNEncoder(
            32, 16, ("author", "paper"), types, {"author": 12, "paper": 20},
            conv="simple_hgn", heads=4), LinkPredictionDecoder(),
            EdgeFeatureScorer(3, 8))
        tr = HeteroNALPTrainer(
            model, HeteroDeviceGraph.from_hetero(
                graph, paths, supervision_edge_type=writes,
                supervision_edges=graph.edges[writes],
                supervision_edge_features=feats, device=device),
            paths, HeteroNALPTrainerConfig("paper", "author",
                                           num_random_negs=64),
            device=device)
        st = tr.init_state(0)
        _build.reset_launches()
        st, got = tr.train_steps(st, typed_anchors)
        if device.type == "cuda":
            for k in ("fanout_attention", "fanout_attention_bwd"):
                assert _build.launches[k] > 0, k
        losses[device.type] = got.cpu().numpy()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [6, 12, 16, 128, 136])
def test_gather_rows_q8_bit_equal(dev, dtype, dim):
    """K12 at each load width (D 6: one value a thread; fp32: four; bf16:
    eight, or four at D 12), with the degrees alongside."""
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(N, dim)).astype(np.float32) * rng.uniform(
        0.01, 30.0, (N, 1)).astype(np.float32)
    x[7] = 0.0
    t = QuantizedTable.quantize(x, out_dtype=dtype, device=dev)
    deg = torch.from_numpy(rng.random(N).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, N, (50, 7)).astype(np.int32)).to(
        dev)
    ids[0, :2] = torch.tensor([0, N - 1], dtype=torch.int32)
    before = _build.launches["gather_rows_q8"]
    rows, vals = t.gather(ids, deg)
    torch.cuda.synchronize()
    assert _build.launches["gather_rows_q8"] == before + 1
    want, wvals = _gather_rows_q8_plain(t.q, t.scale, ids, dtype, deg)
    assert rows.dtype == dtype and rows.shape == (50, 7, dim)
    assert torch.equal(rows, want) and torch.equal(vals, wvals)
    assert torch.equal(t[ids[0]], want[0])
    assert gather_rows_q8(t.q, t.scale, ids[1], dtype)[1] is None


def _q8_segments(dev, count, dtype, seed=0):
    """``count`` K12 gathers over their own int8 tables: widths 4, 12, 128,
    130 and 6 in turn, the degrees on every other one, gather 1 empty
    (where there is one), ids of shape [7, m] with both ends of the
    table."""
    rng = np.random.default_rng(seed)
    deg = torch.from_numpy(rng.random(N).astype(np.float32)).to(dev)
    segs = []
    for k in range(count):
        d = (4, 12, 128, 130, 6)[k % 5]
        x = rng.normal(size=(N, d)).astype(np.float32) * rng.uniform(
            0.01, 30.0, (N, 1)).astype(np.float32)
        t = QuantizedTable.quantize(x, out_dtype=dtype, device=dev)
        shape = (0,) if k == 1 else (7, int(rng.integers(1, 60)))
        ids = torch.from_numpy(rng.integers(0, N, shape).astype(
            np.int32)).to(dev)
        if k != 1:
            ids[0, 0], ids[-1, -1] = 0, N - 1
        segs.append((t.q, t.scale, ids, dtype, deg if k % 2 == 0 else None))
    return segs


def _q8_equal(got, want):
    for (rows, vals), (w_rows, w_vals) in zip(got, want, strict=True):
        assert rows.dtype == w_rows.dtype and torch.equal(rows, w_rows)
        assert (vals is None) == (w_vals is None)
        if vals is not None:
            assert torch.equal(vals, w_vals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("count", [1, 2, 4, 8, 9])
def test_gather_rows_q8_many_bit_equal(dev, count, dtype):
    """K12's segmented launch: every gather of one launch (one per eight)
    bit-equal to its twin, each output at a 16-byte-aligned offset."""
    segs = _q8_segments(dev, count, dtype, seed=count)
    before = _build.launches["gather_rows_q8"]
    got = gather_rows_q8_many(segs)
    torch.cuda.synchronize()
    assert _build.launches["gather_rows_q8"] == before + -(-count // 8)
    _q8_equal(got, _gather_rows_q8_many_plain(segs))
    for rows, vals in got:
        assert rows.data_ptr() % 16 == 0
        assert vals is None or vals.data_ptr() % 16 == 0
    # one gather of the same launch gives the one-gather call's bits
    _q8_equal(got[:1], [gather_rows_q8(*segs[0])])


def test_gather_rows_q8_many_graph_replay(dev):
    """The segmented launch captured in a CUDA graph (its gathers by value
    in the kernel's parameters) and replayed over new ids equals the
    eager call over them."""
    segs = _q8_segments(dev, 5, torch.float32, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gather_rows_q8_many(segs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gather_rows_q8_many(segs)
    rng = np.random.default_rng(4)
    for _, _, ids, _, _ in segs:
        ids.copy_(torch.from_numpy(rng.integers(0, N, ids.shape).astype(
            np.int32)))
    graph.replay()
    torch.cuda.synchronize()
    _q8_equal(captured, gather_rows_q8_many(segs))
    _q8_equal(captured, _gather_rows_q8_many_plain(segs))


@pytest.mark.parametrize("depth,width", [
    (5, 2048), (3, 2047), (1, 7), (4, 4099), (1, 1), (8, 1), (8, 7),
    (1, 2048), (8, 2049), (1, 65536), (8, 65536)])
def test_cms_kernels_bit_equal(dev, depth, width):
    """K13 (one tiled kernel for every width: 65536 is a 256 KB sketch of
    eight 8192-cell tiles a row, 2049 and 7 take the one-cell accesses) and
    K14 against their twins on the card, over batches of no id, one id,
    1,024 ids up to 2**31 - 1 with duplicates, 1,024 copies of one id
    (1,024 atomics on one cell a row), negative ids and 65,536 ids, with
    the total wrapping past 2**31 - 1; one launch a call, and the input
    sketch is never written."""
    rng = np.random.default_rng(width)
    top = np.arange(2**31 - 8, 2**31, dtype=np.int64).astype(np.int32)
    got = cms_ops.cms_init(depth, width, device=dev)
    got = got._replace(total=torch.tensor(2**31 - 50_000, dtype=torch.int32,
                                          device=dev))
    want = got
    batches = [np.zeros(0, np.int64),
               np.concatenate([rng.integers(0, 500, 1016), top]),
               rng.integers(0, 500, 333), np.array([7]),
               np.full(1024, 123_456_789), rng.integers(-2**31, 0, 999),
               rng.integers(-2**31, 2**31, 65_536)]
    for ids in batches:
        t_ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        before = got.table.clone()
        launches = _build.launches["cms_add"]
        nxt = cms_ops.cms_add(got, t_ids)
        torch.cuda.synchronize()
        assert _build.launches["cms_add"] == launches + 1
        assert torch.equal(got.table, before)
        got, want = nxt, cms_ops._cms_add_plain(want, t_ids)
        assert torch.equal(got.table, want.table)
        assert int(got.total) == int(want.total) and got.total.shape == ()
        query = torch.from_numpy(np.concatenate(
            [rng.integers(0, 800, 200), top]).astype(np.int32)).to(dev)
        assert torch.equal(cms_ops.cms_estimate(got, query),
                           cms_ops._cms_estimate_plain(want, query))
        assert torch.equal(cms_ops.cms_sampling_probability(got, query),
                           cms_ops._cms_probability_plain(want, query))
    assert int(got.total) < 0                    # wrapped past 2**31 - 1


@pytest.mark.parametrize("depth", list(range(1, 11)))
@pytest.mark.parametrize("n", [0, 1, 1024, 65_536])
def test_cms_estimate_depths_bit_equal(dev, depth, n):
    """K14 (its rows unrolled for depth 1-8, a loop at 9 and 10) over
    every id batch size the paths give it and none, right behind the K13
    launch that wrote its table and total: estimates and probabilities
    bit-equal to the twins, one launch a call."""
    rng = np.random.default_rng(depth * 100_000 + n)
    width = 2048 if n <= 1024 else 16384
    sk = cms_ops.cms_init(depth, width, device=dev)
    for _ in range(3):
        sk = cms_ops.cms_add(sk, torch.from_numpy(rng.integers(
            0, 5000, 4096).astype(np.int32)).to(dev))
    ids = torch.from_numpy(np.concatenate([
        rng.integers(0, 5000, n - n // 2),
        rng.integers(-2**31, 2**31, n // 2)]).astype(np.int32)).to(dev)
    for fn, plain in ((cms_ops.cms_estimate, cms_ops._cms_estimate_plain),
                      (cms_ops.cms_sampling_probability,
                       cms_ops._cms_probability_plain)):
        fresh = cms_ops.cms_add(sk, ids)        # K13 just before K14
        launches = _build.launches["cms_estimate"]
        got = fn(fresh, ids)
        torch.cuda.synchronize()
        assert _build.launches["cms_estimate"] == launches + 1
        assert got.shape == ids.shape
        assert torch.equal(got, plain(fresh, ids))


def test_cms_estimate_waits_for_the_op_that_writes_its_ids(dev):
    """K14 launched right after a long PyTorch kernel whose last elements
    are K14's ids (and after a K13 whose output it reads): a read before
    the dependent launch's wait would see the stale ids, -1, or the
    previous table."""
    sk = cms_ops.cms_init(5, 2048, device=dev)
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.integers(0, 10**6, 1 << 26).astype(
        np.int32)).to(dev)
    buf = torch.full_like(src, -1)
    ids = buf[-1024:]
    want_ids = src[-1024:].clone()
    sk = cms_ops.cms_add(sk, want_ids)
    torch.cuda.synchronize()
    for _ in range(3):
        buf.fill_(-1)
        torch.cuda.synchronize()
        torch.add(src, 0, out=buf)              # writes ids last
        got = cms_ops.cms_estimate(sk, ids)
        torch.cuda.synchronize()
        assert torch.equal(got, cms_ops._cms_estimate_plain(sk, want_ids))
        buf.fill_(-1)
        torch.cuda.synchronize()
        torch.add(src, 0, out=buf)
        nxt = cms_ops.cms_add(sk, ids)          # K13 writes the table
        prob = cms_ops.cms_sampling_probability(nxt, ids)
        torch.cuda.synchronize()
        assert torch.equal(prob, cms_ops._cms_probability_plain(
            cms_ops._cms_add_plain(sk, want_ids), want_ids))


def test_cms_pair_graph_replay_matches_eager(dev):
    """K13 then K14 (the dependent launch) captured in one CUDA graph, as
    a captured step holds them, replayed with new ids copied into the
    captured buffer: every replay's table, total and probabilities are
    the eager calls' bits."""
    rng = np.random.default_rng(11)
    sk = cms_ops.cms_add(cms_ops.cms_init(5, 2048, device=dev),
                         torch.from_numpy(rng.integers(0, 3000, 8192).astype(
                             np.int32)).to(dev))
    ids = torch.empty(1024, dtype=torch.int32, device=dev)

    def pair():
        nxt = cms_ops.cms_add(sk, ids)
        return nxt.table, nxt.total, cms_ops.cms_sampling_probability(nxt,
                                                                      ids)

    ids.copy_(torch.from_numpy(rng.integers(0, 3000, 1024).astype(np.int32)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pair()
    for _ in range(3):
        ids.copy_(torch.from_numpy(rng.integers(0, 3000, 1024).astype(
            np.int32)))
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        eager = pair()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)


@pytest.mark.parametrize("agg", ["mean", "sum", "gcn"])
@pytest.mark.parametrize("fanout,dim", [(3, 16), (10, 128), (40, 132),
                                        (10, 132), (40, 128), (3, 48)])
def test_neighbor_cache_int8_matches_plain(dev, agg, fanout, dim):
    """16-byte pieces where the int8 row is a multiple of 16 bytes (D 16:
    one piece, 3 of a group of 4 lanes idle; D 48: three; D 128: 8 lanes
    a node), 4-byte pieces otherwise (D 132: 33 pieces, a warp and one
    lane of a second column chunk); nodes of degree 0 get 0."""
    csr = _csr(dev, 2)
    rng = np.random.default_rng(dim)
    t = QuantizedTable.quantize(rng.normal(size=(N, dim)), device=dev)
    deg = torch.diff(csr.indptr).float()
    before = _build.launches["build_neighbor_cache"]
    out = build_neighbor_cache(csr, t, fanout=fanout, seed=7, hop_key=2,
                               agg=agg, degrees=deg)
    torch.cuda.synchronize()
    assert _build.launches["build_neighbor_cache"] == before + 1
    want = torch.empty((N, dim), device=dev)
    _neighbor_cache_plain(csr, t, fanout, 7, 2, agg, deg, want)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(out[[5, 6, 699]], torch.zeros_like(out[:3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,c", [(1, 40), (50, 77), (512, 1024), (5, 7),
                                 (9, 1500)])
def test_retrieval_loss_logq_matches_plain(dev, dtype, q, c):
    """K5 with the logQ term (a template flag): p = 0 columns (clamped to
    1e-10), masked columns; the same tolerances as without it."""
    scores, masks = _retrieval_inputs(dev, q, c, dtype, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    prob = torch.randint(0, 9, (c,), generator=g, device=dev).float() / 37.0
    masks = dataclasses.replace(masks, candidate_sampling_probability=prob)
    loss, count, lse, ce = retrieval_fwd(scores, masks)
    gscale = torch.tensor(0.37, device=dev)
    ds = retrieval_bwd(scores, masks, lse, gscale)
    torch.cuda.synchronize()
    wloss, wcount, wlse, wce = _retrieval_fwd_plain(scores, masks)
    wds = _retrieval_bwd_plain(scores, masks, wlse, gscale)
    assert int(count) == int(wcount)
    assert abs(float(loss) - float(wloss)) <= 1e-5 * abs(float(wloss))
    torch.testing.assert_close(ce, wce, rtol=1e-5, atol=1e-5)
    scale = float(wds.float().abs().max())
    tol = (1e-5 * scale if dtype == torch.float32 or scale == 0
           else 2.0 ** (np.floor(np.log2(scale)) - 7))
    assert float((ds.float() - wds.float()).abs().max()) <= tol
    if int(count):     # a single query may be masked: nothing to move
        plain = retrieval_fwd(scores, dataclasses.replace(
            masks, candidate_sampling_probability=None))[0]
        assert float(plain) != float(loss)


def test_quantized_cms_train_steps_on_card_match_cpu(dev):
    """Two NALP steps over int8 features and an int8 cache with the sketch
    on (cached hop, tabularized): K12, K13, K14 and K5's logQ mode on the
    card against the CPU, from the CPU graph's quantized cache (the card
    builds its own from fp32 sums in another order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    anchors = rng.integers(0, N, (2, 64))
    out, cpu_cache = {}, None
    for device in (torch.device("cpu"), dev):
        g = DeviceGraph.from_hetero(
            HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                    node_features=x),
            supervision_edges=np.stack([src, dst]), quantize_features=True,
            device=device)
        _build.reset_launches()
        t = NALPTrainer(LinkPredictionGNN(GNNEncoder(16, 32, 16),
                                          LinkPredictionDecoder()),
                        g, NALPTrainerConfig(fanouts=(4, 3), cached_hop=True,
                                             quantize_cache=True,
                                             use_cms_correction=True,
                                             num_random_negs=64),
                        optimizer_args={"learning_rate": "0.01"},
                        device=device)
        if cpu_cache is None:
            cpu_cache = t.graph.nbr_cache
        else:
            t.graph = dataclasses.replace(t.graph, nbr_cache=QuantizedTable(
                cpu_cache.q.to(dev), cpu_cache.scale.to(dev)))
        state = t.init_state(0)
        state, losses = t.train_steps(state, anchors)
        out[device.type] = (losses.cpu(), {k: v.cpu() for k, v in
                                           t.model.state_dict().items()},
                            state.cms)
        if device.type == "cuda":
            for k in ("sample_uniform", "uniform_ids", "build_neighbor_cache",
                      "gather_rows", "gather_rows_q8", "masked_reduce",
                      "masked_reduce_bwd", "retrieval_loss", "cms_add",
                      "cms_estimate"):
                assert _build.launches[k] > 0, k
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, rtol=1e-4, atol=1e-5)
    assert torch.equal(out["cuda"][2].table.cpu(), out["cpu"][2].table)
    assert int(out["cuda"][2].total) == int(out["cpu"][2].total) == 2 * 128


# -- partitioned training: K15, K16, K1's row-offset mode, K17 ---------------

def _route_ids(g, hi, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, g).astype(np.int32)
    if g >= 6:
        ids[:3] = ids[3:6]
        ids[-1], ids[-2] = hi + 17, -5
    return torch.from_numpy(ids)


@pytest.mark.parametrize("num_shards", [1, 2, 4, 32])
@pytest.mark.parametrize("g,rows,cap", [(0, 40, 8), (1, 7, 8),
                                        (5000, 300, 700), (5000, 300, 64),
                                        (63_744, 25_000, 63_744)])
def test_route_requests_bit_equal(dev, num_shards, g, rows, cap):
    """K15 against its twin: an empty vector, one id, overflow, ids past
    the table and negative ids, the flagship's union size."""
    ids = _route_ids(g, num_shards * rows, seed=g + num_shards)
    want = fl._route_requests_plain(ids, rows, num_shards, cap)
    got = fl.route_requests(ids.to(dev), rows, num_shards, cap)
    for name, w, k in zip(("req", "owner", "pos", "ok"), want, got):
        assert torch.equal(k.cpu(), w), name


ROUTE_BATCH_CASES = [  # (G, rows per shard, capacity)
    (0, 40, 8), (1, 7, 8), (2047, 100, 300), (2049, 100, 3000),
    (4096, 300, 1200), (5000, 300, 700), (5000, 300, 64),
    (63_744, 25_000, 31_872)]


@pytest.mark.parametrize("num_shards", [1, 4, 32])
@pytest.mark.parametrize("g,rows,cap", ROUTE_BATCH_CASES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_route_requests_batched_bit_equal(dev, s, num_shards, g, rows, cap):
    """K15 over S request vectors in one call ([S, G]) against the twin of
    each vector alone, and the one-vector call [G] against the first row:
    duplicates, ids past the table and negative ids, overflow past C, an
    empty vector, G not a multiple of the tile, the flagship's union
    size."""
    ids = torch.stack([_route_ids(g, num_shards * rows, seed=g + v)
                       for v in range(s)])
    got = fl.route_requests(ids.to(dev), rows, num_shards, cap)
    assert got[0].shape == (s, num_shards, cap)
    for v in range(s):
        want = fl._route_requests_plain(ids[v], rows, num_shards, cap)
        for name, w, k in zip(("req", "owner", "pos", "ok"), want, got):
            assert torch.equal(k[v].cpu(), w), (v, name)
    one = fl.route_requests(ids[0].to(dev), rows, num_shards, cap)
    for a, b in zip(one, got):
        assert torch.equal(a, b[0])
    again = fl.route_requests(ids.to(dev), rows, num_shards, cap)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_route_requests_rejects_too_many_shards(dev):
    with pytest.raises(ValueError, match="shards"):
        fl.route_requests(torch.zeros(4, dtype=torch.int32, device=dev), 1,
                          fl.MAX_SHARDS + 1, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("width", [1, 10, 15, 129, 132])
@pytest.mark.parametrize("num_shards,cap", [(1, 300), (4, 40)])
def test_unroute_rows_bit_equal(dev, dtype, width, num_shards, cap):
    """K16 against its twin: 2- and 4-byte words and 16-byte rows, zero
    rows for dropped requests (cap 40 overflows)."""
    ids = _route_ids(300, num_shards * 100, seed=width)
    _, owner, pos, ok = fl._route_requests_plain(ids, 100, num_shards, cap)
    back = (torch.randn((num_shards, cap, width),
                        generator=torch.Generator().manual_seed(width))
            * 100).to(dtype)
    want = fl._unroute_plain(back, owner, pos, ok)
    got = fl.unroute_rows(back.to(dev), owner.to(dev), pos.to(dev),
                          ok.to(dev))
    assert got.dtype == dtype and torch.equal(got.cpu(), want)
    empty = fl.unroute_rows(back.to(dev), *(t[:0].to(dev)
                                            for t in (owner, pos, ok)))
    assert empty.shape == (0, width)


def test_sample_uniform_row_offset_mode(dev):
    """K1's row-offset mode against its twin on one shard's block, and
    against the plain mode over the global CSR for the shard's own ids."""
    csr = _csr(dev)
    ip, ix = dist_sampled._shard_csr(csr.indptr.cpu().numpy(),
                                     csr.indices.cpu().numpy(), 4, 175)
    for shard in range(4):
        lip = torch.from_numpy(ip[shard]).to(dev)
        lix = torch.from_numpy(ix[shard]).to(dev)
        frontier = _route_ids(3000, N, seed=shard).to(dev)
        got = sample_uniform(lip, lix, frontier, 10, 5, 2,
                             row_offset=shard * 175)
        want = _sample_uniform_plain(lip.cpu(), lix.cpu(), frontier.cpu(),
                                     10, 5, 2, row_offset=shard * 175)
        for k, w in zip(got, want):
            assert torch.equal(k.cpu(), w)
        own = torch.arange(shard * 175, (shard + 1) * 175, dtype=torch.int32,
                           device=dev)
        a = sample_uniform(lip, lix, own, 10, 5, 2, row_offset=shard * 175)
        b = sample_uniform(csr.indptr, csr.indices, own, 10, 5, 2)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _ring_case(dev, ql, cl, seed, own_labels=True):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(dev)

    scores = t((rng.normal(size=(ql, cl)) * 3).astype(np.float32))
    qids = t(rng.integers(0, max(ql // 2, 1), ql).astype(np.int32))
    own_pos = t(rng.integers(0, 50, ql).astype(np.int32))
    cids = t(rng.integers(0, 50, cl).astype(np.int32))
    pos_qids = np.full(cl, -1, np.int32)
    pos_qids[: min(ql, cl)] = qids.cpu().numpy()[: min(ql, cl)]
    cmask = rng.random(cl) < 0.8
    logq = np.log(np.clip(rng.integers(0, 5, cl) / 9.0, 1e-10, None))
    rows = sharded_retrieval.RingRows(
        temperature=0.07,
        label_cols=t(np.arange(ql, dtype=np.int32) if own_labels
                     else np.full(ql, cl + 5, np.int32)),
        query_ids=qids, own_pos_ids=own_pos)
    cols = sharded_retrieval.RingColumns(
        ids=cids, pos_qids=t(pos_qids), mask=t(cmask),
        log_q=t(logq.astype(np.float32)))
    state = torch.full((ql,), sharded_retrieval.FMIN, device=dev)
    return scores, rows, cols, state


@pytest.mark.parametrize("ql,cl", [(1, 40), (128, 256), (77, 1000),
                                   (9, 1100), (33, 70)])
@pytest.mark.parametrize("own", [True, False])
def test_ring_fold_and_backward_match_plain(dev, ql, cl, own):
    """K17's fold of three blocks [3, Ql, Cl] in one launch (the first own
    and fully masked, so every row is fully masked after it: the
    reference's guard; ``own`` False: no label columns) and its backward
    over the three, against the twins (rtol 1e-5: exps summed in another
    order) and bit for bit against three one-block launches in turn.
    Above 1,024 columns a lane recomputes its values for the exp-sum."""
    scores, rows, cols, m0 = _ring_case(dev, ql, cl, seed=ql + cl,
                                        own_labels=own)
    empty = dataclasses.replace(cols, mask=torch.zeros_like(cols.mask))
    blocks = [empty, cols, cols]
    stacked = sharded_retrieval.stack_columns(blocks)
    s3 = torch.stack([scores * (t + 1) for t in range(3)])
    run = {}
    for name, fold in (("kern", sharded_retrieval.ring_fold),
                       ("plain", sharded_retrieval._ring_fold_plain)):
        m, s, p = m0.clone(), torch.zeros_like(m0), torch.zeros_like(m0)
        before = _build.launches["ring_retrieval"]
        fold(s3, rows, stacked, True, m, s, p)
        if name == "kern":
            assert _build.launches["ring_retrieval"] == before + 1
        run[name] = (m, s, p)
    m, s, p = m0.clone(), torch.zeros_like(m0), torch.zeros_like(m0)
    for t, blk_cols in enumerate(blocks):
        sharded_retrieval.ring_fold(s3[t].contiguous(), rows, blk_cols,
                                    t == 0, m, s, p)
    for k, w, one in zip(run["kern"], run["plain"], (m, s, p)):
        torch.testing.assert_close(k, w, rtol=1e-5, atol=0)
        assert torch.equal(k, one)
    m, s, _ = run["plain"]
    lse = torch.log(torch.clamp(s, min=1e-30)) + m
    g = torch.rand((ql,), device=dev)
    got = sharded_retrieval.ring_block_bwd(s3, rows, stacked, True, lse, g)
    want = sharded_retrieval._ring_block_bwd_plain(s3, rows, stacked, True,
                                                   lse, g)
    assert got.shape == (3, ql, cl)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1e-30)
    assert not got[0].any()                  # the fully masked block
    for t, blk_cols in enumerate(blocks):
        assert torch.equal(got[t], sharded_retrieval.ring_block_bwd(
            s3[t].contiguous(), rows, blk_cols, t == 0, lse, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ql,cl,d", [(128, 256, 128), (5, 33, 16),
                                     (77, 1000, 64)])
def test_ring_block_scores_bit_equal(dev, dtype, ql, cl, d):
    """The ring loss's [P, Ql, Cl] scores: block t the bits of
    ``(q @ c_t.T).float()``, written in place where aligned."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(ql)
    q = torch.randn((ql, d), generator=g, device=dev).to(dtype)
    cands = [torch.randn((cl, d), generator=g, device=dev).to(dtype)
             for _ in range(4)]
    got = sharded_retrieval._block_scores(q, cands)
    for t, c in enumerate(cands):
        assert torch.equal(got[t], (q @ c.T).float())


def test_ring_retrieval_gradients_on_card_match_cpu(dev):
    """K17's autograd.Function on the card against the same function on
    the CPU: (ce_sum, count) and every gradient, 4 shards (ROADMAP C3), one
    fold and one backward launch a shard."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    p, ql, cl, d = 4, 32, 48, 16
    q0 = rng.normal(size=(p, ql, d)).astype(np.float32)
    c0 = rng.normal(size=(p, cl, d)).astype(np.float32)
    out = {}
    for device in (torch.device("cpu"), dev):
        mesh = Mesh(p, device)
        q = [torch.from_numpy(q0[s]).to(device).requires_grad_()
             for s in range(p)]
        c = [torch.from_numpy(c0[s]).to(device).requires_grad_()
             for s in range(p)]
        cols = [sharded_retrieval.RingColumns(
            ids=torch.arange(s * cl, (s + 1) * cl, dtype=torch.int32,
                             device=device),
            pos_qids=torch.full((cl,), -1, dtype=torch.int32, device=device),
            mask=torch.arange(cl, device=device) % 7 != 3) for s in range(p)]
        cv, colv = (sharded_retrieval.ring_blocks(mesh, x) for x in (c, cols))
        _build.reset_launches()
        total = sum(sharded_retrieval.ring_retrieval_loss(
            q[s], cv[s], colv[s], temperature=0.1,
            own_pos_ids=torch.arange(s * cl, s * cl + ql, dtype=torch.int32,
                                     device=device))[0] for s in range(p))
        total.backward()
        if device.type == "cuda":   # a fold and a backward a shard
            assert _build.launches["ring_retrieval"] == 2 * p
        out[device.type] = (total.detach().cpu(),
                            [x.grad.cpu() for x in q + c])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for k, w in zip(out["cuda"][1], out["cpu"][1]):
        assert float((k - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("ring", [False, True], ids=["per_shard", "ring"])
def test_partitioned_steps_on_card_match_cpu(dev, ring):
    """Three partitioned steps at 4 shards (the sketch on) on the card
    against the CPU: losses and weights within 1e-4 relative, the sketch
    bit-equal; every kernel of the path launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    anchors = rng.integers(0, N, (3, 64))
    out = {}
    for device in (torch.device("cpu"), dev):
        g = DeviceGraph.from_hetero(
            HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                    node_features=x),
            supervision_edges=np.stack([src, dst]), device=device)
        mesh = Mesh(4, device)
        model = LinkPredictionGNN(GNNEncoder(16, 32, 16),
                                  LinkPredictionDecoder())
        t = dist_sampled.PartitionedNALPTrainer(
            model, dist_sampled.PartitionedGraph.build(g, mesh), mesh,
            NALPTrainerConfig(fanouts=(4, 3), num_random_negs=64,
                              use_cms_correction=True,
                              global_candidate_pool=ring),
            optimizer_args={"learning_rate": "0.01"}, capacity_factor=8.0)
        state = t.init_state(0)
        _build.reset_launches()
        state, losses = t.train_steps(state, anchors)
        out[device.type] = (losses.cpu(), {k: v.cpu() for k, v in
                                           t.model.state_dict().items()},
                            state.cms)
        if device.type == "cuda":
            for k in ("sample_uniform", "uniform_ids", "gather_rows",
                      "masked_reduce", "masked_reduce_bwd", "cms_add",
                      "cms_estimate", "route_requests", "unroute_rows",
                      "ring_retrieval" if ring else "retrieval_loss"):
                assert _build.launches[k] > 0, k
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, rtol=1e-4, atol=1e-5)
    assert torch.equal(out["cuda"][2].table.cpu(), out["cpu"][2].table)
    assert int(out["cuda"][2].total) == int(out["cpu"][2].total) == 3 * 128


def _ring_bucket(dev, rows, m, e, d, hub=False, seed=0, misalign=False):
    """One bucket's row-sorted edges: (x [m, d], acc [rows, d] random, ptr,
    row, col, w) on ``dev``; ``hub``: every edge on row 3."""
    rng = np.random.default_rng(seed)
    row = (np.full(e, 3) if hub else rng.integers(0, rows, e)).astype(
        np.int32)
    col = rng.integers(0, m, e).astype(np.int32)
    order = np.argsort(row, kind="stable")
    row, col = row[order], col[order]
    ptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=rows))])
    w = rng.random(e).astype(np.float32)
    x = rng.normal(size=(m, d)).astype(np.float32)
    if misalign:        # a base 4 bytes past a 16-byte boundary
        flat = torch.zeros(m * d + 1)
        flat[1:] = torch.from_numpy(x).reshape(-1)
        xt = flat.to(dev)[1:].view(m, d)
    else:
        xt = torch.from_numpy(x).to(dev)
    acc = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (xt, acc.to(dev), t(ptr.astype(np.int32)), t(row), t(col), t(w))


@pytest.mark.parametrize("case", ["bucket", "hub", "rows37"])
@pytest.mark.parametrize("d,misalign", [(256, False), (128, False),
                                        (7, False), (4, True), (1, False),
                                        (33, False)])
def test_ring_spmm_bucket_matches_plain(dev, case, d, misalign):
    rows, m, e = {"bucket": (1000, 1200, 9000), "hub": (50, 900, 5000),
                  "rows37": (37, 300, 700)}[case]
    x, acc, ptr, row, col, w = _ring_bucket(dev, rows, m, e, d,
                                            hub=case == "hub",
                                            misalign=misalign)
    if misalign:
        assert x.data_ptr() % 16 != 0
    want = halo._ring_spmm_bucket_plain(x, acc.clone(), ptr, row, col, w)
    _build.reset_launches()
    got = halo.ring_spmm_bucket(x, acc.clone(), ptr, row, col, w)
    again = halo.ring_spmm_bucket(x, acc.clone(), ptr, row, col, w)
    torch.cuda.synchronize()
    assert _build.launches["ring_spmm"] == 2
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, again)
    untouched = torch.diff(ptr.long()) == 0
    assert torch.equal(got[untouched], acc[untouched])


def test_ring_spmm_bucket_empty_launches_nothing(dev):
    x, acc, ptr, row, col, w = _ring_bucket(dev, 40, 50, 0, 8)
    _build.reset_launches()
    got = halo.ring_spmm_bucket(x, acc.clone(), ptr, row, col, w)
    torch.cuda.synchronize()
    assert _build.launches["ring_spmm"] == 0
    assert torch.equal(got, acc)


def _ring_graph(n, e, seed, hub=False):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if hub:
        dst[: e // 2] = 5          # a destination hub of e / 2 edges
    return np.stack([src, dst]), rng.random(e).astype(np.float32)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("num_shards", [1, 4, 5])
def test_ring_spmm_gradients_on_card_match_cpu(dev, num_shards, reduce):
    """ring_spmm's autograd.Function on the card against the CPU: the
    output and the input's gradient through two stacked rings, P^2 forward
    launches a ring (every bucket non-empty here) and P^2 transposed ones
    a ring that needs a gradient (ROADMAP C3)."""
    edges, w = _ring_graph(1003, 20000, seed=num_shards, hub=True)
    g0 = np.random.default_rng(1).normal(size=(1005, 24)).astype(np.float32)
    x0 = np.random.default_rng(2).normal(size=(1003, 24)).astype(np.float32)
    out = {}
    for device in (torch.device("cpu"), dev):
        mesh = Mesh(num_shards, device)
        sched = halo.build_ring_schedule(edges, 1003, num_shards,
                                         edge_weight=w)
        assert (sched.counts > 0).all()
        placed = halo.put_ring_schedule(sched, mesh)
        x = shard_features_rowwise(x0, mesh)
        pad = x.shape[0]
        x = x.requires_grad_()
        g = torch.from_numpy(g0[:pad]).to(device)
        _build.reset_launches()
        y = halo.ring_spmm(torch.tanh(halo.ring_spmm(x, placed, mesh,
                                                     reduce=reduce)),
                           placed, mesh, reduce=reduce)
        (y * g).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert _build.launches["ring_spmm"] == 4 * num_shards ** 2
        out[device.type] = (y.detach().cpu(), x.grad.cpu())
    for k, c in zip(out["cuda"], out["cpu"]):
        assert float((k - c).abs().max()) <= 1e-5 * float(c.abs().max())


@pytest.mark.parametrize("conv", ["gcn", "graphsage"])
def test_sharded_full_batch_steps_on_card_match_cpu(dev, conv):
    """Three steps at 4 shards on the card against the CPU from the same
    seeded params: losses and weights within 1e-4 relative; 48 K18
    launches a step (two rings forward, the second one's backward)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    n = 1001
    edges = np.stack([rng.integers(0, n, 12000), rng.integers(0, n, 12000)])
    x = rng.normal(size=(n, 32)).astype(np.float32)
    labels = rng.integers(0, 7, n)
    masks = rng.random((3, n)) < np.array([[0.6], [0.2], [0.2]])
    out = {}
    for device in (torch.device("cpu"), dev):
        t = sfb.ShardedFullBatchTrainer(
            edges, x, labels, *masks, Mesh(4, device),
            sfb.ShardedFullBatchConfig(conv=conv, hid_dim=64, out_dim=7),
            optimizer_args={"learning_rate": "0.01"})
        state = t.init_state(0)
        _build.reset_launches()
        losses = []
        for _ in range(3):
            state, loss = t.train_step(state)
            losses.append(loss)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert _build.launches["ring_spmm"] == 3 * 48
        out[device.type] = (torch.stack(losses).cpu(),
                            {k: v.cpu() for k, v in
                             t.model.state_dict().items()})
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, rtol=1e-4, atol=1e-5)


def _weighted_csr(dev, kind, seed=0):
    """A CSR of 700 rows (degrees 0-60, a hub of 1,500 beyond every window,
    three isolated rows) with weights: continuous, tied integers 0-3 with
    negatives, or continuous with +inf and NaN entries (two +inf in the
    hub's first 32 slots)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 61, N)
    deg[11] = 1500
    deg[[5, 6, 699]] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(indptr[-1])
    w = (rng.integers(-1, 4, e) if kind == "tied"
         else rng.random(e)).astype(np.float32)
    if kind == "special":
        w[rng.integers(0, e, 30)] = np.inf
        w[rng.integers(0, e, 30)] = np.nan
        w[indptr[11] + 3] = w[indptr[11] + 20] = np.inf
    return DeviceCSR(torch.from_numpy(indptr).to(dev),
                     torch.from_numpy(rng.integers(0, N, e).astype(
                         np.int32)).to(dev),
                     torch.from_numpy(w).to(dev))


@pytest.mark.parametrize("window,fanout", [(32, 32), (128, 15), (128, 128),
                                           (1024, 40), (1024, 1024),
                                           (200, 33), (8, 3)])
@pytest.mark.parametrize("kind", ["continuous", "tied", "special"])
@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_sample_weighted_bit_equal(dev, method, kind, window, fanout):
    """K19 against its twin on the card: windows of one to 32 keys a lane,
    fanout = window, all-invalid rows, a hub beyond the window, ties, +inf
    and NaN scores; the seed and hop wrap mod 2**32."""
    csr = _weighted_csr(dev, kind)
    frontier = torch.cat([torch.arange(N, dtype=torch.int32, device=dev),
                          torch.tensor([5, 11], dtype=torch.int32,
                                       device=dev)]).reshape(-1, 3)
    before = _build.launches["sample_weighted"]
    got = sample_weighted(csr.indptr, csr.indices, csr.edge_weights,
                          frontier, fanout, window, method, 2**32 - 3,
                          2**31 + 7)
    torch.cuda.synchronize()
    assert _build.launches["sample_weighted"] == before + 1
    want = _sample_weighted_plain(csr.indptr, csr.indices, csr.edge_weights,
                                  frontier, fanout, window, method,
                                  2**32 - 3, 2**31 + 7)
    for g, w in zip(got, want):
        assert g.shape == frontier.shape + (fanout,)
        assert torch.equal(g, w)
    assert not got[1].reshape(-1, fanout)[[5, 6, 699]].any()


@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_sample_weighted_row_offset_mode(dev, method):
    """The owner-side draw over one shard's row block (global ids, local
    rows clipped, the hash keyed by the global id) is the replicated draw
    for the shard's own ids and the twin's for every id."""
    csr = _weighted_csr(dev, "tied", 1)
    ip = csr.indptr.cpu().numpy()
    lo, hi = 200, 400
    local_ip = torch.from_numpy(ip[lo: hi + 1] - ip[lo]).to(dev)
    local_ix = csr.indices[ip[lo]: ip[hi]].contiguous()
    local_w = csr.edge_weights[ip[lo]: ip[hi]].contiguous()
    ids = torch.arange(0, N, dtype=torch.int32, device=dev)
    got = sample_weighted(local_ip, local_ix, local_w, ids, 10, 128, method,
                          9, 4, row_offset=lo)
    want = _sample_weighted_plain(local_ip, local_ix, local_w, ids, 10, 128,
                                  method, 9, 4, row_offset=lo)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    repl = sample_weighted(csr.indptr, csr.indices, csr.edge_weights,
                           ids[lo:hi], 10, 128, method, 9, 4)
    assert torch.equal(got[0][lo:hi], repl[0])
    assert torch.equal(got[1][lo:hi], repl[1])


def test_sample_weighted_raises_on_what_it_does_not_take(dev):
    csr = _weighted_csr(dev, "continuous")
    ids = torch.arange(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="window"):
        sample_weighted(csr.indptr, csr.indices, csr.edge_weights, ids, 9, 8,
                        "top_k", 0, 1)
    with pytest.raises(ValueError, match="exceeds"):
        sample_weighted(csr.indptr, csr.indices, csr.edge_weights, ids, 9,
                        2048, "top_k", 0, 1)
    with pytest.raises(ValueError, match="f32"):
        sample_weighted(csr.indptr, csr.indices, csr.edge_weights.double(),
                        ids, 3, 8, "top_k", 0, 1)


# degrees at K19's key-register boundaries, and a hub past every window
K19_DEGREES = (0, 1, 31, 32, 33, 64, 65, 127, 128, 129, 1500)


def _boundary_csr(dev, kind):
    """Each degree of K19_DEGREES five times, in shuffled rows, with
    continuous, equal, or NaN / +inf / -inf-sprinkled weights."""
    rng = np.random.default_rng(len(kind))
    deg = rng.permutation(np.repeat(np.array(K19_DEGREES), 5))
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(indptr[-1])
    w = (np.ones(e) if kind == "equal" else rng.random(e)).astype(np.float32)
    if kind == "special":
        for value, count in ((np.nan, 80), (np.inf, 40), (-np.inf, 40)):
            w[rng.integers(0, e, count)] = value
    return DeviceCSR(torch.from_numpy(indptr).to(dev),
                     torch.from_numpy(rng.integers(0, N, e).astype(
                         np.int32)).to(dev),
                     torch.from_numpy(w).to(dev))


@pytest.mark.parametrize("window,fanout", [
    (32, 1), (32, 15), (32, 32), (128, 1), (128, 15), (128, 32), (128, 33),
    (128, 128), (1024, 15), (1024, 33), (1024, 128), (1024, 1024)])
@pytest.mark.parametrize("kind", ["continuous", "equal", "special"])
@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_sample_weighted_register_boundaries(dev, method, kind, window,
                                             fanout):
    """K19 bit-equal to its twin at the degrees where its live key
    registers change (0, 1, 31-33, 64, 65, 127-129, and a hub of 1,500),
    at windows 32, 128 and 1024, fanouts 1, 15, 32, 33, 128 and the
    window, with ties, NaN and +-inf weights; and in the row-offset
    mode."""
    csr = _boundary_csr(dev, kind)
    n = csr.indptr.shape[0] - 1
    frontier = torch.arange(n, dtype=torch.int32, device=dev)
    args = (csr.indptr, csr.indices, csr.edge_weights, frontier, fanout,
            window, method, 5, 3)
    for g, w in zip(sample_weighted(*args), _sample_weighted_plain(*args),
                    strict=True):
        assert torch.equal(g, w)
    ip = csr.indptr.cpu().numpy()
    lo, hi = 10, 40
    local = (torch.from_numpy(ip[lo: hi + 1] - ip[lo]).to(dev),
             csr.indices[ip[lo]: ip[hi]].contiguous(),
             csr.edge_weights[ip[lo]: ip[hi]].contiguous())
    args = local + (frontier, fanout, window, method, 5, 3, lo)
    for g, w in zip(sample_weighted(*args), _sample_weighted_plain(*args),
                    strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("method,fanout", [
    ("weighted", 10), ("top_k", 10), ("weighted", 40), ("top_k", 128)])
def test_neighbor_cache_weighted_bit_equal_in_slot_order(dev, method, fanout,
                                                         agg, quantized):
    """K2's weighted and top-k modes give the bits of K19's draw over the
    first 128 slots followed by an fp32 sum of the drawn rows in slot
    order (then one division for the mean), as K2 adds them."""
    csr = _weighted_csr(dev, "special", 3)
    rng = np.random.default_rng(fanout)
    x = rng.normal(size=(N, 64)).astype(np.float32)
    feats = (QuantizedTable.quantize(x, device=dev) if quantized
             else torch.from_numpy(x).to(dev))
    out = build_neighbor_cache(csr, feats, fanout=fanout, seed=7, hop_key=2,
                               agg=agg, method=method)
    frontier = torch.arange(N, dtype=torch.int32, device=dev)
    ids, mask, _ = sample_weighted(csr.indptr, csr.indices, csr.edge_weights,
                                   frontier, fanout, 128, method, 7, 2)
    rows = (feats.q[ids.long()].float() * feats.scale.reshape(-1)[
        ids.long()][..., None] if quantized else feats[ids.long()])
    acc = torch.zeros((N, 64), device=dev)
    for s in range(fanout):
        acc = torch.where(mask[:, s, None], acc + rows[:, s], acc)
    if agg == "mean":
        acc = acc / mask.sum(1).clamp(min=1).float()[:, None]
    assert torch.equal(out, acc)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("agg", ["mean", "sum", "gcn"])
@pytest.mark.parametrize("method,fanout,dim", [
    ("weighted", 10, 128), ("top_k", 40, 132), ("weighted", 128, 16)])
def test_neighbor_cache_weighted_matches_plain(dev, method, fanout, dim, agg,
                                               quantized):
    """K2's weighted mode (K19's draw over the first 128 slots, in the
    same warp) against its twin: fp32 within 1e-5 of the output's scale
    (sums of up to 128 rows in another order; a flat atol of 1e-6 does not
    hold for sums of 40-128 rows that cancel, measured 1.6e-6 on values of
    scale ~40)."""
    csr = _weighted_csr(dev, "special", 2)
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(N, dim)).astype(np.float32)
    feats = (QuantizedTable.quantize(x, device=dev) if quantized
             else torch.from_numpy(x).to(dev))
    deg = torch.diff(csr.indptr).float()
    before = _build.launches["build_neighbor_cache"]
    out = build_neighbor_cache(csr, feats, fanout=fanout, seed=7, hop_key=2,
                               agg=agg, degrees=deg, method=method)
    torch.cuda.synchronize()
    assert _build.launches["build_neighbor_cache"] == before + 1
    want = torch.empty((N, dim), device=dev)
    _neighbor_cache_plain(csr, feats, fanout, 7, 2, agg, deg, want,
                          method=method)
    _within(out, want, torch.float32)
    assert torch.equal(out[[5, 6, 699]], torch.zeros_like(out[:3]))


# -- K8's composed mode and K6b's composed transpose table ----------------------
def _composed_graph(dev, seed=0):
    """Segment ids on the card, shuffled, with an odd edge count: segments
    0-6 of 0, 1, 2, 3, 31, 33 and 5,000 edges, the rest random (so that
    K8's two slots in flight end on an odd tail); source ids over 4,000
    rows; the index built with them (``gather``: K8's composed mode)."""
    rng = np.random.default_rng(seed)
    s = 2000
    ids = np.concatenate([rng.integers(7, s, 14_013)]
                         + [np.full(d, seg) for seg, d in
                            enumerate((0, 1, 2, 3, 31, 33, 5000))])
    ids = torch.as_tensor(rng.permutation(ids).astype(np.int32), device=dev)
    src = torch.as_tensor(rng.integers(0, 4000, ids.shape[0]).astype(
        np.int32), device=dev)
    assert ids.shape[0] % 2 == 1
    return ids, src, SegmentIndex.from_ids(ids, s, gather=src)


def _k8_modes():
    """K8's launches with a gather so far: (composed, chained)."""
    return (_build.launches["segment_reduce_composed"],
            _build.launches["segment_reduce_chained"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("weights", ["none", "edge", "head"])
@pytest.mark.parametrize("heads,dk,shift", [
    (4, 64, 0), (4, 4, 0), (1, 3, 0), (4, 32, 4), (1, 8, 4)])
def test_segment_reduce_composed_and_chained_modes_agree(
        dev, dtype, op, weights, heads, dk, shift):
    """K8 given the tensor its index was built from (the composed mode:
    each slot's row read from ``index.gathered``) and a copy of it (the
    chained mode: order, then src): one launch each, counted by mode,
    bit-equal to each other and on a repeat launch, and within the
    twin's tolerance; rows of 1 KB to 12 bytes (the vector and the scalar
    paths), tables 4 bytes past a 16-byte boundary (``shift``); without
    a gather K8 reads rows per edge."""
    ids, src, index = _composed_graph(dev)
    e, s = index.num_edges, index.num_segments
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((4000, heads * dk), generator=g, device=dev)
    if op == "max":
        x = (x * 2).round()                               # ties
    x = x.to(dtype)
    if shift:
        x = _shifted(x, shift)
    w = {"none": None,
         "edge": torch.rand((e,), generator=g, device=dev),
         "head": torch.rand((e, heads), generator=g, device=dev)}[weights]
    composed0, chained0 = _k8_modes()
    launches = _build.launches["segment_reduce"]
    got = segment_reduce(x, ids, s, op=op, src=src, weight=w, index=index)
    torch.cuda.synchronize()
    assert _k8_modes() == (composed0 + 1, chained0)
    chained = segment_reduce(x, ids, s, op=op, src=src.clone(), weight=w,
                             index=index)
    torch.cuda.synchronize()
    assert _k8_modes() == (composed0 + 1, chained0 + 1)
    assert _build.launches["segment_reduce"] == launches + 2
    assert torch.equal(got, chained)
    assert torch.equal(got, segment_reduce(x, ids, s, op=op, src=src,
                                           weight=w, index=index))
    want = _segment_reduce_plain(x, ids, s, op, src, w)
    assert got.dtype == dtype and got.shape == (s, heads * dk)
    _within(got, want, dtype)
    assert not got[0].any()                       # an empty segment: 0
    rows = segment_reduce(x[src.long()], ids, s, op=op, weight=w,
                          index=index)            # per-edge rows, no gather
    assert torch.equal(rows, got)


def test_segment_reduce_mismatched_src_takes_the_chained_mode(dev):
    """Other source ids than the index's (a different tensor with other
    values): the chained mode reads them, and the result is theirs."""
    ids, src, index = _composed_graph(dev)
    s = index.num_segments
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((4000, 64), generator=g, device=dev)
    other = torch.flip(src, (0,)).contiguous()
    composed0, chained0 = _k8_modes()
    got = segment_reduce(x, ids, s, src=other, index=index)
    torch.cuda.synchronize()
    assert _k8_modes() == (composed0, chained0 + 1)
    _within(got, _segment_reduce_plain(x, ids, s, "sum", other),
            torch.float32)


def test_segment_reduce_src_changed_in_place_takes_the_chained_mode(dev):
    """The index's own src tensor, changed in place after the build (its
    version counter moved): K8 reads the new ids through the chained mode,
    not the stale composed rows, and agrees with its twin on them."""
    ids, src, index = _composed_graph(dev)
    s = index.num_segments
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn((4000, 64), generator=g, device=dev)
    src.copy_(torch.flip(src, (0,)))
    assert segment_ops.gather_mode(src, index) == "chained"
    composed0, chained0 = _k8_modes()
    got = segment_reduce(x, ids, s, src=src, index=index)
    torch.cuda.synchronize()
    assert _k8_modes() == (composed0, chained0 + 1)
    _within(got, _segment_reduce_plain(x, ids, s, "sum", src),
            torch.float32)


def test_segment_reduce_inference_src_changed_in_place_takes_the_chained_mode(
        dev):
    """ROADMAP C10 on the card: an index built under inference mode keeps
    its own copy of the inference src; that src changed in place runs the
    chained mode and sums the new rows (segment 0: x[1], not the stale
    x[3]), and so does the index's copy changed in place under inference
    mode (its version counter moves); the twin's results, bit for bit."""
    x = torch.arange(16.0, device=dev).reshape(4, 4)
    with torch.inference_mode():
        dst = torch.tensor([0, 1, 1, 2], dtype=torch.int32, device=dev)
        src = torch.tensor([3, 2, 1, 0], dtype=torch.int32, device=dev)
        index = SegmentIndex.from_ids(dst, 3, gather=src)
        assert index.gather is not src and not index.gather.is_inference()
        src[0] = 1
        for ids in (src, index.gather):
            if ids is index.gather:
                ids[0] = 1
            composed0, chained0 = _k8_modes()
            got = segment_reduce(x, dst, 3, src=ids, index=index)
            torch.cuda.synchronize()
            assert _k8_modes() == (composed0, chained0 + 1)
            assert torch.equal(got, _segment_reduce_plain(
                x.cpu(), dst.cpu(), 3, "sum", ids.cpu()).to(dev))
            assert torch.equal(got[0], x[1])


def _k8b_modes():
    """K8b's launches over a source walk so far: (composed, chained)."""
    return (_build.launches["segment_reduce_bwd_composed"],
            _build.launches["segment_reduce_bwd_chained"])


def _k8b_graph(dev, seed=25):
    """20,001 edges from 4,000 sources (a hub of 1,000 edges; sources
    3,900-3,999 read by none) into 2,000 destinations; the destination
    index built with the sources and the source index with the
    destination ids (K8 and K8b composed)."""
    rng = np.random.default_rng(seed)
    e = 20_001
    src = rng.integers(0, 3900, e)
    src[:1000] = 7
    src = rng.permutation(src)
    ids = rng.integers(0, 2000, e)
    ids, src = (torch.as_tensor(a.astype(np.int32), device=dev)
                for a in (ids, src))
    return (ids, src, SegmentIndex.from_ids(ids, 2000, gather=src),
            SegmentIndex.from_ids(src, 4000, gather=ids))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("weights", ["none", "edge", "head"])
@pytest.mark.parametrize("heads,dk", [(4, 64), (4, 4), (1, 3), (1, 8)])
def test_segment_reduce_bwd_composed_and_chained_modes_agree(
        dev, dtype, op, weights, heads, dk):
    """K8b given the destination ids its source index was built from (the
    composed mode: each slot's destination read from the index's
    ``gathered``) and a copy of them (the chained mode: order, then the
    ids): one launch each, counted by mode, bit-equal to each other and on
    a repeat launch, within the twin's tolerance; rows of 1 KB to 12 bytes
    (the vector and the scalar paths), a 1,000-edge source hub, sources
    without edges (0)."""
    ids, src, index, src_index = _k8b_graph(dev)
    e, s, c = index.num_edges, index.num_segments, heads * dk
    g = torch.Generator(device=dev).manual_seed(26)
    cot = torch.randn((s, c), generator=g, device=dev).to(dtype)
    x = None
    if op == "max":
        x = (torch.randn((4000, c), generator=g, device=dev) * 2).round(
        ).to(dtype)                                        # ties
    w = {"none": None,
         "edge": torch.rand((e,), generator=g, device=dev),
         "head": torch.rand((e, heads), generator=g, device=dev)}[weights]

    def k8b(ids_):
        return segment_reduce_bwd(cot, ids_, 4000, op=op, src=src, weight=w,
                                  x=x, index=index, src_index=src_index)

    composed0, chained0 = _k8b_modes()
    got = k8b(ids)
    torch.cuda.synchronize()
    assert _k8b_modes() == (composed0 + 1, chained0)
    chained = k8b(ids.clone())
    torch.cuda.synchronize()
    assert _k8b_modes() == (composed0 + 1, chained0 + 1)
    assert torch.equal(got, chained)
    assert torch.equal(got, k8b(ids))
    want = _segment_reduce_bwd_plain(cot, ids, 4000, op, src, w, x)
    assert got.dtype == dtype and got.shape == (4000, c)
    _within(got, want, dtype)
    assert not got[3900:].any()                   # no edges: 0


def test_segment_reduce_bwd_ids_changed_in_place_take_the_chained_mode(dev):
    """K8b's side of ROADMAP C10: the source index's own destination ids,
    changed in place after the build, and an inference tensor's, changed
    under inference mode (the index keeps a copy), run the chained mode
    and add to the new destinations, as the twin does."""
    ids, src, index, src_index = _k8b_graph(dev)
    g = torch.Generator(device=dev).manual_seed(27)
    cot = torch.randn((2000, 64), generator=g, device=dev)
    ids.copy_(torch.flip(ids, (0,)))
    composed0, chained0 = _k8b_modes()
    got = segment_reduce_bwd(cot, ids, 4000, op="mean", src=src,
                             src_index=src_index)
    torch.cuda.synchronize()
    assert _k8b_modes() == (composed0, chained0 + 1)
    _within(got, _segment_reduce_bwd_plain(cot.cpu(), ids.cpu(), 4000,
                                           "mean", src.cpu()).to(dev),
            torch.float32)
    with torch.inference_mode():
        dst = torch.tensor([0, 1, 1, 2], dtype=torch.int32, device=dev)
        s4 = torch.tensor([3, 2, 1, 0], dtype=torch.int32, device=dev)
        sidx = SegmentIndex.from_ids(s4, 4, gather=dst)
        assert sidx.gather is not dst and not sidx.gather.is_inference()
        dst[0] = 1
        g4 = cot[:3, :4].contiguous()
        composed0, chained0 = _k8b_modes()
        got = segment_reduce_bwd(g4, dst, 4, src=s4, src_index=sidx)
        torch.cuda.synchronize()
        assert _k8b_modes() == (composed0, chained0 + 1)
        assert torch.equal(got[3], g4[1])


def _softmax_graph(dev, seed=28):
    """Segments of 0, 1, 16, 17, 32, 33 and 1,000 edges, then 3,000 of
    Poisson(20) edges and 500 of Poisson(3) (a warp's lane groups hold
    several segments; some spill past a group's registers), the edges in
    random order."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([[0, 1, 16, 17, 32, 33, 1000],
                            rng.poisson(20, 3000), rng.poisson(3, 500)])
    ids = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    ids = torch.as_tensor(ids.astype(np.int32), device=dev)
    return ids, SegmentIndex.from_ids(ids, len(sizes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2, 4, 8, 16, 17])
def test_segment_softmax_forms_agree(dev, dtype, heads):
    """K9 over lane groups that hold several segments (a warp each above 4
    heads), whose rows stay in registers or, past a group's capacity, are
    read again in three passes, and over rows 4 bytes off a 16-byte
    boundary (the re-reading form, a value at a time): the same bits in
    every form and on a repeat run, zeros for
    a segment of -inf logits, and within the twin's tolerance (fp32 5e-5
    absolute, the 1,000-edge segment summed in another order; bf16 2**-8)
    outside a segment with a row of NaN logits. There the clamp keeps the
    NaN sum, so the whole segment is NaN, as the twin's torch.clamp and the
    reference's jnp.maximum give (ROADMAP C11: the first version's fmaxf
    dropped it, and only the NaN row was NaN); K9b over that alpha is NaN
    where its twin is."""
    ids, index = _softmax_graph(dev)
    e, s = index.num_edges, index.num_segments
    g = torch.Generator(device=dev).manual_seed(29)
    shape = (e,) if heads == 1 else (e, heads)
    logits = torch.randn(shape, generator=g, device=dev) * 4
    logits[ids == 8] = float("-inf")
    logits[int(torch.nonzero(ids == 9)[0])] = float("nan")
    logits = logits.to(dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    outs = [segment_softmax(t, ids, s, index=index)
            for t in (logits, _shifted(logits), logits)]
    for other in outs[1:]:
        assert torch.equal(outs[0].view(bits), other.view(bits))
    got = outs[0]
    want = _segment_softmax_plain(logits, ids, s)
    poisoned = ids == 9
    assert torch.isnan(want[poisoned]).all()
    assert torch.isnan(got[poisoned]).all()
    assert not torch.isnan(got[~poisoned]).any()
    assert not got[ids == 8].any()
    tol = 5e-5 if dtype == torch.float32 else 2.0 ** -8
    err = (got.float() - want.float())[~poisoned].abs().max()
    assert float(err) <= tol
    if heads <= 16:                      # K9b takes at most 16 heads
        cot = torch.randn(shape, generator=g, device=dev).to(dtype)
        d_got = segment_softmax_bwd(got, cot, ids, s, index=index)
        d_want = _segment_softmax_bwd_plain(got, cot, ids, s)
        assert torch.isnan(d_got[poisoned]).all()
        assert torch.equal(torch.isnan(d_got), torch.isnan(d_want))


def _fmaf(a, b, c):
    """fp32 fmaf(a, b, c) on the CPU, rounded once: the product is exact in
    float64, and the float64 sum's own rounding error (TwoSum) decides a
    float32 tie that the sum lands on."""
    p_, c64 = a.double() * b.double(), c.double()
    s_ = p_ + c64
    bb = s_ - p_
    err = (p_ - (s_ - bb)) + (c64 - bb)
    r = s_.float()
    d = s_ - r.double()
    nxt = torch.nextafter(r, torch.where(d > 0, float("inf"),
                                         float("-inf")).float())
    tie = (d != 0) & (s_ == (r.double() + nxt.double()) / 2)
    past = tie & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(past, nxt, r)


def _k9b_first_bits(alpha, g, ids, index):
    """K9b's first version on the CPU, operation for operation: a warp a
    segment, lane L summing fmaf(alpha, g) over the slots L, L + 32, ... in
    slot order, the lanes reduced by an xor butterfly (16, 8, 4, 2, 1),
    then alpha * (g - sum), rounded once to alpha's type."""
    e, s = index.num_edges, index.num_segments
    a = alpha.float().reshape(e, -1).cpu()
    gf = g.float().reshape(a.shape).cpu()
    order, ptr = index.order.long().cpu(), index.ptr.long().cpu()
    seg = torch.repeat_interleave(torch.arange(s), ptr[1:] - ptr[:-1])
    k = torch.arange(e) - ptr[seg]
    x = torch.zeros((s, 32, a.shape[1]))
    for u in range(int(k.max()) // 32 + 1 if e else 0):
        sel = k // 32 == u
        at, ln, ed = seg[sel], k[sel] % 32, order[sel]
        x[at, ln] = _fmaf(a[ed], gf[ed], x[at, ln])
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, torch.arange(32) ^ off]
    out = a * (gf - x[:, 0][ids.long().cpu()])
    return out.reshape(alpha.shape).to(alpha.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2, 3, 4, 8, 16])
def test_segment_softmax_bwd_forms_agree(dev, dtype, heads):
    """K9b over lane groups that hold several segments (16 lanes up to 4
    heads, a warp above), whose rows stay in registers or, past a group's
    capacity, are read again in two passes (segments of 33 to 1,000 edges
    and a 10^4 hub), and over rows 4 bytes off a 16-byte boundary (the
    passes a value at a time, a warp a segment): every form gives the
    first version's bits (a CPU replay of its fmaf and butterfly order),
    the same on a repeat run, and stays within the twin's tolerance (fp32
    1e-4, bf16 2e-2 of the scale). A NaN in g makes its segment's head NaN,
    as in the twin."""
    ids, index = _softmax_graph(dev)
    hub = torch.full((10_000,), 5, dtype=torch.int32, device=dev)
    ids = torch.cat([ids, hub])[torch.randperm(
        ids.shape[0] + 10_000, generator=torch.Generator().manual_seed(30))
        .to(dev)]
    s = index.num_segments
    index = SegmentIndex.from_ids(ids, s)
    e = index.num_edges
    gen = torch.Generator(device=dev).manual_seed(31)
    shape = (e,) if heads == 1 else (e, heads)
    alpha = segment_softmax(torch.randn(shape, generator=gen, device=dev)
                            * 4, ids, s, index=index).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev)
    poisoned = int(torch.nonzero(ids == 9)[0])
    g[poisoned] = float("nan")
    g = g.to(dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    outs = [segment_softmax_bwd(a_, g_, ids, s, index=index)
            for a_, g_ in ((alpha, g), (_shifted(alpha), _shifted(g)),
                           (alpha, g))]
    want = _k9b_first_bits(alpha, g, ids, index).to(dev)
    nan = torch.isnan(want)
    assert nan[ids == 9].all() and not nan[ids != 9].any()
    for got in outs:
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(bits), want[~nan].view(bits))
    twin = _segment_softmax_bwd_plain(alpha, g, ids, s)
    fin = ~torch.isnan(twin)
    scale = float(twin[fin].float().abs().max())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((outs[0][fin].float() - twin[fin].float()).abs().max()) \
        <= tol * scale


def test_coo_spmm_composed_gradients_on_card_match_cpu(dev):
    """coo_spmm over an index built with its gather (K8 composed forward,
    K8b over the source index, K10 for the weights) and the sddmm backward's
    dq (K8 composed) on the card against the CPU (fp32: 1e-5 of each
    gradient's scale)."""
    ids_d, src_d, index = _composed_graph(dev)
    e, s = index.num_edges, index.num_segments
    rng = np.random.default_rng(23)
    arrays = {"q": rng.normal(size=(s, 4, 16)),
              "k": rng.normal(size=(4000, 4, 16)),
              "v": rng.normal(size=(4000, 4, 16)),
              "w": rng.random((e, 4)), "g_score": rng.normal(size=(e, 4)),
              "g_out": rng.normal(size=(s, 4, 16))}
    grads = {}
    for device in (dev, torch.device("cpu")):
        t = {k_: torch.tensor(a, dtype=torch.float32, device=device)
             .requires_grad_(not k_.startswith("g_"))
             for k_, a in arrays.items()}
        ids, src = ids_d.to(device), src_d.to(device)
        idx = (index if device == dev
               else SegmentIndex.from_ids(ids, s, gather=src))
        sidx = SegmentIndex.from_ids(src, 4000)
        composed0, chained0 = _k8_modes()
        score = sddmm(src, ids, t["q"], t["k"], index=idx, src_index=sidx)
        out = segment_ops.coo_spmm(src, ids, t["v"], s, edge_weight=t["w"],
                                   index=idx, src_index=sidx)
        ((score * t["g_score"]).sum() + (out * t["g_out"]).sum()).backward()
        if device == dev:   # the forward and the backward's dq
            assert _k8_modes() == (composed0 + 2, chained0)
        grads[device.type] = {k_: t[k_].grad.cpu() for k_ in
                              ("q", "k", "v", "w")}
    for k_, want in grads["cpu"].items():
        scale = float(want.abs().max())
        err = float((grads["cuda"][k_] - want).abs().max())
        assert err <= 1e-5 * scale, (k_, err, scale)


def _every_width_ell(dev, n=6000, seed=3):
    """An ELL graph whose sources have out-degrees in every transpose
    bucket width from 4 to 8,192 (a 5,000-edge hub source), sources
    without out-edges (0-2) and random edges."""
    rng = np.random.default_rng(seed)
    src = [rng.integers(20, n, 4 * n)]
    dst = [rng.integers(0, n, 4 * n)]
    for v, deg in zip(range(3, 20), (3, 6, 12, 24, 48, 96, 192, 384, 768,
                                     1536, 3000, 5000)):
        src.append(np.full(deg, v))
        dst.append(rng.choice(n, deg, replace=False))
    src, dst = np.concatenate(src), np.concatenate(dst)
    ell = EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=n),
                            device=dev)
    return ell, len(src)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mean", "sum", "gcn", "weighted", "gatv2",
                                "max", "gine", "gine_edges"])
@pytest.mark.parametrize("d,heads", [(128, 4), (12, 3)])
def test_ell_transpose_over_t_row_matches_plain(dev, dtype, op, d, heads):
    """K6b walking ``EllGraph.t_row`` (each slot's destination row,
    composed at build; the entry read beside it by the weighted, gatv2
    and edge-row gine modes) over transpose buckets of every width up to a
    5,000-slot hub, in all seven modes: one launch per non-empty bucket
    (and per forward bucket for max's tie pass), within the twin's
    tolerance, the same bits on a repeat launch, 0 for sources without
    out-edges."""
    ell, e = _every_width_ell(dev)
    widths = [w for w, lo, hi in zip(ell.t_widths, ell.t_boundaries,
                                     ell.t_boundaries[1:]) if hi > lo]
    assert widths == [4 * 2 ** k for k in range(12)]
    for t_row, t_nbr, t_mask in zip(ell.t_row, ell.t_nbr, ell.t_mask):
        assert torch.equal(t_row.long(), torch.where(
            t_mask, ell.ent_row.long()[t_nbr.long()], -1))
    n = ell.num_nodes
    g = torch.Generator(device=dev).manual_seed(24)
    rows = torch.randn((n, d), generator=g, device=dev).to(dtype)
    p = ell.ent_row.shape[0]
    kw = {}
    if op in ("weighted", "gatv2"):
        kw = {"wt": torch.randn((p, heads), generator=g, device=dev),
              "wt2": torch.randn((p, heads), generator=g, device=dev),
              "vec": torch.randn(d, generator=g, device=dev),
              "heads": heads}
    if op == "gatv2":
        kw["rows2"], kw["table"] = (torch.randn(
            (n, d), generator=g, device=dev).to(dtype) for _ in range(2))
    if op == "max":
        kw["table"] = (torch.randn((n, d), generator=g, device=dev) * 2
                       ).round().to(dtype)
        kw["rows2"] = ell_aggregate_graph(kw["table"], ell, "max")
    if op.startswith("gine"):
        kw["table"] = torch.randn((n, d), generator=g, device=dev).to(dtype)
        if op == "gine_edges":
            kw["ea"] = torch.randn((e, d), generator=g, device=dev).to(dtype)
    mode = "gine" if op == "gine_edges" else op
    before = _build.launches["ell_transpose_aggregate"]
    got = ell_transpose_aggregate(rows, ell, mode, **kw)
    torch.cuda.synchronize()
    launches = len(widths) + (sum(hi > lo for lo, hi in zip(
        ell.boundaries, ell.boundaries[1:])) if op == "max" else 0)
    assert _build.launches["ell_transpose_aggregate"] == before + launches
    assert torch.equal(got, ell_transpose_aggregate(rows, ell, mode, **kw))
    want = _ell_transpose_plain(rows, ell, mode, **kw)
    assert got.dtype == dtype and got.shape == (n, d)
    assert not got[ell.rank[:3].long()].any()
    _within(got, want, dtype)


# -- the COO per-edge terms ---------------------------------------------------------
def _coo_edge_graph(dev, walk, n=3000, e=20000, hub_deg=1000, seed=7):
    """COO edges on the card over ``n`` nodes: 100 destinations and 100
    sources without edges, a destination hub (5) and a source hub (9) of
    ``hub_deg`` edges each, shuffled; the destination and source indexes
    built with each other's ids, or (``walk``) the graph relabelled in its
    destination walk order (``coo_walk``)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n - 100, e), rng.integers(0, n, hub_deg),
                          np.full(hub_deg, 9)])
    dst = np.concatenate([rng.integers(100, n, e), np.full(hub_deg, 5),
                          rng.integers(100, n, hub_deg)])
    perm = rng.permutation(len(src))
    src, dst = (torch.as_tensor(a[perm].astype(np.int32), device=dev)
                for a in (src, dst))
    index = SegmentIndex.from_ids(dst, n, gather=src)
    src_index = SegmentIndex.from_ids(src, n, gather=dst)
    if walk:
        w = segment_ops.coo_walk(index, src)
        return w.src, w.dst, w.index, w.src_index
    return src, dst, index, src_index


def _off16(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary
    (the kernels' one-value pieces)."""
    flat = torch.empty(t.numel() + 16 // t.element_size(), dtype=t.dtype,
                       device=t.device)
    skip = (16 - flat.data_ptr() % 16) % 16 // t.element_size() \
        + 4 // t.element_size()
    out = flat[skip: skip + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


COO_EDGE_CASES = [  # (heads, head dim, 4 bytes off 16)
    (4, 64, False), (1, 128, False), (4, 3, False), (2, 8, True),
    (3, 5, False), (4, 32, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dh,off", COO_EDGE_CASES)
@pytest.mark.parametrize("walk", [False, True])
def test_coo_edge_modes_match_plain(dev, dtype, heads, dh, off, walk):
    """K8 add (weighted per head) and gine, K10 with the key addend and
    GATv2's scores, K8b's gine gate and GATv2 source walk, K8's GATv2
    destination walk (d hd and d att), K11's COO form in its three modes:
    each against its plain twin on the card, empty segments and 1,000-edge
    hubs on both sides, the edges in their own order or in walk order;
    fp32 within 1e-5 of the scale, bf16 within 2e-2; K11 gine and every
    output on a repeat run bit-equal."""
    src, dst, index, src_index = _coo_edge_graph(dev, walk)
    n, e, c = index.num_segments, index.num_edges, heads * dh
    g = torch.Generator(device=dev).manual_seed(11)

    def rand(*shape, scale=1.0):
        t = (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
        return _off16(t) if off else t

    x, hd, gout = rand(n, c), rand(n, c), rand(n, c)
    ea = rand(e, c)
    w = torch.rand((e, heads), generator=g, device=dev)
    gl = torch.randn((e, heads), generator=g, device=dev)
    att = torch.randn((heads, dh), generator=g, device=dev)
    scale = torch.rand(heads, generator=g, device=dev) + 0.5
    x3, hd3, ea3 = (t.view(-1, heads, dh) for t in (x, hd, ea))
    _build.reset_launches()
    calls = {
        "k8_add": (lambda: segment_ops._segment_reduce_fwd(
            x3, dst, n, "sum", src, w, index, ea3, "add"),
            lambda: _segment_reduce_plain(x3, dst, n, "sum", src, w, ea3,
                                          "add")),
        "k8_gine": (lambda: segment_ops._segment_reduce_fwd(
            x, dst, n, "sum", src, None, index, ea, "gine"),
            lambda: _segment_reduce_plain(x, dst, n, "sum", src, None, ea,
                                          "gine")),
        "k10_addend": (lambda: segment_ops._sddmm_fwd(
            src, dst, hd3, x3, scale, index, edge=ea3),
            lambda: _sddmm_plain(src, dst, hd3, x3, scale, edge=ea3)),
        "k10_gatv2": (lambda: segment_ops._sddmm_fwd(
            src, dst, hd3, x3, index=index, att=att, negative_slope=0.2),
            lambda: _sddmm_plain(src, dst, hd3, x3, att=att)),
        "k8b_gine": (lambda: segment_ops.gine_bwd(
            gout, src, dst, x, ea, src_index=src_index),
            lambda: segment_ops._edge_bwd_plain(
                gout, dst, n, "gine", src, None, x, ea, None, 0.2)),
        "k8b_gatv2": (lambda: segment_ops.gatv2_src_bwd(
            gl, src, dst, x3, hd3, att, src_index=src_index),
            lambda: segment_ops._edge_bwd_plain(
                hd, dst, n, "gatv2", src, gl, x, None, att, 0.2)),
        "k8_gatv2": (lambda: segment_ops.gatv2_dst_bwd(
            gl, src, dst, x3, hd3, att, index=index),
            lambda: segment_ops._gatv2_dst_plain(gl, src, dst, x3, hd3, att,
                                                 0.2)),
        "k11_gine": (lambda: edge_ops.coo_edge_grad(
            gout, src, dst, index, "gine", x=x, ea=ea),
            lambda: edge_ops._coo_edge_grad_plain(gout, src, dst, "gine",
                                                  x=x, ea=ea)),
        "k11_gat": (lambda: edge_ops.coo_edge_grad(
            gout, src, dst, index, "gat", alpha=w, coef=gl,
            vec=att.reshape(-1), heads=heads),
            lambda: edge_ops._coo_edge_grad_plain(
                gout, src, dst, "gat", alpha=w, coef=gl, vec=att.reshape(-1),
                heads=heads)),
        "k11_gat_values": (lambda: edge_ops.coo_edge_grad(
            gout, src, dst, index, "gat", alpha=w, heads=heads),
            lambda: edge_ops._coo_edge_grad_plain(
                gout, src, dst, "gat", alpha=w, heads=heads)),
        "k11_transformer": (lambda: edge_ops.coo_edge_grad(
            gout, src, dst, index, "transformer", alpha=w, coef=gl, xd=hd,
            heads=heads),
            lambda: edge_ops._coo_edge_grad_plain(
                gout, src, dst, "transformer", alpha=w, coef=gl, xd=hd,
                heads=heads)),
    }
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        again = kernel()
        got, want, again = (t if isinstance(t, tuple) else (t,)
                            for t in (got, want, again))
        for a, b, r in zip(got, want, again):
            assert a.shape == b.reshape(a.shape).shape, name
            assert torch.equal(a, r), name          # no atomics: same bits
            if name == "k11_gine":
                assert torch.equal(a, b), name       # a gated copy
            elif a.dtype == torch.float32 and b.dtype != dtype:
                _within(a, b, torch.float32)         # d att: fp32 sums
            else:
                _within(a, b.reshape(a.shape), dtype)
    for mode in ("segment_reduce_add", "segment_reduce_gine",
                 "segment_reduce_gatv2", "segment_reduce_bwd_gine",
                 "segment_reduce_bwd_gatv2", "sddmm_addend", "sddmm_gatv2",
                 "ell_edge_grad_coo"):
        assert _build.launches[mode] > 0, mode
    assert _build.launches["segment_reduce_bwd_composed"] > 0


def test_coo_edge_modes_take_the_chained_ids(dev):
    """The edge modes given ids other than their indexes' own tensors (a
    copy) read them through the order (the chained modes), with the same
    results as the composed modes, bit for bit."""
    src, dst, index, src_index = _coo_edge_graph(dev, False)
    n, e, c = index.num_segments, index.num_edges, 64
    g = torch.Generator(device=dev).manual_seed(12)
    x, hd, gout = (torch.randn((n, c), generator=g, device=dev)
                   for _ in range(3))
    ea = torch.randn((e, c), generator=g, device=dev)
    gl = torch.randn((e, 4), generator=g, device=dev)
    att = torch.randn((4, 16), generator=g, device=dev)
    for s_, d_ in ((src, dst), (src.clone(), dst.clone())):
        assert (segment_ops.gather_mode(s_, index) == "composed") == (
            s_ is src)
    outs = []
    for s_, d_ in ((src, dst), (src.clone(), dst.clone())):
        outs.append((
            segment_ops._segment_reduce_fwd(x, d_, n, "sum", s_, None, index,
                                            ea, "gine"),
            segment_ops.gine_bwd(gout, s_, d_, x, ea, src_index=src_index),
            segment_ops._sddmm_fwd(s_, d_, hd.view(n, 4, 16),
                                   x.view(n, 4, 16), index=index, att=att),
            segment_ops.gatv2_dst_bwd(gl, s_, d_, x.view(n, 4, 16),
                                      hd.view(n, 4, 16), att, index=index),
            edge_ops.coo_edge_grad(gout, s_, d_, index, "gine", x=x, ea=ea)))
    for a, b in zip(*outs):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)


def _edge_fn_inputs(dev, device, dtype=torch.float32, seed=13):
    """The same COO graph (walk order) and inputs on ``dev`` or the CPU."""
    src, dst, index, src_index = _coo_edge_graph(dev, True, n=1500, e=12000,
                                                 hub_deg=1000, seed=seed)
    n, e = index.num_segments, index.num_edges
    g = torch.Generator().manual_seed(seed)
    h, dh = 4, 16
    t = {k: torch.randn(shape, generator=g).to(dtype) for k, shape in (
        ("hs", (n, h, dh)), ("hd", (n, h, dh)), ("v", (n, h, dh)),
        ("he", (e, h * dh)), ("pre", (e, h)))}
    t["att"] = torch.randn((h, dh), generator=g)
    t["w"] = torch.rand((e, h), generator=g)
    if device.type == "cpu":
        src, dst = src.cpu(), dst.cpu()
        index = SegmentIndex.from_ids(dst, n, gather=src)
        src_index = SegmentIndex.from_ids(src, n, gather=dst)
    return src, dst, index, src_index, {
        k: v.to(device).requires_grad_() for k, v in t.items()}


@pytest.mark.parametrize("fn", ["add", "gine", "gatv2", "gat_edges",
                                "transformer_edges"])
def test_coo_edge_functions_gradients_on_card_match_cpu(dev, fn):
    """Each new autograd.Function (ROADMAP C3's lesson): coo_spmm with edge
    rows (add with per-head weights, gine), gatv2_scores, coo_gat_edges
    and coo_transformer_edges on the card against the CPU's twins, the
    output and the gradient of every input (the edge table's included),
    fp32 within 1e-4 of the scale (softmax and sums in another order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for device in (dev, torch.device("cpu")):
        src, dst, idx, sidx, t = _edge_fn_inputs(dev, device)
        n = idx.num_segments
        if fn == "add":
            used = ("v", "w", "he")
            out = segment_ops.coo_spmm(
                src, dst, t["v"], n, edge_weight=t["w"], index=idx,
                src_index=sidx, edge_rows=t["he"], edge_mode="add")
        elif fn == "gine":
            used = ("v", "he")
            out = segment_ops.coo_spmm(
                src, dst, t["v"], n, index=idx, src_index=sidx,
                edge_rows=t["he"], edge_mode="gine")
        elif fn == "gatv2":
            used = ("hs", "hd", "att")
            out = coo_edges.gatv2_scores(src, dst, t["hs"], t["hd"],
                                         t["att"], index=idx, src_index=sidx)
        elif fn == "gat_edges":
            used = ("hs", "he", "pre", "att")
            out = coo_edges.coo_gat_edges(src, dst, n, t["hs"], t["he"],
                                          t["pre"], t["att"], index=idx,
                                          src_index=sidx)
        else:
            used = ("hd", "hs", "v", "he")
            scale = torch.full((4,), 0.25, device=device)
            out = coo_edges.coo_transformer_edges(
                src, dst, t["hd"], t["hs"], t["v"], t["he"], scale,
                index=idx, src_index=sidx)
        cot = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        out.backward(cot.to(device))
        res[device.type] = [out.detach().cpu()] + [t[k].grad.cpu()
                                                   for k in used]
    for a, b in zip(res["cuda"], res["cpu"]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("conv", ["gine", "edge_attr_gat", "transformer",
                                  "gatv2"])
def test_encode_coo_with_edges_gradients_on_card_match_cpu(dev, conv):
    """encode_coo with edge features on the card (the walk-ordered graph,
    K8's edge modes, K10's addend or GATv2 scores, their backward): the
    output and every parameter's, the node rows' and the raw edge rows'
    gradients of the CPU's computation (fp32, within 1e-4 of the scale),
    with the new modes launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, x, _ = _small_graph()
    ea = np.random.default_rng(3).normal(size=(len(src), 8)).astype(
        np.float32)
    kw = ({} if conv == "gine" else {"heads": 4}) | (
        {"use_edge_attr": True} if conv == "transformer" else {})
    modes = {"gine": ("segment_reduce_gine", "segment_reduce_bwd_gine",
                      "ell_edge_grad_coo"),
             "edge_attr_gat": ("segment_reduce_add", "sddmm_addend",
                               "ell_edge_grad_coo"),
             "transformer": ("segment_reduce_add", "sddmm_addend",
                             "ell_edge_grad_coo", "sddmm_bwd"),
             "gatv2": ("sddmm_gatv2", "segment_reduce_gatv2",
                       "segment_reduce_bwd_gatv2")}[conv]
    din = 32 if conv == "gine" else 16
    xs = np.concatenate([x, x], 1) if conv == "gine" else x
    res = {}
    for device in (dev, torch.device("cpu")):
        enc = GNNEncoder(din, 32, 8, conv=conv, conv_kwargs=kw, edge_dim=8)
        init_params(enc, 3)
        enc = enc.to(device)
        ts, td = (torch.as_tensor(a.astype(np.int32), device=device)
                  for a in (src, dst))
        tx = torch.as_tensor(xs, device=device).requires_grad_()
        tea = torch.as_tensor(ea, device=device).requires_grad_()
        _build.reset_launches()
        out = enc.encode_coo(tx, ts, td, N, None if conv == "gatv2" else tea)
        (out * torch.linspace(-1, 1, out.numel(), device=device)
         .reshape(out.shape)).sum().backward()
        if device.type == "cuda":
            for k in modes:
                assert _build.launches[k] > 0, (conv, k)
        res[device.type] = {"out": out.detach().cpu(), "x": tx.grad.cpu(),
                            **{n: p.grad.cpu()
                               for n, p in enc.named_parameters()
                               if p.grad is not None}}
        if conv != "gatv2":
            res[device.type]["ea"] = tea.grad.cpu()
    floor = 1e-2 * max(float(v.abs().max()) for v in res["cpu"].values())
    assert set(res["cuda"]) == set(res["cpu"])
    for k, v in res["cpu"].items():
        err = float((res["cuda"][k] - v).abs().max())
        assert err <= 1e-4 * max(float(v.abs().max()), floor), (conv, k)


@pytest.mark.parametrize("conv", ["gine", "edge_attr_gat", "transformer",
                                  "gatv2"])
def test_encode_coo_with_edges_bf16_on_card_matches_cpu(dev, conv):
    """The same encoders in bf16 (every kernel mode in its bf16 form, the
    edge rows rounded to bf16 after the fp32 permute): the embeddings on
    the card against the CPU's within 2e-2 of their scale (one rounding
    against another), and a finite node-row gradient through the bf16
    backward kernels (its size is not compared: a relu gate within a bf16
    ulp of 0 may fall on either side in the two runs and move a whole
    term)."""
    src, dst, x, _ = _small_graph()
    ea = np.random.default_rng(4).normal(size=(len(src), 8)).astype(
        np.float32)
    kw = ({} if conv == "gine" else {"heads": 4}) | (
        {"use_edge_attr": True} if conv == "transformer" else {})
    din = 32 if conv == "gine" else 16
    xs = np.concatenate([x, x], 1) if conv == "gine" else x
    res = {}
    for device in (dev, torch.device("cpu")):
        enc = GNNEncoder(din, 32, 8, conv=conv, conv_kwargs=kw, edge_dim=8,
                         dtype=torch.bfloat16)
        init_params(enc, 5)
        enc = enc.to(device)
        ts, td = (torch.as_tensor(a.astype(np.int32), device=device)
                  for a in (src, dst))
        tx = torch.as_tensor(xs, device=device).requires_grad_()
        out = enc.encode_coo(tx, ts, td, N, None if conv == "gatv2"
                             else torch.as_tensor(ea, device=device))
        assert out.dtype == torch.bfloat16
        out.float().square().sum().backward()
        assert bool(torch.isfinite(tx.grad).all()) and bool(tx.grad.any())
        res[device.type] = out.detach().float().cpu()
    a, b = res["cuda"], res["cpu"]
    assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())



# -- the quantized partitioned graph's bit-packed int8 rows --------------------

def _packed_rows(n, d, dc, seed=0):
    """[n, D + 8] (or [n, D + Dc + 12]) bit-packed int8 rows: random int8
    values, positive fp32 scales and integer degrees in the tail, each
    word little-endian (the reference's layout)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (n, d + dc)).astype(np.int8)
    words = [rng.random((n, 1)).astype(np.float32) / 50]
    if dc:
        words.append(rng.random((n, 1)).astype(np.float32) / 20)
    words.append(rng.integers(0, 300, (n, 1)).astype(np.float32))
    tail = np.concatenate(words, axis=1).view(np.int8)
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate([q, tail], axis=1)))


def _equal3(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == torch.float32 and torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("d,dc", [(13, 0), (13, 13), (16, 0), (16, 16),
                                  (128, 0), (128, 128), (5, 3)])
@pytest.mark.parametrize("num_shards,cap", [(1, 300), (4, 40)])
def test_unroute_rows_q8_bit_equal(dev, d, dc, num_shards, cap):
    """K16's int8 mode against its twin at odd and flagship widths, with
    and without the cache: the decoded features, degrees and cache
    bit-equal; zeros for dropped requests (cap 40 overflows); the packed
    rows read at any byte alignment (D 13: 21- and 38-byte rows)."""
    ids = _route_ids(300, num_shards * 100, seed=d + dc)
    _, owner, pos, ok = fl._route_requests_plain(ids, 100, num_shards, cap)
    back = _packed_rows(num_shards * cap, d, dc, seed=d).reshape(
        num_shards, cap, -1)
    want = fl._unroute_q8_plain(back, owner, pos, ok, d, dc)
    before = _build.launches["unroute_rows_q8"]
    got = fl.unroute_rows_q8(back.to(dev), owner.to(dev), pos.to(dev),
                             ok.to(dev), d, dc)
    assert _build.launches["unroute_rows_q8"] == before + 1
    _equal3(got, want)
    if cap == 40:
        assert not bool(ok.all())
        assert float(got[0][~ok.to(dev)].abs().sum()) == 0.0
    empty = fl.unroute_rows_q8(back.to(dev), *(t[:0].to(dev)
                                               for t in (owner, pos, ok)),
                               d, dc)
    assert empty[0].shape == (0, d) and empty[1].shape == (0,)


@pytest.mark.parametrize("d,dc", [(13, 0), (13, 13), (16, 16), (128, 0),
                                  (128, 128)])
def test_gather_packed_rows_q8_bit_equal(dev, d, dc):
    """K12's packed-row mode against its twin: ids out of range clamped
    into [0, N - 1] (as XLA's gather clamps), a 2-D id shape."""
    table = _packed_rows(N, d, dc, seed=d + 1)
    ids = _route_ids(600, N, seed=d).reshape(20, 30)
    want = _gather_packed_rows_q8_plain(table, ids, d, dc)
    before = _build.launches["gather_rows_q8_packed"]
    got = gather_packed_rows_q8(table.to(dev), ids.to(dev), d, dc)
    assert _build.launches["gather_rows_q8_packed"] == before + 1
    assert got[0].shape == (20, 30, d) and got[1].shape == (20, 30)
    _equal3(got, want)


def test_packed_q8_modes_graph_replay(dev):
    """K16's int8 mode and K12's packed-row mode captured in one CUDA graph
    and replayed over new ids equal the eager calls and the twins."""
    d, dc, p, cap = 13, 13, 4, 64
    back = _packed_rows(p * cap, d, dc, seed=5).reshape(p, cap, -1).to(dev)
    table = _packed_rows(N, d, dc, seed=6).to(dev)
    ids = _route_ids(200, p * 100, seed=7).to(dev)
    _, owner, pos, ok = fl.route_requests(ids, 100, p, cap)
    gids = _route_ids(300, N, seed=8).to(dev)

    def both():
        return (fl.unroute_rows_q8(back, owner, pos, ok, d, dc),
                gather_packed_rows_q8(table, gids, d, dc))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    ids.copy_(_route_ids(200, p * 100, seed=9).to(dev))
    _, o2, p2, k2 = fl.route_requests(ids, 100, p, cap)
    owner.copy_(o2)
    pos.copy_(p2)
    ok.copy_(k2)
    gids.copy_(_route_ids(300, N, seed=10).to(dev))
    graph.replay()
    torch.cuda.synchronize()
    eager = both()
    for c, e in zip(captured, eager):
        _equal3(c, e)
    _equal3(captured[0], fl._unroute_q8_plain(
        back.cpu(), owner.cpu(), pos.cpu(), ok.cpu(), d, dc))
    _equal3(captured[1], _gather_packed_rows_q8_plain(table.cpu(),
                                                      gids.cpu(), d, dc))


@pytest.mark.parametrize("width,stride", [(21, 21), (38, 38), (13, 40),
                                          (7, 7), (136, 136)])
def test_gather_rows_byte_widths_bit_equal(dev, width, stride):
    """K3 over int8 rows of any byte width and stride (its byte mode where
    the width, stride or base is not a multiple of 4 bytes; 136 the word
    form) against the plain gather."""
    base = torch.from_numpy(np.random.default_rng(width).integers(
        -128, 128, (N, stride)).astype(np.int8))
    table = base[:, :width]
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, N, 900).astype(np.int32))
    before = _build.launches["gather_rows_bytes"]
    got, vals = gather_rows(base.to(dev)[:, :width], ids.to(dev))
    assert vals is None
    assert torch.equal(got.cpu(), table[ids.long()])
    word = width % 4 == 0 and stride % 4 == 0
    assert _build.launches["gather_rows_bytes"] == before + (not word)


def _labeled_graph(device, d=13, seed=14):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, d)).astype(np.float32)
    return DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                node_features=x,
                                node_labels=rng.integers(0, 4, N)),
        supervision_edges=np.stack([src, dst]), device=device)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("d", [13, 16])
def test_partitioned_tabularized_on_card_match_cpu(dev, quantize,
                                                   num_shards, d):
    """with_tabularized on the card against the CPU (D 13 and 16): the sample
    tables bit-equal, the fp32 cache within 1e-5 of its scale (K4 sums in
    another order), int8 cache values within 1 and scales within 1e-6
    relative, the features and degrees bit-equal; then one cached NALP step
    and one cached node-classification step on the card against the CPU
    (losses and weights within 1e-4 relative); the int8 step at 4 shards
    decodes every row through K16's int8 mode, at one shard through K12's
    packed-row mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    anchors = np.random.default_rng(3).integers(0, N, (1, 64))
    out = {}
    for device in (torch.device("cpu"), dev):
        g = _labeled_graph(device, d)
        mesh = Mesh(num_shards, device)
        pg = dist_sampled.PartitionedGraph.build(g, mesh,
                                                 quantize_features=quantize)
        tab = pg.with_tabularized(mesh, fanouts=(4, 3), capacity_factor=8.0)
        res = {"fd": torch.cat(tab.feat_deg).cpu(),
               "tables": torch.cat(tab.sample_tables[0]).cpu()}
        model = LinkPredictionGNN(GNNEncoder(d, 32, 16),
                                  LinkPredictionDecoder())
        t = dist_sampled.PartitionedNALPTrainer(
            model, tab, mesh, NALPTrainerConfig(
                fanouts=(4, 3), num_random_negs=64, cached_hop=True),
            optimizer_args={"learning_rate": "0.01"}, capacity_factor=8.0)
        state = t.init_state(0)
        _build.reset_launches()
        _, losses = t.train_steps(state, anchors)
        launches = dict(_build.launches)
        nc = dist_sampled.PartitionedNodeClassificationTrainer(
            GNNEncoder(d, 32, 4), tab, mesh, NodeClassificationTrainerConfig(
                fanouts=(4, 3), cached_hop=True),
            optimizer_args={"learning_rate": "0.01"}, capacity_factor=8.0)
        _, nc_losses = nc.train_steps(nc.init_state(1), anchors)
        res.update(loss=losses.cpu(), nc_loss=nc_losses.cpu(),
                   w={k: v.cpu() for k, v in t.model.state_dict().items()})
        out[device.type] = res
        if device.type == "cuda":
            assert t.overflow_total == 0 == nc.overflow_total
            if quantize:
                mode = ("unroute_rows_q8" if num_shards > 1
                        else "gather_rows_q8_packed")
                assert launches[mode] > 0, mode
            if num_shards > 1:
                assert launches["unroute_rows"] > 0
            else:
                assert launches["gather_rows"] > 0
    a, b = out["cuda"], out["cpu"]
    assert torch.equal(a["tables"], b["tables"])
    if quantize:
        assert torch.equal(a["fd"][:, :d], b["fd"][:, :d])
        qa, qb = (x[:, d:2 * d].to(torch.int32) for x in (a["fd"], b["fd"]))
        assert int((qa - qb).abs().max()) <= 1
        ta, tb = (x[:, 2 * d:].contiguous().view(torch.float32)
                  for x in (a["fd"], b["fd"]))
        assert torch.equal(ta[:, [0, 2]], tb[:, [0, 2]])
        torch.testing.assert_close(ta[:, 1], tb[:, 1], rtol=1e-6, atol=0)
    else:
        assert torch.equal(a["fd"][:, :d + 1], b["fd"][:, :d + 1])
        scale = float(b["fd"][:, d + 1:].abs().max())
        assert float((a["fd"] - b["fd"]).abs().max()) <= 1e-5 * scale
    for key in ("loss", "nc_loss"):
        torch.testing.assert_close(a[key], b[key], rtol=1e-4, atol=0)
    for k, v in b["w"].items():
        torch.testing.assert_close(a["w"][k], v, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cached", [False, True], ids=["live", "cached"])
def test_partitioned_nc_steps_on_card_match_cpu(dev, cached):
    """Three node-classification steps at 4 shards over int8 rows on the
    card against the CPU (losses within 1e-4 relative), then evaluate and
    predict_batch (logits within 1e-4 of their scale)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    nodes = np.random.default_rng(5).integers(0, N, (3, 64))
    out = {}
    for device in (torch.device("cpu"), dev):
        g = _labeled_graph(device, 16, seed=15)
        mesh = Mesh(4, device)
        t = dist_sampled.PartitionedNodeClassificationTrainer(
            GNNEncoder(16, 32, 4),
            dist_sampled.PartitionedGraph.build(g, mesh,
                                                quantize_features=True),
            mesh, NodeClassificationTrainerConfig(fanouts=(4, 3),
                                                  cached_hop=cached),
            optimizer_args={"learning_rate": "0.01"}, capacity_factor=8.0)
        state = t.init_state(0)
        _build.reset_launches()
        state, losses = t.train_steps(state, nodes)
        if device.type == "cuda":
            for k in ("route_requests", "unroute_rows", "unroute_rows_q8",
                      "gather_rows", "masked_reduce", "masked_reduce_bwd"):
                assert _build.launches[k] > 0, k
        out[device.type] = (losses.cpu(), t.evaluate([np.arange(100)]),
                            t.predict_batch(np.arange(50)).float().cpu())
    (la, acc_a, pa), (lb, acc_b, pb) = out["cuda"], out["cpu"]
    torch.testing.assert_close(la, lb, rtol=1e-4, atol=0)
    assert abs(acc_a - acc_b) <= 0.02
    assert float((pa - pb).abs().max()) <= 1e-4 * float(pb.abs().max())


# -- the partitioned tier's label edges and K17's own-block bias mode -------------
def _bias_case(dev, b, p_, h, num_blocks, dtype, seed):
    """A shard's [P, Ql, Cl] ring scores from ``dtype`` embeddings (Ql = b
    anchors x p positives; Cl = Ql + b h hard + 37 random columns) with
    their rows and columns, and the own-block bias terms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    ql, nh = b * p_, b * h
    cl = ql + nh + 37

    def t(a):
        return torch.from_numpy(a).to(dev)

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((ql, 32), generator=g, device=dev).to(dtype)
    cands = [torch.randn((cl, 32), generator=g, device=dev).to(dtype)
             for _ in range(num_blocks)]
    scores = sharded_retrieval._block_scores(q, cands)
    aid = rng.integers(0, 40, b).astype(np.int32)
    qids = np.repeat(aid, p_)
    rows = sharded_retrieval.RingRows(
        temperature=0.07, label_cols=t(np.arange(ql, dtype=np.int32)),
        query_ids=t(qids), own_pos_ids=t(rng.integers(0, 60, ql).astype(
            np.int32)))
    blocks = []
    for k in range(num_blocks):
        pos_qids = np.full(cl, -1, np.int32)
        pos_qids[:ql] = qids if k == 0 else rng.integers(0, 40, ql)
        blocks.append(sharded_retrieval.RingColumns(
            ids=t(rng.integers(0, 60, cl).astype(np.int32)),
            pos_qids=t(pos_qids), mask=t(rng.random(cl) < 0.85)))
    e_pos = t((rng.normal(size=ql) * 2).astype(np.float32))
    e_hard = t((rng.normal(size=nh) * 2).astype(np.float32)) if h else None
    bias = sharded_retrieval.OwnBlockBias(e_pos, e_hard, p_, h)
    return scores, rows, sharded_retrieval.stack_columns(blocks), bias


@pytest.mark.parametrize("b,p_,h,num_blocks", [
    (13, 3, 2, 4), (128, 1, 1, 4), (64, 2, 0, 4), (9, 1, 3, 1),
    (512, 1, 1, 4), (1, 1, 1, 1)],
    ids=["ql39_p3_h2", "flagship_shard", "h0", "one_block", "wide",
         "one_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_bias_mode_matches_plain(dev, b, p_, h, num_blocks, dtype):
    """K17's own-block bias mode (fold and backward with d e_pos, d
    e_hard) against its twin (the dense bias added to block 0, the terms'
    cotangents by autograd through it): the fold's state rtol 1e-5, dS and
    the cotangents within 1e-5 of their scale; the same bits on a repeat
    run; one launch each, counted as the bias mode."""
    scores, rows, cols, bias = _bias_case(dev, b, p_, h, num_blocks, dtype,
                                          seed=b * 10 + p_ + h)
    ql = scores.shape[1]
    fresh = lambda: [torch.full((ql,), sharded_retrieval.FMIN,  # noqa: E731
                                device=dev),
                     torch.zeros(ql, device=dev), torch.zeros(ql, device=dev)]
    _build.reset_launches()
    got, again, want = fresh(), fresh(), fresh()
    sharded_retrieval.ring_fold(scores, rows, cols, True, *got, bias=bias)
    assert _build.launches["ring_retrieval"] == 1
    assert _build.launches["ring_retrieval_bias"] == 1
    sharded_retrieval.ring_fold(scores, rows, cols, True, *again, bias=bias)
    sharded_retrieval._ring_fold_plain(scores, rows, cols, True, *want,
                                       bias=bias)
    for k, a, w in zip(got, again, want):
        assert torch.equal(k, a)
        torch.testing.assert_close(k, w, rtol=1e-5, atol=0)
    lse = torch.log(torch.clamp(want[1], min=1e-30)) + want[0]
    gr = torch.rand((ql,), device=dev)
    k_out = sharded_retrieval.ring_block_bwd(scores, rows, cols, True, lse,
                                             gr, bias)
    k_again = sharded_retrieval.ring_block_bwd(scores, rows, cols, True, lse,
                                               gr, bias)
    w_out = sharded_retrieval._ring_block_bwd_plain(scores, rows, cols, True,
                                                    lse, gr, bias)
    assert _build.launches["ring_retrieval_bias"] == 4
    assert (k_out[2] is None) == (h == 0) == (w_out[2] is None)
    for k, a, w in zip(k_out, k_again, w_out):
        if w is None:
            continue
        assert torch.equal(k, a)
        scale = max(float(w.abs().max()), 1e-30)
        assert float((k - w).abs().max()) <= 1e-5 * scale
    assert torch.equal(k_out[1], torch.diagonal(k_out[0][0]))
    if h:   # each hard column's p cells summed in row order
        ds0 = k_out[0][0][:, ql:ql + b * h].reshape(b, p_, b * h)
        want_h = sum(ds0[:, r, :] for r in range(p_))
        want_h = want_h.reshape(b, b, h)[torch.arange(b), torch.arange(b)]
        torch.testing.assert_close(k_out[2], want_h.reshape(-1), rtol=1e-6,
                                   atol=1e-7)


def test_ring_bias_mode_replays_in_a_cuda_graph(dev):
    """K17's bias-mode fold and backward captured in a CUDA graph give the
    eager calls' bits on replay, also over new scores and terms copied in
    place."""
    scores, rows, cols, bias = _bias_case(dev, 128, 1, 1, 4, torch.float32,
                                          seed=3)
    ql = scores.shape[1]
    state = torch.stack([torch.full((ql,), sharded_retrieval.FMIN,
                                    device=dev), torch.zeros(ql, device=dev),
                         torch.zeros(ql, device=dev)])
    work = state.clone()
    gr = torch.rand((ql,), device=dev)

    def step():
        work.copy_(state)
        sharded_retrieval.ring_fold(scores, rows, cols, True, *work,
                                    bias=bias)
        lse = torch.log(torch.clamp(work[1], min=1e-30)) + work[0]
        return (work.clone(),) + tuple(sharded_retrieval.ring_block_bwd(
            scores, rows, cols, True, lse, gr, bias))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                          # warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for k in range(2):
        if k:
            scores.mul_(1.5)
            bias.e_pos.add_(0.25)
            bias.e_hard.mul_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        eager = step()
        for c, e in zip(captured, eager):
            assert torch.equal(c, e)


@pytest.mark.parametrize("de", [8, 3])
@pytest.mark.parametrize("fanout", [1, 10, 15])
def test_unroute_carries_edge_rows(dev, de, fanout):
    """K16 over [P, C, fanout, De] fp32 edge rows (16-byte pieces for De 8,
    4-byte words for an odd De) bit-equal to its twin, zero rows for
    dropped requests."""
    ids = _route_ids(300, 4 * 100, seed=de + fanout)
    _, owner, pos, ok = fl._route_requests_plain(ids, 100, 4, 40)
    back = torch.randn((4, 40, fanout, de),
                       generator=torch.Generator().manual_seed(de))
    want = fl._unroute_plain(back, owner, pos, ok)
    _build.reset_launches()
    got = fl.unroute_rows(back.to(dev), owner.to(dev), pos.to(dev),
                          ok.to(dev))
    assert _build.launches["unroute_rows"] == 1
    assert got.shape == (300, fanout, de) and torch.equal(got.cpu(), want)
    assert not ok.all() and not want[~ok].any()


@pytest.mark.parametrize("num_shards", [4, 1])
def test_routed_edge_rows_on_card_match_cpu(dev, num_shards):
    """routed_sample_neighbors(local_edge_feats=) on the card (K15, K1's
    row-offset mode, K3 over the drawn slots, K16 for ids and rows)
    bit-equal to the CPU's."""
    csr = _csr(dev)
    rows = -(-N // num_shards)
    feats = np.random.default_rng(5).normal(
        size=(csr.indices.shape[0], 8)).astype(np.float32)
    ip, ix, ef = dist_sampled._shard_csr(
        csr.indptr.cpu().numpy(), csr.indices.cpu().numpy(), num_shards,
        rows, weights=feats)
    frontier = np.random.default_rng(6).integers(0, N, (num_shards, 256))
    out = {}
    for device in (dev, torch.device("cpu")):
        _build.reset_launches()
        out[device.type] = fl.routed_sample_neighbors(
            Mesh(num_shards, device),
            [torch.from_numpy(a).to(device) for a in ip],
            [torch.from_numpy(a).to(device) for a in ix],
            [torch.from_numpy(f.astype(np.int32)).to(device)
             for f in frontier], 10, seed=3, hop=1_000_003,
            capacity_factor=4.0,
            local_edge_feats=[torch.from_numpy(a).to(device) for a in ef])
        if device.type == "cuda":
            assert _build.launches["gather_rows"] == num_shards
            if num_shards > 1:
                assert _build.launches["unroute_rows"] == 2 * num_shards
    for k, w in zip(out["cuda"], out["cpu"]):
        for a, b in zip(k, w):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("ring", [False, True], ids=["per_shard", "ring"])
def test_partitioned_label_edge_steps_on_card_match_cpu(dev, ring):
    """Three partitioned NALP steps with label-edge features and the
    scorer (2 positives, 1 hard negative) at 4 shards on the card against
    the CPU: losses and weights within 1e-4 relative, K17's bias mode
    launched on the ring."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(14)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    hard = np.stack([rng.integers(0, N, 3000), rng.integers(0, N, 3000)])
    x = rng.normal(size=(N, 16)).astype(np.float32)
    sup_ef = rng.normal(size=(E, 8)).astype(np.float32)
    hard_ef = rng.normal(size=(3000, 8)).astype(np.float32)
    anchors = rng.integers(0, N, (3, 64))
    out = {}
    for device in (torch.device("cpu"), dev):
        g = DeviceGraph.from_hetero(
            HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                    node_features=x),
            supervision_edges=np.stack([src, dst]), hard_neg_edges=hard,
            supervision_edge_features=sup_ef,
            hard_neg_edge_features=hard_ef, device=device)
        mesh = Mesh(4, device)
        model = LinkPredictionGNN(GNNEncoder(16, 32, 16),
                                  LinkPredictionDecoder(),
                                  EdgeFeatureScorer(8, 32))
        t = dist_sampled.PartitionedNALPTrainer(
            model, dist_sampled.PartitionedGraph.build(g, mesh), mesh,
            NALPTrainerConfig(fanouts=(4, 3), num_positives=2,
                              num_hard_negs=1, num_random_negs=64,
                              global_candidate_pool=ring),
            optimizer_args={"learning_rate": "0.01"}, capacity_factor=8.0)
        state = t.init_state(0)
        _build.reset_launches()
        state, losses = t.train_steps(state, anchors)
        out[device.type] = (losses.cpu(), {k: v.cpu() for k, v in
                                           t.model.state_dict().items()})
        if device.type == "cuda":
            assert _build.launches["unroute_rows"] > 0
            assert (_build.launches["ring_retrieval_bias"] == 3 * 8) == ring
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("conv,tabularized", [("hgt", False), ("hgt", True),
                                              ("rgcn", False)])
def test_typed_partitioned_steps_on_card_match_cpu(dev, conv, tabularized):
    """Three typed partitioned steps (the DBLP paths over 4 shards; HGT
    with 4 heads or RGCN with 2 bases, live or tabularized) on the card
    against the CPU: losses within 1e-4 relative, the routed kernels
    launched; encode_batch of both types from the initial weights within
    1e-5 of the scale."""
    from gigl_tpu_torch.training.dist_hetero import (
        PartitionedHeteroGraph,
        PartitionedHeteroNALPTrainer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    graph, paths, types = _typed_graph()
    dims = {"author": 12, "paper": 20}
    writes = EdgeType.from_str(types[0])
    anchors = np.random.default_rng(2).integers(0, 500, (3, 64))
    out = {}
    for device in (dev, torch.device("cpu")):
        hdg = HeteroDeviceGraph.from_hetero(
            graph, paths, supervision_edge_type=writes,
            supervision_edges=graph.edges[writes], device=device)
        mesh = Mesh(4, device)
        pg = PartitionedHeteroGraph.build(hdg, paths, mesh,
                                          anchor_node_type="paper")
        if tabularized:
            pg = pg.with_sample_tables(hdg, paths, mesh)
        model = HeteroLinkPredictionGNN(HeteroGNNEncoder(
            32, 16, ("author", "paper"), types, dims, conv=conv, heads=4,
            num_bases=2), LinkPredictionDecoder())
        tr = PartitionedHeteroNALPTrainer(
            model, pg, paths, HeteroNALPTrainerConfig(
                "paper", "author", num_random_negs=64,
                tabularized=tabularized), mesh, capacity_factor=8.0)
        st = tr.init_state(0)
        # from the initial weights: HGT's last author bias has a gradient
        # that is zero by symmetry, so Adam moves it by its rounding noise
        embs = [tr.encode_batch(np.arange(0, n, 3), nt).cpu()
                for nt, n in (("paper", 500), ("author", 300))]
        _build.reset_launches()
        st, got = tr.train_steps(st, anchors)
        if device.type == "cuda":
            for k in ("route_requests", "unroute_rows", "gather_rows",
                      "uniform_ids", "retrieval_loss"):
                assert _build.launches[k] > 0, k
        out[device.type] = (got.cpu().numpy(), embs)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for k, w in zip(out["cuda"][1], out["cpu"][1]):
        assert float((k - w).abs().max()) <= 1e-5 * float(w.abs().max())


# -- GATv2 with edge rows (ROADMAP B6b) ----------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dh,off", COO_EDGE_CASES)
@pytest.mark.parametrize("walk", [False, True])
def test_gatv2_edge_coo_modes_match_plain(dev, dtype, heads, dh, off, walk):
    """The COO modes of GATv2 with edge rows: K10's gatv2 mode with the edge
    row, K8's gatv2 destination walk with it (d hd, d att), K11's gatv2
    mode and K8b's sum of a per-edge table along the source walk, each
    against its plain twin on the card (empty segments, 1,000-edge hubs on
    both sides, the edges in their own order or in walk order): fp32
    within 1e-5 of the scale, bf16 within 2e-2; a repeat run bit-equal."""
    src, dst, index, src_index = _coo_edge_graph(dev, walk)
    n, e, c = index.num_segments, index.num_edges, heads * dh
    g = torch.Generator(device=dev).manual_seed(31)

    def rand(*shape):
        t = torch.randn(shape, generator=g, device=dev).to(dtype)
        return _off16(t) if off else t

    x, hd, gout, ea = rand(n, c), rand(n, c), rand(n, c), rand(e, c)
    alpha = torch.rand((e, heads), generator=g, device=dev)
    gl = torch.randn((e, heads), generator=g, device=dev)
    att = torch.randn((heads, dh), generator=g, device=dev)
    x3, hd3, ea3 = (t.view(-1, heads, dh) for t in (x, hd, ea))
    _build.reset_launches()
    calls = {
        "k10_gatv2_edge": (lambda: segment_ops._sddmm_fwd(
            src, dst, hd3, x3, index=index, edge=ea3, att=att,
            negative_slope=0.2),
            lambda: _sddmm_plain(src, dst, hd3, x3, edge=ea3, att=att)),
        "k8_gatv2_edge": (lambda: segment_ops.gatv2_dst_bwd(
            gl, src, dst, x3, hd3, att, index=index, edge=ea3),
            lambda: segment_ops._gatv2_dst_plain(gl, src, dst, x3, hd3, att,
                                                 0.2, ea3)),
        "k11_gatv2": (lambda: edge_ops.coo_edge_grad(
            gout, src, dst, index, "gatv2", x=x, ea=ea, alpha=alpha,
            coef=gl, vec=att.reshape(-1), xd=hd, heads=heads),
            lambda: edge_ops._coo_edge_grad_plain(
                gout, src, dst, "gatv2", x=x, ea=ea, alpha=alpha, coef=gl,
                vec=att.reshape(-1), xd=hd, heads=heads)),
        "k8b_edge_rows": (lambda: segment_ops.edge_rows_by_source(
            ea, src, n, src_index=src_index),
            lambda: torch.zeros((n, c), device=dev).index_add(
                0, src.long(), ea.float()).to(dtype)),
    }
    for name, (kernel, plain) in calls.items():
        got, want, again = kernel(), plain(), kernel()
        got, want, again = (t if isinstance(t, tuple) else (t,)
                            for t in (got, want, again))
        for a, b, r in zip(got, want, again):
            assert a.shape == b.reshape(a.shape).shape, name
            assert torch.equal(a, r), name          # no atomics: same bits
            if a.dtype == torch.float32 and b.dtype != dtype:
                _within(a, b, torch.float32)         # d att: fp32 sums
            else:
                _within(a, b.reshape(a.shape), dtype)
    for mode in ("sddmm_gatv2_edge", "segment_reduce_gatv2_edge",
                 "ell_edge_grad_gatv2", "segment_reduce_bwd_edge_rows"):
        assert _build.launches[mode] > 0, mode
    assert _build.launches["segment_reduce_bwd_chained"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads", [(256, 4), (128, 4), (12, 3)])
def test_gatv2_edge_ell_modes_match_plain(dev, dtype, d, heads):
    """The ELL modes of GATv2 with edge rows over transpose buckets of every
    width up to a 5,000-slot hub: K11's gatv2 mode (an [E, D] table, every
    edge's row written once) and K6b's sum of an [E, D] table over
    EllGraph.t_edge (one launch per non-empty transpose bucket, 0 for
    sources without out-edges), each against its twin: fp32 within 1e-5
    of the scale, bf16 within 2e-2; a repeat run bit-equal; t_edge the
    composed edge of every transpose slot."""
    ell, e = _every_width_ell(dev)
    for t_edge, t_nbr, t_mask in zip(ell.t_edge, ell.t_nbr, ell.t_mask):
        assert torch.equal(t_edge.long(), torch.where(
            t_mask, ell.ent_edge.long()[t_nbr.long()], -1))
    n, p = ell.num_nodes, ell.ent_row.shape[0]
    g = torch.Generator(device=dev).manual_seed(32)
    x, xd, gout = (torch.randn((n, d), generator=g, device=dev).to(dtype)
                   for _ in range(3))
    ea = torch.randn((e, d), generator=g, device=dev).to(dtype)
    alpha, coef = (torch.randn((p, heads), generator=g, device=dev)
                   for _ in range(2))
    att = torch.randn(d, generator=g, device=dev)
    kw = dict(x=x, ea=ea, alpha=alpha, coef=coef, vec=att, xd=xd,
              heads=heads)
    _build.reset_launches()
    got = edge_ops.ell_edge_grad(gout, ell, "gatv2", **kw)
    assert torch.equal(got, edge_ops.ell_edge_grad(gout, ell, "gatv2", **kw))
    _within(got, edge_ops._ell_edge_grad_plain(gout, ell, "gatv2", **kw),
            dtype)
    assert _build.launches["ell_edge_grad_gatv2"] == 2
    nonempty = sum(hi > lo for lo, hi in zip(ell.t_boundaries,
                                             ell.t_boundaries[1:]))
    before = _build.launches["ell_transpose_aggregate"]
    summed = ell_edge_rows_sum(ea, ell)
    torch.cuda.synchronize()
    assert _build.launches["ell_transpose_aggregate"] == before + nonempty
    assert torch.equal(summed, ell_edge_rows_sum(ea, ell))
    want = torch.zeros((n, d), device=dev)
    ent = torch.nonzero(ell.ent_mask).reshape(-1)
    want.index_add_(0, ell.ent_src.long()[ent],
                    ea.float()[ell.ent_edge.long()[ent]])
    assert summed.dtype == dtype
    _within(summed, want.to(dtype), dtype)
    assert not summed[ell.rank[:3].long()].any()


@pytest.mark.parametrize("form", ["block", "ell", "coo"])
def test_gatv2_edges_gradients_on_card_match_cpu(dev, form):
    """GATConv(v2=True, use_edge_attr=True) in each form on the card
    against the CPU's twins (ROADMAP C3's lesson: the new autograd paths
    on the card): the output and the gradients of every parameter, the
    node rows and the edge rows, fp32 within 1e-4 of the scale (softmax and
    sums in another order), with the new modes launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, x, _ = _small_graph()
    rng = np.random.default_rng(8)
    ea = rng.normal(size=(len(src), 8)).astype(np.float32)
    modes = {"block": ("fanout_attention", "fanout_attention_bwd"),
             "ell": ("fanout_attention", "fanout_attention_bwd",
                     "ell_edge_grad_gatv2", "ell_transpose_edge_rows"),
             "coo": ("sddmm_gatv2_edge", "segment_reduce_gatv2_edge",
                     "ell_edge_grad_gatv2", "segment_reduce_bwd_edge_rows",
                     "segment_reduce_add")}[form]
    blk = (rng.normal(size=(64, 16)).astype(np.float32),
           rng.normal(size=(64, 10, 16)).astype(np.float32),
           rng.random((64, 10)) < 0.7,
           rng.normal(size=(64, 10, 8)).astype(np.float32))
    res = {}
    for device in (dev, torch.device("cpu")):
        conv = convs.GATConv(16, 32, heads=4, v2=True, use_edge_attr=True,
                             edge_dim=8)
        for prm in conv.parameters():
            prm.data = torch.randn(prm.shape, generator=torch.Generator(
            ).manual_seed(prm.numel())) * 0.3
        conv = conv.to(device)
        _build.reset_launches()
        if form == "block":
            ins = [torch.as_tensor(blk[i], device=device).requires_grad_()
                   for i in (0, 1, 3)]
            out = conv.block(ins[0], ins[1], torch.as_tensor(
                blk[2], device=device), ins[2])
        else:
            ins = [torch.as_tensor(a, device=device).requires_grad_()
                   for a in (x, ea)]
            if form == "ell":
                ell = EllGraph.from_csr(build_csr(src, dst,
                                                  num_anchor_nodes=N),
                                        device=device)
                out = conv.ell(ins[0], ell, ins[1])
            else:
                ts, td = (torch.as_tensor(a.astype(np.int32), device=device)
                          for a in (src, dst))
                out = conv.coo(ins[0], ts, td, N, ins[1])
        (out * torch.linspace(-1, 1, out.numel(), device=device)
         .reshape(out.shape)).sum().backward()
        if device.type == "cuda":
            for k in modes:
                assert _build.launches[k] > 0, (form, k)
        res[device.type] = [out.detach().cpu()] + [
            t.grad.cpu() for t in ins] + [p.grad.cpu()
                                          for p in conv.parameters()]
    for a, b in zip(res["cuda"], res["cpu"]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


# -- out-of-core training (ROADMAP A14) ----------------------------------------------
@pytest.mark.parametrize("stream_dtype", ["float32", "bfloat16"])
def test_streaming_ring_on_card_matches_cpu(dev, stream_dtype):
    """StreamingNALPTrainer.run_steps on the card (pinned ring slots, the
    copies on a side stream, prefetch 2 and 0) against the same steps on
    the CPU, from the same weights: six fp32-model losses within 1e-4
    relative (K4 / K5 sums in another order); the streamed bytes a step
    are the slot's pinned buffers; no row is drawn or gathered on the
    card."""
    from gigl_tpu_torch.training.streaming import (
        HostGraphStore, StreamingNALPTrainer)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(21)
    n, e = 700, 9000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    edges = np.stack([src, dst])
    store = HostGraphStore.build(message_edges=edges,
                                 supervision_edges=edges, features=feats,
                                 num_nodes=n, fanouts=(5, 4))
    cfg = NALPTrainerConfig(fanouts=(5, 4), num_random_negs=64,
                            cached_hop=True)
    anchors = (np.arange(32 * 6).reshape(6, 32) % n).astype(np.int32)
    losses = {}
    for device, prefetch in ((dev, 2), (dev, 0), (torch.device("cpu"), 2)):
        model = LinkPredictionGNN(GNNEncoder(16, 32, 8), LinkPredictionDecoder())
        init_params(model, 4)
        tr = StreamingNALPTrainer(model, store, cfg,
                                  optimizer_args={"learning_rate": "1e-2"},
                                  stream_dtype=stream_dtype, device=device)
        _build.reset_launches()
        _, got = tr.run_steps(tr.init_state(params=model.state_dict()),
                              anchors, prefetch=prefetch, timing=True)
        assert np.isfinite(got).all()
        if device.type == "cuda":
            for k in ("masked_reduce", "masked_reduce_bwd", "retrieval_loss"):
                assert _build.launches[k] > 0, k
            for k in ("sample_uniform", "uniform_ids", "gather_rows",
                      "build_neighbor_cache"):
                assert _build.launches[k] == 0, k
            want_bytes = sum(
                np.prod(s) * (2 if kind == "rows" and stream_dtype
                              == "bfloat16" else 4 if kind != "bool" else 1)
                for _, s, kind, on in tr._layout(32) if on)
            assert tr.last_run["bytes_per_step"] == want_bytes
            assert all(ms > 0 for ms in tr.last_run["copy_ms"])
        losses[(device.type, prefetch)] = got
    want = losses[("cpu", 2)]
    for key, got in losses.items():
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=str(key))


# -- the streamed-partitioned tier (ROADMAP A17) ------------------------------------
def test_streamed_partitioned_schedules_bit_equal_on_card(dev):
    """StreamingPartitionedNALPTrainer on the card over 4 shards: ten
    pipelined steps (run_steps, every plan and apply dispatched under
    set_sync_debug_mode("error"): the host's only wait is on the plan's
    recv event) equal ten sequential steps (train_step) bit for bit, and
    the CPU's within 1e-4 relative (K4 / K5 sums in another order); the
    two answer slots ring (each reused after its copy's event); no float
    row gathered on the card."""
    from gigl_tpu_torch.training.streaming import HostGraphStore
    from gigl_tpu_torch.training.streaming_partitioned import (
        StreamingPartitionedNALPTrainer)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(23)
    n, e = 700, 9000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    edges = np.stack([src, dst])
    store = HostGraphStore.build(
        message_edges=edges, supervision_edges=edges,
        features=rng.normal(size=(n, 16)).astype(np.float32), num_nodes=n,
        fanouts=(5, 4))
    cfg = NALPTrainerConfig(fanouts=(5, 4), num_random_negs=64,
                            cached_hop=True)
    anchors = (np.arange(32 * 10).reshape(10, 32) * 7 % n).astype(np.int32)
    model = LinkPredictionGNN(GNNEncoder(16, 32, 8), LinkPredictionDecoder())
    init_params(model, 4)
    params = {k: v.clone() for k, v in model.state_dict().items()}

    def trainer(device):
        m = LinkPredictionGNN(GNNEncoder(16, 32, 8), LinkPredictionDecoder())
        tr = StreamingPartitionedNALPTrainer(
            m, store, Mesh(4, device), cfg, batch_size=32,
            optimizer_args={"learning_rate": "1e-2"}, capacity_factor=8.0,
            overflow_policy="raise")
        return tr, tr.init_state(params=params)

    seq, ss = trainer(dev)
    got_seq = []
    for a in anchors:
        ss, loss = seq.train_step(ss, a)
        got_seq.append(float(loss))
    pipe, ps = trainer(dev)
    pipe.sync_debug_mode = "error"
    _build.reset_launches()
    gathered = []
    orig = fl.gather_rows
    fl.gather_rows = lambda t, *a, **k: (gathered.append(t.dtype),
                                         orig(t, *a, **k))[1]
    try:
        ps, got_pipe = pipe.run_steps(ps, list(anchors), timing=True)
    finally:
        fl.gather_rows = orig
    np.testing.assert_array_equal(np.asarray(got_seq, np.float32), got_pipe)
    for k in ("route_requests", "unroute_rows", "gather_rows",
              "masked_reduce", "masked_reduce_bwd", "retrieval_loss"):
        assert _build.launches[k] > 0, k
    assert gathered and all(dt == torch.int32 for dt in gathered)
    (key, ring), = pipe._rings.items()
    assert len(ring) == 2 and pipe._turn[key] == 10
    assert len(pipe.last_run["copy_ms"]) == 10
    assert all(ms > 0 for ms in pipe.last_run["copy_ms"])
    cpu, cs = trainer(torch.device("cpu"))
    _, want = cpu.run_steps(cs, list(anchors))
    np.testing.assert_allclose(got_pipe, want, rtol=1e-4)


# -- the encoder options, the link task and SSL (slice 29) ---------------------
def _option_tree(rng, b=64, k1=10, k2=5, d=16):
    """A sampled tree: feats per level, masks with empty rows."""
    shapes = [(b,), (b, k1), (b, k1, k2)]
    feats = [rng.normal(size=s + (d,)).astype(np.float32) for s in shapes]
    masks = [np.ones((b,), bool)] + [rng.random(s) < 0.7 for s in shapes[1:]]
    masks[1][:3] = False
    masks[2] &= masks[1][..., None]
    return feats, masks


def _seeded(module, seed=0):
    for prm in module.parameters():
        prm.data = torch.randn(prm.shape, generator=torch.Generator(
        ).manual_seed(seed + prm.numel())) * 0.3
    return module


def _close_to_cpu(got, want, largest):
    """Each tensor within 1e-4 of its scale, or of 1e-2 of ``largest``
    where its own is rounding noise (a gradient zero by symmetry: the
    convs' biases before batch norm, JK-lstm's att bias, an MLP's last
    bias under the retrieval softmax)."""
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-2 * largest)
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_bn_jk_lstm_encoder_train_mode_on_card_matches_cpu(dev):
    """A batch-norm + JK-lstm encoder (final linear, DCN) in train mode on
    the block path: the output, every parameter's gradient and the running
    statistics after two calls, card against CPU, fp32 within 1e-4 of the
    scale (K4 / K4b on the card; sums in another order), a gradient zero by
    symmetry within 1e-6 of the largest."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, masks = _option_tree(np.random.default_rng(20))
    res = {}
    for device in (dev, torch.device("cpu")):
        enc = _seeded(GNNEncoder(16, 32, 8, batchnorm=True, jk_mode="lstm",
                                 linear_layer=True,
                                 feature_interaction_layers=1)).to(device)
        _build.reset_launches()
        tf = [torch.as_tensor(f, device=device) for f in feats]
        tm = [torch.as_tensor(m, device=device) for m in masks]
        enc(tf, tm, train=True)
        out = enc(tf, tm, train=True)
        (out * torch.linspace(-1, 1, out.numel(), device=device).reshape(
            out.shape)).sum().backward()
        if device.type == "cuda":
            for k in ("masked_reduce", "masked_reduce_bwd"):
                assert _build.launches[k] > 0, k
        res[device.type] = [out.detach().cpu()] + [
            b.cpu() for b in enc.buffers()] + [
            p.grad.cpu() for p in enc.parameters()]
    grads = res["cpu"][-len(list(enc.parameters())):]
    _close_to_cpu(res["cuda"], res["cpu"],
                  max(float(g.abs().max()) for g in grads))


def _option_graph(seed=21, n=N, d=16):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, E), rng.integers(0, n, E)
    return src, dst, rng.normal(size=(n, d)).astype(np.float32)


def test_hadamard_mlp_nalp_step_on_card_matches_cpu(dev):
    """A NALP step's loss and gradients (live draws, retrieval loss
    through K5) with the hadamard_mlp decoder and a JK-cat encoder with
    the final linear, card against CPU from the same weights: within 1e-4
    of each scale, the MLP's last bias (zero by symmetry: the retrieval
    softmax takes a query's constant out) within 1e-6 of the largest
    gradient. Its gradient is rounding noise, so Adam's first update of it
    is +-lr by the noise's sign: the weights after a step are not held."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from gigl_tpu_torch.models.init import init_params

    src, dst, x = _option_graph()
    anchors = np.arange(64)
    res = {}
    for device in (dev, torch.device("cpu")):
        g = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
            src=src, dst=dst, num_nodes=N, node_features=x),
            supervision_edges=np.stack([src, dst]), device=device)
        model = LinkPredictionGNN(
            GNNEncoder(16, 32, 16, jk_mode="cat", linear_layer=True),
            LinkPredictionDecoder("hadamard_mlp", hidden_dim=32, in_dim=16))
        init_params(model, 3)
        t = NALPTrainer(model, g, NALPTrainerConfig(
            fanouts=(10, 5), num_random_negs=64), device=device)
        t.init_state(params=model.state_dict())
        _build.reset_launches()
        loss = t.loss(t.sample_batch(anchors, 0))
        loss.backward()
        if device.type == "cuda":
            for k in ("sample_uniform", "uniform_ids", "gather_rows",
                      "masked_reduce", "masked_reduce_bwd", "retrieval_loss"):
                assert _build.launches[k] > 0, k
        res[device.type] = [loss.detach().cpu().reshape(1)] + [
            p.grad.cpu() for p in t.model.parameters()]
    _close_to_cpu(res["cuda"], res["cpu"],
                  max(float(g.abs().max()) for g in res["cpu"][1:]))


def test_link_task_step_on_card_matches_cpu(dev):
    """One LinkClassificationTrainer step (both endpoints' trees: K1, K3,
    K4, K4b) card against CPU: the loss, every weight after the update and
    predict_batch's logits within 1e-4 relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from gigl_tpu_torch.models.init import init_params
    from gigl_tpu_torch.training.link_task import (
        EdgeClassifierHead, LinkClassificationModel,
        LinkClassificationTrainer, LinkClassificationTrainerConfig)

    src, dst, x = _option_graph(22)
    labels = np.random.default_rng(23).integers(0, 2, 400)
    edges = np.stack([src[:400], dst[:400]])
    res = {}
    for device in (dev, torch.device("cpu")):
        g = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
            src=src, dst=dst, num_nodes=N, node_features=x), device=device)
        model = LinkClassificationModel(GNNEncoder(16, 32, 16),
                                        EdgeClassifierHead(16, 2, 16))
        init_params(model, 4)
        t = LinkClassificationTrainer(model, g, edges, labels,
                                      LinkClassificationTrainerConfig(
                                          fanouts=(10, 5)), device=device)
        state = t.init_state(params=model.state_dict())
        _build.reset_launches()
        state, loss = t.train_step(state, np.arange(64))
        if device.type == "cuda":
            for k in ("sample_uniform", "gather_rows", "masked_reduce",
                      "masked_reduce_bwd"):
                assert _build.launches[k] > 0, k
        res[device.type] = [loss.cpu().reshape(1), t.predict_batch(
            src[:32], dst[:32]).cpu()] + [p.detach().cpu()
                                          for p in t.model.parameters()]
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("task", ["grace", "bgrl"])
def test_ssl_steps_on_card_match_cpu(dev, task):
    """Two SSL steps from the same weights and the same view draws (made on
    the CPU, moved to the card): the losses, every weight and, for BGRL,
    the EMA target within 1e-4 relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from gigl_tpu_torch.models.augmentations import ViewDraw
    from gigl_tpu_torch.models.init import init_params
    from gigl_tpu_torch.training.ssl_trainer import (SSLTrainer,
                                                     SSLTrainerConfig)

    src, dst, x = _option_graph(24)
    res, views = {}, None
    for device in (torch.device("cpu"), dev):
        g = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
            src=src, dst=dst, num_nodes=N, node_features=x), device=device)
        t = SSLTrainer(GNNEncoder(16, 32, 16), g, SSLTrainerConfig(
            task=task, fanouts=(10, 5)), device=device)
        init_params(t.model, 5)
        state = t.init_state(params=t.model.state_dict())
        if views is None:
            gen = torch.Generator().manual_seed(6)
            views = [t.draw_views(64, gen) for _ in range(2)]

        def on(draw):
            def mv(a):
                return None if a is None else a.to(device)
            return ViewDraw([mv(k) for k in draw.feature_keeps],
                            None if draw.edge_keeps is None
                            else [mv(k) for k in draw.edge_keeps],
                            mv(draw.perm))

        losses = []
        _build.reset_launches()
        for k in range(2):
            state, loss = t.train_step(state, np.arange(64) + 64 * k,
                                       views={n: on(v) for n, v in
                                              views[k].items()})
            losses.append(loss.cpu().reshape(1))
        if device.type == "cuda":
            for kname in ("sample_uniform", "gather_rows", "masked_reduce",
                          "masked_reduce_bwd"):
                assert _build.launches[kname] > 0, kname
        res[device.type] = losses + [p.detach().cpu()
                                     for p in t.model.parameters()] + (
            [p.detach().cpu() for p in state.target.parameters()]
            if state.target is not None else [])
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
