"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs a GPU and skips
without one. Run them on a machine with a card (no JAX needed there):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m cuda tests/test_torch_cuda_kernels.py

Edge shapes beyond the flagship ones that chip_smoke.py checks: isolated
nodes, fanouts above a warp (40), rows narrower and wider than a warp's
16-byte pieces, 4-byte-only rows, strided tables, all-masked rows. Integer
and copied outputs must be bit-equal; fp32 sums rtol 1e-5 (order differs);
bf16 reductions within 2e-2 of the row scale (one rounding vs another).
"""

import numpy as np
import pytest
import torch

from gigl_tpu_torch.graph.csr import HeteroGraph, build_csr
from gigl_tpu_torch.inference.inferencer import InferenceConfig, run_inference
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.fanout import _masked_reduce_plain, masked_reduce
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
from gigl_tpu_torch.sampling.neighbor_sampler import (
    DeviceCSR,
    _sample_uniform_plain,
    sample_uniform,
)
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.trainer import NALPTrainer, NALPTrainerConfig

pytestmark = pytest.mark.cuda

N, E = 700, 9000


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
@pytest.mark.parametrize("fanout,dim", [(3, 16), (10, 128), (40, 160)])
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
@pytest.mark.parametrize("shape", [(40, 15, 256), (9, 3, 8), (64, 40, 32)])
def test_masked_reduce_matches_plain(dev, dtype, op, shape):
    m, k, d = shape
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    mask = torch.rand((m, k), generator=g, device=dev) < 0.6
    mask[:2] = False
    got = masked_reduce(x, mask, op)
    want = _masked_reduce_plain(x, mask, op)
    assert got.dtype == dtype and got.shape == (m, d)
    assert torch.equal(got[:2], torch.zeros_like(got[:2]))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale


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
