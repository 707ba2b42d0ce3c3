#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gigl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs CUDA

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from gigl_tpu_torch/csrc and prints the build time;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the flagship configuration (bench.py:593-615: N=100k nodes,
   E=2M edges, D=128, fanouts (15, 10), batch 512, GraphSAGE hidden 256,
   out 128, bf16), and times both (device time from CUDA-graph replay,
   plus the wrapper's eager time; warm L2);
4. runs the port's sampled-inference path — NALPTrainer(cached_hop,
   fused_cache) -> run_inference over all nodes — with every kernel's launch
   count reset just before and read just after, checks the export, and
   recomputes batch 0 through the plain versions, and times one batch's
   device work alone (CUDA-graph replay) beside the host-clocked ms/batch;
5. prints one JSON line with every kernel's numbers, then the card line,
   then {"ok": true, ...} as the last line.

Any failed check raises; nothing is printed as a result without a card.
It imports neither JAX nor the JAX package.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N, E, D = 100_000, 2_000_000, 128
HID, OUT, BATCH = 256, 128, 512
FANOUTS = (15, 10)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def cuda_ms(fn, reps=20):
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph, replayed and timed with CUDA events, so the host's launch cost
    is left out (``eager_ms`` measures it in)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def eager_ms(fn, reps=50):
    """Time per call of ``fn`` issued back to back from Python: bounded by
    the host's launch cost when the device work is shorter."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    if not (REPO / "gigl_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(gigl_tpu_torch/ not found beside this script)")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(REPO))
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, run_inference)
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.fanout import _masked_reduce_plain, masked_reduce
    from gigl_tpu_torch.ops.gather import (
        _expand_table_plain, _gather_rows_plain, expand_table, gather_rows)
    from gigl_tpu_torch.ops.hopcache import (
        _neighbor_cache_plain, build_neighbor_cache)
    from gigl_tpu_torch.sampling.neighbor_sampler import (
        _sample_uniform_plain, sample_uniform)
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.trainer import NALPTrainer, NALPTrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- build ------------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds})

    # -- the flagship graph, exactly as bench.py builds it -------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    graph = HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N,
        node_features=rng.normal(size=(N, D)).astype(np.float32))
    dg = DeviceGraph.from_hetero(graph, supervision_edges=np.stack([src, dst]))
    torch.cuda.synchronize()
    emit({"phase": "graph", "seconds": time.perf_counter() - t0})
    csr, x, deg = dg.message_csr, dg.node_features, dg.degrees
    deg_i = torch.diff(csr.indptr.long())
    k1, k2 = FANOUTS
    results = []

    def record(name_, source, replaces, err, ms, plain_ms, nbytes, nops,
               library_ms=None, **extra):
        b, by = bound_ms(nbytes, nops)
        row = {"name": name_, "route": "cuda", "source": source,
               "replaces": replaces, "launches": None, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
               "library_ms": library_ms, **extra}
        results.append(row)
        emit({"phase": "kernel", **row})

    def unique(t):
        return int(torch.unique(t).numel())

    # -- K1 sample_uniform: the sample-table draw (fanout 15, hop 1) --------------
    ids_all = torch.arange(N, dtype=torch.int32, device=dev)

    def k1_kernel():
        return sample_uniform(csr.indptr, csr.indices, ids_all, k1, 0, 1)

    def k1_plain():
        return _sample_uniform_plain(csr.indptr, csr.indices, ids_all, k1, 0, 1)

    got = k1_kernel()
    for g, w in zip(got, k1_plain()):
        check(torch.equal(g, w), "K1 sample_uniform is not bit-equal")
    # bytes: indptr and frontier read once, the CSR slots drawn read once,
    # ids + mask + slots written; ops: ~24 integer ops per (node, slot).
    record("sample_uniform", "gigl_tpu_torch/csrc/sample_uniform.cu",
           "gigl_tpu/sampling/neighbor_sampler.py:176", 0.0,
           cuda_ms(k1_kernel), cuda_ms(k1_plain, reps=5),
           nbytes=(N + 1) * 4 + N * 4 + unique(got[2][got[1]]) * 4
           + N * k1 * 9,
           nops=N * k1 * 24, eager_ms=eager_ms(k1_kernel))
    table = torch.where(got[1], got[0], -1)

    # -- K2 build_neighbor_cache: mean of 10 rows into the fused table -----------
    fused = torch.empty((N, 2 * D), dtype=torch.float32, device=dev)
    fused[:, :D].copy_(x)

    def k2_kernel():
        return build_neighbor_cache(csr, x, fanout=k2, seed=0, hop_key=2,
                                    agg="mean", out=fused[:, D:])

    plain_cache = torch.empty((N, D), dtype=torch.float32, device=dev)

    def k2_plain():
        return _neighbor_cache_plain(csr, x, k2, 0, 2, "mean", None,
                                     plain_cache)

    k2_kernel()
    k2_plain()
    torch.testing.assert_close(fused[:, D:], plain_cache, rtol=1e-5, atol=1e-6)
    err2 = float((fused[:, D:] - plain_cache).abs().max())
    d_ids, d_mask, d_slots = _sample_uniform_plain(csr.indptr, csr.indices,
                                                   ids_all, k2, 0, 2)
    valid2 = int(d_mask.sum())
    # bytes: indptr, the drawn CSR slots and the drawn feature rows each read
    # once (a row drawn by several nodes counts once), the table written.
    record("build_neighbor_cache", "gigl_tpu_torch/csrc/neighbor_cache.cu",
           "gigl_tpu/ops/hopcache.py:52", err2,
           cuda_ms(k2_kernel), cuda_ms(k2_plain, reps=5),
           nbytes=(N + 1) * 4 + unique(d_slots[d_mask]) * 4
           + unique(d_ids[d_mask]) * D * 4 + N * D * 4,
           nops=valid2 * D + N * D, eager_ms=eager_ms(k2_kernel))

    # -- K3 gather_rows: batch 0's expansion and fused-row hydration --------------
    roots = torch.arange(BATCH, dtype=torch.int32, device=dev)
    parent = torch.ones(BATCH, dtype=torch.bool, device=dev)
    nbr, m1 = expand_table(table, roots, parent)
    pn, pm = _expand_table_plain(table, roots, parent)
    check(torch.equal(nbr, pn) and torch.equal(m1, pm),
          "K3 expand mode is not bit-equal")
    level_ids = torch.cat([roots, nbr.reshape(-1)])

    def k3_kernel():
        return gather_rows(fused, level_ids, deg)

    rows, degs = k3_kernel()
    prow, pdeg = _gather_rows_plain(fused, level_ids, deg)
    check(torch.equal(rows, prow) and torch.equal(degs, pdeg),
          "K3 rows mode is not bit-equal")
    idx64 = level_ids.long()
    mrows, urows = level_ids.shape[0], unique(level_ids)
    # bytes: ids read, each distinct fused row (1 KB) and degree read once,
    # every gathered row and degree written.
    record("gather_rows", "gigl_tpu_torch/csrc/gather_rows.cu",
           "gigl_tpu/training/dataset.py:419", 0.0,
           cuda_ms(k3_kernel),
           cuda_ms(lambda: _gather_rows_plain(fused, level_ids, deg)),
           nbytes=mrows * 4 + (urows + mrows) * (2 * D * 4 + 4), nops=0,
           library_ms=cuda_ms(lambda: torch.index_select(fused, 0, idx64)),
           eager_ms=eager_ms(k3_kernel),
           expand_ms=cuda_ms(lambda: expand_table(table, roots, parent)),
           expand_plain_ms=cuda_ms(
               lambda: _expand_table_plain(table, roots, parent)),
           expand_bound_ms=bound_ms(BATCH * 5 + 2 * BATCH * k1 * 4
                                    + BATCH * k1, 0)[0])

    # -- K4 masked_reduce: layer 2's mean over [512, 15, 256] bf16 -----------------
    h1 = torch.randn((BATCH, k1, HID), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).to(torch.bfloat16)

    def k4_kernel():
        return masked_reduce(h1, m1, "mean")

    got4 = k4_kernel()
    want4 = _masked_reduce_plain(h1, m1, "mean")
    scale = float(want4.float().abs().max())
    err4 = float((got4.float() - want4.float()).abs().max())
    check(err4 <= 2e-2 * scale, f"K4 masked_reduce error {err4} > 2e-2*{scale}")
    valid4 = int(m1.sum())
    # bytes: the valid slot rows and the mask read once, [M, D] written.
    record("masked_reduce", "gigl_tpu_torch/csrc/masked_reduce.cu",
           "gigl_tpu/ops/fanout.py:34", err4,
           cuda_ms(k4_kernel),
           cuda_ms(lambda: _masked_reduce_plain(h1, m1, "mean")),
           nbytes=valid4 * HID * 2 + BATCH * k1 + BATCH * HID * 2,
           nops=valid4 * HID + BATCH * HID, eager_ms=eager_ms(k4_kernel))

    # -- the main path: refresh the tables, then embed every node -----------------
    class Sink:
        def __init__(self):
            self.ids, self.embs = [], []

        def add_embeddings(self, ids, emb):
            self.ids.append(np.asarray(ids))
            self.embs.append(emb)

        def flush(self):
            pass

    torch.manual_seed(0)
    model = LinkPredictionGNN(
        GNNEncoder(D, HID, OUT, num_layers=2, conv="graphsage",
                   dtype=torch.bfloat16), LinkPredictionDecoder())
    cfg = NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=512,
                            loss_type="retrieval", num_positives=1,
                            cached_hop=True, fused_cache=True)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = NALPTrainer(model, dg, cfg)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    trainer.init_params(0)
    sink = Sink()
    t0 = time.perf_counter()
    total = run_inference(trainer, N, sink, InferenceConfig(batch_size=BATCH))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    n_batches = -(-N // BATCH)
    # K1/K2 run once per table refresh, K3/K4 once per batch.
    per_pass = {"sample_uniform": 1, "build_neighbor_cache": 1,
                "gather_rows": n_batches, "masked_reduce": n_batches}
    for row in results:
        row["launches"] = launches[row["name"]]
        row["launches_per_pass"] = launches[row["name"]] / per_pass[row["name"]]
    emit({"phase": "main_path", "launches": launches,
          "refresh_s": refresh_s, "inference_s": cold_s})
    for kname in _build.KERNEL_NAMES:
        check(launches[kname] > 0, f"{kname} was not launched on the main path")

    ids = np.concatenate(sink.ids)
    embs = np.concatenate(sink.embs)
    check(total == N and ids.shape == (N,), "wrong number of exported rows")
    check(np.array_equal(np.sort(ids), np.arange(N)),
          "exported ids are not every node exactly once")
    check(embs.shape == (N, OUT) and np.isfinite(embs).all(),
          "embeddings are not finite [N, 128]")

    # warm pass (timing only; the launch counts above are the main path's)
    sink2 = Sink()
    t0 = time.perf_counter()
    run_inference(trainer, N, sink2, InferenceConfig(batch_size=BATCH))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(np.array_equal(np.concatenate(sink2.embs), embs),
          "a second inference pass differs from the first")
    ids_t = torch.arange(BATCH, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        device_ms = cuda_ms(
            lambda: trainer._encode_impl(trainer.graph, ids_t, 0, False),
            reps=10)
    emit({"phase": "throughput", "nodes": N, "batches": n_batches,
          "device_ms_per_batch": device_ms,
          "cold_nodes_per_s": N / cold_s, "warm_nodes_per_s": N / warm_s,
          "cold_ms_per_batch": cold_s / n_batches * 1e3,
          "warm_ms_per_batch": warm_s / n_batches * 1e3,
          "refresh_ms": refresh_s * 1e3, "card": card})

    # -- batch 0 again, through the plain versions only -------------------------
    with torch.inference_mode():
        enc = trainer.model.encoder
        ids0, m0, _ = _sample_uniform_plain(csr.indptr, csr.indices, roots,
                                            k1, cfg.seed, 1)
        nbr0 = torch.where(m0, ids0, 0)
        h = []
        for lvl in (roots, nbr0.reshape(-1)):
            cn, cm, _ = _sample_uniform_plain(csr.indptr, csr.indices, lvl,
                                              k2, cfg.seed, len(FANOUTS))
            agg = _masked_reduce_plain(x[cn.long()], cm, "mean")
            xin = x[lvl.long()].to(torch.bfloat16)
            h.append(torch.relu(enc.convs[0].block_cached(xin, agg)))
        agg2 = _masked_reduce_plain(h[1].reshape(BATCH, k1, HID), m0, "mean")
        ref0 = enc.convs[1]._combine(h[0], agg2).float().cpu().numpy()
    got0 = embs[:BATCH]
    scale0 = float(np.abs(ref0).max())
    err0 = float(np.abs(got0 - ref0).max())
    emit({"phase": "batch0_vs_plain", "max_abs_err": err0, "scale": scale0})
    check(err0 <= 3e-2 * scale0,
          f"batch 0 differs from the plain recomputation: {err0} vs {scale0}")

    emit({"kernels": results})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
