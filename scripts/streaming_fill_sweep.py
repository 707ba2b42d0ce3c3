#!/usr/bin/env python3
"""Host fill time of the streamed trainer's batches: the host engine's
work between two steps of ``StreamingNALPTrainer.run_steps``, measured on
the machine that holds the card (its host's cores).

    python3 scripts/streaming_fill_sweep.py [--rows 4096 16384] \\
        [--workers 1 2] [--batches 24] [--repeats 2]

Builds a copy of ``gigl_tpu_torch/native/src/gigl_native.cpp`` for each
``--rows`` value (``-DGIGL_PARALLEL_ROWS``: the rows an engine call takes
before it fans out over threads) into ``build/sweep/native/``. The store is
the flagship's (``bench.py:593-615``: N 100k, E 2M uniform random edges,
numpy seed 0, 128 fp32 features in an ``np.memmap`` under
``build/sweep/``, fanouts (15, 10), seed 0) and the batches the flagship
step's (B 512, P 1, R 512, anchors ``arange % N``). For each variant in
turns (the order reversed every other repeat), ``workers`` threads fill
ring slots (pinned when CUDA is available, as ``run_steps`` makes them)
with ``--batches`` batches between them, in three forms: the fp32 stream,
the bf16 stream (the engine writes the bf16 bits in its gather pass), and
``numpy_cast``: the fp32 fill followed by ``utils/cast.py``'s
``to_bfloat16`` of every row into bf16 buffers (the cast after the gather
that the engine's pass replaced). One JSON line a (variant, form, workers,
repeat): the median fill ms a batch and the batches a second across the
workers; then the card's nvidia-smi line.
"""

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gigl_tpu_torch import native  # noqa: E402
from gigl_tpu_torch.models.encoders import GNNEncoder  # noqa: E402
from gigl_tpu_torch.models.link_prediction import (  # noqa: E402
    LinkPredictionDecoder, LinkPredictionGNN)
from gigl_tpu_torch.training.streaming import (  # noqa: E402
    HostGraphStore, StreamingNALPTrainer)
from gigl_tpu_torch.training.trainer import NALPTrainerConfig  # noqa: E402
from gigl_tpu_torch.utils.cast import to_bfloat16  # noqa: E402

N, E, D, B, R, FANOUTS = 100_000, 2_000_000, 128, 512, 512, (15, 10)
SWEEP = REPO / "build" / "sweep"


def engine(rows: int) -> Path:
    out = SWEEP / "native" / f"libgigl_native_rows{rows}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", *native.FLAGS, f"-DGIGL_PARALLEL_ROWS={rows}",
                    str(native.SRC), "-o", str(out)], check=True)
    return out


def fill(trainer, slots, anchors, workers, batches, cast_after):
    """``batches`` fills over ``workers`` threads, each on its own slot;
    (median ms a batch, batches a second)."""
    per = []

    def work(w):
        slot = slots[w]
        out = {k: np.empty(v.shape, np.uint16) for k, v in slot.host.items()
               if ".feat" in k or ".agg" in k} if cast_after else None
        for i in range(w, batches, workers):
            t0 = time.perf_counter()
            trainer._fill(slot, anchors[i], i)
            if cast_after:
                for k, buf in out.items():
                    to_bfloat16(slot.host[k], out=buf)
            per.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for f in [pool.submit(work, w) for w in range(workers)]:
            f.result()
    wall = time.perf_counter() - t0
    return float(np.median(per)) * 1e3, batches / wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[4096, 16384])
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    libs = {rows: native.load(engine(rows)) for rows in args.rows}
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    feats = rng.normal(size=(N, D)).astype(np.float32)
    path = SWEEP / "features.f32"
    feats.tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=(N, D))
    edges = np.stack([src, dst])
    native._lib = libs[args.rows[0]]
    store = HostGraphStore.build(message_edges=edges,
                                 supervision_edges=edges, features=mm,
                                 num_nodes=N, fanouts=FANOUTS)
    cfg = NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R,
                            cached_hop=True)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    trainers = {
        sd: StreamingNALPTrainer(
            LinkPredictionGNN(GNNEncoder(D, 256, 128, num_layers=2),
                              LinkPredictionDecoder()), store, cfg,
            stream_dtype=sd, device=device)
        for sd in ("float32", "bfloat16")}
    anchors = (np.arange(B * args.batches) % N).astype(np.int32).reshape(
        args.batches, B)
    forms = (("float32", "float32", False), ("bfloat16", "bfloat16", False),
             ("numpy_cast", "float32", True))
    for rep in range(args.repeats):
        order = args.rows if rep % 2 == 0 else list(reversed(args.rows))
        for rows in order:
            native._lib = libs[rows]
            for form, sd, cast_after in forms:
                tr = trainers[sd]
                for w in args.workers:
                    slots = [tr._new_slot(B) for _ in range(w)]
                    fill(tr, slots, anchors, w, min(w, args.batches), False)
                    ms, per_s = fill(tr, slots, anchors, w, args.batches,
                                     cast_after)
                    print(json.dumps({
                        "phase": "streaming_fill", "parallel_rows": rows,
                        "form": form, "workers": w, "repeat": rep,
                        "fill_ms_median": ms, "batches_per_s": per_s,
                        "engine_threads": native.THREADS,
                        "device": device}), flush=True)
    path.unlink()
    if device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
