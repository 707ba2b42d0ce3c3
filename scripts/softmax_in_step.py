#!/usr/bin/env python3
"""Where K9 segment_softmax's and K9b segment_softmax_bwd's time goes
inside a COO full-batch step, on one NVIDIA GPU: K9's launch timed in the
step and alone, in several states of the L2, and K9b's in the step.

    python3 scripts/softmax_in_step.py [--models gat transformer]
        [--steps 3] [--calls 10]

The graph and models are chip_smoke.py's COO full-batch paths: N=100k
nodes, E=2M uniform random edges in their random order (numpy seed 0),
128 features, two layers of width 256, 4 heads, 16 classes. For each
model it runs ``--steps`` training steps under torch.profiler and prints
every K9 launch of the step: its kernel form (the template arguments in
its name: the dtype, the heads, the lane group and the evict-first reads),
its device time, what the wrapper was given (shape, contiguity, 16-byte
alignment, the ``_softmax_streams`` choice) and the device op before it,
and the same for every K9b launch (``k9b_in_step``: the backward of each
layer's softmax, cold as the step leaves the L2), after a ``step`` line
with the device ms a step (every device op) and K9's and K9b's share. Then, on each layer's
logits as the step made them, ``--calls`` launches
of the wrapper, each profiled alone, after one of:

- ``warm``: the previous launch on the same logits (back to back);
- ``after_write``: the logits written again (a copy from another tensor:
  32 MB of dirty lines in the L2, as their producer leaves them);
- ``cold_clean``: a 256 MB read of another tensor (the logits and alpha
  in DRAM only, the L2 clean);
- ``cold_dirty``: a 256 MB write of another tensor (the L2 full of dirty
  lines that the launch must write back as it evicts them);

and the same after ``after_write`` with the evict-first reads forced on
and off (``stream``, ``cache``, the C entry launched directly). Each line is
one JSON object with the mean, the minimum and the maximum device time in
ms; the last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
N, E, D = 100_000, 2_000_000, 128
HID, C, HEADS = 256, 16, 4
FLUSH_BYTES = 256 * 2**20


def emit(obj):
    print(json.dumps(obj), flush=True)


def k9_events(prof):
    """The profiled device ops in start order, as (name, start us, ms)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return sorted(((e.name, e.time_range.start,
                    e.time_range.elapsed_us() / 1e3) for e in events),
                  key=lambda t: t[1])


def is_k9(name):
    return "segment_softmax_kernel" in name


def is_k9b(name):
    return "segment_softmax_bwd_kernel" in name


def summary(ms):
    return {"ms_mean": float(np.mean(ms)), "ms_min": float(np.min(ms)),
            "ms_max": float(np.max(ms)), "launches": len(ms)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--models", nargs="+",
                        default=["gat", "transformer"],
                        choices=["gat", "transformer"])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--calls", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("softmax_in_step: no CUDA device")
    sys.path.insert(0, str(REPO))
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops import segment as seg
    from gigl_tpu_torch.training.full_batch import (
        FullBatchTrainer, full_batch_data_from_graph)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    graph = HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N,
        node_features=rng.normal(size=(N, D)).astype(np.float32),
        node_labels=rng.integers(0, C, N))
    fb = full_batch_data_from_graph(graph, build_ell=False, device=dev)
    index, ids = fb.index, fb.dst

    # what the wrapper is given in the step: _softmax_streams sees the
    # contiguous logits it launches on
    seen, keep = [], {"on": False}
    streams = seg._softmax_streams

    def watched(lg, *tables):
        choice = streams(lg, *tables)   # K9 passes no table count
        seen.append({"kernel": "K9b" if tables else "K9",
                     "shape": list(lg.shape), "dtype": str(lg.dtype),
                     "contiguous": lg.is_contiguous(),
                     "aligned16": lg.data_ptr() % 16 == 0,
                     "streams": choice})
        if keep["on"] and not tables:
            keep.setdefault("logits", []).append(lg.detach().clone())
        return choice

    seg._softmax_streams = watched
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    other = torch.zeros(FLUSH_BYTES // 4, device=dev)

    for model in args.models:
        fbt = FullBatchTrainer(
            GNNEncoder(D, HID, C, num_layers=2, conv=model,
                       conv_kwargs={"heads": HEADS}), fb,
            optimizer_args={"learning_rate": "1e-2"}, device=dev)
        state = fbt.init_state(0)
        for _ in range(3):
            state, _ = fbt.train_step(state)
        torch.cuda.synchronize()
        seen.clear()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                state, _ = fbt.train_step(state)
            torch.cuda.synchronize()
        events = k9_events(prof)
        emit({"phase": "step", "model": model, "steps": args.steps,
              "device_ms_per_step": sum(ev[2] for ev in events)
              / args.steps, **{f"{k_}_ms_per_step": sum(
                  ev[2] for ev in events if m_(ev[0])) / args.steps
                  for k_, m_ in (("k9", is_k9), ("k9b", is_k9b))}})
        for phase, match, kernel in (("k9_in_step", is_k9, "K9"),
                                     ("k9b_in_step", is_k9b, "K9b")):
            hits = [(i, ev) for i, ev in enumerate(events) if match(ev[0])]
            saw = [x for x in seen if x["kernel"] == kernel]
            n_calls = len(hits) // args.steps
            for c_ in range(n_calls):
                mine = [ev for k, (_, ev) in enumerate(hits)
                        if k % n_calls == c_]
                before = {events[i - 1][0][:90]
                          for k, (i, _) in enumerate(hits)
                          if k % n_calls == c_ and i > 0}
                emit({"phase": phase, "model": model, "call": c_,
                      "form": mine[0][0][:160],
                      "wrapper_saw": saw[c_] if c_ < len(saw) else None,
                      "device_op_before": sorted(before),
                      **summary([ev[2] for ev in mine])})
        calls = len([ev for ev in events if is_k9(ev[0])]) // args.steps
        keep["on"] = True
        state, _ = fbt.train_step(state)
        torch.cuda.synchronize()
        keep["on"] = False
        taken = keep.pop("logits")
        del fbt, state

        for layer, lg in enumerate(taken[:calls], start=1):
            src_copy = lg.clone()
            heads = lg.shape[1] if lg.dim() == 2 else 1
            dcode = 0 if lg.dtype == torch.float32 else 1

            def launch_k9(lg=lg):
                return seg.segment_softmax(lg, ids, N, index=index)

            def forced(stream, lg=lg, heads=heads, dcode=dcode):
                out = torch.empty_like(lg)
                _build.launch("segment_softmax", "gigl_segment_softmax", dev,
                              lg.data_ptr(), index.order.data_ptr(),
                              index.ptr.data_ptr(), out.data_ptr(), N, heads,
                              dcode, 1, stream)
                return out

            befores = {
                "warm": lambda: None,
                "after_write": lambda lg=lg, s_=src_copy: lg.copy_(s_),
                "cold_clean": lambda: other.sum(),
                "cold_dirty": lambda: flush.fill_(1.0),
            }
            runs = [(cond, before, launch_k9)
                    for cond, before in befores.items()]
            runs += [(f"after_write_{name}", befores["after_write"],
                      lambda s_=s_, f=forced: f(s_))
                     for name, s_ in (("stream", 1), ("cache", 0))]
            for cond, before, fn in runs:
                fn()
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.calls):
                        before()
                        fn()
                    torch.cuda.synchronize()
                ms = [ev[2] for ev in k9_events(prof) if is_k9(ev[0])]
                emit({"phase": "k9_alone", "model": model, "layer": layer,
                      "condition": cond, "shape": list(lg.shape),
                      **summary(ms)})
            del src_copy
        del taken
    seg._softmax_streams = streams
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
