#!/usr/bin/env python3
"""Device time of chosen kernels inside the paths that launch them, on one
NVIDIA GPU: each path driven through its user entry point and profiled.

    python3 scripts/in_path_profile.py --paths full_graph_graphsage \\
        partitioned_ring --kernel k6=ell_aggregate_kernel \\
        --kernel k17=ring_fold_kernel,ring_block_bwd_kernel [--count 5]

``--kernel NAME=SUB[,SUB...]`` counts every device op whose name holds one
of the substrings under NAME (the names are those chip_smoke.py's
``profile_summary`` matches: ``ell_aggregate_kernel`` for K6,
``ring_fold_kernel`` / ``ring_block_bwd_kernel`` for K17,
``segment_softmax_kernel`` / ``segment_softmax_bwd_kernel`` for K9 / K9b,
``masked_reduce_kernel`` / ``masked_reduce_walk_kernel`` for K4's two
forms, ``retrieval_fwd`` / ``retrieval_bwd`` for K5's forward and
backward launches, ...). The graph is chip_smoke.py's flagship: N=100k
nodes, E=2M uniform random edges (numpy seed 0), 128 fp32 features and
16 labels, and 8 fp32 features an edge (numpy seed 8). The paths
(``--paths``, all by default):

- ``full_graph_graphsage``: ``GNNEncoder.encode_ell`` (GraphSAGE, hidden
  256, out 128, bf16, ``init_params`` seed 0) under inference mode;
- ``full_graph_gine``: the same with the edge features (GINE, hidden =
  out = 128);
- ``full_batch_graphsage``: ``FullBatchTrainer`` steps (2 layers, hidden
  256, fp32, Adam 1e-2) over the ELL tables;
- ``full_batch_gine``: the same with ``FullBatchData.edge_attr`` (GINE,
  hidden 128);
- ``coo_gat``, ``coo_transformer``: ``FullBatchTrainer`` steps over the
  COO tables (``build_ell=False``; hidden 256, 4 heads, fp32);
- ``partitioned_ring``: ``PartitionedNALPTrainer`` over ``make_mesh(4)``
  with the global candidate pool (the ring loss) and the sketch on:
  GraphSAGE (15, 10), bf16, batch 512, 512 random negatives, capacity
  factor 4;
- ``nalp_step``: the flagship NALP training step, ``NALPTrainer.train_steps``
  one step a call (GraphSAGE (15, 10), cached hop in the fused table,
  bf16, batch 512, 512 random negatives, the retrieval loss, Adam 1e-3;
  anchors ``arange % N`` as bench.py:617 draws them);
- ``sampled_inference``: ``run_inference`` over every node of the
  flagship graph with that trainer's model (batch 512: 196 batches a
  pass, the rows kept in host memory);
- ``quantized_inference``: the same pass over int8 tables (features from
  ``from_hetero(quantize_features=True)``, the cached hop's table with
  ``quantize_cache``), as chip_smoke.py's phase 13 runs it;
- ``weighted_live_step``: a NALP training step over chip_smoke.py's
  weighted graph (column 0 of an [E, 8] uniform edge table, numpy seed
  16) with ``sampling_method="weighted"`` and live sampling (no cached
  hop): six K19 draws a step.

Per path, two warm calls (a pass or a step), then ``--count`` more under
torch.profiler: one JSON line with the device ms a call (every device
op), and each kernel's device ms and launches a call. The last line is
the card's name and power limit. The script calls only entry points that
earlier checkouts have too: copied into such a checkout's ``scripts/`` and
run from its root, it times the same paths there, so two trees can be
compared in turns in one call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
N, E, D = 100_000, 2_000_000, 128
HID, OUT, C, EDGE_DE, GINE_HID, HEADS = 256, 128, 16, 8, 128, 4
BATCH, R, SHARDS = 512, 512, 4   # the ring step: anchors, negatives
PATHS = ("full_graph_graphsage", "full_graph_gine", "full_batch_graphsage",
         "full_batch_gine", "coo_gat", "coo_transformer", "partitioned_ring",
         "nalp_step", "sampled_inference", "quantized_inference",
         "weighted_live_step")


def profiled(fn, count, kernels):
    """Device ms a call of ``fn`` (every device op) and each kernel's
    device ms and launches a call, over ``count`` profiled calls after
    two warm ones. ``kernels``: name -> substrings of its device ops."""
    from torch.autograd import DeviceType

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
    row = {"device_ms": 0.0}
    for key in kernels:
        row[f"{key}_ms"] = row[f"{key}_launches"] = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3 / count
        row["device_ms"] += ms
        for key, subs in kernels.items():
            if any(s in e.name for s in subs):
                row[f"{key}_ms"] += ms
                row[f"{key}_launches"] += 1 / count
    return row


class Flagship:
    """The flagship graph, its tables made at first use."""

    def __init__(self, dev):
        from gigl_tpu_torch.graph.csr import HeteroGraph

        self.dev = dev
        rng = np.random.default_rng(0)
        self.src, self.dst = rng.integers(0, N, E), rng.integers(0, N, E)
        self.x_np = rng.normal(size=(N, D)).astype(np.float32)
        self.graph = HeteroGraph.homogeneous(
            src=self.src, dst=self.dst, num_nodes=N,
            node_features=self.x_np, node_labels=rng.integers(0, C, N))
        self.ea = torch.as_tensor(np.random.default_rng(8).normal(
            size=(E, EDGE_DE)).astype(np.float32), device=dev)
        self._ell = self._coo = None

    def ell_data(self):
        from gigl_tpu_torch.training.full_batch import (
            full_batch_data_from_graph)

        if self._ell is None:
            self._ell = full_batch_data_from_graph(self.graph,
                                                   device=self.dev)
        return self._ell

    def coo_data(self):
        from gigl_tpu_torch.training.full_batch import (
            full_batch_data_from_graph)

        if self._coo is None:
            self._coo = full_batch_data_from_graph(
                self.graph, build_ell=False, device=self.dev)
        return self._coo


def full_graph(g, conv):
    """A full-graph pass of a bf16 encoder over the ELL tables."""
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.init import init_params

    edges = g.ea if conv == "gine" else None
    enc = GNNEncoder(D, GINE_HID if edges is not None else HID, OUT,
                     num_layers=2, conv=conv,
                     edge_dim=EDGE_DE if edges is not None else None,
                     dtype=torch.bfloat16)
    init_params(enc, 0)
    enc.to(g.dev)
    ell, x = g.ell_data().ell, torch.as_tensor(g.x_np, device=g.dev)

    def one_pass():
        with torch.inference_mode():
            if edges is None:
                return enc.encode_ell(x, ell)
            return enc.encode_ell(x, ell, edges)
    return one_pass


def full_batch(g, conv, coo):
    """A full-batch training step over the ELL or the COO tables."""
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.training.full_batch import FullBatchTrainer

    data = g.coo_data() if coo else g.ell_data()
    edges = g.ea if conv == "gine" else None
    kwargs = {"conv_kwargs": {"heads": HEADS}} if coo else {}
    fbt = FullBatchTrainer(
        GNNEncoder(D, GINE_HID if edges is not None else HID, C,
                   num_layers=2, conv=conv,
                   edge_dim=EDGE_DE if edges is not None else None,
                   **kwargs),
        dataclasses.replace(data, edge_attr=edges),
        optimizer_args={"learning_rate": "1e-2"}, device=g.dev)
    state = [fbt.init_state(0)]

    def one_step():
        state[0], _ = fbt.train_step(state[0])
    return one_step


def partitioned_ring(g, count):
    """A step of the partitioned trainer with the ring loss."""
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.parallel.mesh import make_mesh
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.dist_sampled import (
        PartitionedGraph, PartitionedNALPTrainer)
    from gigl_tpu_torch.training.trainer import NALPTrainerConfig

    dg = dataclasses.replace(DeviceGraph.from_hetero(
        g.graph, supervision_edges=np.stack([g.src, g.dst]), device=g.dev),
        node_labels=None)
    mesh = make_mesh(SHARDS, g.dev)
    trainer = PartitionedNALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT, num_layers=2,
                                     conv="graphsage", dtype=torch.bfloat16),
                          LinkPredictionDecoder()),
        PartitionedGraph.build(dg, mesh), mesh,
        NALPTrainerConfig(fanouts=(15, 10), num_random_negs=R,
                          loss_type="retrieval", num_positives=1,
                          use_cms_correction=True,
                          global_candidate_pool=True),
        optimizer_args={"learning_rate": "1e-3"}, capacity_factor=4.0,
        overflow_policy="raise")
    state = [trainer.init_state(0)]
    gens = [torch.Generator(device=g.dev).manual_seed(s)
            for s in range(SHARDS)]
    anchors = (np.arange(BATCH * (count + 2)) % N).astype(
        np.int32).reshape(-1, 1, BATCH)
    step = [0]

    def ring_step():
        state[0], _ = trainer.train_steps(state[0], anchors[step[0]], gens)
        step[0] += 1
    return ring_step


class _Rows:
    """An exporter that keeps the rows it is given."""

    def __init__(self):
        self.rows = []

    def add_embeddings(self, ids, emb):
        self.rows.append((ids, emb))

    def flush(self):
        pass


def nalp_trainer(g, kind="fused"):
    """The flagship NALP trainer (chip_smoke.py's main paths): ``fused``,
    the cached hop in the fused fp32 table; ``int8``, int8 features and
    cache; ``weighted``, live weighted draws over the [E, 8] edge table's
    column 0."""
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.trainer import (
        NALPTrainer, NALPTrainerConfig)

    graph, extra = g.graph, {}
    cfg = NALPTrainerConfig(fanouts=(15, 10), num_random_negs=R,
                            loss_type="retrieval", num_positives=1,
                            cached_hop=True, fused_cache=True)
    if kind == "int8":
        extra = {"quantize_features": True}
        cfg = dataclasses.replace(cfg, fused_cache=False,
                                  quantize_cache=True)
    elif kind == "weighted":
        graph = HeteroGraph.homogeneous(
            src=g.src, dst=g.dst, num_nodes=N, node_features=g.x_np,
            edge_features=np.random.default_rng(16).random(
                (E, EDGE_DE), dtype=np.float32))
        extra = {"sampling_weight_index": 0}
        cfg = dataclasses.replace(cfg, cached_hop=False, fused_cache=False,
                                  sampling_method="weighted")
    dg = DeviceGraph.from_hetero(
        graph, supervision_edges=np.stack([g.src, g.dst]), device=g.dev,
        **extra)
    torch.manual_seed(0)
    return NALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT, num_layers=2,
                                     conv="graphsage", dtype=torch.bfloat16),
                          LinkPredictionDecoder()),
        dg, cfg, optimizer_args={"learning_rate": "1e-3"}, device=g.dev)


def nalp_step(g, count, kind="fused"):
    """A flagship NALP training step."""
    trainer = nalp_trainer(g, kind)
    state = [trainer.init_state(0, batch_size=BATCH)]
    gen = torch.Generator(device=g.dev).manual_seed(1)
    anchors = (np.arange(BATCH * (count + 2)) % N).astype(np.int32).reshape(
        -1, 1, BATCH)
    step = [0]

    def one_step():
        state[0], _ = trainer.train_steps(state[0], anchors[step[0]], gen)
        step[0] += 1
    return one_step


def sampled_inference(g, kind="fused"):
    """``run_inference`` over every node of the flagship graph."""
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, run_inference)

    trainer = nalp_trainer(g, kind)
    trainer.init_params(0)

    def one_pass():
        run_inference(trainer, N, _Rows(), InferenceConfig(batch_size=BATCH),
                      device=g.dev)
    return one_pass


def build(path, g, count):
    """``path``'s call and what a call is."""
    if path.startswith("full_graph_"):
        return full_graph(g, path[len("full_graph_"):]), "pass"
    if path.startswith("full_batch_"):
        return full_batch(g, path[len("full_batch_"):], coo=False), "step"
    if path.startswith("coo_"):
        return full_batch(g, path[len("coo_"):], coo=True), "step"
    if path == "nalp_step":
        return nalp_step(g, count), "step"
    if path == "sampled_inference":
        return sampled_inference(g), "pass"
    if path == "quantized_inference":
        return sampled_inference(g, "int8"), "pass"
    if path == "weighted_live_step":
        return nalp_step(g, count, "weighted"), "step"
    return partitioned_ring(g, count), "step"


def parse_kernel(text):
    name, sep, subs = text.partition("=")
    if not sep or not name or not subs:
        raise argparse.ArgumentTypeError(
            f"--kernel takes NAME=SUBSTRING[,SUBSTRING...], got {text!r}")
    return name, tuple(s for s in subs.split(",") if s)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--paths", nargs="+", default=list(PATHS),
                        choices=PATHS)
    parser.add_argument("--kernel", type=parse_kernel, action="append",
                        default=[], metavar="NAME=SUB[,SUB...]")
    parser.add_argument("--count", type=int, default=5,
                        help="profiled passes or steps a path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("in_path_profile: no CUDA device")
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    kernels = dict(args.kernel)
    g = Flagship(dev)
    for path in args.paths:
        fn, per = build(path, g, args.count)
        print(json.dumps({"phase": "in_path", "path": path, "per": per,
                          "count": args.count,
                          **profiled(fn, args.count, kernels)}), flush=True)
        del fn
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
