#!/usr/bin/env python3
"""Time K7 fanout_attention and K7b fanout_attention_bwd at several depths of
loads ahead (``kDepth`` in csrc/gigl_attention.cuh) on one NVIDIA GPU.

    python3 scripts/attention_depth_sweep.py [--depths 1 2 4]
        [--min-blocks 0 5]

Builds a copy of the attention sources per depth (``kDepth`` replaced, the
same nvcc flags as the port's build, one nvcc per source, all started
together) into ``build/depth_sweep/``; ``--min-blocks B`` (B > 0) also
builds each depth with the warp kernels' ``__launch_bounds__(kThreads,
B)``, a cap on their registers for B resident blocks an SM. Times each copy through the
port's wrappers on the flagship graph's largest ELL bucket (N=100k, E=2M
uniform random edges, numpy seed 0, as chip_smoke.py): K7 GAT bf16 Dh 64,
fp32 Dh 64 and Dh 4; K7b GAT fp32 Dh 64 and Dh 4, Transformer Dh 64.
Device ms per call from CUDA-graph replay, the depths in turns (each depth
timed twice, in the order given and then reversed) in one process on one
card. Prints one JSON line per (depth, case, turn), then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from _kernel_sweep import card, cuda_ms, finish_variant, load, start_variant

REPO = Path(__file__).resolve().parent.parent
N, E, HEADS = 100_000, 2_000_000, 4


def start_depth(depth, min_blocks, _build):
    """Start compiling the attention sources (fanout_attention*.cu) with
    kDepth = depth in gigl_attention.cuh (and, for min_blocks > 0, the warp
    kernels' launch bounds)."""
    edits = {"gigl_attention.cuh": [(r"constexpr int kDepth = \d+;",
                                     f"constexpr int kDepth = {depth};")]}
    if min_blocks > 0:
        for name in ("fanout_attention_warp.cuh",
                     "fanout_attention_bwd_warp.cuh"):
            edits[name] = [(r"__launch_bounds__\(kThreads\)",
                            f"__launch_bounds__(kThreads, {min_blocks})")]
    return start_variant(
        REPO / "build" / "depth_sweep" / f"d{depth}_b{min_blocks}",
        _build.CSRC, ["fanout_attention*.cu"], edits, _build)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--depths", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--min-blocks", type=int, nargs="+", default=[0])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attention_depth_sweep: no CUDA device")
    sys.path.insert(0, str(REPO))
    from gigl_tpu_torch.graph.csr import build_csr
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.attention import (
        _fanout_attention_fwd, fanout_attention_bwd)
    from gigl_tpu_torch.ops.ell import EllGraph

    dev = torch.device("cuda", 0)
    variants = [(d, b) for d in args.depths for b in args.min_blocks]
    started = {v: start_depth(*v, _build) for v in variants}
    _build.build()           # the port's own library, meanwhile
    signatures = {fn: _build._SIGNATURES[fn] for fn in (
        "gigl_fanout_attention", "gigl_fanout_attention_bwd")}
    libs = {v: load(finish_variant(*started[v], _build), signatures)
            for v in variants}
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    ell = EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N),
                            device=dev)
    sizes = [hi - lo for lo, hi in zip(ell.boundaries, ell.boundaries[1:])]
    big = int(np.argmax(sizes))
    nbr, mask = ell.nbr[big], ell.mask[big]
    n_b = nbr.shape[0]
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = {}
    for label, mode, dtype, hd in (
            ("k7_gat_bf16_dh64", "gat", torch.bfloat16, 256),
            ("k7_gat_fp32_dh64", "gat", torch.float32, 256),
            ("k7_gat_fp32_dh4", "gat", torch.float32, 16),
            ("k7b_gat_fp32_dh64", "gat", torch.float32, 256),
            ("k7b_gat_fp32_dh4", "gat", torch.float32, 16),
            ("k7b_transformer_fp32_dh64", "transformer", torch.float32,
             256)):
        xd, ks, vs, g = (torch.randn(s, generator=gen, device=dev).to(dtype)
                         for s in ((n_b, hd), (N, hd), (N, hd), (n_b, hd)))
        att = att2 = None
        if mode == "gat":
            vs = ks
            att, att2 = (torch.randn(hd, generator=gen, device=dev) * 0.2
                         for _ in range(2))
        stats = torch.empty((n_b, HEADS, 2), device=dev)
        out = _fanout_attention_fwd(xd, ks, vs, nbr, mask, mode, HEADS, att,
                                    att2, 0.2, stats=stats)
        if label.startswith("k7b"):
            cases[label] = (lambda g=g, xd=xd, ks=ks, vs=vs, out=out,
                            stats=stats, mode=mode, att=att, att2=att2:
                            fanout_attention_bwd(g, xd, ks, vs, nbr, mask,
                                                 out, stats, mode, HEADS,
                                                 att, att2, 0.2))
        else:
            cases[label] = (lambda xd=xd, ks=ks, vs=vs, mode=mode, att=att,
                            att2=att2: _fanout_attention_fwd(
                                xd, ks, vs, nbr, mask, mode, HEADS, att,
                                att2, 0.2))
    order = variants + list(reversed(variants))
    for turn, (depth, min_blocks) in enumerate(order):
        _build._lib = libs[(depth, min_blocks)]
        for label, fn in cases.items():
            print(json.dumps({"phase": "depth_sweep", "k_depth": depth,
                              "min_blocks": min_blocks,
                              "turn": turn, "case": label,
                              "bucket": [n_b, int(nbr.shape[1])],
                              "ms": cuda_ms(fn)}), flush=True)
    _build._lib = None
    print(card(), flush=True)


if __name__ == "__main__":
    main()
