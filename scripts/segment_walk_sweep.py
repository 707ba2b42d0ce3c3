#!/usr/bin/env python3
"""Time K10 sddmm on one NVIDIA GPU at several depths of loads ahead of its
walk (``kSegDepth`` in csrc/gigl_segment.cuh) and walk thresholds, and,
given the sources of an earlier version, that version beside them.

    python3 scripts/segment_walk_sweep.py [--depths 1 2 4]
        [--min-blocks 0 12] [--walk-row-bytes 512]
        [--head-dims 64 32 4] [--first DIR]

Builds a copy of sddmm.cu per depth and walk threshold (``kSegDepth`` and
``kWalkRowBytes`` replaced; ``--min-blocks B`` (B > 0) also builds each
with the walk kernel's ``__launch_bounds__(kThreads, B)``, a cap on its
registers for B resident blocks an SM; the port's nvcc flags) into
``build/segment_sweep/``. ``--first DIR`` also builds the sddmm.cu found
in DIR (a csrc directory of an earlier checkout, whose gigl_sddmm walks
no index: it takes src, dst, scale, out, E, C, heads, dtype and a 16-byte
flag) as the variant ``first``. Times each variant through the port's
wrapper (the earlier K10 through its own C signature) on the flagship
graph (N=100k, E=2M uniform random edges in their random order, numpy
seed 0, as chip_smoke.py), destination-sorted by a SegmentIndex, at 4
heads of each head dim given (fp32, scaled by 1 / sqrt(dk)); at 64 and 4
also over the same edges sorted by destination (``_sorted``: the
per-edge reads and writes in order) and over 2,000 destinations of 1,000
edges each (``_hub1000``, the same sources). Each output is held against
the plain twin first (fp32, 1e-5 of its scale). Device ms per call from
CUDA-graph replay, the variants in turns (each timed twice, in the order
given and then reversed) in one process on one card. Prints one JSON
line per (variant, case, turn), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from _kernel_sweep import card, cuda_ms, finish_variant, load, start_variant

REPO = Path(__file__).resolve().parent.parent
N, E, HEADS = 100_000, 2_000_000, 4
# the earlier gigl_sddmm: q, k, src, dst, scale, out, E, C, heads, dtype,
# vec, stream
FIRST_SDDMM = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def start_walk(name, csrc, depth, min_blocks, walk_bytes, _build):
    """Start compiling ``csrc``'s sddmm.cu (kSegDepth = depth in
    gigl_segment.cuh and kWalkRowBytes = walk_bytes in sddmm.cu, when
    given; for min_blocks > 0, the walk's launch bounds)."""
    edits = {}
    if depth is not None:
        edits["gigl_segment.cuh"] = [(r"constexpr int kSegDepth = \d+;",
                                      f"constexpr int kSegDepth = {depth};")]
        edits["sddmm.cu"] = [(r"constexpr int kWalkRowBytes = \d+;",
                              f"constexpr int kWalkRowBytes = {walk_bytes};")]
    if min_blocks:
        edits.setdefault("sddmm.cu", []).append((
            r"__launch_bounds__\(kThreads\) sddmm_walk",
            f"__launch_bounds__(kThreads, {min_blocks}) sddmm_walk"))
    return start_variant(REPO / "build" / "segment_sweep" / name, csrc,
                         ["sddmm.cu"], edits, _build)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--depths", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--min-blocks", type=int, nargs="+", default=[0])
    parser.add_argument("--walk-row-bytes", type=int, nargs="+",
                        default=[512])
    parser.add_argument("--head-dims", type=int, nargs="+",
                        default=[64, 32, 4])
    parser.add_argument("--first", type=Path, default=None,
                        help="csrc directory of an earlier version")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("segment_walk_sweep: no CUDA device")
    sys.path.insert(0, str(REPO))
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.segment import SegmentIndex, _sddmm_plain, sddmm

    dev = torch.device("cuda", 0)
    variants = {f"k_seg_depth_{d}_b{b}_walk{r}": (_build.CSRC, d, b, r)
                for d in args.depths for b in args.min_blocks
                for r in args.walk_row_bytes}
    if args.first is not None:
        variants["first"] = (args.first, None, 0, None)
    started = {v: start_walk(v, *c, _build) for v, c in variants.items()}
    _build.build()           # the port's own library, meanwhile
    libs = {v: load(finish_variant(*started[v], _build), {
        "gigl_sddmm": FIRST_SDDMM if v == "first"
        else _build._SIGNATURES["gigl_sddmm"]}) for v in variants}
    rng = np.random.default_rng(0)
    src_np, dst_np = rng.integers(0, N, E), rng.integers(0, N, E)
    # the same edges sorted by destination (each per-edge array read and
    # written in order), and 2,000 hub destinations of 1,000 edges each
    # (the other destinations empty)
    by_dst = np.argsort(dst_np, kind="stable")
    hub_np = rng.permutation(np.repeat(np.arange(2000), E // 2000))
    graphs = {}
    for name, (s_np, d_np) in (("", (src_np, dst_np)),
                               ("_sorted", (src_np[by_dst], dst_np[by_dst])),
                               ("_hub1000", (src_np, hub_np))):
        s_t, d_t = (torch.as_tensor(a.astype(np.int32), device=dev)
                    for a in (s_np, d_np))
        graphs[name] = (s_t, d_t, SegmentIndex.from_ids(d_t, N))
    gen = torch.Generator(device=dev).manual_seed(14)
    state = {"first": False}

    def k10(g, q, k, scale):
        src, dst, index = g
        if not state["first"]:
            return sddmm(src, dst, q, k, scale=scale, index=index)
        out = torch.empty((E, HEADS), dtype=q.dtype, device=dev)
        _build.launch("sddmm", "gigl_sddmm", dev, q.data_ptr(), k.data_ptr(),
                      src.data_ptr(), dst.data_ptr(), scale.data_ptr(),
                      out.data_ptr(), E, q.shape[1] * q.shape[2], HEADS, 0, 1)
        return out

    cases = {}
    for dk in args.head_dims:
        q, k = (torch.randn((N, HEADS, dk), generator=gen, device=dev)
                for _ in range(2))
        scale = torch.full((HEADS,), dk ** -0.5, device=dev)
        for name, g in graphs.items():
            if name and dk not in (64, 4):
                continue
            cases[f"k10_dh{dk}{name}"] = (
                lambda g=g, q=q, k=k, scale=scale: k10(g, q, k, scale),
                lambda g=g, q=q, k=k, scale=scale: _sddmm_plain(
                    g[0], g[1], q, k, scale))
    order = list(variants) + list(reversed(variants))
    for turn, name in enumerate(order):
        _build._lib = libs[name]
        state["first"] = name == "first"
        for label, (fn, plain) in cases.items():
            got, want = fn(), plain()
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max())
            if not err <= 1e-5:
                raise RuntimeError(f"{name} {label}: {err} from the twin")
            print(json.dumps({"phase": "segment_sweep", "variant": name,
                              "turn": turn, "case": label, "edges": E,
                              "err": err, "ms": cuda_ms(fn)}), flush=True)
    _build._lib = None
    print(card(), flush=True)


if __name__ == "__main__":
    main()
