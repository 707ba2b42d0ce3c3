#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on one NVIDIA GPU: copies of
their sources with constants replaced, and the sources of an earlier
checkout, each built as the port builds them and timed in turns.

    python3 scripts/kernel_sweep.py SWEEP [--set KNOB=V1,V2 ...]
        [--min-blocks B ...] [--first DIR] [--repeats R]

``SWEEP`` is an entry of ``SWEEPS`` below, which names its sources, its
knobs (a constant of the sources: the file and the pattern that sets it),
the kernels that ``--min-blocks`` caps, its cases and, where it has one,
the C signature of its earlier version:

- ``attention``: K7 fanout_attention and K7b fanout_attention_bwd at the
  flagship graph's largest ELL bucket: K7 GAT bf16 Dh 64, fp32 Dh 64 and
  Dh 4; K7b GAT fp32 Dh 64 and Dh 4, Transformer Dh 64. Knob ``depth``
  (kDepth, the loads ahead, csrc/gigl_attention.cuh).
- ``walk``: K10 sddmm at 4 heads of 64, 32 and 4 (fp32, scaled by
  1 / sqrt(dk)) over the flagship graph's destination index; at 64 and 4
  also over the same edges sorted by destination (``_sorted``) and over
  2,000 destinations of 1,000 edges each (``_hub1000``). Knobs
  ``seg_depth`` (kSegDepth, csrc/gigl_segment.cuh) and ``walk_row_bytes``
  (kWalkRowBytes, csrc/sddmm.cu). ``first``: an sddmm that walks no index.
- ``gather``: K8 segment_reduce at the COO Transformer's two layers (v
  [N, 4, 64] and [N, 4, 4] fp32, weighted per head by an [E, 4] alpha, and
  unweighted) and at a typed relation's shape (1.4M edges from 150k
  sources, [150k, 4 x 32], weighted), in its composed mode (src the
  tensor the index was built from) and its chained mode (a copy); K6b
  ell_transpose_aggregate over the whole transpose walk of the graph's
  ELL tables at [N, 256] fp32 in every mode (max: its walk alone, the
  tie counts given) and gine at [N, 128] with and without [E, 128] edge
  rows. Knobs: ``slots`` (kSlotsInFlight in both sources: K8's composed
  mode, K6b's sum, gcn, gatv2 and gine), ``k8_chained_slots``,
  ``k6b_mean_weighted_slots`` and ``k6b_max_slots`` (the slots in flight
  of the other modes). ``first``: a K8
  without composed rows and a K6b that reads the mask, the entry and
  ``ent_row``; every output is held bit for bit against its output.
- ``k8b``: K8b segment_reduce_bwd over the flagship graph's source walk at
  [N, 256] fp32 cotangents, mean, sum and weighted per head by an [E, 4]
  alpha, and the COO Transformer's layer 2 ([N, 4 x 4], weighted), over
  the graph and over 2,000 destinations of 1,000 edges each
  (``_hub1000``), in its composed mode (the segment ids the source index
  was built from) and its chained mode (a copy); the mean also as
  ``sparse.mm`` of the source-sorted CSR (``library``) and as each
  cotangent row divided by its count beforehand, then the sum walk
  (``prescaled``, the division's time included). Knob ``slots``
  (kSlotsInFlight, the composed mode's slots in flight). ``first``: the
  K8b that reads order, then dst, then the row;
  every output is held bit for bit against its output.
- ``softmax``: K9 segment_softmax over the flagship graph's destination
  index at [2M, 4] fp32 and bf16 and at 1 and 16 heads, the typed
  relation's shape (1.4M edges into 100k destinations, 4 heads) and
  ``_hub1000``, through the wrapper (``kept``) and with its evict-first
  reads forced on and off (``stream``, ``cache``). Knobs ``group_lanes``
  (kGroupLanes, the lanes a segment for up to 4 heads: 8, 16 or 32) and
  ``slots_per_lane`` (kSlotsPerLane), in csrc/gigl_softmax.cuh. ``first``: the K9 that walks a
  segment three times a head; every output is held bit for bit against
  its output.
- ``softmax_bwd``: K9b segment_softmax_bwd at K9's cases (alpha the
  softmax of random logits, g random), through the wrapper (``kept``) and
  with its evict-first reads forced on and off (``stream``, ``cache``).
  Knobs ``group_lanes`` and ``slots_per_lane`` (csrc/gigl_softmax.cuh, the
  walk K9 and K9b share). ``first``: the K9b that walks a segment twice
  with a warp, a value at a time; every output is held bit for bit
  against its output.
- ``ell``: K6 ell_aggregate over the flagship graph's ELL tables, one
  launch over every bucket: the two layers' widths (D 128 and 256) in
  bf16 and fp32, mean, sum, max and gcn, and gine at D 128 with and
  without [E, 128] edge rows; and the largest bucket's rows alone (bf16
  D 256 mean). Modes ``kept`` (CUDA-graph replay), ``kept_eager`` and
  ``window_eager`` (eager calls between CUDA events, the latter with a
  persisting L2 access-policy window over x, the set-aside the most the
  card grants). Knob ``slots`` (kSlotsInFlight).
  ``first``: the K6 that launched once a bucket and walked every slot's
  mask byte, id and row; every output is held bit for bit against its
  output.
- ``ring``: K17 ring_retrieval's fold and backward at a shard's
  [P, 128, 256] fp32 scores (the flagship ring step's), P 1 and 4, with
  every mask on and a logQ term. Knob ``warps`` (kRingWarps, the rows a
  block of the fold). ``first``: the K17 that took one block a launch,
  launched once a block; every output is held bit for bit against its
  output (the fold's [3, Ql] state, reset before and copied out after the
  fold in every variant).
- ``masked``: K4 masked_reduce at the flagship NALP step's layer 2
  ([512, 15, 256] bf16 and fp32: mean, sum and max) and at layer 1's
  shape where no cache serves it (the NC and typed steps: [8192, 10, 128]
  fp32 and bf16, mean), each row's valid slots those of a uniform draw
  over the flagship's degrees (Poisson(20): a row of degree d < K has its
  first d slots). Knobs ``rows`` (kBlockRows, a block's rows of 32
  pieces) and ``chunk`` (kSlotChunk, the slot rows in flight a thread;
  a grid larger than the card holds at once in that form takes the first
  version's slot walk).
  ``first``: the K4 that loaded a slot's mask byte, then its row, one
  slot at a time; every output is held bit for bit against its output.
- ``masked_bwd``: K4b masked_reduce_bwd at the flagship NALP step's layer
  2 ([512, 15, 256] bf16 and fp32: mean, sum and max, x on a coarse grid
  so that the max has ties) and at [8192, 10, 128] fp32 and bf16 (mean;
  bf16 max),
  the masks those of ``masked``; the sum also as ``torch.where(mask,
  g, 0)`` (``library``), the one PyTorch call that computes it. Knobs
  ``rows`` (kBwdBlockRows, a small block's rows of 32 pieces), ``chunk``
  (kSlotChunk, the x rows a thread holds for max; K4's too); past what the
  card holds at once in small blocks, every mode takes the first version's
  slot walk. ``first``: the K4b that read a
  mask byte before each slot's store in blocks of 256; every output is
  held bit for bit against its output.
- ``cache``: K2 build_neighbor_cache over the flagship graph's CSR (every
  node, fanout 10, hop 2, seed 0): fp32 D 128 mean, sum and gcn, int8 D
  128 mean, the weighted and top-k draws (fp32 D 128 mean, uniform random
  edge weights), fp32 D 256 (two column chunks of a warp) and fanout 40
  (two draws of 32 slots, the partial sum between them kept in the
  output row).
  Also int8 D 128 with the weighted draw (the warp form over 4-byte
  pieces). Knobs ``chunk`` (kSlotChunk, the group form's rows in flight a
  lane), ``warp_unroll`` (kWarpUnroll, the warp form's slot loop
  unrolled), ``warp_min_blocks`` and ``weighted_min_blocks``
  (kWarpMinBlocks, kWeightedMinBlocks: the warp form's launch bound under
  the uniform and the weighted draw) and ``threads`` (kCacheThreads, a
  block).
  ``first``: the K2 that drew a warp's slots anew for every 32 pieces of
  a row and added one slot's row at a time, int8 in 4-byte pieces; every
  output is held bit for bit against its output.
- ``retrieval``: K5 retrieval_loss's forward and backward at the flagship
  step's [512, 1024] bf16 scores (query ids, accidental hits, query and
  candidate masks, T 0.07) without and with the logQ term, fp32 at the
  same shape (the typed steps'), and bf16 with logQ at the per-shard
  pool's [128, 640]. Knobs ``row_threads`` (kRowThreads, the forward's
  threads a query row), ``rows`` (kBlockRows, its rows a block),
  ``lane_values`` (kLaneValues, the logits a thread holds) and
  ``bwd_threads`` (kBwdThreads, the backward's block).
  ``first``: the K5 that took a block a row and summed in a second
  launch. The backward (given the same lse) is held bit for bit against
  its output; the forward sums in another order, so its largest
  difference from ``first`` is printed (``first_rel_diff``).
- ``route``: K15 route_requests at the partitioned step's largest routed
  lookup (4 request vectors of 63,744 ids over N = 100k nodes in 4 shards
  of 25,000 rows, capacity 31,872), all four in one call (``batched_s4``)
  and one vector (``single``). Knob ``tile`` (kRouteTile, the ids a
  block). ``first``: the K15
  that ran one block a vector, called once a vector; every output is held
  bit for bit against its output.
- ``q8``: K12 gather_rows_q8 over the flagship graph's int8 tables (the
  features with their degrees, and the int8 neighbor cache, fp32 out) at a
  quantized inference batch's four gathers (roots 0-511 and their 7,680
  first-hop rows from the tabularized tree, from each table), at a NALP
  encode chain's four (512 random anchors), that chain's 7,680 first-hop
  feature rows alone, at a live (15, 10) tree's three feature levels, and
  over the whole feature table; and mixed
  (fp32 D 128, bf16 D 130, bf16 D 12 with degrees). Modes ``kept`` (one
  segmented launch), ``per_segment`` (a launch a gather, the kept
  kernel). No knob. Every mode writes the gathers'
  outputs into one preallocated buffer (the wrapper's layout). ``first``:
  the K12 that took one gather a launch, launched once a gather; every
  output is held bit for bit against its output.
- ``weighted``: K19 sample_weighted over chip_smoke.py's weighted graph
  (column 0 of an [E, 8] uniform edge table, numpy seed 16, each CSR row
  sorted by descending weight): every node at fanout 15 (weighted, top_k),
  the live step's two hops (1,536 nodes at fanout 15; their 23,040 drawn
  ids at fanout 10, hop 2), a 1,000 x 1,000 hub CSR (integer weights
  0-3; weighted, top_k), the row-offset mode (shard 1 of 4's rows asked
  for the hop-2 ids it owns), and every node at windows 32 and 1024.
  No knob (``--min-blocks`` caps its registers). Every mode writes into a
  preallocated buffer. ``first``: the K19 whose rounds were a 64-bit warp
  arg-max over every key register; every output is held bit for bit
  against its output.

- ``k10b``: K10b sddmm_bwd at the COO Transformer step's [2M, 4]: the
  coefficients alone (the step's mode) with fp32 and bf16 g, at 16 heads,
  and with g a view 4 bytes off a 16-byte boundary (the one-value form);
  with the scale's cotangent (fp32, bf16; [8M, 1] fp32). Mode
  ``library``: ``torch.mul(g, scale)`` for the coefficients. Knobs
  ``pieces`` (kPiecesInFlight, a thread's pieces loaded at once) and
  ``threads`` (kThreads, a block). ``first``: the K10b that took a thread
  an edge and summed the scale's cotangent in a second launch after a
  fill; the coefficients are held bit for bit against its output; the cotangent
  (another order) within 1e-6 of sum |g raw| of an fp64 sum.
- ``cms``: K14 cms_estimate (the probabilities) alone and behind K13
  cms_add (``pair_``: one CUDA graph replays both) at the flagship's 1,024
  candidate ids over a 5 x 2048 sketch and 65,536 ids over 5 x 16384,
  each sketch after 20 batches of counts. Knobs ``threads`` (kEstThreads,
  K14's block) and ``unrolled`` (kMaxUnrolled: the depths K14 unrolls by
  template; 0 takes the loop for every depth). ``first``: the K14
  launched without a dependent launch, a thread an id walking the rows;
  every output is held bit for bit
  against its output.
- ``k1b``: K1b uniform_ids alone at the NALP step's 512 ids over N =
  100k and at 65,536 ids; K1 sample_uniform alone at the step's
  positives (512 anchors, 1 positive, hop 1,000,003, over the flagship's
  supervision CSR) and at the table draw (every node, fanout 15); K1b's
  host cost (``k1b_512_host``: eager calls of the C entry made alike for
  kept and first, ``kept_eager`` / ``first_eager``, and through the
  wrapper, ``wrapper_eager``); the pair (``pair_``: K1's positives then
  K1b, one CUDA graph replays both, as the step runs them); and the
  launch floor: an empty kernel of the sweep's own source, one block of
  128 threads, as a plain launch (``plain_launch``) and as a dependent
  launch that only waits (``dependent_launch``). Knobs ``ids``
  (kIdsPerThread, K1b's ids a thread) and ``trigger`` (0 takes K1's
  ``griddepcontrol.launch_dependents`` out, 2 leaves it to thread 0 of a
  block). ``first``: the K1b launched without a dependent launch, a
  thread an id, and the K1 without the trigger; every output is held
  bit for bit against its output.

The flagship graph is chip_smoke.py's: N=100k nodes, E=2M uniform random
edges in their random order, numpy seed 0. Variants: ``kept`` (the port's
own library), one per combination of the knob values given and launch
bound (``--min-blocks B``: ``__launch_bounds__(threads, B)``, a cap on the
registers for B resident blocks an SM), and ``first`` (``--first DIR``, a
csrc directory of an earlier checkout: ``git archive <commit>
gigl_tpu_torch/csrc | tar -x -C build/first``), built with the port's
nvcc flags under build/sweep/SWEEP/. Prints one JSON line per kernel form
of each variant's sources with its registers a thread, spill bytes and
static shared memory (the ptxas report, ``-Xptxas -v``); holds every
case's output against its plain twin (1e-5 of its scale, where the case
has one), against ``first``'s where the sweep asks (bit for bit; a case
may say otherwise), and against a repeat run; then prints one JSON line
per (variant, case, mode, turn) with the device ms of one call from
CUDA-graph replay and the case's largest difference from ``first``'s
output over its scale (``first_rel_diff``), the variants in turns (the
order given, then reversed, ``--repeats`` times) in one process on one
card. Last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
N, E, HEADS = 100_000, 2_000_000, 4
TYPED_SRC, TYPED_E = 150_000, 1_400_000   # the gather sweep's typed relation
_P, _I64, _I32, _U32, _F32 = (ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_uint32, ctypes.c_float)
K6B_OPS = {"mean": 0, "sum": 1, "max": 2, "gcn": 3, "weighted": 4,
           "gatv2": 5, "gine": 6}


# -- variants: edited copies of the sources, built as the port builds --------
def edit_sources(out: Path, csrc: Path, edits) -> None:
    """Copy ``csrc`` to ``out`` (replacing it) and apply ``edits`` ({file
    name: [(pattern, replacement), ...]}, each pattern matching once)."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    for name, subs in edits.items():
        path = out / name
        text = path.read_text()
        for pattern, repl in subs:
            text, count = re.subn(pattern, repl, text)
            if count != 1:
                raise RuntimeError(f"{name}: {pattern} matched {count} times")
        path.write_text(text)


def start_build(out: Path, sources, _build):
    """One nvcc per source of ``out`` matching the globs ``sources``, all
    started together, with the port's compile flags."""
    procs = []
    for src in sorted({p for g in sources for p in out.glob(g)}):
        obj = src.with_suffix(".o")
        procs.append((obj, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, "-I", str(out), "-o",
             str(obj), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return out, procs


def finish_build(out: Path, procs, _build) -> Path:
    """Wait for the compiles, write their output to ``out/build.log`` (as
    the port's build writes its own) and link the library; its path."""
    logs = []
    for obj, proc in procs:
        log, _ = proc.communicate()
        logs.append(f"== {obj.stem}.cu (rc {proc.returncode})\n{log}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{log}")
    (out / "build.log").write_text("\n".join(logs))
    lib = out / "libsweep.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                    str(lib), *[str(o) for o, _ in procs]], check=True)
    return lib


def load(path: Path, signatures) -> ctypes.CDLL:
    """The library at ``path`` with ``signatures`` ({C entry: argtypes})
    declared, each returning an int."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        f = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def registers(log: Path, sources):
    """The ptxas report in a build log, for the sources matching the globs
    ``sources``: per kernel form its source, name and template arguments
    (demangled by c++filt where the toolchain has it), registers a thread,
    spill stores and loads and static shared memory (bytes)."""
    rows, source, cur = [], None, None
    for line in log.read_text().splitlines():
        if line.startswith("== "):
            source = line.split()[1]
        elif m := _ENTRY.search(line):
            cur = {"source": source, "kernel": m.group(1)}
            rows.append(cur)
        elif cur is not None:
            if m := _USED.search(line):
                cur["registers"] = int(m.group(1))
                if s := _SMEM.search(line):
                    cur["smem_bytes"] = int(s.group(1))
            elif m := _SPILL.search(line):
                cur["spill_store_bytes"] = int(m.group(1))
                cur["spill_load_bytes"] = int(m.group(2))
    rows = [r for r in rows if any(Path(r["source"]).match(g)
                                   for g in sources)]
    tool = shutil.which("c++filt")
    names = [r["kernel"] for r in rows]
    if tool is not None and names:
        out = subprocess.run([tool], input="\n".join(names),
                             capture_output=True, text=True).stdout
        if len(out.splitlines()) == len(names):
            names = out.splitlines()
    for row, name in zip(rows, names):
        # the kernel and its template arguments, without its parameters
        # (a template's demangled name starts with its return type)
        row["kernel"] = name.replace("void ", "", 1).replace(
            "(anonymous namespace)::", "").split("(", 1)[0]
    return rows


def eager_ms(fn, reps=20) -> float:
    """Device ms of one call: reps eager calls between two CUDA events,
    after two warm calls (for modes that a CUDA graph would not capture as
    they run, such as a stream attribute set around the launch)."""
    for _ in range(2):
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


def cuda_ms(fn, reps=20) -> float:
    """Device ms of one call: reps calls in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
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


# -- the cases: {label: ({mode: fn}, plain twin or None[, tolerance[,
# bit-equal to first]])} ---------------------------------------------------
# Each case builder takes the device, the port's _build module and
# ``first(entry, *args)``, which launches the earlier version's C entry on
# the current stream (None without --first); a mode named ``first`` (or
# ``first_eager``) runs only in the turns of the variant ``first``, the
# others in every other's.
# The tolerance against the twin is 1e-5 of its scale unless the case gives
# another; a case is held bit for bit against first's output as its sweep's
# ``bit_equal_first`` says unless it says itself.
def flagship():
    rng = np.random.default_rng(0)
    return rng, rng.integers(0, N, E), rng.integers(0, N, E)


def attention_cases(dev, _build, first):
    from gigl_tpu_torch.graph.csr import build_csr
    from gigl_tpu_torch.ops.attention import (
        _fanout_attention_fwd, fanout_attention_bwd)
    from gigl_tpu_torch.ops.ell import EllGraph

    _, src, dst = flagship()
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
            fn = (lambda g=g, xd=xd, ks=ks, vs=vs, out=out, stats=stats,
                  mode=mode, att=att, att2=att2: fanout_attention_bwd(
                      g, xd, ks, vs, nbr, mask, out, stats, mode, HEADS, att,
                      att2, 0.2))
        else:
            fn = (lambda xd=xd, ks=ks, vs=vs, mode=mode, att=att,
                  att2=att2: _fanout_attention_fwd(
                      xd, ks, vs, nbr, mask, mode, HEADS, att, att2, 0.2))
        cases[label] = ({"kept": fn}, None)
    return cases


def walk_cases(dev, _build, first):
    from gigl_tpu_torch.ops.segment import SegmentIndex, _sddmm_plain, sddmm

    rng, src_np, dst_np = flagship()
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

    def k10_first(g, q, k, scale):
        src, dst, _ = g
        out = torch.empty((E, HEADS), dtype=q.dtype, device=dev)
        first("gigl_sddmm", q.data_ptr(), k.data_ptr(), src.data_ptr(),
              dst.data_ptr(), scale.data_ptr(), out.data_ptr(), E,
              q.shape[1] * q.shape[2], HEADS, 0, 1)
        return out

    cases = {}
    for dk in (64, 32, 4):
        q, k = (torch.randn((N, HEADS, dk), generator=gen, device=dev)
                for _ in range(2))
        scale = torch.full((HEADS,), dk ** -0.5, device=dev)
        for name, g in graphs.items():
            if name and dk not in (64, 4):
                continue
            fns = {"kept": lambda g=g, q=q, k=k, scale=scale: sddmm(
                g[0], g[1], q, k, scale=scale, index=g[2])}
            if first is not None:
                fns["first"] = (lambda g=g, q=q, k=k, scale=scale:
                                k10_first(g, q, k, scale))
            cases[f"k10_dh{dk}{name}"] = (
                fns, lambda g=g, q=q, k=k, scale=scale: _sddmm_plain(
                    g[0], g[1], q, k, scale))
    return cases


def gather_cases(dev, _build, first):
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.ops.ell import EllGraph
    from gigl_tpu_torch.ops.ell_aggregate import (
        _ell_transpose_plain, _tie_count_plain, ell_aggregate_graph,
        ell_transpose_aggregate)
    from gigl_tpu_torch.ops.segment import (
        SegmentIndex, _segment_reduce_plain, segment_reduce)

    rng, src_np, dst_np = flagship()
    gen = torch.Generator(device=dev).manual_seed(15)
    cases = {}

    def k8_case(label, src, dst, n_dst, x, w):
        index = SegmentIndex.from_ids(dst, n_dst, gather=src)
        src_copy = src.clone()
        c = x.shape[1] * x.shape[2]
        w_cols = 1 if w is None else w.shape[1]

        def run_first():
            out = torch.empty((n_dst, c), device=dev)
            first("gigl_segment_reduce", x.data_ptr(), src.data_ptr(),
                  index.order.data_ptr(), index.ptr.data_ptr(),
                  _build.ptr(w), out.data_ptr(), n_dst, c, c // w_cols,
                  w_cols, 0, 0, 1)
            return out.reshape((n_dst,) + tuple(x.shape[1:]))

        fns = {"composed": lambda: segment_reduce(
                   x, dst, n_dst, src=src, weight=w, index=index),
               "chained": lambda: segment_reduce(
                   x, dst, n_dst, src=src_copy, weight=w, index=index)}
        if first is not None:
            fns["first"] = run_first
        cases[label] = (fns, lambda: _segment_reduce_plain(
            x, dst, n_dst, "sum", src, w))

    src_t, dst_t = (torch.as_tensor(a.astype(np.int32), device=dev)
                    for a in (src_np, dst_np))
    alpha = torch.rand((E, HEADS), generator=gen, device=dev)
    for layer, dk in (("coo_layer1", 64), ("coo_layer2", 4)):
        v = torch.randn((N, HEADS, dk), generator=gen, device=dev)
        k8_case(f"k8_{layer}_weighted", src_t, dst_t, N, v, alpha)
        k8_case(f"k8_{layer}_sum", src_t, dst_t, N, v, None)
    t_src = torch.as_tensor(rng.integers(0, TYPED_SRC, TYPED_E)
                            .astype(np.int32), device=dev)
    t_dst = torch.as_tensor(rng.integers(0, N, TYPED_E).astype(np.int32),
                            device=dev)
    msg = torch.randn((TYPED_SRC, HEADS, 32), generator=gen, device=dev)
    k8_case("k8_typed_weighted", t_src, t_dst, N, msg,
            torch.rand((TYPED_E, HEADS), generator=gen, device=dev))

    graph = HeteroGraph.homogeneous(src=src_np, dst=dst_np, num_nodes=N)
    et = graph.metadata.edge_types[0]
    ell = EllGraph.from_csr(graph.csr(et, anchor="dst"), device=dev)
    p_total = ell.ent_row.shape[0]

    def walk(rows, op, cnt, wt=None, wt2=None, vec=None, rows2=None,
             table=None, ea=None):
        """K6b's walk alone over the current library (max: over the tie
        counts given; the wrapper also runs the tie-count pass)."""
        out = torch.empty_like(rows)
        by_entry = op in ("weighted", "gatv2") or ea is not None
        for tb, tw in enumerate(ell.t_widths):
            lo, hi = ell.t_boundaries[tb], ell.t_boundaries[tb + 1]
            if hi == lo:
                continue
            _build.launch(
                "ell_transpose_aggregate", "gigl_ell_transpose_aggregate",
                dev, rows.data_ptr(),
                _build.ptr(ell.t_nbr[tb] if by_entry else None),
                ell.t_row[tb].data_ptr(), ell.t_perm[lo:hi].data_ptr(),
                ell.deg_p.data_ptr(), *map(_build.ptr, (
                    wt, wt2, vec, rows2, table, cnt, ea,
                    None if ea is None else ell.ent_edge)),
                out.data_ptr(), hi - lo, tw, rows.shape[1], HEADS,
                rows.shape[1] // HEADS, 0, K6B_OPS[op], 1, 0.2)
        return out

    def k6b_case(label, rows, op, **kw):
        cnt = (_tie_count_plain(kw["table"], ell, kw["rows2"])
               if op == "max" else None)

        def run_first():
            out = torch.empty_like(rows)
            ea = kw.get("ea")
            for tb, tw in enumerate(ell.t_widths):
                lo, hi = ell.t_boundaries[tb], ell.t_boundaries[tb + 1]
                if hi == lo:
                    continue
                first("gigl_ell_transpose_aggregate", rows.data_ptr(),
                      ell.t_nbr[tb].data_ptr(), ell.t_mask[tb].data_ptr(),
                      ell.t_perm[lo:hi].data_ptr(), ell.ent_row.data_ptr(),
                      ell.deg_p.data_ptr(), *map(_build.ptr, (
                          kw.get("wt"), kw.get("wt2"), kw.get("vec"),
                          kw.get("rows2"), kw.get("table"), cnt, ea,
                          None if ea is None else ell.ent_edge)),
                      out.data_ptr(), hi - lo, tw, rows.shape[1], HEADS,
                      rows.shape[1] // HEADS, 0, K6B_OPS[op], 1, 0.2)
            return out

        fns = {"kept": (lambda: walk(rows, op, cnt, **kw)) if op == "max"
               else (lambda: ell_transpose_aggregate(rows, ell, op,
                                                     heads=HEADS, **kw))}
        if first is not None:
            fns["first"] = run_first
        cases[label] = (fns, lambda: _ell_transpose_plain(
            rows, ell, op, heads=HEADS, **kw))

    g = torch.randn((N, 256), generator=gen, device=dev)
    wt = torch.rand((p_total, HEADS), generator=gen, device=dev) * 0.1
    wt2 = torch.randn((p_total, HEADS), generator=gen, device=dev) * 0.1
    vec = torch.randn(256, generator=gen, device=dev) * 0.2
    q, t = (torch.randn((N, 256), generator=gen, device=dev)
            for _ in range(2))
    xm = (t * 2).round()          # a coarse grid: the max has ties
    for op in ("mean", "sum", "gcn"):
        k6b_case(f"k6b_{op}", g, op)
    k6b_case("k6b_weighted", g, "weighted", wt=wt, wt2=wt2, vec=vec)
    k6b_case("k6b_gatv2", g, "gatv2", wt=wt, wt2=wt2, vec=vec, rows2=q,
             table=t)
    k6b_case("k6b_max", g, "max", rows2=ell_aggregate_graph(xm, ell, "max"),
             table=xm)
    g128, x128 = (torch.randn((N, 128), generator=gen, device=dev)
                  for _ in range(2))
    ea = torch.randn((E, 128), generator=gen, device=dev)
    k6b_case("k6b_gine_edges", g128, "gine", table=x128, ea=ea)
    k6b_case("k6b_gine", g128, "gine", table=x128)
    return cases


def k8b_cases(dev, _build, first):
    from gigl_tpu_torch.ops.segment import (
        SegmentIndex, _segment_reduce_bwd_plain, segment_reduce_bwd)

    rng, src_np, dst_np = flagship()
    hub_np = rng.permutation(np.repeat(np.arange(2000), E // 2000))
    gen = torch.Generator(device=dev).manual_seed(16)
    alpha = torch.rand((E, HEADS), generator=gen, device=dev)
    src = torch.as_tensor(src_np.astype(np.int32), device=dev)
    cases = {}

    def graph_cases(name, d_np):
        dst = torch.as_tensor(d_np.astype(np.int32), device=dev)
        index = SegmentIndex.from_ids(dst, N, gather=src)
        sidx = SegmentIndex.from_ids(src, N, gather=dst)
        dst_copy = dst.clone()
        cnt = index.ptr[1:] - index.ptr[:-1]
        cnt_t = cnt.float().clamp(min=1.0)
        col = sidx.gathered.long()
        csr = torch.sparse_csr_tensor(
            sidx.ptr.long(), col, 1.0 / cnt.float().clamp(min=1.0)[col],
            (N, N))

        def case(label, c, op, w):
            g = torch.randn((N, c), generator=gen, device=dev)
            w_cols = 1 if w is None else w.shape[1]

            def kernel(ids):
                return segment_reduce_bwd(g, ids, N, op=op, src=src,
                                          weight=w, index=index,
                                          src_index=sidx)

            def run_first():
                out = torch.empty((N, c), device=dev)
                first("gigl_segment_reduce_bwd", g.data_ptr(), None, None,
                      None, dst.data_ptr(), sidx.order.data_ptr(),
                      sidx.ptr.data_ptr(),
                      index.ptr.data_ptr() if op == "mean" else None,
                      _build.ptr(w), out.data_ptr(), N, c, c // w_cols,
                      w_cols, 0, {"sum": 0, "mean": 1}[op], 1)
                return out

            fns = {"composed": lambda: kernel(dst),
                   "chained": lambda: kernel(dst_copy)}
            if op == "mean":
                fns["library"] = lambda: torch.sparse.mm(csr, g)
                # each cotangent row divided by its count once, before the
                # walk (a PyTorch division), then the sum walk: the mean's
                # bits without a division a slot
                fns["prescaled"] = lambda: segment_reduce_bwd(
                    g / cnt_t[:, None], dst, N, op="sum", src=src,
                    index=index, src_index=sidx)
            if first is not None:
                fns["first"] = run_first
            cases[f"k8b_{label}{name}"] = (
                fns, lambda: _segment_reduce_bwd_plain(g, dst, N, op, src, w))

        case("mean", 256, "mean", None)
        if not name:
            case("sum", 256, "sum", None)
        case("weighted", 256, "sum", alpha)
        case("layer2_weighted", 16, "sum", alpha)

    graph_cases("", dst_np)
    graph_cases("_hub1000", hub_np)
    return cases


def softmax_cases(dev, _build, first):
    from gigl_tpu_torch.ops import segment as seg

    rng, _, dst_np = flagship()
    hub_np = rng.permutation(np.repeat(np.arange(2000), E // 2000))
    typed_np = rng.integers(0, N, TYPED_E)
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = {}
    for label, d_np, heads, dtype in (
            ("fp32_h4", dst_np, 4, torch.float32),
            ("bf16_h4", dst_np, 4, torch.bfloat16),
            ("fp32_h1", dst_np, 1, torch.float32),
            ("fp32_h16", dst_np, 16, torch.float32),
            ("typed_fp32_h4", typed_np, 4, torch.float32),
            ("hub1000_fp32_h4", hub_np, 4, torch.float32)):
        dst = torch.as_tensor(d_np.astype(np.int32), device=dev)
        index = seg.SegmentIndex.from_ids(dst, N)
        e = dst.shape[0]
        lg = (torch.randn((e, heads), generator=gen, device=dev) * 3).to(
            dtype)
        dcode = 0 if dtype == torch.float32 else 1

        def forced(stream, lg=lg, index=index, heads=heads, dcode=dcode):
            out = torch.empty_like(lg)
            _build.launch("segment_softmax", "gigl_segment_softmax", dev,
                          lg.data_ptr(), index.order.data_ptr(),
                          index.ptr.data_ptr(), out.data_ptr(), N, heads,
                          dcode, 1, stream)
            return out

        def run_first(lg=lg, index=index, heads=heads, dcode=dcode):
            out = torch.empty_like(lg)
            first("gigl_segment_softmax", lg.data_ptr(),
                  index.order.data_ptr(), index.ptr.data_ptr(),
                  out.data_ptr(), N, heads, dcode)
            return out

        fns = {"kept": lambda lg=lg, dst=dst, index=index:
               seg.segment_softmax(lg, dst, N, index=index),
               "stream": lambda forced=forced: forced(1),
               "cache": lambda forced=forced: forced(0)}
        if first is not None:
            fns["first"] = run_first
        cases[f"k9_{label}"] = (
            fns, lambda lg=lg, dst=dst: seg._segment_softmax_plain(lg, dst, N),
            1e-5 if dtype == torch.float32 else 2.0 ** -8)
    return cases


def softmax_bwd_cases(dev, _build, first):
    from gigl_tpu_torch.ops import segment as seg

    rng, _, dst_np = flagship()
    hub_np = rng.permutation(np.repeat(np.arange(2000), E // 2000))
    typed_np = rng.integers(0, N, TYPED_E)
    gen = torch.Generator(device=dev).manual_seed(18)
    cases = {}
    for label, d_np, heads, dtype in (
            ("fp32_h4", dst_np, 4, torch.float32),
            ("bf16_h4", dst_np, 4, torch.bfloat16),
            ("fp32_h1", dst_np, 1, torch.float32),
            ("fp32_h16", dst_np, 16, torch.float32),
            ("typed_fp32_h4", typed_np, 4, torch.float32),
            ("hub1000_fp32_h4", hub_np, 4, torch.float32)):
        dst = torch.as_tensor(d_np.astype(np.int32), device=dev)
        index = seg.SegmentIndex.from_ids(dst, N)
        e = dst.shape[0]
        lg = torch.randn((e, heads), generator=gen, device=dev) * 3
        alpha = seg._segment_softmax_plain(lg, dst, N).to(dtype)
        g = torch.randn((e, heads), generator=gen, device=dev).to(dtype)
        dcode = 0 if dtype == torch.float32 else 1
        del lg

        def forced(stream, a=alpha, g=g, index=index, heads=heads,
                   dcode=dcode):
            out = torch.empty_like(a)
            _build.launch("segment_softmax_bwd", "gigl_segment_softmax_bwd",
                          dev, a.data_ptr(), g.data_ptr(),
                          index.order.data_ptr(), index.ptr.data_ptr(),
                          out.data_ptr(), N, heads, dcode, 1, stream)
            return out

        def run_first(a=alpha, g=g, index=index, heads=heads, dcode=dcode):
            out = torch.empty_like(a)
            first("gigl_segment_softmax_bwd", a.data_ptr(), g.data_ptr(),
                  index.order.data_ptr(), index.ptr.data_ptr(),
                  out.data_ptr(), N, heads, dcode)
            return out

        fns = {"kept": lambda a=alpha, g=g, dst=dst, index=index:
               seg.segment_softmax_bwd(a, g, dst, N, index=index),
               "stream": lambda forced=forced: forced(1),
               "cache": lambda forced=forced: forced(0)}
        if first is not None:
            fns["first"] = run_first
        cases[f"k9b_{label}"] = (
            fns, lambda a=alpha, g=g, dst=dst:
            seg._segment_softmax_bwd_plain(a, g, dst, N),
            1e-5 if dtype == torch.float32 else 2.0 ** -8)
    return cases


def route_cases(dev, _build, first):
    from gigl_tpu_torch.parallel import feature_lookup as fl

    s, g, p, rows = 4, 63_744, 4, N // 4
    cap = fl.request_capacity(g, p)
    rng = np.random.default_rng(19)
    ids = torch.as_tensor(rng.integers(0, N, (s, g)).astype(np.int32),
                          device=dev)

    def flat(out):
        """The four outputs as one int32 vector (the sweep compares one
        tensor)."""
        return torch.cat([t_.reshape(-1).to(torch.int32) for t_ in out])

    def run_first(vectors):
        outs = []
        for v in vectors:
            req = torch.empty((p, cap), dtype=torch.int32, device=dev)
            owner, pos = (torch.empty((g,), dtype=torch.int32, device=dev)
                          for _ in range(2))
            ok = torch.empty((g,), dtype=torch.bool, device=dev)
            first("gigl_route_requests", v.data_ptr(), g, rows, p, cap,
                  req.data_ptr(), owner.data_ptr(), pos.data_ptr(),
                  ok.data_ptr())
            outs.append((req, owner, pos, ok))
        return flat([torch.stack(x) for x in zip(*outs)])

    cases = {}
    for label, vec in (("batched_s4", ids), ("single", ids[0])):
        rows_of = vec.reshape(-1, g)
        fns = {"kept": lambda vec=vec: flat(fl.route_requests(vec, rows, p,
                                                              cap))}
        if first is not None:
            fns["first"] = lambda rows_of=rows_of: run_first(rows_of)
        cases[f"k15_{label}"] = (fns, lambda vec=vec: flat(
            fl._route_requests_plain(vec, rows, p, cap)), 0.0)
    return cases


def masked_cases(dev, _build, first):
    from gigl_tpu_torch.ops.fanout import _masked_reduce_fwd, _masked_reduce_plain

    rng = np.random.default_rng(22)
    gen = torch.Generator(device=dev).manual_seed(22)
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    ops = {"mean": 0, "sum": 1, "max": 2}
    cases = {}

    def case(label, m, k, d, dtype, op):
        x = torch.randn((m, k, d), generator=gen, device=dev).to(dtype)
        mask = poisson_prefix_mask(rng, m, k, dev)

        def run_first():
            out = torch.empty((m, d), dtype=dtype, device=dev)
            first("gigl_masked_reduce", x.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), m, k, d, dtypes[dtype], ops[op])
            return out

        fns = {"kept": lambda: _masked_reduce_fwd(x, mask, op)}
        if first is not None:
            fns["first"] = run_first
        cases[label] = (fns, lambda: _masked_reduce_plain(x, mask, op),
                        1e-5 if dtype == torch.float32 else 2.0 ** -7)

    for op in ("mean", "sum", "max"):
        case(f"k4_bf16_512x15x256_{op}", 512, 15, 256, torch.bfloat16, op)
        case(f"k4_fp32_512x15x256_{op}", 512, 15, 256, torch.float32, op)
    case("k4_fp32_8192x10x128_mean", 8192, 10, 128, torch.float32, "mean")
    case("k4_bf16_8192x10x128_mean", 8192, 10, 128, torch.bfloat16, "mean")
    return cases


def poisson_prefix_mask(rng, m, k, dev):
    """[m, k] masks whose row of degree d has its first min(d, k) slots
    valid, d ~ Poisson(E / N): a uniform draw over the flagship's degrees."""
    deg = rng.poisson(E / N, m)
    return torch.as_tensor(np.arange(k)[None, :] < deg[:, None], device=dev)


def masked_bwd_cases(dev, _build, first):
    from gigl_tpu_torch.ops.fanout import (
        _masked_reduce_bwd_plain, _masked_reduce_fwd, masked_reduce_bwd)

    rng = np.random.default_rng(24)
    gen = torch.Generator(device=dev).manual_seed(24)
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    ops = {"mean": 0, "sum": 1, "max": 2}
    cases = {}

    def case(label, m, k, d, dtype, op):
        # a coarse grid, so the max has ties to share its gradient among
        x = (torch.randn((m, k, d), generator=gen, device=dev) * 2).round()
        x = x.to(dtype)
        mask = poisson_prefix_mask(rng, m, k, dev)
        g = torch.randn((m, d), generator=gen, device=dev).to(dtype)
        out = _masked_reduce_fwd(x, mask, op) if op == "max" else None
        saved = (x, out) if op == "max" else ()

        def run_first():
            grad = torch.empty((m, k, d), dtype=dtype, device=dev)
            first("gigl_masked_reduce_bwd", g.data_ptr(), mask.data_ptr(),
                  *(_build.ptr(t) for t in saved or (None, None)),
                  grad.data_ptr(), m, k, d, dtypes[dtype], ops[op])
            return grad

        fns = {"kept": lambda: masked_reduce_bwd(g, mask, op, *saved)}
        if first is not None:
            fns["first"] = run_first
        if op == "sum":   # the one PyTorch call that computes it
            fns["library"] = lambda: torch.where(mask[..., None],
                                                 g[:, None, :], 0)
        cases[label] = (fns, lambda: _masked_reduce_bwd_plain(g, mask, op,
                                                              *saved),
                        1e-6 if dtype == torch.float32 else 2.0 ** -7)

    for op in ("mean", "sum", "max"):
        case(f"k4b_bf16_512x15x256_{op}", 512, 15, 256, torch.bfloat16, op)
        case(f"k4b_fp32_512x15x256_{op}", 512, 15, 256, torch.float32, op)
    case("k4b_fp32_8192x10x128_mean", 8192, 10, 128, torch.float32, "mean")
    case("k4b_bf16_8192x10x128_mean", 8192, 10, 128, torch.bfloat16, "mean")
    case("k4b_bf16_8192x10x128_max", 8192, 10, 128, torch.bfloat16, "max")
    return cases


def cache_cases(dev, _build, first):
    from gigl_tpu_torch.graph.csr import build_csr
    from gigl_tpu_torch.ops.hopcache import (
        _neighbor_cache_plain, build_neighbor_cache)
    from gigl_tpu_torch.ops.quantized import QuantizedTable
    from gigl_tpu_torch.sampling.neighbor_sampler import (
        WEIGHTED_METHODS, DeviceCSR)

    rng, src, dst = flagship()
    host = build_csr(src, dst, num_anchor_nodes=N, num_neighbor_nodes=N)
    csr = DeviceCSR.from_csr(host, dev, edge_weights=rng.random(
        host.indices.shape[0]).astype(np.float32))
    deg = torch.diff(csr.indptr).float()
    feats = {d: rng.normal(size=(N, d)).astype(np.float32) for d in (128, 256)}
    tables = {"fp32": {d: torch.from_numpy(x).to(dev)
                       for d, x in feats.items()},
              "int8": {128: QuantizedTable.quantize(feats[128], device=dev)}}
    aggs = {"mean": 0, "sum": 1, "gcn": 2}
    cases = {}

    def case(label, kind, d, fanout, agg, method="uniform"):
        table = tables[kind][d]
        q8 = kind == "int8"
        weights = csr.edge_weights if method != "uniform" else None

        def run_first():
            out = torch.empty((N, d), dtype=torch.float32, device=dev)
            first("gigl_build_neighbor_cache", csr.indptr.data_ptr(),
                  csr.indices.data_ptr(), csr.indices.shape[0], N,
                  (table.q if q8 else table).data_ptr(),
                  table.scale.data_ptr() if q8 else None, d,
                  deg.data_ptr() if agg == "gcn" else None,
                  _build.ptr(weights),
                  0 if weights is None else weights.shape[0],
                  WEIGHTED_METHODS.get(method, 0), fanout, 0, 2, aggs[agg],
                  out.data_ptr(), d)
            return out

        fns = {"kept": lambda: build_neighbor_cache(
            csr, table, fanout=fanout, seed=0, hop_key=2, agg=agg,
            degrees=deg, method=method)}
        if first is not None:
            fns["first"] = run_first
        plain = torch.empty((N, d), dtype=torch.float32, device=dev)
        cases[label] = (fns, lambda: _neighbor_cache_plain(
            csr, table, fanout, 0, 2, agg, deg, plain, method=method))

    for agg in aggs:
        case(f"k2_fp32_d128_f10_{agg}", "fp32", 128, 10, agg)
    case("k2_int8_d128_f10_mean", "int8", 128, 10, "mean")
    case("k2_weighted_fp32_d128_f10_mean", "fp32", 128, 10, "mean",
         "weighted")
    case("k2_top_k_fp32_d128_f10_mean", "fp32", 128, 10, "mean", "top_k")
    case("k2_weighted_int8_d128_f10_mean", "int8", 128, 10, "mean",
         "weighted")
    case("k2_fp32_d256_f10_mean", "fp32", 256, 10, "mean")
    case("k2_fp32_d128_f40_mean", "fp32", 128, 40, "mean")
    return cases


def q8_cases(dev, _build, first):
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.ops.quantized import (
        QuantizedTable, _gather_rows_q8_many_plain)
    from gigl_tpu_torch.training.dataset import DeviceGraph

    rng, src, dst = flagship()
    x = rng.normal(size=(N, 128)).astype(np.float32)
    graph = HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                    node_features=x)
    dg = DeviceGraph.from_hetero(graph, quantize_features=True,
                                 device=dev).with_neighbor_cache(
        fanout=10, hop_key=2, table_fanouts=(15,), quantize=True)
    feats, cache, deg = dg.node_features, dg.nbr_cache, dg.degrees

    def tree(roots):
        return dg.sample_hop_blocks_tabularized(roots, (15,)).node_ids

    def case(label, parts):
        """Each mode writes the gathers' outputs at 16-byte-aligned offsets
        of its own byte buffer, as the wrapper lays them out (no copy
        timed), zeroed at its first call under each variant's library; the
        buffers are compared."""
        segs, at, total = [], [], 0
        for t_, ids, rv in parts:
            ids = ids.reshape(-1).contiguous()
            rows_b = ids.numel() * t_.dim * t_.out_dtype.itemsize
            vals_b = 0 if rv is None else ids.numel() * 4
            segs.append((t_.q, t_.scale, ids, t_.out_dtype, rv))
            at.append((total, rows_b, total + -(-rows_b // 16) * 16, vals_b))
            total += -(-rows_b // 16) * 16 + -(-vals_b // 16) * 16

        def launcher(mode):
            buf = torch.zeros(total, dtype=torch.uint8, device=dev)
            table = np.zeros((len(segs), 10), np.int64)
            for k, ((q, scale, ids, dtype, rv), (r0, _, v0, vb)) in (
                    enumerate(zip(segs, at))):
                table[k] = (q.data_ptr(), scale.data_ptr(), q.shape[0],
                            q.shape[1], ids.data_ptr(), ids.numel(),
                            0 if dtype == torch.float32 else 1,
                            buf.data_ptr() + r0, _build.ptr(rv) or 0,
                            buf.data_ptr() + v0 if vb else 0)
            rows = [np.ascontiguousarray(table[k:k + 1])
                    for k in range(len(segs))]
            lib = [None]

            def run():
                if mode != "first" and lib[0] is not _build._lib:
                    buf.zero_()
                    lib[0] = _build._lib
                if mode == "kept":
                    _build.launch("gather_rows_q8",
                                  "gigl_gather_rows_q8_many", dev,
                                  table.ctypes.data, len(segs))
                elif mode == "per_segment":
                    for row in rows:
                        _build.launch("gather_rows_q8",
                                      "gigl_gather_rows_q8_many", dev,
                                      row.ctypes.data, 1)
                else:
                    for r_ in table:
                        first("gigl_gather_rows_q8",
                              *(int(v) for v in r_[:8]), int(r_[8]) or None,
                              int(r_[9]) or None)
                return buf
            return run

        def plain():
            want = torch.zeros(total, dtype=torch.uint8, device=dev)
            for (rows, vals), (r0, rb, v0, vb) in zip(
                    _gather_rows_q8_many_plain(segs), at):
                want[r0:r0 + rb] = rows.reshape(-1).view(torch.uint8)
                if vals is not None:
                    want[v0:v0 + vb] = vals.view(torch.uint8)
            return want

        modes = ["kept", "per_segment"] + ([] if first is None else ["first"])
        cases[label] = ({m: launcher(m) for m in modes}, plain, 0.0)

    cases = {}
    for label, roots in (
            ("inference_batch", torch.arange(512, dtype=torch.int32,
                                             device=dev)),
            ("nalp_chain", torch.as_tensor(rng.integers(0, N, 512).astype(
                np.int32), device=dev))):
        levels = tree(roots)
        case(label, [(feats, ids, deg) for ids in levels]
             + [(cache, ids, None) for ids in levels])
    case("first_hop", [(feats, levels[1], deg)])
    live = dg.sample_hop_blocks(torch.arange(512, dtype=torch.int32,
                                             device=dev), (15, 10)).node_ids
    case("live_tree", [(feats, ids, deg) for ids in live])
    case("whole_table", [(feats, torch.arange(N, dtype=torch.int32,
                                              device=dev), deg)])
    x130 = rng.normal(size=(N, 130)).astype(np.float32)
    mixed = [QuantizedTable.quantize(x, device=dev),
             QuantizedTable.quantize(x130, out_dtype=torch.bfloat16,
                                     device=dev),
             QuantizedTable.quantize(x[:, :12], out_dtype=torch.bfloat16,
                                     device=dev)]
    ids = torch.as_tensor(rng.integers(0, N, 7680).astype(np.int32),
                          device=dev)
    case("mixed", [(mixed[0], ids, None), (mixed[1], ids, None),
                   (mixed[2], ids, deg)])
    return cases


def weighted_cases(dev, _build, first):
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.sampling.neighbor_sampler import (
        WEIGHTED_METHODS, DeviceCSR, _sample_weighted_plain)
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.dist_sampled import _shard_csr

    _, src, dst = flagship()
    ef = np.random.default_rng(16).random((E, 8), dtype=np.float32)
    graph = HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N,
        node_features=np.zeros((N, 4), np.float32), edge_features=ef)
    csr = DeviceGraph.from_hetero(graph, sampling_weight_index=0,
                                  device=dev).message_csr
    hrng = np.random.default_rng(17)
    hub = DeviceCSR(
        torch.as_tensor((np.arange(1001) * 1000).astype(np.int32),
                        device=dev),
        torch.as_tensor(hrng.integers(0, N, 10**6).astype(np.int32),
                        device=dev),
        torch.as_tensor(hrng.integers(0, 4, 10**6).astype(np.float32),
                        device=dev))
    rows = -(-N // 4)
    ip_s, ix_s, w_s = _shard_csr(csr.indptr.cpu().numpy(),
                                 csr.indices.cpu().numpy(), 4, rows,
                                 weights=csr.edge_weights.cpu().numpy())
    shard1 = DeviceCSR(*(torch.as_tensor(a[1], device=dev)
                         for a in (ip_s, ix_s, w_s)))
    ids_all = torch.arange(N, dtype=torch.int32, device=dev)
    hop1 = torch.arange(3 * 512, dtype=torch.int32, device=dev) % N
    ids1, mask1, _ = _sample_weighted_plain(
        csr.indptr, csr.indices, csr.edge_weights, hop1, 15, 128,
        "weighted", 0, 1)
    hop2 = torch.where(mask1, ids1, 0).reshape(-1).contiguous()
    owned = hop2[(hop2 >= rows) & (hop2 < 2 * rows)].contiguous()

    def case(label, c_, frontier, fanout, method, hop, window=128,
             row_offset=None):
        """Each mode writes ids, mask and slots into its own byte buffer
        (no copy timed), zeroed at its first call under each variant's
        library; the buffers are compared."""
        args = (c_.indptr, c_.indices, c_.edge_weights, frontier, fanout,
                window, method, 0, hop, row_offset)
        mf = frontier.numel() * fanout
        mask_at, slots_at = 4 * mf, 4 * mf + -(-mf // 16) * 16

        def launcher(mode):
            buf = torch.zeros(slots_at + 4 * mf, dtype=torch.uint8,
                              device=dev)
            call = (c_.indptr.data_ptr(), c_.indices.data_ptr(),
                    c_.indices.shape[0], c_.edge_weights.data_ptr(),
                    c_.edge_weights.shape[0], frontier.data_ptr(),
                    frontier.numel(), fanout, window,
                    WEIGHTED_METHODS[method], 0, hop,
                    int(row_offset is not None), row_offset or 0,
                    c_.indptr.shape[0] - 1, buf.data_ptr(),
                    buf.data_ptr() + mask_at, buf.data_ptr() + slots_at)
            lib = [None]

            def run():
                if mode == "first":
                    first("gigl_sample_weighted", *call)
                    return buf
                if lib[0] is not _build._lib:
                    buf.zero_()
                    lib[0] = _build._lib
                _build.launch("sample_weighted", "gigl_sample_weighted",
                              dev, *call)
                return buf
            return run

        def plain():
            want = torch.zeros(slots_at + 4 * mf, dtype=torch.uint8,
                               device=dev)
            ids, mask, slots = _sample_weighted_plain(*args)
            want[:4 * mf] = ids.reshape(-1).view(torch.uint8)
            want[mask_at:mask_at + mf] = mask.reshape(-1).view(torch.uint8)
            want[slots_at:] = slots.reshape(-1).view(torch.uint8)
            return want

        modes = ["kept"] + ([] if first is None else ["first"])
        cases[label] = ({m: launcher(m) for m in modes}, plain, 0.0)

    cases = {}
    for method in ("weighted", "top_k"):
        case(f"all_nodes_{method}", csr, ids_all, 15, method, 1)
    case("live_hop1", csr, hop1, 15, "weighted", 1)
    case("live_hop2", csr, hop2, 10, "weighted", 2)
    for method in ("weighted", "top_k"):
        case(f"hub_{method}", hub, torch.arange(1000, dtype=torch.int32,
                                                device=dev), 15, method, 1)
    case("row_offset", shard1, owned, 10, "weighted", 2, row_offset=rows)
    for window in (32, 1024):
        case(f"all_nodes_window{window}", csr, ids_all, 15, "weighted", 1,
             window)
    case("hub_window1024", hub, torch.arange(1000, dtype=torch.int32,
                                             device=dev), 15, "weighted", 1,
         1024)
    return cases


def retrieval_cases(dev, _build, first):
    from gigl_tpu_torch.ops import retrieval as rl

    rng = np.random.default_rng(23)
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    cases = {}

    def t(a):
        return torch.as_tensor(a, device=dev)

    for label, q, c, dtype, logq in (
            ("bf16_512x1024", 512, 1024, torch.bfloat16, False),
            ("bf16_512x1024_logq", 512, 1024, torch.bfloat16, True),
            ("fp32_512x1024", 512, 1024, torch.float32, False),
            ("bf16_128x640_logq", 128, 640, torch.bfloat16, True)):
        # the step's layout: query rows are anchors, columns their
        # positives (masked where an anchor has none), then random ids
        pos_mask = rng.random(q) < 0.97
        masks = rl.RetrievalMasks(
            temperature=0.07, query_ids=t(np.arange(q, dtype=np.int32)),
            candidate_ids=t(rng.integers(0, N, c).astype(np.int32)),
            remove_accidental_hits=True, query_mask=t(pos_mask),
            candidate_mask=t(np.concatenate([pos_mask, np.ones(c - q, bool)])),
            candidate_sampling_probability=t(
                (rng.random(c) * 1e-3).astype(np.float32)) if logq else None)
        scores = t((rng.normal(size=(q, c)) * 0.5).astype(np.float32)).to(
            dtype)
        g = torch.tensor(1.0 / max(int(pos_mask.sum()), 1), device=dev)
        lse = rl._retrieval_fwd_plain(scores, masks)[2]

        def flat(out):
            """loss_sum, count, lse, ce as one fp32 vector."""
            loss, count, lse_, ce = out
            return torch.cat([loss.reshape(1), count.float().reshape(1),
                              lse_, ce])

        def first_fwd(scores=scores, masks=masks, dtype=dtype, q=q, c=c):
            _, args = rl._kernel_args(scores, masks)
            out = (torch.empty((), device=dev),
                   torch.empty((), dtype=torch.int32, device=dev),
                   torch.empty(q, device=dev), torch.empty(q, device=dev))
            first("gigl_retrieval_loss_fwd", scores.data_ptr(), q, c,
                  dtypes[dtype], *args, out[2].data_ptr(), out[3].data_ptr(),
                  out[0].data_ptr(), out[1].data_ptr())
            return flat(out)

        def first_bwd(scores=scores, masks=masks, dtype=dtype, lse=lse, g=g,
                      q=q, c=c):
            _, args = rl._kernel_args(scores, masks)
            ds = torch.empty_like(scores)
            first("gigl_retrieval_loss_bwd", scores.data_ptr(), q, c,
                  dtypes[dtype], *args, lse.data_ptr(), g.data_ptr(),
                  ds.data_ptr())
            return ds

        fns = {"kept": lambda scores=scores, masks=masks: flat(
            rl.retrieval_fwd(scores, masks))}
        if first is not None:
            fns["first"] = first_fwd
        cases[f"k5_fwd_{label}"] = (fns, lambda scores=scores, masks=masks:
                                    flat(rl._retrieval_fwd_plain(scores,
                                                                 masks)),
                                    1e-5, False)
        fns = {"kept": lambda scores=scores, masks=masks, lse=lse, g=g:
               rl.retrieval_bwd(scores, masks, lse, g)}
        if first is not None:
            fns["first"] = first_bwd
        cases[f"k5_bwd_{label}"] = (
            fns, lambda scores=scores, masks=masks, lse=lse, g=g:
            rl._retrieval_bwd_plain(scores, masks, lse, g),
            1e-5 if dtype == torch.float32 else 2.0 ** -7)
    return cases


def k10b_cases(dev, _build, first):
    from gigl_tpu_torch.ops import segment as seg

    gen = torch.Generator(device=dev).manual_seed(22)
    cases = {}
    for label, e, heads, dtype, offset, dscale in (
            ("coef_fp32", E, HEADS, torch.float32, 0, False),
            ("coef_bf16", E, HEADS, torch.bfloat16, 0, False),
            ("coef_fp32_h16", E, 16, torch.float32, 0, False),
            ("coef_fp32_offset", E, HEADS, torch.float32, 1, False),
            ("dscale_fp32", E, HEADS, torch.float32, 0, True),
            ("dscale_bf16", E, HEADS, torch.bfloat16, 0, True),
            ("dscale_fp32_h1", E * HEADS, 1, torch.float32, 0, True)):
        g, raw = ((torch.randn(e * heads + offset, generator=gen, device=dev)
                   * s_).to(dtype)[offset:].view(e, heads)
                  for s_ in (1.0, 8.0))
        scale = torch.rand(heads, generator=gen, device=dev) + 0.5
        rw = raw if dscale else None
        blocks = min(max(-(-e // 256), 1), 1024)

        def first_fn(g=g, rw=rw, scale=scale, e=e, heads=heads,
                     blocks=blocks):
            coef = torch.empty((e, heads), device=dev)
            part = (None if rw is None else
                    torch.empty((blocks, heads), device=dev))
            first("gigl_sddmm_bwd_coef", g.data_ptr(), scale.data_ptr(),
                  _build.ptr(rw), coef.data_ptr(), _build.ptr(part), e,
                  heads, blocks, 0 if g.dtype == torch.float32 else 1)
            if rw is None:
                return coef
            out = torch.zeros(heads, device=dev)
            first("gigl_sddmm_bwd_scale", part.data_ptr(), out.data_ptr(),
                  blocks, heads)
            return out

        which = 1 if dscale else 0
        fns = {"kept": lambda g=g, rw=rw, scale=scale, which=which:
               seg.sddmm_bwd_coef(g, scale, rw)[which]}
        if first is not None:
            fns["first"] = first_fn
        if not dscale:
            fns["library"] = lambda g=g, scale=scale: torch.mul(g, scale)
            cases[label] = (fns, lambda g=g, scale=scale:
                            seg._sddmm_bwd_coef_plain(g, scale)[0], 0.0)
        else:
            # against an fp64 sum, within 1e-6 of sum |g raw| per head (the
            # sum nearly cancels: no bound relative to it would mean
            # anything), as a fraction of the largest |dscale|; the first
            # version sums in another order
            prod = g.double() * raw.double()
            want = prod.sum(0)
            tol = float(1e-6 * prod.abs().sum(0).max() / want.abs().max())
            del prod
            cases[label] = (fns, lambda want=want: want, tol, False)
    return cases


def cms_cases(dev, _build, first):
    from gigl_tpu_torch.losses import count_min_sketch as cms

    rng = np.random.default_rng(14)
    cases = {}
    for label, n, width in (("1024_5x2048", 1024, 2048),
                            ("65536_5x16384", 65_536, 16384)):
        ids = torch.from_numpy(rng.integers(0, N, n).astype(np.int32)).to(dev)
        sk = cms.cms_init(5, width, device=dev)
        for _ in range(20):
            sk = cms.cms_add(sk, torch.from_numpy(rng.integers(
                0, N, n).astype(np.int32)).to(dev))

        def first_k14(sk=sk, ids=ids):
            prob = torch.empty(ids.shape, device=dev)
            first("gigl_cms_estimate", sk.table.data_ptr(), sk.depth,
                  sk.width, ids.data_ptr(), ids.numel(), sk.total.data_ptr(),
                  None, prob.data_ptr())
            return prob

        def first_pair(sk=sk, ids=ids):
            table = torch.empty_like(sk.table)
            total = torch.empty_like(sk.total)
            first("gigl_cms_add", sk.table.data_ptr(), sk.depth, sk.width,
                  ids.data_ptr(), ids.numel(), sk.total.data_ptr(),
                  table.data_ptr(), total.data_ptr())
            return first_k14(cms.CountMinSketch(table, total), ids)

        for kind, kept, plain, first_fn in (
                ("k14", lambda sk=sk, ids=ids:
                 cms.cms_sampling_probability(sk, ids),
                 lambda sk=sk, ids=ids: cms._cms_probability_plain(sk, ids),
                 first_k14),
                ("pair", lambda sk=sk, ids=ids: cms.cms_sampling_probability(
                    cms.cms_add(sk, ids), ids),
                 lambda sk=sk, ids=ids: cms._cms_probability_plain(
                     cms._cms_add_plain(sk, ids), ids), first_pair)):
            fns = {"kept": kept}
            if first is not None:
                fns["first"] = first_fn
            cases[f"{kind}_{label}"] = (fns, plain, 0.0)
    return cases


FLOOR_SOURCE = r"""// The launch floor: empty kernels, a block of 128 threads.
#include "gigl_common.cuh"

namespace {
__global__ void empty_kernel() {}
__global__ void empty_dependent_kernel() { gigl::wait_for_prior_grid(); }
}  // namespace

extern "C" int floor_plain(void* stream) {
  empty_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int floor_dependent(void* stream) {
  return static_cast<int>(gigl::launch_dependent(
      empty_dependent_kernel, dim3(1), dim3(128),
      static_cast<cudaStream_t>(stream)));
}
"""


def k1b_cases(dev, _build, first):
    from gigl_tpu_torch.graph.csr import build_csr
    from gigl_tpu_torch.sampling import neighbor_sampler as ns

    out = REPO / "build" / "sweep" / "k1b_floor"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    (out / "floor.cu").write_text(FLOOR_SOURCE)
    shutil.copy(_build.CSRC / "gigl_common.cuh", out)
    floor = load(finish_build(*start_build(out, ["floor.cu"], _build),
                              _build), {"floor_plain": [_P],
                                        "floor_dependent": [_P]})

    def launch_floor(fn):
        rc = fn(torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"floor: cudaError {rc}")

    _, src, dst = flagship()
    sup = ns.DeviceCSR.from_csr(build_csr(src, dst, num_anchor_nodes=N,
                                          num_neighbor_nodes=N), dev)
    anchors = torch.arange(512, dtype=torch.int32, device=dev)
    every = torch.arange(N, dtype=torch.int32, device=dev)

    def k1(frontier, fanout, hop):
        return ns.sample_uniform(sup.indptr, sup.indices, frontier, fanout,
                                 0, hop)[0]

    def k1_first(frontier, fanout, hop):
        ids, slots = (torch.empty((frontier.numel(), fanout),
                                  dtype=torch.int32, device=dev)
                      for _ in range(2))
        mask = torch.empty(ids.shape, dtype=torch.bool, device=dev)
        first("gigl_sample_uniform", sup.indptr.data_ptr(),
              sup.indices.data_ptr(), sup.indices.numel(),
              frontier.data_ptr(), frontier.numel(), fanout, 0, hop, 0, 0,
              N, ids.data_ptr(), mask.data_ptr(), slots.data_ptr())
        return ids

    def k1b(count):
        return ns.uniform_ids(count, 0, 3_000_017, N, dev)

    def k1b_first(count):
        ids = torch.empty(count, dtype=torch.int32, device=dev)
        first("gigl_uniform_ids", count, 0, 3_000_017, N, ids.data_ptr())
        return ids

    cases = {}
    for label, kept, first_fn, plain in (
            ("k1b_512", lambda: k1b(512), lambda: k1b_first(512),
             lambda: ns._uniform_ids_plain(512, 0, 3_000_017, N, dev)),
            ("k1b_65536", lambda: k1b(65_536), lambda: k1b_first(65_536),
             lambda: ns._uniform_ids_plain(65_536, 0, 3_000_017, N, dev)),
            ("k1_512x1", lambda: k1(anchors, 1, 1_000_003),
             lambda: k1_first(anchors, 1, 1_000_003),
             lambda: ns._sample_uniform_plain(sup.indptr, sup.indices,
                                              anchors, 1, 0, 1_000_003)[0]),
            ("k1_table", lambda: k1(every, 15, 1),
             lambda: k1_first(every, 15, 1),
             lambda: ns._sample_uniform_plain(sup.indptr, sup.indices,
                                              every, 15, 0, 1)[0]),
            ("pair_512", lambda: (k1(anchors, 1, 1_000_003), k1b(512))[1],
             lambda: (k1_first(anchors, 1, 1_000_003), k1b_first(512))[1],
             lambda: ns._uniform_ids_plain(512, 0, 3_000_017, N, dev))):
        fns = {"kept": kept}
        if first is not None:
            fns["first"] = first_fn
        cases[label] = (fns, plain, 0.0)
    def k1b_direct(count):
        """The kept C entry called as ``first`` calls the earlier one, so
        that the two eager times differ by the launch alone."""
        ids = torch.empty(count, dtype=torch.int32, device=dev)
        rc = _build._lib.gigl_uniform_ids(
            count, 0, 3_000_017, N, ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"gigl_uniform_ids: cudaError {rc}")
        return ids

    fns = {"kept_eager": lambda: k1b_direct(512),
           "wrapper_eager": lambda: k1b(512)}
    if first is not None:
        fns["first_eager"] = lambda: k1b_first(512)
    cases["k1b_512_host"] = (fns, lambda: ns._uniform_ids_plain(
        512, 0, 3_000_017, N, dev), 0.0)
    cases["floor"] = ({"plain_launch": lambda: launch_floor(
        floor.floor_plain), "dependent_launch": lambda: launch_floor(
            floor.floor_dependent)}, None)
    return cases


class _AccessPolicyWindow(ctypes.Structure):
    _fields_ = [("base_ptr", ctypes.c_void_p), ("num_bytes", ctypes.c_size_t),
                ("hit_ratio", ctypes.c_float), ("hit_prop", ctypes.c_int),
                ("miss_prop", ctypes.c_int)]


class _StreamAttr(ctypes.Union):
    _fields_ = [("window", _AccessPolicyWindow), ("pad", ctypes.c_char * 64)]


def persisting_window(dev, table):
    """``fn -> fn'``: fn run with a persisting L2 access-policy window over
    ``table``'s bytes on the current stream (CUDA driver API, this process's
    context: its persisting L2 set-aside raised to the most the card
    allows), the window removed after; and the set-aside in bytes. (None,
    0) where the driver grants no set-aside."""
    cuda = ctypes.CDLL("libcuda.so.1")
    torch.cuda.synchronize(dev)
    size, most, window = ctypes.c_size_t(), ctypes.c_int(), ctypes.c_int()
    device = ctypes.c_int()
    # CU_DEVICE_ATTRIBUTE_MAX_PERSISTING_L2_CACHE_SIZE (108): ask for it
    # (CU_LIMIT_PERSISTING_L2_CACHE_SIZE, 0x06), read back what is granted;
    # the window at most CU_DEVICE_ATTRIBUTE_MAX_ACCESS_POLICY_WINDOW_SIZE
    # (109)
    rcs = (cuda.cuCtxGetDevice(ctypes.byref(device)),
           cuda.cuDeviceGetAttribute(ctypes.byref(most), 108, device),
           cuda.cuDeviceGetAttribute(ctypes.byref(window), 109, device),
           cuda.cuCtxSetLimit(0x06, ctypes.c_size_t(most.value)),
           cuda.cuCtxGetLimit(ctypes.byref(size), 0x06))
    nbytes = min(table.numel() * table.element_size(), window.value)
    print(json.dumps({"phase": "persisting_l2", "cu_results": rcs,
                      "max_set_aside_bytes": most.value,
                      "set_aside_bytes": size.value,
                      "max_window_bytes": window.value,
                      "window_bytes": nbytes}), flush=True)
    if any(rcs) or size.value == 0 or nbytes == 0:
        return None, 0
    on, off = _StreamAttr(), _StreamAttr()
    on.window = _AccessPolicyWindow(table.data_ptr(), nbytes,
                                    min(1.0, size.value / nbytes), 2, 1)
    off.window = _AccessPolicyWindow(table.data_ptr(), 0, 0.0, 0, 0)

    def wrap(fn):
        def run():
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev)
                                     .cuda_stream)
            # CU_STREAM_ATTRIBUTE_ACCESS_POLICY_WINDOW
            rc = cuda.cuStreamSetAttribute(stream, 1, ctypes.byref(on))
            if rc:
                raise RuntimeError(f"access-policy window: CUresult {rc}")
            out = fn()
            rc = cuda.cuStreamSetAttribute(stream, 1, ctypes.byref(off))
            if rc:
                raise RuntimeError(f"access-policy window: CUresult {rc}")
            return out
        return run
    return wrap, size.value


def ell_cases(dev, _build, first):
    from gigl_tpu_torch.graph.csr import build_csr
    from gigl_tpu_torch.ops.ell import EllGraph
    from gigl_tpu_torch.ops.ell_aggregate import (
        OPS, _ell_aggregate_fwd, _ell_aggregate_graph_plain)

    _, src, dst = flagship()
    ell = EllGraph.from_csr(build_csr(src, dst, num_anchor_nodes=N),
                            device=dev)
    sizes = [hi - lo for lo, hi in zip(ell.boundaries, ell.boundaries[1:])]
    big = int(np.argmax(sizes))
    gen = torch.Generator(device=dev).manual_seed(20)
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    cases = {}

    def run_first(x, op, ea, rows=None):
        """The first version: one launch a bucket, each into its rows."""
        lo_r, hi_r = rows or (0, N)
        d = x.shape[1]
        out = torch.empty((hi_r - lo_r, d), dtype=x.dtype, device=dev)
        vec = int(d * x.element_size() % 16 == 0)
        for b, w in enumerate(ell.widths):
            lo, hi = ell.boundaries[b], ell.boundaries[b + 1]
            if hi == lo or lo < lo_r or hi > hi_r:
                continue
            gcn = op == "gcn"
            first("gigl_ell_aggregate", x.data_ptr(), ell.nbr[b].data_ptr(),
                  ell.mask[b].data_ptr(),
                  ell.deg_p[lo:].data_ptr() if gcn else None,
                  ell.deg_p.data_ptr() if gcn else None, _build.ptr(ea),
                  None if ea is None else ell.edge_slots[b].data_ptr(),
                  out[lo - lo_r:].data_ptr(), hi - lo, w, d, dtypes[x.dtype],
                  OPS[op], vec)
        return out

    def case(label, x, op, ea=None, rows=None):
        window, _ = persisting_window(dev, x)

        def kept():
            return _ell_aggregate_fwd(x, ell, op, ea=ea, rows=rows)

        fns = {"kept": kept, "kept_eager": kept}
        if window is not None:
            fns["window_eager"] = window(kept)
        if first is not None:
            fns["first"] = lambda: run_first(x, op, ea, rows)
        cases[label] = (fns, lambda: _ell_aggregate_graph_plain(
            x, ell, op, ea, rows),
            1e-5 if x.dtype == torch.float32 else 2.0 ** -7)

    x_big = torch.randn((N, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    case("k6_bucket_bf16_d256_mean", x_big, "mean",
         rows=(ell.boundaries[big], ell.boundaries[big + 1]))
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for d in (128, 256):
            x = torch.randn((N, d), generator=gen, device=dev).to(dtype)
            for op in ("mean", "sum", "max", "gcn"):
                case(f"k6_{tag}_d{d}_{op}", x, op)
        x = torch.randn((N, 128), generator=gen, device=dev).to(dtype)
        ea = torch.randn((E, 128), generator=gen, device=dev).to(dtype)
        case(f"k6_{tag}_d128_gine_edges", x, "gine", ea=ea)
        case(f"k6_{tag}_d128_gine", x, "gine")
    return cases


def ring_cases(dev, _build, first):
    from gigl_tpu_torch.losses import sharded_retrieval as sr

    ql, cl = 128, 256       # a shard's rows and block at the flagship step
    rng = np.random.default_rng(21)
    cases = {}

    def t(a):
        return torch.as_tensor(a, device=dev)

    rows = sr.RingRows(
        temperature=0.07, label_cols=t(np.arange(ql, dtype=np.int32)),
        query_ids=t(rng.integers(0, N, ql).astype(np.int32)),
        own_pos_ids=t(rng.integers(0, N, ql).astype(np.int32)))
    for p in (1, 4):
        scores = t((rng.normal(size=(p, ql, cl)) * 3).astype(np.float32))
        blocks = [sr.RingColumns(
            ids=t(rng.integers(0, N, cl).astype(np.int32)),
            pos_qids=t(np.where(np.arange(cl) < ql,
                                rng.integers(0, N, cl), -1).astype(np.int32)),
            mask=t(rng.random(cl) < 0.95),
            log_q=t(np.log(rng.random(cl) * 1e-3 + 1e-6).astype(np.float32)))
            for _ in range(p)]
        cols = sr.stack_columns(blocks)
        fresh = torch.stack([torch.full((ql,), sr.FMIN, device=dev),
                             torch.zeros(ql, device=dev),
                             torch.zeros(ql, device=dev)])
        state = torch.empty_like(fresh)

        def fold(fn, state=state, fresh=fresh):
            """[3, Ql]: (m, s, pos) after the fold (a reset copy before it
            and a copy out after it, in every variant)."""
            state.copy_(fresh)
            fn(*state)
            return state.clone()

        def args(b, s_t, own):
            _, a = sr._kernel_args("ring_retrieval", s_t, rows, b, own)
            return a

        def first_fold(m, s, pos, scores=scores, blocks=blocks):
            for k, b in enumerate(blocks):
                a = args(b, scores[k], k == 0)
                first("gigl_ring_fold", a[0], *a[2:], m.data_ptr(),
                      s.data_ptr(), pos.data_ptr())

        st = fresh.clone()        # the fold's own logsumexp
        sr._ring_fold_plain(scores, rows, cols, True, *st)
        lse = torch.log(torch.clamp(st[1], min=1e-30)) + st[0]
        g = torch.rand(ql, device=dev)

        def first_bwd(scores=scores, blocks=blocks, lse=lse, g=g):
            ds = torch.empty_like(scores)
            for k, b in enumerate(blocks):
                a = args(b, scores[k], k == 0)
                first("gigl_ring_block_bwd", a[0], *a[2:], lse.data_ptr(),
                      g.data_ptr(), ds[k].data_ptr())
            return ds

        fns = {"kept": lambda scores=scores, cols=cols, fold=fold: fold(
            lambda *st: sr.ring_fold(scores, rows, cols, True, *st))}
        if first is not None:
            fns["first"] = lambda fold=fold, ff=first_fold: fold(ff)
        cases[f"k17_fold_p{p}"] = (fns, lambda scores=scores, cols=cols,
                                   fold=fold: fold(
            lambda *st: sr._ring_fold_plain(scores, rows, cols, True, *st)))
        fns = {"kept": lambda scores=scores, cols=cols, lse=lse, g=g:
               sr.ring_block_bwd(scores, rows, cols, True, lse, g)}
        if first is not None:
            fns["first"] = first_bwd
        cases[f"k17_bwd_p{p}"] = (fns, lambda scores=scores, cols=cols,
                                  lse=lse, g=g: sr._ring_block_bwd_plain(
            scores, rows, cols, True, lse, g))
    return cases


# -- the sweeps ----------------------------------------------------------------
# K9's and K9b's shared walk (csrc/gigl_softmax.cuh)
SOFTMAX_KNOBS = {name: [("gigl_softmax.cuh",
                         rf"constexpr int {const} = (\d+);")]
                 for name, const in (("group_lanes", "kGroupLanes"),
                                     ("slots_per_lane", "kSlotsPerLane"))}
# knobs: name -> [(file, pattern whose group 1 is the constant's value)];
# bounds: [(file, pattern, replacement with {b})] for --min-blocks B.
SWEEPS = {
    "attention": {
        "sources": ["fanout_attention*.cu"],
        "entries": ["gigl_fanout_attention", "gigl_fanout_attention_bwd"],
        "knobs": {"depth": [("gigl_attention.cuh",
                             r"constexpr int kDepth = (\d+);")]},
        "bounds": [(name, r"__launch_bounds__\(kThreads\)",
                    "__launch_bounds__(kThreads, {b})")
                   for name in ("fanout_attention_warp.cuh",
                                "fanout_attention_bwd_warp.cuh")],
        "cases": attention_cases, "first": None, "bit_equal_first": False},
    "walk": {
        "sources": ["sddmm.cu"],
        "entries": ["gigl_sddmm"],
        "knobs": {"seg_depth": [("gigl_segment.cuh",
                                 r"constexpr int kSegDepth = (\d+);")],
                  "walk_row_bytes": [("sddmm.cu",
                                      r"constexpr int kWalkRowBytes = "
                                      r"(\d+);")]},
        "bounds": [("sddmm.cu", r"__launch_bounds__\(kThreads\) sddmm_walk",
                    "__launch_bounds__(kThreads, {b}) sddmm_walk")],
        "cases": walk_cases,
        # q, k, src, dst, scale, out, E, C, heads, dtype, vec, stream
        "first": {"gigl_sddmm": [_P] * 6 + [_I64] + [_I32] * 4 + [_P]},
        "bit_equal_first": False},
    "gather": {
        "sources": ["segment_reduce.cu", "ell_transpose.cu"],
        "entries": ["gigl_segment_reduce", "gigl_ell_transpose_aggregate"],
        "knobs": {"slots": [(name, r"constexpr int kSlotsInFlight = (\d+);")
                            for name in ("segment_reduce.cu",
                                         "ell_transpose.cu")],
                  "k8_chained_slots": [("segment_reduce.cu",
                                        r"COMPOSED \? kSlotsInFlight : "
                                        r"(\d+);")],
                  "k6b_mean_weighted_slots": [("ell_transpose.cu",
                                               r"OP == kWeighted \? (\d+) :")],
                  "k6b_max_slots": [("ell_transpose.cu",
                                     r"OP == kMax \? (\d+) :")]},
        "bounds": [(name, rf"__global__ void {kernel}\(",
                    f"__global__ void __launch_bounds__(256, {{b}}) "
                    f"{kernel}(")
                   for name, kernel in (
                       ("segment_reduce.cu", "segment_reduce_kernel"),
                       ("ell_transpose.cu", "ell_transpose_kernel"))],
        "cases": gather_cases,
        # K8: x, gather, order, ptr, w, out, S, C, wc, w_cols, dtype, op,
        # vec, stream; K6b: rows, t_nbr, t_mask, t_perm, ent_row, deg, wt,
        # wt2, vec, rows2, table, cnt, ea, ent_edge, out, n, W, D, heads,
        # dh, dtype, op, vec, slope, stream
        "first": {"gigl_segment_reduce": [_P] * 6 + [_I64] + [_I32] * 6
                  + [_P],
                  "gigl_ell_transpose_aggregate": [_P] * 15 + [_I64]
                  + [_I32] * 7 + [_F32, _P]},
        "bit_equal_first": True},
    "k8b": {
        "sources": ["segment_reduce_bwd.cu"],
        "entries": ["gigl_segment_reduce_bwd"],
        "knobs": {"slots": [("segment_reduce_bwd.cu",
                             r"constexpr int kSlotsInFlight = (\d+);")]},
        "bounds": [("segment_reduce_bwd.cu",
                    r"__global__ void segment_reduce_bwd_kernel\(",
                    "__global__ void __launch_bounds__(256, {b}) "
                    "segment_reduce_bwd_kernel(")],
        "cases": k8b_cases,
        # g, gs, mref, x, dst, order, ptr, dst_ptr, w, out, rows, C, wc,
        # w_cols, dtype, op, vec, stream
        "first": {"gigl_segment_reduce_bwd": [_P] * 10 + [_I64] + [_I32] * 6
                  + [_P]},
        "bit_equal_first": True},
    "softmax": {
        "sources": ["segment_softmax.cu"],
        "entries": ["gigl_segment_softmax"],
        "knobs": SOFTMAX_KNOBS,
        "bounds": [("segment_softmax.cu",
                    r"__global__ void segment_softmax_kernel\(",
                    "__global__ void __launch_bounds__(256, {b}) "
                    "segment_softmax_kernel(")],
        "cases": softmax_cases,
        # logits, order, ptr, out, S, heads, dtype, stream
        "first": {"gigl_segment_softmax": [_P] * 4 + [_I64, _I32, _I32, _P]},
        "bit_equal_first": True},
    "softmax_bwd": {
        "sources": ["segment_softmax_bwd.cu"],
        "entries": ["gigl_segment_softmax_bwd"],
        "knobs": SOFTMAX_KNOBS,
        "bounds": [("segment_softmax_bwd.cu",
                    r"__global__ void segment_softmax_bwd_kernel\(",
                    "__global__ void __launch_bounds__(256, {b}) "
                    "segment_softmax_bwd_kernel(")],
        "cases": softmax_bwd_cases,
        # alpha, g, order, ptr, out, S, heads, dtype, stream
        "first": {"gigl_segment_softmax_bwd": [_P] * 5
                  + [_I64, _I32, _I32, _P]},
        "bit_equal_first": True},
    "ell": {
        "sources": ["ell_aggregate.cu"],
        "entries": ["gigl_ell_aggregate"],
        "knobs": {"slots": [("ell_aggregate.cu",
                             r"constexpr int kSlotsInFlight = (\d+);")]},
        "bounds": [("ell_aggregate.cu",
                    r"__global__ void ell_aggregate_kernel\(",
                    "__global__ void __launch_bounds__(256, {b}) "
                    "ell_aggregate_kernel(")],
        "cases": ell_cases,
        # x, nbr, mask, deg_dst, deg_tab, ea, eslot, out, n, W, D, dtype,
        # op, vec, stream
        "first": {"gigl_ell_aggregate": [_P] * 8 + [_I64] + [_I32] * 5
                  + [_P]},
        "bit_equal_first": True},
    "ring": {
        "sources": ["ring_retrieval.cu"],
        "entries": ["gigl_ring_fold", "gigl_ring_block_bwd"],
        "knobs": {"warps": [("ring_retrieval.cu",
                             r"constexpr int kRingWarps = (\d+);")]},
        "bounds": [],
        "cases": ring_cases,
        # scores, Ql, Cl, label_col, qid, pos_qid, own_pos, cand_id, cmask,
        # logq, T, fmin, then m, s, pos (fold) or lse, g, ds (backward),
        # stream
        "first": {fn: [_P, _I32, _I32] + [_P] * 7 + [_F32, _F32] + [_P] * 4
                  for fn in ("gigl_ring_fold", "gigl_ring_block_bwd")},
        "bit_equal_first": True},
    "masked": {
        "sources": ["masked_reduce.cu"],
        "entries": ["gigl_masked_reduce"],
        "knobs": {"rows": [("masked_reduce.cu",
                            r"constexpr int kBlockRows = (\d+);")],
                  "chunk": [("masked_reduce.cu",
                             r"constexpr int kSlotChunk = (\d+);")]},
        "bounds": [("masked_reduce.cu", r"__launch_bounds__\(kBlockRows \* 32\)",
                    "__launch_bounds__(kBlockRows * 32, {b})")],
        "cases": masked_cases,
        # x, mask, out, M, K, D, dtype, op, stream
        "first": {"gigl_masked_reduce": [_P] * 3 + [_I64] + [_I32] * 4
                  + [_P]},
        "bit_equal_first": True},
    "masked_bwd": {
        "sources": ["masked_reduce.cu"],
        "entries": ["gigl_masked_reduce_bwd"],
        "knobs": {name: [("masked_reduce.cu",
                          rf"constexpr int {const} = (\d+);")]
                  for name, const in (("rows", "kBwdBlockRows"),
                                      ("chunk", "kSlotChunk"))},
        "bounds": [],
        "cases": masked_bwd_cases,
        # grad_out, mask, x, out, grad_x, M, K, D, dtype, op, stream
        "first": {"gigl_masked_reduce_bwd": [_P] * 5 + [_I64] + [_I32] * 4
                  + [_P]},
        "bit_equal_first": True},
    "cache": {
        "sources": ["neighbor_cache.cu"],
        "entries": ["gigl_build_neighbor_cache"],
        "knobs": {"chunk": [("neighbor_cache.cu",
                             r"constexpr int kSlotChunk = (\d+);")],
                  "threads": [("neighbor_cache.cu",
                               r"constexpr int kCacheThreads = (\d+);")],
                  "warp_unroll": [("neighbor_cache.cu",
                                   r"constexpr int kWarpUnroll = (\d+);")],
                  "warp_min_blocks": [("neighbor_cache.cu",
                                       r"constexpr int kWarpMinBlocks = "
                                       r"(\d+);")],
                  "weighted_min_blocks": [("neighbor_cache.cu",
                                           r"constexpr int kWeightedMinBlocks"
                                           r" = (\d+);")]},
        "bounds": [("neighbor_cache.cu", r"__launch_bounds__\(kCacheThreads\)",
                    "__launch_bounds__(kCacheThreads, {b})")],
        "cases": cache_cases,
        # indptr, indices, E, N, features, scale, dim, degrees, weights,
        # n_weights, method, fanout, seed, hop, agg, out, out_stride, stream
        "first": {"gigl_build_neighbor_cache": [_P, _P, _I64, _I64, _P, _P,
                                                _I32, _P, _P, _I64, _I32,
                                                _I32, _U32, _U32, _I32, _P,
                                                _I64, _P]},
        "bit_equal_first": True},
    "q8": {
        "sources": ["gather_rows_q8.cu"],
        "entries": ["gigl_gather_rows_q8_many"],
        "knobs": {},
        "bounds": [],
        "cases": q8_cases,
        # q, scale, N, D, ids, M, out_dtype, out, row_vals, out_vals, stream
        "first": {"gigl_gather_rows_q8": [_P, _P, _I64, _I32, _P, _I64, _I32,
                                          _P, _P, _P, _P]},
        "bit_equal_first": True},
    "weighted": {
        "sources": ["sample_weighted.cu"],
        "entries": ["gigl_sample_weighted"],
        "knobs": {},
        "bounds": [("sample_weighted.cu", r"__launch_bounds__\(kThreads\)",
                    "__launch_bounds__(kThreads, {b})")],
        "cases": weighted_cases,
        # indptr, indices, E, weights, n_weights, frontier, M, fanout,
        # window, method, seed, hop, has_offset, row_offset, n_rows, ids,
        # mask, slots, stream
        "first": {"gigl_sample_weighted": [_P, _P, _I64, _P, _I64, _P, _I64,
                                           _I32, _I32, _I32, _U32, _U32,
                                           _I32, _I32, _I64, _P, _P, _P,
                                           _P]},
        "bit_equal_first": True},
    "retrieval": {
        "sources": ["retrieval_loss.cu"],
        "entries": ["gigl_retrieval_loss_fwd", "gigl_retrieval_loss_bwd"],
        "knobs": {name: [("retrieval_loss.cu",
                          rf"constexpr int {const} = (\d+);")]
                  for name, const in (("row_threads", "kRowThreads"),
                                      ("rows", "kBlockRows"),
                                      ("lane_values", "kLaneValues"),
                                      ("bwd_threads", "kBwdThreads"))},
        "bounds": [],
        "cases": retrieval_cases,
        # scores, Q, C, dtype, qids, cids, qmask, cmask, cprob, T, fmin,
        # use_qids, rah, then lse, ce, loss_sum, count (forward) or lse, g,
        # ds (backward), stream
        "first": {"gigl_retrieval_loss_fwd": [_P, _I64, _I64, _I32]
                  + [_P] * 5 + [_F32, _F32, _I32, _I32] + [_P] * 5,
                  "gigl_retrieval_loss_bwd": [_P, _I64, _I64, _I32]
                  + [_P] * 5 + [_F32, _F32, _I32, _I32] + [_P] * 4},
        "bit_equal_first": True},
    "k10b": {
        "sources": ["sddmm_bwd.cu"],
        "entries": ["gigl_sddmm_bwd", "gigl_sddmm_bwd_ticket"],
        "knobs": {name: [("sddmm_bwd.cu",
                          rf"constexpr int {const} = (\d+);")]
                  for name, const in (("pieces", "kPiecesInFlight"),
                                      ("threads", "kThreads"))},
        "bounds": [],
        "cases": k10b_cases,
        # g, scale, raw, coef, partial, E, heads, blocks, dtype, stream;
        # partial, dscale, blocks, heads, stream
        "first": {"gigl_sddmm_bwd_coef": [_P] * 5 + [_I64] + [_I32] * 3
                  + [_P],
                  "gigl_sddmm_bwd_scale": [_P, _P, _I32, _I32, _P]},
        "bit_equal_first": True},
    "cms": {
        "sources": ["cms.cu"],
        "entries": ["gigl_cms_add", "gigl_cms_estimate"],
        "knobs": {name: [("cms.cu", rf"constexpr int {const} = (\d+);")]
                  for name, const in (("threads", "kEstThreads"),
                                      ("unrolled", "kMaxUnrolled"))},
        "bounds": [],
        "cases": cms_cases,
        # table, depth, width, ids, n, total, est / out, prob / out_total,
        # stream
        "first": {"gigl_cms_add": [_P, _I32, _I32, _P, _I64, _P, _P, _P, _P],
                  "gigl_cms_estimate": [_P, _I32, _I32, _P, _I64, _P, _P, _P,
                                        _P]},
        "bit_equal_first": True},
    "k1b": {
        "sources": ["sample_uniform.cu"],
        "entries": ["gigl_sample_uniform", "gigl_uniform_ids"],
        "knobs": {"ids": [("sample_uniform.cu",
                           r"constexpr int kIdsPerThread = (\d+);")],
                  "trigger": [("sample_uniform.cu",
                               r"  // a dependent launch behind this one "
                               r"\(K1b\) may start its blocks now\n"
                               r"  gigl::allow_dependents_to_start\(\);\n",
                               {0: "", 1: None,
                                2: "  if (threadIdx.x == 0) "
                                   "gigl::allow_dependents_to_start();\n"})]},
        "bounds": [],
        "cases": k1b_cases,
        # indptr, indices, E, frontier, M, fanout, seed, hop, has_offset,
        # row_offset, n_rows, ids, mask, slots, stream; count, seed, hop,
        # n, out, stream
        "first": {"gigl_sample_uniform": [_P, _P, _I64, _P, _I64, _I32, _U32,
                                          _U32, _I32, _I32, _I64, _P, _P, _P,
                                          _P],
                  "gigl_uniform_ids": [_I64, _U32, _U32, _U32, _P, _P]},
        "bit_equal_first": True},
    "route": {
        "sources": ["route.cu"],
        "entries": ["gigl_route_requests", "gigl_route_tiles"],
        "knobs": {"tile": [("route.cu", r"constexpr int kRouteTile = (\d+);")]},
        "bounds": [],
        "cases": route_cases,
        # ids, G, rows, P, C, req, owner, pos, ok, stream
        "first": {"gigl_route_requests": [_P, _I64] + [_I32] * 3 + [_P] * 5},
        "bit_equal_first": True},
}


def variant_edits(sweep, knobs, min_blocks):
    """The edits of one variant: each knob's constant set, the launch
    bounds added when min_blocks > 0."""
    edits = {}
    for name, value in knobs.items():
        for file, pattern, *pick in sweep["knobs"][name]:
            if pick:        # {value: the pattern's replacement, or None}
                if pick[0][value] is not None:
                    edits.setdefault(file, []).append((pattern,
                                                       pick[0][value]))
                continue
            prefix, suffix = pattern.split(r"(\d+)")
            edits.setdefault(file, []).append(
                (pattern, prefix.replace("\\", "") + str(value)
                 + suffix.replace("\\", "")))
    if min_blocks:
        for file, pattern, repl in sweep["bounds"]:
            edits.setdefault(file, []).append(
                (pattern, repl.format(b=min_blocks)))
    return edits


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sweep", choices=sorted(SWEEPS))
    parser.add_argument("--set", action="append", default=[],
                        metavar="KNOB=V1,V2",
                        help="values of one of the sweep's knobs")
    parser.add_argument("--min-blocks", type=int, nargs="+", default=[0])
    parser.add_argument("--first", type=Path, default=None,
                        help="csrc directory of an earlier version")
    parser.add_argument("--repeats", type=int, default=1)
    args = parser.parse_args()
    sweep = SWEEPS[args.sweep]
    knob_values = {}
    for item in args.set:
        name, _, values = item.partition("=")
        if name not in sweep["knobs"]:
            parser.error(f"{args.sweep} has no knob {name!r}: "
                         f"{sorted(sweep['knobs'])}")
        knob_values[name] = [int(v) for v in values.split(",")]
    if args.first is not None and sweep["first"] is None:
        parser.error(f"{args.sweep} has no earlier version to compare")
    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: no CUDA device")
    sys.path.insert(0, str(REPO))
    from gigl_tpu_torch.ops import _build

    root = REPO / "build" / "sweep" / args.sweep
    started = {}
    for combo in itertools.product(*knob_values.values()):
        for b in args.min_blocks:
            knobs = dict(zip(knob_values, combo))
            if not knobs and not b:
                continue                                 # that is kept
            name = ",".join([f"{k}={v}" for k, v in knobs.items()]
                            + ([f"b{b}"] if b else []))
            edit_sources(root / name, _build.CSRC,
                         variant_edits(sweep, knobs, b))
            started[name] = start_build(root / name, sweep["sources"],
                                        _build)
    if args.first is not None:
        edit_sources(root / "first", args.first, {})
        started["first"] = start_build(root / "first", sweep["sources"],
                                       _build)
    libs = {"kept": _build.library()}     # the port's own, meanwhile
    logs = {"kept": _build.BUILD_DIR / "build.log"}
    first_lib = None
    for name, job in started.items():
        lib = finish_build(*job, _build)
        logs[name] = job[0] / "build.log"
        if name == "first":
            first_lib = load(lib, sweep["first"])
        else:
            libs[name] = load(lib, {fn: _build._SIGNATURES[fn]
                                    for fn in sweep["entries"]})
    for name, log in logs.items():
        for row in registers(log, sweep["sources"]):
            print(json.dumps({"phase": "registers", "variant": name, **row}),
                  flush=True)
    dev = torch.device("cuda", 0)

    def first(fn, *a):
        """The earlier version's entry ``fn`` on the current stream (a CUDA
        graph's capture stream inside cuda_ms)."""
        rc = getattr(first_lib, fn)(*a,
                                    torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"first {fn}: cudaError {rc}")

    cases = sweep["cases"](dev, _build, first if first_lib else None)
    errs, first_diffs = {}, {}
    for label, (fns, plain, *opts) in cases.items():
        tol = opts[0] if opts else 1e-5
        exact_first = opts[1] if len(opts) > 1 else sweep["bit_equal_first"]
        want = None if plain is None else plain()
        ref = fns["first"]() if "first" in fns else None
        for variant, lib in libs.items():
            _build._lib = lib
            for mode, fn in fns.items():
                if mode.startswith("first") and variant != "kept":
                    continue
                got = fn()
                if want is not None:
                    err = float((got.float() - want.float()).abs().max()
                                / want.float().abs().max())
                    errs[label] = max(errs.get(label, 0.0), err)
                    if not err <= tol:
                        raise RuntimeError(f"{variant} {mode} {label}: "
                                           f"{err} from the twin")
                if (ref is not None and not mode.startswith("first")
                        and mode != "library"):
                    diff = float((got.float() - ref.float()).abs().max()
                                 / ref.float().abs().max())
                    first_diffs[label] = max(first_diffs.get(label, 0.0),
                                             diff)
                    if exact_first and not torch.equal(got, ref):
                        raise RuntimeError(f"{variant} {mode} {label}: not "
                                           "bit-equal to first")
                if (want is not None and mode != "library"
                        and not torch.equal(got, fn())):
                    raise RuntimeError(f"{variant} {mode} {label}: a "
                                       "repeat run differs")
        del want, ref
    names = list(libs) + (["first"] if first_lib else [])
    turns = names + list(reversed(names))
    for rep in range(args.repeats):
        for turn, variant in enumerate(turns):
            if variant != "first":
                _build._lib = libs[variant]
            for label, (fns, *_) in cases.items():
                for mode, fn in fns.items():
                    if mode.startswith("first") != (variant == "first"):
                        continue
                    print(json.dumps({
                        "phase": f"{args.sweep}_sweep", "variant": variant,
                        "mode": mode, "repeat": rep, "turn": turn,
                        "case": label, "err": errs.get(label),
                        "first_rel_diff": first_diffs.get(label),
                        "ms": (eager_ms if mode.endswith("_eager")
                               else cuda_ms)(fn)}), flush=True)
    _build._lib = libs["kept"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
