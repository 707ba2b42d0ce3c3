"""What the kernel sweeps (attention_depth_sweep.py, segment_walk_sweep.py)
share: a copy of the port's CUDA sources with some constants replaced,
built as the port builds them (one nvcc per source, all started together,
then linked), and the device time of one call on the card."""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch


def start_variant(out: Path, csrc: Path, sources, edits, _build):
    """Copy ``csrc`` to ``out`` (replacing it), apply ``edits`` ({file name:
    [(pattern, replacement), ...]}, each pattern matching exactly once) and
    start one nvcc per source matching the globs ``sources``, with the
    port's compile flags; finish_variant links them."""
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
    procs = []
    for src in sorted({p for g in sources for p in out.glob(g)}):
        obj = src.with_suffix(".o")
        procs.append((obj, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, "-I", str(out), "-o",
             str(obj), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return out, procs


def finish_variant(out: Path, procs, _build) -> Path:
    """Wait for a variant's compiles and link its library; its path."""
    for obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{log}")
    lib = out / "libsweep.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                    str(lib), *[str(o) for o, _ in procs]], check=True)
    return lib


def load(path: Path, signatures) -> ctypes.CDLL:
    """The library at ``path`` with the entry points of ``signatures``
    ({name: argtypes}) declared, each returning an int."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        f = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


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


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
