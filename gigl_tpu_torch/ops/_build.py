"""Build and load the port's CUDA kernels (nvcc + ctypes).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper); the objects are linked into one
shared library, ``build/kernels/libgigl_tpu_torch.so`` at the root of the
checkout, and loaded with ``ctypes``. The sources expose a plain C
interface (no PyTorch headers), so a full build takes seconds. The build
happens at the first kernel launch, and again whenever a hash of the
sources and flags changes.

Each C entry point enqueues its kernel on the stream it is given (the
current PyTorch stream; K15's entry enqueues a count launch and a write
launch), never synchronises, allocates
nothing, and returns ``cudaGetLastError()``; :func:`launch` raises when
that is not 0 and counts the call under the kernel's name in
:data:`launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
LIB_NAME = "libgigl_tpu_torch.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]

# Kernel name -> number of launches since the last reset_launches().
# retrieval_loss and ring_retrieval count their forward and their backward
# entry point, ring_spmm its forward and its transposed launches;
# segment_reduce_bwd its max mode's tie pass;
# route_requests counts one a call, however many request vectors it takes;
# gather_rows_q8 one a launch, however many gathers (segments) it takes.
KERNEL_NAMES = ("sample_uniform", "uniform_ids", "build_neighbor_cache",
                "gather_rows", "masked_reduce", "masked_reduce_bwd",
                "retrieval_loss", "ell_aggregate", "fanout_attention",
                "ell_transpose_aggregate", "fanout_attention_bwd",
                "segment_reduce", "segment_softmax", "sddmm",
                "segment_reduce_bwd", "segment_softmax_bwd", "sddmm_bwd",
                "ell_edge_grad", "gather_rows_q8", "cms_add", "cms_estimate",
                "route_requests", "unroute_rows", "ring_retrieval",
                "ring_spmm", "sample_weighted")
# Beside them, the launches of a kernel's mode that the paths' checks
# count, by ops/segment.py's gather_mode: K8's launches with a gather
# (composed: the destination index's gathered rows; chained: its order,
# then src) and K8b's over a source walk (composed: the source index's
# gathered destinations; chained: its order, then the segment ids); and
# the COO per-edge terms' modes: K8 with edge rows (add, gine) and its
# GATv2 destination walk, K8b's gine gate and GATv2 source walk, K10 with
# the key addend and its GATv2 scores, K11's COO form; K17's own-block
# bias mode (fold and backward); GATv2 with edge rows: K10's gatv2 mode
# with the edge row, K8's destination walk with it, K11's gatv2 mode (ELL
# and COO), and the per-edge table summed into the source rows (K8b over
# the source walk, K6b over EllGraph.t_edge).
MODE_NAMES = ("segment_reduce_composed", "segment_reduce_chained",
              "segment_reduce_bwd_composed", "segment_reduce_bwd_chained",
              "segment_reduce_add", "segment_reduce_gine",
              "segment_reduce_gatv2", "segment_reduce_bwd_gine",
              "segment_reduce_bwd_gatv2", "sddmm_addend", "sddmm_gatv2",
              "ell_edge_grad_coo", "gather_rows_bytes", "unroute_rows_q8",
              "gather_rows_q8_packed", "ring_retrieval_bias",
              "sddmm_gatv2_edge", "segment_reduce_gatv2_edge",
              "ell_edge_grad_gatv2", "segment_reduce_bwd_edge_rows",
              "ell_transpose_edge_rows")
launches: Dict[str, int] = dict.fromkeys(KERNEL_NAMES + MODE_NAMES, 0)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
# C entry point -> argument types (the trailing pointer is the stream).
_SIGNATURES = {
    "gigl_sample_uniform": [_P, _P, _I64, _P, _I64, _I32, _U32, _U32,
                            _I32, _I32, _I64, _P, _P, _P, _P],
    "gigl_uniform_ids": [_I64, _U32, _U32, _U32, _P, _P],
    "gigl_sample_weighted": [_P, _P, _I64, _P, _I64, _P, _I64, _I32, _I32,
                             _I32, _U32, _U32, _I32, _I32, _I64, _P, _P, _P,
                             _P],
    "gigl_build_neighbor_cache": [_P, _P, _I64, _I64, _P, _P, _I32, _P, _P,
                                  _I64, _I32, _I32, _U32, _U32, _I32, _P,
                                  _I64, _P],
    "gigl_gather_rows": [_P, _I64, _I64, _I32, _P, _I64, _P, _P, _P, _P,
                         _P, _P],
    "gigl_gather_rows_bytes": [_P, _I64, _I64, _I32, _P, _I64, _P, _P],
    "gigl_masked_reduce": [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
    "gigl_masked_reduce_bwd": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                               _I32, _P],
    "gigl_retrieval_loss_fwd": [_P, _I64, _I64, _I32, _P, _P, _P, _P, _P,
                                _F32, _F32, _I32, _I32, _P, _P, _P, _P, _P],
    "gigl_retrieval_loss_bwd": [_P, _I64, _I64, _I32, _P, _P, _P, _P, _P,
                                _F32, _F32, _I32, _I32, _P, _P, _P, _P],
    "gigl_retrieval_loss_ticket": [_P, _P],
    "gigl_ell_aggregate": [_P] * 7 + [_I32, _I64] + [_I32] * 5 + [_P],
    "gigl_fanout_attention": [_P] * 12 + [_I64] + [_I32] * 5
    + [_F32, _F32, _P],
    "gigl_ell_transpose_aggregate": [_P] * 14 + [_I64] + [_I32] * 7
    + [_F32, _P],
    "gigl_ell_tie_count": [_P] * 5 + [_I64] + [_I32] * 4 + [_P],
    "gigl_fanout_attention_bwd": [_P] * 20 + [_I64] + [_I32] * 5
    + [_F32, _F32, _I32, _P],
    "gigl_segment_reduce": [_P] * 7 + [_I64] + [_I32] * 6
    + [_P, _I32, _P, _P, _F32, _P, _P, _I64, _P],
    "gigl_segment_softmax": [_P] * 4 + [_I64] + [_I32] * 4 + [_P],
    "gigl_sddmm": [_P] * 8 + [_I64, _I64] + [_I32] * 4 + [_P] * 3
    + [_F32, _I32, _P],
    "gigl_segment_reduce_bwd": [_P] * 11 + [_I64] + [_I32] * 7 + [_P] * 2
    + [_F32, _P],
    "gigl_segment_max_ties": [_P] * 8 + [_I64] + [_I32] * 5 + [_P],
    "gigl_segment_softmax_bwd": [_P] * 5 + [_I64] + [_I32] * 4 + [_P],
    "gigl_sddmm_bwd": [_P] * 6 + [_I64] + [_I32] * 3 + [_P],
    "gigl_sddmm_bwd_ticket": [_P, _P],
    "gigl_ell_edge_grad": [_P] * 12 + [_I64] + [_I32] * 6
    + [_P, _I64, _F32, _P],
    "gigl_gather_rows_q8_many": [_P, _I32, _P],
    "gigl_gather_packed_q8": [_P, _I64, _I32, _I32, _I32, _P, _I64, _P, _P,
                              _P, _P],
    "gigl_cms_add": [_P, _I32, _I32, _P, _I64, _P, _P, _P, _P],
    "gigl_cms_estimate": [_P, _I32, _I32, _P, _I64, _P, _P, _P, _P],
    "gigl_route_requests": [_P, _I64, _I64, _I32, _I32, _I32] + [_P] * 6,
    "gigl_route_tiles": [_I64],
    "gigl_unroute_rows": [_P, _I32, _I32, _I32, _P, _P, _P, _I64, _P, _P],
    "gigl_unroute_rows_q8": [_P, _I32, _I32, _I32, _I32, _P, _P, _P, _I64,
                             _P, _P, _P, _P],
    "gigl_ring_fold": [_P, _I32, _I32, _I32] + [_P] * 7 + [_F32, _F32]
    + [_P] * 4,
    "gigl_ring_block_bwd": [_P, _I32, _I32, _I32] + [_P] * 7 + [_F32, _F32]
    + [_P] * 4,
    "gigl_ring_fold_bias": [_P, _I32, _I32, _I32] + [_P] * 7 + [_F32, _F32]
    + [_P, _P, _I32, _I32, _I32] + [_P] * 4,
    "gigl_ring_block_bwd_bias": [_P, _I32, _I32, _I32] + [_P] * 7
    + [_F32, _F32] + [_P, _P, _I32, _I32, _I32] + [_P] * 6,
    "gigl_ring_spmm": [_P] * 5 + [_I32] * 3 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); the port's "
            "CUDA kernels are built from gigl_tpu_torch/csrc at first use")
    return str(path)


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile every csrc/*.cu in parallel and link the shared library;
    skipped when the library on disk was built from the same sources."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _source_hash()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-o", str(obj), str(src)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp_lib = work / LIB_NAME
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp_lib, lib_path)
    stamp.write_text(digest)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, fn: str, device: torch.device, *args) -> None:
    """Enqueue C entry ``fn`` on ``device``'s current stream (with that
    device current); raise if the launch was refused; count it under
    ``kernel``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(library(), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: cudaError {rc}")
    launches[kernel] += 1


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor is contiguous and on one CUDA device;
    return that device."""
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    return device
