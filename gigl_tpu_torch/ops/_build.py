"""Build and load the port's CUDA kernels (nvcc + ctypes).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper); the objects are linked into one
shared library, ``build/kernels/libgigl_tpu_torch.so`` at the root of the
checkout, and loaded with ``ctypes``. The sources expose a plain C
interface (no PyTorch headers), so a full build takes seconds. The build
happens at the first kernel launch, and again whenever a hash of the
sources and flags changes.

Each C entry point enqueues one kernel on the stream it is given (the
current PyTorch stream), never synchronises, allocates nothing, and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0 and counts
the launch under the kernel's name in :data:`launches`.
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
KERNEL_NAMES = ("sample_uniform", "build_neighbor_cache", "gather_rows",
                "masked_reduce")
launches: Dict[str, int] = dict.fromkeys(KERNEL_NAMES, 0)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
# C entry point -> argument types (the trailing pointer is the stream).
_SIGNATURES = {
    "gigl_sample_uniform": [_P, _P, _I64, _P, _I64, _I32, _U32, _U32,
                            _P, _P, _P, _P],
    "gigl_build_neighbor_cache": [_P, _P, _I64, _I64, _P, _I32, _P, _I32,
                                  _U32, _U32, _I32, _P, _I64, _P],
    "gigl_gather_rows": [_P, _I64, _I64, _I32, _P, _I64, _P, _P, _P, _P,
                         _P, _P],
    "gigl_masked_reduce": [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def reset_launches() -> None:
    for name in KERNEL_NAMES:
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
