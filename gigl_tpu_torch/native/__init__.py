"""ctypes binding of the port's host engine (``src/gigl_native.cpp``): the
threaded feature gather (fp32 rows, or their bf16 bits written in the same
pass), the host fanout sampler and the fused tree-level
expansion with its gather (a copy of the needed part of
``gigl_tpu/native/__init__.py``).

The library is built by ``g++`` at first use into ``build/native/`` at the
root of the checkout, beside the CUDA kernels' library, and rebuilt when
the source changes. A failed build raises: the streamed trainer has no
numpy fallback (``training/streaming.py`` keeps the numpy mirrors as the
plain versions the tests hold the engine against). Every function takes
and returns numpy arrays; ``out`` buffers (e.g. numpy views of pinned host
tensors) are written in place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "gigl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libgigl_native.so"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread"]
THREADS = max(1, (os.cpu_count() or 2) - 1)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the engine with g++ unless the library on disk was built
    from the same source and flags; raises when the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = hashlib.sha256(" ".join(FLAGS).encode()
                            + SRC.read_bytes()).hexdigest()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {LIB_NAME} with g++ failed:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def load(path) -> ctypes.CDLL:
    """An engine library at ``path`` with its entry points declared."""
    lib = ctypes.CDLL(str(path))
    i64, i32, u32, vp = (ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32,
                         ctypes.c_void_p)
    for name, args in (
            ("gigl_gather_f32", [vp, i64, i64, vp, i64, vp, ctypes.c_int,
                                 ctypes.c_int]),
            ("gigl_sample_fanout", [vp, vp, i64, i64, vp, i64, i32, u32,
                                    u32, vp, vp, vp, ctypes.c_int]),
            ("gigl_expand_gather", [vp, vp, i64, vp, vp, i64, i64, vp, i64,
                                    vp, i64, vp, vp, vp, vp, vp, vp,
                                    ctypes.c_int, ctypes.c_int])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i64
    return lib


def library() -> ctypes.CDLL:
    """The loaded engine (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _rows_f32(table: np.ndarray) -> np.ndarray:
    """A C-contiguous float32 [N, D] view (no copy for such a table, an
    np.memmap included)."""
    table = np.ascontiguousarray(table, np.float32)
    if table.ndim != 2:
        raise ValueError("expected an [N, D] float32 table")
    return table


def _out(out: Optional[np.ndarray], shape, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if out.shape != tuple(shape) or out.dtype != np.dtype(dtype) \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous {np.dtype(dtype)} "
                         f"{tuple(shape)}, got {out.dtype} {out.shape}")
    return out


def gather_f32(table: np.ndarray, idx: np.ndarray,
               out: Optional[np.ndarray] = None,
               bf16: bool = False) -> np.ndarray:
    """``table[idx]`` for an [N, D] float32 table (RAM or np.memmap) ->
    idx.shape + (D,); raises IndexError for an index out of range.
    ``out``: a C-contiguous buffer of that shape to write instead (e.g. a
    numpy view of a pinned host tensor). ``bf16``: the rows written as
    bfloat16 bits (``uint16``, round to nearest even: ``utils/cast.py``
    ``to_bfloat16``'s bits) in the gather's own pass."""
    table = _rows_f32(table)
    idx = np.ascontiguousarray(idx, np.int64)
    n, d = table.shape
    res = _out(out, idx.shape + (d,), np.uint16 if bf16 else np.float32)
    rc = library().gigl_gather_f32(_ptr(table), n, d, _ptr(idx), idx.size,
                                   _ptr(res), int(bf16), THREADS)
    if rc != 0:
        raise IndexError(f"gather index out of range at flat position "
                         f"{-rc - 1}")
    return res


def sample_fanout(indptr: np.ndarray, indices: np.ndarray, roots: np.ndarray,
                  fanout: int, *, seed: int, hop: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Uniform fanout draws of ``roots`` over a CSR, bit-equal to the
    device sampler's (K1): (nbr int32, mask bool, CSR slots int64), each
    [R, fanout]; raises IndexError for a root out of range."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    roots = np.ascontiguousarray(roots, np.int32).reshape(-1)
    r = roots.shape[0]
    nbr = np.empty((r, fanout), np.int32)
    mask = np.empty((r, fanout), np.bool_)
    slots = np.empty((r, fanout), np.int64)
    rc = library().gigl_sample_fanout(
        _ptr(indptr), _ptr(indices), len(indptr) - 1, len(indices),
        _ptr(roots), r, fanout, seed & 0xFFFFFFFF, hop & 0xFFFFFFFF,
        _ptr(nbr), _ptr(mask), _ptr(slots), THREADS)
    if rc != 0:
        raise IndexError(f"root id out of range at position {-rc - 1}")
    return nbr, mask, slots


def expand_gather(frontier: np.ndarray, parent_mask: Optional[np.ndarray],
                  ids_table: Optional[np.ndarray],
                  mask_table: Optional[np.ndarray], feats: np.ndarray,
                  agg: np.ndarray, degrees: np.ndarray,
                  out: Optional[Sequence[Optional[np.ndarray]]] = None,
                  bf16: bool = False) -> Tuple[np.ndarray, ...]:
    """One tree level in one engine call: expand ``frontier`` through the
    frozen sample table (``ids_table`` [N, K] int32, ``mask_table`` [N, K]
    bool) and gather every child's feature row, hop-cache aggregate row
    and degree. With ``ids_table=None`` the root level: the frontier's own
    rows (its ids and a mask of ones returned). Returns (ids, mask,
    feats, agg, degs), the children shaped frontier.shape + (K,) (+ the
    row width). ``out``: (ids, mask, feats, agg, degs) buffers to write
    instead (ids and mask unused at the root level). ``bf16``: the feature
    and aggregate rows written as bfloat16 bits (``uint16``, round to
    nearest even: ``utils/cast.py`` ``to_bfloat16``'s bits) in the same
    pass. Raises ValueError for an id out of range."""
    feats, agg = _rows_f32(feats), _rows_f32(agg)
    degrees = np.ascontiguousarray(degrees, np.float32)
    n, df = feats.shape
    da = agg.shape[1]
    if agg.shape[0] != n or degrees.shape != (n,):
        raise ValueError(f"expand_gather: agg {agg.shape} and degrees "
                         f"{degrees.shape} must have the features' {n} rows")
    frontier = np.ascontiguousarray(frontier, np.int32)
    shape = frontier.shape
    m = frontier.size
    pm = (np.ones(m, np.bool_) if parent_mask is None else
          np.ascontiguousarray(parent_mask, np.bool_).reshape(-1))
    o_ids, o_mask, o_f, o_a, o_d = out if out is not None else (None,) * 5
    rows = np.uint16 if bf16 else np.float32
    if ids_table is None:
        res_f = _out(o_f, shape + (df,), rows)
        res_a = _out(o_a, shape + (da,), rows)
        res_d = _out(o_d, shape, np.float32)
        rc = library().gigl_expand_gather(
            _ptr(frontier), _ptr(pm), m, None, None, n, 0, _ptr(feats), df,
            _ptr(agg), da, _ptr(degrees), None, None, _ptr(res_f),
            _ptr(res_a), _ptr(res_d), int(bf16), THREADS)
        if rc != 0:
            raise ValueError("expand_gather: node id out of range")
        return frontier, pm.reshape(shape), res_f, res_a, res_d
    ids_table = np.ascontiguousarray(ids_table, np.int32)
    mask_table = np.ascontiguousarray(mask_table, np.bool_)
    if ids_table.shape[0] != n or mask_table.shape != ids_table.shape:
        raise ValueError(f"expand_gather: the sample tables {ids_table.shape}"
                         f" must have the features' {n} rows")
    k = ids_table.shape[1]
    cs = shape + (k,)
    res_i = _out(o_ids, cs, np.int32)
    res_m = _out(o_mask, cs, np.bool_)
    res_f = _out(o_f, cs + (df,), rows)
    res_a = _out(o_a, cs + (da,), rows)
    res_d = _out(o_d, cs, np.float32)
    rc = library().gigl_expand_gather(
        _ptr(frontier), _ptr(pm), m, _ptr(ids_table), _ptr(mask_table), n, k,
        _ptr(feats), df, _ptr(agg), da, _ptr(degrees), _ptr(res_i),
        _ptr(res_m), _ptr(res_f), _ptr(res_a), _ptr(res_d), int(bf16),
        THREADS)
    if rc != 0:
        raise ValueError("expand_gather: node id out of range")
    return res_i, res_m, res_f, res_a, res_d
