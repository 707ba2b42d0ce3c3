"""Vectorized host-side casts for the streamed data paths (a copy of
``gigl_tpu/utils/cast.py``).

bfloat16 is the upper 16 bits of an IEEE float32 rounded to nearest even,
so the cast is three vector operations on the uint32 view, bit-equal to
the reference's. The port keeps bf16 on the host as its ``uint16`` bit
patterns (no ``ml_dtypes``): a pinned ``uint16`` buffer is copied to the
card as it is and viewed there as ``torch.bfloat16``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def to_bfloat16(x: np.ndarray, out: Optional[np.ndarray] = None
                ) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (``uint16``), round to nearest
    even, NaNs quieted; written into ``out`` when given."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    lsb = (u >> np.uint32(16)) & np.uint32(1)
    with np.errstate(over="ignore"):
        bits = ((u + np.uint32(0x7FFF) + lsb) >> np.uint32(16)).astype(
            np.uint16)
    # NaN payloads must not carry into the exponent: quiet them.
    nan = np.isnan(x)
    if nan.any():
        bits = np.where(nan, np.uint16(0x7FC0), bits)
    bits = bits.reshape(x.shape)
    if out is None:
        return bits
    out[...] = bits
    return out


def stream_cast_from_str(name: Optional[str]
                         ) -> Tuple[torch.dtype, np.dtype,
                                    Callable[..., np.ndarray]]:
    """A stream dtype name -> (the type on the card, the host buffer's
    numpy type, the host cast ``f(x_f32, out=None)``): ``float32`` (or
    None, ``f32``) streams fp32 as it is; ``bfloat16`` / ``bf16`` streams
    the bit patterns of :func:`to_bfloat16`."""
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16, np.dtype(np.uint16), to_bfloat16
    if name in (None, "float32", "f32"):
        def same(x, out=None):
            x = np.ascontiguousarray(x, np.float32)
            if out is None:
                return x
            out[...] = x
            return out
        return torch.float32, np.dtype(np.float32), same
    raise ValueError(f"unknown stream dtype {name!r}")
