"""Device selection for the port's entry points.

The port is written for the card: an entry point given ``device=None``
runs on CUDA and raises when there is none. It never drops quietly to the
CPU — the CPU (the plain PyTorch versions of the kernels) is only used when
the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without CUDA); anything
    else -> that device, with the CUDA index made explicit."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gigl_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
