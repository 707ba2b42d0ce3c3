"""gigl_tpu_torch — the PyTorch + CUDA (Hopper) port of gigl_tpu.

The JAX package ``gigl_tpu`` is the reference; this package mirrors its
layout module by module and imports nothing of it (nor JAX). Device work on
the sampled-inference path runs through hand-written CUDA kernels in
``csrc/`` (built with nvcc at first use, loaded with ctypes); each kernel has
a plain PyTorch twin in the same module that runs only for CPU tensors.

Entry points (``DeviceGraph.from_hetero``, ``NALPTrainer``,
``run_inference``) run on CUDA unless the caller passes ``device="cpu"``.
"""

from gigl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
