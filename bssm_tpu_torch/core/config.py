"""Default device and dtype of the PyTorch/CUDA package.

The entry points run on the GPU unless the caller asks for the CPU: a
``device`` argument of ``None`` means ``"cuda"``, and when no CUDA device is
present the call raises instead of moving the work to the CPU on its own.
There is no switch between the hand-written kernels and their plain
versions: a tensor on a CUDA device goes through the kernel, a tensor on the
CPU through the plain version (see ``ops/cuda_kalman.py``).
"""
from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when that is absent.
    An explicit ``"cpu"`` is honoured (the CPU tests pass it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bssm_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU.")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available.")
    if device.type == "cuda" and device.index is None:
        # "cuda" and "cuda:0" must compare equal downstream
        device = torch.device("cuda", torch.cuda.current_device())
    return device
