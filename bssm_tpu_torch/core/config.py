"""Default device and dtype of the PyTorch/CUDA package, and the
time-parallel switch.

The entry points run on the GPU unless the caller asks for the CPU: a
``device`` argument of ``None`` means ``"cuda"``, and when no CUDA device is
present the call raises instead of moving the work to the CPU on its own.
There is no switch between the hand-written kernels and their plain
versions: a tensor on a CUDA device goes through the kernel, a tensor on the
CPU through the plain version (see ``ops/cuda_kalman.py``).

``time_parallel``: the Laplace mode iteration of univariate non-Gaussian
models (``inference/approx.approximate``) and its Gaussian log-likelihood
run through the associative-scan Kalman filter and smoother
(``ops/pkalman.py``), O(log n) depth in place of the serial chain over
time, as in the JAX package.  Read at every call; ``parallel_time()`` sets
it for a block.
"""
from __future__ import annotations

import contextlib

import torch

DEFAULT_DTYPE = torch.float32

time_parallel: bool = False


def set_time_parallel(value: bool) -> None:
    global time_parallel
    time_parallel = bool(value)


@contextlib.contextmanager
def parallel_time(value: bool = True):
    """``time_parallel`` set to ``value`` inside the block, the old value
    restored after it, also when the block raises."""
    global time_parallel
    old = time_parallel
    time_parallel = bool(value)
    try:
        yield
    finally:
        time_parallel = old


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
