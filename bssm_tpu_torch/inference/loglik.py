"""Log-likelihood API for linear-Gaussian models.

Counterpart of the linear-Gaussian part of ``bssm_tpu/inference/loglik.py``.
The exact log-likelihood goes through ``ops/cuda_kalman.log_likelihood``:
the Kalman log-likelihood kernel on the GPU, its plain version on the CPU,
with the kernel wrapper's degenerate-model rule (see
``ops/kalman.degenerate_h2rr``) on both.  Non-Gaussian models wait.
"""
from __future__ import annotations

import torch

from ..ops import cuda_kalman
from .smoothers import _spec_of


def logLik(model_or_spec, particles: int = 0, theta=None) -> torch.Tensor:
    """Exact log-likelihood ``(B,)`` of a linear-Gaussian model (built at
    ``theta``, by default its initial value) or spec.  ``particles`` must
    be 0: a linear-Gaussian likelihood needs no particle filter."""
    if particles:
        raise NotImplementedError(
            "particle estimates of the likelihood are not ported")
    return cuda_kalman.log_likelihood(_spec_of(model_or_spec, theta))
