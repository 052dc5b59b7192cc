"""Public smoothing API for linear-Gaussian models.

Counterpart of the linear-Gaussian parts of
``bssm_tpu/inference/smoothers.py``.  Each function takes a model (built at
``theta``, by default its initial value) or an ``LGSpec``; a spec with a
leading batch axis is smoothed row by row in one pass.  Non-Gaussian models,
which the JAX package smooths through their Gaussian approximation, wait.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.spec import LGSpec
from ..models.base import Model
from ..ops import kalman
from ..ops.simsmooth import simulate_states


def _spec_of(model_or_spec, theta=None) -> LGSpec:
    if isinstance(model_or_spec, Model):
        th = model_or_spec.theta_init if theta is None else theta
        spec = model_or_spec.build(torch.as_tensor(
            np.asarray(th), dtype=model_or_spec.dtype,
            device=model_or_spec.device))
    else:
        spec = model_or_spec
    if not isinstance(spec, LGSpec):
        raise NotImplementedError(
            "only linear-Gaussian models are smoothed so far")
    return spec


def fast_smoother(model_or_spec, theta=None) -> torch.Tensor:
    """Smoothed state means ``(B, n+1, m)``."""
    return kalman.fast_smoother(_spec_of(model_or_spec, theta))


def smoother(model_or_spec, theta=None) -> kalman.SmoothResult:
    """Smoothed means ``alphahat``, covariances ``Vt`` and lag-one
    cross-covariances ``ccov``, with the log-likelihood."""
    return kalman.smoother(_spec_of(model_or_spec, theta))


def sim_smoother(model_or_spec, nsim: int,
                 generator: Optional[torch.Generator] = None, seed: int = 1,
                 use_antithetic: bool = True, theta=None) -> torch.Tensor:
    """``nsim`` Durbin-Koopman simulation-smoother draws of one model's
    states, ``(nsim, n+1, m)``; without a ``generator`` one is seeded with
    ``seed`` on the model's device."""
    spec = _spec_of(model_or_spec, theta)
    if generator is None:
        generator = torch.Generator(device=spec.y.device).manual_seed(
            int(seed))
    return simulate_states(spec, nsim, generator, use_antithetic)
