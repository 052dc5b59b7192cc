"""Public smoothing API.

Counterpart of ``bssm_tpu/inference/smoothers.py`` for univariate models.
Each function takes a model (built at ``theta``, by default its initial
value, and handed on as one unbatched model) or a spec; a spec with a
leading batch axis is smoothed row by row in one pass.  A non-Gaussian model
is smoothed through its Gaussian approximation (``_to_gaussian``: the
single-model Laplace solve for one model, the ``laplace_solve`` kernel for a
batched spec).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.spec import NGSpec
from ..ops import kalman
from ..ops.simsmooth import simulate_states
from . import approx as approx_mod
from .filters import generator_for, spec_of


def _to_gaussian(spec):
    if isinstance(spec, NGSpec):
        return approx_mod.approximate(spec).gaussian(spec)
    return spec


def fast_smoother(model_or_spec, theta=None) -> torch.Tensor:
    """Smoothed state means ``(B, n+1, m)``."""
    return kalman.fast_smoother(_to_gaussian(spec_of(model_or_spec, theta)))


def smoother(model_or_spec, theta=None) -> kalman.SmoothResult:
    """Smoothed means ``alphahat``, covariances ``Vt`` and lag-one
    cross-covariances ``ccov``, with the log-likelihood."""
    return kalman.smoother(_to_gaussian(spec_of(model_or_spec, theta)))


def sim_smoother(model_or_spec, nsim: int,
                 generator: Optional[torch.Generator] = None, seed: int = 1,
                 use_antithetic: bool = True, theta=None) -> torch.Tensor:
    """``nsim`` Durbin-Koopman simulation-smoother draws of one model's
    states, ``(nsim, n+1, m)``; without a ``generator`` one is seeded with
    ``seed`` on the model's device."""
    spec = _to_gaussian(spec_of(model_or_spec, theta))
    return simulate_states(spec, nsim, generator_for(spec, generator, seed),
                           use_antithetic)
