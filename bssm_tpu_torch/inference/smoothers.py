"""Public smoothing API.

Counterpart of ``bssm_tpu/inference/smoothers.py``.
Each function takes a model (built at ``theta``, by default its initial
value, and handed on as one unbatched model) or a spec; a spec with a
leading batch axis is smoothed row by row in one pass.  A non-Gaussian model
is smoothed through its Gaussian approximation (``_to_gaussian``: the
single-model Laplace solve for one model, the ``laplace_solve`` kernel for a
batched spec; for several series ``approx_mv.approximate_mv``), and several
series through ``ops/kalman_mv``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.spec import MVLGSpec, MVNGSpec, NGSpec
from ..ops import kalman, kalman_mv
from ..ops.simsmooth import simulate_states
from . import approx as approx_mod
from . import approx_mv as mv_mod
from .filters import generator_for, refuse_sde, spec_of


def _to_gaussian(spec):
    refuse_sde(spec, "the smoothers")
    if isinstance(spec, NGSpec):
        return approx_mod.approximate(spec).gaussian(spec)
    if isinstance(spec, MVNGSpec):
        return mv_mod.approximate_mv(spec).gaussian(spec)
    return spec


def fast_smoother(model_or_spec, theta=None) -> torch.Tensor:
    """Smoothed state means ``(B, n+1, m)``."""
    spec = _to_gaussian(spec_of(model_or_spec, theta))
    if isinstance(spec, MVLGSpec):
        return kalman_mv.fast_smoother_mv(spec)
    return kalman.fast_smoother(spec)


def smoother(model_or_spec, theta=None):
    """Smoothed means ``alphahat``, covariances ``Vt`` and lag-one
    cross-covariances ``ccov``, with the log-likelihood."""
    spec = _to_gaussian(spec_of(model_or_spec, theta))
    if isinstance(spec, MVLGSpec):
        return kalman_mv.smoother_mv(spec)
    return kalman.smoother(spec)


def sim_smoother(model_or_spec, nsim: int,
                 generator: Optional[torch.Generator] = None, seed: int = 1,
                 use_antithetic: bool = True, theta=None) -> torch.Tensor:
    """``nsim`` Durbin-Koopman simulation-smoother draws of one model's
    states, ``(nsim, n+1, m)``; without a ``generator`` one is seeded with
    ``seed`` on the model's device."""
    spec = _to_gaussian(spec_of(model_or_spec, theta))
    gen = generator_for(spec, generator, seed)
    if isinstance(spec, MVLGSpec):
        if (spec.batch or 1) != 1:
            raise ValueError("sim_smoother draws for one model")
        return kalman_mv.simulate_states_mv(spec, nsim, gen,
                                            use_antithetic)[0]
    return simulate_states(spec, nsim, gen, use_antithetic)
