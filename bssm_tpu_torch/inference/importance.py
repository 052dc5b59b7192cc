"""SPDK importance sampling of one non-Gaussian model.

Counterpart of ``bssm_tpu/inference/importance.py``: ``nsim`` draws of the
states from the smoothing law of the model's Gaussian approximation, by
the simulation smoother (``ops/simsmooth.simulate_states_batched``, the
``fast_smoother_ll`` kernel on the card; for several series
``kalman_mv.simulate_states_mv``), with their importance weights.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.spec import MVNGSpec, NGSpec
from . import approx as approx_mod
from . import approx_mv as mv_mod
from .filters import generator_for, refuse_sde, spec_of
from .particle import spdk_sample


class ImportanceSample(NamedTuple):
    alpha: torch.Tensor     # (nsim, n+1, m) smoother draws
    weights: torch.Tensor   # (nsim,) normalised importance weights
    loglik: torch.Tensor    # () log-likelihood estimate


def importance_sample(model_or_spec, nsim: int,
                      generator: Optional[torch.Generator] = None,
                      seed: int = 1, use_antithetic: bool = True,
                      theta=None) -> ImportanceSample:
    """SPDK draws of a model (built at ``theta``, by default its initial
    value, as one model) or of a one-model spec, their normalised weights
    and the log-likelihood estimate.  The approximation is the single-model
    Laplace solve; the randomness comes from ``generator`` (default: one
    seeded with ``seed`` on the model's device)."""
    spec = refuse_sde(spec_of(model_or_spec, theta), "importance_sample")
    if not isinstance(spec, (NGSpec, MVNGSpec)):
        raise TypeError("importance_sample requires a non-Gaussian model")
    if (spec.batch or 1) != 1:
        raise ValueError("importance_sample takes one model")
    gen = generator_for(spec, generator, seed)
    if isinstance(spec, MVNGSpec):
        r = mv_mod.spdk_sample_mv(spec, mv_mod.approx_loglik_mv(spec),
                                  int(nsim), gen, use_antithetic)
    else:
        r = spdk_sample(spec, approx_mod.approx_loglik(spec), int(nsim), gen,
                        use_antithetic)
    return ImportanceSample(r.alpha[0], r.weights[0], r.loglik[0])
