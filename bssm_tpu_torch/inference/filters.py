"""Public filtering API: the Kalman filter, the bootstrap filter, the particle
smoother, and the nonlinear models' extended and unscented Kalman filters,
extended Kalman smoothers and extended Kalman particle filter.  An SDE
model takes the bootstrap filter (``inference/sde.py``) and nothing else
here: the JAX package's other filters fail on one, and the port's refuse
it with a ``ValueError`` (``refuse_sde``).

Counterpart of ``bssm_tpu/inference/filters.py``.  Every function takes a
model (built at ``theta``, by default its initial value) or a spec.  A model
is handed on as ONE unbatched model (a nonlinear one as a spec of one row of
theta), as the JAX package hands it to its functions, so its Gaussian
approximation is the single-model solve
(``inference/approx.laplace_solve_steps``, the ``laplace_step`` kernel on
the card); a spec passes as it is, so a batched spec is filtered row by row
in one pass.  Results keep a leading batch axis (of one for a model).  The
randomness of the particle filters comes from ``generator`` (default: one
seeded with ``seed`` on the model's device) or is injected as ``eps``/``us``
(see ``inference/particle``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.spec import LGSpec, MVLGSpec, MVNGSpec, NGSpec, drop_batch
from ..models.base import Model
from ..models.nlg import NLGSpec
from ..models.sde import SDESpec
from ..ops import kalman, kalman_mv
from ..ops.resample import ancestor_trace
from . import approx as approx_mod
from . import approx_mv as mv_mod
from . import nlg as nlg_mod
from . import particle as pf_mod
from . import sde as sde_mod


def theta_of(model: Model, theta=None) -> torch.Tensor:
    """``theta`` (array or tensor; default: the model's initial value) as a
    tensor on the model's device and dtype."""
    th = model.theta_init if theta is None else theta
    if not torch.is_tensor(th):
        th = np.asarray(th)
    return torch.as_tensor(th, dtype=model.dtype, device=model.device)


def spec_of(model_or_spec, theta=None):
    """The spec of a model at ``theta`` (default: its initial value), as one
    unbatched model; a spec is returned as it is."""
    if not isinstance(model_or_spec, Model):
        return model_or_spec
    th = theta_of(model_or_spec, theta)
    if th.dim() != 1:
        raise ValueError("theta must be one parameter vector (d,)")
    spec = model_or_spec.build(th)
    return spec if isinstance(spec, (NLGSpec, SDESpec)) else drop_batch(spec)


def refuse_sde(spec, what: str):
    """``spec``, or a ``ValueError`` for an SDE model, which ``what`` does
    not take (the JAX package fails on one there)."""
    if isinstance(spec, SDESpec):
        raise ValueError(f"{what}: not defined for an SDE model, which has "
                         "no Gaussian approximation; bootstrap_filter, "
                         "logLik and run_mcmc take one")
    return spec


def generator_for(spec, generator: Optional[torch.Generator], seed: int):
    if generator is not None:
        return generator
    return torch.Generator(device=spec.y.device).manual_seed(int(seed))


def kfilter(model_or_spec, theta=None):
    """Kalman filter (``kalman.FilterResult``, or for several series
    ``kalman_mv.MVFilterResult``); a non-Gaussian model is filtered through
    its Gaussian approximation."""
    spec = refuse_sde(spec_of(model_or_spec, theta), "kfilter")
    if isinstance(spec, NGSpec):
        spec = approx_mod.approximate(spec).gaussian(spec)
    elif isinstance(spec, MVNGSpec):
        spec = mv_mod.approximate_mv(spec).gaussian(spec)
    if isinstance(spec, MVLGSpec):
        return kalman_mv.kfilter_mv(spec)
    return kalman.kfilter(spec)


def bootstrap_filter(model_or_spec, particles: int,
                     generator: Optional[torch.Generator] = None,
                     seed: int = 1, theta=None, eps=None,
                     us=None, dBf=None) -> pf_mod.PFResult:
    """Bootstrap particle filter of a non-Gaussian (one or several series),
    univariate linear-Gaussian, nonlinear or SDE model, trajectories
    untraced (``ops/resample.ancestor_trace``).  An SDE model's filter runs
    at its fine level ``L_f`` (``sde.bsf_filter_sde``, an ``SDEPFResult``);
    its randomness is injected as ``dBf`` and ``us``, or drawn from seeds
    taken from the generator."""
    spec = spec_of(model_or_spec, theta)
    if isinstance(spec, SDESpec):
        return sde_mod.bsf_filter_sde(
            spec, particles, spec.L_f, dBf=dBf, us=us,
            generator=generator_for(spec, generator, seed))
    runs = {NGSpec: pf_mod.bsf_filter, MVNGSpec: mv_mod.bsf_filter_mv,
            LGSpec: pf_mod.bsf_filter_lg, NLGSpec: nlg_mod.bsf_filter_nlg}
    if type(spec) not in runs:
        raise TypeError(f"bootstrap_filter takes no {type(spec).__name__}")
    return runs[type(spec)](spec, particles,
                            generator_for(spec, generator, seed), eps=eps,
                            us=us)


class ParticleSmootherResult(NamedTuple):
    alphahat: torch.Tensor  # (B, n+1, m) weighted smoothed mean
    Vt: torch.Tensor        # (B, n+1, m, m)
    alpha: torch.Tensor     # (B, N, n+1, m) traced trajectories
    weights: torch.Tensor   # (B, N) final weights, normalised
    logLik: torch.Tensor    # (B,)


def particle_smoother(model_or_spec, particles: int, method: str = "psi",
                      generator: Optional[torch.Generator] = None,
                      seed: int = 1, theta=None, eps=None, us=None,
                      conv_tol: float = approx_mod.CONV_TOL,
                      max_iter: int = approx_mod.MAX_ITER
                      ) -> ParticleSmootherResult:
    """Filter-smoother state estimates by the psi-auxiliary
    (``method="psi"``) or the bootstrap (``"bsf"``) particle filter, or for
    a nonlinear model also the extended Kalman particle filter
    (``"ekf"``): the weighted mean and covariance of the traced
    trajectories.  A linear-Gaussian model takes the bootstrap filter
    whatever ``method`` is, as in the JAX package."""
    spec = refuse_sde(spec_of(model_or_spec, theta), "particle_smoother")
    gen = generator_for(spec, generator, seed)
    nlg = isinstance(spec, NLGSpec)
    if method not in (("psi", "bsf", "ekf") if nlg else ("psi", "bsf")):
        raise NotImplementedError(f"method={method!r}: 'psi' and 'bsf' are "
                                  "ported (and 'ekf' for nonlinear models)")
    if nlg:
        if method == "psi":
            pf = nlg_mod.psi_filter_nlg(spec, nlg_mod.approximate_nlg(spec),
                                        particles, gen, eps=eps, us=us)
        elif method == "ekf":
            pf = nlg_mod.ekpf_filter(spec, particles, gen, eps=eps, us=us)
        else:
            pf = nlg_mod.bsf_filter_nlg(spec, particles, gen, eps=eps, us=us)
    elif isinstance(spec, MVNGSpec):
        if method == "psi":
            al = mv_mod.approx_loglik_mv(spec, conv_tol=conv_tol,
                                         max_iter=max_iter)
            pf = mv_mod.psi_filter_mv(spec, al, particles, gen, eps=eps,
                                      us=us)
        else:
            pf = mv_mod.bsf_filter_mv(spec, particles, gen, eps=eps, us=us)
    elif not isinstance(spec, NGSpec):
        pf = pf_mod.bsf_filter_lg(spec, particles, gen, eps=eps, us=us)
    elif method == "psi":
        al = approx_mod.approx_loglik(spec, conv_tol=conv_tol,
                                      max_iter=max_iter)
        pf = pf_mod.psi_filter(spec, al, particles, gen, eps=eps, us=us)
    else:
        pf = pf_mod.bsf_filter(spec, particles, gen, eps=eps, us=us)
    traced = ancestor_trace(pf.alpha, pf.indices)
    w = pf.weights[..., -1]
    w = w / w.sum(-1, keepdim=True)
    mean = torch.einsum('bi,bitm->btm', w, traced)
    dev = traced - mean[:, None]
    Vt = torch.einsum('bi,bitm,bitk->btmk', w, dev, dev)
    return ParticleSmootherResult(mean, Vt, traced, w, pf.loglik)


# ---------------------------------------------------------------------------
# the nonlinear models' filters
# ---------------------------------------------------------------------------

def _nlg_spec(model_or_spec, theta, iekf_iter: int = 0) -> NLGSpec:
    spec = refuse_sde(spec_of(model_or_spec, theta),
                      "the extended / unscented Kalman API")
    if not isinstance(spec, NLGSpec):
        raise TypeError(f"a nonlinear model is needed, got "
                        f"{type(spec).__name__}")
    return dataclasses.replace(spec, iekf_iter=int(iekf_iter)) \
        if iekf_iter else spec


def ekf(model_or_spec, theta=None, iekf_iter: int = 0) -> nlg_mod.EKFResult:
    """(Iterated, with ``iekf_iter`` > 0) extended Kalman filter of a
    nonlinear model."""
    return nlg_mod.ekf(_nlg_spec(model_or_spec, theta, iekf_iter))


def ukf(model_or_spec, theta=None, alpha: float = 1.0, beta: float = 0.0,
        kappa: float = 2.0) -> nlg_mod.EKFResult:
    """Unscented Kalman filter of a nonlinear model."""
    return nlg_mod.ukf(_nlg_spec(model_or_spec, theta), alpha, beta, kappa)


def ekf_smoother(model_or_spec, theta=None,
                 iekf_iter: int = 0) -> kalman_mv.MVSmoothResult:
    """Extended Kalman smoother of a nonlinear model."""
    return nlg_mod.ekf_smoother(_nlg_spec(model_or_spec, theta, iekf_iter))


def ekf_fast_smoother(model_or_spec, theta=None,
                      iekf_iter: int = 0) -> torch.Tensor:
    """Means-only extended Kalman smoother, ``(B, n+1, m)``."""
    return nlg_mod.ekf_fast_smoother(
        _nlg_spec(model_or_spec, theta, iekf_iter))


def ekpf_filter(model_or_spec, particles: int,
                generator: Optional[torch.Generator] = None, seed: int = 1,
                theta=None, eps=None, us=None) -> pf_mod.PFResult:
    """Extended Kalman particle filter of a nonlinear model, trajectories
    untraced."""
    spec = _nlg_spec(model_or_spec, theta)
    return nlg_mod.ekpf_filter(spec, particles,
                               generator_for(spec, generator, seed), eps=eps,
                               us=us)
