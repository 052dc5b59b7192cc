"""Log-likelihood API.

Counterpart of ``bssm_tpu/inference/loglik.py``.  A univariate
linear-Gaussian model's exact log-likelihood goes through
``ops/cuda_kalman.log_likelihood`` (the Kalman log-likelihood kernel on the
GPU, its plain version on the CPU and for models the kernel does not take,
with the kernel wrapper's degenerate-model rule,
``ops/kalman.degenerate_h2rr``, on both), whatever ``particles`` is; a
multivariate one's through ``ops/kalman_mv``.  A non-Gaussian model's is the
approximate log-likelihood of its Laplace approximation (``particles=0``) or
an importance-sampling estimate: the psi-auxiliary filter
(``method="psi"``), the bootstrap filter (``"bsf"``) or SPDK draws from the
approximating model (``"spdk"``, antithetic).  A nonlinear model's is the
mode approximation's (``particles=0``) or the extended Kalman filter's
(``particles=0, method="ekf"``), or the estimate of the psi filter, the
bootstrap filter or the extended Kalman particle filter (``"ekf"``).  An
SDE model's is the estimate of the bootstrap filter at its fine level
with max(particles, 2) particles, whatever ``method`` is, as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.spec import MVLGSpec, MVNGSpec, NGSpec
from ..models.nlg import NLGSpec
from ..models.sde import SDESpec
from ..ops import cuda_kalman, kalman_mv
from . import approx as approx_mod
from . import approx_mv as mv_mod
from . import nlg as nlg_mod
from . import particle as pf_mod
from . import sde as sde_mod
from .filters import generator_for, spec_of


def logLik(model_or_spec, particles: int = 0, method: str = "psi",
           generator: Optional[torch.Generator] = None, seed: int = 1,
           theta=None, conv_tol: float = approx_mod.CONV_TOL,
           max_iter: int = approx_mod.MAX_ITER, eps=None,
           us=None, dBf=None) -> torch.Tensor:
    """Log-likelihood ``(B,)`` of a model (built at ``theta``, by default
    its initial value) or spec: exact for a linear-Gaussian one, whatever
    ``particles`` is (as in the JAX package), else approximate
    (``particles=0``) or the estimate of a ``particles``-particle filter,
    whose randomness comes from ``generator`` (default: seeded with
    ``seed``) or, for the particle filters, ``eps``/``us`` (an SDE
    model's ``dBf``/``us``, ``inference/sde.py``)."""
    spec = spec_of(model_or_spec, theta)
    if isinstance(spec, SDESpec):
        return sde_mod.bsf_filter_sde(
            spec, max(int(particles), 2), spec.L_f, dBf=dBf, us=us,
            generator=generator_for(spec, generator, seed), keep_paths=False)
    if isinstance(spec, MVLGSpec):
        return kalman_mv.log_likelihood_mv(spec)
    if isinstance(spec, NLGSpec):
        return _loglik_nlg(spec, particles, method, generator, seed, eps, us)
    if isinstance(spec, MVNGSpec):
        return _loglik_mv(spec, particles, method, generator, seed,
                          conv_tol, max_iter, eps, us)
    if not isinstance(spec, NGSpec):
        return cuda_kalman.routed_log_likelihood(spec)
    if particles == 0:
        return approx_mod.approx_loglik(spec, conv_tol=conv_tol,
                                        max_iter=max_iter).loglik
    gen = generator_for(spec, generator, seed)
    if method == "bsf":
        return pf_mod.bsf_filter(spec, particles, gen, eps=eps, us=us).loglik
    if method not in ("psi", "spdk"):
        raise NotImplementedError(f"method={method!r}: 'psi', 'bsf' and "
                                  "'spdk' are ported")
    al = approx_mod.approx_loglik(spec, conv_tol=conv_tol, max_iter=max_iter)
    if method == "spdk":
        return pf_mod.spdk_sample(spec, al, particles, gen).loglik
    return pf_mod.psi_filter(spec, al, particles, gen, eps=eps, us=us).loglik


def _loglik_mv(spec, particles, method, generator, seed, conv_tol, max_iter,
               eps, us):
    """``logLik`` of several series (``approx_mv``): the approximation's,
    or a psi, bsf or SPDK estimate (the JAX package's multivariate
    ``logLik`` takes psi for every method but bsf)."""
    if particles == 0:
        return mv_mod.approx_loglik_mv(spec, conv_tol=conv_tol,
                                       max_iter=max_iter).loglik
    gen = generator_for(spec, generator, seed)
    if method == "bsf":
        return mv_mod.bsf_filter_mv(spec, particles, gen, eps=eps,
                                    us=us).loglik
    if method not in ("psi", "spdk"):
        raise NotImplementedError(f"method={method!r}: 'psi', 'bsf' and "
                                  "'spdk' are ported")
    al = mv_mod.approx_loglik_mv(spec, conv_tol=conv_tol, max_iter=max_iter)
    if method == "spdk":
        return mv_mod.spdk_sample_mv(spec, al, particles, gen).loglik
    return mv_mod.psi_filter_mv(spec, al, particles, gen, eps=eps, us=us,
                                keep_paths=False)


def _loglik_nlg(spec, particles, method, generator, seed, eps, us):
    """``logLik`` of a nonlinear model: the mode approximation's or the
    EKF's (``particles=0``), or a psi, bsf or EKPF (``"ekf"``) estimate.
    (The JAX package runs the bootstrap filter for any other method; the
    port refuses it.)"""
    if method not in ("psi", "bsf", "ekf"):
        raise ValueError(f"method={method!r}: a nonlinear model takes "
                         "'psi', 'bsf' or 'ekf'")
    if particles == 0:
        if method == "ekf":
            return nlg_mod.ekf_loglik(spec)
        return nlg_mod.approximate_nlg(spec).loglik
    gen = generator_for(spec, generator, seed)
    if method == "psi":
        return nlg_mod.psi_filter_nlg(spec, nlg_mod.approximate_nlg(spec),
                                      particles, gen, eps=eps, us=us,
                                      keep_paths=False)
    run = nlg_mod.ekpf_filter if method == "ekf" else nlg_mod.bsf_filter_nlg
    return run(spec, particles, gen, eps=eps, us=us, keep_paths=False)
