"""Observation-family math for non-Gaussian models.

Counterpart of ``bssm_tpu/core/distributions.py``: second-order (Laplace)
matching of pseudo-observations, unnormalised log observation densities and
importance log-weights, mode-based correction "scales", and the exact
normalising constants in lgamma form.

Every function is elementwise in the signal and broadcasts its arguments;
a batched ``phi`` of shape ``(B,)`` is passed by the caller as ``(B, 1)``
against ``(B, n)`` series.  The constant terms sum over the last (time)
axis.  Missing y (NaN) is masked as in the JAX package.
"""
from __future__ import annotations

import torch

from .spec import SVM, POISSON, BINOMIAL, NEGBIN, GAMMA, GAUSSIAN

LOG2PI = 1.8378770664093453


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with the argument clipped below the dtype's overflow point, so
    one extreme particle cannot poison an ensemble with inf/NaN."""
    cap = 80.0 if x.dtype == torch.float32 else 700.0
    return torch.exp(torch.clamp(x, max=cap))


def _lchoose(n, k):
    """log C(n, k) through lgamma."""
    return (-torch.log(n + 1.0) - torch.lgamma(n - k + 1.0)
            - torch.lgamma(k + 1.0) + torch.lgamma(n + 2.0))


def laplace_match(dist: int, y, u, phi, signal):
    """(ytilde, HHtilde) of the local Gaussian approximation at ``signal``
    (one Laplace iteration).  NaN y propagates into ytilde; HH is sanitised
    downstream."""
    if dist == SVM:
        ys = torch.where(torch.abs(y) < 1e-4, torch.full_like(y, 1e-4), y)
        HH = 2.0 * safe_exp(signal) / torch.square(ys / phi)
        yt = signal + 1.0 - 0.5 * HH
    elif dist == POISSON:
        HH = 1.0 / (safe_exp(signal) * u)
        yt = y * HH + signal - 1.0
    elif dist == BINOMIAL:
        es = safe_exp(signal)
        HH = torch.square(1.0 + es) / (u * es)
        yt = y * HH + signal - 1.0 - es
    elif dist == NEGBIN:
        eu = safe_exp(signal) * u
        HH = torch.square(phi + eu) / (phi * eu * (y + phi))
        yt = signal + (phi + eu) * (y - eu) / ((y + phi) * eu)
    elif dist == GAMMA:
        eu = safe_exp(signal) * u
        HH = eu / (y * phi)
        yt = signal - eu / y + 1.0
    elif dist == GAUSSIAN:
        HH = torch.square(phi) * torch.ones_like(signal)
        yt = y * torch.ones_like(signal)
    else:
        raise ValueError(f"unknown distribution {dist}")
    return yt, HH


def log_obs_density(dist: int, y, u, phi, signal):
    """Unnormalised log g(y_t | signal_t); zero where y is NaN."""
    ok = torch.isfinite(y)
    ys = torch.where(ok, y, torch.zeros_like(y))
    if dist == SVM:
        w = -0.5 * (signal + torch.square(ys / phi) * safe_exp(-signal))
    elif dist == POISSON:
        w = ys * signal - u * safe_exp(signal)
    elif dist == BINOMIAL:
        w = ys * signal - u * torch.logaddexp(torch.zeros_like(signal),
                                              signal)
    elif dist == NEGBIN:
        w = ys * signal - (ys + phi) * torch.log(phi + u * safe_exp(signal))
    elif dist == GAMMA:
        w = -phi * (signal + ys * safe_exp(-signal) / u)
    elif dist == GAUSSIAN:
        w = -0.5 * torch.square((ys - signal) / phi)
    else:
        raise ValueError(f"unknown distribution {dist}")
    return torch.where(ok, w, torch.zeros_like(w))


def log_gaussian_unnorm(ytilde, Htilde, signal):
    """Unnormalised log g~(ytilde_t | signal_t) of the approximating model."""
    ok = torch.isfinite(ytilde)
    yt = torch.where(ok, ytilde, torch.zeros_like(ytilde))
    Hs = torch.where(ok & (Htilde > 0), Htilde, torch.ones_like(Htilde))
    g = -0.5 * torch.square((yt - signal) / Hs)
    return torch.where(ok, g, torch.zeros_like(g))


def log_weights(dist: int, y, u, phi, signal, ytilde, Htilde):
    """Unnormalised importance log-weights log g(y|s) - log g~(ytilde|s)."""
    return (log_obs_density(dist, y, u, phi, signal)
            - log_gaussian_unnorm(ytilde, Htilde, signal))


def scales(dist: int, y, u, phi, mode, ytilde, Htilde):
    """Mode-based correction terms: ``log_weights`` evaluated at the mode."""
    return log_weights(dist, y, u, phi, mode, ytilde, Htilde)


def obs_log_const(dist: int, y, u, phi):
    """Sum over observed t of the exact log normalising constants of the
    observation family."""
    ok = torch.isfinite(y)
    ys = torch.where(ok, y, torch.ones_like(y))
    us = torch.where(ok, u, torch.ones_like(u))
    if dist in (SVM, GAUSSIAN):
        c = -0.5 * LOG2PI - torch.log(phi) + torch.zeros_like(ys)
    elif dist == POISSON:
        c = -torch.lgamma(ys + 1.0) + ys * torch.log(us)
    elif dist == BINOMIAL:
        c = _lchoose(us, ys)
    elif dist == NEGBIN:
        c = (_lchoose(ys + phi - 1.0, ys) + phi * torch.log(phi)
             + ys * torch.log(us))
    elif dist == GAMMA:
        c = (phi * torch.log(phi) - torch.lgamma(phi)
             + (phi - 1.0) * torch.log(ys) - phi * torch.log(us))
    else:
        raise ValueError(f"unknown distribution {dist}")
    return torch.sum(torch.where(ok, c, torch.zeros_like(c)), dim=-1)


def gauss_log_const(y, H):
    """Sum over observed t of the Gaussian log normalising constants."""
    ok = torch.isfinite(y)
    Hs = torch.where(ok & (H > 0), H, torch.ones_like(H))
    c = -0.5 * LOG2PI - torch.log(Hs)
    return torch.sum(torch.where(ok, c, torch.zeros_like(c)), dim=-1)


def const_term(dist: int, y, u, phi, ytilde, Htilde):
    """Exact normalising-constant difference between the true and the
    approximating Gaussian observation densities."""
    return obs_log_const(dist, y, u, phi) - gauss_log_const(ytilde, Htilde)
