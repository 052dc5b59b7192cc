"""Built-in example models.

Counterpart of ``bssm_tpu/models/examples.py``: the four nonlinear
example models, their functions written batched over rows (the contract of
``models/nlg.py``), and ``simulate_growth``, the growth model's simulator
(numpy only).  Each model gives its Jacobians ``Z_gn`` / ``T_gn`` in closed
form, as bssm's C++ snippets do; the JAX package takes ``jacfwd`` instead,
and ``tests/test_torch_nlg_models.py`` holds the closed forms against it
and against ``forward_jacobian``.  A closed form is a few tensor
operations where forward mode costs some hundred (on the CPU the growth
model's T Jacobian took 2.6 ms a call by ``forward_jacobian``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import DEFAULT_DTYPE, resolve_device
from .nlg import ssm_nlg


def _halfnormal_lp(x, sd):
    return -0.5 * torch.square(x / sd) - 0.5 * math.log(2 * math.pi) \
        - math.log(sd)


def _cov(x):
    """A ``(R,)`` column as ``(R, 1, 1)``."""
    return x.reshape(-1, 1, 1)


def _ones(a):
    """A Jacobian of ones ``(R, 1, 1)`` for a state ``a (R, 1)``."""
    return torch.ones_like(a)[:, :, None]


def _eye_rows(th, m, scale=1.0):
    return scale * torch.eye(m, dtype=th.dtype, device=th.device).expand(
        th.shape[0], m, m)


def nlg_linear_gaussian(y, dtype=DEFAULT_DTYPE, device=None):
    """Random walk + noise: y_t ~ N(alpha_t, exp(th0)^2), alpha RW(1);
    theta = (log sd_y,)."""
    def Z_fn(t, a, th):
        return a

    def H_fn(t, a, th):
        return _cov(torch.exp(th[:, 0]))

    def T_fn(t, a, th):
        return a

    def R_fn(t, a, th):
        return torch.ones_like(a).reshape(-1, 1, 1)

    def log_prior(th):
        return _halfnormal_lp(torch.exp(th[:, 0]), 1.0) + th[:, 0]

    return ssm_nlg(y, Z_fn, H_fn, T_fn, R_fn, m=1, k=1,
                   Z_gn=lambda t, a, th: _ones(a),
                   T_gn=lambda t, a, th: _ones(a),
                   P1_fn=lambda th: _eye_rows(th, 1, 1e2),
                   theta_init=(np.log(1.0),), log_prior=log_prior,
                   theta_names=("log_sd_y",), dtype=dtype, device=device)


def nlg_sin_exp(y, dtype=DEFAULT_DTYPE, device=None):
    """alpha_{t+1} = sin(alpha_t) + eta; y ~ N(exp(alpha), .);
    theta = (log sd_y, log sd_x)."""
    def Z_fn(t, a, th):
        return torch.exp(a)

    def H_fn(t, a, th):
        return _cov(torch.exp(th[:, 0]))

    def T_fn(t, a, th):
        return torch.sin(a)

    def R_fn(t, a, th):
        return _cov(torch.exp(th[:, 1]))

    def log_prior(th):
        return (_halfnormal_lp(torch.exp(th[:, 0]), 1.0) + th[:, 0]
                + _halfnormal_lp(torch.exp(th[:, 1]), 1.0) + th[:, 1])

    return ssm_nlg(y, Z_fn, H_fn, T_fn, R_fn, m=1, k=1,
                   Z_gn=lambda t, a, th: torch.exp(a)[:, :, None],
                   T_gn=lambda t, a, th: torch.cos(a)[:, :, None],
                   P1_fn=lambda th: _eye_rows(th, 1),
                   theta_init=(np.log(0.7), np.log(0.5)),
                   log_prior=log_prior,
                   theta_names=("log_sd_y", "log_sd_x"), dtype=dtype,
                   device=device)


def nlg_ar_exp(y, dtype=DEFAULT_DTYPE, device=None):
    """AR(1) state, y ~ N(exp(alpha), .); theta = (mu, rho, log sd_x,
    log sd_y)."""
    def Z_fn(t, a, th):
        return torch.exp(a)

    def H_fn(t, a, th):
        return _cov(torch.exp(th[:, 3]))

    def T_fn(t, a, th):
        return (th[:, 0] * (1.0 - th[:, 1]))[:, None] + th[:, 1:2] * a

    def R_fn(t, a, th):
        return _cov(torch.exp(th[:, 2]))

    def a1_fn(th):
        return th[:, 0:1]

    def P1_fn(th):
        return _cov(torch.exp(th[:, 2]) ** 2 / (1.0 - th[:, 1] ** 2))

    def log_prior(th):
        mu, rho = th[:, 0], th[:, 1]
        lp = -0.5 * torch.square(mu / 10.0)
        inside = (rho > 0) & (rho < 1)
        safe = torch.where(inside, rho, torch.full_like(rho, 0.5))
        lp = lp + torch.where(inside, torch.log(safe) + torch.log1p(-safe),
                              torch.full_like(rho, -torch.inf))
        lp = lp + _halfnormal_lp(torch.exp(th[:, 2]), 1.0) + th[:, 2]
        return lp + _halfnormal_lp(torch.exp(th[:, 3]), 1.0) + th[:, 3]

    return ssm_nlg(y, Z_fn, H_fn, T_fn, R_fn, m=1, k=1,
                   Z_gn=lambda t, a, th: torch.exp(a)[:, :, None],
                   T_gn=lambda t, a, th: _cov(th[:, 1]),
                   a1_fn=a1_fn, P1_fn=P1_fn,
                   theta_init=(0.5, 0.5, np.log(0.5), np.log(0.5)),
                   log_prior=log_prior,
                   theta_names=("mu", "rho", "log_sd_x", "log_sd_y"),
                   dtype=dtype, device=device)


def nlg_growth(y, dT=1.0, K=100.0, a11=0.0, a12=5.0, P11=1.0, P12=2.0,
               dtype=DEFAULT_DTYPE, device=None):
    """Univariate logistic growth model (bssm's growth-model vignette):
    states (growth rate on the logit scale, population level); theta =
    (log H, log R1, log R2)."""
    def Z_fn(t, a, th):
        return a[:, 1:2]

    def H_fn(t, a, th):
        return _cov(torch.exp(th[:, 0]))

    def T_fn(t, a, th):
        r = torch.exp(a[:, 0]) / (1.0 + torch.exp(a[:, 0]))
        e = torch.exp(r * dT)
        growth = K * a[:, 1] * e / (K + a[:, 1] * (e - 1.0))
        return torch.stack([a[:, 0], growth], dim=-1)

    def Z_gn(t, a, th):
        return torch.stack([torch.zeros_like(a[:, 1]),
                            torch.ones_like(a[:, 1])], -1)[:, None, :]

    def T_gn(t, a, th):
        r = torch.exp(a[:, 0]) / (1.0 + torch.exp(a[:, 0]))
        e = torch.exp(r * dT)
        den = K + a[:, 1] * (e - 1.0)
        # d growth / d e = K a2 (K - a2) / den^2, d e / d a1 = e dT r (1-r)
        d0 = K * a[:, 1] * (K - a[:, 1]) / (den * den) * e * dT * r * (1 - r)
        d1 = K * K * e / (den * den)
        zero, one = torch.zeros_like(d0), torch.ones_like(d0)
        return torch.stack([torch.stack([one, zero], -1),
                            torch.stack([d0, d1], -1)], -2)

    def R_fn(t, a, th):
        return torch.diag_embed(torch.exp(th[:, 1:3]))

    # made here: a copy from the host has no place inside a graph capture
    a1 = torch.tensor([a11, a12], dtype=dtype, device=resolve_device(device))
    P1 = torch.diag(torch.tensor([P11, P12], dtype=dtype, device=a1.device))

    def a1_fn(th):
        return a1.expand(th.shape[0], 2)

    def P1_fn(th):
        return P1.expand(th.shape[0], 2, 2)

    def log_prior(th):
        return (-0.5 * torch.square(torch.exp(th) / 2.0) + th).sum(-1)

    return ssm_nlg(y, Z_fn, H_fn, T_fn, R_fn, m=2, k=2,
                   Z_gn=Z_gn, T_gn=T_gn, a1_fn=a1_fn, P1_fn=P1_fn,
                   theta_init=(np.log(0.5), np.log(0.05), np.log(1.0)),
                   log_prior=log_prior,
                   theta_names=("log_H", "log_R1", "log_R2"), dtype=dtype,
                   device=device)


def simulate_growth(n=100, seed=0, theta=(np.log(1.0), np.log(0.05),
                                          np.log(1.0)),
                    dT=1.0, K=100.0):
    """Simulate data from the growth model (the vignette's setup)."""
    rng = np.random.default_rng(seed)
    H, R1, R2 = np.exp(np.asarray(theta))
    alpha = np.array([0.0, 5.0])
    ys = np.zeros(n)
    for t in range(n):
        ys[t] = alpha[1] + H * rng.normal()
        r = np.exp(alpha[0]) / (1 + np.exp(alpha[0]))
        g = K * alpha[1] * np.exp(r * dT) / (K + alpha[1] *
                                             (np.exp(r * dT) - 1))
        alpha = np.array([alpha[0] + R1 * rng.normal(),
                          g + R2 * rng.normal()])
    return ys
