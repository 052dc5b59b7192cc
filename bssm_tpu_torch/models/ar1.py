"""AR(1) models with Gaussian or exponential-family observations.

Counterpart of ``bssm_tpu/models/ar1.py``:
  alpha_{t+1} = mu (1 - rho) + rho alpha_t + sigma eta_t,
  alpha_1 ~ N(mu, sigma^2 / (1 - rho^2)),
theta = (rho, log sigma, [mu], [log sd_y | log phi], [beta...]).  The
initial state and the intercept C depend on theta, so every leaf of the
built spec but y, Z and u carries the batch axis.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import DEFAULT_DTYPE, resolve_device
from ..core.priors import IDENTITY, LOG
from ..core.spec import GAMMA, LGSpec, NEGBIN, NGSpec
from ..core.validate import check_beta, check_u, check_xreg, check_y
from .base import Model, collect_priors, init_mode, _is_prior
from .bsm import _DIST_NAMES


def ar1_lg(y, rho, sigma, mu=None, sd_y=None, beta=None, xreg=None,
           dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """``device=None`` means the CUDA device (raises when there is none)."""
    device = resolve_device(device)
    y = check_y(y)
    n = y.shape[0]
    mu_est = _is_prior(mu)
    sd_y_est = _is_prior(sd_y)
    mu_fix = 0.0 if mu is None or mu_est else float(mu)
    sd_y_fix = 0.0 if sd_y is None or sd_y_est else float(sd_y)

    xreg_np = None if xreg is None else check_xreg(xreg, n)
    if xreg_np is not None:
        check_beta(beta, xreg_np.shape[1])
    n_beta = 0 if xreg_np is None else xreg_np.shape[1]

    stack, theta0, names = collect_priors([
        ("rho", rho, IDENTITY),
        ("sigma", sigma, LOG),
        ("mu", mu if mu_est else None, IDENTITY),
        ("sd_y", sd_y if sd_y_est else None, LOG),
        ("beta", beta, IDENTITY),
    ])

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    yj, Zj, H_fix = dev(y), dev(np.ones((1, 1))), dev([sd_y_fix])
    D0 = torch.zeros(1, dtype=dtype, device=device)
    xregj = None if xreg_np is None else dev(xreg_np)

    def build(theta: torch.Tensor) -> LGSpec:
        theta = torch.atleast_2d(theta).to(dtype)
        B = theta.shape[0]
        rho_v = theta[:, 0]
        sig = torch.exp(theta[:, 1])
        mu_v = theta[:, 2] if mu_est else torch.full_like(rho_v, mu_fix)
        H = torch.exp(theta[:, 2 + int(mu_est), None]) if sd_y_est \
            else H_fix
        D = theta[:, -n_beta:] @ xregj.T if n_beta else D0
        return LGSpec(
            y=yj, Z=Zj, H=H, T=rho_v.reshape(B, 1, 1, 1),
            R=sig.reshape(B, 1, 1, 1), a1=mu_v[:, None],
            P1=(sig * sig / (1.0 - rho_v * rho_v)).reshape(B, 1, 1),
            D=D, C=(mu_v * (1.0 - rho_v)).reshape(B, 1, 1))

    return Model(build=build, log_prior=stack.bound(device, dtype),
                 theta_init=theta0, theta_names=names,
                 transforms=stack.transforms, kind="lg", device=device,
                 dtype=dtype, extra={"m": 1, "n": n, "stack": stack})


def ar1_ng(y, rho, sigma, mu=None, distribution="poisson", phi=1.0, u=None,
           beta=None, xreg=None, dtype: torch.dtype = DEFAULT_DTYPE,
           device=None) -> Model:
    """AR(1) states with Poisson, binomial, negative binomial or gamma
    observations; phi is estimated (on the log scale) for the last two
    when it is a prior.  ``device=None`` means the CUDA device."""
    device = resolve_device(device)
    dist = _DIST_NAMES[distribution] if isinstance(distribution, str) \
        else int(distribution)
    y = check_y(y, distribution=distribution
                if isinstance(distribution, str) else None)
    n = y.shape[0]
    u_ = np.ones(n) if u is None else check_u(u, y)
    mu_est = _is_prior(mu)
    mu_fix = 0.0 if mu is None or mu_est else float(mu)
    phi_used = dist in (NEGBIN, GAMMA)
    phi_est = phi_used and _is_prior(phi)
    phi_init = float(phi.init) if phi_est else float(phi if phi_used else 1.0)

    xreg_np = None if xreg is None else check_xreg(xreg, n)
    if xreg_np is not None:
        check_beta(beta, xreg_np.shape[1])
    n_beta = 0 if xreg_np is None else xreg_np.shape[1]

    stack, theta0, names = collect_priors([
        ("rho", rho, IDENTITY),
        ("sigma", sigma, LOG),
        ("mu", mu if mu_est else None, IDENTITY),
        ("phi", phi if phi_est else None, LOG),
        ("beta", beta, IDENTITY),
    ])

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    yj, uj, Zj = dev(y), dev(u_), dev(np.ones((1, 1)))
    modej = dev(init_mode(y, u_, dist))
    D0, phij = dev(np.zeros(1)), dev(phi_init)
    xregj = None if xreg_np is None else dev(xreg_np)

    def build(theta: torch.Tensor) -> NGSpec:
        theta = torch.atleast_2d(theta).to(dtype)
        B = theta.shape[0]
        rho_v = theta[:, 0]
        sig = torch.exp(theta[:, 1])
        mu_v = theta[:, 2] if mu_est else torch.full_like(rho_v, mu_fix)
        phi_v = torch.exp(theta[:, 2 + int(mu_est)]) if phi_est else phij
        D = theta[:, -n_beta:] @ xregj.T if n_beta else D0
        return NGSpec(
            y=yj, Z=Zj, T=rho_v.reshape(B, 1, 1, 1),
            R=sig.reshape(B, 1, 1, 1), a1=mu_v[:, None],
            P1=(sig * sig / (1.0 - rho_v * rho_v)).reshape(B, 1, 1),
            D=D, C=(mu_v * (1.0 - rho_v)).reshape(B, 1, 1),
            phi=phi_v, u=uj, distribution=dist, initial_mode=modej)

    return Model(build=build, log_prior=stack.bound(device, dtype),
                 theta_init=theta0, theta_names=names,
                 transforms=stack.transforms, kind="ng", device=device,
                 dtype=dtype, extra={"m": 1, "n": n, "stack": stack,
                                     "distribution": dist})
