"""Basic structural time-series models (level / slope / seasonal [/ noise]).

Counterpart of ``bssm_tpu/models/bsm.py``: ``bsm_lg`` (Gaussian
observations) and ``bsm_ng`` (Poisson / binomial / negative binomial /
gamma observations).

Standard-deviation parameters (and phi for negbin/gamma) are sampled on the
log scale; priors are evaluated on the natural scale with the log-Jacobian
added (``PriorStack`` transform codes).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import DEFAULT_DTYPE, resolve_device
from ..core.priors import IDENTITY, LOG
from ..core.spec import GAMMA, LGSpec, NEGBIN, NGSpec
from ..core.validate import (check_beta, check_period, check_u, check_xreg,
                             check_y)
from .base import Model, collect_priors, init_mode, _is_prior

_DIST_NAMES = {"svm": 0, "poisson": 1, "binomial": 2,
               "negative binomial": 3, "gamma": 4, "gaussian": 5}


def _bsm_structure(slope: bool, seasonal: bool, period: int, noise: bool):
    """Z, T, R masks for the BSM state space.

    As in the JAX package (and the R package it follows), the seasonal row
    of T is filled with -1 through column m-1 inclusive, so with a noise
    state the seasonal recursion also subtracts the lagged noise state; the
    noise sd lives only in its own column of R."""
    m = 1 + int(slope) + (period - 1 if seasonal else 0) + int(noise)
    npar_R = 1 + int(slope) + int(seasonal) + int(noise)
    Z = np.zeros(m)
    Z[0] = 1.0
    if seasonal:
        Z[1 + int(slope)] = 1.0
    if noise:
        Z[m - 1] = 1.0
    T = np.zeros((m, m))
    T[0, 0] = 1.0
    if slope:
        T[0, 1] = 1.0
        T[1, 1] = 1.0
    if seasonal:
        s0 = 1 + int(slope)
        T[s0, s0:m] = -1.0      # extends into the noise column
        for j in range(period - 2):
            T[s0 + 1 + j, s0 + j] = 1.0
    R = np.zeros((m, npar_R))
    return m, Z, T, R


def _sd_entry(x):
    """(is_estimated, init_value) for a prior-or-fixed sd argument."""
    if x is None:
        return False, 0.0
    if _is_prior(x):
        return True, float(x.init)
    return False, float(x)


def bsm_lg(y, sd_y, sd_level, sd_slope=None, sd_seasonal=None,
           beta=None, xreg=None, period: Optional[int] = None,
           a1=None, P1=None, D=None, C=None,
           dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """Gaussian basic structural model.  The regressors ``xreg`` are folded
    into a time-varying intercept D = D0 + xreg beta.  ``device=None`` means
    the CUDA device (raises when there is none)."""
    device = resolve_device(device)
    y = check_y(y)
    n = y.shape[0]
    slope = sd_slope is not None
    seasonal = sd_seasonal is not None
    if seasonal:
        period = check_period(period, n)
    period = int(period or 1)
    m, Zv, Tm, Rm = _bsm_structure(slope, seasonal, period, noise=False)

    y_est, y_init = _sd_entry(sd_y)
    lvl_est, lvl_init = _sd_entry(sd_level)
    slo_est, slo_init = _sd_entry(sd_slope)
    sea_est, sea_init = _sd_entry(sd_seasonal)

    xreg_np = None if xreg is None else check_xreg(xreg, n)
    if xreg_np is not None:
        check_beta(beta, xreg_np.shape[1])

    stack, theta0, names = collect_priors([
        ("sd_y", sd_y if y_est else None, LOG),
        ("sd_level", sd_level if lvl_est else None, LOG),
        ("sd_slope", sd_slope if slo_est else None, LOG),
        ("sd_seasonal", sd_seasonal if sea_est else None, LOG),
        ("beta", beta, IDENTITY),
    ])

    a1_ = np.zeros(m) if a1 is None else np.asarray(a1, dtype=np.float64)
    P1_ = np.eye(m) * 100.0 if P1 is None else np.asarray(P1, np.float64)
    D_ = np.zeros(1) if D is None else np.atleast_1d(np.asarray(D, np.float64))
    C_ = np.zeros((1, m)) if C is None else \
        np.asarray(C, np.float64).reshape(-1, m)

    Rm[0, 0] = lvl_init
    if slope:
        Rm[1, 1] = slo_init
    if seasonal:
        Rm[1 + int(slope), 1 + int(slope)] = sea_init

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    yj, Zj, Tj = dev(y), dev(Zv)[None], dev(Tm)[None]
    R0, a1j, P1j, Dj, Cj = dev(Rm)[None], dev(a1_), dev(P1_), dev(D_), dev(C_)
    Hj0 = dev([y_init])
    xregj = None if xreg_np is None else dev(xreg_np)
    n_beta = 0 if xreg_np is None else xreg_np.shape[1]

    idx = np.cumsum([y_est, lvl_est, slo_est, sea_est]) - 1
    j_sea = 1 + int(slope)

    def build(theta: torch.Tensor) -> LGSpec:
        theta = torch.atleast_2d(theta).to(dtype)
        B = theta.shape[0]
        sd = torch.exp(theta)
        H = sd[:, idx[0], None] if y_est else Hj0
        R = R0.expand(B, 1, m, R0.shape[-1]).clone()
        if lvl_est:
            R[:, 0, 0, 0] = sd[:, idx[1]]
        if slo_est:
            R[:, 0, 1, 1] = sd[:, idx[2]]
        if sea_est:
            R[:, 0, j_sea, j_sea] = sd[:, idx[3]]
        D = Dj
        if n_beta:
            xb = theta[:, -n_beta:] @ xregj.T
            D = Dj + xb if Dj.shape[0] == n else Dj[0] + xb
        return LGSpec(y=yj, Z=Zj, H=H, T=Tj, R=R, a1=a1j, P1=P1j, D=D, C=Cj)

    return Model(build=build, log_prior=stack.bound(device, dtype),
                 theta_init=theta0, theta_names=names,
                 transforms=stack.transforms, kind="lg", device=device,
                 dtype=dtype, extra={"m": m, "n": n, "stack": stack})


def bsm_ng(y, sd_level, sd_slope=None, sd_seasonal=None, sd_noise=None,
           distribution="poisson", phi=1.0, u=None, beta=None, xreg=None,
           period: Optional[int] = None, a1=None, P1=None, C=None,
           dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """Non-Gaussian basic structural model.  ``device=None`` means the CUDA
    device (raises when there is none); the model's tensors live there."""
    device = resolve_device(device)
    dist = _DIST_NAMES[distribution] if isinstance(distribution, str) \
        else int(distribution)
    y = check_y(y, distribution=distribution
                if isinstance(distribution, str) else None)
    n = y.shape[0]
    u_ = np.ones(n) if u is None else check_u(u, y)
    slope = sd_slope is not None
    seasonal = sd_seasonal is not None
    noise = sd_noise is not None
    if seasonal:
        period = check_period(period, n)
    period = int(period or 1)
    m, Zv, Tm, Rm = _bsm_structure(slope, seasonal, period, noise)

    lvl_est, lvl_init = _sd_entry(sd_level)
    slo_est, slo_init = _sd_entry(sd_slope)
    sea_est, sea_init = _sd_entry(sd_seasonal)
    noi_est, noi_init = _sd_entry(sd_noise)
    phi_used = dist in (NEGBIN, GAMMA)
    phi_est = phi_used and _is_prior(phi)
    phi_init = float(phi.init) if phi_est else float(phi if phi_used else 1.0)

    xreg_np = None if xreg is None else check_xreg(xreg, n)
    if xreg_np is not None:
        check_beta(beta, xreg_np.shape[1])

    stack, theta0, names = collect_priors([
        ("sd_level", sd_level if lvl_est else None, LOG),
        ("sd_slope", sd_slope if slo_est else None, LOG),
        ("sd_seasonal", sd_seasonal if sea_est else None, LOG),
        ("sd_noise", sd_noise if noi_est else None, LOG),
        ("phi", phi if phi_est else None, LOG),
        ("beta", beta, IDENTITY),
    ])

    a1_ = np.zeros(m) if a1 is None else np.asarray(a1, dtype=np.float64)
    P1_ = np.eye(m) * 100.0 if P1 is None else np.asarray(P1, np.float64)
    C_ = np.zeros((1, m)) if C is None else \
        np.asarray(C, np.float64).reshape(-1, m)

    Rm[0, 0] = lvl_init
    if slope:
        Rm[1, 1] = slo_init
    if seasonal:
        Rm[1 + int(slope), 1 + int(slope)] = sea_init
    if noise:
        Rm[m - 1, Rm.shape[1] - 1] = noi_init
        P1_[m - 1, m - 1] = noi_init ** 2

    mode0 = init_mode(y, u_, dist)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    yj, uj = dev(y), dev(u_)
    Zj, Tj = dev(Zv)[None], dev(Tm)[None]
    R0, a1j, P1j, Cj = dev(Rm)[None], dev(a1_), dev(P1_), dev(C_)
    Dj = torch.zeros(1, dtype=dtype, device=device)
    modej = dev(mode0)
    phij = torch.tensor(phi_init, dtype=dtype, device=device)
    xregj = None if xreg_np is None else dev(xreg_np)
    n_beta = 0 if xreg_np is None else xreg_np.shape[1]

    idx = np.cumsum([lvl_est, slo_est, sea_est, noi_est, phi_est]) - 1
    j_sea = 1 + int(slope)

    def build(theta: torch.Tensor) -> NGSpec:
        theta = torch.atleast_2d(theta).to(dtype)
        B = theta.shape[0]
        sd = torch.exp(theta)
        R = R0.expand(B, 1, m, R0.shape[-1]).clone()
        P1 = P1j
        if lvl_est:
            R[:, 0, 0, 0] = sd[:, idx[0]]
        if slo_est:
            R[:, 0, 1, 1] = sd[:, idx[1]]
        if sea_est:
            R[:, 0, j_sea, j_sea] = sd[:, idx[2]]
        if noise and noi_est:
            R[:, 0, m - 1, -1] = sd[:, idx[3]]
            P1 = P1j.expand(B, m, m).clone()
            P1[:, m - 1, m - 1] = sd[:, idx[3]] ** 2
        phi_v = sd[:, idx[4]] if phi_est else phij
        D = Dj
        if n_beta:
            D = Dj[0] + theta[:, -n_beta:] @ xregj.T
        return NGSpec(y=yj, Z=Zj, T=Tj, R=R, a1=a1j, P1=P1, D=D, C=Cj,
                      phi=phi_v, u=uj, distribution=dist,
                      initial_mode=modej)

    return Model(build=build, log_prior=stack.bound(device, dtype),
                 theta_init=theta0,
                 theta_names=names, transforms=stack.transforms, kind="ng",
                 device=device, dtype=dtype,
                 extra={"m": m, "n": n, "stack": stack,
                        "distribution": dist})
