"""Univariate diffusion models observed at integer times.

  d alpha_t = drift(alpha_t, theta) dt + diffusion(alpha_t, theta) dB_t,
  y_k ~ g(y_k | alpha_k),   k = 1..n,

propagated by the Milstein scheme at discretisation level 2^L.
Counterpart of ``bssm_tpu/models/sde.py``.  The JAX package takes model
functions of one state and one theta and lays ``vmap`` over them; here they
are **torch functions batched over a leading row axis**, as those of
``models/nlg.py``:

  drift(x, theta) -> (R,)         diffusion(x, theta) -> (R,)
  ddiffusion(x, theta) -> (R,)    (the derivative of the diffusion in x)
  log_obs_density(y, x, theta) -> (R,)
  log_prior(theta) -> (B,)

with ``x (R,)``, ``theta (R, d)``, ``y (R,)`` (one observation broadcast
over the rows) and ``theta (B, d)`` for the prior.  Row r of an output
depends on row r of the inputs only; a function makes no host
synchronisation and no Python branch on tensor values, so that it runs
inside a CUDA-graph capture.  A filter calls them for every (row of theta,
particle) pair at once (R = B N).

The multilevel coupling of the coarse (2^L_c) and fine (2^L_f) levels comes
from drawing the Brownian increments at the fine level and summing them
onto the coarse grid (``milstein_coupled``, ``milstein(..., gen_L=L_f)``),
as in the JAX package; the filters (``inference/sde.py``) draw them from a
counter-based generator keyed by a per-row seed, so that a coarse and a
fine filter run from one seed share their Brownian path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import DEFAULT_DTYPE, resolve_device
from ..core.spec import Replaceable
from .base import Model


@dataclasses.dataclass(frozen=True)
class SDESpec(Replaceable):
    """An SDE model at a batch of thetas: ``y (n,)`` shared by the rows,
    ``theta (B, d)``, the fixed initial state ``x0``; the functions, the
    ``positive`` flag (take |x| after each step) and the levels are static
    fields."""
    y: torch.Tensor
    theta: torch.Tensor
    x0: float
    drift: Callable
    diffusion: Callable
    ddiffusion: Callable
    log_obs_density: Callable
    positive: bool = False
    L_f: int = 5
    L_c: int = 2

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def m(self) -> int:
        return 1

    @property
    def batch(self) -> int:
        return self.theta.shape[0]


def milstein_step(x, dB, dt, theta, spec: SDESpec):
    """One Milstein update of every row: ``x``, ``dB (R,)``, ``theta (R,
    d)``."""
    d = spec.diffusion(x, theta)
    x = x + spec.drift(x, theta) * dt + d * dB \
        + 0.5 * d * spec.ddiffusion(x, theta) * (dB * dB - dt)
    return torch.abs(x) if spec.positive else x


def coarsen(dBf: torch.Tensor, L: int) -> torch.Tensor:
    """Increments on the 2^L grid from those of a finer one ``(..., 2^gen_L)``
    (sums of 2^(gen_L - L) consecutive ones)."""
    ratio = dBf.shape[-1] >> L
    if ratio < 1 or (ratio << L) != dBf.shape[-1]:
        raise ValueError(f"{dBf.shape[-1]} increments do not refine 2^{L}")
    return dBf if ratio == 1 else dBf.reshape(
        dBf.shape[:-1] + (1 << L, ratio)).sum(-1)


def brownian_increments(shape, gen_L: int, dtype, device,
                        generator: Optional[torch.Generator] = None,
                        t: float = 1.0) -> torch.Tensor:
    """``shape + (2^gen_L,)`` Brownian increments on [0, t]."""
    nf = 1 << gen_L
    return math.sqrt(t / nf) * torch.randn(
        tuple(shape) + (nf,), dtype=dtype, device=device, generator=generator)


def milstein(spec: SDESpec, x0: torch.Tensor, L: int,
             gen_L: Optional[int] = None, *, dBf=None, theta=None,
             generator: Optional[torch.Generator] = None, t: float = 1.0):
    """Terminal values ``(R,)`` of a 2^L-step Milstein discretisation on [0,
    t] from ``x0 (R,)``.  The Brownian increments ``dBf (R, 2^gen_L)`` live
    on the finer grid 2^gen_L (default L) and are summed onto the 2^L one,
    so that runs at two levels from the same increments share their path;
    drawn from ``generator`` unless given.  ``theta (R, d)`` defaults to
    ``spec.theta``."""
    theta = spec.theta if theta is None else theta
    if dBf is None:
        dBf = brownian_increments(x0.shape, L if gen_L is None else gen_L,
                                  x0.dtype, x0.device, generator, t)
    dB = coarsen(dBf, L)
    dt = t / (1 << L)
    x = x0
    for j in range(dB.shape[-1]):
        x = milstein_step(x, dB[..., j], dt, theta, spec)
    return x


def milstein_coupled(spec: SDESpec, x0_f: torch.Tensor, x0_c: torch.Tensor,
                     *, dBf=None, theta=None,
                     generator: Optional[torch.Generator] = None,
                     t: float = 1.0):
    """One interval at the fine level ``spec.L_f`` and the coarse level
    ``spec.L_c`` from the same Brownian path: the coarse increments are the
    sums of 2^(L_f - L_c) fine ones ``dBf (R, 2^L_f)``.  Returns
    ``(x_f, x_c)``."""
    if dBf is None:
        dBf = brownian_increments(x0_f.shape, spec.L_f, x0_f.dtype,
                                  x0_f.device, generator, t)
    return (milstein(spec, x0_f, spec.L_f, dBf=dBf, theta=theta, t=t),
            milstein(spec, x0_c, spec.L_c, dBf=dBf, theta=theta, t=t))


def ssm_sde(y, drift, diffusion, ddiffusion, log_obs_density, *,
            x0: float, positive: bool = False, L_f: int = 5, L_c: int = 2,
            theta_init=(), log_prior=None, theta_names=None,
            dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """An SDE model from batched torch functions (see the module docstring
    for their contract).  ``y`` is ``(n,)`` with NaN for a missing value;
    ``x0`` the fixed initial state; ``L_f`` / ``L_c`` the fine and coarse
    discretisation levels (2^L Milstein steps per unit of time); the prior
    defaults to a flat one; theta is sampled untransformed.  ``dtype``
    defaults to the port's float32 (the JAX package's to float64).
    ``device=None`` means the CUDA device (raises when there is none)."""
    device = resolve_device(device)
    y_np = np.asarray(y, np.float64).reshape(-1)
    if not 0 <= int(L_c) <= int(L_f):
        raise ValueError("need 0 <= L_c <= L_f")
    yt = torch.as_tensor(y_np, dtype=dtype, device=device)
    theta0 = np.atleast_1d(np.asarray(theta_init, np.float64))

    def build(theta: torch.Tensor) -> SDESpec:
        theta = torch.atleast_2d(torch.as_tensor(theta)).to(
            dtype=dtype, device=device)
        return SDESpec(y=yt, theta=theta, x0=float(x0), drift=drift,
                       diffusion=diffusion, ddiffusion=ddiffusion,
                       log_obs_density=log_obs_density,
                       positive=bool(positive), L_f=int(L_f), L_c=int(L_c))

    def lp(theta: torch.Tensor) -> torch.Tensor:
        rows = torch.atleast_2d(theta)
        out = torch.zeros(rows.shape[0], dtype=rows.dtype,
                          device=rows.device) if log_prior is None \
            else log_prior(rows)
        return out[0] if theta.dim() == 1 else out

    names = tuple(theta_names) if theta_names else tuple(
        f"theta_{i + 1}" for i in range(theta0.shape[0]))
    return Model(build=build, log_prior=lp, theta_init=theta0,
                 theta_names=names,
                 transforms=np.zeros(theta0.shape[0], np.int32),
                 kind="sde", device=device, dtype=dtype,
                 extra={"n": y_np.shape[0], "m": 1})


# ---------------------------------------------------------------------------
# the built-in examples
# ---------------------------------------------------------------------------

def sde_poisson_ou(y, x0: float = 0.0, L_f: int = 5, L_c: int = 2,
                   dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """Latent Ornstein-Uhlenbeck process with Poisson observations of
    exp(x); theta = (log rho, nu, log sigma)."""
    def drift(x, th):
        return torch.exp(th[:, 0]) * (th[:, 1] - x)

    def diffusion(x, th):
        return torch.exp(th[:, 2]) * torch.ones_like(x)

    def ddiffusion(x, th):
        return torch.zeros_like(x)

    def log_obs(yv, x, th):
        return yv * x - torch.exp(x) - torch.lgamma(yv + 1.0)

    def log_prior(th):
        rho = torch.exp(th[:, 0])
        sig = torch.exp(th[:, 2])
        lp = (2.0 - 1.0) * torch.log(rho) - rho / 0.5   # gamma(2, scale .5)
        lp = lp - 0.5 * torch.square(th[:, 1] / 4.0)
        lp = lp - 0.5 * torch.square(sig)
        return lp + th[:, 0] + th[:, 2]

    return ssm_sde(y, drift, diffusion, ddiffusion, log_obs, x0=x0,
                   positive=False, L_f=L_f, L_c=L_c,
                   theta_init=(np.log(0.5), 0.0, np.log(0.3)),
                   log_prior=log_prior,
                   theta_names=("log_rho", "nu", "log_sigma"), dtype=dtype,
                   device=device)


def sde_gbm(y, x0: float = 1.0, L_f: int = 5, L_c: int = 2,
            dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """Geometric Brownian motion with log-normal observations; theta =
    (mu, sigma_x, sigma_y).  The observation density takes log of
    max(x, 1e-300), which is max(x, 0) in float32, as in the JAX package."""
    def drift(x, th):
        return th[:, 0] * x

    def diffusion(x, th):
        return torch.clamp(th[:, 1] * x, min=0.0)

    def ddiffusion(x, th):
        return th[:, 1] * (x > 0.0).to(x.dtype)

    def log_obs(yv, x, th):
        xs = torch.clamp(x, min=1e-300)     # 0 in float32
        return -0.5 * torch.square((yv - torch.log(xs)) / th[:, 2]) \
            - torch.log(th[:, 2]) - 0.9189385332046727

    def log_prior(th):
        ok = (th[:, 0] >= 0) & (th[:, 1] >= 0) & (th[:, 2] >= 0.5)
        lp = (-0.5 * torch.square(th[:, 0] / 0.1)
              - 0.5 * torch.square(th[:, 1] / 0.5)
              - 0.5 * torch.square((th[:, 2] - 1.5) / 0.5))
        return torch.where(ok, lp, torch.full_like(lp, -torch.inf))

    return ssm_sde(y, drift, diffusion, ddiffusion, log_obs, x0=x0,
                   positive=True, L_f=L_f, L_c=L_c,
                   theta_init=(0.05, 0.3, 1.5), log_prior=log_prior,
                   theta_names=("mu", "sigma_x", "sigma_y"), dtype=dtype,
                   device=device)
