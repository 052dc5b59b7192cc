"""Prior system: packed prior stacks evaluated on batches of theta.

Counterpart of ``bssm_tpu/core/priors.py``.  A ``PriorStack`` holds integer
distribution codes, a ``(4, d)`` parameter matrix and a transform code per
parameter; ``log_pdf`` takes theta of shape ``(..., d)`` and returns the
joint log density of shape ``(...)``, branch free.

Densities are unnormalised (constants do not affect sampling):
  uniform(min, max):        0 inside, -inf outside
  halfnormal(sd):           -x^2/(2 sd^2) for x >= 0
  normal(mean, sd):         -(x-mean)^2/(2 sd^2)
  tnormal(mean, sd, lo, hi) normal inside [lo, hi], -inf outside
  gamma(shape, rate):       (shape-1) log x - rate x for x >= 0

Transforms: code 0 identity; code 1 theta = log(x), the prior is evaluated
at exp(theta) and the log-Jacobian theta is added.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

UNIFORM, HALFNORMAL, NORMAL, TNORMAL, GAMMA_P = 0, 1, 2, 3, 4
IDENTITY, LOG = 0, 1


class Prior(NamedTuple):
    dist: int
    params: tuple      # up to 4 floats
    init: float


def _mk(dist, params, init):
    init = np.atleast_1d(np.asarray(init, dtype=np.float64))
    out = []
    for i, x0 in enumerate(init):
        ps = tuple(float(np.broadcast_to(p, init.shape)[i]) for p in params)
        out.append(Prior(dist, ps, float(x0)))
    return out if len(out) > 1 else out[0]


def uniform_prior(init, min, max):
    return _mk(UNIFORM, (min, max, 0.0, 0.0), init)


def halfnormal_prior(init, sd):
    return _mk(HALFNORMAL, (sd, 0.0, 0.0, 0.0), init)


def normal_prior(init, mean, sd):
    return _mk(NORMAL, (mean, sd, 0.0, 0.0), init)


def tnormal_prior(init, mean, sd, min=-np.inf, max=np.inf):
    return _mk(TNORMAL, (mean, sd, min, max), init)


def gamma_prior(init, shape, rate):
    return _mk(GAMMA_P, (shape, rate, 0.0, 0.0), init)


class PriorStack(NamedTuple):
    """Packed priors for a d-dimensional theta (numpy; moved to theta's
    device and dtype when evaluated)."""
    dists: np.ndarray       # (d,) int
    params: np.ndarray      # (4, d)
    transforms: np.ndarray  # (d,) int

    @staticmethod
    def from_priors(priors: Sequence[Prior], transforms=None) -> "PriorStack":
        flat = []
        for p in priors:
            flat.extend(p if isinstance(p, list) else [p])
        d = len(flat)
        dists = np.array([p.dist for p in flat], dtype=np.int32)
        params = np.zeros((4, d))
        for i, p in enumerate(flat):
            params[:len(p.params), i] = p.params
        tr = np.zeros(d, dtype=np.int32) if transforms is None \
            else np.asarray(transforms, dtype=np.int32)
        return PriorStack(dists, params, tr)

    @property
    def d(self) -> int:
        return len(self.dists)

    def bound(self, device, dtype):
        """``log_pdf`` with the packed parameters already on ``device`` as
        ``dtype``: the MCMC loop evaluates the prior at every iteration and
        should not copy them from the host each time."""
        kw = dict(device=device)
        is_log = torch.as_tensor(self.transforms == LOG, **kw)
        dd = torch.as_tensor(self.dists, **kw)
        p0, p1, p2, p3 = torch.as_tensor(self.params, dtype=dtype, **kw)
        sd = torch.where(p1 > 0, p1, torch.ones_like(p1))

        def log_pdf(theta: torch.Tensor) -> torch.Tensor:
            zero = torch.zeros_like(theta)
            ninf = torch.full_like(theta, -torch.inf)

            x = torch.where(is_log, torch.exp(theta), theta)
            jac = torch.where(is_log, theta, zero)

            lp_unif = torch.where((x < p0) | (x > p1), ninf, zero)
            lp_hn = torch.where(x < 0, ninf, -0.5 * torch.square(x / p0))
            lp_n = -0.5 * torch.square((x - p0) / sd)
            lp_tn = torch.where((x < p2) | (x > p3), ninf, lp_n)
            xs = torch.clamp(x, min=torch.finfo(theta.dtype).tiny)
            lp_g = torch.where(x < 0, ninf,
                               (p0 - 1.0) * torch.log(xs) - p1 * x)

            lp = zero
            for code, val in ((UNIFORM, lp_unif), (HALFNORMAL, lp_hn),
                              (NORMAL, lp_n), (TNORMAL, lp_tn),
                              (GAMMA_P, lp_g)):
                lp = torch.where(dd == code, val, lp)
            return torch.sum(lp + jac, dim=-1)

        return log_pdf

    def log_pdf(self, theta: torch.Tensor) -> torch.Tensor:
        """Joint log prior density of theta (sampled space), Jacobian
        included; theta ``(..., d)`` -> ``(...)``."""
        return self.bound(theta.device, theta.dtype)(theta)

    def init_theta(self, inits: Sequence[float]) -> np.ndarray:
        """Map natural-space initial values into the sampled space."""
        x = np.asarray(inits, dtype=np.float64)
        return np.where(self.transforms == LOG,
                        np.log(np.maximum(x, 1e-300)), x)
