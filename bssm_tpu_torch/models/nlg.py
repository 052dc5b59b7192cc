"""General nonlinear-Gaussian state-space models.

  y_t       = Z(t, alpha_t, theta) + H(t, alpha_t, theta) eps_t
  alpha_t+1 = T(t, alpha_t, theta) + R(t, alpha_t, theta) eta_t

Counterpart of ``bssm_tpu/models/nlg.py``.  The JAX package takes model
functions of one state and one theta and lays ``vmap`` / ``jacfwd`` over
them; here they are **torch functions batched over a leading row axis**,
like the ``update_fn`` / ``prior_fn`` of ``models/ssm.py``:

  Z_fn(t, alpha, theta) -> (R, p)     H_fn(t, alpha, theta) -> (R, p, p)
  T_fn(t, alpha, theta) -> (R, m)     R_fn(t, alpha, theta) -> (R, m, k)
  a1_fn(theta) -> (B, m)              P1_fn(theta) -> (B, m, m)
  log_prior(theta) -> (B,)

with ``t`` of shape ``(R,)`` (int64), ``alpha (R, m)``, ``theta (R, d)``
and ``(B, d)``.  H is a lower factor of the observation covariance H H'.
Row r of an output depends on row r of the inputs only; a function makes
no host synchronisation and no Python branch on tensor values, so that it
runs inside a CUDA-graph capture.  ``t`` is a tensor so that one call
evaluates every (row, time) pair of a batch (R = B n) or every particle
of a filter step (R = B N).  Known parameters are closed over.

The Jacobians ``Z_gn(t, alpha, theta) -> (R, p, m)`` and ``T_gn -> (R, m,
m)`` default to forward mode (``forward_jacobian``): ``torch.func.jvp``
along the m basis directions of alpha, vmapped over the directions, which
for functions with independent rows is ``jacfwd`` of every row at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import DEFAULT_DTYPE, resolve_device
from ..core.spec import Replaceable
from .base import Model


@dataclasses.dataclass(frozen=True)
class NLGSpec(Replaceable):
    """A nonlinear model at a batch of thetas: ``y (n, p)`` shared by the
    rows, ``theta (B, d)``; the functions and sizes are static fields."""
    y: torch.Tensor
    theta: torch.Tensor
    Z_fn: Callable
    H_fn: Callable
    T_fn: Callable
    R_fn: Callable
    Z_gn: Callable
    T_gn: Callable
    a1_fn: Callable
    P1_fn: Callable
    m: int = 1
    k: int = 1
    iekf_iter: int = 0
    max_iter: int = 100
    conv_tol: float = 1e-8

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def p(self) -> int:
        return self.y.shape[1]

    @property
    def batch(self) -> int:
        return self.theta.shape[0]

    @property
    def obs_mask(self) -> torch.Tensor:
        return torch.isfinite(self.y)

    def a1(self) -> torch.Tensor:
        return self.a1_fn(self.theta)

    def P1(self) -> torch.Tensor:
        return self.P1_fn(self.theta)


def forward_jacobian(fn: Callable) -> Callable:
    """The Jacobian in alpha of a batched model function, ``(R, out, m)``:
    one forward-mode pass per basis direction, the directions vmapped."""
    def jac(t, alpha, theta):
        eye = torch.eye(alpha.shape[-1], dtype=alpha.dtype,
                        device=alpha.device)

        def along(v):
            return torch.func.jvp(lambda a: fn(t, a, theta), (alpha,),
                                  (v.expand_as(alpha),))[1]

        return torch.func.vmap(along, out_dims=-1)(eye)
    return jac


def ssm_nlg(y, Z_fn, H_fn, T_fn, R_fn, *, m: int, k: Optional[int] = None,
            a1_fn=None, P1_fn=None, Z_gn=None, T_gn=None,
            theta_init=(), log_prior=None, theta_names=None,
            iekf_iter: int = 0, max_iter: int = 100, conv_tol: float = 1e-8,
            dtype: torch.dtype = DEFAULT_DTYPE, device=None) -> Model:
    """A nonlinear-Gaussian model from batched torch functions (see the
    module docstring for their contract).  ``y`` is ``(n,)`` or ``(n, p)``
    with NaN for a missing value; ``a1_fn`` / ``P1_fn`` default to zero and
    the identity, ``Z_gn`` / ``T_gn`` to ``forward_jacobian``, the prior to
    a flat one.  theta is sampled untransformed.  ``iekf_iter`` sets the
    iterated EKF's update iterations, ``max_iter`` / ``conv_tol`` the mode
    approximation's Gauss-Newton loop.  ``device=None`` means the CUDA
    device (raises when there is none)."""
    device = resolve_device(device)
    y_np = np.asarray(y, np.float64)
    if y_np.ndim == 1:
        y_np = y_np[:, None]
    yt = torch.as_tensor(y_np, dtype=dtype, device=device)
    k = m if k is None else k

    if a1_fn is None:
        def a1_fn(th):
            return torch.zeros(th.shape[0], m, dtype=th.dtype,
                               device=th.device)
    if P1_fn is None:
        def P1_fn(th):
            return torch.eye(m, dtype=th.dtype, device=th.device).expand(
                th.shape[0], m, m)
    Z_gn = forward_jacobian(Z_fn) if Z_gn is None else Z_gn
    T_gn = forward_jacobian(T_fn) if T_gn is None else T_gn
    theta0 = np.atleast_1d(np.asarray(theta_init, np.float64))

    def build(theta: torch.Tensor) -> NLGSpec:
        theta = torch.atleast_2d(torch.as_tensor(theta)).to(
            dtype=dtype, device=device)
        return NLGSpec(y=yt, theta=theta, Z_fn=Z_fn, H_fn=H_fn, T_fn=T_fn,
                       R_fn=R_fn, Z_gn=Z_gn, T_gn=T_gn, a1_fn=a1_fn,
                       P1_fn=P1_fn, m=m, k=k, iekf_iter=int(iekf_iter),
                       max_iter=int(max_iter), conv_tol=float(conv_tol))

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
                 kind="nlg", device=device, dtype=dtype,
                 extra={"m": m, "n": y_np.shape[0], "p": y_np.shape[1]})
