"""Durbin-Koopman simulation smoother, with antithetic variates.

Counterpart of ``bssm_tpu/ops/simsmooth.py``: draw an unconditional
trajectory (alpha+, y+), smooth the synthetic data, and combine
alpha_sim = alphahat - E[alpha | y+] + alpha+.

The randomness is injectable, as in the rest of the package: standard
normals ``um (B, m)`` for the initial state, ``eps (B, n)`` for the
observations and ``eta (B, n, k)`` for the state disturbances, or a
``torch.Generator`` from which they are drawn in that order.  The smoothed
means of all draws go through ``ops/cuda_kalman.fast_smoother_ll``: one
launch of the fast-smoother kernel for the whole batch on the GPU, its plain
version on the CPU and for models the kernel does not take
(``cuda_kalman.routed_fast_smoother_ll``).  Its moment-identity means equal the classic
``kalman.fast_smoother``'s, which the JAX package uses here, up to
roundoff.  The JAX package reuses one model's gains across its draws; the
kernel recomputes them for every series, which gives the same means.

``simulate_states_batched`` draws for a batch of models at once (SPDK
importance sampling over the stored draws of a correction, or over the
chains): two smoother launches, one for the B rows' alphahat, one for all
B x ceil(nsim/2) simulated series.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import rows
from ..core.spec import LGSpec, at_t, with_batch
from . import cuda_kalman
from .chol import psd_chol
from .kalman import _mv, _sys


def _normals(spec: LGSpec, B: int, generator, um, eps, eta):
    """The injected draws, or fresh ones from ``generator``."""
    given = [x is not None for x in (um, eps, eta)]
    if any(given):
        if not all(given):
            raise ValueError("give all of um, eps and eta, or none")
        return um, eps, eta
    kw = dict(dtype=spec.y.dtype, device=spec.y.device, generator=generator)
    return (rows.randn((B, spec.m), **kw), rows.randn((B, spec.n), **kw),
            rows.randn((B, spec.n, spec.k), **kw))


def _simulate_prior_and_obs(spec: LGSpec, zero_mean: bool, um, eps, eta):
    """Unconditional draws ``(alpha+ (B, n+1, m), y+ (B, n))``.  With
    ``zero_mean`` the intercepts and a1 are dropped (the single-draw form of
    the simulation smoother)."""
    s = _sys(spec)
    R = with_batch(spec.R, 3)
    H = torch.sqrt(with_batch(spec.HH, 1))
    a = _mv(psd_chol(s.P1), um)
    if not zero_mean:
        a = s.a1 + a
    aplus, ysim = [a], []
    for t in range(s.y.shape[1]):
        ysim.append((at_t(s.Z, t) * a).sum(-1) + at_t(H, t) * eps[:, t])
        a = _mv(at_t(s.T, t), a) + _mv(at_t(R, t), eta[:, t])
        if not zero_mean:
            a = at_t(s.C, t) + a
        aplus.append(a)
    ysim = torch.stack(ysim, dim=1)
    if not zero_mean:
        ysim = ysim + s.D
    return torch.stack(aplus, dim=1), ysim


def simulate_states_single(spec: LGSpec, generator=None, *,
                           um: Optional[torch.Tensor] = None,
                           eps: Optional[torch.Tensor] = None,
                           eta: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One posterior draw of the state trajectory for every batch row of
    ``spec``, ``(B, n+1, m)``."""
    B = um.shape[0] if um is not None else (spec.batch or 1)
    um, eps, eta = _normals(spec, B, generator, um, eps, eta)
    aplus, ysim = _simulate_prior_and_obs(spec, True, um, eps, eta)
    y = with_batch(spec.y, 1)
    ystar = torch.where(torch.isfinite(y), y - ysim, y)
    cond, _ = cuda_kalman.routed_fast_smoother_ll(spec._replace(y=ystar))
    return cond + aplus


def simulate_states(spec: LGSpec, nsim: int, generator=None,
                    use_antithetic: bool = True, *,
                    um: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None,
                    eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nsim`` posterior draws of one model's states, ``(nsim, n+1, m)``.
    With antithetic variates, draw i + ceil(nsim/2) is 2 alphahat - draw i;
    the injected normals then cover the ceil(nsim/2) base draws."""
    if (spec.batch or 1) != 1:
        raise ValueError("simulate_states draws for one model; batch the "
                         "models with simulate_states_single")
    if nsim == 1:
        return simulate_states_single(spec, generator, um=um, eps=eps,
                                      eta=eta)
    alphahat, _ = cuda_kalman.routed_fast_smoother_ll(spec)
    n_base = (nsim + 1) // 2 if use_antithetic else nsim
    um, eps, eta = _normals(spec, n_base, generator, um, eps, eta)
    aplus, ysim = _simulate_prior_and_obs(spec, False, um, eps, eta)
    y = with_batch(spec.y, 1)
    ystar = torch.where(torch.isfinite(y), ysim, y)
    cond, _ = cuda_kalman.routed_fast_smoother_ll(spec._replace(y=ystar))
    base = alphahat - cond + aplus
    if use_antithetic:
        base = torch.cat([base, 2.0 * alphahat - base], dim=0)
    return base[:nsim]


def repeat_rows(spec: LGSpec, reps: int) -> LGSpec:
    """``spec`` with every batched leaf repeated ``reps`` times row by row
    (row b becomes rows b reps .. b reps + reps - 1); shared leaves stay
    shared.  The kernels read a leaf with one batch stride, so a per-model
    system reaches ``reps`` series of one model only as a copy: for m = 2
    float32 that is at most 72 bytes a series (Z, T, R, a1, P1, C)."""
    from ..core.spec import CORE_NDIM
    new = {}
    for f in LGSpec._fields:
        x = getattr(spec, f)
        if x.dim() == CORE_NDIM[f] + 1 and x.shape[0] > 1:
            new[f] = x.repeat_interleave(reps, dim=0)
    return spec._replace(**new)


def simulate_states_batched(spec: LGSpec, nsim: int, generator=None,
                            use_antithetic: bool = True, *,
                            um: Optional[torch.Tensor] = None,
                            eps: Optional[torch.Tensor] = None,
                            eta: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``nsim`` posterior draws of the states of every batch row of
    ``spec``, ``(B, nsim, n+1, m)``: ``simulate_states`` row by row.  Two
    smoother calls (``routed_fast_smoother_ll``): the B rows of alphahat,
    and the B x n_base simulated series, n_base = ceil(nsim/2) with
    antithetic variates (draw i + n_base is 2 alphahat - draw i), else
    nsim.  Injected normals: ``um (B, n_base, m)``, ``eps (B, n_base, n)``,
    ``eta (B, n_base, n, k)``; else drawn from ``generator`` in that
    order."""
    B = um.shape[0] if um is not None else (spec.batch or 1)
    n, m, k = spec.n, spec.m, spec.k
    n_base = (nsim + 1) // 2 if use_antithetic else nsim
    if um is None:
        kw = dict(dtype=spec.y.dtype, device=spec.y.device,
                  generator=generator)
        um = rows.randn((B, n_base, m), **kw)
        eps = rows.randn((B, n_base, n), **kw)
        eta = rows.randn((B, n_base, n, k), **kw)
    elif eps is None or eta is None:
        raise ValueError("give all of um, eps and eta, or none")
    alphahat, _ = cuda_kalman.routed_fast_smoother_ll(spec)      # (B, n+1, m)
    rep = repeat_rows(spec, n_base)
    aplus, ysim = _simulate_prior_and_obs(
        rep, False, um.reshape(B * n_base, m), eps.reshape(B * n_base, n),
        eta.reshape(B * n_base, n, k))
    y = with_batch(spec.y, 1)
    y = y.repeat_interleave(n_base, dim=0) if y.shape[0] > 1 else y
    ystar = torch.where(torch.isfinite(y), ysim, y)
    cond, _ = cuda_kalman.routed_fast_smoother_ll(rep._replace(y=ystar))
    base = (alphahat[:, None] - cond.reshape(B, n_base, n + 1, m)
            + aplus.reshape(B, n_base, n + 1, m))
    if use_antithetic:
        base = torch.cat([base, 2.0 * alphahat[:, None] - base], dim=1)
    return base[:, :nsim]
