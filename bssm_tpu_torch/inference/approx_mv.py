"""Laplace approximation, particle filters and SPDK for multivariate
non-Gaussian models, batched.

Counterpart of ``bssm_tpu/inference/approx_mv.py``.  Every series has its
own family (``MVNGSpec.distributions``, ``GAUSSIAN`` with sd ``phi[j]``
included): the per-series functions of ``core/distributions.py`` apply
column by column and the importance log-weights sum over the series.  The
Laplace iteration stops row by row as ``approx._solve`` does, always from
``spec.initial_mode``; the filters and SPDK mirror the univariate ones with
signals ``(B, n, p)``, take their randomness injected or from a
``torch.Generator``, and resample at every step.

The JAX package reaches no TPU kernel here, and none is written: this is
batched tensor code on either device, thousands of small operations a
Laplace pass.  On the card a chain may run each pass, and a filter's
estimate, as one CUDA graph (``inference/replay.Replay``, passed as
``replay``); the host still tests convergence after every pass.

The approximation reuses the univariate containers: ``approx.ApproxResult``
with ``mode``, ``ytilde`` and ``Htilde`` ``(B, n, p)`` and
``approx.ApproxLoglik`` with the mode-based scales summed over the series,
``(B, n)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import distributions as fam
from ..core.spec import MVNGSpec, with_batch
from ..ops import kalman_mv
from ..ops.resample import ancestor_trace, stratified_indices_from_uniforms
from .approx import (ApproxLoglik, ApproxResult, CONV_TOL, GlobalApprox,
                     MAX_ITER, _col, _solve)
from .particle import (PFResult, SPDKResult, _bsf_run, _draws, _pick,
                       _weigh)


class _Cols(NamedTuple):
    """The per-series leaves with one leading batch axis: y and u
    ``(b, n, p)``, phi ``(b, p)``."""
    y: torch.Tensor
    u: torch.Tensor
    phi: torch.Tensor


def _cols(spec: MVNGSpec) -> _Cols:
    return _Cols(with_batch(spec.y, 2), with_batch(spec.u, 2),
                 with_batch(spec.phi, 1))


def signal_mv(spec, alpha: torch.Tensor) -> torch.Tensor:
    """Linear signals D_t + Z_t alpha_t, ``(B, n, p)`` from alpha
    ``(B, n, m)``."""
    Z = with_batch(spec.Z, 3)                       # (b, nz, p, m)
    D = with_batch(spec.D, 2).to(alpha.dtype)       # (b, nd, p)
    return D + (Z * alpha.unsqueeze(-2)).sum(-1)


def _match_mv(spec: MVNGSpec, mode: torch.Tensor):
    """Per-series Laplace matching at ``mode (B, n, p)``: (ytilde, Htilde),
    each ``(B, n, p)``, ytilde NaN where y is."""
    c = _cols(spec)
    cols_y, cols_H = [], []
    for j, d in enumerate(spec.distributions):
        y = c.y[..., j]
        yt, HH = fam.laplace_match(d, y, c.u[..., j], _col(c.phi[:, j]),
                                   mode[..., j])
        H = torch.sqrt(torch.where(torch.isfinite(HH) & (HH > 0), HH,
                                   torch.ones_like(HH)))
        cols_y.append(torch.where(torch.isfinite(y), yt,
                                  torch.full_like(yt, torch.nan)))
        cols_H.append(H)
    return torch.stack(cols_y, dim=-1), torch.stack(cols_H, dim=-1)


def _laplace_step_mv(spec: MVNGSpec, mode: torch.Tensor):
    """One pass of the iteration: (new mode, Kalman log-likelihood of the
    approximating model at match(mode), mean-squared change), per row."""
    yt, H = _match_mv(spec, mode)
    alpha, ll = kalman_mv.fast_smoother_mv_ll(spec.approx_gaussian(yt, H))
    new_mode = signal_mv(spec, alpha[:, :spec.n])
    diff = torch.square(new_mode - mode).sum((-1, -2)) / spec.n
    return new_mode, ll, diff


def approximate_mv(spec: MVNGSpec, conv_tol: float = CONV_TOL,
                   max_iter: int = MAX_ITER, mode0=None,
                   replay=None) -> ApproxResult:
    """The Laplace iteration of every row from ``spec.initial_mode`` (or
    ``mode0``), stopping row by row.  ``ytilde``/``Htilde`` are those of
    the penultimate mode, the pair the last smoother pass consumed, and
    ``gloglik`` that pass's Kalman log-likelihood.  With ``replay`` every
    pass runs through it (one CUDA graph a shape on the card)."""
    if mode0 is None:
        mode0 = spec.initial_mode
    mode0 = mode0.to(spec.y.dtype)
    # a conv_tol below the dtype's noise floor would always exhaust max_iter
    conv_tol = max(conv_tol, 50.0 * float(torch.finfo(spec.y.dtype).eps))
    step = _laplace_step_mv if replay is None \
        else (lambda s, m: replay(_laplace_step_mv, s, m))
    mode, prev, niter, diff, gll = _solve(spec, mode0, conv_tol, max_iter,
                                          step, core=2)
    yt, H = _match_mv(spec, prev)
    return ApproxResult(mode, yt, H, niter, diff, gll)


def _series_scales(spec: MVNGSpec, mode, yt, H) -> torch.Tensor:
    """The mode-based correction terms summed over the series, ``(B, n)``
    (zero where a series is missing)."""
    c = _cols(spec)
    total = 0.0
    for j, d in enumerate(spec.distributions):
        y = c.y[..., j]
        sc = fam.scales(d, y, c.u[..., j], _col(c.phi[:, j]), mode[..., j],
                        yt[..., j], H[..., j])
        total = total + torch.where(torch.isfinite(y), sc,
                                    torch.zeros_like(sc))
    return total


def _const_term(spec: MVNGSpec, yt, H) -> torch.Tensor:
    c = _cols(spec)
    return sum(fam.const_term(d, c.y[..., j], c.u[..., j],
                              _col(c.phi[:, j]), yt[..., j], H[..., j])
               for j, d in enumerate(spec.distributions))


def mode_scales_mv(spec: MVNGSpec, approx: ApproxResult) -> torch.Tensor:
    return _series_scales(spec, approx.mode, approx.ytilde, approx.Htilde)


def approx_loglik_mv(spec: MVNGSpec, approx: Optional[ApproxResult] = None,
                     conv_tol: float = CONV_TOL, max_iter: int = MAX_ITER,
                     mode0=None, replay=None) -> ApproxLoglik:
    """Approximate log-likelihood: the Kalman log-likelihood of the
    approximating model + the exact constant terms + the scales, every
    series summed."""
    if approx is None:
        approx = approximate_mv(spec, conv_tol, max_iter, mode0, replay)
    gll = approx.gloglik
    if gll is None:
        gll = kalman_mv.log_likelihood_mv(approx.gaussian(spec))
    sc = mode_scales_mv(spec, approx)
    ct = _const_term(spec, approx.ytilde, approx.Htilde)
    return ApproxLoglik(approx, sc, gll + ct + sc.sum(-1), gll)


def approximate_for_is_mv(spec: MVNGSpec,
                          mode: torch.Tensor) -> ApproxLoglik:
    """The approximation rebuilt at a stored mode ``(B, n, p)`` without
    iterating, with its scales and zero log-likelihood terms: what the
    filters and SPDK of the correction consume."""
    yt, H = _match_mv(spec, mode)
    B, dev = mode.shape[0], mode.device
    zero = torch.zeros(B, dtype=spec.y.dtype, device=dev)
    ar = ApproxResult(mode, yt, H, torch.ones(B, dtype=torch.int32,
                                              device=dev), zero)
    return ApproxLoglik(ar, _series_scales(spec, mode, yt, H), zero, zero)


def rebuilt_loglik_mv(spec: MVNGSpec, approx: ApproxResult) -> torch.Tensor:
    """``approx.rebuilt_loglik`` for several series: the approximate
    log-likelihood ``(B,)`` of an approximation rebuilt at a mode."""
    return (kalman_mv.log_likelihood_mv(approx.gaussian(spec))
            + _const_term(spec, approx.ytilde, approx.Htilde)
            + mode_scales_mv(spec, approx).sum(-1))


def global_approximation_mv(model, conv_tol: float = CONV_TOL,
                            max_iter: int = MAX_ITER) -> GlobalApprox:
    """The pseudo-observations ``(n, p)`` of the global approximation,
    solved once for ONE model at ``model.theta_init``."""
    from .filters import spec_of
    ap = approximate_mv(spec_of(model), conv_tol, max_iter)
    return GlobalApprox(ap.ytilde[0], ap.Htilde[0])


def global_approx_loglik_mv(spec: MVNGSpec, ga: GlobalApprox):
    """The global approximation at every row: one fast-smoother pass of
    the approximating model with the frozen pseudo-observations, its mode
    ``(B, n, p)`` and ``ll (B,)`` = Kalman log-likelihood + constant terms
    + the scales at that mode (the JAX package's ``local_approx=False``
    evaluation)."""
    g = spec.approx_gaussian(ga.ytilde, ga.Htilde)
    alpha, gll = kalman_mv.fast_smoother_mv_ll(g)
    mode = signal_mv(spec, alpha[:, :spec.n])
    sc = _series_scales(spec, mode, ga.ytilde, ga.Htilde)
    return gll + _const_term(spec, ga.ytilde, ga.Htilde) + sc.sum(-1), mode


# ---------------------------------------------------------------------------
# particle filters and SPDK
# ---------------------------------------------------------------------------

def _log_weights_mv(spec: MVNGSpec, c: _Cols, sig, t, yt, H):
    """Importance log-weights ``(B, N)`` of particles with signals
    ``sig (B, N, p)`` at time t, summed over the series."""
    total = 0.0
    for j, d in enumerate(spec.distributions):
        total = total + fam.log_weights(
            d, c.y[:, t, None, j], c.u[:, t, None, j], _col(c.phi[:, j]),
            sig[..., j], yt[:, t, None, j], H[:, t, None, j])
    return total


def _particle_signal(spec, alpha: torch.Tensor, t: int) -> torch.Tensor:
    """Signals ``(B, N, p)`` of particles ``alpha (B, N, m)`` at time t."""
    Z = with_batch(spec.Z, 3)
    D = with_batch(spec.D, 2).to(alpha.dtype)
    Zt = Z[:, 0] if Z.shape[1] == 1 else Z[:, t]
    Dt = D[:, 0] if D.shape[1] == 1 else D[:, t]
    return Dt[:, None, :] + alpha @ Zt.transpose(-1, -2)


def psi_filter_mv(spec: MVNGSpec, al: ApproxLoglik, nsim: int,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  us: Optional[torch.Tensor] = None,
                  keep_paths: bool = True):
    """psi-auxiliary particle filter twisted by the approximation ``al``:
    the proposal is the approximating model's smoothing law in its backward
    factorisation (``kalman_mv.smoother_bwd_factors_mv``), generation runs
    t = n..0 and resamples before every step.  Randomness: ``eps (B, n+1,
    N, m)`` and ``us (B, n, N)`` as ``particle.psi_filter``'s, or drawn
    from ``generator``.  Returns a ``PFResult`` (trajectories traced, in
    time order, identity indices), or with ``keep_paths=False`` only the
    log-likelihood estimate ``(B,)``: ``al.loglik`` plus the log-weight."""
    n, m = spec.n, spec.m
    B = al.approx.mode.shape[0]
    dt, dev = spec.y.dtype, spec.y.device
    eps, us = _draws("psi_filter_mv", B, n + 1, nsim, m, dt, dev, generator,
                     eps, us)
    N = eps.shape[2]
    ahat, Lb, Ab = kalman_mv.smoother_bwd_factors_mv(
        al.approx.gaussian(spec))
    c = _cols(spec)
    obs = torch.isfinite(c.y).any(-1)                       # (b, n)
    yt, Ht, scl = al.approx.ytilde, al.approx.Htilde, al.scales
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731

    alpha = ahat[:, n, None, :] + eps[:, 0] @ tr(Lb[:, n])
    nw = torch.full((B, N), 1.0 / N, dtype=dt, device=dev)
    ll = torch.zeros(B, dtype=dt, device=dev) + al.loglik
    alphas, nws, idxs = [alpha], [nw], []
    for s in range(1, n + 1):
        t = n - s
        idx = stratified_indices_from_uniforms(nw, us[:, s - 1])
        alpha = (ahat[:, t, None, :]
                 + (_pick(alpha, idx) - ahat[:, t + 1, None, :])
                 @ tr(Ab[:, t]) + eps[:, s] @ tr(Lb[:, t]))
        lw = _log_weights_mv(spec, c, _particle_signal(spec, alpha, t), t,
                             yt, Ht) - scl[:, t, None]
        inc, nw = _weigh(lw, obs[:, t, None])
        ll = ll + inc
        if keep_paths:
            alphas.append(alpha)
            nws.append(nw)
            idxs.append(idx)
    if not keep_paths:
        return ll
    traced = ancestor_trace(torch.stack(alphas, dim=2),
                            torch.stack(idxs, dim=2)).flip(2)
    identity = torch.arange(N, device=dev)[:, None].expand(B, N, n)
    return PFResult(ll, traced, torch.stack(nws, dim=2), identity)


def _log_obs_mv(spec: MVNGSpec, c: _Cols, sig, t):
    return sum(fam.log_obs_density(d, c.y[:, t, None, j],
                                   c.u[:, t, None, j], _col(c.phi[:, j]),
                                   sig[..., j])
               for j, d in enumerate(spec.distributions))


def bsf_filter_mv(spec: MVNGSpec, nsim: int,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  us: Optional[torch.Tensor] = None) -> PFResult:
    """Bootstrap particle filter of a multivariate non-Gaussian model:
    ``particle.bsf_filter`` (the same randomness, outputs and order) with
    the observation log-densities summed over the series; ``loglik``
    includes every series' exact constants."""
    c = _cols(spec)
    pf = _bsf_run("bsf_filter_mv", spec, nsim, generator, eps, us,
                  lambda alpha, t: _log_obs_mv(
                      spec, c, _particle_signal(spec, alpha, t), t))
    const = sum(fam.obs_log_const(d, c.y[..., j], c.u[..., j],
                                  _col(c.phi[:, j]))
                for j, d in enumerate(spec.distributions))
    return pf._replace(loglik=pf.loglik + const)


def spdk_weights_mv(spec: MVNGSpec, al: ApproxLoglik, alpha: torch.Tensor):
    """SPDK importance weights of draws ``alpha (B, N, n+1, m)`` from the
    approximating model's smoothing law: ``(loglik (B,), normalised
    weights (B, N))``, loglik = ``al.loglik`` + log of the mean weight."""
    n = spec.n
    c = _cols(spec)
    Z = with_batch(spec.Z, 3)[:, None]                  # (b, 1, nz, p, m)
    D = with_batch(spec.D, 2).to(alpha.dtype)[:, None]  # (b, 1, nd, p)
    sig = D + (Z * alpha[..., :n, None, :]).sum(-1)     # (B, N, n, p)
    yt, H = al.approx.ytilde[:, None], al.approx.Htilde[:, None]
    w = 0.0
    for j, d in enumerate(spec.distributions):
        phi = _col(c.phi[:, j]).unsqueeze(-1)            # (b, 1, 1)
        lw = fam.log_weights(d, c.y[:, None, :, j], c.u[:, None, :, j], phi,
                             sig[..., j], yt[..., j], H[..., j])
        w = w + lw.sum(-1)
    w = w - al.scales.sum(-1)[:, None]
    mx = w.max(dim=-1, keepdim=True).values
    we = torch.exp(w - mx)
    loglik = al.loglik + torch.log(we.mean(-1)) + mx[:, 0]
    return loglik, we / we.sum(-1, keepdim=True)


def spdk_sample_mv(spec: MVNGSpec, al: ApproxLoglik, nsim: int,
                   generator: Optional[torch.Generator] = None,
                   antithetic: bool = True, *,
                   um: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   eta: Optional[torch.Tensor] = None) -> SPDKResult:
    """SPDK importance sampling of every row: ``nsim`` simulation-smoother
    draws of the approximating model (``kalman_mv.simulate_states_mv``;
    ``um``/``eps``/``eta`` inject its normals) weighed by
    ``spdk_weights_mv``."""
    alpha = kalman_mv.simulate_states_mv(al.approx.gaussian(spec), nsim,
                                         generator, antithetic, um=um,
                                         eps=eps, eta=eta)
    ll, w = spdk_weights_mv(spec, al, alpha)
    return SPDKResult(ll, alpha, w)


def approx_state_draws_mv(spec: MVNGSpec, modes: torch.Tensor,
                          generator=None, *, um=None, eps=None,
                          eta=None) -> torch.Tensor:
    """One draw of the states of every row ``(B, n+1, m)`` from the
    approximating model rebuilt at its stored mode ``(B, n, p)``: the
    approximate run's full output (the JAX package's ``_approx_state_draws``
    calls the univariate rebuild here and fails on a multivariate model)."""
    ar = approximate_for_is_mv(spec, modes).approx
    return kalman_mv.simulate_states_mv(ar.gaussian(spec), 1, generator,
                                        False, um=um, eps=eps, eta=eta)[:, 0]
