"""Univariate-observation Kalman filtering and smoothing, batched loops.

Counterpart of ``bssm_tpu/ops/kalman.py``: the same masked, Joseph-form
recursions, written as a Python loop over time with every batch row
advanced together by broadcasting tensor operations.  These functions are
the PLAIN versions of the hand-written kernels in ``ops/cuda_kalman.py``
(``log_likelihood`` of the Kalman log-likelihood kernel and of the Laplace
solve, ``fast_smoother_ll`` of the fast-smoother kernel and of the Laplace
solve, ``smoother_bwd_factors`` of the RTS-factor kernel): the CPU tests
compare them with the JAX package, and on the GPU they serve only as the
yardstick the kernels are held against.  ``fast_smoother`` (the classic
two-pass form, optionally reusing the gains of another series) and
``smoother`` (J-form, with variances) have no kernel.

  F_t = Z' P Z + H^2               (innovation variance)
  K_t = P Z / F
  a_{t+1} = C + T (a + K v),  v = y - D - Z' a
  P_{t+1} = T ((I-KZ')P(I-KZ')' + K H^2 K') T' + R R'   (Joseph form)
with the "no update" branch when y is missing or F <= zero_tol.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.spec import LGSpec, at_t, with_batch

LOG2PI = 1.8378770664093453
ZERO_TOL = 1e-8


class FilterResult(NamedTuple):
    at: torch.Tensor    # (B, n+1, m)  predicted means
    att: torch.Tensor   # (B, n, m)    filtered means
    Pt: torch.Tensor    # (B, n+1, m, m)
    Ptt: torch.Tensor   # (B, n, m, m)
    logLik: torch.Tensor  # (B,)
    vt: torch.Tensor    # (B, n) innovations (0 where missing)
    Ft: torch.Tensor    # (B, n) innovation variances (1 where masked)
    Kt: torch.Tensor    # (B, n, m) gains (0 where missing)


class _Sys(NamedTuple):
    """A spec's leaves, each with one leading batch axis (size 1 or B)."""
    y: torch.Tensor     # (b, n)
    obs: torch.Tensor   # (b, n)
    Z: torch.Tensor     # (b, nz, m)
    HH: torch.Tensor    # (b, nh)
    T: torch.Tensor     # (b, nt, m, m)
    RR: torch.Tensor    # (b, nr, m, m)
    D: torch.Tensor     # (b, nd)
    C: torch.Tensor     # (b, nc, m)
    a1: torch.Tensor    # (b, m)
    P1: torch.Tensor    # (b, m, m)


def _sys(spec: LGSpec) -> _Sys:
    y = with_batch(spec.y, 1)
    return _Sys(y, torch.isfinite(y), with_batch(spec.Z, 2),
                with_batch(spec.HH, 1), with_batch(spec.T, 3),
                with_batch(spec.RR, 3), with_batch(spec.D, 1).to(y.dtype),
                with_batch(spec.C, 2), with_batch(spec.a1, 1),
                with_batch(spec.P1, 2))


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (b, i, j) x (b, j) -> (b, i)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _sym(P: torch.Tensor) -> torch.Tensor:
    return 0.5 * (P + P.transpose(-1, -2))


def _update(a, P, y, obs, Z, HH, T, RR, D, C):
    """One masked predict+update step for every batch row; a ``(b, m)``,
    P ``(b, m, m)``, y/obs/HH/D ``(b,)``, Z/C ``(b, m)``, T/RR ``(b, m, m)``."""
    m = a.shape[-1]
    # a missing y may come with a NaN pseudo-variance (Laplace
    # approximations leave H undefined there); keep the algebra NaN-free
    HH = torch.where(torch.isfinite(HH), HH, torch.ones_like(HH))
    PZ = _mv(P, Z)
    F = (Z * PZ).sum(-1) + HH
    ok = obs & (F > ZERO_TOL)
    okf = ok.to(a.dtype)
    Fs = torch.where(ok, F, torch.ones_like(F))
    v = torch.where(ok, y - D - (Z * a).sum(-1), torch.zeros_like(F))
    K = torch.where(ok.unsqueeze(-1), PZ / Fs.unsqueeze(-1),
                    torch.zeros_like(PZ))
    att = a + K * v.unsqueeze(-1)
    a_next = C + _mv(T, att)
    ImKZ = torch.eye(m, dtype=a.dtype, device=a.device) \
        - K.unsqueeze(-1) * Z.unsqueeze(-2)
    P_upd = ImKZ @ P @ ImKZ.transpose(-1, -2) \
        + HH[..., None, None] * (K.unsqueeze(-1) * K.unsqueeze(-2))
    o = okf[..., None, None]
    Ptt = _sym(o * P_upd + (1.0 - o) * P)
    P_next = _sym(T @ Ptt @ T.transpose(-1, -2) + RR)
    ll = okf * (-0.5 * (LOG2PI + torch.log(Fs) + v * v / Fs))
    return a_next, P_next, att, Ptt, v, Fs, K, ll, ok


def _degenerate(spec: LGSpec) -> torch.Tensor:
    """All noise zero -> the log-likelihood is defined as -inf."""
    hh = with_batch(spec.HH, 1).sum(-1)
    rr = with_batch(spec.R, 3).abs().sum((-1, -2, -3))
    return (hh + rr) < ZERO_TOL


def degenerate_h2rr(spec: LGSpec) -> torch.Tensor:
    """The degenerate-model rule of the JAX package's fused-kernel wrappers,
    which its linear-Gaussian MCMC target follows on the TPU: H^2 summed
    over time (a time-invariant H counts n times) plus sum |R R'|, below
    ZERO_TOL.  ``_degenerate`` sums H^2 once and |R| instead, so with state
    sds near 1e-5 and a tiny observation sd the two rules disagree."""
    n = spec.n
    hh = with_batch(spec.HH, 1)
    hh = hh.expand(-1, n) if hh.shape[1] == 1 else hh
    rr = with_batch(spec.RR, 3).abs().sum((-1, -2, -3))
    return (hh.sum(-1) + rr) < ZERO_TOL


def _steps(s: _Sys):
    n = s.y.shape[1]
    for t in range(n):
        yield (s.y[:, t], s.obs[:, t], at_t(s.Z, t), at_t(s.HH, t),
               at_t(s.T, t), at_t(s.RR, t), at_t(s.D, t), at_t(s.C, t))


def log_likelihood(spec: LGSpec, degenerate=_degenerate) -> torch.Tensor:
    """Marginal log-likelihood via the Kalman filter, ``(B,)``; -inf where
    ``degenerate(spec)`` calls the model degenerate."""
    s = _sys(spec)
    a, P, acc = s.a1, s.P1, 0.0
    for xs in _steps(s):
        a, P, _, _, _, _, _, ll, _ = _update(a, P, *xs)
        acc = acc + ll
    return torch.where(degenerate(spec), torch.full_like(acc, -torch.inf),
                       acc)


def kfilter(spec: LGSpec) -> FilterResult:
    """Full Kalman filter storing predicted and filtered moments."""
    s = _sys(spec)
    a, P = s.a1, s.P1
    at, Pt, att, Ptt, vt, Ft, Kt = [], [], [], [], [], [], []
    acc = 0.0
    for xs in _steps(s):
        a2, P2, att_t, Ptt_t, v, F, K, ll, _ = _update(a, P, *xs)
        B = v.shape[0]
        at.append(a.expand(B, -1))
        Pt.append(P.expand(B, -1, -1))
        att.append(att_t)
        Ptt.append(Ptt_t)
        vt.append(v)
        Ft.append(F)
        Kt.append(K)
        acc = acc + ll
        a, P = a2, P2
    at.append(a)
    Pt.append(P)
    st = lambda xs: torch.stack(xs, dim=1)                   # noqa: E731
    return FilterResult(st(at), st(att), st(Pt), st(Ptt), acc, st(vt),
                        st(Ft), st(Kt))


def fast_smoother_ll(spec: LGSpec, degenerate=_degenerate):
    """(smoothed means ``(B, n+1, m)``, filter log-likelihood ``(B,)``) from
    one shared forward pass.  Means come from the moment identity
    alphahat_t = a_t + P_t r_{t-1} (Durbin-Koopman eq. 4.44); the
    log-likelihood is -inf where ``degenerate(spec)``."""
    r = kfilter(spec)
    s = _sys(spec)
    n, m = s.y.shape[1], s.a1.shape[-1]
    ok = s.obs & (r.Ft > ZERO_TOL)
    eye = torch.eye(m, dtype=s.y.dtype, device=s.y.device)
    rc = torch.zeros_like(r.at[:, 0])
    rprev = [None] * n
    for t in range(n - 1, -1, -1):
        Z, T = at_t(s.Z, t), at_t(s.T, t)
        okf = ok[:, t].to(s.y.dtype).unsqueeze(-1)
        K, v, F = r.Kt[:, t], r.vt[:, t], r.Ft[:, t]
        L = T @ (eye - K.unsqueeze(-1) * Z.unsqueeze(-2))
        r_obs = Z * (v / F).unsqueeze(-1) + _mv(L.transpose(-1, -2), rc)
        r_mis = _mv(T.transpose(-1, -2), rc)
        rc = okf * r_obs + (1 - okf) * r_mis
        rprev[t] = rc
    rprev = torch.stack(rprev, dim=1)                        # (B, n, m)
    alphas = r.at[:, :-1] + _mv(r.Pt[:, :-1], rprev)
    alpha = torch.cat([alphas, r.at[:, -1:]], dim=1)
    ll = torch.where(degenerate(spec),
                     torch.full_like(r.logLik, -torch.inf), r.logLik)
    return alpha, ll


class SmootherStats(NamedTuple):
    """Forward-pass quantities reused by every smoothing variant."""
    vt: torch.Tensor    # (B, n)
    Ft: torch.Tensor    # (B, n)   (1 where masked)
    Kt: torch.Tensor    # (B, n, m) (0 where masked)
    ok: torch.Tensor    # (B, n)   update mask
    at: torch.Tensor    # (B, n+1, m)
    Pt: torch.Tensor    # (B, n+1, m, m)


def forward_stats(spec: LGSpec) -> SmootherStats:
    r = kfilter(spec)
    ok = _sys(spec).obs & (r.Ft > ZERO_TOL)
    return SmootherStats(r.vt, r.Ft, r.Kt, ok, r.at, r.Pt)


def fast_smoother(spec: LGSpec,
                  stats: SmootherStats | None = None) -> torch.Tensor:
    """Mean-only two-pass smoother, E[alpha_t | y], ``(B, n+1, m)``.

    Given ``stats`` (of a model with the same system), the y-independent
    gains (Ft, Kt) are reused and only the O(n m) mean recursions run
    against ``spec.y``: what a simulation smoother needs for each synthetic
    series."""
    if stats is None:
        return _mean_passes(spec, forward_stats(spec))
    s = _sys(spec)
    a, vt = s.a1, []
    for t in range(s.y.shape[1]):
        F, K = stats.Ft[:, t], stats.Kt[:, t]
        ok = s.obs[:, t] & (F > ZERO_TOL)
        v = s.y[:, t] - at_t(s.D, t) - (at_t(s.Z, t) * a).sum(-1)
        v = torch.where(ok, v, torch.zeros_like(v))
        a = at_t(s.C, t) + _mv(at_t(s.T, t), a + K * v.unsqueeze(-1))
        vt.append(v)
    vt = torch.stack(vt, dim=1)
    return _mean_passes(spec, stats._replace(
        vt=vt, ok=s.obs & (stats.Ft > ZERO_TOL)))


def _mean_passes(spec: LGSpec, stats: SmootherStats) -> torch.Tensor:
    """Backward r-recursion (r_{n-1} = 0) and forward mean pass
    alpha_0 = a1 + P1 r_{-1}, alpha_{t+1} = C + T alpha_t + R R' r_t of the
    fast smoother."""
    s = _sys(spec)
    n, m = s.y.shape[1], s.a1.shape[-1]
    dt = stats.vt.dtype
    eye = torch.eye(m, dtype=dt, device=stats.vt.device)
    r = torch.zeros(stats.vt.shape[0], m, dtype=dt, device=stats.vt.device)
    rt = [None] * n
    for t in range(n - 1, -1, -1):
        rt[t] = r
        Z, T = at_t(s.Z, t), at_t(s.T, t)
        okf = stats.ok[:, t].to(dt).unsqueeze(-1)
        K, v, F = stats.Kt[:, t], stats.vt[:, t], stats.Ft[:, t]
        L = T @ (eye - K.unsqueeze(-1) * Z.unsqueeze(-2))
        r_obs = Z * (v / F).unsqueeze(-1) + _mv(L.transpose(-1, -2), r)
        r = okf * r_obs + (1 - okf) * _mv(T.transpose(-1, -2), r)
    alpha = s.a1 + _mv(s.P1, r)
    alphas = [alpha]
    for t in range(n):
        alpha = at_t(s.C, t) + _mv(at_t(s.T, t), alpha) \
            + _mv(at_t(s.RR, t), rt[t])
        alphas.append(alpha)
    return torch.stack(alphas, dim=1)


def smoother_bwd_factors(spec: LGSpec):
    """(ahat, Lb, Ab): the BACKWARD (FFBS) factorisation of the smoothing
    law, the psi-APF proposal factors.

        alpha_n ~ N(ahat_n, P_{n|n-1}),
        alpha_t | alpha_{t+1} ~ N(ahat_t + J_t (alpha_{t+1} - ahat_{t+1}),
                                  Ptt_t - J_t P_{t+1|t} J_t'),
    with J_t = Ptt_t T_t' P_{t+1|t}^+ the smoothing gain.  The gain needs
    only filter quantities whose per-direction scales match, so it is
    stable in float32 where a pseudo-inverse of the smoothed covariance is
    not; the conditional covariance is formed in its all-additive Joseph
    form (I - J T) Ptt (I - J T)' + J RR J'.

    Returns ahat ``(B, n+1, m)``, Lb and Ab ``(B, n+1, m, m)`` where
    Ab[t] = J_t for t < n, Ab[n] = 0, Lb[t] a square-root factor of the
    backward conditional covariance and Lb[n] = factor(P_{n|n-1})."""
    from .chol import _psd_factor, _psd_pinv
    r = kfilter(spec)
    s = _sys(spec)
    n, m = s.y.shape[1], s.a1.shape[-1]
    eye = torch.eye(m, dtype=s.y.dtype, device=s.y.device)
    ahat_next = r.at[:, -1]
    ahat, Lb, Ab = [None] * (n + 1), [None] * (n + 1), [None] * (n + 1)
    ahat[n] = ahat_next
    Lb[n] = _psd_factor(r.Pt[:, -1])
    Ab[n] = torch.zeros_like(Lb[n])
    for t in range(n - 1, -1, -1):
        T, RR = at_t(s.T, t), at_t(s.RR, t)
        Ptt = r.Ptt[:, t]
        J = Ptt @ T.transpose(-1, -2) @ _psd_pinv(r.Pt[:, t + 1])
        ahat_next = r.att[:, t] + _mv(J, ahat_next - r.at[:, t + 1])
        ImJT = eye - J @ T
        Sig = _sym(ImJT @ Ptt @ ImJT.transpose(-1, -2)
                   + J @ RR @ J.transpose(-1, -2))
        ahat[t], Lb[t], Ab[t] = ahat_next, _psd_factor(Sig), J
    st = lambda xs: torch.stack(xs, dim=1)                   # noqa: E731
    return st(ahat), st(Lb), st(Ab)


class SmoothResult(NamedTuple):
    alphahat: torch.Tensor  # (B, n+1, m)
    Vt: torch.Tensor        # (B, n+1, m, m)
    ccov: torch.Tensor      # (B, n+1, m, m) Cov(alpha_t, alpha_{t+1} | y); [n]=0
    logLik: torch.Tensor    # (B,)


def smoother(spec: LGSpec, want_ccov: bool = False) -> SmoothResult:
    """Smoothed means, variances and lag-one cross-covariances by the
    J-form recursion
        J_t = Ptt_t T_t' P_{t+1|t}^+,
        alphahat_t = att_t + J_t (alphahat_{t+1} - a_{t+1}),
        V_t = Ptt_t + J_t (V_{t+1} - P_{t+1|t}) J_t',
    which float32 keeps where the N-recursion V = P - P N P cancels a
    diffuse P1 away.  ``ccov`` is computed whatever ``want_ccov`` says, as
    in the JAX package; the flag is taken for its call form only."""
    from .chol import _psd_pinv
    r = kfilter(spec)
    s = _sys(spec)
    n, m = s.y.shape[1], s.a1.shape[-1]
    ahat_next, V_next = r.at[:, -1], r.Pt[:, -1]
    ahat, Vt, ccov = [None] * (n + 1), [None] * (n + 1), [None] * (n + 1)
    ahat[n], Vt[n], ccov[n] = ahat_next, V_next, torch.zeros_like(V_next)
    for t in range(n - 1, -1, -1):
        T, Ptt, P_next = at_t(s.T, t), r.Ptt[:, t], r.Pt[:, t + 1]
        J = Ptt @ T.transpose(-1, -2) @ _psd_pinv(P_next)
        ccov[t] = J @ V_next
        ahat_next = r.att[:, t] + _mv(J, ahat_next - r.at[:, t + 1])
        V_next = _sym(Ptt + J @ (V_next - P_next) @ J.transpose(-1, -2))
        ahat[t], Vt[t] = ahat_next, V_next
    st = lambda xs: torch.stack(xs, dim=1)                   # noqa: E731
    return SmoothResult(st(ahat), st(Vt), st(ccov), r.logLik)
