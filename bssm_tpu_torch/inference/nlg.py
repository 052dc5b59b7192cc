"""Inference for nonlinear-Gaussian models, batched: the extended (and
iterated) Kalman filter, the unscented Kalman filter, extended Kalman
smoothing, the mode approximation by damped Gauss-Newton, the psi-auxiliary
particle filter with transition-ratio weights, the bootstrap filter and the
extended Kalman particle filter.

Counterpart of ``bssm_tpu/inference/nlg.py``.  Every function takes an
``NLGSpec`` whose ``theta`` holds B rows and advances all of them together;
row b's results equal the JAX package's for that row's theta alone.  The
model functions are evaluated once a step for every row (or every particle
of every row), and where the JAX package maps over time (the
linearisation, the signal density, the scales) once for every (row, time)
pair: only the filters stay a chain.  Loops that JAX runs as
``while_loop`` under ``vmap`` (the iterated EKF update, the Gauss-Newton
iteration) run here with per-row masks, a finished row keeping its
values; the Gauss-Newton loop tests on the host once a pass.

The JAX package reaches no TPU kernel here, and none is written: the
linearised model is time varying, which the Kalman kernels do not take.
On the card a chain may run each block it repeats (an EKF log-likelihood,
a Gauss-Newton pass, a filter's estimate) as one CUDA graph
(``inference/replay.Replay``, passed as ``replay``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.spec import MVLGSpec, with_batch
from ..models.nlg import NLGSpec
from ..ops import kalman_mv
from ..ops.chol import psd_chol
from ..ops.dmvnorm import dmvnorm
from ..ops.kalman import _mv, _sym
from ..ops.kalman_mv import _cho_solve
from ..ops.resample import ancestor_trace, stratified_indices_from_uniforms
from .particle import PFResult, _draws, _lse_update, _pick

LOG2PI = 1.8378770664093453


def _tr(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _thetas(spec: NLGSpec, B: int, per: int) -> torch.Tensor:
    """theta of B rows, each repeated ``per`` times, ``(B per, d)``."""
    th = spec.theta.expand(B, -1) if spec.theta.shape[0] == 1 \
        else spec.theta
    return th.repeat_interleave(per, 0) if per > 1 else th


def _ev(fn, spec: NLGSpec, t, alpha: torch.Tensor) -> torch.Tensor:
    """A model function at states ``alpha (B, ..., m)`` (row b with theta
    b) at time ``t``: an int, or a tensor broadcasting to ``alpha``'s
    leading axes.  Returns ``(B, ..., out)``."""
    lead = alpha.shape[:-1]
    R = lead.numel()
    a = alpha.reshape(R, alpha.shape[-1])
    th = _thetas(spec, lead[0], R // lead[0])
    if isinstance(t, int):
        tt = torch.full((R,), t, dtype=torch.int64, device=alpha.device)
    else:
        tt = t.expand(lead).reshape(R)
    out = fn(tt, a, th)
    return out.reshape(lead + out.shape[1:])


def _times(spec: NLGSpec, B: int, n: int) -> torch.Tensor:
    return torch.arange(n, device=spec.y.device).expand(B, n)


def _masked_HH(H: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """H H' with the rows and columns of missing series zeroed and a unit
    diagonal there; ``mp`` the observed series as 0/1, broadcasting."""
    HH = H @ _tr(H)
    return HH * (mp.unsqueeze(-1) * mp.unsqueeze(-2)) \
        + torch.diag_embed(1.0 - mp)


# ---------------------------------------------------------------------------
# extended and unscented Kalman filters
# ---------------------------------------------------------------------------

def _linear_update(spec: NLGSpec, t: int, y_t, a, P, a_lin):
    """The measurement update of ``y_t`` linearised at ``a_lin``
    (``_masked_lin`` and the JAX ``linear_update``), every row: (Zg, HHm,
    cholF, v, K, ok).  The missing series are those of ``spec.y[t]``."""
    mask = torch.isfinite(spec.y[t])
    mp = mask.to(a.dtype)
    Zg = _ev(spec.Z_gn, spec, t, a_lin) * mp[:, None]
    HHm = _masked_HH(_ev(spec.H_fn, spec, t, a_lin), mp)
    zfn = _ev(spec.Z_fn, spec, t, a_lin)
    ZP = Zg @ P
    F = _sym(ZP @ _tr(Zg) + HHm)
    cholF, info = torch.linalg.cholesky_ex(F)
    diag = torch.diagonal(cholF, dim1=-2, dim2=-1)
    ok = (info == 0) & torch.isfinite(cholF).all((-1, -2)) \
        & (diag > 0).all(-1)
    eye = torch.eye(spec.p, dtype=a.dtype, device=a.device)
    cholF = torch.where(ok[:, None, None], cholF, eye)
    v = torch.where(mask, y_t - zfn - _mv(Zg, a - a_lin),
                    torch.zeros_like(zfn))
    K = _tr(_cho_solve(cholF, ZP))
    return Zg, HHm, cholF, v, K, ok


def ekf_update_step(spec: NLGSpec, t: int, y_t: torch.Tensor,
                    a: torch.Tensor, P: torch.Tensor):
    """One (iterated) EKF measurement update of rows ``a (R, m)``, ``P
    (R, m, m)`` by the observation ``y_t (p,)`` (or ``(R, p)``; the
    filters pass ``spec.y[t]``) at time t, whose missing series are those
    of ``spec.y[t]``, as in the JAX package; R is the batch or a multiple
    of it (particles of every row).  The iterations of the iterated EKF
    run per row while the mean squared change exceeds 1e-4.  Returns (att,
    Ptt, loglik contribution ``(R,)``); a row whose F has no Cholesky
    factor gets the identity in its place and -inf."""
    mask = torch.isfinite(spec.y[t])
    lin = _linear_update(spec, t, y_t, a, P, a)
    att = a + _mv(lin[4], lin[3])
    if spec.iekf_iter > 0:
        diff = torch.ones(a.shape[0], dtype=a.dtype, device=a.device)
        for _ in range(spec.iekf_iter):
            go = diff > 1e-4
            new = _linear_update(spec, t, y_t, a, P, att)
            att_new = a + _mv(new[4], new[3])
            d_new = torch.square(att - att_new).mean(-1)
            lin = tuple(torch.where(go.reshape((-1,) + (1,) * (x.dim() - 1)),
                                    x, y) for x, y in zip(new, lin))
            att = torch.where(go[:, None], att_new, att)
            diff = torch.where(go, d_new, diff)
    Zg, HHm, cholF, v, K, ok = lin
    ImKZ = torch.eye(spec.m, dtype=a.dtype, device=a.device) - K @ Zg
    Ptt = _sym(ImKZ @ P @ _tr(ImKZ) + K @ HHm @ _tr(K))
    Fv = torch.linalg.solve_triangular(cholF, v.unsqueeze(-1),
                                       upper=False).squeeze(-1)
    logdiag = torch.log(torch.diagonal(cholF, dim1=-2, dim2=-1))
    ll_obs = -0.5 * (mask.to(a.dtype).sum() * LOG2PI
                     + 2.0 * torch.where(mask, logdiag,
                                         torch.zeros_like(logdiag)).sum(-1)
                     + (Fv * Fv).sum(-1))
    any_obs = mask.any()
    att = torch.where(any_obs, att, a)
    Ptt = torch.where(any_obs, Ptt, P)
    ll = torch.where(any_obs, torch.where(ok, ll_obs,
                                          torch.full_like(ll_obs,
                                                          -torch.inf)),
                     torch.zeros_like(ll_obs))
    return att, Ptt, ll


class EKFResult(NamedTuple):
    at: torch.Tensor      # (B, n+1, m)
    att: torch.Tensor     # (B, n, m)
    Pt: torch.Tensor      # (B, n+1, m, m)
    Ptt: torch.Tensor     # (B, n, m, m)
    logLik: torch.Tensor  # (B,)


def _stack_filter(a, P, at, Pt, att, Ptt, ll) -> EKFResult:
    st = lambda xs: torch.stack(xs, dim=1)                   # noqa: E731
    return EKFResult(st(at + [a]), st(att), st(Pt + [P]), st(Ptt), ll)


def ekf(spec: NLGSpec) -> EKFResult:
    """(Iterated) extended Kalman filter of every row."""
    a, P = spec.a1(), spec.P1()
    at, Pt, atts, Ptts, ll = [], [], [], [], 0.0
    for t in range(spec.n):
        att, Ptt, llt = ekf_update_step(spec, t, spec.y[t], a, P)
        at.append(a)
        Pt.append(P)
        atts.append(att)
        Ptts.append(Ptt)
        ll = ll + llt
        Tg = _ev(spec.T_gn, spec, t, att)
        R = _ev(spec.R_fn, spec, t, att)
        a = _ev(spec.T_fn, spec, t, att)
        P = _sym(Tg @ Ptt @ _tr(Tg) + R @ _tr(R))
    return _stack_filter(a, P, at, Pt, atts, Ptts, ll)


def ekf_loglik(spec: NLGSpec) -> torch.Tensor:
    return ekf(spec).logLik


def _ekf_ll(spec: NLGSpec):
    """``ekf_loglik`` as a block of ``Replay``."""
    return (ekf_loglik(spec),)


def ukf(spec: NLGSpec, alpha: float = 1.0, beta: float = 0.0,
        kappa: float = 2.0) -> EKFResult:
    """Unscented Kalman filter of every row, Sarkka-style sigma points."""
    n, m, p = spec.n, spec.m, spec.p
    dt, dev = spec.y.dtype, spec.y.device
    lam = alpha * alpha * (m + kappa) - m
    wm = torch.full((2 * m + 1,), 1.0 / (2.0 * (lam + m)), dtype=dt,
                    device=dev)
    wm[0] = lam / (lam + m)
    wc = wm.clone()
    wc[0] += 1.0 - alpha * alpha + beta
    sq = (m + lam) ** 0.5
    eye_p = torch.eye(p, dtype=dt, device=dev)

    def sigmas(x, P):
        S = sq * _tr(psd_chol(P))
        return torch.cat([x[:, None], x[:, None] + S, x[:, None] - S], dim=1)

    def wcov(u, w):
        return torch.einsum('i,bij,bik->bjk', wc, u, w)

    a, P = spec.a1(), spec.P1()
    at, Pt, atts, Ptts, ll = [], [], [], [], 0.0
    for t in range(n):
        sig = sigmas(a, P)                                  # (B, 2m+1, m)
        mask = torch.isfinite(spec.y[t])
        mp = mask.to(dt)
        any_obs = mask.any()
        sig_y = _ev(spec.Z_fn, spec, t, sig) * mp
        pred_mean = torch.einsum('i,bip->bp', wm, sig_y)
        dy = sig_y - pred_mean[:, None]
        pred_var = _masked_HH(_ev(spec.H_fn, spec, t, a), mp) + wcov(dy, dy)
        pred_cov = wcov(sig - a[:, None], dy)
        v = torch.where(mask, spec.y[t] - pred_mean,
                        torch.zeros_like(pred_mean))
        cholF, info = torch.linalg.cholesky_ex(_sym(pred_var))
        ok = (info == 0) & torch.isfinite(cholF).all((-1, -2))
        cholF = torch.where(ok[:, None, None], cholF, eye_p)
        K = _tr(_cho_solve(cholF, _tr(pred_cov)))
        att = torch.where(any_obs, a + _mv(K, v), a)
        Ptt = _sym(torch.where(any_obs, P - K @ pred_var @ _tr(K), P))
        Fv = torch.linalg.solve_triangular(cholF, v.unsqueeze(-1),
                                           upper=False).squeeze(-1)
        logdiag = torch.log(torch.diagonal(cholF, dim1=-2, dim2=-1))
        llt = -0.5 * (mp.sum() * LOG2PI
                      + 2.0 * torch.where(mask, logdiag,
                                          torch.zeros_like(logdiag)).sum(-1)
                      + (Fv * Fv).sum(-1))
        llt = torch.where(any_obs, llt, torch.zeros_like(llt))
        ll = ll + torch.where(ok, llt, torch.full_like(llt, -torch.inf))
        at.append(a)
        Pt.append(P)
        atts.append(att)
        Ptts.append(Ptt)
        sig2p = _ev(spec.T_fn, spec, t, sigmas(att, Ptt))
        a = torch.einsum('i,bim->bm', wm, sig2p)
        R = _ev(spec.R_fn, spec, t, att)
        d2 = sig2p - a[:, None]
        P = _sym(R @ _tr(R) + wcov(d2, d2))
    return _stack_filter(a, P, at, Pt, atts, Ptts, ll)


# ---------------------------------------------------------------------------
# linearisation and the mode approximation
# ---------------------------------------------------------------------------

def build_approx(spec: NLGSpec, mode: torch.Tensor,
                 att: Optional[torch.Tensor] = None) -> MVLGSpec:
    """Linearise every row around a state trajectory ``mode (B, n, m)`` to
    a fully time-varying multivariate linear-Gaussian model (batch B);
    with ``att`` the transition is linearised there instead (the EKF
    start)."""
    B, n = mode.shape[0], spec.n
    tr = _times(spec, B, n)
    at_T = mode if att is None else att
    Z = _ev(spec.Z_gn, spec, tr, mode)
    T = _ev(spec.T_gn, spec, tr, at_T)
    D = _ev(spec.Z_fn, spec, tr, mode) - _mv(Z, mode)
    C = _ev(spec.T_fn, spec, tr, at_T) - _mv(T, at_T)
    return MVLGSpec(y=spec.y, Z=Z, H=_ev(spec.H_fn, spec, tr, mode), T=T,
                    R=_ev(spec.R_fn, spec, tr, at_T), a1=spec.a1(),
                    P1=spec.P1(), D=D, C=C)


def _obs_logdens(spec: NLGSpec, t, alpha: torch.Tensor) -> torch.Tensor:
    """The masked observation log-density log g(y_t | alpha) of states
    ``alpha (B, ..., m)`` at ``t`` (an int, or per row and time as in
    ``_ev``); 0 where y_t is missing altogether."""
    y = spec.y[t]
    mask = torch.isfinite(y)
    mp = mask.to(alpha.dtype)
    HHm = _masked_HH(_ev(spec.H_fn, spec, t, alpha), mp)
    zf = _ev(spec.Z_fn, spec, t, alpha)
    yv = torch.where(mask, y, torch.zeros_like(y))
    muv = torch.where(mask, zf, torch.zeros_like(zf))
    lo = dmvnorm(yv, muv, HHm) + 0.5 * (1.0 - mp).sum(-1) * LOG2PI
    return torch.where(mask.any(-1), lo, torch.zeros_like(lo))


def _leaf(x: torch.Tensor, core: int, t, n: int) -> torch.Tensor:
    """A leaf of the linearised model at an int ``t`` (a particle axis of
    1 after the batch axis), or at the first n time points (``t=None``);
    a time axis of 1 serves every t."""
    x = with_batch(x, core)
    if t is None:
        return x[:, :n] if x.shape[1] > 1 else x
    return (x[:, 0] if x.shape[1] == 1 else x[:, t])[:, None]


def _approx_obs_logdens(g: MVLGSpec, t, alpha: torch.Tensor):
    """The same under the linearised model ``g``; ``alpha (B, N, m)`` at an
    int t, or ``(B, n, m)`` at every t (``t=None``)."""
    n = alpha.shape[1]
    y, H, Z, D = (_leaf(x, c, t, n) for x, c in ((g.y, 2), (g.H, 3),
                                                  (g.Z, 3), (g.D, 2)))
    mask = torch.isfinite(y)
    mp = mask.to(alpha.dtype)
    HHm = _masked_HH(H, mp)
    mu = D + _mv(Z, alpha)
    yv = torch.where(mask, y, torch.zeros_like(y))
    muv = torch.where(mask, mu, torch.zeros_like(mu))
    lo = dmvnorm(yv, muv, HHm) + 0.5 * (1.0 - mp).sum(-1) * LOG2PI
    return torch.where(mask.any(-1), lo, torch.zeros_like(lo))


def _trans_ratio(spec: NLGSpec, g: MVLGSpec, t, a_prev, a_next):
    """log mu(a_next | a_prev) - log mu~(a_next | a_prev): the model's
    transition density against the linearised one's, at ``t`` an int (the
    states ``(B, N, m)``) or every t (``t=None``, ``(B, n-1, m)``)."""
    B, n = a_prev.shape[:2]
    tt = _times(spec, B, n) if t is None else t
    mean = _ev(spec.T_fn, spec, tt, a_prev)
    R = _ev(spec.R_fn, spec, tt, a_prev)
    gR = _leaf(g.R, 3, t, n)
    amean = _leaf(g.C, 2, t, n) + _mv(_leaf(g.T, 3, t, n), a_prev)
    return dmvnorm(a_next, mean, R @ _tr(R)) \
        - dmvnorm(a_next, amean, gR @ _tr(gR))


def log_signal_pdf(spec: NLGSpec, alpha: torch.Tensor) -> torch.Tensor:
    """Joint log-density of state trajectories ``alpha (B, n, m)`` and the
    data, ``(B,)``."""
    B, n = alpha.shape[0], spec.n
    tr = _times(spec, B, n)
    ll = dmvnorm(alpha[:, 0], spec.a1(), spec.P1())
    ll = ll + _obs_logdens(spec, tr, alpha).sum(-1)
    mean = _ev(spec.T_fn, spec, tr[:, :-1], alpha[:, :-1])
    R = _ev(spec.R_fn, spec, tr[:, :-1], alpha[:, :-1])
    return ll + dmvnorm(alpha[:, 1:], mean, R @ _tr(R)).sum(-1)


def _scales_nlg(spec: NLGSpec, mode: torch.Tensor,
                g: MVLGSpec) -> torch.Tensor:
    """The mode-based correction terms ``(B, n)``: the observation
    log-density against the linearised one at every t, plus the transition
    ratio of the pair (t-1, t) at t >= 1."""
    B, n = mode.shape[0], spec.n
    sc = _obs_logdens(spec, _times(spec, B, n), mode) \
        - _approx_obs_logdens(g, None, mode)
    tratio = _trans_ratio(spec, g, None, mode[:, :-1], mode[:, 1:])
    return torch.cat([sc[:, :1], sc[:, 1:] + tratio], dim=1)


class NLGApprox(NamedTuple):
    mode: torch.Tensor      # (B, n, m)
    approx: MVLGSpec        # the linearised model, batch B
    scales: torch.Tensor    # (B, n)
    loglik: torch.Tensor    # (B,) approximate log-likelihood
    niter: torch.Tensor     # (B,) Gauss-Newton passes


def _ekf_start(spec: NLGSpec):
    """The iteration's start: the EKF smoother's means and their
    log-density."""
    mode = ekf_fast_smoother(spec)[:, :spec.n]
    return mode, log_signal_pdf(spec, mode)


def _gn_pass(spec: NLGSpec, mode: torch.Tensor):
    """One Gauss-Newton pass: the smoothed means of the model linearised
    at ``mode`` and their log-density."""
    new = kalman_mv.fast_smoother_mv(build_approx(spec, mode))[:, :spec.n]
    return new, log_signal_pdf(spec, new)


def nlg_mode(spec: NLGSpec, replay=None):
    """The Gauss-Newton iteration of every row from the EKF start, with the
    JAX package's rules: a row goes on while its mode and objective are
    finite, it has run fewer than ``max_iter`` passes, its relative change
    is above ``conv_tol`` (at least 50 eps of the dtype) and its absolute
    change above 1e-4; a finished row keeps its values.  The JAX loop also
    holds a step-halving search, entered where the relative change is below
    -conv_tol and the absolute change above 1e-4 at once; the two share
    their sign, so it never runs, and the port leaves it out: a pass whose
    objective fell ends that row's iteration, in both packages.  One host
    check a pass; with ``replay`` every pass runs through it.  Returns
    (mode (B, n, m), ok (B,), niter (B,))."""
    call = replay or (lambda fn, *a: fn(*a))
    tol = max(spec.conv_tol, 50.0 * float(torch.finfo(spec.y.dtype).eps))
    mode, ll = call(_ekf_start, spec)
    i = torch.zeros(ll.shape[0], dtype=torch.int32, device=ll.device)
    rel = torch.full_like(ll, torch.inf)
    absd = torch.ones_like(ll)
    ok = torch.isfinite(mode).all(-1).all(-1) & torch.isfinite(ll)
    active = ok & (i < spec.max_iter)
    while bool(active.any()):
        new, ll_new = call(_gn_pass, spec, mode)
        diff = ll_new - ll
        rel = torch.where(active, diff / ll.abs(), rel)
        absd = torch.where(active, diff.abs(), absd)
        ok = torch.where(active, torch.isfinite(new).all(-1).all(-1)
                         & torch.isfinite(ll_new), ok)
        mode = torch.where(active[:, None, None], new, mode)
        ll = torch.where(active, ll_new, ll)
        i = i + active.to(torch.int32)
        active = ok & (i < spec.max_iter) & (rel > tol) & (absd > 1e-4)
    return mode, ok, i


def _linearised_ll(spec: NLGSpec, mode: torch.Tensor):
    """The model linearised at a mode, its scales, and the approximate
    log-likelihood: the linearised model's Kalman log-likelihood plus the
    scales."""
    g = build_approx(spec, mode)
    sc = _scales_nlg(spec, mode, g)
    return g, sc, kalman_mv.log_likelihood_mv(g) + sc.sum(-1)


def _final_ll(spec: NLGSpec, mode: torch.Tensor):
    """The approximate log-likelihood at a mode (a block of ``Replay``)."""
    return (_linearised_ll(spec, mode)[2],)


def approximate_nlg(spec: NLGSpec, replay=None) -> NLGApprox:
    """The mode approximation of every row (``nlg_mode``), its linearised
    model, scales and approximate log-likelihood (-inf where the iteration
    failed)."""
    mode, ok, niter = nlg_mode(spec, replay)
    g, sc, ll = _linearised_ll(spec, mode)
    return NLGApprox(mode, g, sc, torch.where(ok, ll, torch.full_like(
        ll, -torch.inf)), niter)


def approx_loglik_nlg(spec: NLGSpec, replay=None):
    """(approximate log-likelihood ``(B,)``, mode ``(B, n, m)``): what a
    chain evaluates, every pass and the final likelihood through
    ``replay`` when given."""
    mode, ok, _ = nlg_mode(spec, replay)
    ll = (replay or (lambda fn, *a: fn(*a)))(_final_ll, spec, mode)[0]
    return torch.where(ok, ll, torch.full_like(ll, -torch.inf)), mode


def approximate_for_is_nlg(spec: NLGSpec, mode: torch.Tensor) -> NLGApprox:
    """The linearisation rebuilt at a stored mode ``(B, n, m)`` without
    iterating, with its scales and a zero log-likelihood, so that a psi
    filter's estimate is the correction term alone."""
    g = build_approx(spec, mode)
    B, dev = mode.shape[0], mode.device
    return NLGApprox(mode, g, _scales_nlg(spec, mode, g),
                     torch.zeros(B, dtype=spec.y.dtype, device=dev),
                     torch.zeros(B, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# particle filters
# ---------------------------------------------------------------------------

def _pf_result(ll, alphas, nws, idxs, keep_paths):
    if not keep_paths:
        return ll
    return PFResult(ll, torch.stack(alphas, dim=2), torch.stack(nws, dim=2),
                    torch.stack(idxs, dim=2))


def psi_filter_nlg(spec: NLGSpec, ap: NLGApprox, nsim: int,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None,
                   us: Optional[torch.Tensor] = None,
                   keep_paths: bool = True):
    """psi-auxiliary particle filter: the proposal is the linearised
    model's smoothing law in its backward factorisation (generation t =
    n..0, resampling before every step), the weights the observation
    density ratios less the scales plus the transition ratio of the pair
    (t, t+1) for t + 1 <= n - 1 (into the observation-free alpha_n the
    ratio cancels).  Randomness: ``eps (B, n+1, N, m)``, ``us (B, n, N)``,
    or drawn from ``generator``.  A step whose weights all vanish adds
    nothing to the log-likelihood (``ap.loglik`` plus the log-weight).
    Returns a ``PFResult`` with the trajectories traced, in time order,
    and identity indices, or with ``keep_paths=False`` the log-likelihood
    ``(B,)`` alone."""
    n, m = spec.n, spec.m
    B = ap.mode.shape[0]
    dt, dev = spec.y.dtype, spec.y.device
    eps, us = _draws("psi_filter_nlg", B, n + 1, nsim, m, dt, dev,
                     generator, eps, us)
    N = eps.shape[2]
    g = ap.approx
    ahat, Lb, Ab = kalman_mv.smoother_bwd_factors_mv(g)
    alpha = ahat[:, n, None, :] + eps[:, 0] @ _tr(Lb[:, n])
    nw = torch.full((B, N), 1.0 / N, dtype=dt, device=dev)
    ll = torch.zeros(B, dtype=dt, device=dev) + ap.loglik
    alphas, nws, idxs = [alpha], [nw], []
    for s in range(1, n + 1):
        t = n - s
        idx = stratified_indices_from_uniforms(nw, us[:, s - 1])
        anc = _pick(alpha, idx)
        alpha = (ahat[:, t, None, :]
                 + (anc - ahat[:, t + 1, None, :]) @ _tr(Ab[:, t])
                 + eps[:, s] @ _tr(Lb[:, t]))
        lw = _obs_logdens(spec, t, alpha) \
            - _approx_obs_logdens(g, t, alpha) - ap.scales[:, t, None]
        lw = torch.where(torch.isfinite(spec.y[t]).any(), lw,
                         torch.zeros_like(lw))
        if t + 1 <= n - 1:
            lw = lw + _trans_ratio(spec, g, t, alpha, anc)
        inc, nw = _lse_update(lw)
        ll = ll + torch.where(torch.isfinite(inc), inc,
                              torch.zeros_like(inc))
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


def _weighted(lw, y_any, N):
    """The JAX ``_lse`` step (``particle._lse_update``) on log-weights
    counted only where y is observed: (increment, normalised weights)."""
    inc, nw = _lse_update(torch.where(y_any, lw, torch.zeros_like(lw)))
    return (torch.where(y_any, inc, torch.zeros_like(inc)),
            torch.where(y_any, nw, torch.full_like(nw, 1.0 / N)))


def bsf_filter_nlg(spec: NLGSpec, nsim: int,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None,
                   us: Optional[torch.Tensor] = None,
                   keep_paths: bool = True):
    """Bootstrap particle filter: particles start from N(a1, P1), move
    through the state equation, are weighted by the observation density and
    resampled before every step; the last step predicts alpha_n (uniform
    weights).  Randomness: ``eps (B, n+1, N, max(m, k))`` (``eps[:, 0]``'s
    first m entries the initial draws, the first k entries of ``eps[:, s]``
    the disturbances of step s) and ``us (B, n, N)``, or drawn from
    ``generator``.  Returns a ``PFResult`` (trajectories untraced), or
    with ``keep_paths=False`` the log-likelihood ``(B,)``."""
    n, m, k = spec.n, spec.m, spec.k
    B = eps.shape[0] if eps is not None else spec.batch
    dt, dev = spec.y.dtype, spec.y.device
    eps, us = _draws("bsf_filter_nlg", B, n + 1, nsim, max(m, k), dt, dev,
                     generator, eps, us)
    N = eps.shape[2]
    y_any = torch.isfinite(spec.y).any(-1)
    a1 = spec.a1().expand(B, -1)
    L1 = psd_chol(spec.P1()).expand(B, -1, -1)
    alpha = a1[:, None, :] + eps[:, 0, :, :m] @ _tr(L1)
    ll, nw = _weighted(_obs_logdens(spec, 0, alpha), y_any[0], N)
    alphas, nws, idxs = [alpha], [nw], []
    for s in range(1, n + 1):
        t = s - 1
        idx = stratified_indices_from_uniforms(nw, us[:, s - 1])
        anc = _pick(alpha, idx)
        alpha = _ev(spec.T_fn, spec, t, anc) + _mv(
            _ev(spec.R_fn, spec, t, anc), eps[:, s, :, :k])
        if s < n:
            inc, nw = _weighted(_obs_logdens(spec, s, alpha), y_any[s], N)
            ll = ll + inc
        else:
            nw = torch.full_like(nw, 1.0 / N)
        if keep_paths:
            alphas.append(alpha)
            nws.append(nw)
            idxs.append(idx)
    return _pf_result(ll, alphas, nws, idxs, keep_paths)


def ekpf_filter(spec: NLGSpec, nsim: int,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None,
                us: Optional[torch.Tensor] = None,
                keep_paths: bool = True):
    """Extended Kalman particle filter: every particle proposes from its
    own EKF update of the transition's prediction, and the weights correct
    the prior against that proposal.  Randomness as ``psi_filter_nlg``'s:
    ``eps (B, n+1, N, m)``, ``us (B, n, N)``.  Returns a ``PFResult``
    (trajectories untraced), or with ``keep_paths=False`` the
    log-likelihood ``(B,)``."""
    n, m = spec.n, spec.m
    B = eps.shape[0] if eps is not None else spec.batch
    dt, dev = spec.y.dtype, spec.y.device
    eps, us = _draws("ekpf_filter", B, n + 1, nsim, m, dt, dev, generator,
                     eps, us)
    N = eps.shape[2]
    y_any = torch.isfinite(spec.y).any(-1)
    a1 = spec.a1().expand(B, -1)
    P1 = spec.P1().expand(B, -1, -1)
    att1, Ptt1, _ = ekf_update_step(spec, 0, spec.y[0], a1, P1)
    L1 = psd_chol(Ptt1)
    alpha = att1[:, None, :] + eps[:, 0] @ _tr(L1)
    lw = _obs_logdens(spec, 0, alpha) \
        + dmvnorm(alpha, a1[:, None], P1[:, None]) \
        - dmvnorm(alpha, att1[:, None], L1[:, None], lwr=True)
    ll, nw = _weighted(lw, y_any[0], N)
    alphas, nws, idxs = [alpha], [nw], []
    part = _with_rows(spec, B, N)
    for s in range(1, n + 1):
        t = s - 1
        idx = stratified_indices_from_uniforms(nw, us[:, s - 1])
        anc = _pick(alpha, idx).reshape(B * N, m)
        at = _ev(spec.T_fn, part, t, anc)
        R = _ev(spec.R_fn, part, t, anc)
        Pt = R @ _tr(R)
        if s < n:
            att, Ptt, _ = ekf_update_step(part, s, part.y[s], at, Pt)
            L = psd_chol(Ptt)
        else:
            att, L = at, psd_chol(Pt)
        new = att + _mv(L, eps[:, s].reshape(B * N, m))
        corr = dmvnorm(new, at, Pt) - dmvnorm(new, att, L, lwr=True)
        alpha = new.reshape(B, N, m)
        if s < n:
            inc, nw = _weighted(_obs_logdens(spec, s, alpha)
                                + corr.reshape(B, N), y_any[s], N)
            ll = ll + inc
        else:
            nw = torch.full_like(nw, 1.0 / N)
        if keep_paths:
            alphas.append(alpha)
            nws.append(nw)
            idxs.append(idx)
    return _pf_result(ll, alphas, nws, idxs, keep_paths)


def _with_rows(spec: NLGSpec, B: int, per: int = 1) -> NLGSpec:
    """The spec with theta of B rows each repeated ``per`` times: the
    functions' rows are then particles."""
    return dataclasses.replace(spec, theta=_thetas(spec, B, per))


# ---------------------------------------------------------------------------
# extended Kalman smoothing
# ---------------------------------------------------------------------------

def _ekf_linearised(spec: NLGSpec) -> MVLGSpec:
    """The model linearised along the EKF: Z, H at the predictions, T, R
    at the filtered states."""
    r = ekf(spec)
    return build_approx(spec, r.at[:, :-1], att=r.att)


def ekf_smoother(spec: NLGSpec) -> kalman_mv.MVSmoothResult:
    """Extended Kalman smoother: the EKF, then the RTS pass of the model
    linearised along it."""
    return kalman_mv.smoother_mv(_ekf_linearised(spec))


def ekf_fast_smoother(spec: NLGSpec) -> torch.Tensor:
    """Means-only extended Kalman smoothing, ``(B, n+1, m)``."""
    return kalman_mv.fast_smoother_mv(_ekf_linearised(spec))
