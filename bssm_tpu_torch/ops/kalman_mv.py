"""Multivariate-observation Kalman filtering and smoothing, batched loops.

Counterpart of ``bssm_tpu/ops/kalman_mv.py``: the same masked recursions,
a Python loop over time with every batch row advanced together.  A series
missing at time t keeps the static shapes: its row of Z is zeroed, the
observation covariance gets a unit diagonal entry there and its
innovation is zero, which is exactly the partial update (the masked block
of F is the identity and adds nothing to the log-determinant or the
quadratic form).  The covariance update is the Joseph form.

The JAX package's multivariate path reaches no TPU kernel, and none is
written here: these functions are batched tensor code on either device.
A Cholesky factorisation of F that fails (a float32 F that is not
positive definite) is caught row by row (``torch.linalg.cholesky_ex``): the
row's step uses the identity in its place and its log-likelihood is -inf,
as the JAX package does, while the other rows go on.

Shapes, after the leading batch axis B: y ``(n, p)``, Z ``(nz, p, m)``, H
``(nh, p, p)`` (observation covariance H H'), D ``(nd, p)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import rows
from ..core.spec import MVLGSpec, at_t, with_batch
from .kalman import _mv, _sym

LOG2PI = 1.8378770664093453


class _Sys(NamedTuple):
    """A spec's leaves, each with one leading batch axis (size 1 or B)."""
    y: torch.Tensor     # (b, n, p)
    obs: torch.Tensor   # (b, n, p)
    Z: torch.Tensor     # (b, nz, p, m)
    HH: torch.Tensor    # (b, nh, p, p)
    T: torch.Tensor     # (b, nt, m, m)
    RR: torch.Tensor    # (b, nr, m, m)
    D: torch.Tensor     # (b, nd, p)
    C: torch.Tensor     # (b, nc, m)
    a1: torch.Tensor    # (b, m)
    P1: torch.Tensor    # (b, m, m)


def _sys(spec: MVLGSpec) -> _Sys:
    y = with_batch(spec.y, 2)
    return _Sys(y, torch.isfinite(y), with_batch(spec.Z, 3),
                with_batch(spec.HH, 3), with_batch(spec.T, 3),
                with_batch(spec.RR, 3), with_batch(spec.D, 2).to(y.dtype),
                with_batch(spec.C, 2), with_batch(spec.a1, 1),
                with_batch(spec.P1, 2))


def _masked_sys(Z, HH, mask):
    """Zero the Z rows and the HH rows and columns of missing series and
    put a unit diagonal there (any leading axes)."""
    mp = mask.to(Z.dtype)
    Zm = Z * mp.unsqueeze(-1)
    HHm = HH * (mp.unsqueeze(-1) * mp.unsqueeze(-2)) \
        + torch.diag_embed(1.0 - mp)
    return Zm, HHm


def _cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(L L')^{-1} B by two triangular solves."""
    x = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), x, upper=True)


class _Step(NamedTuple):
    """One time point's inputs of the update, batch first."""
    yD: torch.Tensor    # (b, p) y - D (NaN where missing)
    mask: torch.Tensor  # (b, p)
    Zm: torch.Tensor    # (b, p, m) masked Z
    HHm: torch.Tensor   # (b, p, p) masked H H'
    T: torch.Tensor     # (b, m, m)
    RR: torch.Tensor    # (b, m, m)
    C: torch.Tensor     # (b, m)
    c0: torch.Tensor    # (b,) -0.5 log(2 pi) x the number observed


def _steps(s: _Sys):
    """Every time point's ``_Step``: what does not depend on the recursion
    (the masked system, y - D, the constant of the log-density) is formed
    for all time points at once.  A NaN in HH counts as zero, as in the
    JAX package."""
    HH = torch.where(torch.isfinite(s.HH), s.HH, torch.zeros_like(s.HH))
    Zm, HHm = _masked_sys(s.Z, HH, s.obs)                   # (b, n, ...)
    yD = s.y - s.D
    c0 = -0.5 * LOG2PI * s.obs.to(s.y.dtype).sum(-1)        # (b, n)
    for t in range(s.y.shape[1]):
        yield _Step(yD[:, t], s.obs[:, t], Zm[:, t], HHm[:, t], at_t(s.T, t),
                    at_t(s.RR, t), at_t(s.C, t), c0[:, t])


def _update_mv(a, P, st: _Step, eye_m, eye_p):
    """One masked predict+update step of every row: a ``(b, m)``, P
    ``(b, m, m)``, the step's inputs ``st`` and identities of sizes m and
    p.  Returns (a_next, P_next, att, Ptt, v, cholF, K, ll).  A time point
    with no series observed needs no branch: Zm = 0 and HHm = I give K = 0,
    att = a, Ptt = P and ll = 0 exactly.  A failed factorisation of F
    (``cholesky_ex``'s info, or a diagonal that is not positive) gives the
    identity in its place and ll = -inf for that row only."""
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731
    ZP = st.Zm @ P
    F = _sym(ZP @ tr(st.Zm) + st.HHm)
    cholF, info = torch.linalg.cholesky_ex(F)
    diag = torch.diagonal(cholF, dim1=-2, dim2=-1)
    ok_chol = (info == 0) & (diag > 0).all(-1)
    cholF = torch.where(ok_chol[..., None, None], cholF, eye_p)
    v = torch.where(st.mask, st.yD - _mv(st.Zm, a), 0.0)
    K = tr(_cho_solve(cholF, ZP))                            # (b, m, p)
    att = a + _mv(K, v)
    ImKZ = eye_m - K @ st.Zm
    Ptt = _sym(ImKZ @ P @ tr(ImKZ) + K @ st.HHm @ tr(K))
    P_next = _sym(st.T @ Ptt @ tr(st.T) + st.RR)
    Fv = torch.linalg.solve_triangular(cholF, v.unsqueeze(-1),
                                       upper=False).squeeze(-1)
    logdet = torch.where(st.mask, torch.log(
        torch.diagonal(cholF, dim1=-2, dim2=-1)), 0.0).sum(-1)
    ll = st.c0 - logdet - 0.5 * (Fv * Fv).sum(-1)
    ll = torch.where(ok_chol, ll, -torch.inf)
    return st.C + _mv(st.T, att), P_next, att, Ptt, v, cholF, K, ll


def _eyes(s: _Sys):
    kw = dict(dtype=s.y.dtype, device=s.y.device)
    return torch.eye(s.a1.shape[-1], **kw), torch.eye(s.y.shape[-1], **kw)


def log_likelihood_mv(spec: MVLGSpec) -> torch.Tensor:
    """Marginal log-likelihood by the Kalman filter, ``(B,)``."""
    s = _sys(spec)
    eyes = _eyes(s)
    a, P, acc = s.a1, s.P1, 0.0
    for st in _steps(s):
        a, P, *_, ll = _update_mv(a, P, st, *eyes)
        acc = acc + ll
    return acc


class MVFilterResult(NamedTuple):
    at: torch.Tensor      # (B, n+1, m)
    att: torch.Tensor     # (B, n, m)
    Pt: torch.Tensor      # (B, n+1, m, m)
    Ptt: torch.Tensor     # (B, n, m, m)
    logLik: torch.Tensor  # (B,)
    vt: torch.Tensor      # (B, n, p) innovations (0 where missing)
    cholF: torch.Tensor   # (B, n, p, p)
    Kt: torch.Tensor      # (B, n, m, p)
    Zm: torch.Tensor      # (B, n, p, m) masked Z


def kfilter_mv(spec: MVLGSpec) -> MVFilterResult:
    """Kalman filter storing predicted and filtered moments."""
    s = _sys(spec)
    eyes = _eyes(s)
    B = spec.batch or 1
    a, P = s.a1, s.P1
    out = [[] for _ in range(8)]
    acc = 0.0
    for st in _steps(s):
        a2, P2, att, Ptt, v, cholF, K, ll = _update_mv(a, P, st, *eyes)
        for lst, x in zip(out, (a, P, att, Ptt, v, cholF, K, st.Zm)):
            lst.append(x.expand((B,) + x.shape[1:]))
        acc = acc + ll
        a, P = a2, P2
    out[0].append(a.expand((B,) + a.shape[1:]))
    out[1].append(P.expand((B,) + P.shape[1:]))
    at, Pt, att, Ptt, vt, cholF, Kt, Zm = (torch.stack(x, dim=1)
                                           for x in out)
    return MVFilterResult(at, att, Pt, Ptt, acc, vt, cholF, Kt, Zm)


class MVSmoothResult(NamedTuple):
    alphahat: torch.Tensor  # (B, n+1, m)
    Vt: torch.Tensor        # (B, n+1, m, m)
    ccov: torch.Tensor      # (B, n+1, m, m); [n] = 0
    logLik: torch.Tensor    # (B,)


def _over_time(A: torch.Tensor, n: int) -> torch.Tensor:
    """A ``with_batch`` leaf with its time axis of 1 broadcast to n."""
    return A.expand(-1, n, *A.shape[2:]) if A.shape[1] == 1 else A


def _gains(s: _Sys, r: MVFilterResult) -> torch.Tensor:
    """The smoothing gains J_t = Ptt_t T_t' P_{t+1|t}^+ of every t at once,
    ``(B, n, m, m)`` (they depend on the filter alone)."""
    from .chol import _psd_pinv
    T = _over_time(s.T, s.y.shape[1])
    return r.Ptt @ T.transpose(-1, -2) @ _psd_pinv(r.Pt[:, 1:])


def smoother_bwd_factors_mv(spec: MVLGSpec):
    """(ahat, Lb, Ab): the backward (FFBS) factorisation of the smoothing
    law, the psi-APF proposal factors; ``ops.kalman.smoother_bwd_factors``
    for several series.  The gains and the conditional covariances (in
    their Joseph form (I - J T) Ptt (I - J T)' + J RR J') depend on the
    filter alone and are formed for every t at once; only the mean runs
    step by step."""
    from .chol import _psd_factor
    r = kfilter_mv(spec)
    s = _sys(spec)
    n, m = s.y.shape[1], s.a1.shape[-1]
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731
    T, RR = _over_time(s.T, n), _over_time(s.RR, n)
    J = _gains(s, r)
    ImJT = torch.eye(m, dtype=s.y.dtype, device=s.y.device) - J @ T
    Sig = _sym(ImJT @ r.Ptt @ tr(ImJT) + J @ RR @ tr(J))
    Lb = _psd_factor(torch.cat([Sig, r.Pt[:, -1:]], dim=1))
    Ab = torch.cat([J, torch.zeros_like(J[:, :1])], dim=1)
    ahat_next = r.at[:, -1]
    ahat = [None] * (n + 1)
    ahat[n] = ahat_next
    for t in range(n - 1, -1, -1):
        ahat_next = r.att[:, t] + _mv(J[:, t], ahat_next - r.at[:, t + 1])
        ahat[t] = ahat_next
    return torch.stack(ahat, dim=1), Lb, Ab


def smoother_mv(spec: MVLGSpec) -> MVSmoothResult:
    """Smoothed means, covariances and lag-one cross-covariances by the
    J-form recursion (see ``ops.kalman.smoother``), the gains formed for
    every t at once."""
    r = kfilter_mv(spec)
    s = _sys(spec)
    n = s.y.shape[1]
    J = _gains(s, r)
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731
    ahat_next, V_next = r.at[:, -1], r.Pt[:, -1]
    ahat, Vt, ccov = [None] * (n + 1), [None] * (n + 1), [None] * (n + 1)
    ahat[n], Vt[n], ccov[n] = ahat_next, V_next, torch.zeros_like(V_next)
    for t in range(n - 1, -1, -1):
        Jt, P_next = J[:, t], r.Pt[:, t + 1]
        ccov[t] = Jt @ V_next
        ahat_next = r.att[:, t] + _mv(Jt, ahat_next - r.at[:, t + 1])
        V_next = _sym(r.Ptt[:, t] + Jt @ (V_next - P_next) @ tr(Jt))
        ahat[t], Vt[t] = ahat_next, V_next
    st = lambda xs: torch.stack(xs, dim=1)                   # noqa: E731
    return MVSmoothResult(st(ahat), st(Vt), st(ccov), r.logLik)


def _backward_r(s: _Sys, flt: MVFilterResult, vt: torch.Tensor):
    """The r-recursion of the fast smoother, r_{n-1} = 0 and
    r_{t-1} = Z_t' F_t^{-1} v_t + L_t' r_t, L_t = T_t (I - K_t Z_t) (= T_t
    where nothing is observed: Zm = 0, K = 0).  The terms that do not
    depend on r are formed for every t at once; only the m-vector chain
    runs step by step.  Returns ``(r_{t-1} (B, n, m), r_t (B, n, m))`` for
    t = 0..n-1."""
    n, m = vt.shape[1], flt.at.shape[-1]
    dt, dev = vt.dtype, vt.device
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731
    T = s.T.expand(-1, n, -1, -1) if s.T.shape[1] == 1 else s.T
    u = _mv(tr(_cho_solve(flt.cholF, flt.Zm)), vt)           # (B, n, m)
    Lt = tr(T @ (torch.eye(m, dtype=dt, device=dev) - flt.Kt @ flt.Zm))
    r = torch.zeros(vt.shape[0], m, dtype=dt, device=dev)
    rprev, rt = [None] * n, [None] * n
    for t in range(n - 1, -1, -1):
        rt[t] = r
        r = u[:, t] + _mv(Lt[:, t], r)
        rprev[t] = r
    return torch.stack(rprev, dim=1), torch.stack(rt, dim=1)


def _mv_mean_passes(spec: MVLGSpec, flt: MVFilterResult,
                    vt: torch.Tensor) -> torch.Tensor:
    """Backward r pass and forward mean pass alpha_0 = a1 + P1 r_{-1},
    alpha_{t+1} = C + T alpha_t + R R' r_t, ``(B, n+1, m)``."""
    s = _sys(spec)
    rprev, rt = _backward_r(s, flt, vt)
    alpha = s.a1 + _mv(s.P1, rprev[:, 0])
    alphas = [alpha]
    for t in range(vt.shape[1]):
        alpha = at_t(s.C, t) + _mv(at_t(s.T, t), alpha) \
            + _mv(at_t(s.RR, t), rt[:, t])
        alphas.append(alpha)
    return torch.stack(alphas, dim=1)


def fast_smoother_mv(spec: MVLGSpec,
                     flt: Optional[MVFilterResult] = None) -> torch.Tensor:
    """Smoothed state means ``(B, n+1, m)``.  With ``flt`` (the filter of a
    model with the same system and missingness, batch size 1 or B) its
    y-independent gains are reused and only the mean recursions run
    against ``spec.y``: what the simulation smoother needs for each
    synthetic series."""
    if flt is None:
        flt = kfilter_mv(spec)
        return _mv_mean_passes(spec, flt, flt.vt)
    s = _sys(spec)
    a, vt = s.a1, []
    for t in range(s.y.shape[1]):
        mask = s.obs[:, t]
        Zm = at_t(s.Z, t) * mask.to(a.dtype).unsqueeze(-1)
        v = torch.where(mask, s.y[:, t] - at_t(s.D, t) - _mv(Zm, a),
                        torch.zeros_like(s.y[:, t]))
        a = at_t(s.C, t) + _mv(at_t(s.T, t), a + _mv(flt.Kt[:, t], v))
        vt.append(v)
    return _mv_mean_passes(spec, flt, torch.stack(vt, dim=1))


def fast_smoother_mv_ll(spec: MVLGSpec):
    """(smoothed means ``(B, n+1, m)``, filter log-likelihood ``(B,)``)
    from one forward pass: alphahat_t = a_t + P_t r_{t-1}."""
    flt = kfilter_mv(spec)
    rprev, _ = _backward_r(_sys(spec), flt, flt.vt)
    alphas = flt.at[:, :-1] + _mv(flt.Pt[:, :-1], rprev)
    return torch.cat([alphas, flt.at[:, -1:]], dim=1), flt.logLik


def _normals(spec: MVLGSpec, B: int, n_base: int, generator, um, eps, eta):
    given = [x is not None for x in (um, eps, eta)]
    if any(given):
        if not all(given):
            raise ValueError("give all of um, eps and eta, or none")
        return um, eps, eta
    kw = dict(dtype=spec.y.dtype, device=spec.y.device, generator=generator)
    return (rows.randn((B, n_base, spec.m), **kw),
            rows.randn((B, n_base, spec.n, spec.p), **kw),
            rows.randn((B, n_base, spec.n, spec.k), **kw))


def _rows(x: torch.Tensor, reps: int) -> torch.Tensor:
    """Every row of a ``with_batch`` view repeated ``reps`` times (a shared
    row stays one)."""
    return x if x.shape[0] == 1 else x.repeat_interleave(reps, dim=0)


def simulate_states_mv(spec: MVLGSpec, nsim: int, generator=None,
                       use_antithetic: bool = True, *,
                       um: Optional[torch.Tensor] = None,
                       eps: Optional[torch.Tensor] = None,
                       eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Durbin-Koopman simulation smoother: ``nsim`` posterior draws of the
    states of every row, ``(B, nsim, n+1, m)``.  Each base draw simulates
    (alpha+, y+) from the model and returns alphahat - E[alpha | y+] +
    alpha+, the conditional means reusing the row's filter gains; with
    antithetic variates draw i + ceil(nsim/2) is 2 alphahat - draw i.
    Injected normals: ``um (B, n_base, m)``, ``eps (B, n_base, n, p)``,
    ``eta (B, n_base, n, k)`` for the n_base = ceil(nsim/2) (antithetic)
    or nsim base draws; else drawn from ``generator`` in that order."""
    from .chol import psd_chol
    s = _sys(spec)
    n = s.y.shape[1]
    B = um.shape[0] if um is not None else (spec.batch or 1)
    nb = (nsim + 1) // 2 if use_antithetic else nsim
    um, eps, eta = _normals(spec, B, nb, generator, um, eps, eta)
    flt = kfilter_mv(spec)
    alphahat = _mv_mean_passes(spec, flt, flt.vt)           # (b, n+1, m)
    H, R = with_batch(spec.H, 3), with_batch(spec.R, 3)
    rep = lambda x: _rows(x, nb)                             # noqa: E731
    a = rep(s.a1) + _mv(rep(psd_chol(s.P1)), um.reshape(B * nb, -1))
    eps = eps.reshape(B * nb, n, -1)
    eta = eta.reshape(B * nb, n, -1)
    aplus, ysim = [a], []
    for t in range(n):
        ysim.append(rep(at_t(s.D, t)) + _mv(rep(at_t(s.Z, t)), a)
                    + _mv(rep(at_t(H, t)), eps[:, t]))
        a = rep(at_t(s.C, t)) + _mv(rep(at_t(s.T, t)), a) \
            + _mv(rep(at_t(R, t)), eta[:, t])
        aplus.append(a)
    aplus = torch.stack(aplus, dim=1)
    y = rep(s.y)
    ystar = torch.where(torch.isfinite(y), torch.stack(ysim, dim=1), y)
    sim = MVLGSpec(ystar, *(rep(x) for x in (s.Z, with_batch(spec.H, 3),
                                             s.T, with_batch(spec.R, 3),
                                             s.a1, s.P1, s.D, s.C)))
    flt_rep = MVFilterResult(*(rep(x) for x in flt))
    cond = fast_smoother_mv(sim, flt_rep)
    ah = alphahat.expand(B, -1, -1)
    base = ah[:, None] - cond.reshape(B, nb, n + 1, -1) \
        + aplus.reshape(B, nb, n + 1, -1)
    if use_antithetic:
        base = torch.cat([base, 2.0 * ah[:, None] - base], dim=1)
    return base[:, :nsim]
