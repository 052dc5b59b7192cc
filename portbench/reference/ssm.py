"""Plain reference of a univariate non-Gaussian state-space model.

A frozen, self-contained restatement in plain PyTorch of what the port
computes on the timed paths, written from the textbook definitions
(Durbin & Koopman 2012, ch. 10-11; Vihola, Helske & Franks 2020):

- the prior of theta in the sampled space, the Jacobian of a log transform
  included;
- the Laplace (mode-matching) approximation: pseudo-observations at the
  current signal, a Kalman filter and fast smoother of the approximating
  linear-Gaussian model, the new signal, until the mean squared change is
  below a tolerance; its approximate log-likelihood = the Gaussian
  log-likelihood + the exact normalising-constant difference + the sum of
  the log-weights at the mode;
- the psi-APF: particles from the approximating model's smoothing
  distribution (backward sampling from the filtered moments), weighed by
  the ratio of the true to the approximating observation density less its
  value at the mode, resampled systematically at every step; the log of
  the mean weight estimates log p(y | theta) - approximate log-likelihood.

It imports nothing of the program.  Every function takes its dtype from
its inputs, so the same code runs in float64 (the reference) and bfloat16
(the control).  Small matrices (m <= 4) are factored by explicit loops,
which every dtype supports.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

LOG2PI = 1.8378770664093453
ZERO_TOL = 1e-8


class System(NamedTuple):
    """One model at a batch of thetas.  ``y``, ``u`` ``(n,)``; ``Z`` ``(m,)``;
    ``T``, ``RR``, ``P1`` ``(B, m, m)``; ``a1`` ``(B, m)``; ``phi`` ``(B,)``;
    ``family`` "poisson" or "svm"; ``mode0`` ``(n,)``, the starting
    signal."""
    y: torch.Tensor
    u: torch.Tensor
    Z: torch.Tensor
    T: torch.Tensor
    RR: torch.Tensor
    a1: torch.Tensor
    P1: torch.Tensor
    phi: torch.Tensor
    family: str
    mode0: torch.Tensor

    def to(self, dtype) -> "System":
        return System(*(x.to(dtype) if torch.is_tensor(x) else x
                        for x in self))


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------

def log_prior(priors: list, theta: torch.Tensor) -> torch.Tensor:
    """Joint log prior ``(B,)`` of sampled-space ``theta (B, d)``; each prior
    a dict with ``dist`` ("halfnormal" with ``sd``, "uniform" with ``min``
    and ``max``) and ``transform`` ("log" or "identity").  Unnormalised, as
    the program's: a halfnormal is -x^2 / (2 sd^2) on x >= 0."""
    total = torch.zeros(theta.shape[0], dtype=theta.dtype,
                        device=theta.device)
    for j, p in enumerate(priors):
        th = theta[:, j]
        x = torch.exp(th) if p["transform"] == "log" else th
        jac = th if p["transform"] == "log" else torch.zeros_like(th)
        if p["dist"] == "halfnormal":
            lp = torch.where(x < 0, torch.full_like(x, -math.inf),
                             -0.5 * torch.square(x / p["sd"]))
        elif p["dist"] == "uniform":
            lp = torch.where((x < p["min"]) | (x > p["max"]),
                             torch.full_like(x, -math.inf),
                             torch.zeros_like(x))
        else:
            raise ValueError(f"prior {p['dist']!r} has no reference")
        total = total + lp + jac
    return total


# ---------------------------------------------------------------------------
# observation families
# ---------------------------------------------------------------------------

def _safe_exp(x):
    cap = 700.0 if x.dtype == torch.float64 else 80.0
    return torch.exp(torch.clamp(x, max=cap))


def match(family: str, y, u, phi, s):
    """Pseudo-observation and its variance of the Gaussian matched to the
    observation density's log at signal ``s`` (second order)."""
    if family == "poisson":
        HH = 1.0 / (_safe_exp(s) * u)
        return y * HH + s - 1.0, HH
    if family == "svm":
        ys = torch.where(torch.abs(y) < 1e-4, torch.full_like(y, 1e-4), y)
        HH = 2.0 * _safe_exp(s) / torch.square(ys / phi)
        return s + 1.0 - 0.5 * HH, HH
    raise ValueError(f"family {family!r} has no reference")


def log_obs(family: str, y, u, phi, s):
    """Unnormalised log density of y given signal ``s``."""
    if family == "poisson":
        return y * s - u * _safe_exp(s)
    if family == "svm":
        return -0.5 * (s + torch.square(y / phi) * _safe_exp(-s))
    raise ValueError(f"family {family!r} has no reference")


def obs_const(family: str, y, u, phi):
    """Sum over time of the observation density's normalising constants."""
    if family == "poisson":
        c = -torch.lgamma(y + 1.0) + y * torch.log(u)
    elif family == "svm":
        c = -0.5 * LOG2PI - torch.log(phi) + torch.zeros_like(y)
    else:
        raise ValueError(f"family {family!r} has no reference")
    return c.sum(-1)


def log_ratio(sysm: System, s, yt, H):
    """log g(y | s) - log g~(yt | s), both unnormalised; the series' axes
    broadcast against ``s``."""
    return (log_obs(sysm.family, sysm.y, sysm.u, sysm.phi[..., None], s)
            + 0.5 * torch.square((yt - s) / H))


# ---------------------------------------------------------------------------
# small-matrix algebra (m <= 4, any dtype)
# ---------------------------------------------------------------------------

def chol(A: torch.Tensor, rel_floor: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of symmetric ``A (..., m, m)``; a pivot below
    ``rel_floor`` times its diagonal entry is raised to that (0: a
    non-positive pivot becomes 0)."""
    m = A.shape[-1]
    L = [[None] * m for _ in range(m)]
    zero = torch.zeros_like(A[..., 0, 0])
    for j in range(m):
        d = A[..., j, j] - sum((L[j][k] * L[j][k] for k in range(j)), zero)
        d = torch.maximum(d, rel_floor * torch.abs(A[..., j, j]))
        L[j][j] = torch.sqrt(torch.clamp(d, min=0.0))
        inv = torch.where(L[j][j] > 0, 1.0 / L[j][j], zero)
        for i in range(j + 1, m):
            L[i][j] = (A[..., i, j] - sum((L[i][k] * L[j][k]
                                            for k in range(j)), zero)) * inv
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(m)], -1)
            for i in range(m)]
    return torch.stack(rows, -2)


def spd_inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric positive definite ``A (..., m, m)`` through its
    Cholesky factor, by explicit substitution; a pivot lost to rounding
    (bfloat16) is kept at the dtype's resolution."""
    m = A.shape[-1]
    L = chol(A, torch.finfo(A.dtype).eps)
    zero = torch.zeros_like(A[..., 0, 0])
    # inverse of L (lower), column by column
    Li = [[zero] * m for _ in range(m)]
    for i in range(m):
        Li[i][i] = 1.0 / L[..., i, i]
        for j in range(i):
            acc = sum((L[..., i, k] * Li[k][j] for k in range(j, i)), zero)
            Li[i][j] = -acc / L[..., i, i]
    Linv = torch.stack([torch.stack(Li[i], -1) for i in range(m)], -2)
    return Linv.transpose(-1, -2) @ Linv


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Kalman filter and smoother of the approximating model
# ---------------------------------------------------------------------------

class Filtered(NamedTuple):
    at: torch.Tensor    # (B, n+1, m) predicted means
    Pt: torch.Tensor    # (B, n+1, m, m)
    att: torch.Tensor   # (B, n, m) filtered means
    Ptt: torch.Tensor   # (B, n, m, m)
    v: torch.Tensor     # (B, n)
    F: torch.Tensor     # (B, n)
    K: torch.Tensor     # (B, n, m)
    ok: torch.Tensor    # (B, n)
    loglik: torch.Tensor  # (B,)


def kalman(sysm: System, yt: torch.Tensor, H: torch.Tensor) -> Filtered:
    """Kalman filter (Joseph form) of y~ = Z' alpha + N(0, H^2),
    alpha_{t+1} = T alpha_t + N(0, RR); ``yt``, ``H`` ``(B, n)``."""
    B, n = yt.shape
    m = sysm.Z.shape[-1]
    Z = sysm.Z
    eye = torch.eye(m, dtype=yt.dtype, device=yt.device)
    a = sysm.a1.expand(B, m)
    P = sysm.P1.expand(B, m, m)
    T, RR = sysm.T, sysm.RR
    out = {k: [] for k in ("at", "Pt", "att", "Ptt", "v", "F", "K", "ok")}
    ll = torch.zeros(B, dtype=yt.dtype, device=yt.device)
    for t in range(n):
        HH = torch.square(H[:, t])
        PZ = _mv(P, Z.expand(B, m))
        F = (PZ * Z).sum(-1) + HH
        ok = torch.isfinite(yt[:, t]) & (F > ZERO_TOL)
        Fs = torch.where(ok, F, torch.ones_like(F))
        v = torch.where(ok, yt[:, t] - (Z * a).sum(-1), torch.zeros_like(F))
        K = torch.where(ok[:, None], PZ / Fs[:, None], torch.zeros_like(PZ))
        att = a + K * v[:, None]
        ImKZ = eye - K[:, :, None] * Z[None, None, :]
        Ptt = ImKZ @ P @ ImKZ.transpose(-1, -2) \
            + HH[:, None, None] * (K[:, :, None] * K[:, None, :])
        Ptt = torch.where(ok[:, None, None], Ptt, P)
        Ptt = 0.5 * (Ptt + Ptt.transpose(-1, -2))
        ll = ll + torch.where(ok, -0.5 * (LOG2PI + torch.log(Fs)
                                          + v * v / Fs), torch.zeros_like(F))
        for k, x in (("at", a), ("Pt", P), ("att", att), ("Ptt", Ptt),
                     ("v", v), ("F", Fs), ("K", K), ("ok", ok)):
            out[k].append(x)
        a = _mv(T, att)
        P = T @ Ptt @ T.transpose(-1, -2) + RR
        P = 0.5 * (P + P.transpose(-1, -2))
    out["at"].append(a)
    out["Pt"].append(P)
    st = {k: torch.stack(v, 1) for k, v in out.items()}
    return Filtered(st["at"], st["Pt"], st["att"], st["Ptt"], st["v"],
                    st["F"], st["K"], st["ok"], ll)


def smoothed_means(sysm: System, f: Filtered) -> torch.Tensor:
    """Smoothed state means ``(B, n, m)`` by the backward recursion of
    r_t (Durbin & Koopman eq. 4.44): alphahat_t = a_t + P_t r_{t-1}."""
    B, n = f.v.shape
    m = sysm.Z.shape[-1]
    Z, T = sysm.Z, sysm.T
    eye = torch.eye(m, dtype=f.v.dtype, device=f.v.device)
    r = torch.zeros(B, m, dtype=f.v.dtype, device=f.v.device)
    rs = [None] * n
    for t in range(n - 1, -1, -1):
        L = T @ (eye - f.K[:, t, :, None] * Z[None, None, :])
        r_obs = Z * (f.v[:, t] / f.F[:, t])[:, None] \
            + _mv(L.transpose(-1, -2), r)
        r = torch.where(f.ok[:, t, None], r_obs,
                        _mv(T.transpose(-1, -2), r))
        rs[t] = r
    rs = torch.stack(rs, 1)
    return f.at[:, :n] + _mv(f.Pt[:, :n], rs)


# ---------------------------------------------------------------------------
# Laplace approximation
# ---------------------------------------------------------------------------

class Laplace(NamedTuple):
    mode: torch.Tensor      # (B, n)
    yt: torch.Tensor        # (B, n)
    H: torch.Tensor         # (B, n)
    loglik: torch.Tensor    # (B,) approximate log-likelihood
    scales: torch.Tensor    # (B, n) log-weights at the mode
    passes: torch.Tensor    # (B,) passes each row needed
    filtered: Filtered      # of the last approximating model
    diff: Optional[torch.Tensor] = None    # (B,) last mean squared change


def _pseudo(sysm: System, s):
    yt, HH = match(sysm.family, sysm.y, sysm.u, sysm.phi[:, None], s)
    H = torch.sqrt(torch.where(torch.isfinite(HH) & (HH > 0), HH,
                               torch.ones_like(HH)))
    return yt, H


def laplace(sysm: System, conv_tol: float = 1e-12, max_iter: int = 100,
            count_tol: float = 0.0, must: Optional[int] = None,
            min_iter: int = 10) -> Laplace:
    """Mode-matching iteration from ``sysm.mode0``, every row on until its
    mean squared change is at most ``conv_tol`` (or ``max_iter`` passes).
    ``passes`` counts for each row the passes until its change is at most
    ``count_tol`` (a program's tolerance), for the operation counts.  With
    ``must``, the iteration also ends once the first ``must`` rows have
    converged and ``min_iter`` passes are done: rows after them that still
    move (far out on a grid, some cycle for ever) are left as they are,
    their last change in ``diff``."""
    B = sysm.T.shape[0]
    mode = sysm.mode0.to(sysm.T.dtype).expand(B, -1).clone()
    active = torch.ones(B, dtype=torch.bool, device=mode.device)
    counting = active.clone()
    passes = torch.zeros(B, dtype=torch.int64, device=mode.device)
    last = torch.full((B,), math.inf, dtype=mode.dtype, device=mode.device)
    for it in range(max_iter):
        yt, H = _pseudo(sysm, mode)
        f = kalman(sysm, yt, H)
        new = (smoothed_means(sysm, f) * sysm.Z).sum(-1)
        diff = torch.square(new - mode).mean(-1)
        passes = passes + counting.to(torch.int64)
        counting = counting & (diff > count_tol)
        mode = torch.where(active[:, None], new, mode)
        last = torch.where(active, diff, last)
        active = active & (diff > conv_tol)
        if not bool(active.any()) or (
                must is not None and it + 1 >= min_iter
                and not bool(active[:must].any())):
            break
    return rebuild(sysm, mode)._replace(passes=passes, diff=last)


def rebuild(sysm: System, mode: torch.Tensor) -> Laplace:
    """The approximation rebuilt at a given ``mode (B, n)`` without
    iterating: its pseudo-observations, filter, scales and approximate
    log-likelihood."""
    yt, H = _pseudo(sysm, mode)
    f = kalman(sysm, yt, H)
    sc = log_ratio(sysm, mode, yt, H)
    const = obs_const(sysm.family, sysm.y, sysm.u, sysm.phi[:, None]) \
        - (-0.5 * LOG2PI - torch.log(H)).sum(-1)
    passes = torch.zeros(mode.shape[0], dtype=torch.int64,
                         device=mode.device)
    return Laplace(mode, yt, H, f.loglik + const + sc.sum(-1), sc, passes, f)


# ---------------------------------------------------------------------------
# psi-APF
# ---------------------------------------------------------------------------

def psi_apf(sysm: System, lap: Laplace, N: int,
            generator: torch.Generator, resample_every: int = 1
            ) -> torch.Tensor:
    """The psi-APF log-weight ``(B,)`` with ``N`` particles: the estimate of
    log p(y | theta) less ``lap.loglik``.  Particles run backward in time
    from alpha_n ~ N(a_n, P_n), each alpha_t drawn from its conditional
    given alpha_{t+1} under the approximating model, N(att_t + J_t
    (alpha_{t+1} - a_{t+1}), Ptt_t - J_t P_{t+1} J_t'), J_t = Ptt_t T'
    P_{t+1}^-1.  Systematic resampling before generation steps 1 + k,
    1 + 2k, ... (k = ``resample_every``; before step 1 the weights are
    uniform), the normalised log-weights carried between them."""
    f = lap.filtered
    B, n = f.v.shape
    m = sysm.Z.shape[-1]
    dt, dev = f.v.dtype, f.v.device
    T = sysm.T
    Tt = T.transpose(-1, -2)

    def normals(shape):
        return torch.randn(shape, dtype=torch.float64, device=dev,
                           generator=generator).to(dt)

    Ln = chol(f.Pt[:, n])
    alpha = f.at[:, n, None, :] + normals((B, N, m)) @ Ln.transpose(-1, -2)
    lnw = torch.full((B, N), -math.log(N), dtype=dt, device=dev)
    total = torch.zeros(B, dtype=dt, device=dev)
    grid = torch.arange(N, dtype=torch.float64, device=dev)
    observed = torch.isfinite(sysm.y).tolist()
    kk = int(resample_every)
    for t in range(n - 1, -1, -1):
        s_gen = n - t                       # generation step, 1 .. n
        if s_gen > 1 and (s_gen - 1) % kk == 0:
            w = torch.exp(lnw - lnw.max(-1, keepdim=True).values)
            cw = torch.cumsum(w.double(), -1)
            cw = cw / cw[:, -1:]
            u0 = torch.rand((B, 1), dtype=torch.float64, device=dev,
                            generator=generator)
            idx = torch.searchsorted(cw, (grid + u0) / N)
            idx = torch.clamp(idx, max=N - 1)
            alpha = torch.gather(alpha, 1, idx[..., None].expand(-1, -1, m))
            lnw = torch.full_like(lnw, -math.log(N))
        J = f.Ptt[:, t] @ Tt @ spd_inv(f.Pt[:, t + 1])
        V = f.Ptt[:, t] - J @ f.Pt[:, t + 1] @ J.transpose(-1, -2)
        V = 0.5 * (V + V.transpose(-1, -2))
        mean = f.att[:, t, None, :] + (alpha - f.at[:, t + 1, None, :]) \
            @ J.transpose(-1, -2)
        alpha = mean + normals((B, N, m)) @ chol(V).transpose(-1, -2)
        s = (alpha * sysm.Z).sum(-1)                        # (B, N)
        if observed[t]:
            lw = (log_obs(sysm.family, sysm.y[t], sysm.u[t],
                          sysm.phi[:, None], s)
                  + 0.5 * torch.square((lap.yt[:, t, None] - s)
                                       / lap.H[:, t, None])
                  - lap.scales[:, t, None])
            a = lnw + lw
            mx = a.max(-1, keepdim=True).values
            inc = mx[:, 0] + torch.log(torch.exp(a - mx).sum(-1))
            total = total + inc
            lnw = a - inc[:, None]
    return total
