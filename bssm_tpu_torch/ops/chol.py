"""Branch-free factorisations of (possibly) singular covariances, batched.

Counterpart of ``bssm_tpu/ops/chol.py``; every function takes any number of
leading batch axes.  State-space models carry deterministic state
components, so covariance matrices have exact zero rows and columns; the
"unit-diagonal padding" trick (add 1 to the diagonal of zero rows, factor,
zero them back out) keeps shapes static without approximation.

These forms were forced by float32, not by any accelerator: the Tikhonov
roll-off of ``_psd_pinv`` replaces a hard eigenvalue cutoff whose f32 noise
produced conditional gains in the hundreds, and ``_psd_factor`` clips
instead of failing where Cholesky meets a cancellation-indefinite matrix.
"""
from __future__ import annotations

import torch

from .cuda_kalman import MAX_M

_EPS = 2.220446049250313e-16  # double eps; threshold semantics of the ref


def _zero_diag_mask(x: torch.Tensor, rel: bool = True) -> torch.Tensor:
    """True for rows considered active (diagonal > tolerance)."""
    d = torch.diagonal(x, dim1=-2, dim2=-1)
    if rel:
        dmax = d.max(dim=-1, keepdim=True).values
        tol = torch.clamp(_EPS * x.shape[-1] * dmax, min=_EPS)
    else:
        tol = _EPS
    return d > tol


def psd_chol(x: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of a PSD matrix whose singularity comes from zero
    diagonal entries (deterministic states)."""
    return masked_chol(x, _zero_diag_mask(x, rel=True))


def masked_chol(x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Cholesky of ``x`` restricted to ``active`` rows/cols; inactive rows
    and columns of the result are exactly zero.  A genuinely indefinite
    input yields zeros where the factorisation broke down (no exception)."""
    am = active.to(x.dtype)
    outer = am.unsqueeze(-1) * am.unsqueeze(-2)
    padded = x * outer + torch.diag_embed(1.0 - am)
    L, _ = torch.linalg.cholesky_ex(padded)
    L = torch.where(torch.isfinite(L), L, torch.zeros_like(L))
    return L * outer


def masked_tri_solve(L: torch.Tensor, b: torch.Tensor, active: torch.Tensor,
                     lower: bool = True) -> torch.Tensor:
    """Solve L x = b on the ``active`` subspace (L from ``masked_chol``):
    L ``(..., k, k)``, b ``(..., k)`` or ``(..., k, r)``; the inactive
    entries of x are zero."""
    am = active.to(L.dtype)
    Ls = L + torch.diag_embed(1.0 - am)
    vec = b.dim() == L.dim() - 1
    rhs = b.unsqueeze(-1) if vec else b
    x = torch.linalg.solve_triangular(Ls, rhs, upper=not lower)
    return x.squeeze(-1) * am if vec else x * am.unsqueeze(-1)


def _eigh2x2(Vs: torch.Tensor):
    """Closed-form eigendecomposition of symmetric 2x2 matrices.

    lambda = mean(tr) +- sqrt(((a-c)/2)^2 + b^2).  Returns (w, U) with the
    columns of U the orthonormal eigenvectors and ascending eigenvalues, the
    convention of ``torch.linalg.eigh``.  The hand-written kernels use the
    same formulas, so their factors agree column for column."""
    a, b, c = Vs[..., 0, 0], Vs[..., 0, 1], Vs[..., 1, 1]
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    r = torch.sqrt(half_diff * half_diff + b * b)
    w = torch.stack([half_tr - r, half_tr + r], dim=-1)
    # eigenvector of the larger eigenvalue: (b, r - half_diff) or
    # (r + half_diff, b); pick the better-conditioned form branch-free
    use_first = torch.abs(r - half_diff) > torch.abs(r + half_diff)
    v1 = torch.where(use_first, b, r + half_diff)
    v2 = torch.where(use_first, r - half_diff, b)
    nrm = torch.sqrt(v1 * v1 + v2 * v2)
    ok = nrm > 0
    nrm = torch.where(ok, nrm, torch.ones_like(nrm))
    v1 = torch.where(ok, v1 / nrm, torch.ones_like(v1))
    v2 = torch.where(ok, v2 / nrm, torch.zeros_like(v2))
    # the smaller eigenvalue's eigenvector is the orthogonal complement
    U = torch.stack([torch.stack([-v2, v1], dim=-1),
                     torch.stack([v1, v2], dim=-1)], dim=-1)
    return w, U


def _sym_eigh(Vs: torch.Tensor):
    """eigh with closed forms for the m <= 2 shapes of the main models.  On
    the card a float32 batch of more states than the kernels take
    (``cuda_kalman.MAX_M``) is solved in float64 and rounded back: the
    batched float32 Jacobi solver of cuSOLVER fails to converge on the many
    repeated zero eigenvalues of a seasonal model's covariances (period 12,
    m = 12), which the plain versions meet on the card for models the
    kernels do not take."""
    m = Vs.shape[-1]
    if m == 1:
        return Vs[..., 0], torch.ones_like(Vs)
    if m == 2:
        return _eigh2x2(Vs)
    if m > MAX_M and Vs.is_cuda and Vs.dtype == torch.float32:
        w, U = torch.linalg.eigh(Vs.double())
        return w.float(), U.float()
    return torch.linalg.eigh(Vs)


def _psd_factor(V: torch.Tensor) -> torch.Tensor:
    """Square-root factor of a (numerically) PSD matrix via eigh with
    eigenvalue clipping: columns = eigenvectors * sqrt(clipped eigenvalues)."""
    Vs = 0.5 * (V + V.transpose(-1, -2))
    w, U = _sym_eigh(Vs)
    w = torch.clamp(w, min=0.0)
    return U * torch.sqrt(w).unsqueeze(-2)


def _psd_pinv(V: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of a PSD matrix (eigh, Tikhonov-smoothed).

    lambda / (lambda^2 + delta^2) with delta = 4 m eps lambda_max equals
    1/lambda for healthy eigenvalues and rolls off to 0 for directions below
    the noise floor, so numerically deterministic state components are
    treated as exactly deterministic without a branch."""
    m = V.shape[-1]
    Vs = 0.5 * (V + V.transpose(-1, -2))
    w, U = _sym_eigh(Vs)
    w = torch.clamp(w, min=0.0)
    delta = 4.0 * m * torch.finfo(V.dtype).eps * w.max(dim=-1,
                                                       keepdim=True).values
    den = w * w + delta * delta
    pos = den > 0
    winv = torch.where(pos, w / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(w))
    return (U * winv.unsqueeze(-2)) @ U.transpose(-1, -2)


def conditional_cov_factors(Vt: torch.Tensor, Ct: torch.Tensor):
    """Smoothed covariances ``Vt (..., n+1, m, m)`` and lag-one
    cross-covariances ``Ct`` (``Ct[t]`` = Cov(alpha_t, alpha_{t+1} | y) for
    t < n) as the parameters of the FORWARD conditional proposal:
    ``Lcond`` a square-root factor of Var(alpha_t | alpha_{t-1}, y) (of
    Var(alpha_0 | y) at t = 0) and ``Acond`` the regression coefficients,
    E[alpha_t | alpha_{t-1}] = ahat_t + Acond_t (alpha_{t-1} - ahat_{t-1}),
    ``Acond[0] = 0``; both ``(..., n+1, m, m)``."""
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731
    A = tr(Ct[..., :-1, :, :]) @ _psd_pinv(Vt[..., :-1, :, :])
    Vc = Vt[..., 1:, :, :] - A @ Ct[..., :-1, :, :]
    Lcond = torch.cat([_psd_factor(Vt[..., :1, :, :]), _psd_factor(Vc)],
                      dim=-3)
    Acond = torch.cat([torch.zeros_like(A[..., :1, :, :]), A], dim=-3)
    return Lcond, Acond


def chol_rank1_update(L: torch.Tensor, v: torch.Tensor,
                      down: torch.Tensor) -> torch.Tensor:
    """Rank-1 Cholesky update (``down`` False) / downdate (``down`` True) of
    lower-triangular factors, L L' +- v v'; L ``(..., d, d)``, v ``(..., d)``,
    ``down`` a bool tensor ``(...)``.  Sequential over the (small) parameter
    dimension, batched over everything else."""
    d = L.shape[-1]
    L = L.clone()
    v = v.clone()
    sign = torch.where(down, -1.0, 1.0).to(L.dtype)
    tiny = torch.finfo(L.dtype).tiny
    for k in range(d):
        Lkk = L[..., k, k]
        vk = v[..., k]
        r2 = Lkk * Lkk + sign * vk * vk
        r = torch.sqrt(torch.clamp(r2, min=tiny))
        c = r / Lkk
        s = vk / Lkk
        col = L[..., :, k]
        new_col = (col + (sign * s).unsqueeze(-1) * v) / c.unsqueeze(-1)
        new_v = c.unsqueeze(-1) * v - s.unsqueeze(-1) * new_col
        # only rows strictly below the diagonal change, plus the diagonal
        L[..., k + 1:, k] = new_col[..., k + 1:]
        L[..., k, k] = r
        v[..., k + 1:] = new_v[..., k + 1:]
    return L
