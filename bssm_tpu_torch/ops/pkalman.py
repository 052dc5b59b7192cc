"""Parallel-in-time Kalman filtering and smoothing by associative scans,
batch first.

Counterpart of ``bssm_tpu/ops/pkalman.py``: the prefix-sum form of
Sarkka & Garcia-Fernandez ("Temporal Parallelization of Bayesian
Smoothers", IEEE TAC 2021).  Every time step becomes an element
(A, b, C, eta, J) and the Kalman filter is their associative composition,
so a pass takes O(log n) dependent steps in place of n; a missing
observation makes its element pure prediction (J = eta = 0).  The fast
smoother's backward recursion (r) composes affine maps and is scanned the
same way.  Its means then follow elementwise from the moment identity
alphahat_t = a_t + P_t r_{t-1} (Durbin-Koopman eq. 4.44, as
``kalman.fast_smoother_ll`` takes them), where the JAX package scans the
forward recursion alpha_{t+1} = C_t + T_t alpha_t + R_t R_t' r_t from
alpha_1: the same values, but in float32 that recursion carries alpha_1's
rounding through T^t, which grows linearly in t for a trend (level +
slope at n = 153: 6.7e-3 from the float64 means on the CPU, against
4.6e-5 by the identity and 3.8e-5 by the sequential smoother).

Torch has no associative scan: ``_scan`` is the work-efficient odd/even
recursion of ``jax.lax.associative_scan`` (about 2n combines in 2 log2 n
levels) over axis 1 of tensors with a leading row axis.  The small
matrices of a step are multiplied and inverted in elementwise operations
(``_mm``, ``_inverse``); no step waits on the host, so a pass can be
captured as one CUDA graph.  Plain batched tensor code, as the JAX package computes the
scan in XLA outside any Pallas kernel.  The elements are not in Joseph
form.  The option pays for long series and few rows; thousands of rows
already fill the card through the sequential kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.spec import LGSpec
from .kalman import LOG2PI, ZERO_TOL, _sym, _sys


class PFilterResult(NamedTuple):
    att: torch.Tensor     # (B, n, m) filtered means
    Ptt: torch.Tensor     # (B, n, m, m) filtered covariances
    at: torch.Tensor      # (B, n, m) predicted means (a_0 = a1)
    Pt: torch.Tensor      # (B, n, m, m) predicted covariances
    logLik: torch.Tensor  # (B,)


def _scan(fn, elems, reverse: bool = False):
    """Inclusive scan of ``fn(earlier, later)`` over axis 1 of the tuple of
    tensors ``elems`` (each ``(b, n, ...)``; a batch of 1 broadcasts), any
    n >= 1.  ``reverse``: flip, scan, flip, so that ``fn`` still receives
    (aggregate of the later steps, earlier step) in the flipped order and
    an operator written for (earlier, later) composes suffixes."""
    if reverse:
        out = _scan(fn, tuple(torch.flip(e, (1,)) for e in elems))
        return tuple(torch.flip(e, (1,)) for e in out)
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _scan(fn, fn(tuple(e[:, 0:-1:2] for e in elems),
                       tuple(e[:, 1::2] for e in elems)))
    later = tuple(e[:, 2::2] for e in elems)
    if n == 2:
        even = later                              # empty
    elif n % 2 == 0:
        even = fn(tuple(o[:, :-1] for o in odd), later)
    else:
        even = fn(odd, later)
    return tuple(_interleave(e, ev, o) for e, ev, o in zip(elems, even, odd))


def _interleave(first, even, odd):
    """``first``'s step 0, then out[2i+1] = odd[i], out[2i+2] = even[i]."""
    B = max(first.shape[0], even.shape[0], odd.shape[0])
    out = odd.new_empty((B, 1 + even.shape[1] + odd.shape[1])
                        + odd.shape[2:])
    out[:, :1] = first[:, :1]
    out[:, 1::2] = odd
    out[:, 2::2] = even
    return out


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B over stacks of small matrices as a broadcast product and a
    sum: a batched GEMM gives each 2 x 2 matrix a 32 x 32 tile of its
    own."""
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x over stacks of small matrices and vectors, as ``_mm``."""
    return (A * x.unsqueeze(-2)).sum(-1)


def _inverse(A: torch.Tensor) -> torch.Tensor:
    """A^{-1} over a stack of small matrices: Gauss-Jordan elimination with
    partial pivoting in elementwise operations, so that nothing waits on
    the host (``torch.linalg.solve`` checks for singularity) and no
    library solve launches work matrix by matrix."""
    m = A.shape[-1]
    idx = torch.arange(m, device=A.device)
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    M = torch.cat([A, eye.expand_as(A)], -1)
    for k in range(m):
        is_k = (idx == k).unsqueeze(-1)
        if k < m - 1:     # swap row k with the largest |pivot| below it
            p = M[..., k:, k].abs().argmax(-1, keepdim=True) + k
            is_p = (idx == p).unsqueeze(-1)
            row_p = (M * is_p).sum(-2, keepdim=True)
            M = torch.where(is_k, row_p, torch.where(is_p, M[..., k:k + 1, :],
                                                     M))
        row = M[..., k:k + 1, :] / M[..., k:k + 1, k:k + 1]
        M = torch.where(is_k, row, M - M[..., :, k:k + 1] * row)
    return M[..., m:]


def _plus_eye(M: torch.Tensor) -> torch.Tensor:
    M.diagonal(dim1=-2, dim2=-1).add_(1.0)
    return M


def _combine(e1, e2):
    """Associative composition of filtering elements, ``e1`` the earlier
    (Lemma 8 of the paper; ``bssm_tpu/ops/pkalman.py:35-61``, which solves
    with I + C1 J2 and I + J2 C1: with C1, J2 symmetric the second is the
    transpose of the first, so one inverse serves both)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    G = _inverse(_plus_eye(_mm(C1, J2)))          # (I + C1 J2)^{-1}
    Gt = G.transpose(-1, -2)                      # (I + J2 C1)^{-1}
    A1t, A2t = A1.transpose(-1, -2), A2.transpose(-1, -2)
    A = _mm(A2, _mm(G, A1))
    b = _mv(A2, _mv(G, b1 + _mv(C1, eta2))) + b2
    C = _mm(_mm(A2, _mm(G, C1)), A2t) + C2
    eta = _mv(A1t, _mv(Gt, eta2 - _mv(J2, b1))) + eta1
    J = _sym(_mm(A1t, _mm(Gt, _mm(J2, A1))) + J1)
    return A, b, C, eta, J


def _affine(e1, e2):
    """Affine maps f(x) = b + M x: ``e2`` after ``e1``."""
    b1, M1 = e1
    b2, M2 = e2
    return b2 + _mv(M2, b1), _mm(M2, M1)


def _arrays(spec: LGSpec):
    """The spec's leaves with one leading batch axis and a full time axis
    (``bssm_tpu/ops/kalman._step_arrays``): y, obs, Z, HH (NaN -> 1), T,
    RR, D, C, and a1, P1."""
    s = _sys(spec)
    n = s.y.shape[1]

    def full(x):
        return x.expand((x.shape[0], n) + x.shape[2:])
    HH = full(s.HH)
    HH = torch.where(torch.isfinite(HH), HH, torch.ones_like(HH))
    return (s.y, s.obs, full(s.Z), HH, full(s.T), full(s.RR), full(s.D),
            full(s.C), s.a1, s.P1)


def _cat0(x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Step 0 ``x0 (b, ...)`` ahead of steps ``x (b', n-1, ...)``."""
    B = max(x0.shape[0], x.shape[0])
    return torch.cat([x0.unsqueeze(1).expand((B, 1) + x0.shape[1:]),
                      x.expand((B,) + x.shape[1:])], 1)


def _elements(arr):
    """Per-step filtering elements, each ``(B, n, ...)`` at the batch of
    the spec, step 0 folding in the prior; and the observed steps ``ok``
    (``bssm_tpu/ops/pkalman.py:64-124``)."""
    y, obs, Z, HH, T, RR, D, C, a1, P1 = arr
    m = a1.shape[-1]
    eye = torch.eye(m, dtype=y.dtype, device=y.device)
    ok = obs & (HH + (Z * Z).sum(-1) > 0)
    yv = torch.where(ok, y - D, torch.zeros_like(HH))

    # steps k >= 1: F = T_{k-1}, Q = RR_{k-1}, c = C_{k-1}
    F, Q, c = T[:, :-1], RR[:, :-1], C[:, :-1]
    Z1, y1 = Z[:, 1:], yv[:, 1:]
    o = ok[:, 1:].unsqueeze(-1)
    QZ = _mv(Q, Z1)
    S = (Z1 * QZ).sum(-1) + HH[:, 1:]
    K = QZ / S.unsqueeze(-1)
    ImKZ = eye - K.unsqueeze(-1) * Z1.unsqueeze(-2)
    resid = (y1 - (Z1 * c).sum(-1)).unsqueeze(-1)
    Ft = F.transpose(-1, -2)
    HS = Z1 / S.unsqueeze(-1)
    # J = F' Z S^{-1} Z' F
    J_obs = _mv(Ft, HS).unsqueeze(-1) * _mv(Ft, Z1).unsqueeze(-2)
    A = torch.where(o.unsqueeze(-1), _mm(ImKZ, F), F)
    b = torch.where(o, c + K * resid, c)
    Cm = _sym(torch.where(o.unsqueeze(-1), _mm(ImKZ, Q), Q))
    eta = torch.where(o, _mv(Ft, HS * resid), torch.zeros_like(QZ))
    J = torch.where(o.unsqueeze(-1), J_obs, torch.zeros_like(J_obs))

    # step 0: the prior updated by y_0
    Z0 = Z[:, 0]
    PZ0 = _mv(P1, Z0)
    K0 = PZ0 / ((Z0 * PZ0).sum(-1) + HH[:, 0]).unsqueeze(-1)
    r0 = (yv[:, 0] - (Z0 * a1).sum(-1)).unsqueeze(-1)
    o0 = ok[:, :1]
    b0 = torch.where(o0, a1 + K0 * r0, a1)
    C0 = _sym(torch.where(o0.unsqueeze(-1), _mm(
        eye - K0.unsqueeze(-1) * Z0.unsqueeze(-2), P1), P1))
    zv = torch.zeros_like(b0)
    zm = torch.zeros_like(C0)
    elems = (_cat0(zm, A), _cat0(b0, b), _cat0(C0, Cm), _cat0(zv, eta),
             _cat0(zm, J))
    B = max(e.shape[0] for e in elems)
    return tuple(e.expand((B,) + e.shape[1:]) for e in elems), ok


def _filter(arr) -> PFilterResult:
    y, obs, Z, HH, T, RR, D, C, a1, P1 = arr
    elems, ok = _elements(arr)
    _, att, Ptt, _, _ = _scan(_combine, elems)
    # predicted moments: a_0 = a1; a_k = c_{k-1} + T_{k-1} att_{k-1}
    Tp = T[:, :-1]
    at = _cat0(a1, C[:, :-1] + _mv(Tp, att[:, :-1]))
    Pt = _cat0(P1, _mm(_mm(Tp, Ptt[:, :-1]), Tp.transpose(-1, -2))
               + RR[:, :-1])
    F = (Z * _mv(Pt, Z)).sum(-1) + HH
    Fs = torch.where(ok, F, torch.ones_like(F))
    v = torch.where(ok, y - D - (Z * at).sum(-1), torch.zeros_like(F))
    lls = torch.where(ok, -0.5 * (LOG2PI + torch.log(Fs) + v * v / Fs),
                      torch.zeros_like(F))
    return PFilterResult(att, Ptt, at, Pt, lls.sum(-1))


def kfilter_parallel(spec: LGSpec) -> PFilterResult:
    """O(log n)-depth Kalman filter (``bssm_tpu/ops/pkalman.py:127-154``);
    its moments match ``kalman.kfilter``'s first n."""
    return _filter(_arrays(spec))


def log_likelihood_parallel(spec: LGSpec) -> torch.Tensor:
    """The Kalman log-likelihood ``(B,)`` by ``kfilter_parallel``."""
    return kfilter_parallel(spec).logLik


def fast_smoother_ll_parallel(spec: LGSpec):
    """(smoothed means ``(B, n+1, m)``, Kalman log-likelihood ``(B,)``):
    the filter by its elements and the backward r-recursion as a
    composition of affine maps, both scans, then the means elementwise
    (``bssm_tpu/ops/pkalman.py:177-219`` computes the same means by a
    third scan); the parallel twin of ``kalman.fast_smoother_ll``, without
    its degenerate-model rule."""
    arr = _arrays(spec)
    y, obs, Z, HH, T, _, D, C, a1, _ = arr
    flt = _filter(arr)
    m = a1.shape[-1]
    PZ = _mv(flt.Pt, Z)
    F = (Z * PZ).sum(-1) + HH
    ok = obs & (F > ZERO_TOL)          # not _elements' rule, as in JAX
    okf = ok.to(y.dtype).unsqueeze(-1)
    Fs = torch.where(ok, F, torch.ones_like(F))
    v = torch.where(ok, y - D - (Z * flt.at).sum(-1), torch.zeros_like(F))
    K = PZ / Fs.unsqueeze(-1) * okf
    # L_t = T_t (I - K_t Z_t'), T_t where y_t is missing
    eye = torch.eye(m, dtype=y.dtype, device=y.device)
    L = _mm(T, eye - K.unsqueeze(-1) * Z.unsqueeze(-2))
    # backward: r_{t-1} = Z_t v_t / F_t + L_t' r_t, r_{n-1} = 0; the
    # suffix composition's offset at t is r_{t-1}
    bs = Z * (v / Fs).unsqueeze(-1) * okf
    r, _ = _scan(_affine, (bs, L.transpose(-1, -2)), reverse=True)
    # the means by the moment identity alphahat_t = a_t + P_t r_{t-1}, and
    # alphahat_n = a_n (module docstring: not the forward scan)
    alpha = flt.at + _mv(flt.Pt, r)
    a_n = C[:, -1] + _mv(T[:, -1], flt.att[:, -1])
    return torch.cat([alpha, a_n.unsqueeze(1).expand_as(alpha[:, :1])],
                     1), flt.logLik


def fast_smoother_parallel(spec: LGSpec) -> torch.Tensor:
    """O(log n)-depth smoothed means ``(B, n+1, m)``, equal to
    ``kalman.fast_smoother``'s."""
    return fast_smoother_ll_parallel(spec)[0]
