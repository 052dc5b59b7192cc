"""psi-auxiliary particle filter log-weights, batched.

Counterpart of ``bssm_tpu/inference/particle.py`` for the log-weight-only
correction of IS-MCMC: the proposal is the smoothing law of the
approximating Gaussian model in its BACKWARD (FFBS) factorisation, so
generation runs t = n..0, drawing alpha_n from the smoothed marginal and each
alpha_t from N(ahat_t + Ab_t (alpha_{t+1} - ahat_{t+1}), Lb_t Lb_t');
observation weights attach at the step that generates their state, and the
ensemble is stratified-resampled at every step.

All randomness is injected as tensors (``eps`` normals, ``us`` uniforms), so
the hand-written ``psi_logw`` kernel (``ops/cuda_kalman.py``) and its plain
version ``psi_logw_scan`` below consume identical inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import distributions as fam
from ..core.spec import NGSpec, SVM, at_t, with_batch
from ..ops import cuda_kalman
from ..ops.resample import stratified_gather_from_uniforms
from .approx import ApproxLoglik, _col


def _lse_update(logw: torch.Tensor):
    """Log-sum-exp weight update of every ensemble; logw ``(B, N)``.
    Returns (log-likelihood increment ``(B,)``, normalised weights
    ``(B, N)``).  Non-finite particle weights (float32 overflow artefacts)
    count as zero; a dead ensemble gives ``-inf`` and uniform weights."""
    N = logw.shape[-1]
    ninf = torch.full_like(logw, -torch.inf)
    logw = torch.where(torch.isfinite(logw), logw, ninf)
    mx = logw.max(dim=-1, keepdim=True).values
    w = torch.exp(logw - mx)
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    sw = w.sum(-1, keepdim=True)
    ok = (sw > 0) & torch.isfinite(mx)
    sws = torch.where(sw > 0, sw, torch.ones_like(sw))
    inc = torch.where(ok, mx + torch.log(sws / N), ninf[..., :1])
    normw = torch.where(ok, w / sws, torch.full_like(w, 1.0 / N))
    return inc.squeeze(-1), normw


def psi_logw_scan(spec: NGSpec, al: ApproxLoglik, eps: torch.Tensor,
                  us: torch.Tensor, factors=None) -> torch.Tensor:
    """Plain version of the ``psi_logw`` kernel: the psi-APF log-weight
    ``(B,)`` as a Python loop over time with injected randomness
    ``eps (B, n+1, N, m)`` and ``us (B, n, N)``.  ``factors`` are the
    proposal factors ``(ahat, Lb, Ab)``; computed when absent."""
    n = spec.n
    B, _, N, _ = eps.shape
    dt = spec.y.dtype
    if factors is None:
        factors = cuda_kalman.rts_factors(al.approx.gaussian(spec))
    ahat, Lb, Ab = factors
    y = with_batch(spec.y, 1)
    u = with_batch(spec.u, 1)
    Z = with_batch(spec.Z, 2)
    D = with_batch(spec.D, 1).to(dt)
    phi = _col(spec.phi)
    yt, Ht, scl = al.approx.ytilde, al.approx.Htilde, al.scales
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731

    alpha = ahat[:, n, None, :] + eps[:, 0] @ tr(Lb[:, n])   # no observation
    nw = torch.full((B, N), 1.0 / N, dtype=dt, device=eps.device)
    ll = torch.zeros(B, dtype=dt, device=eps.device)
    for s in range(1, n + 1):
        t = n - s
        anc = stratified_gather_from_uniforms(nw, us[:, s - 1], alpha)
        alpha = (ahat[:, t, None, :]
                 + (anc - ahat[:, t + 1, None, :]) @ tr(Ab[:, t])
                 + eps[:, s] @ tr(Lb[:, t]))
        if spec.distribution == SVM:
            sig = alpha[..., 0]
        else:
            sig = at_t(D, t).unsqueeze(-1) \
                + (alpha * at_t(Z, t).unsqueeze(-2)).sum(-1)
        y_t = y[:, t, None]
        lw = fam.log_weights(spec.distribution, y_t, u[:, t, None], phi, sig,
                             yt[:, t, None], Ht[:, t, None]) - scl[:, t, None]
        ok = torch.isfinite(y_t)                             # (b, 1)
        inc, nw_new = _lse_update(torch.where(ok, lw, torch.zeros_like(lw)))
        ll = ll + torch.where(ok[:, 0], inc, torch.zeros_like(inc))
        nw = torch.where(ok, nw_new, torch.full_like(nw_new, 1.0 / N))
    return ll


def psi_logw(spec: NGSpec, al: ApproxLoglik, nsim: int,
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None,
             us: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The psi-APF log-likelihood estimate only (no trajectories), ``(B,)``:
    ``al.loglik`` plus the log-weight of ``nsim`` particles.  The normals
    and uniforms are drawn from ``generator`` unless given."""
    if nsim > cuda_kalman.MAX_N_PSI:
        raise NotImplementedError(
            f"psi_logw handles at most {cuda_kalman.MAX_N_PSI} particles; "
            "the large-ensemble kernel (in-kernel random numbers, resampling "
            "period) is the next slice of this package.")
    n, m = spec.n, spec.m
    B = al.approx.mode.shape[0]
    dt, dev = spec.y.dtype, spec.y.device
    if eps is None:
        eps = torch.randn((B, n + 1, nsim, m), dtype=dt, device=dev,
                          generator=generator)
    if us is None:
        us = torch.rand((B, n, nsim), dtype=dt, device=dev,
                        generator=generator)
    ahat, Lb, Ab = cuda_kalman.rts_factors(al.approx.gaussian(spec))
    return al.loglik + cuda_kalman.psi_logw(spec, al, ahat, Lb, Ab, eps, us)
