"""Particle filters, batched: the psi-auxiliary particle filter and the
bootstrap filter, as log-likelihood estimates alone and as filters that keep
their trajectories.

Counterpart of ``bssm_tpu/inference/particle.py``.  The estimators without
trajectories (``psi_logw``, ``bsf_logw``) serve IS-MCMC with
``output_type="theta"`` and pseudo-marginal / delayed-acceptance MCMC; the
filters with trajectories (``psi_filter``, ``bsf_filter``, returning a
``PFResult``) serve the state outputs of the IS correction,
``particle_smoother`` and the particle ``logLik``.

psi-APF: the proposal is the smoothing law of the approximating Gaussian
model in its BACKWARD (FFBS) factorisation, so generation runs t = n..0,
drawing alpha_n from the smoothed marginal and each alpha_t from
N(ahat_t + Ab_t (alpha_{t+1} - ahat_{t+1}), Lb_t Lb_t'); observation weights
attach at the step that generates their state.  Bootstrap filter: particles
start from N(a1, P1), move forwards through the state equation and are
weighted by the observation density.  Both resample (stratified) at every
``resample_every``-th step and carry their log-weights in between.

Which kernel serves which ensemble (``ops/cuda_kalman.py``):

=============  ======================  ==============================
particles      psi-APF                 bootstrap filter
=============  ======================  ==============================
N <= 32        ``psi_logw``            ``bsf_big_logw``
32 < N <= 512  ``psi_big_logw``        ``bsf_big_logw``
N > 512        ``psi_logw_scan``       ``bsf_logw_scan``
=============  ======================  ==============================

The tier is decided by N alone, as in the JAX package, whose keyed scans
serve N > 512: above ``cuda_kalman.MAX_N_BIG`` the plain recursions run
over all rows in batched tensor code, drawing each step's uniforms and
normals from the generator at that step (``_Draws``; the whole ``(B, n+1,
N, m)`` tensor of a 16384-row chunk at N = 1024 would be 20 GB).  That tier
is not a plain route of a kernel and ``PLAIN_ROUTES`` does not count it.
Every filter here carries log-weights between resamplings, where the JAX
keyed scans carry linear weights that underflow to 0 in the far tail and
stay dead until the next resampling: a deliberate deviation, equal where
the weights do not underflow (an informative initial state).

SPDK importance sampling (``spdk_sample``) draws from the approximating
model's smoothing law by the batched simulation smoother
(``ops/simsmooth.simulate_states_batched``, the ``fast_smoother_ll``
kernel) and weighs the draws (``spdk_weights``).

``psi_logw`` takes its randomness injected as tensors; the large-ensemble
kernel takes a Philox key drawn from the caller's generator and makes its
own normals and uniforms, or injected tensors (and, as a check, injected
ancestors) for the checks.  The plain versions ``psi_logw_scan`` and
``bsf_logw_scan`` below consume injected tensors; they also serve, on
either device, the models the kernels do not take (``cuda_kalman.route``),
a seed then standing for the tensors ``philox_fill_plain`` draws.

The JAX package has no TPU kernel for the filters with trajectories:
``psi_filter``, ``bsf_filter`` and ``bsf_filter_lg`` (the bootstrap filter
of a linear-Gaussian model) are batched tensor code on the card too,
with the proposal factors of ``psi_filter`` from the ``rts_factors``
kernel.  Each takes injected normals and uniforms (stream mode) or draws
them from a ``torch.Generator``, and resamples at every step, as the JAX
package's filters do.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core import distributions as fam
from ..core import rows
from ..core.spec import LGSpec, NGSpec, SVM, at_t, is_mv, with_batch
from ..diagnostics import profiling
from ..ops import cuda_kalman
from ..ops.chol import psd_chol
from ..ops.kalman import smoother_bwd_factors
from ..ops.resample import (  # noqa: F401 (the gather is re-exported)
    ancestor_trace, stratified_gather_from_uniforms,
    stratified_indices_from_uniforms)
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


def _carry_update(lnw: torch.Tensor, lw: torch.Tensor, ok: torch.Tensor):
    """Weight update of every ensemble with carried log-weights, as the
    large-ensemble kernel does it: ``lnw (B, N)`` normalised log-weights,
    ``lw (B, N)`` the step's log-weights, ``ok (B, 1)`` whether y is
    observed.  Returns (increment ``(B,)``, new normalised log-weights).  A
    missing y leaves the weights as they were (normalised anew); a dead
    ensemble gives ``-inf`` and log-weights ``-log N``."""
    N = lnw.shape[-1]
    lt = lnw + torch.where(ok, lw, torch.zeros_like(lw))
    fin = torch.isfinite(lt)
    ninf = torch.full_like(lt, -torch.inf)
    lt = torch.where(fin, lt, ninf)
    mx = lt.max(dim=-1, keepdim=True).values
    mx_ok = torch.isfinite(mx)
    mxs = torch.where(mx_ok, mx, torch.zeros_like(mx))
    w = torch.where(fin, torch.exp(lt - mxs), torch.zeros_like(lt))
    sw = w.sum(-1, keepdim=True)
    ok2 = (sw > 0) & mx_ok
    inc = torch.where(ok2, mxs + torch.log(torch.clamp(sw, min=1e-35)),
                      ninf[..., :1])
    lnw_new = torch.where(ok2, lt - inc,
                          torch.full_like(lt, -math.log(N)))
    return inc.squeeze(-1), lnw_new


def _ancestors(lnw: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Stratified ancestors ``(B, N)`` from the normalised log-weights
    ``lnw`` and uniforms ``r``."""
    nw = torch.where(torch.isfinite(lnw), torch.exp(lnw),
                     torch.zeros_like(lnw))
    return stratified_indices_from_uniforms(nw, r)


class _AncestorLog:
    """The ancestors a scan used, ``(B, S, N)`` int32: identity at the steps
    that do not resample; kept only when ``keep``.  With ``anc`` given they
    are read from it instead of searched for (the kernels' check-only input
    of the same layout)."""

    def __init__(self, anc, B: int, S: int, N: int, dev, keep: bool):
        self.given = anc
        self.log = torch.arange(N, dtype=torch.int32, device=dev).expand(
            B, S, N).clone() if keep else None

    def pick(self, s: int, search) -> torch.Tensor:
        idx = search() if self.given is None else self.given[:, s - 1].long()
        if self.log is not None:
            self.log[:, s - 1] = idx.to(torch.int32)
        return idx


class _Draws:
    """The randomness of a plain scan, read one step at a time: step 0's
    normals, then at every step s >= 1 its uniforms and its normals.  Either
    slices of injected tensors ``eps (B, S, N, w)`` and ``us (B, S-1, N)``,
    or fresh draws from ``generator`` made at that step, in that order
    (``stream_draws`` makes the same stream as tensors).  A scan asks for
    every step's uniforms, also at steps that do not resample."""

    def __init__(self, eps, us, generator=None, B=None, N=None, w=None,
                 dt=None, dev=None):
        self.eps, self.us = eps, us
        if eps is not None:
            B, _, N, w = eps.shape
        self.shape, self.kw = (B, N, w), dict(dtype=dt, device=dev,
                                             generator=generator)

    def normals(self, s: int) -> torch.Tensor:
        if self.eps is not None:
            return self.eps[:, s].contiguous()
        return rows.randn(self.shape, **self.kw)

    def uniforms(self, s: int) -> torch.Tensor:
        if self.eps is not None:
            return self.us[:, s - 1].contiguous()
        return rows.rand(self.shape[:2], **self.kw)


def stream_draws(generator: torch.Generator, B: int, steps: int, N: int,
                 w: int, dtype, device):
    """The tensors ``eps (B, steps, N, w)`` and ``us (B, steps-1, N)`` that
    a plain scan fed ``generator`` draws step by step (``_Draws``)."""
    d = _Draws(None, None, generator, B, N, w, dtype, device)
    eps = [d.normals(0)]
    us = []
    for s in range(1, steps):
        us.append(d.uniforms(s))
        eps.append(d.normals(s))
    return torch.stack(eps, dim=1), torch.stack(us, dim=1)


def _signal(spec: NGSpec, alpha: torch.Tensor, Z, D, t: int) -> torch.Tensor:
    if spec.distribution == SVM:
        return alpha[..., 0]
    return at_t(D, t).unsqueeze(-1) \
        + (alpha * at_t(Z, t).unsqueeze(-2)).sum(-1)


def psi_logw_scan(spec: NGSpec, al: ApproxLoglik,
                  eps: Optional[torch.Tensor] = None,
                  us: Optional[torch.Tensor] = None, factors=None,
                  resample_every: int = 1,
                  anc: Optional[torch.Tensor] = None,
                  return_ancestors: bool = False,
                  generator: Optional[torch.Generator] = None,
                  nsim: Optional[int] = None):
    """Plain version of the ``psi_logw`` and ``psi_big_logw`` kernels, and
    the tier above 512 particles: the psi-APF log-weight ``(B,)`` as a
    Python loop over time with injected randomness ``eps (B, n+1, N, m)``
    and ``us (B, n, N)``, or without them ``nsim`` particles whose draws
    come from ``generator`` step by step (``_Draws``).  ``factors`` are
    the proposal factors ``(ahat, Lb, Ab)``; computed when absent.  With
    ``resample_every`` = kk > 1 the ensemble is resampled at generation
    steps 1, 1 + kk, ... only (``us`` of the other steps is not read) and
    carries its log-weights in between (``_carry_update``, the recursion of
    the large-ensemble kernel).  kk = 1 keeps the linear-weight recursion of
    the ``psi_logw`` kernel (``_lse_update``) so that its result stays what
    that kernel's tests pin, to the bit; with weights that restart from 1/N
    at every step the two recursions are the same function, and the float64
    checks on the card hold the large-ensemble kernel at kk = 1 to this
    branch at 1e-9.  ``anc (B, n, N)`` replaces the search at the resampling
    steps (the large-ensemble kernel's check-only input);
    ``return_ancestors`` returns ``(logw, ancestors used (B, n, N) int32)``."""
    n = spec.n
    dt, dev = spec.y.dtype, spec.y.device
    draws = _Draws(eps, us, generator, al.approx.mode.shape[0], nsim,
                   spec.m, dt, dev)
    B, N, _ = draws.shape
    kk = int(resample_every)
    ahat, Lb, Ab = _factors(spec, al) if factors is None else factors
    y = with_batch(spec.y, 1)
    u = with_batch(spec.u, 1)
    Z = with_batch(spec.Z, 2)
    D = with_batch(spec.D, 1).to(dt)
    phi = _col(spec.phi)
    yt, Ht, scl = al.approx.ytilde, al.approx.Htilde, al.scales
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731
    log = _AncestorLog(anc, B, n, N, dev, return_ancestors)

    # no observation at alpha_n
    alpha = ahat[:, n, None, :] + draws.normals(0) @ tr(Lb[:, n])
    nw = torch.full((B, N), 1.0 / N, dtype=dt, device=dev)
    lnw = torch.full((B, N), -math.log(N), dtype=dt, device=dev)
    ll = torch.zeros(B, dtype=dt, device=dev)
    for s in range(1, n + 1):
        t = n - s
        r = draws.uniforms(s)
        if kk == 1:
            anc_s = _pick(alpha, log.pick(
                s, lambda: stratified_indices_from_uniforms(nw, r)))
        elif (s - 1) % kk == 0:
            anc_s = _pick(alpha, log.pick(s, lambda: _ancestors(lnw, r)))
            lnw = torch.full_like(lnw, -math.log(N))
        else:
            anc_s = alpha
        alpha = (ahat[:, t, None, :]
                 + (anc_s - ahat[:, t + 1, None, :]) @ tr(Ab[:, t])
                 + draws.normals(s) @ tr(Lb[:, t]))
        sig = _signal(spec, alpha, Z, D, t)
        y_t = y[:, t, None]
        lw = fam.log_weights(spec.distribution, y_t, u[:, t, None], phi, sig,
                             yt[:, t, None], Ht[:, t, None]) - scl[:, t, None]
        ok = torch.isfinite(y_t)                             # (b, 1)
        if kk == 1:
            inc, nw_new = _lse_update(torch.where(ok, lw,
                                                  torch.zeros_like(lw)))
            nw = torch.where(ok, nw_new, torch.full_like(nw_new, 1.0 / N))
        else:
            inc, lnw = _carry_update(lnw, lw, ok)
        ll = ll + torch.where(ok[:, 0], inc, torch.zeros_like(inc))
    return (ll, log.log) if return_ancestors else ll


def bsf_logw_scan(spec: NGSpec, eps: Optional[torch.Tensor] = None,
                  us: Optional[torch.Tensor] = None,
                  resample_every: int = 1,
                  anc: Optional[torch.Tensor] = None,
                  return_ancestors: bool = False,
                  generator: Optional[torch.Generator] = None,
                  nsim: Optional[int] = None):
    """Plain version of the ``bsf_big_logw`` kernel, and the tier above 512
    particles: the bootstrap-filter log-likelihood ``(B,)`` less the
    observation constants, as a Python loop over time with injected
    randomness ``eps (B, n, N, m)`` (``eps[:, 0]`` draws the initial
    ensemble; the state noise is ``R`` zero-padded to m columns times
    ``eps[:, s]``) and ``us (B, n-1, N)`` (``us[:, s-1]`` resamples before
    step s), or ``nsim`` particles drawing from ``generator`` step by step
    (``_Draws``).  ``anc`` and ``return_ancestors`` as in
    ``psi_logw_scan``, ``(B, n-1, N)``."""
    n, m = spec.n, spec.m
    dt, dev = spec.y.dtype, spec.y.device
    draws = _Draws(eps, us, generator, spec.batch or 1, nsim, m, dt, dev)
    B, N, _ = draws.shape
    kk = int(resample_every)
    y = with_batch(spec.y, 1)
    u = with_batch(spec.u, 1)
    Z = with_batch(spec.Z, 2)
    D = with_batch(spec.D, 1).to(dt)
    phi = _col(spec.phi)
    sysb = cuda_kalman.pack_bootstrap_system(spec, B)
    a1, L1, C, R, T = torch.split(sysb, [m, m * m, m, m * m, m * m], dim=1)
    mat = lambda A: A.reshape(B, m, m).transpose(-1, -2)     # noqa: E731
    log = _AncestorLog(anc, B, n - 1, N, dev, return_ancestors)

    def weigh(alpha, lnw, ll, t):
        y_t = y[:, t, None]
        lw = fam.log_obs_density(spec.distribution, y_t, u[:, t, None], phi,
                                 _signal(spec, alpha, Z, D, t))
        ok = torch.isfinite(y_t)
        inc, lnw = _carry_update(lnw, lw, ok)
        return lnw, ll + torch.where(ok[:, 0], inc, torch.zeros_like(inc))

    alpha = a1[:, None, :] + draws.normals(0) @ mat(L1)
    lnw = torch.full((B, N), -math.log(N), dtype=dt, device=dev)
    lnw, ll = weigh(alpha, lnw, torch.zeros(B, dtype=dt, device=dev), 0)
    for s in range(1, n):
        r = draws.uniforms(s)
        if (s - 1) % kk == 0:
            alpha = _pick(alpha, log.pick(s, lambda: _ancestors(lnw, r)))
            lnw = torch.full_like(lnw, -math.log(N))
        alpha = C[:, None, :] + alpha @ mat(T) + draws.normals(s) @ mat(R)
        lnw, ll = weigh(alpha, lnw, ll, s)
    return (ll, log.log) if return_ancestors else ll


def _factors(spec: NGSpec, al: ApproxLoglik):
    """The proposal factors of ``al``'s approximating model: the
    ``rts_factors`` kernel where it takes the model, else its plain
    version."""
    g = al.approx.gaussian(spec)
    if cuda_kalman.route("rts_factors", g):
        return cuda_kalman.rts_factors(g)
    return smoother_bwd_factors(g)


def _plain_draws(key, B, steps, N, m, dt, eps, us):
    """The injected tensors, or those a Philox key stands for
    (``philox_fill_plain``, the local rows counted from ``rows.offset()``):
    the randomness of a plain route in seed mode, as the wrappers' own CPU
    branches draw it."""
    if eps is not None:
        return eps, us
    return cuda_kalman.philox_fill_plain(key, B, steps, N, m, dt,
                                         rows.offset())


def psi_logw(spec: NGSpec, al: ApproxLoglik, nsim: int,
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None,
             us: Optional[torch.Tensor] = None,
             resample_every: int = 1) -> torch.Tensor:
    """The psi-APF log-likelihood estimate only (no trajectories), ``(B,)``:
    ``al.loglik`` plus the log-weight of ``nsim`` particles.

    Up to 32 particles go to the ``psi_logw`` kernel, which resamples at
    every step, with normals and uniforms drawn from ``generator`` unless
    given.  Up to 512 go to ``psi_big_logw`` with the resampling period
    ``resample_every``; unless ``eps`` and ``us`` are given it draws a
    Philox key from ``generator`` and the kernel makes its own randomness
    (the injected tensors of one 16384-row chunk at n = 153, N = 256 would
    be gigabytes), keyed by each row's place in the batch (``row0``, the
    row window's ``rows.offset()``).  Every draw from ``generator`` is
    made with the whole batch's shape inside a row window
    (``core.rows``).  A model the kernels do not take
    (``cuda_kalman.kernel_takes``) runs the plain version,
    ``psi_logw_scan``, on the same randomness.  Above 512 particles every
    model runs ``psi_logw_scan`` with its draws made step by step from
    ``generator`` (or ``eps`` and ``us`` if given)."""
    with profiling.span("bssm.psi.factors"):
        factors = _factors(spec, al)
    with profiling.span("bssm.psi.filter"):
        return al.loglik + _psi_logw_filter(spec, al, nsim, generator, eps,
                                            us, resample_every, factors)


def _psi_logw_filter(spec, al, nsim, generator, eps, us, resample_every,
                     factors):
    """``psi_logw``'s log-weight from the proposal ``factors``."""
    n, m = spec.n, spec.m
    B = al.approx.mode.shape[0]
    dt, dev = spec.y.dtype, spec.y.device
    ahat, Lb, Ab = factors
    if nsim > cuda_kalman.MAX_N_BIG:
        return psi_logw_scan(
            spec, al, eps, us, factors=factors,
            resample_every=resample_every, generator=generator, nsim=nsim)
    if nsim > cuda_kalman.MAX_N_PSI:
        key = None if eps is not None \
            else cuda_kalman.philox_key(generator, dev)
        if cuda_kalman.route("psi_big_logw", spec):
            return cuda_kalman.psi_big_logw(
                spec, al, ahat, Lb, Ab, resample_every, eps=eps, us=us,
                seed=key, nsim=None if key is None else nsim,
                row0=0 if key is None else rows.offset())
        eps, us = _plain_draws(key, B, n + 1, nsim, m, dt, eps, us)
        return psi_logw_scan(spec, al, eps, us, factors=factors,
                             resample_every=resample_every)
    if eps is None:
        eps = rows.randn((B, n + 1, nsim, m), dtype=dt, device=dev,
                         generator=generator)
    if us is None:
        us = rows.rand((B, n, nsim), dtype=dt, device=dev,
                       generator=generator)
    if cuda_kalman.route("psi_logw", spec):
        return cuda_kalman.psi_logw(spec, al, ahat, Lb, Ab, eps, us)
    return psi_logw_scan(spec, al, eps, us, factors=factors)


def bsf_logw(spec: NGSpec, nsim: int,
             generator: Optional[torch.Generator] = None,
             resample_every: int = 1, eps: Optional[torch.Tensor] = None,
             us: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bootstrap-filter log-likelihood estimate only, ``(B,)``: up to
    512 particles the ``bsf_big_logw`` kernel plus the exact observation
    constants.  Randomness as in ``psi_logw``'s large-ensemble branch, and
    a model the kernel does not take likewise runs the plain version,
    ``bsf_logw_scan``, which also serves every model above 512 particles
    with its draws made step by step, as in ``psi_logw``."""
    const = fam.obs_log_const(spec.distribution, with_batch(spec.y, 1),
                              with_batch(spec.u, 1), _col(spec.phi))
    if nsim > cuda_kalman.MAX_N_BIG:
        return const + bsf_logw_scan(spec, eps, us,
                                     resample_every=resample_every,
                                     generator=generator, nsim=nsim)
    key = None if eps is not None \
        else cuda_kalman.philox_key(generator, spec.y.device)
    if cuda_kalman.route("bsf_big_logw", spec):
        return const + cuda_kalman.bsf_big_logw(
            spec, resample_every, eps=eps, us=us, seed=key,
            nsim=None if key is None else nsim,
            row0=0 if key is None else rows.offset())
    eps, us = _plain_draws(key, spec.batch or 1, spec.n, nsim, spec.m,
                           spec.y.dtype, eps, us)
    return const + bsf_logw_scan(spec, eps, us,
                                 resample_every=resample_every)


# ---------------------------------------------------------------------------
# filters with trajectories
# ---------------------------------------------------------------------------

class PFResult(NamedTuple):
    """Particle-filter output, batch first.  ORDER CONTRACT (as the JAX
    package's): ``alpha`` is in time order (``alpha[:, :, t]`` is time t).
    ``weights`` columns are in GENERATION order: time order for the
    forward ``bsf_filter``, reverse time order for the backward-factorised
    ``psi_filter`` (column 0 is t = n).  Either way ``weights[..., -1]``
    are the final importance weights of the complete trajectories, the only
    column downstream consumers may use."""
    loglik: torch.Tensor    # (B,)
    alpha: torch.Tensor     # (B, N, n+1, m) particle trajectories
    weights: torch.Tensor   # (B, N, n+1) normalised weights, generation order
    indices: torch.Tensor   # (B, N, n) resampling ancestors (int64)


def _draws(name, B, steps, N, w, dt, dev, generator, eps, us):
    """The filter's normals ``(B, steps, N, w)`` and uniforms
    ``(B, steps - 1, N)``: the injected ones, or fresh ones from
    ``generator``, normals first."""
    if (eps is None) != (us is None):
        raise ValueError(f"{name}: give both eps and us, or neither")
    if eps is None:
        eps = rows.randn((B, steps, N, w), dtype=dt, device=dev,
                         generator=generator)
        us = rows.rand((B, steps - 1, N), dtype=dt, device=dev,
                       generator=generator)
    if eps.shape[:2] != (B, steps) or eps.shape[-1] != w \
            or tuple(us.shape) != (B, steps - 1, eps.shape[2]):
        raise ValueError(f"{name}: eps must be (B, {steps}, N, {w}) and us "
                         f"(B, {steps - 1}, N) with B = {B}")
    return eps, us


def _weigh(lw: torch.Tensor, ok: torch.Tensor):
    """Normalised weights and the log-likelihood increment of one step from
    the particles' log-weights; a missing y contributes nothing and leaves
    uniform weights."""
    N = lw.shape[-1]
    inc, nw = _lse_update(torch.where(ok, lw, torch.zeros_like(lw)))
    return (torch.where(ok[:, 0], inc, torch.zeros_like(inc)),
            torch.where(ok, nw, torch.full_like(nw, 1.0 / N)))


def _pick(alpha: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(alpha, 1,
                        idx.unsqueeze(-1).expand(*idx.shape, alpha.shape[-1]))


def psi_filter(spec: NGSpec, al: ApproxLoglik, nsim: int,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None,
               us: Optional[torch.Tensor] = None) -> PFResult:
    """psi-auxiliary particle filter twisted by the Gaussian approximation
    ``al``, with trajectories.  The proposal is the smoothing law of the
    approximating model in its backward (FFBS) factorisation; generation
    runs t = n..0 and resamples before every step.  Randomness: ``eps
    (B, n+1, N, m)`` (``eps[:, 0]`` draws alpha_n, ``eps[:, s]`` the state
    of generation step s) and ``us (B, n, N)``, or drawn from
    ``generator``.  ``loglik`` is ``al.loglik`` plus the log-weight.

    The trajectories come back already traced, in time order, with
    identity indices, and ``weights[..., -1]`` are the final weights (those
    of the t = 0 step), as in the JAX package."""
    n, m = spec.n, spec.m
    B = al.approx.mode.shape[0]
    dt, dev = spec.y.dtype, spec.y.device
    eps, us = _draws("psi_filter", B, n + 1, nsim, m, dt, dev, generator,
                     eps, us)
    N = eps.shape[2]
    ahat, Lb, Ab = _factors(spec, al)
    y = with_batch(spec.y, 1)
    u = with_batch(spec.u, 1)
    Z = with_batch(spec.Z, 2)
    D = with_batch(spec.D, 1).to(dt)
    phi = _col(spec.phi)
    yt, Ht, scl = al.approx.ytilde, al.approx.Htilde, al.scales
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731

    alpha = ahat[:, n, None, :] + eps[:, 0] @ tr(Lb[:, n])   # no observation
    nw = torch.full((B, N), 1.0 / N, dtype=dt, device=dev)
    ll = torch.zeros(B, dtype=dt, device=dev) + al.loglik
    alphas, nws, idxs = [alpha], [nw], []
    for s in range(1, n + 1):
        t = n - s
        idx = stratified_indices_from_uniforms(nw, us[:, s - 1])
        anc = _pick(alpha, idx)
        alpha = (ahat[:, t, None, :]
                 + (anc - ahat[:, t + 1, None, :]) @ tr(Ab[:, t])
                 + eps[:, s] @ tr(Lb[:, t]))
        y_t = y[:, t, None]
        lw = fam.log_weights(spec.distribution, y_t, u[:, t, None], phi,
                             _signal(spec, alpha, Z, D, t), yt[:, t, None],
                             Ht[:, t, None]) - scl[:, t, None]
        inc, nw = _weigh(lw, torch.isfinite(y_t))
        ll = ll + inc
        alphas.append(alpha)
        nws.append(nw)
        idxs.append(idx)
    # generation-order cloud (step 0 is t = n), traced, then time-flipped
    traced = ancestor_trace(torch.stack(alphas, dim=2),
                            torch.stack(idxs, dim=2)).flip(2)
    identity = torch.arange(N, device=dev)[:, None].expand(B, N, n)
    return PFResult(ll, traced, torch.stack(nws, dim=2), identity)


def _bsf_run(name: str, spec, nsim: int, generator, eps, us, log_dens):
    """The bootstrap filter's loop, shared by every model kind:
    ``log_dens(alpha (B, N, m), t) -> (B, N)`` the observation
    log-densities, up to their constants, of y_t.  Returns the PFResult
    with the log-likelihood less those constants."""
    n, m, k = spec.n, spec.m, spec.k
    if k > m:
        raise NotImplementedError(
            f"{name}: R has {k} columns, more than the {m} states")
    B = eps.shape[0] if eps is not None else (spec.batch or 1)
    dt, dev = spec.y.dtype, spec.y.device
    eps, us = _draws(name, B, n + 1, nsim, m, dt, dev, generator, eps, us)
    N = eps.shape[2]
    # a time point counts as observed where any of its series is
    obs = torch.isfinite(with_batch(spec.y, 2)).any(-1) if is_mv(spec) \
        else torch.isfinite(with_batch(spec.y, 1))
    T, R, C = with_batch(spec.T, 3), with_batch(spec.R, 3), \
        with_batch(spec.C, 2)
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731

    def weigh(alpha, t):
        return _weigh(log_dens(alpha, t), obs[:, t, None])

    alpha = with_batch(spec.a1, 1)[:, None, :] \
        + eps[:, 0] @ tr(psd_chol(with_batch(spec.P1, 2)))
    ll, nw = weigh(alpha, 0)
    alphas, nws, idxs = [alpha], [nw], []
    for s in range(1, n + 1):
        idx = stratified_indices_from_uniforms(nw, us[:, s - 1])
        alpha = (at_t(C, s - 1)[:, None, :]
                 + _pick(alpha, idx) @ tr(at_t(T, s - 1))
                 + eps[:, s, :, :k] @ tr(at_t(R, s - 1)))
        if s < n:
            inc, nw = weigh(alpha, s)
            ll = ll + inc
        else:
            nw = torch.full_like(nw, 1.0 / N)
        alphas.append(alpha)
        nws.append(nw)
        idxs.append(idx)
    return PFResult(ll, torch.stack(alphas, dim=2), torch.stack(nws, dim=2),
                    torch.stack(idxs, dim=2))


def bsf_filter(spec: NGSpec, nsim: int,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None,
               us: Optional[torch.Tensor] = None) -> PFResult:
    """Bootstrap particle filter of a non-Gaussian model with trajectories:
    particles start from N(a1, P1), move forwards through the state
    equation and are weighted by the observation density, resampling before
    every step; the last step predicts alpha_n beyond the data (uniform
    weights).  Randomness: ``eps (B, n+1, N, m)`` (``eps[:, 0]`` the
    initial draws, the first k entries of ``eps[:, s]`` the state
    disturbances of step s) and ``us (B, n, N)``, or drawn from
    ``generator``.  ``loglik`` includes the exact observation constants.
    The trajectories are untraced: ``ancestor_trace(alpha, indices)`` gives
    the paths."""
    y = with_batch(spec.y, 1)
    u = with_batch(spec.u, 1)
    Z = with_batch(spec.Z, 2)
    D = with_batch(spec.D, 1).to(spec.y.dtype)
    phi = _col(spec.phi)

    def log_dens(alpha, t):
        return fam.log_obs_density(spec.distribution, y[:, t, None],
                                   u[:, t, None], phi,
                                   _signal(spec, alpha, Z, D, t))

    pf = _bsf_run("bsf_filter", spec, nsim, generator, eps, us, log_dens)
    return pf._replace(loglik=pf.loglik + fam.obs_log_const(
        spec.distribution, y, u, phi))


def bsf_filter_lg(spec: LGSpec, nsim: int,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  us: Optional[torch.Tensor] = None) -> PFResult:
    """``bsf_filter`` of a linear-Gaussian model, weighted by the Gaussian
    observation density N(D_t + Z_t' alpha_t, H_t^2): the JAX package's
    ``bsf_filter_lg``, a Monte-Carlo check of the Kalman filter.  The
    same randomness, outputs and order."""
    y = with_batch(spec.y, 1)
    Z = with_batch(spec.Z, 2)
    D = with_batch(spec.D, 1).to(spec.y.dtype)
    HH = with_batch(spec.HH, 1)

    def log_dens(alpha, t):
        mu = at_t(D, t)[:, None] + (alpha * at_t(Z, t)[:, None, :]).sum(-1)
        return -0.5 * torch.square(y[:, t, None] - mu) / at_t(HH, t)[:, None]

    pf = _bsf_run("bsf_filter_lg", spec, nsim, generator, eps, us, log_dens)
    const = -0.5 * (math.log(2.0 * math.pi) + torch.log(HH))
    const = torch.where(torch.isfinite(y), const, torch.zeros_like(const))
    return pf._replace(loglik=pf.loglik + const.expand(-1, spec.n).sum(-1))


# ---------------------------------------------------------------------------
# SPDK importance sampling
# ---------------------------------------------------------------------------

class SPDKResult(NamedTuple):
    loglik: torch.Tensor    # (B,)
    alpha: torch.Tensor     # (B, N, n+1, m) simulation-smoother draws
    weights: torch.Tensor   # (B, N) normalised importance weights


def spdk_weights(spec: NGSpec, al: ApproxLoglik, alpha: torch.Tensor):
    """The Shephard-Pitt / Durbin-Koopman importance weights of draws
    ``alpha (B, N, n+1, m)`` from the smoothing law of ``al``'s
    approximating model: ``(loglik (B,), weights (B, N))``, with loglik
    ``al.loglik`` plus the log of the mean weight.  The signal of the SV
    family is the first state."""
    n = spec.n
    dt = spec.y.dtype
    if spec.distribution == SVM:
        sig = alpha[..., :n, 0]
    else:
        Z = with_batch(spec.Z, 2)[:, None]                  # (b, 1, nz, m)
        D = with_batch(spec.D, 1).to(dt)[:, None]           # (b, 1, nd)
        sig = D + (alpha[..., :n, :] * Z).sum(-1)
    phi = _col(spec.phi)
    phi = phi.unsqueeze(-1) if phi.dim() == 2 else phi
    lw = fam.log_weights(spec.distribution, with_batch(spec.y, 1)[:, None],
                         with_batch(spec.u, 1)[:, None], phi, sig,
                         al.approx.ytilde[:, None], al.approx.Htilde[:, None])
    w = lw.sum(-1) - al.scales.sum(-1)[:, None]
    mx = w.max(dim=-1, keepdim=True).values
    we = torch.exp(w - mx)
    loglik = al.loglik + torch.log(we.mean(-1)) + mx[:, 0]
    return loglik, we / we.sum(-1, keepdim=True)


def spdk_sample(spec: NGSpec, al: ApproxLoglik, nsim: int,
                generator: Optional[torch.Generator] = None,
                antithetic: bool = True, *,
                um: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None,
                eta: Optional[torch.Tensor] = None) -> SPDKResult:
    """SPDK importance sampling of every row: ``nsim`` draws from the
    approximating model's smoothing law (``simulate_states_batched``, the
    ``fast_smoother_ll`` kernel; antithetic by default; ``um``/``eps``/
    ``eta`` inject its normals) weighed by ``spdk_weights``."""
    from ..ops.simsmooth import simulate_states_batched
    alpha = simulate_states_batched(al.approx.gaussian(spec), nsim,
                                    generator, antithetic, um=um,
                                    eps=eps, eta=eta)
    ll, w = spdk_weights(spec, al, alpha)
    return SPDKResult(ll, alpha, w)
