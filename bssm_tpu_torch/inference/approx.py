"""Gaussian (Laplace) approximation of non-Gaussian models, batched.

Counterpart of ``bssm_tpu/inference/approx.py``.  The mode-matching
iteration of Durbin-Koopman / Shephard-Pitt: iterate
{ pseudo-observations (ytilde, Htilde) at the current signal mode ->
  Kalman fast-smooth the approximating LG model -> new signal mode }
until the mean-squared signal change drops below ``conv_tol`` (at most
``max_iter`` passes), always started cold from ``spec.initial_mode``.

Two routes, chosen by the call site as in the JAX package's
``get_laplace_solver``: a batched spec (the chains, the stored draws of the
correction) goes to the ``laplace_solve`` kernel, the whole iteration in one
launch; an unbatched spec (one model: the public API, ``suggest_N``) goes to
``laplace_solve_steps``, a host loop over the ``laplace_step`` kernel that
tests convergence after every pass.  ``laplace_solve_plain`` is the plain
version of both (``ops/cuda_kalman.py``), and what runs, on either device,
for a model the kernels do not take (``cuda_kalman.kernel_takes``: m > 4,
a time-varying system); all stop row by row.  With
``config.time_parallel`` set every spec, batched or not, iterates by
``_laplace_step_parallel`` instead (the associative-scan smoother of
``ops/pkalman.py``, each pass through ``replay`` when given), as the JAX
package switches at the same two places: the mode iteration and the
Gaussian log-likelihood of ``approx_loglik``.

The global approximation (``run_mcmc(local_approx=False)``) solves the
pseudo-observations once, at the model's initial theta
(``global_approximation``), and then evaluates every proposal with one
``fast_smoother_ll`` pass of the approximating model they define
(``global_approx_loglik``).  Its particle filters and SPDK propose from
the approximation rebuilt at that mode, and ``rebuilt_loglik`` completes
their log-weight to an estimate of the log-likelihood itself, so that a
correction or a pseudo-marginal chain weighs against the global
approximation's likelihood.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import config
from ..core import distributions as fam
from ..core.spec import LGSpec, NGSpec, SVM, with_batch
from ..diagnostics import profiling
from ..ops import cuda_kalman, kalman, pkalman

CONV_TOL = 1e-8
MAX_ITER = 100


def _col(phi: torch.Tensor) -> torch.Tensor:
    """phi ``()`` or ``(B,)`` -> broadcastable against ``(B, n)`` series."""
    return phi.unsqueeze(-1) if phi.dim() == 1 else phi


def signal_from_states(spec: NGSpec, alpha: torch.Tensor) -> torch.Tensor:
    """Linear signal s_t = D_t + Z_t' alpha_t, ``(B, n)`` from alpha
    ``(B, n, m)``; for the SV family the signal is the first state."""
    if spec.distribution == SVM:
        return alpha[..., 0]
    Z = with_batch(spec.Z, 2)               # (b, nz, m), nz in {1, n}
    D = with_batch(spec.D, 1)               # (b, nd)
    return D + (Z * alpha).sum(-1)


class ApproxResult(NamedTuple):
    mode: torch.Tensor       # (B, n) converged signal mode
    ytilde: torch.Tensor     # (B, n) pseudo-observations (NaN at missing y)
    Htilde: torch.Tensor     # (B, n) pseudo-std-devs
    niter: torch.Tensor      # (B,) passes used
    diff: torch.Tensor       # (B,) final mean-squared change
    gloglik: Optional[torch.Tensor] = None   # (B,) KF loglik of the
    # approximating model at (ytilde, Htilde), from the final smoother pass

    def gaussian(self, spec: NGSpec) -> LGSpec:
        return spec.approx_gaussian(self.ytilde, self.Htilde)


def _one_match(spec: NGSpec, mode: torch.Tensor):
    yt, HH = fam.laplace_match(spec.distribution, spec.y, spec.u,
                               _col(spec.phi), mode)
    H = torch.sqrt(torch.where(torch.isfinite(HH) & (HH > 0), HH,
                               torch.ones_like(HH)))
    yt = torch.where(spec.obs_mask, yt, torch.full_like(yt, torch.nan))
    return yt, H


def _laplace_step(spec: NGSpec, mode: torch.Tensor,
                  smoother=kalman.fast_smoother_ll):
    """One body of the iteration: (new mode, KF loglik of the approximating
    model at match(mode), mean-squared change), all per row."""
    yt, H = _one_match(spec, mode)
    alpha, ll = smoother(spec.approx_gaussian(yt, H))
    new_mode = signal_from_states(spec, alpha[:, :spec.n])
    diff = torch.square(new_mode - mode).sum(-1) / spec.n
    return new_mode, ll, diff


def _laplace_step_parallel(spec: NGSpec, mode: torch.Tensor):
    """``_laplace_step`` through the time-parallel smoother."""
    return _laplace_step(spec, mode, pkalman.fast_smoother_ll_parallel)


def _solve(spec: NGSpec, mode0: torch.Tensor, conv_tol: float,
           max_iter: int, step, core: int = 1):
    """The batched loop over a Laplace ``step`` with per-row stopping (a
    converged row keeps its values while the others go on), one host
    synchronisation a pass.  ``core`` is the number of axes of one row's
    mode: 1, ``(n,)``; 2 for several series, ``(n, p)``.  Returns (mode,
    prev, niter, diff, ll)."""
    m0 = with_batch(mode0, core)
    B = spec.batch or m0.shape[0]
    dt, dev = spec.y.dtype, spec.y.device
    mode = m0.expand((B,) + m0.shape[1:]).clone()
    prev = mode.clone()
    niter = torch.zeros(B, dtype=torch.int32, device=dev)
    diff = torch.full((B,), conv_tol + 1.0, dtype=dt, device=dev)
    ll = torch.zeros(B, dtype=dt, device=dev)
    for _ in range(int(max_iter)):
        active = diff > conv_tol
        if not bool(active.any()):
            break
        new_mode, new_ll, new_diff = step(spec, mode)
        a2 = active.reshape((B,) + (1,) * core)
        prev = torch.where(a2, mode, prev)
        mode = torch.where(a2, new_mode, mode)
        ll = torch.where(active, new_ll, ll)
        diff = torch.where(active, new_diff, diff)
        niter = niter + active.to(torch.int32)
    return mode, prev, niter, diff, ll


def _counted(out):
    """A Laplace solve's result, its passes added to the open fit's counter
    (``profiling.count_passes``): the routes the kernel does not count."""
    profiling.count_passes(out[2])
    return out


def _replayed(step, replay):
    """``step`` itself, or each call of it through ``replay``."""
    return step if replay is None else (
        lambda s, mode: replay(step, s, mode))


def laplace_solve_plain(spec: NGSpec, mode0: torch.Tensor, conv_tol: float,
                        max_iter: int, replay=None):
    """Plain version of the ``laplace_solve`` kernel and of
    ``laplace_solve_steps``: the loop over ``_laplace_step``; with
    ``replay`` (``inference.replay.Replay``) each pass runs through it, one
    CUDA graph a shape on the card."""
    return _counted(_solve(spec, mode0, conv_tol, max_iter,
                           _replayed(_laplace_step, replay)))


def laplace_solve_steps(spec: NGSpec, mode0: torch.Tensor, conv_tol: float,
                        max_iter: int):
    """The single-model solve, the counterpart of the JAX package's
    ``_laplace_solve_base``: the loop over ``cuda_kalman.laplace_step``
    (the ``laplace_step`` kernel on the card), testing convergence between
    launches.  It serves any batch, row by row.  Returns (mode, prev,
    niter, diff, ll) as ``cuda_kalman.laplace_solve``.  A model the kernel
    does not take loops over the plain pass instead."""
    step = cuda_kalman.laplace_step \
        if cuda_kalman.route("laplace_step", spec) else _laplace_step
    return _counted(_solve(spec, mode0, conv_tol, max_iter, step))


def approximate(spec: NGSpec, conv_tol: float = CONV_TOL,
                max_iter: int = MAX_ITER, mode0=None,
                replay=None) -> ApproxResult:
    """Full Laplace iteration from ``spec.initial_mode`` (or ``mode0``): an
    unbatched spec through ``laplace_solve_steps``, a batched one through
    the ``laplace_solve`` kernel, or where the kernel does not take it
    through ``laplace_solve_plain`` (its passes through ``replay`` when
    given); under ``config.time_parallel`` any spec through the
    time-parallel pass (through ``replay`` when given).

    The (ytilde, Htilde) returned are re-derived from the penultimate mode,
    exactly the pair the last smoother pass consumed, and ``gloglik`` is
    that pass's Kalman log-likelihood.  Counts its rows in the counter
    ``laplace.rows`` and, while spans are on, its passes in the fit's
    ``laplace.passes`` (``diagnostics/profiling.py``): the kernel adds
    them on the card, ``_counted`` on every other route."""
    if mode0 is None:
        mode0 = spec.initial_mode
    mode0 = mode0.to(spec.y.dtype)
    # a conv_tol below the dtype's noise floor would always exhaust max_iter
    # (float32 eps ~1e-7); clamp to a resolvable tolerance
    conv_tol = max(conv_tol, 50.0 * float(torch.finfo(spec.y.dtype).eps))
    if config.time_parallel:
        # every pass by associative scans (any batch, m, time variation);
        # neither Laplace kernel runs and no plain route is counted
        def solve(*a):
            return _counted(_solve(*a, _replayed(_laplace_step_parallel,
                                                 replay)))
    elif spec.batch is None:
        solve = laplace_solve_steps
    elif cuda_kalman.route("laplace_solve", spec):
        solve = cuda_kalman.laplace_solve
    else:
        def solve(*a):
            return laplace_solve_plain(*a, replay=replay)
    with profiling.span("bssm.laplace"):
        mode, prev, niter, diff, gll = solve(spec, mode0, conv_tol,
                                             max_iter)
        profiling.HOST["laplace.rows"] += niter.shape[0]
        yt, H = _one_match(spec, prev)
    return ApproxResult(mode, yt, H, niter, diff, gll)


def approximate_for_is(spec: NGSpec, stored_mode: torch.Tensor
                       ) -> ApproxResult:
    """Rebuild the approximation from a stored mode without iterating."""
    with profiling.span("bssm.laplace.rebuild"):
        yt, H = _one_match(spec, stored_mode)
        B = stored_mode.shape[0]
        dev = stored_mode.device
        return ApproxResult(stored_mode, yt, H,
                            torch.ones(B, dtype=torch.int32, device=dev),
                            torch.zeros(B, dtype=spec.y.dtype, device=dev))


class ApproxLoglik(NamedTuple):
    approx: ApproxResult
    scales: torch.Tensor        # (B, n) mode-based correction terms
    loglik: torch.Tensor        # (B,) approximate marginal log-likelihood
    gaussian_loglik: torch.Tensor


def mode_scales(spec: NGSpec, approx: ApproxResult) -> torch.Tensor:
    """Mode-based correction terms ``(B, n)``, zero at missing y."""
    sc = fam.scales(spec.distribution, spec.y, spec.u, _col(spec.phi),
                    approx.mode, approx.ytilde, approx.Htilde)
    return torch.where(spec.obs_mask, sc, torch.zeros_like(sc))


def approx_loglik(spec: NGSpec, approx: Optional[ApproxResult] = None,
                  conv_tol: float = CONV_TOL, max_iter: int = MAX_ITER,
                  mode0=None, replay=None) -> ApproxLoglik:
    """Approximate marginal log-likelihood = KF loglik of the approximating
    model + exact constant term + sum of the mode-based scales."""
    if approx is None:
        approx = approximate(spec, conv_tol, max_iter, mode0=mode0,
                             replay=replay)
    if approx.gloglik is not None:
        gll = approx.gloglik
    elif config.time_parallel:
        gll = pkalman.log_likelihood_parallel(approx.gaussian(spec))
    else:
        gll = kalman.log_likelihood(approx.gaussian(spec))
    sc = mode_scales(spec, approx)
    ct = fam.const_term(spec.distribution, spec.y, spec.u, _col(spec.phi),
                        approx.ytilde, approx.Htilde)
    return ApproxLoglik(approx, sc, gll + ct + sc.sum(-1), gll)


class GlobalApprox(NamedTuple):
    """The frozen pseudo-observations of the global approximation, solved
    once at a model's initial theta: ``(n,)`` each, shared by every row."""
    ytilde: torch.Tensor
    Htilde: torch.Tensor


def global_approximation(model, conv_tol: float = CONV_TOL,
                         max_iter: int = MAX_ITER) -> GlobalApprox:
    """``(ytilde0, Htilde0)`` of the global approximation: the Laplace
    approximation of ONE model, built at ``model.theta_init`` (unbatched,
    as the single-model API builds it, so the solve is
    ``laplace_solve_steps``).  It is a constant of the run, not a function
    of theta."""
    from .filters import spec_of
    ap = approximate(spec_of(model), conv_tol, max_iter)
    return GlobalApprox(ap.ytilde[0], ap.Htilde[0])


def global_approx_loglik(spec: NGSpec, ga: GlobalApprox):
    """The global approximation at every row of ``spec``: one fast-smoother
    pass of the approximating model with the frozen pseudo-observations
    (``fast_smoother_ll``; y and H shared, the system per row), the mode of
    its smoothed states, and ``ll = Kalman loglik + const_term +
    sum of the scales at that mode``.  Returns ``(ll (B,), mode (B, n))``,
    the JAX package's ``local_approx=False`` evaluation."""
    # the frozen series as stride-0 views of B rows: the kernel reads them
    # with batch stride 0, nothing is copied
    B = spec.batch or 1
    g = spec.approx_gaussian(ga.ytilde.expand(B, -1), ga.Htilde.expand(B, -1))
    alpha, gll = cuda_kalman.routed_fast_smoother_ll(g)
    mode = signal_from_states(spec, alpha[:, :spec.n])
    sc = fam.scales(spec.distribution, spec.y, spec.u, _col(spec.phi), mode,
                    ga.ytilde, ga.Htilde)
    sc = torch.where(spec.obs_mask, sc, torch.zeros_like(sc))
    ct = fam.const_term(spec.distribution, spec.y, spec.u, _col(spec.phi),
                        ga.ytilde, ga.Htilde)
    return gll + ct + sc.sum(-1), mode


def rebuilt_loglik(spec: NGSpec, approx: ApproxResult) -> torch.Tensor:
    """The approximate log-likelihood ``(B,)`` of an approximation rebuilt
    at a mode (``approximate_for_is``): the Kalman log-likelihood of its
    approximating model (``log_likelihood``) + const_term + the sum of its
    scales.  A psi filter or SPDK built on that approximation estimates
    L(theta) over exp of it, so this plus their log-weight estimates the
    log-likelihood itself."""
    sc = mode_scales(spec, approx)
    ct = fam.const_term(spec.distribution, spec.y, spec.u, _col(spec.phi),
                        approx.ytilde, approx.Htilde)
    return (cuda_kalman.routed_log_likelihood(approx.gaussian(spec)) + ct
            + sc.sum(-1))


def gaussian_approx(spec, conv_tol: float = CONV_TOL,
                    max_iter: int = MAX_ITER, theta=None) -> LGSpec:
    """The approximating linear-Gaussian model of ``spec``, a non-Gaussian
    model (built at ``theta``, by default its initial value) or spec: an
    ``LGSpec``, or for several series or a nonlinear model (linearised at
    its mode) an ``MVLGSpec``."""
    from ..core.spec import MVNGSpec
    from ..models.nlg import NLGSpec
    from .filters import refuse_sde, spec_of
    spec = refuse_sde(spec_of(spec, theta), "gaussian_approx")
    if isinstance(spec, NLGSpec):
        from .nlg import approximate_nlg
        return approximate_nlg(spec).approx
    if isinstance(spec, MVNGSpec):
        from .approx_mv import approximate_mv
        return approximate_mv(spec, conv_tol, max_iter).gaussian(spec)
    if not isinstance(spec, NGSpec):
        raise TypeError(f"gaussian_approx takes a non-Gaussian model, got "
                        f"{type(spec).__name__}")
    return approximate(spec, conv_tol, max_iter).gaussian(spec)
