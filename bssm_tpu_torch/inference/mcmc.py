"""MCMC engines: RAM Metropolis on the Gaussian approximation and its
importance-sampling post-correction.  Counterpart of
``bssm_tpu/inference/mcmc.py`` for ``mcmc_type in ("approx", "is2")`` with
``output_type="theta"`` on non-Gaussian (``kind == "ng"``) models.

- Phase 1 is a Python loop over iterations with ALL chains advanced together
  as one batch: every proposal costs one launch of the ``laplace_solve``
  kernel plus elementwise tensor code.  A proposal whose prior is not finite
  is masked out, not branched around.
- Phase 2 (is2) corrects each jump-chain head once with a psi-auxiliary
  particle filter; duplicate slots share their head's result.  The heads are
  processed in chunks of ``corr_batch`` rows, which only bounds memory (the
  injected normals of one chunk are ``corr_batch x (n+1) x N x m`` values).
  Each chunk runs the ``laplace_solve`` (when the modes were not stored),
  ``rts_factors`` and ``psi_logw`` kernels once.

Statistical defaults: burnin = iter/2, target acceptance 0.234,
gamma = 2/3, RAM adaptation at every iteration unless
``end_adaptive_phase`` freezes it after the burn-in.
"""
from __future__ import annotations

import dataclasses
import time as _time
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import resolve_device
from ..models.base import Model
from . import approx as approx_mod
from . import particle as pf_mod
from .ram import adapt_S


# --------------------------------------------------------------------------
# generic RAM-MH loop, all chains batched
# --------------------------------------------------------------------------

class ChainState(NamedTuple):
    theta: torch.Tensor        # (C, d)
    lp_prior: torch.Tensor     # (C,)
    ll: torch.Tensor           # (C,) log-likelihood of the current state
    aux: Optional[torch.Tensor]  # (C, ...) extras carried with theta
    S: torch.Tensor            # (C, d, d)


def _ram_step(logdens: Callable, log_prior: Callable, state: ChainState,
              u: torch.Tensor, unif: torch.Tensor, i: int, target: float,
              gamma: float, adapt: bool):
    """One RAM-MH iteration of every chain from injected randomness:
    ``u (C, d)`` standard normals of the proposal, ``unif (C,)`` uniforms of
    the accept test, ``i`` the 1-based iteration number.  Returns the new
    state and the accept flags ``(C,)``.

    ``logdens(theta (C, d)) -> (ll (C,), aux)``.  Rows whose proposal has a
    non-finite prior are evaluated at their current theta (so the kernels
    see sane inputs) and then masked: log-likelihood -inf, never accepted."""
    prop = state.theta + (state.S @ u.unsqueeze(-1)).squeeze(-1)
    lp_prop = log_prior(prop)
    ok = lp_prop > -torch.inf
    ll_prop, aux_prop = logdens(torch.where(ok.unsqueeze(-1), prop,
                                            state.theta))
    ll_prop = torch.where(ok, ll_prop.to(prop.dtype),
                          torch.full_like(lp_prop, -torch.inf))
    diff = ll_prop - state.ll + lp_prop - state.lp_prior
    acc_prob = torch.where(ok, torch.clamp(torch.exp(diff), max=1.0),
                           torch.zeros_like(diff))
    accept = ok & (torch.log(unif) < diff)
    acc1 = accept.unsqueeze(-1)
    aux = state.aux
    if aux is not None:
        aux = torch.where(accept.reshape((-1,) + (1,) * (aux.dim() - 1)),
                          aux_prop, aux)
    S = adapt_S(state.S, u, acc_prob, target, i, gamma) if adapt else state.S
    new = ChainState(theta=torch.where(acc1, prop, state.theta),
                     lp_prior=torch.where(accept, lp_prop, state.lp_prior),
                     ll=torch.where(accept, ll_prop, state.ll), aux=aux, S=S)
    return new, accept


def _ram_scan(logdens: Callable, log_prior: Callable, theta0: torch.Tensor,
              S0: torch.Tensor, generator: torch.Generator, n_iter: int,
              burnin: int, thin: int, target: float, gamma: float,
              end_ram: bool, store_aux: bool):
    """Run the RAM-MH chains; stores the post-burn-in slots
    ``burnin, burnin + thin, ...`` (0-based iteration positions).

    Returns (final state, thetas (C, S, d), log-priors (C, S), log-liks
    (C, S), accept flags (C, S), aux (C, S, ...) or None, acceptance rate
    after burn-in ``(C,)``)."""
    C, d = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    ll0, aux0 = logdens(theta0)
    state = ChainState(theta0, log_prior(theta0), ll0.to(dt),
                       aux0 if store_aux else None, S0)
    slots = list(range(burnin, n_iter, thin))
    Sn = len(slots)
    thetas = torch.empty((C, Sn, d), dtype=dt, device=dev)
    lps = torch.empty((C, Sn), dtype=dt, device=dev)
    lls = torch.empty((C, Sn), dtype=dt, device=dev)
    accs = torch.empty((C, Sn), dtype=torch.bool, device=dev)
    auxs = None
    if store_aux:
        auxs = torch.empty((C, Sn) + tuple(aux0.shape[1:]), dtype=aux0.dtype,
                           device=dev)
    n_acc = torch.zeros(C, dtype=dt, device=dev)
    k = 0
    for i in range(1, n_iter + 1):
        u = torch.randn((C, d), dtype=dt, device=dev, generator=generator)
        unif = torch.rand((C,), dtype=dt, device=dev, generator=generator)
        adapt = (i <= burnin) if end_ram else True
        state, accept = _ram_step(logdens, log_prior, state, u, unif, i,
                                  target, gamma, adapt)
        pos = i - 1
        if pos >= burnin:
            n_acc += accept.to(dt)
            if (pos - burnin) % thin == 0:
                thetas[:, k] = state.theta
                lps[:, k] = state.lp_prior
                lls[:, k] = state.ll
                accs[:, k] = accept
                if store_aux:
                    auxs[:, k] = state.aux
                k += 1
    acc_rate = n_acc / max(n_iter - burnin, 1)
    return state, thetas, lps, lls, accs, auxs, acc_rate


# --------------------------------------------------------------------------
# results container
# --------------------------------------------------------------------------

@dataclasses.dataclass(repr=False, eq=False)
class McmcOutput:
    """Posterior sample container (dense storage, chain axis first), plain
    numpy arrays.  theta is reported in the natural space (log-sampled
    parameters exponentiated back)."""
    theta: np.ndarray            # (chains, S, d)
    posterior: np.ndarray        # (chains, S)
    accepted: np.ndarray         # (chains, S) jump-chain head flags
    acceptance_rate: float
    S: np.ndarray                # (chains, d, d) final RAM factors
    theta_names: tuple
    mcmc_type: str
    output_type: str
    iter: int
    burnin: int
    thin: int
    weights: Optional[np.ndarray] = None     # (chains, S) IS weights
    modes: Optional[np.ndarray] = None       # (chains, S, n) Laplace modes
    approx_loglik: Optional[np.ndarray] = None
    prior: Optional[np.ndarray] = None
    time: Optional[dict] = None
    theta_sampled: Optional[np.ndarray] = None  # (chains, S, d) sampled space
    n_corrected: Optional[int] = None        # jump-chain heads corrected

    @property
    def counts(self) -> np.ndarray:
        return np.ones_like(self.posterior, dtype=np.int64)

    def flat_theta(self) -> np.ndarray:
        return self.theta.reshape(-1, self.theta.shape[-1])

    def flat_weights(self) -> np.ndarray:
        if self.weights is None:
            return np.ones(self.posterior.size)
        return self.weights.reshape(-1)

    def __repr__(self) -> str:
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                parts.append(f"{f.name}=<{'x'.join(map(str, v.shape))} "
                             f"{v.dtype}>")
            elif f.name in ("mcmc_type", "output_type", "acceptance_rate",
                            "iter"):
                parts.append(f"{f.name}={v!r}")
        return f"McmcOutput({', '.join(parts)})"


# --------------------------------------------------------------------------
# phase 1: approximate MCMC
# --------------------------------------------------------------------------

def _approx_chain(model: Model, n_iter, burnin, thin, target, gamma, end_ram,
                  conv_tol, max_iter, scan_modes=True):
    """The phase-1 sampler targeting the Gaussian-approximation posterior.
    Every evaluation cold-starts the Laplace iteration from the data-derived
    mode, so the approximate posterior does not depend on the chain's
    history.  With ``scan_modes`` the converged mode of the current state is
    carried and stored per slot for the correction; without, the correction
    recomputes it."""

    def logdens(theta):
        spec = model.build(theta)
        al = approx_mod.approx_loglik(spec, conv_tol=conv_tol,
                                      max_iter=max_iter)
        return al.loglik, al.approx.mode

    def chain(generator, theta0, S0):
        final, thetas, lps, lls, accepted, modes, acc_rate = _ram_scan(
            logdens, model.log_prior, theta0, S0, generator, n_iter, burnin,
            thin, target, gamma, end_ram, store_aux=scan_modes)
        return dict(theta=thetas, prior=lps, approx_ll=lls,
                    accepted=accepted, modes=modes, S=final.S,
                    acc_rate=acc_rate)

    return chain


# --------------------------------------------------------------------------
# phase 2: IS post-correction
# --------------------------------------------------------------------------

def _make_correct_rows(model: Model, nsim: int, sampling_method: str,
                       conv_tol: float = 1e-8, max_iter: int = 100):
    """The psi-APF log-weight-only correction of a batch of stored draws
    (the counterpart of the JAX package's per-draw ``_make_correct_one``,
    psi / theta-output branch).

    ``correct_rows(theta (B, d), modes (B, n) or None, generator, eps=None,
    us=None) -> {"log_w": (B,)}``.  Without stored modes the Laplace
    approximation is recomputed cold, which reproduces phase 1's (it cold
    starts too)."""
    if sampling_method != "psi":
        raise NotImplementedError(
            f"sampling_method={sampling_method!r}: only 'psi' is ported")
    if model.kind != "ng":
        raise NotImplementedError(f"model kind {model.kind!r} is not ported")

    def correct_rows(theta, modes=None, generator=None, eps=None, us=None):
        spec = model.build(theta)
        if modes is None:
            ar = approx_mod.approximate(spec, conv_tol, max_iter)
        else:
            ar = approx_mod.approximate_for_is(spec, modes)
        sc = approx_mod.mode_scales(spec, ar)
        zero = torch.zeros(theta.shape[0], dtype=spec.y.dtype,
                           device=spec.y.device)
        al = approx_mod.ApproxLoglik(ar, sc, zero, zero)
        return {"log_w": pf_mod.psi_logw(spec, al, nsim, generator, eps=eps,
                                         us=us)}

    return correct_rows


def _is_correction_flat(model: Model, thetas, modes, generator, nsim,
                        sampling_method, batch_size, conv_tol=1e-8,
                        max_iter=100):
    """IS correction over a flat axis of stored draws, in chunks of
    ``batch_size`` rows.  thetas ``(Ns, d)``; modes ``(Ns, n)`` or None.
    Returns ``{"log_w": (Ns,)}``."""
    correct_rows = _make_correct_rows(model, nsim, sampling_method, conv_tol,
                                      max_iter)
    parts = []
    for lo in range(0, thetas.shape[0], batch_size):
        mo = None if modes is None else modes[lo:lo + batch_size]
        parts.append(correct_rows(thetas[lo:lo + batch_size], mo,
                                  generator)["log_w"])
    return {"log_w": torch.cat(parts)}


def _is_postprocess(model: Model, thetas, modes, accepted, generator, *,
                    nsim, sampling_method, batch_size, conv_tol=1e-8,
                    max_iter=100):
    """is2: correct each jump-chain head once with ``nsim`` particles;
    duplicate slots share the head's result.  thetas ``(C, S, d)``; returns
    ``({"log_w": (C, S)}, number of heads)``."""
    C, Sn = thetas.shape[:2]
    hmask = accepted.clone()
    hmask[:, 0] = True                      # slot 0 of a chain is a head
    hmask = hmask.reshape(-1)
    hidx = torch.nonzero(hmask).squeeze(-1)
    th_rows = thetas.reshape(C * Sn, -1)[hidx]
    mo_rows = None if modes is None else modes.reshape(C * Sn, -1)[hidx]
    corr = _is_correction_flat(model, th_rows, mo_rows, generator, nsim,
                               sampling_method, batch_size, conv_tol,
                               max_iter)
    return _is_finish(corr, hmask, (C, Sn)), int(hidx.shape[0])


def _is_finish(corr, hmask, shape):
    """Assembly pass of is2: jump-chain fill of the heads' log-weights."""
    src = torch.cumsum(hmask.to(torch.int64), 0) - 1   # head ordinal per slot
    log_w = corr["log_w"][src]
    log_w = torch.where(torch.isfinite(log_w), log_w,
                        torch.full_like(log_w, -torch.inf))
    return {"log_w": log_w.reshape(shape)}


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def _generators(seed: int, device: torch.device):
    """One generator for phase 1 and one for phase 2, both on ``device``."""
    s1, s2 = np.random.SeedSequence(int(seed)).generate_state(2)
    g1 = torch.Generator(device=device).manual_seed(int(s1))
    g2 = torch.Generator(device=device).manual_seed(int(s2))
    return g1, g2


def run_mcmc(model: Model, iter: int = 2000, *, burnin: Optional[int] = None,
             thin: int = 1, particles: int = 0,
             mcmc_type: Optional[str] = None,
             sampling_method: Optional[str] = None,
             target_acceptance: float = 0.234, gamma: float = 2.0 / 3.0,
             S=None, end_adaptive_phase: bool = False,
             output_type: str = "theta", n_chains: int = 1, seed: int = 1,
             conv_tol: float = 1e-8, max_iter: int = 100, theta_init=None,
             corr_batch: Optional[int] = None, store_modes: bool = True,
             device=None, dtype: Optional[torch.dtype] = None) -> McmcOutput:
    """Bayesian inference via adaptive MCMC for non-Gaussian models.

    mcmc_type: "is2" (default) or "approx".  sampling_method: "psi".
    output_type: "theta".  ``device=None`` means the CUDA device and raises
    when there is none; it must agree with the device the model was built
    on.  ``dtype`` defaults to the model's."""
    t0 = _time.time()
    device = resolve_device(device)
    dtype = model.dtype if dtype is None else dtype
    if device != model.device or dtype != model.dtype:
        raise ValueError(
            f"the model lives on {model.device} as {model.dtype}; run_mcmc "
            f"was asked for {device} and {dtype}.  Build the model with the "
            "same device and dtype.")
    if model.kind != "ng":
        raise NotImplementedError(f"model kind {model.kind!r} is not ported")
    mcmc_type = mcmc_type or "is2"
    sampling_method = sampling_method or "psi"
    if mcmc_type not in ("approx", "is2"):
        raise NotImplementedError(
            f"mcmc_type={mcmc_type!r}: only 'approx' and 'is2' are ported")
    if output_type != "theta":
        raise NotImplementedError(
            f"output_type={output_type!r}: only 'theta' is ported")
    if sampling_method != "psi":
        raise NotImplementedError(
            f"sampling_method={sampling_method!r}: only 'psi' is ported")
    if mcmc_type == "is2" and particles < 2:
        raise ValueError("particles >= 2 required for non-approx MCMC")
    if burnin is None:
        burnin = iter // 2

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    theta0 = dev(model.theta_init if theta_init is None else theta_init)
    if theta0.dim() == 1:
        theta0 = theta0.expand(n_chains, -1).contiguous()
    elif theta0.shape[0] != n_chains:
        raise ValueError("theta_init must be (d,) or (n_chains, d)")
    S0 = dev(model.initial_S() if S is None else S)
    if S0.dim() == 2:
        S0 = S0.expand(n_chains, -1, -1).contiguous()
    gen1, gen2 = _generators(seed, device)

    # fail fast on a non-finite initial prior
    if not bool(torch.isfinite(model.log_prior(theta0)).all()):
        raise ValueError("Initial prior probability is not finite.")

    # "approx" keeps the modes when asked (later state draws replay them)
    scan_modes = bool(store_modes)
    chain = _approx_chain(model, n_iter=iter, burnin=burnin, thin=thin,
                          target=target_acceptance, gamma=gamma,
                          end_ram=end_adaptive_phase, conv_tol=conv_tol,
                          max_iter=max_iter, scan_modes=scan_modes)
    res = chain(gen1, theta0, S0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_mcmc = _time.time() - t0

    def host(x):
        return x.detach().cpu().numpy()

    out = McmcOutput(
        theta=host(model.to_natural(res["theta"])),
        posterior=host(res["prior"] + res["approx_ll"]),
        accepted=host(res["accepted"]),
        acceptance_rate=float(res["acc_rate"].mean()),
        S=host(res["S"]), theta_names=model.theta_names, mcmc_type=mcmc_type,
        output_type=output_type, iter=iter, burnin=burnin, thin=thin,
        prior=host(res["prior"]), approx_loglik=host(res["approx_ll"]),
        time={"mcmc": t_mcmc})
    if store_modes:
        out.modes = host(res["modes"])
        out.theta_sampled = host(res["theta"])

    if mcmc_type == "is2":
        t1 = _time.time()
        post, n_heads = _is_postprocess(
            model, res["theta"], res["modes"], res["accepted"], gen2,
            nsim=particles, sampling_method=sampling_method,
            batch_size=int(corr_batch or 256), conv_tol=conv_tol,
            max_iter=max_iter)
        log_w = post["log_w"]
        # weights are stored shifted by the global max so exp never
        # overflows (IS averages are scale invariant)
        mx = log_w.max()
        shift = torch.clamp(torch.where(torch.isfinite(mx), mx,
                                        torch.zeros_like(mx)), min=0.0)
        weights = torch.exp(log_w - shift)
        posterior = res["prior"] + res["approx_ll"] + log_w
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.weights = host(weights)
        out.posterior = host(posterior)
        out.n_corrected = n_heads
        out.time["correction"] = _time.time() - t1

    if out.acceptance_rate == 0.0:
        warnings.warn("No proposals were accepted after burn-in. "
                      "Check your model.", RuntimeWarning)
    return out
