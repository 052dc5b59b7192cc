"""MCMC engines.  Counterpart of ``bssm_tpu/inference/mcmc.py`` for

- ``mcmc_type="gaussian"`` (linear-Gaussian models, ``kind`` "lg" or
  "mlg"): RAM
  Metropolis on the exact Kalman log-likelihood, with ``output_type``
  "theta", "summary" (posterior mean and covariance of the states) or
  "full" (one simulation-smoother draw of the states per stored theta);

and, for non-Gaussian models (``kind`` "ng" or "mng"):

- ``mcmc_type="approx"``: RAM Metropolis on the Gaussian approximation, with
  ``output_type`` "theta" or "full" (one draw of the states from the
  approximating Gaussian model per stored theta);
- ``mcmc_type="is2"``: the same chain followed by an importance-sampling
  correction of each jump-chain head, by the psi-auxiliary particle filter
  (``sampling_method="psi"``), the bootstrap filter (``"bsf"``) or SPDK
  importance sampling from the approximating model (``"spdk"``);
  ``"is1"`` corrects every stored slot and averages each jump-chain
  segment's estimates, ``"is3"`` corrects every slot on its own; all three
  with ``output_type`` "theta", "summary" (weighted posterior mean and
  covariance of the states) or "full" (one trajectory per slot);
- ``mcmc_type="pm"``: pseudo-marginal Metropolis on an importance-sampling
  estimate of the likelihood (psi, bsf or spdk), ``output_type`` "theta" or
  "full" (the trajectory drawn with the accepted estimate, kept on
  rejection);
- ``mcmc_type="da"``: delayed acceptance, stage 1 on the approximation and
  stage 2 on that estimate, ``output_type`` "theta" or "full".

The approximation is local (``local_approx=True``, the default: a Laplace
iteration at every evaluation) or global (frozen pseudo-observations solved
once at the initial theta, then one ``fast_smoother_ll`` pass a proposal;
``approx.global_approx_loglik``); ``_approx_evaluator`` is the one
evaluation phase 1, pm, and da's stage 1 call.

All chains advance together as one batch in a Python loop over iterations:
every proposal costs one launch of each kernel on its path plus elementwise
tensor code.  A proposal whose prior is not finite is masked out, not
branched around.  Kernels per evaluation (``ops/cuda_kalman.py``):
``log_likelihood`` for the linear-Gaussian target, ``fast_smoother_ll``
for the conditional means of its state draws; ``laplace_solve`` for the
approximation; ``rts_factors`` and ``psi_logw``
(up to 32 particles) or ``psi_big_logw`` (up to 512) for the psi filter;
``bsf_big_logw`` for the bootstrap filter; above 512 particles the plain
scans (``particle.psi_logw_scan`` / ``bsf_logw_scan``); ``fast_smoother_ll``
for the global approximation and for SPDK's simulation smoother.  Summary
and full output of the IS correction, and full output of pm and da, run
the filters with trajectories (``particle.psi_filter`` / ``bsf_filter``,
batched tensor code; the psi factors from ``rts_factors``) or SPDK, and
the approx full output the simulation smoother (``fast_smoother_ll``).
A model the kernels do not take (m > 4, a time-varying system: a seasonal
model with period 12, say) runs the same chains through their plain
versions on the card (``cuda_kalman.route``).

The nonlinear models (``kind`` "nlg", ``inference/nlg.py``) run
``mcmc_type="ekf"`` (RAM Metropolis on the extended Kalman filter's
log-likelihood, ``output_type`` "theta", "summary" or "full" from the
model linearised along the EKF) and approx, is1/is2/is3, pm and da on the
mode approximation (damped Gauss-Newton from the EKF start) with the psi
filter or the bootstrap filter (``sampling_method`` defaults to "bsf", as
in the JAX package; SPDK and the global approximation do not exist for
them).  They reach no kernel either: an EKF log-likelihood, each
Gauss-Newton pass and pm / da's filter estimate run as CUDA graphs.

The SDE models (``kind`` "sde", ``inference/sde.py``) run approx,
is1/is2/is3, pm and da with the bootstrap filter (``sampling_method`` is
"bsf" whatever is asked, as in the JAX package): the approximation of
phase 1 and of da's first stage is the coarse-level (2^L_c) filter with
max(particles, 2) particles, coupled to the fine-level (2^L_f) filter that
corrects it: both draw from one per-row seed (the "mode" stored per draw),
so the IS weights and da's second-stage ratio exp(ll_f - ll_c) are the
coupled multilevel estimators.  No kernel either: each filter runs as a
CUDA graph on the card.

The multivariate models reach no kernel (the JAX package has none there
either): ``kalman_mv`` and ``approx_mv`` are batched tensor code, and a
chain iteration's repeated blocks of it (the mlg log-likelihood, each
Laplace pass of an mng evaluation, pm / da's filter estimate) run on the
card as CUDA graphs (``replay.Replay``).  A psi or bsf filter of an mng
resamples at every step.

The IS correction processes its rows in chunks of ``corr_batch`` rows,
and the state draws or smoothing of linear-Gaussian output the stored
thetas; the chunks only bound memory.  Duplicate slots share their head's
result.  The
filters of pm and da resample at every step; ``psi_resample_every`` sets the
period of the is2 correction's filter above 32 particles.

Statistical defaults: burnin = iter/2, target acceptance 0.234,
gamma = 2/3, RAM adaptation at every iteration unless
``end_adaptive_phase`` freezes it after the burn-in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time as _time
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import rows
from ..core.config import resolve_device
from ..core.priors import LOG
from ..core.spec import is_mv
from ..diagnostics import profiling
from ..models.base import Model
from ..models.nlg import NLGSpec
from ..ops import cuda_kalman
from ..ops import kalman as kalman_mod
from ..ops import kalman_mv
from ..ops.resample import ancestor_trace
from ..ops.simsmooth import simulate_states_single
from . import approx as approx_mod
from . import approx_mv as mv_mod
from . import nlg as nlg_mod
from . import particle as pf_mod
from . import sde as sde_mod
from .ram import adapt_S
from .replay import Replay


# --------------------------------------------------------------------------
# generic RAM-MH loop, all chains batched
# --------------------------------------------------------------------------

class ChainState(NamedTuple):
    theta: torch.Tensor        # (C, d)
    lp_prior: torch.Tensor     # (C,)
    ll: torch.Tensor           # (C,) log-likelihood of the current state
    aux: Optional[torch.Tensor]  # (C, ...) extras carried with theta
    S: torch.Tensor            # (C, d, d)
    # (C,) log-likelihood the RAM adaptation sees: ``ll`` itself, or in
    # pseudo-marginal psi the approximation's, free of filter noise
    ll_ram: torch.Tensor


def _ram_step(logdens: Callable, log_prior: Callable, state: ChainState,
              u: torch.Tensor, unif: torch.Tensor, i: int, target: float,
              gamma: float, adapt: bool):
    """One RAM-MH iteration of every chain from injected randomness:
    ``u (C, d)`` standard normals of the proposal, ``unif (C,)`` uniforms of
    the accept test, ``i`` the 1-based iteration number.  Returns the new
    state and the accept flags ``(C,)``.

    ``logdens(theta (C, d)) -> (ll (C,), ll_ram (C,), aux)``: the accept
    test uses ``ll``, the acceptance probability fed to the RAM adaptation
    comes from ``ll_ram``.  Rows whose proposal has a non-finite prior are
    evaluated at their current theta (so the kernels see sane inputs) and
    then masked: log-likelihood -inf, never accepted.  The stored ``ll`` of
    the current state is never evaluated again, which is what makes a noisy
    ``logdens`` a valid pseudo-marginal sampler."""
    with profiling.span("bssm.chain.propose"):
        prop = state.theta + (state.S @ u.unsqueeze(-1)).squeeze(-1)
        lp_prop = log_prior(prop)
        ok = lp_prop > -torch.inf
        ninf = torch.full_like(lp_prop, -torch.inf)
        at = torch.where(ok.unsqueeze(-1), prop, state.theta)
    ll_prop, ll_ram_prop, aux_prop = logdens(at)
    with profiling.span("bssm.chain.accept"):
        ll_prop = torch.where(ok, ll_prop.to(prop.dtype), ninf)
        ll_ram_prop = torch.where(ok, ll_ram_prop.to(prop.dtype), ninf)
        diff = ll_prop - state.ll + lp_prop - state.lp_prior
        ram_diff = ll_ram_prop - state.ll_ram + lp_prop - state.lp_prior
        acc_prob = torch.where(ok, torch.clamp(torch.exp(ram_diff), max=1.0),
                               torch.zeros_like(diff))
        accept = ok & (torch.log(unif) < diff)
        acc1 = accept.unsqueeze(-1)
        aux = state.aux
        if aux is not None:
            aux = torch.where(accept.reshape((-1,) + (1,) * (aux.dim() - 1)),
                              aux_prop, aux)
        S = adapt_S(state.S, u, acc_prob, target, i, gamma) if adapt \
            else state.S
        new = ChainState(
            theta=torch.where(acc1, prop, state.theta),
            lp_prior=torch.where(accept, lp_prop, state.lp_prior),
            ll=torch.where(accept, ll_prop, state.ll), aux=aux, S=S,
            ll_ram=torch.where(accept, ll_ram_prop, state.ll_ram))
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
    ll0, ll_ram0, aux0 = logdens(theta0)
    state = ChainState(theta0, log_prior(theta0), ll0.to(dt),
                       aux0 if store_aux else None, S0, ll_ram0.to(dt))
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
        with profiling.span("bssm.chain.iter", i=i):
            u = rows.randn((C, d), dtype=dt, device=dev, generator=generator)
            unif = rows.rand((C,), dtype=dt, device=dev, generator=generator)
            adapt = (i <= burnin) if end_ram else True
            state, accept = _ram_step(logdens, log_prior, state, u, unif, i,
                                      target, gamma, adapt)
            pos = i - 1
            if pos < burnin:
                continue
            with profiling.span("bssm.chain.store"):
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
    parameters exponentiated back).  ``save`` / ``load`` write and read the
    JAX package's ``.npz`` format; ``summary`` and ``check_diagnostics``
    (``diagnostics/summary.py``) take it as they are."""
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
    alpha: Optional[np.ndarray] = None       # (chains, S, n+1, m) draws
    alphahat: Optional[np.ndarray] = None    # (n+1, m) posterior mean
    Vt: Optional[np.ndarray] = None          # (n+1, m, m)
    weights: Optional[np.ndarray] = None     # (chains, S) IS weights
    modes: Optional[np.ndarray] = None       # (chains, S, n) Laplace modes
    approx_loglik: Optional[np.ndarray] = None
    prior: Optional[np.ndarray] = None
    time: Optional[dict] = None
    theta_sampled: Optional[np.ndarray] = None  # (chains, S, d) sampled space
    n_corrected: Optional[int] = None        # rows the IS correction ran
    # approximate and IS runs: whether every evaluation used the local
    # (cold-started) Laplace approximation, which post_correct may
    # recompute when the modes were not stored
    local_approx: Optional[bool] = None
    # da: the share of proposals after burn-in that passed the first stage
    # (acceptance_rate over it is the second stage's acceptance)
    stage1_acceptance_rate: Optional[float] = None

    @property
    def counts(self) -> np.ndarray:
        return np.ones_like(self.posterior, dtype=np.int64)

    # -- checkpointing ----------------------------------------------------
    # The stored theta and final S are the resumable state:
    # ``run_mcmc(model, theta_init=out.last_theta(model), S=out.S,
    # burnin=0, n_chains=...)`` continues the run.
    def save(self, path: str) -> None:
        """One compressed ``.npz``: every array field under its name, the
        other fields as ``repr`` of a dict under ``__meta__``; the JAX
        package's format, so that either package loads the other's."""
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        arrays = {k: v for k, v in fields.items()
                  if isinstance(v, np.ndarray)}
        meta = {k: v for k, v in fields.items()
                if not isinstance(v, np.ndarray) and v is not None}
        np.savez_compressed(path, __meta__=np.asarray([repr(meta)]),
                            **arrays)

    @staticmethod
    def load(path: str) -> "McmcOutput":
        """A saved output; fields this class does not know are ignored."""
        import ast
        z = np.load(path, allow_pickle=False)
        meta = ast.literal_eval(str(z["__meta__"][0]))
        fields = {f.name for f in dataclasses.fields(McmcOutput)}
        kw = {k: z[k] for k in z.files if k in fields}
        kw.update({k: v for k, v in meta.items() if k in fields})
        kw["theta_names"] = tuple(kw.get("theta_names", ()))
        return McmcOutput(**kw)

    def last_theta(self, model) -> np.ndarray:
        """Every chain's final draw ``(chains, d)`` mapped back to the
        sampled space through ``model.transforms``: a continuation run's
        ``theta_init``."""
        th = self.theta[:, -1, :]
        tr = np.asarray(model.transforms)
        return np.where(tr == LOG, np.log(np.maximum(th, 1e-300)), th)

    def flat_theta(self) -> np.ndarray:
        return self.theta.reshape(-1, self.theta.shape[-1])

    def flat_weights(self) -> np.ndarray:
        if self.weights is None:
            return np.ones(self.posterior.size)
        return self.weights.reshape(-1)

    # -- exports ----------------------------------------------------------
    def to_dataframe(self, variable: str = "theta"):
        """Long-format draws as the R package's ``as.data.frame``: one row
        a (chain, iteration, parameter) for "theta", one row a (chain,
        iteration, state) with a column a time point for "states".  Needs
        pandas."""
        import pandas as pd
        C, S = self.posterior.shape
        w = self.weights if self.weights is not None else np.ones((C, S))
        if variable == "theta":
            frames = []
            for j, name in enumerate(self.theta_names):
                frames.append(pd.DataFrame({
                    "iter": np.tile(np.arange(S), C),
                    "chain": np.repeat(np.arange(C), S),
                    "variable": name,
                    "value": self.theta[..., j].reshape(-1),
                    "weight": w.reshape(-1)}))
            return pd.concat(frames, ignore_index=True)
        if variable == "states":
            if self.alpha is None:
                raise ValueError("state draws need output_type='full'")
            C, S, n1, m = self.alpha.shape
            recs = []
            for j in range(m):
                df = pd.DataFrame(self.alpha[..., j].reshape(C * S, n1))
                df.insert(0, "chain", np.repeat(np.arange(C), S))
                df.insert(1, "iter", np.tile(np.arange(S), C))
                df.insert(2, "variable", f"state_{j + 1}")
                df.insert(3, "weight", w.reshape(-1))
                recs.append(df)
            return pd.concat(recs, ignore_index=True)
        raise ValueError(variable)

    def as_draws(self) -> dict:
        """``{name: (chains, draws)}`` as the R package's ``as_draws``, with
        ``.log_posterior`` and, for IS runs, the weights as ``.weight``."""
        out = {name: self.theta[..., j]
               for j, name in enumerate(self.theta_names)}
        out[".log_posterior"] = self.posterior
        if self.weights is not None:
            out[".weight"] = self.weights
        return out

    def plot(self, variables=None, bins: int = 40):
        """Trace and density of each parameter, one row of two axes each;
        an IS run plots its approximate (unweighted) chains, as the R
        package does.  Needs matplotlib; returns the Figure."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        if self.mcmc_type in ("is1", "is2", "is3"):
            warnings.warn("Input is based on a IS-weighted MCMC, the plots "
                          "correspond to the approximate MCMC.")
        names = list(variables or self.theta_names)
        fig, axes = plt.subplots(len(names), 2,
                                 figsize=(9, 2.2 * len(names)),
                                 squeeze=False)
        for r, name in enumerate(names):
            j = self.theta_names.index(name)
            for c in range(self.theta.shape[0]):
                axes[r][0].plot(self.theta[c, :, j], lw=0.5)
                axes[r][1].hist(self.theta[c, :, j], bins=bins,
                                histtype="step", density=True)
            axes[r][0].set_ylabel(name)
        axes[-1][0].set_xlabel("iteration")
        fig.tight_layout()
        return fig

    def __str__(self) -> str:
        """Run summary as the R package's ``print.mcmc_output``."""
        from ..diagnostics.summary import summary as _summary
        lines = [f"Iterations = {self.burnin + 1}:{self.iter}",
                 f"Thinning interval = {self.thin}",
                 f"MCMC type = {self.mcmc_type} "
                 f"({self.posterior.shape[0]} chains x "
                 f"{self.posterior.shape[1]} stored draws)",
                 "",
                 "Acceptance rate after the burn-in period: "
                 f"{self.acceptance_rate:.3f}", "", "Summary for theta:"]
        for row in _summary(self, variable="theta", return_se=True):
            lines.append(
                "  {variable}: mean {Mean:.4g} sd {SD:.4g} se {SE:.3g} "
                "ess {ESS:.0f}".format(**row))
        if self.alphahat is not None:
            n = self.alphahat.shape[0] - 1
            mean = np.atleast_1d(self.alphahat[n])
            sd = np.sqrt(np.atleast_1d(np.diag(np.atleast_2d(self.Vt[n]))))
            lines.append(f"\nSummary for alpha_{n + 1}:")
            for j, (mu, s) in enumerate(zip(mean, sd)):
                lines.append(f"  state_{j + 1}: mean {mu:.4g} sd {s:.4g}")
        elif self.alpha is not None:
            n = self.alpha.shape[2] - 1
            w = self.flat_weights()
            a = self.alpha.reshape((-1,) + self.alpha.shape[2:])[:, n, :]
            sw = w.sum()
            mean = (w[:, None] * a).sum(0) / sw
            sd = np.sqrt((w[:, None] * (a - mean) ** 2).sum(0) / sw)
            lines.append(f"\nSummary for alpha_{n + 1}:")
            for j in range(a.shape[1]):
                lines.append(
                    f"  state_{j + 1}: mean {mean[j]:.4g} sd {sd[j]:.4g}")
        else:
            lines.append("\nNo posterior samples for states available.")
        if self.time:
            lines.append("\nRun time (s): " + ", ".join(
                f"{k} {v:.2f}" for k, v in self.time.items()))
        return "\n".join(lines)

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
# linear-Gaussian marginal MCMC
# --------------------------------------------------------------------------

def _loglik_mv(spec):
    return (kalman_mv.log_likelihood_mv(spec),)


def _gaussian_chain(model: Model, n_iter, burnin, thin, target, gamma,
                    end_ram):
    """RAM Metropolis on the exact Kalman log-likelihood, all chains
    batched: one launch of the log-likelihood kernel per iteration, or for
    several series (``kind == "mlg"``) the plain multivariate filter, on
    the card one CUDA graph replayed per iteration (``replay.Replay``), as
    is the plain filter of a model the kernel does not take.  A
    nonlinear model (``mcmc_type="ekf"``) targets the EKF's log-likelihood
    the same way, one CUDA graph an iteration."""
    replay = Replay()

    def logdens(theta):
        spec = model.build(theta)
        if model.kind == "mlg":
            ll = replay(_loglik_mv, spec)[0]
        elif model.kind == "nlg":
            ll = replay(nlg_mod._ekf_ll, spec)[0]
        else:
            ll = cuda_kalman.routed_log_likelihood(spec, replay)
        return ll, ll, None

    def chain(generator, theta0, S0):
        final, thetas, lps, lls, accepted, _, acc_rate = _ram_scan(
            logdens, model.log_prior, theta0, S0, generator, n_iter, burnin,
            thin, target, gamma, end_ram, store_aux=False)
        return dict(theta=thetas, prior=lps, ll=lls, accepted=accepted,
                    S=final.S, acc_rate=acc_rate)

    return chain


def _chunk_rows(n: int, batch: int, own: Optional[slice] = None):
    """The chunks of a list of ``n`` rows, ``batch`` rows each, as ``(rows,
    keep, window)``: without ``own`` each chunk's rows, kept, under no
    window.  With ``own`` (a rank's rows on a mesh) the chunk's rows inside
    ``own``, to be drawn under ``window``, the row window of the whole chunk
    (``core.rows``); a chunk that holds none of them gives its first row
    with ``keep`` False, computed only so that the generator draws as in the
    unsharded run, and dropped."""
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        if own is None:
            yield slice(lo, hi), True, contextlib.nullcontext()
            continue
        a, b = max(lo, own.start), min(hi, own.stop)
        keep = a < b
        if not keep:
            a, b = lo, lo + 1
        yield slice(a, b), keep, rows.window(a - lo, hi - lo)


def _draw_chunks(C: int, Sn: int, batch_size: int, own: Optional[slice],
                 draw: Callable) -> np.ndarray:
    """``draw(rows)`` (a tensor of the flat rows ``rows`` of ``C S``) over
    the chunks of ``batch_size`` rows, each copied to the host before the
    next: all rows as ``(C, S, ...)``, or with ``own`` those rows, flat
    (``_chunk_rows``)."""
    lo0, n_out = (0, C * Sn) if own is None \
        else (own.start, own.stop - own.start)
    out = None
    for sl, keep, win in _chunk_rows(C * Sn, batch_size, own):
        with win:
            a = draw(sl).cpu().numpy()
        if out is None:
            out = np.empty((n_out,) + a.shape[1:], dtype=a.dtype)
        if keep:
            out[sl.start - lo0:sl.stop - lo0] = a
    return out if own is not None else out.reshape((C, Sn) + out.shape[1:])


def _state_draws(model: Model, thetas: torch.Tensor, generator,
                 batch_size: int, own: Optional[slice] = None) -> np.ndarray:
    """``output_type="full"``: one simulation-smoother draw of the states at
    every stored theta ``(C, S, d)``, returned on the host as
    ``(C, S, n+1, m)``.  Drawn on the device in chunks of ``batch_size``
    rows, each copied to the host before the next.  With ``own`` only the
    flat rows ``own`` of ``C S``, returned flat (``_draw_chunks``)."""
    C, Sn, d = thetas.shape
    flat = thetas.reshape(C * Sn, d)

    def draw(sl):
        spec = model.build(flat[sl])
        if model.kind == "mlg":
            return kalman_mv.simulate_states_mv(spec, 1, generator,
                                                False)[:, 0]
        if model.kind == "nlg":         # on the model linearised by the EKF
            return kalman_mv.simulate_states_mv(
                nlg_mod._ekf_linearised(spec), 1, generator, False)[:, 0]
        return simulate_states_single(spec, generator)
    return _draw_chunks(C, Sn, batch_size, own, draw)


def _state_summary(model: Model, thetas: torch.Tensor, batch_size: int,
                   mesh_run=None):
    """``output_type="summary"``: the posterior mean of the states and
    their covariance by the law of total variance over the stored thetas,
    mean of the smoothed covariances plus covariance of the smoothed means.
    The JAX package pools per chain and then across chains; every chain
    stores as many draws, so that equals pooling all rows at once, which is
    done here in chunks of ``batch_size`` rows, summed in float64 around
    the first row's smoothed means.  A nonlinear model's smoothed moments
    are the extended Kalman smoother's.  On a mesh (``mesh_run``) each rank
    sums its flat rows around the first row's means, smoothed alone, and
    the sums are added over the ranks."""
    flat = thetas.reshape(-1, thetas.shape[-1])
    N = flat.shape[0]
    ref = s1 = s2 = sv = None
    smoother = {"mlg": kalman_mv.smoother_mv,
                "nlg": nlg_mod.ekf_smoother}.get(model.kind,
                                                 kalman_mod.smoother)
    own = None if mesh_run is None else mesh_run.flat.slice(N)
    if own is not None:         # one reference for every rank
        sm = smoother(model.build(flat[:1]))
        ref = sm.alphahat.double()[0]
        s1, s2 = torch.zeros_like(ref), torch.zeros_like(sm.Vt[0]).double()
        sv = torch.zeros_like(s2)
    for sl, keep, _ in _chunk_rows(N, batch_size, own):
        if not keep:            # no draws here: a foreign chunk is skipped
            continue
        sm = smoother(model.build(flat[sl]))
        ah = sm.alphahat.double()
        if ref is None:
            ref = ah[0]
            s1, s2 = torch.zeros_like(ref), torch.zeros_like(sm.Vt[0]).double()
            sv = torch.zeros_like(s2)
        dev = ah - ref
        s1 = s1 + dev.sum(0)
        s2 = s2 + torch.einsum('bti,btj->tij', dev, dev)
        sv = sv + sm.Vt.double().sum(0)
    if mesh_run is not None:
        s1, s2, sv = (mesh_run.all_reduce(x) for x in (s1, s2, sv))
    mean_dev = s1 / N
    Vt = sv / N + s2 / N - mean_dev.unsqueeze(-1) * mean_dev.unsqueeze(-2)
    return (ref + mean_dev).to(model.dtype), Vt.to(model.dtype)


# --------------------------------------------------------------------------
# phase 1: approximate MCMC
# --------------------------------------------------------------------------

class Approximation(NamedTuple):
    """The Gaussian approximation of a run: ``evaluate(spec) ->
    (approximate loglik (B,), mode (B, n))`` of every row, the counterpart
    of the JAX package's ``_family_ops(...).approx_eval`` (None for the
    correction of a stored run, which evaluates nothing), and whether it is
    the global one."""
    evaluate: Optional[Callable] = None
    is_global: bool = False

    def base(self, spec, ar, approx_ll):
        """What a psi filter's or SPDK's log-weight against ``ar`` (the
        approximation rebuilt at the mode) adds to, to estimate the
        log-likelihood: the evaluated ``approx_ll`` when it is ``ar``'s own
        (local), else ``ar``'s likelihood (global; the JAX package adds the
        global approximation's instead, which leaves its global estimates
        relative to another likelihood: ROADMAP, deliberate deviations)."""
        if not self.is_global:
            return approx_ll
        if is_mv(spec):
            return mv_mod.rebuilt_loglik_mv(spec, ar)
        return approx_mod.rebuilt_loglik(spec, ar)

    def estimates_loglik(self, sampling_method: str) -> bool:
        """Whether an IS correction's log-weight estimates the
        log-likelihood itself, so that ``_is_finish`` subtracts the stored
        approximate one: bsf always; psi and spdk on the global
        approximation, where their log-weight adds to ``base``."""
        return sampling_method == "bsf" or self.is_global


def _approx_evaluator(model: Model, conv_tol: float, max_iter: int,
                      local_approx: bool = True, generator=None,
                      coarse_nsim: int = 2) -> Approximation:
    """The approximation that phase 1, pm and da's stage 1 evaluate.
    Local: the Laplace iteration, cold-started from the data-derived mode
    at every evaluation, so the approximate posterior does not depend on a
    chain's history.  Global: the pseudo-observations are solved once here,
    at ``model.theta_init`` (also when a resumed run starts elsewhere), and
    every evaluation is one smoother pass (``approx.global_approx_loglik``).
    Either way the filters propose from the approximation rebuilt at the
    evaluated mode (``approximate_for_is``).  A nonlinear model has the
    local mode approximation only (``nlg.approx_loglik_nlg``, each
    Gauss-Newton pass one CUDA graph on the card).  An SDE model's is the
    coarse-level filter with ``coarse_nsim`` particles and fresh seeds from
    ``generator``, which it returns as the mode (one CUDA graph on the
    card)."""
    if model.kind == "sde":
        replay = Replay()

        def evaluate(spec):
            seeds = sde_mod.new_seeds(spec.batch, spec.y.device, generator)
            return replay(_sde_coarse, spec, seeds, int(coarse_nsim))[0], \
                seeds
        return Approximation(evaluate, False)
    if model.kind == "nlg":
        replay = Replay()
        return Approximation(
            lambda spec: nlg_mod.approx_loglik_nlg(spec, replay), False)
    mv = model.kind == "mng"
    if local_approx:
        replay = Replay()

        def evaluate(spec):
            if mv:      # each Laplace pass one CUDA graph on the card
                al = mv_mod.approx_loglik_mv(spec, conv_tol=conv_tol,
                                             max_iter=max_iter,
                                             replay=replay)
            else:       # the plain route's passes are CUDA graphs too
                al = approx_mod.approx_loglik(spec, conv_tol=conv_tol,
                                              max_iter=max_iter,
                                              replay=replay)
            return al.loglik, al.approx.mode
        return Approximation(evaluate, False)
    if mv:
        ga = mv_mod.global_approximation_mv(model, conv_tol, max_iter)
        return Approximation(
            lambda spec: mv_mod.global_approx_loglik_mv(spec, ga), True)
    ga = approx_mod.global_approximation(model, conv_tol, max_iter)
    return Approximation(
        lambda spec: approx_mod.global_approx_loglik(spec, ga), True)


def _approx_chain(model: Model, n_iter, burnin, thin, target, gamma, end_ram,
                  approx: Approximation, scan_modes=True):
    """The phase-1 sampler targeting the Gaussian-approximation posterior
    (``approx.evaluate``).  With ``scan_modes`` the mode of the current
    state is carried and stored per slot for the correction; without, the
    correction recomputes it (local only)."""

    def logdens(theta):
        with profiling.span("bssm.model.build"):
            spec = model.build(theta)
        ll, mode = approx.evaluate(spec)
        return ll, ll, mode

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

def _check_method(model: Model, sampling_method: str) -> None:
    if sampling_method not in ("psi", "bsf", "spdk"):
        raise NotImplementedError(
            f"sampling_method={sampling_method!r}: 'psi', 'bsf' and 'spdk' "
            "are ported")
    if model.kind not in ("ng", "mng", "nlg", "sde"):
        raise NotImplementedError(f"model kind {model.kind!r} is not ported")
    if model.kind == "nlg" and sampling_method == "spdk":
        raise ValueError("spdk not available for this model family")
    if model.kind == "sde" and sampling_method != "bsf":
        # the JAX package dies here (its SDE family has no psi / spdk)
        raise ValueError(f"sampling_method={sampling_method!r}: an SDE model "
                         "is corrected by the bootstrap filter ('bsf') only")


def _sde_coarse(spec, seeds, N):
    """The coarse-level filter's estimate (the SDE approximation), coupled
    to the fine level."""
    return (sde_mod.bsf_filter_sde(spec, N, spec.L_c, True, seeds=seeds,
                                   keep_paths=False),)


def _sde_fine(spec, seeds, N, keep):
    """The fine-level filter's estimate, with ``keep`` also its traced
    trajectories ``(B, N, n+1, 1)`` and final weights."""
    pf = sde_mod.bsf_filter_sde(spec, N, spec.L_f, True, seeds=seeds,
                                keep_paths=keep)
    if not keep:
        return (pf,)
    return (pf.loglik, ancestor_trace(pf.alpha, pf.indices),
            pf.weights[..., -1])


def _sde_states(spec, seeds, N, Nc, u):
    """pm / da's evaluation of an SDE model: the fine estimate, with ``Nc``
    the coarse one from the same seeds (so the same Brownian path and
    uniforms on the slots they share), with uniforms ``u`` one trajectory
    picked by the final weights."""
    pf = sde_mod.bsf_filter_sde(spec, N, spec.L_f, True, seeds=seeds,
                                keep_paths=u is not None)
    out = (pf if u is None else pf.loglik,)
    if Nc:
        out += (sde_mod.bsf_filter_sde(spec, Nc, spec.L_c, True, seeds=seeds,
                                       keep_paths=False),)
    if u is not None:
        out += (_pick_trajectory(ancestor_trace(pf.alpha, pf.indices),
                                 pf.weights[..., -1], u=u),)
    return out


def _psi_al(spec, ar):
    """What the log-weight-only psi filter consumes: the approximation with
    its mode-based scales and zero log-likelihood terms."""
    zero = torch.zeros(ar.mode.shape[0], dtype=spec.y.dtype,
                       device=spec.y.device)
    if isinstance(spec, NLGSpec):       # ar: an NLGApprox, scales inside
        return ar._replace(loglik=zero)
    scales = mv_mod.mode_scales_mv if is_mv(spec) else approx_mod.mode_scales
    return approx_mod.ApproxLoglik(ar, scales(spec, ar), zero, zero)


def _rebuild(spec, modes, conv_tol=approx_mod.CONV_TOL,
             max_iter=approx_mod.MAX_ITER):
    """The approximation a filter weighs against, as ``_psi_al`` gives it:
    rebuilt at ``modes``, or without them solved anew (cold, as phase 1
    solved it).  A nonlinear model's is an ``nlg.NLGApprox``."""
    if isinstance(spec, NLGSpec):
        if modes is None:
            return _psi_al(spec, nlg_mod.approximate_nlg(spec))
        return nlg_mod.approximate_for_is_nlg(spec, modes)
    if is_mv(spec):
        if modes is None:
            return _psi_al(spec, mv_mod.approximate_mv(spec, conv_tol,
                                                       max_iter))
        return mv_mod.approximate_for_is_mv(spec, modes)
    if modes is None:
        return _psi_al(spec, approx_mod.approximate(spec, conv_tol,
                                                    max_iter))
    return _psi_al(spec, approx_mod.approximate_for_is(spec, modes))


def _pick_trajectory(traced: torch.Tensor, w: torch.Tensor, generator=None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One trajectory of every row drawn by its weights: ``traced (B, N,
    n+1, m)``, ``w (B, N)`` (not necessarily normalised); the inverse CDF
    at a uniform ``u (B,)``, drawn from ``generator`` unless given.
    Returns ``(B, n+1, m)``."""
    cw = torch.cumsum(w, dim=-1)
    if u is None:
        u = rows.rand((w.shape[0],), dtype=w.dtype, device=w.device,
                      generator=generator)
    pick = torch.searchsorted(cw, (u * cw[:, -1])[:, None], right=True)
    pick = torch.clamp(pick, max=w.shape[-1] - 1)
    return torch.gather(traced, 1, pick[:, :, None, None].expand(
        -1, 1, *traced.shape[2:]))[:, 0]


def _make_correct_rows(model: Model, nsim: int, sampling_method: str,
                       conv_tol: float = 1e-8, max_iter: int = 100,
                       psi_resample_every: int = 1,
                       want_states: bool = False,
                       want_moments: bool = False,
                       approx: Approximation = Approximation()):
    """The correction of a batch of stored draws (the counterpart of the
    JAX package's per-draw ``_make_correct_one``) of a run on ``approx``.
    psi and spdk add their log-weight to ``approx.base`` with a zero
    approximate log-likelihood: on the local approximation that leaves the
    correction itself, on the global one an estimate of the log-likelihood
    (``approx.rebuilt_loglik`` plus the log-weight), from which
    ``_is_finish`` subtracts the stored approximate log-likelihood
    (``Approximation.estimates_loglik``), as it does for bsf.

    ``correct_rows(theta (B, d), modes (B, n) or None, generator, eps=None,
    us=None, states=None, u_pick=None) -> dict``.  Without states or
    moments it returns ``{"log_w": (B,)}`` from the log-weight-only
    estimators: psi, the psi-APF log-weight (without stored modes the
    Laplace approximation is recomputed cold, which reproduces phase 1's:
    it cold starts too); bsf, the bootstrap filter's log-likelihood
    estimate, from which ``_is_finish`` subtracts the stored approximate
    log-likelihood (the modes are not used).  ``eps``/``us`` inject the
    filter's randomness.  spdk: the log of the mean SPDK weight of ``nsim``
    simulation-smoother draws (``states (B, N, n+1, m)`` injects the
    draws), like psi already the correction.

    With ``want_states`` / ``want_moments`` the filter keeps its
    trajectories (``psi_filter`` / ``bsf_filter``, resampling at every
    step; spdk's draws) and the dict adds ``alpha (B, n+1, m)``, one
    trajectory per row drawn from the final weights (``_pick_trajectory``,
    by a uniform from ``generator`` after the filter's draws, or
    ``u_pick``), and ``mean (B, n+1, m)`` / ``Vt (B, n+1, m, m)``, the
    weighted moments of the row's trajectories."""
    _check_method(model, sampling_method)
    kk = int(psi_resample_every)
    replay = Replay()

    def approximation(spec, modes):
        al = _rebuild(spec, modes, conv_tol, max_iter)
        return al._replace(loglik=approx.base(spec, al.approx, al.loglik))

    def correct_rows(theta, modes=None, generator=None, eps=None, us=None,
                     states=None, u_pick=None):
        with profiling.span("bssm.model.build"):
            spec = model.build(theta)
        if model.kind == "mng":
            return correct_rows_mv(spec, modes, generator, eps, us, states,
                                   u_pick)
        if model.kind == "nlg":
            return correct_rows_nlg(spec, modes, generator, eps, us, u_pick)
        if model.kind == "sde":
            return correct_rows_sde(spec, modes, generator, u_pick)
        if sampling_method == "spdk":
            al = approximation(spec, modes)
            if states is None:
                r = pf_mod.spdk_sample(spec, al, nsim, generator)
                log_w, traced, w = r.loglik, r.alpha, r.weights
            else:
                traced = states
                log_w, w = pf_mod.spdk_weights(spec, al, states)
        elif not (want_states or want_moments):
            if sampling_method == "bsf":
                return {"log_w": pf_mod.bsf_logw(
                    spec, nsim, generator, resample_every=kk, eps=eps,
                    us=us)}
            return {"log_w": pf_mod.psi_logw(
                spec, approximation(spec, modes), nsim, generator, eps=eps,
                us=us, resample_every=kk)}
        elif sampling_method == "bsf":
            pf = pf_mod.bsf_filter(spec, nsim, generator, eps=eps, us=us)
            log_w, traced, w = (pf.loglik, ancestor_trace(pf.alpha,
                                                          pf.indices),
                                pf.weights[..., -1])
        else:       # psi_filter returns its trajectories traced
            pf = pf_mod.psi_filter(spec, approximation(spec, modes), nsim,
                                   generator, eps=eps, us=us)
            log_w, traced, w = pf.loglik, pf.alpha, pf.weights[..., -1]
        return finish(log_w, traced, w, generator, u_pick)

    def correct_rows_mv(spec, modes, generator, eps, us, states, u_pick):
        """The same for several series (``approx_mv``): no kernel, the
        filters with or without their trajectories, psi and bsf resampling
        at every step as the JAX package's multivariate filters do."""
        keep = want_states or want_moments
        if sampling_method == "bsf":
            pf = mv_mod.bsf_filter_mv(spec, nsim, generator, eps=eps, us=us)
            if not keep:
                return {"log_w": pf.loglik}
            log_w, traced, w = (pf.loglik,
                                ancestor_trace(pf.alpha, pf.indices),
                                pf.weights[..., -1])
        else:
            al = approximation(spec, modes)
            if sampling_method == "spdk":
                if states is None:
                    r = mv_mod.spdk_sample_mv(spec, al, nsim, generator)
                    log_w, traced, w = r.loglik, r.alpha, r.weights
                else:
                    traced = states
                    log_w, w = mv_mod.spdk_weights_mv(spec, al, states)
            elif not keep:
                return {"log_w": mv_mod.psi_filter_mv(
                    spec, al, nsim, generator, eps=eps, us=us,
                    keep_paths=False)}
            else:
                pf = mv_mod.psi_filter_mv(spec, al, nsim, generator,
                                          eps=eps, us=us)
                log_w, traced, w = pf.loglik, pf.alpha, pf.weights[..., -1]
        return finish(log_w, traced, w, generator, u_pick)

    def correct_rows_nlg(spec, modes, generator, eps, us, u_pick):
        """The same for a nonlinear model (``inference/nlg.py``): psi or
        bsf, resampling at every step, without trajectories when neither
        states nor moments are asked for."""
        keep = want_states or want_moments
        if sampling_method == "bsf":
            pf = nlg_mod.bsf_filter_nlg(spec, nsim, generator, eps=eps,
                                        us=us, keep_paths=keep)
            if not keep:
                return {"log_w": pf}
            traced = ancestor_trace(pf.alpha, pf.indices)
        else:
            pf = nlg_mod.psi_filter_nlg(spec, approximation(spec, modes),
                                        nsim, generator, eps=eps, us=us,
                                        keep_paths=keep)
            if not keep:
                return {"log_w": pf}
            traced = pf.alpha
        return finish(pf.loglik, traced, pf.weights[..., -1], generator,
                      u_pick)

    def correct_rows_sde(spec, seeds, generator, u_pick):
        """The same for an SDE model: the fine-level filter from the stored
        evaluation seeds ``seeds (B,)``, which couples it to the coarse
        estimate phase 1 stored (one CUDA graph a chunk shape on the
        card)."""
        if seeds is None:
            raise ValueError("an SDE run's correction needs its stored seeds")
        keep = want_states or want_moments
        res = replay(_sde_fine, spec, seeds.to(torch.int64), nsim, keep)
        if not keep:
            return {"log_w": res[0]}
        return finish(*res, generator, u_pick)

    def finish(log_w, traced, w, generator, u_pick):
        out = {"log_w": log_w}
        if want_states:
            out["alpha"] = _pick_trajectory(traced, w, generator, u_pick)
        if want_moments:
            sw = w.sum(-1)[:, None, None]
            mean = torch.einsum('bi,bitm->btm', w, traced) / sw
            dev = traced - mean[:, None]
            out["mean"] = mean
            out["Vt"] = torch.einsum('bi,bitm,bitk->btmk', w, dev,
                                     dev) / sw[..., None]
        return out

    return correct_rows


def _is_correction_flat(model: Model, thetas, modes, generator, nsim,
                        sampling_method, batch_size, conv_tol=1e-8,
                        max_iter=100, psi_resample_every=1,
                        want_states=False, want_moments=False,
                        approx: Approximation = Approximation(),
                        own: Optional[slice] = None):
    """IS correction over a flat axis of stored draws, in chunks of
    ``batch_size`` rows.  thetas ``(Ns, d)``; modes ``(Ns, n)`` or None.
    Returns the dict of ``_make_correct_rows`` with leading axis Ns, or
    with ``own`` (a rank's rows on a mesh, ``_chunk_rows``) that of the rows
    ``own``."""
    correct_rows = _make_correct_rows(model, nsim, sampling_method, conv_tol,
                                      max_iter, psi_resample_every,
                                      want_states, want_moments, approx)
    parts, dropped = [], None
    for sl, keep, win in _chunk_rows(thetas.shape[0], batch_size, own):
        mo = None if modes is None else modes[sl]
        profiling.HOST["correct.chunks"] += 1
        with win, profiling.span("bssm.correct.chunk",
                                 rows=sl.stop - sl.start):
            r = correct_rows(thetas[sl], mo, generator)
        if keep:
            parts.append(r)
        elif dropped is None:
            dropped = r
    if not parts:               # a rank with no rows: the shapes, empty
        return {k: v[:0] for k, v in dropped.items()}
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _is_postprocess(model: Model, thetas, modes, accepted, approx_ll,
                    generator, *, nsim, sampling_method, batch_size,
                    is_type=2, want_states=False, want_moments=False,
                    conv_tol=1e-8, max_iter=100, psi_resample_every=1,
                    approx: Approximation = Approximation(), mesh_run=None):
    """The IS correction of a stored approximate run.  thetas ``(C, S, d)``,
    approx_ll ``(C, S)``.

    is2: correct each jump-chain head once with ``nsim`` particles;
    duplicate slots share the head's result.  is1: correct every stored
    slot and average each jump-chain segment's estimates in probability
    space (``_is_finish``).  is3: correct every slot on its own.  Returns
    (the dict of ``_is_finish``, the number of rows corrected).

    On a mesh (``mesh_run``, every rank holding the whole stored run) the
    flat slots are cut over the ranks at jump-chain heads (is1, is2: a
    rank gets whole segments, split by head count; is3 by slot count).  A
    rank corrects its rows under the row windows of the unsharded run's
    chunks and finishes its slots; the slots are gathered in rank order
    and the weighted moments summed over the ranks (``_weighted_moments``),
    so that every rank returns the whole result."""
    C, Sn = thetas.shape[:2]
    hmask = accepted.clone()
    hmask[:, 0] = True                      # slot 0 of a chain is a head
    hmask = hmask.reshape(-1)
    th_rows = thetas.reshape(C * Sn, -1)
    mo_rows = None if modes is None \
        else modes.reshape((C * Sn,) + tuple(modes.shape[2:]))
    if is_type == 2:
        hidx = torch.nonzero(hmask).squeeze(-1)
        th_rows = th_rows[hidx]
        mo_rows = None if mo_rows is None else mo_rows[hidx]
    n_rows = int(th_rows.shape[0])
    slots = own = None
    if mesh_run is not None:
        slots, own = _own_slots(mesh_run, hmask, is_type)
    profiling.HOST["correct.heads"] += n_rows
    corr = _is_correction_flat(model, th_rows, mo_rows, generator, nsim,
                               sampling_method, batch_size, conv_tol,
                               max_iter, psi_resample_every, want_states,
                               want_moments, approx, own=own)
    with profiling.span("bssm.correct.finish"):
        if mesh_run is None:
            return (_is_finish(corr, hmask, (C, Sn), approx_ll,
                               sampling_method, is_type, generator,
                               approx=approx), n_rows)
        with rows.window(slots.start, C * Sn):    # is1's Gumbel noise
            fin = _is_finish(corr, hmask[slots],
                             (1, slots.stop - slots.start),
                             approx_ll.reshape(-1)[slots], sampling_method,
                             is_type, generator, approx=approx,
                             mesh_run=mesh_run)
        fin["log_w"] = mesh_run.gather(fin["log_w"][0]).reshape(C, Sn)
        if "alpha" in fin:
            a = mesh_run.gather(fin["alpha"][0])
            fin["alpha"] = a.reshape((C, Sn) + a.shape[1:])
    return fin, n_rows


def _own_slots(mesh_run, hmask: torch.Tensor, is_type: int):
    """A rank's flat slots and its rows of the correction's row list (the
    heads for is2, the slots for is1 and is3), both as slices: is1 and is2
    split the heads over the mesh's flat axis and take the slots from each
    head to the next, is3 splits the slots."""
    CS = hmask.shape[0]
    if is_type == 3:
        sl = mesh_run.flat.slice(CS)
        return sl, sl
    hidx = torch.nonzero(hmask).squeeze(-1).tolist() + [CS]
    h = mesh_run.flat.slice(len(hidx) - 1)
    slots = slice(hidx[h.start], hidx[h.stop])
    return slots, (h if is_type == 2 else slots)


def _segment_max(x: torch.Tensor, seg: torch.Tensor, fill) -> torch.Tensor:
    out = torch.full(x.shape, fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg, x, reduce="amax", include_self=True)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x).index_add(0, seg, x)


def _is_finish(corr, hmask, shape, approx_ll=None, sampling_method="psi",
               is_type=2, generator=None, gumbel=None,
               approx: Approximation = Approximation(), mesh_run=None):
    """Assembly pass: jump-chain fill of is2's head results, is1's segment
    mixture, and the global weighted moments of summary output.

    Where the correction estimates the full likelihood
    (``approx.estimates_loglik``: bsf, and psi and spdk after a run on the
    global approximation), its weight is the ratio to the stored
    approximate likelihood ``approx_ll``.  is1: a
    segment's log-weight is the log of the mean of its slots' weights; its
    trajectory is one slot's, drawn with probability proportional to the
    weight by the Gumbel-max rule (noise ``gumbel (C S,)``, drawn from
    ``generator`` unless given); its moments are the weight-mixture of its
    slots' moments.  Returns ``{"log_w": (C, S)}`` plus ``alpha (C, S, n+1,
    m)`` for full output or ``alphahat (n+1, m)`` / ``Vt (n+1, m, m)`` for
    summary output.  On a mesh (``mesh_run``) ``corr`` and ``hmask`` are a
    rank's slots, whole segments, and the moments are summed over the
    ranks."""
    C, Sn = shape
    CS = C * Sn
    if is_type == 2:
        src = torch.cumsum(hmask.to(torch.int64), 0) - 1  # head ordinal
        corr = {k: v[src] for k, v in corr.items()}
    log_w = corr["log_w"]
    if approx.estimates_loglik(sampling_method):
        log_w = log_w - approx_ll.reshape(-1)
    ninf = torch.full_like(log_w, -torch.inf)
    log_w = torch.where(torch.isfinite(log_w), log_w, ninf)
    alpha, mean_s, vt_s = corr.get("alpha"), corr.get("mean"), corr.get("Vt")

    if is_type == 1:
        seg = torch.cumsum(hmask.to(torch.int64), 0) - 1  # segment ids
        M = _segment_max(log_w, seg, -torch.inf)
        Ms = torch.where(torch.isfinite(M), M, torch.zeros_like(M))[seg]
        p = torch.where(torch.isfinite(log_w), torch.exp(log_w - Ms),
                        torch.zeros_like(log_w))
        psum = _segment_sum(p, seg)
        cnt = torch.clamp(_segment_sum(torch.ones_like(p), seg), min=1.0)
        log_w = (M + torch.log(psum) - torch.log(cnt))[seg]
        pn = p / torch.where(psum[seg] > 0, psum[seg], torch.ones_like(p))
        if alpha is not None:
            if gumbel is None:
                gumbel = -torch.log(rows.draw(
                    lambda s: torch.empty(s, dtype=p.dtype, device=p.device
                                          ).exponential_(generator=generator),
                    p.shape))
            val = torch.where(p > 0, torch.log(p) + gumbel, ninf)
            vmax = _segment_max(val, seg, -torch.inf)[seg]
            slot = torch.arange(CS, device=p.device)
            cand = torch.where(val >= vmax, slot, torch.full_like(slot, -1))
            sel = _segment_max(cand, seg, -1)
            alpha = alpha[torch.clamp(sel, min=0)[seg]]
        if mean_s is not None:
            mbar = _segment_sum(pn[:, None, None] * mean_s, seg)
            e2 = vt_s + mean_s.unsqueeze(-1) * mean_s.unsqueeze(-2)
            e2bar = _segment_sum(pn[:, None, None, None] * e2, seg)
            vbar = e2bar - mbar.unsqueeze(-1) * mbar.unsqueeze(-2)
            mean_s, vt_s = mbar[seg], vbar[seg]

    out = {"log_w": log_w.reshape(C, Sn)}
    if alpha is not None:
        out["alpha"] = alpha.reshape((C, Sn) + alpha.shape[1:])
    if mean_s is not None:
        out.update(_weighted_moments(log_w, mean_s, vt_s, mesh_run))
    return out


def _weighted_moments(log_w, mean_s, vt_s, mesh_run=None) -> dict:
    """``alphahat``, ``Vt``: the global weighted moments over all slots
    (law of total variance, the between-draw deviation term included) of
    per-slot log-weights ``(S,)``, means ``(S, n+1, m)`` and covariances.
    On a mesh (``mesh_run``) each rank holds its slots: the maximum
    log-weight, the shift, is taken over the ranks first, then each sum
    (the JAX package's psum design)."""
    def red(x, op="sum"):
        return x if mesh_run is None else mesh_run.all_reduce(x, op)

    mx = red(log_w.max() if log_w.numel() else
             torch.full((), -torch.inf, dtype=log_w.dtype,
                        device=log_w.device), "max")
    w = torch.exp(log_w - torch.where(torch.isfinite(mx), mx,
                                      torch.zeros_like(mx)))
    sw = torch.clamp(red(w.sum()), min=torch.finfo(w.dtype).tiny)
    mean = red(torch.einsum('s,stm->tm', w, mean_s)) / sw
    dev = mean_s - mean
    return {"alphahat": mean,
            "Vt": red(torch.einsum('s,stmk->tmk', w, vt_s)
                      + torch.einsum('s,stm,stk->tmk', w, dev, dev)) / sw}


def _approx_state_draws(model: Model, thetas, modes, generator,
                        batch_size: int,
                        own: Optional[slice] = None) -> np.ndarray:
    """``mcmc_type="approx"`` with ``output_type="full"``: one draw of the
    states from the approximating Gaussian model (rebuilt from the stored
    mode) at every stored theta, by the simulation smoother; ``(C, S, n+1,
    m)`` on the host.  Drawn in chunks of ``batch_size`` rows.  A
    multivariate model rebuilds its approximation with ``approx_mv`` (the
    JAX package's ``_approx_state_draws`` takes the univariate rebuild for
    every model and fails there).  ``own`` as in ``_state_draws``."""
    C, Sn, d = thetas.shape
    flat = thetas.reshape(C * Sn, d)
    fmodes = modes.reshape((C * Sn,) + tuple(modes.shape[2:]))

    def draw(sl):
        spec, mo = model.build(flat[sl]), fmodes[sl]
        if model.kind == "mng":
            return mv_mod.approx_state_draws_mv(spec, mo, generator)
        if model.kind == "nlg":
            return kalman_mv.simulate_states_mv(
                nlg_mod.build_approx(spec, mo), 1, generator, False)[:, 0]
        ar = approx_mod.approximate_for_is(spec, mo)
        return simulate_states_single(ar.gaussian(spec), generator)
    return _draw_chunks(C, Sn, batch_size, own, draw)


# --------------------------------------------------------------------------
# pseudo-marginal and delayed-acceptance MCMC
# --------------------------------------------------------------------------

def _psi_states(spec, al, eps, us, u):
    """psi filter with trajectories on injected draws, and one trajectory
    picked by the final weights at the uniforms ``u``."""
    pf = pf_mod.psi_filter(spec, al, eps.shape[2], eps=eps, us=us)
    return pf.loglik, _pick_trajectory(pf.alpha, pf.weights[..., -1], u=u)


def _bsf_states(spec, eps, us, u):
    """``_psi_states`` of the bootstrap filter (its paths traced)."""
    pf = pf_mod.bsf_filter(spec, eps.shape[2], eps=eps, us=us)
    return pf.loglik, _pick_trajectory(ancestor_trace(pf.alpha, pf.indices),
                                       pf.weights[..., -1], u=u)


def _spdk_estimate(spec, al, um, eps, eta, nsim, u):
    """SPDK's estimate on the simulation smoother's injected normals, and
    with uniforms ``u`` one of its draws picked by the weights."""
    r = pf_mod.spdk_sample(spec, al, nsim, um=um, eps=eps, eta=eta)
    if u is None:
        return (r.loglik,)
    return r.loglik, _pick_trajectory(r.alpha, r.weights, u=u)


def _psi_states_mv(spec, al, eps, us, u):
    """``_psi_states`` of several series; without ``u`` the estimate only."""
    if u is None:
        return (mv_mod.psi_filter_mv(spec, al, eps.shape[2], eps=eps, us=us,
                                     keep_paths=False),)
    pf = mv_mod.psi_filter_mv(spec, al, eps.shape[2], eps=eps, us=us)
    return pf.loglik, _pick_trajectory(pf.alpha, pf.weights[..., -1], u=u)


def _bsf_states_mv(spec, eps, us, u):
    """``_bsf_states`` of several series; without ``u`` the estimate only."""
    pf = mv_mod.bsf_filter_mv(spec, eps.shape[2], eps=eps, us=us)
    if u is None:
        return (pf.loglik,)
    return pf.loglik, _pick_trajectory(ancestor_trace(pf.alpha, pf.indices),
                                       pf.weights[..., -1], u=u)


def _spdk_estimate_mv(spec, al, um, eps, eta, nsim, u):
    """``_spdk_estimate`` of several series."""
    r = mv_mod.spdk_sample_mv(spec, al, nsim, um=um, eps=eps, eta=eta)
    if u is None:
        return (r.loglik,)
    return r.loglik, _pick_trajectory(r.alpha, r.weights, u=u)


def _psi_states_nlg(spec, mode, eps, us, u):
    """``_psi_states`` of a nonlinear model, the linearisation rebuilt at
    the evaluated ``mode`` inside; without ``u`` the estimate only."""
    ap = nlg_mod.approximate_for_is_nlg(spec, mode)
    if u is None:
        return (nlg_mod.psi_filter_nlg(spec, ap, eps.shape[2], eps=eps,
                                       us=us, keep_paths=False),)
    pf = nlg_mod.psi_filter_nlg(spec, ap, eps.shape[2], eps=eps, us=us)
    return pf.loglik, _pick_trajectory(pf.alpha, pf.weights[..., -1], u=u)


def _bsf_states_nlg(spec, eps, us, u):
    """``_bsf_states`` of a nonlinear model; without ``u`` the estimate
    only."""
    if u is None:
        return (nlg_mod.bsf_filter_nlg(spec, eps.shape[2], eps=eps, us=us,
                                       keep_paths=False),)
    pf = nlg_mod.bsf_filter_nlg(spec, eps.shape[2], eps=eps, us=us)
    return pf.loglik, _pick_trajectory(ancestor_trace(pf.alpha, pf.indices),
                                       pf.weights[..., -1], u=u)


def _eager(fn, spec, *args):
    return fn(spec, *args)


def _pf_loglik(model: Model, theta: torch.Tensor, generator, nsim: int,
               sampling_method: str, approx: Approximation,
               need_states: bool = False, replay=None,
               coarse_nsim: Optional[int] = None):
    """``(ll (C,), approx_ll (C,), alpha (C, n+1, m) or None)`` of every row
    of ``theta``: the importance-sampling estimate of the log-likelihood,
    the approximation's (``approx.evaluate``), and with ``need_states`` one
    trajectory drawn by the final weights (``_pick_trajectory``, a uniform
    from ``generator`` after the filter's draws).  bsf: the bootstrap
    filter's estimate, twice.  psi: the psi-APF log-weight against the
    approximation rebuilt at the evaluated mode, plus ``approx.base`` (the
    approximate log-likelihood, or on the global approximation the rebuilt
    one's).  spdk: the same with the SPDK weights of ``nsim``
    simulation-smoother draws.  The filters resample at every step; without
    states psi and bsf run the log-weight-only kernels, with states
    ``psi_filter`` / ``bsf_filter``.  The randomness is drawn here, in the
    order the filters would draw it, and the tensor code with trajectories
    (and SPDK) goes through ``replay`` (``replay.Replay``: one CUDA graph
    per shape on the card) when given.  An SDE model: the fine-level
    bootstrap filter from fresh seeds, and its estimate twice, or with
    ``coarse_nsim`` as the second value the coupled coarse estimate from
    the same seeds (da's first stage)."""
    call = replay or _eager
    spec = model.build(theta)
    n, m = spec.n, spec.m
    mv = model.kind == "mng"
    kw = dict(dtype=spec.y.dtype, device=spec.y.device, generator=generator)

    def uniforms(B):
        return rows.rand((B,), **kw) if need_states else None

    if model.kind == "sde":             # bsf, always through call
        seeds = sde_mod.new_seeds(spec.batch, spec.y.device, generator)
        res = call(_sde_states, spec, seeds, nsim, coarse_nsim,
                   uniforms(spec.batch))
        second = res[1] if coarse_nsim else res[0]
        return res[0], second, res[-1] if need_states else None
    if model.kind == "nlg":             # psi or bsf, always through call
        B = spec.batch
        if sampling_method == "bsf":
            eps = rows.randn((B, n + 1, nsim, max(m, spec.k)), **kw)
            us = rows.rand((B, n, nsim), **kw)
            res = call(_bsf_states_nlg, spec, eps, us, uniforms(B))
            return res[0], res[0], res[1] if need_states else None
        approx_ll, mode = approx.evaluate(spec)
        eps = rows.randn((B, n + 1, nsim, m), **kw)
        us = rows.rand((B, n, nsim), **kw)
        res = call(_psi_states_nlg, spec, mode, eps, us, uniforms(B))
        return approx_ll + res[0], approx_ll, res[1] if need_states else None

    if sampling_method == "bsf":
        if not (need_states or mv):
            ll = pf_mod.bsf_logw(spec, nsim, generator)
            return ll, ll, None
        B = spec.batch or 1
        eps = rows.randn((B, n + 1, nsim, m), **kw)
        us = rows.rand((B, n, nsim), **kw)
        res = call(_bsf_states_mv if mv else _bsf_states, spec, eps, us,
                   uniforms(B))
        return res[0], res[0], res[1] if need_states else None
    approx_ll, mode = approx.evaluate(spec)
    al = _rebuild(spec, mode)
    base = approx.base(spec, al.approx, approx_ll)
    B = mode.shape[0]
    if sampling_method == "spdk":
        nb = (nsim + 1) // 2
        um = rows.randn((B, nb, m), **kw)
        eps = rows.randn((B, nb, n) + ((spec.p,) if mv else ()), **kw)
        eta = rows.randn((B, nb, n, spec.k), **kw)
        res = call(_spdk_estimate_mv if mv else _spdk_estimate, spec, al,
                   um, eps, eta, nsim, uniforms(B))
    elif not (need_states or mv):
        return (base + pf_mod.psi_logw(spec, al, nsim, generator),
                approx_ll, None)
    else:
        eps = rows.randn((B, n + 1, nsim, m), **kw)
        us = rows.rand((B, n, nsim), **kw)
        res = call(_psi_states_mv if mv else _psi_states, spec, al, eps, us,
                   uniforms(B))
    return base + res[0], approx_ll, res[1] if need_states else None


def _pm_chain(model: Model, n_iter, burnin, thin, target, gamma, end_ram,
              nsim, sampling_method, approx, pf_generator,
              store_states=False):
    """Pseudo-marginal RAM Metropolis: the chain accepts on the noisy
    estimate of the log-likelihood, whose value at the current state is kept
    as stored, and adapts on the approximation's (psi, spdk) or the same
    (bsf).  With ``store_states`` the trajectory drawn with the estimate is
    the chain's aux: kept on rejection, stored per slot."""
    _check_method(model, sampling_method)

    replay = Replay()

    def logdens(theta):
        return _pf_loglik(model, theta, pf_generator, nsim, sampling_method,
                          approx, store_states, replay)

    def chain(generator, theta0, S0):
        final, thetas, lps, lls, accepted, alphas, acc_rate = _ram_scan(
            logdens, model.log_prior, theta0, S0, generator, n_iter, burnin,
            thin, target, gamma, end_ram, store_aux=store_states)
        return dict(theta=thetas, prior=lps, ll=lls, accepted=accepted,
                    S=final.S, acc_rate=acc_rate, alpha=alphas)

    return chain


class DaState(NamedTuple):
    theta: torch.Tensor        # (C, d)
    lp_prior: torch.Tensor     # (C,)
    ll: torch.Tensor           # (C,) particle-filter log-likelihood, stored
    ll_approx: torch.Tensor    # (C,) approximate log-likelihood
    S: torch.Tensor            # (C, d, d)
    alpha: Optional[torch.Tensor] = None   # (C, n+1, m) with state output
    passed: Optional[torch.Tensor] = None  # (C,) passed the first stage


def _da_step(full_eval: Callable, log_prior: Callable, state: DaState,
             u: torch.Tensor, unif1: torch.Tensor, unif2: torch.Tensor,
             i: int, target: float, gamma: float, adapt: bool):
    """One delayed-acceptance iteration of every chain from injected
    randomness: ``u (C, d)`` proposal normals, ``unif1``, ``unif2 (C,)`` the
    uniforms of the two stages.  ``full_eval(theta) -> (ll, ll_approx,
    alpha or None)``; a state's trajectory changes with its theta.

    Stage 1 screens the proposal on the approximation; stage 2 accepts the
    survivors with the ratio of the particle-filter estimate to the
    approximation.  ``full_eval`` runs on every row and the rows that failed
    stage 1 are masked out of stage 2: the same law as evaluating the
    survivors only, without a host round trip per iteration.  RAM adapts on
    the stage-1 acceptance probability."""
    prop = state.theta + (state.S @ u.unsqueeze(-1)).squeeze(-1)
    lp_prop = log_prior(prop)
    ok = lp_prop > -torch.inf
    ninf = torch.full_like(lp_prop, -torch.inf)
    ll_prop, ll_approx_prop, alpha_prop = full_eval(
        torch.where(ok.unsqueeze(-1), prop, state.theta))
    ll_prop = torch.where(ok, ll_prop.to(prop.dtype), ninf)
    ll_approx_prop = torch.where(ok, ll_approx_prop.to(prop.dtype), ninf)
    acc_prob = torch.where(
        ok, torch.clamp(torch.exp(ll_approx_prop - state.ll_approx
                                  + lp_prop - state.lp_prior), max=1.0),
        torch.zeros_like(lp_prop))
    pass1 = unif1 < acc_prob
    log_alpha = ll_prop + state.ll_approx - state.ll - ll_approx_prop
    accept = pass1 & (torch.log(unif2) < log_alpha)
    S = adapt_S(state.S, u, acc_prob, target, i, gamma) if adapt else state.S
    alpha = state.alpha
    if alpha is not None:
        alpha = torch.where(accept[:, None, None], alpha_prop, alpha)
    new = DaState(
        theta=torch.where(accept.unsqueeze(-1), prop, state.theta),
        lp_prior=torch.where(accept, lp_prop, state.lp_prior),
        ll=torch.where(accept, ll_prop, state.ll),
        ll_approx=torch.where(accept, ll_approx_prop, state.ll_approx), S=S,
        alpha=alpha, passed=pass1)
    return new, accept


def _da_init(model: Model, theta0, S0, pf_generator, nsim: int,
             sampling_method: str, approx: Approximation,
             store_states: bool = False, replay=None,
             coarse_nsim: Optional[int] = None) -> DaState:
    """The initial state of delayed acceptance.  As in the JAX package,
    ``ll_approx`` starts at the second value of ``_pf_loglik``: the
    approximation's log-likelihood for psi and spdk, the bootstrap estimate
    itself for bsf (which changes only the first stage-1 ratio), the
    coupled coarse estimate for an SDE model (``coarse_nsim``)."""
    dt = theta0.dtype
    ll0, all0, alpha0 = _pf_loglik(model, theta0, pf_generator, nsim,
                                   sampling_method, approx, store_states,
                                   replay, coarse_nsim)
    return DaState(theta0, model.log_prior(theta0), ll0.to(dt), all0.to(dt),
                   S0, alpha0)


def _da_chain(model: Model, n_iter, burnin, thin, target, gamma, end_ram,
              nsim, sampling_method, approx, pf_generator,
              store_states=False):
    """Delayed-acceptance RAM Metropolis, all chains batched; stores the
    post-burn-in slots like ``_ram_scan``, with ``store_states`` also the
    current trajectory ``(C, S, n+1, m)``.  An SDE model's two stages are
    the coarse and the fine filter from one draw of seeds, so stage 2's
    ratio is the coupled multilevel one; both take ``nsim`` particles
    (the JAX package's coarse count max(particles, 2): da takes 2 or
    more)."""
    _check_method(model, sampling_method)
    replay = Replay()
    coarse_nsim = nsim if model.kind == "sde" else None

    def full_eval(theta):
        ll, approx_ll, alpha = _pf_loglik(model, theta, pf_generator, nsim,
                                          sampling_method, approx,
                                          store_states, replay, coarse_nsim)
        if sampling_method == "bsf" and not coarse_nsim:
            # stage 1 needs the approximation
            approx_ll = approx.evaluate(model.build(theta))[0]
        return ll, approx_ll, alpha

    def chain(generator, theta0, S0):
        C, d = theta0.shape
        dt, dev = theta0.dtype, theta0.device
        state = _da_init(model, theta0, S0, pf_generator, nsim,
                         sampling_method, approx, store_states, replay,
                         coarse_nsim)
        Sn = len(range(burnin, n_iter, thin))
        thetas = torch.empty((C, Sn, d), dtype=dt, device=dev)
        lps = torch.empty((C, Sn), dtype=dt, device=dev)
        lls = torch.empty((C, Sn), dtype=dt, device=dev)
        accs = torch.empty((C, Sn), dtype=torch.bool, device=dev)
        alphas = None
        if store_states:
            alphas = torch.empty((C, Sn) + tuple(state.alpha.shape[1:]),
                                 dtype=dt, device=dev)
        n_acc = torch.zeros(C, dtype=dt, device=dev)
        n_pass = torch.zeros(C, dtype=dt, device=dev)
        k = 0
        for i in range(1, n_iter + 1):
            u = rows.randn((C, d), dtype=dt, device=dev,
                           generator=generator)
            unif = rows.rand((2, C), axis=1, dtype=dt, device=dev,
                             generator=generator)
            adapt = (i <= burnin) if end_ram else True
            state, accept = _da_step(full_eval, model.log_prior, state, u,
                                     unif[0], unif[1], i, target, gamma,
                                     adapt)
            pos = i - 1
            if pos >= burnin:
                n_acc += accept.to(dt)
                n_pass += state.passed.to(dt)
                if (pos - burnin) % thin == 0:
                    thetas[:, k] = state.theta
                    lps[:, k] = state.lp_prior
                    lls[:, k] = state.ll
                    accs[:, k] = accept
                    if store_states:
                        alphas[:, k] = state.alpha
                    k += 1
        kept = max(n_iter - burnin, 1)
        return dict(theta=thetas, prior=lps, ll=lls, accepted=accs,
                    S=state.S, acc_rate=n_acc / kept, alpha=alphas,
                    stage1_rate=n_pass / kept)

    return chain


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def _generators(seed: int, device: torch.device):
    """One generator for phase 1 and one for phase 2, both on ``device``."""
    s1, s2 = np.random.SeedSequence(int(seed)).generate_state(2)
    g1 = torch.Generator(device=device).manual_seed(int(s1))
    g2 = torch.Generator(device=device).manual_seed(int(s2))
    return g1, g2


def is_correction_generator(seed: int, device) -> torch.Generator:
    """The phase-2 generator ``run_mcmc`` derives from ``seed``, in its
    initial state: ``post_correct(generator=...)`` with it replays a stored
    run's IS correction."""
    return _generators(seed, torch.device(device))[1]


def _store_correction(out: McmcOutput, post: dict, base_lp: torch.Tensor,
                      host) -> None:
    """Weights, posterior and states of an IS correction into ``out``.
    Weights are stored shifted by the global max so exp never overflows (IS
    averages are scale invariant)."""
    log_w = post["log_w"]
    mx = log_w.max()
    shift = torch.clamp(torch.where(torch.isfinite(mx), mx,
                                    torch.zeros_like(mx)), min=0.0)
    out.weights = host(torch.exp(log_w - shift))
    out.posterior = host(base_lp + log_w)
    if "alpha" in post:
        out.alpha = host(post["alpha"])
    if "alphahat" in post:
        out.alphahat, out.Vt = host(post["alphahat"]), host(post["Vt"])


def _flat_draws(mesh_run, thetas: torch.Tensor, draws) -> np.ndarray:
    """``draws(own)`` (``_state_draws`` or ``_approx_state_draws`` with
    their other arguments bound): all rows without a mesh; on one, this
    rank's flat rows of the mesh's flat split, gathered from every rank in
    order and shaped ``(C, S, ...)``."""
    if mesh_run is None:
        return draws(None)
    C, Sn = thetas.shape[:2]
    a = mesh_run.gather(torch.from_numpy(draws(mesh_run.flat.slice(C * Sn))))
    return a.numpy().reshape((C, Sn) + tuple(a.shape[1:]))


def _run_types(model: Model, mcmc_type, sampling_method, output_type,
               particles, local_approx):
    """``run_mcmc``'s checks of the run's types and options against the
    model; returns the ``(mcmc_type, sampling_method)`` it runs."""
    if model.kind in ("lg", "mlg"):
        mcmc_type = mcmc_type or "gaussian"
        if mcmc_type != "gaussian":
            raise NotImplementedError(
                f"mcmc_type={mcmc_type!r}: linear-Gaussian models run "
                "'gaussian'")
        if output_type not in ("theta", "summary", "full"):
            raise NotImplementedError(
                f"output_type={output_type!r}: 'theta', 'summary' and "
                "'full' are ported")
    else:
        nlg, sde = model.kind == "nlg", model.kind == "sde"
        mcmc_type = mcmc_type or "is2"
        # psi for the exponential families, bsf for the nonlinear models;
        # an SDE model takes bsf whatever is asked, as in the JAX package
        sampling_method = "bsf" if sde else (
            sampling_method or ("bsf" if nlg else "psi"))
        if mcmc_type not in ("approx", "is1", "is2", "is3", "pm", "da") \
                + (("ekf",) if nlg else ()):
            raise NotImplementedError(
                f"mcmc_type={mcmc_type!r}: only 'approx', 'is1', 'is2', "
                "'is3', 'pm', 'da' and, for nonlinear models, 'ekf' are "
                "ported")
        outputs = ("theta", "full") if mcmc_type in ("approx", "pm", "da") \
            else ("theta", "summary", "full")
        if output_type not in outputs:
            raise NotImplementedError(
                f"output_type={output_type!r}: mcmc_type={mcmc_type!r} "
                f"takes {outputs}")
        if nlg and not local_approx:
            raise ValueError(
                "local_approx=False: a nonlinear model has only the local "
                "mode approximation")
        if sde and not local_approx:
            raise ValueError("local_approx=False: an SDE model has no "
                             "Gaussian approximation")
        if sde and mcmc_type == "approx" and output_type == "full":
            # the JAX package dies here (its state draws rebuild a
            # Gaussian approximation)
            raise ValueError("an approximate SDE run has no state draws; "
                             "take output_type='full' of is1/is2/is3")
        if mcmc_type != "ekf":
            _check_method(model, sampling_method)
        if mcmc_type not in ("approx", "ekf"):
            if particles < 2:
                raise ValueError(
                    "particles >= 2 required for non-approx MCMC")
    return mcmc_type, sampling_method


def run_mcmc(model: Model, iter: int = 2000, *, burnin: Optional[int] = None,
             thin: int = 1, particles: int = 0,
             mcmc_type: Optional[str] = None,
             sampling_method: Optional[str] = None,
             target_acceptance: float = 0.234, gamma: float = 2.0 / 3.0,
             S=None, end_adaptive_phase: bool = False,
             output_type: str = "theta", n_chains: int = 1, seed: int = 1,
             conv_tol: float = 1e-8, max_iter: int = 100, theta_init=None,
             corr_batch: Optional[int] = None, store_modes: bool = True,
             psi_resample_every: int = 1, local_approx: bool = True,
             device=None, dtype: Optional[torch.dtype] = None,
             mesh=None) -> McmcOutput:
    """Bayesian inference via adaptive MCMC.

    Linear-Gaussian models (``kind`` "lg", "mlg"): mcmc_type "gaussian" (the
    default), output_type "theta" (the default; the JAX package defaults to
    "full"), "summary" (``alphahat``, ``Vt``) or "full" (``alpha``).
    Non-Gaussian models: mcmc_type "is2" (default), "is1", "is3",
    "approx", "pm" or "da"; sampling_method "psi" (default), "bsf" or
    "spdk"; output_type "theta" (the default; the JAX package defaults to
    "full"), for is1/is2/is3 also "summary" (``alphahat``, ``Vt``) or
    "full" (``alpha``), for approx, pm and da also "full".  ``particles``:
    2 or more (kernels up to 512, the plain scans above).
    ``local_approx=False`` freezes the Gaussian approximation's
    pseudo-observations at the model's initial theta: one smoother pass a
    proposal instead of the Laplace iteration; the modes are then always
    stored.  ``psi_resample_every``: the stratified-resampling period of the
    theta-output correction's particle filter above 32 particles; 1
    (default) resamples at every step, k > 1 at every k-th step only, which
    keeps the likelihood estimate unbiased for a fixed schedule (check
    ESS_IS when raising it).  The filters of pm and da and those of the
    state outputs always resample at every step.
    SDE models (``kind`` "sde"): mcmc_type "is2" (default), "is1", "is3",
    "approx" (theta output), "pm" or "da", always with the bootstrap
    filter; phase 1 and da's first stage run the coarse level with
    max(particles, 2) particles, coupled to the fine-level correction.
    Nonlinear models (``kind`` "nlg"): mcmc_type "is2" (default), "is1",
    "is3", "approx", "pm", "da" or "ekf" (the EKF's log-likelihood;
    output_type "theta", "summary" or "full"); sampling_method "bsf"
    (default) or "psi"; ``local_approx=False`` and "spdk" raise
    ``ValueError``; the mode approximation takes the model's own
    ``max_iter`` and ``conv_tol`` (``ssm_nlg``), not this call's.
    ``corr_batch``: rows per chunk of the work after the chain, the IS
    correction (default 256) or the state draws and smoothing (default
    65536); it only bounds memory.
    ``device=None`` means the CUDA device and raises when there is none; it
    must agree with the device the model was built on.  ``dtype`` defaults
    to the model's.
    ``mesh``: a ``torch.distributed`` device mesh (``parallel.make_mesh``),
    one process a device; every rank calls ``run_mcmc`` with the same
    arguments.  The chains are split over the mesh's first ("chains")
    axis, in ceil-divided blocks (every block must hold a chain; ranks of
    one "chains" coordinate run the same block), the rows of the IS
    correction and of the state outputs over the whole mesh; under a seed
    every row gets the draws it gets without a mesh (``core/rows.py``), and
    every rank returns the whole output.  Per-row fields equal the
    unsharded run's; sums (acceptance rate aside, the weighted moments)
    differ from it only in the order of their additions."""
    t0 = _time.time()
    with profiling.fit("run_mcmc", seed, "bssm.fit"):
        with profiling.span("bssm.fit.setup"):
            device = resolve_device(device)
            dtype = model.dtype if dtype is None else dtype
            if device != model.device or dtype != model.dtype:
                raise ValueError(
                    f"the model lives on {model.device} as {model.dtype}; "
                    f"run_mcmc was asked for {device} and {dtype}.  Build "
                    "the model with the same device and dtype.")
            mcmc_type, sampling_method = _run_types(
                model, mcmc_type, sampling_method, output_type, particles,
                local_approx)
            if int(psi_resample_every) < 1:
                raise ValueError("psi_resample_every must be >= 1")
            if burnin is None:
                burnin = iter // 2

            def dev(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device)

            theta0 = dev(model.theta_init if theta_init is None
                         else theta_init)
            if theta0.dim() == 1:
                theta0 = theta0.expand(n_chains, -1).contiguous()
            elif theta0.shape[0] != n_chains:
                raise ValueError("theta_init must be (d,) or (n_chains, d)")
            S0 = dev(model.initial_S() if S is None else S)
            if S0.dim() == 2:
                S0 = S0.expand(n_chains, -1, -1).contiguous()
            mesh_run = None
            if mesh is not None:
                from ..parallel.mesh import MeshRun
                mesh_run = MeshRun(mesh, device)
                block = mesh_run.chains.slice(n_chains)
                if block.start >= block.stop:
                    raise ValueError(
                        f"n_chains={n_chains} leaves a rank of the mesh's "
                        f"{mesh_run.chains.parts} chain blocks no chain")
            # gen1: proposals and accept tests; gen2: the particle filters
            # or the state draws
            gen1, gen2 = _generators(seed, device)

            # fail fast on a non-finite initial prior
            if not bool(torch.isfinite(model.log_prior(theta0)).all()):
                raise ValueError("Initial prior probability is not finite.")

            base = dict(n_iter=iter, burnin=burnin, thin=thin,
                        target=target_acceptance, gamma=gamma,
                        end_ram=end_adaptive_phase)
            if mcmc_type in ("gaussian", "ekf"):
                chain = _gaussian_chain(model, **base)
            else:
                approx = _approx_evaluator(model, conv_tol, max_iter,
                                           bool(local_approx), gen1,
                                           max(int(particles), 2))
            if mcmc_type in ("pm", "da"):
                make = _pm_chain if mcmc_type == "pm" else _da_chain
                chain = make(model, nsim=particles,
                             sampling_method=sampling_method, approx=approx,
                             pf_generator=gen2,
                             store_states=output_type == "full", **base)
            elif mcmc_type not in ("gaussian", "ekf"):
                # the modes are kept when asked, always for the approx full
                # output, whose state draws replay them, always on the
                # global approximation, which a cold recompute would
                # replace by the local, and always for an SDE model, whose
                # "modes" are the seeds that couple the correction to
                # phase 1
                store_modes = bool(store_modes) or not local_approx or (
                    mcmc_type == "approx" and output_type == "full") \
                    or model.kind == "sde"
                chain = _approx_chain(model, approx=approx,
                                      scan_modes=store_modes, **base)
        with profiling.span("bssm.chain"):
            if mesh_run is None:
                res = chain(gen1, theta0, S0)
            else:   # this rank's block of chains, then every block
                with rows.window(block.start, n_chains):
                    res = chain(gen1, theta0[block], S0[block])
                res = mesh_run.gather_chains(res)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        t_mcmc = _time.time() - t0

        def host(x):
            return x.detach().cpu().numpy()

        with profiling.span("bssm.fit.host_copy"):
            out = McmcOutput(
                theta=host(model.to_natural(res["theta"])),
                posterior=host(res["prior"] + res["ll" if "ll" in res
                                                  else "approx_ll"]),
                accepted=host(res["accepted"]),
                acceptance_rate=float(res["acc_rate"].mean()),
                S=host(res["S"]), theta_names=model.theta_names,
                mcmc_type=mcmc_type, output_type=output_type, iter=iter,
                burnin=burnin, thin=thin, prior=host(res["prior"]),
                time={"mcmc": t_mcmc})
            if mcmc_type in ("pm", "da") and output_type == "full":
                out.alpha = host(res["alpha"])
            if mcmc_type == "da":
                out.stage1_acceptance_rate = float(
                    res["stage1_rate"].mean())
            if mcmc_type == "approx" or mcmc_type.startswith("is"):
                out.approx_loglik = host(res["approx_ll"])
                out.theta_sampled = host(res["theta"])
                out.local_approx = bool(local_approx)
                if store_modes:
                    out.modes = host(res["modes"])
        if mcmc_type in ("gaussian", "ekf") and output_type != "theta":
            t1 = _time.time()
            batch = int(corr_batch or 65536)
            if output_type == "full":
                out.alpha = _flat_draws(
                    mesh_run, res["theta"], functools.partial(
                        _state_draws, model, res["theta"], gen2, batch))
            else:
                alphahat, Vt = _state_summary(model, res["theta"], batch,
                                              mesh_run)
                out.alphahat, out.Vt = host(alphahat), host(Vt)
            out.time["states"] = _time.time() - t1
        if mcmc_type == "approx" and output_type == "full":
            t1 = _time.time()
            out.alpha = _flat_draws(mesh_run, res["theta"], functools.partial(
                _approx_state_draws, model, res["theta"], res["modes"], gen2,
                int(corr_batch or 65536)))
            out.time["states"] = _time.time() - t1

        if mcmc_type.startswith("is"):
            t1 = _time.time()
            with profiling.span("bssm.correct"):
                post, n_rows = _is_postprocess(
                    model, res["theta"], res["modes"], res["accepted"],
                    res["approx_ll"], gen2, nsim=particles,
                    sampling_method=sampling_method,
                    batch_size=int(corr_batch or 256),
                    is_type=int(mcmc_type[-1]),
                    want_states=output_type == "full",
                    want_moments=output_type == "summary",
                    conv_tol=conv_tol, max_iter=max_iter,
                    psi_resample_every=psi_resample_every, approx=approx,
                    mesh_run=mesh_run)
                _store_correction(out, post, res["prior"] + res["approx_ll"],
                                  host)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            out.n_corrected = n_rows
            out.time["correction"] = _time.time() - t1

    if out.acceptance_rate == 0.0:
        warnings.warn("No proposals were accepted after burn-in. "
                      "Check your model.", RuntimeWarning)
    return out
