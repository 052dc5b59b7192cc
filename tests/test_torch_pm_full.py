"""PyTorch port vs the JAX package: the state output of pseudo-marginal and
delayed-acceptance MCMC (``output_type="full"``), on the CPU.

Every proposal runs a filter with trajectories (``psi_filter``,
``bsf_filter`` + ``ancestor_trace``, or SPDK) and draws one trajectory by
the final weights; it is the chain's aux, kept on rejection and stored per
slot.  Held end to end against the JAX package within Monte-Carlo error of
the state means, and the pick against its inverse-CDF definition.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.inference import particle as tpf


def _pair(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    y = y.astype(float)
    y[n // 3] = np.nan
    kw = dict(a1=np.array([1.0]), P1=np.array([[1.0]]),
              distribution="poisson")
    jm = jbsm_ng(y, sd_level=j_halfnormal(0.1, 1.0), dtype=np.float64, **kw)
    tm = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                   dtype=torch.float64, device="cpu", **kw)
    return jm, tm


def _chain_means(x):
    """Pooled mean and its standard error from the spread of the per-chain
    means of ``x (C, S, ...)``."""
    per = x.mean(axis=1)
    return per.mean(0), per.std(0, ddof=1) / np.sqrt(x.shape[0])


@pytest.mark.parametrize("mcmc_type,method,particles,local", [
    ("pm", "psi", 10, True), ("pm", "bsf", 40, True),
    ("pm", "spdk", 10, False), ("da", "psi", 10, False)])
def test_state_output_matches_jax_within_monte_carlo_error(
        mcmc_type, method, particles, local):
    """48 chains x 80 iterations on each side (the CPU pays per iteration,
    not per chain), n = 16, on the port's side the local or the global
    approximation (both target the posterior; the JAX package's side runs
    the local one, its global estimate being relative to another
    likelihood): the means of theta and of every state alpha_t over the
    stored slots within 4.5 combined Monte-Carlo standard errors (per-chain
    means); alpha has the JAX package's shape, is finite, and a rejected
    slot repeats the previous slot's trajectory."""
    jm, tm = _pair(16, 2)
    kw = dict(iter=80, particles=particles, mcmc_type=mcmc_type,
              sampling_method=method, output_type="full", n_chains=48,
              seed=3)
    jout = jmcmc.run_mcmc(jm, **kw)
    tout = bt.run_mcmc(tm, device="cpu", local_approx=local, **kw)
    assert tout.alpha.shape == np.asarray(jout.alpha).shape == (
        48, 40, 17, 1)
    assert np.isfinite(tout.alpha).all()
    rej = ~tout.accepted[:, 1:]
    assert rej.any()
    assert np.array_equal(tout.alpha[:, 1:][rej], tout.alpha[:, :-1][rej])
    for j_x, t_x in ((np.asarray(jout.theta), tout.theta),
                     (np.asarray(jout.alpha)[..., 0], tout.alpha[..., 0])):
        jm_, jse = _chain_means(j_x)
        tm_, tse = _chain_means(t_x)
        z = np.abs(jm_ - tm_) / np.sqrt(jse ** 2 + tse ** 2)
        assert (z < 4.5).all(), (z.max(), jm_, tm_)
    assert abs(jout.acceptance_rate - tout.acceptance_rate) < 0.12


def test_trajectory_pick_is_the_inverse_cdf_of_the_final_weights():
    """``_pf_loglik(need_states=True)`` with psi: its trajectory is the
    filter's trajectory at the inverse CDF of the final weights at one
    uniform drawn after the filter's draws; ``_make_correct_rows`` fed the
    same draws and that uniform picks the same trajectory."""
    _, tm = _pair(16, 4)
    th = torch.as_tensor(np.asarray(tm.theta_init) + np.array(
        [[0.0], [0.3], [-0.4], [0.2], [0.5]]))
    B, N, n = 5, 10, 16
    approx = tmcmc._approx_evaluator(tm, 1e-8, 100)
    ll, all_, alpha = tmcmc._pf_loglik(tm, th, torch.Generator().manual_seed(
        6), N, "psi", approx, need_states=True)
    assert alpha.shape == (B, n + 1, 1)
    g = torch.Generator().manual_seed(6)
    spec = tm.build(th)
    mode = approx.evaluate(spec)[1]
    al = tmcmc._psi_al(spec, tapprox.approximate_for_is(spec, mode))
    eps = torch.randn((B, n + 1, N, 1), dtype=torch.float64, generator=g)
    us = torch.rand((B, n, N), dtype=torch.float64, generator=g)
    u = torch.rand(B, dtype=torch.float64, generator=g)
    pf = tpf.psi_filter(spec, al, N, eps=eps, us=us)
    torch.testing.assert_close(ll, all_ + pf.loglik, rtol=0, atol=0)
    w = pf.weights[..., -1].numpy()
    for b in range(B):
        cw = np.cumsum(w[b])
        i = min(int(np.searchsorted(cw, u[b].item() * cw[-1],
                                    side="right")), N - 1)
        assert torch.equal(alpha[b], pf.alpha[b, i])
    rows = tmcmc._make_correct_rows(tm, N, "psi", want_states=True)(
        th, mode, None, eps=eps, us=us, u_pick=u)
    assert torch.equal(rows["alpha"], alpha)


def test_state_output_options():
    """pm and da take ``output_type`` "theta" or "full" with every
    sampling method; "summary" raises; a theta run stores no states."""
    _, tm = _pair(12, 5)
    out = bt.run_mcmc(tm, iter=20, particles=8, mcmc_type="da",
                      sampling_method="bsf", output_type="full", n_chains=2,
                      device="cpu")
    assert out.alpha.shape == (2, 10, 13, 1)
    out = bt.run_mcmc(tm, iter=20, particles=8, mcmc_type="pm",
                      n_chains=2, device="cpu")
    assert out.alpha is None
    with pytest.raises(NotImplementedError, match="summary"):
        bt.run_mcmc(tm, iter=20, particles=8, mcmc_type="pm",
                    output_type="summary", device="cpu")
