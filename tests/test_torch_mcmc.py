"""PyTorch port vs the JAX package: the slice as a whole on the CPU.  RAM
adaptation and one Metropolis step from injected randomness, the phase-2
correction draw for draw, and IS-MCMC end to end within Monte-Carlo error.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.inference import approx as japprox
from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.inference.ram import adapt_S as j_adapt_S
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng

import bssm_tpu_torch as bt
from bssm_tpu_torch.convert import model_state_from_numpy
from bssm_tpu_torch.diagnostics.summary import (ess_is, weighted_mean,
                                                weighted_var)
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.inference.ram import adapt_S as t_adapt_S


def _series(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    y = y.astype(float)
    y[n // 4] = np.nan
    return y


def _models(n=40, seed=0, jdtype=jnp.float64, tdtype=torch.float64):
    y = _series(n, seed)
    jm = jbsm_ng(y, sd_level=j_halfnormal(0.1, 1.0),
                 sd_slope=j_halfnormal(0.01, 0.1), distribution="poisson",
                 dtype=jdtype)
    tm = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                   sd_slope=bt.halfnormal_prior(0.01, 0.1),
                   distribution="poisson", dtype=tdtype, device="cpu")
    return jm, tm


def test_adapt_S_matches():
    """RAM update and downdate of a batch of chains, incl. a chain whose
    downdate would lose positive definiteness (kept unchanged); rtol 1e-12,
    the same rank-1 recursion in float64."""
    rng = np.random.default_rng(1)
    C, d = 6, 3
    A = rng.normal(size=(C, d, d))
    S = np.linalg.cholesky(np.einsum('cij,ckj->cik', A, A) + np.eye(d))
    u = rng.normal(size=(C, d))
    acc = np.array([0.9, 0.0, 0.234, 0.5, 0.01, 1.0])
    for i in (1, 7, 300):
        ref = jax.vmap(lambda s, x, a: j_adapt_S(s, x, a, 0.234,
                                                 jnp.asarray(i), 2.0 / 3.0))(
            jnp.asarray(S), jnp.asarray(u), jnp.asarray(acc))
        got = t_adapt_S(torch.as_tensor(S), torch.as_tensor(u),
                        torch.as_tensor(acc), 0.234, i, 2.0 / 3.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-14)


def test_ram_step_matches_jax_scan():
    """Two iterations of the chain from JAX's own normals and uniforms: the
    port's ``_ram_step`` is fed the draws ``_ram_scan`` makes from its key.
    theta, log-prior, log-likelihood, accept flag and S agree to rtol 1e-9
    (the Laplace solve sits inside the log-density)."""
    jm, tm = _models(n=25, seed=2)
    key = jax.random.PRNGKey(5)
    theta0 = jnp.asarray(jm.theta_init)
    S0 = jnp.asarray(jm.initial_S())

    def logdens(theta, k, aux):
        al = japprox.approx_loglik(jm.build(theta))
        return al.loglik, al.loglik, al.approx.mode

    n_iter = 2
    final, thetas, lps, lls, accepted, _ = jmcmc._ram_scan(
        logdens, jm.log_prior, theta0, S0, key, n_iter, 0, 0.234, 2.0 / 3.0,
        False, jnp.zeros(25))
    # replay the key schedule of _ram_scan to get its draws
    k, _ = jax.random.split(key)
    us, unifs = [], []
    for _ in range(n_iter):
        k, k_u, k_acc, _ = jax.random.split(k, 4)
        us.append(np.asarray(jax.random.normal(k_u, (2,), jnp.float64)))
        unifs.append(float(jax.random.uniform(k_acc, (), jnp.float64)))

    def t_logdens(theta):
        al = tmcmc.approx_mod.approx_loglik(tm.build(theta))
        return al.loglik, al.loglik, al.approx.mode

    th, S = model_state_from_numpy(np.asarray(theta0), np.asarray(S0),
                                   device="cpu", dtype=torch.float64)
    assert th.shape == (1, 2) and S.shape == (1, 2, 2)
    ll0, _, mode0 = t_logdens(th)
    state = tmcmc.ChainState(th, tm.log_prior(th), ll0, mode0, S, ll0)
    for i in range(n_iter):
        state, acc = tmcmc._ram_step(
            t_logdens, tm.log_prior, state, torch.tensor(us[i])[None],
            torch.tensor([unifs[i]], dtype=torch.float64), i + 1, 0.234,
            2.0 / 3.0, True)
        assert bool(acc[0]) == bool(accepted[i])
        np.testing.assert_allclose(state.theta[0].numpy(),
                                   np.asarray(thetas[i]), rtol=1e-9)
        np.testing.assert_allclose(state.lp_prior[0].numpy(),
                                   np.asarray(lps[i]), rtol=1e-9)
        np.testing.assert_allclose(state.ll[0].numpy(), np.asarray(lls[i]),
                                   rtol=1e-9)
    np.testing.assert_allclose(state.S[0].numpy(), np.asarray(final.S),
                               rtol=1e-9)


def test_nonfinite_prior_rows_are_masked():
    """A proposal outside the prior's support is never accepted and does not
    disturb the other chains."""
    _, tm = _models(n=20, seed=3)
    calls = []

    def logdens(theta):
        calls.append(theta.clone())
        return theta.sum(-1), theta.sum(-1), None

    def log_prior(theta):                 # chain 1's proposal is out
        lp = torch.zeros(theta.shape[0], dtype=theta.dtype)
        return torch.where(theta[:, 0] > 5.0, torch.full_like(lp, -torch.inf),
                           lp)

    th = torch.zeros((3, 2), dtype=torch.float64)
    state = tmcmc.ChainState(th, log_prior(th), th.sum(-1), None,
                             torch.eye(2, dtype=torch.float64).expand(
                                 3, 2, 2).clone(), th.sum(-1))
    u = torch.tensor([[1.0, 1.0], [9.0, 0.0], [0.5, 0.5]],
                     dtype=torch.float64)
    new, acc = tmcmc._ram_step(logdens, log_prior, state, u,
                               torch.full((3,), 1e-3, dtype=torch.float64), 1,
                               0.234, 2.0 / 3.0, True)
    assert acc.tolist() == [True, False, True]
    assert torch.equal(new.theta[1], th[1])
    # the masked row was evaluated at its current theta, not at the proposal
    assert torch.equal(calls[0][1], th[1])
    assert torch.isfinite(new.S).all()


@pytest.mark.parametrize("stored_modes", [True, False])
def test_correction_matches_draw_for_draw(stored_modes):
    """Phase 2 alone: the same (theta, eps, us) rows through the JAX
    package's ``_make_correct_one`` and the port's ``_make_correct_rows``.
    The JAX side draws eps/us from its key inside ``psi_logw``; the test
    replays that key schedule and injects the draws into the port.  log_w
    atol 1e-8 (float64; Laplace solve, factors and filter chained)."""
    n, N, B = 30, 6, 5
    jm, tm = _models(n=n, seed=4)
    rng = np.random.default_rng(6)
    thetas = np.asarray(jm.theta_init) + 0.3 * rng.normal(size=(B, 2))
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    correct_one = jmcmc._make_correct_one(jm, N, "psi", want_states=False,
                                          want_moments=False)
    if stored_modes:
        modes = jax.vmap(lambda t: japprox.approximate(jm.build(t)).mode)(
            jnp.asarray(thetas))
    else:
        modes = jnp.zeros((B, 1))          # store_modes=False: recompute
    ref = jax.vmap(lambda t, m, k: correct_one((t, m, k))["log_w"])(
        jnp.asarray(thetas), modes, keys)

    eps, us = [], []
    for i in range(B):
        k_pf, _ = jax.random.split(keys[i])
        k_e, k_r = jax.random.split(k_pf)
        eps.append(np.asarray(jax.random.normal(k_e, (n + 1, N, 2),
                                                jnp.float64)))
        us.append(np.asarray(jax.random.uniform(k_r, (n, N), jnp.float64)))
    correct_rows = tmcmc._make_correct_rows(tm, N, "psi")
    got = correct_rows(
        torch.as_tensor(thetas),
        torch.as_tensor(np.asarray(modes)) if stored_modes else None, None,
        eps=torch.as_tensor(np.stack(eps)), us=torch.as_tensor(np.stack(us)))
    np.testing.assert_allclose(got["log_w"].numpy(), np.asarray(ref), rtol=0,
                               atol=1e-8)


def _is_stats(out):
    """Weighted posterior means of the parameters, their Monte-Carlo
    standard errors from the spread of the per-chain weighted means,
    acceptance, and ESS_IS as a fraction."""
    w = out.weights
    d = out.theta.shape[-1]
    means = np.array([[weighted_mean(out.theta[c, :, j], w[c])
                       for j in range(d)] for c in range(out.theta.shape[0])])
    fw = out.flat_weights()
    pooled = np.array([weighted_mean(out.flat_theta()[:, j], fw)
                       for j in range(d)])
    se = means.std(axis=0, ddof=1) / np.sqrt(means.shape[0])
    return pooled, se, out.acceptance_rate, ess_is(fw) / fw.size


def test_is2_end_to_end_matches_within_monte_carlo_error():
    """run_mcmc(is2, psi, theta) on both sides with different random
    streams: the weighted posterior means of both sds agree within 4
    Monte-Carlo standard errors (from the spread across chains, both runs'
    errors combined), the acceptance rates within 0.08, and the
    importance-sampling ESS fraction exceeds 0.9 on both."""
    jm, tm = _models(n=40, seed=8)
    kw = dict(iter=400, particles=6, mcmc_type="is2", sampling_method="psi",
              output_type="theta", n_chains=8, seed=3)
    jout = jmcmc.run_mcmc(jm, **kw)
    tout = bt.run_mcmc(tm, device="cpu", **kw)
    assert tout.theta.shape == jout.theta.shape == (8, 200, 2)
    assert tout.weights.shape == (8, 200)
    assert np.isfinite(tout.posterior).all()
    assert set(tout.time) == {"mcmc", "correction"}
    heads = tout.accepted.copy()
    heads[:, 0] = True
    assert tout.n_corrected == int(heads.sum())
    jmean, jse, jacc, jess = _is_stats(jout)
    tmean, tse, tacc, tess = _is_stats(tout)
    z = np.abs(jmean - tmean) / np.sqrt(jse ** 2 + tse ** 2)
    assert (z < 4.0).all(), (jmean, tmean, jse, tse)
    assert abs(jacc - tacc) < 0.08, (jacc, tacc)
    assert jess > 0.9 and tess > 0.9, (jess, tess)
    assert weighted_var(tout.flat_theta()[:, 0], tout.flat_weights()) > 0


def test_store_modes_true_and_false_give_the_same_weights():
    """One generator state, modes stored or recomputed: phase 1 is the same
    chain either way, and the correction differs only in where it linearises
    (the stored converged mode vs the last pass's starting mode, which agree
    to below the convergence tolerance).  log-posteriors within atol 1e-5."""
    _, tm = _models(n=30, seed=10)
    kw = dict(iter=60, particles=6, mcmc_type="is2", n_chains=3, seed=11,
              device="cpu")
    a = bt.run_mcmc(tm, store_modes=True, **kw)
    b = bt.run_mcmc(tm, store_modes=False, **kw)
    assert a.modes.shape == (3, 30, 30) and b.modes is None
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.accepted, b.accepted)
    np.testing.assert_allclose(a.posterior, b.posterior, rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.weights, b.weights, rtol=1e-5)


def test_approx_mcmc_runs_without_correction():
    _, tm = _models(n=20, seed=12)
    out = bt.run_mcmc(tm, iter=40, mcmc_type="approx", n_chains=2, seed=1,
                      device="cpu")
    assert out.weights is None and out.flat_weights().shape == (40,)
    np.testing.assert_allclose(out.posterior, out.prior + out.approx_loglik)
    assert out.counts.sum() == 40 and out.theta_sampled.shape == (2, 20, 2)
    np.testing.assert_allclose(out.theta, np.exp(out.theta_sampled))


@pytest.mark.parametrize("method", ["bsf", "psi"])
def test_da_initial_state_takes_the_second_value_of_pf_loglik(method):
    """The JAX package starts delayed acceptance at ``_pf_loglik``'s second
    value: the bootstrap estimate itself for bsf (its ``_pf_loglik`` returns
    that estimate twice), the approximation's log-likelihood for psi.  With
    the generator state fixed, the port's initial ``ll_approx`` is that
    value; for bsf it differs from the approximation's log-likelihood, which
    is where the chain used to start."""
    y = _series(24, 9)
    kw = dict(distribution="poisson", a1=np.array([1.0]), P1=np.array([[1.0]]))
    jm = jbsm_ng(y, sd_level=j_halfnormal(0.1, 1.0), dtype=jnp.float64, **kw)
    tm = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                   dtype=torch.float64, device="cpu", **kw)
    theta0 = jnp.asarray(jm.theta_init)
    j_ll, j_all, _ = jmcmc._pf_loglik(jm, theta0, jax.random.PRNGKey(2), 16,
                                      method, 1e-8, 100, need_states=False)
    assert (float(j_ll) == float(j_all)) == (method == "bsf")
    th = torch.as_tensor(np.array(jm.theta_init)).expand(5, -1)
    S0 = torch.as_tensor(np.asarray(tm.initial_S())).expand(5, -1, -1)
    approx = tmcmc._approx_evaluator(tm, 1e-8, 100)
    state = tmcmc._da_init(tm, th, S0, torch.Generator().manual_seed(7), 16,
                           method, approx)
    want_ll, want_all, _ = tmcmc._pf_loglik(
        tm, th, torch.Generator().manual_seed(7), 16, method, approx)
    approx_ll = bt.approx_loglik(tm.build(th)).loglik
    assert torch.equal(state.ll, want_ll)
    assert torch.equal(state.ll_approx, want_all)
    assert torch.equal(state.lp_prior, tm.log_prior(th))
    if method == "bsf":
        assert torch.equal(state.ll_approx, state.ll)
        assert (state.ll_approx - approx_ll).abs().min() > 1e-6
    else:
        np.testing.assert_allclose(state.ll_approx.numpy(),
                                   approx_ll.numpy(), rtol=1e-12)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked_for():
    """No silent move to the CPU: without a CUDA device, ``device=None``
    raises in the constructor and in run_mcmc."""
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    y = _series(20, 13)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0))
    _, tm = _models(n=20, seed=13)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.run_mcmc(tm, iter=10, particles=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bt.run_mcmc(tm, iter=10, particles=4, device="cuda")


def test_unported_options_raise():
    _, tm = _models(n=20, seed=14)
    for kw in (dict(mcmc_type="approx", output_type="summary"),
               dict(mcmc_type="da", output_type="summary"),
               dict(output_type="bogus"),
               dict(sampling_method="bogus"), dict(mcmc_type="ekf"),
               dict(mcmc_type="pm", output_type="summary")):
        with pytest.raises(NotImplementedError):
            bt.run_mcmc(tm, **{**dict(iter=10, particles=4, device="cpu"),
                               **kw})
    with pytest.raises(ValueError, match="particles"):
        bt.run_mcmc(tm, iter=10, particles=1, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        bt.run_mcmc(tm, iter=10, particles=4, device="cpu",
                    dtype=torch.float32)


def test_import_leaves_jax_out():
    """``import bssm_tpu_torch`` pulls in neither jax, flax nor the JAX
    package, and switches TF32 off."""
    code = ("import sys, torch, bssm_tpu_torch, bssm_tpu_torch.convert, "
            "bssm_tpu_torch.ops.cuda_kalman\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'bssm_tpu')]\n"
            "assert not bad, bad\n"
            "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
            "assert torch.backends.cudnn.allow_tf32 is False\n"
            "print('clean')")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
