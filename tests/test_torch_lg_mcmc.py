"""PyTorch port vs the JAX package: linear-Gaussian marginal MCMC
(``mcmc_type="gaussian"``) with ``output_type`` "theta", "summary" and
"full", on the CPU in float64.

The chains of the two packages draw from different random streams, so they
are compared within Monte-Carlo error; the state summary is compared with
the JAX package's pooling formula on the same stored thetas, and the state
draws with the summary of the same theta chains.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.core.priors import normal_prior as j_normal
from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.models.bsm import bsm_lg as jbsm_lg
from bssm_tpu.ops import kalman as jkalman

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.ops import kalman as tkalman


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1))
    y = np.cumsum(rng.normal(0, 0.3, n)) + 0.8 * x[:, 0] \
        + rng.normal(0, 0.6, n)
    y[[5, n // 2]] = np.nan
    return y, x


def _models(n=40, seed=0, slope=False):
    """bsm_lg level (+ slope) with one regressor, on both sides."""
    y, x = _data(n, seed)
    jkw = dict(sd_y=j_halfnormal(0.5, 2.0), sd_level=j_halfnormal(0.3, 1.0),
               xreg=x, beta=j_normal(np.zeros(1), 0.0, 2.0),
               dtype=jnp.float64)
    tkw = dict(sd_y=bt.halfnormal_prior(0.5, 2.0),
               sd_level=bt.halfnormal_prior(0.3, 1.0), xreg=x,
               beta=bt.normal_prior(np.zeros(1), 0.0, 2.0),
               dtype=torch.float64, device="cpu")
    if slope:
        jkw["sd_slope"] = j_halfnormal(0.05, 0.1)
        tkw["sd_slope"] = bt.halfnormal_prior(0.05, 0.1)
    return jbsm_lg(y, **jkw), bt.bsm_lg(y, **tkw)


def _chain_stats(out):
    """Posterior means, their Monte-Carlo standard errors from the spread of
    the per-chain means, and the acceptance rate."""
    per_chain = out.theta.mean(axis=1)
    se = per_chain.std(axis=0, ddof=1) / np.sqrt(per_chain.shape[0])
    return out.flat_theta().mean(axis=0), se, out.acceptance_rate


def test_gaussian_end_to_end_matches_within_monte_carlo_error():
    """run_mcmc(gaussian, theta) on both sides, 8 chains x 400 iterations:
    posterior means within 4 combined Monte-Carlo standard errors and
    acceptance within 0.08."""
    jm, tm = _models()
    kw = dict(iter=400, output_type="theta", n_chains=8, seed=3)
    jout = jmcmc.run_mcmc(jm, **kw)
    tout = bt.run_mcmc(tm, device="cpu", **kw)
    assert tout.mcmc_type == "gaussian" == jout.mcmc_type
    assert tout.theta.shape == jout.theta.shape == (8, 200, 3)
    assert tout.alpha is None and tout.alphahat is None
    assert set(tout.time) == {"mcmc"}
    assert np.isfinite(tout.posterior).all()
    # the stored log-likelihood is the Kalman filter's at the stored theta
    th = np.where(tm.transforms == 1, np.log(tout.theta[0]), tout.theta[0])
    ll = tkalman.log_likelihood(tm.build(torch.as_tensor(th)))
    np.testing.assert_allclose(tout.posterior[0] - tout.prior[0], ll.numpy(),
                               rtol=1e-9)
    jmean, jse, jacc = _chain_stats(jout)
    tmean, tse, tacc = _chain_stats(tout)
    z = np.abs(jmean - tmean) / np.sqrt(jse ** 2 + tse ** 2)
    assert (z < 4.0).all(), (jmean, tmean, jse, tse)
    assert abs(jacc - tacc) < 0.08, (jacc, tacc)


def test_summary_at_one_theta_is_the_smoother():
    """Every stored theta equal: the summary is the smoother at that theta
    (no spread of the smoothed means), whatever the chunking."""
    _, tm = _models(slope=True)
    th = torch.as_tensor(tm.theta_init).expand(3, 4, -1)
    ahat, Vt = tmcmc._state_summary(tm, th, batch_size=5)
    sm = tkalman.smoother(tm.build(th[0, 0]))
    np.testing.assert_allclose(ahat.numpy(), sm.alphahat[0].numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Vt.numpy(), sm.Vt[0].numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("batch_size", [5, 64])
def test_summary_pools_like_the_jax_package(batch_size):
    """Distinct stored thetas (3 chains x 4 draws), chunks that cross
    chains or hold all rows: the JAX package's pooling (law of total
    variance per chain, then across chains) on its own smoother, rtol
    1e-9."""
    jm, tm = _models(slope=True)
    rng = np.random.default_rng(4)
    th = np.asarray(jm.theta_init)[None, None] + 0.3 * rng.normal(
        size=(3, 4, 4))
    ahat, Vt = tmcmc._state_summary(tm, torch.as_tensor(th), batch_size)
    sm = jax.vmap(jax.vmap(lambda t: jkalman.smoother(jm.build(t))))(
        jnp.asarray(th))
    a, v = np.asarray(sm.alphahat), np.asarray(sm.Vt)     # (3, 4, n+1, ...)
    dev = a - a.mean(1, keepdims=True)
    vt_c = v.mean(1) + np.einsum('csti,cstj->ctij', dev, dev) / 4
    a_c = a.mean(1)
    dev_c = a_c - a_c.mean(0)
    want_v = vt_c.mean(0) + np.einsum('cti,ctj->tij', dev_c, dev_c) / 3
    np.testing.assert_allclose(ahat.numpy(), a_c.mean(0), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(Vt.numpy(), want_v, rtol=1e-9, atol=1e-9)


def test_full_draws_average_to_the_summary():
    """output_type "summary" and "full" from one seed: the theta chains
    are the same (the state draws take the second generator), and the mean
    of the draws lies within 6 sqrt(Vt / draws) of alphahat at every
    (t, j).  The draws run in chunks of 96 rows."""
    _, tm = _models(slope=True)
    kw = dict(iter=300, n_chains=6, seed=5, device="cpu", corr_batch=96)
    summ = bt.run_mcmc(tm, output_type="summary", **kw)
    full = bt.run_mcmc(tm, output_type="full", **kw)
    np.testing.assert_array_equal(full.theta, summ.theta)
    n, m = tm.extra["n"], tm.extra["m"]
    assert full.alpha.shape == (6, 150, n + 1, m)
    assert summ.alphahat.shape == (n + 1, m)
    assert summ.Vt.shape == (n + 1, m, m)
    assert set(full.time) == set(summ.time) == {"mcmc", "states"}
    assert np.isfinite(full.alpha).all()
    draws = full.alpha.reshape((-1, n + 1, m))
    sd = np.sqrt(np.diagonal(summ.Vt, axis1=-2, axis2=-1) / draws.shape[0])
    z = np.abs(draws.mean(0) - summ.alphahat) / sd
    assert z.max() < 6.0, z.max()
    # the draws' spread is the posterior's, not the smoother's alone
    np.testing.assert_allclose(draws.var(0), np.diagonal(summ.Vt, axis1=-2,
                                                         axis2=-1),
                               rtol=0.35)


def test_full_draws_are_simulation_smoother_draws_at_the_stored_thetas():
    """_state_draws at one repeated theta is the simulation smoother's
    law: its mean within 6 standard errors of the smoothed mean."""
    _, tm = _models()
    th = torch.as_tensor(tm.theta_init).expand(2, 300, -1)
    g = torch.Generator().manual_seed(9)
    a = tmcmc._state_draws(tm, th, g, batch_size=256)
    sm = tkalman.smoother(tm.build(th[0, 0]))
    assert a.shape == (2, 300, tm.extra["n"] + 1, 1)
    draws = a.reshape(600, -1)
    sd = np.sqrt(sm.Vt[0, :, 0, 0].numpy() / 600)
    z = np.abs(draws.mean(0) - sm.alphahat[0, :, 0].numpy()) / sd
    assert z.max() < 6.0, z.max()


def test_lg_entry_points_raise_without_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    y, x = _data(20, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.bsm_lg(y, sd_y=bt.halfnormal_prior(0.5, 1.0),
                  sd_level=bt.halfnormal_prior(0.3, 1.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.ar1_lg(y, rho=bt.uniform_prior(0.5, -0.9, 0.9),
                  sigma=bt.halfnormal_prior(0.3, 1.0))
    _, tm = _models(n=20, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.run_mcmc(tm, iter=10, output_type="summary")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bt.run_mcmc(tm, iter=10, device="cuda")


def test_lg_options():
    """Linear-Gaussian models run mcmc_type "gaussian" only, with the three
    ported output types; ar1_lg runs end to end."""
    _, tm = _models(n=20, seed=2)
    for kw in (dict(mcmc_type="is2"), dict(mcmc_type="pm"),
               dict(output_type="bogus")):
        with pytest.raises(NotImplementedError):
            bt.run_mcmc(tm, iter=10, device="cpu", **kw)
    y, _ = _data(30, 3)
    am = bt.ar1_lg(y * 0.3, rho=bt.uniform_prior(0.5, -0.95, 0.95),
                   sigma=bt.halfnormal_prior(0.3, 1.0),
                   sd_y=bt.halfnormal_prior(0.3, 1.0), dtype=torch.float64,
                   device="cpu")
    out = bt.run_mcmc(am, iter=60, n_chains=2, output_type="full",
                      device="cpu")
    assert out.alpha.shape == (2, 30, 31, 1)
    assert np.isfinite(out.alpha).all() and np.isfinite(out.posterior).all()
