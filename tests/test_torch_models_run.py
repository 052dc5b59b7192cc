"""PyTorch port vs the JAX package: runs on the new univariate models.

- The bootstrap filter on a linear-Gaussian model (``ssm_ulg``,
  ``bootstrap_filter`` / ``particle_smoother``): over 16 independent runs
  of 1000 particles, the mean log-likelihood estimate lies within 4 of its
  standard errors of the exact Kalman value, and the mean smoothed means
  within 5 standard errors of the Kalman smoother's at every (t, j); the
  same test holds the JAX package's ``bsf_filter_lg``.
- The slice as a whole: ``run_mcmc`` is2 / psi on an ``svm`` model (n = 24,
  8 chains x 120 iterations, 8 particles) on each side, with different
  random streams: the weighted posterior means of the three parameters
  agree within 4 Monte-Carlo standard errors (from the spread across
  chains, both runs' errors combined), the acceptance rates within 0.1,
  and the ESS_IS fraction exceeds 0.8 on both.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bssm_tpu.core import priors as jpri
from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.inference import particle as jpf
from bssm_tpu.models.svm import svm as jsvm
from bssm_tpu.ops import kalman as jkalman
from bssm_tpu.ops.resample import ancestor_trace as j_trace

import bssm_tpu_torch as bt
from tests.test_torch_mcmc import _is_stats
from tests.test_torch_models import pair, sv_series

REPS, PARTICLES = 16, 1000


def _agree(ll, ll_exact, means, alphahat):
    """Replicates ``ll (R,)`` and ``means (R, n+1, m)`` against the exact
    values."""
    se = ll.std(ddof=1) / np.sqrt(len(ll))
    assert abs(ll.mean() - ll_exact) < 4.0 * se, (ll.mean(), ll_exact, se)
    sem = means.std(0, ddof=1) / np.sqrt(means.shape[0])
    z = np.abs(means.mean(0) - alphahat) / sem
    assert z.max() < 5.0, z.max()


def test_bootstrap_filter_of_a_linear_gaussian_model():
    jm, tm, th = pair("ssm_ulg")
    theta = np.repeat(th[:1], REPS, axis=0)
    spec = tm.build(torch.as_tensor(theta))
    one = bt.smoother(tm, theta=th[0])
    exact = float(bt.logLik(tm, theta=th[0])[0])
    pf = bt.bootstrap_filter(spec, PARTICLES, seed=3)
    assert pf.alpha.shape == (REPS, PARTICLES, spec.n + 1, 2)
    ps = bt.particle_smoother(spec, PARTICLES, seed=4)
    np.testing.assert_allclose(ps.weights.sum(-1).numpy(), 1.0)
    _agree(pf.loglik.numpy(), exact, ps.alphahat.numpy(),
           one.alphahat[0].numpy())
    # the JAX package's bsf_filter_lg, by the same test
    jspec = jm.build(jnp.asarray(th[0]))

    def run(key):
        res = jpf.bsf_filter_lg(jspec, PARTICLES, key)
        traced = j_trace(res.alpha, res.indices)
        w = res.weights[:, -1] / jnp.sum(res.weights[:, -1])
        return res.loglik, jnp.einsum('i,itm->tm', w, traced)

    ll, means = jax.jit(jax.vmap(run))(
        jax.random.split(jax.random.PRNGKey(5), REPS))
    sm = jkalman.smoother(jspec)
    np.testing.assert_allclose(float(jkalman.log_likelihood(jspec)), exact,
                               rtol=1e-9)
    _agree(np.asarray(ll), exact, np.asarray(means), np.asarray(sm.alphahat))


def test_svm_is2_end_to_end_matches_within_monte_carlo_error():
    y = sv_series(24, 7)

    def priors(p):
        return dict(rho=p.uniform_prior(0.9, -0.999, 0.999),
                    sd_ar=p.halfnormal_prior(0.2, 1.0),
                    sigma=p.halfnormal_prior(0.6, 2.0))

    jm = jsvm(y, **priors(jpri), dtype=jnp.float64)
    tm = bt.svm(y, **priors(bt), dtype=torch.float64, device="cpu")
    kw = dict(iter=120, particles=8, mcmc_type="is2", sampling_method="psi",
              output_type="theta", n_chains=8, seed=3)
    jout = jmcmc.run_mcmc(jm, **kw)
    tout = bt.run_mcmc(tm, device="cpu", **kw)
    assert tout.theta.shape == jout.theta.shape == (8, 60, 3)
    assert np.isfinite(tout.posterior).all() and np.isfinite(
        tout.weights).all()
    assert (np.abs(tout.theta[..., 0]) < 1.0).all()
    jmean, jse, jacc, jess = _is_stats(jout)
    tmean, tse, tacc, tess = _is_stats(tout)
    z = np.abs(jmean - tmean) / np.sqrt(jse ** 2 + tse ** 2)
    assert (z < 4.0).all(), (jmean, tmean, jse, tse)
    assert abs(jacc - tacc) < 0.1, (jacc, tacc)
    assert jess > 0.8 and tess > 0.8, (jess, tess)
