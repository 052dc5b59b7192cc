"""PyTorch port vs the JAX package: ``predict`` and ``fitted``, on the CPU.

Both packages read the same stored output (thetas in the natural space,
state draws, weights), built here from a seed, so no MCMC runs: fitted
means must agree to round-off; predictive draws, whose random streams
differ, within Monte-Carlo error.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.core.priors import normal_prior as j_normal
from bssm_tpu.core.priors import uniform_prior as j_uniform
from bssm_tpu.inference import predict as jpredict
from bssm_tpu.models.ar1 import ar1_ng as jar1_ng
from bssm_tpu.models.bsm import bsm_lg as jbsm_lg
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.models.svm import svm as jsvm

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.inference import predict as tpredict


def _models(kind, y):
    """The same model of ``y`` on both sides."""
    j, t = {}, dict(dtype=torch.float64, device="cpu")
    if kind == "bsm_lg":
        return (jbsm_lg(y, sd_y=j_halfnormal(0.5, 2.0),
                        sd_level=j_halfnormal(0.1, 1.0),
                        sd_slope=j_halfnormal(0.01, 0.1), dtype=jnp.float64),
                bt.bsm_lg(y, sd_y=bt.halfnormal_prior(0.5, 2.0),
                          sd_level=bt.halfnormal_prior(0.1, 1.0),
                          sd_slope=bt.halfnormal_prior(0.01, 0.1), **t))
    if kind in ("poisson", "negbin"):
        extra = {} if kind == "poisson" else dict(
            distribution="negative binomial", phi=None)
        dist = extra.pop("distribution", "poisson")
        if kind == "negbin":
            j["phi"], t["phi"] = j_halfnormal(3.0, 5.0), \
                bt.halfnormal_prior(3.0, 5.0)
        return (jbsm_ng(y, sd_level=j_halfnormal(0.1, 1.0),
                        sd_slope=j_halfnormal(0.01, 0.1), distribution=dist,
                        dtype=jnp.float64, **j),
                bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                          sd_slope=bt.halfnormal_prior(0.01, 0.1),
                          distribution=dist, **t))
    if kind == "svm":
        return (jsvm(y, rho=j_uniform(0.9, -0.999, 0.999),
                     sd_ar=j_halfnormal(0.3, 1.0),
                     sigma=j_halfnormal(0.8, 2.0), dtype=jnp.float64),
                bt.svm(y, rho=bt.uniform_prior(0.9, -0.999, 0.999),
                       sd_ar=bt.halfnormal_prior(0.3, 1.0),
                       sigma=bt.halfnormal_prior(0.8, 2.0), **t))
    return (jar1_ng(y, rho=j_uniform(0.8, -0.999, 0.999),
                    sigma=j_halfnormal(0.3, 1.0), mu=j_normal(1.0, 0.0, 2.0),
                    distribution="poisson", dtype=jnp.float64),
            bt.ar1_ng(y, rho=bt.uniform_prior(0.8, -0.999, 0.999),
                      sigma=bt.halfnormal_prior(0.3, 1.0),
                      mu=bt.normal_prior(1.0, 0.0, 2.0),
                      distribution="poisson", **t))


def _stored(tm, n, C=3, S=40, seed=0):
    """A stored "full" output of ``tm``: thetas near the initial value (in
    the natural space), state draws around a level of 1 and weights, all
    from a seed."""
    rng = np.random.default_rng(seed)
    th = np.asarray(tm.theta_init) + 0.1 * rng.normal(size=(C, S, tm.n_par))
    th = np.asarray(tm.to_natural(torch.as_tensor(th)))
    m = tm.build(torch.as_tensor(tm.theta_init)).a1.shape[-1]
    alpha = 0.1 * rng.normal(size=(C, S, n + 1, m)).cumsum(2)
    alpha[..., 0] += 1.0
    w = rng.uniform(0.2, 1.0, size=(C, S))
    return tmcmc.McmcOutput(
        theta=th, posterior=np.zeros((C, S)), accepted=np.ones((C, S), bool),
        acceptance_rate=0.3, S=np.zeros((C, tm.n_par, tm.n_par)),
        theta_names=tm.theta_names, mcmc_type="is2", output_type="full",
        iter=2 * S, burnin=S, thin=1, alpha=alpha, weights=w)


def _series(kind, n, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "bsm_lg":
        return np.cumsum(rng.normal(0, .3, n)) + rng.normal(0, .5, n)
    if kind == "svm":
        return 0.8 * rng.normal(size=n)
    return rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0)) \
        .astype(float)


@pytest.mark.parametrize("kind", ["bsm_lg", "poisson", "svm"])
def test_fitted_means_match_jax(kind):
    """``fitted(type="mean")`` of the same stored output on both sides:
    within 1e-12 (relative).  For the SV family the JAX package also
    returns a column for the stored state beyond the data (its signal is
    the whole first state); the port returns the n fitted values."""
    n = 15
    jm, tm = _models(kind, _series(kind, n))
    out = _stored(tm, n)
    got = bt.fitted(out, tm)
    ref = np.asarray(jpredict.fitted(out, jm))[:, :n]
    assert got.shape == ref.shape == (120, n)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    resp = bt.fitted(out, tm, type="response")
    assert resp.shape == (120, n) and np.isfinite(resp).all()


def test_sim_states_is_the_state_recursion():
    """``_sim_states`` with injected noise against the recursion written
    out in numpy: alpha_1 = a1, alpha_{t+1} = C + T alpha_t + R eta_t."""
    _, tm = _models("poisson", _series("poisson", 10))
    spec = tm.build(torch.as_tensor(np.asarray(tm.theta_init)[None]
                                    + np.array([[0.0, 0.0], [0.3, -0.2]])))
    rng = np.random.default_rng(2)
    a1 = rng.normal(size=(2, 2))
    eta = rng.normal(size=(2, 10, 2))
    got = tpredict._sim_states(spec, torch.as_tensor(a1),
                               eta=torch.as_tensor(eta)).numpy()
    T = spec.T[0].numpy()
    C = spec.C[0].numpy()
    for b in range(2):
        R = spec.R[b, 0].numpy()
        a = a1[b]
        for t in range(10):
            np.testing.assert_allclose(got[b, t], a, rtol=1e-14, atol=1e-14)
            a = C + T @ a + R @ eta[b, t]


@pytest.mark.parametrize("kind", ["bsm_lg", "poisson", "negbin", "svm",
                                  "ar1_ng"])
def test_predict_moments_match_jax_within_monte_carlo_error(kind):
    """A 6-step future model (y all NaN), 4000 draws of each type on each
    side: the means of the states, the observation means and the responses
    at every horizon within 4.5 combined standard errors; shapes and
    finiteness.  The JAX package's state recursion emits the stored state
    twice (its scan's outputs already start with a1, and a1 is prepended
    again), so its horizon t + 1 is the port's horizon t."""
    n, h = 15, 6
    y = _series(kind, n)
    _, tm = _models(kind, y)
    jf, tf = _models(kind, np.full(h, np.nan))
    out = _stored(tm, n, seed=3)
    for typ in ("state", "mean", "response"):
        ref = np.asarray(jpredict.predict(out, jf, typ, 4000, seed=5))
        got = bt.predict(out, tf, typ, 4000, seed=6)
        assert got.shape == ref.shape and np.isfinite(got).all()
        ref, got = ref[:, 1:], got[:, :-1]
        se = np.sqrt(ref.var(0) / 4000 + got.var(0) / 4000)
        z = np.abs(ref.mean(0) - got.mean(0)) / np.maximum(se, 1e-12)
        assert (z < 4.5).all(), (kind, typ, z.max())


def test_predict_and_fitted_need_state_output():
    _, tm = _models("poisson", _series("poisson", 10))
    out = _stored(tm, 10)
    out.alpha = None
    with pytest.raises(ValueError, match="output_type='full'"):
        bt.predict(out, tm)
    with pytest.raises(ValueError, match="output_type='full'"):
        bt.fitted(out, tm)
