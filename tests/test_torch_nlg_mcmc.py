"""PyTorch port vs the JAX package: ``run_mcmc`` on a nonlinear model, end
to end on the CPU in float64, within Monte-Carlo error.

The growth model on ``simulate_growth(n=30)``.  One module-scoped fixture
holds the JAX reference: an is2/psi run, whose unweighted draws are the
approximate posterior (the port's approx and is2 phase 1) and whose
weighted draws the posterior that the port's is2, pm and da target, and an
``mcmc_type="ekf"`` run.  The streams differ, so means agree within 4
combined standard errors (the spread of the per-chain means).  The port's
ekf full output is held against its summary output over the same thetas,
``post_correct`` against ``run_mcmc``'s own correction, and the forecast
recursion against the JAX ``_sim_states_nlg`` on the same disturbances.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.inference import predict as jpredict
from bssm_tpu.models import examples as jex

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.inference import predict as tpredict

from test_torch_mv_mcmc import _unweighted, _z
from test_torch_pm import _stats

ITER = 140
KW = dict(particles=10, n_chains=8, seed=4, output_type="theta",
          sampling_method="psi")


@pytest.fixture(scope="module")
def growth():
    """The port's model and the JAX references (is2/psi and ekf, 8 chains
    x 140 iterations)."""
    y = jex.simulate_growth(n=30, seed=1)
    y[9] = np.nan
    jm = jex.nlg_growth(y)
    tm = bt.example_models.nlg_growth(y, dtype=torch.float64, device="cpu")
    jis2 = jmcmc.run_mcmc(jm, iter=ITER, mcmc_type="is2", **KW)
    jekf = jmcmc.run_mcmc(jm, iter=ITER, mcmc_type="ekf", n_chains=8,
                          seed=4, output_type="theta")
    return y, tm, jis2, jekf


def test_is2_approx_and_post_correct_match(growth):
    """is2/psi: its phase-1 draws (the approx chain) against the JAX run's
    unweighted draws, its weighted draws against the JAX run's weighted
    draws; ``post_correct`` of the run with ``run_mcmc``'s correction
    generator gives its weights again."""
    _, tm, jout, _ = growth
    tout = bt.run_mcmc(tm, iter=ITER, mcmc_type="is2", **KW, device="cpu")
    assert tout.theta.shape == jout.theta.shape == (8, 70, 3)
    assert tout.modes.shape == (8, 70, 30, 2)
    for fn in (_unweighted, _stats):
        jmean, jse, jacc, jess = fn(jout)
        tmean, tse, tacc, tess = fn(tout)
        assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    assert abs(jacc - tacc) < 0.1, (jacc, tacc)
    assert tess > 0.5 and jess > 0.5, (tess, jess)
    pc = bt.post_correct(tm, tout, 10, sampling_method="psi",
                         output_type="theta",
                         generator=bt.is_correction_generator(4, "cpu"))
    np.testing.assert_array_equal(pc.weights, tout.weights)


@pytest.mark.parametrize("mcmc_type", ["pm", "da"])
def test_pm_da_match_jax_posterior(growth, mcmc_type):
    """pm and da with the psi filter (half as many iterations) against
    the JAX run's weighted draws: the same posterior."""
    _, tm, jout, _ = growth
    tout = bt.run_mcmc(tm, iter=ITER // 2, mcmc_type=mcmc_type, **KW,
                       device="cpu")
    assert tout.theta.shape == (8, 35, 3) and tout.weights is None
    jmean, jse, _, _ = _stats(jout)
    tmean, tse, tacc, _ = _stats(tout)
    assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    assert 0.05 < tacc < 0.9


def test_ekf_matches_jax_and_full_agrees_with_summary(growth):
    """``mcmc_type="ekf"`` against the JAX run; its full output (one
    simulation-smoother draw on the EKF linearisation a stored theta)
    averages to its summary (the extended Kalman smoother's moments by the
    law of total variance) over the same thetas within 6 sqrt(Vt /
    draws)."""
    _, tm, _, jout = growth
    full = bt.run_mcmc(tm, iter=ITER, mcmc_type="ekf", n_chains=8, seed=4,
                       output_type="full", device="cpu")
    summ = bt.run_mcmc(tm, iter=ITER, mcmc_type="ekf", n_chains=8, seed=4,
                       output_type="summary", device="cpu")
    np.testing.assert_array_equal(full.theta, summ.theta)
    jmean, jse, jacc, _ = _stats(jout)
    tmean, tse, tacc, _ = _stats(full)
    assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    assert abs(jacc - tacc) < 0.1, (jacc, tacc)
    a = full.alpha.reshape((-1,) + full.alpha.shape[2:])
    assert a.shape == (560, 31, 2) and np.isfinite(a).all()
    sd = np.sqrt(np.diagonal(summ.Vt, axis1=1, axis2=2) / a.shape[0])
    assert (np.abs(a.mean(0) - summ.alphahat) < 6 * sd).all()
    # the summary is the pooled EKF smoother of the stored thetas
    ahat, Vt = tmcmc._state_summary(tm, torch.as_tensor(full.theta), 4096)
    np.testing.assert_allclose(summ.alphahat, ahat.numpy(), rtol=1e-12)


def test_predict_recursion_and_other_flavours(growth):
    """``_sim_states_nlg`` on the disturbances of the JAX recursion's key
    equals it (both emit a1 once); ``predict`` on an approx run; short
    runs of is1 / is3 / pm / da with the bootstrap filter (nlg's default
    method) and state outputs; ``suggest_N``."""
    y, tm, _, _ = growth
    jm = jex.nlg_growth(np.full(6, np.nan))
    fut = bt.example_models.nlg_growth(np.full(6, np.nan),
                                       dtype=torch.float64, device="cpu")
    th = np.asarray(jm.theta_init)
    a1 = np.array([0.3, 40.0])
    key = jax.random.PRNGKey(3)
    want = jpredict._sim_states_nlg(jm.build(jnp.asarray(th)),
                                    jnp.asarray(a1), key)
    eta = torch.as_tensor(np.array(jax.random.normal(key, (6, 2),
                                                     jnp.float64)))[None]
    got = tpredict._sim_states_nlg(fut.build(torch.as_tensor(th)),
                                   torch.as_tensor(a1)[None], eta=eta)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12)
    short = dict(iter=12, particles=8, n_chains=2, seed=1, device="cpu")
    ap = bt.run_mcmc(tm, mcmc_type="approx", output_type="full", **short)
    for ty, shape in (("state", (50, 6, 2)), ("mean", (50, 6, 1)),
                      ("response", (50, 6, 1))):
        pr = bt.predict(ap, fut, ty, nsim=50)
        assert pr.shape == shape and np.isfinite(pr).all()
    for mt, ot in (("is1", "summary"), ("is3", "full"), ("pm", "full"),
                   ("da", "full")):
        o = bt.run_mcmc(tm, mcmc_type=mt, output_type=ot, **short)
        assert np.isfinite(o.posterior).all(), mt
        if ot == "full":
            assert o.alpha.shape == (2, 6, 31, 2), mt
            assert np.isfinite(o.alpha).all(), mt
        else:
            assert o.alphahat.shape == (31, 2) and o.Vt.shape == (31, 2, 2)
    sug = bt.suggest_N(tm, candidates=(2, 8), replications=16)
    assert set(sug["all"]) <= {2, 8} and np.isfinite(sug["sd"])


def test_deviations_raise(growth):
    """``local_approx=False`` (the JAX package runs the local
    approximation regardless), ``fitted`` (the JAX package dies with an
    AttributeError), SPDK (as in the JAX package) and ``ekf`` on a model
    that is not nonlinear (``NotImplementedError``, as every mcmc_type a
    model kind does not run)."""
    _, tm, _, _ = growth
    short = dict(iter=4, particles=4, n_chains=2, device="cpu")
    with pytest.raises(ValueError, match="local_approx"):
        bt.run_mcmc(tm, local_approx=False, **short)
    with pytest.raises(ValueError, match="spdk"):
        bt.run_mcmc(tm, sampling_method="spdk", **short)
    ap = bt.run_mcmc(tm, mcmc_type="approx", output_type="full", **short)
    with pytest.raises(ValueError, match="nonlinear"):
        bt.fitted(ap, tm)
    ng = bt.bsm_ng(np.arange(1.0, 11.0), sd_level=bt.halfnormal_prior(
        0.1, 1.0), distribution="poisson", dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="nonlinear"):
        bt.run_mcmc(ng, mcmc_type="ekf", **short)
