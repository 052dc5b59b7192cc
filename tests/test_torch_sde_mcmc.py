"""PyTorch port vs the JAX package: ``run_mcmc`` on the SDE models, end to
end on the CPU in float64, within Monte-Carlo error.

``sde_gbm`` on a simulated series (n = 15, L_f = 4, L_c = 2, 16
particles).  One module-scoped fixture holds the JAX reference: an is2
run, whose unweighted draws are the approximate (coarse-level) posterior
and whose weighted draws the posterior that is2, pm and da target, and a
da run.  The randomness differs (threefry keys there, per-row Philox seeds
here), so means agree within 4 combined standard errors (the spread of the
per-chain means).  ``post_correct`` of the port's approx run, from its
stored seeds, gives is2's weights again; two models with different
particle counts interleaved leave each other's output as it was (the JAX
package's ``tests/test_sde.py`` regression).
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import numpy as np
import pytest
import torch

from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.models import sde as jsde

import bssm_tpu_torch as bt

from test_torch_mv_mcmc import _unweighted, _z
from test_torch_pm import _stats

N = 16
KW = dict(particles=N, output_type="theta", device="cpu")
PORT = dict(iter=120, n_chains=16, seed=3)


def simulate_gbm(n=15, mu=0.05, sx=0.2, sy=1.5, x0=1.0, seed=0):
    """The JAX package's ``tests/test_sde.py`` simulation: exact GBM
    transitions over unit time, log-normal observations."""
    rng = np.random.default_rng(seed)
    x, y = x0, np.zeros(n)
    for t in range(n):
        x = x * np.exp((mu - 0.5 * sx * sx) + sx * rng.normal())
        y[t] = np.log(x) + sy * rng.normal()
    return y


@pytest.fixture(scope="module")
def gbm():
    """The port's model, the JAX references (is2 and da, 16 chains x 300
    iterations) and the port's approx run (16 chains x 120)."""
    y = simulate_gbm()
    jm = jsde.sde_gbm(y, L_f=4, L_c=2)
    tm = bt.sde_gbm(y, L_f=4, L_c=2, dtype=torch.float64, device="cpu")
    ref = dict(iter=300, particles=N, n_chains=16, seed=2,
               output_type="theta")
    jis2 = jmcmc.run_mcmc(jm, mcmc_type="is2", **ref)
    jda = jmcmc.run_mcmc(jm, mcmc_type="da", **ref)
    ap = bt.run_mcmc(tm, mcmc_type="approx", **PORT, **KW)
    return tm, jis2, jda, ap


def _in_support(out):
    th = out.flat_theta()
    assert np.isfinite(th).all() and np.isfinite(out.posterior).all()
    assert th[:, 2].min() >= 0.5 and th[:, :2].min() >= 0.0


def test_approx_is2_and_post_correct(gbm):
    """approx: its draws against the JAX is2 run's unweighted draws (the
    coarse-level posterior); is2 with full output: its weighted draws
    against the JAX run's; ``post_correct`` of the approx run from its
    stored seeds gives is2's weights and trajectories, its summary output
    is finite."""
    tm, jis2, _, ap = gbm
    assert ap.modes.shape == (16, 60) and ap.modes.dtype == np.int64
    jmean, jse, jacc, _ = _unweighted(jis2)
    tmean, tse, tacc, _ = _unweighted(ap)
    assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    assert abs(jacc - tacc) < 0.1, (jacc, tacc)
    is2 = bt.run_mcmc(tm, mcmc_type="is2", **PORT,
                      **{**KW, "output_type": "full"})
    np.testing.assert_array_equal(is2.theta, ap.theta)
    jmean, jse, _, jess = _stats(jis2)
    tmean, tse, _, tess = _stats(is2)
    assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    assert tess > 0.5 and jess > 0.5, (tess, jess)
    assert is2.alpha.shape == (16, 60, 16, 1)
    assert np.isfinite(is2.alpha).all()
    _in_support(is2)
    gen = bt.is_correction_generator(PORT["seed"], "cpu")
    pc = bt.post_correct(tm, ap, N, sampling_method="bsf",
                         output_type="full", generator=gen)
    np.testing.assert_array_equal(pc.weights, is2.weights)
    np.testing.assert_array_equal(pc.alpha, is2.alpha)
    summ = bt.post_correct(tm, ap, N, sampling_method="bsf",
                           output_type="summary")
    assert summ.alphahat.shape == (16, 1) and summ.Vt.shape == (16, 1, 1)
    assert np.isfinite(summ.alphahat).all() and np.isfinite(summ.Vt).all()
    with pytest.raises(ValueError, match="bootstrap filter"):
        bt.post_correct(tm, ap, N)              # psi: the JAX package dies


@pytest.mark.parametrize("mcmc_type", ["pm", "da"])
def test_pm_da_match_jax_posterior(gbm, mcmc_type):
    """pm (full output) and da against the JAX is2 run's weighted draws,
    da's acceptance against the JAX da run's."""
    tm, jis2, jda, _ = gbm
    out_type = "full" if mcmc_type == "pm" else "theta"
    out = bt.run_mcmc(tm, mcmc_type=mcmc_type, **PORT,
                      **{**KW, "output_type": out_type})
    jmean, jse, _, _ = _stats(jis2)
    tmean, tse, tacc, _ = _stats(out)
    assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    _in_support(out)
    if mcmc_type == "pm":
        assert out.alpha.shape == (16, 60, 16, 1)
        assert np.isfinite(out.alpha).all()
    else:
        assert abs(tacc - jda.acceptance_rate) < 0.1, \
            (tacc, jda.acceptance_rate)


def test_interleaved_particle_counts_and_poisson_ou():
    """Two models with different particle counts interleaved leave each
    other's output unchanged; ``sde_poisson_ou`` runs is2 and da."""
    y = simulate_gbm(n=12)
    m1 = bt.sde_gbm(y, L_f=4, L_c=2, dtype=torch.float64, device="cpu")
    m2 = bt.sde_gbm(y + 0.1, L_f=4, L_c=2, dtype=torch.float64,
                    device="cpu")
    kw = dict(iter=30, mcmc_type="is2", seed=1, n_chains=4, device="cpu")
    o1a = bt.run_mcmc(m1, particles=8, **kw)
    o2 = bt.run_mcmc(m2, particles=16, **kw)
    o1b = bt.run_mcmc(m1, particles=8, **kw)
    assert np.isfinite(o2.posterior).all()
    np.testing.assert_array_equal(o1a.theta, o1b.theta)
    np.testing.assert_array_equal(o1a.weights, o1b.weights)
    rng = np.random.default_rng(5)
    ou = bt.sde_poisson_ou(rng.poisson(1.0, size=12).astype(float), L_f=4,
                           L_c=2, dtype=torch.float64, device="cpu")
    for mcmc_type in ("is2", "da"):
        out = bt.run_mcmc(ou, iter=30, particles=8, mcmc_type=mcmc_type,
                          seed=6, n_chains=4, device="cpu")
        assert np.isfinite(out.flat_theta()).all()
        assert np.isfinite(out.posterior).all()
