"""PyTorch port vs the JAX package: ``run_mcmc`` on the multivariate models,
end to end on the CPU in float64, within Monte-Carlo error.

- ``ssm_mlg`` with ``mcmc_type="gaussian"``: a bivariate local level with
  a partly missing row, the sds from an update function; posterior means
  against the JAX run's, and the port's full output against the smoothed
  moments of its summary output over the same thetas.
- ``ssm_mng`` (the zoo's Poisson + Gaussian model): one JAX is2/psi run
  serves as the reference.  Its unweighted draws are the approximate
  posterior (the port's approx and is2 phase 1), its weighted draws the
  posterior the port's is2, pm and da target.  The streams differ, so
  means agree within 4 combined standard errors (the spread of the
  per-chain means).  The JAX reference is one module-scoped run, shared by
  every case.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.models.ssm import ssm_mlg as j_ssm_mlg

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import mcmc as tmcmc

from test_torch_mv_approx import models
from test_torch_pm import _stats


def _z(jm, js, tm, ts):
    return np.abs(jm - tm) / np.sqrt(js ** 2 + ts ** 2)


# ---------------------------------------------------------------------------
# multivariate linear-Gaussian
# ---------------------------------------------------------------------------

def mlg_models(n=40, seed=3):
    """A bivariate local level (Z = T = I), sds exp(theta): H's two and
    R's two, theta ~ N(log 0.5, 1) each."""
    rng = np.random.default_rng(seed)
    lvl = np.cumsum(rng.normal(0, 0.3, size=(n, 2)), axis=0)
    y = lvl + rng.normal(0, 0.5, size=(n, 2))
    y[5, 0] = np.nan
    y[n // 2] = np.nan
    kw = dict(Z=np.eye(2), H=0.5 * np.eye(2), T=np.eye(2),
              R=0.3 * np.eye(2), P1=4.0 * np.eye(2),
              init_theta=np.log([0.5, 0.5, 0.3, 0.3]))
    mu = np.log(0.5)

    def jupd(th):
        e = jnp.exp(th)
        return {"H": jnp.diag(e[:2])[None], "R": jnp.diag(e[2:])[None]}

    jm = j_ssm_mlg(y, **kw, update_fn=jupd,
                   prior_fn=lambda th: -0.5 * jnp.sum(jnp.square(th - mu)))

    def tupd(th):
        e = torch.exp(th)
        return {"H": torch.diag_embed(e[:, :2])[:, None],
                "R": torch.diag_embed(e[:, 2:])[:, None]}

    tm = bt.ssm_mlg(y, **kw, update_fn=tupd,
                    prior_fn=lambda th: -0.5 * ((th - mu) ** 2).sum(-1),
                    dtype=torch.float64, device="cpu")
    return jm, tm


def test_mlg_gaussian_matches_jax_and_full_agrees_with_summary():
    jm, tm = mlg_models()
    kw = dict(iter=200, mcmc_type="gaussian", n_chains=8, seed=2)
    jout = jmcmc.run_mcmc(jm, output_type="theta", **kw)
    tout = bt.run_mcmc(tm, output_type="full", **kw, device="cpu")
    assert tout.theta.shape == jout.theta.shape == (8, 100, 4)
    jmean, jse, jacc, _ = _stats(jout)
    tmean, tse, tacc, _ = _stats(tout)
    assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    assert abs(jacc - tacc) < 0.1, (jacc, tacc)
    # summary output's moments (smoother_mv) over the same thetas: the
    # state draws' mean lies within 6 sqrt(Vt / draws) of them
    ahat, Vt = tmcmc._state_summary(tm, torch.as_tensor(tout.theta), 4096)
    a = tout.alpha.reshape((-1,) + tout.alpha.shape[2:])
    assert a.shape[1:] == (41, 2) and np.isfinite(a).all()
    sd = np.sqrt(np.diagonal(Vt.numpy(), axis1=1, axis2=2) / a.shape[0])
    assert (np.abs(a.mean(0) - ahat.numpy()) < 6 * sd).all()


# ---------------------------------------------------------------------------
# multivariate non-Gaussian
# ---------------------------------------------------------------------------

KW = dict(particles=10, n_chains=8, seed=4, output_type="theta")


@pytest.fixture(scope="module")
def mng():
    """The port's model and the JAX reference run (is2/psi, 8 x 160)."""
    jm, tm = models("pois_gauss", n=16, seed=5)
    jout = jmcmc.run_mcmc(jm, iter=160, mcmc_type="is2", **KW)
    return tm, jout


class _Unweighted:
    """A run's draws without their IS weights (its approximate chain)."""

    def __init__(self, out):
        self.theta, self.weights = out.theta, None
        self.acceptance_rate = out.acceptance_rate

    def flat_theta(self):
        return self.theta.reshape(-1, self.theta.shape[-1])


def _unweighted(out):
    return _stats(_Unweighted(out))


def test_mng_is2_matches_jax(mng):
    """The port's is2/psi: its phase-1 draws against the JAX run's
    (the approximate posterior), its weighted draws against the JAX run's
    weighted draws; acceptance within 0.1, ESS_IS fractions near 1."""
    tm, jout = mng
    tout = bt.run_mcmc(tm, iter=160, mcmc_type="is2", **KW, device="cpu")
    assert tout.theta.shape == jout.theta.shape == (8, 80, 1)
    for fn in (_unweighted, _stats):
        jmean, jse, jacc, jess = fn(jout)
        tmean, tse, tacc, tess = fn(tout)
        assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    assert abs(jacc - tacc) < 0.1, (jacc, tacc)
    assert tess > 0.9 and jess > 0.9, (tess, jess)


@pytest.mark.parametrize("mcmc_type", ["pm", "da"])
def test_mng_pm_da_match_jax_posterior(mng, mcmc_type):
    """pm and da with the psi filter against the JAX run's weighted
    draws: the same posterior."""
    tm, jout = mng
    tout = bt.run_mcmc(tm, iter=100, mcmc_type=mcmc_type, **KW,
                       device="cpu")
    assert tout.theta.shape == (8, 50, 1) and tout.weights is None
    jmean, jse, _, _ = _stats(jout)
    tmean, tse, tacc, _ = _stats(tout)
    assert (_z(jmean, jse, tmean, tse) < 4.0).all(), (jmean, tmean)
    assert 0.05 < tacc < 0.9


def test_mng_approx_full_output_and_options(mng):
    """approx with full output (the JAX package's AttributeError, done
    here by ``approx_mv.approx_state_draws_mv``), and short runs of the
    other options: is1 / is3 with bsf and spdk, state outputs, the global
    approximation, and ``suggest_N``."""
    tm, _ = mng
    short = dict(iter=30, particles=6, n_chains=2, seed=1, device="cpu")
    out = bt.run_mcmc(tm, mcmc_type="approx", output_type="full", **short)
    assert out.alpha.shape == (2, 15, 17, 2) and np.isfinite(out.alpha).all()
    assert out.modes.shape == (2, 15, 16, 2)
    for mt, sm, ot in (("is1", "bsf", "summary"), ("is3", "spdk", "full"),
                       ("is2", "psi", "full"), ("da", "spdk", "theta")):
        o = bt.run_mcmc(tm, mcmc_type=mt, sampling_method=sm, output_type=ot,
                        **short)
        assert np.isfinite(o.posterior).all(), (mt, sm)
        if ot == "full":
            assert o.alpha.shape == (2, 15, 17, 2)
        if ot == "summary":
            assert o.alphahat.shape == (17, 2) and o.Vt.shape == (17, 2, 2)
    g = bt.run_mcmc(tm, mcmc_type="is2", local_approx=False, **short)
    assert g.local_approx is False and np.isfinite(g.weights).all()
    assert g.modes.shape == (2, 15, 16, 2)
    sug = bt.suggest_N(tm, candidates=(2, 8), replications=16)
    assert set(sug["all"]) <= {2, 8} and np.isfinite(sug["sd"])
