"""PyTorch port vs the JAX package: the linear-Gaussian smoothers, the public
smoothing and log-likelihood API, and the simulation smoother fed the JAX
package's own normals, on the CPU in float64.

The models, thetas and tolerances are those of ``tests/test_torch_lg.py``.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.ops import kalman as jkalman
from bssm_tpu.ops import simsmooth as jsim

import bssm_tpu_torch as bt
from bssm_tpu_torch.ops import kalman as tkalman
from bssm_tpu_torch.ops import simsmooth as tsim
from tests.test_torch_lg import _close, _pair, _specs, _thetas


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bsm4", "ar1"])
def test_smoothers_match(kind):
    """fast_smoother with and without reused gains, the J-form smoother
    (alphahat, Vt, ccov, logLik), and forward_stats."""
    jm, tm = _pair(kind)
    B = 3
    jspec, tspec = _specs(jm, tm, _thetas(jm, B, seed=6))
    _close(tkalman.fast_smoother(tspec), jax.vmap(jkalman.fast_smoother)(jspec))
    js = jax.vmap(jkalman.forward_stats)(jspec)
    ts = tkalman.forward_stats(tspec)
    for name in js._fields:
        _close(getattr(ts, name).double(), getattr(js, name).astype(float))
    # a new series through the gains of the first
    rng = np.random.default_rng(7)
    y2 = np.asarray(jspec.y) + rng.normal(size=jspec.y.shape)
    jspec2 = jspec._replace(y=jnp.asarray(y2))
    tspec2 = tspec._replace(y=torch.as_tensor(y2))
    _close(tkalman.fast_smoother(tspec2, ts),
           jax.vmap(jkalman.fast_smoother)(jspec2, js))
    jr, tr = jax.vmap(jkalman.smoother)(jspec), tkalman.smoother(tspec)
    for name in ("alphahat", "Vt", "ccov", "logLik"):
        _close(getattr(tr, name), getattr(jr, name))


def test_public_smoothers_and_loglik_match():
    """The public API on a model at a theta: ``fast_smoother``,
    ``smoother`` and ``logLik`` against the JAX package's, and
    ``sim_smoother``'s antithetic pairs averaging to the smoothed means."""
    from bssm_tpu.inference import loglik as jloglik
    from bssm_tpu.inference import smoothers as jsmoothers
    jm, tm = _pair("aq")
    th = _thetas(jm, 1, seed=8)[0]
    _close(bt.fast_smoother(tm, theta=th)[0],
           jsmoothers.fast_smoother(jm, theta=jnp.asarray(th)))
    jr = jsmoothers.smoother(jm, theta=jnp.asarray(th))
    tr = bt.smoother(tm, theta=th)
    _close(tr.alphahat[0], jr.alphahat)
    _close(tr.Vt[0], jr.Vt)
    _close(bt.logLik(tm, theta=th)[0], jloglik.logLik(jm, theta=jnp.asarray(th)))
    draws = bt.sim_smoother(tm, 6, seed=3, theta=th)
    assert draws.shape == (6, tm.extra["n"] + 1, 2)
    _close(0.5 * (draws[:3] + draws[3:]),
           np.broadcast_to(np.asarray(jr.alphahat), (3,) + jr.alphahat.shape),
           rtol=1e-8)


# ---------------------------------------------------------------------------
# simulation smoother from the JAX package's own draws
# ---------------------------------------------------------------------------

def _key_normals(keys, n, m, k):
    """The normals ``_simulate_prior_and_obs`` draws from each key:
    ``um (B, m)``, ``eps (B, n)``, ``eta (B, n, k)``."""
    def one(key):
        k0, k1, k2 = jax.random.split(key, 3)
        return (jax.random.normal(k0, (m,), jnp.float64),
                jax.random.normal(k1, (n,), jnp.float64),
                jax.random.normal(k2, (n, k), jnp.float64))
    return [torch.as_tensor(np.array(x)) for x in jax.vmap(one)(keys)]


@pytest.mark.parametrize("kind", ["bsm4", "ar1"])
def test_simulate_states_single_matches_for_the_same_keys(kind):
    """One draw per batch row (the full output of linear-Gaussian MCMC),
    with the port fed the normals the JAX package draws from each row's
    key."""
    jm, tm = _pair(kind)
    B = 4
    jspec, tspec = _specs(jm, tm, _thetas(jm, B, seed=9))
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    want = jax.vmap(jsim.simulate_states_single)(jspec, keys)
    um, eps, eta = _key_normals(keys, tspec.n, tspec.m, tspec.k)
    got = tsim.simulate_states_single(tspec, um=um, eps=eps, eta=eta)
    _close(got, want)


@pytest.mark.parametrize("antithetic", [True, False])
def test_simulate_states_matches_for_the_same_key(antithetic):
    """``nsim`` draws of one model, with antithetic pairs."""
    jm, tm = _pair("bsm4")
    th = _thetas(jm, 1, seed=10)[0]
    jspec = jm.build(jnp.asarray(th))
    tspec = tm.build(torch.as_tensor(th))
    key, nsim = jax.random.PRNGKey(12), 5
    want = jsim.simulate_states(jspec, nsim, key, use_antithetic=antithetic)
    n_base = 3 if antithetic else nsim
    um, eps, eta = _key_normals(jax.random.split(key, n_base), tspec.n,
                                tspec.m, tspec.k)
    got = tsim.simulate_states(tspec, nsim, use_antithetic=antithetic,
                               um=um, eps=eps, eta=eta)
    assert got.shape == (nsim, tspec.n + 1, tspec.m)
    _close(got, want)


def test_simulate_states_needs_all_or_none_of_the_normals():
    jm, tm = _pair("bsm1")
    tspec = tm.build(torch.as_tensor(np.array(jm.theta_init)))
    with pytest.raises(ValueError):
        tsim.simulate_states_single(tspec, um=torch.zeros(1, 1))
