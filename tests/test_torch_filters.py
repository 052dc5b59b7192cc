"""PyTorch port vs the JAX package: the particle filters with trajectories,
ancestor tracing, and the non-Gaussian public API on one model.

The JAX filters draw their normals and uniforms from a key; the tests replay
that key schedule (``bssm_tpu/inference/particle.py``, ``psi_filter`` and
``bsf_filter``) and inject the draws into the port, so the two sides run the
same randomness.  Float64 throughout; both sides run the same recursions
with sums taken in other orders, so results agree to 1e-10 (1 + |ref|), and
resampled ancestors exactly.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.inference import approx as japprox
from bssm_tpu.inference import filters as jfilters
from bssm_tpu.inference import loglik as jloglik
from bssm_tpu.inference import particle as jparticle
from bssm_tpu.inference import smoothers as jsmoothers
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.ops.resample import ancestor_trace as j_ancestor_trace

import bssm_tpu_torch as bt
from bssm_tpu_torch.core.spec import drop_batch
from bssm_tpu_torch.inference.filters import spec_of
from bssm_tpu_torch.inference import particle as tparticle
from bssm_tpu_torch.ops.resample import ancestor_trace

F64 = jnp.float64


def _close(got, want, tol=1e-10):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _models(n=30, seed=0, family="poisson", slope=True):
    """A bsm_ng built by both packages, two missing y, an informative
    initial state (the bootstrap filter's ensemble then starts near the
    data)."""
    rng = np.random.default_rng(seed)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    y = y.astype(float)
    y[[n // 4, n - 3]] = np.nan
    m = 2 if slope else 1
    kw = dict(distribution=family, a1=np.r_[1.0, 0.0][:m],
              P1=np.eye(m) * 0.5)
    if family == "negative binomial":
        kw["phi"] = 3.0
    jkw, tkw = {}, {}
    for k, a, b in [("sd_level", 0.1, 1.0)] + (
            [("sd_slope", 0.01, 0.1)] if slope else []):
        jkw[k], tkw[k] = j_halfnormal(a, b), bt.halfnormal_prior(a, b)
    jm = jbsm_ng(y, dtype=F64, **kw, **jkw)
    tm = bt.bsm_ng(y, dtype=torch.float64, device="cpu", **kw, **tkw)
    return jm, tm


def _psi_draws(key, n, N, m):
    """The normals and uniforms ``psi_filter`` draws from ``key``, in the
    port's layout ``eps (n+1, N, m)``, ``us (n, N)``."""
    key, k0 = jax.random.split(key)
    eps = [jax.random.normal(k0, (N, m), F64)]
    us = []
    for kt in jax.random.split(key, n):
        kr, kp = jax.random.split(kt)
        us.append(jax.random.uniform(kr, (N,), F64))
        eps.append(jax.random.normal(kp, (N, m), F64))
    return np.stack(eps), np.stack(us)


def _bsf_draws(key, n, N, m, k):
    """``bsf_filter``'s draws from ``key``: the initial normals, then per
    step a uniform per particle and k state disturbances (padded to m)."""
    key, k0 = jax.random.split(key)
    eps = [jax.random.normal(k0, (N, m), F64)]
    us = []
    for kt in jax.random.split(key, n):
        kr, kp = jax.random.split(kt)
        us.append(jax.random.uniform(kr, (N,), F64))
        eta = np.asarray(jax.random.normal(kp, (N, k), F64))
        eps.append(np.pad(eta, ((0, 0), (0, m - k))))
    return np.stack(eps), np.stack(us)


def _stack(draws):
    return tuple(torch.as_tensor(np.stack(x)) for x in zip(*draws))


def test_ancestor_trace_is_exact():
    rng = np.random.default_rng(1)
    B, N, n, m = 3, 7, 9, 2
    alpha = rng.normal(size=(B, N, n + 1, m))
    idx = rng.integers(0, N, size=(B, N, n))
    want = jax.vmap(j_ancestor_trace)(jnp.asarray(alpha),
                                      jnp.asarray(idx, jnp.int32))
    got = ancestor_trace(torch.as_tensor(alpha), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # identity ancestors leave the trajectories as they are
    ident = torch.arange(N)[:, None].expand(B, N, n)
    assert torch.equal(ancestor_trace(torch.as_tensor(alpha), ident),
                       torch.as_tensor(alpha))


def _rows(jm, tm, B, seed):
    rng = np.random.default_rng(seed)
    th = np.asarray(jm.theta_init) + 0.3 * rng.normal(size=(B, 2))
    return (th, jax.vmap(jm.build)(jnp.asarray(th)),
            tm.build(torch.as_tensor(th)))


@pytest.mark.parametrize("N", [10, 64])
def test_psi_filter_matches(N):
    """Two rows, each with its own key: log-likelihood, traced trajectories
    and the weights of every generation step."""
    jm, tm = _models(seed=2)
    th, jspec, tspec = _rows(jm, tm, 2, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(N), 2)
    jal = jax.vmap(japprox.approx_loglik)(jspec)
    want = jax.jit(jax.vmap(lambda s, a, k: jparticle.psi_filter(
        s, a, N, k)))(jspec, jal, keys)
    eps, us = _stack([_psi_draws(k, tspec.n, N, 2) for k in keys])
    got = tparticle.psi_filter(tspec, bt.approx_loglik(tspec), N, eps=eps,
                               us=us)
    _close(got.loglik, want.loglik)
    _close(got.alpha, want.alpha)
    _close(got.weights, want.weights)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))


@pytest.mark.parametrize("N", [10, 64])
def test_bsf_filter_matches(N):
    """Two rows of the level-only model (R has one column): log-likelihood
    with the observation constants, untraced trajectories, weights and
    ancestors; a generator-drawn run has the same shapes."""
    jm, tm = _models(seed=4, slope=False)
    rng = np.random.default_rng(5)
    th = np.asarray(jm.theta_init) + 0.3 * rng.normal(size=(2, 1))
    jspec = jax.vmap(jm.build)(jnp.asarray(th))
    tspec = tm.build(torch.as_tensor(th))
    keys = jax.random.split(jax.random.PRNGKey(N + 1), 2)
    want = jax.jit(jax.vmap(lambda s, k: jparticle.bsf_filter(s, N, k)))(
        jspec, keys)
    eps, us = _stack([_bsf_draws(k, tspec.n, N, 1, 1) for k in keys])
    got = tparticle.bsf_filter(tspec, N, eps=eps, us=us)
    _close(got.loglik, want.loglik)
    _close(got.alpha, want.alpha)
    _close(got.weights, want.weights)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    drawn = tparticle.bsf_filter(tspec, N, torch.Generator().manual_seed(1))
    assert drawn.alpha.shape == got.alpha.shape
    assert torch.isfinite(drawn.loglik).all()
    with pytest.raises(ValueError, match="both"):
        tparticle.bsf_filter(tspec, N, eps=eps)


def test_public_api_on_one_model_matches():
    """gaussian_approx, logLik (approximate, psi, bsf), kfilter, the
    smoothers and particle_smoother (psi, bsf) of a non-Gaussian model at
    its initial theta, with the JAX key's draws injected."""
    jm, tm = _models(seed=6)
    n, N = tm.extra["n"], 12
    key = jax.random.PRNGKey(3)
    psi = [torch.as_tensor(x)[None] for x in _psi_draws(key, n, N, 2)]
    bsf = [torch.as_tensor(x)[None] for x in _bsf_draws(key, n, N, 2, 2)]

    g, jg = bt.gaussian_approx(tm), japprox.gaussian_approx(jm)
    for name in ("y", "H"):
        _close(getattr(g, name)[0], getattr(jg, name))
    _close(bt.logLik(tm)[0], jloglik.logLik(jm))
    _close(bt.logLik(tm, N, eps=psi[0], us=psi[1])[0],
           jloglik.logLik(jm, N, key=key))
    _close(bt.logLik(tm, N, method="bsf", eps=bsf[0], us=bsf[1])[0],
           jloglik.logLik(jm, N, method="bsf", key=key))
    kf, jkf = bt.kfilter(tm), jfilters.kfilter(jm)
    for name in ("at", "att", "Pt", "Ptt", "logLik", "vt", "Ft", "Kt"):
        _close(getattr(kf, name)[0], getattr(jkf, name))
    sm, jsm = bt.smoother(tm), jsmoothers.smoother(jm)
    _close(sm.alphahat[0], jsm.alphahat)
    _close(sm.Vt[0], jsm.Vt)
    _close(bt.fast_smoother(tm)[0], jsmoothers.fast_smoother(jm))
    assert bt.sim_smoother(tm, 4, seed=2).shape == (4, n + 1, 2)
    for method, (eps, us) in (("psi", psi), ("bsf", bsf)):
        ps = bt.particle_smoother(tm, N, method=method, eps=eps, us=us)
        jps = jfilters.particle_smoother(jm, N, method=method, key=key)
        for name in ("alphahat", "Vt", "alpha", "weights", "logLik"):
            _close(getattr(ps, name)[0], getattr(jps, name))


def test_one_model_is_unbatched():
    """A model goes to the single-model functions as one unbatched model;
    a spec passes as it is."""
    _, tm = _models(seed=7)
    spec = spec_of(tm)
    assert spec.batch is None and spec.R.dim() == 3
    same = spec_of(tm, torch.as_tensor(tm.theta_init))   # a tensor theta
    assert torch.equal(same.R, spec.R)
    batched = tm.build(torch.as_tensor(np.asarray(tm.theta_init))[None]
                       .expand(3, -1))
    assert spec_of(batched) is batched
    assert bt.logLik(batched).shape == (3,)
    torch.testing.assert_close(bt.logLik(batched)[1], bt.logLik(tm)[0],
                               rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="one model"):
        drop_batch(batched)
