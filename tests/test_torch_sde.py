"""PyTorch port vs the JAX package: the SDE models (``models/sde.py``) and
their bootstrap filter (``inference/sde.py``), exact parts, on the CPU in
float64.

The JAX package draws its Brownian increments and resampling uniforms from
threefry keys; ``jax_draws`` rebuilds the tensors that its
``bsf_filter_sde`` derives from one key, and the port's stream mode is fed
them.  Milstein steps and paths agree to 1e-12, the filter to 1e-10 on
the log-likelihood and the states, exactly on the ancestors and to 1e-12
on the weights.  The seeded mode (Philox keyed by a per-row seed) exists in
the port only: a coarse and a fine run of one seed share their Brownian
path (coarse increments the sums of fine ones) and their resampling
uniforms.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.inference import filters as jfilters
from bssm_tpu.inference import loglik as jloglik
from bssm_tpu.inference import sde as jisde
from bssm_tpu.models import sde as jsde

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import sde as tisde
from bssm_tpu_torch.models import sde as tsde

KW = dict(dtype=torch.float64, device="cpu")


def gbm_series(n=12, seed=0):
    """A GBM path's log plus noise (the JAX package's ``tests/test_sde.py``
    simulation), one value missing."""
    rng = np.random.default_rng(seed)
    x, y = 1.0, np.zeros(n)
    for t in range(n):
        x = x * np.exp((0.05 - 0.5 * 0.04) + 0.2 * rng.normal())
        y[t] = np.log(x) + 1.5 * rng.normal()
    y[4] = np.nan
    return y


def increments(keys, gen_L):
    """The increments JAX's ``milstein`` draws from each key, ``(K,
    2^gen_L)``."""
    nf = 2 ** gen_L
    return jax.vmap(lambda k: jnp.sqrt(1.0 / nf) * jax.random.normal(
        k, (nf,), jnp.float64))(keys)


def jax_draws(key, nsim, n, gen_L):
    """The draws of JAX's ``bsf_filter_sde(spec, nsim, L, key, ...)``
    generating at ``gen_L``: increments ``(n+1, nsim, 2^gen_L)`` and
    resampling uniforms ``(n, nsim)``."""
    key, k0 = jax.random.split(key)
    dB = [increments(jax.random.split(k0, nsim), gen_L)]
    us = []
    for kt in jax.random.split(key, n):
        kr, kp = jax.random.split(kt)
        us.append(jax.random.uniform(kr, (nsim,), jnp.float64))
        dB.append(increments(jax.random.split(kp, nsim), gen_L))
    return jnp.stack(dB), jnp.stack(us)


def draws_of(keys, nsim, n, gen_L):
    """``jax_draws`` of each key, stacked, as torch tensors."""
    d, u = jax.jit(jax.vmap(lambda k: jax_draws(k, nsim, n, gen_L)))(keys)
    return torch.as_tensor(np.array(d)), torch.as_tensor(np.array(u))


def models(y, L_f, L_c):
    return {"gbm": (jsde.sde_gbm(y, L_f=L_f, L_c=L_c),
                    tsde.sde_gbm(y, L_f=L_f, L_c=L_c, **KW)),
            "ou": (jsde.sde_poisson_ou(y, L_f=L_f, L_c=L_c),
                   tsde.sde_poisson_ou(y, L_f=L_f, L_c=L_c, **KW))}


THETA = {"gbm": np.array([0.05, 0.3, 1.5]),
         "ou": np.array([np.log(0.5), 0.2, np.log(0.3)])}


@pytest.mark.parametrize("name", ["gbm", "ou"])
def test_milstein_matches_jax(name):
    """``milstein_step``, ``milstein`` (gen_L = L and gen_L > L) and
    ``milstein_coupled`` on JAX's increments, ``positive`` True (gbm) and
    False (ou), to 1e-12."""
    jm, tm = models(np.zeros(1), 5, 2)[name]
    th = THETA[name]
    js = jm.build(jnp.asarray(th))
    ts = tm.build(torch.as_tensor(th))
    K = 24
    rows = torch.as_tensor(np.tile(th, (K, 1)))
    rng = np.random.default_rng(3)
    x0 = rng.uniform(0.2, 2.0, K)
    dB = rng.normal(0, 0.3, K)
    got = tsde.milstein_step(torch.as_tensor(x0), torch.as_tensor(dB), 0.25,
                             rows, ts)
    ref = jax.vmap(lambda x, b: jsde.milstein_step(x, b, 0.25, js.theta,
                                                   js))(x0, dB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    keys = jax.random.split(jax.random.PRNGKey(11), K)
    for L, gen_L in ((3, 3), (2, 5)):
        dBf = torch.as_tensor(np.array(increments(keys, gen_L)))
        got = tsde.milstein(ts, torch.as_tensor(x0), L, gen_L, dBf=dBf,
                            theta=rows)
        ref = jax.vmap(lambda k, x: jsde.milstein(js, x, k, L,
                                                  gen_L=gen_L))(keys, x0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)
    xf, xc = tsde.milstein_coupled(ts, torch.as_tensor(x0),
                                   torch.as_tensor(x0[::-1].copy()),
                                   dBf=torch.as_tensor(np.array(
                                       increments(keys, 5))),
                                   theta=rows)
    rf, rc = jax.vmap(lambda k, a, b: jsde.milstein_coupled(js, a, b, k))(
        keys, x0, x0[::-1].copy())
    np.testing.assert_allclose(xf.numpy(), np.asarray(rf), rtol=0, atol=1e-12)
    np.testing.assert_allclose(xc.numpy(), np.asarray(rc), rtol=0, atol=1e-12)


def test_example_functions_and_priors():
    """The model functions and priors of ``sde_gbm`` and ``sde_poisson_ou``
    row by row against the JAX package's, to 1e-12; gbm's prior is -inf
    outside its support and its density takes log max(x, 1e-300)."""
    rng = np.random.default_rng(5)
    R = 40
    x = rng.normal(0.5, 1.0, R)
    x[:3] = [0.0, -0.5, 1e-200]
    ys = {"gbm": rng.normal(0, 1, R), "ou": rng.poisson(2.0, R) * 1.0}
    ths = {"gbm": np.column_stack([rng.normal(0.05, 0.1, R),
                                   rng.normal(0.3, 0.3, R),
                                   rng.uniform(0.3, 2.0, R)]),
           "ou": rng.normal([-0.5, 0.2, -1.0], 0.5, (R, 3))}
    for name, (jm, tm) in models(np.zeros(1), 5, 2).items():
        th, yv = ths[name], ys[name]
        js, ts = jm.build(jnp.asarray(th[0])), tm.build(torch.as_tensor(th))
        tt, tx, ty = (torch.as_tensor(a) for a in (th, x, yv))
        for f in ("drift", "diffusion", "ddiffusion"):
            got = getattr(ts, f)(tx, tt)
            ref = jax.vmap(getattr(js, f))(x, th)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=1e-12, err_msg=f"{name} {f}")
        got = ts.log_obs_density(ty, tx, tt)
        ref = jax.vmap(js.log_obs_density)(yv, x, th)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12, err_msg=f"{name} obs")
        got = tm.log_prior(tt)
        ref = np.asarray(jax.vmap(jm.log_prior)(jnp.asarray(th)))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12,
                                   err_msg=f"{name} prior")
        if name == "gbm":
            assert np.isneginf(ref).any() and np.isfinite(ref).any()


def _stream(y, rows, N, L, couple):
    """JAX's filter on each row of theta from its own key (one jitted
    vmap), and the port's stream mode on those draws, batched."""
    jm, tm = models(y, 4, 2)["gbm"]
    keys = jax.random.split(jax.random.PRNGKey(10), len(rows))
    refs = jax.jit(jax.vmap(lambda th, k: jisde.bsf_filter_sde(
        jm.build(th), N, L, k, couple=couple)))(jnp.asarray(rows), keys)
    dBf, us = draws_of(keys, N, len(y), 4 if couple else L)
    got = tisde.bsf_filter_sde(tm.build(torch.as_tensor(rows)), N, L, couple,
                               dBf=dBf, us=us)
    return refs, got


@pytest.mark.parametrize("couple,L", [(False, 4), (True, 2)])
def test_bsf_filter_stream_matches_jax(couple, L):
    """Three rows of theta, the last with sigma_y so small that every
    weight underflows (log-likelihood -inf, uniform weights), a missing
    observation; the fine filter and the coarse one generating at L_f."""
    rows = np.array([[0.05, 0.3, 1.5], [0.1, 0.5, 1.0], [0.05, 0.3, 1e-160]])
    ref, got = _stream(gbm_series(), rows, 8, L, couple)
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(ref.loglik),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               rtol=0, atol=1e-12)
    assert np.isneginf(float(got.loglik[2]))
    np.testing.assert_array_equal(got.weights[2].numpy(), 1.0 / 8)


def test_seeded_mode_couples_levels():
    """One seed: the coarse increments are the sums of the fine ones, the
    uniforms do not depend on the level, a slot's draws not on the particle
    count; a coarse (couple) and a fine run consume exactly those draws,
    and a second call gives the same result."""
    y = gbm_series()
    n = len(y)
    _, tm = models(y, 4, 2)["gbm"]
    spec = tm.build(torch.as_tensor(np.array([[0.05, 0.3, 1.5],
                                              [0.1, 0.4, 1.2]])))
    seeds = tisde.new_seeds(2, "cpu", torch.Generator().manual_seed(9))
    fine, us = tisde.philox_draws(seeds, 8, 4, 0, n + 1, torch.float64)
    coarse_own, us_c = tisde.philox_draws(seeds, 8, 2, 0, n + 1,
                                          torch.float64)
    torch.testing.assert_close(us_c, us, rtol=0, atol=0)
    summed = tsde.coarsen(fine, 2)
    assert summed.shape == coarse_own.shape
    assert (summed - coarse_own).abs().max() > 0.1   # other draws at L_c
    fewer, us4 = tisde.philox_draws(seeds, 4, 4, 0, n + 1, torch.float64)
    torch.testing.assert_close(fewer, fine[:, :, :4], rtol=0, atol=0)
    torch.testing.assert_close(us4, us[:, :, :4], rtol=0, atol=0)
    # the increments are N(0, 1/16) per fine step
    z = fine.reshape(-1) * 4.0
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1) < 0.05
    for L, couple in ((2, True), (4, False), (4, True)):
        seeded = tisde.bsf_filter_sde(spec, 8, L, couple, seeds=seeds)
        stream = tisde.bsf_filter_sde(spec, 8, L, couple, dBf=fine,
                                      us=us[:, 1:])
        again = tisde.bsf_filter_sde(spec, 8, L, couple, seeds=seeds)
        for a, b in ((seeded, stream), (seeded, again)):
            torch.testing.assert_close(a.loglik, b.loglik, rtol=0, atol=0)
            torch.testing.assert_close(a.alpha, b.alpha, rtol=0, atol=0)
            torch.testing.assert_close(a.indices, b.indices, rtol=0, atol=0)
    # seeded draws made in blocks of intervals equal those made at once
    whole = tisde.bsf_filter_sde(spec, 8, 2, True, seeds=seeds)
    old = tisde.BLOCK_COUNTERS
    try:
        tisde.BLOCK_COUNTERS = 2 * 8 * 5 * 3      # three intervals a block
        blocked = tisde.bsf_filter_sde(spec, 8, 2, True, seeds=seeds)
    finally:
        tisde.BLOCK_COUNTERS = old
    torch.testing.assert_close(blocked.alpha, whole.alpha, rtol=0, atol=0)


def test_loglik_and_bootstrap_filter_match_jax():
    """``logLik`` (fine level, max(particles, 2) particles: 1 runs 2) and
    ``bootstrap_filter`` of one model at theta_init against the JAX
    package's on its own key's draws; seeded, from ``seed``."""
    y = gbm_series()
    jm, tm = models(y, 4, 2)["gbm"]
    key = jax.random.PRNGKey(1)
    d, u = draws_of(key[None], 2, len(y), 4)
    ref = float(jloglik.logLik(jm, 1, key=key))
    got = bt.logLik(tm, 1, dBf=d, us=u)
    np.testing.assert_allclose(float(got[0]), ref, rtol=1e-10, atol=1e-10)
    ref = jfilters.bootstrap_filter(jm, 2, key=key)
    got = bt.bootstrap_filter(tm, 2, dBf=d, us=u)
    np.testing.assert_allclose(float(got.loglik[0]), float(ref.loglik),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.alpha[0].numpy(), np.asarray(ref.alpha),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.indices[0].numpy(),
                                  np.asarray(ref.indices))
    seeded = bt.bootstrap_filter(tm, 6, seed=3)
    assert seeded.alpha.shape == (1, 6, len(y) + 1, 1)
    torch.testing.assert_close(bt.logLik(tm, 6, seed=3), seeded.loglik,
                               rtol=0, atol=0)


def test_api_refuses_what_the_jax_package_fails_on():
    """The single-model functions that the JAX package's fail on with an
    SDE model (``ROADMAP.md``, known faults of the reference) raise a
    ``ValueError`` in the port, and so do approx with full output,
    ``local_approx=False`` and a psi correction."""
    _, tm = models(gbm_series(), 3, 1)["gbm"]
    calls = [lambda: bt.particle_smoother(tm, 4), lambda: bt.kfilter(tm),
             lambda: bt.smoother(tm), lambda: bt.fast_smoother(tm),
             lambda: bt.sim_smoother(tm, 2), lambda: bt.ekf(tm),
             lambda: bt.ukf(tm), lambda: bt.importance_sample(tm, 4),
             lambda: bt.gaussian_approx(tm), lambda: bt.suggest_N(tm)]
    kw = dict(iter=4, particles=4, n_chains=2, device="cpu")
    calls += [lambda: bt.run_mcmc(tm, mcmc_type="approx", output_type="full",
                                  **kw),
              lambda: bt.run_mcmc(tm, local_approx=False, **kw)]
    out = bt.run_mcmc(tm, output_type="full", **kw)
    calls += [lambda: bt.predict(out, tm, "mean", nsim=4),
              lambda: bt.fitted(out, tm),
              lambda: bt.post_correct(tm, out, 4, sampling_method="psi")]
    for call in calls:
        with pytest.raises(ValueError):
            call()
