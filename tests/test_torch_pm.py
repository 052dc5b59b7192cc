"""PyTorch port vs the JAX package: the chains that sit on the large-ensemble
particle filters, on the CPU.  One delayed-acceptance step and one
pseudo-marginal step from injected randomness, the is2 correction draw for
draw at 64 particles (psi with two resampling periods, and bootstrap), and
is2 / pm / da end to end within Monte-Carlo error.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng

import bssm_tpu_torch as bt
from bssm_tpu_torch.diagnostics.summary import ess_is, weighted_mean
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.inference.ram import adapt_S


def _series(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    y = y.astype(float)
    y[n // 4] = np.nan
    return y


def _models(n=40, seed=0, slope=True, **kw):
    """The same model on both sides; ``kw`` (a1, P1) goes to both."""
    y = _series(n, seed)
    jkw = dict(sd_level=j_halfnormal(0.1, 1.0), distribution="poisson",
               dtype=jnp.float64, **kw)
    tkw = dict(sd_level=bt.halfnormal_prior(0.1, 1.0),
               distribution="poisson", dtype=torch.float64, device="cpu",
               **kw)
    if slope:
        jkw["sd_slope"] = j_halfnormal(0.01, 0.1)
        tkw["sd_slope"] = bt.halfnormal_prior(0.01, 0.1)
    return jbsm_ng(y, **jkw), bt.bsm_ng(y, **tkw)


def _keyed_draws(key, n, N, m):
    """The draws the JAX package's keyed scan filters make from ``key``:
    ``eps (n+1, N, m)``, ``us (n, N)``."""
    key, k0 = jax.random.split(key)
    u0 = jax.random.normal(k0, (N, m), jnp.float64)
    krkp = jax.vmap(jax.random.split)(jax.random.split(key, n))
    r = jax.vmap(lambda k: jax.random.uniform(k, (N,), jnp.float64))(
        krkp[:, 0])
    um = jax.vmap(lambda k: jax.random.normal(k, (N, m), jnp.float64))(
        krkp[:, 1])
    return jnp.concatenate([u0[None], um]), r


# ---------------------------------------------------------------------------
# single steps from injected randomness
# ---------------------------------------------------------------------------

def test_da_step_matches_numpy_rederivation():
    """``_da_step`` against the delayed-acceptance body of the JAX package
    written out in numpy per chain, with stub log-likelihoods (smooth
    functions of theta) and injected normals and uniforms.  Covers a chain
    whose proposal leaves the prior's support, chains that fail stage 1,
    and chains that pass stage 1 and fail stage 2: rtol 1e-12."""
    rng = np.random.default_rng(3)
    C, d = 12, 2
    theta = rng.normal(size=(C, d))
    S = np.stack([np.linalg.cholesky(np.eye(d) * 0.3
                                     + 0.1 * np.ones((d, d)))] * C)
    u = rng.normal(size=(C, d))
    u[0] = [40.0, 0.0]                       # chain 0 leaves the support
    unif1, unif2 = rng.uniform(size=C), rng.uniform(size=C)

    def f_ll(th):
        return -0.5 * (th ** 2).sum(-1) + 0.3 * np.sin(3 * th[..., 0])

    def f_approx(th):
        return -0.5 * (th ** 2).sum(-1)

    def f_prior(th):
        return np.where(np.abs(th[..., 0]) > 6.0, -np.inf,
                        -0.1 * np.abs(th).sum(-1))

    ll = f_ll(theta) + 0.2 * rng.normal(size=C)     # stored, noisy
    ll_approx = f_approx(theta)
    lp = f_prior(theta)
    calls = []

    def full_eval(th):
        calls.append(th.clone())
        t = th.numpy()
        return torch.as_tensor(f_ll(t)), torch.as_tensor(f_approx(t)), None

    def log_prior(th):
        return torch.as_tensor(f_prior(th.numpy()))

    t = torch.as_tensor
    state = tmcmc.DaState(t(theta), t(lp), t(ll), t(ll_approx), t(S))
    i, target, gamma = 7, 0.234, 2.0 / 3.0
    new, acc = tmcmc._da_step(full_eval, log_prior, state, t(u), t(unif1),
                              t(unif2), i, target, gamma, True)

    n_pass1 = n_acc = 0
    for c in range(C):
        prop = theta[c] + S[c] @ u[c]
        lp_prop = f_prior(prop)
        ok = lp_prop > -np.inf
        lla_prop = f_approx(prop) if ok else -np.inf
        acc_prob = min(1.0, np.exp(lla_prop - ll_approx[c] + lp_prop
                                   - lp[c])) if ok else 0.0
        pass1 = unif1[c] < acc_prob
        accept = False
        ll_prop = -np.inf
        if pass1:
            ll_prop = f_ll(prop)
            accept = np.log(unif2[c]) < (ll_prop + ll_approx[c] - ll[c]
                                         - lla_prop)
        n_pass1 += pass1
        n_acc += accept
        assert bool(acc[c]) == bool(accept), c
        want = (prop, lp_prop, ll_prop, lla_prop) if accept else \
            (theta[c], lp[c], ll[c], ll_approx[c])
        got = (new.theta[c], new.lp_prior[c], new.ll[c], new.ll_approx[c])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12)
        S_ref = adapt_S(t(S[c:c + 1]), t(u[c:c + 1]),
                        t(np.array([acc_prob])), target, i, gamma)
        np.testing.assert_allclose(new.S[c].numpy(), S_ref[0].numpy(),
                                   rtol=1e-12)
    # the cases the step must tell apart all occurred
    assert not bool(acc[0]) and 0 < n_acc < n_pass1 < C
    # the row outside the support was evaluated at its current theta
    assert torch.equal(calls[0][0], t(theta[0]))
    # adapt=False leaves S alone
    kept, _ = tmcmc._da_step(full_eval, log_prior, state, t(u), t(unif1),
                             t(unif2), i, target, gamma, False)
    assert torch.equal(kept.S, state.S)


def test_pm_step_keeps_the_stored_loglik_and_adapts_on_the_approximation():
    """Pseudo-marginal property: a rejected chain keeps the noisy
    log-likelihood it stored and the noisy ``logdens`` is called once a step
    (the current state is never evaluated again).  The RAM adaptation sees
    the acceptance probability of the second returned log-likelihood, the
    accept test the first's."""
    rng = np.random.default_rng(5)
    C, d = 6, 1
    theta = torch.as_tensor(rng.normal(size=(C, d)))
    noise = iter(rng.normal(size=(50, C)))
    calls = []

    def logdens(th):
        calls.append(1)
        clean = -0.5 * (th ** 2).sum(-1)
        return clean + torch.as_tensor(next(noise)), clean, None

    def log_prior(th):
        return torch.zeros(th.shape[0], dtype=th.dtype)

    ll0, llr0, _ = logdens(theta)
    S = 0.8 * torch.eye(d, dtype=torch.float64).expand(C, d, d).clone()
    state = tmcmc.ChainState(theta, log_prior(theta), ll0, None, S, llr0)
    n_rej = 0
    for i in range(1, 9):
        u = torch.as_tensor(rng.normal(size=(C, d)))
        unif = torch.as_tensor(rng.uniform(size=C))
        new, acc = tmcmc._ram_step(logdens, log_prior, state, u, unif, i,
                                   0.234, 2.0 / 3.0, True)
        assert len(calls) == 1 + i
        rej = ~acc
        n_rej += int(rej.sum())
        assert torch.equal(new.ll[rej], state.ll[rej])
        assert torch.equal(new.ll_ram[rej], state.ll_ram[rej])
        assert torch.equal(new.theta[rej], state.theta[rej])
        prop = state.theta + (state.S @ u.unsqueeze(-1)).squeeze(-1)
        clean = -0.5 * (prop ** 2).sum(-1)
        assert torch.equal(new.ll_ram[acc], clean[acc])
        acc_prob = torch.clamp(torch.exp(clean - state.ll_ram), max=1.0)
        np.testing.assert_allclose(
            new.S.numpy(), adapt_S(state.S, u, acc_prob, 0.234, i,
                                   2.0 / 3.0).numpy(), rtol=1e-12)
        state = new
    assert n_rej > 0


# ---------------------------------------------------------------------------
# the is2 correction at 64 particles, draw for draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,kk", [("psi", 1), ("psi", 4), ("bsf", 1),
                                       ("bsf", 4)])
def test_big_correction_matches_draw_for_draw(method, kk):
    """Phase 2 alone at N = 64: the same thetas through the JAX package's
    ``_make_correct_one`` (which reaches its keyed scan filter on the CPU)
    and the port's ``_make_correct_rows`` with that filter's draws rebuilt
    from the key and injected.  log_w atol 1e-8 scaled by 1 + |ref|
    (float64; Laplace solve, factors and filter chained)."""
    n, N, B = 24, 64, 5
    # an informative initial state keeps the bootstrap filter out of the far
    # tail, where the JAX scan (linear weights, which underflow to exactly 0)
    # and the kernel's convention (log-weights, which do not) part ways
    jm, tm = _models(n=n, seed=4, a1=np.array([1.0, 0.0]),
                     P1=np.diag([1.0, 0.01]))
    rng = np.random.default_rng(6)
    thetas = np.asarray(jm.theta_init) + 0.3 * rng.normal(size=(B, 2))
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    correct_one = jmcmc._make_correct_one(
        jm, N, method, want_states=False, want_moments=False,
        psi_resample_every=kk)
    modes = jnp.zeros((B, 1))                # not stored: recompute
    ref = np.asarray(jax.vmap(
        lambda t, m, k: correct_one((t, m, k))["log_w"])(
            jnp.asarray(thetas), modes, keys))
    k_pf = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    eps, us = jax.vmap(lambda k: _keyed_draws(k, n, N, 2))(k_pf)
    eps, us = np.array(eps), np.array(us)
    if method == "bsf":
        eps = np.ascontiguousarray(eps[:, :n])
        us = np.ascontiguousarray(us[:, :n - 1])
    correct_rows = tmcmc._make_correct_rows(tm, N, method,
                                            psi_resample_every=kk)
    got = correct_rows(torch.as_tensor(thetas), None, None,
                       eps=torch.as_tensor(eps),
                       us=torch.as_tensor(us))["log_w"].numpy()
    assert np.isfinite(ref).all()
    assert (np.abs(got - ref) <= 1e-8 * (1 + np.abs(ref))).all(), (got, ref)


# ---------------------------------------------------------------------------
# end to end, within Monte-Carlo error
# ---------------------------------------------------------------------------

def _stats(out):
    """Pooled weighted posterior means, their Monte-Carlo standard errors
    from the spread of the per-chain means, acceptance, ESS_IS fraction."""
    C, _, d = out.theta.shape
    w = out.weights if out.weights is not None else np.ones(
        out.theta.shape[:2])
    means = np.array([[weighted_mean(out.theta[c, :, j], w[c])
                       for j in range(d)] for c in range(C)])
    fw = w.reshape(-1)
    pooled = np.array([weighted_mean(out.flat_theta()[:, j], fw)
                       for j in range(d)])
    se = means.std(axis=0, ddof=1) / np.sqrt(C)
    return pooled, se, out.acceptance_rate, ess_is(fw) / fw.size


def _agree(jout, tout, acc_tol):
    jmean, jse, jacc, jess = _stats(jout)
    tmean, tse, tacc, tess = _stats(tout)
    z = np.abs(jmean - tmean) / np.sqrt(jse ** 2 + tse ** 2)
    assert (z < 4.0).all(), (jmean, tmean, jse, tse)
    assert abs(jacc - tacc) < acc_tol, (jacc, tacc)
    return jess, tess


def _big_kw(method, kk):
    return dict(iter=300, particles=64, mcmc_type="is2",
                sampling_method=method, output_type="theta", n_chains=8,
                seed=3, psi_resample_every=kk)


@pytest.fixture(scope="module")
def big_is2():
    """The models of the is2 cases and the port's is2/psi run at period 4.
    Its phase-1 chain is the other cases' too (one seed, and phase 1 does
    not depend on the correction), so they correct it by ``post_correct``
    with ``run_mcmc``'s correction generator, which gives what their own
    ``run_mcmc`` would, bit for bit (held below on a short run), without
    running the chain again."""
    jm, tm = _models(n=30, seed=8, a1=np.array([1.0, 0.0]),
                     P1=np.diag([1.0, 0.01]))
    return jm, tm, bt.run_mcmc(tm, device="cpu", **_big_kw("psi", 4))


@pytest.mark.parametrize("method,kk,ess_min", [("psi", 1, 0.9),
                                               ("psi", 4, 0.9),
                                               ("bsf", 1, 0.0)])
def test_is2_big_end_to_end_matches_within_monte_carlo_error(big_is2, method,
                                                             kk, ess_min):
    """run_mcmc(is2, N = 64) on both sides with different random streams:
    weighted posterior means within 4 combined Monte-Carlo standard errors,
    acceptance within 0.08, ESS_IS fractions above 0.9 for the psi filter
    and within 0.15 of each other for the bootstrap filter (whose weights
    carry the filter's own noise)."""
    jm, tm, base = big_is2
    kw = _big_kw(method, kk)
    jout = jmcmc.run_mcmc(jm, **kw)
    if (method, kk) == ("psi", 4):
        tout = base
    else:                   # run_mcmc's output, without a second chain
        tout = bt.post_correct(tm, base, 64, sampling_method=method,
                               output_type="theta",
                               generator=bt.is_correction_generator(3, "cpu"))
        # the replay this relies on: run_mcmc against approx + post_correct
        short = {**kw, "iter": 10, "n_chains": 2}
        run = bt.run_mcmc(tm, device="cpu", **short)
        ap = bt.run_mcmc(tm, device="cpu", **{**short, "mcmc_type": "approx"})
        pc = bt.post_correct(tm, ap, 64, sampling_method=method,
                             output_type="theta",
                             generator=bt.is_correction_generator(3, "cpu"))
        np.testing.assert_array_equal(pc.weights, run.weights)
        np.testing.assert_array_equal(pc.posterior, run.posterior)
    assert tout.theta.shape == jout.theta.shape == (8, 150, 2)
    assert np.isfinite(tout.posterior).all()
    jess, tess = _agree(jout, tout, 0.08)
    assert jess > ess_min and tess > ess_min, (jess, tess)
    assert abs(jess - tess) < 0.15, (jess, tess)


@pytest.mark.parametrize("mcmc_type,method", [("pm", "bsf"), ("pm", "psi"),
                                              ("da", "psi")])
def test_pm_da_end_to_end_match_within_monte_carlo_error(mcmc_type, method):
    """run_mcmc(pm / da) on both sides, 12 chains x 300 iterations, 40
    particles: posterior means within 4 combined Monte-Carlo standard
    errors and acceptance within 0.1."""
    jm, tm = _models(n=24, seed=9, slope=False, a1=np.array([1.0]),
                     P1=np.array([[1.0]]))
    kw = dict(iter=300, particles=40, mcmc_type=mcmc_type,
              sampling_method=method, output_type="theta", n_chains=12,
              seed=5)
    jout = jmcmc.run_mcmc(jm, **kw)
    tout = bt.run_mcmc(tm, device="cpu", **kw)
    assert tout.theta.shape == jout.theta.shape == (12, 150, 1)
    assert tout.weights is None and tout.mcmc_type == mcmc_type
    assert np.isfinite(tout.posterior).all()
    assert set(tout.time) == {"mcmc"}
    _agree(jout, tout, 0.1)
    assert 0.05 < tout.acceptance_rate < 0.6


def test_pm_da_options_and_limits():
    """da with the bootstrap filter runs, and so do pm with state output, da
    with SPDK and pm above 512 particles; what this package does not serve
    yet raises and names it."""
    _, tm = _models(n=16, seed=10, slope=False)
    out = bt.run_mcmc(tm, iter=30, particles=34, mcmc_type="da",
                      sampling_method="bsf", n_chains=3, device="cpu")
    assert out.theta.shape == (3, 15, 1) and np.isfinite(out.posterior).all()
    for kw in (dict(mcmc_type="pm", output_type="full"),
               dict(mcmc_type="da", sampling_method="spdk"),
               dict(mcmc_type="pm", particles=600)):
        out = bt.run_mcmc(tm, **{**dict(iter=10, particles=8, n_chains=2,
                                        device="cpu"), **kw})
        assert np.isfinite(out.posterior).all()
        assert (out.alpha is not None) == (kw.get("output_type") == "full")
    for kw in (dict(mcmc_type="pm", output_type="summary"),
               dict(mcmc_type="da", sampling_method="bogus"),
               dict(mcmc_type="ekf")):
        with pytest.raises(NotImplementedError):
            bt.run_mcmc(tm, **{**dict(iter=10, particles=8, device="cpu"),
                               **kw})
    with pytest.raises(ValueError, match="particles"):
        bt.run_mcmc(tm, iter=10, mcmc_type="pm", device="cpu")
    with pytest.raises(ValueError, match="psi_resample_every"):
        bt.run_mcmc(tm, iter=10, particles=8, psi_resample_every=0,
                    device="cpu")
