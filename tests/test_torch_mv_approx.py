"""PyTorch port vs the JAX package: the Laplace approximation, the particle
filters and SPDK of multivariate non-Gaussian models
(``inference/approx_mv.py``), float64 on the CPU.

Two models, built by both packages from the same numpy arrays: Poisson +
Gaussian (the zoo's ``ssm_mng``) and binomial + negative binomial + gamma
over two states, each with a partly missing row and a wholly missing time
point.  Rows differ in theta (R = exp(theta) R0, through each package's
update function).  The deterministic parts agree to 1e-9; the filters and
SPDK exactly (to roundoff) on the normals and uniforms the JAX functions
draw from their keys, handed to the port.  The approximate run's state
draws are the JAX composition ``approximate_for_is_mv`` +
``simulate_states_mv`` (the JAX package's own ``run_mcmc`` fails there),
and an mng with one series equals the port's ``ssm_ung``.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.inference import approx_mv as japx
from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.models.ssm import ssm_mng as j_ssm_mng
from bssm_tpu.ops import kalman_mv as jkmv

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import approx_mv as tapx

from test_torch_filters import _bsf_draws, _psi_draws
from test_torch_mv_kalman import _sim_draws

TOL = 1e-9
F64 = jnp.float64


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def mv_data(kind, n=30, seed=0):
    """``(y, ssm_mng keyword arguments)`` of one of the two models."""
    rng = np.random.default_rng(seed)
    lvl = np.cumsum(rng.normal(0, 0.1, size=(n, 2)), axis=0)
    if kind == "pois_gauss":
        y = np.column_stack([rng.poisson(np.exp(lvl[:, 0] + 1.0)),
                             lvl[:, 1] + rng.normal(0, 0.5, n)])
        y[4, 0] = np.nan
        y[n // 2, 0] = np.nan
        kw = dict(Z=np.eye(2), T=0.95 * np.eye(2), R=0.2 * np.eye(2),
                  distributions=["poisson", "gaussian"],
                  phi=np.array([1.0, 0.5]), P1=np.eye(2))
    else:
        u = np.column_stack([np.full(n, 10.0), np.ones(n), np.ones(n)])
        sig = np.column_stack([lvl[:, 0], lvl[:, 1] + 1.0,
                               0.5 * (lvl[:, 0] + lvl[:, 1])])
        y = np.column_stack([
            rng.binomial(10, 1.0 / (1.0 + np.exp(-sig[:, 0]))),
            rng.negative_binomial(3.0, 3.0 / (3.0 + np.exp(sig[:, 1]))),
            rng.gamma(2.0, np.exp(sig[:, 2]) / 2.0)]).astype(float)
        y[3, 1] = np.nan
        y[n // 2, :] = np.nan
        kw = dict(Z=np.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]]),
                  T=0.9 * np.eye(2), R=0.2 * np.eye(2),
                  distributions=["binomial", "negative binomial", "gamma"],
                  phi=np.array([1.0, 3.0, 2.0]), u=u, a1=[0.0, 1.0],
                  P1=0.5 * np.eye(2))
    return y.astype(float), kw


def models(kind, n=30, seed=0, dtype=torch.float64):
    """The JAX and the port's model: R = exp(theta) R0, theta ~ N(0, 1)
    a priori (the zoo's ``ssm_mng`` form)."""
    y, kw = mv_data(kind, n, seed)
    R0 = kw["R"]
    jm = j_ssm_mng(y, **kw, init_theta=(0.0,),
                   update_fn=lambda th: {"R": jnp.exp(th[0]) * R0[None]},
                   prior_fn=lambda th: -0.5 * jnp.sum(jnp.square(th)))
    R0t = torch.as_tensor(R0, dtype=dtype)
    tm = bt.ssm_mng(y, **kw, init_theta=(0.0,),
                    update_fn=lambda th: {
                        "R": torch.exp(th[:, 0])[:, None, None, None] * R0t},
                    prior_fn=lambda th: -0.5 * (th ** 2).sum(-1),
                    dtype=dtype, device="cpu")
    return jm, tm


THETAS = np.array([[0.0], [-0.4], [0.5]])


@pytest.fixture(scope="module", params=["pois_gauss", "binom_negbin_gamma"])
def built(request):
    """(kind, JAX spec rows, port spec rows, JAX approximation rows)."""
    jm, tm = models(request.param)
    jspec = jax.vmap(jm.build)(jnp.asarray(THETAS))
    tspec = tm.build(torch.as_tensor(THETAS))
    jal = jax.jit(jax.vmap(japx.approx_loglik_mv))(jspec)
    return request.param, jspec, tspec, jal


def test_laplace_approximation_matches(built):
    """Mode, pseudo-observations, passes and the approximate
    log-likelihood with its scales, per row."""
    _, jspec, tspec, jal = built
    tal = tapx.approx_loglik_mv(tspec)
    _close(tal.approx.mode, jal.approx.mode)
    _close(tal.approx.ytilde, jal.approx.ytilde)
    _close(tal.approx.Htilde, jal.approx.Htilde)
    np.testing.assert_array_equal(tal.approx.niter.numpy(),
                                  np.asarray(jal.approx.niter))
    _close(tal.approx.gloglik, jal.approx.gloglik)
    _close(tal.scales, jal.scales)
    _close(tal.loglik, jal.loglik)
    # rebuilt at the stored modes, as the correction rebuilds it
    jre = jax.vmap(japx.approximate_for_is_mv)(jspec, jal.approx.mode)
    tre = tapx.approximate_for_is_mv(tspec, tal.approx.mode)
    _close(tre.approx.ytilde, jre.approx.ytilde)
    _close(tre.approx.Htilde, jre.approx.Htilde)
    _close(tre.scales, jre.scales)
    assert (tre.loglik == 0).all()


def test_psi_and_bsf_filters_match(built, N=7):
    """Three rows, each with its own key: log-likelihood, trajectories,
    weights and ancestors of both filters; the psi estimate without the
    trajectories is the same number."""
    _, jspec, tspec, jal = built
    n, m, k = tspec.n, tspec.m, tspec.k
    keys = jax.random.split(jax.random.PRNGKey(N), 3)
    tal = tapx.approx_loglik_mv(tspec)
    want = jax.jit(jax.vmap(lambda s, a, kk: japx.psi_filter_mv(
        s, a, N, kk)))(jspec, jal, keys)
    eps, us = (torch.as_tensor(np.stack(x)) for x in zip(
        *[_psi_draws(kk, n, N, m) for kk in keys]))
    got = tapx.psi_filter_mv(tspec, tal, N, eps=eps, us=us)
    _close(got.loglik, want.loglik)
    _close(got.alpha, want.alpha)
    _close(got.weights, want.weights)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    ll = tapx.psi_filter_mv(tspec, tal, N, eps=eps, us=us, keep_paths=False)
    assert torch.equal(ll, got.loglik)
    want = jax.jit(jax.vmap(lambda s, kk: japx.bsf_filter_mv(s, N, kk)))(
        jspec, keys)
    eps, us = (torch.as_tensor(np.stack(x)) for x in zip(
        *[_bsf_draws(kk, n, N, m, k) for kk in keys]))
    got = tapx.bsf_filter_mv(tspec, N, eps=eps, us=us)
    _close(got.loglik, want.loglik)
    _close(got.alpha, want.alpha)
    _close(got.weights, want.weights)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))


def test_spdk_matches(built):
    """SPDK's draws, weights and estimate on the simulation smoother's
    normals (antithetic, 6 draws)."""
    _, jspec, tspec, jal = built
    n, p, m, k = tspec.n, tspec.p, tspec.m, tspec.k
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    want = jax.jit(jax.vmap(lambda s, a, kk: japx.spdk_sample_mv(
        s, a, 6, kk)))(jspec, jal, keys)
    um, eps, eta = (torch.as_tensor(np.stack(x)) for x in zip(
        *[_sim_draws(kk, 6, True, n, p, m, k) for kk in keys]))
    got = tapx.spdk_sample_mv(tspec, tapx.approx_loglik_mv(tspec), 6,
                              um=um, eps=eps, eta=eta)
    _close(got.loglik, want[0])
    _close(got.alpha, want[1])
    _close(got.weights, want[2])


def test_approx_state_draws_are_the_jax_composition(built):
    """mcmc_type="approx" with full output: one draw from the
    approximating model rebuilt at the stored mode, against the JAX
    package's ``approximate_for_is_mv`` + ``simulate_states_mv`` on the
    same normals (its ``run_mcmc`` raises AttributeError there)."""
    _, jspec, tspec, jal = built
    n, p, m, k = tspec.n, tspec.p, tspec.m, tspec.k
    keys = jax.random.split(jax.random.PRNGKey(4), 3)

    def one(s, mode, kk):
        g = japx.approximate_for_is_mv(s, mode).approx.gaussian(s)
        return jkmv.simulate_states_mv(g, 1, kk, use_antithetic=False)[0]

    want = jax.jit(jax.vmap(one))(jspec, jal.approx.mode, keys)
    um, eps, eta = (torch.as_tensor(np.stack(x)) for x in zip(
        *[_sim_draws(kk, 1, False, n, p, m, k) for kk in keys]))
    got = tapx.approx_state_draws_mv(tspec, torch.as_tensor(
        np.array(jal.approx.mode)), um=um, eps=eps, eta=eta)
    _close(got, want)


def test_global_approximation_matches(built):
    """``local_approx=False``: the frozen pseudo-observations at the
    initial theta and one smoother pass per row, against the JAX
    package's global ``approx_eval``."""
    kind, jspec, tspec, _ = built
    jm, tm = models(kind)
    ops = jmcmc._family_ops(jm, 1e-8, 100, local_approx=False)
    want_ll, want_mode = jax.vmap(lambda s: ops.approx_eval(
        s, jax.random.PRNGKey(0)))(jspec)
    ga = tapx.global_approximation_mv(tm)
    ll, mode = tapx.global_approx_loglik_mv(tspec, ga)
    _close(mode, want_mode)
    _close(ll, want_ll)


def test_mng_p1_equals_ung():
    """An mng with one Poisson series equals the port's ``ssm_ung`` of
    the same series: the approximation and the psi filter on the same
    draws (the JAX package's ``test_mng_p1_equals_ung`` for the port)."""
    rng = np.random.default_rng(8)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, 0.1, 40)) + 1.0))
    y = y.astype(float)
    y[[5, 20]] = np.nan
    kw = dict(T=np.array([[1.0, 1.0], [0.0, 1.0]]),
              R=np.diag([0.1, 0.01]), P1=np.eye(2), init_theta=(0.0,),
              dtype=torch.float64, device="cpu")
    upd = lambda th: {"R": torch.exp(th[:, 0])[:, None, None, None]  # noqa
                      * torch.diag(torch.tensor([0.1, 0.01],
                                                dtype=torch.float64))}
    ung = bt.ssm_ung(y, Z=np.array([1.0, 0.0]), distribution="poisson",
                     update_fn=upd, **kw)
    mng = bt.ssm_mng(y[:, None], Z=np.array([[1.0, 0.0]]),
                     distributions="poisson", update_fn=upd, **kw)
    th = torch.as_tensor(THETAS)
    su, sm = ung.build(th), mng.build(th)
    au = bt.approx_loglik(su)
    am = tapx.approx_loglik_mv(sm)
    _close(am.loglik, au.loglik, 1e-10)
    _close(am.approx.mode[..., 0], au.approx.mode, 1e-10)
    _close(am.scales, au.scales, 1e-10)
    gen = torch.Generator().manual_seed(2)
    eps = torch.randn((3, 41, 10, 2), generator=gen, dtype=torch.float64)
    us = torch.rand((3, 40, 10), generator=gen, dtype=torch.float64)
    pu = bt.psi_filter(su, au, 10, eps=eps, us=us)
    pm = tapx.psi_filter_mv(sm, am, 10, eps=eps, us=us)
    _close(pm.loglik, pu.loglik, 1e-10)
    _close(pm.alpha, pu.alpha, 1e-10)
    bu = bt.bsf_filter(su, 10, eps=eps, us=us)
    bm = tapx.bsf_filter_mv(sm, 10, eps=eps, us=us)
    _close(bm.loglik, bu.loglik, 1e-10)
