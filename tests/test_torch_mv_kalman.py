"""PyTorch port vs the JAX package: the multivariate Kalman filter and
smoothers (``ops/kalman_mv.py``), ``dmvnorm`` and the Cholesky helpers
they need, in float64 on the CPU.

The models have time-varying Z and H, some rows partly missing (one series
NaN) and one row wholly missing.  The JAX functions take one model and are
mapped over the rows with ``vmap``; the port takes the rows as its batch
axis.  Both sides run the same recursions, summed in another order, so the
results agree to rtol 1e-10.  Lb is a square-root factor: at m = 3 the
eigenvector signs of the two eigensolvers may differ, so Lb Lb' is
compared there.  The simulation smoother is compared draw for draw: the
normals the JAX function draws from its keys are handed to the port.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.spec import MVLGSpec as JMVLGSpec
from bssm_tpu.ops import chol as jchol
from bssm_tpu.ops import dmvnorm as jdmv
from bssm_tpu.ops import kalman_mv as jkmv

from bssm_tpu_torch.convert import mvlgspec_from_numpy
from bssm_tpu_torch.core.spec import MVLGSpec
from bssm_tpu_torch.ops import chol as tchol
from bssm_tpu_torch.ops import dmvnorm as tdmv
from bssm_tpu_torch.ops import kalman_mv as tkmv

RTOL = 1e-10


def _mv_arrays(seed, n, p, m, batch):
    """Rows of a multivariate model in the JAX spec layout: Z and H vary
    in time, y has partly missing rows and one missing time point."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(batch, n, p)).cumsum(1)
    y[:, 2, 0] = np.nan
    y[:, n // 2, :] = np.nan
    y[:, n - 3, p - 1] = np.nan
    Z = 0.5 * rng.normal(size=(batch, n, p, m)) + 1.0
    H = np.tril(0.2 * rng.normal(size=(batch, n, p, p))) \
        + 0.6 * np.eye(p)
    A = rng.normal(size=(batch, m, m))
    T = (0.85 * np.eye(m) + 0.05 * A)[:, None]
    R = 0.4 * rng.normal(size=(batch, 1, m, m))
    a1 = rng.normal(size=(batch, m))
    P = rng.normal(size=(batch, m, m))
    P1 = np.einsum('bij,bkj->bik', P, P) + np.eye(m)
    D = 0.3 * rng.normal(size=(batch, 1, p))
    C = 0.1 * rng.normal(size=(batch, 1, m))
    return dict(y=y, Z=Z, H=H, T=T, R=R, a1=a1, P1=P1, D=D, C=C)


def _both(d):
    j = JMVLGSpec(**{k: jnp.asarray(v) for k, v in d.items()})
    t = mvlgspec_from_numpy(d, device="cpu", dtype=torch.float64)
    assert isinstance(t, MVLGSpec)
    return j, t


def _jv(fn):
    """The JAX function mapped over the rows, compiled once."""
    return jax.jit(jax.vmap(fn))


def _close(got, want, rtol=RTOL, atol=1e-10):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def models():
    """(p, m) -> (JAX spec, port spec) of three rows."""
    return {pm: _both(_mv_arrays(3 + pm[0] + pm[1], 25, pm[0], pm[1], 3))
            for pm in ((2, 2), (3, 3))}


@pytest.mark.parametrize("pm", [(2, 2), (3, 3)])
def test_filter_and_loglik_match(models, pm):
    j, t = models[pm]
    _close(tkmv.log_likelihood_mv(t), _jv(jkmv.log_likelihood_mv)(j))
    rj = _jv(jkmv.kfilter_mv)(j)
    rt = tkmv.kfilter_mv(t)
    for name in rj._fields:
        _close(getattr(rt, name), getattr(rj, name))


@pytest.mark.parametrize("pm", [(2, 2), (3, 3)])
def test_smoothers_match(models, pm):
    j, t = models[pm]
    sj, st = _jv(jkmv.smoother_mv)(j), tkmv.smoother_mv(t)
    for name in sj._fields:
        _close(getattr(st, name), getattr(sj, name))
    _close(tkmv.fast_smoother_mv(t), _jv(
        lambda s: jkmv.fast_smoother_mv(s))(j))
    aj, lj = _jv(jkmv.fast_smoother_mv_ll)(j)
    at, lt = tkmv.fast_smoother_mv_ll(t)
    _close(at, aj)
    _close(lt, lj)
    hj, Lj, Aj = _jv(jkmv.smoother_bwd_factors_mv)(j)
    ht, Lt, At = tkmv.smoother_bwd_factors_mv(t)
    _close(ht, hj)
    _close(At, Aj)
    if pm[1] == 2:      # the closed-form 2x2 eigenvectors on both sides
        _close(Lt, Lj)
    _close(Lt @ Lt.transpose(-1, -2), jnp.einsum('...ij,...kj->...ik', Lj,
                                                 Lj))


def test_mean_passes_reuse_the_gains(models):
    """fast_smoother_mv with another series' filter gains (the
    simulation smoother's call) against the JAX package's."""
    j, t = models[(2, 2)]
    rng = np.random.default_rng(11)
    y2 = np.where(np.isfinite(np.asarray(j.y)),
                  rng.normal(size=j.y.shape), np.nan)
    jf = _jv(jkmv.kfilter_mv)(j)
    want = _jv(jkmv.fast_smoother_mv)(j._replace(y=jnp.asarray(y2)), jf)
    got = tkmv.fast_smoother_mv(t._replace(y=torch.as_tensor(y2)),
                                tkmv.kfilter_mv(t))
    _close(got, want)


def _sim_draws(key, nsim, antithetic, n, p, m, k):
    """The normals ``kalman_mv.simulate_states_mv`` draws from ``key`` for
    its base draws: ``um (nb, m)``, ``eps (nb, n, p)``, ``eta (nb, n, k)``."""
    nb = (nsim + 1) // 2 if antithetic else nsim
    um, eps, eta = [], [], []
    for kk in jax.random.split(key, nb):
        k0, k1, k2 = jax.random.split(kk, 3)
        um.append(jax.random.normal(k0, (m,), jnp.float64))
        eps.append(jax.random.normal(k1, (n, p), jnp.float64))
        eta.append(jax.random.normal(k2, (n, k), jnp.float64))
    return tuple(np.stack(x) for x in (um, eps, eta))


@pytest.mark.parametrize("nsim,antithetic", [(1, False), (4, True),
                                             (3, False)])
def test_simulation_smoother_matches(models, nsim, antithetic):
    """Draw for draw: the JAX function draws for one model from a key, the
    port for the rows of a batch from the same normals."""
    j, t = models[(2, 2)]
    n, p, m, k = t.n, t.p, t.m, t.k
    keys = jax.random.split(jax.random.PRNGKey(nsim), 3)
    draws = [_sim_draws(kk, nsim, antithetic, n, p, m, k) for kk in keys]
    um, eps, eta = (torch.as_tensor(np.stack(x)) for x in zip(*draws))
    got = tkmv.simulate_states_mv(t, nsim, use_antithetic=antithetic,
                                  um=um, eps=eps, eta=eta)
    assert got.shape == (3, nsim, n + 1, m)
    want = _jv(lambda s, kk: jkmv.simulate_states_mv(
        s, nsim, kk, antithetic))(j, keys)
    _close(got, want, rtol=1e-9, atol=1e-9)
    drawn = tkmv.simulate_states_mv(t, nsim, torch.Generator().manual_seed(1),
                                    antithetic)
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()


def test_failed_cholesky_is_minus_inf_for_that_row_only(models):
    """One step of three rows where row 1's F is not positive definite:
    that row's log-likelihood is -inf and its factor the identity, as in
    the JAX package; rows 0 and 2 equal the step without it, bit for bit
    (``cholesky_ex``: no exception in the middle of a batch)."""
    _, t = models[(2, 2)]
    s = tkmv._sys(t)
    st = next(tkmv._steps(s))
    bad = st.HHm.clone()
    bad[1] = -100.0 * torch.eye(2, dtype=torch.float64)
    eyes = tkmv._eyes(s)
    ok = tkmv._update_mv(s.a1, s.P1, st, *eyes)
    got = tkmv._update_mv(s.a1, s.P1, st._replace(HHm=bad), *eyes)
    assert torch.isneginf(got[-1][1])
    assert torch.equal(got[5][1], torch.eye(2, dtype=torch.float64))
    for a, b in zip(got, ok):
        assert torch.equal(a[[0, 2]], b[[0, 2]])
    want = jkmv._update_mv(*(jnp.asarray(x[1].numpy()) for x in (
        t.a1, t.P1, t.y[:, 0], torch.isfinite(t.y[:, 0]), t.Z[:, 0], bad,
        t.T[:, 0], t.RR[:, 0], t.D[:, 0], t.C[:, 0])))
    assert np.isneginf(np.asarray(want[-1]))


def test_dmvnorm_and_chol_helpers_match(models):
    """dmvnorm (full and lower-factor input, a deterministic component),
    masked_tri_solve and conditional_cov_factors."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 3, 3))
    cov = np.einsum('bij,bkj->bik', A, A)
    cov[1, 2, :] = cov[1, :, 2] = 0.0
    x, mu = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    want = _jv(jdmv.dmvnorm)(jnp.asarray(x), jnp.asarray(mu),
                             jnp.asarray(cov))
    t = lambda a: torch.as_tensor(a)                          # noqa: E731
    _close(tdmv.dmvnorm(t(x), t(mu), t(cov)), want)
    L = np.linalg.cholesky(cov[[0, 2, 3]])
    want = _jv(lambda a, b, c: jdmv.dmvnorm(a, b, c, lwr=True))(
        jnp.asarray(x[[0, 2, 3]]), jnp.asarray(mu[[0, 2, 3]]),
        jnp.asarray(L))
    _close(tdmv.dmvnorm(t(x[[0, 2, 3]]), t(mu[[0, 2, 3]]), t(L), lwr=True),
           want)
    active = np.array([True, False, True])
    b = rng.normal(size=(4, 3))
    want = _jv(lambda LL, bb: jchol.masked_tri_solve(
        LL, bb, jnp.asarray(active)))(jnp.asarray(np.tril(A)),
                                      jnp.asarray(b))
    _close(tchol.masked_tri_solve(t(np.tril(A)), t(b), t(active)), want)
    # smoothed moments of a model: the forward conditional factors
    j, tt = models[(2, 2)]
    sj = _jv(jkmv.smoother_mv)(j)
    Lj, Aj = _jv(jchol.conditional_cov_factors)(sj.Vt, sj.ccov)
    st = tkmv.smoother_mv(tt)
    Lt, At = tchol.conditional_cov_factors(st.Vt, st.ccov)
    _close(At, Aj, rtol=1e-8, atol=1e-9)
    _close(Lt, Lj, rtol=1e-8, atol=1e-9)
