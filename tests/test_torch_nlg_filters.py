"""PyTorch port vs the JAX package: the inference of nonlinear models
(``inference/nlg.py``) and their single-model API, float64 on the CPU.

Three models, each with a missing time point: the growth model on
``simulate_growth(n=40)``, ``nlg_sin_exp`` and ``nlg_ar_exp`` on series
simulated here.  Four rows of theta go through the port in one batch; the JAX
functions run on each row alone (mapped over the rows).  The deterministic
parts agree to 1e-9: EKF (plain and iterated), UKF, the extended Kalman
smoothers, the linearisation, the signal log-density, the scales and the
mode approximation with its number of passes, which differ between the rows
of a batch; one row starts far from the data's theta.  (The JAX package's
step-halving asks for a relative change below -conv_tol and an absolute
change above 1e-4 at once, which cannot both hold: it never halves a step,
and the port has no halving; a pass whose objective falls ends that row's
iteration in both.) On the linear-Gaussian example EKF, UKF and the
approximation equal the Kalman log-likelihood.  The psi, bootstrap and
extended Kalman particle filters agree exactly (to roundoff) on the draws
the JAX functions make from their keys.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.inference import filters as jfilters
from bssm_tpu.inference import loglik as jloglik
from bssm_tpu.inference import nlg as jnlg
from bssm_tpu.models import examples as jex

import bssm_tpu_torch as bt
from bssm_tpu_torch.convert import nlg_approx_from_numpy
from bssm_tpu_torch.core.spec import LGSpec
from bssm_tpu_torch.inference import nlg as tnlg
from bssm_tpu_torch.ops import kalman as tkalman

from test_torch_filters import _bsf_draws, _psi_draws

TOL = 1e-9


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _series(name, n=40, seed=0):
    if name == "nlg_growth":
        y = jex.simulate_growth(n=n, seed=3)
    else:
        rng = np.random.default_rng(seed)
        a = np.zeros(n)
        for t in range(1, n):
            a[t] = (np.sin(a[t - 1]) if name == "nlg_sin_exp"
                    else 0.5 + 0.5 * (a[t - 1] - 0.5)) + 0.5 * rng.normal()
        y = np.exp(a) + 0.6 * rng.normal(size=n)
    y[n // 3] = np.nan
    return y


# theta offsets of the four rows from the initial theta; the last row is far
SPREAD = {"nlg_growth": [[0, 0, 0], [0.3, -0.2, 0.1], [-0.4, 0.3, -0.2],
                         [1.5, 1.0, -1.5]],
          "nlg_sin_exp": [[0, 0], [0.3, -0.2], [-0.4, 0.3], [1.2, -1.0]],
          "nlg_ar_exp": [[0, 0, 0, 0], [0.2, 0.1, -0.2, 0.1],
                         [-0.3, -0.2, 0.3, -0.2], [1.0, 0.35, 0.8, -0.8]]}


@pytest.fixture(scope="module", params=sorted(SPREAD))
def case(request):
    name = request.param
    y = _series(name)
    jm = getattr(jex, name)(y)
    tm = getattr(bt.example_models, name)(y, dtype=torch.float64,
                                          device="cpu")
    th = np.asarray(jm.theta_init) + np.asarray(SPREAD[name])
    return name, jm, tm, th, tm.build(torch.as_tensor(th))


def _jax_rows(jm, th, fn):
    """``fn(spec)`` of the JAX package at every row of theta alone."""
    return jax.jit(jax.vmap(lambda t: fn(jm.build(t))))(jnp.asarray(th))


def test_ekf_ukf_and_smoothers_match_jax(case):
    _, jm, tm, th, spec = case
    for it in (0, 2):
        want = _jax_rows(jm, th, lambda s: jnlg.ekf(s.replace(iekf_iter=it)))
        got = tnlg.ekf(dataclasses.replace(spec, iekf_iter=it))
        for g, w in zip(got, want):
            _close(g, w)
    for g, w in zip(tnlg.ukf(spec), _jax_rows(jm, th, jnlg.ukf)):
        _close(g, w)
    sm, wsm = tnlg.ekf_smoother(spec), _jax_rows(jm, th, jnlg.ekf_smoother)
    for f in ("alphahat", "Vt", "logLik"):
        _close(getattr(sm, f), getattr(wsm, f))
    _close(tnlg.ekf_fast_smoother(spec),
           _jax_rows(jm, th, jnlg.ekf_fast_smoother))


def test_mode_approximation_matches_jax(case):
    """``approximate_nlg`` (mode, log-likelihood, passes, scales, the
    linearised model), and at that mode ``build_approx``,
    ``log_signal_pdf`` and ``_scales_nlg`` (the last two also at the EKF's
    predictions, away from the mode)."""
    name, jm, tm, th, spec = case
    want = _jax_rows(jm, th, jnlg.approximate_nlg)
    got = tnlg.approximate_nlg(spec)
    _close(got.mode, want.mode)
    _close(got.loglik, want.loglik)
    _close(got.scales, want.scales)
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(want.niter))
    for f in ("Z", "H", "T", "R", "D", "C", "a1", "P1"):
        _close(getattr(got.approx, f), getattr(want.approx, f))
    # the rows stop at different passes: the per-row masks are exercised
    assert len(set(np.asarray(want.niter).tolist())) > 1, want.niter
    at = tnlg.ekf(spec).at[:, :-1]

    def jat(s):
        return jnlg.ekf(s).at[:-1]
    jpdf = jax.jit(jax.vmap(lambda t, a: jnlg.log_signal_pdf(jm.build(t), a)))
    for mode in (got.mode, at):
        jmode = jnp.asarray(mode.numpy())
        _close(tnlg.log_signal_pdf(spec, mode), jpdf(jnp.asarray(th), jmode))
        g = tnlg.build_approx(spec, mode)
        jg = jax.jit(jax.vmap(lambda t, a: jnlg.build_approx(
            jm.build(t), a)))(jnp.asarray(th), jmode)
        jsc = jax.jit(jax.vmap(lambda t, a, gg: jnlg._scales_nlg(
            jm.build(t), a, gg)))(jnp.asarray(th), jmode, jg)
        _close(tnlg._scales_nlg(spec, mode, g), jsc)
    _close(at, _jax_rows(jm, th, jat))


def test_linear_gaussian_example_is_the_kalman_filter():
    """On ``nlg_linear_gaussian`` EKF, UKF and the approximation's
    log-likelihood equal the Kalman filter's, and the approximation's
    scales vanish."""
    rng = np.random.default_rng(4)
    n = 25
    y = np.cumsum(rng.normal(size=n)) + rng.normal(size=n)
    y[5] = np.nan
    tm = bt.example_models.nlg_linear_gaussian(y, dtype=torch.float64,
                                               device="cpu")
    th = np.array([[0.0], [-0.5], [0.7]])
    spec = tm.build(torch.as_tensor(th))
    one = lambda v: torch.tensor([[v]], dtype=torch.float64)  # noqa: E731
    ll = torch.cat([tkalman.log_likelihood(LGSpec(
        y=torch.as_tensor(y), Z=one(1.0), H=torch.exp(torch.tensor(
            [t[0]], dtype=torch.float64)), T=one(1.0)[None],
        R=one(1.0)[None], a1=torch.zeros(1, dtype=torch.float64),
        P1=100 * one(1.0), D=torch.zeros(1, dtype=torch.float64),
        C=torch.zeros(1, 1, dtype=torch.float64))).reshape(1) for t in th])
    _close(tnlg.ekf(spec).logLik, ll, 1e-10)
    _close(tnlg.ukf(spec).logLik, ll, 1e-8)
    ap = tnlg.approximate_nlg(spec)
    _close(ap.loglik, ll, 1e-8)
    _close(ap.scales, np.zeros((3, n)), 1e-8)


def _filter_case(n=30, N=16):
    y = jex.simulate_growth(n=n, seed=5)
    y[7] = np.nan
    jm = jex.nlg_growth(y)
    tm = bt.example_models.nlg_growth(y, dtype=torch.float64, device="cpu")
    th = np.asarray(jm.theta_init) + np.array([[0.0, 0.0, 0.0],
                                               [0.3, -0.3, 0.2]])
    keys = [jax.random.PRNGKey(11 + b) for b in range(2)]
    return jm, tm, th, keys, n, N


def _stack(draws):
    return tuple(torch.as_tensor(np.stack(x)) for x in zip(*draws))


def _same_pf(got, want, b):
    _close(got.loglik[b], want.loglik, 1e-10)
    _close(got.alpha[b], want.alpha, 1e-10)
    _close(got.weights[b], want.weights, 1e-10)
    np.testing.assert_array_equal(got.indices[b].numpy(),
                                  np.asarray(want.indices))


def test_particle_filters_match_jax_on_its_draws():
    """psi (the JAX package's approximation carried over by
    ``nlg_approx_from_numpy``), bootstrap and EKPF on two rows, each with
    its JAX key's draws: log-likelihood, trajectories, weights and
    ancestors; the ``keep_paths=False`` estimate is the same number."""
    jm, tm, th, keys, n, N = _filter_case()
    spec = tm.build(torch.as_tensor(th))
    js = [jm.build(jnp.asarray(t)) for t in th]
    jap = [jax.jit(jnlg.approximate_nlg)(s) for s in js]
    ap = nlg_approx_from_numpy(
        {"mode": np.stack([a.mode for a in jap]),
         "approx": {f: np.stack([getattr(a.approx, f) for a in jap])
                    if f != "y" else np.asarray(jap[0].approx.y)
                    for f in jap[0].approx._fields},
         "scales": np.stack([a.scales for a in jap]),
         "loglik": np.stack([a.loglik for a in jap]),
         "niter": np.stack([a.niter for a in jap])}, device="cpu",
        dtype=torch.float64)
    _close(ap.mode, tnlg.approximate_nlg(spec).mode)
    eps, us = _stack([_psi_draws(k, n, N, 2) for k in keys])
    psi = tnlg.psi_filter_nlg(spec, ap, N, eps=eps, us=us)
    est = tnlg.psi_filter_nlg(spec, ap, N, eps=eps, us=us, keep_paths=False)
    jpsi = jax.jit(jnlg.psi_filter_nlg, static_argnums=2)
    jekpf = jax.jit(jnlg.ekpf_filter, static_argnums=1)
    jbsf = jax.jit(jnlg.bsf_filter_nlg, static_argnums=1)
    for b in range(2):
        one = tm.build(torch.as_tensor(th[b]))
        _same_pf(psi, jpsi(js[b], jap[b], N, keys[b]), b)
        assert est[b] == psi.loglik[b]
        for run, jrun, draws in (
                (tnlg.ekpf_filter, jekpf, _psi_draws(keys[b], n, N, 2)),
                (tnlg.bsf_filter_nlg, jbsf,
                 _bsf_draws(keys[b], n, N, 2, 2))):
            e, u = _stack([draws])
            pf = run(one, N, eps=e, us=u)
            _same_pf(pf, jrun(js[b], N, keys[b]), 0)
            assert run(one, N, eps=e, us=u, keep_paths=False)[0] \
                == pf.loglik[0]


def test_single_model_api():
    """The public functions on one model (theta_init): the filters and
    smoothers (the iterated EKF through ``iekf_iter``) and ``logLik``
    without particles against the JAX package's; with particles
    ``logLik``, ``particle_smoother`` (psi, bsf, ekf), ``ekpf_filter`` and
    ``bootstrap_filter`` against the port's filters on the same draws
    (those match the JAX package's above); ``gaussian_approx``."""
    jm, tm, _, keys, n, N = _filter_case()
    for g, w in zip(bt.ekf(tm, iekf_iter=2), jfilters.ekf(jm, iekf_iter=2)):
        _close(g[0], w)
    for g, w in zip(bt.ukf(tm), jfilters.ukf(jm)):
        _close(g[0], w)
    _close(bt.ekf_smoother(tm).Vt[0], jfilters.ekf_smoother(jm).Vt)
    _close(bt.ekf_fast_smoother(tm)[0], jfilters.ekf_fast_smoother(jm))
    _close(bt.logLik(tm), jloglik.logLik(jm).reshape(1))
    _close(bt.logLik(tm, method="ekf"),
           jloglik.logLik(jm, method="ekf").reshape(1))
    spec = tm.build(torch.as_tensor(tm.theta_init))
    ap = tnlg.approximate_nlg(spec)
    e, u = _stack([_psi_draws(keys[0], n, N, 2)])
    eb, ub = _stack([_bsf_draws(keys[0], n, N, 2, 2)])
    runs = {"psi": (lambda: tnlg.psi_filter_nlg(spec, ap, N, eps=e, us=u),
                    e, u),
            "ekf": (lambda: tnlg.ekpf_filter(spec, N, eps=e, us=u), e, u),
            "bsf": (lambda: tnlg.bsf_filter_nlg(spec, N, eps=eb, us=ub),
                    eb, ub)}
    for method, (run, ee, uu) in runs.items():
        pf = run()
        assert bt.logLik(tm, N, method=method, eps=ee, us=uu) == pf.loglik
        ps = bt.particle_smoother(tm, N, method=method, eps=ee, us=uu)
        traced = bt.ancestor_trace(pf.alpha, pf.indices)
        w = pf.weights[..., -1] / pf.weights[..., -1].sum(-1, keepdim=True)
        _close(ps.alphahat, torch.einsum('bi,bitm->btm', w, traced))
        assert ps.logLik == pf.loglik
    assert torch.equal(bt.ekpf_filter(tm, N, eps=e, us=u).alpha,
                       runs["ekf"][0]().alpha)
    assert torch.equal(bt.bootstrap_filter(tm, N, eps=eb, us=ub).alpha,
                       runs["bsf"][0]().alpha)
    assert torch.equal(bt.gaussian_approx(tm).Z, ap.approx.Z)
    with pytest.raises(ValueError):
        bt.logLik(tm, N, method="spdk")
