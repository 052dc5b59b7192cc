"""PyTorch port vs the JAX package: the multivariate model constructors and
their checks, the single-model API, ``predict`` / ``fitted``, and the
kernel wrappers' refusal of multivariate specs, on the CPU in float64.

- The constructors build the same spec from the same R-layout arrays (time
  varying Z, H, D and C included); a bad input raises the same exception
  type in both packages.
- The single-model API on one model at its initial theta: the Kalman
  filter and smoothers exactly, the Laplace approximation to 1e-9, and the
  particle filters and smoother exactly on the draws the JAX functions make
  from their keys (``seed``), handed to the port.
- ``fitted`` means of a stored output exactly; ``predict``'s deterministic
  parts as the JAX package's ``test_predict_mv_p1_equals_univariate``
  checks them: an mlg (mng) of one series equals the univariate model, and
  here, with one generator, its response draws do too.
- No kernel takes a multivariate spec: ``kernel_takes`` is False for every
  wrapper, and every wrapper raises on one, on either device.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.inference import filters as jfilters
from bssm_tpu.inference.approx import gaussian_approx as j_gaussian_approx
from bssm_tpu.inference import loglik as jloglik
from bssm_tpu.inference import predict as jpredict
from bssm_tpu.inference import smoothers as jsmoothers
from bssm_tpu.models.ssm import ssm_mlg as j_ssm_mlg
from bssm_tpu.models.ssm import ssm_mng as j_ssm_mng

import bssm_tpu_torch as bt
from bssm_tpu_torch.core.spec import MVLGSpec, MVNGSpec, drop_batch
from bssm_tpu_torch.inference.approx import ApproxLoglik
from bssm_tpu_torch.ops import cuda_kalman as ck

from test_torch_filters import _bsf_draws, _psi_draws
from test_torch_mv_approx import models as mng_models
from test_torch_predict import _stored

T64 = dict(dtype=torch.float64, device="cpu")


def _close(got, want, tol=1e-10):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _mlg_inputs(n=20, seed=0):
    """R-layout arrays of a time-varying bivariate model over two states."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, 2)).cumsum(0)
    y[3, 1] = np.nan
    y[n // 2] = np.nan
    Z = 1.0 + 0.3 * rng.normal(size=(2, 2, n))
    H = np.tril(0.1 * rng.normal(size=(2, 2, n)).transpose(2, 0, 1)) \
        .transpose(1, 2, 0) + 0.5 * np.eye(2)[..., None]
    return y, dict(Z=Z, H=H, T=0.9 * np.eye(2), R=0.3 * np.eye(2),
                   a1=[0.5, -0.5], P1=2.0 * np.eye(2),
                   D=0.1 * rng.normal(size=(2, n)),
                   C=0.05 * rng.normal(size=(2, n)))


def _mlg_pair():
    """The time-varying bivariate model on both sides, R = exp(theta) R0."""
    y, kw = _mlg_inputs()
    R0 = kw["R"]
    jm = j_ssm_mlg(y, **kw, init_theta=(0.1,),
                   update_fn=lambda th: {"R": jnp.exp(th[0]) * R0[None]})
    tm = bt.ssm_mlg(y, **kw, init_theta=(0.1,), update_fn=lambda th: {
        "R": torch.exp(th[:, 0])[:, None, None, None]
        * torch.as_tensor(R0)}, **T64)
    return jm, tm


def _spec_leaves_equal(jspec, tspec):
    for f in ("y", "Z", "T", "R", "a1", "P1", "D", "C") + tuple(
            f for f in ("H", "phi", "u", "initial_mode")
            if hasattr(tspec, f)):
        want, got = np.asarray(getattr(jspec, f)), getattr(tspec, f)
        assert got.shape == want.shape, (f, got.shape, want.shape)
        np.testing.assert_array_equal(got.numpy(), want)


def test_constructors_build_the_jax_spec():
    jm, tm = _mlg_pair()
    ts = drop_batch(tm.build(torch.as_tensor(tm.theta_init)))
    assert isinstance(ts, MVLGSpec) and tm.kind == "mlg"
    _spec_leaves_equal(jm.build(jm.theta_init), ts)
    for kind in ("pois_gauss", "binom_negbin_gamma"):
        jm, tm = mng_models(kind)
        js = jm.build(jm.theta_init)
        ts = tm.build(torch.as_tensor(tm.theta_init))
        assert isinstance(ts, MVNGSpec) and tm.kind == "mng"
        assert ts.distributions == js.distributions
        assert ts.batch == 1 and ts.R.shape == (1, 1, 2, 2)
        _spec_leaves_equal(js, drop_batch(ts))
    # defaults: D = 0 (1, p), C = 0, a1 = 0, P1 = 0, one family for all
    y = np.ones((5, 3))
    jm = j_ssm_mng(y, Z=np.ones((3, 1)), T=np.eye(1), R=np.eye(1),
                   distributions="poisson")
    tm = bt.ssm_mng(y, Z=np.ones((3, 1)), T=np.eye(1), R=np.eye(1),
                    distributions="poisson", **T64)
    _spec_leaves_equal(jm.build(jm.theta_init), tm.build(torch.zeros(0)))


BAD = {
    "y not 2-d": lambda f, k: f(np.ones(5), **k),
    "y infinite": lambda f, k: f(np.array([[1.0, np.inf]] * 5), **k),
    "y too short": lambda f, k: f(np.ones((1, 2)), **k),
    "Z rows": lambda f, k: f(np.ones((5, 2)), **{**k, "Z": np.ones((3, 2))}),
    "Z time axis": lambda f, k: f(np.ones((5, 2)),
                                  **{**k, "Z": np.ones((2, 2, 4))}),
    "D shape": lambda f, k: f(np.ones((5, 2)), **{**k, "D": np.ones((3, 5))}),
    "C shape": lambda f, k: f(np.ones((5, 2)), **{**k, "C": np.ones((3, 1))}),
    "T shape": lambda f, k: f(np.ones((5, 2)), **{**k, "T": np.eye(3)}),
    "NaN in R": lambda f, k: f(np.ones((5, 2)),
                               **{**k, "R": np.full((2, 2), np.nan)}),
}
BAD_MLG = {"H shape": lambda f, k: f(np.ones((5, 2)),
                                     **{**k, "H": np.ones((3, 3))})}
BAD_MNG = {
    "negative poisson": lambda f, k: f(np.array([[-1.0, 0.0]] * 5), **k),
    "non-integer negbin": lambda f, k: f(
        np.array([[1.5, 0.0]] * 5), **{**k, "distributions": [
            "negative binomial", "gaussian"]}),
    "negative gamma": lambda f, k: f(
        np.array([[1.0, -2.0]] * 5), **{**k, "distributions": [
            "poisson", "gamma"]}),
    "u not positive": lambda f, k: f(np.ones((5, 2)), **{**k, "u": 0.0}),
}


@pytest.mark.parametrize("case", sorted(
    [("mlg", c) for c in {**BAD, **BAD_MLG}]
    + [("mng", c) for c in {**BAD, **BAD_MNG}]))
def test_bad_input_raises_as_in_jax(case):
    kind, name = case
    base = dict(Z=np.eye(2), T=np.eye(2), R=np.eye(2))
    if kind == "mlg":
        fns = (j_ssm_mlg, lambda *a, **k: bt.ssm_mlg(*a, **k, **T64))
        base["H"] = np.eye(2)
    else:
        fns = (j_ssm_mng, lambda *a, **k: bt.ssm_mng(*a, **k, **T64))
        base["distributions"] = ["poisson", "gaussian"]
    call = {**BAD, **BAD_MLG, **BAD_MNG}[name]
    kinds = []
    for f in fns:
        with pytest.raises(Exception) as e:
            call(f, base)
        kinds.append(type(e.value))
    assert kinds[0] is kinds[1], kinds


def test_single_model_api_on_mlg_matches_jax():
    jm, tm = _mlg_pair()
    _close(bt.logLik(tm), jloglik.logLik(jm))
    kf_j, kf_t = jfilters.kfilter(jm), bt.kfilter(tm)
    for f in kf_j._fields:
        _close(getattr(kf_t, f)[0], getattr(kf_j, f))
    _close(bt.fast_smoother(tm)[0], jsmoothers.fast_smoother(jm))
    sm_j, sm_t = jsmoothers.smoother(jm), bt.smoother(tm)
    for f in sm_j._fields:
        _close(getattr(sm_t, f)[0], getattr(sm_j, f))
    ss = bt.sim_smoother(tm, 4)
    assert ss.shape == (4, 21, 2) and torch.isfinite(ss).all()
    with pytest.raises(TypeError):
        bt.bootstrap_filter(tm, 10)


def test_single_model_api_on_mng_matches_jax():
    jm, tm = mng_models("pois_gauss")
    n, m, k = 30, 2, 2
    g_j, g_t = j_gaussian_approx(jm), bt.gaussian_approx(tm)
    assert isinstance(g_t, MVLGSpec)
    for f in ("y", "H"):
        _close(getattr(g_t, f)[0], getattr(g_j, f), 1e-9)
    _close(bt.logLik(tm), jloglik.logLik(jm), 1e-9)
    kf_j, kf_t = jfilters.kfilter(jm), bt.kfilter(tm)
    _close(kf_t.at[0], kf_j.at, 1e-9)
    _close(kf_t.logLik, kf_j.logLik, 1e-9)
    _close(bt.fast_smoother(tm)[0], jsmoothers.fast_smoother(jm), 1e-9)
    # particle estimates on the JAX package's draws of seed 1
    key = jax.random.PRNGKey(1)
    eps, us = (torch.as_tensor(x)[None] for x in _psi_draws(key, n, 10, m))
    _close(bt.logLik(tm, 10, eps=eps, us=us), jloglik.logLik(jm, 10), 1e-9)
    ps_j = jfilters.particle_smoother(jm, 10)
    ps_t = bt.particle_smoother(tm, 10, eps=eps, us=us)
    for f in ("alphahat", "Vt", "weights", "logLik"):
        got = getattr(ps_t, f)
        _close(got[0] if got.dim() else got, getattr(ps_j, f), 1e-9)
    eps, us = (torch.as_tensor(x)[None] for x in _bsf_draws(key, n, 10, m, k))
    _close(bt.logLik(tm, 10, method="bsf", eps=eps, us=us),
           jloglik.logLik(jm, 10, method="bsf"), 1e-9)
    bf_j = jfilters.bootstrap_filter(jm, 10)
    bf_t = bt.bootstrap_filter(tm, 10, eps=eps, us=us)
    _close(bf_t.alpha[0], bf_j.alpha, 1e-9)
    _close(bf_t.loglik[0], bf_j.loglik, 1e-9)
    imp = bt.importance_sample(tm, 20)
    assert imp.alpha.shape == (20, 31, 2)
    assert abs(float(imp.weights.sum()) - 1.0) < 1e-12
    assert torch.isfinite(bt.logLik(tm, 20, method="spdk")).all()


def test_fitted_means_match_jax():
    """``fitted(type="mean")`` of one stored output: the signals (mlg) and
    the families' means (mng) of every draw, exactly."""
    jm, tm = _mlg_pair()
    out = _stored(tm, 20)
    _close(bt.fitted(out, tm), jpredict.fitted(out, jm), 1e-12)
    for kind in ("pois_gauss", "binom_negbin_gamma"):
        jm, tm = mng_models(kind)
        out = _stored(tm, 30)
        got = bt.fitted(out, tm)
        assert got.shape == (120, 30, tm.build(torch.zeros(1, 1,
                                                           **T64)).p)
        _close(got, jpredict.fitted(out, jm), 1e-12)
        resp = bt.fitted(out, tm, type="response")
        assert resp.shape == got.shape and np.isfinite(resp).all()


def _p1_model(kind, mv, y):
    """The univariate model of ``y`` (``ssm_ulg`` / ``ssm_ung``) or its
    one-series multivariate form (``ssm_mlg`` / ``ssm_mng``), H and R from
    theta."""
    kw = dict(T=np.ones((1, 1)), R=np.full((1, 1), 0.5), P1=np.eye(1) * 10.0,
              init_theta=np.log([1.0, 0.5]), **T64)

    def upd(th):
        R = torch.exp(th[:, 1])[:, None, None, None]
        if kind == "ng":
            return {"R": R}
        H = torch.exp(th[:, 0])
        return {"H": H[:, None, None, None] if mv else H[:, None], "R": R}

    if kind == "lg":
        if mv:
            return bt.ssm_mlg(y[:, None], Z=np.ones((1, 1)), H=np.eye(1),
                              update_fn=upd, **kw)
        return bt.ssm_ulg(y, Z=np.ones(1), H=np.ones(1), update_fn=upd, **kw)
    if mv:
        return bt.ssm_mng(y[:, None], Z=np.ones((1, 1)),
                          distributions="poisson", update_fn=upd, **kw)
    return bt.ssm_ung(y, Z=np.ones(1), distribution="poisson", update_fn=upd,
                      **kw)


@pytest.mark.parametrize("kind", ["lg", "ng"])
def test_predict_p1_equals_univariate(kind):
    """An mlg / mng of one series predicts what its univariate model
    predicts, type by type, from one stored output and one seed."""
    rng = np.random.default_rng(4)
    y = np.cumsum(rng.normal(0, 0.5, 25)) + rng.normal(0, 1.0, 25) \
        if kind == "lg" else rng.poisson(np.exp(np.cumsum(
            rng.normal(0, 0.1, 25)) + 1.0)).astype(float)
    out = _stored(_p1_model(kind, False, y), 25)
    h = 6
    fut = {mv: _p1_model(kind, mv, np.full(h, np.nan)) for mv in (0, 1)}
    for typ in ("state", "mean", "response"):
        pu = bt.predict(out, fut[0], typ, 64, seed=3)
        pm = bt.predict(out, fut[1], typ, 64, seed=3)
        if typ != "state":
            assert pm.shape == (64, h, 1)
            pm = pm[..., 0]
        np.testing.assert_allclose(pm, pu, rtol=1e-12, atol=1e-12)


def _mv_specs():
    _, tm = _mlg_pair()
    _, nm = mng_models("pois_gauss")
    return (tm.build(torch.as_tensor(tm.theta_init)),
            nm.build(torch.as_tensor(nm.theta_init)))


@pytest.mark.parametrize("wrapper", sorted(ck.PLAIN_ROUTES))
def test_kernel_wrappers_refuse_multivariate_specs(wrapper):
    """``kernel_takes`` is False and ``route`` sends nothing, and the
    wrapper raises TypeError, for both kinds of multivariate spec."""
    from bssm_tpu_torch.inference import approx_mv as amv
    lg, ng = _mv_specs()
    al = amv.approx_loglik_mv(ng)
    zeros = torch.zeros(1, **T64)
    calls = {
        "log_likelihood": lambda s: ck.log_likelihood(s),
        "fast_smoother_ll": lambda s: ck.fast_smoother_ll(s),
        "rts_factors": lambda s: ck.rts_factors(s),
        "laplace_solve": lambda s: ck.laplace_solve(s, al.approx.mode, 1e-8,
                                                    10),
        "laplace_step": lambda s: ck.laplace_step(s, al.approx.mode),
        "psi_logw": lambda s: ck.psi_logw(s, al, zeros, zeros, zeros, zeros,
                                          zeros),
        "psi_big_logw": lambda s: ck.psi_big_logw(
            s, al, zeros, zeros, zeros, 1, eps=torch.zeros(1, 31, 40, 2,
                                                           **T64),
            us=torch.zeros(1, 30, 40, **T64)),
        "bsf_big_logw": lambda s: ck.bsf_big_logw(
            s, 1, eps=torch.zeros(1, 30, 40, 2, **T64),
            us=torch.zeros(1, 29, 40, **T64))}
    for spec in (lg, ng):
        assert not ck.kernel_takes(spec, wrapper)
        assert not ck.route(wrapper, spec)
        with pytest.raises(TypeError, match="one observed series"):
            calls[wrapper](spec)
    assert isinstance(al, ApproxLoglik)
    assert not any(ck.PLAIN_ROUTES.values()) and not any(
        ck.LAUNCHES.values())
