"""PyTorch port vs the JAX package: the univariate models ``svm`` (both
types), ``ar1_ng`` and ``ssm_ulg`` / ``ssm_ung`` with user functions.

For each model at a batch of thetas, float64 on the CPU, from the same
numpy inputs:
- every spec leaf and the log prior equal the JAX package's per-theta
  build to rtol 1e-15 (the same formulas; ``exp`` may differ in the last
  ulp between the two libraries);
- the approximate log-likelihood (the Kalman one for ``ssm_ulg``) within
  rtol 1e-9 (the Laplace solve and the filter chained, products summed in
  another order);
- the psi log-weight of the IS correction (in
  ``tests/test_torch_models_psi.py``).
The user functions of ``ssm_*`` are torch functions batched over chains in
the port and per-theta JAX functions in the JAX package.  Also: the
validation errors of the new checks, as ``tests/test_validate.py`` has
them, and rows whose prior is -inf in one batch with valid rows.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import priors as jpri
from bssm_tpu.inference import approx as japprox
from bssm_tpu.models.ar1 import ar1_ng as jar1_ng
from bssm_tpu.models.ssm import ssm_ulg as jssm_ulg
from bssm_tpu.models.ssm import ssm_ung as jssm_ung
from bssm_tpu.models.svm import svm as jsvm
from bssm_tpu.ops import kalman as jkalman

import bssm_tpu_torch as bt
from bssm_tpu_torch.core import validate as val
from bssm_tpu_torch.core.spec import CORE_NDIM
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.ops import cuda_kalman as ck

N_OBS = 24
LEAVES = {"lg": ("y", "Z", "H", "T", "R", "a1", "P1", "D", "C"),
          "ng": ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u",
                 "initial_mode")}


def sv_series(n, seed, rho=0.95, sd_ar=0.2, sigma=0.6):
    """A stochastic-volatility series simulated with numpy."""
    rng = np.random.default_rng(seed)
    h = np.zeros(n)
    h[0] = rng.normal(0, sd_ar / np.sqrt(1 - rho ** 2))
    for t in range(1, n):
        h[t] = rho * h[t - 1] + sd_ar * rng.normal()
    return sigma * np.exp(h / 2) * rng.normal(size=n)


def _counts(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    y = y.astype(float)
    y[[4, n - 3]] = np.nan
    return y


def _pri(p, name, *a):
    return getattr(p, name)(*a)


def pair(case):
    """The same model built by both packages, and thetas (B, d) of it."""
    rng = np.random.default_rng(len(case))
    n = N_OBS
    if case.startswith("svm"):
        y = sv_series(n, 1)
        y[5] = np.nan

        def kw(p):
            third = dict(sigma=_pri(p, "halfnormal_prior", 0.6, 2.0)) \
                if case == "svm sigma" else \
                dict(mu=_pri(p, "normal_prior", -0.5, 0.0, 2.0))
            return dict(rho=_pri(p, "uniform_prior", 0.9, -0.999, 0.999),
                        sd_ar=_pri(p, "halfnormal_prior", 0.2, 1.0), **third)
        jm = jsvm(y, **kw(jpri), dtype=jnp.float64)
        tm = bt.svm(y, **kw(bt), dtype=torch.float64, device="cpu")
        th = np.asarray(jm.theta_init) + 0.05 * rng.normal(size=(4, 3))
        return jm, tm, th
    if case.startswith("ar1_ng"):
        y = _counts(n, 2)
        extra = {}
        if case == "ar1_ng negbin":
            extra = dict(distribution="negative binomial",
                         u=rng.uniform(0.5, 2.0, n))
        elif case == "ar1_ng xreg":
            extra = dict(xreg=rng.normal(size=(n, 2)))

        def kw(p):
            out = dict(rho=_pri(p, "uniform_prior", 0.7, -0.999, 0.999),
                       sigma=_pri(p, "halfnormal_prior", 0.3, 1.0),
                       mu=_pri(p, "normal_prior", 1.0, 0.0, 2.0), **extra)
            if case == "ar1_ng negbin":
                out["phi"] = _pri(p, "halfnormal_prior", 2.0, 5.0)
            if case == "ar1_ng xreg":
                out["beta"] = _pri(p, "normal_prior", np.zeros(2), 0.0, 1.0)
            return out
        jm = jar1_ng(y, **kw(jpri), dtype=jnp.float64)
        tm = bt.ar1_ng(y, **kw(bt), dtype=torch.float64, device="cpu")
        t0 = np.asarray(jm.theta_init)
        th = t0 + 0.1 * rng.normal(size=(4, t0.size))
        return jm, tm, th
    Tm = np.array([[1.0, 1.0], [0.0, 1.0]])
    th = np.log([0.1, 0.02]) + 0.2 * rng.normal(size=(4, 2))

    def jprior(t):
        return -0.5 * jnp.sum(jnp.square(t - jnp.log(0.05)))

    def tprior(t):
        return -0.5 * torch.square(t - np.log(0.05)).sum(-1)

    if case == "ssm_ulg":
        y = np.cumsum(rng.normal(0, 0.3, n)) + rng.normal(0, 0.5, n)
        y[[3, n - 1]] = np.nan
        th = np.column_stack([np.log(0.5) + 0.1 * rng.normal(size=4), th])

        def jupd(t):
            return {"H": jnp.exp(t[0])[None],
                    "R": jnp.diag(jnp.exp(t[1:]))[None]}

        def tupd(t):
            return {"H": torch.exp(t[:, :1]),
                    "R": torch.diag_embed(torch.exp(t[:, 1:]))[:, None]}
        args = (y,)
        kw = dict(Z=np.array([1.0, 0.0]), H=0.5, T=Tm, R=np.diag([0.1, 0.02]),
                  a1=np.array([0.0, 0.0]), P1=np.eye(2) * 10.0,
                  D=rng.normal(0, 0.1, n), init_theta=th[0])
        jm = jssm_ulg(*args, **kw, update_fn=jupd, prior_fn=jprior,
                      dtype=jnp.float64)
        tm = bt.ssm_ulg(*args, **kw, update_fn=tupd, prior_fn=tprior,
                        dtype=torch.float64, device="cpu")
        return jm, tm, th
    y = _counts(n, 3)
    kw = dict(Z=np.array([1.0, 0.0]), T=Tm, R=np.diag([0.1, 0.02]),
              distribution="poisson", P1=np.eye(2), a1=np.array([1.0, 0.0]),
              init_theta=np.log([0.1, 0.02]))
    if case == "ssm_ung":
        def jupd(t):
            return {"R": jnp.diag(jnp.exp(t))[None]}

        def tupd(t):
            return {"R": torch.diag_embed(torch.exp(t))[:, None]}
    else:       # a time-varying Z (the R package's (m, n) from the JAX
        # update function, the spec's (n, m) from the port's, unbatched)
        Zt = np.stack([np.ones(n), np.linspace(0.0, 1.0, n)])

        def jupd(t):
            return {"R": jnp.diag(jnp.exp(t))[None], "Z": jnp.asarray(Zt)}

        def tupd(t):
            return {"R": torch.diag_embed(torch.exp(t))[:, None],
                    "Z": torch.as_tensor(Zt.T)}
    jm = jssm_ung(y, **kw, update_fn=jupd, prior_fn=jprior,
                  dtype=jnp.float64)
    tm = bt.ssm_ung(y, **kw, update_fn=tupd, prior_fn=tprior,
                    dtype=torch.float64, device="cpu")
    return jm, tm, th


NG = ["svm sigma", "svm mu", "ar1_ng poisson", "ar1_ng negbin",
      "ar1_ng xreg", "ssm_ung", "ssm_ung tv"]


@pytest.mark.parametrize("case", NG + ["ssm_ulg"])
def test_build_and_prior_match(case):
    jm, tm, th = pair(case)
    assert tm.theta_names == jm.theta_names and tm.kind == jm.kind
    np.testing.assert_array_equal(tm.transforms, jm.transforms)
    np.testing.assert_array_equal(tm.theta_init, np.asarray(jm.theta_init))
    np.testing.assert_array_equal(tm.initial_S(), np.asarray(jm.initial_S()))
    tspec = tm.build(torch.as_tensor(th))
    for i in range(th.shape[0]):
        jspec = jm.build(jnp.asarray(th[i]))
        for name in LEAVES[tm.kind]:
            leaf = getattr(tspec, name)
            got = leaf[i] if leaf.dim() == CORE_NDIM[name] + 1 else leaf
            np.testing.assert_allclose(
                got.numpy(), np.asarray(getattr(jspec, name)), rtol=1e-15,
                atol=0, equal_nan=True, err_msg=f"{case}: {name}")
        if tm.kind == "ng":
            assert tspec.distribution == jspec.distribution
    np.testing.assert_allclose(
        tm.log_prior(torch.as_tensor(th)).numpy(),
        np.asarray(jax.vmap(jm.log_prior)(jnp.asarray(th))), rtol=1e-15)


def _loglik_ref(jm, th):
    if jm.kind == "lg":
        return jax.vmap(lambda t: jkalman.log_likelihood(jm.build(t)))(
            jnp.asarray(th))
    return jax.jit(jax.vmap(
        lambda t: japprox.approx_loglik(jm.build(t)).loglik))(jnp.asarray(th))


@pytest.mark.parametrize("case", NG + ["ssm_ulg"])
def test_loglik_matches(case):
    """The batched log-likelihood (the chains' target) and ``logLik`` of
    one model; a time-varying Z takes the plain route and launches no
    kernel, on the CPU as on the card."""
    jm, tm, th = pair(case)
    ref = np.asarray(_loglik_ref(jm, th))
    assert np.isfinite(ref).all()
    spec = tm.build(torch.as_tensor(th))
    assert ck.kernel_takes(spec, "log_likelihood" if tm.kind == "lg"
                           else "laplace_solve") == (case != "ssm_ung tv")
    if tm.kind == "lg":
        got = ck.routed_log_likelihood(spec)
    else:
        got = bt.approx_loglik(spec).loglik
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)
    np.testing.assert_allclose(bt.logLik(tm, theta=th[1]).numpy(),
                               ref[1:2], rtol=1e-9)


def test_nonfinite_prior_rows_do_not_touch_the_valid_rows():
    """svm samples rho and sd_ar untransformed: |rho| >= 1 or sd_ar < 0
    builds P1 <= 0, a model without meaning.  In one batch with valid rows
    the valid rows' results equal those of the valid rows alone (pass
    counts included: nothing is decided batch-wide); in a chain step such
    proposals are masked: evaluated at the current theta, never
    accepted."""
    _, tm, th = pair("svm sigma")
    bad = th.copy()
    bad[1, 0], bad[3, 1] = 1.2, -0.1
    prior = tm.log_prior(torch.as_tensor(bad))
    assert torch.isinf(prior[[1, 3]]).all() and torch.isfinite(
        prior[[0, 2]]).all()
    mixed = bt.approx_loglik(tm.build(torch.as_tensor(bad)))
    alone = bt.approx_loglik(tm.build(torch.as_tensor(th[[0, 2]])))
    for a, b in ((mixed.loglik, alone.loglik),
                 (mixed.approx.mode, alone.approx.mode),
                 (mixed.approx.niter, alone.approx.niter)):
        np.testing.assert_allclose(a[[0, 2]].numpy(), b.numpy(), rtol=1e-12)

    def logdens(theta):
        assert torch.isfinite(tm.log_prior(theta)).all()
        ll = bt.approx_loglik(tm.build(theta)).loglik
        return ll, ll, None

    cur = torch.as_tensor(th)
    state = tmcmc.ChainState(cur, tm.log_prior(cur), logdens(cur)[0], None,
                             torch.eye(3, dtype=torch.float64).expand(
                                 4, 3, 3).clone(), logdens(cur)[0])
    u = torch.as_tensor(bad - th)
    new, acc = tmcmc._ram_step(logdens, tm.log_prior, state, u,
                               torch.full((4,), 1e-300, dtype=torch.float64),
                               1, 0.234, 2.0 / 3.0, True)
    assert acc.tolist() == [True, False, True, False]
    assert torch.equal(new.theta[[1, 3]], cur[[1, 3]])
    np.testing.assert_allclose(new.ll[[0, 2]].numpy(),
                               alone.loglik.numpy(), rtol=1e-12)
    assert torch.isfinite(new.S).all()


def test_validation_errors_mirror_the_jax_package():
    """The checks of ``tests/test_validate.py`` that the univariate
    constructors use, and the constructors' rejections."""
    n, m = 10, 2
    y = np.arange(1.0, 11.0)
    assert val.check_Z(np.ones(m), 1, n).shape == (m, 1)
    assert val.check_Z(np.ones((m, n)), 1, n).shape == (m, n)
    with pytest.raises(ValueError, match="'Z'"):
        val.check_Z(np.ones((m, 3)), 1, n)
    assert val.check_T(1.0, 1, n).shape == (1, 1, 1)
    assert val.check_T(np.eye(m), m, n).shape == (m, m, 1)
    for bad in (np.ones((m, 3)), np.ones((m, m, 4))):
        with pytest.raises(ValueError, match="'T'"):
            val.check_T(bad, m, n)
    assert val.check_R(np.ones(m), m, n).shape == (m, 1, 1)
    with pytest.raises(ValueError, match="'R'"):
        val.check_R(np.ones((m, m + 1)), m, n)
    assert val.check_a1(None, m).shape == (m,)
    assert val.check_a1(1.0, m).tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="a1"):
        val.check_a1(np.ones(3), m)
    with pytest.raises(ValueError, match="P1"):
        val.check_P1(np.ones((m, 3)), m)
    assert val.check_H(2.0, 1, n).shape == (1,)
    assert val.check_H(np.ones(n), 1, n).shape == (n,)
    with pytest.raises(ValueError, match="'H'"):
        val.check_H(np.ones(3), 1, n)
    assert val.check_D(None, 1, n).shape == (1,)
    with pytest.raises(ValueError, match="'D'"):
        val.check_D(np.ones(4), 1, n)
    assert val.check_C(None, m, n).shape == (m, 1)
    with pytest.raises(ValueError, match="'C'"):
        val.check_C(np.ones((m, 5)), m, n)
    with pytest.raises(ValueError, match="Missing values"):
        val.check_missingness({"T": np.array([1.0, np.nan])})
    cpu = dict(device="cpu")
    for kw in (dict(Z=np.ones((2, 3)), H=1.0, T=np.eye(2), R=np.eye(2)),
               dict(Z=np.ones(2), H=np.ones(3), T=np.eye(2), R=np.eye(2)),
               dict(Z=np.ones(2), H=1.0, T=np.eye(3), R=np.eye(2)),
               dict(Z=np.ones(2), H=1.0, T=np.eye(2), R=np.ones((2, 3)))):
        with pytest.raises(ValueError):
            bt.ssm_ulg(y, **kw, **cpu)
    with pytest.raises(ValueError, match="Missing values"):
        bt.ssm_ulg(y, Z=np.array([1.0, np.nan]), H=1.0, T=np.eye(2),
                   R=np.eye(2), **cpu)
    ung = dict(Z=np.ones(1), T=np.ones((1, 1)), R=np.ones((1, 1)),
               distribution="poisson", **cpu)
    with pytest.raises(ValueError, match="positive finite"):
        bt.ssm_ung(y, u=-1.0, **ung)
    with pytest.raises(ValueError, match="Negative or non-integer"):
        bt.ssm_ung(-y, **ung)
    with pytest.raises(ValueError, match="exactly one"):
        bt.svm(y, rho=bt.uniform_prior(0.9, -1, 1),
               sd_ar=bt.halfnormal_prior(0.1, 1), **cpu)
    with pytest.raises(ValueError, match="Negative or non-integer"):
        bt.ar1_ng(y - 20.0, rho=bt.uniform_prior(0.9, -1, 1),
                  sigma=bt.halfnormal_prior(0.1, 1), **cpu)
    with pytest.raises(ValueError, match="number of columns"):
        bt.ar1_ng(y, rho=bt.uniform_prior(0.9, -1, 1),
                  sigma=bt.halfnormal_prior(0.1, 1), xreg=np.ones((n, 2)),
                  beta=bt.normal_prior(0.0, 0.0, 1.0), **cpu)
    m1 = bt.ssm_ung(y, **ung, update_fn=lambda t: {"R": torch.ones(3, 1)},
                    init_theta=(0.0,))
    with pytest.raises(ValueError, match="update_fn: R"):
        m1.build(torch.zeros(2, 1))
