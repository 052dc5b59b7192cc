"""PyTorch port vs the JAX package: observation families, priors and the
``bsm_ng`` model constructor.

Both sides run in float64 on the CPU from the same numpy inputs.  The
functions are elementwise formulas evaluated in the same order, so the
tolerance is a few ulps: rtol 1e-12 (lgamma and exp differ in the last
digits between the two libraries).
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import distributions as jfam
from bssm_tpu.core import priors as jpri
from bssm_tpu.models import bsm as jbsm

from bssm_tpu_torch.core import distributions as tfam
from bssm_tpu_torch.core import priors as tpri
from bssm_tpu_torch.models import bsm as tbsm

RTOL = 1e-12
FAMILIES = ["svm", "poisson", "binomial", "negbin", "gamma"]
CODE = {"svm": 0, "poisson": 1, "binomial": 2, "negbin": 3, "gamma": 4}


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _family_inputs(family, seed, n=25):
    rng = np.random.default_rng(seed)
    signal = rng.normal(0.3, 0.8, n)
    u = np.ones(n)
    phi = 1.0
    if family == "svm":
        y = rng.normal(0, 1, n)
        y[3] = 0.0                      # the |y| < 1e-4 guard
        phi = 0.7
    elif family == "poisson":
        u = rng.uniform(0.5, 2.0, n)
        y = rng.poisson(u * np.exp(signal)).astype(float)
    elif family == "binomial":
        u = rng.integers(3, 12, n).astype(float)
        y = rng.binomial(u.astype(int), 1 / (1 + np.exp(-signal))).astype(float)
    elif family == "negbin":
        u = rng.uniform(0.5, 2.0, n)
        phi = 2.5
        y = rng.poisson(u * np.exp(signal)).astype(float)
    else:
        u = rng.uniform(0.5, 2.0, n)
        phi = 3.0
        y = rng.gamma(phi, u * np.exp(signal) / phi)
    y[5] = np.nan
    y[n - 1] = np.nan
    ytilde = signal + rng.normal(0, 0.2, n)
    ytilde[np.isnan(y)] = np.nan
    Htilde = rng.uniform(0.3, 1.5, n)
    return y, u, phi, signal, ytilde, Htilde


def _close(t_val, j_val, rtol=RTOL):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=rtol,
                               atol=1e-13, equal_nan=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_elementwise_match(family):
    """laplace_match, log_obs_density, log_weights and scales, with NaN y."""
    d = CODE[family]
    y, u, phi, s, yt, Ht = _family_inputs(family, 11)
    jy, ju, js, jyt, jHt = map(jnp.asarray, (y, u, s, yt, Ht))
    ty, tu, ts, tyt, tHt = map(_t, (y, u, s, yt, Ht))
    tphi = _t(phi)
    a, b = tfam.laplace_match(d, ty, tu, tphi, ts)
    ja, jb = jfam.laplace_match(d, jy, ju, phi, js)
    _close(a, ja)
    _close(b, jb)
    _close(tfam.log_obs_density(d, ty, tu, tphi, ts),
           jfam.log_obs_density(d, jy, ju, phi, js))
    _close(tfam.log_weights(d, ty, tu, tphi, ts, tyt, tHt),
           jfam.log_weights(d, jy, ju, phi, js, jyt, jHt))
    _close(tfam.scales(d, ty, tu, tphi, ts, tyt, tHt),
           jfam.scales(d, jy, ju, phi, js, jyt, jHt))


@pytest.mark.parametrize("family", FAMILIES)
def test_family_constants_match_batched(family):
    """Normalising constants; the port sums over time per batch row and takes
    a batched phi as a column."""
    d = CODE[family]
    rows = [_family_inputs(family, 20 + i) for i in range(3)]
    phis = np.array([r[2] * (1 + 0.1 * i) for i, r in enumerate(rows)])
    Y, U, YT, HT = (np.stack([r[k] for r in rows]) for k in (0, 1, 4, 5))
    tphi = _t(phis)[:, None]
    got_o = tfam.obs_log_const(d, _t(Y), _t(U), tphi)
    got_g = tfam.gauss_log_const(_t(YT), _t(HT))
    got_c = tfam.const_term(d, _t(Y), _t(U), tphi, _t(YT), _t(HT))
    for i in range(3):
        jo = jfam.obs_log_const(d, jnp.asarray(Y[i]), jnp.asarray(U[i]),
                                phis[i])
        jg = jfam.gauss_log_const(jnp.asarray(YT[i]), jnp.asarray(HT[i]))
        _close(got_o[i], jo)
        _close(got_g[i], jg)
        _close(got_c[i], jo - jg, rtol=1e-11)   # a difference of two sums


def test_safe_exp_caps_by_dtype():
    x64 = torch.tensor([0.0, 100.0, 800.0], dtype=torch.float64)
    x32 = x64.to(torch.float32)
    np.testing.assert_allclose(tfam.safe_exp(x64).numpy(),
                               np.exp([0.0, 100.0, 700.0]), rtol=RTOL)
    assert tfam.safe_exp(x32)[2] == torch.exp(torch.tensor(80.0))
    assert torch.isfinite(tfam.safe_exp(x32)).all()


def _prior_list(mod):
    return [mod.uniform_prior(0.5, 0.0, 2.0), mod.halfnormal_prior(0.1, 1.0),
            mod.normal_prior(0.2, 0.0, 2.0),
            mod.tnormal_prior(0.3, 0.1, 1.0, -1.0, 1.5),
            mod.gamma_prior(1.0, 2.0, 0.5),
            mod.normal_prior(np.array([0.1, -0.2]), 0.0, 1.0)]


def test_prior_stack_log_pdf_batched():
    """The 5 prior families, identity and log transforms, inside and outside
    the supports, evaluated on a batch of thetas."""
    tr = [0, 1, 0, 0, 1, 0, 0]
    js = jpri.PriorStack.from_priors(_prior_list(jpri), tr)
    ts = tpri.PriorStack.from_priors(_prior_list(tpri), tr)
    assert ts.d == js.d == 7
    np.testing.assert_array_equal(ts.dists, js.dists)
    np.testing.assert_array_equal(ts.params, np.asarray(js.params))
    rng = np.random.default_rng(3)
    theta = rng.normal(0.3, 0.8, (16, 7))
    theta[0, 0] = 2.5          # outside the uniform support
    theta[1, 3] = -1.5         # outside the truncated normal
    theta[2, 2] = 7.0
    got = ts.log_pdf(_t(theta))
    ref = jax.vmap(js.log_pdf)(jnp.asarray(theta))
    assert got.shape == (16,)
    _close(got, ref)
    assert np.isneginf(got[0].item()) and np.isneginf(got[1].item())
    np.testing.assert_allclose(ts.init_theta([0.5, 0.1, 0.2, 0.3, 1.0, 0.1,
                                              -0.2]),
                               np.asarray(js.init_theta(
                                   [0.5, 0.1, 0.2, 0.3, 1.0, 0.1, -0.2])),
                               rtol=RTOL)


def _compare_specs(tspec, jspecs, B):
    """Port spec (batched leaves) vs a list of per-theta JAX specs."""
    from bssm_tpu_torch.core.spec import CORE_NDIM
    assert tspec.distribution == jspecs[0].distribution
    for name in ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u",
                 "initial_mode"):
        leaf = getattr(tspec, name)
        batched = leaf.dim() == CORE_NDIM[name] + 1
        for i in range(B):
            ref = np.asarray(getattr(jspecs[i], name))
            got = (leaf[i] if batched else leaf).numpy()
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0,
                                       equal_nan=True, err_msg=name)


def _build_both(kw_fn, thetas):
    jm = jbsm.bsm_ng(**kw_fn(jpri), dtype=jnp.float64)
    tm = tbsm.bsm_ng(**kw_fn(tpri), dtype=torch.float64, device="cpu")
    assert tm.theta_names == jm.theta_names
    np.testing.assert_allclose(tm.theta_init, np.asarray(jm.theta_init),
                               rtol=RTOL)
    np.testing.assert_array_equal(tm.transforms, jm.transforms)
    np.testing.assert_allclose(tm.initial_S(), np.asarray(jm.initial_S()),
                               rtol=RTOL)
    tspec = tm.build(_t(thetas))
    jspecs = [jm.build(jnp.asarray(th)) for th in thetas]
    _compare_specs(tspec, jspecs, len(thetas))
    _close(tm.log_prior(_t(thetas)),
           jax.vmap(jm.log_prior)(jnp.asarray(thetas)))
    _close(tm.to_natural(_t(thetas)), jm.to_natural(jnp.asarray(thetas)))
    return tm, jm


def test_bsm_ng_build_poisson_level_slope():
    rng = np.random.default_rng(5)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, 30)))).astype(float)
    y[4] = np.nan

    def kw(p):
        return dict(y=y, sd_level=p.halfnormal_prior(0.1, 1.0),
                    sd_slope=p.halfnormal_prior(0.01, 0.1),
                    distribution="poisson")

    tm, _ = _build_both(kw, rng.normal(-2.5, 0.3, (5, 2)))
    assert tm.extra["m"] == 2 and tm.n_par == 2
    # a single theta is a batch of one
    assert tm.build(_t(tm.theta_init)).R.shape == (1, 1, 2, 2)


def test_bsm_ng_build_gamma_xreg():
    from bssm_tpu.utils.datasets import airquality
    aq = airquality()
    oz = np.asarray(aq["Ozone"], dtype=float)[:40]
    xreg = np.column_stack([aq["Wind"], aq["Temp"]])[:40]

    def kw(p):
        return dict(y=oz, xreg=xreg,
                    beta=p.normal_prior(np.zeros(2), 0.0, 1.0),
                    distribution="gamma", phi=p.gamma_prior(1.0, 2.0, 0.01),
                    sd_level=p.gamma_prior(1.0, 2.0, 0.1),
                    sd_slope=p.gamma_prior(1.0, 2.0, 0.1))

    rng = np.random.default_rng(6)
    thetas = np.column_stack([rng.normal(-1.0, 0.3, (4, 3)),
                              rng.normal(0.0, 0.01, (4, 2))])
    tm, _ = _build_both(kw, thetas)
    assert tm.theta_names == ("sd_level", "sd_slope", "phi", "beta_1",
                              "beta_2")
    assert tm.build(_t(thetas)).D.shape == (4, 40)


def test_bsm_ng_build_negbin_seasonal_noise():
    """Seasonal + noise: the seasonal row of T reaches into the noise column
    and the noise sd enters both R and P1."""
    rng = np.random.default_rng(7)
    y = rng.poisson(3.0, 30).astype(float)
    u = rng.uniform(0.5, 2.0, 30)

    def kw(p):
        return dict(y=y, sd_level=p.halfnormal_prior(0.1, 1.0),
                    sd_seasonal=p.halfnormal_prior(0.05, 1.0),
                    sd_noise=p.halfnormal_prior(0.2, 1.0), period=4,
                    distribution="negative binomial",
                    phi=p.gamma_prior(2.0, 2.0, 0.5),
                    u=u)

    tm, _ = _build_both(kw, rng.normal(-1.5, 0.3, (3, 4)))
    spec = tm.build(_t(rng.normal(-1.5, 0.3, (3, 4))))
    assert spec.m == 5 and spec.P1.shape == (3, 5, 5)
    assert spec.T[0, 1, 4].item() == -1.0


def test_validation_errors_carry_over():
    with pytest.raises(ValueError, match="non-integer"):
        tbsm.bsm_ng(np.array([1.0, 2.5, 3.0]),
                    sd_level=tpri.halfnormal_prior(0.1, 1.0), device="cpu")
    with pytest.raises(ValueError, match="period"):
        tbsm.bsm_ng(np.arange(10.0), sd_level=0.1,
                    sd_seasonal=tpri.halfnormal_prior(0.1, 1.0), period=2,
                    device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tbsm.bsm_ng(np.arange(10.0), sd_level=0.1, u=np.zeros(10),
                    device="cpu")
