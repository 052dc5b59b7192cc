"""PyTorch port vs the JAX package: the linear-Gaussian models and the
Kalman log-likelihood and fast-smoother kernels' plain versions, on the CPU
in float64 (the smoothers and the simulation smoother are in
``tests/test_torch_lg_smooth.py``).

``ops/cuda_kalman.log_likelihood`` and ``fast_smoother_ll`` run their plain
versions on CPU tensors; they are held against the JAX package's Pallas
kernels in interpret mode (``fused_log_likelihood_batched``,
``fused_fast_smoother_ll_batched``) and against its scan path.

Tolerances: both sides run the same recursions in float64 with products
summed in another order, so they agree to rtol 1e-9 with an absolute floor
of 1e-9 times the largest magnitude of the compared array (the smoothed
means of a diffuse P1 = 100 I start near 1e2).
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import priors as jpri
from bssm_tpu.models.ar1 import ar1_lg as jar1_lg
from bssm_tpu.models.bsm import bsm_lg as jbsm_lg
from bssm_tpu.ops import kalman as jkalman
from bssm_tpu.ops.pallas_kalman import (fused_fast_smoother_ll_batched,
                                        fused_log_likelihood_batched)
from bssm_tpu.utils.datasets import airquality as j_airquality

import bssm_tpu_torch as bt
from bssm_tpu_torch.ops import cuda_kalman
from bssm_tpu_torch.ops import kalman as tkalman

RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = np.nanmax(np.abs(np.where(np.isfinite(want), want, 0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9 * (1 + scale))


def _pair(kind, n=24, seed=0):
    """The same linear-Gaussian model built by both packages.

    ``bsm1``..``bsm4``: bsm_lg with m = 1 (level), 2 (+ slope), 3 (level +
    seasonal(3)), 4 (level + slope + seasonal(3)), two regressors (a
    time-varying D) and three missing observations; ``ar1``: ar1_lg with mu,
    sd_y and a regressor (a1, P1, C and D vary over rows); ``ar1_fixed``:
    ar1_lg with fixed mu and sd_y; ``aq``: bssm's README model, bsm_lg level
    + slope on airquality Ozone (37 missing) with Wind and Temp."""
    if kind == "aq":
        d = j_airquality()
        y, xreg = d["Ozone"], np.column_stack([d["Wind"], d["Temp"]])
        kw = dict(xreg=xreg)
        pri = dict(beta=("normal_prior", np.zeros(2), 0.0, 1.0),
                   sd_y=("gamma_prior", 1.0, 2.0, 0.01),
                   sd_level=("gamma_prior", 1.0, 2.0, 0.01),
                   sd_slope=("gamma_prior", 1.0, 2.0, 0.01))
        return _build(jbsm_lg, bt.bsm_lg, y, kw, pri)
    rng = np.random.default_rng(100 + seed)
    y = np.cumsum(rng.normal(0, 0.3, n)) + rng.normal(0, 0.5, n)
    y[[3, n // 2, n - 1]] = np.nan
    if kind.startswith("ar1"):
        y = y * 0.3
        if kind == "ar1":
            kw = dict(xreg=rng.normal(size=(n, 1)))
            pri = dict(rho=("uniform_prior", 0.6, -0.999, 0.999),
                       sigma=("halfnormal_prior", 0.3, 1.0),
                       mu=("normal_prior", 0.2, 0.0, 2.0),
                       sd_y=("halfnormal_prior", 0.4, 1.0),
                       beta=("normal_prior", np.zeros(1), 0.0, 1.0))
        else:
            kw = dict(mu=0.1, sd_y=0.5)
            pri = dict(rho=("uniform_prior", 0.6, -0.999, 0.999),
                       sigma=("halfnormal_prior", 0.3, 1.0))
        return _build(jar1_lg, bt.ar1_lg, y, kw, pri)
    m = int(kind[-1])
    kw = dict(xreg=rng.normal(size=(n, 2)))
    pri = dict(sd_y=("halfnormal_prior", 0.5, 1.0),
               sd_level=("halfnormal_prior", 0.3, 1.0),
               beta=("normal_prior", np.zeros(2), 0.0, 1.0))
    if m in (2, 4):
        pri["sd_slope"] = ("halfnormal_prior", 0.05, 0.1)
    if m in (3, 4):
        pri["sd_seasonal"] = ("halfnormal_prior", 0.2, 1.0)
        kw["period"] = 3
    return _build(jbsm_lg, bt.bsm_lg, y, kw, pri)


def _build(jfn, tfn, y, kw, pri):
    jkw = {k: getattr(jpri, v[0])(*v[1:]) for k, v in pri.items()}
    tkw = {k: getattr(bt, v[0])(*v[1:]) for k, v in pri.items()}
    jm = jfn(y, **kw, **jkw, dtype=jnp.float64)
    tm = tfn(y, **kw, **tkw, dtype=torch.float64, device="cpu")
    return jm, tm


def _thetas(model, B, seed, spread=0.3):
    rng = np.random.default_rng(seed)
    t0 = np.asarray(model.theta_init, dtype=np.float64)
    th = t0[None] + spread * rng.normal(size=(B, t0.shape[0]))
    if "rho" in model.theta_names:        # keep |rho| < 1
        th[:, 0] = np.clip(th[:, 0], -0.95, 0.95)
    return th


def _specs(jm, tm, th):
    """(JAX spec with every leaf batched, the port's spec) at ``th``."""
    jspec = jax.vmap(jm.build)(jnp.asarray(th))
    return jspec, tm.build(torch.as_tensor(th))


SWEEP = ["bsm1", "bsm2", "bsm3", "bsm4", "ar1"]


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_airquality_matches_the_jax_package():
    t, j = bt.airquality(), j_airquality()
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("kind", ["aq", "bsm3", "bsm4", "ar1", "ar1_fixed"])
def test_build_and_prior_match(kind):
    """Every leaf of the built spec and the log-prior, for a batch of
    thetas (xreg folded into D, NaN y kept, LOG-sampled sds)."""
    jm, tm = _pair(kind)
    assert tm.kind == "lg" and tm.theta_names == tuple(jm.theta_names)
    np.testing.assert_array_equal(tm.transforms, jm.transforms)
    np.testing.assert_allclose(tm.theta_init, np.asarray(jm.theta_init),
                               rtol=0)
    th = _thetas(jm, 5, seed=1)
    jspec, tspec = _specs(jm, tm, th)
    for name in jspec._fields:
        want = np.asarray(getattr(jspec, name))
        got = np.broadcast_to(getattr(tspec, name).numpy(), want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0,
                                   err_msg=name)
    _close(tm.log_prior(torch.as_tensor(th)),
           jax.vmap(jm.log_prior)(jnp.asarray(th)))


# ---------------------------------------------------------------------------
# the two kernels' plain versions (K6, K7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", SWEEP + ["aq"])
def test_log_likelihood_matches_kernel_and_scan(kind):
    """The port's ``log_likelihood`` (the plain version of its Kalman
    log-likelihood kernel) against the JAX package's kernel in interpret mode
    and its scan path, m = 1..4 with missing y and time-varying D."""
    jm, tm = _pair(kind)
    B = 5
    jspec, tspec = _specs(jm, tm, _thetas(jm, B, seed=2))
    got = cuda_kalman.log_likelihood(tspec)
    _close(got, fused_log_likelihood_batched(jspec, B, interpret=True))
    _close(tkalman.log_likelihood(tspec),
           jax.vmap(jkalman.log_likelihood)(jspec))
    assert torch.isfinite(got).all()


def test_degenerate_rule_follows_the_kernel_wrapper():
    """State sds of 1e-5 and an observation sd of 1e-6: the kernel wrapper's
    rule (H^2 over time plus |R R'|) calls the model degenerate, the scan
    path's (H^2 once plus |R|) does not.  The port's log_likelihood (the
    target of its linear-Gaussian MCMC) follows the kernel on either device;
    a regular row in the same batch is unchanged."""
    jm, tm = _pair("bsm2")
    th = _thetas(jm, 3, seed=3)
    th[0, :3] = np.log([1e-6, 1e-5, 1e-5])
    jspec, tspec = _specs(jm, tm, th)
    kern = np.asarray(fused_log_likelihood_batched(jspec, 3, interpret=True))
    scan = np.asarray(jax.vmap(jkalman.log_likelihood)(jspec))
    assert kern[0] == -np.inf and np.isfinite(scan[0])
    got = cuda_kalman.log_likelihood(tspec)
    assert got[0].item() == -np.inf
    _close(got[1:], kern[1:])
    assert bool(tkalman.degenerate_h2rr(tspec)[0])
    assert not bool(tkalman._degenerate(tspec)[0])
    _, ll = cuda_kalman.fast_smoother_ll(tspec)
    assert ll[0].item() == -np.inf
    _close(ll[1:], kern[1:])


@pytest.mark.parametrize("kind", SWEEP)
def test_fast_smoother_ll_matches_kernel(kind):
    """The port's ``fast_smoother_ll`` (the plain version of its
    fast-smoother kernel) against the JAX package's kernel in interpret
    mode."""
    jm, tm = _pair(kind)
    B = 4
    jspec, tspec = _specs(jm, tm, _thetas(jm, B, seed=4))
    ja, jl = fused_fast_smoother_ll_batched(jspec, B, interpret=True)
    ta, tl = cuda_kalman.fast_smoother_ll(tspec)
    assert ta.shape == (B, tspec.n + 1, tspec.m)
    _close(ta, ja)
    _close(tl, jl)


def test_cuda_wrappers_refuse_nothing_on_the_cpu_and_count_no_launch():
    """On CPU tensors the wrappers run their plain versions and leave the
    launch counts alone."""
    jm, tm = _pair("bsm2")
    _, tspec = _specs(jm, tm, _thetas(jm, 2, seed=5))
    cuda_kalman.reset_launch_counts()
    cuda_kalman.log_likelihood(tspec)
    cuda_kalman.fast_smoother_ll(tspec)
    assert cuda_kalman.LAUNCHES["log_likelihood"] == 0
    assert cuda_kalman.LAUNCHES["fast_smoother_ll"] == 0
