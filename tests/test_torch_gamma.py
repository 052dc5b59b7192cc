"""PyTorch port vs the JAX package: the ``gamma_airquality_N10`` bench row's
model (``bench.py:205-219``), ``bsm_ng`` gamma level + slope on airquality
Ozone with Wind and Temp as regressors, ``beta`` normal(0, 1), ``phi`` and
the sds with gamma priors.

Both packages build the model from the same arguments on the first 40 days
(12 missing Ozone values among them) in float64.  At a few thetas around
the initial value the port's parameters, priors, specs, approximate
(Laplace) log-likelihood and psi-APF log-likelihood (10 particles, the same
injected normals and uniforms on both sides) are held against the JAX
package's: the same recursions, summed in another order, hence rtol 1e-9
(1e-8 through the particle filter's pseudo-inverse).
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bssm_tpu.core.priors import gamma_prior as jgamma_prior
from bssm_tpu.core.priors import normal_prior as jnormal_prior
from bssm_tpu.inference import approx as japprox
from bssm_tpu.inference import particle as jpf
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.utils.datasets import airquality as jairquality

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.inference import particle as tpf
from bssm_tpu_torch.ops import cuda_kalman

N_DAYS = 40


def _models():
    aq, jaq = bt.airquality(), jairquality()
    for k in ("Ozone", "Wind", "Temp"):
        np.testing.assert_array_equal(np.asarray(aq[k]), np.asarray(jaq[k]))
    y = np.asarray(aq["Ozone"], dtype=float)[:N_DAYS]
    xreg = np.column_stack([aq["Wind"], aq["Temp"]])[:N_DAYS]
    jm = jbsm_ng(y, xreg=xreg, beta=jnormal_prior(np.zeros(2), 0.0, 1.0),
                 distribution="gamma", phi=jgamma_prior(1.0, 2.0, 0.01),
                 sd_level=jgamma_prior(1.0, 2.0, 0.1),
                 sd_slope=jgamma_prior(1.0, 2.0, 0.1), dtype=jnp.float64)
    tm = bt.bsm_ng(y, xreg=xreg, beta=bt.normal_prior(np.zeros(2), 0.0, 1.0),
                   distribution="gamma", phi=bt.gamma_prior(1.0, 2.0, 0.01),
                   sd_level=bt.gamma_prior(1.0, 2.0, 0.1),
                   sd_slope=bt.gamma_prior(1.0, 2.0, 0.1),
                   dtype=torch.float64, device="cpu")
    return jm, tm


def test_gamma_airquality_loglik_matches_jax():
    jm, tm = _models()
    assert tuple(tm.theta_names) == tuple(jm.theta_names) == (
        "sd_level", "sd_slope", "phi", "beta_1", "beta_2")
    np.testing.assert_allclose(tm.theta_init, np.asarray(jm.theta_init),
                               rtol=1e-12)
    rng = np.random.default_rng(17)
    B, N = 4, 10
    thetas = np.asarray(jm.theta_init) + rng.normal(
        0, 1, (B, 5)) * np.array([0.3, 0.3, 0.3, 0.05, 0.01])
    thetas[:, :3] += np.array([-1.0, -3.0, 1.0])
    jth = jnp.asarray(thetas)
    tth = torch.as_tensor(thetas)
    np.testing.assert_allclose(tm.log_prior(tth).numpy(),
                               np.asarray(jax.vmap(jm.log_prior)(jth)),
                               rtol=1e-12)
    # the specs: the regression intercept, R, phi
    jspec = jax.vmap(jm.build)(jth)
    spec = tm.build(tth)
    assert spec.batch == B and spec.distribution == jspec.distribution
    for name in ("D", "R", "phi"):
        np.testing.assert_allclose(
            getattr(spec, name).expand(np.asarray(getattr(jspec, name))
                                       .shape).numpy(),
            np.asarray(getattr(jspec, name)), rtol=1e-12, atol=1e-12)
    # approximate (Laplace) log-likelihood
    jal = jax.vmap(japprox.approx_loglik)(jspec)
    al = tapprox.approx_loglik(spec)
    np.testing.assert_allclose(al.loglik.numpy(), np.asarray(jal.loglik),
                               rtol=1e-9)
    np.testing.assert_allclose(al.approx.mode.numpy(),
                               np.asarray(jal.approx.mode), rtol=1e-9,
                               atol=1e-9)
    # psi-APF log-likelihood from the same randomness
    eps = rng.normal(size=(B, N_DAYS + 1, N, 2))
    us = rng.uniform(size=(B, N_DAYS, N))
    ref = np.asarray(jal.loglik) + np.asarray(jax.vmap(jpf.psi_logw_scan)(
        jspec, jal, jnp.asarray(eps), jnp.asarray(us)))
    before = dict(cuda_kalman.LAUNCHES)
    got = tpf.psi_logw(spec, al, N, eps=torch.as_tensor(eps),
                       us=torch.as_tensor(us))
    assert cuda_kalman.LAUNCHES == before          # CPU: plain versions
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8)
