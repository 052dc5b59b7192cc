"""PyTorch port vs the JAX package: the Laplace (Gaussian-approximation)
mode iteration, i.e. the module that holds the ``laplace_solve`` kernel.

On CPU tensors the port's wrapper runs the kernel's plain version
(``inference/approx.laplace_solve_plain``); it is held against the JAX scan
path (per-row stopping, like the port) in float64 and against the Pallas
kernel in interpret mode in float32.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import config as jconfig
from bssm_tpu.core.priors import halfnormal_prior, uniform_prior
from bssm_tpu.inference import approx as japprox
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.models.svm import svm as jsvm

from bssm_tpu_torch.convert import ngspec_from_numpy
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.ops import cuda_kalman

FAMILIES = ["svm", "poisson", "binomial", "negative binomial", "gamma"]
SPEC_FIELDS = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u",
               "initial_mode")


def _jax_model(family, n, seed, dtype):
    rng = np.random.default_rng(seed)
    if family == "svm":
        y = rng.normal(0, 1, n) * np.exp(0.3 * np.sin(np.arange(n) / 5))
        y[n // 2] = np.nan
        model = jsvm(y, rho=uniform_prior(0.9, -0.999, 0.999),
                     sd_ar=halfnormal_prior(0.3, 1.0),
                     sigma=halfnormal_prior(1.0, 2.0), dtype=dtype)
        thetas = np.stack([rng.normal([0.9, -1.2, 0.0], 0.05)
                           for _ in range(4)])
        return model, thetas
    lam = np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0)
    kw = dict(sd_level=halfnormal_prior(0.1, 1),
              sd_slope=halfnormal_prior(0.01, 0.1), distribution=family,
              dtype=dtype)
    if family == "binomial":
        kw["u"] = np.full(n, 12.0)
        y = rng.binomial(12, lam / (1 + lam)).astype(float)
    elif family == "gamma":
        kw["phi"] = 4.0
        y = rng.gamma(4.0, lam / 4.0)
    else:
        if family == "negative binomial":
            kw["phi"] = 3.0
        y = rng.poisson(lam).astype(float)
    y[n // 3] = np.nan
    model = jbsm_ng(y, **kw)
    thetas = rng.normal(-2.5, 0.4, (4, 2))
    return model, thetas


def _specs(model, thetas, jdtype, tdtype):
    """The same batch of specs on both sides: vmapped JAX spec, and the
    port's spec made from its numpy arrays."""
    jspec = jax.vmap(model.build)(jnp.asarray(thetas, jdtype))
    d = {k: np.asarray(getattr(jspec, k)) for k in SPEC_FIELDS}
    # leaves that do not depend on theta (the data; for the structural
    # models also Z, T, C, a1) are handed over unbatched, as the port's own
    # models keep them
    for k in ("y", "u", "Z", "T", "C", "a1", "initial_mode"):
        if (d[k] == d[k][:1]).all() or k in ("y", "u", "initial_mode"):
            d[k] = d[k][0]
    d["distribution"] = jspec.distribution
    return jspec, ngspec_from_numpy(d, device="cpu", dtype=tdtype)


@pytest.mark.parametrize("family", FAMILIES)
def test_approximate_matches_scan_path(family):
    """mode, ytilde, Htilde and the pass count equal the JAX scan path's;
    approximate log-likelihood to rtol 1e-9.  Both iterate each row to its
    own convergence in float64; sums are taken in another order, hence 1e-9
    and not the ulp."""
    model, thetas = _jax_model(family, 30, 7, jnp.float64)
    jspec, tspec = _specs(model, thetas, jnp.float64, torch.float64)
    assert not jconfig.use_fused()
    jal = jax.vmap(japprox.approx_loglik)(jspec)
    before = dict(cuda_kalman.LAUNCHES)
    tal = tapprox.approx_loglik(tspec)
    assert cuda_kalman.LAUNCHES == before      # CPU tensors launch nothing
    np.testing.assert_array_equal(tal.approx.niter.numpy(),
                                  np.asarray(jal.approx.niter))
    assert int(tal.approx.niter.max()) < 100
    for name in ("mode", "ytilde", "Htilde"):
        np.testing.assert_allclose(getattr(tal.approx, name).numpy(),
                                   np.asarray(getattr(jal.approx, name)),
                                   rtol=1e-9, atol=1e-10, equal_nan=True,
                                   err_msg=name)
    np.testing.assert_allclose(tal.scales.numpy(), np.asarray(jal.scales),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tal.loglik.numpy(), np.asarray(jal.loglik),
                               rtol=1e-9)
    np.testing.assert_allclose(tal.gaussian_loglik.numpy(),
                               np.asarray(jal.gaussian_loglik), rtol=1e-9)


def test_rows_stop_on_their_own():
    """A row that converges early keeps its values while the others go on:
    solving a row alone gives what it gets inside a batch."""
    model, thetas = _jax_model("svm", 30, 9, jnp.float64)
    _, tspec = _specs(model, thetas, jnp.float64, torch.float64)
    full = tapprox.approximate(tspec)
    assert len(set(full.niter.tolist())) > 1
    tm = tapprox
    for i in (0, 3):
        _, one = _specs(model, thetas[i:i + 1], jnp.float64, torch.float64)
        alone = tm.approximate(one)
        assert int(alone.niter[0]) == int(full.niter[i])
        np.testing.assert_allclose(alone.mode[0].numpy(),
                                   full.mode[i].numpy(), rtol=1e-12)


def test_approximate_for_is_matches():
    model, thetas = _jax_model("poisson", 30, 11, jnp.float64)
    jspec, tspec = _specs(model, thetas, jnp.float64, torch.float64)
    modes = np.random.default_rng(1).normal(1.0, 0.3, (4, 30))
    jar = jax.vmap(japprox.approximate_for_is)(jspec, jnp.asarray(modes))
    tar = tapprox.approximate_for_is(tspec, torch.as_tensor(modes))
    for name in ("mode", "ytilde", "Htilde"):
        np.testing.assert_allclose(getattr(tar, name).numpy(),
                                   np.asarray(getattr(jar, name)),
                                   rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize("family", ["poisson", "negative binomial", "svm"])
def test_approximate_matches_pallas_interpret_f32(family):
    """Plain version (float32) vs the TPU kernel in interpret mode.  The TPU
    kernel stops per block of rows and the port per row, so the kernel is
    given one row at a time: then both stop at the same pass, the modes
    agree to float32 rounding accumulated over the passes (atol 1e-4 on a
    signal of order 1 to 10) and the log-likelihoods to rtol 1e-4."""
    from bssm_tpu.ops.pallas_kalman import fused_laplace_solve_batched
    model, thetas = _jax_model(family, 30, 13, jnp.float32)
    jspec, tspec = _specs(model, thetas, jnp.float32, torch.float32)
    conv_tol = max(1e-8, 50.0 * float(jnp.finfo(jnp.float32).eps))
    mode0 = jnp.asarray(jspec.initial_mode, jnp.float32)
    old = jconfig.fused_kernels
    outs = []
    try:
        jconfig.set_fused_kernels(True)
        for i in range(4):
            one = jax.tree_util.tree_map(lambda a: a[i:i + 1], jspec)
            outs.append(fused_laplace_solve_batched(
                one, mode0[i:i + 1], conv_tol, 100, 1, interpret=True))
    finally:
        jconfig.set_fused_kernels(old)
    assert all(o is not None for o in outs)
    kmode, _, kniter, _, kll = (np.concatenate([np.asarray(o[k])
                                                for o in outs])
                                for k in range(5))
    res = tapprox.approximate(tspec)
    assert res.mode.dtype == torch.float32
    np.testing.assert_array_equal(res.niter.numpy(), kniter)
    np.testing.assert_allclose(res.mode.numpy(), np.asarray(kmode),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.gloglik.numpy(), np.asarray(kll),
                               rtol=1e-4)


def test_conv_tol_clamped_to_dtype():
    """A tolerance below float32's noise floor would exhaust max_iter; it is
    clamped to 50 eps, so float32 converges in a handful of passes."""
    model, thetas = _jax_model("poisson", 30, 15, jnp.float32)
    _, tspec = _specs(model, thetas, jnp.float32, torch.float32)
    res = tapprox.approximate(tspec, conv_tol=1e-12)
    assert int(res.niter.max()) < 20
