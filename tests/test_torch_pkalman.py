"""PyTorch port vs the JAX package: the time-parallel Kalman option.

``bssm_tpu_torch/ops/pkalman.py`` (the associative-scan filter and fast
smoother, batch first) against ``bssm_tpu/ops/pkalman.py``, and the Laplace
approximation under ``core.config.parallel_time()`` against the JAX
package's under its own ``parallel_time()``, all in float64 on the CPU.
Both sides compose the same elements in the same odd/even tree, so they
agree to roundoff: rtol 1e-9 on the filter and smoother (atol 1e-12 for
entries near 0; the values are of order 1), 1e-8 on the Laplace mode and
log-likelihoods (the iteration compounds a few passes of roundoff).  The
JAX side runs under ``jax.jit`` (one compilation in place of one a
primitive and shape).
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import config as jconfig
from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.inference import approx as japprox
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.ops import pkalman as jpk

import bssm_tpu_torch as bt
from bssm_tpu_torch.convert import lgspec_from_numpy
from bssm_tpu_torch.core import config as tconfig
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.inference.filters import spec_of
from bssm_tpu_torch.ops import kalman as tkalman
from bssm_tpu_torch.ops import pkalman as tpk
from test_torch_approx import _jax_model, _specs
from tests.test_kalman import random_lg

RTOL, ATOL = 1e-9, 1e-12


def _affine_maps(n: int, seed: int):
    """Offsets ``(2, n, 3)`` and matrices ``(1, n, 3, 3)`` (shared by both
    rows, so the scan's broadcasting over rows is exercised): 0.97 times
    orthogonal matrices, so that products over 300 steps stay of order 1."""
    rng = np.random.default_rng(seed)
    M = np.stack([0.97 * np.linalg.qr(rng.normal(size=(3, 3)))[0]
                  for _ in range(n)])[None]
    b = rng.normal(size=(2, n, 3))
    return torch.as_tensor(b), torch.as_tensor(M)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 17, 300])
def test_scan_matches_sequential_fold(n, reverse):
    """The log-depth scan against the step-by-step fold of the same
    operator (``fn(earlier, later)``; reversed: ``fn(suffix of the later
    steps, earlier step)``), rtol 1e-12 with an atol of 1e-12 times the
    largest entry: the tree sums the same products in another order."""
    b, M = _affine_maps(n, seed=n + 7 * reverse)
    got_b, got_M = tpk._scan(tpk._affine, (b, M), reverse=reverse)
    order = range(n - 1, -1, -1) if reverse else range(n)
    ref_b, ref_M = [None] * n, [None] * n
    acc = None
    for t in order:
        e = (b[:, t], M[:, t])
        acc = e if acc is None else tpk._affine(acc, e)
        ref_b[t], ref_M[t] = acc
    for got, ref in ((got_b, torch.stack(ref_b, 1)),
                     (got_M, torch.stack(ref_M, 1))):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(ref.abs().max()))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_inverse_of_small_matrices(m):
    """``_inverse`` (Gauss-Jordan with partial pivoting) against
    ``torch.linalg.inv`` on random matrices I + C J (C, J symmetric PSD,
    as the scan builds them) and, at m = 2, on I + C J with a zero first
    pivot ([[0, 7], [-2, 15]]), which elimination without row swaps cannot
    invert; rtol 1e-12."""
    rng = np.random.default_rng(m)
    X, Y = rng.normal(size=(2, 50, m, m))
    A = np.eye(m) + (X @ X.swapaxes(-1, -2)) @ (Y @ Y.swapaxes(-1, -2))
    if m == 2:
        C = np.array([[1.0, 2.0], [2.0, 4.0]])
        J = np.array([[1.0, -1.0], [-1.0, 4.0]])
        A[0] = np.eye(2) + C @ J
        assert A[0, 0, 0] == 0.0
    A = torch.as_tensor(A)
    np.testing.assert_allclose(tpk._inverse(A).numpy(),
                               torch.linalg.inv(A).numpy(), rtol=1e-12,
                               atol=1e-12)


def _stacked(n: int, tv: bool, seed: int):
    """Three ``random_lg`` specs (missing y at steps 2 and 7) as JAX specs
    and as the rows of one batched port spec."""
    rng = np.random.default_rng(seed)
    jspecs = [random_lg(rng, n=n, m=3, k=2, missing=True, tv=tv)
              for _ in range(3)]
    d = {k: np.stack([np.asarray(getattr(s, k)) for s in jspecs])
         for k in jspecs[0]._fields}
    return jspecs, lgspec_from_numpy(d, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("tv", [False, True])
def test_kfilter_parallel_matches_jax(tv):
    """All five fields of ``kfilter_parallel`` at n = 17, m = 3, k = 2, row
    by row of a batch of three specs."""
    jspecs, tspec = _stacked(17, tv, seed=1 + tv)
    got = tpk.kfilter_parallel(tspec)
    for i, js in enumerate(jspecs):
        ref = jax.jit(jpk.kfilter_parallel)(js)
        for f in ref._fields:
            np.testing.assert_allclose(getattr(got, f)[i].numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("tv", [False, True])
def test_fast_smoother_parallel_matches_jax(tv):
    """Smoothed means ``(B, n+1, m)`` at n = 23, row by row of a batch of
    three specs; the log-likelihood of the same pass equals the filter's."""
    jspecs, tspec = _stacked(23, tv, seed=3 + tv)
    alpha, ll = tpk.fast_smoother_ll_parallel(tspec)
    smoother = jax.jit(jpk.fast_smoother_parallel)
    assert alpha.shape == (3, 24, 3)
    np.testing.assert_array_equal(ll.numpy(),
                                  tpk.log_likelihood_parallel(tspec).numpy())
    np.testing.assert_array_equal(alpha.numpy(),
                                  tpk.fast_smoother_parallel(tspec).numpy())
    for i, js in enumerate(jspecs):
        np.testing.assert_allclose(alpha[i].numpy(),
                                   np.asarray(smoother(js)),
                                   rtol=RTOL, atol=ATOL)


def test_log_likelihood_parallel_long_series():
    """n = 300 (an unbatched spec): the JAX package's parallel value and the
    port's sequential Kalman filter."""
    js = random_lg(np.random.default_rng(5), n=300, m=2, k=1, missing=False)
    ts = lgspec_from_numpy({k: np.asarray(getattr(js, k))
                            for k in js._fields}, device="cpu",
                           dtype=torch.float64)
    got = tpk.log_likelihood_parallel(ts)
    assert got.shape == (1,)
    np.testing.assert_allclose(got.numpy(),
                               float(jax.jit(jpk.log_likelihood_parallel)(js)),
                               rtol=RTOL)
    np.testing.assert_allclose(got.numpy(),
                               tkalman.log_likelihood(ts).numpy(), rtol=1e-8)


def _poisson_level():
    """``tests/test_pkalman.py``'s model: a Poisson local level, n = 40, at
    its initial theta (one model, unbatched)."""
    y = np.random.default_rng(42).poisson(2.0, 40).astype(float)
    jm = jbsm_ng(y, sd_level=j_halfnormal(0.2, 1.0), distribution="poisson")
    tm = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.2, 1.0),
                   distribution="poisson", dtype=torch.float64, device="cpu")
    return jm.build(jm.theta_init), spec_of(tm)


def _pair(case):
    if case == "bsm_ng poisson n=40":
        return _poisson_level()
    model, thetas = _jax_model(case, 30, 7, jnp.float64)
    jspec, tspec = _specs(model, thetas, jnp.float64, torch.float64)
    return jspec, tspec


@pytest.mark.parametrize("case", ["bsm_ng poisson n=40", "svm",
                                  "negative binomial"])
def test_approximation_under_parallel_time_matches_jax(case):
    """``approximate`` / ``approx_loglik`` under ``parallel_time()`` on both
    sides (the negative binomial series has a missing y): mode, ytilde,
    Htilde, the pass count, the approximate log-likelihood and the Gaussian
    one, which the port takes from the last pass and the JAX package
    recomputes with ``log_likelihood_parallel``.  The flag is read at call
    time and restored after the block."""
    jspec, tspec = _pair(case)
    batched = case != "bsm_ng poisson n=40"
    with jconfig.parallel_time():
        jal = jax.jit(jax.vmap(japprox.approx_loglik) if batched
                      else japprox.approx_loglik)(jspec)
    with tconfig.parallel_time():
        tal = tapprox.approx_loglik(tspec)
    assert tconfig.time_parallel is False
    rows = lambda x: np.asarray(x).reshape(tal.loglik.shape[0], -1)  # noqa
    np.testing.assert_array_equal(tal.approx.niter.numpy(),
                                  rows(jal.approx.niter)[:, 0])
    for name in ("mode", "ytilde", "Htilde"):
        np.testing.assert_allclose(getattr(tal.approx, name).numpy(),
                                   rows(getattr(jal.approx, name)),
                                   rtol=1e-8, atol=1e-10, equal_nan=True,
                                   err_msg=name)
    for name in ("loglik", "gaussian_loglik"):
        np.testing.assert_allclose(getattr(tal, name).numpy(),
                                   rows(getattr(jal, name))[:, 0], rtol=1e-8,
                                   err_msg=name)
    # the sequential route reaches the same fixed point
    seq = tapprox.approx_loglik(tspec)
    np.testing.assert_allclose(seq.approx.mode.numpy(),
                               tal.approx.mode.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_gaussian_loglik_of_a_rebuilt_approximation():
    """``approx_loglik`` of an approximation without a Gaussian
    log-likelihood (rebuilt at stored modes) takes it from
    ``log_likelihood_parallel`` under the flag, as the JAX package's
    ``approx.py:146-148`` does."""
    model, thetas = _jax_model("poisson", 30, 11, jnp.float64)
    jspec, tspec = _specs(model, thetas, jnp.float64, torch.float64)
    modes = np.random.default_rng(1).normal(1.0, 0.3, (4, 30))
    with jconfig.parallel_time():
        jal = jax.jit(jax.vmap(lambda s, mo: japprox.approx_loglik(
            s, japprox.approximate_for_is(s, mo))))(jspec, jnp.asarray(modes))
    with tconfig.parallel_time():
        tal = tapprox.approx_loglik(tspec, tapprox.approximate_for_is(
            tspec, torch.as_tensor(modes)))
    np.testing.assert_allclose(tal.loglik.numpy(), np.asarray(jal.loglik),
                               rtol=1e-8)


def test_run_mcmc_under_parallel_time_equals_sequential():
    """is2 / psi, 2 chains x 100 iterations, float64: under
    ``parallel_time()`` phase 1 and the correction's cold Laplace solves
    run through the scans, yet the approximate log-likelihoods agree to
    roundoff, so every accept decision is the same and theta and the
    weights equal the sequential run's to 1e-8."""
    rng = np.random.default_rng(0)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, 60)) + 1.0))
    y = y.astype(float)
    y[17] = np.nan
    m = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                  sd_slope=bt.halfnormal_prior(0.01, 0.1),
                  distribution="poisson", dtype=torch.float64, device="cpu")
    kw = dict(iter=100, particles=10, mcmc_type="is2",
              sampling_method="psi", n_chains=2, seed=4, device="cpu",
              store_modes=False)
    seq = bt.run_mcmc(m, **kw)
    with tconfig.parallel_time():
        par = bt.run_mcmc(m, **kw)
    np.testing.assert_allclose(par.theta, seq.theta, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(par.weights, seq.weights, rtol=1e-8)
    assert par.acceptance_rate == seq.acceptance_rate


def test_parallel_time_restores_and_set_time_parallel_sets():
    assert tconfig.time_parallel is False
    with pytest.raises(ZeroDivisionError):
        with tconfig.parallel_time():
            assert tconfig.time_parallel is True
            1 / 0
    assert tconfig.time_parallel is False
    with tconfig.parallel_time(False):
        assert tconfig.time_parallel is False
    try:
        tconfig.set_time_parallel(1)
        assert tconfig.time_parallel is True
        with tconfig.parallel_time(False):
            assert tconfig.time_parallel is False
        assert tconfig.time_parallel is True
    finally:
        tconfig.set_time_parallel(False)
    assert tconfig.time_parallel is False


def test_new_modules_leave_jax_out():
    """``ops.pkalman`` and ``diagnostics.profiling`` import neither jax nor
    the JAX package."""
    code = ("import sys, bssm_tpu_torch.ops.pkalman, "
            "bssm_tpu_torch.diagnostics.profiling\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bssm_tpu')]\n"
            "assert not bad, bad\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
