"""PyTorch port vs the JAX package: the posterior diagnostics
(``diagnostics/summary.py``) and the host library under them (``native/``).

Both sides take the same numpy arrays, made from a seed, and run the same
numpy code, the port's a copy: values agree to rtol 1e-12 and the printed
strings are equal.  ``iact`` runs numpy below 2000 draws and the native
library above; the port's numpy path is also held against its native path
on the same long series.  ``summary`` and ``check_diagnostics`` take an
``McmcOutput`` that each package builds from the same arrays, no MCMC run.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import numpy as np
import pytest

from bssm_tpu import native as jnative
from bssm_tpu.diagnostics import summary as jsum
from bssm_tpu.inference.mcmc import McmcOutput as JOut

from bssm_tpu_torch import native as tnative
from bssm_tpu_torch.diagnostics import summary as tsum
from bssm_tpu_torch.inference.mcmc import McmcOutput as TOut

RTOL = 1e-12


def _ar1(n, rho, seed, chains=None):
    """AR(1) draws, (n,) or (chains, n): autocorrelated like a chain."""
    rng = np.random.default_rng(seed)
    shape = (n,) if chains is None else (chains, n)
    e = rng.normal(size=shape)
    x = np.empty(shape)
    x[..., 0] = e[..., 0]
    for t in range(1, n):
        x[..., t] = rho * x[..., t - 1] + e[..., t]
    return x


def outputs(seed=0, C=3, S=60, d=2, n=9, m=2, states=True, weights=True):
    """The same arrays as an ``McmcOutput`` of each package."""
    rng = np.random.default_rng(seed)
    theta = np.exp(0.3 * _ar1(C * S * d, 0.7, seed + 1).reshape(C, S, d))
    kw = dict(theta=theta, posterior=rng.normal(-50.0, 2.0, (C, S)),
              accepted=rng.uniform(size=(C, S)) < 0.3,
              acceptance_rate=0.29, S=np.tile(np.eye(d) * 0.1, (C, 1, 1)),
              theta_names=tuple(f"sd_{j}" for j in range(d)),
              mcmc_type="is2", output_type="full", iter=2 * S, burnin=S,
              thin=1, prior=rng.normal(-3.0, 0.5, (C, S)),
              time={"mcmc": 1.25, "correction": 0.5})
    if weights:
        kw["weights"] = rng.gamma(5.0, 0.2, (C, S))
    if states:
        kw["alpha"] = rng.normal(size=(C, S, n + 1, m))
    return JOut(**kw), TOut(**kw)


@pytest.mark.parametrize("n", [600, 1999, 2001, 3000])
def test_iact_asymptotic_var_and_ess_match(n):
    """Both sides of 2000 draws, where iact goes native; weighted and
    unweighted."""
    x = _ar1(n, 0.8, n)
    w = np.random.default_rng(n).gamma(4.0, 0.25, n)
    np.testing.assert_allclose(tsum.iact(x), jsum.iact(x), rtol=RTOL)
    for ww in (None, w):
        np.testing.assert_allclose(tsum.asymptotic_var(x, ww),
                                   jsum.asymptotic_var(x, ww), rtol=RTOL)
        np.testing.assert_allclose(tsum.estimate_ess(x, ww),
                                   jsum.estimate_ess(x, ww), rtol=RTOL)
    assert tsum.ess_is(w) == jsum.ess_is(w)


def test_iact_numpy_path_equals_native_path(monkeypatch):
    """One long series through the native library and through the numpy
    loop (the library reported absent): the same Sokal window."""
    assert tnative.get_lib() is not None
    x = _ar1(3000, 0.9, 5)
    native = tsum.iact(x)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    np.testing.assert_allclose(tsum.iact(x), native, rtol=RTOL)
    xs = np.stack([x, _ar1(3000, 0.5, 6)])
    np.testing.assert_allclose(tnative.iact_batch(xs),
                               jnative.iact_batch(xs), rtol=RTOL)


@pytest.mark.parametrize("fn", ["rhat", "ess_bulk", "ess_tail",
                                "rhat_rank"])
@pytest.mark.parametrize("case", ["mixing", "stuck", "ties"])
def test_multichain_diagnostics_match(fn, case):
    """Split, rank-normalised and folded diagnostics of (chains, draws):
    well-mixed chains, one chain off by a shift, and draws with ties (the
    average ranks)."""
    c = _ar1(240, 0.6, 11, chains=4)
    if case == "stuck":
        c[0] += 3.0
    elif case == "ties":
        c = np.round(c)
    np.testing.assert_allclose(getattr(tsum, fn)(c), getattr(jsum, fn)(c),
                               rtol=RTOL)


def _rows_close(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], str):
                assert a[k] == b[k]
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("variable", ["theta", "states"])
@pytest.mark.parametrize("return_se", [False, True])
def test_summary_matches(variable, return_se):
    jo, to = outputs()
    _rows_close(tsum.summary(to, variable, return_se),
                jsum.summary(jo, variable, return_se))


def test_summary_of_unweighted_output_and_quantiles():
    jo, to = outputs(weights=False, states=False)
    probs = (0.1, 0.5, 0.9)
    _rows_close(tsum.summary(to, "theta", True, probs),
                jsum.summary(jo, "theta", True, probs))
    with pytest.raises(ValueError, match="full"):
        tsum.summary(to, "states")


@pytest.mark.parametrize("weights", [True, False])
def test_check_diagnostics_text_is_equal(weights):
    jo, to = outputs(seed=3, C=4, S=80, weights=weights)
    text = tsum.check_diagnostics(to)
    assert text == jsum.check_diagnostics(jo)
    assert "bulk-ESS" in text and ("IS weight ESS" in text) == weights


def test_native_helpers_match():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(500, 3))
    w = rng.gamma(2.0, 1.0, 500)
    w[::7] = 0.0                        # zero weights are skipped
    for got, ref in zip(tnative.weighted_moments(x, w),
                        jnative.weighted_moments(x, w)):
        np.testing.assert_allclose(got, ref, rtol=RTOL)
    p = rng.dirichlet(np.ones(40))
    r = rng.uniform(size=25)
    np.testing.assert_array_equal(tnative.stratified_sample(p, r),
                                  jnative.stratified_sample(p, r))
    np.testing.assert_array_equal(tnative.iact_batch(x.T),
                                  jnative.iact_batch(x.T))


def test_native_library_builds_into_the_ports_build_directory():
    from pathlib import Path
    import bssm_tpu_torch
    lib = Path(bssm_tpu_torch.__file__).parent / "_build" / "libfastdiag.so"
    assert tnative.get_lib() is not None and lib.is_file()
