"""PyTorch port vs the JAX package: one pass of the Laplace iteration (the
module of the ``laplace_step`` kernel) and the single-model solve built on
it.

On CPU tensors ``ops/cuda_kalman.laplace_step`` runs its plain version
(``inference/approx._laplace_step``); it is held against the JAX package's
TPU kernel in interpret mode (``fused_laplace_step_batched``) and against
its plain step under ``vmap`` (``_laplace_step_base``), float64, all five
families, m = 1, 2 and 4, with missing y.  Both sides run the same
recursions in float64 with products summed in another order: tolerance
1e-10 (1 + |ref|).

``approximate`` on one unbatched model runs the single-model solve
(``laplace_solve_steps``), held against the JAX package's unbatched
``approximate`` (its ``_laplace_solve_base`` loop).
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.inference import approx as japprox
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.ops.pallas_kalman import (_laplace_step_base,
                                        fused_laplace_step_batched)

import bssm_tpu_torch as bt
from bssm_tpu_torch.core.spec import drop_batch
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.ops import cuda_kalman

from torch_split_mirror import split_laplace_step

FAMILIES = ["svm", "poisson", "binomial", "negative binomial", "gamma"]


def _close(got, want, tol=1e-10):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _pair(family, m, n=24):
    """The same bsm_ng built by both packages: m = 1 (level), 2 (+ slope),
    4 (level + slope + seasonal(3)); two missing observations."""
    rng = np.random.default_rng(300 + 10 * m + FAMILIES.index(family))
    lam = np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0)
    kw = dict(distribution=family)
    if family == "svm":
        y = rng.normal(0, 1, n) * np.exp(0.3 * np.sin(np.arange(n) / 5))
    elif family == "binomial":
        kw["u"] = np.full(n, 12.0)
        y = rng.binomial(12, lam / (1 + lam)).astype(float)
    elif family == "gamma":
        kw["phi"] = 4.0
        y = rng.gamma(4.0, lam / 4.0)
    else:
        if family == "negative binomial":
            kw["phi"] = 3.0
        y = rng.poisson(lam).astype(float)
    y[[n // 3, n - 2]] = np.nan
    if m == 4:
        kw["period"] = 3
    pri = [("sd_level", 0.1, 1.0)]
    if m in (2, 4):
        pri.append(("sd_slope", 0.01, 0.1))
    if m == 4:
        pri.append(("sd_seasonal", 0.05, 1.0))
    jm = jbsm_ng(y, dtype=jnp.float64, **kw,
                 **{k: j_halfnormal(a, b) for k, a, b in pri})
    tm = bt.bsm_ng(y, dtype=torch.float64, device="cpu", **kw,
                   **{k: bt.halfnormal_prior(a, b) for k, a, b in pri})
    return jm, tm


def _thetas(model, B, seed):
    rng = np.random.default_rng(seed)
    t0 = np.asarray(model.theta_init, dtype=np.float64)
    return t0[None] + 0.3 * rng.normal(size=(B, t0.shape[0]))


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_laplace_step_matches_kernel_and_vmapped_step(family, m):
    """new mode, log-likelihood and mean-squared change of one pass at a
    perturbed mode, for three rows."""
    jm, tm = _pair(family, m)
    B = 3
    th = _thetas(jm, B, seed=m)
    jspec = jax.vmap(jm.build)(jnp.asarray(th))
    tspec = tm.build(torch.as_tensor(th))
    n = tspec.n
    mode = (np.asarray(jspec.initial_mode)
            + 0.2 * np.random.default_rng(m).normal(size=(B, n)))
    got = cuda_kalman.laplace_step(tspec, torch.as_tensor(mode))
    kern = fused_laplace_step_batched(jspec, jnp.asarray(mode), B,
                                      interpret=True)
    assert kern is not None
    base = jax.vmap(_laplace_step_base)(jspec, jnp.asarray(mode))
    for g, k, b, name in zip(got, kern, base, ("mode", "ll", "diff")):
        assert torch.isfinite(g).all(), name
        _close(g, k)
        _close(g, b)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("family", ["poisson", "svm"])
def test_split_step_matches_kernel_interpret(family, m):
    """One pass split as the laplace_step kernel runs it
    (``torch_split_mirror.split_laplace_step``: the pseudo-observations of
    every step first, the filter, the split backward pass, the new mode
    and its squared change for every step, their mean in the kernel's
    lane order), float64, missing y: within 1e-10 of the JAX package's
    TPU kernel in interpret mode, and of the port's plain step."""
    jm, tm = _pair(family, m)
    B = 3
    th = _thetas(jm, B, seed=10 + m)
    jspec = jax.vmap(jm.build)(jnp.asarray(th))
    tspec = tm.build(torch.as_tensor(th))
    mode = (np.asarray(jspec.initial_mode)
            + 0.2 * np.random.default_rng(10 + m).normal(size=(B,
                                                               tspec.n)))
    got = split_laplace_step(tspec, torch.as_tensor(mode))
    kern = fused_laplace_step_batched(jspec, jnp.asarray(mode), B,
                                      interpret=True)
    plain = cuda_kalman.laplace_step(tspec, torch.as_tensor(mode))
    for g, k, p, name in zip(got, kern, plain, ("mode", "ll", "diff")):
        assert torch.isfinite(g).all(), name
        _close(g, k)
        _close(g, p, tol=1e-12)


@pytest.mark.parametrize("family", ["poisson", "svm", "gamma"])
def test_unbatched_approximate_matches_jax(family):
    """One model, as the public API hands it over: the port's single-model
    solve against the JAX package's unbatched ``approximate``."""
    jm, tm = _pair(family, 2)
    th = _thetas(jm, 1, seed=5)[0]
    want = japprox.approximate(jm.build(jnp.asarray(th)))
    spec = drop_batch(tm.build(torch.as_tensor(th)))
    assert spec.batch is None
    got = tapprox.approximate(spec)
    assert int(got.niter[0]) == int(want.niter)
    for name in ("mode", "ytilde", "Htilde"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=1e-10, equal_nan=True,
                                   err_msg=name)
    _close(got.diff[0], want.diff, tol=1e-12)
    _close(got.gloglik[0], want.gloglik)


def test_approximate_dispatches_by_call_site(monkeypatch):
    """An unbatched spec goes to the step loop, a batched one to the whole
    solve; on the CPU both are the same plain loop and agree exactly."""
    _, tm = _pair("poisson", 2)
    th = torch.as_tensor(_thetas(tm, 2, seed=2))
    calls = []
    for name in ("laplace_step", "laplace_solve"):
        fn = getattr(cuda_kalman, name)
        monkeypatch.setattr(cuda_kalman, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))
    one = tapprox.approximate(drop_batch(tm.build(th[0])))
    assert set(calls) == {"laplace_step"}
    calls.clear()
    both = tapprox.approximate(tm.build(th))
    assert calls == ["laplace_solve"]
    assert torch.equal(one.mode[0], both.mode[0])
    assert torch.equal(one.gloglik[0], both.gloglik[0])


def test_step_loop_stops_row_by_row():
    """``laplace_solve_steps`` on a batch: a converged row keeps its mode,
    previous mode, log-likelihood, change and pass count while the others
    go on, so it equals the whole solve's plain version row for row."""
    _, tm = _pair("gamma", 2)
    th = np.asarray(tm.theta_init) + np.array([[-2.0, -2.0], [0.0, 0.0],
                                               [1.5, 1.0], [2.5, -1.0]])
    spec = tm.build(torch.as_tensor(th))
    conv = 1e-8
    a = tapprox.laplace_solve_steps(spec, spec.initial_mode, conv, 100)
    b = tapprox.laplace_solve_plain(spec, spec.initial_mode, conv, 100)
    assert len(set(a[2].tolist())) > 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="one model"):
        drop_batch(spec)
