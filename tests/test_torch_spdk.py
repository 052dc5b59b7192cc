"""PyTorch port vs the JAX package: SPDK importance sampling and the batched
simulation smoother it draws with, on the CPU.

- ``spdk_weights`` fed the draws of the JAX package's ``spdk_sample`` gives
  its log-likelihood and weights (Poisson, negative binomial, SV);
- ``simulate_states_batched`` with injected normals is ``simulate_states``
  row by row;
- ``importance_sample`` and ``logLik(method="spdk")`` agree with the psi
  filter's estimate within Monte-Carlo error;
- the is2 correction rows of ``sampling_method="spdk"`` (log-weight, the
  weighted moments, the drawn trajectory) against the JAX package's
  ``_make_correct_one`` on the draws it made.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.core.priors import uniform_prior as j_uniform
from bssm_tpu.inference import approx as japprox
from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.inference import particle as jpf
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.models.svm import svm as jsvm

import bssm_tpu_torch as bt
from bssm_tpu_torch.convert import approx_from_numpy, ngspec_from_numpy
from bssm_tpu_torch.core.spec import CORE_NDIM, LGSpec
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.inference import particle as tpf
from bssm_tpu_torch.ops import cuda_kalman as ck
from bssm_tpu_torch.ops import simsmooth as tsim

FIELDS = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u",
          "initial_mode")


def _pair(family, n=30, seed=0):
    """The same model on both sides."""
    rng = np.random.default_rng(seed)
    if family == "svm":
        h = np.zeros(n)
        for t in range(1, n):
            h[t] = 0.9 * h[t - 1] + 0.3 * rng.normal()
        y = 0.8 * np.exp(h / 2) * rng.normal(size=n)
        kw = dict(rho=(0.9, -0.999, 0.999), sd_ar=(0.3, 1.0),
                  sigma=(0.8, 2.0))
        jm = jsvm(y, rho=j_uniform(*kw["rho"]),
                  sd_ar=j_halfnormal(*kw["sd_ar"]),
                  sigma=j_halfnormal(*kw["sigma"]), dtype=jnp.float64)
        tm = bt.svm(y, rho=bt.uniform_prior(*kw["rho"]),
                    sd_ar=bt.halfnormal_prior(*kw["sd_ar"]),
                    sigma=bt.halfnormal_prior(*kw["sigma"]),
                    dtype=torch.float64, device="cpu")
        return jm, tm
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    y = y.astype(float)
    y[n // 3] = np.nan
    dist = "poisson" if family == "poisson" else "negative binomial"
    extra = {} if family == "poisson" else dict(phi=3.0)
    jm = jbsm_ng(y, sd_level=j_halfnormal(0.1, 1.0),
                 sd_slope=j_halfnormal(0.01, 0.1), distribution=dist,
                 dtype=jnp.float64, **extra)
    tm = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                   sd_slope=bt.halfnormal_prior(0.01, 0.1), distribution=dist,
                   dtype=torch.float64, device="cpu", **extra)
    return jm, tm


def _port_spec(jspec):
    d = {k: np.asarray(getattr(jspec, k)) for k in FIELDS}
    d["distribution"] = jspec.distribution
    return ngspec_from_numpy(d, device="cpu", dtype=torch.float64)


def _port_al(jal):
    """The port's ApproxLoglik of one model (batch of one) from the JAX
    package's, log-likelihood included."""
    al = approx_from_numpy(
        dict(mode=np.asarray(jal.approx.mode)[None],
             ytilde=np.asarray(jal.approx.ytilde)[None],
             Htilde=np.asarray(jal.approx.Htilde)[None],
             scales=np.asarray(jal.scales)[None]), device="cpu",
        dtype=torch.float64)
    return al._replace(loglik=torch.tensor([float(jal.loglik)],
                                           dtype=torch.float64))


@pytest.mark.parametrize("family", ["poisson", "negbin", "svm"])
def test_spdk_weights_match_jax_on_its_draws(family):
    """The JAX package's ``spdk_sample`` at N = 20 (antithetic); its draws
    through the port's ``spdk_weights`` with its approximation: loglik and
    weights within 1e-10."""
    jm, _ = _pair(family)
    jspec = jm.build(jnp.asarray(jm.theta_init))
    jal, r = jax.jit(lambda sp: (lambda al: (al, jpf.spdk_sample(
        sp, al, 20, jax.random.PRNGKey(3))))(japprox.approx_loglik(sp)))(
            jspec)
    ll, w = tpf.spdk_weights(_port_spec(jspec), _port_al(jal),
                             torch.as_tensor(np.array(r.alpha))[None])
    assert np.isfinite(float(r.loglik))
    np.testing.assert_allclose(ll.numpy()[0], float(r.loglik), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(w.numpy()[0], np.asarray(r.weights), rtol=0,
                               atol=1e-10)


def test_batched_simulation_smoother_is_the_single_one_row_by_row():
    """Three approximating models of different theta, seven draws each
    (antithetic: four base draws) from injected normals: each row equals
    ``simulate_states`` of that model alone on its normals, exactly; the
    antithetic half mirrors the base half about alphahat."""
    _, tm = _pair("poisson", n=25, seed=2)
    th = torch.as_tensor(np.asarray(tm.theta_init) + np.array(
        [[0.0, 0.0], [0.4, -0.3], [-0.5, 0.6]]))
    spec = tm.build(th)
    ar = bt.approximate(spec)
    g = ar.gaussian(spec)
    B, n, m, k = 3, spec.n, spec.m, spec.k
    rng = np.random.default_rng(4)
    um, eps, eta = (torch.as_tensor(rng.normal(size=s))
                    for s in ((B, 4, m), (B, 4, n), (B, 4, n, k)))
    got = tsim.simulate_states_batched(g, 7, um=um, eps=eps, eta=eta)
    assert got.shape == (B, 7, n + 1, m)
    for b in range(B):
        gb = LGSpec(*[x[b] if x.dim() > CORE_NDIM[f] else x
                      for f, x in zip(LGSpec._fields, g)])
        want = tsim.simulate_states(gb, 7, um=um[b], eps=eps[b],
                                    eta=eta[b])
        assert torch.equal(got[b], want), b
    ahat, _ = ck.routed_fast_smoother_ll(g)
    np.testing.assert_allclose((got[:, :3] + got[:, 4:]).numpy(),
                               2 * ahat[:, None].expand(-1, 3, -1, -1),
                               rtol=1e-12)


def test_importance_sample_and_spdk_loglik_within_monte_carlo_error():
    """One model, N = 200: the SPDK estimate of ``importance_sample`` and of
    ``logLik(method="spdk")`` (eight seeds each) against the psi filter's
    estimate at N = 200 (eight seeds): the means within 4 combined standard
    errors; the weights are normalised, the draws finite."""
    _, tm = _pair("poisson", n=30, seed=5)
    r = bt.importance_sample(tm, 200, seed=1)
    assert r.alpha.shape == (200, 31, 2) and torch.isfinite(r.alpha).all()
    assert abs(float(r.weights.sum()) - 1.0) < 1e-12
    sp = np.array([float(bt.logLik(tm, 200, "spdk", seed=s))
                   for s in range(8)])
    assert float(r.loglik) == float(bt.logLik(tm, 200, "spdk", seed=1))
    ps = np.array([float(bt.logLik(tm, 200, "psi", seed=s)[0])
                   for s in range(8)])
    se = np.sqrt(sp.var(ddof=1) / 8 + ps.var(ddof=1) / 8)
    assert abs(sp.mean() - ps.mean()) < 4 * se + 1e-6, (sp, ps)


def test_is2_spdk_correction_rows_match_jax_on_its_draws():
    """Phase 2 with ``sampling_method="spdk"`` at N = 12: the JAX package's
    ``_make_correct_one`` (states and moments) on five thetas and the
    stored modes, and the port's ``_make_correct_rows`` fed the draws that
    correction made (its ``spdk`` family op on the same key): log_w, the
    weighted mean and covariance within 1e-10; the port's trajectory is one
    of the draws, the one its injected uniform picks."""
    jm, tm = _pair("poisson", n=24, seed=7)
    n, N, B = 24, 12, 5
    rng = np.random.default_rng(8)
    thetas = np.asarray(jm.theta_init) + 0.3 * rng.normal(size=(B, 2))
    ops = jmcmc._family_ops(jm, 1e-8, 100)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    correct_one = jmcmc._make_correct_one(jm, N, "spdk")

    @jax.jit
    def jax_side(th, keys):
        modes = jax.vmap(lambda t: ops.approx_eval(jm.build(t), None)[1])(th)
        ref = jax.vmap(lambda t, mo, k: correct_one((t, mo, k)))(
            th, modes, keys)
        draws = jax.vmap(lambda t, mo, k: ops.spdk(
            jm.build(t), mo, N, jax.random.split(k)[0])[1])(th, modes, keys)
        return modes, ref, draws

    modes, ref, draws = jax_side(jnp.asarray(thetas), keys)
    correct = tmcmc._make_correct_rows(tm, N, "spdk", want_states=True,
                                       want_moments=True)
    u = torch.as_tensor(rng.uniform(size=B))
    got = correct(torch.as_tensor(thetas), torch.as_tensor(np.array(modes)),
                  None, states=torch.as_tensor(np.array(draws)), u_pick=u)
    np.testing.assert_allclose(got["log_w"].numpy(), np.asarray(ref["log_w"]),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["mean"].reshape(B, -1).numpy(),
                               np.asarray(ref["mean"]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["Vt"].reshape(B, -1).numpy(),
                               np.asarray(ref["Vt"]), rtol=0, atol=1e-10)
    spec = tm.build(torch.as_tensor(thetas))
    al = tmcmc._psi_al(spec, tapprox.approximate_for_is(
        spec, torch.as_tensor(np.array(modes))))
    _, w = tpf.spdk_weights(spec, al, torch.as_tensor(np.array(draws)))
    cw = np.cumsum(w.numpy(), axis=1)
    for b in range(B):
        i = min(int(np.searchsorted(cw[b], u[b].item() * cw[b, -1],
                                    side="right")), N - 1)
        assert torch.equal(got["alpha"][b],
                           torch.as_tensor(np.array(draws))[b, i])
