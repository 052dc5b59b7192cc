"""PyTorch port vs the JAX package: the particle filters above 512
particles, on the CPU.

Above ``cuda_kalman.MAX_N_BIG`` the JAX package runs its keyed scans, not a
kernel; the port runs the same recursions as plain tensor code over all
rows (``psi_logw_scan`` / ``bsf_logw_scan``), drawing each step's uniforms
and normals from the generator at that step.  Both carry their weights
between resamplings in their own way: the JAX scans as linear weights,
which underflow to 0 in the far tail, the port as log-weights.  The exact
check therefore starts from an informative initial state, where the two
agree; the others compare in mean over keys.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import distributions as jfam
from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.inference import approx as japprox
from bssm_tpu.inference import particle as jpf
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng

from bssm_tpu_torch.convert import approx_from_numpy, ngspec_from_numpy
from bssm_tpu_torch.inference import particle as tpf
from bssm_tpu_torch.ops import cuda_kalman as ck

FIELDS = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u",
          "initial_mode")
N = 640


def _jax_model(n=20, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    y = y.astype(float)
    y[n // 3] = np.nan
    return jbsm_ng(y, sd_level=j_halfnormal(0.1, 1.0),
                   sd_slope=j_halfnormal(0.01, 0.1), distribution="poisson",
                   a1=np.array([1.0, 0.0]), P1=np.diag([1.0, 0.01]),
                   dtype=jnp.float64)


def _both(jm, B):
    """The JAX package's (spec, ApproxLoglik with zero loglik) at the
    initial theta, and the port's with B equal rows."""
    jspec = jm.build(jnp.asarray(jm.theta_init))
    al = japprox.approx_loglik(jspec)
    z = jnp.zeros((), jnp.float64)
    jal = japprox.ApproxLoglik(al.approx, al.scales, z, z)
    d = {k: np.asarray(getattr(jspec, k)) for k in FIELDS}
    d["distribution"] = jspec.distribution
    spec = ngspec_from_numpy(d, device="cpu", dtype=torch.float64)
    spec = spec.__class__(**{**spec.__dict__, "R": spec.R.expand(
        B, *spec.R.shape)})
    tal = approx_from_numpy(
        {k: np.repeat(np.asarray(v)[None], B, 0) for k, v in
         (("mode", jal.approx.mode), ("ytilde", jal.approx.ytilde),
          ("Htilde", jal.approx.Htilde), ("scales", jal.scales))},
        device="cpu", dtype=torch.float64)
    return jspec, jal, spec, tal


def test_plain_tier_matches_the_jax_scan_on_injected_draws():
    """N = 640, one model at an informative initial state: the port's
    ``psi_logw`` (which sends N > 512 to the plain tier, launching nothing)
    on the draws fed to the JAX package's ``psi_logw_scan``: within
    1e-10."""
    jm = _jax_model()
    jspec, jal, spec, tal = _both(jm, 1)
    n = jspec.n
    rng = np.random.default_rng(1)
    eps = rng.normal(size=(n + 1, N, 2))
    us = rng.uniform(size=(n, N))
    ref = float(jax.jit(jpf.psi_logw_scan)(jspec, jal, jnp.asarray(eps),
                                           jnp.asarray(us)))
    before = dict(ck.LAUNCHES)
    got = tpf.psi_logw(spec, tal, N, eps=torch.as_tensor(eps)[None],
                       us=torch.as_tensor(us)[None])
    assert ck.LAUNCHES == before and np.isfinite(ref)
    assert abs(float(got[0]) - ref) < 1e-10, (float(got[0]), ref)


@pytest.mark.parametrize("kk", [1, 4])
def test_plain_tier_draws_are_the_injected_stream(kk):
    """The plain tier fed a generator gives, to the bit, what it gives fed
    the tensors ``stream_draws`` makes from a generator in the same state:
    its per-step draws are the stream the tests inject (psi and bsf, with
    the resampling period kk)."""
    jm = _jax_model(n=12)
    _, _, spec, tal = _both(jm, 3)
    n = spec.n
    a = tpf.psi_logw(spec, tal, N, torch.Generator().manual_seed(2),
                     resample_every=kk)
    eps, us = tpf.stream_draws(torch.Generator().manual_seed(2), 3, n + 1, N,
                               2, torch.float64, "cpu")
    assert torch.equal(a, tpf.psi_logw(spec, tal, N, eps=eps, us=us,
                                       resample_every=kk))
    a = tpf.bsf_logw(spec, N, torch.Generator().manual_seed(3),
                     resample_every=kk)
    eps, us = tpf.stream_draws(torch.Generator().manual_seed(3), 3, n, N, 2,
                               torch.float64, "cpu")
    assert torch.equal(a, tpf.bsf_logw(spec, N, eps=eps, us=us,
                                       resample_every=kk))


def _agree_in_mean(ref, got):
    """Means of two samples of log-likelihood estimates within 4.5 combined
    standard errors."""
    se = np.sqrt(ref.var(ddof=1) / ref.size + got.var(ddof=1) / got.size)
    assert abs(ref.mean() - got.mean()) < 4.5 * se, (ref.mean(), got.mean(),
                                                     se)


def test_bsf_plain_tier_matches_jax_in_mean():
    """The bootstrap filter at N = 640: the JAX package's ``bsf_filter``
    log-likelihood less the observation constants over 64 keys, and the
    port's plain tier over 64 rows of the same model."""
    jm = _jax_model()
    jspec, _, spec, _ = _both(jm, 64)
    const = jfam.obs_log_const(jspec.distribution, jspec.y, jspec.u,
                               jspec.phi)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda k: jpf.bsf_filter(jspec, N, k).loglik - const))(
            jax.random.split(jax.random.PRNGKey(4), 64)))
    got = tpf.bsf_logw_scan(spec, generator=torch.Generator().manual_seed(5),
                            nsim=N).numpy()
    assert got.shape == (64,) and np.isfinite(got).all()
    _agree_in_mean(ref, got)


def test_resample_every_4_matches_the_jax_keyed_scan_in_mean():
    """The psi filter at N = 640 resampling at every fourth step: the JAX
    package's ``_psi_logw_keyed(resample_every=4)`` over 64 keys, and the
    port's plain tier over 64 rows."""
    jm = _jax_model()
    jspec, jal, spec, tal = _both(jm, 64)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda k: jpf._psi_logw_keyed(jspec, jal, N, k, resample_every=4)))(
            jax.random.split(jax.random.PRNGKey(6), 64)))
    got = tpf.psi_logw(spec, tal, N, torch.Generator().manual_seed(7),
                       resample_every=4).numpy()
    assert np.isfinite(got).all()
    _agree_in_mean(ref, got)
