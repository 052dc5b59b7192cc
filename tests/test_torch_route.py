"""PyTorch port vs the JAX package: the route for models outside the
kernels' contract, and ``logLik`` of a linear-Gaussian model with
particles.

- ``cuda_kalman.kernel_takes`` decides from a spec's shape alone whether a
  kernel takes it: it takes the main model (``bsm_ng`` level + slope),
  ``bsm_lg`` on airquality, ``ar1_lg`` and an ``ssm_ung`` whose batched
  update function sets R per row, and declines a period-12 seasonal
  ``bsm_ng`` / ``bsm_lg`` (m = 12, 13), a time-varying Z (set directly or
  by an ``ssm_ung``'s update function) and, in bootstrap mode only, an R
  with more columns than states.  The call sites
  then run the plain versions; ``route`` counts that in ``PLAIN_ROUTES``
  for specs on the card only.
- The plain route at period 12 (n = 48, float64) against the JAX package on
  the CPU with its kernels declined, as its own tests run it: the
  approximate log-likelihood and mode (batched and single-model solves),
  the Kalman log-likelihood of ``bsm_lg``, and the psi log-weight from
  injected ``eps``/``us`` (N = 10, and N = 40 against the keyed filters
  with their draws rebuilt).  Both sides run the same recursions in
  float64 with products summed in another order: rtol 1e-9.
- ``logLik`` of a linear-Gaussian model with ``particles`` > 0 is the exact
  Kalman log-likelihood, as the JAX package's, to 1e-9.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import config as jconfig
from bssm_tpu.core import priors as jpri
from bssm_tpu.inference import approx as japprox
from bssm_tpu.inference import loglik as jloglik
from bssm_tpu.inference import particle as jpf
from bssm_tpu.models.bsm import bsm_lg as jbsm_lg
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.ops import kalman as jkalman

import bssm_tpu_torch as bt
from bssm_tpu_torch.convert import approx_from_numpy
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.inference import particle as tpf
from bssm_tpu_torch.inference.filters import spec_of
from bssm_tpu_torch.ops import cuda_kalman as ck
from tests.test_torch_big import _keyed_draws
from tests.test_torch_lg import _build, _close, _pair

RTOL = 1e-9
N_OBS = 48
WRAPPERS = tuple(ck.PLAIN_ROUTES)


def _monthly(seed, n=N_OBS, lg=False):
    """A simulated monthly series: a slowly drifting level and a period-12
    cycle, Gaussian (``lg``) or Poisson counts, two values missing."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    level = np.cumsum(rng.normal(0, 0.05, n)) + 0.5 * np.sin(2 * np.pi * t
                                                              / 12)
    if lg:
        y = 10.0 + 3.0 * level + rng.normal(0, 0.5, n)
    else:
        y = rng.poisson(np.exp(1.5 + level)).astype(float)
    y[[5, n - 3]] = np.nan
    return y


def _seasonal_pair(lg, seed=0, proper=False):
    """The period-12 seasonal model built by both packages: ``bsm_lg`` level
    + slope + seasonal (m = 13) or ``bsm_ng`` Poisson level + seasonal
    (m = 12); ``proper`` starts the latter from a1 = (1.5, 0, ...),
    P1 = 0.1 I instead of the diffuse P1 = 100 I, under which a bootstrap
    filter keeps particles far in the tail, where the estimate is of the
    order -1e11 and float64 rounding moves it visibly."""
    y = _monthly(seed, lg=lg)
    if lg:
        pri = dict(sd_y=("halfnormal_prior", 0.5, 1.0),
                   sd_level=("halfnormal_prior", 0.1, 1.0),
                   sd_slope=("halfnormal_prior", 0.01, 0.1),
                   sd_seasonal=("halfnormal_prior", 0.1, 1.0))
        return _build(jbsm_lg, bt.bsm_lg, y, dict(period=12), pri)
    pri = dict(sd_level=("halfnormal_prior", 0.1, 1.0),
               sd_seasonal=("halfnormal_prior", 0.1, 1.0))
    kw = dict(period=12, distribution="poisson")
    if proper:
        kw.update(a1=np.r_[1.5, np.zeros(11)], P1=0.1 * np.eye(12))
    return _build(jbsm_ng, bt.bsm_ng, y, kw, pri)


def _thetas(model, B, seed):
    rng = np.random.default_rng(seed)
    t0 = np.asarray(model.theta_init, dtype=np.float64)
    return t0[None] + 0.3 * rng.normal(size=(B, t0.shape[0]))


def _main_model():
    y = _monthly(1)
    return bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                     sd_slope=bt.halfnormal_prior(0.01, 0.1),
                     distribution="poisson", dtype=torch.float64,
                     device="cpu")


# ---------------------------------------------------------------------------
# the predicate
# ---------------------------------------------------------------------------

def _case(kind):
    """(spec, the wrappers whose kernels take it)."""
    if kind == "main":
        spec = spec_of(_main_model())
        return spec, set(WRAPPERS)
    if kind in ("aq", "ar1"):
        return spec_of(_pair(kind)[1]), set(WRAPPERS) - set(ck.NG_WRAPPERS)
    if kind in ("ng12", "lg12"):
        spec = spec_of(_seasonal_pair(kind == "lg12")[1])
        assert spec.m == (13 if kind == "lg12" else 12)
        return spec, set()
    if kind.startswith("ssm_ung"):
        return _ssm_ung_case(kind.endswith("time-varying"))
    spec = spec_of(_main_model())
    if kind == "time-varying Z":
        return dataclasses.replace(
            spec, Z=spec.Z.expand(spec.n, spec.m).contiguous()), set()
    assert kind == "R wider than m"
    R = torch.full((1, spec.m, 3), 0.1, dtype=spec.y.dtype)
    return dataclasses.replace(spec, R=R), set(WRAPPERS) - {"bsf_big_logw"}


def _ssm_ung_case(varying: bool):
    """The main model as an ``ssm_ung`` whose batched ``update_fn`` sets R
    per row and, when ``varying``, also a Z with a time axis of n (the
    second state's loading a trend): (a batch of three rows, the wrappers
    whose kernels take it)."""
    y = _monthly(1)
    n = y.shape[0]
    Zt = torch.stack([torch.ones(n), torch.linspace(0.0, 1.0, n)], dim=1)

    def update(th):
        out = {"R": torch.diag_embed(torch.exp(th))[:, None]}
        if varying:
            out["Z"] = Zt.to(th.dtype)
        return out

    model = bt.ssm_ung(y, Z=np.array([1.0, 0.0]),
                       T=np.array([[1.0, 1.0], [0.0, 1.0]]),
                       R=np.diag([0.1, 0.01]), distribution="poisson",
                       P1=100.0 * np.eye(2), init_theta=np.log([0.1, 0.01]),
                       update_fn=update, dtype=torch.float64, device="cpu")
    spec = model.build(torch.as_tensor(_thetas(model, 3, 2)))
    assert spec.R.shape == (3, 1, 2, 2)
    assert spec.Z.shape == ((n, 2) if varying else (1, 2))
    return spec, set() if varying else set(WRAPPERS)


@pytest.mark.parametrize("kind", ["main", "aq", "ar1", "ng12", "lg12",
                                  "time-varying Z", "R wider than m",
                                  "ssm_ung", "ssm_ung time-varying"])
def test_kernel_takes_the_served_models_only(kind):
    """The predicate per wrapper; on the CPU ``route`` gives the same
    answer and counts no plain route."""
    spec, takes = _case(kind)
    before = dict(ck.PLAIN_ROUTES)
    for w in WRAPPERS:
        assert ck.kernel_takes(spec, w) == (w in takes), (kind, w)
        assert ck.route(w, spec) == (w in takes)
    assert ck.PLAIN_ROUTES == before
    if not takes:
        with pytest.raises(NotImplementedError):
            ck._check_system(spec)


def test_route_counts_plain_routes_on_the_card_only():
    """A spec on the card that a kernel does not take adds one to that
    wrapper's plain-route count; ``reset_launch_counts`` clears both
    counts; an unknown wrapper name is refused."""
    ck.reset_launch_counts()
    shape = lambda *s: SimpleNamespace(shape=s)              # noqa: E731
    card = SimpleNamespace(m=12, Z=shape(1, 12), T=shape(1, 12, 12),
                           R=shape(1, 12, 2), C=shape(1, 12), k=2,
                           distribution=1,
                           y=SimpleNamespace(is_cuda=True))
    assert not ck.route("laplace_solve", card)
    assert not ck.route("laplace_solve", card)
    assert not ck.route("psi_logw", card)
    assert ck.PLAIN_ROUTES["laplace_solve"] == 2
    assert ck.PLAIN_ROUTES["psi_logw"] == 1
    small = SimpleNamespace(**{**vars(card), "m": 2, "Z": shape(1, 2),
                               "T": shape(1, 2, 2), "R": shape(1, 2, 2),
                               "C": shape(1, 2)})
    assert ck.route("bsf_big_logw", small)
    assert ck.PLAIN_ROUTES["bsf_big_logw"] == 0
    ck.reset_launch_counts()
    assert set(ck.PLAIN_ROUTES.values()) == {0}
    assert set(ck.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="unknown"):
        ck.kernel_takes(small, "philox_fill")


# ---------------------------------------------------------------------------
# the plain route at period 12 against the JAX package
# ---------------------------------------------------------------------------

def test_seasonal_approximation_matches_jax():
    """Batched (the chains': ``laplace_solve``'s route) and single-model
    (``laplace_solve_steps``'s route) solves of the period-12 bsm_ng
    against the JAX scan path: pass counts equal, mode, approximate and
    Gaussian log-likelihood to rtol 1e-9; nothing is launched."""
    jm, tm = _seasonal_pair(lg=False)
    th = _thetas(jm, 4, seed=3)
    assert not jconfig.use_fused()
    jspec = jax.vmap(jm.build)(jnp.asarray(th))
    jal = jax.vmap(japprox.approx_loglik)(jspec)
    before = dict(ck.LAUNCHES)
    tal = tapprox.approx_loglik(tm.build(torch.as_tensor(th)))
    assert ck.LAUNCHES == before
    np.testing.assert_array_equal(tal.approx.niter.numpy(),
                                  np.asarray(jal.approx.niter))
    _close(tal.approx.mode, jal.approx.mode)
    _close(tal.loglik, jal.loglik)
    _close(tal.gaussian_loglik, jal.gaussian_loglik)
    one = tapprox.approx_loglik(spec_of(tm, th[1]))
    assert one.approx.mode.shape == (1, N_OBS)
    _close(one.approx.mode[0], jal.approx.mode[1])
    _close(one.loglik[0], jal.loglik[1])
    _close(bt.logLik(tm, theta=th[2])[0],
           jloglik.logLik(jm, theta=jnp.asarray(th[2])))
    assert ck.LAUNCHES == before


def test_seasonal_lg_loglik_matches_jax():
    """The Kalman log-likelihood of the period-12 bsm_lg (m = 13), batched
    (the chain's target) and through ``logLik``, against the JAX package's
    at rtol 1e-9."""
    jm, tm = _seasonal_pair(lg=True)
    th = _thetas(jm, 5, seed=4)
    ref = jax.vmap(lambda t: jkalman.log_likelihood(jm.build(t)))(
        jnp.asarray(th))
    got = ck.routed_log_likelihood(tm.build(torch.as_tensor(th)))
    assert np.isfinite(np.asarray(ref)).all()
    _close(got, ref)
    _close(bt.logLik(tm, theta=th[0])[0],
           jloglik.logLik(jm, theta=jnp.asarray(th[0])))
    alpha, ll = ck.routed_fast_smoother_ll(tm.build(torch.as_tensor(th)))
    _close(ll, ref)
    assert alpha.shape == (5, N_OBS + 1, 13)


def _seasonal_al(B, seed, proper=False):
    """The period-12 bsm_ng at B thetas: (JAX spec, JAX ApproxLoglik, the
    JAX package's proposal factors, the port's spec and ApproxLoglik)."""
    jm, tm = _seasonal_pair(lg=False, proper=proper)
    th = _thetas(jm, B, seed)
    jspec = jax.vmap(jm.build)(jnp.asarray(th))

    def make_al(spec):
        al = japprox.approx_loglik(spec)
        z = jnp.zeros((), jnp.float64)
        return japprox.ApproxLoglik(al.approx, al.scales, z, z)

    jal = jax.vmap(make_al)(jspec)
    jfac = jax.vmap(lambda s, a: jkalman.smoother_bwd_factors(
        a.approx.gaussian(s)))(jspec, jal)
    spec = tm.build(torch.as_tensor(th))
    al = approx_from_numpy(
        dict(mode=np.asarray(jal.approx.mode),
             ytilde=np.asarray(jal.approx.ytilde),
             Htilde=np.asarray(jal.approx.Htilde),
             scales=np.asarray(jal.scales)), device="cpu",
        dtype=torch.float64)
    jfac = tuple(torch.as_tensor(np.array(x)) for x in jfac)
    return jspec, jal, jfac, spec, al


def _same_law(fac, jfac):
    """Proposal factors of one law: ahat, Ab and Lb Lb' to rtol 1e-9 (at
    m = 12 the square-root factor Lb itself comes from a general eigen-
    solver on each side, whose eigenvectors may differ in sign and order
    within repeated eigenvalues)."""
    outer = lambda L: L @ L.transpose(-1, -2)               # noqa: E731
    _close(fac[0], jfac[0])
    _close(fac[2], jfac[2])
    _close(outer(fac[1]), outer(jfac[1]))


def _within(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(ref).all()
    assert (np.abs(got - ref) <= RTOL * (1 + np.abs(ref))).all(), (got, ref)


def test_seasonal_psi_logw_matches_jax():
    """``psi_logw`` (N = 10, the ``psi_logw`` kernel's route) on injected
    numpy ``eps``/``us`` runs the plain scan with the port's own factors;
    that scan given the JAX package's factors meets the JAX scan at atol
    1e-9 (1 + |ref|), and the two sets of factors describe one law."""
    B, N, m = 4, 10, 12
    jspec, jal, jfac, spec, al = _seasonal_al(B, 5)
    rng = np.random.default_rng(6)
    eps = torch.as_tensor(rng.normal(size=(B, N_OBS + 1, N, m)))
    us = torch.as_tensor(rng.uniform(size=(B, N_OBS, N)))
    ref = jax.vmap(jpf.psi_logw_scan)(jspec, jal, jnp.asarray(eps.numpy()),
                                      jnp.asarray(us.numpy()))
    before = dict(ck.LAUNCHES)
    via = tpf.psi_logw(spec, al, N, eps=eps, us=us)
    assert ck.LAUNCHES == before
    fac = tpf._factors(spec, al)
    _same_law(fac, jfac)
    assert torch.equal(via, tpf.psi_logw_scan(spec, al, eps, us,
                                              factors=fac))
    _within(tpf.psi_logw_scan(spec, al, eps, us, factors=jfac), ref)


def _bsf_keyed_draws(key, n, N, m, k):
    """The draws of ``_bsf_logw_keyed`` from ``key`` where R has k < m
    columns: as ``_keyed_draws``, but each step's disturbances are k
    normals (zero-padded to m, which the port's R, zero-padded to m
    columns, does not read)."""
    eps, us = _keyed_draws(key, n, N, m, jnp.float64)
    key, _ = jax.random.split(key)
    krkp = jax.vmap(jax.random.split)(jax.random.split(key, n))
    eta = jax.vmap(lambda kq: jax.random.normal(kq, (N, k), jnp.float64))(
        krkp[:, 1])
    eta = jnp.concatenate([eta, jnp.zeros((n, N, m - k))], axis=-1)
    return jnp.concatenate([eps[:1], eta]), us


@pytest.mark.parametrize("mode", ["psi", "bsf"])
def test_seasonal_large_ensemble_route_matches_jax_keyed(mode):
    """N = 40, resampling every 3rd step: the large-ensemble entry points on
    the period-12 model run the plain scans, which meet the JAX package's
    keyed filters (their draws rebuilt) at atol 1e-9 (1 + |ref|); the psi
    scan is given the JAX package's factors, as above.  The bootstrap
    model's R has 2 columns for 12 states."""
    B, N, kk, m = 3, 40, 3, 12
    jspec, jal, jfac, spec, al = _seasonal_al(B, 7, proper=mode == "bsf")
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    if mode == "psi":
        eps, us = jax.vmap(lambda k: _keyed_draws(k, N_OBS, N, m,
                                                  jnp.float64))(keys)
        eps, us = torch.as_tensor(np.array(eps)), torch.as_tensor(
            np.array(us))
        ref = jax.vmap(lambda s, a, k: jpf._psi_logw_keyed(
            s, a, N, k, resample_every=kk))(jspec, jal, keys)
        via = tpf.psi_logw(spec, al, N, eps=eps, us=us, resample_every=kk)
        assert torch.equal(via, tpf.psi_logw_scan(spec, al, eps, us,
                                                  resample_every=kk))
        got = tpf.psi_logw_scan(spec, al, eps, us, factors=jfac,
                                resample_every=kk)
    else:
        assert spec.k == 2
        eps, us = jax.vmap(lambda k: _bsf_keyed_draws(k, N_OBS, N, m, 2))(
            keys)
        ref = jax.vmap(lambda s, k: jpf._bsf_logw_keyed(
            s, N, k, resample_every=kk))(jspec, keys)
        ref = np.asarray(ref) + np.asarray(jax.vmap(
            lambda s: japprox.fam.obs_log_const(s.distribution, s.y, s.u,
                                                s.phi))(jspec))
        got = tpf.bsf_logw(spec, N, None, resample_every=kk,
                           eps=torch.as_tensor(np.array(eps)[:, :N_OBS]),
                           us=torch.as_tensor(np.array(us)[:, :N_OBS - 1]))
    _within(got.numpy(), ref)


def test_seasonal_seed_mode_draws_the_philox_tensors():
    """In seed mode the plain route of a model beyond m = 4 draws the
    tensors ``philox_fill_plain`` gives for the key (normals 4.. from the
    calls with which = 2, ...; the first four and the uniforms as at
    m = 4), as the wrappers' own CPU branches do."""
    B, N, m = 2, 40, 12
    _, _, _, spec, al = _seasonal_al(B, 9)
    gen = torch.Generator().manual_seed(11)
    got = tpf.psi_logw(spec, al, N, gen, resample_every=2)
    key = ck.philox_key(torch.Generator().manual_seed(11), "cpu")
    eps, us = ck.philox_fill_plain(key, B, N_OBS + 1, N, m, torch.float64)
    want = al.loglik + tpf.psi_logw_scan(spec, al, eps, us,
                                         resample_every=2)
    assert torch.equal(got, want)
    e4, u4 = ck.philox_fill_plain(key, B, N_OBS + 1, N, 4, torch.float64)
    assert eps.shape == (B, N_OBS + 1, N, m)
    assert torch.equal(eps[..., :4], e4) and torch.equal(us, u4)
    e = eps.reshape(-1, m).numpy()
    c = np.corrcoef(e.T)                  # the twelve normals uncorrelated
    assert np.abs(c - np.eye(m)).max() < 5.0 / np.sqrt(e.shape[0])


# ---------------------------------------------------------------------------
# logLik of a linear-Gaussian model with particles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,method", [("aq", "psi"), ("ar1", "bsf")])
def test_lg_loglik_with_particles_is_exact(kind, method):
    """As in the JAX package, ``particles`` does not turn a linear-Gaussian
    log-likelihood into an estimate: ``logLik(model, 10)`` is the Kalman
    log-likelihood, to 1e-9."""
    jm, tm = _pair(kind)
    got = bt.logLik(tm, 10, method=method)
    assert got.shape == (1,)
    _close(got[0], jloglik.logLik(jm, particles=10, method=method))
    assert torch.equal(got, bt.logLik(tm))


@pytest.mark.parametrize("run", [
    dict(mcmc_type="is2", particles=10),
    dict(mcmc_type="pm", particles=40, sampling_method="bsf")])
def test_seasonal_chains_run_on_the_route(run):
    """The MCMC entry point on the period-12 bsm_ng (float64, CPU, a short
    run): is2 with the psi filter and pm with a 40-particle bootstrap filter
    in seed mode go through the routed call sites (approximation, factors,
    the N <= 32 and large-ensemble filters) to finite output of the right
    shape; nothing is launched."""
    _, tm = _seasonal_pair(lg=False, proper=run["mcmc_type"] == "pm")
    before = dict(ck.LAUNCHES)
    out = bt.run_mcmc(tm, iter=16, n_chains=2, seed=2, device="cpu", **run)
    assert ck.LAUNCHES == before
    assert out.theta.shape == (2, 8, 2)
    assert np.isfinite(out.posterior).all() and np.isfinite(out.theta).all()
    if out.weights is not None:
        assert np.isfinite(out.weights).all()
