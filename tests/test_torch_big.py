"""PyTorch port vs the JAX package: the large-ensemble particle filters, i.e.
the module that holds the ``psi_big_logw`` / ``bsf_big_logw`` kernel.

On the CPU the wrappers run the kernel's plain versions
(``psi_logw_scan(resample_every=kk)``, ``bsf_logw_scan``).  They are held

- in float64, exactly, against the JAX package's keyed scan filters
  (``_psi_logw_keyed``, ``_bsf_logw_keyed``): the test rebuilds the draws
  those make from their key and injects them into the port;
- in float32 against the Pallas kernel in interpret mode with the same
  injected stream tensors, carried across by ``convert``'s layout function.

The Philox generator's tensor version is held against the published
known-answer vectors of Philox-4x32-10.  The plain versions fed the
ancestors their own search chose (the kernel's check-only ``anc`` input)
reproduce themselves bit for bit.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import config as jconfig
from bssm_tpu.core.priors import halfnormal_prior, uniform_prior
from bssm_tpu.inference import approx as japprox
from bssm_tpu.inference import particle as jpf
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.models.svm import svm as jsvm

from bssm_tpu_torch.convert import (approx_from_numpy, ngspec_from_numpy,
                                    particle_streams_from_numpy)
from bssm_tpu_torch.core import distributions as tfam
from bssm_tpu_torch.inference import particle as tpf
from bssm_tpu_torch.ops import cuda_kalman as ck

SPEC_FIELDS = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u",
               "initial_mode")


def _jax_batch(family, m2, n, B, seed, dtype, missing=True, proper=False):
    """Batched (spec, ApproxLoglik) of the JAX package for B thetas;
    ``proper`` starts a bsm_ng model from a1 = (1, 0), P1 = diag(1, 0.01)
    instead of the diffuse initial state."""
    rng = np.random.default_rng(seed)
    if family == "svm":
        y = rng.normal(0, 1, n) * np.exp(0.3 * np.sin(np.arange(n) / 5))
        model = jsvm(y, rho=uniform_prior(0.9, -0.999, 0.999),
                     sd_ar=halfnormal_prior(0.3, 1.0),
                     sigma=halfnormal_prior(1.0, 2.0), dtype=dtype)
        thetas = jnp.asarray(np.stack(
            [rng.normal([0.9, -1.2, 0.0], 0.05) for _ in range(B)]), dtype)
    else:
        y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
        y = y.astype(float)
        if missing:
            y[n // 3] = np.nan
        kw = dict(sd_level=halfnormal_prior(0.1, 1), distribution=family,
                  dtype=dtype)
        if m2:
            kw["sd_slope"] = halfnormal_prior(0.01, 0.1)
        if proper:
            kw["a1"] = np.array([1.0, 0.0])[:2 if m2 else 1]
            kw["P1"] = np.diag([1.0, 0.01])[:2 if m2 else 1, :2 if m2 else 1]
        model = jbsm_ng(y, **kw)
        thetas = jnp.asarray(rng.normal(-2.5, .2, (B, 2 if m2 else 1)),
                             dtype)

    def make_al(theta):
        spec = model.build(theta)
        al = japprox.approx_loglik(spec)
        z = jnp.zeros((), dtype)
        return spec, japprox.ApproxLoglik(al.approx, al.scales, z, z)

    return jax.vmap(make_al)(thetas)


def _to_port(jspec, jal, tdtype):
    """The port's (spec, ApproxLoglik) from the JAX package's batched ones;
    a leaf whose rows are all equal loses its batch axis."""
    d = {}
    for k in SPEC_FIELDS:
        a = np.asarray(getattr(jspec, k))
        d[k] = a[0] if (a == a[:1]).all() or np.isnan(a).any() else a
    d["distribution"] = jspec.distribution
    spec = ngspec_from_numpy(d, device="cpu", dtype=tdtype)
    al = approx_from_numpy(
        dict(mode=np.asarray(jal.approx.mode),
             ytilde=np.asarray(jal.approx.ytilde),
             Htilde=np.asarray(jal.approx.Htilde),
             scales=np.asarray(jal.scales)), device="cpu", dtype=tdtype)
    return spec, al


def _keyed_draws(key, n, N, m, dtype):
    """The draws of ``_psi_logw_keyed`` / ``_bsf_logw_keyed`` from ``key``:
    the initial normals, then per step a uniform block (as
    ``stratified_gather`` draws it) and a normal block.  Returns
    ``eps (n+1, N, m)``, ``us (n, N)``."""
    key, k0 = jax.random.split(key)
    u0 = jax.random.normal(k0, (N, m), dtype)
    krkp = jax.vmap(jax.random.split)(jax.random.split(key, n))
    r = jax.vmap(lambda k: jax.random.uniform(k, (N,), dtype))(krkp[:, 0])
    um = jax.vmap(lambda k: jax.random.normal(k, (N, m), dtype))(krkp[:, 1])
    return jnp.concatenate([u0[None], um]), r


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answers(ctr, key, want):
    """Philox-4x32-10 in tensor code gives the known-answer vectors of the
    Random123 distribution (exact integers)."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)       # noqa: E731
    got = ck.philox4x32_10([t(c) for c in ctr], [t(k) for k in key])
    assert tuple(int(g) for g in got) == want


@contextlib.contextmanager
def _one_thread():
    """torch's intra-op threads set to one inside the block."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def test_philox_fill_plain_layout_and_moments():
    """Filled tensors: shapes, uniforms strictly inside (0, 1) in float32
    too, moments of 2e5 normals within 5 standard errors, another key or
    another row gives another stream, and a value depends only on its
    (row, step, particle): a longer fill agrees on the common part."""
    key = torch.tensor([123456789, 987654321], dtype=torch.int64)
    eps, us = ck.philox_fill_plain(key, 50, 21, 64, 3, torch.float32)
    assert eps.shape == (50, 21, 64, 3) and us.shape == (50, 20, 64)
    assert eps.dtype == us.dtype == torch.float32
    assert 0.0 < float(us.min()) and float(us.max()) < 1.0
    e = eps.double().reshape(-1)
    assert abs(float(e.mean())) < 5.0 / np.sqrt(e.numel())
    assert abs(float(e.var()) - 1.0) < 5.0 * np.sqrt(2.0 / e.numel())
    assert abs(float(us.double().mean()) - 0.5) < 5.0 / np.sqrt(
        12.0 * us.numel())
    # components of one particle are uncorrelated
    c = np.corrcoef(eps.reshape(-1, 3).double().numpy().T)
    assert np.abs(c - np.eye(3)).max() < 5.0 / np.sqrt(eps.numel() / 3)
    eps2, us2 = ck.philox_fill_plain(key + 1, 50, 21, 64, 3, torch.float32)
    assert not torch.equal(eps, eps2) and not torch.equal(us, us2)
    assert not torch.equal(eps[0], eps[1])
    # the two fills on one intra-op thread: every element of either goes
    # through the same vectorised code (both sizes are multiples of the
    # vector width), so that the comparison does not depend on how the
    # thread pool splits the elementwise ops under load
    with _one_thread():
        one_e, one_u = ck.philox_fill_plain(key, 50, 21, 64, 3,
                                            torch.float32)
        big_e, big_u = ck.philox_fill_plain(key, 60, 25, 64, 3,
                                            torch.float32)
    assert torch.equal(big_e[:50, :21], one_e)
    assert torch.equal(big_u[:50, :20], one_u)
    assert torch.equal(one_u, us)
    # the extreme words: the largest 24-bit value stays below 1 in float32
    top = ck._u01(torch.tensor([0xffffffff, 0], dtype=torch.int64),
                  torch.float32)
    assert float(top[0]) < 1.0 and float(top[1]) == 2.0 ** -25
    # the wrapper on a CPU key is the plain version
    w_e, w_u = ck.philox_fill(key, 50, 21, 64, 3, torch.float32)
    assert torch.equal(w_e, eps) and torch.equal(w_u, us)
    # m <= 2: one Philox call per particle-step, the uniform from its word 2
    e2, u2 = ck.philox_fill_plain(key, 50, 21, 64, 2, torch.float64)
    assert e2.shape == (50, 21, 64, 2) and u2.shape == (50, 20, 64)
    # the same words as the first pair of m = 3, rounded in float64 instead
    assert torch.allclose(e2, eps[..., :2].double(), rtol=0, atol=1e-3)
    ar = lambda k: torch.arange(k, dtype=torch.int64)        # noqa: E731
    w = ck.philox4x32_10(
        [ar(64)[None, None, :].expand(50, 21, 64),
         ar(21)[None, :, None].expand(50, 21, 64),
         ar(50)[:, None, None].expand(50, 21, 64),
         torch.zeros((50, 21, 64), dtype=torch.int64)],
        (key[0], key[1]))
    assert torch.equal(u2, ck._u01(w[2], torch.float64)[:, 1:])
    assert 0.0 < float(u2.min()) and float(u2.max()) < 1.0
    c2 = np.corrcoef(np.stack([u2.reshape(-1).numpy(),
                               e2[:, 1:, :, 0].reshape(-1).numpy(),
                               e2[:, 1:, :, 1].reshape(-1).numpy()]))
    assert np.abs(c2 - np.eye(3)).max() < 5.0 / np.sqrt(u2.numel())


# ---------------------------------------------------------------------------
# float64, exact given the JAX package's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,m2,kk", [
    ("poisson", True, 1), ("poisson", True, 3), ("svm", False, 1),
    ("svm", False, 3), ("negative binomial", False, 3)])
def test_psi_scan_matches_jax_keyed(family, m2, kk):
    """``psi_logw_scan(resample_every=kk)`` against ``_psi_logw_keyed`` with
    the draws rebuilt from its key: atol 1e-9 scaled by 1 + |ref| (float64;
    the same recursion, proposal factors computed on each side)."""
    n, B, N = 20, 4, 40
    jspec, jal = _jax_batch(family, m2, n, B, 21, jnp.float64)
    m = jspec.a1.shape[-1]
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    assert not jconfig.use_fused()
    ref = np.asarray(jax.vmap(lambda s, a, k: jpf._psi_logw_keyed(
        s, a, N, k, resample_every=kk))(jspec, jal, keys))
    eps, us = jax.vmap(lambda k: _keyed_draws(k, n, N, m, jnp.float64))(keys)
    spec, al = _to_port(jspec, jal, torch.float64)
    got = tpf.psi_logw_scan(spec, al, torch.as_tensor(np.array(eps)),
                            torch.as_tensor(np.array(us)),
                            resample_every=kk).numpy()
    assert np.isfinite(ref).all()
    assert (np.abs(got - ref) <= 1e-9 * (1 + np.abs(ref))).all(), (got, ref)
    # through the entry point and the wrapper (plain version on CPU tensors)
    before = dict(ck.LAUNCHES)
    via = tpf.psi_logw(spec, al, N, eps=torch.as_tensor(np.array(eps)),
                       us=torch.as_tensor(np.array(us)), resample_every=kk)
    assert ck.LAUNCHES == before
    np.testing.assert_allclose(via.numpy(), got, rtol=0, atol=1e-12)


@pytest.mark.parametrize("m2,kk", [(True, 1), (True, 3), (False, 1),
                                   (False, 3)])
def test_bsf_scan_matches_jax_keyed(m2, kk):
    """``bsf_logw_scan`` against ``_bsf_logw_keyed`` (the JAX scan runs one
    more, observation-free step whose draws the port does not need), and
    ``bsf_logw`` against ``bsf_logw``'s value with the observation constants:
    atol 1e-9 scaled (float64)."""
    n, B, N = 20, 4, 40
    jspec, jal = _jax_batch("poisson", m2, n, B, 22, jnp.float64)
    m = jspec.a1.shape[-1]
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    ref = np.asarray(jax.vmap(lambda s, k: jpf._bsf_logw_keyed(
        s, N, k, resample_every=kk))(jspec, keys))
    eps, us = jax.vmap(lambda k: _keyed_draws(k, n, N, m, jnp.float64))(keys)
    eps = torch.as_tensor(np.ascontiguousarray(np.array(eps)[:, :n]))
    us = torch.as_tensor(np.ascontiguousarray(np.array(us)[:, :n - 1]))
    spec, _ = _to_port(jspec, jal, torch.float64)
    got = tpf.bsf_logw_scan(spec, eps, us, resample_every=kk).numpy()
    assert (np.abs(got - ref) <= 1e-9 * (1 + np.abs(ref))).all(), (got, ref)
    jconst = np.asarray(jax.vmap(lambda s: japprox.fam.obs_log_const(
        s.distribution, s.y, s.u, s.phi))(jspec))
    full = tpf.bsf_logw(spec, N, None, resample_every=kk, eps=eps,
                        us=us).numpy()
    assert (np.abs(full - (ref + jconst))
            <= 1e-9 * (1 + np.abs(ref + jconst))).all()


def test_kk1_is_bit_equal_to_the_every_step_recursion():
    """``resample_every=1`` takes the branch the N <= 32 kernel's tests pin:
    its result equals, bit for bit, the every-step recursion in linear
    weights written out here from the module's own pieces."""
    n, B, N = 15, 3, 12
    jspec, jal = _jax_batch("poisson", True, n, B, 23, jnp.float64)
    spec, al = _to_port(jspec, jal, torch.float64)
    rng = np.random.default_rng(1)
    eps = torch.as_tensor(rng.normal(size=(B, n + 1, N, 2)))
    us = torch.as_tensor(rng.uniform(size=(B, n, N)))
    ahat, Lb, Ab = ck.rts_factors(al.approx.gaussian(spec))
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731
    alpha = ahat[:, n, None, :] + eps[:, 0] @ tr(Lb[:, n])
    nw = torch.full((B, N), 1.0 / N, dtype=torch.float64)
    ll = torch.zeros(B, dtype=torch.float64)
    for s in range(1, n + 1):
        t = n - s
        anc = tpf.stratified_gather_from_uniforms(nw, us[:, s - 1], alpha)
        alpha = (ahat[:, t, None, :]
                 + (anc - ahat[:, t + 1, None, :]) @ tr(Ab[:, t])
                 + eps[:, s] @ tr(Lb[:, t]))
        sig = spec.D[..., None] + (alpha * spec.Z[None]).sum(-1)
        y_t = spec.y[None, t, None]
        lw = tfam.log_weights(spec.distribution, y_t, spec.u[None, t, None],
                              spec.phi, sig, al.approx.ytilde[:, t, None],
                              al.approx.Htilde[:, t, None]) \
            - al.scales[:, t, None]
        ok = torch.isfinite(y_t)
        inc, nw_new = tpf._lse_update(torch.where(ok, lw,
                                                  torch.zeros_like(lw)))
        ll = ll + torch.where(ok[:, 0], inc, torch.zeros_like(inc))
        nw = torch.where(ok, nw_new, torch.full_like(nw_new, 1.0 / N))
    got = tpf.psi_logw_scan(spec, al, eps, us, factors=(ahat, Lb, Ab))
    assert torch.equal(got, ll)
    assert torch.equal(got, tpf.psi_logw_scan(spec, al, eps, us,
                                              factors=(ahat, Lb, Ab),
                                              resample_every=1))
    # kk > 1 reads the uniforms of the resampling steps only
    us2 = us.clone()
    us2[:, 1] = 0.123
    us2[:, 2] = 0.987
    a = tpf.psi_logw_scan(spec, al, eps, us, factors=(ahat, Lb, Ab),
                          resample_every=3)
    b = tpf.psi_logw_scan(spec, al, eps, us2, factors=(ahat, Lb, Ab),
                          resample_every=3)
    assert torch.equal(a, b) and not torch.equal(a, got)


def test_missing_observation_carries_the_weights():
    """On a carried step with y missing the normalised log-weights come out
    unchanged (normalised anew) and nothing is added; a dead ensemble gives
    -inf and log-weights -log N (the kernel's convention)."""
    lnw = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4],
                                  [0.25, 0.25, 0.25, 0.25]],
                                 dtype=torch.float64))
    lw = torch.tensor([[5.0, -3.0, 2.0, 0.5], [0.0, 1.0, 2.0, 3.0]],
                      dtype=torch.float64)
    inc, new = tpf._carry_update(lnw, lw, torch.tensor([[False], [True]]))
    np.testing.assert_allclose(new[0].numpy(), lnw[0].numpy(), atol=1e-15)
    assert abs(float(inc[0])) < 1e-15
    want = np.log(np.mean(np.exp([0.0, 1.0, 2.0, 3.0])))
    np.testing.assert_allclose(float(inc[1]), want, rtol=1e-14)
    np.testing.assert_allclose(float(torch.exp(new[1]).sum()), 1.0,
                               rtol=1e-14)
    dead = torch.full((1, 4), -torch.inf, dtype=torch.float64)
    inc, new = tpf._carry_update(dead, lw[:1], torch.tensor([[True]]))
    assert torch.isneginf(inc[0])
    np.testing.assert_allclose(new[0].numpy(), np.full(4, -np.log(4.0)))


# ---------------------------------------------------------------------------
# injected ancestors (the kernel's check-only input)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,kk,dtype", [
    ("psi", 1, torch.float64), ("psi", 3, torch.float64),
    ("psi", 1, torch.float32), ("psi", 4, torch.float32),
    ("bsf", 1, torch.float64), ("bsf", 3, torch.float32)])
def test_injected_ancestors_reproduce_the_search(mode, kk, dtype):
    """A scan fed the ancestors its own search chose returns, bit for bit,
    what it returns without them; the ancestors are int32 (B, S, N), the
    identity at the steps that do not resample; the wrapper on CPU tensors
    passes them through; another set of ancestors gives another value."""
    n, B, N = 14, 5, 40
    jspec, jal = _jax_batch("poisson", True, n, B, 51,
                            jnp.float64 if dtype == torch.float64
                            else jnp.float32, proper=True)
    spec, al = _to_port(jspec, jal, dtype)
    rng = np.random.default_rng(52)
    steps = n + 1 if mode == "psi" else n
    eps = torch.as_tensor(rng.normal(size=(B, steps, N, 2)), dtype=dtype)
    us = torch.as_tensor(rng.uniform(size=(B, steps - 1, N)), dtype=dtype)
    if mode == "psi":
        fac = ck.rts_factors(al.approx.gaussian(spec))
        scan = lambda **kw: tpf.psi_logw_scan(            # noqa: E731
            spec, al, eps, us, factors=fac, resample_every=kk, **kw)
        wrap = lambda a: ck.psi_big_logw(spec, al, *fac, kk,  # noqa: E731
                                         eps=eps, us=us, anc=a)
    else:
        scan = lambda **kw: tpf.bsf_logw_scan(            # noqa: E731
            spec, eps, us, resample_every=kk, **kw)
        wrap = lambda a: ck.bsf_big_logw(spec, kk, eps=eps,  # noqa: E731
                                         us=us, anc=a)
    ref, anc = scan(return_ancestors=True)
    assert anc.dtype == torch.int32 and anc.shape == (B, steps - 1, N)
    assert torch.equal(ref, scan())
    assert torch.equal(scan(anc=anc), ref)
    assert torch.equal(wrap(anc), ref)
    still = [s for s in range(steps - 1) if s % kk != 0]
    ident = torch.arange(N, dtype=torch.int32)
    assert all(torch.equal(anc[:, s], ident.expand(B, N)) for s in still)
    assert int(anc.min()) >= 0 and int(anc.max()) < N
    other = anc.roll(1, dims=-1)
    assert not torch.equal(scan(anc=other), ref)
    with pytest.raises(ValueError, match="ancestors need"):
        if mode == "psi":
            ck.psi_big_logw(spec, al, *fac, kk, seed=ck.philox_key(
                None, "cpu"), nsim=N, anc=anc)
        else:
            ck.bsf_big_logw(spec, kk, seed=ck.philox_key(None, "cpu"),
                            nsim=N, anc=anc)
    with pytest.raises(TypeError, match="int32"):
        wrap(anc.long())


# ---------------------------------------------------------------------------
# float32 against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

def _stream_noise(seed, B, steps, m, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, steps, m, N)).astype(np.float32),
            rng.uniform(size=(B, steps, N)).astype(np.float32))


@pytest.mark.parametrize("family,kk", [("poisson", 1), ("poisson", 4),
                                       ("svm", 2)])
def test_psi_big_matches_pallas_interpret_f32(family, kk):
    """The wrapper on CPU tensors (float32) against ``_psi_big_kernel`` in
    interpret mode on the same stream tensors.  Tolerance of the JAX
    package's own kernel test: the log-weight is a residue of |scales|-sized
    terms, and rounding noise can flip a resampled ancestor, after which the
    two runs are different, equally valid draws; so at least 95% of the rows
    inside 2e-4 + 2e-6 sum|scales|, all inside 0.5."""
    from bssm_tpu.ops.pallas_kalman import psi_big_logw_stream
    n, B, N = 11, 128, 64
    old = jconfig.fused_kernels
    try:
        jconfig.set_fused_kernels(True)
        jspec, jal = _jax_batch(family, family != "svm", n, B, 31,
                                jnp.float32)
        m = jspec.a1.shape[-1]
        eps, us = _stream_noise(32, B, n + 1, m, N)
        out = psi_big_logw_stream(jspec, jal, jnp.asarray(eps),
                                  jnp.asarray(us), kk, interpret=True)
    finally:
        jconfig.set_fused_kernels(old)
    assert out is not None
    spec, al = _to_port(jspec, jal, torch.float32)
    t_eps, t_us = particle_streams_from_numpy(eps, us, device="cpu",
                                              dtype=torch.float32)
    assert t_eps.shape == (B, n + 1, N, m) and t_us.shape == (B, n, N)
    ahat, Lb, Ab = ck.rts_factors(al.approx.gaussian(spec))
    got = ck.psi_big_logw(spec, al, ahat, Lb, Ab, kk, eps=t_eps, us=t_us)
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy() - np.asarray(out))
    atol = 2e-4 + 2e-6 * np.abs(np.asarray(jal.scales)).sum(axis=1)
    assert np.mean(diff < atol) >= 0.95, (diff.max(), np.mean(diff < atol))
    assert np.all(diff < 0.5)


@pytest.mark.parametrize("kk", [1, 3])
def test_bsf_big_matches_pallas_interpret_f32(kk):
    """The bootstrap mode likewise: at least 95% of the rows inside
    rtol = atol = 2e-4 (the JAX package's tolerance for this kernel), every
    row inside 0.5 + 0.05 |ref| (a flipped ancestor moves the estimate by
    its Monte-Carlo spread, which grows with the log-likelihood's size).
    The model starts from a proper initial state: under the diffuse one some
    rows keep particles whose signal is far in the tail, where exp(signal)
    turns the rounding of the Pallas kernel's telescoped selection sum (not
    an exact gather) into log-weight differences of order 1 to 100."""
    from bssm_tpu.ops.pallas_kalman import bsf_big_logw_stream
    n, B, N = 11, 128, 64
    old = jconfig.fused_kernels
    try:
        jconfig.set_fused_kernels(True)
        jspec, jal = _jax_batch("poisson", True, n, B, 33, jnp.float32,
                                proper=True)
        eps, us = _stream_noise(34, B, n, 2, N)
        out = bsf_big_logw_stream(jspec, jnp.asarray(eps), jnp.asarray(us),
                                  kk, interpret=True)
    finally:
        jconfig.set_fused_kernels(old)
    assert out is not None
    out = np.asarray(out)
    spec, _ = _to_port(jspec, jal, torch.float32)
    t_eps, t_us = particle_streams_from_numpy(eps, us, device="cpu",
                                              dtype=torch.float32)
    assert t_eps.shape == (B, n, N, 2) and t_us.shape == (B, n - 1, N)
    got = ck.bsf_big_logw(spec, kk, eps=t_eps, us=t_us).numpy()
    diff = np.abs(got - out)
    assert np.isfinite(got).all() and np.isfinite(out).all()
    assert np.mean(diff < 2e-4 + 2e-4 * np.abs(out)) >= 0.95, diff.max()
    assert np.all(diff < 0.5 + 0.05 * np.abs(out)), (diff.max(),
                                                     np.abs(out).max())


# ---------------------------------------------------------------------------
# dispatch and contracts
# ---------------------------------------------------------------------------

def test_dispatch_by_particle_count_and_wrapper_contracts():
    n, B = 12, 3
    jspec, jal = _jax_batch("poisson", True, n, B, 41, jnp.float64)
    spec, al = _to_port(jspec, jal, torch.float64)
    gen = torch.Generator().manual_seed(3)
    for N in (2, 32, 33, 200, 512):
        out = tpf.psi_logw(spec, al, N, gen, resample_every=2)
        assert out.shape == (B,) and torch.isfinite(out).all()
        out = tpf.bsf_logw(spec, N, gen, resample_every=2)
        assert out.shape == (B,) and torch.isfinite(out).all()
    # above 512 the plain scan tier, from the generator step by step
    before = dict(ck.LAUNCHES)
    for fn in (lambda: tpf.psi_logw(spec, al, 513, gen),
               lambda: tpf.bsf_logw(spec, 513, gen)):
        out = fn()
        assert out.shape == (B,) and torch.isfinite(out).all()
    assert ck.LAUNCHES == before
    # the same key gives the same value; the seed mode needs the count
    ahat, Lb, Ab = ck.rts_factors(al.approx.gaussian(spec))
    key = ck.philox_key(torch.Generator().manual_seed(4), "cpu")
    assert key.dtype == torch.int64 and key.shape == (2,)
    a = ck.psi_big_logw(spec, al, ahat, Lb, Ab, 2, seed=key, nsim=40)
    b = ck.psi_big_logw(spec, al, ahat, Lb, Ab, 2, seed=key, nsim=40)
    assert torch.equal(a, b)
    eps, us = ck.philox_fill(key, B, n + 1, 40, 2, torch.float64)
    c = ck.psi_big_logw(spec, al, ahat, Lb, Ab, 2, eps=eps, us=us)
    assert torch.equal(a, c)
    with pytest.raises(ValueError, match="nsim"):
        ck.psi_big_logw(spec, al, ahat, Lb, Ab, 2, seed=key)
    with pytest.raises(ValueError, match="either"):
        ck.bsf_big_logw(spec, 1)
    with pytest.raises(ValueError, match="either"):
        ck.bsf_big_logw(spec, 1, eps=eps, us=us, seed=key)
    # more noise columns than states are not served
    wide = ngspec_from_numpy(
        {**{k: np.asarray(getattr(jspec, k))[0] for k in SPEC_FIELDS},
         "R": np.ones((1, 2, 3)), "distribution": 1}, device="cpu",
        dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="columns"):
        ck.pack_bootstrap_system(wide, 1)
    assert ck.MAX_N_BIG == 512 and set(ck.LAUNCHES) >= {
        "psi_big_logw", "bsf_big_logw"}
