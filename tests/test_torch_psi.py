"""PyTorch port vs the JAX package: the psi-auxiliary particle filter
log-weight, i.e. the module that holds the ``psi_logw`` kernel.

The same normals and uniforms, drawn with numpy, go through
``bssm_tpu.inference.particle.psi_logw_scan`` and the port's
``psi_logw_scan`` (the kernel's plain version, which the wrapper runs on CPU
tensors), and through the Pallas kernel in interpret mode.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core import config as jconfig
from bssm_tpu.core.priors import halfnormal_prior
from bssm_tpu.inference import approx as japprox
from bssm_tpu.inference import particle as jpf
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.ops import resample as jres

from bssm_tpu_torch.convert import approx_from_numpy, ngspec_from_numpy
from bssm_tpu_torch.inference import particle as tpf
from bssm_tpu_torch.ops import cuda_kalman
from bssm_tpu_torch.ops import resample as tres

SPEC_FIELDS = ("y", "Z", "T", "R", "a1", "P1", "D", "C", "phi", "u",
               "initial_mode")


def _jax_batch(family, m2, n, B, seed, dtype):
    """Batched (spec, ApproxLoglik) of the JAX package for B thetas."""
    rng = np.random.default_rng(seed)
    lam = np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0)
    kw = dict(sd_level=halfnormal_prior(0.1, 1), distribution=family,
              dtype=dtype)
    if m2:
        kw["sd_slope"] = halfnormal_prior(0.01, 0.1)
    if family == "gamma":
        kw["phi"] = 4.0
        y = rng.gamma(4.0, lam / 4.0)
    else:
        if family == "negative binomial":
            kw["phi"] = 3.0
        y = rng.poisson(lam).astype(float)
    y[n // 3] = np.nan
    model = jbsm_ng(y, **kw)
    thetas = jnp.asarray(rng.normal(-2.5, .2, (B, 2 if m2 else 1)), dtype)

    def make_al(theta):
        spec = model.build(theta)
        al = japprox.approx_loglik(spec)
        z = jnp.zeros((), dtype)
        return spec, japprox.ApproxLoglik(al.approx, al.scales, z, z)

    return jax.vmap(make_al)(thetas)


def _to_port(jspec, jal, tdtype):
    d = {k: np.asarray(getattr(jspec, k)) for k in SPEC_FIELDS}
    for k in ("y", "u", "Z", "T", "C", "a1", "initial_mode"):
        d[k] = d[k][0]
    d["distribution"] = jspec.distribution
    spec = ngspec_from_numpy(d, device="cpu", dtype=tdtype)
    al = approx_from_numpy(
        dict(mode=np.asarray(jal.approx.mode),
             ytilde=np.asarray(jal.approx.ytilde),
             Htilde=np.asarray(jal.approx.Htilde),
             scales=np.asarray(jal.scales)), device="cpu", dtype=tdtype)
    return spec, al


def _noise(seed, B, n, N, m, dtype):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n + 1, N, m)).astype(dtype),
            rng.uniform(size=(B, n, N)).astype(dtype))


@pytest.mark.parametrize("family,m2,N", [
    ("poisson", True, 10), ("poisson", False, 4),
    ("negative binomial", True, 4), ("negative binomial", False, 10),
    ("gamma", True, 10), ("gamma", False, 4)])
def test_psi_logw_scan_matches_jax(family, m2, N):
    """Log-weights agree draw for draw, atol 1e-9 in float64: the same
    recursion from the same randomness, with the proposal factors computed
    on each side (their agreement is rtol 1e-8, see test_torch_kalman)."""
    n, B = 30, 5
    m = 2 if m2 else 1
    jspec, jal = _jax_batch(family, m2, n, B, 3, jnp.float64)
    eps, us = _noise(4, B, n, N, m, np.float64)
    assert not jconfig.use_fused()
    ref = jax.vmap(jpf.psi_logw_scan)(jspec, jal, jnp.asarray(eps),
                                      jnp.asarray(us))
    spec, al = _to_port(jspec, jal, torch.float64)
    got = tpf.psi_logw_scan(spec, al, torch.as_tensor(eps),
                            torch.as_tensor(us))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)
    # the entry point adds al.loglik (zero here) and takes the injected
    # randomness through the wrappers (plain versions on CPU tensors)
    before = dict(cuda_kalman.LAUNCHES)
    via = tpf.psi_logw(spec, al, N, eps=torch.as_tensor(eps),
                       us=torch.as_tensor(us))
    assert cuda_kalman.LAUNCHES == before
    np.testing.assert_allclose(via.numpy(), got.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("family,m2", [("poisson", True),
                                       ("negative binomial", False)])
def test_psi_logw_scan_matches_pallas_interpret_f32(family, m2):
    """Plain version (float32) vs the TPU kernel in interpret mode, atol
    1e-4 as in the JAX package's own kernel test: float32 sums of ~30
    increments of order 0.1."""
    from bssm_tpu.ops.pallas_kalman import fused_psi_logw_batched
    n, B, N = 30, 5, 10
    m = 2 if m2 else 1
    old = jconfig.fused_kernels
    try:
        jconfig.set_fused_kernels(True)
        jspec, jal = _jax_batch(family, m2, n, B, 5, jnp.float32)
        eps, us = _noise(6, B, n, N, m, np.float32)
        out = fused_psi_logw_batched(jspec, jal, jnp.asarray(eps),
                                     jnp.asarray(us), B, interpret=True)
    finally:
        jconfig.set_fused_kernels(old)
    assert out is not None
    spec, al = _to_port(jspec, jal, torch.float32)
    got = tpf.psi_logw_scan(spec, al, torch.as_tensor(eps),
                            torch.as_tensor(us))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-4,
                               atol=1e-4)


def test_stratified_indices_equal_index_for_index():
    rng = np.random.default_rng(8)
    w = rng.uniform(size=(6, 12))
    w[1, :5] = 0.0                       # dead particles
    w[2] = 0.0
    w[2, 7] = 1.0                        # one survivor
    w /= w.sum(-1, keepdims=True)
    r = rng.uniform(size=(6, 12))
    ref = jax.vmap(jres.stratified_indices_from_uniforms)(jnp.asarray(w),
                                                          jnp.asarray(r))
    got = tres.stratified_indices_from_uniforms(torch.as_tensor(w),
                                                torch.as_tensor(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    alpha = rng.normal(size=(6, 12, 2))
    gref = jax.vmap(jres.stratified_gather_from_uniforms)(
        jnp.asarray(w), jnp.asarray(r), jnp.asarray(alpha))
    ggot = tres.stratified_gather_from_uniforms(
        torch.as_tensor(w), torch.as_tensor(r), torch.as_tensor(alpha))
    np.testing.assert_allclose(ggot.numpy(), np.asarray(gref), rtol=1e-14)


def _segment_scan(x, w):
    """The psi_logw kernel's inclusive prefix sum over a segment of w lanes
    (Hillis-Steele, shuffle-up by 1, 2, ..., w/2), in x's own precision."""
    x = x.copy()
    o = 1
    while o < w:
        up = x.copy()
        x[o:] = x[o:] + up[:-o]
        o *= 2
    return x


def _kernel_ancestors(nw, r, search):
    """The psi_logw kernel's stratified resampling of one row, in the
    precision of ``nw``: the segment's scan (lanes >= N hold 0), cum[N-1]
    := 1, u_p = (p + r_p) * (1/N), and the ancestor by ``search``:
    "first" reads every cumulative weight (the first design), "bound" is
    the lower bound over their running maximum in log2 w steps (the
    redesign)."""
    N = nw.shape[0]
    w, _ = cuda_kalman.psi_segment(N)
    dt = nw.dtype.type
    cum = _segment_scan(np.concatenate([nw, np.zeros(w - N, nw.dtype)]), w)
    cum[N - 1] = dt(1)
    inv_n = dt(1) / dt(N)
    u = (np.arange(N).astype(nw.dtype) + r) * inv_n
    if search == "first":
        out = []
        for up in u:
            hit = [q for q in range(N) if cum[q] >= up]
            out.append(hit[0] if hit else N - 1)
        return np.array(out)
    cm = np.maximum.accumulate(cum)
    out = []
    for up in u:
        q, half = 0, w // 2
        while half >= 1:
            q += half if cm[q + half - 1] < up else 0
            half //= 2
        out.append(min(q, N - 1))
    return np.array(out)


@pytest.mark.parametrize("N", [1, 7, 8, 10, 16, 17, 32])
def test_lower_bound_picks_the_first_designs_ancestors(N):
    """The redesigned search (a lower bound over the running maximum of the
    segment's scan) returns the first q with cum[q] >= u_p, the ancestor
    of the first design and of particle._ancestors: with zero weights,
    one survivor, ties of u_p with a cumulative weight (dyadic weights and
    uniforms, exact in any summation order, so particle._ancestors sees
    the same cum), and in float32 with random weights, where the scan of
    the segment may decrease by an ulp and a bare lower bound on cum could
    pick another ancestor."""
    rng = np.random.default_rng(N)
    cases = []
    for kind in range(6):
        if kind == 0:                      # dyadic weights, dyadic u: ties
            w = rng.integers(0, 4, N).astype(float)
            w[rng.integers(0, N)] += 1
            w *= 2.0 ** -int(np.ceil(np.log2(w.sum())))
            w[-1] += 1 - w.sum()
            r = rng.integers(0, 4, N) / 4.0
        elif kind == 1:                    # dead particles
            w = rng.uniform(size=N)
            w[: N // 2] = 0
            w /= w.sum()
            r = rng.uniform(size=N)
        elif kind == 2:                    # one survivor
            w = np.zeros(N)
            w[rng.integers(0, N)] = 1.0
            r = rng.uniform(size=N)
        elif kind == 3:                    # equal weights, u on the edges
            w = np.full(N, 1.0 / N)
            r = np.zeros(N)
        else:
            w = rng.uniform(size=N) ** 4
            w /= w.sum()
            r = rng.uniform(size=N)
        cases.append((w, r))
    for kind, (w, r) in enumerate(cases):
        first = _kernel_ancestors(w, r, "first")
        np.testing.assert_array_equal(_kernel_ancestors(w, r, "bound"),
                                      first)
        if kind in (0, 3):
            # ties: exact only where u_p = (p + r_p) / N is (N a power of
            # two), and against the search itself, since exp(log w) in
            # particle._ancestors rounds the weights
            if N & (N - 1) == 0:
                ref = tres.stratified_indices_from_uniforms(
                    torch.as_tensor(w), torch.as_tensor(r)).numpy()
                np.testing.assert_array_equal(first, ref)
        else:
            ref = tpf._ancestors(torch.log(torch.as_tensor(w))[None],
                                 torch.as_tensor(r)[None])[0].numpy()
            np.testing.assert_array_equal(first, ref)
        w32, r32 = w.astype(np.float32), r.astype(np.float32)
        np.testing.assert_array_equal(_kernel_ancestors(w32, r32, "bound"),
                                      _kernel_ancestors(w32, r32, "first"))
    # a float32 segment scan that decreases: w = (1/2, 2^-25, 2^-25, 0, ...)
    # scans to (1/2, 1/2, 1/2 + 2^-24, 1/2, ...); particle N/2 with
    # r = N 2^-24 has u = 1/2 + 2^-24, whose first q is 2; a bare lower
    # bound on cum answers another q
    if N >= 8 and N & (N - 1) == 0:
        w32 = np.full(N, (0.5 - 2.0 ** -24) / (N - 4), np.float32)
        w32[:4] = [0.5, 2.0 ** -25, 2.0 ** -25, 0.0]
        cum = _segment_scan(w32, N)
        assert cum[3] < cum[2]
        r32 = np.zeros(N, np.float32)
        r32[N // 2] = N * 2.0 ** -24
        got = _kernel_ancestors(w32, r32, "bound")
        assert got[N // 2] == 2
        np.testing.assert_array_equal(got, _kernel_ancestors(w32, r32,
                                                             "first"))
        cum[N - 1] = 1
        u = np.float32(N // 2 + r32[N // 2]) * np.float32(1 / N)
        q, half = 0, N // 2
        while half >= 1:
            q += half if cum[q + half - 1] < u else 0
            half //= 2
        assert q != 2


def test_lse_update_guards():
    """Non-finite particle weights count as zero; a dead ensemble gives -inf
    and uniform weights (the guards the kernel keeps)."""
    lw = torch.tensor([[0.0, -1.0, float("nan"), float("inf")],
                       [float("-inf")] * 4,
                       [1.0, 2.0, 3.0, 4.0]], dtype=torch.float64)
    inc, nw = tpf._lse_update(lw)
    for i in range(3):
        jinc, jnw = jpf._lse_update(jnp.asarray(lw[i].numpy()), 4,
                                    jnp.float64)
        np.testing.assert_allclose(inc[i].numpy(), np.asarray(jinc),
                                   rtol=1e-14)
        np.testing.assert_allclose(nw[i].numpy(), np.asarray(jnw),
                                   rtol=1e-14)
    assert torch.isneginf(inc[1]) and torch.allclose(
        nw[1], torch.full((4,), 0.25, dtype=torch.float64))


def test_more_than_32_particles_names_the_next_slice():
    """More than 32 particles go to the large-ensemble kernel's wrapper (on
    the CPU: its plain version fed from the Philox key), up to 512; beyond
    that the plain scan tier runs, drawing from the generator step by
    step."""
    jspec, jal = _jax_batch("poisson", True, 12, 2, 9, jnp.float64)
    spec, al = _to_port(jspec, jal, torch.float64)
    gen = torch.Generator().manual_seed(0)
    before = dict(cuda_kalman.LAUNCHES)
    a = tpf.psi_logw(spec, al, 64, gen)
    b = tpf.psi_logw(spec, al, 64, gen)
    assert cuda_kalman.LAUNCHES == before
    assert a.shape == (2,) and torch.isfinite(a).all()
    assert not torch.equal(a, b)          # each call draws a fresh key
    small = tpf.psi_logw(spec, al, 32, torch.Generator().manual_seed(0))
    assert torch.isfinite(small).all()
    big = tpf.psi_logw(spec, al, 513, torch.Generator().manual_seed(5))
    assert cuda_kalman.LAUNCHES == before
    assert big.shape == (2,) and torch.isfinite(big).all()
    assert torch.equal(big, tpf.psi_logw(spec, al, 513,
                                         torch.Generator().manual_seed(5)))
