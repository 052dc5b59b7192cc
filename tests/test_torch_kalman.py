"""PyTorch port vs the JAX package: Kalman recursions, PSD factorisations
and the backward (FFBS) proposal factors.

``ops/kalman.smoother_bwd_factors`` is the plain version of the port's
``rts_factors`` CUDA kernel, and ``ops/kalman.fast_smoother_ll`` the body of
its ``laplace_solve`` kernel; here they are held against the JAX scan path
in float64 and against the Pallas kernel in interpret mode in float32.

Tolerances: both sides are the same recursions in float64, but the products
are summed in another order (batched matmul vs per-row dot), so over n ~ 30
steps the results agree to rtol 1e-9, not to the ulp.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.spec import LGSpec as JLGSpec
from bssm_tpu.ops import chol as jchol
from bssm_tpu.ops import kalman as jkalman

from bssm_tpu_torch.convert import lgspec_from_numpy
from bssm_tpu_torch.core.spec import LGSpec as TLGSpec
from bssm_tpu_torch.ops import chol as tchol
from bssm_tpu_torch.ops import cuda_kalman
from bssm_tpu_torch.ops import kalman as tkalman

from torch_split_mirror import split_backward

RTOL = 1e-9


def _lg_arrays(seed, n, m, batch, dtype=np.float64, diffuse=False):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(batch, n)).astype(dtype)
    y[:, rng.integers(0, n, size=max(1, n // 5))] = np.nan
    Z = rng.normal(size=(batch, 1, m)).astype(dtype)
    H = (np.abs(rng.normal(size=(batch, n))) + 0.3).astype(dtype)
    A = rng.normal(size=(batch, m, m)).astype(dtype)
    T = (0.8 * np.eye(m, dtype=dtype) + 0.1 * A)[:, None]
    R = (rng.normal(size=(batch, 1, m, m)) * 0.4).astype(dtype)
    a1 = rng.normal(size=(batch, m)).astype(dtype)
    if diffuse:
        P1 = np.broadcast_to(100.0 * np.eye(m, dtype=dtype),
                             (batch, m, m)).copy()
    else:
        P = rng.normal(size=(batch, m, m)).astype(dtype)
        P1 = np.einsum('bij,bkj->bik', P, P).astype(dtype)
    D = rng.normal(size=(batch, n)).astype(dtype)
    C = (rng.normal(size=(batch, 1, m)) * 0.1).astype(dtype)
    return dict(y=y, Z=Z, H=H, T=T, R=R, a1=a1, P1=P1, D=D, C=C)


def _both(d):
    j = JLGSpec(**{k: jnp.asarray(v) for k, v in d.items()})
    t = lgspec_from_numpy(d, device="cpu", dtype=torch.as_tensor(d["y"]).dtype)
    assert isinstance(t, TLGSpec)
    return j, t


def _close(t_val, j_val, rtol=RTOL, atol=1e-11):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("m,diffuse", [(1, False), (2, True), (3, False),
                                       (3, True)])
def test_filter_and_smoother_match(m, diffuse):
    """log_likelihood, kfilter and fast_smoother_ll with missing y."""
    j, t = _both(_lg_arrays(10 + m, 30, m, 4, diffuse=diffuse))
    _close(tkalman.log_likelihood(t), jax.vmap(jkalman.log_likelihood)(j))
    rj = jax.vmap(jkalman.kfilter)(j)
    rt = tkalman.kfilter(t)
    for name in ("at", "att", "Pt", "Ptt", "logLik", "vt", "Ft", "Kt"):
        _close(getattr(rt, name), getattr(rj, name))
    aj, lj = jax.vmap(jkalman.fast_smoother_ll)(j)
    at, lt = tkalman.fast_smoother_ll(t)
    _close(at, aj)
    _close(lt, lj)


@pytest.mark.parametrize("m,diffuse", [(1, False), (2, True), (4, False)])
def test_split_backward_matches_jax_fast_smoother(m, diffuse):
    """The fast smoother's backward pass split as the fast_smoother_ll and
    laplace_step kernels run it (``torch_split_mirror``: F = +inf and v = 0
    staged where a step updates nothing, c_t and L_t for every t at once,
    the r chain alone step by step), float64, missing y: within 1e-10 of
    the JAX package's fast smoother; at a folded step w and g are exact
    zeros and the chain's step is exactly the missing branch T' r."""
    j, t = _both(_lg_arrays(40 + m, 30, m, 3, diffuse=diffuse))
    sp = split_backward(t)
    aj, lj = jax.vmap(jkalman.fast_smoother_ll)(j)
    _close(sp["alpha"], aj, rtol=1e-10, atol=1e-10)
    _close(sp["ll"], lj, rtol=1e-10, atol=1e-10)
    at, _ = tkalman.fast_smoother_ll(t)
    _close(sp["alpha"], at, rtol=1e-12, atol=1e-12)
    miss = ~sp["ok"]
    assert miss.any() and sp["ok"].any()
    assert torch.isfinite(sp["w"]).all() and torch.isfinite(sp["g"]).all()
    assert torch.isinf(sp["F"][miss]).all() and (sp["v"][miss] == 0).all()
    assert (sp["w"][miss] == 0).all() and (sp["g"][miss] == 0).all()
    T, rp = sp["T"], sp["rprev"]
    n = rp.shape[1]
    for b, s in miss.nonzero().tolist():
        r_in = rp[b, s + 1] if s + 1 < n else torch.zeros(m,
                                                           dtype=rp.dtype)
        want = []
        for jj in range(m):
            acc = torch.zeros((), dtype=rp.dtype)
            for i in range(m):
                acc = acc + T[b, i, jj] * r_in[i]
            want.append(acc)
        assert torch.equal(rp[b, s], torch.stack(want)), (b, s)


def test_shared_leaves_broadcast():
    """Leaves without a batch axis (data, Z, T, C, a1) broadcast against
    batched ones, and a time-invariant H and D take the size-1 time axis."""
    d = _lg_arrays(3, 20, 2, 3)
    shared = dict(d)
    for k in ("y", "Z", "T", "C", "a1"):
        shared[k] = d[k][0]
    shared["H"] = d["H"][:, :1]
    shared["D"] = d["D"][0, :1]
    full = dict(d)
    for k in ("y", "Z", "T", "C", "a1"):
        full[k] = np.broadcast_to(d[k][0], d[k].shape).copy()
    full["H"] = np.broadcast_to(d["H"][:, :1], d["H"].shape).copy()
    full["D"] = np.broadcast_to(d["D"][0, :1], d["D"].shape).copy()
    ts = lgspec_from_numpy(shared, device="cpu", dtype=torch.float64)
    assert ts.batch == 3
    j, _ = _both(full)
    _close(tkalman.log_likelihood(ts), jax.vmap(jkalman.log_likelihood)(j))
    aj, _ = jax.vmap(jkalman.fast_smoother_ll)(j)
    _close(tkalman.fast_smoother_ll(ts)[0], aj)


def test_degenerate_model_loglik_is_minus_inf():
    d = _lg_arrays(4, 10, 2, 2)
    d["H"] = np.zeros_like(d["H"])
    d["R"] = np.zeros_like(d["R"])
    _, t = _both(d)
    assert torch.isneginf(tkalman.log_likelihood(t)).all()


@pytest.mark.parametrize("m", [1, 2, 3])
def test_psd_pinv_and_factor_match(m):
    """Tikhonov pseudo-inverse and clipped factor, with a rank-deficient and
    a slightly indefinite matrix in the batch."""
    rng = np.random.default_rng(20 + m)
    A = rng.normal(size=(6, m, m))
    V = np.einsum('bij,bkj->bik', A, A)
    if m > 1:
        V[1, -1, :] = 0.0
        V[1, :, -1] = 0.0                # deterministic component
    V[2] -= 1e-9 * np.eye(m)             # cancellation-indefinite
    tV = torch.as_tensor(V)
    _close(tchol._psd_pinv(tV), jax.vmap(jchol._psd_pinv)(jnp.asarray(V)),
           rtol=1e-8, atol=1e-9)
    Lt = tchol._psd_factor(tV)
    Lj = jax.vmap(jchol._psd_factor)(jnp.asarray(V))
    if m <= 2:
        # closed-form eigensystem: the same column convention on both sides
        _close(Lt, Lj, atol=1e-10)
    else:
        # eigh's eigenvector signs are arbitrary: compare L L'
        _close(Lt @ Lt.transpose(-1, -2),
               jnp.einsum('bij,bkj->bik', Lj, Lj), atol=1e-10)


def test_psd_chol_zero_rows():
    rng = np.random.default_rng(31)
    A = rng.normal(size=(3, 3, 3))
    V = np.einsum('bij,bkj->bik', A, A)
    V[0, 1, :] = 0.0
    V[0, :, 1] = 0.0
    _close(tchol.psd_chol(torch.as_tensor(V)),
           jax.vmap(jchol.psd_chol)(jnp.asarray(V)))


@pytest.mark.parametrize("down", [False, True])
def test_chol_rank1_update_match(down):
    rng = np.random.default_rng(32)
    A = rng.normal(size=(5, 3, 3))
    L = np.linalg.cholesky(np.einsum('bij,bkj->bik', A, A)
                           + 2.0 * np.eye(3))
    v = rng.normal(size=(5, 3)) * (0.2 if down else 1.0)
    ref = jax.vmap(lambda l, x: jchol.chol_rank1_update(l, x, down))(
        jnp.asarray(L), jnp.asarray(v))
    got = tchol.chol_rank1_update(torch.as_tensor(L), torch.as_tensor(v),
                                  torch.full((5,), down))
    _close(got, ref)
    sign = -1.0 if down else 1.0
    np.testing.assert_allclose(
        (got @ got.transpose(-1, -2)).numpy(),
        np.einsum('bij,bkj->bik', L, L)
        + sign * np.einsum('bi,bj->bij', v, v), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_bwd_factors_match_scan(m):
    """Plain version of the rts_factors kernel vs the JAX scan path (f64).
    ahat and Ab to rtol 1e-8 (a pseudo-inverse sits in the chain); Lb column
    for column at m <= 2, as L L' at m = 3 (eigenvector signs)."""
    j, t = _both(_lg_arrays(40 + m, 28, m, 4, diffuse=(m == 2)))
    ra, rl, rc = jax.vmap(jkalman.smoother_bwd_factors)(j)
    ahat, Lb, Ab = cuda_kalman.rts_factors(t)      # CPU tensors: plain path
    assert ahat.shape == (4, 29, m) and Lb.shape == Ab.shape == (4, 29, m, m)
    _close(ahat, ra, rtol=1e-8, atol=1e-9)
    _close(Ab, rc, rtol=1e-8, atol=1e-9)
    if m <= 2:
        _close(Lb, rl, rtol=1e-8, atol=1e-9)
    else:
        _close(Lb @ Lb.transpose(-1, -2),
               jnp.einsum('btij,btkj->btik', rl, rl), rtol=1e-8, atol=1e-9)
    assert torch.equal(Ab[:, -1], torch.zeros_like(Ab[:, -1]))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_bwd_factors_come_from_the_filtered_moments_alone(m):
    """The premise of the rts_factors kernel's layout: at every t < n, J_t
    and the factor of Sig_t computed from (att_t, Ptt_t) alone, with
    P_{t+1|t} and a_{t+1|t} predicted again from them, equal
    smoother_bwd_factors' Ab_t and Lb_t; the affine recursion
    ahat_t = att_t + J_t (ahat_{t+1} - a_{t+1|t}) from ahat_n = a_{n|n-1}
    reproduces its ahat; t = n is the factor of P_{n|n-1} alone.  Float64,
    missing y, to roundoff (rtol 1e-12: the same operations in another
    batching)."""
    from bssm_tpu_torch.ops.chol import _psd_factor, _psd_pinv
    from bssm_tpu_torch.core.spec import at_t
    d = _lg_arrays(70 + m, 26, m, 3, diffuse=(m == 2))
    d["y"][:, [0, 11, 25]] = np.nan
    _, t = _both(d)
    ahat, Lb, Ab = tkalman.smoother_bwd_factors(t)
    r = tkalman.kfilter(t)
    s = tkalman._sys(t)
    n = t.n
    T, RR, C = at_t(s.T, 0), at_t(s.RR, 0), at_t(s.C, 0)
    tr = lambda A: A.transpose(-1, -2)                       # noqa: E731
    close = lambda a, b: torch.testing.assert_close(        # noqa: E731
        a, b, rtol=1e-12, atol=1e-12)
    J, a_next = [], []
    for k in range(n):
        Ptt, att = r.Ptt[:, k], r.att[:, k]
        P_next = tkalman._sym(T @ Ptt @ tr(T) + RR)
        close(P_next, r.Pt[:, k + 1])
        a_next.append(C + (T @ att[..., None])[..., 0])
        close(a_next[-1], r.at[:, k + 1])
        Jk = Ptt @ tr(T) @ _psd_pinv(P_next)
        ImJT = torch.eye(m, dtype=Jk.dtype) - Jk @ T
        Sig = tkalman._sym(ImJT @ Ptt @ tr(ImJT) + Jk @ RR @ tr(Jk))
        close(Jk, Ab[:, k])
        L = _psd_factor(Sig)
        close(L @ tr(L), Lb[:, k] @ tr(Lb[:, k]))
        if m <= 2:
            close(L, Lb[:, k])
        J.append(Jk)
    close(_psd_factor(r.Pt[:, n]), Lb[:, n])
    assert torch.equal(Ab[:, n], torch.zeros_like(Ab[:, n]))
    ah = r.at[:, n]
    close(ah, ahat[:, n])
    for k in range(n - 1, -1, -1):
        ah = r.att[:, k] + (J[k] @ (ah - a_next[k])[..., None])[..., 0]
        close(ah, ahat[:, k])


@pytest.mark.parametrize("m", [2, 3])
def test_bwd_factors_match_pallas_interpret_f32(m):
    """Plain version (float32) vs the TPU kernel in interpret mode, at the
    tolerances the JAX package's own kernel tests use: rtol/atol 1e-4 on
    ahat at m = 2 (1e-3 at m = 3, Jacobi), 5e-3 on L L'."""
    from bssm_tpu.core import config
    from bssm_tpu.ops.pallas_kalman import fused_smoother_bwd_factors_batched
    d = _lg_arrays(50 + m, 29, m, 3, dtype=np.float32)
    j, t = _both(d)
    old = config.fused_kernels
    try:
        config.set_fused_kernels(True)
        out = fused_smoother_bwd_factors_batched(j, 3, interpret=True)
    finally:
        config.set_fused_kernels(old)
    assert out is not None
    ka, kl, kc = out
    ahat, Lb, Ab = tkalman.smoother_bwd_factors(t)
    assert ahat.dtype == torch.float32
    tol = 1e-4 if m == 2 else 1e-3
    _close(ahat, ka, rtol=tol, atol=tol)
    _close(Ab, kc, rtol=1e-3, atol=1e-3)
    _close(Lb @ Lb.transpose(-1, -2),
           np.einsum('btij,btkj->btik', np.asarray(kl), np.asarray(kl)),
           rtol=0, atol=5e-3)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The contract checks of the CUDA wrappers are plain Python and run on
    any device: m > 4 and time-varying system matrices are refused."""
    d = _lg_arrays(60, 12, 5, 2)
    _, t = _both(d)
    with pytest.raises(NotImplementedError, match="m <= 4"):
        cuda_kalman._check_system(t)
    d = _lg_arrays(61, 12, 2, 2)
    d["T"] = np.broadcast_to(d["T"], (2, 12, 2, 2)).copy()
    _, t = _both(d)
    with pytest.raises(NotImplementedError, match="time-invariant T"):
        cuda_kalman._check_system(t)
    with pytest.raises(TypeError, match="dtype"):
        cuda_kalman._check_tensors([("H", t.H.to(torch.float32))], t.y)
    flat, leaves = cuda_kalman._system_args(
        _both(_lg_arrays(62, 12, 2, 3))[1], 3, with_phi=False)
    assert len(flat) == 15 and [nm for nm, _, _ in leaves] == \
        list(cuda_kalman.SYSTEM)
