"""PyTorch port vs the JAX package: the nonlinear models
(``models/nlg.py``, ``models/examples.py``), float64 on the CPU.

The four example models are built by both packages; their functions are
evaluated at the same (t, alpha, theta) rows, the JAX ones mapped over the
rows, the port's batched, and agree to 1e-12: Z, H, T, R, a1, P1, the
Jacobians (the JAX package's ``jacfwd`` against the port's closed forms,
and those against the port's ``forward_jacobian``) and the log prior.
``simulate_growth`` gives the JAX package's series.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.models import examples as jex

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import nlg as tnlg
from bssm_tpu_torch.models.nlg import forward_jacobian

EXAMPLES = {"nlg_linear_gaussian": 1, "nlg_sin_exp": 1, "nlg_ar_exp": 1,
            "nlg_growth": 2}


def _close(got, want, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _rows(name, R=24, seed=0):
    """(t, alpha, theta) rows around the model's initial theta; the growth
    model's population level near its scale."""
    m = EXAMPLES[name]
    jm = getattr(jex, name)(np.ones(10))
    rng = np.random.default_rng(seed)
    th = np.asarray(jm.theta_init) + 0.2 * rng.normal(
        size=(R, jm.theta_init.shape[0]))
    if name == "nlg_ar_exp":
        th[:, 1] = rng.uniform(0.1, 0.9, R)     # rho inside (0, 1)
    alpha = rng.normal(size=(R, m))
    if name == "nlg_growth":
        alpha[:, 1] = rng.uniform(1.0, 90.0, R)
    return jm, rng.integers(0, 10, R), alpha, th


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_functions_match_jax(name):
    jm, t, alpha, th = _rows(name)
    tm = getattr(bt.example_models, name)(np.ones(10), dtype=torch.float64,
                                          device="cpu")
    js = jm.build(jnp.asarray(th[0]))
    ts = tm.build(torch.as_tensor(th))
    tt, ta, tth = (torch.as_tensor(x) for x in (t, alpha, th))
    jt, ja, jth = (jnp.asarray(x) for x in (t, alpha, th))
    for f in ("Z_fn", "H_fn", "T_fn", "R_fn", "Z_gn", "T_gn"):
        want = jax.vmap(getattr(js, f))(jt, ja, jth)
        _close(getattr(ts, f)(tt, ta, tth), want)
    for f in ("Z_fn", "T_fn"):          # the closed forms against autodiff
        _close(forward_jacobian(getattr(ts, f))(tt, ta, tth),
               getattr(ts, f.replace("_fn", "_gn"))(tt, ta, tth))
    _close(ts.a1(), jax.vmap(js.a1_fn)(jth))
    _close(ts.P1(), jax.vmap(js.P1_fn)(jth))
    _close(tm.log_prior(tth), jax.vmap(jm.log_prior)(jth))
    _close(tm.log_prior(tth[0]), jm.log_prior(jth[0]))
    assert tm.kind == "nlg" and tm.theta_names == jm.theta_names
    np.testing.assert_array_equal(tm.theta_init, np.asarray(jm.theta_init))


def test_simulate_growth_matches_jax():
    for kw in ({}, dict(n=40, seed=3)):
        np.testing.assert_array_equal(bt.example_models.simulate_growth(**kw),
                                      jex.simulate_growth(**kw))


def _growth_fns(model):
    s = model.build(torch.as_tensor(model.theta_init))
    return dict(Z_fn=s.Z_fn, H_fn=s.H_fn, T_fn=s.T_fn, R_fn=s.R_fn,
                a1_fn=s.a1_fn, P1_fn=s.P1_fn), s


def test_ssm_nlg_default_jacobians_equal_user_jacobians():
    """``ssm_nlg`` with the growth model's functions and no Jacobians
    (forward mode) against the example with its closed forms: the
    Jacobians at every (row, t) of a batch and the EKF, iterated EKF and
    mode approximation they drive."""
    y = bt.example_models.simulate_growth(n=30, seed=2)
    y[4] = np.nan
    ex = bt.example_models.nlg_growth(y, dtype=torch.float64, device="cpu")
    fns, s = _growth_fns(ex)
    auto = bt.ssm_nlg(y, fns["Z_fn"], fns["H_fn"], fns["T_fn"],
                      fns["R_fn"], m=2, k=2, a1_fn=fns["a1_fn"],
                      P1_fn=fns["P1_fn"], theta_init=ex.theta_init,
                      log_prior=lambda th: torch.zeros(th.shape[0],
                                                       dtype=th.dtype),
                      iekf_iter=2, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(1)
    th = torch.as_tensor(ex.theta_init + 0.2 * rng.normal(size=(3, 3)))
    sa, se = auto.build(th), ex.build(th)
    mode = tnlg.approximate_nlg(se).mode
    ga, ge = tnlg.build_approx(sa, mode), tnlg.build_approx(se, mode)
    _close(ga.Z, ge.Z)
    _close(ga.T, ge.T)
    for it in (0, 2):
        ra = tnlg.ekf(dataclasses.replace(sa, iekf_iter=it))
        re = tnlg.ekf(dataclasses.replace(se, iekf_iter=it))
        _close(ra.logLik, re.logLik, 1e-10)
        _close(ra.att, re.att, 1e-10)
    _close(tnlg.approximate_nlg(sa).loglik,
           tnlg.approximate_nlg(se).loglik, 1e-10)
    assert auto.theta_names == ("theta_1", "theta_2", "theta_3")
    assert sa.iekf_iter == 2 and sa.batch == 3 and sa.n == 30 and sa.p == 1


def test_ssm_nlg_defaults_and_device():
    """Default a1 (zero), P1 (identity), prior (flat); the model runs on the
    CUDA device unless the caller asks for the CPU."""
    def Z_fn(t, a, th):
        return a[:, :1]

    def H_fn(t, a, th):
        return torch.exp(th[:, :1])[:, :, None]

    def T_fn(t, a, th):
        return 0.9 * a

    def R_fn(t, a, th):
        return torch.exp(th[:, 1:2])[:, :, None] * torch.eye(
            2, 1, dtype=a.dtype)

    m = bt.ssm_nlg(np.arange(5.0), Z_fn, H_fn, T_fn, R_fn, m=2, k=1,
                   theta_init=(0.0, -1.0), dtype=torch.float64,
                   device="cpu")
    s = m.build(torch.zeros(4, 2, dtype=torch.float64))
    assert s.a1().shape == (4, 2) and not s.a1().any()
    _close(s.P1(), np.broadcast_to(np.eye(2), (4, 2, 2)))
    _close(m.log_prior(torch.zeros(4, 2, dtype=torch.float64)), np.zeros(4))
    _close(s.T_gn(torch.zeros(4, dtype=torch.int64), s.a1(), s.theta),
           np.broadcast_to(0.9 * np.eye(2), (4, 2, 2)))
    assert s.k == 1 and s.y.shape == (5, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bt.ssm_nlg(np.arange(5.0), Z_fn, H_fn, T_fn, R_fn, m=2)
