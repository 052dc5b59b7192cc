"""PyTorch port vs the JAX package: KFAS ``SSModel`` ingestion
(``utils/rdata.py``, ``utils/kfas.py``) and ``as_bssm``, on the CPU in
float64.

The ``.rds`` files are written by ``tests/rds_writer.py`` in the layouts
of ``tests/test_kfas.py``: a local level with a diffuse P1, a bivariate
Gaussian with LDL-factored H and Q, Poisson with exposure, negative
binomial with phi in u, a mixed Poisson + Gaussian pair, and a
time-varying phi that both packages refuse.  For each the port's model is
the JAX package's: the same kind, every system array to 1e-12 and the
log-likelihood (exact, or of the Laplace approximation) to 1e-9.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import dataclasses

import numpy as np
import pytest
import torch

from bssm_tpu.inference.loglik import logLik as jlogLik
from bssm_tpu.models.ssm import as_bssm as jas_bssm
from bssm_tpu.utils.rdata import load_rds as jload_rds

import bssm_tpu_torch as bt
from bssm_tpu_torch.utils.rdata import load_rds

from rds_writer import write_rds
from test_kfas import _nile_like

KW = dict(dtype=torch.float64, device="cpu")


def _layout(name, rng):
    """An SSModel of ``tests/test_kfas.py``'s layout ``name`` (the writer's
    form: arrays, a (values, attributes) pair for y, names)."""
    if name in ("gaussian_diffuse", "poisson_exposure", "negbin_phi",
                "time_varying_phi"):
        m = _nile_like(rng)
        if name == "poisson_exposure":
            lam = np.exp(np.cumsum(rng.normal(0, 0.1, 60)))
            m["y"] = (rng.poisson(lam).astype(float).reshape(60, 1),
                      {"dim": np.array([60, 1.0])})
            m["distribution"] = "poisson"
            m["u"] = np.full((60, 1), 2.0)
        elif name == "negbin_phi":
            m["y"] = (rng.poisson(5.0, 60).astype(float).reshape(60, 1),
                      {"dim": np.array([60, 1.0])})
            m["distribution"] = "negative binomial"
            m["u"] = np.full((60, 1), 3.5)
        elif name == "time_varying_phi":
            m["distribution"] = "negative binomial"
            m["u"] = np.linspace(1, 2, 60).reshape(60, 1)
        return m
    if name == "mlg_ldl":
        n = 40
        return {"y": (rng.normal(size=(n, 2)).cumsum(axis=0),
                      {"dim": np.array([n, 2.0])}),
                "Z": np.eye(2).reshape(2, 2, 1),
                "H": np.array([[2.0, 0.5], [0.5, 1.0]]).reshape(2, 2, 1),
                "T": np.eye(2).reshape(2, 2, 1),
                "R": np.eye(2).reshape(2, 2, 1),
                "Q": np.array([[0.3, 0.1], [0.1, 0.2]]).reshape(2, 2, 1),
                "a1": np.zeros((2, 1)), "P1": np.eye(2) * 5.0,
                "P1inf": np.zeros((2, 2)), "u": np.ones((n, 2)),
                "distribution": ["gaussian", "gaussian"]}
    assert name == "mng_mixed"
    n = 30
    y = np.column_stack([rng.poisson(3.0, n).astype(float),
                         rng.normal(0, 1, n)])
    return {"y": (y, {"dim": np.array([n, 2.0])}),
            "Z": np.eye(2).reshape(2, 2, 1), "H": np.zeros((2, 2, 1)),
            "T": np.eye(2).reshape(2, 2, 1), "R": np.eye(2).reshape(2, 2, 1),
            "Q": (0.1 * np.eye(2)).reshape(2, 2, 1), "a1": np.zeros((2, 1)),
            "P1": np.eye(2), "P1inf": np.zeros((2, 2)),
            "u": np.column_stack([np.ones(n), np.full(n, 4.0)]),
            "distribution": ["poisson", "gaussian"]}


KINDS = {"gaussian_diffuse": "lg", "mlg_ldl": "mlg",
         "poisson_exposure": "ng", "negbin_phi": "ng", "mng_mixed": "mng"}


def _leaves(spec):
    fields = spec._asdict() if isinstance(spec, tuple) else {
        f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    return {k: v for k, v in fields.items() if hasattr(v, "shape")}


def _same_system(tm, jm):
    """Every array leaf of the two models' specs at theta_init to 1e-12."""
    assert tm.kind == jm.kind
    ts = tm.build(torch.as_tensor(tm.theta_init))
    js = jm.build(jm.theta_init)
    tl, jl = _leaves(ts), _leaves(js)
    assert set(tl) == set(jl)
    for k, v in tl.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jl[k]), rtol=0,
                                   atol=1e-12, err_msg=k)


def _rds(tmp_path, rng, name):
    path = str(tmp_path / f"{name}.rds")
    write_rds(path, _layout(name, rng))
    return path


def test_load_rds_equals_jax(tmp_path, rng):
    """The port's reader returns what the JAX package's returns, to the bit,
    for every layout."""
    for name in list(KINDS) + ["time_varying_phi"]:
        path = _rds(tmp_path, rng, name)
        got, ref = load_rds(path), jload_rds(path)
        assert list(got) == list(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray) and ref[k].dtype.kind == "f":
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            else:
                assert list(np.atleast_1d(got[k])) == \
                    list(np.atleast_1d(ref[k])), k


@pytest.mark.parametrize("name", sorted(KINDS))
def test_as_bssm_kfas_matches_jax(tmp_path, rng, name):
    """An ``.rds`` path and its parsed dict give the JAX package's model:
    kind, system arrays, and the log-likelihood (exact for lg / mlg, of
    the Laplace approximation for ng / mng) to 1e-9."""
    path = _rds(tmp_path, rng, name)
    jm = jas_bssm(path, kappa=1e4)
    tm = bt.as_bssm(path, kappa=1e4, **KW)
    assert tm.kind == KINDS[name]
    _same_system(tm, jm)
    _same_system(bt.as_bssm(load_rds(path), kappa=1e4, **KW), jm)
    ref = float(jlogLik(jm))
    got = float(bt.logLik(tm).reshape(-1)[0])
    assert np.isfinite(got)
    assert abs(got - ref) <= 1e-9 * (1.0 + abs(ref)), (got, ref)


def test_as_bssm_time_varying_phi_rejected(tmp_path, rng):
    path = _rds(tmp_path, rng, "time_varying_phi")
    for make in (jas_bssm, lambda p: bt.as_bssm(p, **KW)):
        with pytest.raises(ValueError, match="time-varying"):
            make(path)


def _raw(kind, rng):
    """Raw system matrices in the R package's layout, and the extra
    arguments, for a model of ``kind``."""
    n = 25
    if kind in ("lg", "ng"):
        y = rng.poisson(3.0, n).astype(float) if kind == "ng" \
            else rng.normal(size=n).cumsum()
        sysm = dict(Z=np.array([1.0, 0.0]),
                    T=np.array([[1.0, 1.0], [0.0, 1.0]]),
                    R=np.diag([0.3, 0.05]), a1=np.array([1.0, 0.0]),
                    P1=np.diag([2.0, 0.1]))
        if kind == "lg":
            return y, dict(H=0.7, **sysm)
        return y, dict(distribution="poisson", u=np.full(n, 2.0), **sysm)
    y = np.column_stack([rng.poisson(3.0, n).astype(float),
                         rng.normal(size=n)])
    sysm = dict(Z=np.eye(2), T=0.9 * np.eye(2), R=0.3 * np.eye(2),
                a1=np.zeros(2), P1=np.eye(2))
    if kind == "mlg":
        y[:, 0] = rng.normal(size=n)
        return y, dict(H=np.array([[1.0, 0.0], [0.4, 0.8]]), **sysm)
    return y, dict(distribution=["poisson", "gaussian"], phi=[1.0, 0.5],
                   **sysm)


@pytest.mark.parametrize("kind", ["lg", "ng", "mlg", "mng"])
def test_as_bssm_raw_matrices(rng, kind):
    """Raw system matrices give ``ssm_ulg`` / ``ssm_ung`` / ``ssm_mlg`` /
    ``ssm_mng``, each equal to the JAX package's (kind and arrays)."""
    y, kw = _raw(kind, rng)
    tm = bt.as_bssm(y, **kw, **KW)
    assert tm.kind == kind
    _same_system(tm, jas_bssm(y, **kw))
