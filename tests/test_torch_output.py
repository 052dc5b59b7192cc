"""PyTorch port vs the JAX package: the methods of ``McmcOutput``.

- ``save`` / ``load``: a round trip keeps every field; a file saved by the
  JAX package loads in the port and one saved by the port loads in the JAX
  package (each ignores the fields it does not know).
- ``last_theta``, ``as_draws``, ``to_dataframe`` (theta and states) and
  ``str()`` equal the JAX package's on an output each builds from the same
  arrays; ``plot`` returns a figure of d rows of two axes.
- A run resumed from ``last_theta`` and the final ``S`` with ``burnin=0``
  starts where the first ended, as ``tests/test_checkpoint.py`` holds for
  the JAX package.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import numpy as np
import pandas as pd
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.inference.mcmc import McmcOutput as JOut
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference.mcmc import McmcOutput as TOut
from tests.test_torch_diagnostics import outputs


def _fields(out):
    import dataclasses
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}


def _same(a, b, names):
    fa, fb = _fields(a), _fields(b)
    for k in names:
        if isinstance(fb[k], np.ndarray):
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
            assert fa[k].dtype == fb[k].dtype, k
        else:
            assert fa[k] == fb[k], k


def _port_output():
    _, to = outputs(seed=4)
    to.alphahat = to.alpha.mean(axis=(0, 1))
    to.Vt = np.tile(np.eye(2), (10, 1, 1))
    to.theta = to.theta.astype(np.float32)      # a float32 run's arrays
    to.n_corrected, to.local_approx = 57, True
    return to


def test_save_load_round_trip(tmp_path):
    to = _port_output()
    path = tmp_path / "run.npz"
    to.save(str(path))
    back = TOut.load(str(path))
    _same(back, to, _fields(to))
    assert isinstance(back.theta_names, tuple)
    assert back.time == {"mcmc": 1.25, "correction": 0.5}


def test_files_load_across_packages(tmp_path):
    jo, to = outputs(seed=5)
    to.n_corrected, to.local_approx = 12, False
    shared = [k for k in _fields(jo)]
    jo.save(str(tmp_path / "jax.npz"))
    to.save(str(tmp_path / "torch.npz"))
    from_jax = TOut.load(str(tmp_path / "jax.npz"))
    _same(from_jax, to, shared)
    assert from_jax.n_corrected is None and from_jax.local_approx is None
    from_torch = JOut.load(str(tmp_path / "torch.npz"))
    _same(from_torch, jo, shared)


def test_last_theta_and_as_draws_match():
    y = np.random.default_rng(2).poisson(3.0, 20).astype(float)
    jm = jbsm_ng(y, sd_level=j_halfnormal(0.1, 1.0), distribution="poisson")
    tm = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                   distribution="poisson", dtype=torch.float64, device="cpu")
    jo, to = outputs(seed=6, d=1)
    np.testing.assert_array_equal(to.last_theta(tm), jo.last_theta(jm))
    np.testing.assert_allclose(to.last_theta(tm), np.log(to.theta[:, -1]))
    jd, td = jo.as_draws(), to.as_draws()
    assert list(td) == list(jd) == ["sd_0", ".log_posterior", ".weight"]
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k])


@pytest.mark.parametrize("variable", ["theta", "states"])
def test_to_dataframe_matches(variable):
    jo, to = outputs(seed=7)
    pd.testing.assert_frame_equal(to.to_dataframe(variable),
                                  jo.to_dataframe(variable))


@pytest.mark.parametrize("kind", ["states", "summary", "theta only"])
def test_str_matches(kind):
    jo, to = outputs(seed=8, states=kind == "states")
    if kind == "summary":
        for o in (jo, to):
            o.alphahat = np.linspace(0.0, 1.0, 20).reshape(10, 2)
            o.Vt = np.tile(np.diag([0.5, 2.0]), (10, 1, 1))
    text = str(to)
    assert text == str(jo)
    assert "Summary for theta" in text


def test_plot_has_a_row_of_two_axes_a_parameter():
    _, to = outputs(seed=9, d=3)
    with pytest.warns(UserWarning, match="IS-weighted"):
        fig = to.plot()
    assert np.asarray(fig.axes).size == 6
    assert fig.axes[0].get_ylabel() == "sd_0"
    import matplotlib.pyplot as plt
    plt.close(fig)


def test_save_load_resume(tmp_path):
    """A linear-Gaussian run saved, loaded and continued from its final
    state: the resumed chains start where the first run ended."""
    rng = np.random.default_rng(42)
    n = 30
    y = np.cumsum(rng.normal(0, 0.3, n)) + rng.normal(0, 1.0, n)
    model = bt.bsm_lg(y, sd_y=bt.halfnormal_prior(1.0, 5.0),
                      sd_level=bt.halfnormal_prior(0.3, 5.0),
                      dtype=torch.float64, device="cpu")
    out = bt.run_mcmc(model, iter=200, seed=1, n_chains=3, device="cpu")
    path = str(tmp_path / "run.npz")
    out.save(path)
    back = TOut.load(path)
    np.testing.assert_array_equal(back.theta, out.theta)
    assert back.mcmc_type == out.mcmc_type == "gaussian"
    out2 = bt.run_mcmc(model, iter=100, burnin=0, seed=2, n_chains=3,
                       theta_init=back.last_theta(model), S=back.S,
                       device="cpu")
    assert out2.theta.shape == (3, 100, 2)
    assert np.isfinite(out2.theta).all()
    np.testing.assert_allclose(np.log(out2.theta[:, 0, :]).mean(),
                               np.log(out.theta[:, -1, :]).mean(), atol=1.0)
