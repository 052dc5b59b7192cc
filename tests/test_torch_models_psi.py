"""PyTorch port vs the JAX package: the psi log-weight of the IS
correction on the new univariate models (``svm`` both types, ``ar1_ng``,
``ssm_ung`` with a time-invariant and a time-varying Z), N = 6 particles,
float64 on the CPU, from the JAX package's own draws injected into the
port, as ``tests/test_torch_mcmc.py`` holds it for ``bsm_ng``: the Laplace
solve, the proposal factors and the filter chained, within atol 1e-9.
The models are ``tests/test_torch_models.py``'s.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.inference import mcmc as jmcmc

from bssm_tpu_torch.inference import mcmc as tmcmc
from tests.test_torch_models import N_OBS, NG, pair


@pytest.mark.parametrize("case", NG)
def test_psi_logw_matches_with_injected_draws(case):
    """The IS correction of B stored draws, the Laplace approximation
    recomputed (``store_modes=False``): the JAX package draws eps/us from
    its key inside ``psi_logw``; the test replays that key schedule and
    injects the draws into the port."""
    jm, tm, th = pair(case)
    n, N, B, m = N_OBS, 6, th.shape[0], tm.extra["m"]
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    correct_one = jmcmc._make_correct_one(jm, N, "psi", want_states=False,
                                          want_moments=False)
    ref = jax.jit(jax.vmap(lambda t, k: correct_one(
        (t, jnp.zeros((1,)), k))["log_w"]))(jnp.asarray(th), keys)
    eps, us = [], []
    for i in range(B):
        k_pf, _ = jax.random.split(keys[i])
        k_e, k_r = jax.random.split(k_pf)
        eps.append(np.asarray(jax.random.normal(k_e, (n + 1, N, m),
                                                jnp.float64)))
        us.append(np.asarray(jax.random.uniform(k_r, (n, N), jnp.float64)))
    got = tmcmc._make_correct_rows(tm, N, "psi")(
        torch.as_tensor(th), None, None, eps=torch.as_tensor(np.stack(eps)),
        us=torch.as_tensor(np.stack(us)))["log_w"]
    assert np.isfinite(np.asarray(ref)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)
