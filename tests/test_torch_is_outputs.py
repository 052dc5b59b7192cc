"""PyTorch port vs the JAX package: the state outputs of the IS correction
(is1 / is2 / is3 with summary and full output), ``post_correct`` and
``suggest_N``.

- ``_is_finish`` (jump-chain fill, is1's segment mixture, the global
  weighted moments) is deterministic given the corrections and the Gumbel
  noise of is1's mixture draw: both sides get the same, and agree to
  roundoff.
- The corrections themselves draw particle-filter randomness, which the two
  packages take from different generators: both correct the same stored
  draws, and the weighted means of theta, the summary ``alphahat`` and the
  mean of the full output's trajectories agree within Monte-Carlo error.
- ``post_correct`` with ``is_correction_generator`` replays a ``run_mcmc``
  correction exactly.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.inference.postcorrect import post_correct as j_post_correct

import bssm_tpu_torch as bt
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.inference.postcorrect import _make_correct_rows

from test_torch_filters import _models

F64 = jnp.float64


@pytest.mark.parametrize("output", ["theta", "summary", "full"])
@pytest.mark.parametrize("is_type", [1, 2, 3])
def test_is_finish_matches(is_type, output):
    """Synthetic corrections with a -inf and a NaN log-weight; is3 takes
    the bootstrap filter's ratio to the stored approximate likelihood.
    Log-weights, mixture draws and moments to 1e-12."""
    rng = np.random.default_rng(is_type)
    C, Sn, n1, m = 3, 8, 5, 2
    hm = rng.random((C, Sn)) < 0.4
    hm[:, 0] = True
    hmask = hm.reshape(-1)
    Ns = int(hmask.sum()) if is_type == 2 else C * Sn
    corr = {"log_w": rng.normal(size=Ns)}
    corr["log_w"][[1, 4]] = (-np.inf, np.nan)
    if output == "full":
        corr["alpha"] = rng.normal(size=(Ns, n1, m))
    if output == "summary":
        corr["mean"] = rng.normal(size=(Ns, n1, m))
        A = rng.normal(size=(Ns, n1, m, m))
        corr["Vt"] = A @ np.swapaxes(A, -1, -2)
    approx_ll = rng.normal(size=(C, Sn))
    method = "bsf" if is_type == 3 else "psi"
    key = jax.random.PRNGKey(4)
    want = jmcmc._is_finish(
        {k: jnp.asarray(v.reshape(Ns, -1) if v.ndim > 1 else v)
         for k, v in corr.items()}, jnp.asarray(hmask),
        jnp.asarray(approx_ll), key, is_type=is_type,
        sampling_method=method, want_states=output == "full",
        want_moments=output == "summary", n1m=(n1, m))
    gumbel = jax.random.gumbel(jax.random.fold_in(key, 17), (C * Sn,), F64)
    got = tmcmc._is_finish({k: torch.as_tensor(v) for k, v in corr.items()},
                           torch.as_tensor(hmask), (C, Sn),
                           torch.as_tensor(approx_ll), method, is_type,
                           gumbel=torch.as_tensor(np.array(gumbel)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-12, err_msg=k)


@pytest.fixture(scope="module")
def stored():
    """A stored approximate run on both sides: 4 x 60 slots of thetas
    around the initial value with jump-chain flags, the converged modes and
    the approximate log-likelihoods (the batched Laplace solve)."""
    jm, tm = _models(n=24, seed=11)
    rng = np.random.default_rng(12)
    C, Sn = 4, 60
    th = np.asarray(tm.theta_init) + 0.2 * rng.normal(size=(C, Sn, 2))
    acc = rng.random((C, Sn)) < 0.3
    al = tapprox.approx_loglik(tm.build(torch.as_tensor(th.reshape(-1, 2))))
    prior = tm.log_prior(torch.as_tensor(th)).numpy()
    fields = dict(theta=np.exp(th), posterior=prior, accepted=acc,
                  acceptance_rate=float(acc.mean()), S=np.zeros((C, 2, 2)),
                  theta_names=tm.theta_names, mcmc_type="approx",
                  output_type="theta", iter=2 * Sn, burnin=Sn, thin=1,
                  modes=al.approx.mode.numpy().reshape(C, Sn, -1),
                  approx_loglik=al.loglik.numpy().reshape(C, Sn),
                  prior=prior, theta_sampled=th)
    tout = tmcmc.McmcOutput(**fields, local_approx=True)
    return jm, tm, jmcmc.McmcOutput(**fields), tout


def _segment_ess(out, is_type):
    """Effective number of independent trajectories: segments share one
    (is1 and is2), is3 slots do not."""
    w = out.weights.reshape(-1)
    hm = out.accepted.copy()
    hm[:, 0] = True
    W = w if is_type == 3 else np.bincount(np.cumsum(hm.reshape(-1)) - 1,
                                           weights=w)
    return W.sum() ** 2 / (W ** 2).sum()


@pytest.mark.parametrize("is_type", [1, 2, 3])
def test_state_outputs_match_within_monte_carlo_error(stored, is_type):
    """Both packages correct the same stored draws with 10 particles.  The
    weighted means of theta agree to 2% of their spread; the summary's
    alphahat and the weighted mean of the full output's trajectories agree
    within 4 combined Monte-Carlo standard errors sqrt(2 Vt / ESS), ESS the
    effective number of independent trajectories; the summaries' state
    variances within 50% (each is a weighted mean of per-row ensemble
    variances of 10 particles, which path degeneracy near t = 0 leaves with
    a few distinct values, over about 50 independent rows for is1/is2)."""
    jm, tm, jout, tout = stored
    N = 10
    kw = dict(particles=N, is_type=is_type, corr_batch=64)
    res = {}
    for ot in ("summary", "full"):
        res[ot] = (j_post_correct(jm, jout, key=jax.random.PRNGKey(is_type),
                                  output_type=ot, **kw),
                   bt.post_correct(tm, tout, seed=is_type, output_type=ot,
                                   **kw))
    th = tout.theta.reshape(-1, 2)
    spread = th.std(0)
    js, ts = res["summary"]
    V = np.diagonal(js.Vt, axis1=-2, axis2=-1)
    for j, t in res.values():
        assert t.mcmc_type == f"is{is_type}" and np.isfinite(t.weights).all()
        wj, wt = j.weights.reshape(-1), t.weights.reshape(-1)
        mj = (wj[:, None] * th).sum(0) / wj.sum()
        mt = (wt[:, None] * th).sum(0) / wt.sum()
        assert (np.abs(mj - mt) < 0.02 * spread).all(), (mj, mt)
        ess = min(_segment_ess(j, is_type), _segment_ess(t, is_type))
        se = np.sqrt(2.0 * V / ess)
        if t.output_type == "summary":
            a_j, a_t = j.alphahat, t.alphahat
        else:
            assert t.alpha.shape == j.alpha.shape
            a_j = np.einsum('s,stm->tm', wj, j.alpha.reshape(
                (-1,) + j.alpha.shape[2:])) / wj.sum()
            a_t = np.einsum('s,stm->tm', wt, t.alpha.reshape(
                (-1,) + t.alpha.shape[2:])) / wt.sum()
        z = np.abs(a_j - a_t) / se
        assert z.max() < 4.0, (t.output_type, z.max())
    Vt_t = np.diagonal(ts.Vt, axis1=-2, axis2=-1)
    np.testing.assert_allclose(Vt_t, V, rtol=0.5)


def _small(seed=13):
    _, tm = _models(n=20, seed=seed)
    return tm


def test_post_correct_replays_run_mcmc_exactly():
    """An approx run and an is2 run with one seed share their theta chain;
    post_correct of the first with the run's correction generator gives the
    second's weights, trajectories and posterior exactly.  The approx run's
    full output holds one state draw per stored theta."""
    tm = _small()
    kw = dict(iter=60, particles=8, seed=7, n_chains=2, device="cpu",
              output_type="full")
    out_is = bt.run_mcmc(tm, mcmc_type="is2", **kw)
    out_ap = bt.run_mcmc(tm, mcmc_type="approx", **kw)
    np.testing.assert_array_equal(out_ap.theta, out_is.theta)
    assert out_ap.alpha.shape == (2, 30, 21, 2)
    assert np.isfinite(out_ap.alpha).all() and out_ap.weights is None
    pc = bt.post_correct(tm, out_ap, 8, is_type=2, output_type="full",
                         generator=bt.is_correction_generator(7, "cpu"))
    np.testing.assert_array_equal(pc.weights, out_is.weights)
    np.testing.assert_array_equal(pc.alpha, out_is.alpha)
    np.testing.assert_allclose(pc.posterior, out_is.posterior, rtol=0,
                               atol=1e-12)
    assert pc.n_corrected == out_is.n_corrected


def test_is1_summary_runs_and_replays_without_modes():
    """run_mcmc(is1, summary) without stored modes: every slot corrected,
    the weight constant within a jump-chain segment, moments of the right
    shape; post_correct recomputes the approximation cold and replays it.
    A run that did not use the local approximation and kept no modes is
    refused."""
    tm = _small(14)
    kw = dict(iter=60, particles=6, seed=5, n_chains=2, device="cpu",
              store_modes=False)
    out = bt.run_mcmc(tm, mcmc_type="is1", output_type="summary", **kw)
    assert out.modes is None and out.n_corrected == 60
    assert out.alphahat.shape == (21, 2) and out.Vt.shape == (21, 2, 2)
    assert (np.diagonal(out.Vt, axis1=-2, axis2=-1)[1:] > 0).all()
    lw = (out.posterior - out.prior - out.approx_loglik).reshape(-1)
    hm = out.accepted.copy()
    hm[:, 0] = True
    seg = np.cumsum(hm.reshape(-1)) - 1
    for s in np.unique(seg):
        np.testing.assert_allclose(lw[seg == s], lw[seg == s][0], rtol=0,
                                   atol=1e-10)
    ap = bt.run_mcmc(tm, mcmc_type="approx", **kw)
    pc = bt.post_correct(tm, ap, 6, is_type=1, output_type="summary",
                         generator=bt.is_correction_generator(5, "cpu"))
    np.testing.assert_array_equal(pc.weights, out.weights)
    np.testing.assert_array_equal(pc.alphahat, out.alphahat)
    ap.local_approx = False
    with pytest.raises(ValueError, match="local approximation"):
        bt.post_correct(tm, ap, 6)


def test_is3_full_with_the_bootstrap_filter():
    tm = _small(15)
    out = bt.run_mcmc(tm, iter=40, particles=16, mcmc_type="is3",
                      sampling_method="bsf", output_type="full", n_chains=2,
                      seed=2, device="cpu")
    assert out.alpha.shape == (2, 20, 21, 2) and out.n_corrected == 40
    assert np.isfinite(out.alpha).all() and np.isfinite(out.weights).all()


def test_suggest_N_is_one_batched_correction_per_candidate():
    """suggest_N's sd is the spread of ``replications`` corrections at the
    single-model mode, drawn from a generator seeded with seed + N; it
    stops at the first candidate below 1."""
    tm = _small(16)
    res = bt.suggest_N(tm, candidates=(2, 8), replications=30, seed=3)
    mode = tapprox.approximate(tm.build(torch.as_tensor(
        tm.theta_init))).mode
    th = torch.as_tensor(tm.theta_init).expand(30, -1)
    for N, sd in res["all"].items():
        lw = _make_correct_rows(tm, N, "psi")(
            th, mode.expand(30, -1), torch.Generator().manual_seed(3 + N))
        assert sd == pytest.approx(float(lw["log_w"].std(unbiased=False)),
                                   rel=1e-9)
    below = [N for N, sd in res["all"].items() if sd < 1.0]
    assert res["N"] == (below[0] if below else 8)
    assert len(below) <= 1                 # it stopped at the first
