"""One rank of the two-rank ``torch.distributed`` (gloo) CPU test of the
port's mesh.

    python tests/torch_distributed_worker.py PORT RANK OUT_DIR

Each rank starts the process group through
``bssm_tpu_torch.parallel.distributed.initialize``, builds meshes of shape
(2, 1) and (1, 2) over the two ranks, runs ``run_mcmc`` / ``post_correct``
with ``mesh=`` and holds the whole output it gets back against its own
``mesh=None`` run of the same arguments, under the JAX package's sharding
tolerances (``tests/test_parallel.py``).  The cases cover the chains split
(gaussian summary, is2 psi summary, pm with the bootstrap filter's Philox
tier at 40 particles, da with psi's at 40, the EKF chain with summary
output), the correction split (is2 at (1, 2), is3 with bsf and summary
output, ``post_correct`` with psi at 40 particles, SDE is1 and nlg is2
with full output) and the state draws split (gaussian full output).  Rank
0 then writes the weighted theta means and their Monte-Carlo SEs of a
16-chain is2 run at (2, 1) to ``OUT_DIR/means.npz`` for the comparison
with the JAX package's sharded run.  Prints ``OK rank R`` and exits 0 on
success.

Run by ``tests/test_torch_parallel.py::test_two_ranks_gloo``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_threads  # noqa: E402,F401  (one intra-op thread)
import numpy as np  # noqa: E402
import torch  # noqa: E402

F64 = torch.float64


def is2_series(n: int = 20) -> np.ndarray:
    """The series of the JAX package's ``test_sharded_is2_equals_unsharded``
    recipe (its ``rng`` fixture is seeded 42)."""
    rng = np.random.default_rng(42)
    return rng.poisson(np.exp(np.cumsum(rng.normal(0, 0.2, n)))).astype(
        float)


def is2_model(bt):
    return bt.ar1_ng(is2_series(), rho=bt.uniform_prior(0.6, -0.99, 0.99),
                     sigma=bt.halfnormal_prior(0.4, 1.0),
                     distribution="poisson", dtype=F64, device="cpu")


IS2_RUN = dict(particles=4, mcmc_type="is2", seed=5, output_type="summary",
               corr_batch=64)
# the run held against the JAX package's at mesh (4, 2)
JAX_RUN = dict(IS2_RUN, iter=400, n_chains=16)


def lg_model(bt):
    rng = np.random.default_rng(3)
    y = np.cumsum(rng.normal(0, 0.3, 40)) + rng.normal(0, 1.0, 40)
    return bt.bsm_lg(y, sd_y=bt.halfnormal_prior(1.0, 5.0),
                     sd_level=bt.halfnormal_prior(0.3, 5.0), dtype=F64,
                     device="cpu")


def calm_model(bt):
    rng = np.random.default_rng(4)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .05, 20)) + 1.0))
    return bt.bsm_ng(y.astype(float), sd_level=bt.halfnormal_prior(0.1, 1),
                     distribution="poisson", dtype=F64, device="cpu")


def sde_model(bt):
    rng = np.random.default_rng(5)
    x, y = 1.0, np.zeros(15)
    for t in range(15):
        x *= np.exp(0.03 + 0.2 * rng.normal())
        y[t] = np.log(x) + rng.normal()
    return bt.sde_gbm(y, L_f=4, L_c=2, dtype=F64, device="cpu")


def same(tag: str, got, want) -> None:
    """A sharded output against the unsharded one: per-row fields and
    sums at the JAX package's tolerances."""
    def close(name, rtol, atol=0.0):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), f"{tag}: {name}"
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"{tag}: {name}")

    close("theta", 1e-12)
    assert np.array_equal(got.accepted, want.accepted), f"{tag}: accepted"
    close("posterior", 1e-9, 1e-9)
    close("weights", 1e-9, 1e-9)
    close("S", 1e-12)
    close("alpha", 1e-9, 1e-9)
    close("alphahat", 1e-8, 1e-8)
    close("Vt", 1e-7, 1e-9)
    assert got.acceptance_rate == want.acceptance_rate, tag
    assert got.n_corrected == want.n_corrected, tag


def main():
    port, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    import bssm_tpu_torch as bt
    from bssm_tpu_torch.parallel.distributed import (global_mesh, initialize,
                                                     local_chain_slice)
    assert initialize(coordinator_address=f"127.0.0.1:{port}",
                      num_processes=2, process_id=rank) is True
    assert torch.distributed.get_backend() == "gloo"
    assert local_chain_slice(8) == slice(4 * rank, 4 * rank + 4)
    assert local_chain_slice(7) == slice(4 * rank, min(4 * rank + 4, 7))
    meshes = {s: global_mesh(shape=s, device="cpu") for s in ((2, 1), (1, 2))}
    assert dict(zip(meshes[(1, 2)].mesh_dim_names,
                    meshes[(1, 2)].shape)) == {"chains": 1, "draws": 2}

    def both(tag, model, shape, **kw):
        ref = bt.run_mcmc(model, device="cpu", **kw)
        same(tag, bt.run_mcmc(model, device="cpu", mesh=meshes[shape], **kw),
             ref)
        return ref

    lg = lg_model(bt)
    both("gaussian summary (2, 1)", lg, (2, 1), iter=100, n_chains=4,
         output_type="summary", seed=2)
    both("gaussian full (1, 2)", lg, (1, 2), iter=100, n_chains=4,
         output_type="full", seed=2, corr_batch=96)

    m = is2_model(bt)
    ref = bt.run_mcmc(m, iter=100, n_chains=4, device="cpu", **IS2_RUN)
    for shape in ((2, 1), (1, 2)):
        same(f"is2 psi summary {shape}", bt.run_mcmc(
            m, iter=100, n_chains=4, device="cpu", mesh=meshes[shape],
            **IS2_RUN), ref)

    calm = calm_model(bt)
    both("pm bsf 40 (2, 1)", calm, (2, 1), iter=60, n_chains=4,
         particles=40, mcmc_type="pm", sampling_method="bsf", seed=3)
    both("da psi 40 (2, 1)", calm, (2, 1), iter=30, n_chains=4,
         particles=40, mcmc_type="da", seed=3)
    both("is3 bsf summary (1, 2)", calm, (1, 2), iter=30, n_chains=4,
         particles=8, mcmc_type="is3", sampling_method="bsf",
         output_type="summary", seed=3, corr_batch=16)
    ap = bt.run_mcmc(calm, iter=60, n_chains=4, mcmc_type="approx", seed=3,
                     device="cpu")
    kw = dict(sampling_method="psi", output_type="summary", corr_batch=16)
    same("post_correct psi 40 (1, 2)",
         bt.post_correct(calm, ap, 40, mesh=meshes[(1, 2)], **kw),
         bt.post_correct(calm, ap, 40, **kw))

    both("sde is1 full (1, 2)", sde_model(bt), (1, 2), iter=40, n_chains=4,
         particles=8, mcmc_type="is1", output_type="full", seed=3,
         corr_batch=32)
    ex = bt.example_models
    growth = ex.nlg_growth(ex.simulate_growth(n=15), dtype=F64, device="cpu")
    both("nlg ekf summary (2, 1)", growth, (2, 1), iter=20, n_chains=4,
         mcmc_type="ekf", output_type="summary", seed=3)
    both("nlg is2 psi full (1, 2)", growth, (1, 2), iter=10, n_chains=4,
         particles=8, sampling_method="psi", output_type="full", seed=3,
         corr_batch=8)

    out = bt.run_mcmc(m, device="cpu", mesh=meshes[(2, 1)], **JAX_RUN)
    if rank == 0:
        rows = bt.summary(out, return_se=True)
        np.savez(os.path.join(out_dir, "means.npz"),
                 mean=[r["Mean"] for r in rows], se=[r["SE"] for r in rows])
    torch.distributed.destroy_process_group()
    print(f"OK rank {rank}", flush=True)


if __name__ == "__main__":
    main()
