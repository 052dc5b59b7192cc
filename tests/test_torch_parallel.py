"""The port's ``parallel/`` (``bssm_tpu_torch/parallel``) against the JAX
package's: the helpers on the same inputs, ``run_mcmc(mesh=...)`` in a
world of one equal to ``mesh=None`` at the JAX package's sharding
tolerances (``tests/test_parallel.py``), two gloo ranks in subprocesses
(``tests/torch_distributed_worker.py``) equal to their unsharded runs, and
their 16-chain is2 run within Monte-Carlo error of the JAX package's on a
(4, 2) mesh of its 8 virtual devices."""
import torch_threads  # noqa: F401  (one intra-op thread; first)

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import bssm_tpu_torch as bt
from bssm_tpu_torch.core import rows
from bssm_tpu_torch.ops import cuda_kalman as ck
from bssm_tpu_torch.parallel import distributed as tdist
from bssm_tpu_torch.parallel import mesh as tmesh
from bssm_tpu.parallel import distributed as jdist
from bssm_tpu.parallel import mesh as jmesh

import torch_distributed_worker as worker

F64 = torch.float64


@pytest.fixture(scope="module")
def mesh():
    """A world of one (gloo, a local store); the process group is taken
    down after the module."""
    started = not dist.is_initialized()
    yield bt.make_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the helpers against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mult,axis", [((5, 3), 4, 0), ((5, 3), 5, 0),
                                             ((2, 7, 3), 3, 1), ((1,), 8, 0)])
def test_pad_to_multiple_matches_jax(shape, mult, axis):
    x = np.random.default_rng(1).normal(size=shape)
    want, n_j = jmesh.pad_to_multiple(jax.numpy.asarray(x), mult, axis)
    got, n_t = tmesh.pad_to_multiple(torch.as_tensor(x), mult, axis)
    assert n_t == n_j == shape[axis]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_np, _ = tmesh.pad_to_multiple(x, mult, axis)
    np.testing.assert_array_equal(got_np, np.asarray(want))


def test_single_process_helpers_match_jax(mesh):
    """initialize() has nothing to do in one process and refuses a
    coordinator without a process count on both sides; local_chain_slice
    owns the whole axis; a world of one's mesh has the JAX package's axes
    and shape at one device; the sharding helpers own every row."""
    assert jdist.initialize() is False
    assert tdist.initialize() is False
    for init in (jdist.initialize, tdist.initialize):
        with pytest.raises(ValueError):
            init(coordinator_address="10.0.0.1:1234")
    assert tdist.local_chain_slice(100) == jdist.local_chain_slice(100) \
        == slice(0, 100)
    jm = jmesh.make_mesh(1)
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == dict(jm.shape) \
        == {"chains": 1, "draws": 1}
    for split in (tmesh.chains_sharding(mesh), tmesh.flat_sharding(mesh),
                  tmesh.replicated(mesh)):
        assert split.slice(37) == slice(0, 37)
    g = tdist.global_mesh(("chains",), device="cpu")
    assert g.mesh_dim_names == ("chains",) and tuple(g.shape) == (1,)
    with pytest.raises(ValueError):
        bt.make_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        bt.make_mesh(shape=(2, 1), device="cpu")


@pytest.mark.parametrize("parts,n", [(4, 10), (3, 9), (4, 3), (8, 8)])
def test_row_split_is_local_chain_slices_rule(parts, n):
    """RowSplit's ceil-divided blocks: the JAX package's
    local_chain_slice rule, covering the axis in order."""
    blocks = [tmesh.RowSplit(parts, i).slice(n) for i in range(parts)]
    per = -(-n // parts)
    assert blocks[0] == slice(0, min(per, n))
    assert sum(b.stop - b.start for b in blocks) == n
    assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))


@pytest.mark.parametrize("row0,B", [(0, 5), (3, 4), (9, 1)])
def test_philox_fill_row0_is_a_window_of_the_whole_fill(row0, B):
    """The Philox counters count rows from row0: rows row0.. of a fill of
    the whole batch."""
    key = torch.tensor([12345, 678], dtype=torch.int64)
    eps, us = ck.philox_fill_plain(key, 10, 6, 5, 3, F64)
    e2, u2 = ck.philox_fill(key, B, 6, 5, 3, F64, row0=row0)
    assert torch.equal(e2, eps[row0:row0 + B])
    assert torch.equal(u2, us[row0:row0 + B])


def test_row_window_draws_the_whole_batch():
    """Inside a window a draw is the whole batch's draw, the window's rows
    kept; outside it is the plain draw; the window nests and restores."""
    g = torch.Generator().manual_seed(3)
    full = torch.randn((7, 3), generator=g, dtype=F64)
    g.manual_seed(3)
    with rows.window(2, 7):
        assert rows.offset() == 2
        part = rows.randn((4, 3), generator=g, dtype=F64)
    assert rows.offset() == 0
    assert torch.equal(part, full[2:6])
    g.manual_seed(3)
    full = torch.rand((2, 6), generator=g, dtype=F64)
    g.manual_seed(3)
    with rows.window(1, 6):
        assert torch.equal(rows.rand((2, 3), axis=1, generator=g,
                                     dtype=F64), full[:, 1:4])
        with pytest.raises(ValueError):
            rows.rand((6,), generator=g)


# ---------------------------------------------------------------------------
# a world of one: mesh= equal to mesh=None
# ---------------------------------------------------------------------------

def _close(got, want):
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-12)
    assert np.array_equal(got.accepted, want.accepted)
    np.testing.assert_allclose(got.posterior, want.posterior, rtol=1e-9,
                               atol=1e-9)
    for name, rtol, atol in (("alphahat", 1e-8, 1e-8), ("Vt", 1e-7, 1e-9),
                             ("weights", 1e-9, 1e-9)):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_world_of_one_gaussian(mesh):
    model = worker.lg_model(bt)
    kw = dict(iter=200, seed=1, output_type="theta", n_chains=4,
              device="cpu")
    _close(bt.run_mcmc(model, mesh=mesh, **kw), bt.run_mcmc(model, **kw))


def test_world_of_one_is2_summary(mesh):
    """The JAX package's test_sharded_is2_equals_unsharded run (n = 20, 4
    chains, 200 iterations, 4 particles, corr_batch 64)."""
    model = worker.is2_model(bt)
    kw = dict(iter=200, n_chains=4, device="cpu", **worker.IS2_RUN)
    _close(bt.run_mcmc(model, mesh=mesh, **kw), bt.run_mcmc(model, **kw))


def test_mesh_run_takes_its_devices_type_only(mesh):
    model = worker.lg_model(bt)
    m2 = bt.make_mesh(device="cpu")
    assert m2.device_type == "cpu"
    with pytest.raises(ValueError):
        tmesh.MeshRun(m2, torch.device("meta"))
    out = bt.run_mcmc(model, iter=4, n_chains=1, device="cpu", mesh=m2)
    assert out.theta.shape[0] == 1


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def test_two_ranks_gloo(tmp_path):
    """Two ranks in subprocesses (gloo, a coordinator on a free local
    port) hold their gathered outputs against their own unsharded runs; the
    JAX package's run on a (4, 2) mesh of 8 virtual devices is made here
    meanwhile, and rank 0's 16-chain is2 weighted means lie within 5
    combined Monte-Carlo SEs of it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = os.path.join(os.path.dirname(__file__),
                          "torch_distributed_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, script, str(port), str(r),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    try:
        from bssm_tpu.core.priors import halfnormal_prior, uniform_prior
        from bssm_tpu.diagnostics.summary import summary as jsummary
        from bssm_tpu.inference.mcmc import run_mcmc as jrun
        from bssm_tpu.models.ar1 import ar1_ng as jar1
        jm = jar1(worker.is2_series(), rho=uniform_prior(0.6, -0.99, 0.99),
                  sigma=halfnormal_prior(0.4, 1.0), distribution="poisson")
        jout = jrun(jm, mesh=jmesh.make_mesh(8, shape=(4, 2)),
                    **worker.JAX_RUN)
        jrows = jsummary(jout, return_se=True)
        outs = [p.communicate(timeout=420)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"OK rank {r}" in out
    got = np.load(tmp_path / "means.npz")
    for j, row in enumerate(jrows):
        se = np.hypot(got["se"][j], row["SE"])
        assert abs(got["mean"][j] - row["Mean"]) <= 5 * se, \
            (row["variable"], got["mean"][j], row["Mean"], se)
