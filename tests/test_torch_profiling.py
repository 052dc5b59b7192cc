"""PyTorch port vs the JAX package: ``diagnostics/profiling.py``.

``PhaseTimer`` accumulates named phases and reports the same keys as the
JAX package's for the same phase names; ``profile_trace(None)`` does
nothing and ``profile_trace(dir)`` writes a Chrome trace of the block
(host operators here on the CPU; on the card also its CUDA kernels, which
``chip_smoke.py`` checks).
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import json
import os
import time

import numpy as np
import pytest
import torch

from bssm_tpu.diagnostics import profiling as jprof

from bssm_tpu_torch.diagnostics import profiling as tprof


def _phases(timer, sync):
    with timer("build") as ph:
        time.sleep(0.01)
        ph.sync(sync)
    with timer("mcmc", sync=sync):
        time.sleep(0.02)
    with timer("build"):
        time.sleep(0.01)


@pytest.mark.parametrize("samples", [None, 1000])
def test_phase_timer_matches_jax_keys_and_accumulates(samples):
    t = tprof.PhaseTimer()
    _phases(t, (torch.ones(3), {"x": torch.zeros(2)}))
    j = jprof.PhaseTimer()
    _phases(j, np.ones(3))
    got, ref = t.report(samples=samples), j.report(samples=samples)
    assert list(got) == list(ref)
    assert got["build"] >= 0.02 and got["mcmc"] >= 0.02
    assert got["total"] == pytest.approx(got["build"] + got["mcmc"])
    assert t.total == got["total"]
    if samples is not None:
        assert got["samples_per_s"] == pytest.approx(samples / got["total"])


def test_phase_timer_records_a_phase_that_raises():
    t = tprof.PhaseTimer()
    with pytest.raises(RuntimeError):
        with t("failing"):
            raise RuntimeError("inside the block")
    assert "failing" in t.phases


def test_profile_trace_none_is_a_no_op(tmp_path):
    before = set(os.listdir(tmp_path))
    with tprof.profile_trace(None):
        x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0
    assert set(os.listdir(tmp_path)) == before


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tprof.profile_trace(str(logdir)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
