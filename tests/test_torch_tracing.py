"""The port's spans and counters (``diagnostics/profiling.py``) on a tiny
Poisson local linear trend is2/psi fit on the CPU: the span tree of a fit
and of a ``post_correct``, the counters against what the fit did, no
record and no allocation with spans off, and the spans on the clock of the
profiler's Chrome trace.  On the card ``chip_smoke.py``'s ``k1_passes``
check holds the kernel's own pass count against ``niter``."""
import torch_threads  # noqa: F401  (one torch thread; first)
import json
import math
import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch

import bssm_tpu_torch as bt
from bssm_tpu_torch.diagnostics import profiling
from bssm_tpu_torch.inference import approx as approx_mod

ITER, CHAINS, BATCH, N = 12, 8, 5, 4
RUN = dict(iter=ITER, particles=N, mcmc_type="is2", n_chains=CHAINS,
           corr_batch=BATCH, store_modes=False, seed=2 ** 31 + 5,
           device="cpu")

# where each span of an is2 fit may sit: the initial evaluation of the
# chains is in bssm.chain itself, the correction's cold solves in its chunks
FIT_PARENTS = {
    "bssm.fit": {None},
    "bssm.fit.setup": {"bssm.fit"},
    "bssm.chain": {"bssm.fit"},
    "bssm.chain.iter": {"bssm.chain"},
    "bssm.chain.propose": {"bssm.chain.iter"},
    "bssm.model.build": {"bssm.chain", "bssm.chain.iter",
                         "bssm.correct.chunk"},
    "bssm.laplace": {"bssm.chain", "bssm.chain.iter", "bssm.correct.chunk"},
    "bssm.chain.accept": {"bssm.chain.iter"},
    "bssm.chain.store": {"bssm.chain.iter"},
    "bssm.fit.host_copy": {"bssm.fit"},
    "bssm.correct": {"bssm.fit"},
    "bssm.correct.chunk": {"bssm.correct"},
    "bssm.psi.factors": {"bssm.correct.chunk"},
    "bssm.psi.filter": {"bssm.correct.chunk"},
    "bssm.correct.finish": {"bssm.correct"},
}
POST_PARENTS = {
    "bssm.post_correct": {None},
    "bssm.post_correct.to_device": {"bssm.post_correct"},
    "bssm.correct": {"bssm.post_correct"},
    "bssm.correct.chunk": {"bssm.correct"},
    "bssm.model.build": {"bssm.correct.chunk"},
    "bssm.laplace.rebuild": {"bssm.correct.chunk"},
    "bssm.psi.factors": {"bssm.correct.chunk"},
    "bssm.psi.filter": {"bssm.correct.chunk"},
    "bssm.correct.finish": {"bssm.correct"},
}


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(11)
    slope = np.cumsum(rng.normal(0, 0.01, 20))
    y = rng.poisson(np.exp(1.0 + np.cumsum(slope + rng.normal(0, 0.1, 20))))
    return bt.bsm_ng(y.astype(float), sd_level=bt.halfnormal_prior(0.1, 1),
                     sd_slope=bt.halfnormal_prior(0.01, 0.1),
                     distribution="poisson", dtype=torch.float64,
                     device="cpu")


@pytest.fixture(scope="module")
def traced(model):
    """A traced fit, its output, and the passes and rows of every Laplace
    solve it made, read from the plain route's own ``niter``."""
    seen = []
    orig = approx_mod._solve

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append((int(out[2].sum()), int(out[2].shape[0])))
        return out

    approx_mod._solve = spy
    try:
        with profiling.tracing():
            out = bt.run_mcmc(model, **RUN)
    finally:
        approx_mod._solve = orig
    return out, profiling.records()[-1], seen


def _tree(rec, parents):
    by_id = {s.id: s for s in rec.spans}
    names = Counter(s.name for s in rec.spans)
    assert set(names) == set(parents), set(names) ^ set(parents)
    assert set(names) <= set(profiling.SPANS)
    for s in rec.spans:
        assert s.fit == rec.fit
        up = by_id[s.parent] if s.parent in by_id else None
        assert (up.name if up else None) in parents[s.name], s
        assert s.start_ns <= s.end_ns
        if up is not None:                  # a child inside its parent
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    return names


def test_fit_span_tree(traced):
    out, rec, _ = traced
    assert rec.entry == "run_mcmc" and rec.seed == RUN["seed"]
    names = _tree(rec, FIT_PARENTS)
    heads = out.n_corrected
    chunks = math.ceil(heads / BATCH)
    assert names["bssm.fit"] == names["bssm.correct"] == 1
    assert names["bssm.chain.iter"] == ITER
    assert names["bssm.chain.store"] == ITER - ITER // 2
    assert names["bssm.correct.chunk"] == chunks
    assert names["bssm.laplace"] == ITER + 1 + chunks
    assert names["bssm.psi.filter"] == names["bssm.psi.factors"] == chunks
    iters = [s.attrs["i"] for s in rec.spans if s.name == "bssm.chain.iter"]
    assert iters == list(range(1, ITER + 1))
    assert sum(s.attrs["rows"] for s in rec.spans
               if s.name == "bssm.correct.chunk") == heads


def test_fit_counters(traced):
    out, rec, seen = traced
    c = rec.counters
    heads = out.n_corrected
    assert c["laplace.rows"] == (ITER + 1) * CHAINS + heads \
        == sum(r for _, r in seen)
    assert len(seen) == ITER + 1 + math.ceil(heads / BATCH)
    assert c["laplace.passes"] == sum(p for p, _ in seen) > 0
    assert c["correct.heads"] == heads
    assert c["correct.chunks"] == math.ceil(heads / BATCH)
    # the kernels' counters join the registry; on the CPU none counts
    assert profiling.COUNTERS["launches"] is bt.ops.cuda_kalman.LAUNCHES
    assert c["launches.laplace_solve"] == c["plain_routes.psi_logw"] == 0


def test_off_means_no_record_and_no_allocation(model, traced):
    out, _, _ = traced
    before = profiling.records()
    host = profiling.HOST["laplace.rows"]
    plain = bt.run_mcmc(model, **RUN)
    assert profiling.records() == before
    # the host counters count whatever spans say
    assert profiling.HOST["laplace.rows"] - host == \
        (ITER + 1) * CHAINS + plain.n_corrected
    np.testing.assert_array_equal(plain.theta, out.theta)
    np.testing.assert_array_equal(plain.posterior, out.posterior)
    assert profiling.span("bssm.fit") is profiling.span("bssm.chain.iter",
                                                          i=3)
    assert profiling.fit("run_mcmc", 1, "bssm.fit") is profiling.span("x")
    assert profiling.passes_counter(torch.device("cpu")) is None
    span = profiling.span
    span("bssm.chain.iter", i=700)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()
        span("bssm.chain.iter", i=700)
        span("bssm.correct.chunk", rows=700)
        span("bssm.laplace")
        assert tracemalloc.get_traced_memory() == base
    finally:
        tracemalloc.stop()


def test_a_fit_that_raises_leaves_no_record(model):
    before = profiling.records()
    with profiling.tracing(), pytest.raises(ValueError):
        bt.run_mcmc(model, **dict(RUN, psi_resample_every=0))
    assert profiling.records() == before
    assert profiling._ST.stack == [] and profiling._ST.fit is None


def test_only_the_last_records_are_kept():
    with profiling.tracing():
        for k in range(profiling.RECORDS_KEPT + 3):
            with profiling.fit("run_mcmc", k, "bssm.fit"):
                with profiling.span("bssm.chain"):
                    pass
    recs = profiling.records()
    assert [r.seed for r in recs] == list(range(
        3, profiling.RECORDS_KEPT + 3))
    assert all([s.name for s in r.spans] == ["bssm.chain", "bssm.fit"]
               for r in recs)


def test_spans_are_ranges_on_the_profiler_clock(model, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.run_mcmc(model, **dict(RUN, seed=7))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ranges = {}
    for e in trace["traceEvents"]:
        if str(e.get("name", "")).startswith("bssm.") and e.get("ph") == "X":
            ranges.setdefault(e["name"], []).append(float(e["ts"]) + base_us)
    rec = profiling.records()[-1]
    assert rec.seed == 7
    spans = {}
    for s in rec.spans:
        spans.setdefault(s.name, []).append(s.start_ns / 1e3)
    assert {k: len(v) for k, v in ranges.items()} == \
        {k: len(v) for k, v in spans.items()}
    for name, starts in spans.items():
        for a, b in zip(sorted(starts), sorted(ranges[name])):
            assert abs(a - b) < 1000.0, (name, a - b)


def test_post_correct_records_the_correction(model):
    ap = bt.run_mcmc(model, **dict(RUN, mcmc_type="approx",
                                   store_modes=True))
    with profiling.tracing():
        pc = bt.post_correct(model, ap, N, seed=9, corr_batch=BATCH,
                             output_type="theta")
    rec = profiling.records()[-1]
    assert rec.entry == "post_correct" and rec.seed == 9
    names = _tree(rec, POST_PARENTS)
    chunks = math.ceil(pc.n_corrected / BATCH)
    assert names["bssm.correct.chunk"] == names["bssm.laplace.rebuild"] \
        == chunks
    assert rec.counters["correct.heads"] == pc.n_corrected
    assert rec.counters["laplace.rows"] == rec.counters["laplace.passes"] \
        == 0
