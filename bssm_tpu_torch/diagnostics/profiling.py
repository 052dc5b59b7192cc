"""Structured timing, profiler traces, and the program's spans and counters.

Counterpart of ``bssm_tpu/diagnostics/profiling.py``: wall-clock time by
named phase, synchronised with the device (``McmcOutput.time`` is the same
idea inside ``run_mcmc``), and an optional ``torch.profiler`` trace around
a block for kernel-level analysis.

    with profile_trace("trace_dir"):          # a Chrome trace: open it in
        out = run_mcmc(model, ...)            # Perfetto or TensorBoard

    timer = PhaseTimer()
    with timer("mcmc") as phase:
        out = run_chains(...)
        phase.sync(out)                       # its CUDA devices finish
    timer.report(samples=chains * iters)      # before the clock stops

The program marks its own layers with ``span``: ``bssm.fit`` (one
``run_mcmc``), its chain, each chain iteration and the stages inside it,
the output's host copy and the IS correction's chunks (the names and the
tree: ``SPANS``).  Spans are on only while a ``torch.profiler`` is active
or inside ``with tracing():``.  Under the profiler each span is also a
``record_function`` range, so a Chrome trace holds the program's layers
beside its kernels.  Each span is kept in memory on the ``time.time_ns()``
clock, which is the clock of the profiler's trace (an event's ``ts`` plus
the trace's ``baseTimeNanoseconds`` / 1000, in microseconds); each
finished fit is one ``Record`` of its spans and of the change of every
counter over it (``COUNTERS``), and ``records()`` returns the last few:

    with tracing():
        out = run_mcmc(model, ...)
    rec = records()[-1]
    host_copy = [s for s in rec.spans if s.name == "bssm.fit.host_copy"]
    passes_per_row = (rec.counters["laplace.passes"]
                      / rec.counters["laplace.rows"])

A span's duration is the host's time inside it: launches return before
the device has run them, so device time falls in the span that waits for
it (a copy to the host, a synchronisation).  Spans are opened by one
thread, the one that runs the fit; never inside a block that
``inference/replay.py`` captures into a CUDA graph.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Dict, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (host operators, and the CUDA
    kernels, copies and synchronisations where a CUDA device is present)
    and write it as a Chrome trace into ``logdir``; a no-op for ``None``."""
    if logdir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _synchronize(items) -> None:
    """Wait for every CUDA device that holds a tensor of ``items`` (nested
    tuples, lists and dicts of tensors; other leaves are ignored)."""
    leaves, _ = tree_flatten(items)
    for dev in {x.device for x in leaves
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


class _PhaseHandle:
    """Collects what a timed block produces; everything registered by
    ``.sync(x)`` is waited for before the phase's clock stops."""

    def __init__(self):
        self._items = []

    def sync(self, x):
        self._items.append(x)
        return x


class PhaseTimer:
    """Accumulating named wall-clock phases, synchronised with the device."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        """Time a block.  The context yields a handle: call ``handle.sync(
        out)`` on tensors produced inside the block (or pass tensors that
        exist already as ``sync=``); their CUDA devices are synchronised
        before the clock stops, so that asynchronous launches do not hide
        device time."""
        handle = _PhaseHandle()
        if sync is not None:
            handle.sync(sync)
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            _synchronize(handle._items)
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    @property
    def total(self) -> float:
        return sum(self.phases.values())

    def report(self, samples: Optional[int] = None) -> Dict[str, float]:
        """Seconds by phase, their ``total`` and, given ``samples``, the
        ``samples_per_s`` over the total."""
        out = dict(self.phases)
        out["total"] = self.total
        if samples is not None and self.total > 0:
            out["samples_per_s"] = samples / self.total
        return out


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

#: The spans the program opens, and what each covers.  A ``run_mcmc`` of
#: the IS types nests them as ``bssm.fit`` > ``bssm.fit.setup``,
#: ``bssm.chain`` > ``bssm.chain.iter`` > (``bssm.chain.propose``,
#: ``bssm.model.build``, ``bssm.laplace``, ``bssm.chain.accept``,
#: ``bssm.chain.store``), ``bssm.fit.host_copy``, ``bssm.correct`` >
#: ``bssm.correct.chunk`` > (``bssm.model.build``, ``bssm.laplace`` or
#: ``bssm.laplace.rebuild``, ``bssm.psi.factors``, ``bssm.psi.filter``),
#: ``bssm.correct.finish``; ``post_correct`` as ``bssm.post_correct`` >
#: ``bssm.post_correct.to_device``, ``bssm.correct`` (the same subtree).
SPANS = {
    "bssm.fit": "one run_mcmc, its root",
    "bssm.fit.setup": "validation, generators, the approximation's "
                      "evaluator, the initial prior's check",
    "bssm.chain": "the whole chain, up to its synchronisation",
    "bssm.chain.iter": "one chain iteration (attribute i)",
    "bssm.chain.propose": "the proposal and its prior",
    "bssm.model.build": "the model's system at a batch of theta",
    "bssm.laplace": "a Laplace solve (inference/approx.py approximate)",
    "bssm.laplace.rebuild": "the approximation rebuilt at stored modes",
    "bssm.chain.accept": "the accept test, the RAM adaptation, the state",
    "bssm.chain.store": "after the burn-in: the acceptance count and the "
                        "stores of a kept slot",
    "bssm.fit.host_copy": "McmcOutput's host arrays of the chain",
    "bssm.correct": "the IS correction, its weights to the host",
    "bssm.correct.chunk": "one chunk of corrected rows (attribute rows)",
    "bssm.psi.factors": "the psi filter's proposal factors (K2)",
    "bssm.psi.filter": "the psi filter's log-weight (K3, K4)",
    "bssm.correct.finish": "the weights and moments of the slots",
    "bssm.post_correct": "one post_correct, its root",
    "bssm.post_correct.to_device": "the stored run's copy to the device",
}

#: The program's own counters, plain integers it adds to whether or not
#: spans are on: rows sent to a Laplace solve, rows IS-corrected, chunks
#: of the correction.
HOST = {"laplace.rows": 0, "correct.heads": 0, "correct.chunks": 0}
#: Every counter, by group: ``HOST`` under "", and the groups registered
#: with ``register`` (``ops/cuda_kalman.py``'s ``LAUNCHES``,
#: ``PLAIN_ROUTES`` and ``REPLAYED`` as "launches", "plain_routes",
#: "replayed").  A record names a group's counter "<group>.<name>".  The
#: Laplace passes, ``laplace.passes``, are counted on the device, into a
#: tensor of the fit (``passes_counter``), and read as the fit ends.
COUNTERS: Dict[str, Dict[str, int]] = {"": HOST}
#: How many finished fits ``records()`` keeps.
RECORDS_KEPT = 8


def register(group: str, counts: Dict[str, int]) -> Dict[str, int]:
    """Adds the dict ``counts`` (itself, not a copy) to ``COUNTERS`` under
    ``group``; returns it."""
    COUNTERS[group] = counts
    return counts


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]       # the enclosing span's id
    fit: int                    # the fit's id
    start_ns: int               # time.time_ns()
    end_ns: int
    attrs: dict


class Record(NamedTuple):
    """One finished fit: the entry point, its ``seed`` argument, its spans
    in the order they closed, and each counter's change over it."""
    fit: int
    entry: str
    seed: int
    spans: list
    counters: dict


class _State:
    def __init__(self):
        self.forced = 0         # depth of tracing()
        self.stack = []         # ids of the open spans, innermost last
        self.fit = None         # the open fit


_ST = _State()
_IDS = itertools.count(1)
_RECORDS: collections.deque = collections.deque(maxlen=RECORDS_KEPT)
_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Open:
    """An open span."""
    __slots__ = ("name", "attrs", "id", "parent", "range", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        st = _ST.stack
        self.parent = st[-1] if st else None
        self.id = next(_IDS)
        st.append(self.id)
        self.range = None
        # the clock is read just before the range takes its own time, on
        # both sides, so that the two agree
        self.t0 = time.time_ns()
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _ST.stack.pop()
        fit = _ST.fit
        if fit is not None:
            fit.spans.append(Span(self.name, self.id, self.parent, fit.id,
                                  self.t0, t1, self.attrs))
        return False


def span(name: str, *, i: Optional[int] = None, rows: Optional[int] = None):
    """A span of the program's layer ``name`` (``SPANS``) with the
    attributes given (an iteration ``i``, a number of ``rows``).  Off (no
    profiler active, outside ``tracing()``) it is one shared no-op context:
    no allocation, no clock read.  The attributes are named keywords, not
    ``**attrs``, for that reason: a ``**`` parameter allocates a dict at
    every call."""
    if not (_ST.forced or _profiler_enabled()):
        return _NULL
    attrs = {}
    if i is not None:
        attrs["i"] = i
    if rows is not None:
        attrs["rows"] = rows
    return _Open(name, attrs)


def _counts() -> Dict[str, int]:
    return {(f"{g}.{k}" if g else k): v for g, counts in COUNTERS.items()
            for k, v in counts.items()}


class _Fit:
    """An open fit: its spans, and its Laplace pass counters by device."""

    def __init__(self, entry: str, seed: int, root: str):
        self.entry, self.seed, self.root = entry, int(seed), root
        self.id = next(_IDS)
        self.spans = []
        self.passes = {}

    def passes_counter(self, device) -> torch.Tensor:
        c = self.passes.get(device)
        if c is None:
            c = self.passes[device] = torch.zeros(1, dtype=torch.int64,
                                                  device=device)
        return c

    def __enter__(self):
        self.before = _counts()
        _ST.fit = self
        self.root_span = _Open(self.root, {})
        self.root_span.__enter__()
        return self

    def __exit__(self, exc_type, *exc):
        try:
            self.root_span.__exit__(exc_type, *exc)
        finally:
            _ST.fit = None
        if exc_type is None:
            counters = {k: v - self.before.get(k, 0)
                        for k, v in _counts().items()}
            # the fit has synchronised with its devices already
            counters["laplace.passes"] = sum(int(c.item())
                                             for c in self.passes.values())
            _RECORDS.append(Record(self.id, self.entry, self.seed,
                                   self.spans, counters))
        return False


def fit(entry: str, seed: int, root: str):
    """The context of one call of the entry point ``entry`` with ``seed``:
    while spans are on, a span ``root`` and, if the call returns, one
    record (``records()``).  A fit inside an open fit adds its spans to
    that one.  Off, the shared no-op context."""
    if _ST.fit is not None or not (_ST.forced or _profiler_enabled()):
        return _NULL
    return _Fit(entry, seed, root)


def passes_counter(device) -> Optional[torch.Tensor]:
    """The open fit's Laplace pass counter on ``device``, an int64 tensor of
    one value that the ``laplace_solve`` kernel adds each row's passes to;
    None outside a fit (spans off)."""
    f = _ST.fit
    return None if f is None else f.passes_counter(device)


def count_passes(niter: torch.Tensor) -> None:
    """Adds the passes ``niter (B,)`` of a Laplace solve outside the kernel
    (the plain, single-model and time-parallel loops) to the open fit's
    counter; nothing outside a fit."""
    f = _ST.fit
    if f is not None:
        f.passes_counter(niter.device).add_(niter.sum())


@contextlib.contextmanager
def tracing():
    """Spans and records on inside the block, without a profiler."""
    _ST.forced += 1
    try:
        yield
    finally:
        _ST.forced -= 1


def records() -> list:
    """The last ``RECORDS_KEPT`` finished fits' ``Record``s, oldest first."""
    return list(_RECORDS)
