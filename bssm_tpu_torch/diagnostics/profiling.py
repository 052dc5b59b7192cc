"""Structured timing and profiler traces.

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
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

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
