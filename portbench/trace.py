"""The traced job: ``torch.profiler`` over one whole job, and its reduction
to what the per-layer readers take.

The job runs inside a ``record_function`` span named ``portbench.job``;
the traced window is that span.  From the Chrome trace the profiler writes
(to a temporary directory under ``TMPDIR``, removed after reading) come:

- every device operation (kernels, copies, fills) in the window: its
  count, its seconds by name, and the union of their intervals, the
  device's busy seconds;
- the idle gaps between those intervals, each put down to the innermost
  host operation of the job's thread that spans the gap's midpoint
  ("python" where none does).
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from collections import defaultdict
from typing import NamedTuple

SPAN = "portbench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    n_device_ops: int
    device_s_by_name: dict      # name -> seconds
    count_by_name: dict         # name -> launches
    idle_by_host_op: dict       # host op -> idle seconds

    def device_s(self, fragment: str) -> float:
        """Seconds of the device operations whose name holds
        ``fragment``."""
        return sum(s for k, s in self.device_s_by_name.items()
                   if fragment in k)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k[:120], v] for k, v in ops[:top]],
                "idle_gaps": [[k[:120], v] for k, v in gaps[:top]]}


class Traced:
    """``with Traced(torch) as tr: job()``, then ``tr.summary()`` once the
    window has closed."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.span = None

    def __enter__(self):
        self.prof.__enter__()
        self.span = self.torch.profiler.record_function(SPAN)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> TraceSummary:
        tmp = tempfile.mkdtemp(prefix="portbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_events(events)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events: list) -> TraceSummary:
    """The summary of a Chrome trace's events (times in microseconds)."""
    span = [e for e in events if e.get("name") == SPAN
            and e.get("ph") == "X" and "dur" in e]
    span = [e for e in span if e.get("cat") != "gpu_user_annotation"]
    if not span:
        raise RuntimeError(f"the trace holds no {SPAN} span")
    w0 = float(span[0]["ts"])
    w1 = w0 + float(span[0]["dur"])
    tid = span[0].get("tid")
    dev = []
    by_name, count = defaultdict(float), defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        d = float(e.get("dur", 0.0))
        if s + d < w0 or s > w1:
            continue
        s, t = max(s, w0), min(s + d, w1)
        dev.append((s, t))
        by_name[e["name"]] += (t - s) * 1e-6
        count[e["name"]] += 1
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6

    # host operations of the job's thread, for the idle gaps
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                  and e.get("tid") == tid)
    starts = [h[0] for h in host]
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = defaultdict(float)
    stack, i = [], 0
    for g0, g1 in gaps:                     # gaps are in time order
        mid = 0.5 * (g0 + g1)
        j = bisect.bisect_right(starts, mid)
        while i < j:                        # host ops that began by mid
            h = host[i]
            while stack and stack[-1][1] <= h[0]:
                stack.pop()
            stack.append(h)
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "python"
        idle[name] += (g1 - g0) * 1e-6
    return TraceSummary((w1 - w0) * 1e-6, busy_s, sum(count.values()),
                        dict(by_name), dict(count), dict(idle))
