"""One run of one cell: set-up, the measured window, the traced job, the
comparison and the result's line.  Everything that belongs to a cell is
found by name: the cell in ``BENCHMARK.json``, its configuration under
``configs/`` (``<config>.json`` and ``<config>.py``), its traffic mix under
``traffic/<traffic>.json``, its limits under ``limits/<cell>.json``, and
each per-layer metric's reader under ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

PB = Path(__file__).resolve().parent
ROOT = PB.parent
# top-level modules the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "bssm_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict            # the configuration's file
    cfgmod: object          # its module: series, build, system
    mix: dict               # the traffic mix
    limits: dict
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # the cell's per-layer metric entries


def _applies(metric: dict, cell: str, cell_e2e: Optional[set]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, else every
    cell (an end-to-end metric, ``cell_e2e`` None) or every cell that
    reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return cell_e2e is None or metric["moves"] in cell_e2e


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              pb: Path = PB) -> Cell:
    """The cell ``name`` of ``bench_path``, each of its parts read from its
    own file under ``pb`` (the configuration's from the ``file`` that
    ``BENCHMARK.json`` names, relative to ``bench_path``'s directory)."""
    bench_path = Path(bench_path)
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_file = bench_path.parent / entry["file"]
    config = json.loads(cfg_file.read_text())
    cfgmod = _module(cfg_file.with_suffix(".py"),
                     f"portbench_config_{w['config']}")
    mix = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((pb / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, int(w["chips"]), config, cfgmod, mix, limits, e2e,
                per)


def reader(metric: str, pb: Path = PB):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return _module(pb / "metrics" / f"{metric}.py",
                   f"portbench_metric_{metric.replace('.', '_')}").read


def job_seed(seed: int, j: int) -> int:
    """Job ``j``'s seed, derived from the run's."""
    return int(np.random.SeedSequence([seed, 1000 + j]).generate_state(
        1, np.uint32)[0])


class Context(NamedTuple):
    """What a per-layer reader reads."""
    cell: Cell
    jobs: list              # the window's jobs
    traced: Optional[object]    # the traced job, or None
    trace: Optional[object]     # its ``trace.TraceSummary``
    passes_mean: Optional[float]    # the reference's Laplace passes a head

    @property
    def untraced(self) -> list:
        """The jobs the profiler did not slow (the traced one if alone)."""
        rest = [j for j in self.jobs if j is not self.traced]
        return rest or [self.traced]


def nvidia_smi() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s entries for the keys it has, nested dicts
    merged."""
    out = dict(base)
    for k, v in over.items():
        if k in out:
            out[k] = merged(out[k], v) if isinstance(v, dict) else v
    return out


class Prepared(NamedTuple):
    """A cell made ready on its device: the model and the entry's driver,
    warmed up."""
    cell: Cell
    y: np.ndarray
    model: object
    drv: object
    device: object
    dtype: object


def prepare(cell_name: str, seed: int, device,
            shrink: Optional[dict] = None) -> Prepared:
    """Set-up: the configuration's model and the mix's driver, made from
    ``seed``, and one warm-up at the cell's shapes.  ``shrink`` (the tests
    on the CPU: ``{"config": ..., "mix": ..., "limits": ...}``) merges
    smaller sizes, and the limits that go with them, into the cell's
    files."""
    import torch
    import bssm_tpu_torch as bt
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from portbench import entries

    cell = load_cell(cell_name)
    if shrink:
        cell = cell._replace(
            config=merged(cell.config, shrink.get("config", {})),
            mix=merged(cell.mix, shrink.get("mix", {})),
            limits=merged(cell.limits, shrink.get("limits", {})))
    dtype = getattr(torch, cell.config["dtype"])
    y = cell.cfgmod.series(cell.config)
    model = cell.cfgmod.build(bt, cell.config, y, dtype, device)
    drv = entries.make(bt, torch, model, cell.mix, device,
                       job_seed(seed, 10 ** 6))
    t0 = time.time()
    drv.warm_up(job_seed(seed, 10 ** 6 + 1))
    print(json.dumps({"portbench_warm_up_s": time.time() - t0}),
          flush=True)
    ck.reset_launch_counts()
    return Prepared(cell, y, model, drv, device, dtype)


class Window(NamedTuple):
    jobs: list
    failed: int
    traced: Optional[object]    # the traced job
    tracer: Optional[object]    # its ``trace.Traced``
    counts: dict                # the port's launch counts over the window
    seconds: float


def measure(p: Prepared, seed: int, seconds: float, trace: bool,
            fault=None) -> Window:
    """Jobs back to back while fewer than ``seconds`` have passed since the
    first began (the one running at the close counts); with ``trace`` the
    first under the profiler.  Each job is cut to the check's sample as it
    ends (``check.keep``), and the garbage collector waits for the close.
    ``fault``: a context manager entered around the window (the tests plant
    a broken program with it)."""
    import contextlib
    import gc
    import torch
    from bssm_tpu_torch.ops import cuda_kalman as ck
    from portbench import check

    k = int(p.cell.mix["check"]["heads"])
    ck.reset_launch_counts()
    jobs, failed, traced, tracer = [], 0, None, None
    gc.collect()
    gc.disable()
    w0 = time.time()
    try:
        with fault or contextlib.nullcontext():
            j = 0
            while j == 0 or time.time() - w0 < seconds:
                s = job_seed(seed, j)
                try:
                    if trace and j == 0:
                        from portbench.trace import Traced
                        with Traced(torch) as tracer:
                            jb = p.drv.job(s)
                    else:
                        jb = p.drv.job(s)
                    jb = check.keep(jb, k, seed, j)
                    if trace and j == 0:
                        traced = jb
                    jobs.append(jb)
                except Exception:                  # noqa: BLE001
                    failed += 1
                    print(f"job {j} failed:", file=sys.stderr)
                    traceback.print_exc()
                j += 1
        seconds_ = time.time() - w0
    finally:
        gc.enable()
    counts = {"launches": dict(ck.LAUNCHES),
              "plain_routes": dict(ck.PLAIN_ROUTES),
              "replayed": dict(ck.REPLAYED)}
    return Window(jobs, failed, traced, tracer, counts, seconds_)


def compare(p: Prepared, w: Window, seed: int, control: bool = False):
    """(correct, checks, the evaluation) of a window's jobs."""
    from portbench import check
    plain = sum(w.counts["plain_routes"].values())
    numbers, ev = {"failed_jobs": float(w.failed)}, None
    if w.jobs:
        ev = check.evaluate(p.cell.config, p.cell.cfgmod, p.y, p.cell.mix,
                            w.jobs, plain, seed, p.device, control)
        numbers.update(ev.numbers)
    good, checks = check.judge(numbers,
                               dict(p.cell.limits, failed_jobs=0))
    return good and bool(w.jobs), checks, ev


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None, emit=print,
        shrink: Optional[dict] = None) -> dict:
    """One run; returns the result's dict (``checks`` last).  ``device``
    a ``torch.device``; ``fault`` and ``shrink`` as ``measure`` and
    ``prepare`` take them."""
    import torch

    t_prepare = time.time()
    p = prepare(cell_name, seed, device, shrink)
    cell, mix = p.cell, p.cell.mix
    setup_s = time.time() - t_start
    emit(json.dumps({"portbench_setup_s": {
        "to_prepare": t_prepare - t_start,
        "prepare": time.time() - t_prepare}}))
    w = measure(p, seed, seconds, trace, fault)
    jobs = w.jobs
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    p = p._replace(model=None, drv=None)      # the program's state goes
    if device.type == "cuda":
        torch.cuda.empty_cache()
    emit(json.dumps({"portbench_counts": w.counts, "jobs": len(jobs),
                     "window_s": w.seconds}))

    t0 = time.time()
    summary = w.tracer.summary() if w.tracer is not None else None
    t1 = time.time()
    correct, checks, ev = compare(p, w, seed)
    emit(json.dumps({"portbench_after_window_s": {
        "trace_reading": t1 - t0, "comparison": time.time() - t1},
        "jobs": [[jb.wall, jb.time] for jb in jobs],
        "check_details": ev.details if ev else None}))

    metrics = {}
    work = sum(jb.work for jb in jobs)
    span = (jobs[-1].start + jobs[-1].wall - jobs[0].start) if jobs else 0.0
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                v = setup_s
            elif m["name"] == mix["rate"] and span > 0:
                v = work / span
            else:
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = Context(cell, jobs, w.traced, summary,
                      ev.passes_mean if ev else None)
        for m in cell.per_layer:
            v = reader(m["name"])(ctx) if jobs else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None:
            from portbench.counts import work
            emit(json.dumps({"portbench_rooflines": {
                k: dict(b, device_s=summary.device_s(k),
                        launches=sum(c for n, c in
                                     summary.count_by_name.items()
                                     if k in n))
                for k, b in work.kernels(ctx).items()}}))

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    result = {"correct": correct,
              "attempted": len(jobs) + w.failed, "failed": w.failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result
