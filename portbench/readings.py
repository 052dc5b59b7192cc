"""The readings that the limits of ``limits/<cell>.json`` are set from, in
one process: the cell's set-up once, then for each seed a window of the
cell's length and the comparison's numbers, for each control seed also the
control's (the reference in the program's place in bfloat16), and for each
fault seed the numbers of a window run with each named fault of
``faults.py`` planted.  Not run by the benchmark's own runs.

    python3 -m portbench.readings --workload poisson_llt.is2_psi_N10 \\
        --seconds 0 --seeds 101 102 ... --control-seeds 201 202 203 \\
        --fault-seeds 301 --faults frozen half

``--override '{"run": {"iter": 4000}}'`` merges other sizes into the mix
(a look at what a number depends on; such readings set no limit).
Prints one JSON line a seed (and fault), then one line with the largest
reading of each number over the seeds, the smallest of the control's, and
the smallest of each fault's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell: str, seconds: float, seeds, control_seeds, device,
             shrink=None, emit=print, fault_seeds=(), faults=()) -> dict:
    from portbench import harness
    from portbench.faults import FAULTS

    p = harness.prepare(cell, (list(seeds) + list(control_seeds)
                               + list(fault_seeds))[0], device, shrink)
    lower, upper, caught = {}, {}, {}

    def one(seed, ctrl=False, fault=None):
        w = harness.measure(p, seed, seconds, False,
                            FAULTS[fault]() if fault else None)
        good, checks, ev = harness.compare(p, w, seed, control=ctrl)
        nums = {k: c["value"] for k, c in checks.items()}
        span = (w.jobs[-1].start + w.jobs[-1].wall - w.jobs[0].start) \
            if w.jobs else 0.0
        line = {"seed": seed, "fault": fault, "correct": good,
                "jobs": len(w.jobs),
                "rate": sum(j.work for j in w.jobs) / span if span else None,
                "numbers": nums, "details": ev.details if ev else None}
        if ctrl and ev is not None:
            line["control"] = ev.control
        emit(json.dumps(line))
        return nums, ev

    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        ctrl = seed in control_seeds
        nums, ev = one(seed, ctrl)
        if seed in seeds:
            for k, v in nums.items():
                lower[k] = max(lower.get(k, v), v)
        if ctrl and ev is not None:
            for k, v in ev.control.items():
                if v == v:                      # a NaN sets no reading
                    upper[k] = min(upper.get(k, v), v)
    for seed in fault_seeds:
        for f in faults:
            nums, _ = one(seed, fault=f)
            got = caught.setdefault(f, {})
            for k, v in nums.items():
                got[k] = min(got.get(k, v), v)
    summary = {"cell": cell, "lower": lower, "control_lowest": upper,
               "fault_lowest": caught}
    emit(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=["frozen", "half"])
    ap.add_argument("--override", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    shrink = {"mix": json.loads(args.override)} if args.override else None
    readings(args.workload, args.seconds, args.seeds, args.control_seeds,
             torch.device("cuda", 0), shrink, fault_seeds=args.fault_seeds,
             faults=args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
