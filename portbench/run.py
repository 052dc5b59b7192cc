"""The benchmark of the PyTorch/CUDA port ``bssm_tpu_torch``, one cell a run.

    python3 -m portbench.run --workload poisson_llt.is2_psi_N10 \\
        --seed 12345 --seconds 30 --trace 0

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  Prints the device, its power limit and clocks and the port's
launch counts on earlier lines, the numbers compared beside their limits
as the last lines of standard error, and the result as one JSON object on
the last line of standard output.  Without a CUDA device, or with fewer
than the cell asks for, or when a module of JAX or of the JAX package is
loaded once the window has closed, it prints no result and exits 2.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ", no result", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    result = harness.run(args.workload, args.seed % 2 ** 63, args.seconds,
                         bool(args.trace), device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules {bad} are loaded; no result",
              file=sys.stderr)
        return 2
    # after the window, so that set-up does not wait for nvidia-smi
    print(json.dumps({"portbench_device": {
        "name": torch.cuda.get_device_name(device),
        "count": torch.cuda.device_count(),
        "nvidia_smi": harness.nvidia_smi(),
        "torch": torch.__version__, "cuda": torch.version.cuda}}),
        flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
