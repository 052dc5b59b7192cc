"""No module that the benchmark loads is JAX's or the JAX package's
(compared by whole top-level names: the port's name begins with the JAX
package's), nothing under portbench/ reads the JAX package's benchmark
files, and without a CUDA device a run fails and prints no result."""
import json
import os
import re
import subprocess
import sys

from portbench import harness

PROBE = r"""
import sys, json
sys.path.insert(0, %r)
from portbench import run, harness, check, entries, trace, readings
from portbench.counts import ops, work
import bssm_tpu_torch
b = json.load(open(%r))
for w in b["workloads"]:
    harness.load_cell(w["name"])
for m in b["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def test_no_jax_module_is_loaded():
    root = str(harness.ROOT)
    out = subprocess.run(
        [sys.executable, "-c", PROBE % (root, str(harness.ROOT /
                                                  "BENCHMARK.json"))],
        capture_output=True, text=True, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bssm_tpu_torch" in tops and "portbench" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_sources_name_no_jax_package_file():
    bad = re.compile(r"\bbench\.py\b|\bbenchmarks/|^\s*(import|from)\s+"
                     r"(jax|jaxlib|flax|bssm_tpu)\b", re.M)
    for path in harness.PB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not bad.search(path.read_text()), path


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "poisson_llt.is2_psi_N10", "--seed", "3000000000", "--seconds",
         "1", "--trace", "0"], cwd=str(harness.ROOT), capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
