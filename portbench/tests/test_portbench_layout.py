"""The harness finds a cell, a configuration and a per-layer metric that
were added as files alone, and the repo's BENCHMARK.json keeps to the
layout its harness reads."""
import json
import shutil
from pathlib import Path

import pytest

from portbench import harness

PB = Path(harness.PB)


def test_every_cell_loads_with_its_metrics():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and cell.mix["rate"] in names
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names
            assert callable(harness.reader(m["name"]))


def test_added_files_alone_make_a_new_cell(tmp_path):
    pb = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(PB / d, pb / d)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    # a new configuration: the main model's files under a new name
    for ext in (".json", ".py"):
        shutil.copy(pb / "configs" / f"poisson_llt{ext}",
                    pb / "configs" / f"poisson_llt_copy{ext}")
    bench["configs"].append(dict(bench["configs"][0], name="poisson_llt_copy",
                                 file="portbench/configs/poisson_llt_copy.json"))
    # a new traffic mix and its limits
    mix = json.loads((pb / "traffic" / "is2_psi_N10.json").read_text())
    mix["run"]["n_chains"] = 4096
    (pb / "traffic" / "is2_psi_N10_c4096.json").write_text(json.dumps(mix))
    name = "poisson_llt_copy.is2_psi_N10_c4096"
    (pb / "limits" / f"{name}.json").write_text(
        (pb / "limits" / "poisson_llt.is2_psi_N10.json").read_text())
    bench["workloads"].append({"name": name, "config": "poisson_llt_copy",
                               "traffic": "is2_psi_N10_c4096", "chips": 1,
                               "why": "test"})
    # a new per-layer metric with its reader
    (pb / "metrics" / "jobs_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.jobs))\n")
    bench["per_layer"].append({
        "name": "jobs_in_window", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "chain loop",
        "moves": "samples_per_s", "workloads": [name]})
    for m in bench["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append(name)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))

    cell = harness.load_cell(name, path, pb)
    assert cell.mix["run"]["n_chains"] == 4096
    assert cell.config["name"] == "poisson_llt"
    assert [m["name"] for m in cell.per_layer] == ["jobs_in_window"]
    assert harness.reader("jobs_in_window", pb)(
        harness.Context(cell, [1, 2], None, None, None)) == 2.0
    assert cell.cfgmod.series(cell.config).shape == (100,)
    with pytest.raises(KeyError):
        harness.load_cell("no.such_cell", path, pb)


def test_benchmark_json_keeps_the_contract_shape():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PB / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for c in bench["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []


def test_poisson_prior_bounds_follow_the_series():
    """bssm's example bounds both sds by 2 sd(log(max(0.1, y))), R's sd."""
    import numpy as np
    cell = harness.load_cell("poisson_llt.is2_psi_N10")
    y = cell.cfgmod.series(cell.config)
    s = np.std(np.log(np.maximum(0.1, y)), ddof=1)
    for p in cell.config["priors"]:
        assert p["dist"] == "uniform" and p["min"] == 0.0
        assert abs(p["max"] - 2 * s) < 1e-12
