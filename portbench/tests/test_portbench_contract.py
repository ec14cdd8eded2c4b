"""The benchmark's files: BENCHMARK.json within its contract, a cell found
from files alone, the result line's keys, and no JAX in what a run
imports."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.run import forbidden_modules, result_line

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(harness.REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_its_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(harness.REPO, c["file"]))
        with open(os.path.join(harness.REPO, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        for kind, key in (("configs", "config"), ("traffic", "traffic"),
                          ("cells", "name")):
            assert os.path.isfile(os.path.join(harness.ROOT, kind,
                                               w[key] + ".json"))
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(harness.ROOT, "metrics",
                                           m["name"] + ".py"))
    assert len(json.dumps(b)) < 64 * 1024


def test_cell_found_from_files_alone(tmp_path):
    base = tmp_path / "bench"
    for kind in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(os.path.join(harness.ROOT, kind), base / kind)
    (base / "traffic" / "mixed.json").write_text(json.dumps(dict(
        json.loads((base / "traffic" / "p2_binned.json").read_text()),
        batch_size=8)))
    (base / "cells" / "bert_large.mixed.json").write_text(
        (base / "cells" / "bert_large.p2_binned.json").read_text())
    bench = _bench()
    bench["workloads"].append({"name": "bert_large.mixed",
                               "config": "bert_large", "traffic": "mixed",
                               "chips": 1, "why": "a cell of files"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = harness.find_cell("bert_large.mixed", str(path), str(base))
    assert cell.traffic["batch_size"] == 8
    assert cell.family.__name__ == "portbench.families.bert"
    # metrics that list their cells leave a cell they do not list
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in bench["per_layer"] if "workloads" not in m}
    ctx = {"spans": {"loader_wait": [0.5], "step": [0.25], "wall": 2.0}}
    assert harness.read_metric("loader.wait_share", ctx, str(base)) == 25.0


def test_silent_metric_fails_the_run():
    cell = harness.find_cell("bart_base.L1024")
    ctx = {"spans": {"loader_wait": [0.5], "step": [0.25], "wall": 2.0},
           "counters": ({"stage_s": {"collate": 1.0, "h2d": 1.0},
                         "loader_batches": 1, "prefetch_batches": 1},
                        {"stage_s": {"collate": 2.0, "h2d": 2.0},
                         "loader_batches": 3, "prefetch_batches": 3}),
           "trace": {"busy_s": 0.0, "window_s": 1.0, "optimizer_s": 0.5,
                     "launches": [], "kernels": {}, "step_stats": [],
                     "device_events": 0, "marker": True}}
    with pytest.raises(RuntimeError, match="device.idle_share"):
        harness.per_layer_metrics(cell, ctx)


def test_result_line_keys():
    line = result_line(
        {"correct": True, "attempted": 3, "failed": 0,
         "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
         "breakdown": {"device_ops": [], "idle_gaps": []}},
        {"loss_gap": (1e-4, 1e-3)},
        {"platform": "gpu", "kind": "k", "count": 1,
         "memory_peak_bytes": 7})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["checks"] == {"loss_gap": {"value": 1e-4, "limit": 1e-3}}


def test_forbidden_names_compare_whole():
    assert forbidden_modules({"lddl_tpu_torch", "lddl_tpu_torch.loader",
                              "jaxtyping", "torch"}) == []
    assert forbidden_modules({"lddl_tpu.loader", "jax.numpy",
                              "flax"}) == ["flax", "jax", "lddl_tpu"]


def test_run_and_reference_import_no_jax():
    code = (
        "import sys\n"
        "import portbench.run, portbench.harness, portbench.control\n"
        "import portbench.families.bert, portbench.families.bart\n"
        "from portbench.run import forbidden_modules\n"
        "import lddl_tpu_torch.loader, lddl_tpu_torch.models\n"
        "assert forbidden_modules() == [], forbidden_modules()\n")
    subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                   check=True, timeout=300)


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "import portbench.reference.bert, portbench.reference.bart\n"
        "import portbench.reference.common\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('lddl_tpu_torch', 'lddl_tpu', 'jax', 'flax'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                   check=True, timeout=300)
