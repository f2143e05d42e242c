"""The benchmark as data: ``BENCHMARK.json`` keeps to its contract and
names only files that exist, and a cell and a metric added as files are
found and run without an edit to the code."""

from __future__ import annotations

import json
import os
import re
import shutil
import time

import pytest

from benchmark.harness import spec
from benchmark.run import run_cell
from benchmark.tests.helpers import DATA

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _bench(root=spec.ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(spec.ROOT, c["file"]))
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        for part, name in (("cells", w["name"]), ("traffic", w["traffic"])):
            assert os.path.exists(os.path.join(spec.HERE, part, name + ".json"))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]} and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "roofline" not in m["name"] or m["name"].split(".")[0].endswith("_roofline")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert spec.metric_path(m["name"]) is not None
    for w in cells:
        cell = spec.load_cell(w)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_metric_of_a_kind_reads_with_its_shared_file():
    """``mfu.train`` has no file of its own and reads with ``mfu.py``; a
    name with neither file is refused."""
    assert spec.metric_path("mfu.train") == os.path.join(spec.HERE, "metrics", "mfu.py")
    assert spec.metric_path("attn_roofline.train").endswith("attn_roofline.train.py")
    assert spec.metric_path("no_such_metric.train") is None
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")


def test_a_cell_and_a_metric_added_as_files_run(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric, by files and BENCHMARK.json entries alone; the
    harness finds them and runs the cell."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    here = root / "benchmark"
    shutil.copy(os.path.join(DATA, "tiny.json"), here / "configs" / "tiny.json")
    (here / "traffic" / "tiny-images.json").write_text(
        json.dumps({"inputs": "images", "batch": 2, "pool": 2}))
    (here / "cells" / "tiny.encode.json").write_text(json.dumps(
        {"driver": "encode", "driver_options": {"precision": "highest", "checked_batches": 2},
         "trace_calls": 1, "limits": {"id_mismatch_share": 0.0}, "control": {"precision": "high"}}))
    (here / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return float(run.window.calls)\n")
    b = _bench(root)
    b["configs"].append({"name": "tiny", "source": "tests", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "a dummy"})
    b["workloads"].append({"name": "tiny.encode", "config": "tiny", "traffic": "tiny-images",
                           "chips": 1, "why": "a dummy"})
    b["end_to_end"].append({"name": "calls_made", "unit": "count", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["tiny.encode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("tiny.encode", root=str(root))
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "calls_made"}
    assert cell.traffic["batch"] == 2 and cell.config["name"] == "tiny"
    result, _ = run_cell(cell, 99, 0.0, device="cpu", t0=time.perf_counter(), calls=3,
                         root=str(root))
    assert result["correct"] is True
    assert result["metrics"]["calls_made"] == {"value": 3.0, "unit": "count"}
    assert list(result)[-1] == "checks"
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", root=str(root))
