"""The benchmark as data: ``BENCHMARK.json`` names the cells and the
metrics; every cell, configuration, traffic mix, driver and metric sits in
a file of its own under ``benchmark/``, found by its name.

* a cell: ``cells/<workload>.json`` (its driver, the driver's options,
  the correctness limits, the calls its traced run traces);
* a configuration: ``configs/<config>.json``;
* a traffic mix: ``traffic/<traffic>.json``, read by ``harness/traffic.py``;
* a driver: ``drivers/<driver>.py``, a class ``Driver``;
* a metric: ``metrics/<metric name>.py``, a function ``read(run)``; a
  metric ``<name>.<kind>`` (``mfu.train``) with no file of its own reads
  with ``metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # benchmark/
ROOT = os.path.dirname(HERE)                                          # the checkout


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    options: dict           # the cell's file
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric, workload, reported):
    """Whether a cell reports ``metric``: it lists the cell, or it lists no
    cells and moves an end-to-end metric the cell reports."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if reported is not None else True


def load_cell(workload, bench=None, root=ROOT):
    """The cell ``workload`` of ``BENCHMARK.json`` with its files."""
    bench = bench or _json(root, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    here = os.path.join(root, "benchmark")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(name=workload, chips=entry["chips"],
                config=_json(here, "configs", entry["config"] + ".json"),
                traffic=_json(here, "traffic", entry["traffic"] + ".json"),
                options=_json(here, "cells", workload + ".json"),
                end_to_end=e2e, per_layer=per_layer)


def driver_class(name):
    return importlib.import_module(f"benchmark.drivers.{name}").Driver


def metric_path(name, root=ROOT):
    """The file that reads metric ``name``: ``metrics/<name>.py``, else, for
    a name ``<name>.<kind>``, ``metrics/<name>.py``; None where neither is."""
    here = os.path.join(root, "benchmark", "metrics")
    for stem in (name, name.rpartition(".")[0]):
        if stem and os.path.exists(os.path.join(here, stem + ".py")):
            return os.path.join(here, stem + ".py")
    return None


def metric_reader(name, root=ROOT):
    """``read`` of the metric's file (names may hold dots, so the file is
    loaded by its path)."""
    path = metric_path(name, root)
    if path is None:
        raise FileNotFoundError(f"benchmark/metrics has no file for metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
