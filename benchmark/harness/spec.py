"""What BENCHMARK.json and the files under ``benchmark/`` say about a cell.

Everything that belongs to one configuration, cell or metric is a file of
its own, found by its name:

* a configuration: the ``file`` of its entry (``configs/<name>.json``);
* a cell: ``workloads/<cell name>.json``, the closed loop's parameters;
* a circuit kind: ``circuits/<kind>.py`` and ``ref/kinds/<kind>.py``;
* a per-layer metric: ``metrics/<metric name>.py`` with ``read(run)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


class Cell:
    """One cell: its name, configuration (name, file, contents), closed-loop
    parameters, and the names and units of the metrics it reports."""

    def __init__(self, name: str, config_name: str, config_path: str,
                 loop: dict, end_to_end: list, per_layer: list, chips=1):
        self.name = name
        self.config_name = config_name
        self.config_path = config_path
        self.cfg = _read_json(config_path)
        self.loop = loop
        self.end_to_end = end_to_end
        self.per_layer = per_layer
        self.chips = int(chips)

    @classmethod
    def from_benchmark(cls, bench: dict, name: str, root: str = ROOT):
        entry = _named(bench["workloads"], name, "workload")
        conf = _named(bench["configs"], entry["config"], "config")
        loop = _read_json(os.path.join(HERE, "workloads", name + ".json"))
        if loop["traffic"] != entry["traffic"]:
            raise ValueError(f"workloads/{name}.json is traffic "
                             f"{loop['traffic']!r}, BENCHMARK.json says "
                             f"{entry['traffic']!r}")
        return cls(name, conf["name"], os.path.join(root, conf["file"]), loop,
                   _for_cell(bench["end_to_end"], name),
                   _for_cell(bench["per_layer"], name), entry["chips"])


def _for_cell(metrics, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def circuit_kind(cfg: dict):
    """The benchmark's module for the configuration's circuit kind."""
    return importlib.import_module(f"benchmark.circuits.{cfg['circuit']}")


def ref_kind(cfg: dict):
    """The reference's module for the configuration's circuit kind."""
    return importlib.import_module(f"benchmark.ref.kinds.{cfg['circuit']}")


def metric_reader(name: str):
    """``read(run) -> number or None`` of the per-layer metric ``name``,
    loaded from ``metrics/<name>.py`` by path (a metric name may hold dots
    and dashes)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
