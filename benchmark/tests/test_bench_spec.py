"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file: a cell's loop, a configuration's file and circuit kind,
a metric's reader."""

import json
import math
import os
import re

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_contract():
    path = os.path.join(spec.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    b = spec.benchmark()
    assert set(b) == KEYS["top"]
    assert b["paths"] == ["benchmark"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[part]]
        assert len(names) == len(set(names))
        for e in b[part]:
            assert set(e) - {"workloads"} == KEYS[part], e["name"]
            assert NAME.match(e["name"])
            for k in ("why", "source", "layer"):
                if k in e:
                    assert TEXT.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    assert cells >= 1
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in b["workloads"]:
        assert w["chips"] in (1, 4)
        assert w["config"] in {c["name"] for c in b["configs"]}


def test_every_name_finds_its_files():
    b = spec.benchmark()
    for w in b["workloads"]:
        c = spec.Cell.from_benchmark(b, w["name"])
        assert c.cfg["reduced"] == [
            e for e in b["configs"] if e["name"] == w["config"]][0]["reduced"]
        assert spec.circuit_kind(c.cfg) and spec.ref_kind(c.cfg)
        assert os.path.relpath(c.config_path, spec.ROOT).startswith(
            "benchmark/configs/")
        for m in c.end_to_end + c.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        assert len(c.end_to_end) >= 2 and c.per_layer
    for conf in b["configs"]:
        with open(os.path.join(spec.ROOT, conf["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == conf["source"]
        assert {"source", "assumed", "reduced"} <= set(cfg)


def test_kernel_rate_derivation():
    from benchmark.harness import peaks
    assert math.isclose(peaks.INT_OPS_RATE, 64 * 132 * 1.98e9, rel_tol=0.01)
