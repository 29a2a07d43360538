"""BENCHMARK.json keeps to its schema: its names and units
use only the allowed characters, every entry has just its keys, and
what it names exists under the benchmark's folder."""

from __future__ import annotations

import json
import re

from conftest import BENCH, CHECKOUT
from harness import cell as C

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _spec():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names += [c["name"], *c["reduced"]]
        assert (CHECKOUT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        names.append(m["name"])
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.fullmatch(n), n
    assert len(set(m["name"] for m in spec["end_to_end"]
                   + spec["per_layer"])) == len(spec["end_to_end"]) + len(
        spec["per_layer"])


def test_bounds_and_metrics():
    spec = _spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves():
    """Each cell's configuration, mix, references and metric readers
    exist, and it reports setup_s, another end-to-end metric and a
    per-layer one."""
    for w in _spec()["workloads"]:
        cell = C.load(CHECKOUT, BENCH, w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(C.reader(m["name"]))
        for ref in cell.references.values():
            assert ref.SQL and ref.COLUMNS and callable(ref.answer)
