"""Find what a cell is made of, by the names in ``BENCHMARK.json``.

A cell ``<config>.<mix>`` names a configuration
(``configs/<config>.json``, whose ``suite`` says which queries it
runs), a traffic mix of that suite (``traffic/<suite>/<mix>.json``),
the reference of every query the mix runs
(``reference/<suite>/<q>.py``) and a reader for each metric
(``metrics/<metric>.py``). Adding any of them is adding files.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    references: dict  # query name -> its reference module
    end_to_end: list  # BENCHMARK.json metric entries the cell reports
    per_layer: list


def load(checkout: Path, bench: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``checkout/BENCHMARK.json``, its files
    read from ``bench`` (the benchmark's folder)."""
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[workload]
    config = json.loads(
        (bench / "configs" / f"{entry['config']}.json").read_text())
    suite = config["suite"]
    mix = json.loads(
        (bench / "traffic" / suite / f"{entry['traffic']}.json").read_text())
    references = {q: importlib.import_module(f"reference.{suite}.{q}")
                  for q in mix["queries"]}
    return Cell(
        name=workload, chips=int(entry["chips"]), config=config, mix=mix,
        references=references,
        end_to_end=[m for m in spec["end_to_end"]
                    if _reports(m, workload, None)],
        per_layer=[m for m in spec["per_layer"]
                   if _reports(m, workload, spec["end_to_end"])])


def _reports(metric: dict, workload: str, end_to_end) -> bool:
    """Does ``workload`` report ``metric``: named in its ``workloads``,
    or, without that key, every cell that reports what it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if end_to_end is None:
        return True
    moved = [m for m in end_to_end if m["name"] == metric.get("moves")]
    return bool(moved) and all(_reports(m, workload, None) for m in moved)


def reader(name: str):
    """The ``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return importlib.import_module(f"metrics.{name}").read
