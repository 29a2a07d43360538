"""Whole runs of a cell on the CPU at a small scale, the look for a
card skipped: a sound run is judged correct, and one whose timed path
is broken underneath is not. Also: the command itself refuses to run
without a card, and prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

import run as R
from conftest import BENCH, CHECKOUT

SCALE = 0.01


def _run(workload, monkeypatch=None, broken=None, trace=False):
    """A run; ``broken`` rewrites each answer of the window (the
    warm-up's eight stay sound, as a fault that shows only under load)."""
    if broken is not None:
        from presto_tpu_torch import Engine
        real = Engine.execute
        calls = []

        def execute(self, sql, *a, **k):
            calls.append(sql)
            rows = real(self, sql, *a, **k)
            return rows if len(calls) <= 8 else broken(rows)
        monkeypatch.setattr(Engine, "execute", execute)
    out, lines = R.run(workload, 2 ** 31 + 11, 1.5, trace, device="cpu",
                       scale=SCALE)
    return out, lines


@pytest.mark.parametrize("workload", ["tpch-sf10.power", "tpcds-sf10.power"])
def test_sound_run_is_correct(workload):
    out, lines = _run(workload)
    assert out["correct"], lines
    assert out["attempted"] >= 8 and out["failed"] == 0
    assert set(out["metrics"]) == {"queries_per_s", "latency_p95_s",
                                   "setup_s"}  # no device metric off the card
    assert list(out)[-1] == "checks"
    assert lines[-3:] == [f"check {k} {v['value']} limit {v['limit']}"
                          + (" (at least)" if v.get("at_least") else "")
                          for k, v in out["checks"].items()]


def _alter_one_value(rows):
    """An answer altered where it is produced: the last column of the
    first row, one unit off."""
    if not rows:
        return rows
    first = list(rows[0])
    v = first[-1]
    first[-1] = 1 if v is None else v + ("x" if isinstance(v, str) else 1)
    return [tuple(first)] + list(rows[1:])


def _drop_half(rows):
    """Half of the answer left out."""
    return list(rows[: len(rows) // 2])


@pytest.mark.parametrize("fault", [_alter_one_value, _drop_half])
@pytest.mark.parametrize("workload", ["tpch-sf10.power", "tpcds-sf10.power"])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    out, _lines = _run(workload, monkeypatch, fault)
    assert not out["correct"]
    assert out["checks"]["mismatched_rows"]["value"] > 0


def test_failing_queries_are_not_correct(monkeypatch):
    def fail(rows):
        raise RuntimeError("the program failed")
    out, lines = _run("tpch-sf10.power", monkeypatch, fail)
    assert not out["correct"] and out["failed"] == out["attempted"]
    assert "RuntimeError: the program failed" in lines[0]


def test_traced_run_on_cpu():
    out, lines = _run("tpch-sf10.power", trace=True)
    assert out["correct"], lines
    # counts, not device times: the CPU has no device trace
    assert set(out["metrics"]) == {"plan_ms", "host_syncs_per_query"}
    assert "busy_s" not in out["device"]


def _command(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tpch-sf10.power",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_command_needs_a_card(card_absent):
    done = _command(CHECKOUT)
    assert done.returncode != 0
    assert not done.stdout.strip()
    assert "CUDA device" in done.stderr


def test_command_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's
    folder, the command exits non-zero and prints no result."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _command(tmp_path)
    assert done.returncode != 0
    assert not done.stdout.strip()


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
