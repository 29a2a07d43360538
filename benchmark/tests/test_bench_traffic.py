"""The traffic generator: deterministic from the seed, inside the
spec's substitution ranges, and every literal of each template drawn."""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

from conftest import BENCH
from harness import traffic


def _stream(suite: str, seed: int):
    mix = json.loads((BENCH / "traffic" / suite / "power.json").read_text())
    refs = {q: importlib.import_module(f"reference.{suite}.{q}")
            for q in mix["queries"]}
    return traffic.Stream(mix, refs, seed), mix


@pytest.mark.parametrize("suite", ["tpch", "tpcds"])
def test_deterministic_from_seed(suite):
    a, _ = _stream(suite, 2 ** 31 + 17)
    b, _ = _stream(suite, 2 ** 31 + 17)
    c, _ = _stream(suite, 12)
    seq = [a.query(i) for i in range(64)]
    assert seq == [b.query(i) for i in range(64)]
    assert [a.query(i) for i in (63, 5, 0)] == [seq[63], seq[5], seq[0]]
    assert a.warm() == b.warm()
    assert seq != [c.query(i) for i in range(64)]


def _days(s):
    return int((np.datetime64(s) - np.datetime64("1970-01-01")).astype(int))


def test_tpch_literals_in_spec_ranges():
    """Clause 2.4's substitution parameters of the eight queries."""
    from datagen import tpch
    stream, mix = _stream("tpch", 3)
    assert mix["queries"] == ["q14", "q06", "q18", "q03", "q01", "q10",
                              "q05", "q07"]
    seen: dict = {}
    for i in range(8000):
        name, p, sql = stream.query(i)
        assert "{" not in sql
        seen.setdefault(name, []).append(p)
        if name == "q01":
            assert 60 <= p["delta"] <= 120
        elif name == "q03":
            assert p["segment"] in tpch.SEGMENTS
            assert _days("1995-03-01") <= _days(p["date"]) <= \
                _days("1995-03-31")
        elif name == "q05":
            assert p["region"] in tpch.REGIONS
            assert p["date"][4:] == "-01-01" and 1993 <= int(p["date"][:4]) \
                <= 1997
        elif name == "q06":
            assert p["date"][4:] == "-01-01" and 1993 <= int(p["date"][:4]) \
                <= 1997
            assert p["discount"] in [f"0.0{k}" for k in range(2, 10)]
            assert p["quantity"] in (24, 25)
        elif name == "q07":
            names = [n for n, _ in tpch.NATIONS]
            assert p["nation1"] in names and p["nation2"] in names
            assert p["nation1"] != p["nation2"]
        elif name == "q10":
            assert p["date"][8:] == "01"
            assert "1993-02-01" <= p["date"] <= "1995-01-01"
        elif name == "q14":
            assert p["date"][8:] == "01"
            assert "1993-01-01" <= p["date"] <= "1997-12-01"
        elif name == "q18":
            assert 312 <= p["quantity"] <= 315
    # the ranges are covered, not one value each
    assert {p["delta"] for p in seen["q01"]} == set(range(60, 121))
    assert len({p["date"] for p in seen["q14"]}) == 60
    assert len({p["date"] for p in seen["q10"]}) == 24
    assert len({(p["nation1"], p["nation2"]) for p in seen["q07"]}) > 100


def test_tpcds_literals_in_spec_ranges():
    """The substitutions of the eight TPC-DS templates (YEAR, MONTH,
    MANUFACT, MANAGER, GEN, MS, ES, six states, GMT, HOUR, DEPCNT)."""
    from datagen import tpcds
    stream, mix = _stream("tpcds", 3)
    assert mix["queries"] == ["q03", "q07", "q19", "q27", "q42", "q43",
                              "q55", "q96"]
    demo = {"gender": {"M", "F"}, "marital": {"M", "S", "D", "W", "U"},
            "education": set(tpcds._EDUCATION)}
    seen: dict = {}
    for i in range(8000):
        name, p, sql = stream.query(i)
        assert "{" not in sql
        seen.setdefault(name, []).append(p)
        if "year" in p:
            assert 1998 <= p["year"] <= 2002
        if "month" in p:
            assert p["month"] in (11, 12)
        if "manager" in p:
            assert 1 <= p["manager"] <= 100
        if name in ("q07", "q27"):
            for k, values in demo.items():
                assert p[k] in values
        if name == "q03":
            assert 1 <= p["manufact"] <= 1000
        elif name == "q27":
            states = [p[f"state{k}"] for k in range(1, 7)]
            assert len(set(states)) == 6 and set(states) <= set(
                tpcds._STATES)
        elif name == "q43":
            assert p["gmt"] in ("-5", "-6")
        elif name == "q96":
            assert p["hour"] in (8, 15, 16, 20) and 0 <= p["depcnt"] <= 9
    assert {p["year"] for p in seen["q42"]} == set(range(1998, 2003))
    assert {p["depcnt"] for p in seen["q96"]} == set(range(10))
    assert len({p["manufact"] for p in seen["q03"]}) > 500
    assert len({p["education"] for p in seen["q07"]}) == 7


def test_a_mix_asking_for_more_is_refused():
    """Clients, think time or another path are not what this harness
    drives: a mix that names them is refused, not run as one client."""
    mix = json.loads((BENCH / "traffic" / "tpch" / "power.json").read_text())
    for extra in ({"clients": 16}, {"think_s": 0.5},
                  {"path": "CoordinatorServer"}):
        with pytest.raises(ValueError, match="does not implement"):
            traffic.Stream({**mix, **extra}, {}, 1)
