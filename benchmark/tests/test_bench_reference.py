"""Each plain reference gives the port's rows, at SF0.01 (TPC-DS at
0.01 and 0.05), over several seeds and literal sets: the queries of
two loops of each mix, so every query with two sets of literals."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH
from harness import judge as J
from harness import program, traffic
from reference.common import Tables


def _cell(suite: str, scale: float, seed: int):
    import importlib
    config = json.loads((BENCH / "configs" / f"{suite}-sf10.json")
                        .read_text())
    config["scale"] = scale
    mix = json.loads((BENCH / "traffic" / suite / "power.json")
                     .read_text())
    refs = {q: importlib.import_module(f"reference.{suite}.{q}")
            for q in mix["queries"]}
    data, gen = program.generate(config, seed)
    engine = program.engine(config, data, gen, device="cpu")
    return engine, data, traffic.Stream(mix, refs, seed), refs


@pytest.mark.parametrize("suite,scale,seed", [
    ("tpch", 0.01, 19920101), ("tpch", 0.01, 4294967311),
    ("tpch", 0.05, 7), ("tpcds", 0.01, 20030527), ("tpcds", 0.05, 99),
    ("tpcds", 0.02, 2 ** 31 + 5)])
def test_reference_equals_port(suite, scale, seed):
    engine, data, stream, refs = _cell(suite, scale, seed)
    tables = Tables(data, "cpu")
    checked = 0
    for i in range(2 * len(stream.queries)):
        name, params, sql = stream.query(i)
        ref = refs[name]
        got = J.rows_of(ref, engine.execute(sql))
        want = J.reference_rows(ref, tables, params)
        assert J.mismatches(ref, got, want) == 0, (name, params, got[:3],
                                                   want[:3])
        checked += bool(want)
    assert checked >= len(stream.queries)


@pytest.mark.parametrize("precision", ["float32"])
def test_control_fails_at_test_size(precision):
    """The control (the reference computed in float32, put in the
    program's place) is judged not correct; the reference in its own
    precision is judged correct."""
    engine, data, stream, refs = _cell("tpch", 0.01, 5)
    exact, low = Tables(data, "cpu"), Tables(data, "cpu", precision)
    wrong = 0
    for i in range(len(stream.queries)):
        name, params, _sql = stream.query(i)
        ref = refs[name]
        want = J.reference_rows(ref, exact, params)
        assert J.mismatches(ref, want, want) == 0
        wrong += J.mismatches(ref, J.reference_rows(ref, low, params), want)
    assert wrong > 0


def test_ties_and_limits():
    """Rows that tie on every ordering column may come in any order,
    and a LIMIT may cut among them; anything else is a mismatch."""
    class Ref:
        COLUMNS = [("k", "int"), ("v", "dec:2")]
        ORDER = [(1, True)]
        LIMIT = 2
    import decimal
    d = decimal.Decimal
    want = [(1, d("3.00")), (2, d("2.00")), (3, d("2.00"))]
    assert J.mismatches(Ref, [(1, d("3.00")), (3, d("2.00"))], want) == 0
    assert J.mismatches(Ref, [(1, d("3.00")), (2, d("2.00"))], want) == 0
    assert J.mismatches(Ref, [(2, d("2.00")), (1, d("3.00"))], want) == 2
    assert J.mismatches(Ref, [(1, d("3.00"))], want) == 1
    assert J.mismatches(Ref, [(1, d("3.01")), (3, d("2.00"))], want) == 1


def test_canonical_forms():
    import decimal

    import numpy as np
    d = decimal.Decimal
    assert J.canonical(np.float64(561479116.09), "dec:2") == d("561479116.09")
    assert J.canonical(d("14.5"), "dec:2") == d("14.50")
    assert J.canonical(np.datetime64("1995-02-21"), "date") == "1995-02-21"
    assert J.canonical(np.int64(7), "int") == 7
    assert J.canonical(None, "str") is None
