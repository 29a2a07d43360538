"""Dynamic filtering in the port (exec/executor.py): the bloom bits of
a build column equal presto_tpu's bit for bit; the rows of TPC-H Q5,
Q9 and Q12 are the same with the filter on and off and equal the
reference's; the filter prunes the lineitem scans of Q5 and of the
reference's Q17-like query (tests/test_dynamic_filter.py) and Q12's
orders scan, whose live rows equal the reference's EXPLAIN ANALYZE
count. SF0.01."""

import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import types as RT
from presto_tpu.exec import executor as REX
from presto_tpu.exec import operators as ROP
from presto_tpu.expr.compile import Val as RefVal

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import executor as EX
from presto_tpu_torch.exec.operators import DTable
from presto_tpu_torch.expr.compile import Val

from test_dynamic_filter import Q17_LIKE
from tpch_queries import QUERIES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ports():
    """The port with the filter on and off, over one connector."""
    conn = TorchTpch(scale=0.01)
    out = {}
    for df in (True, False):
        e = TorchEngine(device="cpu")
        e.register_catalog("tpch", conn)
        e.session.set("enable_dynamic_filtering", df)
        out[df] = e
    return out


@pytest.fixture(scope="module")
def reference(tpch_tiny):
    e = RefEngine()
    e.register_catalog("tpch", tpch_tiny)
    return e


def _explain_scan_rows(text: str, table: str) -> int:
    for line in text.splitlines():
        if f"TableScan[tpch.{table}]" in line:
            m = re.search(r"rows: (\d+)", line)
            if m:
                return int(m.group(1))
    raise AssertionError(f"no annotated scan of {table} in:\n{text}")


@pytest.mark.parametrize("case", ["int", "int_nulls", "varchar",
                                  "varchar_nulls", "empty", "wide"])
def test_bloom_bits_equal_reference(case):
    rng = np.random.default_rng(len(case))
    n = {"empty": 0, "wide": 5000}.get(case, 300)
    live = rng.random(n) < 0.7
    valid = rng.random(n) < 0.8 if case.endswith("nulls") else None
    if case.startswith("varchar"):
        dictionary = np.array([f"s{i}" for i in range(40)], dtype=object)
        data = rng.integers(0, 40, n).astype(np.int32)
        rtype, ptype = RT.VARCHAR, T.VARCHAR
    else:
        dictionary = None
        data = rng.integers(-10**9, 10**9, n)
        rtype, ptype = RT.BIGINT, T.BIGINT
    crit = [("probe_key", "build_key")]

    ref = REX.PlanInterpreter({}, {})
    ref._collect_dyn_filters(
        types.SimpleNamespace(criteria=crit), ROP.DTable(
            {"build_key": RefVal(rtype, jnp.asarray(data), None if valid
                                 is None else jnp.asarray(valid),
                                 dictionary)}, jnp.asarray(live), n))
    interp = EX.PlanInterpreter({}, {}, None, "cpu")
    interp._collect_dyn_filters(crit, DTable(
        {"build_key": Val(ptype, torch.from_numpy(data), None if valid
                          is None else torch.from_numpy(valid),
                          dictionary)}, torch.from_numpy(live), n,
        torch.device("cpu")))
    want = np.asarray(ref.dyn_filters["probe_key"])
    got = interp.dyn_filters["probe_key"].numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    assert got.sum() <= (live & (valid if valid is not None else True)
                         ).sum()


@pytest.mark.parametrize("qname", ["q05", "q09", "q12"])
def test_rows_unchanged_by_the_filter(qname, ports, reference):
    on = ports[True].execute(QUERIES[qname])
    off = ports[False].execute(QUERIES[qname])
    assert on == off
    assert on == reference.execute(QUERIES[qname])


def test_filter_prunes_q5_lineitem(ports):
    rows = {}
    for df, e in ports.items():
        e.execute(QUERIES["q05"])
        rows[df] = EX.scan_live_rows(e, "lineitem")
    assert len(rows[True]) == len(rows[False]) == 1
    assert rows[True][0] < rows[False][0]


@pytest.mark.parametrize("sql,table", [(Q17_LIKE, "lineitem"),
                                       (QUERIES["q12"], "orders")],
                         ids=["q17_like_lineitem", "q12_orders"])
def test_filter_prunes_the_probe_scan_as_the_reference(sql, table, ports,
                                                        reference):
    # the part filter keeps about 1/1000 of parts, Q12's lineitem
    # filter a few percent of orders: the bloom cuts the probe scan
    rows = {}
    for df, e in ports.items():
        e.execute(sql)
        (rows[df],) = EX.scan_live_rows(e, table)
    assert rows[True] < rows[False] / 5, rows
    assert ports[True].execute(sql) == ports[False].execute(sql)
    text = reference.execute(f"explain analyze {sql}")[0][0]
    assert rows[True] == _explain_scan_rows(text, table)
