"""ARRAY and MAP values, lambdas and UNNEST in presto_tpu_torch
(ROADMAP Queue 1 item 3e) through Engine(device="cpu"), held against
presto_tpu on the same data:

- every SQL of tests/test_arrays.py at SF0.01;
- each of the 22 array, map and lambda scalars and UNNEST over a seeded
  table of random arrays (random lengths, NULL arrays, NULL elements,
  string and double elements): the rows of both engines equal (array
  values compare as Python lists of their live positions; double sums
  within the oracle's tolerance, ROADMAP R2);
- an ARRAY column through a segment carrier on the default route.

Where the reference cannot run a shape (its row gathers drop an
array's lengths: a sort, a join payload or a group key that carries an
ARRAY), the port is held against rows computed independently: the type
(not the rank) tells a LONG decimal from an ARRAY under DISTINCT, GROUP
BY and a join, and an ARRAY rides a join payload and a carrier into
UNNEST.
"""

import math

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.exec import executor as REX
from presto_tpu.expr import compile as RC

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import executor as EX
from presto_tpu_torch.expr import compile as PC

import torch_array_cases as C


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port():
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(scale=0.01))
    return e


@pytest.mark.parametrize("sql", C.ARRAY_SQL)
def test_reference_array_sql(sql, port, engine):
    assert port.execute(sql) == engine.execute(sql)


def test_every_reference_scalar_is_ported():
    assert set(RC.SCALARS) <= set(PC.SCALARS)


# -- the scalars over random arrays -------------------------------------------

@pytest.fixture(scope="module")
def arrays_pair():
    ref = C.memory_engine(RefEngine(), RefMemory(), RT,
                          {"t": C.random_arrays(RT)})
    port = C.memory_engine(TorchEngine(device="cpu"), MemoryConnector(),
                           PT, {"t": C.random_arrays(PT)})
    return ref, port


def _same_rows(got, want):
    """Equal rows; doubles (and doubles in arrays) within 1e-9 relative
    (R2: the reference's sums reassociate)."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, list):
                assert isinstance(a, list) and len(a) == len(b), (a, b)
                pairs = list(zip(a, b))
            else:
                pairs = [(a, b)]
            for x, y in pairs:
                if isinstance(y, (float, np.floating)) and y is not None:
                    assert x is not None and (
                        (math.isnan(x) and math.isnan(y))
                        or x == pytest.approx(y, rel=1e-9, abs=1e-12)), \
                        (g, w)
                else:
                    assert x == y, (g, w)


@pytest.mark.parametrize("name", sorted(C.RANDOM_SQL))
def test_array_scalars_on_random_arrays(name, arrays_pair):
    ref, port = arrays_pair
    sql = C.RANDOM_SQL[name]
    _same_rows(port.execute(sql), ref.execute(sql))


# -- rank is not type -----------------------------------------------------------


def _plain(row) -> str:
    """A row as text, numpy scalars as Python values (a sort key for
    rows whose order is unspecified)."""
    return str([[x.item() if isinstance(x, np.generic) else x for x in v]
                if isinstance(v, list) else
                v.item() if isinstance(v, np.generic) else v for v in row])


def _as_key(v):
    return tuple(v) if isinstance(v, list) else v


def test_distinct_carries_an_array_beside_a_long_decimal(port, engine):
    got = port.execute(
        "select distinct cast(n_regionkey as decimal(38, 2)) as d, "
        "array[n_regionkey % 2, n_nationkey % 3] as a from nation")
    want = {(d, (r % 2, k % 3)) for d, k, r in engine.execute(
        "select cast(n_regionkey as decimal(38, 2)), n_nationkey, "
        "n_regionkey from nation")}
    assert sorted((d, _as_key(a)) for d, a in got) == sorted(want)
    assert len(got) == len(want)


def test_group_by_an_array_beside_a_long_decimal(port, engine):
    got = port.execute(
        "select cast(n_regionkey as decimal(38, 2)) as d, "
        "array[n_regionkey % 2, 7] as a, count(*), sum(n_nationkey) "
        "from nation group by 1, 2")
    want = {}
    for d, k, r in engine.execute(
            "select cast(n_regionkey as decimal(38, 2)), n_nationkey, "
            "n_regionkey from nation"):
        c, s = want.get((d, (r % 2, 7)), (0, 0))
        want[(d, (r % 2, 7))] = (c + 1, s + k)
    assert sorted((d, _as_key(a), c, s) for d, a, c, s in got) == \
        sorted(key + val for key, val in want.items())


def test_join_carries_an_array_beside_a_long_decimal(port, engine):
    got = port.execute(
        "select n_name, r.d, r.w, cardinality(r.w) from nation, "
        "(select r_regionkey k, cast(r_regionkey as decimal(38, 2)) d, "
        "split(r_name, ' ') w from region) r where n_regionkey = r.k")
    want = [(n, d, name.split(" "), len(name.split(" ")))
            for n, d, name in engine.execute(
                "select n_name, cast(r_regionkey as decimal(38, 2)), "
                "r_name from nation, region where n_regionkey = r_regionkey")]
    assert sorted(map(_plain, got)) == sorted(map(_plain, want))


def test_sort_and_window_carry_arrays(port, engine):
    got = port.execute(
        "select n_nationkey, array[n_regionkey, n_nationkey], "
        "row_number() over (partition by n_regionkey order by n_nationkey) "
        "from nation order by n_nationkey desc limit 5")
    want = engine.execute(
        "select n_nationkey, n_regionkey, row_number() over (partition by "
        "n_regionkey order by n_nationkey) from nation "
        "order by n_nationkey desc limit 5")
    assert [(k, list(a), rn) for k, a, rn in got] == \
        [(k, [r, k], rn) for k, r, rn in want]


# -- carriers -----------------------------------------------------------------

SEGMENT_SQL = (
    "select n_name, cardinality(x.a), element_at(x.a, 2), x.a from "
    "(select s_nationkey k, array[s_suppkey, ps_partkey, ps_availqty] a "
    "from supplier, partsupp where s_suppkey = ps_suppkey "
    "and ps_availqty < 50) x, nation where x.k = n_nationkey")


def _carriers(monkeypatch) -> list:
    """Record the carriers the port's segments make."""
    made = []
    run_plan_device = EX.run_plan_device

    def recording(*args, **kw):
        made.append(run_plan_device(*args, **kw))
        return made[-1]
    monkeypatch.setattr(EX, "run_plan_device", recording)
    return made


def _companions(scan) -> set:
    return {k.rpartition("$")[2] for k in scan.arrays if "$" in k}


def test_array_column_through_a_segment_carrier(port, engine, monkeypatch):
    monkeypatch.setattr(REX, "MAX_JOINS_PER_PROGRAM", 1)
    monkeypatch.setattr(EX, "MAX_JOINS_PER_PROGRAM", 1)
    made = _carriers(monkeypatch)
    got = port.execute(SEGMENT_SQL)
    assert port.last_run.segments, "no segment materialized"
    assert any(_companions(c) >= {"len", "emask"} for c in made), \
        [sorted(c.arrays) for c in made]
    want = engine.execute(SEGMENT_SQL)
    assert sorted(map(_plain, got)) == sorted(map(_plain, want))


def test_array_group_key_through_the_aggregate_input_carrier(
        port, engine, monkeypatch):
    # the reference cannot group by an array: held against the scalar
    # group-by it stands for
    monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)
    made = _carriers(monkeypatch)
    got = port.execute(
        "select a, cardinality(a), count(*), sum(ps_availqty) from "
        "(select array[p_size % 3, ps_suppkey % 2] a, ps_availqty "
        "from part, partsupp where p_partkey = ps_partkey) group by a")
    assert any("len" in _companions(c) for c in made), \
        [sorted(c.arrays) for c in made]
    want = engine.execute(
        "select p_size % 3, ps_suppkey % 2, count(*), sum(ps_availqty) "
        "from part, partsupp where p_partkey = ps_partkey group by 1, 2")
    assert sorted((tuple(a), n, c, s) for a, n, c, s in got) == \
        sorted(((x, y), 2, c, s) for x, y, c, s in want)


def test_unnest_over_a_carried_split(port, engine, monkeypatch):
    monkeypatch.setattr(EX, "MAX_JOINS_PER_PROGRAM", 1)
    got = port.execute(
        "select n_name, u from (select s_nationkey k, split(p_type, ' ') w "
        "from part, partsupp, supplier where p_partkey = ps_partkey "
        "and s_suppkey = ps_suppkey and ps_availqty < 30) x, nation, "
        "unnest(x.w) t(u) where x.k = n_nationkey")
    assert len(port.last_run.segments) >= 1
    want = [(n, u) for n, t in engine.execute(
        "select n_name, p_type from part, partsupp, supplier, nation "
        "where p_partkey = ps_partkey and s_suppkey = ps_suppkey "
        "and ps_availqty < 30 and s_nationkey = n_nationkey")
        for u in t.split(" ")]
    assert sorted(got) == sorted(want)
