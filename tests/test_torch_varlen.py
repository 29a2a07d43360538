"""The variable-length aggregates (array_agg, map_agg, listagg;
exec/varlen.py) of presto_tpu_torch through Engine(device="cpu"), held
against presto_tpu on the same data:

- the SQL of tests/test_functions.py's varlen section and the two
  varlen tests of tests/test_arrays.py (a result read by cardinality
  and by UNNEST through the host-table carrier), at SF0.01;
- FILTER (WHERE ...), a group that FILTER empties (NULL), DESC order
  keys with NULLs and ties, NULL elements, NULL map keys and NULL
  listagg values over a seeded table;
- a seeded array_agg of orders grouped by o_custkey at SF0.01.

The port groups the rows with one stable sort where the reference
loops over them; the reference's order among ties (input order) is the
port's too, so lists compare exactly. Result rows whose order the query
leaves open compare as multisets.
"""

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

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


@pytest.mark.parametrize("sql", C.VARLEN_SQL)
def test_reference_varlen_sql(sql, port, engine):
    assert port.execute(sql) == engine.execute(sql)


def test_varlen_values_match_the_reference_tests(port):
    rows = port.execute(C.VARLEN_SQL[0])
    assert len(rows) == 5
    for _, names in rows:
        assert names == sorted(names) and len(names) == 5
    (vals,) = port.execute(C.VARLEN_SQL[1])[0]
    assert vals.count(None) == 5 and len(vals) == 25
    assert port.execute(C.VARLEN_SQL[2])[0][0] == [0, 1, 2, 3, 4]
    assert port.execute(C.VARLEN_SQL[4])[0][1] == \
        "UNITED STATES|PERU|CANADA|BRAZIL|ARGENTINA"


# -- a seeded table of NULLs and ties --------------------------------------------


@pytest.fixture(scope="module")
def pair():
    ref = C.memory_engine(RefEngine(), RefMemory(), RT,
                          {"t": C.nulls_and_ties(RT)})
    port = C.memory_engine(TorchEngine(device="cpu"), MemoryConnector(),
                           PT, {"t": C.nulls_and_ties(PT)})
    return ref, port


@pytest.mark.parametrize("name", sorted(C.NULLS_SQL))
def test_varlen_nulls_ties_and_filters(name, pair):
    ref, port = pair
    sql = C.NULLS_SQL[name]
    assert port.execute(sql) == ref.execute(sql)


def test_filter_emptied_group_is_null(pair):
    _ref, port = pair
    rows = port.execute(C.NULLS_SQL["filter_empties_a_group"])
    assert rows and all(a is None for _g, a in rows)


def test_array_agg_of_orders_by_customer(port, engine):
    sql = C.ORDERS_BY_CUSTOMER_SQL
    got, want = port.execute(sql), engine.execute(sql)
    # the group order is left open: a multiset of rows
    assert sorted(got, key=lambda r: r[0]) == sorted(want, key=lambda r: r[0])
    assert all(c == len(a) == len(s) for _k, c, a, s in got)
