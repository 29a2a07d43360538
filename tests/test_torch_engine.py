"""The port's main path as a whole: TPC-H Q1, Q6, Q3, Q5 and Q9 at
SF0.01 through presto_tpu.Engine and presto_tpu_torch.Engine(device=
"cpu"), rows exactly equal (all five are decimal, date and string
results), and both against the sqlite oracle; the port's TPC-H
generator byte-identical to the reference's; the kernel notes of the
plain versions; and the memory connector over the reference's own
arrays."""

import numpy as np
import pytest
import torch

from presto_tpu.testing.oracle import assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.memory import from_host_tables
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

from tpch_queries import QUERIES

MAIN_PATH = ["q01", "q06", "q03", "q05", "q09"]

# a join on partsupp's composite unique key: no single key column is
# unique, so the join cannot take the dense direct-address path and
# goes through the join_lookup kernel entry (SF0.01 Q3's joins are
# all dense)
LOOKUP_JOIN_SQL = """
select ps_supplycost, sum(l_quantity) as q, count(*) as c
from lineitem, partsupp
where l_partkey = ps_partkey and l_suppkey = ps_suppkey
  and l_shipdate < date '1993-01-01'
group by ps_supplycost
order by q desc, ps_supplycost
limit 5
"""


# a many-to-many join (nation keys repeat on both sides): the
# expanding join path
EXPAND_JOIN_SQL = """
select n_name, count(*) as pairs, sum(s_acctbal) as bal
from supplier, customer, nation
where s_nationkey = c_nationkey and c_nationkey = n_nationkey
  and c_mktsegment = 'BUILDING'
group by n_name
order by n_name
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel, and torch's default of one
    OpenMP thread per core in every worker oversubscribes the host
    (its spinning threads slowed the whole suite several times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(scope="module")
def torch_tpch():
    return TorchTpch(scale=0.01)


@pytest.fixture(scope="module")
def port(torch_tpch):
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tpch)
    return e


@pytest.mark.parametrize("qname", MAIN_PATH)
def test_main_path_rows_equal_reference_and_oracle(qname, engine, port,
                                                   oracle):
    want = engine.execute(QUERIES[qname])
    got = port.execute(QUERIES[qname])
    assert got == want
    assert len(got) > 0
    assert_query(port, oracle, QUERIES[qname])


def _notes(e) -> set[str]:
    return {t for tags in e.last_kernel_notes.values() for t in tags}


def test_main_path_kernel_notes(port):
    expected = {"q01": {"torch:agg_sum"}, "q06": {"torch:agg_sum"},
                "q05": {"torch:agg_sum", "torch:multijoin"},
                "q09": {"torch:multijoin"}}
    for qname, tags in expected.items():
        port.execute(QUERIES[qname])
        assert port.last_backend == "torch"
        assert tags <= _notes(port), (qname, port.last_kernel_notes)


def test_non_dense_join_takes_join_lookup(engine, port, oracle):
    assert "Join[inner, unique" in port.explain(LOOKUP_JOIN_SQL)
    assert port.execute(LOOKUP_JOIN_SQL) == engine.execute(LOOKUP_JOIN_SQL)
    assert "torch:join_lookup" in _notes(port)
    assert_query(port, oracle, LOOKUP_JOIN_SQL)


def test_many_to_many_join_takes_the_expanding_join(engine, port, oracle):
    assert "expanding" in port.explain(EXPAND_JOIN_SQL)
    assert port.execute(EXPAND_JOIN_SQL) == engine.execute(EXPAND_JOIN_SQL)
    assert_query(port, oracle, EXPAND_JOIN_SQL)


def test_kernel_backend_cuda_on_cpu_tensors_runs_plain_versions(
        torch_tpch, engine):
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tpch)
    e.execute("set session kernel_backend = 'cuda'")
    assert e.execute(QUERIES["q05"]) == engine.execute(QUERIES["q05"])
    assert e.last_backend == "cuda"
    assert {"torch:agg_sum", "torch:multijoin"} <= _notes(e)


def test_tpch_generator_byte_identical(tpch_tiny, torch_tpch):
    assert torch_tpch.table_names() == tpch_tiny.table_names()
    for name in tpch_tiny.table_names():
        ref, got = tpch_tiny.table(name), torch_tpch.table(name)
        assert got.nrows == ref.nrows
        assert list(got.columns) == list(ref.columns)
        for cname, rc in ref.columns.items():
            gc = got.columns[cname]
            assert str(gc.dtype) == str(rc.dtype), (name, cname)
            a, b = np.asarray(gc.data), np.asarray(rc.data)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (name, cname)
            if rc.dictionary is None:
                assert gc.dictionary is None
            else:
                assert list(gc.dictionary) == list(rc.dictionary), \
                    (name, cname)


def test_memory_connector_over_reference_arrays(tpch_tiny, engine):
    conn = from_host_tables({"lineitem": tpch_tiny.table("lineitem")})
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", conn)
    col = conn.table("lineitem").columns["l_returnflag"]
    assert col.data is tpch_tiny.table("lineitem").columns[
        "l_returnflag"].data
    for qname in ("q01", "q06"):
        assert e.execute(QUERIES[qname]) == engine.execute(QUERIES[qname])


def test_table_to_host_matches_reference(engine, port):
    from presto_tpu.engine import _table_to_host as ref_to_host
    from presto_tpu_torch.engine import _table_to_host
    sql = QUERIES["q03"]
    rs, rd, rv = ref_to_host(engine.execute_table(sql))
    ps, pd, pv = _table_to_host(port.execute_table(sql))
    assert [str(t) for t in ps.values()] == [str(t) for t in rs.values()]
    for name in rs:
        np.testing.assert_array_equal(pd[name], rd[name], err_msg=name)
        assert (pv[name] is None) == (rv[name] is None), name


def test_unported_features_raise(port):
    with pytest.raises(NotImplementedError, match="not ported"):
        port.execute("select stddev(l_quantity) from lineitem")
    with pytest.raises(NotImplementedError, match="not ported"):
        port.execute("select upper(r_name) from region")
