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
    # the statements that write and transactions (ROADMAP Queue 1 item
    # 6) are still to port; PREPARE, EXECUTE and EXPLAIN ANALYZE run
    # since item 5 (tests/test_torch_templates.py, test_torch_profile.py),
    # the variable-length aggregates and ARRAY values since item 3e
    for sql in ("create table x as select 1 as a",
                "insert into x select 1",
                "delete from x",
                "update x set a = 2",
                "drop table x",
                "start transaction",
                "commit",
                "rollback"):
        with pytest.raises(NotImplementedError, match="not ported"):
            port.execute(sql)
    assert port.execute("select cardinality(array_agg(r_name)) from "
                        "region") == [(5,)]
    assert port.execute("select cardinality(split(r_name, ' ')) from "
                        "region where r_regionkey = 4") == [(2,)]


# -- host-to-device uploads --------------------------------------------------


def _run_upload_site(site: str):
    """Drives one upload site of the port on CPU tensors; returns what
    it made and the value the reference's counterpart makes."""
    import jax.numpy as jnp

    from presto_tpu.expr import compile as RC
    from presto_tpu.ops import hash as RH
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.expr import compile as PC
    from presto_tpu_torch.expr import ir
    from presto_tpu_torch.ops import hash as PH
    # a fresh dictionary object, so no table of it is cached yet
    dictionary = np.array(["AIR", "MAIL", "RAIL", "REG AIR", "SHIP"],
                          dtype=object)
    codes = np.array([0, 3, 1, 4, 2, 3], dtype=np.int32)
    if site == "dictionary-lut":
        def pred(s):
            return np.char.find(s, "AIR") >= 0
        got = PC._dict_predicate(
            PC.Val(PT.VARCHAR, torch.from_numpy(codes), None, dictionary),
            pred).data.numpy()
        want = RC._dict_predicate(
            RC.Val(RC.T.VARCHAR, jnp.asarray(codes), None, dictionary),
            pred).data
    elif site == "literal":
        lit = ir.Literal(PT.DecimalType(12, 2), 123456)
        got = PC.ExprCompiler({}, "cpu").compile(lit).data.numpy()
        want = np.int64(123456)
    elif site == "dictionary-hashes":
        got = PH.hash_string_column(torch.from_numpy(codes),
                                    dictionary).numpy()
        want = np.asarray(RH.hash_string_column(jnp.asarray(codes),
                                                dictionary)).view(np.int64)
    else:  # scan-column
        host = np.arange(7, dtype=np.int64) * 3
        got = TorchEngine(device="cpu").device_array(host).numpy()
        want = host
    return got, np.asarray(want)


@pytest.mark.parametrize("site", ["dictionary-lut", "literal",
                                  "dictionary-hashes", "scan-column"])
def test_upload_sites_go_through_hostsync(site):
    # each host-to-device copy of the execute path is one counted
    # hostsync.upload (pinned and non-blocking on the card), and gives
    # the reference's values
    from presto_tpu_torch.exec import hostsync as HS
    before = dict(HS.UPLOADS.by_site)
    syncs = HS.SYNCS.total()
    got, want = _run_upload_site(site)
    np.testing.assert_array_equal(got, want)
    assert HS.UPLOADS.by_site.get(site, 0) == before.get(site, 0) + 1
    assert {s: c for s, c in HS.UPLOADS.by_site.items()
            if s != site} == {s: c for s, c in before.items() if s != site}
    assert HS.SYNCS.total() == syncs


@pytest.mark.parametrize("case", ["decimal_rescale", "int128_constant"])
def test_scalar_constants_upload_nothing(case):
    # the decimal rescale's divisor and int128's small multiplier are
    # made on the tensor's device (torch.full): no upload, no copy
    from presto_tpu_torch.exec import hostsync as HS
    from presto_tpu_torch.expr import compile as PC
    from presto_tpu_torch.ops import int128 as I
    vals = [123456789012345678901234567, -98765432109876543210987,
            5, -5, 0]
    # the low limb's bits as int64, the signed high limb
    low = np.array([v & ((1 << 64) - 1) for v in vals], dtype=np.uint64)
    limbs = I.pack(torch.from_numpy(low.view(np.int64)),
                   torch.tensor([v >> 64 for v in vals], dtype=torch.int64))
    before = HS.UPLOADS.total()
    if case == "decimal_rescale":
        got = PC._rescale128(limbs, 25, 3)
        # HALF_UP: half away from zero
        want = [(abs(v) + 5 * 10 ** 21) // 10 ** 22 * (1 if v >= 0 else -1)
                for v in vals]
    else:
        got = I.mul_small(limbs, 10 ** 9)
        want = [v * 10 ** 9 for v in vals]
    assert HS.UPLOADS.total() == before
    lo = got[:, 0].numpy().astype(np.uint64).astype(object)
    hi = got[:, 1].numpy().astype(object)
    assert [int(h) * (1 << 64) + int(low) for low, h in zip(lo, hi)] == want


# -- hand-built plans ---------------------------------------------------------


@pytest.mark.parametrize("name", ["q01", "q06"])
def test_hand_built_plans_give_the_sql_rows(port, engine, name):
    # handq's Q1 and Q6 plans run through execute_plan like any plan:
    # equal to the reference's hand-built plans (float averages within
    # their last bits, R2) and to the SQL's rows (whose averages round
    # to the decimal's scale, 2)
    from presto_tpu.benchmarks import handq as ref_handq
    from presto_tpu.exec.executor import execute_plan as ref_execute_plan

    from presto_tpu_torch.benchmarks import handq
    from presto_tpu_torch.exec.executor import execute_plan

    build = {"q01": "q1_plan", "q06": "q6_plan"}[name]
    got = execute_plan(port, getattr(handq, build)()).to_pylist()
    want = ref_execute_plan(engine, getattr(ref_handq, build)()).to_pylist()
    sql = port.execute(QUERIES[name])
    assert len(got) == len(want) == len(sql)
    for g, w, s in zip(got, want, sql):
        for a, b, c in zip(g, w, s):
            if isinstance(a, str):
                assert a == b == c
                continue
            assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b))
            assert abs(float(a) - float(c)) <= 0.005 + 1e-9 * abs(float(c))
