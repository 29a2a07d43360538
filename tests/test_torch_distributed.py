"""Distributed execution of the port (presto_tpu_torch/parallel/) over
LocalShardGroup on the CPU, held against presto_tpu under a mesh of 8
CPU devices and against the sqlite oracle, at TPC-H SF0.01: the
counterparts of tests/test_distributed.py, test_partitioned.py, the
mesh cases of test_skew_join.py, test_connector_partitioning.py,
test_dynamic_filter.py, test_config.py, test_functions.py and
test_statements.py. Where the reference reads its program text (an
all_to_all in last_dist_hlo, the sort dims), the port reads
parallel.group.COLLECTIVES, engine.last_dist_meta["used_capacity"] and
its merged runs. Then what the eager port adds: 2 shards against 8,
host syncs that do not grow with the shard count, a repeat query that
climbs no rung and uploads no scan column, capacities kept apart per
shard count, CTAS and ARRAY values under a group."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from presto_tpu_torch.sql.parser import parse_statement
from presto_tpu_torch.sql.sqlite_dialect import to_sqlite
from presto_tpu_torch.testing.oracle import SqliteOracle, rows_equal

from presto_tpu_torch import Engine
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.parallel.executor import execute_plan_distributed
from presto_tpu_torch.parallel.group import COLLECTIVES, LocalShardGroup
from presto_tpu_torch.plan import nodes as N

from torch_array_cases import RANDOM_SQL, memory_engine, random_arrays
from tpch_queries import QUERIES

DIST_QUERIES = ["q01", "q03", "q05", "q06", "q10", "q12", "q13", "q14",
                "q18", "q19"]
# held against the reference's rows under its mesh; the rest against
# sqlite
REF_MESH_QUERIES = ["q01", "q03", "q05"]
SORT_SQL = ("select l_orderkey, l_extendedprice from lineitem "
            "where l_quantity < 10 "
            "order by l_extendedprice desc, l_orderkey")
ORDERKEY_JOIN = (
    "select o_orderpriority, count(*) as c "
    "from orders, lineitem where o_orderkey = l_orderkey "
    "and l_quantity < 2500 group by o_orderpriority "
    "order by o_orderpriority")
G8 = LocalShardGroup(8, "cpu")
G2 = LocalShardGroup(2, "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]), ("d",))


@pytest.fixture(scope="module")
def torch_tpch():
    return TpchConnector(scale=0.01)


def make(conn, **props) -> Engine:
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    for k, v in props.items():
        e.session.set(k, v)
    return e


@pytest.fixture(scope="module")
def port(torch_tpch):
    return make(torch_tpch)


def _want(oracle, sql):
    return oracle.query(to_sqlite(parse_statement(sql)))


def check(got, want, sql):
    ok, msg = rows_equal(got, want, ordered="order by" in sql.lower())
    assert ok, msg


def kinds(e) -> set:
    return {k for (_, k) in e.last_dist_meta["used_capacity"]}


def _ran(e, sql, group=G8):
    COLLECTIVES.reset()
    rows = e.execute(sql, mesh=group)
    return rows, COLLECTIVES.snapshot()["calls"]


# -- tests/test_distributed.py ---------------------------------------------


@pytest.mark.parametrize("qname", DIST_QUERIES)
def test_distributed_matches(qname, port, engine, oracle, mesh):
    sql = QUERIES[qname]
    got = port.execute(sql, mesh=G8)
    if qname in REF_MESH_QUERIES:
        check(got, engine.execute(sql, mesh=mesh), sql)
    check(got, _want(oracle, sql), sql)
    assert port.last_run.passes == [1] or port.last_run.rungs > 0


def test_distributed_row_sharded_scan_count(port):
    assert port.execute("select count(*) from lineitem", mesh=G8) == \
        port.execute("select count(*) from lineitem")


def test_distributed_sort_merges_presorted_runs(torch_tpch, oracle):
    """With distributed_sort on, each shard sorts its rows and one merge
    of 8 runs replaces the replicated sort; off, no merge runs. Rows
    equal the oracle's either way."""
    want = _want(oracle, SORT_SQL)
    e = make(torch_tpch, distributed_sort=True)
    check(e.execute(SORT_SQL, mesh=G8), want, SORT_SQL)
    merges = e.last_dist_meta["merged_runs"]
    assert len(merges) == 1 and merges[0][1] == 8
    # a run is one shard of lineitem
    assert merges[0][2] == -(-torch_tpch.table("lineitem").nrows // 8)
    e.session.set("distributed_sort", False)
    check(e.execute(SORT_SQL, mesh=G8), want, SORT_SQL)
    assert e.last_dist_meta["merged_runs"] == []


def test_distributed_topn_partial_final(port, oracle):
    sql = ("select l_orderkey, l_extendedprice from lineitem "
           "order by l_extendedprice desc, l_orderkey limit 20")
    check(port.execute(sql, mesh=G8), _want(oracle, sql), sql)


def test_distributed_mixed_distinct_aggregates(port, oracle):
    sql = ("select l_returnflag, count(distinct l_suppkey) as ds, "
           "sum(l_quantity) as sq, count(distinct l_partkey) as dp, "
           "count(*) as c from lineitem group by l_returnflag "
           "order by l_returnflag")
    got, calls = _ran(port, sql)
    assert "mark_exch" in kinds(port) and calls["all_to_all"] > 0
    check(got, _want(oracle, sql), sql)


# -- tests/test_partitioned.py ---------------------------------------------


@pytest.mark.parametrize("qname", ["q03", "q05", "q09", "q18"])
def test_partitioned_join_matches_oracle(qname, torch_tpch, oracle):
    e = make(torch_tpch, join_distribution_type="PARTITIONED",
             partitioned_agg_min_groups=1)
    sql = QUERIES[qname]
    check(e.execute(sql, mesh=G8), _want(oracle, sql), sql)


def test_partitioned_join_uses_all_to_all(torch_tpch):
    e = make(torch_tpch, join_distribution_type="PARTITIONED")
    _rows, calls = _ran(e, QUERIES["q03"])
    assert calls.get("all_to_all", 0) > 0
    assert {"probe_exch", "build_exch"} <= kinds(e)


def test_broadcast_join_avoids_all_to_all(torch_tpch):
    e = make(torch_tpch, join_distribution_type="BROADCAST",
             partitioned_agg_min_groups=1 << 30)
    _rows, calls = _ran(e, QUERIES["q03"])
    assert "all_to_all" not in calls and calls["all_gather"] > 0
    assert not {"probe_exch", "build_exch"} & kinds(e)


def test_automatic_uses_threshold(torch_tpch):
    e = make(torch_tpch)
    e.execute(QUERIES["q03"], mesh=G8)
    assert "build_exch" not in kinds(e)
    e2 = make(torch_tpch, broadcast_join_threshold_rows=1)
    e2.execute(QUERIES["q03"], mesh=G8)
    assert "build_exch" in kinds(e2)


def test_partitioned_aggregation_matches(torch_tpch, oracle):
    sql = ("select l_orderkey, count(*) as c, sum(l_quantity) as q "
           "from lineitem group by l_orderkey order by c desc, "
           "l_orderkey limit 20")
    e = make(torch_tpch, partitioned_agg_min_groups=1,
             use_connector_partitioning=False)
    got, calls = _ran(e, sql)
    assert "agg_exch" in kinds(e) and calls["all_to_all"] > 0
    check(got, _want(oracle, sql), sql)


def test_partial_aggregation_toggle(torch_tpch):
    sql = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
           "group by l_returnflag order by l_returnflag")
    on = make(torch_tpch)
    off = make(torch_tpch, partial_aggregation=False)
    assert on.execute(sql, mesh=G8) == off.execute(sql, mesh=G8)
    # on, the partial -> final split sizes a final merge table
    assert "final" in kinds(on) and "final" not in kinds(off)


def test_repartition_preserves_all_rows(torch_tpch):
    e = make(torch_tpch, join_distribution_type="PARTITIONED",
             use_connector_partitioning=False)
    sql = ("select count(*) from lineitem, orders "
           "where l_orderkey = o_orderkey")
    assert e.execute(sql, mesh=G8) == e.execute(sql)
    assert "build_exch" in kinds(e)


def test_partitioned_window_uses_all_to_all(torch_tpch, oracle):
    sql = ("select c_nationkey, count(*) as c from ("
           "select c_nationkey, rank() over (partition by c_nationkey "
           "order by c_acctbal desc, c_custkey) as r from customer) t "
           "where r <= 5 group by c_nationkey order by c_nationkey")
    e = make(torch_tpch, partitioned_agg_min_groups=1)
    got, calls = _ran(e, sql)
    assert "win_exch" in kinds(e) and calls["all_to_all"] > 0
    check(got, _want(oracle, sql), sql)


def test_sharded_limit_partial(port, torch_tpch):
    got = port.execute("select l_orderkey from lineitem limit 7", mesh=G8)
    assert len(got) == 7
    keys = set(torch_tpch.table("lineitem").columns["l_orderkey"]
               .data.tolist())
    assert all(r[0] in keys for r in got)


def test_distributed_explain_analyze(torch_tpch, tpch_tiny, mesh):
    sql = ("explain analyze select l_returnflag, count(*) from lineitem "
           "group by l_returnflag order by l_returnflag")
    e = make(torch_tpch, partitioned_agg_min_groups=1)
    text = e.execute(sql, mesh=G8)[0][0]
    assert "Distributed plan over 8 devices" in text
    assert "rows:" in text and "[sharded]" in text
    assert "execute" in text and "compile" in text
    from presto_tpu import Engine as RefEngine
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    ref.session.set("partitioned_agg_min_groups", 1)
    want = ref.execute(sql, mesh=mesh)[0][0]

    def annotations(t):
        return sorted(line.strip() for line in t.splitlines()[1:])

    assert annotations(text) == annotations(want)


# -- tests/test_skew_join.py (mesh cases) ----------------------------------


SKEW_PROPS = dict(broadcast_join_threshold_rows=64,
                  skew_hot_key_threshold=64)


@pytest.fixture(scope="module")
def zipf():
    return TpchConnector(scale=0.01, skew="zipf:1.3")


@pytest.fixture(scope="module")
def zipf_oracle():
    o = SqliteOracle()
    o.load_connector(TpchConnector(scale=0.01, skew="zipf:1.3"))
    return o


def _nodes(plan, cls):
    out, stack = [], [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, cls):
            out.append(n)
        stack.extend(n.sources())
    return out


def test_multijoin_distributed_zipf(zipf, zipf_oracle):
    e = make(zipf)
    sql = QUERIES["q05"]
    assert _nodes(e.plan_sql(sql)[0], N.MultiJoin)
    check(e.execute(sql, mesh=G8), _want(zipf_oracle, sql), sql)


def test_hybrid_planned_and_oracle_zipf(zipf, zipf_oracle):
    e = make(zipf, multiway_join=False, **SKEW_PROPS)
    sql = QUERIES["q03"]
    dists = [j.distribution for j in _nodes(e.plan_sql(sql)[0], N.Join)]
    assert "hybrid" in dists, dists
    got, calls = _ran(e, sql)
    assert "hot" in kinds(e) and "htab" in kinds(e)
    check(got, _want(zipf_oracle, sql), sql)


def test_hybrid_empty_hot_key_set(torch_tpch, port):
    e = make(torch_tpch, multiway_join=False,
             broadcast_join_threshold_rows=64, skew_hot_key_threshold=256)
    sql = QUERIES["q03"]
    assert "hybrid" in [j.distribution
                        for j in _nodes(e.plan_sql(sql)[0], N.Join)]
    assert e.execute(sql, mesh=G8) == port.execute(sql)


def test_hybrid_all_keys_hot(zipf):
    e = make(zipf, multiway_join=False, broadcast_join_threshold_rows=64,
             skew_hot_key_threshold=1)
    sql = QUERIES["q03"]
    assert e.execute(sql, mesh=G8) == make(zipf).execute(sql)


def _force_salt(plan, salt):
    def visit(node):
        if isinstance(node, N.Join) and node.criteria:
            return dataclasses.replace(node, distribution="partitioned",
                                       salt_factor=salt)
        return node

    return N.rewrite_bottom_up(plan, visit)


def test_salted_unique_join(zipf):
    e = make(zipf, multiway_join=False, skew_hot_key_threshold=0)
    plan, _ = e.plan_sql(QUERIES["q03"])
    got = execute_plan_distributed(e, _force_salt(plan, 4), G8).to_pylist()
    assert {"probe_exch", "build_exch"} <= kinds(e)
    assert [tuple(r) for r in got] == make(zipf).execute(QUERIES["q03"])


def test_salted_expanding_join():
    mem = MemoryConnector()
    rng = np.random.default_rng(7)
    n = 4000
    fk = np.where(rng.random(n) < 0.5, 0,
                  rng.integers(0, 50, n)).astype(np.int64)
    dk = np.concatenate([np.zeros(40, np.int64), rng.integers(0, 50, 200)])
    mem.create_table("f", {"k": T.BIGINT, "v": T.BIGINT},
                     {"k": fk, "v": np.arange(n) % 97},
                     {"k": None, "v": None})
    mem.create_table("d", {"dk": T.BIGINT, "w": T.BIGINT},
                     {"dk": dk, "w": np.arange(len(dk))},
                     {"dk": None, "w": None})
    e = Engine(device="cpu")
    e.register_catalog("mem", mem)
    e.session.catalog = "mem"
    sql = ("select k, count(*) as c, sum(w) as s "
           "from f join d on f.k = d.dk group by k order by k")
    plan, _ = e.plan_sql(sql)
    assert not all(j.build_unique for j in _nodes(plan, N.Join))
    got = execute_plan_distributed(e, _force_salt(plan, 4), G8).to_pylist()
    assert [tuple(r) for r in got] == e.execute(sql)


# -- tests/test_connector_partitioning.py ----------------------------------


def test_orderkey_join_skips_exchange(torch_tpch, oracle):
    e = make(torch_tpch, join_distribution_type="PARTITIONED")
    got = e.execute(ORDERKEY_JOIN, mesh=G8)
    assert not {"probe_exch", "build_exch"} & kinds(e)
    check(got, _want(oracle, ORDERKEY_JOIN), ORDERKEY_JOIN)


def test_partitioning_off_restores_exchange(torch_tpch, oracle):
    e = make(torch_tpch, join_distribution_type="PARTITIONED",
             use_connector_partitioning=False)
    got = e.execute(ORDERKEY_JOIN, mesh=G8)
    assert {"probe_exch", "build_exch"} <= kinds(e)
    check(got, _want(oracle, ORDERKEY_JOIN), ORDERKEY_JOIN)


def test_copartitioned_groupby_aggregates_locally(torch_tpch, oracle):
    sql = ("select l_orderkey, sum(l_quantity) as q, count(*) as c "
           "from lineitem group by l_orderkey "
           "order by q desc, l_orderkey limit 10")
    e = make(torch_tpch, partitioned_agg_min_groups=1)
    got = e.execute(sql, mesh=G8)
    assert "agg_exch" not in kinds(e)
    check(got, _want(oracle, sql), sql)


def test_unrelated_keys_still_exchange(torch_tpch, oracle):
    sql = ("select c_mktsegment, count(*) as c from customer, orders "
           "where c_custkey = o_custkey group by c_mktsegment "
           "order by c_mktsegment")
    e = make(torch_tpch, join_distribution_type="PARTITIONED")
    got = e.execute(sql, mesh=G8)
    assert {"probe_exch", "build_exch"} & kinds(e)
    check(got, _want(oracle, sql), sql)


# -- the mesh cases of test_dynamic_filter, test_config, test_functions ----


def test_df_distributed_matches(torch_tpch, oracle):
    e = make(torch_tpch, enable_dynamic_filtering=True,
             join_distribution_type="PARTITIONED")
    check(e.execute(QUERIES["q05"], mesh=G8),
          _want(oracle, QUERIES["q05"]), QUERIES["q05"])


def test_groupby_table_size_overrides_capacity(torch_tpch):
    e = make(torch_tpch, groupby_table_size=1 << 18)
    e.execute("select l_orderkey, count(*) from lineitem "
              "group by l_orderkey", mesh=G8)
    caps = [v for (_, k), v in e.last_dist_meta["used_capacity"].items()
            if k in ("table", "final")]
    assert (1 << 18) in caps, caps


def test_broadcast_join_threshold_flips_distribution(torch_tpch):
    sql = ("select count(*) from lineitem, orders "
           "where l_orderkey = o_orderkey")
    e = make(torch_tpch, broadcast_join_threshold_rows=1,
             use_connector_partitioning=False)
    e.execute(sql, mesh=G8)
    assert "build_exch" in kinds(e)
    e2 = make(torch_tpch, broadcast_join_threshold_rows=1 << 30)
    e2.execute(sql, mesh=G8)
    assert "build_exch" not in kinds(e2)


AGG_SQL = """
  select l_returnflag,
         stddev(l_quantity) as sd, stddev_pop(l_quantity) as sdp,
         variance(l_quantity) as v, var_pop(l_quantity) as vp,
         geometric_mean(l_quantity) as gm,
         count_if(l_quantity > 25) as ci,
         bool_and(l_quantity > 0) as ba, bool_or(l_quantity > 49) as bo,
         approx_distinct(l_suppkey) as ad
  from lineitem group by l_returnflag order by l_returnflag"""


@pytest.mark.parametrize("sql", [
    AGG_SQL,
    "select l_returnflag, corr(l_quantity, l_extendedprice), "
    "covar_samp(l_quantity, l_extendedprice) from lineitem "
    "group by l_returnflag order by l_returnflag",
    "select l_linestatus, skewness(l_quantity), kurtosis(l_quantity) "
    "from lineitem group by l_linestatus order by l_linestatus",
    "select checksum(l_partkey) from lineitem",
], ids=["statistical", "covariance", "moments", "checksum"])
def test_aggregate_states_merge_across_shards(port, sql):
    """The partial states merge through the gather exactly (counts,
    booleans, HLL registers, checksums) or to float64 roundoff (the
    moment sums: rows_equal's float tolerance)."""
    local = port.execute(sql)
    dist = port.execute(sql, mesh=G8)
    check(dist, local, sql)
    if "checksum" in sql:
        assert dist == local


# -- tests/test_statements.py ----------------------------------------------


def _mem_engine(torch_tpch):
    e = make(torch_tpch)
    e.register_catalog("memory", MemoryConnector())
    return e


def test_delete_with_mesh_mask_alignment(torch_tpch):
    e = _mem_engine(torch_tpch)
    e.execute("create table memory.t3 as select o_orderkey from orders")
    n = e.execute("select count(*) from memory.t3")[0][0]
    deleted = e.execute("delete from memory.t3 where o_orderkey % 2 = 0",
                        mesh=G8)[0][0]
    left = e.execute("select count(*) from memory.t3")[0][0]
    assert deleted > 0 and deleted + left == n
    assert e.execute("select count(*) from memory.t3 "
                     "where o_orderkey % 2 = 0") == [(0,)]


def test_ctas_and_update_under_a_mesh(torch_tpch):
    e = _mem_engine(torch_tpch)
    local = _mem_engine(torch_tpch)
    sql = ("create table memory.rev as select o_custkey, "
           "sum(o_totalprice) as total, count(*) as c from orders "
           "group by o_custkey")
    assert e.execute(sql, mesh=G8) == local.execute(sql)
    q = "select * from memory.rev order by o_custkey"
    check(e.execute(q), local.execute(q), q)
    up = "update memory.rev set c = c + 100 where total > 300000"
    assert e.execute(up, mesh=G8) == local.execute(up)
    check(e.execute(q, mesh=G8), local.execute(q), q)


# -- what the eager port adds ----------------------------------------------


@pytest.mark.parametrize("qname", ["q03", "q10", "q18"])
def test_two_shards_equal_eight(port, qname):
    sql = QUERIES[qname]
    check(port.execute(sql, mesh=G2), port.execute(sql, mesh=G8), sql)


def _syncs() -> int:
    return HS.SYNCS.total()


@pytest.mark.parametrize("qname", ["q01", "q05", "q18"])
def test_syncs_do_not_grow_with_the_shard_count(torch_tpch, qname):
    sql = QUERIES[qname]
    counts = {}
    for group in (G2, G8):
        e = make(torch_tpch)
        e.execute(sql, mesh=group)  # the capacities settle
        s0 = _syncs()
        e.execute(sql, mesh=group)
        counts[group.nshards] = _syncs() - s0
        assert e.last_run.rungs == 0
    # the ok flags of the one pass, then the result with the node rows
    assert counts == {2: 2, 8: 2}


def test_repeat_climbs_no_rung_and_uploads_no_scan_column(torch_tpch):
    e = make(torch_tpch, join_distribution_type="PARTITIONED",
             partitioned_agg_min_groups=1, groupby_table_size=16)
    sql = QUERIES["q03"]
    first = e.execute(sql, mesh=G8)
    assert e.last_run.rungs > 0  # the tiny tables overflowed
    up0 = dict(HS.UPLOADS.by_site)
    assert e.execute(sql, mesh=G8) == first
    assert e.last_run.rungs == 0 and e.last_run.from_memory == [True]
    grew = {k: v - up0.get(k, 0) for k, v in HS.UPLOADS.by_site.items()
            if v != up0.get(k, 0)}
    assert "scan-column" not in grew and "shard-order" not in grew, grew


def test_capacities_are_kept_apart_per_shard_count(torch_tpch):
    e = make(torch_tpch, partitioned_agg_min_groups=1,
             groupby_table_size=16)
    sql = QUERIES["q18"]
    e.execute(sql, mesh=G8)
    assert e.execute(sql, mesh=G8) and e.last_run.from_memory == [True]
    # 2 shards start from nothing learned over 8
    e.execute(sql, mesh=G2)
    assert e.last_run.from_memory == [False]
    assert len({k[6] for k in e._caps_memory if len(k) > 6
                and k[5] == "distributed"}) == 2


def test_bucketed_scan_placement_is_kept_per_table(torch_tpch):
    e = make(torch_tpch, join_distribution_type="PARTITIONED")
    up0 = HS.UPLOADS.by_site.get("shard-order", 0)
    e.execute(ORDERKEY_JOIN, mesh=G8)
    first = HS.UPLOADS.by_site.get("shard-order", 0) - up0
    assert first == 2 * 2 * 8  # orders and lineitem: indices, live masks
    e.execute(ORDERKEY_JOIN, mesh=G8)
    assert HS.UPLOADS.by_site.get("shard-order", 0) - up0 == first


def test_kernel_notes_and_node_rows_over_shards(port):
    port.execute(QUERIES["q05"], mesh=G8)
    notes = {t for tags in port.last_kernel_notes.values() for t in tags}
    assert {"torch:agg_sum", "torch:multijoin"} <= notes
    rows = dict(port.last_run.node_rows)
    assert set(rows) == {(0, pos) for pos in
                         port.last_dist_meta["node_dist"]}
    # the root's group-wide rows are the result's
    assert rows[(0, 0)] == len(port.execute(QUERIES["q05"]))
    port.execute(QUERIES["q05"], mesh=G8)
    assert port.last_run.node_rows == rows


def test_chip_smoke_distributed_cases_on_the_cpu(torch_tpch, zipf, port,
                                                monkeypatch):
    """Phase 9 of chip_smoke.py at SF0.01 over LocalShardGroup(8,
    "cpu") with the plain versions (its card calls stubbed): every
    case's checks hold against the local rows, and the phase reaches
    agg_sum, join_lookup and multijoin. The launch counts need the
    card."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    local = {q: port.execute(chip_smoke.QUERIES[q]) for q in
             chip_smoke.DIST_QUERIES + ("lineitem_partsupp",)}
    out = chip_smoke.distributed_cases(torch_tpch, zipf, "torch", local,
                                       {}, device="cpu")
    assert {"torch:agg_sum", "torch:join_lookup",
            "torch:multijoin"} <= set(out["notes"])
    assert set(chip_smoke.DIST_QUERIES) <= set(out)


# -- ARRAY values across shards --------------------------------------------


@pytest.fixture(scope="module")
def arrays_engine():
    return memory_engine(Engine(device="cpu"), MemoryConnector(), T,
                         {"t": random_arrays(T)})


def _canon(rows):
    return sorted(repr(r) for r in rows)


@pytest.mark.parametrize("name", ["subscripts", "reshapes", "unnest",
                                  "unnest_aggregate", "strings"])
def test_array_queries_under_a_mesh(arrays_engine, name):
    sql = RANDOM_SQL[name]
    assert _canon(arrays_engine.execute(sql, mesh=G8)) == \
        _canon(arrays_engine.execute(sql))


@pytest.mark.parametrize("dist", ["PARTITIONED", "BROADCAST"])
def test_arrays_cross_the_exchanges(arrays_engine, dist):
    """An ARRAY's lengths and element mask ride every exchange: a
    repartitioned self-join, a gather and a merge sort."""
    arrays_engine.session.set("join_distribution_type", dist)
    try:
        sql = ("select t1.k, t1.a, t2.s, cardinality(t2.f) from t t1 "
               "join t t2 on t1.k = t2.k where t1.k % 3 <> 1 "
               "order by t1.k")
        got = arrays_engine.execute(sql, mesh=G8)
        assert got == arrays_engine.execute(sql)
        assert len(got) == 32
        if dist == "PARTITIONED":
            assert "build_exch" in kinds(arrays_engine)
    finally:
        arrays_engine.session.set("join_distribution_type", "AUTOMATIC")
