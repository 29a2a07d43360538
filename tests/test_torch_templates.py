"""The port's plan templates, program cache and capacity memory
(presto_tpu_torch/templates/, exec/progcache.py, plan/fingerprint.py),
and PREPARE / EXECUTE ... USING / DEALLOCATE, held against presto_tpu:
the engine-level cases of tests/test_templates.py at SF0.01 (not the
HTTP and serve-mode ones), where the reference counts compiled
programs and the port counts program-cache hits and capacity rungs.
``plan_fingerprint`` of the port's optimized plan, and of its template,
equals the reference's for every TPC-H query; a repeat query and a
literal variant take 0 rungs, their capacities from memory; rows equal
presto_tpu's and a fresh untemplated engine's."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.plan.fingerprint import plan_fingerprint as ref_fingerprint
from presto_tpu.templates.analysis import parameterize as ref_parameterize

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import templates as TPL
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import progcache as PC
from presto_tpu_torch.exec.executor import collect_scans
from presto_tpu_torch.plan.fingerprint import plan_fingerprint
from presto_tpu_torch.templates.analysis import (HOISTABLE_CALL_FNS,
                                                 parameterize)

from tpch_queries import QUERIES

REPO = Path(__file__).resolve().parents[1]

Q3_VARIANT = ("1995-03-15", "1995-03-22")
Q5_VARIANT = ("ASIA", "EUROPE")
Q6_VARIANT = ("0.05 and 0.07", "0.03 and 0.05")
Q18_VARIANT = ("> 300", "> 312")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_reference_ledger(monkeypatch):
    """The reference's cost model reads a process-wide ledger of what
    earlier queries observed (``presto_tpu.obs.qstats.DIVERGENCE``), so
    its plans depend on which tests ran before in the same process; the
    port has no such ledger yet (ROADMAP item 7). Each test plans the
    reference against an empty one."""
    from presto_tpu.obs import qstats
    monkeypatch.setattr(qstats, "DIVERGENCE", qstats.DivergenceLedger())


@pytest.fixture(scope="module")
def torch_tpch():
    return TorchTpch(scale=0.01)


def port_engine(torch_tpch, templates: bool = True) -> TorchEngine:
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tpch)
    if not templates:
        e.session.set("plan_templates", False)
    return e


@pytest.fixture(scope="module")
def ref(tpch_tiny):
    e = RefEngine()
    e.register_catalog("tpch", tpch_tiny)
    return e


def _hits() -> float:
    return TPL._TPL_HITS.value()


def _misses() -> float:
    return TPL._TPL_MISSES.value()


# -- fingerprints against the reference --------------------------------------


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_fingerprints_equal_reference(ref, torch_tpch, qname):
    # the optimized plan and its template hash alike in both packages:
    # the walk reads field names, type names and reprs only
    rplan, _ = ref.plan_sql(QUERIES[qname])
    plan, _ = port_engine(torch_tpch).plan_sql(QUERIES[qname])
    assert plan_fingerprint(plan) == ref_fingerprint(rplan)
    rtpl, tpl = ref_parameterize(rplan), parameterize(plan)
    assert (tpl is None) == (rtpl is None)
    if tpl is not None:
        assert tpl.fingerprint() == rtpl.fingerprint()
        assert [(str(p.dtype), p.value) for p in tpl.params] == \
            [(str(p.dtype), p.value) for p in rtpl.params]


def test_bound_values_equal_reference(ref, torch_tpch):
    # the physical encoding of each parameter (a VARCHAR one as its code
    # in the compared column's dictionary) equals the reference's
    sql = ("select count(*) from lineitem where l_quantity < 24 and "
           "l_shipdate > date '1995-06-01' and l_extendedprice > 1000.5 "
           "and l_returnflag = 'R'")
    rtpl = ref_parameterize(ref.plan_sql(sql)[0])
    tpl = parameterize(port_engine(torch_tpch).plan_sql(sql)[0])
    flag = torch_tpch.table("lineitem").columns["l_returnflag"].dictionary
    strings = {i: flag for i, p in enumerate(tpl.params)
               if isinstance(p.dtype, T.VarcharType)}
    assert strings
    got, want = tpl.bind(strings), rtpl.bind(strings)
    assert [np.asarray(g).tolist() for g in got] == \
        [np.asarray(w).tolist() for w in want]
    assert [np.asarray(g).dtype for g in got] == \
        [np.asarray(w).dtype for w in want]


# -- analysis ----------------------------------------------------------------


def test_parameterize_hoists_values_out_of_fingerprint(torch_tpch):
    e = port_engine(torch_tpch)
    base = ("select count(*) from lineitem "
            "where l_quantity < {} and l_shipdate > date '{}'")
    t1 = parameterize(e.plan_sql(base.format(10, "1995-03-15"))[0])
    t2 = parameterize(e.plan_sql(base.format(24, "1995-06-01"))[0])
    assert t1 is not None and t2 is not None
    assert t1.fingerprint() == t2.fingerprint()
    assert [s.dtype for s in t1.params] == [s.dtype for s in t2.params]
    assert [s.value for s in t1.params] != [s.value for s in t2.params]


def test_parameterize_hoists_varchar_equality(torch_tpch):
    p, _ = port_engine(torch_tpch).plan_sql(
        "select count(*) from region where r_name = 'ASIA'")
    t = parameterize(p)
    assert t is not None
    assert any(isinstance(s.dtype, T.VarcharType) for s in t.params)


def test_structural_literals_stay_baked(torch_tpch):
    # LIKE patterns are evaluated over the dictionary on the host: their
    # literals never hoist
    e = port_engine(torch_tpch)

    def fp(sql):
        plan, _ = e.plan_sql(sql)
        t = parameterize(plan)
        return t.fingerprint() if t is not None else plan_fingerprint(plan)

    assert fp("select count(*) from region where r_name like 'A%'") != \
        fp("select count(*) from region where r_name like 'E%'")


# -- literal variants: a template hit, 0 rungs, the right rows ---------------


def _variant_pair(name):
    sql = QUERIES[name]
    old, new = {"q03": Q3_VARIANT, "q05": Q5_VARIANT, "q06": Q6_VARIANT,
                "q18": Q18_VARIANT}[name]
    assert old in sql
    return sql, sql.replace(old, new)


@pytest.mark.parametrize("name", ["q03", "q05", "q06", "q18"])
def test_variant_hits_template_and_matches_oracle(ref, torch_tpch, name):
    """After a first run, the same query with other literals hits the
    template (its programs' entries and capacities) and returns rows
    equal to a fresh untemplated engine's and the reference's."""
    base, variant = _variant_pair(name)
    e = port_engine(torch_tpch)
    e.execute(base)
    h0 = _hits()
    got = e.execute(variant)
    assert _hits() > h0
    assert all(e.last_run.from_memory) and e.last_run.rungs == 0
    assert got == port_engine(torch_tpch, templates=False).execute(variant)
    assert got == ref.execute(variant)


@pytest.mark.parametrize("qname", ["q05", "q09", "q18", "q21"])
def test_repeat_query_takes_no_rungs(torch_tpch, qname):
    # the first run may climb; the second starts every program from the
    # capacities the first remembered
    e = port_engine(torch_tpch)
    e.session.set("groupby_table_size", 16)  # force a first-run ladder
    first = e.execute(QUERIES[qname])
    first_rungs = e.last_run.rungs
    again = e.execute(QUERIES[qname])
    assert again == first
    assert e.last_run.rungs == 0
    assert all(e.last_run.from_memory)
    assert len(e.last_run.passes) == len(e.last_run.from_memory)
    if qname in ("q09", "q18"):  # their group-bys overflow 16 slots
        assert first_rungs > 0


def test_rungs_stay_honest_without_memory(torch_tpch):
    # a program whose key changed starts from its hints again, and its
    # rungs count the passes that overflowed
    e = port_engine(torch_tpch)
    e.session.set("groupby_table_size", 16)
    e.execute(QUERIES["q18"])
    assert e.last_run.rungs > 0 and not any(e.last_run.from_memory)
    e.session.set("groupby_table_size", 32)  # a session key component
    e.execute(QUERIES["q18"])
    assert not any(e.last_run.from_memory)


def test_structural_limit_change_misses(torch_tpch):
    # LIMIT is a plan-node count, not an expression literal
    e = port_engine(torch_tpch)
    base = ("select l_orderkey from lineitem "
            "where l_quantity < 10 order by l_orderkey limit {}")
    e.execute(base.format(5))
    m0, h0 = _misses(), _hits()
    got = e.execute(base.format(7))
    assert _misses() > m0 and _hits() == h0
    assert got == port_engine(torch_tpch, templates=False).execute(
        base.format(7))
    assert len(got) == 7


def test_absent_string_literal_matches_nothing(torch_tpch):
    e = port_engine(torch_tpch)
    sql = "select count(*) from region where r_name = '{}'"
    e.execute(sql.format("ASIA"))
    h0 = _hits()
    assert e.execute(sql.format("ATLANTIS")) == [(0,)]
    assert _hits() > h0


def test_disable_via_session_property(torch_tpch):
    e = port_engine(torch_tpch, templates=False)
    sql = "select count(*) from nation where n_regionkey = {}"
    e.execute(sql.format(0))
    before = e._program_cache.stats()
    h0 = _hits()
    assert e.execute(sql.format(2)) == [(5,)]
    after = e._program_cache.stats()
    # literals stay in the plan: the variant is another entry
    assert after["misses"] > before["misses"]
    assert after["hits"] == before["hits"] and _hits() == h0


def test_template_metrics_and_params_gauge(torch_tpch):
    e = port_engine(torch_tpch)
    sql = "select count(*) from nation where n_regionkey = {}"
    m0, h0 = _misses(), _hits()
    e.execute(sql.format(1))
    assert _misses() > m0
    e.execute(sql.format(3))
    assert _hits() > h0
    assert TPL._TPL_PARAMS.value() >= 1


def test_program_cache_is_bounded(torch_tpch):
    e = port_engine(torch_tpch, templates=False)
    e.session.set("program_cache_entries", 2)
    for k in range(4):
        e.execute(f"select count(*) from nation where n_regionkey = {k}")
    stats = e._program_cache.stats()
    assert stats["entries"] == 2 and stats["max_entries"] == 2
    assert stats["evictions"] >= 2


# -- shapes ------------------------------------------------------------------


def test_shape_bucketing_shares_entries_as_table_grows():
    # a table growing inside its pow2 bucket keeps its entry and its
    # capacities; the rows stay exact (the columns are not padded)
    conn = MemoryConnector()
    conn.create_table("t", {"k": T.BIGINT, "v": T.BIGINT},
                      {"k": np.arange(900) % 7, "v": np.arange(900)})
    e = TorchEngine(device="cpu")
    e.register_catalog("mem", conn)
    e.session.catalog = "mem"
    got_a = e.execute("select sum(v) from t where k < 3")
    before = e._program_cache.stats()
    conn.insert("t", {"k": np.arange(900, 1000) % 7,
                      "v": np.arange(900, 1000)})  # still in 1024
    got_b = e.execute("select sum(v) from t where k < 3")
    assert e._program_cache.stats()["hits"] > before["hits"]
    assert all(e.last_run.from_memory)

    def want(n):
        return int(np.arange(n)[np.arange(n) % 7 < 3].sum())

    assert got_a == [(want(900),)]
    assert got_b == [(want(1000),)]
    assert e.catalogs["mem"].table("t").nrows == 1000


def test_shape_bucketing_respects_session_toggle(torch_tpch):
    e = port_engine(torch_tpch)
    plan, _ = e.plan_sql("select count(*) from nation")
    scans = list(collect_scans(plan, e).values())
    n = scans[0].nrows
    assert TPL.shape_bucketing(e.session)
    bucketed = TPL.scan_shape_key(scans, True)
    assert {shape[0] for _s, shape, _d in bucketed} == {32}
    assert n == 25
    e.session.set("template_shape_bucketing", False)
    assert not TPL.shape_bucketing(e.session)
    assert {shape[0] for _s, shape, _d in
            TPL.scan_shape_key(scans, False)} == {25}


def test_dictionary_contents_enter_the_key():
    a = np.array(["x", "y"], dtype=object)
    b = np.array(["x", "z"], dtype=object)
    assert PC.dictionary_token(a) != PC.dictionary_token(b)
    assert PC.dictionary_token(a) == PC.dictionary_token(a.copy())
    assert PC.dictionary_token(None) is None


# -- PREPARE / EXECUTE -------------------------------------------------------


def test_prepare_execute_engine_roundtrip(ref, torch_tpch):
    e = port_engine(torch_tpch)
    e.execute("prepare q from select count(*) from lineitem "
              "where l_quantity < ? and l_shipdate > ?")
    r1 = e.execute("execute q using 10, date '1995-03-15'")
    h0 = _hits()
    r2 = e.execute("execute q using 24, date '1995-06-01'")
    assert _hits() > h0  # EXECUTE variants share one template
    literal = ("select count(*) from lineitem "
               "where l_quantity < 24 and l_shipdate > date '1995-06-01'")
    assert r2 == port_engine(torch_tpch, templates=False).execute(literal)
    assert r2 == ref.execute(literal)
    assert r1 != r2
    e.execute("deallocate prepare q")
    with pytest.raises(ValueError, match="not found"):
        e.execute("execute q using 1, date '1995-01-01'")
    with pytest.raises(ValueError, match="not found"):
        e.execute("deallocate prepare q")


def test_execute_arity_and_literal_checks(torch_tpch):
    e = port_engine(torch_tpch)
    e.execute("prepare p from select count(*) from nation "
              "where n_regionkey = ?")
    with pytest.raises(ValueError, match="parameter"):
        e.execute("execute p using 1, 2")
    with pytest.raises(ValueError, match="literal"):
        e.execute("execute p using n_regionkey")
    assert e.execute("execute p using 1") == [(5,)]


def test_question_mark_inside_string_is_not_a_marker(torch_tpch):
    e = port_engine(torch_tpch)
    e.execute("prepare ps from select count(*) from region "
              "where r_name = '?' or r_name = ?")
    assert e.execute("execute ps using 'ASIA'") == [(1,)]


def test_execute_table_resolves_prepared(torch_tpch):
    e = port_engine(torch_tpch)
    e.execute("prepare pt from select n_name from nation "
              "where n_nationkey = ?")
    tbl = e.execute_table("execute pt using 7")
    assert tbl.to_pylist() == e.execute(
        "select n_name from nation where n_nationkey = 7")


def test_execute_cannot_smuggle_guarded_statements(torch_tpch):
    # EXECUTE resolves to the statement it names before anything looks
    # at it: a prepared transaction statement meets the same checks as
    # a direct one, and a prepared EXECUTE is not resolved twice
    from presto_tpu_torch.transaction import TransactionError
    e = port_engine(torch_tpch)
    e.execute("prepare tx from start transaction")
    e.execute("start transaction")
    with pytest.raises(TransactionError, match="already in progress"):
        e.execute("execute tx")
    e.execute("rollback")
    e.execute("execute tx")
    with pytest.raises(TransactionError, match="already in progress"):
        e.execute("start transaction")
    e.execute("rollback")
    e.execute("prepare inner from select 1")
    e.execute("prepare outer from execute inner")
    with pytest.raises(NotImplementedError, match="ExecutePrepared"):
        e.execute("execute outer")
    e.execute("prepare pp from prepare leaked from select 1")
    e.execute("execute pp")
    assert e.session.prepared_statements["leaked"] == "select 1"


# -- the hoistable set against the port's compiler ---------------------------


def _scalar_fns_reading_ir() -> set:
    """Scalar fns of the port's expr/compile.py whose body reads
    ``e.args``: literal arguments consumed on the host."""
    path = REPO / "presto_tpu_torch" / "expr" / "compile.py"
    out: set = set()
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, ast.FunctionDef):
            continue
        names = [d.args[0].value for d in node.decorator_list
                 if isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                 and d.func.id == "scalar" and d.args
                 and isinstance(d.args[0], ast.Constant)]
        if names and any(isinstance(sub, ast.Attribute)
                         and sub.attr == "args"
                         and isinstance(sub.value, ast.Name)
                         and sub.value.id == "e"
                         for sub in ast.walk(node)):
            out.update(names)
    return out


def test_hoistable_fns_never_read_ir_args():
    readers = _scalar_fns_reading_ir()
    assert readers, "no IR-reading scalars found: the scan drifted"
    assert not readers & set(HOISTABLE_CALL_FNS), sorted(
        readers & set(HOISTABLE_CALL_FNS))
