"""Segmented execution in the port (exec/executor.py), held against
presto_tpu on the same plans: the subtrees that ``_find_split``
materializes, wave by wave, on every TPC-H query and a set of TPC-DS
queries (the reference's own ``_segment_carriers`` walked with a runner
that runs nothing); the carrier widths ``device_outputs`` chooses;
rows equal to presto_tpu and sqlite with both cuts forced; and a
capacity overflow in the last program re-running that program alone.
TPC-H at SF0.01, TPC-DS at scale 0.003."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import types as RT
from presto_tpu.connectors.tpcds import TpcdsConnector as RefTpcds
from presto_tpu.exec import executor as REX
from presto_tpu.exec import progcache as RPC
from presto_tpu_torch.testing.oracle import assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import executor as EX
from presto_tpu_torch.exec.operators import DTable
from presto_tpu_torch.expr.compile import Val

from test_tpcds import QUERIES as TPCDS
from tpch_queries import QUERIES

# multi-wave and multi-segment TPC-DS plans at scale 0.003
TPCDS_SPLITS = ["q02", "q05", "q10", "q23", "q24", "q58", "q75", "q77",
                "q83", "q88"]
# the queries run with both cuts forced (q19 and q21 take the reference
# over 10 s to compile, tests/test_tpch.py)
FORCED = ["q02", "q03", "q05", "q07", "q08", "q09", "q10", "q11", "q13",
          "q16", "q18", "q20", "q22"]


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


@pytest.fixture(scope="module")
def tpcds_pair():
    ref = RefEngine()
    ref.register_catalog("tpcds", RefTpcds(scale=0.003))
    ref.session.catalog = "tpcds"
    port = TorchEngine(device="cpu")
    port.register_catalog("tpcds", TpcdsConnector(scale=0.003))
    port.session.catalog = "tpcds"
    return ref, port


class _Planned(Exception):
    pass


def executed_plan(engine, executor, sql):
    """The plan ``engine.execute(sql)`` hands to ``execute_plan``, which
    is stopped before it runs anything."""
    plans = []

    def stop(_engine, plan):
        plans.append(plan)
        raise _Planned

    orig = executor.execute_plan
    executor.execute_plan = stop
    try:
        engine.execute(sql)
    except _Planned:
        pass
    finally:
        executor.execute_plan = orig
    return plans[0]


def reference_waves(engine, plan, monkeypatch):
    """The reference's ``_segment_carriers`` over ``plan`` with a
    runner that runs nothing: (the plan that remains, the materialized
    subtrees per wave, as its wave pool receives them)."""
    waves = []

    def serial(fn, items, _width):
        waves.append([mat for _i, mat in items])
        return [fn(it) for it in items]

    def runner(_engine, mat, _scans, cap_floor=None):
        types = dict(mat.output_types())
        return ({s: np.zeros(1) for s in types}, dict.fromkeys(types),
                types, 1, None)

    monkeypatch.setattr(RPC, "map_parallel", serial)
    try:
        rest, _carriers = REX._segment_carriers(engine, plan, "split-test",
                                                runner=runner)
    finally:
        engine.memory_pool.free("split-test")
    return rest, waves


def _signature(waves):
    return [[(type(m).__name__, tuple(m.output_symbols)) for m in w]
            for w in waves]


def _assert_same_splits(ref, port, sql, monkeypatch):
    rest, waves = reference_waves(
        ref, executed_plan(ref, REX, sql), monkeypatch)
    prest, pwaves = EX._plan_segments(executed_plan(port, EX, sql), port)
    assert _signature([[m for m, _c in w] for w in pwaves]) == \
        _signature(waves)
    assert prest.output_symbols == rest.output_symbols
    return waves


def _force_agg_cut(monkeypatch, on: bool):
    if on:
        monkeypatch.setattr(REX, "AGG_SPLIT_MIN_ROWS", 0)
        monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)


@pytest.mark.parametrize("agg_cut", [False, True],
                         ids=["default", "agg_cut"])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_tpch_splits_equal_reference(qname, agg_cut, engine, port,
                                     monkeypatch):
    _force_agg_cut(monkeypatch, agg_cut)
    _assert_same_splits(engine, port, QUERIES[qname], monkeypatch)


@pytest.mark.parametrize("agg_cut", [False, True],
                         ids=["default", "agg_cut"])
@pytest.mark.parametrize("qname", TPCDS_SPLITS)
def test_tpcds_splits_equal_reference(qname, agg_cut, tpcds_pair,
                                      monkeypatch):
    _force_agg_cut(monkeypatch, agg_cut)
    ref, port = tpcds_pair
    waves = _assert_same_splits(ref, port, TPCDS[qname], monkeypatch)
    assert waves  # each of these plans segments at scale 0.003


@pytest.mark.parametrize("n,live_rows", [
    (1000, 0), (1000, 1), (1000, 100), (1000, 128), (1000, 129),
    (1000, 300), (1000, 600), (100, 10), (256, 128), (4096, 2048),
    (4096, 2049), (1 << 16, 5000)])
def test_device_outputs_widths_equal_reference(n, live_rows):
    rng = np.random.default_rng(n + live_rows)
    live = np.zeros(n, dtype=bool)
    live[rng.choice(n, live_rows, replace=False)] = True
    data = rng.integers(-10**12, 10**12, n)
    valid = rng.random(n) < 0.9
    meta = {"out": [("x", RT.BIGINT, None, True)]}
    ref_arrays, _d, _t, ref_n = REX.device_outputs(
        meta, [jnp.asarray(data), jnp.asarray(valid)], jnp.asarray(live))

    limbs = rng.integers(-2**62, 2**62, (n, 2))
    dt = DTable({
        "x": Val(T.BIGINT, torch.from_numpy(data),
                 torch.from_numpy(valid)),
        "d": Val(T.DecimalType(30, 2), torch.from_numpy(limbs)),
        "k": Val(T.BIGINT, torch.tensor(7)),  # a projected literal
    }, torch.from_numpy(live), n, torch.device("cpu"))
    arrays, _dicts, types, got_n, got_live, _counts = EX.device_outputs(dt)
    assert got_n == ref_n
    assert types["d"] == T.DecimalType(30, 2)
    rows = np.asarray(ref_arrays["__live__"])
    assert np.array_equal(got_live.numpy() if got_live is not None
                          else np.ones(got_n, bool), rows)
    for name, want in (("x", data[live]), ("x$valid", valid[live]),
                       ("d", limbs[live]),
                       ("k", np.full(live_rows, 7))):
        assert arrays[name].shape[0] == got_n
        assert np.array_equal(arrays[name].numpy()[rows], want), name
    assert np.array_equal(np.asarray(ref_arrays["x"])[rows], data[live])


@pytest.mark.parametrize("qname", FORCED)
def test_rows_with_both_cuts_forced(qname, port, engine, oracle,
                                    monkeypatch):
    monkeypatch.setattr(EX, "MAX_JOINS_PER_PROGRAM", 1)
    monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)
    got = port.execute(QUERIES[qname])
    assert port.last_run.segments, "no segment materialized"
    assert len(port.last_run.programs) == \
        1 + sum(len(w) for w in port.last_run.segments)
    assert got == engine.execute(QUERIES[qname])
    assert_query(port, oracle, QUERIES[qname])


def test_overflow_in_the_last_program_reruns_it_alone(port, monkeypatch):
    # q10's joins become one segment; its group-by by customer runs in
    # the last program, where a 64-group table overflows
    monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)
    want = port.execute(QUERIES["q10"])
    assert port.last_run.passes == [1, 1]
    port.session.set("groupby_table_size", 64)
    try:
        got = port.execute(QUERIES["q10"])
    finally:
        port.session.set("groupby_table_size", 0)
    run = port.last_run
    assert len(run.segments) == 1 and len(run.passes) == 2
    assert run.passes[0] == 1 and run.passes[1] > 1
    assert run.rungs == run.passes[1] - 1
    assert got == want


def test_run_plan_live_counts_the_result_rows(port, monkeypatch):
    monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)
    sql = QUERIES["q18"]
    rows = port.execute(sql)
    plan = executed_plan(port, EX, sql)
    live = EX.run_plan_live(port, plan)
    assert port.last_run.segments
    assert int(live.sum()) == len(rows)


def test_carriers_resolve_by_name_never_by_catalog(port, monkeypatch):
    # every scan of a segmented plan resolves: connector tables by their
    # catalog, carriers by identity or name (no "__segment__" catalog)
    monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)
    assert "__segment__" not in port.catalogs
    plan = executed_plan(port, EX, QUERIES["q21"])
    rest, waves = EX._plan_segments(plan, port)
    assert [len(w) for w in waves] == [4, 2, 1]
    got = port.execute(QUERIES["q21"])
    assert len(port.last_run.programs) == 8
    assert got and port.last_run.rungs == 0
