"""Cross-query batching (presto_tpu_torch/exec/batch.py) and the
kernels' lane axis (kernels/lanes.py), held against the port's serial
runs and against presto_tpu's ``run_plan_batched``, at SF0.01 on the
plain kernels; and the per-thread query records of the engine.

The variants are chip_smoke's phase-11 cases (``batch_variants``): Q6
and Q1 date/discount variants (segment_sum), a min/max variant
(segment_max/min), a lineitem-partsupp join (join_lookup), a Q5 region
variant (the multijoin walk, a VARCHAR parameter) and a cross join
(compaction per lane). Every lane of a batch of K = 2, 3 (padded to 4)
and 8 equals the port's serial run byte for byte, and the reference's
batched lane (floats within 1e-9 relative, all else exact). Each
kernel's plain rule runs once per batched operator: a group of K
calls each kernel entry as often as ONE serial run does.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.exec import batch as RB
from presto_tpu.templates.analysis import parameterize as ref_parameterize

import chip_smoke as CS
from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import kernels as K
from presto_tpu_torch import templates as TPL
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import batch as B
from presto_tpu_torch.obs.metrics import REGISTRY


def assert_rows_match(got, want, rel=1e-9):
    """Rows equal value for value; floats within ``rel`` relative."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, (float, np.floating)) and isinstance(
                    b, (float, np.floating)):
                assert abs(a - b) <= rel * max(abs(a), abs(b)), (g, w)
            else:
                assert a == b, (g, w)

SF = 0.01
CASES = tuple(CS.BATCH_KERNELS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port():
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(scale=SF))
    return e


@pytest.fixture(scope="module")
def ref(tpch_tiny):
    e = RefEngine()
    e.register_catalog("tpch", tpch_tiny)
    return e


def _templates(engine, sqls, parameterize):
    return [parameterize(engine.plan_sql(s)[0]) for s in sqls]


def _columns(table):
    """A host Table's live rows per column: (dtype, data bytes, valid)."""
    live = (np.ones(table.nrows, bool) if table.mask is None
            else np.asarray(table.mask))
    out = {}
    for name, col in table.columns.items():
        data = np.asarray(col.data)[live]
        valid = None if col.valid is None else np.asarray(col.valid)[live]
        out[name] = (str(col.dtype), data.dtype.str,
                     data.tobytes() if data.dtype != object
                     else list(data),
                     None if valid is None else valid.tobytes())
    return out


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_lanes_equal_serial_and_reference(port, ref, case, k):
    sqls = CS.batch_variants(case, SF, k)
    tpls = _templates(port, sqls, TPL.parameterize)
    assert B.batchable(port, tpls[0].plan)
    assert len({t.fingerprint() for t in tpls}) == 1
    got = B.run_plan_batched(port, tpls)
    want = RB.run_plan_batched(ref, _templates(ref, sqls,
                                               ref_parameterize))
    assert len(got) == len(want) == k
    for sql, lane, ref_lane in zip(sqls, got, want):
        serial = port.execute_table(sql)
        assert _columns(lane) == _columns(serial), sql
        assert_rows_match(lane.to_pylist(), ref_lane.to_pylist())


def _count_plain_calls(monkeypatch) -> dict:
    calls = {name: 0 for name in K.KERNELS}
    for name, impls in K.KERNELS.items():
        def counted(*args, _impl=impls["torch"], _name=name, **kw):
            calls[_name] += 1
            return _impl(*args, **kw)
        monkeypatch.setitem(impls, "torch", counted)
    return calls


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_plain_rule_runs_once_per_batched_operator(port, monkeypatch,
                                                   case, k):
    calls = _count_plain_calls(monkeypatch)
    sqls = CS.batch_variants(case, SF, k)
    port.execute_table(sqls[0])
    serial = dict(calls)
    assert any(serial.values()), case
    for name in calls:
        calls[name] = 0
    B.run_plan_batched(port, _templates(port, sqls, TPL.parameterize))
    assert calls == serial, (case, k)


def test_batched_counters(port):
    total = REGISTRY.counter("presto_tpu_batched_queries_total")
    before = total.value()
    B.run_plan_batched(port, _templates(
        port, CS.batch_variants("q06", SF, 3), TPL.parameterize))
    assert total.value() == before + 3
    assert "presto_tpu_batch_size_queries" in REGISTRY.render()


def test_ladder_grows_when_one_lane_overflows(port):
    """A group table of 16 slots holds every lane's groups but the
    last one's: that lane alone overflows, the table grows for the
    batch, and every lane equals its serial run."""
    sqls = [f"select l_orderkey, count(*) as c from lineitem "
            f"where l_orderkey < {n} group by l_orderkey "
            "order by l_orderkey" for n in (5, 7, 9, 3000)]
    with port.session.as_user(port.session.user,
                              {"groupby_table_size": 16}):
        got = B.run_plan_batched(port, _templates(port, sqls,
                                                  TPL.parameterize))
        assert port.last_run.passes[0] > 1
        for sql, lane in zip(sqls, got):
            assert _columns(lane) == _columns(port.execute_table(sql))
    assert len(got[-1].to_pylist()) > 16


def test_query_records_are_per_thread():
    """Two threads run queries on one engine at the same time: one
    with a cross-join warning, one without. Each thread reads its own
    query's warnings and programs afterwards (the engine's last_*
    records are per thread)."""
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(scale=SF))
    e.session.catalog = "tpch"
    done = threading.Barrier(2)
    seen: dict = {}
    errors: list = []

    def run(name, sql):
        try:
            for _ in range(3):
                e.execute(sql)
                done.wait(timeout=60)
                seen[name] = ([w.name for w in e.last_warnings],
                              list(e.last_run.programs), e.last_backend,
                              dict(e.last_kernel_notes))
                done.wait(timeout=60)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)
            done.abort()

    threads = [threading.Thread(target=run, args=(
        "cross", "select count(*) from nation, region")),
        threading.Thread(target=run, args=(
            "plain", "select l_returnflag, count(*) from lineitem "
                     "group by l_returnflag"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert "PERFORMANCE_WARNING" in seen["cross"][0]
    assert seen["plain"][0] == []
    assert seen["cross"][1] != seen["plain"][1]
    scans = {name: {n.table for p in progs for n in _scans(p)}
             for name, (_w, progs, _b, _n) in seen.items()}
    assert scans == {"cross": {"nation", "region"},
                     "plain": {"lineitem"}}
    assert seen["plain"][2] == seen["cross"][2] == "torch"
    assert any("torch:agg_sum" in tags
               for tags in seen["plain"][3].values())


def _scans(plan):
    from presto_tpu_torch.plan import nodes as N
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, N.TableScan):
            yield node
        stack.extend(node.sources())


def test_offer_take_preplanned_is_one_shot_per_thread(port):
    sql = "select count(*) from nation"
    plan, _ = port.plan_sql(sql)
    port.offer_preplanned(sql, plan)
    other: list = []
    t = threading.Thread(target=lambda: other.append(
        port.take_preplanned(sql)))
    t.start()
    t.join()
    assert other == [None]
    assert port.take_preplanned("select 1") is None  # consumed
    port.offer_preplanned(sql, plan)
    assert port.take_preplanned(sql) is plan
    assert port.take_preplanned(sql) is None
    port.offer_preplanned(sql, plan)
    assert port.execute_table(sql).to_pylist() == [(25,)]
    assert port.take_preplanned(sql) is None
