"""Mid-query adaptive re-planning + speculative straggler re-dispatch in
the port (presto_tpu_torch/parallel/adaptive.py, cost/adapt.py,
ft/speculate.py): the counterparts of tests/test_adaptive.py over
workers on device="cpu".

The reference's acceptance run is timing-bound (ROADMAP R11): here it
is held on rows (the sqlite oracle and the static run), on the
capacity-overflow counter (the static run pays rungs, as the
reference's does; the adaptive run pays no more, all of them the
expanding join's output rung, where the reference's pays none: ROADMAP
P12) and on the re-plan's records (``last_distribution``, the annotated
plan, ``system.adaptive_decisions``), without the wall-time comparison.

The within-query feedback-loop acceptance suite:

- a ledger poisoned with a materially wrong selectivity makes the CBO
  under-plan a TASK-mode query (broadcast where partitioned belongs,
  undersized expanding-join output capacity); the STATIC plan pays
  capacity-overflow retry rungs (recompiles, now counted in
  ``presto_tpu_capacity_overflow_retries_total``) while the ADAPTIVE
  run re-plans the remainder after the divergent stage — zero
  overflow rungs, a broadcast->partitioned flip audited in
  ``system.adaptive_decisions`` and rendered as ``[replanned: ...]``
  — and stays byte-identical to the sqlite oracle either way;
- a seeded ``exchange-fetch-delay`` straggler fault makes one stage
  task stall: speculation dispatches a duplicate attempt on another
  worker, the duplicate WINS, results are byte-identical to the
  fault-free run, and the loser's task is cleaned up with zero leaked
  buffers or spool files;
- unit coverage for the arbiter, the overlay re-costing, remainder
  substitution, and the exact-id task DELETE that keeps a losing
  primary from prefix-wiping its winning duplicate.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest
import torch

from presto_tpu_torch.sql.parser import parse_statement
from presto_tpu_torch.sql.sqlite_dialect import to_sqlite
from presto_tpu_torch.testing.oracle import rows_equal

from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.ft import speculate as SPEC
from presto_tpu_torch.ft.faults import FAULTS
from presto_tpu_torch.obs import qstats as QS
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
from presto_tpu_torch.parallel.worker import WorkerServer

from tpch_queries import QUERIES

_CAP_RETRIES = REGISTRY.counter(
    "presto_tpu_capacity_overflow_retries_total")
_REPLANS = REGISTRY.counter("presto_tpu_adaptive_replans_total")
_SPEC_ATTEMPTS = REGISTRY.counter(
    "presto_tpu_speculative_attempts_total")
_SPEC_WINS = REGISTRY.counter("presto_tpu_speculative_wins_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def torch_tpch():
    return TpchConnector(scale=0.01)


@pytest.fixture(autouse=True)
def _no_armed_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()


@pytest.fixture(scope="module")
def adaptive_cluster(torch_tpch, tmp_path_factory):
    """2 workers sharing a spool + a coordinator engine in TASK mode."""
    before = {t for t in threading.enumerate() if not t.daemon}
    spool = str(tmp_path_factory.mktemp("adaptive_spool"))
    workers, coord = [], None
    try:
        workers = [
            WorkerServer({"tpch": torch_tpch}, node_id=f"aw{i}",
                         spool_dir=spool, device="cpu").start()
            for i in range(2)]
        local = Engine(device="cpu")
        local.register_catalog("tpch", torch_tpch)
        coord = ClusterCoordinator(local, heartbeat_interval_s=0.2).start()
        for w in workers:
            coord.add_worker(w.uri)
        local.session.set("retry_policy", "TASK")
        yield coord, workers, local, spool
    finally:
        if coord is not None:
            coord.stop()
        for w in workers:
            try:
                w.stop()
            except Exception:  # noqa: BLE001
                pass
    leaked = {t for t in threading.enumerate()
              if not t.daemon} - before
    assert not leaked, f"non-daemon threads leaked: {leaked}"


# the expanding join (nationkey is not a key of either side) whose
# output capacity the poisoned estimate undersizes
_CHAOS_SQL = (
    "select s_nationkey, count(*) as c from supplier, customer "
    "where s_nationkey = c_nationkey and c_mktsegment = 'BUILDING' "
    "group by s_nationkey order by s_nationkey")
_POISON_KEY = ("tpch.customer", "eq(c_mktsegment, ?)")


def _poison_ledger():
    # claim the segment filter keeps ~1/1500 of customer rows: a
    # >= 16x-wrong observation (true selectivity is ~1/5, a ~300x
    # error) that the material-divergence gate admits into estimates.
    # Heavily weighted: the in-process workers feed REAL observations
    # into the same ledger while the test runs, and the poisoned mean
    # must stay poisoned across the static run
    for _ in range(400):
        QS.DIVERGENCE.observe_selectivity(*_POISON_KEY, 1500, 1)


def _unpoison_ledger():
    QS.DIVERGENCE.forget_selectivity(*_POISON_KEY)


def test_adaptive_replan_beats_poisoned_static_plan(adaptive_cluster,
                                                    oracle):
    """The acceptance chaos run, on rows, counters and records: with the
    ledger poisoned, the static TASK plan pays capacity-overflow retry
    rungs; the adaptive run re-plans the remainder after the divergent
    side stage (the join flipped broadcast->partitioned) and pays no
    more; both equal the sqlite oracle. The reference's adaptive run
    pays none: the port cuts the re-costed output capacity of the
    expanding join to its first rung, twice the join's input rows
    (exec/executor.PlanInterpreter._capacity), so it pays that one
    output rung (ROADMAP P12)."""
    coord, _workers, local, _spool = adaptive_cluster
    want = oracle.query(to_sqlite(parse_statement(_CHAOS_SQL)))
    _poison_ledger()
    try:
        # a threshold between the poisoned estimate (~1 row) and the
        # true filtered size (~300 rows), so the divergence crosses
        # the broadcast-vs-partitioned line mid-query
        local.session.set("broadcast_join_threshold_rows", 64)
        local.session.set("adaptive_replanning", False)
        base = _CAP_RETRIES.total()
        got_static = coord.execute(_CHAOS_SQL)
        static_rungs = _CAP_RETRIES.total() - base
        ok, msg = rows_equal(got_static, want, ordered=True)
        assert ok, f"static vs oracle: {msg}"
        assert "replans" not in coord.last_distribution
        assert static_rungs > 0, (
            "poisoned static plan should pay overflow retry rungs")

        local.session.set("adaptive_replanning", True)
        _poison_ledger()  # the static run recorded real observations
        r_base = _REPLANS.value(kind="stage-divergence")
        base = _CAP_RETRIES.total()
        base_out = _CAP_RETRIES.value(operator="out")
        got_adapt = coord.execute(_CHAOS_SQL)
        adapt_rungs = _CAP_RETRIES.total() - base
        ok, msg = rows_equal(got_adapt, want, ordered=True)
        assert ok, f"adaptive vs oracle: {msg}"
        assert got_adapt == got_static
        assert adapt_rungs <= static_rungs
        assert adapt_rungs == _CAP_RETRIES.value(operator="out") - base_out
        assert _REPLANS.value(kind="stage-divergence") > r_base
        assert coord.last_distribution["replans"] >= 1
        kinds = {d["kind"]
                 for d in coord.last_distribution["adaptive"]}
        assert "join-capacity" in kinds
        # the corrected plan renders its strategy flip
        assert "replanned: broadcast->partitioned" in (
            coord.last_adaptive_explain or "")

        # the decision audit is queryable from SQL
        rows = local.execute(
            "select kind, old_strategy, new_strategy "
            "from system.adaptive_decisions "
            "where kind = 'join-distribution'")
        assert ("join-distribution", "broadcast",
                "partitioned") in rows
        assert "presto_tpu_adaptive_replans_total" in REGISTRY.render()
        assert "presto_tpu_capacity_overflow_retries_total" \
            in REGISTRY.render()
    finally:
        _unpoison_ledger()
        local.session.set("adaptive_replanning", True)
        local.session.properties.pop("broadcast_join_threshold_rows",
                                     None)


def test_speculative_straggler_redispatch_q5(adaptive_cluster):
    """TPC-H Q5 under an injected exchange slowdown: the straggling
    stage task gets a duplicate attempt on another worker, the first
    finisher's results are byte-identical to the fault-free run, the
    loser's task is DELETEd, and no buffers or spool files leak."""
    coord, workers, local, spool = adaptive_cluster
    import os

    sql = QUERIES["q05"]
    want = coord.execute(sql)  # fault-free TASK run (warms programs)
    # warm the mirror-image placement too: a speculative duplicate of
    # shard i runs on the OTHER worker, whose (i, W) split-view engine
    # would otherwise pay a cold compile mid-race
    coord.workers.reverse()
    try:
        assert coord.execute(sql) == want
    finally:
        coord.workers.reverse()
    local.session.set("speculative_execution", True)
    local.session.set("speculation_min_runtime_s", 0.3)
    local.session.set("speculation_threshold", 1.5)
    # stall the FIRST consumer fetch of side1's store long enough to
    # cross the straggler threshold; the duplicate attempt's re-fetch
    # is fast (limit=1 exhausts the fault)
    FAULTS.arm("exchange-fetch-delay", prob=1.0, match=".side1.",
               limit=1, delay_s=4.0)
    a_base = _SPEC_ATTEMPTS.value()
    w_base = _SPEC_WINS.value()
    try:
        got = coord.execute(sql)
    finally:
        FAULTS.clear()
        local.session.set("speculative_execution", False)
    assert got == want  # first-finisher results byte-identical
    assert _SPEC_ATTEMPTS.value() > a_base
    assert _SPEC_WINS.value() > w_base
    spec = [r for r in QS.ADAPTIVE.records()
            if r["kind"] == "speculation"]
    assert spec and spec[-1]["new_strategy"] == "speculative"

    # the loser eventually unstalls, loses the race, and cleans up:
    # zero leaked worker buffers / spool files / reservations
    deadline = time.time() + 20
    def residue():
        spooled = os.listdir(spool)
        bufs = [tid for w in workers for tid in list(w.buffers)]
        return spooled + bufs
    while time.time() < deadline and residue():
        time.sleep(0.25)
    assert residue() == [], f"leaked task state: {residue()}"
    for w in workers:
        for e in list(w._engines.values()):
            assert e.memory_pool.info()["reservedBytes"] == 0
    # and the loser's dispatch thread comes home (its POST returns
    # once the worker-side stall elapses) — no thread leaks either
    def spec_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith("presto-tpu-speculate")
                and t.is_alive()]
    while time.time() < deadline and spec_threads():
        time.sleep(0.25)
    assert spec_threads() == []


# -- unit: arbitration ------------------------------------------------------


def test_arbiter_first_finisher_and_straggler_gating():
    clock = [0.0]
    policy = SPEC.SpeculationPolicy(enabled=True, quantile=0.75,
                                    multiplier=2.0, min_runtime_s=1.0)
    arb = SPEC.StageArbiter(4, policy, clock=lambda: clock[0])
    # three siblings finish quickly
    for shard in range(3):
        clock[0] = 0.5
        assert arb.claim_win(shard, f"t.{shard}", {"r": shard}, False)
    assert not arb.all_won()
    # below the threshold (max(1.0, 2*0.5s) = 1.0s): no speculation yet
    clock[0] = 0.9
    assert arb.stragglers() == []
    # past it: shard 3 is a straggler, exactly once
    clock[0] = 1.2
    assert arb.stragglers() == [3]
    arb.note_speculation(3)
    assert arb.stragglers() == []
    # first finisher wins; the second is told it lost
    assert arb.claim_win(3, "t.3a1", {"r": "spec"}, True)
    assert not arb.claim_win(3, "t.3", {"r": "late"}, False)
    assert arb.all_won()
    assert arb.winner_task_id(3) == "t.3a1"
    assert arb.winner_was_speculative(3)
    assert arb.results()[3] == {"r": "spec"}
    assert arb.speculation_summary() == {"speculated": [3],
                                         "speculative_wins": 1}


def test_arbiter_failure_surfaces_only_when_no_attempt_remains():
    policy = SPEC.SpeculationPolicy(enabled=True)
    arb = SPEC.StageArbiter(2, policy)
    assert arb.claim_win(0, "t.0", "ok", False)
    arb.note_speculation(1)  # two attempts in flight for shard 1
    arb.record_failure(1, RuntimeError("primary died"))
    assert arb.failed_shard() is None  # duplicate may still win
    arb.record_failure(1, RuntimeError("duplicate died"))
    dead = arb.failed_shard()
    assert dead is not None and dead[0] == 1
    assert "duplicate died" in str(dead[1])


def test_w2_stage_can_speculate():
    """quantile 0.75 of 2 shards would demand BOTH siblings done —
    the need is capped at W-1 so a 2-worker stage still speculates."""
    clock = [0.0]
    policy = SPEC.SpeculationPolicy(enabled=True, quantile=0.75,
                                    multiplier=1.5,
                                    min_runtime_s=0.1)
    arb = SPEC.StageArbiter(2, policy, clock=lambda: clock[0])
    clock[0] = 0.2
    assert arb.claim_win(0, "t.0", "ok", False)
    clock[0] = 1.0
    assert arb.stragglers() == [1]


# -- unit: overlay re-costing + remainder substitution ----------------------


def _mini_engine(torch_tpch) -> Engine:
    e = Engine(device="cpu")
    e.register_catalog("tpch", torch_tpch)
    return e


def test_overlay_stats_answers_carriers(torch_tpch):
    from presto_tpu_torch import types as T
    from presto_tpu_torch.cost.adapt import CarrierStats, OverlayStats
    from presto_tpu_torch.plan import nodes as N

    e = _mini_engine(torch_tpch)
    carrier = N.TableScan("__exchange__", "side1", {"x": "x"},
                          {"x": T.BIGINT})
    stats = OverlayStats(e, {"side1": CarrierStats(777, 0.25)})
    est = stats.stats(carrier)
    assert est.row_count == 777 and est.selectivity == 0.25
    # unknown carriers keep the conservative unknown-relation fallback
    other = N.TableScan("__exchange__", "nope", dict(carrier.assignments),
                        dict(carrier.types))
    assert not stats.stats(other).confident


def test_reannotate_rewrites_only_material_changes(torch_tpch):
    import dataclasses

    from presto_tpu_torch.cost.adapt import (CarrierStats, OverlayStats,
                                             reannotate)
    from presto_tpu_torch.plan import nodes as N

    e = _mini_engine(torch_tpch)
    plan, _ = e.plan_sql(
        "select o_orderpriority, count(*) c from orders, customer "
        "where o_custkey = c_custkey group by o_orderpriority")

    def find_join(node):
        if isinstance(node, N.Join):
            return node
        for s in node.sources():
            hit = find_join(s)
            if hit is not None:
                return hit
        return None

    join = find_join(plan)
    assert join is not None
    # swap the build side for a carrier whose observed rows are 64x
    # the annotation: material -> capacity re-bucketed + flip decided
    carrier = N.TableScan("__exchange__", "side1",
                          {s: s for s in join.right.output_types()},
                          dict(join.right.output_types()))
    poisoned = dataclasses.replace(join, right=carrier, build_rows=16,
                                   capacity=32, distribution="broadcast")
    stats = OverlayStats(e, {"side1": CarrierStats(16 * 64)})
    notes = []
    e.session.set("broadcast_join_threshold_rows", 64)
    try:
        out = reannotate(
            poisoned, e, stats,
            note=lambda kind, node, est, actual, old, new:
            notes.append((kind, old, new)))
    finally:
        e.session.properties.pop("broadcast_join_threshold_rows", None)
    assert out.build_rows == 1024 and out.capacity == 2048
    assert out.distribution == "partitioned"
    assert ("join-distribution", "broadcast", "partitioned") in notes

    # a <4x wobble is NOT material: the node (and its cache-keyed
    # annotations) must come back untouched
    stats2 = OverlayStats(e, {"side1": CarrierStats(20)})
    out2 = reannotate(poisoned, e, stats2, note=None)
    assert out2.build_rows == 16 and out2.capacity == 32


def test_substitute_materialized_outermost_wins(torch_tpch):
    from presto_tpu_torch.plan import nodes as N
    from presto_tpu_torch.plan.optimizer import substitute_materialized

    e = _mini_engine(torch_tpch)
    plan, _ = e.plan_sql(
        "select count(*) c from orders, customer "
        "where o_custkey = c_custkey")
    inner = plan
    while not isinstance(inner, N.Join):
        inner = inner.sources()[0]
    outer_sub = inner.right          # completed OUTER subtree
    inner_sub = outer_sub.sources()[0] if outer_sub.sources() else None
    carrier_outer = N.TableScan("__exchange__", "outer",
                                {s: s for s in outer_sub.output_types()},
                                dict(outer_sub.output_types()))
    replacements = {id(outer_sub): carrier_outer}
    if inner_sub is not None:
        replacements[id(inner_sub)] = N.TableScan(
            "__exchange__", "inner",
            {s: s for s in inner_sub.output_types()},
            dict(inner_sub.output_types()))
    out = substitute_materialized(plan, replacements)
    found = []

    def visit(node):
        if isinstance(node, N.TableScan) \
                and node.catalog == "__exchange__":
            found.append(node.table)
        for s in node.sources():
            visit(s)

    visit(out)
    assert found == ["outer"]  # the nested replacement never applied


# -- unit: exact-id task DELETE ---------------------------------------------


def test_exact_delete_spares_attempt_versioned_sibling(torch_tpch):
    """DELETE /v1/task/{tid}?exact=1 removes ONE task: a losing
    primary's id prefixes its winning duplicate's id, so the prefix
    path would wipe the winner's buffers too."""
    from presto_tpu_torch.parallel.buffer import OutputBuffer

    w = WorkerServer({"tpch": torch_tpch}, node_id="xdel",
                     device="cpu").start()
    try:
        for tid in ("q1.s.0", "q1.s.0a1"):
            buf = OutputBuffer(1, 1 << 20)
            buf.add(0, b"page", 1)
            buf.set_complete()
            w.buffers[tid] = buf
        req = urllib.request.Request(
            f"{w.uri}/v1/task/q1.s.0?exact=1", method="DELETE")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read()) == {}
        assert list(w.buffers) == ["q1.s.0a1"]
        # the prefix path still sweeps the whole query
        req = urllib.request.Request(
            f"{w.uri}/v1/task/q1", method="DELETE")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read()) == {}
        assert not w.buffers
    finally:
        w.stop()
