"""The port's resource groups (presto_tpu_torch/server/resource_groups.py),
mirroring tests/test_resource_groups.py on a CPU engine.

Resource groups / admission control (reference
execution/resourcegroups/InternalResourceGroup.java:77 +
DispatchManager.selectGroup)."""

import time

import pytest

from presto_tpu_torch.server.resource_groups import (GroupSpec,
                                                     QueryQueueFullError,
                                                     ResourceGroupManager)


@pytest.fixture(scope="module")
def tpch_tiny():
    """The port's SF0.01 connector (byte-identical to the reference's)."""
    from presto_tpu_torch.connectors.tpch import TpchConnector
    return TpchConnector(scale=0.01)


def test_group_admits_queues_and_transfers_slots():
    g = ResourceGroupManager(
        [GroupSpec("g", hard_concurrency_limit=2,
                   max_queued=2)]).select("u", "q")
    started = []
    assert g.submit(lambda: started.append("a")) == "RUNNING"
    assert g.submit(lambda: started.append("b")) == "RUNNING"
    assert g.submit(lambda: started.append("c")) == "QUEUED"
    assert started == ["a", "b"]
    assert g.info()["running"] == 2 and g.info()["queued"] == 1
    g.finish()  # a leaves -> c starts on the freed slot
    assert started == ["a", "b", "c"]
    assert g.info()["running"] == 2 and g.info()["queued"] == 0
    g.finish()
    g.finish()
    assert g.info()["running"] == 0


def test_group_rejects_when_queue_full():
    g = ResourceGroupManager(
        [GroupSpec("g", hard_concurrency_limit=1,
                   max_queued=1)]).select("u", "q")
    g.submit(lambda: None)
    g.submit(lambda: None)  # queued
    with pytest.raises(QueryQueueFullError):
        g.submit(lambda: None)


def test_manager_selects_by_user_pattern():
    mgr = ResourceGroupManager([
        GroupSpec("admins", hard_concurrency_limit=8,
                  user_pattern="admin_.*"),
        GroupSpec("global", hard_concurrency_limit=2),
    ])
    assert mgr.select("admin_bob", "select 1").spec.name == "admins"
    assert mgr.select("alice", "select 1").spec.name == "global"


def test_server_enforces_concurrency_limit(tpch_tiny):
    """Through the HTTP coordinator: with a 1-wide group, the second
    query stays QUEUED while the first (artificially slow) runs."""
    import json
    import urllib.request

    from presto_tpu_torch import Engine
    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors.blackhole import BlackholeConnector
    from presto_tpu_torch.server.server import CoordinatorServer

    engine = Engine(device="cpu")
    bh = BlackholeConnector(page_processing_delay_s=1.5)
    engine.register_catalog("blackhole", bh)
    engine.register_catalog("tpch", tpch_tiny)
    bh.create_table("slow", {"x": T.BIGINT})
    bh.set_split_count("slow", 10)

    server = CoordinatorServer(
        engine, resource_groups=[GroupSpec("g",
                                           hard_concurrency_limit=1)])
    server.start()
    base = f"http://127.0.0.1:{server.port}"

    def post(sql):
        req = urllib.request.Request(
            f"{base}/v1/statement", data=sql.encode(), method="POST")
        return json.loads(urllib.request.urlopen(req).read())

    def state(qid):
        out = json.loads(urllib.request.urlopen(
            f"{base}/v1/query/{qid}").read())
        return out["state"]

    try:
        a = post("select count(*) from blackhole.slow")
        b = post("select 1")
        # while the slow query holds the only slot, b must be QUEUED
        time.sleep(0.3)
        sa, sb = state(a["id"]), state(b["id"])
        assert sa in ("RUNNING", "QUEUED")
        assert sb == "QUEUED", (sa, sb)
        deadline = time.time() + 30
        while time.time() < deadline:
            if state(a["id"]) == "FINISHED" and \
                    state(b["id"]) == "FINISHED":
                break
            time.sleep(0.2)
        assert state(a["id"]) == "FINISHED"
        assert state(b["id"]) == "FINISHED"
        groups = json.loads(urllib.request.urlopen(
            f"{base}/v1/resourceGroup").read())
        assert groups[0]["totalAdmitted"] == 2
        assert groups[0]["running"] == 0
    finally:
        server.stop()


def test_cancel_queued_frees_queue_slot():
    g = ResourceGroupManager(
        [GroupSpec("g", hard_concurrency_limit=1,
                   max_queued=1)]).select("u", "q")
    g.submit(lambda: None)
    queued = lambda: None  # noqa: E731
    g.submit(queued)
    assert g.cancel_queued(queued) is True
    # slot freed: another submission queues instead of rejecting
    g.submit(lambda: None)
    assert g.info()["queued"] == 1
    assert g.cancel_queued(queued) is False  # already removed


def test_no_matching_selector_rejects():
    from presto_tpu_torch.server.resource_groups import NoMatchingGroupError
    mgr = ResourceGroupManager([
        GroupSpec("svc", user_pattern="svc_.*")])
    with pytest.raises(NoMatchingGroupError):
        mgr.select("alice", "select 1")


def test_hierarchy_parent_limit_gates_children():
    """A child admission needs free slots in EVERY ancestor (reference
    InternalResourceGroup.java canRunMore walks up)."""
    from presto_tpu_torch.server.resource_groups import (GroupSpec,
                                                         ResourceGroupManager)

    mgr = ResourceGroupManager([
        GroupSpec("global", hard_concurrency_limit=2),
        GroupSpec("global.a", hard_concurrency_limit=2,
                  user_pattern="a.*"),
        GroupSpec("global.b", hard_concurrency_limit=2,
                  user_pattern="b.*"),
    ])
    ran = []
    a = mgr.select("alice", "q")
    b = mgr.select("bob", "q")
    assert a.spec.name == "global.a" and b.spec.name == "global.b"
    assert a.submit(lambda: ran.append("a1")) == "RUNNING"
    assert b.submit(lambda: ran.append("b1")) == "RUNNING"
    # parent 'global' is now at its limit of 2: children must queue
    assert a.submit(lambda: ran.append("a2")) == "QUEUED"
    assert ran == ["a1", "b1"]
    a.finish()  # frees a slot; queued a2 dequeues through the root
    assert ran == ["a1", "b1", "a2"]


def test_weighted_fair_dequeue_order():
    """weighted_fair picks the child with the lowest running/weight
    ratio when a slot frees."""
    from presto_tpu_torch.server.resource_groups import (GroupSpec,
                                                         ResourceGroupManager)

    mgr = ResourceGroupManager([
        GroupSpec("g", hard_concurrency_limit=1,
                  scheduling_policy="weighted_fair"),
        GroupSpec("g.heavy", hard_concurrency_limit=8,
                  scheduling_weight=3, user_pattern="h.*"),
        GroupSpec("g.light", hard_concurrency_limit=8,
                  scheduling_weight=1, user_pattern="l.*"),
    ])
    heavy = mgr.select("h1", "q")
    light = mgr.select("l1", "q")
    ran = []
    assert heavy.submit(lambda: ran.append("h1")) == "RUNNING"
    assert light.submit(lambda: ran.append("l1")) == "QUEUED"
    assert heavy.submit(lambda: ran.append("h2")) == "QUEUED"
    # slot frees: both children idle (running 0) -> ratio ties at 0,
    # FIFO breaks the tie -> l1; next free admits h2
    heavy.finish()
    assert ran == ["h1", "l1"]
    light.finish()
    assert ran == ["h1", "l1", "h2"]


def test_query_priority_policy():
    from presto_tpu_torch.server.resource_groups import (GroupSpec,
                                                         ResourceGroupManager)

    mgr = ResourceGroupManager([
        GroupSpec("p", hard_concurrency_limit=1,
                  scheduling_policy="query_priority"),
    ])
    g = mgr.select("u", "q")
    ran = []
    assert g.submit(lambda: ran.append("first")) == "RUNNING"
    assert g.submit(lambda: ran.append("low"), priority=1) == "QUEUED"
    assert g.submit(lambda: ran.append("high"), priority=9) == "QUEUED"
    g.finish()
    assert ran == ["first", "high"]
    g.finish()
    assert ran == ["first", "high", "low"]
