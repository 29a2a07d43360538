"""The port's coordinator server (presto_tpu_torch/server/), on the
CPU: the REST protocol cases of tests/test_server.py (paging, cancel,
query_max_run_time through the reaper, the Web UI, /metrics, per-client
SET SESSION, a group-queued cancel) against a CoordinatorServer over an
``Engine(device="cpu")`` at SF0.01; and both packages'
CoordinatorServers answering the 22 TPC-H queries in JSON and in arrow
result mode with equal columns, types and rows (floats within 1e-9
relative; decimals and dates are strings on the wire, compared
exactly)."""

import threading

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.client import Client as RefClient
from presto_tpu.server import CoordinatorServer as RefServer

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.client import Client, QueryFailed
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.server import CoordinatorServer

from tpch_queries import QUERIES


def Engine(**kw):  # noqa: N802 - the reference tests' name
    return TorchEngine(device="cpu", **kw)


@pytest.fixture(scope="module")
def tpch_tiny():
    """The port's SF0.01 connector (byte-identical to the reference's)."""
    return TorchTpch(scale=0.01)


@pytest.fixture(scope="module")
def ref_server(request):
    from presto_tpu.connectors.tpch import TpchConnector
    engine = RefEngine()
    engine.register_catalog("tpch", TpchConnector(scale=0.01))
    srv = RefServer(engine).start()
    request.addfinalizer(srv.stop)
    return srv


def _rows_match(got, want, rel=1e-9):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert abs(a - b) <= rel * max(abs(a), abs(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fmt", ["json", "arrow"])
def test_tpch_22_equal_reference_server(server, ref_server, fmt):
    """The JSON pass executes every query; the arrow pass, a repeat,
    is served from each server's result cache through its arrow page
    encoding. The two servers are driven at once."""
    port = Client(f"http://127.0.0.1:{server.port}", user="tester",
                  result_format=fmt)
    ref = RefClient(f"http://127.0.0.1:{ref_server.port}", user="tester",
                    result_format=fmt)
    want: dict = {}
    worker = threading.Thread(target=lambda: want.update(
        {name: ref.execute(sql) for name, sql in QUERIES.items()}))
    worker.start()
    got = {name: port.execute(sql) for name, sql in QUERIES.items()}
    worker.join()
    for name in QUERIES:
        (cols, rows), (want_cols, want_rows) = got[name], want[name]
        assert cols == want_cols, name
        _rows_match(rows, want_rows)


@pytest.fixture(scope="module")
def server(request, tpch_tiny):
    engine = Engine()
    engine.register_catalog("tpch", tpch_tiny)
    srv = CoordinatorServer(engine).start()
    request.addfinalizer(srv.stop)
    return srv


@pytest.fixture()
def client(server):
    return Client(f"http://127.0.0.1:{server.port}", user="tester")


def test_info_and_status(client):
    info = client.server_info()
    assert info["coordinator"] is True


def test_simple_query(client):
    columns, rows = client.execute(
        "select n_name, n_nationkey from nation "
        "where n_regionkey = 0 order by n_name")
    assert [c["name"] for c in columns] == ["n_name", "n_nationkey"]
    assert len(rows) == 5
    assert rows[0][0] == "ALGERIA"


def test_aggregate_query(client):
    _, rows = client.execute("select count(*) from lineitem")
    assert rows[0][0] > 50000


def test_decimal_and_date_encoding(client):
    _, rows = client.execute(
        "select o_totalprice, o_orderdate from orders limit 1")
    assert isinstance(rows[0][0], str) and "." in rows[0][0]
    assert len(rows[0][1]) == 10  # ISO date


def test_query_failure_surfaces(client):
    with pytest.raises(QueryFailed):
        client.execute("select bogus_column from nation")


def test_query_listing(client):
    client.execute("select 1")
    qs = client.queries()
    assert any(q["state"] == "FINISHED" for q in qs)
    assert all(q["user"] == "tester" for q in qs)


def test_paged_results(client):
    # > PAGE_ROWS rows forces multiple nextUri pages
    _, rows = client.execute("select l_orderkey from lineitem")
    assert len(rows) > 4096


def test_a_paged_result_is_fetched_from_the_device_once(server):
    """A multi-page SELECT through the server takes the host syncs of
    one execute_table (the result comes off the device in one fetch);
    its pages are slices of that host result. (The sync counter is the
    process's: this runs before the tests below that leave queries of
    their own to run.)"""
    from presto_tpu_torch.exec import hostsync as HS
    engine = server.httpd.RequestHandlerClass.manager.engine
    sql = "select l_orderkey, l_partkey from lineitem where l_suppkey < 90"
    engine.execute_table(sql)  # capacities remembered: no rung below
    before = HS.SYNCS.total()
    engine.execute_table(sql)
    one = HS.SYNCS.total() - before
    c = Client(f"http://127.0.0.1:{server.port}", user="tester")
    c.session_properties = {"result_cache": False}
    before = HS.SYNCS.total()
    _cols, rows = c.execute(sql)
    assert HS.SYNCS.total() - before == one
    assert len(rows) > 4096


def test_cancel_interrupts_execution(server):
    """DELETE on a running query aborts it at the next host checkpoint
    and frees the engine for the next query."""
    import time

    from presto_tpu_torch.connectors.blackhole import BlackholeConnector
    from presto_tpu_torch import BIGINT

    engine = server.httpd.RequestHandlerClass.manager.engine
    bh = BlackholeConnector(rows_per_table=10,
                            page_processing_delay_s=30.0)
    bh.create_table("slow", {"x": BIGINT}, {"x": []}, {"x": None})
    engine.register_catalog("bh", bh)
    c = Client(f"http://127.0.0.1:{server.port}", user="tester")
    qid, _ = c.submit("SELECT count(*) FROM bh.slow")
    # wait until it is RUNNING (inside the slow scan)
    for _ in range(100):
        if c.query_state(qid) == "RUNNING":
            break
        time.sleep(0.05)
    t0 = time.monotonic()
    c.cancel(qid)
    for _ in range(100):
        if c.query_state(qid) == "CANCELED":
            break
        time.sleep(0.05)
    assert c.query_state(qid) == "CANCELED"
    # the device/engine must be free well before the 30s scan finishes
    cols, rows = c.execute("SELECT 1")
    assert rows == [[1]]
    assert time.monotonic() - t0 < 10


def test_query_max_run_time(server):
    """query_max_run_time cancels a query exceeding its wall budget."""
    from presto_tpu_torch.connectors.blackhole import BlackholeConnector
    from presto_tpu_torch import BIGINT

    engine = server.httpd.RequestHandlerClass.manager.engine
    bh2 = BlackholeConnector(rows_per_table=10,
                             page_processing_delay_s=5.0)
    bh2.create_table("slow2", {"x": BIGINT}, {"x": []}, {"x": None})
    engine.register_catalog("bh2", bh2)
    engine.session.set("query_max_run_time", 0.5)
    try:
        c = Client(f"http://127.0.0.1:{server.port}", user="tester")
        with pytest.raises(QueryFailed):
            c.execute("SELECT count(*) FROM bh2.slow2")
    finally:
        engine.session.set("query_max_run_time", 0.0)


def test_web_ui_and_cluster_stats(server):
    """Minimal Web UI (reference server/ui/ webapp) + cluster stats."""
    import json
    import urllib.request

    base = f"http://127.0.0.1:{server.port}"
    with urllib.request.urlopen(f"{base}/ui") as resp:
        html = resp.read().decode()
    assert "presto-tpu coordinator" in html
    assert "Resource groups" in html
    with urllib.request.urlopen(f"{base}/v1/cluster") as resp:
        stats = json.loads(resp.read())
    assert stats["totalQueries"] >= 1
    assert "runningQueries" in stats


def test_metrics_endpoint(server, client):
    client.execute("select count(*) from nation")
    import urllib.request
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics") as r:
        assert "text/plain" in r.headers["Content-Type"]
        text = r.read().decode()
    assert 'presto_tpu_queries{state="finished"}' in text
    assert "presto_tpu_query_duration_seconds_sum" in text
    assert "presto_tpu_memory_reserved_bytes" in text


# ---- DB-API 2.0 driver (presto_tpu_torch/dbapi.py) --------------------------


def test_dbapi_roundtrip(server):
    import presto_tpu_torch.dbapi as dbapi
    with dbapi.connect("127.0.0.1", server.port, user="tester") as conn:
        cur = conn.cursor()
        cur.execute("select n_name, n_nationkey from nation "
                    "where n_regionkey = ? order by n_name limit ?",
                    (1, 3))
        assert [d[0] for d in cur.description] == ["n_name", "n_nationkey"]
        assert cur.rowcount == 3
        first = cur.fetchone()
        assert first[0] == "ARGENTINA"
        assert len(cur.fetchall()) == 2
        assert cur.fetchone() is None


def test_dbapi_param_quoting(server):
    import presto_tpu_torch.dbapi as dbapi
    conn = dbapi.connect("127.0.0.1", server.port, user="tester")
    cur = conn.cursor()
    # a quoted literal containing ? must not consume a parameter; a
    # string parameter with a quote must be escaped
    cur.execute("select n_name from nation where n_name = ? "
                "or n_name = 'who?'", ("O'BRIENLAND",))
    assert cur.fetchall() == []
    with __import__("pytest").raises(dbapi.ProgrammingError):
        cur.execute("select 1", (1, 2))


def test_dbapi_error_surface(server):
    import presto_tpu_torch.dbapi as dbapi
    import pytest
    conn = dbapi.connect("127.0.0.1", server.port, user="tester")
    with pytest.raises(dbapi.DatabaseError):
        conn.cursor().execute("select bogus_column from nation")


def test_dbapi_comment_and_ident_handling(server):
    import presto_tpu_torch.dbapi as dbapi
    import pytest
    conn = dbapi.connect("127.0.0.1", server.port, user="tester")
    cur = conn.cursor()
    # apostrophe inside a comment must not break placeholder scanning
    cur.execute("select n_name -- don't care\n from nation "
                "where n_nationkey = ?", (3,))
    assert cur.rowcount == 1
    # leftover placeholder with no params fails client-side
    with pytest.raises(dbapi.ProgrammingError, match="not enough"):
        cur.execute("select 1 where 1 = ?")
    # datetime.datetime binds as a TIMESTAMP literal and round-trips
    import datetime
    cur.execute("select ?", (datetime.datetime(2026, 7, 30, 12, 0),))
    [(v,)] = cur.fetchall()
    assert v == datetime.datetime(2026, 7, 30, 12, 0)
    # timezone-aware datetimes are rejected loudly (no TZ type)
    with pytest.raises(dbapi.NotSupportedError):
        cur.execute("select ?", (datetime.datetime(
            2026, 7, 30, 12, 0,
            tzinfo=datetime.timezone.utc),))


def test_http_set_session_scoped_per_client(server):
    """SET SESSION over HTTP is client-scoped: the property rides the
    X-Trino-Session header back in, and never leaks into other
    clients' queries or the shared engine session (reference:
    X-Trino-Set-Session + client session accumulation)."""
    from presto_tpu_torch.client import Client

    url = f"http://127.0.0.1:{server.port}"
    engine = server.httpd.RequestHandlerClass.manager.engine
    a = Client(url)
    b = Client(url)
    a.execute("set session join_distribution_type = 'BROADCAST'")
    assert a.session_properties == {
        "join_distribution_type": "BROADCAST"}
    # the shared engine session is untouched
    assert engine.session.properties.get(
        "join_distribution_type") is None
    assert b.session_properties == {}
    # a's later queries still execute fine with the override bound
    _, rows = a.execute("select 1")
    assert rows == [[1]]


def test_cancel_while_queued_releases_ticket_and_slot():
    """A query canceled while still group-QUEUED must free its
    max_queued slot AND its dispatcher ticket — the ticket dict
    otherwise grows by one (group, closure) entry per canceled query
    for the life of the server."""
    import time

    from presto_tpu_torch import BIGINT
    from presto_tpu_torch.connectors.blackhole import BlackholeConnector
    from presto_tpu_torch.server.resource_groups import GroupSpec
    from presto_tpu_torch.server.server import QueryManager

    engine = Engine()
    bh = BlackholeConnector(rows_per_table=10,
                            page_processing_delay_s=30.0)
    bh.create_table("slow", {"x": BIGINT}, {"x": []}, {"x": None})
    engine.register_catalog("bh", bh)
    mgr = QueryManager(engine, resource_groups=[
        GroupSpec("tiny", hard_concurrency_limit=1, max_queued=4)])
    running = mgr.submit("SELECT count(*) FROM bh.slow", "u")
    for _ in range(100):
        if running.state == "RUNNING":
            break
        time.sleep(0.05)
    queued = mgr.submit("SELECT 1", "u")
    assert queued.state == "QUEUED"
    mgr.cancel(queued.query_id)
    assert queued.state == "CANCELED"
    with mgr.lock:
        assert queued.query_id not in mgr._tickets
    # the queue slot freed: the group accepts max_queued new entries
    for _ in range(4):
        assert mgr.submit("SELECT 1", "u").state == "QUEUED"
    mgr.cancel(running.query_id)

