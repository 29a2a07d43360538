"""The port's protocol clients on the CPU: the DB-API driver
(presto_tpu_torch/dbapi.py; the dbapi cases of tests/test_server.py),
the client library in both result formats, and the CLI
(``python -m presto_tpu_torch.cli``) in-process on a CPU engine and
with ``--server`` against a CoordinatorServer."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from presto_tpu_torch import Engine
from presto_tpu_torch.client import Client
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.server import CoordinatorServer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def server(request):
    engine = Engine(device="cpu")
    engine.register_catalog("tpch", TpchConnector(scale=0.01))
    srv = CoordinatorServer(engine).start()
    request.addfinalizer(srv.stop)
    return srv


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


def test_result_formats_agree(server):
    base = f"http://127.0.0.1:{server.port}"
    sql = ("select o_orderpriority, count(*) as c, sum(o_totalprice) as s, "
           "min(o_orderdate) as d from orders group by o_orderpriority "
           "order by o_orderpriority")
    json_cols, json_rows = Client(base, user="t").execute(sql)
    arrow = Client(base, user="t", result_format="arrow")
    arrow.session_properties = {"result_cache": False}
    assert arrow.execute(sql) == (json_cols, json_rows)
    assert len(json_rows) == 5


def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=REPO)


def test_cli_in_process_on_the_cpu():
    out = _cli("--device", "cpu", "-e",
               "select n_name from nation where n_nationkey < 2 "
               "order by n_name")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].strip() == "n_name"
    assert [ln.strip() for ln in lines[2:4]] == ["ALGERIA", "ARGENTINA"]
    assert "(2 rows" in out.stdout


def test_cli_talks_to_a_coordinator(server):
    out = _cli("--server", f"http://127.0.0.1:{server.port}", "-e",
               "select count(*) as c from region")
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[2].strip() == "5"
    failed = _cli("--server", f"http://127.0.0.1:{server.port}", "-e",
                  "select bogus from region")
    assert "Query failed" in failed.stderr
