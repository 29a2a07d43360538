"""Access control in the port (presto_tpu_torch/security.py, a copy of
presto_tpu's): the planner checks every table it scans, and every
write path checks check_can_write. Held against presto_tpu on the
cases of tests/test_security.py that need no HTTP server: the same
statements are allowed, and the same ones raise AccessDeniedError with
the reference's message. Its HTTP cases (basic authentication, the
user bound to a query, owner-scoped results, transactions refused,
warnings in the protocol response, TLS) run against the port's
CoordinatorServer."""

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import security as RS
from presto_tpu.connectors.memory import MemoryConnector as RefMemory

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import security as S
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def outcome(engine, sql: str):
    try:
        return engine.execute(sql)
    except Exception as exc:  # noqa: BLE001 - the error is the outcome
        return type(exc).__name__, str(exc)


def test_access_control_blocks_select(tpch_tiny):
    ref, port = RefEngine(), TorchEngine(device="cpu")
    ref.register_catalog("tpch", tpch_tiny)
    port.register_catalog("tpch", TorchTpch(scale=0.01))
    for e, mod in ((ref, RS), (port, S)):
        e.access_control = mod.RuleBasedAccessControl([
            mod.AccessRule(user_pattern="analyst", catalog_pattern="tpch",
                           table_pattern="lineitem", allow=True,
                           write=False)])
        e.session.user = "analyst"
    for sql in ["select count(*) from lineitem",
                "select count(*) from orders",
                "select count(*) from lineitem, orders "
                "where l_orderkey = o_orderkey",
                "delete from lineitem where l_orderkey = 1"]:
        assert outcome(port, sql) == outcome(ref, sql), sql
    assert port.execute("select count(*) from lineitem")[0][0] > 0
    with pytest.raises(S.AccessDeniedError):
        port.execute("select count(*) from orders")
    with pytest.raises(S.AccessDeniedError):
        port.execute("delete from lineitem where l_orderkey = 1")


def test_rule_order_first_match_wins():
    ac = S.RuleBasedAccessControl([
        S.AccessRule(user_pattern="bob", table_pattern="secret",
                     allow=False),
        S.AccessRule(),  # allow everything else
    ])
    ac.check_can_select("bob", "c", "public")
    with pytest.raises(S.AccessDeniedError, match="bob cannot select"):
        ac.check_can_select("bob", "c", "secret")
    ac.check_can_select("alice", "c", "secret")
    ac.check_can_write("alice", "c", "secret")


def test_write_access_control_all_dml_paths():
    engines = []
    for engine, conn, mod in ((RefEngine(), RefMemory(), RS),
                              (TorchEngine(device="cpu"),
                               MemoryConnector(), S)):
        engine.register_catalog("memory", conn)
        engine.session.catalog = "memory"
        engine.execute("create table t as select 1 as x")
        engine.access_control = mod.RuleBasedAccessControl([
            mod.AccessRule(user_pattern="reader", catalog_pattern="memory",
                           allow=True, write=False)])
        engine.session.user = "reader"
        engines.append(engine)
    ref, port = engines
    assert port.execute("select x from t") == [(1,)]
    for sql in ["create table t2 as select 1 as x",
                "insert into t select 2",
                "delete from t where x = 1",
                "update t set x = 3",
                "drop table t",
                "drop table if exists t9"]:
        got = outcome(port, sql)
        assert got == outcome(ref, sql), sql
        assert got[0] == "AccessDeniedError", sql
        with pytest.raises(S.AccessDeniedError):
            port.execute(sql)
    # nothing was written, and no transaction snapshot was taken
    assert port.execute("select x from t") == [(1,)]
    assert port.catalogs["memory"].table_names() == ["t"]


def test_password_authenticator():
    auth = S.FileBasedPasswordAuthenticator({
        "alice": S.FileBasedPasswordAuthenticator.hash_password("s3cret")})
    auth.authenticate("alice", "s3cret")
    for user, password in (("alice", "wrong"), ("bob", "s3cret")):
        with pytest.raises(S.AuthenticationError):
            auth.authenticate(user, password)
    assert S.FileBasedPasswordAuthenticator.hash_password("x") == \
        RS.FileBasedPasswordAuthenticator.hash_password("x")


# ---- the HTTP cases of tests/test_security.py, on the port's
# CoordinatorServer over a CPU engine (the port's SF0.01 connector)


@pytest.fixture(scope="module")
def torch_tiny():
    return TorchTpch(scale=0.01)


def test_http_basic_auth(torch_tiny):
    from presto_tpu_torch.client import Client, QueryFailed
    from presto_tpu_torch.server import CoordinatorServer
    import urllib.error

    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tiny)
    auth = S.FileBasedPasswordAuthenticator({
        "alice": S.FileBasedPasswordAuthenticator.hash_password("s3cret")})
    srv = CoordinatorServer(e, authenticator=auth).start()
    try:
        ok = Client(f"http://127.0.0.1:{srv.port}", user="alice",
                    password="s3cret")
        cols, rows = ok.execute("select 1")
        assert rows == [[1]]
        bad = Client(f"http://127.0.0.1:{srv.port}", user="alice",
                     password="wrong")
        with pytest.raises(urllib.error.HTTPError):
            bad.execute("select 1")
        anon = Client(f"http://127.0.0.1:{srv.port}", user="alice")
        with pytest.raises(urllib.error.HTTPError):
            anon.execute("select 1")
    finally:
        srv.stop()


def test_http_user_bound_to_query():
    """The authenticated HTTP user is the one authorized: a restricted
    user's query is denied even though the engine's default user is
    unrestricted."""
    from presto_tpu_torch.client import Client, QueryFailed
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.server import CoordinatorServer

    e = TorchEngine(device="cpu")
    e.register_catalog("memory", MemoryConnector())
    e.session.catalog = "memory"
    e.execute("create table t as select 1 as x")
    e.access_control = S.RuleBasedAccessControl([
        S.AccessRule(user_pattern="presto", allow=True, write=True),
        S.AccessRule(user_pattern="intruder", catalog_pattern="memory",
                   allow=False),
        S.AccessRule(),
    ])
    srv = CoordinatorServer(e).start()
    try:
        ok = Client(f"http://127.0.0.1:{srv.port}", user="presto")
        _, rows = ok.execute("select x from t")
        assert rows == [[1]]
        bad = Client(f"http://127.0.0.1:{srv.port}", user="intruder")
        with pytest.raises(QueryFailed, match="[Aa]ccess"):
            bad.execute("select x from t")
    finally:
        srv.stop()


def test_http_results_owner_scoped(torch_tiny):
    """With an authenticator configured, query state and results are
    visible only to the submitting user (guessable query ids must not
    disclose another user's results)."""
    import urllib.error

    from presto_tpu_torch.client import Client
    from presto_tpu_torch.server import CoordinatorServer

    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tiny)
    auth = S.FileBasedPasswordAuthenticator({
        "alice": S.FileBasedPasswordAuthenticator.hash_password("a"),
        "bob": S.FileBasedPasswordAuthenticator.hash_password("b")})
    srv = CoordinatorServer(e, authenticator=auth).start()
    try:
        alice = Client(f"http://127.0.0.1:{srv.port}", user="alice",
                       password="a")
        qid, _ = alice.submit("select 1")
        alice.execute("select 1")
        bob = Client(f"http://127.0.0.1:{srv.port}", user="bob",
                     password="b")
        with pytest.raises(urllib.error.HTTPError):
            bob.query_state(qid)
        assert all(q["user"] == "bob" for q in bob.queries())
        assert any(q["queryId"] == qid for q in alice.queries())
    finally:
        srv.stop()


def test_http_transactions_rejected(torch_tiny):
    """Transactions over HTTP would share the process-global
    TransactionManager across users; the coordinator rejects them."""
    from presto_tpu_torch.client import Client, QueryFailed
    from presto_tpu_torch.server import CoordinatorServer

    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tiny)
    srv = CoordinatorServer(e).start()
    try:
        c = Client(f"http://127.0.0.1:{srv.port}")
        with pytest.raises(QueryFailed, match="transaction"):
            c.execute("start transaction")
    finally:
        srv.stop()


# ---- warnings + TLS ---------------------------------------------------


def test_warning_reaches_protocol_client(torch_tiny):
    """A deprecated-syntax warning accumulates during parsing and rides
    the QueryResults protocol to the client (reference
    execution/warnings/WarningCollector.java:21 + QueryResults
    warnings field)."""
    from presto_tpu_torch.client import Client
    from presto_tpu_torch.server.server import CoordinatorServer

    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tiny)
    e.session.catalog = "tpch"
    srv = CoordinatorServer(e).start()
    try:
        c = Client(srv.uri)
        _cols, rows = c.execute(
            "select count(*) from nation where n_nationkey != 3")
        assert rows == [[24]]
        assert any("non-standard" in w["message"] for w in c.warnings)
        assert c.warnings[0]["warningCode"]["name"] \
            == "DEPRECATED_SYNTAX"
        _cols, _rows = c.execute("select count(*) from nation")
        assert c.warnings == []
    finally:
        srv.stop()


def test_cross_join_performance_warning(torch_tiny):

    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tiny)
    e.session.catalog = "tpch"
    e.execute("select count(*) from nation, region")
    assert any(w.name == "PERFORMANCE_WARNING"
               for w in e.last_warnings)


def _make_cert(tmp_path):
    import subprocess
    cert = str(tmp_path / "cert.pem")
    key = str(tmp_path / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout",
         key, "-out", cert, "-days", "1", "-nodes", "-subj",
         "/CN=127.0.0.1", "-addext",
         "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    return cert, key


def test_coordinator_and_workers_over_tls(torch_tiny, tmp_path):
    """The whole cluster — protocol client -> coordinator and
    coordinator -> worker RPC + exchange fetches — runs over TLS
    (reference server/security/ServerSecurityModule.java https,
    InternalCommunicationConfig)."""
    from presto_tpu_torch.client import Client
    from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
    from presto_tpu_torch.parallel.worker import WorkerServer
    from presto_tpu_torch.server import httpbase
    from presto_tpu_torch.server.server import CoordinatorServer

    cert, key = _make_cert(tmp_path)
    httpbase.enable_client_tls(cafile=cert)
    workers = []
    try:
        cats = {"tpch": torch_tiny}
        workers = [WorkerServer(cats, tls=(cert, key), device="cpu").start()
                   for _ in range(2)]
        assert all(w.uri.startswith("https://") for w in workers)
        local = TorchEngine(device="cpu")
        local.register_catalog("tpch", torch_tiny)
        local.session.catalog = "tpch"
        coord = ClusterCoordinator(local)
        for w in workers:
            coord.add_worker(w.uri)
        coord.start()
        try:
            sql = ("select c_mktsegment, count(*) from customer, "
                   "orders where c_custkey = o_custkey "
                   "group by c_mktsegment order by c_mktsegment")
            got = coord.execute(sql)
            local2 = TorchEngine(device="cpu")
            local2.register_catalog("tpch", torch_tiny)
            local2.session.catalog = "tpch"
            assert got == local2.execute(sql)
        finally:
            coord.stop()
        # protocol surface over https too
        srv = CoordinatorServer(local, tls=(cert, key)).start()
        try:
            assert srv.uri.startswith("https://")
            c = Client(srv.uri)
            _cols, rows = c.execute("select count(*) from nation")
            assert rows == [[25]]
        finally:
            srv.stop()
    finally:
        httpbase.disable_client_tls()
        for w in workers:
            w.stop()
