"""Access control in the port (presto_tpu_torch/security.py, a copy of
presto_tpu's): the planner checks every table it scans, and every
write path checks check_can_write. Held against presto_tpu on the
cases of tests/test_security.py that need no HTTP server: the same
statements are allowed, and the same ones raise AccessDeniedError with
the reference's message."""

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
