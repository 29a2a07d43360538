"""START TRANSACTION / COMMIT / ROLLBACK in the port
(presto_tpu_torch/transaction.py, a copy of presto_tpu's, over the
memory connector's snapshots), held against presto_tpu on the SQL of
tests/test_transactions.py: each statement's rows, or its error's
type and message, equal the reference's. A rollback swaps in fresh
arrays, and the device copies of the old ones are dropped too."""

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.connectors.memory import MemoryConnector as RefMemory

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.transaction import TransactionError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine(engine, connector):
    engine.register_catalog("mem", connector)
    engine.session.catalog = "mem"
    engine.execute("create table t as select 1 as x")
    engine.execute("insert into t select 2")
    return engine


@pytest.fixture()
def ref():
    return _engine(RefEngine(), RefMemory())


@pytest.fixture()
def port():
    return _engine(TorchEngine(device="cpu"), MemoryConnector())


def outcome(engine, sql: str):
    try:
        return engine.execute(sql)
    except Exception as exc:  # noqa: BLE001 - the error is the outcome
        return type(exc).__name__, str(exc)


def same(ref, port, *sqls):
    for sql in sqls:
        want = outcome(ref, sql)
        assert outcome(port, sql) == want, sql


def _xs(e):
    return sorted(r[0] for r in e.execute("select x from t"))


def test_rollback_restores_writes(ref, port):
    same(ref, port, "start transaction", "insert into t select 3",
         "delete from t where x = 1")
    assert _xs(port) == _xs(ref) == [2, 3]  # reads see the writes
    same(ref, port, "rollback")
    assert _xs(port) == _xs(ref) == [1, 2]


def test_commit_keeps_writes(ref, port):
    same(ref, port, "begin", "update t set x = x + 10 where x = 2",
         "commit")
    assert _xs(port) == _xs(ref) == [1, 12]


def test_rollback_restores_dropped_table(ref, port):
    same(ref, port, "start transaction", "drop table t")
    assert "t" not in port.catalogs["mem"].table_names()
    same(ref, port, "select x from t", "rollback")
    assert _xs(port) == _xs(ref) == [1, 2]


def test_nested_begin_rejected(ref, port):
    same(ref, port, "start transaction", "begin", "rollback")
    with pytest.raises(TransactionError):
        port.execute("start transaction")
        port.execute("begin")


def test_commit_without_transaction_rejected(ref, port):
    same(ref, port, "commit", "rollback")
    with pytest.raises(TransactionError, match="no transaction"):
        port.execute("commit")


def test_rollback_drops_the_device_copies(port):
    """A rollback swaps fresh arrays in; the copies of the arrays it
    replaced are let go, and the reads after it see the snapshot."""
    port.execute("start transaction")
    port.execute("update t set x = x * 100")
    assert _xs(port) == [100, 200]
    written = port.catalogs["mem"]._data["t"]["x"]
    assert port.resident(written) is not None
    port.execute("rollback")
    assert port.resident(written) is None and port._dev_cache == {}
    assert _xs(port) == [1, 2]
    assert port.catalogs["mem"]._data["t"]["x"] is not written


def test_writes_outside_a_transaction_autocommit(ref, port):
    same(ref, port, "insert into t select 3", "rollback",
         "select count(*) from t")
    assert port.transactions.current is None
