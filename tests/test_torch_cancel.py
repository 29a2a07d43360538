"""Query cancellation in the port (presto_tpu_torch/exec/cancel.py, a
copy of presto_tpu's, and Engine.execute's ``cancel_token``), held
against presto_tpu on the same SQL at SF0.01: a token cancelled before
the run raises QueryCanceled, a ``query_max_run_time`` deadline raises
TimeLimitExceeded, and a token cancelled while the query runs stops it
at the next checkpoint of each kind (a capacity rung, a streamed block,
a segment, a spill partition). The engine runs the next query as
before."""

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.exec import cancel as RC

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import cancel as C
from presto_tpu_torch.exec import executor as EX

from tpch_queries import QUERIES

JOIN_SQL = ("select o_orderpriority, count(*) as c from orders, lineitem "
            "where o_orderkey = l_orderkey group by o_orderpriority "
            "order by o_orderpriority")


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
    return TorchTpch(scale=0.01)


@pytest.fixture()
def port(torch_tpch):
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tpch)
    return e


@pytest.fixture()
def ref(tpch_tiny):
    e = RefEngine()
    e.register_catalog("tpch", tpch_tiny)
    return e


def test_cancelled_token_raises(ref, port):
    sql = QUERIES["q01"]
    rtok, tok = RC.CancelToken(), C.CancelToken()
    rtok.cancel()
    tok.cancel()
    with pytest.raises(RC.QueryCanceled, match="canceled"):
        ref.execute(sql, cancel_token=rtok)
    with pytest.raises(C.QueryCanceled, match="canceled") as err:
        port.execute(sql, cancel_token=tok)
    assert not isinstance(err.value, C.TimeLimitExceeded)
    # the token is uninstalled: the next query runs and is right
    assert C.current() is None
    assert port.execute(sql) == ref.execute(sql)


def test_deadline_raises_time_limit(ref, port):
    sql = QUERIES["q09"]
    for engine in (ref, port):
        engine.session.set("query_max_run_time", 1e-6)
    with pytest.raises(RC.TimeLimitExceeded):
        ref.execute(sql)
    with pytest.raises(C.TimeLimitExceeded, match="query_max_run_time"):
        port.execute(sql)
    with pytest.raises(C.TimeLimitExceeded):
        port.execute_table(sql)
    port.session.set("query_max_run_time", 0)
    ref.session.set("query_max_run_time", 0)
    assert port.execute(sql) == ref.execute(sql)


def test_token_deadline_without_the_session_limit(port):
    tok = C.CancelToken(deadline=0.0)  # long past
    with pytest.raises(C.TimeLimitExceeded):
        port.execute(QUERIES["q06"], cancel_token=tok)


def test_killed_token_raises_its_exception(port):
    tok = C.CancelToken()
    tok.kill(MemoryError("killed for memory"))
    with pytest.raises(MemoryError, match="killed for memory"):
        port.execute(QUERIES["q06"], cancel_token=tok)


def _cancel_after(monkeypatch, module, name, token, calls=1):
    """Wrap ``module.name`` so that ``token`` is cancelled once it has
    returned ``calls`` times."""
    fn = getattr(module, name)
    seen = []

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        seen.append(1)
        if len(seen) == calls:
            token.cancel()
        return out
    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.mark.parametrize("route", ["rung", "block", "segment", "partition"])
def test_cancel_mid_query_stops_at_the_next_checkpoint(port, route,
                                                       monkeypatch):
    tok = C.CancelToken()
    if route == "rung":
        # a 16-slot group table overflows: the ladder's second pass
        # meets the cancelled token
        port.session.set("groupby_table_size", 16)
        sql = QUERIES["q18"]
        seen = _cancel_after(monkeypatch, EX, "grow_overflowed", tok)
    elif route == "block":
        port.session.set("scan_block_rows", 16384)
        sql = "select sum(l_quantity) from lineitem"
        seen = _cancel_after(monkeypatch, EX, "prepare_plan", tok)
    elif route == "segment":
        monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)
        sql = QUERIES["q10"]
        seen = _cancel_after(monkeypatch, EX, "run_plan_device", tok)
    else:
        port.session.set("query_max_memory_bytes", 200_000)
        sql = JOIN_SQL
        # the build side's rows, the probe side's, then the first
        # partition's
        seen = _cancel_after(monkeypatch, EX, "fetch_table", tok, calls=3)
    with pytest.raises(C.QueryCanceled):
        port.execute(sql, cancel_token=tok)
    assert len(seen) == (3 if route == "partition" else 1)
    if route == "partition":
        assert port.last_spill is None  # stopped before the merge
    assert C.current() is None
