"""Block-streamed scans in the port (exec/streaming.py), with the
reference's queries (tests/test_streaming.py): Q1, Q6 and a
high-cardinality group-by over blocks of 7000 lineitem rows equal the
whole-table run, presto_tpu streamed the same way and sqlite, in as
many blocks; a join plan and a small scan do not stream. SF0.01."""

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu_torch.testing.oracle import assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import hostsync as HS

from test_streaming import HIGH_CARD, Q1, Q6

BLOCK = 7000
STREAMED = {"q1": Q1, "q6": Q6, "high_card_groupby": HIGH_CARD}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def conn():
    return TorchTpch(scale=0.01)


def _port(conn, block_rows: int) -> TorchEngine:
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", conn)
    e.session.set("scan_block_rows", block_rows)
    return e


@pytest.mark.parametrize("name", sorted(STREAMED))
def test_streamed_equals_whole_reference_and_oracle(name, conn, tpch_tiny,
                                                    oracle):
    sql = STREAMED[name]
    streamed = _port(conn, BLOCK)
    uploads = HS.UPLOADS.by_site.get("scan-block", 0)
    got = streamed.execute(sql)
    blocks = streamed.last_streamed_blocks
    assert blocks == -(-conn.table("lineitem").nrows // BLOCK)
    # one PARTIAL program per block, then the FINAL one
    assert len(streamed.last_run.programs) == blocks + 1
    # the engine held none of the columns: each went up a block at a time
    assert HS.UPLOADS.by_site["scan-block"] - uploads >= blocks
    assert got == _port(conn, 0).execute(sql)
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    ref.session.set("scan_block_rows", BLOCK)
    assert got == ref.execute(sql)
    assert ref.last_streamed_blocks == blocks
    assert_query(streamed, oracle, sql)


def test_resident_columns_are_sliced_not_uploaded(conn):
    e = _port(conn, 0)
    want = e.execute(Q1)  # the whole-table run puts Q1's columns up
    e.session.set("scan_block_rows", BLOCK)
    uploads = HS.UPLOADS.by_site.get("scan-block", 0)
    assert e.execute(Q1) == want
    assert e.last_streamed_blocks > 1
    assert HS.UPLOADS.by_site.get("scan-block", 0) == uploads


def test_join_plan_does_not_stream(conn):
    e = _port(conn, 1000)
    got = e.execute("select count(*) from lineitem, orders "
                    "where l_orderkey = o_orderkey")
    assert e.last_streamed_blocks == 0  # two scans: another path
    assert got[0][0] > 0


def test_small_scan_does_not_stream(conn):
    e = _port(conn, 1 << 24)
    e.execute(Q6)
    assert e.last_streamed_blocks == 0
    assert len(e.last_run.programs) == 1
