"""The port's paged, bounded, acknowledged exchange data plane
(presto_tpu_torch/parallel/buffer.py, worker._emit_pages): the
counterparts of tests/test_exchange_flow.py, the cluster case over
workers on device="cpu" with rows held against presto_tpu's single
engine."""

import threading
import time

import numpy as np
import pytest
import torch

from presto_tpu_torch.parallel.buffer import OutputBuffer, TaskFailed

from tpch_queries import QUERIES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_backpressure_blocks_producer_until_drained():
    buf = OutputBuffer(1, capacity_bytes=100)
    added = []

    def produce():
        for i in range(4):
            buf.add(0, bytes(60), rows=1)
            added.append(i)
        buf.set_complete()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    time.sleep(0.3)
    # 60 bytes in flight; the second page would exceed the 100-byte cap
    assert added == [0]
    assert buf.pending_bytes == 60
    # consumer drains page 0 (token 1 acknowledges it) -> page 1 flows
    blob, nxt, complete = buf.page(0, 0)
    assert blob == bytes(60) and nxt == 1 and not complete
    blob, nxt, _ = buf.page(0, 1)
    assert blob == bytes(60) and nxt == 2
    blob, nxt, _ = buf.page(0, 2)
    assert blob is not None
    blob, nxt, _ = buf.page(0, 3)
    assert blob is not None
    blob, nxt, complete = buf.page(0, 4)
    t.join(timeout=5)
    assert not t.is_alive() and added == [0, 1, 2, 3]
    assert blob is None and complete


def test_multi_reader_page_freed_only_after_all_ack():
    buf = OutputBuffer(1, capacity_bytes=1 << 20, readers=2)
    buf.add(0, b"page0", 1)
    buf.add(0, b"page1", 1)
    buf.set_complete()
    # reader 0 reads + acks both pages
    assert buf.page(0, 0, reader=0)[0] == b"page0"
    assert buf.page(0, 1, reader=0)[0] == b"page1"
    buf.page(0, 2, reader=0)
    # pages must still be readable by reader 1
    assert buf.page(0, 0, reader=1)[0] == b"page0"
    assert buf.page(0, 1, reader=1)[0] == b"page1"
    blob, _, complete = buf.page(0, 2, reader=1)
    assert blob is None and complete
    assert buf.pending_bytes == 0  # both readers acked -> freed


def test_failed_buffer_raises_for_consumer_and_unblocks_producer():
    buf = OutputBuffer(1, capacity_bytes=10)
    buf.add(0, bytes(8), 1)

    blocked = threading.Event()

    def produce():
        try:
            buf.add(0, bytes(8), 1)  # over capacity: blocks
        except TaskFailed:
            blocked.set()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    time.sleep(0.2)
    buf.fail("worker shot")
    assert blocked.wait(timeout=5)
    with pytest.raises(TaskFailed):
        buf.page(0, 0)


def test_stage_output_streams_through_small_buffer(tpch_tiny):
    """A cluster query whose intermediate stage output is far larger
    than the producer buffer cap still answers correctly: pages stream
    through the bounded buffer while the consumer drains (end-to-end
    backpressure)."""
    from presto_tpu import Engine as RefEngine
    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.parallel import worker as wk
    from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
    from presto_tpu_torch.parallel.worker import WorkerServer

    saved = wk.PAGE_BYTES, wk.BUFFER_BYTES
    wk.PAGE_BYTES, wk.BUFFER_BYTES = 4 << 10, 16 << 10  # 4KB/16KB
    cats = {"tpch": TpchConnector(scale=0.01)}
    workers = []
    try:
        workers = [WorkerServer(cats, device="cpu").start()
                   for _ in range(2)]
        local = Engine(device="cpu")
        local.register_catalog("tpch", cats["tpch"])
        local.session.catalog = "tpch"
        local.session.set("join_distribution_type", "partitioned")
        local.session.set("require_distribution", True)
        coord = ClusterCoordinator(local)
        for w in workers:
            coord.add_worker(w.uri)
        coord.start()
        try:
            # Q3's lineitem/orders legs repartition ~tens of KB per
            # stage — dozens of 4KB pages through a 16KB cap
            got = coord.execute(QUERIES["q03"])
        finally:
            coord.stop()
            local.session.set("require_distribution", False)
        local2 = Engine(device="cpu")
        local2.register_catalog("tpch", cats["tpch"])
        local2.session.catalog = "tpch"
        assert got == local2.execute(QUERIES["q03"])
        ref = RefEngine()
        ref.register_catalog("tpch", tpch_tiny)
        assert got == ref.execute(QUERIES["q03"])
    finally:
        wk.PAGE_BYTES, wk.BUFFER_BYTES = saved
        for w in workers:
            w.stop()


def test_emit_pages_chunking_roundtrip():
    from presto_tpu_torch import types as T
    from presto_tpu_torch.block import Column
    from presto_tpu_torch.parallel import worker as wk
    from presto_tpu_torch.parallel.wire import bytes_to_columns

    n = 10_000
    cols = {"a": Column(T.BIGINT, np.arange(n, dtype=np.int64), None),
            "b": Column(T.DOUBLE, np.linspace(0, 1, n), None)}
    buf = OutputBuffer(1, capacity_bytes=1 << 30)
    saved = wk.PAGE_BYTES
    wk.PAGE_BYTES = 8 << 10
    try:
        wk._emit_pages(buf, 0, cols, n)
    finally:
        wk.PAGE_BYTES = saved
    buf.set_complete()
    token = 0
    parts = []
    while True:
        blob, token2, complete = buf.page(0, token)
        if blob is not None:
            parts.append(bytes_to_columns(blob))
        if token2 == token and complete:
            break
        token = token2
    assert len(parts) > 5  # actually chunked
    got = np.concatenate([np.asarray(p[0]["a"].data) for p in parts])
    assert np.array_equal(got, np.arange(n))
    assert sum(p[1] for p in parts) == n
