"""The port's exchange data plane (presto_tpu_torch/parallel/wire.py,
buffer.py, ft/spool.py and the worker's results endpoint): the
counterparts of tests/test_data_plane.py, its streamed-result cases
(the coordinator server's bounded result queue: multi-page JSON and
arrow results, backpressure, the reaper, token discipline) included.
Wire codec checks (arrow vs npz identical across
dictionary varchar, decimal limbs, live/valid masks), pages written by
the port decoded by presto_tpu, codec negotiation and transcoding,
mmap-served spool pages, and a 2-worker TPC-H Q5 on device="cpu"
answering identically on either codec and equal to presto_tpu's
single engine."""

import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.parallel import wire as REF_WIRE
from presto_tpu_torch.testing.oracle import rows_equal

from presto_tpu_torch import Engine
from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.obs import qstats as QS
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.parallel import wire

from tpch_queries import QUERIES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sample_columns(n: int = 257) -> dict:
    """Every physical layout the exchange ships: dictionary varchar
    (with -1 padding and an over-range sentinel code), LONG-decimal
    limb pairs, bool data + __live__ masks, valid siblings, dates,
    uint64 state."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 3, n).astype(np.int32)
    codes[0], codes[1] = -1, 9  # padding + over-range sentinel
    limbs = np.stack([rng.integers(0, 1 << 62, n),
                      rng.integers(-2, 2, n)], axis=1)
    return {
        "k": Column(T.BIGINT, rng.integers(0, 1 << 40, n)),
        "s": Column(T.VARCHAR, codes, rng.random(n) > 0.2,
                    np.asarray(["aa", "b", "cc"], object)),
        "dec": Column(T.DecimalType(25, 2), limbs),
        "flag": Column(T.BOOLEAN, rng.random(n) > 0.5),
        "__live__": Column(T.BOOLEAN, rng.random(n) > 0.1),
        "dt": Column(T.DATE, rng.integers(0, 20000, n).astype(np.int32)),
        "ts": Column(T.TIMESTAMP, rng.integers(0, 1 << 50, n)),
        "st": Column(T.BIGINT, rng.integers(0, 1 << 40, n)
                     .astype(np.uint64)),
    }


def _assert_columns_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for name in a:
        ca, cb = a[name], b[name]
        assert str(ca.dtype) == str(cb.dtype), name
        da, db = np.asarray(ca.data), np.asarray(cb.data)
        assert da.dtype == db.dtype, (name, da.dtype, db.dtype)
        assert np.array_equal(da, db), name
        if ca.valid is None:
            assert cb.valid is None, name
        else:
            assert np.array_equal(np.asarray(ca.valid),
                                  np.asarray(cb.valid)), name
        if ca.dictionary is None:
            assert cb.dictionary is None, name
        else:
            assert list(ca.dictionary) == list(cb.dictionary), name


# -- wire codec checks -------------------------------------------------------


@pytest.mark.parametrize("codec", ["arrow", "npz"])
def test_wire_roundtrip_exact(codec):
    cols = _sample_columns()
    blob = wire.columns_to_bytes(cols, codec=codec)
    assert wire.payload_codec(blob) == codec
    out, n = wire.bytes_to_columns(blob)
    assert n == 257
    _assert_columns_equal(cols, out)


@pytest.mark.parametrize("codec", ["arrow", "npz"])
def test_port_pages_decode_in_the_reference(codec):
    """Every layout of the exchange, written by the port, decodes in
    presto_tpu to the same physical arrays (and back)."""
    cols = _sample_columns()
    out, n = REF_WIRE.bytes_to_columns(
        wire.columns_to_bytes(cols, codec=codec))
    assert n == 257
    _assert_columns_equal(cols, out)
    back, _ = wire.bytes_to_columns(
        REF_WIRE.columns_to_bytes(out, codec=codec))
    _assert_columns_equal(cols, back)


def test_arrow_and_npz_agree_byte_identically():
    cols = _sample_columns()
    a, _ = wire.bytes_to_columns(
        wire.columns_to_bytes(cols, codec="arrow"))
    z, _ = wire.bytes_to_columns(
        wire.columns_to_bytes(cols, codec="npz"))
    _assert_columns_equal(a, z)


def test_arrow_decode_is_zero_copy_views():
    cols = _sample_columns()
    blob = wire.columns_to_bytes(cols, codec="arrow")
    out, _ = wire.bytes_to_columns(blob)
    assert not np.asarray(out["k"].data).flags.writeable
    assert not np.asarray(out["dec"].data).flags.writeable
    assert np.asarray(out["dec"].data).shape == (257, 2)


def test_object_string_columns_ride_both_codecs():
    """Host-materialized strings (object dtype, no dictionary) cross the
    wire on either codec, Nones preserved."""
    data = np.asarray(["x", None, "yy", ""], object)
    cols = {"o": Column(T.VARCHAR, data)}
    for codec in ("arrow", "npz"):
        out, n = wire.bytes_to_columns(
            wire.columns_to_bytes(cols, codec=codec))
        assert n == 4
        got = np.asarray(out["o"].data)
        assert got[1] is None and list(got[[0, 2, 3]]) == ["x", "yy", ""]


def test_transcode_and_accept_negotiation():
    cols = _sample_columns()
    arrow_blob = wire.columns_to_bytes(cols, codec="arrow")
    npz_blob = wire.transcode(arrow_blob, "npz")
    assert wire.payload_codec(npz_blob) == "npz"
    _assert_columns_equal(cols, wire.bytes_to_columns(npz_blob)[0])
    assert wire.accepted_codecs(None) == ("npz",)
    assert wire.accepted_codecs(wire.accept_header()) == ("arrow",
                                                          "npz")
    assert "arrow" in wire.accepted_codecs("*/*")


def test_arrow_file_framing_reads_back():
    cols = _sample_columns()
    stream = wire.columns_to_bytes(cols, codec="arrow")
    fb = wire.arrow_file_bytes(stream)
    assert fb[:8] == wire.ARROW_FILE_MAGIC
    assert wire.payload_codec(fb) == "arrow"
    out, n = wire.bytes_to_columns(fb)
    assert n == 257
    _assert_columns_equal(cols, out)
    assert wire.arrow_file_bytes(
        wire.columns_to_bytes(cols, codec="npz")) is None


def test_pages_to_columns_single_alloc_union_dictionaries():
    c1 = {"s": Column(T.VARCHAR, np.asarray([0, 1], np.int32), None,
                      np.asarray(["aa", "b"], object)),
          "d": Column(T.DecimalType(25, 0),
                      np.arange(4, dtype=np.int64).reshape(2, 2))}
    c2 = {"s": Column(T.VARCHAR, np.asarray([1, 0], np.int32), None,
                      np.asarray(["b", "zz"], object)),
          "d": Column(T.DecimalType(25, 0),
                      np.arange(4, 8, dtype=np.int64).reshape(2, 2))}
    blobs = [wire.columns_to_bytes(c1, codec="arrow"),
             wire.columns_to_bytes(c2, codec="npz")]
    out, n = wire.pages_to_columns(blobs)
    assert n == 4
    s = out["s"]
    decoded = [str(s.dictionary[c]) for c in np.asarray(s.data)]
    assert decoded == ["aa", "b", "zz", "b"]
    assert np.array_equal(np.asarray(out["d"].data),
                          np.arange(8).reshape(4, 2))
    one, n1 = wire.pages_to_columns([blobs[0]])
    assert n1 == 2 and list(one) == ["s", "d"]
    # the reference assembles the port's pages identically
    ref_out, ref_n = REF_WIRE.pages_to_columns(blobs)
    assert ref_n == 4
    _assert_columns_equal(out, ref_out)


def test_result_pages_compact_dictionaries():
    dictionary = np.asarray([f"w{i:04d}" for i in range(1000)], object)
    cols = {"s": Column(T.VARCHAR,
                        np.asarray([3, 3, 7], np.int32), None,
                        dictionary)}
    page = wire.compact_page_dictionaries(cols)
    assert list(page["s"].dictionary) == ["w0003", "w0007"]
    assert list(np.asarray(page["s"].data)) == [0, 0, 1]
    out, _ = wire.bytes_to_columns(
        wire.columns_to_bytes(page, codec="arrow"))
    assert [str(out["s"].dictionary[c])
            for c in np.asarray(out["s"].data)] == \
        ["w0003", "w0003", "w0007"]


# -- spool: mmap-served pages on the repair path -----------------------------


def test_spool_serves_arrow_pages_from_mmap_after_producer_death(
        tmp_path):
    from presto_tpu_torch.ft.spool import TaskSpool
    from presto_tpu_torch.parallel.buffer import OutputBuffer

    mmap_served = REGISTRY.counter(
        "presto_tpu_spool_mmap_served_pages_total")
    spool = TaskSpool(str(tmp_path))
    cols = _sample_columns()
    blob = wire.columns_to_bytes(cols, codec="arrow")
    buf = OutputBuffer(1, capacity_bytes=1 << 30,
                       spool=spool.writer("q.s.0"))
    buf.add(0, blob, 257)
    buf.set_complete()
    del buf  # the producer (and its in-memory buffer) is gone

    base = mmap_served.value()
    got, nxt, complete = spool.page("q.s.0", 0, 0)
    assert not complete and nxt == 1
    assert mmap_served.value() == base + 1
    assert bytes(got[:8]) == wire.ARROW_FILE_MAGIC
    out, n = wire.bytes_to_columns(got)
    assert n == 257
    _assert_columns_equal(cols, out)
    cols2, n2 = spool.replay_columns("q.s.0", 0)
    assert n2 == 257
    _assert_columns_equal(cols, cols2)

    nblob = wire.columns_to_bytes(cols, codec="npz")
    buf2 = OutputBuffer(1, capacity_bytes=1 << 30,
                        spool=spool.writer("q.s.1"))
    buf2.add(0, nblob, 257)
    buf2.set_complete()
    got, _, _ = spool.page("q.s.1", 0, 0)
    assert bytes(got) == nblob


def test_worker_results_endpoint_transcodes_for_npz_only_consumer():
    from presto_tpu_torch.parallel.buffer import OutputBuffer
    from presto_tpu_torch.parallel.worker import WorkerServer
    from presto_tpu_torch.server.httpbase import urlopen as _urlopen

    srv = WorkerServer({}, shared_secret=None, device="cpu")
    cols = _sample_columns()
    blob = wire.columns_to_bytes(cols, codec="arrow")
    buf = OutputBuffer(1, capacity_bytes=1 << 30)
    buf.add(0, blob, 257)
    buf.set_complete()
    srv.buffers["tq.s.0"] = buf
    srv.start()
    try:
        url = f"{srv.uri}/v1/task/tq.s.0/results/0/0"
        req = urllib.request.Request(
            url, headers={"Accept": wire.accept_header()})
        with _urlopen(req, timeout=10) as resp:
            assert resp.read() == blob
        with _urlopen(urllib.request.Request(url), timeout=10) as resp:
            body = resp.read()
        assert wire.payload_codec(body) == "npz"
        _assert_columns_equal(cols, wire.bytes_to_columns(body)[0])
    finally:
        srv.stop()


# -- 2-worker TPC-H Q5 cluster: arrow vs npz ---------------------------------


@pytest.fixture(scope="module")
def q5_runs(tpch_tiny):
    """Q5 over a 2-worker cluster, partitioned, on each codec; the
    exchange bytes each moved, and the system.tasks rows after."""
    from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
    from presto_tpu_torch.parallel.worker import WorkerServer

    conn = TpchConnector(scale=0.01)
    served = REGISTRY.counter("presto_tpu_exchange_bytes_total")
    workers, coord = [], None
    local = Engine(device="cpu")
    local.register_catalog("tpch", conn)
    local.session.catalog = "tpch"
    local.session.set("join_distribution_type", "partitioned")
    local.session.set("require_distribution", True)
    out = {}
    try:
        workers = [WorkerServer({"tpch": conn}, device="cpu").start()
                   for _ in range(2)]
        coord = ClusterCoordinator(local)
        for w in workers:
            coord.add_worker(w.uri)
        coord.start()
        for codec in ("arrow", "npz"):
            before = sum(served.value(node=w.node_id, codec=codec)
                         for w in workers)
            local.session.set("exchange_wire_codec", codec)
            out[codec] = coord.execute(QUERIES["q05"])
            out[f"{codec}_bytes"] = sum(
                served.value(node=w.node_id, codec=codec)
                for w in workers) - before
        out["tasks"] = local.execute(
            "select stage, exchange_bytes_arrow, exchange_bytes_npz "
            "from system.tasks")
    finally:
        if coord is not None:
            coord.stop()
        for w in workers:
            w.stop()
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    out["ref"] = ref.execute(QUERIES["q05"])
    return out


def test_q5_cluster_byte_identical_across_codecs(q5_runs):
    """Q5 (dictionary varchar nation names, decimal revenue,
    partitioned multi-stage exchange) answers identically whether the
    exchange runs arrow or npz, and equals presto_tpu's single
    engine."""
    assert q5_runs["arrow_bytes"] > 0  # pages really moved as arrow
    assert q5_runs["npz_bytes"] > 0
    assert q5_runs["arrow"] == q5_runs["npz"]
    ok, msg = rows_equal(q5_runs["arrow"], q5_runs["ref"], ordered=True)
    assert ok, msg


def test_exchange_bytes_by_codec_in_system_tasks(q5_runs):
    """The qstats codec split surfaces in system.tasks: the two Q5 runs
    pulled bytes under each codec."""
    rows = q5_runs["tasks"]
    assert sum(r[1] for r in rows) > 0
    assert sum(r[2] for r in rows) > 0


def test_emitted_bytes_split_by_codec():
    with QS.task("tq.codec.0", node="w") as rec:
        QS.note_emitted_page(100, spooled=False, codec="arrow")
        QS.note_emitted_page(40, spooled=False, codec="npz")
        QS.note_emitted_page(60, spooled=False, codec="arrow")
    snap = rec.snapshot()
    assert snap["emittedBytesByCodec"] == {"arrow": 160, "npz": 40}
    assert snap["pagesEmitted"] == 3


def test_wire_metrics_histograms_advance():
    enc = REGISTRY.histogram("presto_tpu_wire_encode_seconds")
    dec = REGISTRY.histogram("presto_tpu_wire_decode_seconds")
    e0 = enc.count(codec="arrow")
    d0 = dec.count(codec="arrow")
    blob = wire.columns_to_bytes(_sample_columns(), codec="arrow")
    wire.bytes_to_columns(blob)
    assert enc.count(codec="arrow") == e0 + 1
    assert dec.count(codec="arrow") == d0 + 1


# -- chip_smoke's phase 10 rehearsed on the CPU -------------------------------


def test_chip_smoke_cluster_cases_on_the_cpu(monkeypatch):
    """Phase 10 of chip_smoke.py at SF0.01 with every engine on the CPU
    (its card calls stubbed): C1-C5's checks hold against one engine's
    rows and the numpy checks, C3's crash and straggler recover, C4
    runs both codecs, C5 re-plans; the plain-version cases compare.
    The launch counts need the card: here they stay empty."""
    import sys
    from pathlib import Path

    import presto_tpu_torch
    from presto_tpu_torch.parallel import worker as W

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)

    # the phase asks for the card; every engine it makes goes on the CPU
    class CpuEngine(Engine):
        def __init__(self, *args, device=None, **kw):
            super().__init__(*args, device="cpu", **kw)

    class CpuWorker(W.WorkerServer):
        def __init__(self, *args, device=None, **kw):
            super().__init__(*args, device="cpu", **kw)

    monkeypatch.setattr(presto_tpu_torch, "Engine", CpuEngine)
    monkeypatch.setattr(W, "WorkerServer", CpuWorker)
    conn = TpchConnector(scale=0.01)
    one = Engine(device="cpu")
    one.register_catalog("tpch", conn)
    local = {q: one.execute(chip_smoke.QUERIES[q])
             for q in ("q03", "q05", "q06", "q09", "lineitem_partsupp")}
    out = chip_smoke.cluster_cases(conn, conn, local, {})
    assert "torch:agg_sum" in out["notes"]
    assert "torch:agg_sum" in out["coordinator_notes"]
    assert out["launches"] == {}
    assert {f"C1 {q}" for q in chip_smoke.CLUSTER_PARTIALS} <= set(out)
    assert {f"C2 {q}" for q in chip_smoke.CLUSTER_FRAGMENTS} <= set(out)
    assert out["C4 npz"] == out["C4 arrow"] == out["C2 q05"]
    chip_smoke.plain_cluster_cases(conn)


# -- streaming result delivery (the coordinator server) ----------------


@pytest.fixture(scope="module")
def stream_server(request):
    from presto_tpu_torch.server import CoordinatorServer

    engine = Engine(device="cpu")
    engine.register_catalog("tpch", TpchConnector(scale=0.01))
    srv = CoordinatorServer(engine).start()
    request.addfinalizer(srv.stop)
    return srv


def test_streamed_multipage_select_matches_buffered(stream_server):
    """A > PAGE_ROWS SELECT streams through the bounded queue; JSON
    and arrow result modes return identical rows, and the true row
    total is reported at page-emit time (not len(q.rows) == 0)."""
    from presto_tpu_torch.client import Client

    base = f"http://127.0.0.1:{stream_server.port}"
    sql = ("select l_orderkey, l_extendedprice, l_shipdate, "
           "l_shipinstruct from lineitem")
    cols_j, rows_j = Client(base, user="t").execute(sql)
    cols_a, rows_a = Client(base, user="t",
                            result_format="arrow").execute(sql)
    assert len(rows_j) > 4096  # really multi-page
    assert cols_j == cols_a
    assert rows_j == rows_a
    # emit-time stats: the streamed query reports its true total
    mgr = stream_server.manager
    done = [q for q in mgr.snapshot()
            if q.sql == sql and q.state == "FINISHED"]
    assert done
    for q in done:
        assert q.stats()["processedRows"] == len(rows_j)
        assert q.rows_done() == len(rows_j)


def test_streamed_rows_match_engine_values(stream_server):
    """Decimal/date JSON encodings survive the streamed path exactly
    as the old buffered path produced them."""
    from presto_tpu_torch.client import Client

    base = f"http://127.0.0.1:{stream_server.port}"
    _, rows = Client(base, user="t").execute(
        "select o_totalprice, o_orderdate from orders "
        "order by o_orderkey limit 3")
    assert all(isinstance(r[0], str) and "." in r[0] for r in rows)
    assert all(len(r[1]) == 10 for r in rows)


def test_result_queue_backpressure_and_reaper(stream_server,
                                              monkeypatch):
    """Slow client => bounded queue => the producer BLOCKS holding
    O(page) memory; the reaper can still kill it, unblocking the
    dispatcher thread promptly."""
    import presto_tpu_torch.server.server as S
    from presto_tpu_torch.client import Client

    monkeypatch.setattr(S, "RESULT_QUEUE_PAGES", 2)
    base = f"http://127.0.0.1:{stream_server.port}"
    mgr = stream_server.manager
    c = Client(base, user="t")
    qid, _ = c.submit("select l_orderkey from lineitem")
    q = None
    for _ in range(400):
        q = mgr.get(qid)
        if q is not None and q.result is not None \
                and q.result.depth >= 2:
            break
        time.sleep(0.05)
    assert q is not None and q.result is not None
    assert q.state == "RUNNING"
    assert q.result.depth == 2  # full: producer parked
    emitted = q.result.rows_emitted
    time.sleep(0.4)
    assert q.result.rows_emitted == emitted  # no progress while full
    assert emitted <= 3 * S.PAGE_ROWS  # O(page), not O(result)

    t0 = time.monotonic()
    mgr.reap(q, "test kill", kind="run")
    for _ in range(100):
        if mgr.get(qid).state == "FAILED":
            break
        time.sleep(0.05)
    assert mgr.get(qid).state == "FAILED"
    # the dispatcher thread freed: a follow-up query runs promptly
    _, rows = c.execute("select 1")
    assert rows == [[1]] and time.monotonic() - t0 < 10


def test_result_queue_token_discipline():
    """Exchange-buffer token semantics: idempotent re-get of the
    current token, loud failure below the freed watermark, idle-abort
    when the client vanishes."""
    from presto_tpu_torch.server.results import ResultAbandoned, ResultQueue

    queue = ResultQueue(max_pages=4)
    for i in range(3):
        queue.put([f"p{i}"], 1)
    queue.close()
    assert queue.get(0, poll_s=0)[0] == ["p0"]
    assert queue.get(0, poll_s=0)[0] == ["p0"]  # retry: same page
    assert queue.get(1, poll_s=0)[0] == ["p1"]
    assert queue.get(2, poll_s=0)[0] == ["p2"]
    with pytest.raises(ResultAbandoned):
        queue.get(0, poll_s=0)  # below the freed watermark
    payload, _, done = queue.get(3, poll_s=0)
    assert payload is None and done
    assert queue.drained and queue.rows_emitted == 3

    # a producer abandoned by its client aborts instead of pinning
    # its dispatcher thread forever
    q2 = ResultQueue(max_pages=1)
    q2.IDLE_ABORT_S = 0.3
    q2.put(["a"], 1)
    aborted = []

    def _blocked_put():
        try:
            q2.put(["b"], 1)
        except ResultAbandoned as e:
            aborted.append(e)

    t = threading.Thread(target=_blocked_put)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and aborted
    # the abort released the buffered pages (and their depth-gauge
    # contribution) — an abandoned query must not pin either
    assert q2.depth == 0


def test_below_watermark_token_fails_loudly_over_http(stream_server):
    """A re-requested token below the freed watermark on a FINISHED
    query answers a terminal error envelope — not an eternal
    nextUri loop."""
    import json
    import urllib.request

    from presto_tpu_torch.client import Client
    from presto_tpu_torch.server.httpbase import urlopen as _urlopen

    base = f"http://127.0.0.1:{stream_server.port}"
    c = Client(base, user="t")
    qid, _ = c.submit("select l_orderkey from lineitem limit 9000")
    mgr = stream_server.manager
    for _ in range(200):
        q = mgr.get(qid)
        if q is not None and q.state == "FINISHED":
            break
        time.sleep(0.05)
    assert mgr.get(qid).state == "FINISHED"

    def get(token):
        req = urllib.request.Request(
            f"{base}/v1/statement/executing/{qid}/{token}",
            headers={"X-Trino-User": "t"})
        with _urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    assert get(0).get("data")
    assert get(2).get("data")  # acks pages 0 and 1 away
    out = get(0)  # below the watermark: loud terminal error
    assert out["error"]["errorName"] == "RESULT_PAGES_RELEASED"
    assert "nextUri" not in out


def test_reaper_releases_abandoned_finished_stream(stream_server):
    """A client that submits, never fetches, and vanishes must not
    pin its queued pages (or the depth gauge) forever: the reaper
    sweep releases a FINISHED query's undrained queue after the idle
    window."""
    from presto_tpu_torch.client import Client

    base = f"http://127.0.0.1:{stream_server.port}"
    c = Client(base, user="t")
    qid, _ = c.submit("select n_nationkey from nation")
    mgr = stream_server.manager
    q = None
    for _ in range(200):
        q = mgr.get(qid)
        if q is not None and q.state == "FINISHED":
            break
        time.sleep(0.05)
    assert q.state == "FINISHED" and q.result.depth > 0
    q.result.IDLE_ABORT_S = 0.4  # shrink the idle window
    q.finished -= 1.0            # and pretend it finished a while ago
    for _ in range(100):
        if q.result.depth == 0:
            break
        time.sleep(0.05)
    assert q.result.depth == 0  # pages + gauge contribution released
