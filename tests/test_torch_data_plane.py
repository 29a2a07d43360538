"""The port's exchange data plane (presto_tpu_torch/parallel/wire.py,
buffer.py, ft/spool.py and the worker's results endpoint): the
counterparts of tests/test_data_plane.py, whose streamed-result cases
(the coordinator server's result queue, ROADMAP Queue 1 item 9) stay
with the server tier. Wire codec checks (arrow vs npz identical across
dictionary varchar, decimal limbs, live/valid masks), pages written by
the port decoded by presto_tpu, codec negotiation and transcoding,
mmap-served spool pages, and a 2-worker TPC-H Q5 on device="cpu"
answering identically on either codec and equal to presto_tpu's
single engine."""

import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.parallel import wire as REF_WIRE
from presto_tpu.testing.oracle import rows_equal

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
