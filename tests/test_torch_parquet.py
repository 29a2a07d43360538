"""The port's parquet read path (presto_tpu_torch/formats/parquet.py and
connectors/parquet.py) against the reference's reader and connector and
against pyarrow, on the same pyarrow-written files: the cases of
tests/test_parquet.py (snappy, plain and v2 pages; nulls; short and long
decimals; dates; booleans), every value identical to the reference
reader's and to pyarrow's; the port's vectorized decodes (the converted
dictionary page, fixed-length decimals, batched bit-packed runs, the
VARCHAR columns' codes and dictionaries) identical to the reference's
per-value ones; TPC-H Q1, Q3, Q5 and Q6 at SF0.01 over parquet equal to
presto_tpu's over the same files; row-group pruning equal to the
reference's apply_filter; and chip_smoke's phase 12 rehearsed on the
CPU."""

from __future__ import annotations

import datetime
import decimal
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from presto_tpu import Engine as RefEngine  # noqa: E402
from presto_tpu.connectors.expression import (  # noqa: E402
    ColumnExpr as RefColumn, ComparisonExpr as RefComparison,
    ConstantExpr as RefConstant)
from presto_tpu.connectors.parquet import (  # noqa: E402
    ParquetConnector as RefParquet)
from presto_tpu.formats import parquet as RF  # noqa: E402

from presto_tpu_torch import Engine, types as T  # noqa: E402
from presto_tpu_torch.connectors.expression import (  # noqa: E402
    ColumnExpr, ComparisonExpr, ConstantExpr)
from presto_tpu_torch.connectors.parquet import (  # noqa: E402
    ParquetConnector)
from presto_tpu_torch.connectors.tpch import TpchConnector  # noqa: E402
from presto_tpu_torch.formats import parquet as PF  # noqa: E402

from tpch_queries import QUERIES  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

COLUMNS = ("id", "grp", "price", "name", "flag", "d", "maybe", "dec",
           "sdec", "note")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pq_dir(tmp_path_factory):
    """tests/test_parquet.py's files, with a short decimal (negative
    values too) and a VARCHAR with nulls and empty strings besides."""
    d = tmp_path_factory.mktemp("pq")
    rng = np.random.default_rng(0)
    n = 5000
    tbl = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "grp": pa.array(rng.integers(0, 50, n).astype(np.int32)),
        "price": pa.array(rng.uniform(0, 1000, n)),
        "name": pa.array([f"item_{i % 97}" for i in range(n)]),
        "flag": pa.array(rng.random(n) > 0.5),
        "d": pa.array((np.arange(n) % 900).astype(np.int32),
                      type=pa.date32()),
        "maybe": pa.array([None if i % 7 == 0 else float(i)
                           for i in range(n)]),
        "dec": pa.array([None if i % 11 == 0 else i * 7 - 20_000
                         for i in range(n)],
                        type=pa.decimal128(25, 2)),
        "sdec": pa.array([decimal.Decimal(int(v)) / 100 for v in
                          rng.integers(-10 ** 9, 10 ** 9, n)],
                         type=pa.decimal128(12, 2)),
        "note": pa.array([None if i % 5 == 0 else "x" * (i % 13)
                          for i in range(n)]),
    })
    pq.write_table(tbl, os.path.join(d, "t.parquet"),
                   compression="snappy")
    pq.write_table(tbl, os.path.join(d, "t_plain.parquet"),
                   compression="none", use_dictionary=False)
    pq.write_table(tbl, os.path.join(d, "t_v2.parquet"),
                   compression="snappy", data_page_version="2.0")
    return str(d)


def _same(a, b) -> bool:
    """Equal values, NaN equal to NaN and a float's sign kept."""
    if isinstance(a, float) and isinstance(b, float):
        return (a == b or (a != a and b != b)) and \
            np.signbit(a) == np.signbit(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("fname", ["t", "t_plain", "t_v2"])
def test_reader_equals_the_reference_reader(pq_dir, fname):
    path = os.path.join(pq_dir, fname + ".parquet")
    ref, port = RF.ParquetFile(path), PF.ParquetFile(path)
    assert port.num_rows == ref.num_rows == 5000
    assert [dataclass_fields(c) for c in port.columns] == \
        [dataclass_fields(c) for c in ref.columns]
    for cname in COLUMNS:
        (rv, rok), (pv, pok) = ref.read_column(cname), port.read_column(
            cname)
        assert pv.dtype == rv.dtype and pv.shape == rv.shape, cname
        assert (rok is None) == (pok is None), cname
        if rok is not None:
            assert np.array_equal(rok, pok), cname
        assert all(map(_same, pv.reshape(len(pv), -1).tolist()
                       if pv.ndim == 2 else pv.tolist(),
                       rv.reshape(len(rv), -1).tolist()
                       if rv.ndim == 2 else rv.tolist())), cname


def dataclass_fields(col) -> tuple:
    return (col.name, col.ptype, col.optional, col.type_length,
            col.converted, col.scale, col.precision)


def _unscaled(words) -> int:
    """A decimal's unscaled integer from its int64 word (short) or its
    [low, high] words (long, two's complement over 128 bits)."""
    words = np.atleast_1d(words)
    raw = int(words[0])
    if len(words) > 1:
        raw = (int(words[1]) << 64) + (raw & ((1 << 64) - 1))
    return raw


def _decimal(words, scale: int) -> decimal.Decimal:
    return decimal.Decimal(_unscaled(words)).scaleb(-scale)


@pytest.mark.parametrize("fname", ["t", "t_plain", "t_v2"])
def test_reader_matches_pyarrow(pq_dir, fname):
    """Every row of every column against pyarrow's values."""
    path = os.path.join(pq_dir, fname + ".parquet")
    f = PF.ParquetFile(path)
    ref = pq.read_table(path)
    for cname in COLUMNS:
        vals, valid = f.read_column(cname)
        want = ref.column(cname).to_pylist()
        for i, w in enumerate(want):
            if w is None:
                assert valid is not None and not valid[i], (cname, i)
                continue
            assert valid is None or valid[i], (cname, i)
            g = vals[i]
            if cname in ("dec", "sdec"):
                g = _decimal(g, 2)
            elif cname == "d":
                w = (w - datetime.date(1970, 1, 1)).days
            assert g == w, (cname, i, g, w)


def test_snappy_matches_the_reference_and_pyarrow():
    """The reference's stream, and overlapping copies of every period
    (one byte up to past a copy's length), literal runs of each length
    class and random bytes."""
    rng = np.random.default_rng(3)
    streams = [b"abcabcabcabcabc" * 20 + os.urandom(64) + b"x" * 300]
    for period in (1, 2, 3, 4, 7, 8, 31, 64, 65):
        unit = rng.integers(0, 256, period, dtype=np.uint8).tobytes()
        streams.append(rng.integers(0, 256, 50, dtype=np.uint8).tobytes()
                       + unit * (5000 // period) + unit[:period // 2])
    streams.append(rng.integers(0, 4, 70_000, dtype=np.uint8).tobytes())
    for raw in streams:
        comp = pa.compress(raw, codec="snappy", asbytes=True)
        assert PF.snappy_decompress(comp) == RF.snappy_decompress(comp) \
            == raw


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 9, 13, 17, 20, 31, 32,
                                   33, 57, 58, 63, 64])
def test_rle_bit_packed_runs_equal_the_reference(width):
    """A hybrid stream of RLE runs and bit-packed runs (groups of 8,
    the last cut short) decodes as the reference's decoder does."""
    rng = np.random.default_rng(width)
    hi = (1 << min(width, 62)) if width < 64 else 1 << 62
    runs, buf = [], bytearray()

    def varint(v):
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)
    for k in range(6):
        if k % 2:
            v = int(rng.integers(0, hi))
            buf += varint(17 << 1) + v.to_bytes((width + 7) // 8,
                                                 "little")
            runs.append(17)
        else:
            groups = int(rng.integers(1, 5))
            vals = rng.integers(0, hi, groups * 8, dtype=np.int64)
            if width == 64:
                vals = vals - (1 << 61)
            bits = ((vals[:, None].astype(np.uint64)
                     >> np.arange(width, dtype=np.uint64))
                    & np.uint64(1)).astype(np.uint8)
            buf += varint(groups << 1 | 1) + np.packbits(
                bits.reshape(-1), bitorder="little").tobytes()
            runs.append(groups * 8)
    count = sum(runs) - 5
    got = PF.rle_bp_decode(bytes(buf), width, count)
    assert np.array_equal(got, RF.rle_bp_decode(bytes(buf), width, count))


@pytest.mark.parametrize("precision", [9, 12, 18, 25, 36])
def test_fixed_decimals_equal_the_reference(precision):
    """FIXED_LEN_BYTE_ARRAY decimals of every byte width pyarrow picks,
    short and long, at their extremes and around zero."""
    rng = np.random.default_rng(precision)
    top = 10 ** precision - 1
    vals = [0, 1, -1, top, -top, 10 ** (precision // 2),
            -(10 ** (precision // 2))]
    vals += [int(v) for v in rng.integers(-(1 << 62), 1 << 62, 200)
             if abs(int(v)) <= top]
    with decimal.localcontext() as ctx:
        ctx.prec = 60  # the default 28 digits would round a long value
        tbl = pa.table({"v": pa.array([decimal.Decimal(v).scaleb(-2)
                                       for v in vals],
                                      type=pa.decimal128(precision, 2))})
    for kw in (dict(use_dictionary=False), dict()):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "t.parquet")
            pq.write_table(tbl, path, compression="none", **kw)
            (got, _), (want, _) = (PF.ParquetFile(path).read_column("v"),
                                   RF.ParquetFile(path).read_column("v"))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert [_unscaled(g) for g in got] == vals


@pytest.mark.parametrize("fname", ["t", "t_plain", "t_v2"])
def test_connector_tables_equal_the_reference_connector(pq_dir, fname):
    """Every column's data, validity and dictionary: a VARCHAR column's
    codes and sorted dictionary (a null row's ``None`` fill among them)
    come out as block.dictionary_encode makes them of the reference's
    per-row values."""
    ref, port = RefParquet(pq_dir), ParquetConnector(pq_dir)
    a, b = ref.table(fname), port.table(fname)
    assert a.nrows == b.nrows
    assert list(a.columns) == list(b.columns)
    for cname, ca in a.columns.items():
        cb = b.columns[cname]
        assert str(ca.dtype) == str(cb.dtype), cname
        assert np.array_equal(np.asarray(ca.data), np.asarray(cb.data)), \
            cname
        assert (ca.valid is None) == (cb.valid is None), cname
        if ca.valid is not None:
            assert np.array_equal(ca.valid, cb.valid), cname
        assert (ca.dictionary is None) == (cb.dictionary is None), cname
        if ca.dictionary is not None:
            assert list(ca.dictionary) == list(cb.dictionary), cname


def test_all_null_chunk_fills_like_the_reference(tmp_path):
    """A VARCHAR row group with no present value: the reference's scatter
    fills it with b"" (not None), and its dictionary_encode reads that
    as a string of its own; the port's codes say the same."""
    tbl = pa.table({"s": pa.array([None] * 100 + ["a", None, "b"] * 50,
                                  pa.string())})
    pq.write_table(tbl, str(tmp_path / "t.parquet"), row_group_size=100)
    a = RefParquet(str(tmp_path)).table("t").columns["s"]
    b = ParquetConnector(str(tmp_path)).table("t").columns["s"]
    assert np.array_equal(a.data, b.data)
    assert list(a.dictionary) == list(b.dictionary)
    assert np.array_equal(a.valid, b.valid)


def test_connector_schema_and_stats(pq_dir):
    conn = ParquetConnector(pq_dir)
    assert set(conn.table_names()) == {"t", "t_plain", "t_v2"}
    schema = conn.table_schema("t")
    assert schema["id"] == T.BIGINT
    assert schema["price"] == T.DOUBLE
    assert schema["name"] == T.VARCHAR
    assert schema["d"] == T.DATE
    assert schema["flag"] == T.BOOLEAN
    assert isinstance(schema["dec"], T.DecimalType) \
        and schema["dec"].precision == 25 and schema["dec"].is_long
    assert not schema["sdec"].is_long
    assert conn.row_count_estimate("t") == 5000
    # the reference's row counts alone: a file declares no keys
    assert conn.unique_keys("t") == [] and conn.ndv_estimates("t") == {}
    assert conn.column_range_estimates("t") == {}
    ref = RefParquet(pq_dir)
    assert {k: str(v) for k, v in schema.items()} == \
        {k: str(v) for k, v in ref.table_schema("t").items()}


def test_footer_metadata_declares_nothing_to_the_planner(tmp_path):
    """A footer's key/value metadata (here a claim of a unique key, as a
    rewrite of a filtered or concatenated table carries its source's
    metadata) reaches no planner statistic: the connector plans on the
    kept row groups' counts alone, as the reference's does."""
    import json
    tbl = pa.table({"k": pa.array(np.arange(1000, dtype=np.int64) % 10),
                    "g": pa.array(np.arange(1000, dtype=np.int64) % 7)})
    pq.write_table(tbl.replace_schema_metadata(
        {"statistics": json.dumps({"unique_keys": [["k"]]})}),
        str(tmp_path / "t.parquet"), row_group_size=100)
    port, ref = ParquetConnector(str(tmp_path)), RefParquet(str(tmp_path))
    # no row group can hold k < 0: one is kept for the scan's shape
    token = port.apply_filter("t", [
        ComparisonExpr("<", ColumnExpr("k"), ConstantExpr(0))])
    assert token == ref.apply_filter("t", [
        RefComparison("<", RefColumn("k"), RefConstant(0))]) == "t#rg:0=0"
    for name, rows in (("t", 1000), (token, 100)):
        for conn in (port, ref):
            assert conn.unique_keys(name) == []
            assert conn.ndv_estimates(name) == {}
            assert conn.column_range_estimates(name) == {}
            assert conn.stats(name).row_count == rows
        assert port.stats(name).ndv == ref.stats(name).ndv


def test_sql_over_parquet_equals_the_reference(pq_dir):
    sql = ("select grp, count(*) as c, sum(price) as s, "
           "count(maybe) as nm, min(name) as mn, sum(dec) as sd, "
           "max(sdec) as ms, count(note) as cn "
           "from t group by grp order by grp limit 7")
    port = Engine(device="cpu")
    port.register_catalog("pq", ParquetConnector(pq_dir))
    port.session.catalog = "pq"
    ref = RefEngine()
    ref.register_catalog("pq", RefParquet(pq_dir))
    ref.session.catalog = "pq"
    got, want = port.execute(sql), ref.execute(sql)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 1e-9 * abs(float(w[2]))


@pytest.fixture(scope="module")
def tpch_files(tmp_path_factory):
    """The port's TPC-H tables at SF0.01 written by chip_smoke's writer
    (phase 12's files: plain, dictionary-encoded, v2 and snappy pages),
    the sorted lineitem in groups of 8192."""
    d = tmp_path_factory.mktemp("tpch_pq")
    tables, srt = str(d / "tables"), str(d / "sorted")
    os.makedirs(tables)
    os.makedirs(srt)
    conn = TpchConnector(scale=0.01)
    CS.write_tpch_parquet(conn, tables, srt, 8192)
    return conn, tables, srt


def test_written_tables_read_back_as_the_connectors(tpch_files):
    """Each written table decodes to the generator's values."""
    conn, tables, _ = tpch_files
    pconn = ParquetConnector(tables)
    assert pconn.table_names() == sorted(conn.table_names())
    for name in conn.table_names():
        a, b = conn.table(name), pconn.table(name)
        assert a.nrows == b.nrows
        for cname, ca in a.columns.items():
            cb = b.columns[cname]
            if ca.dictionary is not None:
                assert np.array_equal(
                    np.asarray(ca.dictionary, object)[np.asarray(ca.data)],
                    np.asarray(cb.dictionary, object)[cb.data]), cname
            else:
                assert np.array_equal(np.asarray(ca.data),
                                      np.asarray(cb.data)), cname
        assert pconn.row_count_estimate(name) == a.nrows
        assert pconn.unique_keys(name) == []


@pytest.mark.parametrize("q", ["q01", "q03", "q05", "q06"])
def test_tpch_over_parquet_equals_presto_tpu(tpch_files, q):
    """The port over the files against presto_tpu over the same files
    (floats within 1e-9 relative plus 1e-12 absolute)."""
    _conn, tables, _ = tpch_files
    port = Engine(device="cpu")
    port.register_catalog("tpch", ParquetConnector(tables))
    ref = RefEngine()
    ref.register_catalog("tpch", RefParquet(tables))
    got, want = port.execute(QUERIES[q]), ref.execute(QUERIES[q])
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert abs(x - y) <= 1e-9 * abs(y) + 1e-12, (q, g, w)
            else:
                assert x == y, (q, g, w)


@pytest.mark.parametrize("conjuncts", [
    [(">=", "l_shipdate", 8766), ("<", "l_shipdate", 9131)],
    [("=", "l_shipdate", 9000)],
    [("<", "l_shipdate", 8000)],
    [(">", "l_orderkey", 40_000), ("<=", "l_shipdate", 9500)],
    [("<>", "l_shipdate", 9000)],
    [(">", "l_shipdate", 20_000)],
])
def test_pruning_keeps_the_reference_row_groups(tpch_files, conjuncts):
    """apply_filter over the l_shipdate-sorted lineitem names the same
    constrained table (the same kept row groups) as the reference's,
    and the scan's estimate counts the kept groups' rows."""
    _conn, _tables, srt = tpch_files
    port, ref = ParquetConnector(srt), RefParquet(srt)
    tok = port.apply_filter("lineitem", [
        ComparisonExpr(op, ColumnExpr(c), ConstantExpr(v))
        for op, c, v in conjuncts])
    want = ref.apply_filter("lineitem", [
        RefComparison(op, RefColumn(c), RefConstant(v))
        for op, c, v in conjuncts])
    assert tok == want
    if tok is not None:
        assert port.row_count_estimate(tok) == ref.row_count_estimate(tok)
        assert port.table(tok).nrows == ref.table(tok).nrows


def test_q06_over_sorted_lineitem_prunes_and_keeps_rows(tpch_files):
    """The optimizer offers Q6's date range to the connector: its plan
    scans a constrained lineitem of fewer row groups, and its rows are
    the tpch connector's."""
    conn, _tables, srt = tpch_files
    e = Engine(device="cpu")
    e.register_catalog("tpch", ParquetConnector(srt))
    groups = len(ParquetConnector(srt)._meta("lineitem")[0].row_groups)
    kept = CS.kept_row_groups(e, QUERIES["q06"])
    assert groups > 1 and len(kept) == 1 and kept[0] < groups
    whole = Engine(device="cpu")
    whole.register_catalog("tpch", conn)
    assert e.execute(QUERIES["q06"]) == whole.execute(QUERIES["q06"])


def test_q05_keyless_expansion_counts_the_join(tpch_files):
    """chip_smoke's numpy count of Q5's join of lineitem's ASIA suppliers
    with customer on the nation alone (the join that keeps Q5 over
    keyless files off the card at SF1) equals the engine's count of the
    same join, and exceeds lineitem's rows."""
    conn, _tables, _srt = tpch_files
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    [(want,)] = e.execute(
        "select count(*) from lineitem, supplier, nation, region, customer "
        "where l_suppkey = s_suppkey and s_nationkey = n_nationkey "
        "and n_regionkey = r_regionkey and r_name = 'ASIA' "
        "and c_nationkey = s_nationkey")
    assert CS.q05_keyless_expansion(conn) == want
    assert want > conn.table("lineitem").nrows


def test_chip_smoke_parquet_cases_on_the_cpu(monkeypatch, tmp_path):
    """Phase 12 of chip_smoke.py at SF0.01 with every engine on the CPU
    (its card calls stubbed): the files written and read, every query's
    rows on both backends equal to the tpch connector's, Q6 over the
    sorted lineitem pruned, the kernels of the parquet plans' tags
    named. The launch counts need the card: here they stay 0."""
    import presto_tpu_torch

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)

    class CpuEngine(Engine):
        def __init__(self, *args, device=None, **kw):
            super().__init__(*args, device="cpu", **kw)

    monkeypatch.setattr(presto_tpu_torch, "Engine", CpuEngine)
    out = CS.parquet_cases(TpchConnector(scale=0.01), str(tmp_path), 8192,
                           over_memory=False)
    assert set(out["rows"]) == set(CS.PARQUET_QUERIES)
    assert not any(out["launches"].values())
    # no unique join over files without keys: sums, extrema, compaction
    assert out["kernels"] == ["filter_compact", "segment_max",
                              "segment_min", "segment_sum"]
