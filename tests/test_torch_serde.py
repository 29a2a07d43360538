"""The fragment wire format and the page codec of the port
(presto_tpu_torch/plan/serde.py, native/, parallel/wire.py), held
against presto_tpu: the counterparts of tests/test_serde.py, then what
crosses between the two packages unchanged: each TPC-H plan's
fragment dict, a reference fragment read back by the port, pages
written by either package under both codecs, the native codec's
compressed bytes and checksums, and exchange_host.partition_ids."""

import json

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import types as RT
from presto_tpu.block import Column as RefColumn
from presto_tpu.obs import qstats as REF_QS
from presto_tpu.parallel import exchange_host as REF_XH
from presto_tpu.parallel import wire as REF_WIRE
from presto_tpu.plan.printer import format_plan as ref_format_plan
from presto_tpu.plan.serde import fragment_to_dict as ref_to_dict

from presto_tpu_torch import Engine
from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.obs import qstats as QS
from presto_tpu_torch.parallel import exchange_host as XH
from presto_tpu_torch.parallel import wire
from presto_tpu_torch.plan.fingerprint import plan_fingerprint
from presto_tpu_torch.plan.printer import format_plan
from presto_tpu_torch.plan.serde import fragment_from_dict, fragment_to_dict

from tpch_queries import QUERIES as TPCH

QUERIES = [
    "select 1",
    "select l_returnflag, count(*), sum(l_extendedprice) from lineitem "
    "where l_shipdate <= date '1998-09-02' group by l_returnflag "
    "order by l_returnflag",
    "select o_orderpriority, count(*) from orders, lineitem "
    "where o_orderkey = l_orderkey and o_totalprice > 1000 "
    "group by o_orderpriority",
    "select c_name, rank() over (partition by c_nationkey "
    "order by c_acctbal desc) from customer limit 5",
    "select distinct l_shipmode from lineitem "
    "where l_shipmode in ('AIR', 'MAIL')",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def fresh_ledgers(monkeypatch):
    """Empty divergence ledgers in both packages: the cost model reads
    what earlier queries of the process observed, and two packages
    that ran different queries would plan apart."""
    monkeypatch.setattr(REF_QS, "DIVERGENCE", REF_QS.DivergenceLedger())
    monkeypatch.setattr(QS, "DIVERGENCE", QS.DivergenceLedger())


@pytest.fixture(scope="module")
def port():
    e = Engine(device="cpu")
    e.register_catalog("tpch", TpchConnector(scale=0.01))
    return e


@pytest.fixture(scope="module")
def ref(tpch_tiny):
    e = RefEngine()
    e.register_catalog("tpch", tpch_tiny)
    return e


@pytest.mark.parametrize("sql", QUERIES)
def test_round_trip(port, sql):
    plan, _ = port.plan_sql(sql)
    d = fragment_to_dict(plan)
    restored = fragment_from_dict(json.loads(json.dumps(d)))
    assert plan_fingerprint(restored) == plan_fingerprint(plan)


@pytest.mark.parametrize("qname", sorted(TPCH))
def test_tpch_fragment_dicts_equal_the_reference(port, ref, qname,
                                                 fresh_ledgers):
    """The port's dict of each TPC-H plan is the reference's, and the
    reference's fragment reads back in the port to a plan that prints
    the same."""
    sql = TPCH[qname]
    ref_plan, _ = ref.plan_sql(sql)
    plan, _ = port.plan_sql(sql)
    want = json.loads(json.dumps(ref_to_dict(ref_plan)))
    assert json.loads(json.dumps(fragment_to_dict(plan))) == want
    assert format_plan(fragment_from_dict(want)) == \
        ref_format_plan(ref_plan)


def test_match_recognize_round_trips():
    """MatchRecognize (pattern AST, defines, measures) serializes like
    any other node."""
    from presto_tpu_torch.connectors.memory import MemoryConnector

    e = Engine(device="cpu")
    conn = MemoryConnector()
    conn.create_table(
        "ticks", {"sym_id": T.BIGINT, "ts": T.BIGINT, "price": T.BIGINT},
        {"sym_id": np.array([1, 1, 1]), "ts": np.array([1, 2, 3]),
         "price": np.array([3, 2, 5])},
        {"sym_id": None, "ts": None, "price": None})
    e.register_catalog("mem", conn)
    e.session.catalog = "mem"
    plan, _ = e.plan_sql("""
        select * from ticks match_recognize (
          partition by sym_id order by ts
          measures first(ts) as start_ts, last(price) as end_price
          pattern (strt down+ up+)
          define down as price < prev(price),
                 up as price > prev(price)
        )""")
    restored = fragment_from_dict(
        json.loads(json.dumps(fragment_to_dict(plan))))
    assert plan_fingerprint(restored) == plan_fingerprint(plan)


def test_version_check(port):
    plan, _ = port.plan_sql("select 1")
    d = fragment_to_dict(plan)
    d["version"] = 99
    with pytest.raises(ValueError):
        fragment_from_dict(d)


# ---- native page codec + framed wire format ---------------------------

def _mk_cols(Col=Column, types=T):
    rng = np.random.default_rng(7)
    n = 5000
    return {
        "k": Col(types.BIGINT, rng.integers(0, 50, n)),
        "v": Col(types.DOUBLE, rng.normal(size=n),
                 valid=rng.random(n) > 0.1),
        "s": Col(types.VARCHAR, rng.integers(0, 3, n).astype(np.int32),
                 dictionary=np.asarray(["aa", "bb", "cc"], object)),
    }


def _codecs():
    from presto_tpu.native import codec as ref_codec
    from presto_tpu_torch.native import codec
    return codec(), ref_codec()


def test_native_codec_roundtrip():
    c, _ = _codecs()
    assert c is not None, "g++ builds the codec here"
    for data in (b"", b"q", b"ratatatatatat" * 999,
                 np.arange(10000, dtype=np.int64).tobytes(),
                 np.random.default_rng(0).bytes(65536)):
        z = c.compress(data)
        assert c.decompress(z, len(data)) == data
    # CRC-32C known-answer test ('123456789' -> 0xE3069283)
    assert c.crc32c(b"123456789") == 0xE3069283


def test_native_codec_builds_into_build_dir():
    import os

    import presto_tpu_torch.native as native
    assert native.codec() is not None
    path = native._lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("build",
                                                  "presto_tpu_torch"))


@pytest.mark.parametrize("case", ["empty", "text", "ints", "random"])
def test_native_codec_bytes_equal_the_reference(case):
    """compress and crc32c give the same bytes from both libraries, and
    each decompresses the other's blocks."""
    c, rc = _codecs()
    data = {"empty": b"", "text": b"ratatatatatat" * 999,
            "ints": np.arange(10000, dtype=np.int64).tobytes(),
            "random": np.random.default_rng(0).bytes(65536)}[case]
    assert c.compress(data) == rc.compress(data)
    assert c.crc32c(data) == rc.crc32c(data)
    assert c.decompress(rc.compress(data), len(data)) == data
    assert rc.decompress(c.compress(data), len(data)) == data


def test_wire_roundtrip_framed():
    cols = _mk_cols()
    payload = wire.columns_to_bytes(cols)
    back, nrows = wire.bytes_to_columns(payload)
    assert nrows == 5000
    assert set(back) == set(cols)
    np.testing.assert_array_equal(back["k"].data, cols["k"].data)
    np.testing.assert_array_equal(back["v"].valid, cols["v"].valid)
    assert list(back["s"].dictionary) == ["aa", "bb", "cc"]


def test_wire_roundtrip_without_native(monkeypatch):
    """Pure-Python fallback must interoperate (codec -> None)."""
    import presto_tpu_torch.native as native
    cols = _mk_cols()
    framed = wire.columns_to_bytes(cols, codec="npz")
    monkeypatch.setattr(native, "_codec", None)
    plain = wire.columns_to_bytes(cols, codec="npz")
    assert plain[:4] != wire._MAGIC  # unframed npz
    back, nrows = wire.bytes_to_columns(plain)
    assert nrows == 5000
    monkeypatch.setattr(native, "_codec", False)  # rebuild lazily
    back2, _ = wire.bytes_to_columns(framed)
    np.testing.assert_array_equal(back2["k"].data, cols["k"].data)


def test_wire_corrupt_frame_detected():
    from presto_tpu_torch.native import codec
    assert codec() is not None
    # the npz codec explicitly: the CRC frame belongs to it
    payload = wire.columns_to_bytes(_mk_cols(), codec="npz")
    assert payload[:4] == wire._MAGIC
    corrupt = payload[:-3] + bytes([payload[-3] ^ 0xFF]) + payload[-2:]
    with pytest.raises((ValueError, RuntimeError)):
        wire.bytes_to_columns(corrupt)


def _same_columns(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for name in a:
        assert str(a[name].dtype) == str(b[name].dtype), name
        np.testing.assert_array_equal(np.asarray(a[name].data),
                                      np.asarray(b[name].data))
        assert (a[name].valid is None) == (b[name].valid is None), name
        if a[name].valid is not None:
            np.testing.assert_array_equal(a[name].valid, b[name].valid)
        if a[name].dictionary is not None:
            assert list(a[name].dictionary) == list(b[name].dictionary)


@pytest.mark.parametrize("codec", ["npz", "arrow"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pages_cross_packages(codec, writer):
    """A page written by either package decodes in the other to equal
    columns (both written from the same seeded data)."""
    if codec == "arrow":
        assert wire.have_arrow() and REF_WIRE.have_arrow()
    mine = _mk_cols()
    theirs = _mk_cols(RefColumn, RT)
    if writer == "port":
        blob = wire.columns_to_bytes(mine, codec=codec)
        back, n = REF_WIRE.bytes_to_columns(blob)
    else:
        blob = REF_WIRE.columns_to_bytes(theirs, codec=codec)
        back, n = wire.bytes_to_columns(blob)
    assert n == 5000
    assert wire.payload_codec(blob) == codec
    _same_columns(back, mine)


def _partition_columns(Col, types):
    """Int, string (dictionary), nullable and LONG-decimal keys."""
    rng = np.random.default_rng(11)
    n = 4000
    lo = rng.integers(-(1 << 62), 1 << 62, n)
    hi = rng.integers(-3, 3, n)
    return {
        "i": Col(types.BIGINT, rng.integers(-10 ** 12, 10 ** 12, n)),
        "s": Col(types.VARCHAR, rng.integers(0, 5, n).astype(np.int32),
                 dictionary=np.asarray(
                     ["", "x", "lineitem", "ÅSIA", "AIR"], object)),
        "nl": Col(types.INTEGER, rng.integers(0, 100, n).astype(np.int32),
                  valid=rng.random(n) > 0.3),
        "d": Col(types.DecimalType(30, 2), np.stack([lo, hi], axis=1)),
    }


@pytest.mark.parametrize("keys", [["i"], ["s"], ["nl"], ["d"],
                                  ["i", "s", "nl", "d"]])
@pytest.mark.parametrize("nparts", [3, 8])
def test_partition_ids_equal_the_reference(keys, nparts):
    """Host hash partitioning is the reference's bit for bit, so a page
    lands on the same worker in both packages."""
    got = XH.partition_ids(_partition_columns(Column, T), keys, nparts)
    want = REF_XH.partition_ids(_partition_columns(RefColumn, RT), keys,
                                nparts)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < nparts
