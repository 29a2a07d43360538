"""The scalar function library of ROADMAP Queue 1 item 3a through
presto_tpu_torch.Engine(device="cpu") at SF0.01:

- the SQL of tests/test_functions.py (math, strings, dates, the regexp
  family, JSON, the math tail, bitwise, width_bucket, char, URL and
  binary-string functions, if/typeof), tests/test_datetime.py (all but
  the server tier's test) and tests/test_null_semantics.py, each held
  against presto_tpu and, where the test states them, its values; the
  conditional scalars, two-column concat and the mod tests are in
  tests/test_torch_expressions.py;
- the queries of chip_smoke.py's ``functions`` phase: F1-F3 (every new
  aggregate, the sketches) against presto_tpu, F4-F7 (dates, strings
  over part joined to lineitem, numbers, varchar to number) against
  sqlite, with the functions sqlite lacks given to it as python
  functions;
- two faults of the reference, held against sqlite only (ROADMAP R7,
  R8): ``sign`` over a LONG decimal, and ``date_format``'s dictionary,
  which must be unique for a string comparison or a group by to hold.
"""

import datetime
import math
import re

import numpy as np
import pytest
import torch

from presto_tpu_torch.testing.oracle import assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.expr import compile as PC

from chip_smoke import FUNCTION_QUERIES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel, and torch's default of one
    OpenMP thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port():
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(scale=0.01))
    return e


def _same(got, want):
    """Rows equal; floats within 1e-12 relative (R2)."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and not isinstance(a, bool):
                assert (math.isnan(a) and math.isnan(b)) or a == pytest.approx(
                    b, rel=1e-12, abs=1e-12), (got, want)
            else:
                assert a == b, (got, want)


def test_every_reference_scalar_is_ported():
    from presto_tpu.expr import compile as RC
    array_map_lambda = {
        "all_match", "any_match", "array_concat_fn", "array_ctor",
        "array_distinct", "array_max", "array_min", "array_position",
        "array_sort_fn", "array_sum", "cardinality", "element_at",
        "filter", "map_ctor", "map_keys", "map_values", "none_match",
        "reduce", "sequence", "split", "subscript", "transform"}
    assert set(RC.SCALARS) - array_map_lambda <= set(PC.SCALARS)


# -- constant SQL of the reference tests, with their stated values ------------

U = "'https://user@example.com:8443/a/b?k=v&z=#frag'"
CONSTANT_SQL = {
    # tests/test_functions.py
    "math_scalars": (
        "select sqrt(4.0), power(2, 10), floor(2.7), ceil(2.1), ln(1.0), "
        "log2(8.0), log10(100.0), exp(0.0), cbrt(27.0), sign(-5), "
        "mod(10, 3), truncate(2.9), truncate(-2.9)", None),
    "string_scalars": (
        "select trim('  x  '), ltrim('  x'), rtrim('x  '), "
        "replace('abcabc', 'b', 'Z'), reverse('abc'), "
        "strpos('hello', 'll'), strpos('hello', 'zz'), "
        "starts_with('hello', 'he'), length(trim(' ab '))",
        ("x", "x", "x", "aZcaZc", "cba", 3, 0, True, 2)),
    "date_scalars": (
        "select quarter(date '1995-07-15'), "
        "day_of_week(date '1970-01-01'), "
        "day_of_year(date '1995-02-01'), week(date '1995-01-05'), "
        "year(date '1995-07-15'), month(date '1995-07-15')",
        (3, 4, 32, 1, 1995, 7)),
    "math_tail": (
        "select sin(0), cos(0), tan(0), degrees(pi()), radians(180), "
        "log(2, 8), atan2(1, 1)",
        (0.0, 1.0, 0.0, 180.0, math.pi, 3.0, math.pi / 4)),
    "bitwise": (
        "select bitwise_and(12, 10), bitwise_or(12, 10), "
        "bitwise_xor(12, 10), bitwise_not(0), "
        "bitwise_left_shift(1, 4), bitwise_right_shift(16, 2), "
        "bit_count(255), bitwise_right_shift(-1, 60), bit_count(-1, 8)",
        (8, 14, 6, -1, 16, 4, 8, 15, 8)),
    "width_bucket_and_nan": (
        "select width_bucket(-1, 0, 10, 5), width_bucket(3, 0, 10, 5), "
        "width_bucket(11, 0, 10, 5), is_nan(nan()), "
        "is_finite(infinity()), is_infinite(infinity())",
        (0, 2, 6, True, False, True)),
    "char_functions": (
        "select codepoint('A'), chr(66), translate('abc', 'ab', 'xy'), "
        "levenshtein_distance('kitten', 'sitting'), "
        "hamming_distance('abc', 'abd'), hamming_distance('abc', 'ab')",
        (65, "B", "xyc", 3, 1, None)),
    "url_functions": (
        f"select url_extract_protocol({U}), url_extract_host({U}), "
        f"url_extract_path({U}), url_extract_query({U}), "
        f"url_extract_fragment({U}), url_extract_port({U}), "
        f"url_extract_parameter({U}, 'k'), "
        f"url_extract_parameter({U}, 'nope')",
        ("https", "example.com", "/a/b", "k=v&z=", "frag", 8443, "v",
         None)),
    "binary_string_functions": (
        "select to_hex('AB'), to_base64('hi'), md5(''), "
        "url_encode('a b&c'), from_hex('4142'), from_base64('aGk='), "
        "url_decode('a+b%26c'), sha256('')",
        ("4142", "aGk=", "d41d8cd98f00b204e9800998ecf8427e", "a+b%26c",
         "AB", "hi", "a b&c",
         "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855")),
    "if_and_typeof": (
        "select if(1 > 0, 'yes', 'no'), if(1 > 2, 5), typeof(1)",
        ("yes", None, "bigint")),
    "regexp_constants": (
        "select regexp_like('abc', 'b'), regexp_replace('a-b-c', '-', ''), "
        "regexp_extract('ab12cd', '([0-9]+)', 1), "
        "regexp_extract('abcd', '[0-9]+'), contains('hello', 'ell'), "
        "lpad('7', 3, '0'), rpad('ab', 1), split_part('a,b,c', ',', 5)",
        (True, "abc", "12", None, True, "007", "a", "")),
    # tests/test_datetime.py
    "timestamp_literals": (
        "select timestamp '2020-01-01 10:00:00', "
        "timestamp '2020-01-01 10:00:00.123456', time '13:45:30'",
        (np.datetime64("2020-01-01T10:00:00", "us"),
         np.datetime64("2020-01-01T10:00:00.123456", "us"),
         np.timedelta64(((13 * 60 + 45) * 60 + 30) * 1_000_000, "us"))),
    "extract_fields": (
        "select extract(year from timestamp '2021-03-04 05:06:07'), "
        "extract(month from timestamp '2021-03-04 05:06:07'), "
        "extract(day from timestamp '2021-03-04 05:06:07'), "
        "extract(hour from timestamp '2021-03-04 05:06:07'), "
        "extract(minute from timestamp '2021-03-04 05:06:07'), "
        "extract(second from timestamp '2021-03-04 05:06:07'), "
        "millisecond(timestamp '2021-03-04 05:06:07.891')",
        (2021, 3, 4, 5, 6, 7, 891)),
    "date_trunc": (
        "select date_trunc('hour', timestamp '2020-02-29 13:45:11'), "
        "date_trunc('quarter', date '2020-08-19'), "
        "date_trunc('week', date '2020-08-19'), "
        "date_trunc('year', timestamp '1969-05-06 07:08:09')",
        (np.datetime64("2020-02-29T13:00:00", "us"),
         np.datetime64("2020-07-01"), np.datetime64("2020-08-17"),
         np.datetime64("1969-01-01T00:00:00", "us"))),
    "date_add_diff": (
        "select date_add('month', 1, date '2020-01-31'), "
        "date_diff('hour', timestamp '2020-01-01 00:30:00', "
        "timestamp '2020-01-01 05:00:00'), "
        "date_diff('week', date '1969-12-01', date '1969-11-01'), "
        "date_diff('month', date '1960-03-31', date '1970-01-01'), "
        "date_add('year', -1, date '1960-02-29')",
        (np.datetime64("2020-02-29"), 4, -4, 118,
         np.datetime64("1959-02-28"))),
    "interval_arithmetic": (
        "select timestamp '2020-01-01 23:30:00' + interval '45' minute, "
        "timestamp '2020-03-31 12:00:00' - interval '1' month, "
        "date '2020-01-01' + interval '6' hour",
        (np.datetime64("2020-01-02T00:15:00", "us"),
         np.datetime64("2020-02-29T12:00:00", "us"),
         np.datetime64("2020-01-01T06:00:00", "us"))),
    "unixtime": (
        "select to_unixtime(from_unixtime(1600000000)), "
        "from_unixtime(-86399.5)",
        (1600000000.0, np.datetime64("1969-12-31T00:00:00.500000", "us"))),
    "cast_matrix": (
        "select cast(timestamp '2020-05-06 07:08:09' as date), "
        "cast(date '2020-05-06' as timestamp), "
        "cast('2020-05-06 07:08:09' as timestamp), "
        "try_cast('nonsense' as timestamp)",
        (np.datetime64("2020-05-06"),
         np.datetime64("2020-05-06T00:00:00", "us"),
         np.datetime64("2020-05-06T07:08:09", "us"), None)),
    "date_format": (
        "select date_format(date '2020-07-04', '%Y/%m/%d'), "
        "date_format(timestamp '2020-07-04 10:00:00', '%b %Y'), "
        "date_format(date '1900-02-28', '%e %M %W %j')",
        ("2020/07/04", "Jul 2020", "28 February Wednesday 059")),
    "timestamp_oracle_values": (
        "select timestamp '2020-01-01 10:00:00' + interval '2' hour",
        (np.datetime64("2020-01-01T12:00:00", "us"),)),
    "varchar_to_number": (
        "select cast('12' as bigint), cast(' 5.0 ' as integer), "
        "cast('2.5' as double), cast('1.255' as decimal(10, 2)), "
        "try_cast('x1' as bigint), try_cast('2.5' as bigint), "
        "cast('12345678901234567890.5' as decimal(30, 1))",
        None),
}


@pytest.mark.parametrize("name", sorted(CONSTANT_SQL))
def test_constant_sql_equals_reference(name, port, engine):
    sql, want = CONSTANT_SQL[name]
    got = port.execute(sql)
    _same(got, engine.execute(sql))
    if want is not None:
        _same(got, [want])


def test_math_scalars_values(port):
    (row,) = port.execute(CONSTANT_SQL["math_scalars"][0])
    assert row[0] == 2.0 and abs(row[1] - 1024.0) < 1e-6
    assert row[2] == 2.0 and row[3] == 3.0
    assert row[4] == 0.0 and row[5] == 3.0 and row[6] == 2.0
    assert row[7] == 1.0 and abs(row[8] - 3.0) < 1e-12
    assert row[9] == -1 and row[10] == 1
    assert row[11] == 2.0 and row[12] == -2.0


def test_varchar_to_number_values(port):
    (row,) = port.execute(CONSTANT_SQL["varchar_to_number"][0])
    assert row[:3] == (12, 5, 2.5)
    assert row[3] == 1.26  # 125.5 cents, half even
    assert row[4] is None and row[5] is None
    assert str(row[6]) == "12345678901234567890.5"


# -- column SQL of the reference tests ----------------------------------------

COLUMN_SQL = {
    "regexp_family": (
        "select c_phone, regexp_replace(c_phone, '-', ''), "
        "regexp_extract(c_phone, '([0-9]+)-', 1), "
        "split_part(c_phone, '-', 2), lpad(c_phone, 20, '*'), "
        "rpad(c_phone, 4) from customer order by c_custkey limit 50"),
    "regexp_like_count": (
        "select count(*) from customer where regexp_like(c_phone, '^[12]')"),
    "timestamp_compare_and_filter": (
        "select count(*) from orders where "
        "cast(o_orderdate as timestamp) < timestamp '1995-01-01 00:00:01'"),
    "timestamp_group_keys": (
        "select t, count(*) from (select cast(o_orderdate as timestamp) "
        "as t from orders where o_orderkey < 100) group by t order by t"),
    "avg_decimal_half_up": (
        "select avg(l_quantity) from lineitem where l_orderkey < 100"),
    "date_parts_of_columns": (
        "select o_orderkey, day(o_orderdate), day_of_week(o_orderdate), "
        "day_of_year(o_orderdate), week(o_orderdate), "
        "quarter(o_orderdate), hour(cast(o_orderdate as timestamp)), "
        "date_trunc('week', o_orderdate), "
        "o_orderdate - interval '13' month, date_diff('quarter', o_orderdate, "
        "date '1992-01-01') from orders where o_orderkey < 300 "
        "order by 1"),
    "string_columns": (
        "select p_partkey, length(p_name), upper(reverse(p_brand)), "
        "trim(lpad(p_container, 12)), starts_with(p_type, 'PROMO'), "
        "strpos(p_name, 'a'), codepoint(p_mfgr), translate(p_brand, "
        "'#', '-'), levenshtein_distance(p_container, 'SM BOX'), "
        "hamming_distance(p_container, 'SM CASE') "
        "from part where p_partkey < 60 order by 1"),
    "numeric_columns": (
        "select o_orderkey, sign(o_custkey - 700), sign(o_totalprice), "
        "sqrt(o_totalprice), cbrt(-o_totalprice), "
        "width_bucket(o_totalprice, 1000, 400000, 7), "
        "bitwise_xor(o_orderkey, o_custkey), bit_count(o_custkey), "
        "bitwise_left_shift(o_orderkey, 3) from orders "
        "where o_orderkey < 200 order by 1"),
}


@pytest.mark.parametrize("name", sorted(COLUMN_SQL))
def test_column_sql_equals_reference(name, port, engine):
    sql = COLUMN_SQL[name]
    got = port.execute(sql)
    assert len(got) > 0
    _same(got, engine.execute(sql))


def test_regexp_family_vs_python(port, tpch_tiny):
    tbl = tpch_tiny.table("customer")
    phones = [str(tbl.columns["c_phone"].dictionary[c])
              for c in np.asarray(tbl.columns["c_phone"].data)]
    (n,) = port.execute(COLUMN_SQL["regexp_like_count"])[0]
    assert n == sum(1 for p in phones if re.search("^[12]", p))
    for phone, repl, ext, part2, lp, rp in port.execute(
            COLUMN_SQL["regexp_family"]):
        assert repl == phone.replace("-", "")
        m = re.search("([0-9]+)-", phone)
        assert ext == (m.group(1) if m else None)
        assert part2 == phone.split("-")[1]
        assert lp == phone.rjust(20, "*")[:20]
        assert rp == phone.ljust(4)[:4]


ORACLE_SQL = {
    # tests/test_datetime.py
    "date_before_1995": (
        "select count(*) from orders where o_orderdate < date '1995-01-01'"),
    "date_trunc_month": (
        "select date_trunc('month', o_orderdate), count(*) from orders "
        "group by 1 order by 1"),
    "date_add_day": (
        "select date_add('day', 30, o_orderdate), count(*) from orders "
        "group by 1 order by 1 limit 10"),
}


@pytest.mark.parametrize("name", sorted(ORACLE_SQL))
def test_datetime_columns_equal_oracle(name, port, oracle):
    assert_query(port, oracle, ORACLE_SQL[name])


# -- JSON over a memory table ------------------------------------------------

JSON_DOCS = ['{"a": 1, "b": {"c": "x"}, "arr": [1, 2]}',
             '{"a": 2, "arr": [10, 20, 30]}',
             'not json',
             '{"b": {"c": "y"}, "flag": true}']


@pytest.fixture(scope="module")
def json_pair():
    from presto_tpu import Engine, types as RT
    from presto_tpu.connectors.memory import MemoryConnector as RMem
    docs = np.asarray(JSON_DOCS, object)
    engines = []
    for eng, mem, types in ((Engine(), RMem(), RT),
                            (TorchEngine(device="cpu"), MemoryConnector(),
                             PT)):
        mem.create_table("j", {"id": types.BIGINT, "doc": types.VARCHAR},
                         {"id": np.arange(4), "doc": docs},
                         {"id": None, "doc": None})
        eng.register_catalog("mem", mem)
        eng.session.catalog = "mem"
        engines.append(eng)
    return engines


JSON_SQL = {
    "extract_scalar": (
        "select id, json_extract_scalar(doc, '$.a'), "
        "json_extract_scalar(doc, '$.b.c'), "
        "json_extract_scalar(doc, '$.flag'), "
        "json_extract_scalar(doc, '$.arr[1]') from j order by id",
        [(0, "1", "x", None, "2"), (1, "2", None, None, "20"),
         (2, None, None, None, None), (3, None, "y", "true", None)]),
    "extract_and_lengths": (
        "select id, json_extract(doc, '$.b'), json_array_length(doc), "
        "json_size(doc, '$.arr') from j order by id",
        [(0, '{"c":"x"}', None, 2), (1, None, None, 3),
         (2, None, None, None), (3, '{"c":"y"}', None, None)]),
    "parse_format_roundtrip": (
        "select json_format(json_parse(doc)) from j where id = 1",
        [('{"a": 2, "arr": [10, 20, 30]}',)]),
    "extract_grouped": (
        "select json_extract_scalar(doc, '$.b.c') as c, count(*) from j "
        "group by 1 order by 1", None),
}


@pytest.mark.parametrize("name", sorted(JSON_SQL))
def test_json_functions_equal_reference(name, json_pair):
    ref, port_engine = json_pair
    sql, want = JSON_SQL[name]
    got = port_engine.execute(sql)
    assert got == ref.execute(sql)
    if want is not None:
        assert got == want


# -- chip_smoke's functions phase at SF0.01, against sqlite -------------------


def _sqlite_functions(oracle):
    """The functions of F4-F7 that sqlite lacks, as python functions of
    their SQL meaning (sqlite's own: length, replace, substr, sign,
    sqrt, ln, power, floor)."""
    def split_part(s, sep, i):
        parts = s.split(sep)
        return parts[i - 1] if 0 < i <= len(parts) else ""

    def regexp_extract(s, pattern, group=0):
        m = re.search(pattern, s)
        return None if m is None else (m.group(group) or "")

    def width_bucket(x, lo, hi, n):
        if x < lo:
            return 0
        if x >= hi:
            return n + 1
        return int(math.floor((x - lo) / (hi - lo) * n)) + 1

    def date_parts(kind):
        def f(s):
            d = datetime.date.fromisoformat(s[:10])
            return {"quarter": (d.month - 1) // 3 + 1,
                    "day_of_week": d.isoweekday()}[kind]
        return f
    fns = {"split_part": (3, split_part),
           "lpad": (3, lambda s, n, f: s.rjust(n, f)[:n]),
           "strpos": (2, lambda s, t: s.find(t) + 1),
           "starts_with": (2, lambda s, p: int(s.startswith(p))),
           "regexp_extract": (3, regexp_extract),
           "width_bucket": (4, width_bucket),
           "quarter": (1, date_parts("quarter")),
           "day_of_week": (1, date_parts("day_of_week"))}
    for name, (nargs, fn) in fns.items():
        oracle.conn.create_function(name, nargs, fn, deterministic=True)


# chip_smoke's texts, with sqlite spellings where the dialect has none
F_SQL = {
    "F4_dates": None,
    "F4_date_format": """select strftime('%Y', o_orderdate) as y,
                                count(*) as c
                         from orders group by 1 order by 1""",
    "F5": None,
    "F6": """select sign(l_quantity - 25) as s,
                    width_bucket(l_extendedprice, 0, 110000, 10) as wb,
                    floor(sqrt(l_quantity)) as f, (l_orderkey & 255) % 3 as b,
                    count(*) as c, sum(ln(l_quantity)) as lq,
                    sum(power(l_discount, 2)) as p2
             from lineitem group by 1, 2, 3, 4 order by 1, 2, 3, 4""",
    "F7": None,
}


@pytest.mark.parametrize("name", sorted(F_SQL))
def test_functions_phase_queries_equal_oracle(name, port, oracle):
    _sqlite_functions(oracle)
    sql = FUNCTION_QUERIES[name]
    assert len(port.execute(sql)) > 1
    assert_query(port, oracle, sql, sqlite_sql=F_SQL[name])


def test_functions_phase_string_aggregates_keep_dictionaries(port):
    """min/max of a string expression come out as strings (the
    reference gives their codes, ROADMAP R9)."""
    rows = port.execute(FUNCTION_QUERIES["F5"])
    assert all(isinstance(r[7], str) and isinstance(r[8], str)
               for r in rows)
    [row] = port.execute("select max(lpad(p_brand, 12, '*')), "
                         "min(upper(p_type)) from part")
    assert row == ("****Brand#55", "ECONOMY ANODIZED BRASS")


@pytest.mark.parametrize("name", ["F7"])
def test_functions_phase_queries_equal_reference(name, port, engine):
    sql = FUNCTION_QUERIES[name]
    _same(port.execute(sql), engine.execute(sql))


def test_wide_sketch_query_vs_numpy(port, tpch_tiny):
    """F3 at SF0.01 (100 suppliers, so 100 groups): each group's HLL
    estimate within 4 standard errors, its percentile's rank within
    0.06 (the reference's capacity for this key is 2^17 groups of
    sketches; tests/test_torch_sketches.py holds the sorted path's
    sketches against it at narrower keys)."""
    li = tpch_tiny.table("lineitem").columns
    g = np.asarray(li["l_suppkey"].data) % 512
    part = np.asarray(li["l_partkey"].data)
    price = np.asarray(li["l_extendedprice"].data) / 100.0
    rows = port.execute(FUNCTION_QUERIES["F3"])
    assert [r[0] for r in rows] == sorted(set(g.tolist()))
    for key, est, p25 in rows:
        m = g == key
        exact = len(np.unique(part[m]))
        assert abs(est - exact) <= 4 * 1.04 / 2048 ** 0.5 * exact + 1
        assert abs((price[m] <= p25).mean() - 0.25) < 0.06


@pytest.mark.parametrize("name", ["F1", "F2"])
def test_sketch_queries_equal_reference(name, port, engine, tpch_tiny):
    """F1 and F2 at SF0.01: every column but min_by/max_by's equals the
    reference (float states within 1e-9); min_by/max_by name a row
    attaining the extremum."""
    import chip_smoke
    sql = FUNCTION_QUERIES[name]
    got, want = port.execute(sql), engine.execute(sql)
    floats = chip_smoke.FLOAT_STATE_COLUMNS.get(name, ())
    by = (8, 9) if name == "F1" else ()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if i in floats:
                assert a == pytest.approx(b, rel=1e-9)
            elif i not in by:
                assert a == b, (i, g, w)
    if name == "F1":
        li = tpch_tiny.table("lineitem").columns
        price = np.asarray(li["l_extendedprice"].data)
        key = np.asarray(li["l_orderkey"].data)
        flag = np.asarray(li["l_returnflag"].dictionary)[
            np.asarray(li["l_returnflag"].data)]
        status = np.asarray(li["l_linestatus"].dictionary)[
            np.asarray(li["l_linestatus"].data)]
        for row in got:
            m = (flag == row[0]) & (status == row[1])
            assert row[8] in set(key[m & (price == price[m].min())])
            assert row[9] in set(key[m & (price == price[m].max())])


# -- the reference's faults R7 and R8, against sqlite -------------------------


def test_sign_of_a_long_decimal_equals_oracle(port, oracle):
    """R7: l_quantity - 25 is decimal(22, 2) here; the reference gives
    per-limb signs ([1, 0], [-1, -1]) and groups by them."""
    sql = ("select sign(l_quantity - 25) as s, count(*) from lineitem "
           "group by 1 order by 1")
    got = port.execute(sql)
    assert [r[0] for r in got] == [-1, 0, 1]
    assert_query(port, oracle, sql)
    assert_query(port, oracle,
                 "select l_orderkey, sign(l_extendedprice - 30000.00), "
                 "sign(l_discount - 0.05) from lineitem "
                 "where l_orderkey < 40 order by 1, 2, 3")


R8_SQL = {
    "compare": (
        "select count(*) from orders "
        "where date_format(o_orderdate, '%Y') = '1995'",
        "select count(*) from orders "
        "where strftime('%Y', o_orderdate) = '1995'"),
    "count_distinct": (
        "select count(distinct date_format(o_orderdate, '%Y')), "
        "count(distinct date_format(o_orderdate, '%Y-%m')) from orders",
        "select count(distinct strftime('%Y', o_orderdate)), "
        "count(distinct strftime('%Y-%m', o_orderdate)) from orders"),
    "join_on_formatted": (
        "select count(*) from orders o, lineitem l "
        "where o.o_orderkey = l.l_orderkey "
        "and date_format(o.o_orderdate, '%Y-%m') = "
        "date_format(l.l_shipdate, '%Y-%m')",
        "select count(*) from orders o, lineitem l "
        "where o.o_orderkey = l.l_orderkey "
        "and strftime('%Y-%m', o.o_orderdate) = "
        "strftime('%Y-%m', l.l_shipdate)"),
}


@pytest.mark.parametrize("name", sorted(R8_SQL))
def test_date_format_dictionary_is_unique(name, port, oracle):
    """R8: one dictionary code per string, so equality, DISTINCT and
    joins on a formatted date hold (the reference's per-day entries
    give 11 orders of 1995 at SF0.01, and 2254 distinct years)."""
    sql, sqlite_sql = R8_SQL[name]
    assert_query(port, oracle, sql, sqlite_sql=sqlite_sql)


def test_date_format_years_match_year(port):
    by_format = port.execute("select date_format(o_orderdate, '%Y'), "
                             "count(*) from orders group by 1 order by 1")
    by_year = port.execute("select year(o_orderdate), count(*) from "
                           "orders group by 1 order by 1")
    assert len(by_format) == 7
    assert [(int(y), c) for y, c in by_format] == by_year
