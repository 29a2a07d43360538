"""Queries and seeded tables shared by the port's ARRAY, varlen and
MATCH_RECOGNIZE tests on the CPU (tests/test_torch_arrays.py,
test_torch_varlen.py, test_torch_match_recognize.py, against
presto_tpu) and on the card (tests/test_torch_cuda.py, both backends
against the port on the CPU). numpy only: the card's file imports
neither jax nor presto_tpu."""

import numpy as np

# the SQL of tests/test_arrays.py, in its order (TPC-H SF0.01)
ARRAY_SQL = [
    "select array[1, 2, 3], array[10, 20][2], element_at(array[5, 6], 1)",
    "select array[1, 2][5]",
    "select cardinality(array[1,2,3]), contains(array[1,2,3], 2), "
    "array_position(array[7,8,9], 9)",
    "select transform(array[1,2,3], x -> x + 1)",
    "select filter(array[1,2,3,4], x -> x % 2 = 0)",
    "select reduce(array[1,2,3], 0, (acc, x) -> acc + x)",
    "select any_match(array[1,2], x -> x > 1), "
    "all_match(array[1,2], x -> x > 0), none_match(array[1,2], x -> x > 5)",
    "select array[1,2] || array[3], array_max(array[3,1]), "
    "array_min(array[3,1]), array_sum(array[1,2,3])",
    "select x from unnest(array[1,2,3]) t(x) order by x",
    "select x, o from unnest(array[10,20,30]) with ordinality "
    "t(x, o) order by o",
    "select n_name, x from nation, "
    "unnest(array[n_nationkey, n_regionkey]) t(x) "
    "where n_name = 'BRAZIL' order by x",
    "select sum(x) from unnest(sequence(1, 100)) t(x)",
    "select k, v from unnest(map(array['a','b'], array[1,2])) "
    "t(k, v) order by k",
    "select element_at(map(array['a','b'], array[1,2]), 'b'), "
    "map_keys(map(array['a'], array[1])), "
    "map_values(map(array['a'], array[7])), "
    "cardinality(map(array['a','b'], array[1,2]))",
    "select split('a,b,c', ','), "
    "transform(split('x,y', ','), s -> upper(s))",
    "select cast('5' as bigint), cast('2.5' as double), "
    "cast('3.25' as decimal(10,2)), try_cast('x' as bigint)",
    "select n_regionkey, cardinality(ks) from ("
    " select n_regionkey, array_agg(n_nationkey) ks"
    " from nation group by n_regionkey) order by 1",
    "select r, x from (select n_regionkey r, array_agg(n_name) ns"
    " from nation group by n_regionkey), unnest(ns) t(x) "
    "where r = 1 order by x",
    "select array_distinct(array[3,1,3,2]), array_sort(array[3,1,2])",
    "select array[1, null, 3], cardinality(array[1, null, 3])",
    "select x from unnest(filter(array[1], v -> v > 5)) t(x)",
]

# -- a table of random arrays ---------------------------------------------------

N_ROWS = 48


def _random_lists(rng, gen, null_rows=0.1, null_elems=0.15, most=6):
    out = np.empty(N_ROWS, object)
    for i in range(N_ROWS):
        if rng.random() < null_rows:
            out[i] = None
            continue
        out[i] = [None if rng.random() < null_elems else gen()
                  for _ in range(int(rng.integers(0, most)))]
    return out


def random_arrays(T) -> tuple:
    """(schema, data, validity) of table ``t`` in the types module
    ``T``: seeded arrays of bigint (a, b), double (f) and varchar (s)
    elements with NULL arrays and NULL elements, a varchar column to
    split (w) and a key (k)."""
    rng = np.random.default_rng(20240917)
    words = ["ab", "c", "dd", "e f", ""]
    data = {
        "k": np.arange(N_ROWS, dtype=np.int64),
        "a": _random_lists(rng, lambda: int(rng.integers(-20, 60))),
        "b": _random_lists(rng, lambda: int(rng.integers(0, 9))),
        "f": _random_lists(rng, lambda: float(rng.normal() * 10)),
        "s": _random_lists(rng, lambda: str(rng.choice(words))),
        "w": np.array([",".join(rng.choice(words, int(rng.integers(1, 5))))
                       for _ in range(N_ROWS)], dtype=object),
    }
    valid = {c: (np.array([x is not None for x in v])
                 if c in ("a", "b", "f", "s") else None)
             for c, v in data.items()}
    schema = {"k": T.BIGINT, "a": T.ArrayType(T.BIGINT),
              "b": T.ArrayType(T.BIGINT), "f": T.ArrayType(T.DOUBLE),
              "s": T.ArrayType(T.VARCHAR), "w": T.VARCHAR}
    return schema, data, valid


# each of the 22 array, map and lambda scalars and UNNEST over table t;
# no ORDER BY over an array output (the reference's sort drops an
# array's lengths; the scan order is the key order)
RANDOM_SQL = {
    "subscripts": "select k, a, cardinality(a), element_at(a, 2), a[1], "
                  "element_at(a, 9), contains(a, 3), array_position(a, 5) "
                  "from t",
    "lambdas": "select k, transform(a, x -> x * 2 + k), "
               "filter(a, x -> x > 10), filter(a, x -> x is null), "
               "reduce(a, 0, (acc, x) -> acc + x), "
               "reduce(b, 1, (acc, x) -> acc * (x + 1), acc -> acc - 1) "
               "from t",
    "matches": "select k, any_match(a, x -> x > 40), "
               "all_match(a, x -> x > 0), none_match(a, x -> x < 0), "
               "any_match(s, x -> x = 'dd') from t",
    "folds": "select k, array_max(a), array_min(a), array_sum(a), "
             "array_max(s), array_min(f) from t",
    "reshapes": "select k, a || b, b || a, array_distinct(b), "
                "array_sort(b), array_distinct(s), array_sort(s), "
                "s || s from t",
    "constructors": "select k, array[k, k * 2, null], "
                    "array['x', w], sequence(1, 4), "
                    "sequence(10, 1, -3), array[] from t",
    "strings": "select k, s, transform(s, x -> upper(x)), "
               "contains(s, 'c'), array_position(s, 'dd'), "
               "element_at(s, 1), split(w, ','), "
               "cardinality(split(w, ',')) from t",
    "maps": "select k, element_at(map(b, a), 3), "
            "element_at(map(s, b), 'c'), map_keys(map(b, s)), "
            "map_values(map(b, s)), cardinality(map(b, a)) from t",
    "double_sums": "select k, array_sum(f), "
                   "reduce(f, 0e0, (acc, x) -> acc + x) from t",
    "unnest": "select k, x from t, unnest(a) u(x)",
    "unnest_ordinality": "select k, x, o from t, unnest(s) "
                         "with ordinality u(x, o)",
    "unnest_zip": "select k, x, y from t, unnest(a, s) u(x, y)",
    "unnest_split": "select k, x from t, unnest(split(w, ',')) u(x) "
                    "where x <> 'c'",
    "unnest_aggregate": "select x, count(*), sum(k) from t, unnest(b) u(x) "
                        "group by x order by x",
}

# -- the variable-length aggregates ---------------------------------------------

# tests/test_functions.py's varlen section and test_arrays.py's two
# (TPC-H SF0.01)
VARLEN_SQL = [
    "select n_regionkey, array_agg(n_name order by n_name) "
    "from nation group by n_regionkey order by n_regionkey",
    "select array_agg(case when n_regionkey = 0 then null "
    "else n_regionkey end) from nation",
    "select array_agg(distinct n_regionkey order by n_regionkey) "
    "from nation",
    "select map_agg(r_name, r_regionkey) from region",
    "select n_regionkey, listagg(n_name, '|') within group "
    "(order by n_name desc) from nation "
    "where n_regionkey = 1 group by n_regionkey",
    "select c_nationkey, count(*) as cnt, "
    "array_agg(c_name order by c_acctbal desc) "
    "from customer group by c_nationkey order by c_nationkey limit 3",
    "select cardinality(array_agg(n_name)) from nation",
    "select n_regionkey, cardinality(ks) from ("
    " select n_regionkey, array_agg(n_nationkey) ks"
    " from nation group by n_regionkey) order by 1",
    "select r, x from (select n_regionkey r, array_agg(n_name) ns"
    " from nation group by n_regionkey), unnest(ns) t(x) "
    "where r = 1 order by x",
]

ORDERS_BY_CUSTOMER_SQL = (
    "select o_custkey, count(*), array_agg(o_orderkey order by "
    "o_orderdate desc), array_agg(o_orderstatus order by o_orderdate) "
    "from orders group by o_custkey")

NULLS_ROWS = 200


def nulls_and_ties(T) -> tuple:
    """(schema, data, validity) of table ``t``: a group key g, an order
    key o with few values (ties) and NULLs, bigint values v and strings
    s with NULLs."""
    rng = np.random.default_rng(4242)
    n = NULLS_ROWS
    data = {
        "g": rng.integers(0, 7, n).astype(np.int64),
        "o": rng.integers(0, 5, n).astype(np.int64),
        "v": rng.integers(-50, 50, n).astype(np.int64),
        "s": np.array([f"w{x}" for x in rng.integers(0, 12, n)],
                      dtype=object),
    }
    valid = {"g": rng.random(n) > 0.05, "o": rng.random(n) > 0.2,
             "v": rng.random(n) > 0.15, "s": rng.random(n) > 0.1}
    schema = {"g": T.BIGINT, "o": T.BIGINT, "v": T.BIGINT, "s": T.VARCHAR}
    return schema, data, valid


NULLS_SQL = {
    "desc_null_order_keys": "select g, array_agg(v order by o desc) "
                            "from t group by g order by g",
    "asc_null_order_keys": "select g, array_agg(s order by o) "
                           "from t group by g order by g",
    "filter": "select g, array_agg(v) filter (where o > 2), count(*) "
              "from t group by g order by g",
    "filter_empties_a_group": "select g, array_agg(v) filter (where o > 9) "
                              "from t group by g order by g",
    "map_agg_null_keys": "select g, map_agg(s, v) from t group by g "
                         "order by g",
    "listagg_null_values": "select g, listagg(s, ';') within group "
                           "(order by o desc) from t group by g order by g",
    "distinct": "select g, array_agg(distinct o) from t group by g "
                "order by g",
    "global": "select array_agg(v order by o), count(*) from t",
}

# -- MATCH_RECOGNIZE ------------------------------------------------------------

TICKS = {"sym_id": np.array([1] * 6 + [2] * 5),
         "ts": np.array([1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5]),
         "price": np.array([10, 9, 8, 9, 10, 11, 5, 6, 5, 4, 6])}

# tests/test_match_recognize.py's queries over ``ticks`` and their
# hand-computed rows
MR_HAND = {
    "v_shape": ("""
        select * from ticks match_recognize (
          partition by sym_id order by ts
          measures first(ts) as start_ts, last(ts) as end_ts,
                   last(price) as end_price,
                   match_number() as mno
          one row per match
          after match skip past last row
          pattern (strt down+ up+)
          define down as price < prev(price),
                 up as price > prev(price)
        ) order by sym_id, start_ts""",
                [(1, 1, 6, 11, 1), (2, 2, 5, 6, 1)]),
    "classifier_alternation": ("""
        select * from ticks match_recognize (
          partition by sym_id order by ts
          measures last(ts) as t, classifier() as cls
          pattern (lo | hi)
          define lo as price <= 5, hi as price >= 10
        ) order by sym_id, t""",
                               [(1, 1, "HI"), (1, 5, "HI"), (1, 6, "HI"),
                                (2, 1, "LO"), (2, 3, "LO"), (2, 4, "LO")]),
    "bounded_quantifier": ("""
        select * from ticks match_recognize (
          partition by sym_id order by ts
          measures first(ts) as t0, last(ts) as t1
          pattern (down{2})
          define down as price < prev(price)
        ) order by sym_id, t0""", [(1, 2, 3), (2, 3, 4)]),
    "feeds_downstream": ("""
        select count(*) from ticks match_recognize (
          partition by sym_id order by ts
          measures last(price) as p
          pattern (down)
          define down as price < prev(price)
        )""", [(4,)]),
}


def random_series() -> dict:
    """Table ``series``: a seeded random walk of prices in 9 partitions
    of 40 rows, each partition's timestamps shuffled (no NULLs, no tied
    timestamps)."""
    rng = np.random.default_rng(31337)
    parts, per = 9, 40
    sym = np.repeat(np.arange(parts), per)
    ts = np.concatenate([rng.permutation(per) + 1 for _ in range(parts)])
    walk = rng.integers(-3, 4, parts * per).cumsum() + 100
    return {"sym_id": sym.astype(np.int64), "ts": ts.astype(np.int64),
            "price": walk.astype(np.int64)}


MR_RANDOM_SQL = {
    "v_shape": MR_HAND["v_shape"][0].replace("ticks", "series"),
    "w_shape": """
        select * from series match_recognize (
          partition by sym_id order by ts
          measures first(ts) as t0, last(ts) as t1, first(price) as p0,
                   last(price) as p1, match_number() as mno,
                   classifier() as cls
          pattern (a b+ c+ b+ c+)
          define b as price < prev(price), c as price > prev(price)
        ) order by sym_id, t0""",
    "runs_desc": """
        select * from series match_recognize (
          partition by sym_id order by ts desc
          measures first(ts) as t0, last(ts) as t1
          pattern (flat{2,} | up)
          define flat as price = prev(price),
                 up as price > prev(price, 2)
        ) order by sym_id, t0""",
}


def memory_engine(engine, connector, T, tables: dict):
    """``engine`` with catalog ``mem`` (the default) holding ``tables``:
    name -> (schema, data, validity)."""
    for name, (schema, data, valid) in tables.items():
        connector.create_table(name, schema, data, valid)
    engine.register_catalog("mem", connector)
    engine.session.catalog = "mem"
    return engine


def bigint_table(T, data: dict) -> tuple:
    return ({c: T.BIGINT for c in data}, data, {c: None for c in data})
