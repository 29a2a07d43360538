"""TPC-H data, made from a seed.

A frozen copy of ``TpchGenerator`` (presto_tpu_torch/connectors/tpch.py
at commit 5551729): spec-shaped distributions (TPC-H clause 4.2.3:
dates, discounts, taxes, quantities, the retail-price and partsupp
supplier formulas, customer keys that skip multiples of 3), not dbgen
byte for byte. Every draw is the port's, in the port's order, up to
the last column a configuration can ask for; a draw that only feeds
columns nobody asks for is left out, and so are the strings of a
column not asked for. Decimals are scaled integers (cents), dates are
days since 1970-01-01 (int32), strings are :class:`datagen.Strings`.
"""

from __future__ import annotations

import numpy as np

from datagen import Strings, days, encode, make_all, pick

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]

TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]

N_COLORS = 92  # the port's part-name vocabulary (names are not made)

COMMENT_WORDS = (
    "carefully quickly furiously slyly blithely final pending express bold "
    "regular ironic even special unusual silent deposits requests accounts "
    "packages instructions theodolites foxes pinto beans dependencies ideas "
    "platelets realms sleep haggle nag wake cajole boost detect integrate "
    "Customer Complaints above according across against along"
).split()

STARTDATE = days("1992-01-01")
ENDDATE = days("1998-08-02")
CURRENTDATE = days("1995-06-17")

# column -> SQL type, for every column this generator can make
SCHEMAS = {
    "region": {"r_regionkey": "bigint", "r_name": "varchar"},
    "nation": {"n_nationkey": "bigint", "n_name": "varchar",
               "n_regionkey": "bigint"},
    "supplier": {"s_suppkey": "bigint", "s_nationkey": "bigint"},
    "part": {"p_partkey": "bigint", "p_type": "varchar"},
    "customer": {"c_custkey": "bigint", "c_name": "varchar",
                 "c_address": "varchar", "c_nationkey": "bigint",
                 "c_phone": "varchar", "c_acctbal": "decimal(12,2)",
                 "c_mktsegment": "varchar", "c_comment": "varchar"},
    "orders": {"o_orderkey": "bigint", "o_custkey": "bigint",
               "o_totalprice": "decimal(12,2)", "o_orderdate": "date",
               "o_shippriority": "bigint"},
    "lineitem": {"l_orderkey": "bigint", "l_partkey": "bigint",
                 "l_suppkey": "bigint", "l_linenumber": "bigint",
                 "l_quantity": "decimal(12,2)",
                 "l_extendedprice": "decimal(12,2)",
                 "l_discount": "decimal(12,2)", "l_tax": "decimal(12,2)",
                 "l_returnflag": "varchar", "l_linestatus": "varchar",
                 "l_shipdate": "date"},
}

# the spec's primary keys and the port's partitioning (TpchConnector)
UNIQUE_KEYS = {
    "region": [("r_regionkey",)], "nation": [("n_nationkey",)],
    "supplier": [("s_suppkey",)], "part": [("p_partkey",)],
    "customer": [("c_custkey",)], "orders": [("o_orderkey",)],
    "lineitem": [("l_orderkey", "l_linenumber")],
}
PARTITIONING = {"orders": ("o_orderkey",), "lineitem": ("l_orderkey",)}

_COMMENT_COMBOS: tuple | None = None


def _comments(rng: np.random.Generator, n: int) -> Strings:
    """Three-word comments over one shared sorted dictionary of every
    combination (the port's ``_comments``)."""
    global _COMMENT_COMBOS
    w = np.array(COMMENT_WORDS, dtype=object)
    k = len(w)
    if _COMMENT_COMBOS is None:
        combos = (np.repeat(w, k * k) + " " + np.tile(np.repeat(w, k), k)
                  + " " + np.tile(w, k * k))
        sorted_dict, inv = np.unique(combos.astype("U"),
                                     return_inverse=True)
        _COMMENT_COMBOS = (sorted_dict.astype(object),
                           inv.astype(np.int32))
    sorted_dict, inv = _COMMENT_COMBOS
    i = rng.integers(0, k, size=(n, 3))
    codes = inv[(i[:, 0] * k + i[:, 1]) * k + i[:, 2]]
    if n < (1 << 17):
        used, remap = np.unique(codes, return_inverse=True)
        return Strings(remap.astype(np.int32), sorted_dict[used])
    return Strings(codes, sorted_dict)


def _phone(nationkey: np.ndarray, rng: np.random.Generator) -> Strings:
    cc = (nationkey + 10).astype(np.int64)
    a = rng.integers(100, 1000, len(nationkey))
    b = rng.integers(100, 1000, len(nationkey))
    c = rng.integers(1000, 10000, len(nationkey))
    # 'cc-aaa-bbb-cccc': fixed-width fields, so the number's order is
    # the string's and each distinct phone is written once
    key = ((cc * 1000 + a) * 1000 + b) * 10000 + c
    uniq, inv = np.unique(key, return_inverse=True)
    text = uniq // 10**10
    for div, mod, width in ((10**7, 1000, 3), (10**4, 1000, 3),
                            (1, 10000, 4)):
        text = np.char.add(np.char.add(text.astype("U"), "-"),
                           (uniq // div % mod).astype(f"U{width}"))
    return Strings(inv.astype(np.int32).reshape(-1), text.astype(object))


def _keyed_names(prefix: str, keys: np.ndarray) -> Strings:
    names = np.char.add(f"{prefix}#", np.char.zfill(keys.astype("U9"), 9))
    return Strings(np.arange(len(keys), dtype=np.int32),
                   names.astype(object))


def _retailprice(partkey: np.ndarray) -> np.ndarray:
    pk = partkey.astype(np.int64)
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def _ps_suppkey(partkey: np.ndarray, i: np.ndarray, s: int) -> np.ndarray:
    pk = partkey.astype(np.int64)
    return (pk + i * (s // 4 + (pk - 1) // s)) % s + 1


class TpchData:
    """The tables of a TPC-H configuration from ``seed``: at its
    ``scale``, each with the columns it names."""

    def __init__(self, config: dict, seed: int):
        scale = self.scale = config["scale"]
        self.seed = int(seed)
        self.columns = {t: list(c) for t, c in config["columns"].items()}
        self.n_supplier = max(int(10_000 * scale), 40)
        self.n_part = max(int(200_000 * scale), 200)
        self.n_customer = max(int(150_000 * scale), 150)
        self.n_orders = self.n_customer * 10

    def _rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, salt])

    def tables(self) -> dict:
        """Every asked-for table: {table: {column: array}}."""
        makers = {t: getattr(self, "_" + t) for t in self.columns
                  if t not in ("orders", "lineitem")}
        if {"orders", "lineitem"} & set(self.columns):
            makers["orders+lineitem"] = self._orders_and_lineitem
        made = make_all(makers)
        if "orders+lineitem" in made:
            made["orders"], made["lineitem"] = made.pop("orders+lineitem")
        return {t: {c: made[t][c] for c in cols}
                for t, cols in self.columns.items()}

    def _region(self):
        return {"r_regionkey": np.arange(5, dtype=np.int64),
                "r_name": encode(np.array(REGIONS))}

    def _nation(self):
        return {"n_nationkey": np.arange(25, dtype=np.int64),
                "n_name": encode(np.array([n for n, _ in NATIONS])),
                "n_regionkey": np.array([r for _, r in NATIONS],
                                        dtype=np.int64)}

    def _supplier(self):
        rng = self._rng(3)
        n = self.n_supplier
        return {"s_suppkey": np.arange(1, n + 1, dtype=np.int64),
                "s_nationkey": rng.integers(0, 25, n).astype(np.int64)}

    def _part(self):
        rng = self._rng(4)
        n = self.n_part
        rng.integers(0, N_COLORS, size=(n, 5))  # the names' draw
        rng.integers(1, 6, n)  # the manufacturer's draw
        rng.integers(1, 6, n)  # the brand's draw
        type_vocab = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                      for c in TYPE_S3]
        t1 = rng.integers(0, len(TYPE_S1), n)
        t2 = rng.integers(0, len(TYPE_S2), n)
        t3 = rng.integers(0, len(TYPE_S3), n)
        return {"p_partkey": np.arange(1, n + 1, dtype=np.int64),
                "p_type": pick(type_vocab, (t1 * len(TYPE_S2) + t2)
                               * len(TYPE_S3) + t3)}

    def _customer(self):
        rng = self._rng(6)
        n = self.n_customer
        keys = np.arange(1, n + 1, dtype=np.int64)
        nationkey = rng.integers(0, 25, n).astype(np.int64)
        seg = rng.integers(0, len(SEGMENTS), n)
        out = {"c_custkey": keys, "c_nationkey": nationkey,
               "c_mktsegment": pick(SEGMENTS, seg),
               "c_name": _keyed_names("Customer", keys)}
        out["c_address"] = _comments(rng, n)
        out["c_phone"] = _phone(nationkey, rng)
        out["c_acctbal"] = rng.integers(-99999, 1_000_000, n).astype(
            np.int64)
        out["c_comment"] = _comments(rng, n)
        return out

    def _orders_and_lineitem(self):
        rng = self._rng(8)
        n = self.n_orders
        okeys = np.arange(1, n + 1, dtype=np.int64)
        # customer keys skip multiples of 3 (spec 4.2.3)
        ck = rng.integers(1, self.n_customer + 1, n).astype(np.int64)
        bump = ck % 3 == 0
        ck = np.where(bump, np.maximum((ck + 1) % (self.n_customer + 1), 1),
                      ck)
        ck = np.where(ck % 3 == 0, np.maximum(ck - 2, 1), ck)
        odate = rng.integers(STARTDATE, ENDDATE - 151 + 1, n).astype(
            np.int32)

        counts = self._rng(7).integers(1, 8, n)
        total = int(counts.sum())
        l_orderkey = np.repeat(okeys, counts)
        l_odate = np.repeat(odate, counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        ln = np.arange(total, dtype=np.int64) - np.repeat(starts, counts) + 1

        lrng = self._rng(9)
        lpk = lrng.integers(1, self.n_part + 1, total).astype(np.int64)
        lsk = _ps_suppkey(lpk, lrng.integers(0, 4, total), self.n_supplier)
        qty = lrng.integers(1, 51, total).astype(np.int64)
        eprice = qty * _retailprice(lpk)
        disc = lrng.integers(0, 11, total).astype(np.int64)
        tax = lrng.integers(0, 9, total).astype(np.int64)
        sdate = (l_odate + lrng.integers(1, 122, total)).astype(np.int32)
        del l_odate
        lrng.integers(30, 91, total)  # the commit date's draw
        rdate = sdate + lrng.integers(1, 31, total).astype(np.int32)
        returned = rdate <= CURRENTDATE
        del rdate
        rflag = Strings(np.where(returned,
                                 np.where(lrng.random(total) < 0.5, 2, 0),
                                 1).astype(np.int32),
                        np.array(["A", "N", "R"], object))
        open_line = sdate > CURRENTDATE
        lstatus = Strings(open_line.astype(np.int32),
                          np.array(["F", "O"], object))
        lineitem = {
            "l_orderkey": l_orderkey, "l_partkey": lpk, "l_suppkey": lsk,
            "l_linenumber": ln, "l_quantity": qty * 100,
            "l_extendedprice": eprice, "l_discount": disc, "l_tax": tax,
            "l_returnflag": rflag, "l_linestatus": lstatus,
            "l_shipdate": sdate,
        }
        # o_totalprice: the lines' extendedprice * (1 + tax) *
        # (1 - discount), each rounded to cents; every partial sum is an
        # integer far below 2^53, so the float sums are exact
        line_total = np.round(eprice * (100 + tax) * (100 - disc)
                              / 10000.0)
        totalprice = np.bincount(l_orderkey - 1, weights=line_total,
                                 minlength=n).astype(np.int64)
        orders = {"o_orderkey": okeys, "o_custkey": ck,
                  "o_totalprice": totalprice, "o_orderdate": odate,
                  "o_shippriority": np.zeros(n, dtype=np.int64)}
        return orders, lineitem
