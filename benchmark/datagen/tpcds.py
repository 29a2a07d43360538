"""TPC-DS data, made from a seed.

The draws of the port's ``TpcdsGenerator`` (presto_tpu_torch/connectors/
tpcds.py at commit 5551729): the spec's star schema with dsdgen-shaped
values (uniform keys over each dimension, prices from wholesale cost,
one coupon in ten), not dsdgen byte for byte. The row counts are the
configuration's (``rows``, the spec's at its scale factor), and the
dates are the spec's: ``date_dim`` spans 1900-01-02 to 2100-01-01 with
``d_date_sk`` the Julian day number, and store sales fall on the five
years from 1998-01-02 to 2003-01-02. Decimals are scaled integers
(cents), strings are :class:`datagen.Strings`.
"""

from __future__ import annotations

import numpy as np

from datagen import days, encode, make_all, pick

_CATEGORIES = ["Home", "Books", "Electronics", "Shoes", "Women", "Men",
               "Jewelry", "Sports", "Music", "Children"]
_CLASSES = ["accent", "classical", "fiction", "fitness", "athletic",
            "portable", "dresses", "pants", "birdal", "estate",
            "maternity", "infants", "swimwear", "country", "rock"]
_STATES = ["TN", "GA", "OH", "TX", "CA", "NY", "WA", "IL", "MI", "NC"]
_BRANDS = ["amalgimporto #1", "importoamalg #1", "scholaramalgamalg #7",
           "scholaramalgamalg #9", "scholaramalgamalg #14",
           "exportiunivamalg #9", "edu packscholar #1", "exportischolar #1",
           "exportiexporti #1", "amalgamalg #1", "univamalgamalg #10",
           "maxinameless #4"]
_CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Centerville",
           "Liberty", "Pleasant Hill", "Riverside", "Salem", "Union"]
_DAYNAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
# dsdgen's syllables, one a decimal digit: a store is named by its key
_SYLLABLES = ["bar", "ought", "able", "pri", "ese", "anti", "cally",
              "ation", "eing", "n st"]
_GENDERS = ["M", "F"]
_MARITAL = ["M", "S", "D", "W", "U"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]

DEC = "decimal(7,2)"
SCHEMAS = {
    "date_dim": {"d_date_sk": "bigint", "d_year": "bigint",
                 "d_moy": "bigint", "d_day_name": "varchar"},
    "item": {"i_item_sk": "bigint", "i_item_id": "varchar",
             "i_brand_id": "bigint", "i_brand": "varchar",
             "i_category_id": "bigint", "i_category": "varchar",
             "i_manufact_id": "bigint", "i_manufact": "varchar",
             "i_manager_id": "bigint"},
    "customer": {"c_customer_sk": "bigint", "c_current_addr_sk": "bigint"},
    "customer_address": {"ca_address_sk": "bigint", "ca_zip": "varchar"},
    "customer_demographics": {"cd_demo_sk": "bigint",
                              "cd_gender": "varchar",
                              "cd_marital_status": "varchar",
                              "cd_education_status": "varchar"},
    "household_demographics": {"hd_demo_sk": "bigint",
                               "hd_dep_count": "bigint"},
    "store": {"s_store_sk": "bigint", "s_store_id": "varchar",
              "s_store_name": "varchar", "s_state": "varchar",
              "s_zip": "varchar", "s_gmt_offset": "decimal(5,2)"},
    "promotion": {"p_promo_sk": "bigint", "p_channel_email": "varchar",
                  "p_channel_tv": "varchar", "p_channel_event": "varchar"},
    "time_dim": {"t_time_sk": "bigint", "t_hour": "bigint",
                 "t_minute": "bigint"},
    "store_sales": {"ss_sold_date_sk": "bigint", "ss_sold_time_sk": "bigint",
                    "ss_item_sk": "bigint", "ss_customer_sk": "bigint",
                    "ss_cdemo_sk": "bigint", "ss_hdemo_sk": "bigint",
                    "ss_store_sk": "bigint", "ss_promo_sk": "bigint",
                    "ss_quantity": "bigint", "ss_list_price": DEC,
                    "ss_sales_price": DEC, "ss_ext_sales_price": DEC,
                    "ss_coupon_amt": DEC},
}

# the spec's surrogate primary keys (the port's TpcdsConnector)
UNIQUE_KEYS = {name: [(cols[0],)] for name, cols in
               ((n, list(s)) for n, s in SCHEMAS.items())
               if name != "store_sales"}
PARTITIONING: dict = {}

JULIAN_EPOCH = 2_440_588  # the Julian day number of 1970-01-01
DATES = ("1900-01-02", "2100-01-01")  # date_dim
SALES = ("1998-01-02", "2003-01-02")  # ss_sold_date_sk


def date_sk(iso: str) -> int:
    """The ``d_date_sk`` of an ISO date: its Julian day number."""
    return days(iso) + JULIAN_EPOCH


def _ids(keys: np.ndarray, digits: int):
    """'AAAAAAAA' and the key zero-padded: ascending with the key."""
    return encode(np.char.add("AAAAAAAA", np.char.zfill(
        keys.astype(f"U{digits}"), digits)))


class TpcdsData:
    """The tables of a TPC-DS configuration from ``seed``, each with
    the columns it names. ``config["rows"]`` are the row counts at
    scale factor ``config["rows_scale"]``; at another ``scale`` the
    tables not in ``config["rows_fixed"]`` scale linearly."""

    def __init__(self, config: dict, seed: int):
        self.seed = int(seed)
        self.columns = {t: list(c) for t, c in config["columns"].items()}
        ratio = config["scale"] / config["rows_scale"]
        self._rows = {t: n if t in config["rows_fixed"]
                      else max(10, int(n * ratio))
                      for t, n in config["rows"].items()}

    def rows(self, name: str) -> int:
        return self._rows[name]

    def _rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng(self.seed + salt * 7919)

    def tables(self) -> dict:
        """Every asked-for table: {table: {column: array}}."""
        made = make_all({t: getattr(self, "_" + t) for t in self.columns})
        return {t: {c: made[t][c] for c in cols}
                for t, cols in self.columns.items()}

    def _date_dim(self):
        n = self.rows("date_dim")
        dates = days(DATES[0]) + np.arange(n)
        civil = (np.datetime64("1970-01-01")
                 + dates.astype("timedelta64[D]"))
        years = civil.astype("datetime64[Y]").astype(int) + 1970
        months = civil.astype("datetime64[M]").astype(int) % 12 + 1
        dow = (dates + 4) % 7
        return {"d_date_sk": dates.astype(np.int64) + JULIAN_EPOCH,
                "d_year": years.astype(np.int64),
                "d_moy": months.astype(np.int64),
                "d_day_name": pick(_DAYNAMES, dow)}

    def _item(self):
        n = self.rows("item")
        rng = self._rng(1)
        sk = np.arange(1, n + 1)
        brand_id = rng.integers(1, 1000, n) * 10 + rng.integers(1, 10, n)
        cat = rng.integers(0, len(_CATEGORIES), n)
        rng.integers(0, len(_CLASSES), n)  # the class's draw
        manu = rng.integers(1, 1000, n)
        rng.integers(100, 10000, n)  # the current price's draw
        rng.integers(50, 7000, n)  # the wholesale cost's draw
        brand = np.where(
            brand_id % 7 < 3, np.array(_BRANDS)[brand_id % len(_BRANDS)],
            np.char.add("brand#", (brand_id % 500).astype("U3")))
        return {"i_item_sk": sk, "i_item_id": _ids(sk, 8),
                "i_brand_id": brand_id, "i_brand": encode(brand),
                "i_category_id": cat + 1,
                "i_category": encode(np.array(_CATEGORIES)[cat]),
                "i_manufact_id": manu,
                "i_manufact": encode(np.char.add(
                    "manufact#", (manu % 200).astype("U3"))),
                "i_manager_id": rng.integers(1, 100, n)}

    def _customer(self):
        n = self.rows("customer")
        rng = self._rng(2)
        rng.integers(1, self.rows("customer_demographics") + 1, n)
        rng.integers(1, self.rows("household_demographics") + 1, n)
        return {"c_customer_sk": np.arange(1, n + 1),
                "c_current_addr_sk": rng.integers(
                    1, self.rows("customer_address") + 1, n)}

    def _customer_address(self):
        n = self.rows("customer_address")
        rng = self._rng(3)
        rng.integers(0, len(_CITIES), n)  # city
        rng.integers(0, len(_CITIES), n)  # county
        rng.integers(0, len(_STATES), n)  # state
        return {"ca_address_sk": np.arange(1, n + 1),
                "ca_zip": encode(rng.integers(10000, 99999, n).astype("U5"))}

    def _customer_demographics(self):
        i = np.arange(self.rows("customer_demographics"))
        return {
            "cd_demo_sk": i + 1,
            "cd_gender": pick(_GENDERS, i % 2),
            "cd_marital_status": pick(_MARITAL, (i // 2) % 5),
            "cd_education_status": pick(_EDUCATION, (i // 10) % 7),
        }

    def _household_demographics(self):
        i = np.arange(self.rows("household_demographics"))
        return {"hd_demo_sk": i + 1, "hd_dep_count": i % 10}

    def _store(self):
        n = self.rows("store")
        rng = self._rng(4)
        sk = np.arange(1, n + 1)
        rng.integers(200, 300, n)  # employees
        rng.integers(0, len(_CITIES), n)  # city
        rng.integers(0, len(_CITIES), n)  # county
        state = rng.integers(0, len(_STATES), n)
        gmt = rng.choice(np.array([-600, -500]), n)
        names = ["".join(_SYLLABLES[int(d)] for d in str(k)) for k in sk]
        return {"s_store_sk": sk, "s_store_id": _ids(sk, 8),
                "s_store_name": encode(np.array(names)),
                "s_state": encode(np.array(_STATES)[state]),
                "s_zip": encode(rng.integers(10000, 99999, n).astype("U5")),
                "s_gmt_offset": gmt}

    def _promotion(self):
        n = self.rows("promotion")
        rng = self._rng(6)
        yn = np.array(["Y", "N"])
        rng.integers(0, 2, n)  # dmail
        return {"p_promo_sk": np.arange(1, n + 1),
                "p_channel_email": encode(yn[rng.integers(0, 2, n)]),
                "p_channel_tv": encode(yn[rng.integers(0, 2, n)]),
                "p_channel_event": encode(yn[rng.integers(0, 2, n)])}

    def _time_dim(self):
        n = self.rows("time_dim")
        sec = np.arange(n)
        return {"t_time_sk": sec + 1, "t_hour": sec // 3600,
                "t_minute": (sec // 60) % 60}

    def _store_sales(self):
        n = self.rows("store_sales")
        rng = self._rng(7)
        sold = rng.integers(date_sk(SALES[0]), date_sk(SALES[1]) + 1, n)
        item_sk = rng.integers(1, self.rows("item") + 1, n)
        qty = rng.integers(1, 100, n)
        wholesale = rng.integers(100, 10000, n)
        lp = (wholesale * rng.integers(110, 200, n)) // 100
        del wholesale
        sp = (lp * rng.integers(30, 100, n)) // 100
        ext_sales = sp * qty
        coupon = np.where(rng.integers(0, 10, n) == 0, ext_sales // 10, 0)
        out = {"ss_sold_date_sk": sold, "ss_item_sk": item_sk,
               "ss_quantity": qty, "ss_list_price": lp,
               "ss_sales_price": sp, "ss_ext_sales_price": ext_sales,
               "ss_coupon_amt": coupon}
        for col, dim in (("ss_sold_time_sk", "time_dim"),
                         ("ss_customer_sk", "customer"),
                         ("ss_cdemo_sk", "customer_demographics"),
                         ("ss_hdemo_sk", "household_demographics"),
                         ("ss_addr_sk", "customer_address"),
                         ("ss_store_sk", "store"),
                         ("ss_promo_sk", "promotion")):
            out[col] = rng.integers(1, self.rows(dim) + 1, n)
        del out["ss_addr_sk"]
        return out
