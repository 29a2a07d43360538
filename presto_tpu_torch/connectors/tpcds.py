"""TPC-DS catalog: schemas + deterministic synthetic data generation.

Analog of the reference's plugin/trino-tpcds (TpcdsConnectorFactory over
io.trino.tpcds dsdgen). Schemas follow the TPC-DS specification for the
core star-schema tables; generation is a simplified deterministic model
(uniform/zipf-ish draws seeded per table) — enough for planner/executor
parity work and oracle-checked query correctness at small scales. The
reference's dsdgen fidelity (exact row contents) is NOT reproduced; the
oracle cross-check keeps correctness honest because both sides read the
same generated data.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Table
from presto_tpu_torch.connectors.base import Connector, TableStats

DEC2 = T.DecimalType(7, 2)

_D = lambda s: int((np.datetime64(s) - np.datetime64("1970-01-01"))
                   .astype(int))

SCHEMAS: dict[str, dict[str, T.DataType]] = {
    "date_dim": {
        "d_date_sk": T.BIGINT, "d_date_id": T.VARCHAR, "d_date": T.DATE,
        "d_year": T.BIGINT, "d_moy": T.BIGINT, "d_dom": T.BIGINT,
        "d_qoy": T.BIGINT, "d_dow": T.BIGINT,
        "d_day_name": T.VARCHAR,
        "d_month_seq": T.BIGINT, "d_week_seq": T.BIGINT,
        "d_quarter_name": T.VARCHAR,
    },
    "item": {
        "i_item_sk": T.BIGINT, "i_item_id": T.VARCHAR,
        "i_item_desc": T.VARCHAR, "i_current_price": DEC2,
        "i_wholesale_cost": DEC2, "i_brand_id": T.BIGINT,
        "i_brand": T.VARCHAR, "i_class_id": T.BIGINT,
        "i_class": T.VARCHAR, "i_category_id": T.BIGINT,
        "i_category": T.VARCHAR, "i_manufact_id": T.BIGINT,
        "i_manufact": T.VARCHAR, "i_manager_id": T.BIGINT,
        "i_color": T.VARCHAR, "i_product_name": T.VARCHAR,
        "i_size": T.VARCHAR, "i_units": T.VARCHAR,
    },
    "customer": {
        "c_customer_sk": T.BIGINT, "c_customer_id": T.VARCHAR,
        "c_current_cdemo_sk": T.BIGINT, "c_current_hdemo_sk": T.BIGINT,
        "c_current_addr_sk": T.BIGINT, "c_first_name": T.VARCHAR,
        "c_last_name": T.VARCHAR, "c_birth_year": T.BIGINT,
        "c_birth_country": T.VARCHAR, "c_email_address": T.VARCHAR,
        "c_salutation": T.VARCHAR, "c_preferred_cust_flag": T.VARCHAR,
        "c_birth_month": T.BIGINT, "c_birth_day": T.BIGINT,
        "c_login": T.VARCHAR, "c_first_sales_date_sk": T.BIGINT,
        "c_first_shipto_date_sk": T.BIGINT,
        "c_last_review_date_sk": T.BIGINT,
    },
    "customer_address": {
        "ca_address_sk": T.BIGINT, "ca_address_id": T.VARCHAR,
        "ca_city": T.VARCHAR, "ca_county": T.VARCHAR,
        "ca_state": T.VARCHAR, "ca_zip": T.VARCHAR,
        "ca_country": T.VARCHAR, "ca_gmt_offset": T.DecimalType(5, 2),
        "ca_street_number": T.VARCHAR, "ca_street_name": T.VARCHAR,
        "ca_street_type": T.VARCHAR, "ca_suite_number": T.VARCHAR,
        "ca_location_type": T.VARCHAR,
    },
    "customer_demographics": {
        "cd_demo_sk": T.BIGINT, "cd_gender": T.VARCHAR,
        "cd_marital_status": T.VARCHAR,
        "cd_education_status": T.VARCHAR,
        "cd_purchase_estimate": T.BIGINT,
        "cd_credit_rating": T.VARCHAR, "cd_dep_count": T.BIGINT,
        "cd_dep_employed_count": T.BIGINT,
        "cd_dep_college_count": T.BIGINT,
    },
    "household_demographics": {
        "hd_demo_sk": T.BIGINT, "hd_income_band_sk": T.BIGINT,
        "hd_buy_potential": T.VARCHAR, "hd_dep_count": T.BIGINT,
        "hd_vehicle_count": T.BIGINT,
    },
    "store": {
        "s_store_sk": T.BIGINT, "s_store_id": T.VARCHAR,
        "s_store_name": T.VARCHAR, "s_number_employees": T.BIGINT,
        "s_city": T.VARCHAR, "s_county": T.VARCHAR,
        "s_state": T.VARCHAR, "s_gmt_offset": T.DecimalType(5, 2),
        "s_company_id": T.BIGINT, "s_company_name": T.VARCHAR,
        "s_zip": T.VARCHAR, "s_market_id": T.BIGINT,
        "s_street_number": T.VARCHAR, "s_street_name": T.VARCHAR,
        "s_street_type": T.VARCHAR, "s_suite_number": T.VARCHAR,
    },
    "warehouse": {
        "w_warehouse_sk": T.BIGINT, "w_warehouse_id": T.VARCHAR,
        "w_warehouse_name": T.VARCHAR, "w_warehouse_sq_ft": T.BIGINT,
        "w_city": T.VARCHAR, "w_state": T.VARCHAR,
        "w_county": T.VARCHAR, "w_country": T.VARCHAR,
    },
    "promotion": {
        "p_promo_sk": T.BIGINT, "p_promo_id": T.VARCHAR,
        "p_channel_dmail": T.VARCHAR, "p_channel_email": T.VARCHAR,
        "p_channel_tv": T.VARCHAR, "p_promo_name": T.VARCHAR,
        "p_channel_event": T.VARCHAR,
    },
    "store_sales": {
        "ss_sold_date_sk": T.BIGINT, "ss_sold_time_sk": T.BIGINT,
        "ss_item_sk": T.BIGINT,
        "ss_customer_sk": T.BIGINT, "ss_cdemo_sk": T.BIGINT,
        "ss_hdemo_sk": T.BIGINT, "ss_addr_sk": T.BIGINT,
        "ss_store_sk": T.BIGINT, "ss_promo_sk": T.BIGINT,
        "ss_ticket_number": T.BIGINT, "ss_quantity": T.BIGINT,
        "ss_wholesale_cost": DEC2, "ss_list_price": DEC2,
        "ss_sales_price": DEC2, "ss_ext_discount_amt": DEC2,
        "ss_ext_sales_price": DEC2, "ss_ext_wholesale_cost": DEC2,
        "ss_ext_list_price": DEC2, "ss_coupon_amt": DEC2,
        "ss_net_paid": DEC2, "ss_net_profit": DEC2,
        "ss_ext_tax": DEC2,
    },
    "catalog_sales": {
        "cs_sold_date_sk": T.BIGINT, "cs_item_sk": T.BIGINT,
        "cs_bill_customer_sk": T.BIGINT, "cs_ship_customer_sk": T.BIGINT,
        "cs_bill_cdemo_sk": T.BIGINT, "cs_bill_hdemo_sk": T.BIGINT,
        "cs_ship_date_sk": T.BIGINT, "cs_warehouse_sk": T.BIGINT,
        "cs_ship_mode_sk": T.BIGINT, "cs_call_center_sk": T.BIGINT,
        "cs_promo_sk": T.BIGINT, "cs_order_number": T.BIGINT,
        "cs_quantity": T.BIGINT, "cs_wholesale_cost": DEC2,
        "cs_list_price": DEC2, "cs_sales_price": DEC2,
        "cs_ext_discount_amt": DEC2, "cs_ext_sales_price": DEC2,
        "cs_ext_wholesale_cost": DEC2, "cs_ext_list_price": DEC2,
        "cs_ext_ship_cost": DEC2, "cs_coupon_amt": DEC2,
        "cs_net_paid": DEC2, "cs_net_profit": DEC2,
        "cs_bill_addr_sk": T.BIGINT, "cs_ship_addr_sk": T.BIGINT,
        "cs_sold_time_sk": T.BIGINT, "cs_catalog_page_sk": T.BIGINT,
        "cs_net_paid_inc_tax": DEC2,
    },
    "web_sales": {
        "ws_sold_date_sk": T.BIGINT, "ws_sold_time_sk": T.BIGINT,
        "ws_item_sk": T.BIGINT,
        "ws_bill_customer_sk": T.BIGINT, "ws_ship_customer_sk": T.BIGINT,
        "ws_ship_hdemo_sk": T.BIGINT, "ws_ship_addr_sk": T.BIGINT,
        "ws_ship_date_sk": T.BIGINT, "ws_warehouse_sk": T.BIGINT,
        "ws_web_site_sk": T.BIGINT, "ws_web_page_sk": T.BIGINT,
        "ws_ship_mode_sk": T.BIGINT,
        "ws_promo_sk": T.BIGINT, "ws_order_number": T.BIGINT,
        "ws_quantity": T.BIGINT, "ws_list_price": DEC2,
        "ws_sales_price": DEC2,
        "ws_ext_discount_amt": DEC2, "ws_ext_sales_price": DEC2,
        "ws_ext_wholesale_cost": DEC2, "ws_ext_ship_cost": DEC2,
        "ws_net_paid": DEC2, "ws_net_profit": DEC2,
        "ws_bill_addr_sk": T.BIGINT, "ws_wholesale_cost": DEC2,
        "ws_ext_list_price": DEC2,
    },
    "catalog_returns": {
        "cr_returned_date_sk": T.BIGINT, "cr_item_sk": T.BIGINT,
        "cr_order_number": T.BIGINT,
        "cr_returning_customer_sk": T.BIGINT,
        "cr_call_center_sk": T.BIGINT,
        "cr_return_quantity": T.BIGINT, "cr_return_amount": DEC2,
        "cr_refunded_cash": DEC2, "cr_net_loss": DEC2,
        "cr_returning_addr_sk": T.BIGINT, "cr_reversed_charge": DEC2,
        "cr_catalog_page_sk": T.BIGINT, "cr_return_amt_inc_tax": DEC2,
        "cr_store_credit": DEC2,
    },
    "web_returns": {
        "wr_returned_date_sk": T.BIGINT, "wr_item_sk": T.BIGINT,
        "wr_order_number": T.BIGINT,
        "wr_returning_customer_sk": T.BIGINT,
        "wr_return_quantity": T.BIGINT, "wr_return_amt": DEC2,
        "wr_refunded_cash": DEC2, "wr_net_loss": DEC2,
        "wr_refunded_cdemo_sk": T.BIGINT,
        "wr_returning_addr_sk": T.BIGINT,
        "wr_returning_cdemo_sk": T.BIGINT,
        "wr_refunded_addr_sk": T.BIGINT,
        "wr_reason_sk": T.BIGINT, "wr_web_page_sk": T.BIGINT,
        "wr_fee": DEC2,
    },
    "web_site": {
        "web_site_sk": T.BIGINT, "web_site_id": T.VARCHAR,
        "web_name": T.VARCHAR, "web_company_name": T.VARCHAR,
    },
    "web_page": {
        "wp_web_page_sk": T.BIGINT, "wp_web_page_id": T.VARCHAR,
        "wp_char_count": T.BIGINT,
    },
    "time_dim": {
        "t_time_sk": T.BIGINT, "t_time_id": T.VARCHAR,
        "t_time": T.BIGINT, "t_hour": T.BIGINT,
        "t_minute": T.BIGINT, "t_second": T.BIGINT,
        "t_meal_time": T.VARCHAR,
    },
    "ship_mode": {
        "sm_ship_mode_sk": T.BIGINT, "sm_ship_mode_id": T.VARCHAR,
        "sm_type": T.VARCHAR, "sm_carrier": T.VARCHAR,
        "sm_code": T.VARCHAR,
    },
    "store_returns": {
        "sr_returned_date_sk": T.BIGINT, "sr_item_sk": T.BIGINT,
        "sr_customer_sk": T.BIGINT, "sr_ticket_number": T.BIGINT,
        "sr_reason_sk": T.BIGINT,
        "sr_return_quantity": T.BIGINT, "sr_return_amt": DEC2,
        "sr_net_loss": DEC2, "sr_store_sk": T.BIGINT,
        "sr_cdemo_sk": T.BIGINT,
    },
    "inventory": {
        "inv_date_sk": T.BIGINT, "inv_item_sk": T.BIGINT,
        "inv_warehouse_sk": T.BIGINT,
        "inv_quantity_on_hand": T.BIGINT,
    },
    "reason": {
        "r_reason_sk": T.BIGINT, "r_reason_id": T.VARCHAR,
        "r_reason_desc": T.VARCHAR,
    },
    "income_band": {
        "ib_income_band_sk": T.BIGINT, "ib_lower_bound": T.BIGINT,
        "ib_upper_bound": T.BIGINT,
    },
    "call_center": {
        "cc_call_center_sk": T.BIGINT, "cc_call_center_id": T.VARCHAR,
        "cc_name": T.VARCHAR, "cc_class": T.VARCHAR,
        "cc_employees": T.BIGINT, "cc_manager": T.VARCHAR,
        "cc_county": T.VARCHAR,
    },
    "catalog_page": {
        "cp_catalog_page_sk": T.BIGINT, "cp_catalog_page_id": T.VARCHAR,
        "cp_department": T.VARCHAR, "cp_catalog_number": T.BIGINT,
        "cp_catalog_page_number": T.BIGINT, "cp_type": T.VARCHAR,
    },
}

_BASE_ROWS = {
    "date_dim": 2556,  # 7 years of days
    "item": 18_000, "customer": 100_000, "customer_address": 50_000,
    "customer_demographics": 19_208, "household_demographics": 7_200,
    "store": 12, "warehouse": 5, "promotion": 300,
    "store_sales": 2_880_000, "catalog_sales": 1_440_000,
    "web_sales": 720_000, "store_returns": 288_000,
    "catalog_returns": 144_000, "web_returns": 72_000,
    "inventory": 783_000,
    "web_site": 30, "web_page": 60, "time_dim": 86_400,
    "ship_mode": 20,
    "reason": 35, "income_band": 20, "call_center": 6,
    "catalog_page": 11_718,
}

_UNIQUE = {
    # business identifiers (c_customer_id, i_item_id are spec-unique)
    # matter for FD-based group-key reduction: q4/q11/q74 group the
    # year_total CTE by customer_id plus its dependent attributes
    "date_dim": [("d_date_sk",), ("d_date",)],
    "item": [("i_item_sk",)],
    "customer": [("c_customer_sk",), ("c_customer_id",)],
    "customer_address": [("ca_address_sk",)],
    "customer_demographics": [("cd_demo_sk",)],
    "household_demographics": [("hd_demo_sk",)],
    "store": [("s_store_sk",)], "warehouse": [("w_warehouse_sk",)],
    "promotion": [("p_promo_sk",)],
    "web_site": [("web_site_sk",)], "web_page": [("wp_web_page_sk",)],
    "time_dim": [("t_time_sk",)], "ship_mode": [("sm_ship_mode_sk",)],
    "reason": [("r_reason_sk",)],
    "income_band": [("ib_income_band_sk",)],
    "call_center": [("cc_call_center_sk",)],
    "catalog_page": [("cp_catalog_page_sk",)],
}

_CATEGORIES = ["Home", "Books", "Electronics", "Shoes", "Women", "Men",
               "Jewelry", "Sports", "Music", "Children"]
_CLASSES = ["accent", "classical", "fiction", "fitness", "athletic",
            "portable", "dresses", "pants", "birdal", "estate",
            "maternity", "infants", "swimwear", "country", "rock"]
_STATES = ["TN", "GA", "OH", "TX", "CA", "NY", "WA", "IL", "MI", "NC"]
# dsdgen-style syllable brands referenced verbatim by official query
# filters (q53/q63/q89 and kin)
_BRANDS = ["amalgimporto #1", "importoamalg #1", "scholaramalgamalg #7",
           "scholaramalgamalg #9", "scholaramalgamalg #14",
           "exportiunivamalg #9", "edu packscholar #1", "exportischolar #1",
           "exportiexporti #1", "amalgamalg #1", "univamalgamalg #10",
           "maxinameless #4"]
_COLORS = ["red", "blue", "green", "yellow", "black", "white", "purple",
           "orange", "pink", "brown", "chartreuse", "ivory", "slate",
           "khaki", "salmon", "plum"]
_CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Centerville",
           "Liberty", "Pleasant Hill", "Riverside", "Salem", "Union"]
_DAYNAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
_FIRST = ["James", "Mary", "John", "Linda", "Robert", "Susan", "David",
          "Karen", "Paul", "Nancy"]
_LAST = ["Smith", "Johnson", "Brown", "Jones", "Miller", "Davis",
         "Wilson", "Moore", "Taylor", "White"]


class TpcdsGenerator:
    START = _D("1998-01-01")

    def __init__(self, scale: float, seed: int = 20030527,
                 sales_provider=None):
        self.scale = scale
        self.seed = seed
        # Returns tables sample real (order_number, item_sk, ...) rows
        # from their sales table so the join keys hit. The connector
        # wires this to its Table cache so the numeric sales arrays are
        # held once; standalone generators fall back to regeneration.
        self._sales = sales_provider or self.generate

    def rows(self, name: str) -> int:
        base = _BASE_ROWS[name]
        if name in ("date_dim", "store", "warehouse", "promotion",
                    "customer_demographics", "household_demographics",
                    "web_site", "web_page", "time_dim", "ship_mode",
                    "reason", "income_band", "call_center",
                    "catalog_page"):
            return base
        return max(10, int(base * self.scale))

    def _rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng(self.seed + salt * 7919)

    def generate(self, name: str) -> dict[str, np.ndarray]:
        return getattr(self, "_g_" + name)()

    def _g_date_dim(self):
        n = self.rows("date_dim")
        sk = np.arange(1, n + 1)
        dates = self.START + np.arange(n)
        civil = (np.datetime64("1970-01-01")
                 + dates.astype("timedelta64[D]"))
        years = civil.astype("datetime64[Y]").astype(int) + 1970
        months = civil.astype("datetime64[M]").astype(int) % 12 + 1
        dom = (civil - civil.astype("datetime64[M]")).astype(int) + 1
        dow = (dates + 4) % 7
        return {
            "d_date_sk": sk,
            "d_date_id": np.array([f"AAAAAAAA{sk_:010d}" for sk_ in sk],
                                  object),
            "d_date": dates.astype(np.int32),
            "d_year": years, "d_moy": months, "d_dom": dom,
            "d_qoy": (months - 1) // 3 + 1,
            "d_dow": dow,
            "d_day_name": np.array(_DAYNAMES, object)[dow],
            "d_month_seq": (years - 1900) * 12 + months - 1,
            "d_week_seq": (dates - self.START) // 7,
            "d_quarter_name": np.array(
                [f"{y}Q{q}" for y, q in
                 zip(years, (months - 1) // 3 + 1)], object),
        }

    def _g_item(self):
        n = self.rows("item")
        rng = self._rng(1)
        sk = np.arange(1, n + 1)
        brand_id = rng.integers(1, 1000, n) * 10 + rng.integers(1, 10, n)
        cat = rng.integers(0, len(_CATEGORIES), n)
        cls = rng.integers(0, len(_CLASSES), n)
        manu = rng.integers(1, 1000, n)
        return {
            "i_item_sk": sk,
            "i_item_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "i_item_desc": np.array(
                [f"item description {sk_ % 997}" for sk_ in sk], object),
            "i_current_price": rng.integers(100, 10000, n),
            "i_wholesale_cost": rng.integers(50, 7000, n),
            "i_brand_id": brand_id,
            "i_brand": np.where(
                brand_id % 7 < 3,
                np.array(_BRANDS, object)[brand_id % len(_BRANDS)],
                np.array([f"brand#{b}" for b in brand_id % 500],
                         object)),
            "i_class_id": cls + 1,
            "i_class": np.array(_CLASSES, object)[cls],
            "i_category_id": cat + 1,
            "i_category": np.array(_CATEGORIES, object)[cat],
            "i_manufact_id": manu,
            "i_manufact": np.array(
                [f"manufact#{m}" for m in manu % 200], object),
            "i_manager_id": rng.integers(1, 100, n),
            "i_color": np.array(_COLORS, object)[
                rng.integers(0, len(_COLORS), n)],
            "i_product_name": np.array(
                [f"product{sk_ % 4999}n" for sk_ in sk], object),
            "i_size": np.array(
                ["small", "medium", "large", "extra large", "economy",
                 "N/A", "petite"], object)[rng.integers(0, 7, n)],
            "i_units": np.array(
                ["Each", "Dozen", "Case", "Pallet", "Box"], object)[
                rng.integers(0, 5, n)],
        }

    def _g_customer(self):
        n = self.rows("customer")
        rng = self._rng(2)
        sk = np.arange(1, n + 1)
        return {
            "c_customer_sk": sk,
            "c_customer_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "c_current_cdemo_sk": rng.integers(
                1, self.rows("customer_demographics") + 1, n),
            "c_current_hdemo_sk": rng.integers(
                1, self.rows("household_demographics") + 1, n),
            "c_current_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "c_first_name": np.array(_FIRST, object)[
                rng.integers(0, len(_FIRST), n)],
            "c_last_name": np.array(_LAST, object)[
                rng.integers(0, len(_LAST), n)],
            "c_birth_year": rng.integers(1930, 1995, n),
            "c_birth_country": np.array(
                ["UNITED STATES", "CANADA", "MEXICO", "FRANCE",
                 "GERMANY"], object)[rng.integers(0, 5, n)],
            "c_email_address": np.array(
                [f"c{sk_}@example.com" for sk_ in sk], object),
            "c_salutation": np.array(
                ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"], object)[
                rng.integers(0, 6, n)],
            "c_preferred_cust_flag": np.array(["N", "Y"], object)[
                rng.integers(0, 2, n)],
            "c_birth_month": rng.integers(1, 13, n),
            "c_birth_day": rng.integers(1, 29, n),
            "c_login": np.array([f"login{sk_}" for sk_ in sk], object),
            "c_first_sales_date_sk": rng.integers(
                1, self.rows("date_dim") + 1, n),
            "c_first_shipto_date_sk": rng.integers(
                1, self.rows("date_dim") + 1, n),
            "c_last_review_date_sk": rng.integers(
                1, self.rows("date_dim") + 1, n),
        }

    def _g_customer_address(self):
        n = self.rows("customer_address")
        rng = self._rng(3)
        sk = np.arange(1, n + 1)
        return {
            "ca_address_sk": sk,
            "ca_address_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "ca_city": np.array(_CITIES, object)[
                rng.integers(0, len(_CITIES), n)],
            "ca_county": np.array(
                [f"{c} County" for c in _CITIES], object)[
                rng.integers(0, len(_CITIES), n)],
            "ca_state": np.array(_STATES, object)[
                rng.integers(0, len(_STATES), n)],
            "ca_zip": np.array(
                [f"{z:05d}" for z in rng.integers(10000, 99999, n)],
                object),
            "ca_country": np.full(n, "United States", object),
            "ca_gmt_offset": rng.choice(
                np.array([-800, -700, -600, -500]), n),
            "ca_street_number": np.array(
                [str(x) for x in rng.integers(1, 1000, n)], object),
            "ca_street_name": np.array(
                [f"{c} Street" for c in
                 np.array(_CITIES)[rng.integers(0, len(_CITIES), n)]],
                object),
            "ca_street_type": np.array(
                ["Street", "Ave", "Blvd", "Way", "Ct", "Dr", "Ln"],
                object)[rng.integers(0, 7, n)],
            "ca_suite_number": np.array(
                [f"Suite {x}" for x in rng.integers(0, 100, n)], object),
            "ca_location_type": np.array(
                ["apartment", "condo", "single family"], object)[
                rng.integers(0, 3, n)],
        }

    def _g_customer_demographics(self):
        n = self.rows("customer_demographics")
        i = np.arange(n)
        return {
            "cd_demo_sk": i + 1,
            "cd_gender": np.array(["M", "F"], object)[i % 2],
            "cd_marital_status": np.array(
                ["M", "S", "D", "W", "U"], object)[(i // 2) % 5],
            "cd_education_status": np.array(
                ["Primary", "Secondary", "College", "2 yr Degree",
                 "4 yr Degree", "Advanced Degree", "Unknown"],
                object)[(i // 10) % 7],
            "cd_purchase_estimate": (i % 20) * 500 + 500,
            "cd_credit_rating": np.array(
                ["Low Risk", "Good", "High Risk", "Unknown"],
                object)[(i // 70) % 4],
            "cd_dep_count": i % 7,
            "cd_dep_employed_count": (i // 7) % 7,
            "cd_dep_college_count": (i // 49) % 7,
        }

    def _g_household_demographics(self):
        n = self.rows("household_demographics")
        i = np.arange(n)
        return {
            "hd_demo_sk": i + 1,
            "hd_income_band_sk": i % 20 + 1,
            "hd_buy_potential": np.array(
                [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"], object)[i % 6],
            "hd_dep_count": i % 10,
            "hd_vehicle_count": i % 5,
        }

    def _g_store(self):
        n = self.rows("store")
        rng = self._rng(4)
        sk = np.arange(1, n + 1)
        return {
            "s_store_sk": sk,
            "s_store_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "s_store_name": np.array(
                ["ought", "able", "pri", "ese", "anti", "cally", "ation",
                 "eing", "n st", "bar", "ought2", "able2"],
                object)[:n],
            "s_number_employees": rng.integers(200, 300, n),
            "s_city": np.array(_CITIES, object)[
                rng.integers(0, len(_CITIES), n)],
            "s_county": np.array(
                [f"{c} County" for c in _CITIES], object)[
                rng.integers(0, len(_CITIES), n)],
            "s_state": np.array(_STATES, object)[
                rng.integers(0, len(_STATES), n)],
            "s_gmt_offset": rng.choice(np.array([-600, -500]), n),
            "s_company_id": np.ones(n, dtype=np.int64),
            "s_company_name": np.array(["Unknown"] * n, object),
            "s_zip": np.array(
                [f"{z:05d}" for z in rng.integers(10000, 99999, n)],
                object),
            "s_market_id": rng.integers(1, 11, n),
            "s_street_number": np.array(
                [str(x) for x in rng.integers(1, 1000, n)], object),
            "s_street_name": np.array(
                [f"{c} Street" for c in
                 np.array(_CITIES)[rng.integers(0, len(_CITIES), n)]],
                object),
            "s_street_type": np.array(
                ["Street", "Ave", "Blvd", "Way"], object)[
                rng.integers(0, 4, n)],
            "s_suite_number": np.array(
                [f"Suite {x}" for x in rng.integers(0, 100, n)], object),
        }

    def _g_warehouse(self):
        n = self.rows("warehouse")
        rng = self._rng(5)
        sk = np.arange(1, n + 1)
        return {
            "w_warehouse_sk": sk,
            "w_warehouse_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "w_warehouse_name": np.array(
                [f"Warehouse {sk_}" for sk_ in sk], object),
            "w_warehouse_sq_ft": rng.integers(50_000, 1_000_000, n),
            "w_city": np.array(_CITIES, object)[
                rng.integers(0, len(_CITIES), n)],
            "w_state": np.array(_STATES, object)[
                rng.integers(0, len(_STATES), n)],
            "w_county": np.array(
                [f"{c} County" for c in _CITIES], object)[
                rng.integers(0, len(_CITIES), n)],
            "w_country": np.full(n, "United States", object),
        }

    def _g_promotion(self):
        n = self.rows("promotion")
        rng = self._rng(6)
        sk = np.arange(1, n + 1)
        yn = np.array(["Y", "N"], object)
        return {
            "p_promo_sk": sk,
            "p_promo_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "p_channel_dmail": yn[rng.integers(0, 2, n)],
            "p_channel_email": yn[rng.integers(0, 2, n)],
            "p_channel_tv": yn[rng.integers(0, 2, n)],
            "p_promo_name": np.array(
                [f"promo {sk_ % 50}" for sk_ in sk], object),
            "p_channel_event": yn[rng.integers(0, 2, n)],
        }

    def _sales_common(self, n, rng, n_dates):
        date_sk = rng.integers(1, n_dates + 1, n)
        item_sk = rng.integers(1, self.rows("item") + 1, n)
        qty = rng.integers(1, 100, n)
        wholesale = rng.integers(100, 10000, n)
        list_price = (wholesale * rng.integers(110, 200, n)) // 100
        sales_price = (list_price * rng.integers(30, 100, n)) // 100
        return date_sk, item_sk, qty, wholesale, list_price, sales_price

    def _g_store_sales(self):
        n = self.rows("store_sales")
        rng = self._rng(7)
        n_dates = self.rows("date_dim")
        date_sk, item_sk, qty, wholesale, lp, sp = self._sales_common(
            n, rng, n_dates)
        ext_sales = sp * qty
        ext_wholesale = wholesale * qty
        ext_list = lp * qty
        coupon = np.where(rng.integers(0, 10, n) == 0,
                          ext_sales // 10, 0)
        net_paid = ext_sales - coupon
        return {
            "ss_sold_date_sk": date_sk,
            "ss_sold_time_sk": rng.integers(
                1, self.rows("time_dim") + 1, n),
            "ss_item_sk": item_sk,
            "ss_customer_sk": rng.integers(
                1, self.rows("customer") + 1, n),
            "ss_cdemo_sk": rng.integers(
                1, self.rows("customer_demographics") + 1, n),
            "ss_hdemo_sk": rng.integers(
                1, self.rows("household_demographics") + 1, n),
            "ss_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "ss_store_sk": rng.integers(1, self.rows("store") + 1, n),
            "ss_promo_sk": rng.integers(1, self.rows("promotion") + 1, n),
            "ss_ticket_number": np.arange(1, n + 1) // 4 + 1,
            "ss_quantity": qty,
            "ss_wholesale_cost": wholesale,
            "ss_list_price": lp,
            "ss_sales_price": sp,
            "ss_ext_discount_amt": ext_list - ext_sales,
            "ss_ext_sales_price": ext_sales,
            "ss_ext_wholesale_cost": ext_wholesale,
            "ss_ext_list_price": ext_list,
            "ss_ext_tax": (ext_sales * rng.integers(0, 9, n)) // 100,
            "ss_coupon_amt": coupon,
            "ss_net_paid": net_paid,
            "ss_net_profit": net_paid - ext_wholesale,
        }

    def _g_catalog_sales(self):
        n = self.rows("catalog_sales")
        rng = self._rng(8)
        n_dates = self.rows("date_dim")
        date_sk, item_sk, qty, wholesale, lp, sp = self._sales_common(
            n, rng, n_dates)
        ext_sales = sp * qty
        ext_list = lp * qty
        coupon = np.where(rng.integers(0, 10, n) == 0,
                          ext_sales // 10, 0)
        net_paid = ext_sales - coupon
        return {
            "cs_sold_date_sk": date_sk,
            "cs_item_sk": item_sk,
            "cs_bill_customer_sk": rng.integers(
                1, self.rows("customer") + 1, n),
            "cs_ship_customer_sk": rng.integers(
                1, self.rows("customer") + 1, n),
            "cs_bill_cdemo_sk": rng.integers(
                1, self.rows("customer_demographics") + 1, n),
            "cs_bill_hdemo_sk": rng.integers(
                1, self.rows("household_demographics") + 1, n),
            "cs_ship_date_sk": np.minimum(
                date_sk + rng.integers(1, 30, n), n_dates),
            "cs_warehouse_sk": rng.integers(
                1, self.rows("warehouse") + 1, n),
            "cs_ship_mode_sk": rng.integers(
                1, self.rows("ship_mode") + 1, n),
            "cs_call_center_sk": rng.integers(1, 7, n),
            # ~half the promo keys miss the promotion table so LEFT
            # JOIN promotion (Q72) produces real NULL p_promo_sk rows
            "cs_promo_sk": rng.integers(
                1, 2 * self.rows("promotion") + 1, n),
            "cs_order_number": np.arange(1, n + 1) // 3 + 1,
            "cs_quantity": qty,
            "cs_wholesale_cost": wholesale,
            "cs_list_price": lp,
            "cs_sales_price": sp,
            "cs_ext_discount_amt": ext_list - ext_sales,
            "cs_ext_sales_price": ext_sales,
            "cs_ext_wholesale_cost": wholesale * qty,
            "cs_ext_list_price": ext_list,
            "cs_ext_ship_cost": (ext_sales * rng.integers(2, 10, n)) // 100,
            "cs_coupon_amt": coupon,
            "cs_net_paid": net_paid,
            "cs_net_profit": net_paid - wholesale * qty,
            "cs_bill_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "cs_ship_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "cs_sold_time_sk": rng.integers(
                1, self.rows("time_dim") + 1, n),
            "cs_catalog_page_sk": rng.integers(
                1, self.rows("catalog_page") + 1, n),
            "cs_net_paid_inc_tax": net_paid + (ext_sales
                                               * rng.integers(0, 9, n)
                                               ) // 100,
        }

    def _g_web_sales(self):
        n = self.rows("web_sales")
        rng = self._rng(9)
        n_dates = self.rows("date_dim")
        date_sk, item_sk, qty, wholesale, lp, sp = self._sales_common(
            n, rng, n_dates)
        ext_sales = sp * qty
        ext_list = lp * qty
        return {
            "ws_sold_date_sk": date_sk,
            "ws_sold_time_sk": rng.integers(
                1, self.rows("time_dim") + 1, n),
            "ws_item_sk": item_sk,
            "ws_bill_customer_sk": rng.integers(
                1, self.rows("customer") + 1, n),
            "ws_ship_customer_sk": rng.integers(
                1, self.rows("customer") + 1, n),
            "ws_ship_hdemo_sk": rng.integers(
                1, self.rows("household_demographics") + 1, n),
            "ws_ship_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "ws_ship_date_sk": np.minimum(
                date_sk + rng.integers(1, 30, n), n_dates),
            "ws_warehouse_sk": rng.integers(
                1, self.rows("warehouse") + 1, n),
            "ws_web_site_sk": rng.integers(
                1, self.rows("web_site") + 1, n),
            "ws_web_page_sk": rng.integers(
                1, self.rows("web_page") + 1, n),
            "ws_ship_mode_sk": rng.integers(
                1, self.rows("ship_mode") + 1, n),
            "ws_promo_sk": rng.integers(1, self.rows("promotion") + 1, n),
            "ws_order_number": np.arange(1, n + 1) // 3 + 1,
            "ws_quantity": qty,
            "ws_list_price": lp,
            "ws_sales_price": sp,
            "ws_ext_discount_amt": ext_list - ext_sales,
            "ws_ext_sales_price": ext_sales,
            "ws_ext_wholesale_cost": wholesale * qty,
            "ws_ext_ship_cost": (ext_sales * rng.integers(2, 10, n)) // 100,
            "ws_net_paid": ext_sales,
            "ws_net_profit": ext_sales - wholesale * qty,
            "ws_bill_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "ws_wholesale_cost": wholesale,
            "ws_ext_list_price": ext_list,
        }

    def _g_store_returns(self):
        """Samples real store_sales rows so the
        (sr_customer_sk, sr_item_sk, sr_ticket_number) triple joins back
        to its sale (Q25/Q29 shapes need matching return lines)."""
        n = self.rows("store_returns")
        rng = self._rng(10)
        ss = self._sales("store_sales")
        idx = rng.integers(0, len(ss["ss_ticket_number"]), n)
        return {
            "sr_returned_date_sk": np.minimum(
                ss["ss_sold_date_sk"][idx] + rng.integers(1, 60, n),
                self.rows("date_dim")),
            "sr_item_sk": ss["ss_item_sk"][idx],
            "sr_customer_sk": ss["ss_customer_sk"][idx],
            "sr_ticket_number": ss["ss_ticket_number"][idx],
            "sr_store_sk": rng.integers(1, self.rows("store") + 1, n),
            "sr_cdemo_sk": rng.integers(
                1, self.rows("customer_demographics") + 1, n),
            "sr_reason_sk": rng.integers(
                1, self.rows("reason") + 1, n),
            "sr_return_quantity": np.minimum(
                rng.integers(1, 20, n), ss["ss_quantity"][idx]),
            "sr_return_amt": rng.integers(100, 50000, n),
            "sr_net_loss": rng.integers(50, 20000, n),
        }

    def _g_catalog_returns(self):
        """Returns sample real catalog_sales rows so the
        (cr_order_number, cr_item_sk) pairs join back (reference dsdgen
        emits returns for a fraction of sales lines)."""
        n = self.rows("catalog_returns")
        rng = self._rng(12)
        cs = self._sales("catalog_sales")
        idx = rng.integers(0, len(cs["cs_order_number"]), n)
        qty = np.minimum(rng.integers(1, 20, n), cs["cs_quantity"][idx])
        amt = cs["cs_sales_price"][idx] * qty
        return {
            "cr_returned_date_sk": np.minimum(
                cs["cs_ship_date_sk"][idx] + rng.integers(1, 60, n),
                self.rows("date_dim")),
            "cr_item_sk": cs["cs_item_sk"][idx],
            "cr_order_number": cs["cs_order_number"][idx],
            "cr_returning_customer_sk": cs["cs_bill_customer_sk"][idx],
            "cr_call_center_sk": rng.integers(
                1, self.rows("call_center") + 1, n),
            "cr_return_quantity": qty,
            "cr_return_amount": amt,
            "cr_refunded_cash": (amt * rng.integers(50, 100, n)) // 100,
            "cr_net_loss": rng.integers(50, 20000, n),
            "cr_returning_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "cr_reversed_charge": (amt * rng.integers(0, 40, n)) // 100,
            "cr_catalog_page_sk": rng.integers(
                1, self.rows("catalog_page") + 1, n),
            "cr_return_amt_inc_tax": amt + (amt * rng.integers(0, 9, n)
                                            ) // 100,
            "cr_store_credit": (amt * rng.integers(0, 30, n)) // 100,
        }

    def _g_web_returns(self):
        n = self.rows("web_returns")
        rng = self._rng(13)
        ws = self._sales("web_sales")
        idx = rng.integers(0, len(ws["ws_order_number"]), n)
        qty = np.minimum(rng.integers(1, 20, n), ws["ws_quantity"][idx])
        amt = ws["ws_sales_price"][idx] * qty
        return {
            "wr_returned_date_sk": np.minimum(
                ws["ws_ship_date_sk"][idx] + rng.integers(1, 60, n),
                self.rows("date_dim")),
            "wr_item_sk": ws["ws_item_sk"][idx],
            "wr_order_number": ws["ws_order_number"][idx],
            "wr_returning_customer_sk": ws["ws_bill_customer_sk"][idx],
            "wr_return_quantity": qty,
            "wr_return_amt": amt,
            "wr_refunded_cash": (amt * rng.integers(50, 100, n)) // 100,
            "wr_net_loss": rng.integers(50, 20000, n),
            "wr_refunded_cdemo_sk": rng.integers(
                1, self.rows("customer_demographics") + 1, n),
            "wr_returning_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "wr_returning_cdemo_sk": rng.integers(
                1, self.rows("customer_demographics") + 1, n),
            "wr_refunded_addr_sk": rng.integers(
                1, self.rows("customer_address") + 1, n),
            "wr_reason_sk": rng.integers(1, self.rows("reason") + 1, n),
            "wr_web_page_sk": rng.integers(
                1, self.rows("web_page") + 1, n),
            "wr_fee": rng.integers(50, 10000, n),
        }

    def _g_web_site(self):
        n = self.rows("web_site")
        sk = np.arange(1, n + 1)
        names = ["pri", "able", "ought", "ese", "anti", "cally"]
        return {
            "web_site_sk": sk,
            "web_site_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "web_name": np.array(
                [f"site_{sk_ % 8}" for sk_ in sk], object),
            "web_company_name": np.array(names, object)[sk % len(names)],
        }

    def _g_web_page(self):
        n = self.rows("web_page")
        rng = self._rng(14)
        sk = np.arange(1, n + 1)
        return {
            "wp_web_page_sk": sk,
            "wp_web_page_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "wp_char_count": rng.integers(100, 8000, n),
        }

    def _g_time_dim(self):
        n = self.rows("time_dim")
        sk = np.arange(1, n + 1)
        sec = np.arange(n)
        hour = sec // 3600
        meal = np.full(n, "", object)
        meal[(hour >= 6) & (hour < 9)] = "breakfast"
        meal[(hour >= 11) & (hour < 14)] = "lunch"
        meal[(hour >= 17) & (hour < 20)] = "dinner"
        return {
            "t_time_sk": sk,
            "t_time_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "t_time": sec, "t_hour": hour,
            "t_minute": (sec // 60) % 60, "t_second": sec % 60,
            "t_meal_time": meal,
        }

    def _g_reason(self):
        n = self.rows("reason")
        sk = np.arange(1, n + 1)
        descs = ["Package was damaged", "Stopped working",
                 "Did not get it on time", "Not the product that "
                 "was ordred", "Parts missing", "Does not work with "
                 "a product that I have", "Gift exchange",
                 "Did not like the color", "Did not like the model",
                 "Did not fit", "Wrong size", "Lost my job",
                 "Found a better price in a store",
                 "Found a better extension in a store",
                 "No service location in my area",
                 "Duplicate purchase", "Its is a boring color",
                 "Reason 18", "Reason 19", "unknown"]
        return {
            "r_reason_sk": sk,
            "r_reason_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "r_reason_desc": np.array(descs, object)[
                (sk - 1) % len(descs)],
        }

    def _g_income_band(self):
        n = self.rows("income_band")
        sk = np.arange(1, n + 1)
        return {
            "ib_income_band_sk": sk,
            "ib_lower_bound": (sk - 1) * 10_000,
            "ib_upper_bound": sk * 10_000,
        }

    def _g_call_center(self):
        n = self.rows("call_center")
        sk = np.arange(1, n + 1)
        names = ["NY Metro", "Mid Atlantic", "Hawaii/Alaska",
                 "North Midwest", "California", "Pacific Northwest"]
        classes = ["large", "medium", "small"]
        return {
            "cc_call_center_sk": sk,
            "cc_call_center_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "cc_name": np.array(names, object)[(sk - 1) % len(names)],
            "cc_class": np.array(classes, object)[
                (sk - 1) % len(classes)],
            "cc_employees": sk * 1000 % 7 * 100 + 100,
            "cc_manager": np.array(_FIRST, object)[(sk - 1) % len(_FIRST)],
            "cc_county": np.array(_CITIES, object)[(sk - 1) % len(_CITIES)],
        }

    def _g_catalog_page(self):
        n = self.rows("catalog_page")
        sk = np.arange(1, n + 1)
        depts = ["DEPARTMENT"]
        types = ["bi-annual", "quarterly", "monthly"]
        return {
            "cp_catalog_page_sk": sk,
            "cp_catalog_page_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "cp_department": np.array(depts, object)[np.zeros(n, int)],
            "cp_catalog_number": (sk - 1) // 108 + 1,
            "cp_catalog_page_number": (sk - 1) % 108 + 1,
            "cp_type": np.array(types, object)[(sk - 1) % len(types)],
        }

    def _g_ship_mode(self):
        n = self.rows("ship_mode")
        sk = np.arange(1, n + 1)
        types = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"]
        carriers = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL",
                    "TBS", "ZHOU", "LATVIAN", "DIAMOND", "ORIENTAL",
                    "BARIAN", "BOXBUNDLES", "ALLIANCE", "GREAT EASTERN",
                    "HARMSTORF", "PRIVATECARRIER", "GERMA", "MSC",
                    "RUPEKSA", "GUARANTEED"]
        return {
            "sm_ship_mode_sk": sk,
            "sm_ship_mode_id": np.array(
                [f"AAAAAAAA{sk_:08d}" for sk_ in sk], object),
            "sm_type": np.array(types, object)[(sk - 1) % len(types)],
            "sm_carrier": np.array(carriers, object)[
                (sk - 1) % len(carriers)],
            "sm_code": np.array(["AIR", "SURFACE", "SEA"], object)[
                (sk - 1) % 3],
        }

    def _g_inventory(self):
        n = self.rows("inventory")
        rng = self._rng(11)
        return {
            "inv_date_sk": rng.integers(1, self.rows("date_dim") + 1, n),
            "inv_item_sk": rng.integers(1, self.rows("item") + 1, n),
            "inv_warehouse_sk": rng.integers(
                1, self.rows("warehouse") + 1, n),
            "inv_quantity_on_hand": rng.integers(0, 1000, n),
        }


class TpcdsConnector(Connector):
    """Catalog `tpcds`; tiny scale = 0.001 (~3k store_sales rows)."""

    name = "tpcds"

    def __init__(self, scale: float = 0.001, seed: int = 20030527):
        self.scale = scale
        self.gen = TpcdsGenerator(scale, seed,
                                  sales_provider=self._sales_arrays)
        self._tables: dict[str, Table] = {}

    def _sales_arrays(self, name: str) -> dict[str, np.ndarray]:
        """Numeric sales arrays for the returns generators, served from
        the Table cache so the big sales tables are resident once (the
        returns samplers only touch numeric columns, which Tables store
        unchanged)."""
        t = self.table(name)
        return {c: np.asarray(col.data) for c, col in t.columns.items()}

    def table_names(self) -> list[str]:
        return list(SCHEMAS)

    def table_schema(self, name: str):
        return SCHEMAS[name]

    def table(self, name: str) -> Table:
        if name not in self._tables:
            self._tables[name] = Table.from_numpy(
                SCHEMAS[name], self.gen.generate(name))
        return self._tables[name]

    def row_count_estimate(self, name: str) -> int:
        return self.gen.rows(name)

    def unique_keys(self, name: str) -> list[tuple[str, ...]]:
        return list(_UNIQUE.get(name, []))

    # TPC-DS surrogate keys are named for the dimension they reference;
    # the ndv of an FK column is (at most) that dimension's row count —
    # the analog of the reference tpcds connector's shipped column
    # statistics (plugin/trino-tpcds TpcdsMetadata statistics). Longest
    # suffix wins (cs_bill_cdemo_sk -> customer_demographics before
    # _demo_sk could mis-route).
    _SK_SUFFIX = (
        ("_call_center_sk", "call_center"),
        ("_catalog_page_sk", "catalog_page"),
        ("_web_page_sk", "web_page"),
        ("_web_site_sk", "web_site"),
        ("_ship_mode_sk", "ship_mode"),
        ("_income_band_sk", "income_band"),
        ("_warehouse_sk", "warehouse"),
        ("_customer_sk", "customer"),
        ("_cdemo_sk", "customer_demographics"),
        ("_hdemo_sk", "household_demographics"),
        ("_demo_sk", "customer_demographics"),
        ("_addr_sk", "customer_address"),
        ("_date_sk", "date_dim"),
        ("_time_sk", "time_dim"),
        ("_item_sk", "item"),
        ("_store_sk", "store"),
        ("_promo_sk", "promotion"),
        ("_reason_sk", "reason"),
    )

    def ndv_estimates(self, name: str) -> dict[str, int]:
        rows = self.gen.rows(name)
        out: dict[str, int] = {}
        for col in self.table_schema(name):
            for suffix, ref in self._SK_SUFFIX:
                if col.endswith(suffix):
                    out[col] = min(self.gen.rows(ref), rows)
                    break
        return out

    def stats(self, name: str) -> TableStats:
        return TableStats(row_count=self.gen.rows(name))
