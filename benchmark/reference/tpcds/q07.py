"""TPC-DS query 7 (the text of tests/test_tpcds.py, with the template's
substitutions GEN, MS, ES and YEAR, and its channel test on
``p_channel_event``)."""

from reference.common import avg, dec, group
from reference.tpcds._star import dates, demographics, dim, ok as is_ok

SQL = """
select i_item_id, avg(ss_quantity) as agg1,
       avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3,
       avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk and ss_promo_sk = p_promo_sk
  and cd_gender = '{gender}' and cd_marital_status = '{marital}'
  and cd_education_status = '{education}'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = {year}
group by i_item_id
order by i_item_id limit 100
"""
COLUMNS = [("i_item_id", "str"), ("agg1", "double"), ("agg2", "dec:2"),
           ("agg3", "dec:2"), ("agg4", "dec:2")]
ORDER = [(0, False)]
LIMIT = 100


def answer(db, p):
    ss = "store_sales"
    promo = (db.where("promotion", "p_channel_email", lambda s: s == "N")
             | db.where("promotion", "p_channel_event", lambda s: s == "N"))
    ok = (dates(db, db.col(ss, "ss_sold_date_sk"), d_year=int(p["year"]))
          & demographics(db, db.col(ss, "ss_cdemo_sk"), p["gender"],
                         p["marital"], p["education"])
          & is_ok(db, "promotion", "p_promo_sk", promo,
                  db.col(ss, "ss_promo_sk")))
    keys, ids, n = group([dim(db, "item", "i_item_sk", "i_item_id",
                              db.col(ss, "ss_item_sk")[ok])])
    counts = db.count(ids, n).tolist()
    qty, lp, cp, sp = (db.ints(db.sum(db.num(db.col(ss, c)[ok]), ids, n))
                       for c in ("ss_quantity", "ss_list_price",
                                 "ss_coupon_amt", "ss_sales_price"))
    ids_ = db.strings("item", "i_item_id", keys[:, 0])
    return [(ids_[g], mean(qty[g], counts[g], db.precision),
             dec(avg(lp[g], counts[g], db.precision), 2),
             dec(avg(cp[g], counts[g], db.precision), 2),
             dec(avg(sp[g], counts[g], db.precision), 2))
            for g in range(n)]


def mean(total: int, count: int, precision: str) -> float:
    """avg of a bigint column: a double, the exact sum over the count."""
    import numpy as np
    dt = np.float32 if precision == "float32" else np.float64
    return float(dt(total) / dt(count))
