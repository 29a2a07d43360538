"""TPC-DS query 27 (the text of tests/test_tpcds.py, with the template's
substitutions GEN, MS, ES, YEAR and six states): a rollup over item
and state."""

from reference.common import avg, dec, group
from reference.tpcds._star import dates, demographics, dim, ok as is_ok

SQL = """
SELECT
  "i_item_id"
, "s_state"
, GROUPING ("s_state") "g_state"
, "avg"("ss_quantity") "agg1"
, "avg"("ss_list_price") "agg2"
, "avg"("ss_coupon_amt") "agg3"
, "avg"("ss_sales_price") "agg4"
FROM
  store_sales
, customer_demographics
, date_dim
, store
, item
WHERE ("ss_sold_date_sk" = "d_date_sk")
   AND ("ss_item_sk" = "i_item_sk")
   AND ("ss_store_sk" = "s_store_sk")
   AND ("ss_cdemo_sk" = "cd_demo_sk")
   AND ("cd_gender" = '{gender}')
   AND ("cd_marital_status" = '{marital}')
   AND ("cd_education_status" = '{education}')
   AND ("d_year" = {year})
   AND ("s_state" IN (
     '{state1}'
   , '{state2}'
   , '{state3}'
   , '{state4}'
   , '{state5}'
   , '{state6}'))
GROUP BY ROLLUP (i_item_id, s_state)
ORDER BY "i_item_id" ASC, "s_state" ASC
LIMIT 100
"""
COLUMNS = [("i_item_id", "str"), ("s_state", "str"), ("g_state", "int"),
           ("agg1", "double"), ("agg2", "dec:2"), ("agg3", "dec:2"),
           ("agg4", "dec:2")]
ORDER = [(0, False), (1, False)]
LIMIT = 100


def answer(db, p):
    from reference.tpcds.q07 import mean
    ss = "store_sales"
    states = {p[f"state{k}"] for k in range(1, 7)}
    ok = (dates(db, db.col(ss, "ss_sold_date_sk"), d_year=int(p["year"]))
          & demographics(db, db.col(ss, "ss_cdemo_sk"), p["gender"],
                         p["marital"], p["education"])
          & is_ok(db, "store", "s_store_sk",
                  db.where("store", "s_state", lambda s: s in states),
                  db.col(ss, "ss_store_sk")))
    item = dim(db, "item", "i_item_sk", "i_item_id",
               db.col(ss, "ss_item_sk")[ok])
    state = dim(db, "store", "s_store_sk", "s_state",
                db.col(ss, "ss_store_sk")[ok])
    values = [db.num(db.col(ss, c)[ok]) for c in
              ("ss_quantity", "ss_list_price", "ss_coupon_amt",
               "ss_sales_price")]
    item_ids = db.dictionary("item", "i_item_id")
    states = db.dictionary("store", "s_state")
    rows = []
    # the rollup's levels: (item, state), (item), ()
    for level in (2, 1, 0):
        cols = [item, state][:level]
        if not item.numel():
            # no row: the grand total is still one row, of NULLs
            if not cols:
                rows.append((None, None, 1, None, None, None, None))
            continue
        if cols:
            keys, ids, n = group(cols)
        else:
            keys, ids, n = None, item.new_zeros(item.shape), 1
        counts = db.count(ids, n).tolist()
        sums = [db.ints(db.sum(v, ids, n)) for v in values]
        for g in range(n):
            c = counts[g]
            rows.append((
                str(item_ids[int(keys[g, 0])]) if level >= 1 else None,
                str(states[int(keys[g, 1])]) if level == 2 else None,
                0 if level == 2 else 1,
                mean(sums[0][g], c, db.precision),
                *(dec(avg(s[g], c, db.precision), 2) for s in sums[1:])))
    return rows
