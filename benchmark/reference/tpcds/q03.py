"""TPC-DS query 3 (the text of tests/test_tpcds.py, with the template's
substitutions MONTH and MANUFACT as ``{month}`` and ``{manufact}``)."""

from reference.common import dec, group
from reference.tpcds._star import dates, dim, items

SQL = """
select d_year, i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manufact_id = {manufact} and d_moy = {month}
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, brand_id
limit 100
"""
COLUMNS = [("d_year", "int"), ("brand_id", "int"), ("brand", "str"),
           ("sum_agg", "dec:2")]
ORDER = [(0, False), (3, True), (1, False)]
LIMIT = 100


def answer(db, p):
    ss = "store_sales"
    date, item = db.col(ss, "ss_sold_date_sk"), db.col(ss, "ss_item_sk")
    ok = (dates(db, date, d_moy=int(p["month"]))
          & items(db, item, i_manufact_id=int(p["manufact"])))
    date, item = date[ok], item[ok]
    keys, ids, n = group([
        dim(db, "date_dim", "d_date_sk", "d_year", date),
        dim(db, "item", "i_item_sk", "i_brand_id", item),
        dim(db, "item", "i_item_sk", "i_brand", item)])
    sums = db.ints(db.sum(db.num(db.col(ss, "ss_ext_sales_price")[ok]),
                          ids, n))
    brands = db.strings("item", "i_brand", keys[:, 2])
    return [(int(y), int(b), brands[g], dec(sums[g], 2))
            for g, (y, b, _c) in enumerate(keys)]
