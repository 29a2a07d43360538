"""TPC-DS query 55 (the text of tests/test_tpcds.py, with the template's
substitutions MANAGER, MONTH and YEAR)."""

from reference.common import dec, group
from reference.tpcds._star import dates, dim, items

SQL = """
select i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = {manager} and d_moy = {month} and d_year = {year}
group by i_brand_id, i_brand
order by ext_price desc, brand_id limit 100
"""
COLUMNS = [("brand_id", "int"), ("brand", "str"), ("ext_price", "dec:2")]
ORDER = [(2, True), (0, False)]
LIMIT = 100


def answer(db, p):
    ss = "store_sales"
    date, item = db.col(ss, "ss_sold_date_sk"), db.col(ss, "ss_item_sk")
    ok = (dates(db, date, d_moy=int(p["month"]), d_year=int(p["year"]))
          & items(db, item, i_manager_id=int(p["manager"])))
    item = item[ok]
    keys, ids, n = group([dim(db, "item", "i_item_sk", "i_brand_id", item),
                          dim(db, "item", "i_item_sk", "i_brand", item)])
    sums = db.ints(db.sum(db.num(db.col(ss, "ss_ext_sales_price")[ok]),
                          ids, n))
    brands = db.strings("item", "i_brand", keys[:, 1])
    return [(int(k[0]), brands[g], dec(sums[g], 2))
            for g, k in enumerate(keys)]
