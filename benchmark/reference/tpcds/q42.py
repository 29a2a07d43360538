"""TPC-DS query 42 (the text of tests/test_tpcds.py, with the template's
substitutions MONTH and YEAR)."""

from reference.common import dec, group
from reference.tpcds._star import dates, dim, items

SQL = """
select d_year, i_category_id, i_category,
       sum(ss_ext_sales_price) as s
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = 1 and d_moy = {month} and d_year = {year}
group by d_year, i_category_id, i_category
order by s desc, d_year, i_category_id, i_category
limit 100
"""
COLUMNS = [("d_year", "int"), ("i_category_id", "int"),
           ("i_category", "str"), ("s", "dec:2")]
ORDER = [(3, True), (0, False), (1, False), (2, False)]
LIMIT = 100


def answer(db, p):
    ss = "store_sales"
    date, item = db.col(ss, "ss_sold_date_sk"), db.col(ss, "ss_item_sk")
    ok = (dates(db, date, d_moy=int(p["month"]), d_year=int(p["year"]))
          & items(db, item, i_manager_id=1))
    date, item = date[ok], item[ok]
    keys, ids, n = group([
        dim(db, "date_dim", "d_date_sk", "d_year", date),
        dim(db, "item", "i_item_sk", "i_category_id", item),
        dim(db, "item", "i_item_sk", "i_category", item)])
    sums = db.ints(db.sum(db.num(db.col(ss, "ss_ext_sales_price")[ok]),
                          ids, n))
    cats = db.strings("item", "i_category", keys[:, 2])
    return [(int(k[0]), int(k[1]), cats[g], dec(sums[g], 2))
            for g, k in enumerate(keys)]
