"""TPC-DS query 19 (the text of tests/test_tpcds.py, with the template's
substitutions MANAGER, MONTH and YEAR, and its zip test on ``s_zip``)."""

import torch

from reference.common import dec, group
from reference.tpcds._star import dates, dim, items

SQL = """
select i_brand_id as brand_id, i_brand as brand,
       i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item, customer, customer_address,
     store
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manager_id = {manager} and d_moy = {month} and d_year = {year}
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ss_store_sk = s_store_sk
  and substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)
group by i_brand_id, i_brand, i_manufact_id, i_manufact
order by ext_price desc, brand_id, i_manufact_id
limit 100
"""
COLUMNS = [("brand_id", "int"), ("brand", "str"), ("i_manufact_id", "int"),
           ("i_manufact", "str"), ("ext_price", "dec:2")]
ORDER = [(4, True), (0, False), (2, False)]
LIMIT = 100


def answer(db, p):
    ss = "store_sales"
    item = db.col(ss, "ss_item_sk")
    ok = (dates(db, db.col(ss, "ss_sold_date_sk"), d_moy=int(p["month"]),
                d_year=int(p["year"]))
          & items(db, item, i_manager_id=int(p["manager"])))
    addr = dim(db, "customer", "c_customer_sk", "c_current_addr_sk",
               db.col(ss, "ss_customer_sk")[ok])
    zipc = dim(db, "customer_address", "ca_address_sk", "ca_zip", addr)
    store = dim(db, "store", "s_store_sk", "s_zip",
                db.col(ss, "ss_store_sk")[ok])
    zips = db.dictionary("customer_address", "ca_zip")
    stores = db.dictionary("store", "s_zip")
    differ = torch.tensor([[z[:5] != s[:5] for s in stores] for z in zips],
                          dtype=torch.bool, device=db.device)
    keep = differ[zipc.long(), store.long()]
    item = item[ok][keep]
    keys, ids, n = group([
        dim(db, "item", "i_item_sk", "i_brand_id", item),
        dim(db, "item", "i_item_sk", "i_brand", item),
        dim(db, "item", "i_item_sk", "i_manufact_id", item),
        dim(db, "item", "i_item_sk", "i_manufact", item)])
    sums = db.ints(db.sum(db.num(db.col(ss, "ss_ext_sales_price")[ok][keep]),
                          ids, n))
    brands = db.strings("item", "i_brand", keys[:, 1])
    manus = db.strings("item", "i_manufact", keys[:, 3])
    return [(int(k[0]), brands[g], int(k[2]), manus[g], dec(sums[g], 2))
            for g, k in enumerate(keys)]
