"""TPC-H Q18, the large volume customer query (spec 2.4.18): QUANTITY
from 312 to 315."""

from reference.common import dec, iso, ordered

SQL = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
  sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
    select l_orderkey from lineitem
    group by l_orderkey
    having sum(l_quantity) > {quantity})
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
"""
COLUMNS = [("c_name", "str"), ("c_custkey", "int"), ("o_orderkey", "int"),
           ("o_orderdate", "date"), ("o_totalprice", "dec:2"),
           ("sum", "dec:2")]
ORDER = [(4, True), (3, False)]
LIMIT = 100


def answer(db, p):
    lk = db.col("lineitem", "l_orderkey").long()
    n = db.dense("orders", "o_orderkey").shape[0]
    qty = db.sum(db.num(db.col("lineitem", "l_quantity")), lk, n)
    keys = (qty > int(p["quantity"]) * 100).nonzero().flatten()
    cust = db.dense("orders", "o_orderkey", "o_custkey")[keys]
    names = db.strings("customer", "c_name", db.dense(
        "customer", "c_custkey", "c_name")[cust.long()].cpu().numpy())
    odate = db.dense("orders", "o_orderkey", "o_orderdate")[keys].tolist()
    price = db.dense("orders", "o_orderkey", "o_totalprice")[keys].tolist()
    rows = [(nm, int(c), int(k), iso(d), dec(pr, 2), dec(q, 2))
            for nm, c, k, d, pr, q in zip(names, cust.tolist(), keys.tolist(),
                                          odate, price, db.ints(qty[keys]))]
    return ordered(rows, ORDER, LIMIT)
