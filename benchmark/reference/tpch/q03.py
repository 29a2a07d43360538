"""TPC-H Q3, the shipping priority query (spec 2.4.3): SEGMENT and a
DATE in March 1995."""

from reference.common import dec, days, iso, top

SQL = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = '{segment}' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '{date}'
  and l_shipdate > date '{date}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""
COLUMNS = [("l_orderkey", "int"), ("revenue", "dec:4"),
           ("o_orderdate", "date"), ("o_shippriority", "int")]
ORDER = [(1, True), (2, False)]
LIMIT = 10


def answer(db, p):
    day = days(p["date"])
    cust = db.dense("customer", "c_custkey", rows=db.where(
        "customer", "c_mktsegment", lambda s: s == p["segment"]))
    o_ok = ((db.col("orders", "o_orderdate") < day)
            & cust[db.col("orders", "o_custkey").long()])
    order_ok = db.dense("orders", "o_orderkey", rows=o_ok)
    lk = db.col("lineitem", "l_orderkey").long()
    ok = (db.col("lineitem", "l_shipdate") > day) & order_ok[lk]
    rev = (db.num(db.col("lineitem", "l_extendedprice")[ok])
           * (100 - db.num(db.col("lineitem", "l_discount")[ok])))
    n = order_ok.shape[0]
    sums = db.sum(rev, lk[ok], n)
    has = db.count(lk[ok], n) > 0
    keys = top(sums, has, LIMIT).nonzero().flatten()
    odate = db.dense("orders", "o_orderkey", "o_orderdate")[keys]
    prio = db.dense("orders", "o_orderkey", "o_shippriority")[keys]
    return [(int(k), dec(s, 4), iso(d), int(pr)) for k, s, d, pr in zip(
        keys.tolist(), db.ints(sums[keys]), odate.tolist(), prio.tolist())]
