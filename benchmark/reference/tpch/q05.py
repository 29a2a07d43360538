"""TPC-H Q5, the local supplier volume query (spec 2.4.5): REGION and
January 1 of a year."""

from reference.common import add_months, dec, days

SQL = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = '{region}' and o_orderdate >= date '{date}'
  and o_orderdate < date '{date}' + interval '1' year
group by n_name
order by revenue desc
"""
COLUMNS = [("n_name", "str"), ("revenue", "dec:4")]
ORDER = [(1, True)]
LIMIT = None


def answer(db, p):
    region = db.dense("region", "r_regionkey", rows=db.where(
        "region", "r_name", lambda s: s == p["region"]))
    nation_in = db.dense("nation", "n_nationkey", rows=region[
        db.col("nation", "n_regionkey").long()])
    d0, d1 = days(p["date"]), add_months(p["date"], 12)
    odate = db.col("orders", "o_orderdate")
    order_ok = db.dense("orders", "o_orderkey",
                        rows=(odate >= d0) & (odate < d1))
    o_cust = db.dense("orders", "o_orderkey", "o_custkey")
    c_nat = db.dense("customer", "c_custkey", "c_nationkey")
    s_nat = db.dense("supplier", "s_suppkey", "s_nationkey")
    lk = db.col("lineitem", "l_orderkey").long()
    sn = s_nat[db.col("lineitem", "l_suppkey").long()]
    ok = (order_ok[lk] & (c_nat[o_cust[lk]] == sn) & nation_in[sn])
    rev = (db.num(db.col("lineitem", "l_extendedprice")[ok])
           * (100 - db.num(db.col("lineitem", "l_discount")[ok])))
    n = nation_in.shape[0]
    sums = db.ints(db.sum(rev, sn[ok], n))
    counts = db.count(sn[ok], n).tolist()
    names = db.dense("nation", "n_nationkey", "n_name")
    return [(db.strings("nation", "n_name", [int(names[k])])[0],
             dec(sums[k], 4)) for k in range(n) if counts[k]]
