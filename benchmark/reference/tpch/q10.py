"""TPC-H Q10, the returned item reporting query (spec 2.4.10): the
first of a month from February 1993 to January 1995."""

from reference.common import add_months, dec, days, top

SQL = """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
  c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '{date}'
  and o_orderdate < date '{date}' + interval '3' month
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
  c_comment
order by revenue desc
limit 20
"""
COLUMNS = [("c_custkey", "int"), ("c_name", "str"), ("revenue", "dec:4"),
           ("c_acctbal", "dec:2"), ("n_name", "str"), ("c_address", "str"),
           ("c_phone", "str"), ("c_comment", "str")]
ORDER = [(2, True)]
LIMIT = 20


def answer(db, p):
    odate = db.col("orders", "o_orderdate")
    order_ok = db.dense("orders", "o_orderkey", rows=(
        (odate >= days(p["date"])) & (odate < add_months(p["date"], 3))))
    li = "lineitem"
    lk = db.col(li, "l_orderkey").long()
    ok = order_ok[lk] & db.where(li, "l_returnflag", lambda s: s == "R")
    cust = db.dense("orders", "o_orderkey", "o_custkey")[lk[ok]].long()
    rev = (db.num(db.col(li, "l_extendedprice")[ok])
           * (100 - db.num(db.col(li, "l_discount")[ok])))
    n = db.dense("customer", "c_custkey").shape[0]
    sums = db.sum(rev, cust, n)
    keys = top(sums, db.count(cust, n) > 0, LIMIT).nonzero().flatten()
    nation = db.dense("nation", "n_nationkey", "n_name")

    def strings(column, table="customer", key="c_custkey", at=keys):
        codes = db.dense(table, key, column)[at]
        return db.strings(table, column, codes.cpu().numpy())
    nat = db.dense("customer", "c_custkey", "c_nationkey")[keys].long()
    n_names = db.strings("nation", "n_name", nation[nat].cpu().numpy())
    acct = db.dense("customer", "c_custkey", "c_acctbal")[keys].tolist()
    return [(int(k), nm, dec(s, 4), dec(a, 2), nn, ad, ph, cm)
            for k, nm, s, a, nn, ad, ph, cm in zip(
                keys.tolist(), strings("c_name"), db.ints(sums[keys]), acct,
                n_names, strings("c_address"), strings("c_phone"),
                strings("c_comment"))]
