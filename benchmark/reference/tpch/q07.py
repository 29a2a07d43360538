"""TPC-H Q7, the volume shipping query (spec 2.4.7): two distinct
nations."""

import numpy as np
import torch

from reference.common import EPOCH, dec, days, group

SQL = """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (
  select n1.n_name as supp_nation, n2.n_name as cust_nation,
    extract(year from l_shipdate) as l_year,
    l_extendedprice * (1 - l_discount) as volume
  from supplier, lineitem, orders, customer, nation n1, nation n2
  where s_suppkey = l_suppkey and o_orderkey = l_orderkey
    and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
    and c_nationkey = n2.n_nationkey
    and ((n1.n_name = '{nation1}' and n2.n_name = '{nation2}')
      or (n1.n_name = '{nation2}' and n2.n_name = '{nation1}'))
    and l_shipdate between date '1995-01-01' and date '1996-12-31'
) as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""
COLUMNS = [("supp_nation", "str"), ("cust_nation", "str"),
           ("l_year", "int"), ("revenue", "dec:4")]
ORDER = [(0, False), (1, False), (2, False)]
LIMIT = None


def answer(db, p):
    names = db.dense("nation", "n_nationkey", "n_name").tolist()
    key_of = {db.strings("nation", "n_name", [c])[0]: k
              for k, c in enumerate(names)
              if bool(db.dense("nation", "n_nationkey")[k])}
    n1, n2 = key_of[p["nation1"]], key_of[p["nation2"]]
    li = "lineitem"
    ship = db.col(li, "l_shipdate")
    lk = db.col(li, "l_orderkey").long()
    sn = db.dense("supplier", "s_suppkey", "s_nationkey")[
        db.col(li, "l_suppkey").long()]
    cn = db.dense("customer", "c_custkey", "c_nationkey")[
        db.dense("orders", "o_orderkey", "o_custkey")[lk].long()]
    ok = ((ship >= days("1995-01-01")) & (ship <= days("1996-12-31"))
          & (((sn == n1) & (cn == n2)) | ((sn == n2) & (cn == n1))))
    lo = days("1995-01-01")
    span = np.arange(lo, days("1997-01-01"))
    years = torch.from_numpy((EPOCH + span.astype("timedelta64[D]"))
                             .astype("datetime64[Y]").astype(np.int64)
                             + 1970).to(db.device)
    year = years[(ship[ok] - lo).long()]
    keys, ids, n = group([sn[ok], cn[ok], year])
    rev = (db.num(db.col(li, "l_extendedprice")[ok])
           * (100 - db.num(db.col(li, "l_discount")[ok])))
    sums = db.ints(db.sum(rev, ids, n))
    name = {k: s for s, k in key_of.items()}
    return [(name[int(s)], name[int(c)], int(y), dec(sums[g], 4))
            for g, (s, c, y) in enumerate(keys)]
