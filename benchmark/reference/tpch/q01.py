"""TPC-H Q1, the pricing summary report (spec 2.4.1): DELTA days
before 1998-12-01."""

from reference.common import avg, dec, days, group

SQL = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '{delta}' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""
COLUMNS = [("l_returnflag", "str"), ("l_linestatus", "str"),
           ("sum_qty", "dec:2"), ("sum_base_price", "dec:2"),
           ("sum_disc_price", "dec:4"), ("sum_charge", "dec:6"),
           ("avg_qty", "dec:2"), ("avg_price", "dec:2"),
           ("avg_disc", "dec:2"), ("count_order", "int")]
ORDER = [(0, False), (1, False)]
LIMIT = None


def answer(db, p):
    li = "lineitem"
    keep = db.col(li, "l_shipdate") <= days("1998-12-01") - int(p["delta"])
    keys, ids, n = group([db.col(li, "l_returnflag")[keep],
                          db.col(li, "l_linestatus")[keep]])
    qty = db.num(db.col(li, "l_quantity")[keep])
    price = db.num(db.col(li, "l_extendedprice")[keep])
    disc = db.num(db.col(li, "l_discount")[keep])
    tax = db.num(db.col(li, "l_tax")[keep])
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    sq, sp, sd, sdp, sc = (db.ints(db.sum(x, ids, n)) for x in
                           (qty, price, disc, disc_price, charge))
    counts = db.count(ids, n).tolist()
    flags = db.strings(li, "l_returnflag", keys[:, 0])
    status = db.strings(li, "l_linestatus", keys[:, 1])
    return [(flags[g], status[g], dec(sq[g], 2), dec(sp[g], 2),
             dec(sdp[g], 4), dec(sc[g], 6),
             dec(avg(sq[g], counts[g], db.precision), 2),
             dec(avg(sp[g], counts[g], db.precision), 2),
             dec(avg(sd[g], counts[g], db.precision), 2), counts[g])
            for g in range(n)]
