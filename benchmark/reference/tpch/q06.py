"""TPC-H Q6, the forecasting revenue change query (spec 2.4.6): DATE,
DISCOUNT and QUANTITY."""

from decimal import Decimal

from reference.common import add_months, dec, days

SQL = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '{date}'
  and l_shipdate < date '{date}' + interval '1' year
  and l_discount between {discount} - 0.01 and {discount} + 0.01
  and l_quantity < {quantity}
"""
COLUMNS = [("revenue", "dec:4")]
ORDER = []
LIMIT = None


def answer(db, p):
    li = "lineitem"
    ship = db.col(li, "l_shipdate")
    disc = db.col(li, "l_discount")
    cents = int(Decimal(p["discount"]) * 100)
    ok = ((ship >= days(p["date"])) & (ship < add_months(p["date"], 12))
          & (disc >= cents - 1) & (disc <= cents + 1)
          & (db.col(li, "l_quantity") < int(p["quantity"]) * 100))
    if not bool(ok.any()):
        return [(None,)]
    rev = db.num(db.col(li, "l_extendedprice")[ok]) * db.num(disc[ok])
    return [(dec(db.ints(db.sum(rev))[0], 4),)]
