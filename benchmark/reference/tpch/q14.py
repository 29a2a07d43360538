"""TPC-H Q14, the promotion effect query (spec 2.4.14): the first of a
month from January 1993 to December 1997."""

from reference.common import add_months, days, dec, div_half_up

SQL = """
select 100.00 * sum(case when p_type like 'PROMO%'
    then l_extendedprice * (1 - l_discount) else 0 end)
  / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey and l_shipdate >= date '{date}'
  and l_shipdate < date '{date}' + interval '1' month
"""
COLUMNS = [("promo_revenue", "dec:6")]
ORDER = []
LIMIT = None


def answer(db, p):
    li = "lineitem"
    ship = db.col(li, "l_shipdate")
    ok = (ship >= days(p["date"])) & (ship < add_months(p["date"], 1))
    if not bool(ok.any()):
        return [(None,)]
    promo = db.dense("part", "p_partkey", rows=db.where(
        "part", "p_type", lambda s: s.startswith("PROMO")))[
        db.col(li, "l_partkey")[ok].long()]
    rev = (db.num(db.col(li, "l_extendedprice")[ok])
           * (100 - db.num(db.col(li, "l_discount")[ok])))
    both = db.sum(rev, promo.long(), 2)
    if db.precision == "exact":
        promo_units, all_units = db.ints(both)[1], sum(db.ints(both))
        # 100.00 * a (scale 2 + 4) / b (scale 4), at scale 6: 10^8 a / b
        return [(dec(div_half_up(10**8 * promo_units, all_units), 6),)]
    a, b = both[1], both.sum()
    return [(dec(int(round(float(100.0 * a / b * 10**6))), 6),)]
