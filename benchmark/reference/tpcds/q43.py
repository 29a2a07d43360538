"""TPC-DS query 43 (the text of tests/test_tpcds.py, with the template's
substitutions GMT and YEAR): sales by store and day of the week."""

from reference.common import dec, group
from reference.tpcds._star import dates, dim, ok as is_ok

DAYS = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
        "Saturday")
SQL = """
select s_store_name, s_store_id,
    sum(case when d_day_name = 'Sunday'
        then ss_sales_price else null end) as sun_sales,
    sum(case when d_day_name = 'Monday'
        then ss_sales_price else null end) as mon_sales,
    sum(case when d_day_name = 'Tuesday'
        then ss_sales_price else null end) as tue_sales,
    sum(case when d_day_name = 'Wednesday'
        then ss_sales_price else null end) as wed_sales,
    sum(case when d_day_name = 'Thursday'
        then ss_sales_price else null end) as thu_sales,
    sum(case when d_day_name = 'Friday'
        then ss_sales_price else null end) as fri_sales,
    sum(case when d_day_name = 'Saturday'
        then ss_sales_price else null end) as sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
  and s_gmt_offset = {gmt} and d_year = {year}
group by s_store_name, s_store_id
order by s_store_name, s_store_id, sun_sales, mon_sales,
         tue_sales, wed_sales, thu_sales, fri_sales, sat_sales
limit 100
"""
COLUMNS = [("s_store_name", "str"), ("s_store_id", "str")] + [
    (d[:3].lower() + "_sales", "dec:2") for d in DAYS]
ORDER = [(c, False) for c in range(9)]
LIMIT = 100


def answer(db, p):
    ss = "store_sales"
    date, store = db.col(ss, "ss_sold_date_sk"), db.col(ss, "ss_store_sk")
    ok = (dates(db, date, d_year=int(p["year"]))
          & is_ok(db, "store", "s_store_sk",
                  db.col("store", "s_gmt_offset") == int(p["gmt"]) * 100,
                  store))
    date, store = date[ok], store[ok]
    keys, ids, n = group([
        dim(db, "store", "s_store_sk", "s_store_name", store),
        dim(db, "store", "s_store_sk", "s_store_id", store)])
    day = dim(db, "date_dim", "d_date_sk", "d_day_name", date)
    names = db.dictionary("date_dim", "d_day_name")
    price = db.num(db.col(ss, "ss_sales_price")[ok])
    per_day = []
    for d in DAYS:
        hit = day == [str(s) for s in names].index(d)
        sums = db.ints(db.sum(price[hit], ids[hit], n))
        counts = db.count(ids[hit], n).tolist()
        per_day.append([dec(s, 2) if c else None
                        for s, c in zip(sums, counts)])
    store_names = db.strings("store", "s_store_name", keys[:, 0])
    store_ids = db.strings("store", "s_store_id", keys[:, 1])
    return [(store_names[g], store_ids[g], *(col[g] for col in per_day))
            for g in range(n)]
