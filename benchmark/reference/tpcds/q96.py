"""TPC-DS query 96 (the text of tests/test_tpcds.py, with the template's
substitutions HOUR and DEPCNT)."""

from reference.tpcds._star import ok as is_ok

SQL = """
select count(*) as cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = t_time_sk
  and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk
  and t_hour = {hour} and t_minute >= 30
  and hd_dep_count = {depcnt}
  and s_store_name = 'ese'
order by cnt limit 100
"""
COLUMNS = [("cnt", "int")]
ORDER = [(0, False)]
LIMIT = 100


def answer(db, p):
    ss = "store_sales"
    ok = (is_ok(db, "time_dim", "t_time_sk",
                (db.col("time_dim", "t_hour") == int(p["hour"]))
                & (db.col("time_dim", "t_minute") >= 30),
                db.col(ss, "ss_sold_time_sk"))
          & is_ok(db, "household_demographics", "hd_demo_sk",
                  db.col("household_demographics", "hd_dep_count")
                  == int(p["depcnt"]),
                  db.col(ss, "ss_hdemo_sk"))
          & is_ok(db, "store", "s_store_sk",
                  db.where("store", "s_store_name", lambda s: s == "ese"),
                  db.col(ss, "ss_store_sk")))
    return [(int(ok.sum()),)]
