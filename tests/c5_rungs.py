"""The capacity rungs of C5, the poisoned-ledger chaos run of
tests/test_adaptive.py, over either package on the CPU.

    python -m tests.c5_rungs presto_tpu|presto_tpu_torch SCALE WORKERS

A coordinator and WORKERS in-process workers over TPC-H at SCALE, in
TASK mode, with chip_smoke.py's broadcast threshold (the customers
over 150, at least 64). The ledger claims customer's segment filter
keeps 1/1500 of its rows; the query then runs static and adaptive.
Prints the join's rows and, for each run, the capacity-overflow rungs
(in all and by operator), its seconds and whether its rows equal one
engine's. Not a test: at SF1 it takes a minute and about 5 GB.
"""

from __future__ import annotations

import importlib
import resource
import shutil
import sys
import tempfile
import time

SQL = ("select s_nationkey, count(*) as c from supplier, customer "
       "where s_nationkey = c_nationkey and c_mktsegment = 'BUILDING' "
       "group by s_nationkey order by s_nationkey")
POISON_KEY = ("tpch.customer", "eq(c_mktsegment, ?)")


def main(pkg: str, scale: float, nworkers: int) -> dict:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    engine_cls = importlib.import_module(pkg).Engine
    qstats = mod("obs.qstats")
    rungs = mod("obs.metrics").REGISTRY.counter(
        "presto_tpu_capacity_overflow_retries_total")
    kw = {"device": "cpu"} if pkg == "presto_tpu_torch" else {}
    conn = mod("connectors.tpch").TpchConnector(scale=scale)
    spool = tempfile.mkdtemp()
    workers, coord = [], None
    try:
        workers = [mod("parallel.worker").WorkerServer(
            {"tpch": conn}, node_id=f"w{i}", spool_dir=spool,
            **kw).start() for i in range(nworkers)]
        local = engine_cls(**kw)
        local.register_catalog("tpch", conn)
        local.session.catalog = "tpch"
        local.session.set("retry_policy", "TASK")
        threshold = max(64, int(conn.table("customer").nrows) // 150)
        local.session.set("broadcast_join_threshold_rows", threshold)
        coord = mod("parallel.coordinator").ClusterCoordinator(
            local, heartbeat_interval_s=0.5).start()
        for w in workers:
            coord.add_worker(w.uri)
        want = local.execute(SQL)
        out = {"package": pkg, "scale": scale, "workers": nworkers,
               "threshold": threshold,
               "join_rows": sum(int(c) for _k, c in want)}
        for adaptive in (False, True):
            with qstats.DIVERGENCE._lock:
                qstats.DIVERGENCE._selectivity.pop(POISON_KEY, None)
            for _ in range(400):
                qstats.DIVERGENCE.observe_selectivity(*POISON_KEY, 1500,
                                                      1)
            local.session.set("adaptive_replanning", adaptive)
            ops = ("out", "table", "group")
            total0 = rungs.total()
            by0 = {k: rungs.value(operator=k) for k in ops}
            t0 = time.perf_counter()
            got = coord.execute(SQL)
            out["adaptive" if adaptive else "static"] = {
                "rungs": rungs.total() - total0,
                "by_operator": {k: rungs.value(operator=k) - by0[k]
                                for k in ops},
                "seconds": time.perf_counter() - t0,
                "rows_equal": got == want}
        out["max_rss_gb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6
        return out
    finally:
        if coord is not None:
            coord.stop()
        for w in workers:
            w.stop()
        shutil.rmtree(spool, ignore_errors=True)


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] not in ("presto_tpu",
                                                 "presto_tpu_torch"):
        sys.exit(__doc__)
    print(main(sys.argv[1], float(sys.argv[2]), int(sys.argv[3])))
