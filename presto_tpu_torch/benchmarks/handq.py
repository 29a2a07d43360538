"""Hand-built TPC-H physical plans.

Analog of the reference's hand-constructed operator-tree benchmarks
(testing/trino-benchmark/src/main/java/io/trino/benchmark/HandTpchQuery1.java,
HandTpchQuery6.java:50): the flagship kernels expressed directly as plan
nodes, without going through the SQL frontend. The port's copy of
``presto_tpu/benchmarks/handq.py``; the plans run through
``exec/executor.execute_plan`` like any other plan.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.aggmeta import AggCall
from presto_tpu_torch.plan import nodes as N

DEC2 = T.DecimalType(12, 2)
DEC4 = T.DecimalType(18, 4)
DEC6 = T.DecimalType(18, 6)
SUM2 = T.DecimalType(18, 2)


def _days(s: str) -> int:
    return int((np.datetime64(s) - np.datetime64("1970-01-01")).astype(int))


def _scan(table, cols, types, catalog="tpch"):
    return N.TableScan(catalog, table, {c: c for c in cols},
                       dict(zip(cols, types)))


def _ref(name, t):
    return ir.ColumnRef(t, name)


def q1_plan(catalog: str = "tpch") -> N.PlanNode:
    """TPC-H Q1: pricing summary report (scan+filter+project+group-agg+sort)."""
    scan = _scan(
        "lineitem",
        ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
         "l_discount", "l_tax", "l_shipdate"],
        [T.VARCHAR, T.VARCHAR, DEC2, DEC2, DEC2, DEC2, T.DATE], catalog)
    pred = ir.Call(T.BOOLEAN, "lte", (
        _ref("l_shipdate", T.DATE), ir.Literal(T.DATE, _days("1998-09-02"))))
    filt = N.Filter(scan, pred)

    one_minus_disc = ir.Call(DEC2, "subtract", (
        ir.Literal(DEC2, 100), _ref("l_discount", DEC2)))
    disc_price = ir.Call(DEC4, "multiply", (
        _ref("l_extendedprice", DEC2), one_minus_disc))
    one_plus_tax = ir.Call(DEC2, "add", (
        ir.Literal(DEC2, 100), _ref("l_tax", DEC2)))
    charge = ir.Call(DEC6, "multiply", (disc_price, one_plus_tax))
    proj = N.Project(filt, {
        "l_returnflag": _ref("l_returnflag", T.VARCHAR),
        "l_linestatus": _ref("l_linestatus", T.VARCHAR),
        "l_quantity": _ref("l_quantity", DEC2),
        "l_extendedprice": _ref("l_extendedprice", DEC2),
        "l_discount": _ref("l_discount", DEC2),
        "disc_price": disc_price,
        "charge": charge,
    })
    agg = N.Aggregate(proj, ["l_returnflag", "l_linestatus"], {
        "sum_qty": AggCall("sum", _ref("l_quantity", DEC2), SUM2),
        "sum_base_price": AggCall("sum", _ref("l_extendedprice", DEC2), SUM2),
        "sum_disc_price": AggCall("sum", _ref("disc_price", DEC4), DEC4),
        "sum_charge": AggCall("sum", _ref("charge", DEC6), DEC6),
        "avg_qty": AggCall("avg", _ref("l_quantity", DEC2), T.DOUBLE),
        "avg_price": AggCall("avg", _ref("l_extendedprice", DEC2), T.DOUBLE),
        "avg_disc": AggCall("avg", _ref("l_discount", DEC2), T.DOUBLE),
        "count_order": AggCall("count_star", None, T.BIGINT),
    })
    sort = N.Sort(agg, [N.Ordering("l_returnflag"),
                        N.Ordering("l_linestatus")])
    names = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
             "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
             "avg_disc", "count_order"]
    return N.Output(sort, names, names)


Q1_SQL_SQLITE = (
    "SELECT l_returnflag, l_linestatus, sum(l_quantity), "
    "sum(l_extendedprice), sum(l_extendedprice * (1 - l_discount)), "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*) "
    "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus "
    "ORDER BY l_returnflag, l_linestatus")


def q6_plan(catalog: str = "tpch") -> N.PlanNode:
    """TPC-H Q6: forecasting revenue change (scan+filter+global agg)."""
    scan = _scan("lineitem",
                 ["l_extendedprice", "l_discount", "l_quantity", "l_shipdate"],
                 [DEC2, DEC2, DEC2, T.DATE], catalog)
    pred = ir.Call(T.BOOLEAN, "and", (
        ir.Call(T.BOOLEAN, "gte", (_ref("l_shipdate", T.DATE),
                                   ir.Literal(T.DATE, _days("1994-01-01")))),
        ir.Call(T.BOOLEAN, "lt", (_ref("l_shipdate", T.DATE),
                                  ir.Literal(T.DATE, _days("1995-01-01")))),
        ir.Call(T.BOOLEAN, "gte", (_ref("l_discount", DEC2),
                                   ir.Literal(DEC2, 5))),
        ir.Call(T.BOOLEAN, "lte", (_ref("l_discount", DEC2),
                                   ir.Literal(DEC2, 7))),
        ir.Call(T.BOOLEAN, "lt", (_ref("l_quantity", DEC2),
                                  ir.Literal(DEC2, 2400))),
    ))
    filt = N.Filter(scan, pred)
    proj = N.Project(filt, {"revenue_in": ir.Call(
        DEC4, "multiply", (_ref("l_extendedprice", DEC2),
                           _ref("l_discount", DEC2)))})
    agg = N.Aggregate(proj, [], {
        "revenue": AggCall("sum", _ref("revenue_in", DEC4), DEC4)})
    return N.Output(agg, ["revenue"], ["revenue"])
