"""Plan-wide statistics propagation.

The analog of the reference's cost/StatsCalculator.java +
ComposableStatsCalculator rule table: a per-PlanNode dispatch table
(``StatsCalculator._s_<node>``) propagates
:class:`PlanNodeStatsEstimate` — row count, per-symbol NDV / value
range / null fraction, and output bytes — bottom-up through the whole
tree, seeded from the connector ``TableStats`` SPI
(connectors/base.py row_count_estimate / ndv_estimates /
column_range_estimates).

This generalizes the leaf-only selectivity slice in ``plan/stats.py``
(which stays the shared FilterStatsCalculator) into join, aggregation,
semi-join, union and limit estimation rules, so the ReorderJoins
optimizer (cost/reorder.py) and the CostCalculator (cost/model.py)
price whole subtrees instead of single scans.

Estimates are intentionally COARSE: everything written back into plan
nodes by consumers is power-of-two-bucketed (ops/hash.next_pow2), so
similar inputs keep compiling identical programs and the
compiled-program cache (exec/executor.py) keeps hitting.

A copy of the reference's module; its plan-dispatch lint rule does
not cover the port yet (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
import math
import re

from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.stats import (UNKNOWN_FILTER_COEFFICIENT,
                                   selectivity, selectivity_informed)

_SYM_SUFFIX = re.compile(r"_\d+$")


def base_symbol(sym: str) -> str:
    """Strip the planner's per-statement ``_NN`` suffix so observation
    keys ("n_name") pool across statements that allocate different
    symbol numbers for the same base column (the divergence ledger and
    this calculator must agree on the spelling). Strips exactly ONE
    trailing suffix: every symbol the planner allocates carries one,
    so a base column itself named with a digit suffix ("address_1" ->
    symbol "address_1_17") round-trips correctly."""
    return _SYM_SUFFIX.sub("", sym)


def predicate_shape(expr) -> str:
    """Literal-normalized structural shape of a predicate expression
    ("lte(l_shipdate, ?)"): the key the divergence ledger
    (obs/qstats.py) aggregates observed selectivity under, so every
    literal variant of one predicate shape — the plan-template notion
    of sameness — pools into a single observation series. The
    ``_s_filter`` rule below consults it (ROADMAP item 4's feedback
    loop: observed selectivity outranks the static guess)."""
    from presto_tpu_torch.expr import ir

    def walk(e) -> str:
        if isinstance(e, (ir.Literal, ir.Parameter)):
            return "?"
        if isinstance(e, ir.ColumnRef):
            # planner symbol suffixes are per-statement; the base
            # column name pools one predicate shape across statements
            return base_symbol(e.name)
        if isinstance(e, ir.Call):
            return (f"{e.fn}("
                    + ", ".join(walk(a) for a in e.args) + ")")
        if isinstance(e, ir.Cast):
            return f"cast({walk(e.arg)} as {e.dtype})"
        if isinstance(e, ir.InList):
            return f"{walk(e.arg)} in (?*{len(e.values)})"
        if isinstance(e, ir.IsNull):
            return f"{walk(e.arg)} is " \
                   f"{'not ' if e.negated else ''}null"
        return type(e).__name__.lower()

    return walk(expr)


# row count assumed for a relation with no usable connector statistics
# (exchange carrier scans, unknown catalogs); estimates derived from it
# are flagged non-confident
UNKNOWN_ROWS = 1000.0
# fallback per-symbol NDV when a join/group key has no statistics
# (the planner's _order_joins uses the same default)
DEFAULT_NDV = 32.0
# assumed elements per array for Unnest expansion
UNNEST_FACTOR = 8.0


@dataclasses.dataclass(frozen=True)
class SymbolStats:
    """Per-symbol statistics (reference cost/SymbolStatsEstimate.java):
    distinct-value estimate, physical-value range, null fraction.
    ``None`` means unknown."""

    ndv: float | None = None
    low: float | None = None
    high: float | None = None
    null_fraction: float = 0.0

    def capped(self, rows: float) -> "SymbolStats":
        if self.ndv is None or self.ndv <= rows:
            return self
        return dataclasses.replace(self, ndv=max(rows, 1.0))


@dataclasses.dataclass
class PlanNodeStatsEstimate:
    """Output estimate of one plan node (reference
    cost/PlanNodeStatsEstimate.java). ``confident`` is False once any
    contributing rule fell back to an unknown-stats default.
    ``selectivity`` is the cumulative filter fraction applied to this
    relation since its base scans — the containment input for
    unique-build joins (a filtered PK side keeps only this fraction of
    FK probe rows; the planner's RelationPlan.sel, cost/JoinStatsRule
    analog), which sidesteps the per-criterion independence error on
    composite keys."""

    row_count: float
    symbols: dict[str, SymbolStats] = dataclasses.field(
        default_factory=dict)
    confident: bool = True
    selectivity: float = 1.0

    def symbol(self, name: str) -> SymbolStats:
        return self.symbols.get(name, SymbolStats())

    def output_bytes(self, types) -> float:
        """Estimated output size: row count x sum of physical column
        widths (dictionary-encoded varchar counts its code width, the
        HBM-resident form)."""
        width = 0
        for t in types.values():
            try:
                width += t.physical_dtype().itemsize
            except Exception:
                width += 8
        return self.row_count * max(width, 1)


def _ndv_dicts(est: PlanNodeStatsEstimate):
    """(ndv, ranges) dicts in the plan/stats.selectivity format."""
    ndv = {s: int(st.ndv) for s, st in est.symbols.items()
           if st.ndv is not None and st.ndv >= 1}
    ranges = {s: (st.low, st.high) for s, st in est.symbols.items()
              if st.low is not None and st.high is not None}
    return ndv, ranges


class StatsCalculator:
    """Bottom-up stats propagation over a logical plan. One instance
    memoizes per node object, so repeated subtree queries (DP join
    enumeration) stay cheap."""

    def __init__(self, engine):
        self.engine = engine
        session = getattr(engine, "session", None)
        try:
            self.worst_case_ratio = float(
                session.get("cost_estimation_worst_case_ratio"))
        except Exception:
            self.worst_case_ratio = 8.0
        # id(node) -> (node ref pinning the id, estimate)
        self._memo: dict[int, tuple] = {}

    def stats(self, node: N.PlanNode) -> PlanNodeStatsEstimate:
        hit = self._memo.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        rule = getattr(self, "_s_" + type(node).__name__.lower(),
                       self._unknown)
        est = rule(node)
        # a symbol can never have more distinct values than rows
        est.symbols = {s: st.capped(est.row_count)
                       for s, st in est.symbols.items()}
        self._memo[id(node)] = (node, est)
        return est

    def _unknown(self, node: N.PlanNode) -> PlanNodeStatsEstimate:
        srcs = node.sources()
        if srcs:
            inner = self.stats(srcs[0])
            return PlanNodeStatsEstimate(inner.row_count,
                                         dict(inner.symbols), False)
        return PlanNodeStatsEstimate(UNKNOWN_ROWS, {}, False)

    # -- observed-statistics feedback (the divergence ledger) ----------------
    #
    # Stability contract: estimates flow into pow2-bucketed plan
    # annotations (capacities, build_rows, skew decisions) that key the
    # compiled-program/template caches, so feedback must not wobble
    # them. An observation is admitted only when the static estimate is
    # MATERIALLY wrong (>= FEEDBACK_BAND off — the divergence class the
    # ledger exists to catch), and the admitted value is pow2-quantized
    # so nearby observations of one shape produce identical plans. A
    # corrected shape costs exactly one recompile, then every literal
    # variant keeps hitting.

    FEEDBACK_BAND = 4.0

    @classmethod
    def _material(cls, static: float, observed: float) -> bool:
        hi = max(static, observed)
        lo = max(min(static, observed), 1e-30)
        return hi / lo >= cls.FEEDBACK_BAND

    @staticmethod
    def _quant(value: float) -> float:
        """pow2 quantization for counts (>= 1) and fractions alike."""
        if value <= 0:
            return 1.0
        return float(2.0 ** round(math.log2(value)))

    @staticmethod
    def _ledger():
        """The divergence ledger (observed selectivity and NDV). The
        port has no query-stats module yet, so the ledger is always
        empty and every estimate is the static rule's."""
        return _EMPTY_LEDGER

    @staticmethod
    def _scan_table(node: N.PlanNode) -> str | None:
        """catalog.table of the single base scan under ``node``
        (through Filters/Projects), or None."""
        cur = node
        while True:
            if isinstance(cur, N.TableScan):
                return (None if str(cur.catalog).startswith("__")
                        else f"{cur.catalog}.{cur.table}")
            if not isinstance(cur, (N.Filter, N.Project)):
                return None
            cur = cur.source

    # -- leaves -------------------------------------------------------------

    def _s_tablescan(self, node: N.TableScan) -> PlanNodeStatsEstimate:
        conn = getattr(self.engine, "catalogs", {}).get(node.catalog)
        if conn is None:
            return PlanNodeStatsEstimate(UNKNOWN_ROWS, {}, False)
        try:
            rows = float(conn.row_count_estimate(node.table))
            ndv = conn.ndv_estimates(node.table)
            ranges = conn.column_range_estimates(node.table)
        except Exception:
            # decorated/pushed-down table names a connector does not
            # recognize for stats, or connectors without the SPI
            return PlanNodeStatsEstimate(UNKNOWN_ROWS, {}, False)
        symbols = {}
        ledger = self._ledger()
        tname = f"{node.catalog}.{node.table}"
        for sym, col in node.assignments.items():
            rng = ranges.get(col)
            nd = float(ndv[col]) if col in ndv else None
            # observed-NDV feedback: a real single-key distinct count
            # recorded by the divergence ledger replaces a missing or
            # materially wrong connector guess (ROADMAP item 4
            # seeding; quantized — see the stability contract above)
            seen = ledger.observed_ndv(tname, (col,))
            if seen and (nd is None or self._material(nd, seen)):
                nd = self._quant(float(seen))
            symbols[sym] = SymbolStats(
                ndv=nd,
                low=float(rng[0]) if rng else None,
                high=float(rng[1]) if rng else None)
        return PlanNodeStatsEstimate(max(rows, 1.0), symbols)

    def _s_values(self, node: N.Values) -> PlanNodeStatsEstimate:
        symbols = {}
        for i, sym in enumerate(node.symbols):
            vals = [row[i] for row in node.rows if row[i] is not None]
            nums = [v for v in vals if isinstance(v, (int, float))
                    and not isinstance(v, bool)]
            symbols[sym] = SymbolStats(
                ndv=float(len(set(map(repr, vals)))) or 1.0,
                low=float(min(nums)) if nums else None,
                high=float(max(nums)) if nums else None,
                null_fraction=(1.0 - len(vals) / len(node.rows))
                if node.rows else 0.0)
        return PlanNodeStatsEstimate(float(len(node.rows)) or 1.0,
                                     symbols)

    # -- row-preserving operators -------------------------------------------

    def _s_filter(self, node: N.Filter) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        ndv, ranges = _ndv_dicts(src)
        sel = selectivity(node.predicate, ndv, ranges)
        # observed-selectivity feedback: the ledger's average for this
        # (table, predicate shape) — literal variants pool — replaces
        # a MATERIALLY wrong static guess once a real execution has
        # been measured (quantized; see the stability contract above).
        # Only for predicates the static rule could NOT inform from
        # real statistics: the pooled mean is literal-blind, and a
        # value-aware range interpolation legitimately disagrees with
        # it on selective literals
        table = self._scan_table(node.source)
        if table is not None and not selectivity_informed(
                node.predicate, ndv, ranges):
            seen = self._ledger().observed_selectivity(
                table, predicate_shape(node.predicate))
            if seen is not None and self._material(sel, seen):
                # floor BEFORE quantizing: _quant(0) means "1" for
                # counts, but an observed empty filter must estimate
                # near-zero, not pass-everything
                sel = max(min(self._quant(max(seen, 1e-9)), 1.0),
                          1e-9)
        rows = max(src.row_count * sel, 1.0)
        return PlanNodeStatsEstimate(rows, dict(src.symbols),
                                     src.confident,
                                     src.selectivity * sel)

    def _s_project(self, node: N.Project) -> PlanNodeStatsEstimate:
        from presto_tpu_torch.expr import ir
        src = self.stats(node.source)
        symbols = {}
        for sym, expr in node.assignments.items():
            if isinstance(expr, ir.ColumnRef):
                symbols[sym] = src.symbol(expr.name)
            else:
                symbols[sym] = SymbolStats()
        return PlanNodeStatsEstimate(src.row_count, symbols,
                                     src.confident, src.selectivity)

    def _s_sort(self, node: N.Sort) -> PlanNodeStatsEstimate:
        return self.stats(node.source)

    def _s_exchange(self, node: N.Exchange) -> PlanNodeStatsEstimate:
        return self.stats(node.source)

    def _s_output(self, node: N.Output) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        return PlanNodeStatsEstimate(
            src.row_count,
            {s: src.symbol(s) for s in node.symbols}, src.confident)

    def _s_window(self, node: N.Window) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        symbols = dict(src.symbols)
        for sym in node.functions:
            symbols[sym] = SymbolStats()
        return PlanNodeStatsEstimate(src.row_count, symbols,
                                     src.confident, src.selectivity)

    def _s_markdistinct(self, node: N.MarkDistinct
                        ) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        symbols = dict(src.symbols)
        symbols[node.mark_symbol] = SymbolStats(ndv=2.0)
        return PlanNodeStatsEstimate(src.row_count, symbols,
                                     src.confident, src.selectivity)

    # -- cardinality-changing operators -------------------------------------

    def _s_limit(self, node: N.Limit) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        rows = min(src.row_count, float(node.count))
        return PlanNodeStatsEstimate(max(rows, 1.0), dict(src.symbols),
                                     src.confident)

    def _s_topn(self, node: N.TopN) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        rows = min(src.row_count, float(node.count))
        return PlanNodeStatsEstimate(max(rows, 1.0), dict(src.symbols),
                                     src.confident)

    def _group_rows(self, src: PlanNodeStatsEstimate,
                    keys) -> tuple[float, bool]:
        """Distinct-tuple estimate over ``keys`` (product of per-key
        NDVs, capped at input rows — reference
        AggregationStatsRule.groupBy)."""
        if not keys:
            return 1.0, True
        prod = 1.0
        confident = src.confident
        for k in keys:
            nd = src.symbol(k).ndv
            if nd is None:
                nd = DEFAULT_NDV
                confident = False
            prod = min(prod * max(nd, 1.0), 1e18)
        return max(min(prod, src.row_count), 1.0), confident

    @staticmethod
    def _subtree_single_table(node: N.PlanNode) -> str | None:
        """The one base table under ``node``, or None when the subtree
        scans several — the ledger's OWN recording-side walk, so the
        record and consult keys cannot drift apart."""
        tables: set[str] = set()

        def visit(n):
            if isinstance(n, N.TableScan) \
                    and not str(n.catalog).startswith("__"):
                tables.add(f"{n.catalog}.{n.table}")
            for s in n.sources():
                visit(s)

        visit(node)
        return tables.pop() if len(tables) == 1 else None

    def _s_aggregate(self, node: N.Aggregate) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        rows, confident = self._group_rows(src, node.group_keys)
        if node.group_keys:
            table = self._subtree_single_table(node)
            if table is not None:
                seen = self._ledger().observed_ndv(
                    table,
                    tuple(base_symbol(k) for k in node.group_keys))
                if seen and self._material(rows, seen):
                    # the observation covers the UNFILTERED table; a
                    # filtered source still bounds the group count
                    # (the static rule's min(prod, rows) invariant)
                    rows = min(self._quant(float(seen)),
                               max(src.row_count, 1.0))
                    confident = True
        symbols = {k: src.symbol(k) for k in node.group_keys}
        for sym in node.output_symbols:
            if sym not in symbols:
                symbols[sym] = SymbolStats()
        return PlanNodeStatsEstimate(rows, symbols, confident)

    def _s_distinct(self, node: N.Distinct) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        rows, confident = self._group_rows(
            src, list(node.source.output_types()))
        return PlanNodeStatsEstimate(rows, dict(src.symbols), confident)

    def _s_union(self, node: N.Union) -> PlanNodeStatsEstimate:
        rows = 0.0
        confident = True
        symbols = {s: SymbolStats() for s in node.symbols}
        ndv_sum: dict[str, float] = {}
        for inp, mapping in zip(node.inputs, node.mappings):
            sub = self.stats(inp)
            rows += sub.row_count
            confident = confident and sub.confident
            for out_sym, in_sym in mapping.items():
                st = sub.symbol(in_sym)
                if st.ndv is not None:
                    ndv_sum[out_sym] = ndv_sum.get(out_sym, 0.0) + st.ndv
        for sym, nd in ndv_sum.items():
            symbols[sym] = SymbolStats(ndv=nd)
        return PlanNodeStatsEstimate(max(rows, 1.0), symbols, confident)

    def _s_unnest(self, node: N.Unnest) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        symbols = dict(src.symbols)
        for sym in node.out_syms:
            symbols[sym] = SymbolStats()
        if node.ordinality_sym:
            symbols[node.ordinality_sym] = SymbolStats(low=1.0)
        return PlanNodeStatsEstimate(src.row_count * UNNEST_FACTOR,
                                     symbols, False)

    def _s_matchrecognize(self, node: N.MatchRecognize
                          ) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        rows, _ = self._group_rows(src, node.partition_by)
        symbols = {s: src.symbol(s) for s in node.partition_by}
        for sym, _k, _e, _t in node.measures:
            symbols[sym] = SymbolStats()
        return PlanNodeStatsEstimate(rows, symbols, False)

    # -- joins ---------------------------------------------------------------

    def equi_join_rows(self, probe: PlanNodeStatsEstimate,
                       build: PlanNodeStatsEstimate,
                       criteria, build_unique: bool
                       ) -> tuple[float, bool]:
        """Inner equi-join output estimate: per-criterion selectivity
        1/max(ndv_probe, ndv_build) over the row-count product
        (reference cost/JoinStatsRule.java), with the unique-build
        containment shortcut and a worst-case cap when key statistics
        are missing (session cost_estimation_worst_case_ratio)."""
        confident = probe.confident and build.confident
        if build_unique:
            # FK->PK containment: a filtered PK side keeps its
            # cumulative filter fraction of probe rows (the planner's
            # RelationPlan.sel rule, plan-wide). The per-criterion NDV
            # quotient would undercount composite keys whose columns
            # correlate (lineitem x partsupp on (partkey, suppkey)).
            return (max(probe.row_count * min(build.selectivity, 1.0),
                        1.0), confident)
        sel = 1.0
        for pk, bk in criteria:
            np_ = probe.symbol(pk).ndv
            nb = build.symbol(bk).ndv
            if np_ is None and nb is None:
                np_ = nb = DEFAULT_NDV
            if np_ is None or nb is None:
                # one-sided unknown: the quotient leans on a single
                # side's NDV — keep the estimate but let the worst-case
                # cap below bound the damage
                confident = False
            sel /= max(np_ or 1.0, nb or 1.0, 1.0)
        rows = probe.row_count * build.row_count * sel
        if not confident:
            rows = min(rows, self.worst_case_ratio
                       * max(probe.row_count, build.row_count))
        return max(rows, 1.0), confident

    def _s_join(self, node: N.Join) -> PlanNodeStatsEstimate:
        probe = self.stats(node.left)
        build = self.stats(node.right)
        rows, confident = self.equi_join_rows(
            probe, build, node.criteria, node.build_unique)
        if node.filter is not None:
            rows = max(rows * UNKNOWN_FILTER_COEFFICIENT, 1.0)
        if node.join_type == N.JoinType.LEFT:
            rows = max(rows, probe.row_count)
        elif node.join_type == N.JoinType.RIGHT:
            rows = max(rows, build.row_count)
        elif node.join_type == N.JoinType.FULL:
            rows = max(rows, probe.row_count + build.row_count)
        symbols = {**probe.symbols, **build.symbols}
        return PlanNodeStatsEstimate(
            rows, symbols, confident,
            probe.selectivity * build.selectivity)

    def _s_multijoin(self, node: N.MultiJoin) -> PlanNodeStatsEstimate:
        """Fused star chain: fold the unique-build containment rule
        over the spine, build by build — identical math to the cascade
        of binary joins it replaced, so collapsing cannot change the
        estimates the rest of the plan is costed on."""
        cur = self.stats(node.spine)
        rows, confident = cur.row_count, cur.confident
        symbols = dict(cur.symbols)
        sel = cur.selectivity
        for build, crit in zip(node.builds, node.criteria):
            b = self.stats(build)
            step = PlanNodeStatsEstimate(rows, symbols, confident, sel)
            rows, confident = self.equi_join_rows(
                step, b, crit, build_unique=True)
            symbols = {**symbols, **b.symbols}
            sel = sel * b.selectivity
        return PlanNodeStatsEstimate(max(rows, 1.0), symbols,
                                     confident, sel)

    def _s_semijoin(self, node: N.SemiJoin) -> PlanNodeStatsEstimate:
        src = self.stats(node.source)
        self.stats(node.filter_source)  # priced by the cost model
        symbols = dict(src.symbols)
        symbols[node.output] = SymbolStats(ndv=2.0)
        # the semi-join only ADDS the membership mark; the Filter above
        # consuming it is estimated by the filter rule
        return PlanNodeStatsEstimate(src.row_count, symbols,
                                     src.confident, src.selectivity)

    def _s_crossjoin(self, node: N.CrossJoin) -> PlanNodeStatsEstimate:
        left = self.stats(node.left)
        right = self.stats(node.right)
        rows = (left.row_count if node.scalar
                else left.row_count * right.row_count)
        return PlanNodeStatsEstimate(
            max(rows, 1.0), {**left.symbols, **right.symbols},
            left.confident and right.confident)


class _EmptyLedger:
    """Stand-in for the reference's divergence ledger: no observations."""

    def observed_selectivity(self, table: str, shape: str):
        return None

    def observed_ndv(self, table: str, keys: tuple):
        return None


_EMPTY_LEDGER = _EmptyLedger()
