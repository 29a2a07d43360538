"""Logical plan nodes.

The subset of the reference's 53 plan node types
(sql/planner/plan/*.java) that TPC-H/TPC-DS execution needs, carrying
symbol-based schemas: every node outputs named symbols; expressions
reference symbols via ColumnRef.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.aggmeta import AggCall

# field metadata key: the wire dict (plan/serde.py) and the plan
# fingerprint (plan/fingerprint.py) leave such a field out while it
# holds its default
OMIT_DEFAULT = "omit_default"


def omitted(node, f: dataclasses.Field) -> bool:
    """Is field ``f`` of ``node`` marked OMIT_DEFAULT and at its
    default?"""
    return bool(f.metadata.get(OMIT_DEFAULT)) and \
        getattr(node, f.name) == f.default


@dataclasses.dataclass
class PlanNode:
    def sources(self) -> list["PlanNode"]:
        return []

    @property
    def output_symbols(self) -> list[str]:
        raise NotImplementedError

    def output_types(self) -> dict[str, T.DataType]:
        raise NotImplementedError


@dataclasses.dataclass
class TableScan(PlanNode):
    """Scan of catalog.table; assignments maps output symbol -> source
    column name (reference plan/TableScanNode.java)."""

    catalog: str
    table: str
    assignments: dict[str, str]
    types: dict[str, T.DataType]

    @property
    def output_symbols(self):
        return list(self.assignments)

    def output_types(self):
        return dict(self.types)


@dataclasses.dataclass
class Values(PlanNode):
    """Inline rows (plan/ValuesNode.java)."""

    symbols: list[str]
    types: dict[str, T.DataType]
    rows: list[list[object]]

    @property
    def output_symbols(self):
        return list(self.symbols)

    def output_types(self):
        return dict(self.types)


@dataclasses.dataclass
class Filter(PlanNode):
    source: PlanNode = None  # type: ignore[assignment]
    predicate: ir.Expr = None  # type: ignore[assignment]

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class Project(PlanNode):
    source: PlanNode = None  # type: ignore[assignment]
    assignments: dict[str, ir.Expr] = dataclasses.field(default_factory=dict)

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return list(self.assignments)

    def output_types(self):
        return {s: e.dtype for s, e in self.assignments.items()}


class AggStep(enum.Enum):
    SINGLE = "single"
    PARTIAL = "partial"
    FINAL = "final"


@dataclasses.dataclass
class Aggregate(PlanNode):
    """Group-by aggregation (plan/AggregationNode.java). ``aggs`` maps
    output symbol -> AggCall. PARTIAL outputs state columns named
    ``{symbol}$state_field``; FINAL consumes them."""

    source: PlanNode = None  # type: ignore[assignment]
    group_keys: list[str] = dataclasses.field(default_factory=list)
    aggs: dict[str, AggCall] = dataclasses.field(default_factory=dict)
    step: AggStep = AggStep.SINGLE
    # planner hash-table capacity hint (None = executor default); the
    # executor doubles + recompiles on kernel-reported overflow
    capacity: int | None = None
    # functional-dependency-reduced key subset (plan/dense.py): these
    # keys alone determine every group key (e.g. Q3's l_orderkey
    # determines o_orderdate/o_shippriority through the unique join),
    # so group identity hashes/sorts only them — the rest ride as
    # plain payloads (reference analog: ReplaceRedundantJoinWithSource
    # -class optimizations; Trino v360 lacks this one)
    fd_keys: list[str] | None = None

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        from presto_tpu_torch.expr import aggmeta as A
        out = list(self.group_keys)
        if self.step == AggStep.PARTIAL:
            for s, call in self.aggs.items():
                out += [f"{s}${f}" for f in A.state_fields(call)]
        else:
            out += list(self.aggs)
        return out

    def output_types(self):
        from presto_tpu_torch.expr import aggmeta as A
        src = self.source.output_types()
        out = {k: src[k] for k in self.group_keys}
        for s, call in self.aggs.items():
            if self.step == AggStep.PARTIAL:
                for f in A.state_fields(call):
                    out[f"{s}${f}"] = A.state_type(call, f)
            else:
                out[s] = call.dtype
        return out


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    CROSS = "cross"


@dataclasses.dataclass
class Join(PlanNode):
    """Hash equi-join (plan/JoinNode.java). left = probe, right = build.
    ``criteria`` is a list of (left_symbol, right_symbol) equalities;
    ``filter`` an optional residual non-equi condition."""

    left: PlanNode = None  # type: ignore[assignment]
    right: PlanNode = None  # type: ignore[assignment]
    join_type: JoinType = JoinType.INNER
    criteria: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    filter: Optional[ir.Expr] = None
    # planner hint: probe-side rows match at most one build row (FK->PK,
    # criteria cover a unique key of the build side)
    build_unique: bool = True
    # automatic | broadcast | partitioned | hybrid ("hybrid" = skew-
    # aware: build rows of runtime-detected heavy-hitter keys broadcast
    # while the cold tail hash-partitions; cost/skew.py decides)
    distribution: str = "automatic"
    # planner cardinality estimate of the build side (drives the
    # broadcast-vs-partitioned choice, reference
    # DetermineJoinDistributionType)
    build_rows: int | None = None
    # skew annotations (cost/skew.py, pow2-bucketed so the compiled-
    # program cache keeps hitting across literal variants): estimated
    # heavy-hitter key count sizing the hybrid hot-build table, and the
    # salt fan-out applied to partitioned exchanges of this join
    # (1/None = unsalted)
    hot_keys: int | None = None
    salt_factor: int | None = None
    capacity: int | None = None
    # static output-row capacity for the expanding (many-to-many) path
    output_capacity: int | None = None
    # dense-int build key hint (criterion index, lo, hi) from
    # plan/dense.py: build rows scatter into a (hi-lo+1)-slot
    # direct-address table; probes become one gather (no sort, no hash)
    dense_key: tuple[int, int, int] | None = None
    # output_capacity was re-costed by cost/adapt.revise_join over
    # inputs of known size (observed carriers, tables, no expanding
    # join below): the interpreter takes it as it is, where it cuts a
    # static hint at the first rung. Left out of the wire dict and the
    # fingerprint while False (OMIT_DEFAULT), so a static plan's dict
    # and fingerprint are the reference's
    output_observed: bool = dataclasses.field(
        default=False, repr=False, metadata={OMIT_DEFAULT: True})

    def sources(self):
        return [self.left, self.right]

    @property
    def output_symbols(self):
        return self.left.output_symbols + self.right.output_symbols

    def output_types(self):
        return {**self.left.output_types(), **self.right.output_types()}


@dataclasses.dataclass
class SemiJoin(PlanNode):
    """source rows tested for membership in filter_source keys
    (plan/SemiJoinNode.java, multi-key form for decorrelated EXISTS);
    adds boolean output symbol."""

    source: PlanNode = None  # type: ignore[assignment]
    filter_source: PlanNode = None  # type: ignore[assignment]
    source_keys: list[str] = dataclasses.field(default_factory=list)
    filter_keys: list[str] = dataclasses.field(default_factory=list)
    output: str = ""
    negated: bool = False  # NOT IN / NOT EXISTS handled at planner level
    # three-valued NOT IN semantics: the mark is NULL (not FALSE) when
    # the probed value is NULL or the subquery values contain a NULL
    # (reference SemiJoinNode null-aware semantics); applies to the
    # first key only (later keys are correlation equalities)
    null_aware: bool = False
    capacity: int | None = None
    # dense-int filter key hint (lo, hi) from plan/dense.py: the filter
    # side becomes a membership bitmap, the probe one gather
    dense_key: tuple[int, int] | None = None

    # single-key compatibility accessors
    @property
    def source_key(self) -> str:
        return self.source_keys[0]

    @property
    def filter_key(self) -> str:
        return self.filter_keys[0]

    def sources(self):
        return [self.source, self.filter_source]

    @property
    def output_symbols(self):
        return self.source.output_symbols + [self.output]

    def output_types(self):
        return {**self.source.output_types(), self.output: T.BOOLEAN}


@dataclasses.dataclass
class MultiJoin(PlanNode):
    """Fused multi-way INNER equi-join along one probe spine (the
    TrieJax-style treatment of a star-schema chain as ONE relational
    operator instead of cascaded binary hash joins). ``criteria[i]``
    lists (probe_symbol, build_symbol) equalities for ``builds[i]``,
    where a probe symbol may come from the spine or any EARLIER build
    (the collapse preserves chain order, so the sequential probe walk
    resolves them). All collapsed joins are INNER, unique-build
    (FK->PK) and residual-free by construction (plan/optimizer.py
    collapse_multiway), so execution is probe-preserving: one sorted
    lookup per build over the spine's static width, one fused live
    mask, no intermediate materialization. Distributed lowering keeps
    the spine sharded, replicates small builds, and co-partitions AT
    MOST ONE large build — one repartition of the fact table where the
    cascade paid one per large join."""

    spine: PlanNode = None  # type: ignore[assignment]
    builds: list[PlanNode] = dataclasses.field(default_factory=list)
    criteria: list[list[tuple[str, str]]] = dataclasses.field(
        default_factory=list)
    # per-build annotations carried over from the collapsed Join nodes
    # (pow2-bucketed build rows; broadcast|partitioned distribution)
    build_rows: list = dataclasses.field(default_factory=list)
    distributions: list = dataclasses.field(default_factory=list)

    def sources(self):
        return [self.spine] + list(self.builds)

    @property
    def output_symbols(self):
        out = list(self.spine.output_symbols)
        for b in self.builds:
            out += b.output_symbols
        return out

    def output_types(self):
        out = dict(self.spine.output_types())
        for b in self.builds:
            out.update(b.output_types())
        return out


@dataclasses.dataclass
class CrossJoin(PlanNode):
    """Cartesian product. The executor supports the scalar case (right
    side is a single-row relation, e.g. an uncorrelated scalar subquery —
    reference plan/JoinNode with empty criteria + EnforceSingleRowNode);
    the general case expands to left_n * right_n rows."""

    left: PlanNode = None  # type: ignore[assignment]
    right: PlanNode = None  # type: ignore[assignment]
    scalar: bool = True  # right side guaranteed single row
    # planner row-count estimates for the general (non-scalar) case: the
    # executor compacts each side to ~these before taking the static
    # product, with overflow retry (page-compaction analog)
    left_rows: int | None = None
    right_rows: int | None = None

    def sources(self):
        return [self.left, self.right]

    @property
    def output_symbols(self):
        return self.left.output_symbols + self.right.output_symbols

    def output_types(self):
        return {**self.left.output_types(), **self.right.output_types()}


@dataclasses.dataclass
class Union(PlanNode):
    """UNION ALL concatenation (plan/UnionNode.java). ``mappings`` maps
    each output symbol to the corresponding input symbol per source."""

    inputs: list[PlanNode] = dataclasses.field(default_factory=list)
    symbols: list[str] = dataclasses.field(default_factory=list)
    types: dict[str, T.DataType] = dataclasses.field(default_factory=dict)
    mappings: list[dict[str, str]] = dataclasses.field(default_factory=list)

    def sources(self):
        return list(self.inputs)

    @property
    def output_symbols(self):
        return list(self.symbols)

    def output_types(self):
        return dict(self.types)


@dataclasses.dataclass(frozen=True)
class Ordering:
    symbol: str
    ascending: bool = True
    nulls_first: bool | None = None  # None = Trino default (nulls last)


@dataclasses.dataclass
class Sort(PlanNode):
    source: PlanNode = None  # type: ignore[assignment]
    orderings: list[Ordering] = dataclasses.field(default_factory=list)

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class TopN(PlanNode):
    source: PlanNode = None  # type: ignore[assignment]
    count: int = 0
    orderings: list[Ordering] = dataclasses.field(default_factory=list)

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class Limit(PlanNode):
    source: PlanNode = None  # type: ignore[assignment]
    count: int = 0
    offset: int = 0

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class Distinct(PlanNode):
    """SELECT DISTINCT — group-by on all columns, no aggregates."""

    source: PlanNode = None  # type: ignore[assignment]
    capacity: int | None = None

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class MarkDistinct(PlanNode):
    """Adds a boolean column that is true on exactly one row per
    distinct key tuple — lets DISTINCT aggregates share one Aggregate
    with plain ones via per-call masks (reference MarkDistinctNode /
    operator/MarkDistinctOperator.java)."""

    source: PlanNode = None  # type: ignore[assignment]
    keys: list[str] = dataclasses.field(default_factory=list)
    mark_symbol: str = ""
    capacity: int | None = None

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return list(self.source.output_symbols) + [self.mark_symbol]

    def output_types(self):
        from presto_tpu_torch import types as T
        return {**self.source.output_types(),
                self.mark_symbol: T.BOOLEAN}


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """One planned window function: fn over (args) with the node's
    partition/order; frame semantics follow SQL defaults (RANGE UNBOUNDED
    PRECEDING..CURRENT ROW with ORDER BY, full partition without)."""

    fn: str  # rank|dense_rank|row_number|ntile|percent_rank|cume_dist|
    #          lag|lead|first_value|last_value|nth_value|
    #          sum|count|avg|min|max
    args: tuple[ir.Expr, ...]
    dtype: T.DataType
    # frame: None = SQL default; "rows_unbounded_current" kept for the
    # running-ROWS special case; "full_partition" for no ORDER BY
    frame: Optional[str] = None
    # general ROWS frame (preceding, following): row offsets relative
    # to the current row, None = UNBOUNDED on that side. (2, 0) is
    # ROWS BETWEEN 2 PRECEDING AND CURRENT ROW; (0, 3) CURRENT..3
    # FOLLOWING; negative following (e.g. BETWEEN 3 PRECEDING AND
    # 1 PRECEDING -> (3, -1)) allowed (reference
    # operator/window/RowsFraming.java)
    rows_frame: Optional[tuple] = None
    # value-based RANGE frame (preceding, following): offsets in the
    # single sort key's PHYSICAL units (decimals scaled, dates in days,
    # timestamps in micros), None = UNBOUNDED on that side, 0 = the
    # CURRENT ROW peer group. Signs as in rows_frame. (reference
    # operator/window/RangeFraming.java)
    range_frame: Optional[tuple] = None
    # GROUPS frame (preceding, following): peer-group distances from
    # the current row's group, None = UNBOUNDED. (reference
    # operator/window/GroupsFraming.java)
    groups_frame: Optional[tuple] = None


@dataclasses.dataclass
class Window(PlanNode):
    """Window functions over sorted partitions (plan/WindowNode.java,
    operator/WindowOperator.java:70). All functions on one node share
    partition_by + orderings (the planner splits differing specs into
    separate nodes)."""

    source: PlanNode = None  # type: ignore[assignment]
    partition_by: list[str] = dataclasses.field(default_factory=list)
    orderings: list["Ordering"] = dataclasses.field(default_factory=list)
    functions: dict[str, WindowCall] = dataclasses.field(
        default_factory=dict)  # output symbol -> call

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols + list(self.functions)

    def output_types(self):
        out = self.source.output_types()
        for s, c in self.functions.items():
            out[s] = c.dtype
        return out


@dataclasses.dataclass
class MatchRecognize(PlanNode):
    """Row pattern recognition, ONE ROW PER MATCH + SKIP PAST LAST ROW
    (reference plan/PatternRecognitionNode.java + the NFA program of
    operator/window/matcher/*). ``pattern`` is the parsed pattern AST
    (sql/ast.py PatVar/PatConcat/PatAlt/PatQuant); ``defines`` maps
    variable -> boolean IR over the input symbols, where PREV(col, n)
    references appear as ColumnRef "{sym}$prev{n}"; ``measures`` is
    [(out symbol, kind, IR expr|None, dtype)] with kind in
    {first, last, match_number, classifier}."""

    source: PlanNode = None  # type: ignore[assignment]
    partition_by: list[str] = dataclasses.field(default_factory=list)
    orderings: list[Ordering] = dataclasses.field(default_factory=list)
    pattern: object = None
    defines: dict[str, ir.Expr] = dataclasses.field(default_factory=dict)
    measures: list[tuple] = dataclasses.field(default_factory=list)

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.partition_by + [m[0] for m in self.measures]

    def output_types(self):
        src = self.source.output_types()
        out = {s: src[s] for s in self.partition_by}
        for sym, _kind, _expr, dtype in self.measures:
            out[sym] = dtype
        return out


@dataclasses.dataclass
class Unnest(PlanNode):
    """Expand array-typed columns into one output row per element
    (reference plan/UnnestNode.java). Multiple arrays zip to the
    longest length (shorter ones pad with NULLs); ``ordinality_sym``
    adds the 1-based element index."""

    source: PlanNode = None  # type: ignore[assignment]
    array_syms: list[str] = dataclasses.field(default_factory=list)
    out_syms: list[str] = dataclasses.field(default_factory=list)
    out_types: dict[str, T.DataType] = dataclasses.field(
        default_factory=dict)
    ordinality_sym: Optional[str] = None

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        out = list(self.source.output_symbols) + list(self.out_syms)
        if self.ordinality_sym:
            out.append(self.ordinality_sym)
        return out

    def output_types(self):
        out = dict(self.source.output_types())
        out.update(self.out_types)
        if self.ordinality_sym:
            out[self.ordinality_sym] = T.BIGINT
        return out


class ExchangeType(enum.Enum):
    GATHER = "gather"  # all shards -> one
    REPARTITION = "repartition"  # hash all_to_all
    REPLICATE = "replicate"  # broadcast (all_gather)


@dataclasses.dataclass
class Exchange(PlanNode):
    """Distribution boundary (plan/ExchangeNode.java). Inserted by the
    fragmenter; executed as ICI collectives under shard_map."""

    source: PlanNode = None  # type: ignore[assignment]
    kind: ExchangeType = ExchangeType.GATHER
    partition_keys: list[str] = dataclasses.field(default_factory=list)

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return self.source.output_symbols

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass
class Output(PlanNode):
    """Root node naming the result columns (plan/OutputNode.java)."""

    source: PlanNode = None  # type: ignore[assignment]
    names: list[str] = dataclasses.field(default_factory=list)
    symbols: list[str] = dataclasses.field(default_factory=list)

    def sources(self):
        return [self.source]

    @property
    def output_symbols(self):
        return list(self.symbols)

    def output_types(self):
        src = self.source.output_types()
        return {s: src[s] for s in self.symbols}


def rewrite_bottom_up(plan: PlanNode, fn) -> PlanNode:
    """Rebuild a plan bottom-up, applying ``fn`` to every node after its
    children (functional: unchanged subtrees keep their identity). The
    shared walker behind annotate_dense / late_materialize-class passes
    (the engine's analog of the reference's SimplePlanRewriter).

    The recursion passes ``fn`` down instead of closing over it: a
    nested function that calls itself is a reference cycle, and it
    would keep ``fn``'s closure (an optimizer pass's engine, with its
    device tensors) alive until the cycle collector ran."""
    updates = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, PlanNode):
            nv = rewrite_bottom_up(v, fn)
            if nv is not v:
                updates[f.name] = nv
        elif isinstance(v, list) and v and isinstance(v[0], PlanNode):
            nv = [rewrite_bottom_up(x, fn) for x in v]
            if any(a is not b for a, b in zip(nv, v)):
                updates[f.name] = nv
    if updates:
        plan = dataclasses.replace(plan, **updates)
    return fn(plan)
