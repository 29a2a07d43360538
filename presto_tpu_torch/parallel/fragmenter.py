"""Fragmenter: cut a join plan into multi-host exchange stages.

The analog of the reference's PlanFragmenter + AddExchanges for the
HTTP control plane (sql/planner/PlanFragmenter.java:108): a left-deep
inner/left hash-join tree over scan/filter/project legs becomes

  stage 0..L-1 (scan stages)   one task per worker: leg fragment over
                               the worker's table split, output
                               hash-partitioned by the leg's join key
                               into W buffers;
  stage L..    (join stages)   worker w pulls partition w of its probe
                               and build inputs from every peer,
                               joins locally, and either re-partitions
                               its output by the next join's probe key
                               or (last stage) applies the partial
                               aggregate and returns binary columns;
  coordinator                  FINAL aggregation + sort/limit over the
                               gathered partials.

Within a stage every worker holds rows of one hash partition of the
join keys, so the local joins compose to the global join — the same
argument as FIXED_HASH distribution in the reference
(SystemPartitioningHandle.java:58, AddExchanges.java:245).
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch.cost.model import decide_join_distribution
from presto_tpu_torch.plan import nodes as N


@dataclasses.dataclass
class ScanStage:
    name: str  # exchange table name, stable across queries
    fragment: N.PlanNode  # scan/filter/project subtree (one TableScan)
    partition_keys: list[str]


@dataclasses.dataclass
class JoinStage:
    name: str
    join: N.Join  # original node; sources replaced at dispatch
    probe_name: str  # exchange table fed by the previous stage
    build_name: str
    # None on the last stage (inline result); else next probe keys
    out_partition_keys: list[str] | None
    # applied above the final join on the worker (projects/filters and
    # the PARTIAL aggregate), bottom-up order
    upper: list[N.PlanNode] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FragmentedJoinPlan:
    scan_stages: list[ScanStage]
    join_stages: list[JoinStage]
    # the Aggregate whose FINAL step runs on the coordinator (None =
    # workers return raw joined rows)
    agg: N.Aggregate | None
    # full original plan (coordinator re-roots it onto a carrier scan)
    plan: N.PlanNode
    # node in ``plan`` that the carrier replaces (agg or join root)
    boundary: N.PlanNode


# --- general recursive fragmenter ------------------------------------------


class NotDistributable(Exception):
    """Plan shape the multi-host fragmenter cannot stage (caller falls
    back to local or partial-aggregate execution)."""


@dataclasses.dataclass
class GStage:
    """One distributed stage: every worker runs ``fragment`` over its
    base-table split plus pulled exchange inputs, and either
    hash-partitions its output into W buffers (``partition_keys``) or
    stores one unpartitioned buffer (None — broadcast/gather reads)."""

    name: str
    fragment: N.PlanNode
    # exchange table name used inside ``fragment`` -> (producer stage
    # name, read mode): "part" pulls this worker's partition from every
    # producer, "all" pulls every buffer of every producer (broadcast),
    # "own" pulls ONLY this worker's producer's buffers (a split-
    # distribution read of an already-materialized per-worker store —
    # used by adaptive re-planning's pass-through/repartition stages)
    sources: dict[str, tuple[str, str]]
    partition_keys: list[str] | None
    # the node of the PLAN THAT WAS FRAGMENTED whose output this stage
    # materializes (side/probe/build/rows stages; None for the final
    # stage) — the linkage mid-query adaptive re-planning
    # (parallel/adaptive.py) uses to swap completed subtrees for
    # exchange carrier scans in the remainder
    subtree: N.PlanNode | None = None


@dataclasses.dataclass(frozen=True)
class ExchangeSource:
    """An already-materialized stage a REMAINDER plan may read as a
    leaf (adaptive re-planning): carrier ``TableScan``s with catalog
    ``__exchange__`` and table == the completed stage's name resolve
    here. ``partition_keys`` records how the stage was PRODUCED (hash
    partition keys, or None for a per-worker store) — production
    layout dictates the legal read modes. (Observed row counts flow
    separately, through cost/adapt.CarrierStats into the re-costing
    overlay.)"""

    stage: str
    partition_keys: tuple[str, ...] | None


@dataclasses.dataclass
class GeneralFragmentedPlan:
    stages: list[GStage]  # dependency order
    # coordinator-side remainder: FINAL aggregation and everything
    # above it; reads the last stage's buffers through a carrier scan
    plan: N.PlanNode
    boundary: N.PlanNode  # node in ``plan`` the carrier replaces
    agg: N.Aggregate | None  # top aggregate (FINAL runs on coordinator)
    last_stage: str

    def consumer_readers(self, nworkers: int) -> dict[str, int]:
        """Producer stage -> how many downstream tasks independently
        read EACH partition of its buffer: 1 in "part" mode (consumer
        i owns partition i) and in "own" mode (consumer i alone reads
        producer i's store), ``nworkers`` in "all" (broadcast) mode —
        a page frees only when every reader acked past it. Shared by
        the streaming (_execute_general) and task-retry
        (_execute_general_ft) dispatchers, which must agree or a
        buffer would free pages a retried reader still needs."""
        readers: dict[str, int] = {}
        for st in self.stages:
            for _t, (producer, mode) in st.sources.items():
                readers[producer] = max(
                    readers.get(producer, 1),
                    nworkers if mode == "all" else 1)
        return readers


# the broadcast cutoff lives in the cost model (cost/model.py
# decide_join_distribution — the SAME decision the runtime executor
# and the ReorderJoins rule consult, so fragmenter and runtime can no
# longer disagree about a join's distribution)


def fragment_plan_general(plan: N.PlanNode, mode: str = "automatic",
                          broadcast_threshold: int | None = None,
                          exchange_sources: dict[str, ExchangeSource]
                          | None = None,
                          name_prefix: str = ""
                          ) -> GeneralFragmentedPlan | None:
    """Recursively stage an arbitrary join/semijoin/aggregate plan for
    multi-host execution (reference PlanFragmenter.createSubPlans +
    AddExchanges over any shape, SqlQueryScheduler stage DAG). The
    SPINE (probe chain from the fact scan up to the top aggregate)
    stays row-split or hash-partitioned across workers; every build /
    filter / scalar side becomes its own stage, broadcast when small,
    co-partitioned when large (the session's
    broadcast_join_threshold_rows when the coordinator passes it).

    ``exchange_sources`` (adaptive re-planning) maps carrier-scan
    table names embedded in a REMAINDER plan to the completed stages
    that already materialized them: partitioned carriers are consumed
    per-partition (and reused verbatim as cut sides when the keys
    match), per-worker stores are referenced broadcast when bare or
    read "own" (split semantics) under transforms. ``name_prefix``
    keeps replan-minted stage names collision-free against the
    original graph's. Returns None when the plan shape cannot
    distribute."""
    try:
        return _fragment_general(plan, mode, broadcast_threshold,
                                 exchange_sources, name_prefix)
    except NotDistributable:
        return None


def _fragment_general(plan: N.PlanNode, mode: str = "automatic",
                      broadcast_threshold: int | None = None,
                      exchange_sources: dict[str, ExchangeSource]
                      | None = None,
                      name_prefix: str = ""
                      ) -> GeneralFragmentedPlan:
    # walk the coordinator-side root chain down to the top Aggregate /
    # window chain
    node = plan
    agg: N.Aggregate | None = None
    upper: list[N.PlanNode] = []  # between agg (exclusive) and spine
    wchain: list[N.PlanNode] = []  # window chain (+ proj/filter), top
    #                                window first
    windows: list[N.Window] = []
    distinct_agg = False
    while True:
        if isinstance(node, (N.Join, N.MultiJoin, N.SemiJoin,
                             N.CrossJoin, N.TableScan)):
            break
        if isinstance(node, N.Aggregate):
            if agg is not None or node.step != N.AggStep.SINGLE:
                raise NotDistributable()
            distinct_agg = (distinct_agg or any(
                c.distinct for c in node.aggs.values()))
            agg = node
            upper = []
            node = node.source
            continue
        if isinstance(node, N.Window):
            # windows distribute by FIXED_HASH on their partition keys
            # (reference AddExchanges window partitioning): every
            # window in one distributed tail must share them so a
            # single repartition serves the whole chain
            if agg is not None or not node.partition_by:
                raise NotDistributable()
            if windows and set(node.partition_by) != set(
                    windows[0].partition_by):
                raise NotDistributable()
            windows.append(node)
            wchain.append(node)
            node = node.sources()[0]
            continue
        if isinstance(node, N.Distinct) and agg is not None:
            # a single DISTINCT aggregate lowers to Aggregate over
            # Distinct: the dedup must see each group's complete row
            # set, so keyed-single mode repartitions first (the
            # Distinct rides the post-exchange tail)
            distinct_agg = True
            upper.append(node)
            node = node.sources()[0]
            continue
        if isinstance(node, (N.Output, N.Sort, N.TopN, N.Limit,
                             N.Distinct)):
            if agg is not None or windows:
                raise NotDistributable()
            node = node.sources()[0]
            continue
        if isinstance(node, (N.Project, N.Filter)):
            if agg is not None:
                upper.append(node)
            elif windows:
                wchain.append(node)
            node = node.source
            continue
        if isinstance(node, N.MarkDistinct):
            # DISTINCT aggregates lower to MarkDistinct + masked
            # aggregation: the mark must see a group's WHOLE distinct
            # set, so the plan enters keyed-single mode (rows
            # repartition by the group keys)
            if agg is None:
                raise NotDistributable()
            distinct_agg = True
            upper.append(node)
            node = node.source
            continue
        raise NotDistributable()
    if agg is None and not windows:
        raise NotDistributable()  # raw-row gather: partial path covers
    # keyed-single mode: DISTINCT aggregates / window tails need whole
    # groups / whole window partitions on one worker, so rows
    # repartition by the keys and the tail runs as a complete SINGLE
    # computation per worker (no partial/final split)
    keyed_single = distinct_agg or bool(windows)
    if windows:
        part_keys = list(windows[0].partition_by)
        if agg is not None and not set(part_keys) <= set(
                agg.group_keys):
            raise NotDistributable()
    elif distinct_agg:
        if not agg.group_keys:
            raise NotDistributable()  # global DISTINCT: one group
        part_keys = list(agg.group_keys)
    spine_root = node

    stages: list[GStage] = []
    counter = [0]
    carriers = exchange_sources or {}

    def fresh(prefix: str) -> str:
        counter[0] += 1
        return f"{name_prefix}{prefix}{counter[0]}"

    def exchange_scan(name: str, types: dict) -> N.TableScan:
        return N.TableScan("__exchange__", name,
                           {s: s for s in types}, dict(types))

    def bare_carrier(node: N.PlanNode) -> ExchangeSource | None:
        """The completed stage a node references directly, when the
        node IS a carrier scan (no transforms above it)."""
        if isinstance(node, N.TableScan) \
                and node.catalog == "__exchange__":
            return carriers.get(node.table)
        return None

    def lower_side(side: N.PlanNode) -> tuple[str, dict]:
        """Materialize a build/filter/scalar side as its own stage
        (unpartitioned buffers; consumers read ALL = broadcast). The
        side may itself contain joins (its nested build sides become
        further broadcast stages): each worker contributes the rows
        its base-table split produces, and the union of worker buffers
        is the full side relation. A side that IS a completed
        per-worker store carrier references that stage directly — no
        pass-through copy."""
        src = bare_carrier(side)
        if src is not None and src.partition_keys is None:
            return src.stage, side.output_types()
        srcs: dict[str, tuple[str, str]] = {}
        frag, _dist = lower(side, srcs, allow_cut=False)
        name = fresh("side")
        stages.append(GStage(name, frag, srcs, None, subtree=side))
        return name, frag.output_types()

    def lower(node: N.PlanNode, sources: dict, allow_cut: bool):
        """Rewrite ``node`` for the fragment whose exchange inputs
        accumulate in ``sources``; returns (node', dist) with dist
        "split" or ("part", keys). Appends stages depth-first."""
        if isinstance(node, N.TableScan):
            if node.catalog == "__exchange__":
                src = carriers.get(node.table)
                if src is None:
                    raise NotDistributable()
                if src.partition_keys is not None:
                    # produced hash-partitioned: each worker owns its
                    # partition — the carrier reads co-located
                    sources[node.table] = (src.stage, "part")
                    return node, ("part", list(src.partition_keys))
                # per-worker store: each worker reads its OWN
                # producer's buffers, which is exactly a split
                # distribution (union over workers = full relation)
                sources[node.table] = (src.stage, "own")
                return node, "split"
            return node, "split"
        if isinstance(node, (N.Filter, N.Project)):
            src, dist = lower(node.sources()[0], sources, allow_cut)
            return dataclasses.replace(node, source=src), dist
        if isinstance(node, N.CrossJoin):
            if not node.scalar:
                raise NotDistributable()
            left, dist = lower(node.left, sources, allow_cut)
            sname, stypes = lower_side(node.right)
            scan = exchange_scan(fresh("x"), stypes)
            sources[scan.table] = (sname, "all")
            return dataclasses.replace(node, left=left,
                                       right=scan), dist
        if isinstance(node, N.SemiJoin):
            src, dist = lower(node.source, sources, allow_cut)
            sname, stypes = lower_side(node.filter_source)
            scan = exchange_scan(fresh("x"), stypes)
            sources[scan.table] = (sname, "all")
            return dataclasses.replace(node, source=src,
                                       filter_source=scan), dist
        if isinstance(node, N.MultiJoin):
            # fused star chain over HTTP workers: keep the fusion only
            # while EVERY build is broadcast-sized — each worker's
            # union of side-stage buffers is then the full dimension
            # relation and the multi-key probe walk runs in one
            # fragment. A build the binary cascade would FIXED_HASH
            # co-partition (Q9's partsupp at scale) must not ship
            # whole to every worker, so such chains expand back into
            # their cascade and take the hash-cut staging
            big = any(
                decide_join_distribution(
                    (node.distributions[i]
                     if i < len(node.distributions) else None)
                    or None,
                    mode,
                    (node.build_rows[i]
                     if i < len(node.build_rows) else None),
                    broadcast_threshold) != "broadcast"
                for i in range(len(node.builds)))
            if big:
                from presto_tpu_torch.plan.optimizer import unfuse_multijoin
                return lower(unfuse_multijoin(node), sources,
                             allow_cut)
            spine, dist = lower(node.spine, sources, allow_cut)
            scans = []
            for b in node.builds:
                sname, stypes = lower_side(b)
                scan = exchange_scan(fresh("x"), stypes)
                sources[scan.table] = (sname, "all")
                scans.append(scan)
            return dataclasses.replace(node, spine=spine,
                                       builds=scans), dist
        if isinstance(node, N.Join):
            full = node.join_type == N.JoinType.FULL
            if full and (not node.criteria or not allow_cut):
                # a broadcast FULL join would emit every unmatched
                # build row once PER WORKER; both sides must
                # co-partition (reference AddExchanges: FULL requires
                # PARTITIONED distribution)
                raise NotDistributable()
            left, dist = lower(node.left, sources, allow_cut)
            small = not full and decide_join_distribution(
                node.distribution, mode, node.build_rows,
                broadcast_threshold) == "broadcast"
            if small or not node.criteria or not allow_cut:
                sname, stypes = lower_side(node.right)
                scan = exchange_scan(fresh("x"), stypes)
                sources[scan.table] = (sname, "all")
                return dataclasses.replace(node, left=left,
                                           right=scan), dist
            # big build: FIXED_HASH — cut both sides into
            # key-partitioned stages, join co-partitions locally. A
            # side that IS a carrier already partitioned on exactly
            # the join keys reuses the completed stage's buffers
            # verbatim (no pass-through repartition copy).
            lkeys = [lk for lk, _ in node.criteria]
            rkeys = [rk for _, rk in node.criteria]
            pcar = bare_carrier(left)
            if pcar is not None \
                    and pcar.partition_keys == tuple(lkeys):
                pname = pcar.stage
            else:
                pname = fresh("probe")
                stages.append(GStage(pname, left, dict(sources),
                                     lkeys, subtree=node.left))
            sources.clear()
            bsrcs: dict[str, tuple[str, str]] = {}
            bfrag, _bd = lower(node.right, bsrcs, allow_cut=False)
            bcar = bare_carrier(bfrag)
            if bcar is not None \
                    and bcar.partition_keys == tuple(rkeys):
                bname = bcar.stage
            else:
                bname = fresh("build")
                stages.append(GStage(bname, bfrag, bsrcs, rkeys,
                                     subtree=node.right))
            pscan = exchange_scan(fresh("x"), left.output_types())
            bscan = exchange_scan(fresh("x"), bfrag.output_types())
            sources[pscan.table] = (pname, "part")
            sources[bscan.table] = (bname, "part")
            return dataclasses.replace(node, left=pscan,
                                       right=bscan), ("part", lkeys)
        raise NotDistributable()

    final_sources: dict[str, tuple[str, str]] = {}
    spine, _dist = lower(spine_root, final_sources, True)

    root: N.PlanNode = spine
    for up in reversed(upper):
        root = dataclasses.replace(up, source=root)

    if keyed_single:
        # repartition RAW spine rows by the keys, then run the whole
        # tail (upper chain + SINGLE aggregate and/or window chain)
        # per worker AFTER the exchange — MarkDistinct in particular
        # must see each group's complete row set, not one worker's
        # pre-shuffle slice. The coordinator just gathers finished
        # rows (reference AddExchanges FIXED_HASH + single-step
        # mark-distinct / window partitioning)
        if not set(part_keys) <= set(spine.output_types()):
            # keys computed by a projection above the spine can't
            # partition raw rows
            raise NotDistributable()
        pname = fresh("rows")
        stages.append(GStage(pname, spine, final_sources, part_keys,
                             subtree=spine_root))
        xscan = N.TableScan("__exchange__", fresh("x"),
                            {sym: sym for sym in
                             spine.output_types()},
                            dict(spine.output_types()))
        tail: N.PlanNode = xscan
        for up in reversed(upper):
            tail = dataclasses.replace(up, source=tail)
        if agg is not None:
            tail = dataclasses.replace(agg, source=tail)
        for wnode in reversed(wchain):
            tail = dataclasses.replace(wnode, source=tail)
        last = fresh("tail")
        stages.append(GStage(last, tail,
                             {xscan.table: (pname, "part")}, None))
        boundary = wchain[0] if wchain else agg
        return GeneralFragmentedPlan(stages, plan, boundary, None,
                                     last)

    # last worker stage: spine + upper chain + PARTIAL aggregate
    partial = dataclasses.replace(agg, source=root,
                                  step=N.AggStep.PARTIAL)
    last = fresh("agg")
    stages.append(GStage(last, partial, final_sources, None))
    return GeneralFragmentedPlan(stages, plan, agg, agg, last)


def _is_leg(node: N.PlanNode) -> bool:
    """A leg must be scan/filter/project over exactly one TableScan."""
    if isinstance(node, N.TableScan):
        return True
    if isinstance(node, (N.Filter, N.Project)):
        return _is_leg(node.source)
    return False


def fragment_join_plan(plan: N.PlanNode) -> FragmentedJoinPlan | None:
    """Returns the staged decomposition, or None when the plan shape
    isn't a supported left-deep join pipeline (caller falls back)."""
    # walk down from the root recording the coordinator-side chain
    node = plan
    agg = None
    upper: list[N.PlanNode] = []  # between agg (exclusive) and join root
    while True:
        if isinstance(node, N.Join):
            break
        if isinstance(node, N.Aggregate):
            if agg is not None or node.step != N.AggStep.SINGLE:
                return None
            if any(c.distinct for c in node.aggs.values()):
                return None  # DISTINCT aggs need mark-distinct locality
            agg = node
            upper = []
            node = node.source
            continue
        if isinstance(node, (N.Output, N.Sort, N.TopN, N.Limit,
                             N.Distinct)):
            if agg is not None:
                return None  # below-agg sort/limit: unexpected
            node = node.sources()[0]
            continue
        if isinstance(node, (N.Project, N.Filter)):
            if agg is not None:
                upper.append(node)
            node = node.source
            continue
        return None
    join_root = node
    if agg is None:
        upper = []

    # decompose the left-deep join chain
    chain: list[N.Join] = []
    cur: N.PlanNode = join_root
    while isinstance(cur, N.Join):
        if cur.join_type not in (N.JoinType.INNER, N.JoinType.LEFT):
            return None
        if not _is_leg(cur.right):
            return None
        chain.append(cur)
        cur = cur.left
    if not _is_leg(cur) or not chain:
        return None
    chain.reverse()  # bottom-up: chain[0].left is the base probe leg
    probe_leg = cur

    scan_stages = [ScanStage(
        "probe0", probe_leg, [lk for lk, _ in chain[0].criteria])]
    for i, j in enumerate(chain):
        scan_stages.append(ScanStage(
            f"build{i}", j.right, [rk for _, rk in j.criteria]))

    join_stages = []
    probe_name = "probe0"
    for i, j in enumerate(chain):
        last = i == len(chain) - 1
        out_keys = None
        if not last:
            nxt = chain[i + 1]
            out_keys = [lk for lk, _ in nxt.criteria]
        join_stages.append(JoinStage(
            f"join{i}", j, probe_name, f"build{i}", out_keys,
            upper=list(reversed(upper)) if last else []))
        probe_name = f"join{i}"

    boundary = agg if agg is not None else join_root
    return FragmentedJoinPlan(scan_stages, join_stages, agg, plan,
                              boundary)
