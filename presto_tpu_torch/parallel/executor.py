"""Distributed plan execution over a shard group: the port of
``presto_tpu/parallel/executor.py``.

The reference traces the whole plan, scans through output, into one
``shard_map`` program over a device mesh, and every distribution
boundary lowers to a collective. Here the :class:`ShardedInterpreter`
walks the plan eagerly: each node runs once for every shard that this
process holds, and each boundary calls a collective of the
:class:`~presto_tpu_torch.parallel.group.ShardGroup`:

| reference exchange (SystemPartitioningHandle)  | here |
|---|---|
| SOURCE distribution (splits) | scan rows in blocks over the shards, or by key hash |
| partial -> final aggregation | local fold, then gather or repartition the states, then merge |
| FIXED_BROADCAST (build sides) | ``all_gather`` of the build shards |
| FIXED_HASH repartition | bucket + ``all_to_all`` (``exchange.repartition``) |
| GATHER / SINGLE (sort, limit, output) | ``all_gather``, then replicated |

Every operator in between runs unchanged on its shard (the same
operators and kernels as ``exec/operators.py``): a kernel launches once
per shard, on that shard's rows.

An intermediate is SHARDED (one table per local shard, equal shapes on
every shard, as collectives need) or REPLICATED: held once per process,
since every shard would compute the same rows from it; its group-wide
row count is its own count.

The capacity ladder is the reference's: the ok flags of a pass are
min-reduced over the group and come back in one host sync; an overflow
grows the failed capacities and the plan runs again. The result, its
live mask and the live rows out of every node come back in one more
sync, so a query syncs as often on 2 shards as on 8.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Table
from presto_tpu_torch.cost.model import decide_join_distribution
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.exec import operators as OP
from presto_tpu_torch.exec.executor import (
    MAX_ATTEMPTS, RETRY_GROWTH, SKETCH_FIRST_RUNG, PlanInterpreter, Program,
    QueryRun, ScanInput, apply_blooms, bloom_bits, carrier_arrays,
    collect_scans, fetch_table, first_cost, log_pass, preorder_index,
    program_meta)
from presto_tpu_torch.exec.operators import DTable
from presto_tpu_torch.expr import aggmeta as A
from presto_tpu_torch.expr.compile import Val, is_long_dec
from presto_tpu_torch.ops import hash as H
from presto_tpu_torch.ops.hash import HashChainOverflow, grow_overflowed
from presto_tpu_torch.ops.sizes import next_pow2
from presto_tpu_torch.parallel import exchange as EX
from presto_tpu_torch.plan import nodes as N

SHARDED = "sharded"
REPLICATED = "replicated"
# the bloom of a dynamic filter is smaller under a group: its bits cross
# the shards (the reference's mesh limit)
DIST_BLOOM_BITS = 1 << 20


@dataclasses.dataclass
class DistTable:
    """An intermediate: SHARDED, one DTable per local shard (in
    ``group.local`` order); or REPLICATED, one DTable held once.
    ``part`` names the symbols a SHARDED table is hash-partitioned on
    (equal key tuples on one shard), or None for block sharding: set by
    bucket-sharded scans and FIXED_HASH exchanges, it lets a join or an
    aggregation on the same keys skip its exchange."""

    dts: list[DTable]
    dist: str
    part: tuple[str, ...] | None = None

    @property
    def dt(self) -> DTable:
        assert self.dist == REPLICATED
        return self.dts[0]


def _as_rows(v: Val, n: int) -> Val:
    """A Val with every companion at ``n`` rows (a scalar broadcasts):
    the form a collective ships."""
    if v.map_keys is not None:
        raise NotImplementedError("a MAP value across shards")
    if v.is_array:
        return OP.broadcast_rows(v, n)
    return Val(v.dtype, OP._rows(v.data, n, is_long_dec(v.dtype)),
               None if v.valid is None else v.valid.expand(n),
               v.dictionary)


def _gather(group, dts: list[DTable]) -> DTable:
    """GATHER exchange: every shard's rows, in shard order, as one
    replicated table (``all_gather`` of each column and its
    companions)."""
    first = dts[0]
    cols = {}
    for sym, v0 in first.cols.items():
        vs = [_as_rows(dt.cols[sym], dt.n) for dt in dts]
        parts = {}
        for field in ("data", "valid", "lengths", "elem_valid"):
            xs = [getattr(v, field) for v in vs]
            if all(x is None for x in xs):
                parts[field] = None
                continue
            if field == "valid":
                xs = [torch.ones(dt.n, dtype=torch.bool, device=dt.device)
                      if x is None else x for x, dt in zip(xs, dts)]
            elif field == "elem_valid":
                xs = [v.elem_mask() for v in vs]
            parts[field] = group.all_gather(xs)[0]
        cols[sym] = Val(v0.dtype, parts["data"], parts["valid"],
                        v0.dictionary, parts["lengths"], parts["elem_valid"])
    live = group.all_gather([dt.live_mask() for dt in dts])[0]
    return DTable(cols, live, first.n * group.nshards, first.device)


class ShardedInterpreter:
    """Walks the plan over a shard group, one node at a time for every
    local shard, with a distribution tag per intermediate and a
    collective at each distribution boundary (the reference's
    ShardedInterpreter)."""

    def __init__(self, scans: dict, capacities: dict[tuple, int], group,
                 session, node_order: dict[int, int] | None = None):
        # id(TableScan) -> (ScanInput, [arrays of each local shard])
        self.scans = scans
        self.capacities = capacities
        self.group = group
        self.nshards = group.nshards
        self.device = group.device
        self.session = session
        self.node_order = node_order or {}
        # per ok flag: one 0-d tensor per local shard
        self.ok_flags: list[list] = []
        self.ok_keys: list[tuple] = []
        self.used_capacity: dict[tuple, int] = {}
        # dynamic filtering: probe symbol -> bloom bits, the union over
        # the group of every shard's build keys
        self.dyn_filters: dict[str, torch.Tensor] = {}
        self._df_applied: set[str] = set()
        self.kernel_used: dict[object, list[str]] = {}
        # (preorder position, distribution, live rows per local shard)
        self.row_counts: list[tuple[object, str, list]] = []
        # merge exchanges: (preorder position, runs, rows per run)
        self.merges: list[tuple[object, int, int]] = []

    # -- plumbing shared with the local interpreter -------------------------

    _node_key = PlanInterpreter._node_key
    _capacity = PlanInterpreter._capacity

    def _note_ok(self, node, ok, kind: str = "table"):
        """``ok``: one 0-d flag per local shard, or one for a
        replicated operator."""
        if isinstance(ok, list) and len(ok) == 1:
            ok = ok[0]  # a replicated operator's one flag
        self.ok_flags.append(ok if isinstance(ok, list)
                             else [ok] * len(self.group.local))
        self.ok_keys.append(self._node_key(node, kind))

    def run(self, node: N.PlanNode) -> DistTable:
        from presto_tpu_torch import kernels as K
        m = getattr(self, "_r_" + type(node).__name__.lower(), None)
        if m is None:
            raise NotImplementedError(
                f"plan node {type(node).__name__} has no distributed "
                "execution")
        with K.collect() as used:
            out = m(node)
        key = self.node_order.get(id(node), id(node))
        if used:
            self.kernel_used[key] = list(used)
        if self.dyn_filters:
            out = self._apply_dyn_filters(out)
        self.row_counts.append((key, out.dist, [
            torch.sum(dt.live_mask().to(torch.int64)) for dt in out.dts]))
        return out

    def reduced(self) -> tuple:
        """(the pass's ok flags min-reduced over the group, the live
        rows out of every node summed over it): one all_reduce each. A
        replicated node counts its rows once, on shard 0."""
        nloc = len(self.group.local)
        if self.ok_flags:
            per = [torch.stack([f[i].reshape(()).to(torch.int32)
                                for f in self.ok_flags])
                   for i in range(nloc)]
            oks = self.group.all_reduce(per, "min")[0] > 0
        else:
            oks = torch.ones(0, dtype=torch.bool, device=self.device)
        per = []
        for i, shard in enumerate(self.group.local):
            per.append(torch.stack([
                c[i] if dist == SHARDED else
                (c[0] if shard == 0 else torch.zeros_like(c[0]))
                for _k, dist, c in self.row_counts]))
        counts = self.group.all_reduce(per, "sum")[0]
        return oks, counts

    def _apply_dyn_filters(self, out: DistTable) -> DistTable:
        blooms = {sym: bits for sym, bits in self.dyn_filters.items()
                  if sym in out.dts[0].cols and sym not in self._df_applied}
        if not blooms:
            return out
        self._df_applied.update(blooms)
        return DistTable([apply_blooms(dt, blooms) for dt in out.dts],
                         out.dist, out.part)

    def _collect_dyn_filters(self, criteria, build: DistTable) -> None:
        """A bloom of the build keys per equi-key; over a sharded build,
        the union of every shard's (a shard-local bloom would falsely
        prune other shards' keys)."""
        for lk, rk in criteria:
            per = [bloom_bits(dt, rk, DIST_BLOOM_BITS) for dt in build.dts]
            self.dyn_filters[lk] = (
                per[0] if build.dist == REPLICATED
                else self.group.all_reduce(per, "max")[0])

    def _each(self, fn, src: DistTable, *, part=None) -> DistTable:
        """``fn`` applied to every shard's table, distribution kept."""
        return DistTable([fn(dt) for dt in src.dts], src.dist, part)

    def gathered(self, src: DistTable) -> DTable:
        if src.dist == REPLICATED:
            return src.dt
        return _gather(self.group, src.dts)

    def replicated(self, node: N.PlanNode) -> DTable:
        return self.gathered(self.run(node))

    def _repart(self, dts: list[DTable], keys: list[str], node, kind: str
                ) -> list[DTable]:
        """FIXED_HASH exchange: repartition every shard's live rows over
        the group, so rows with equal key tuples land on one shard (the
        reference's _repart). The per-destination bucket grows on the
        retry ladder."""
        cap = self._capacity(
            node, next_pow2(2 * max(dts[0].n // self.nshards, 16)), kind)
        cols, live, pid = [], [], []
        for dt in dts:
            rows = {sym: _as_rows(v, dt.n) for sym, v in dt.cols.items()}
            cols.append(carrier_arrays(rows))
            live.append(dt.live_mask())
            # golden-ratio fold of the row key: a bucket-sharded scan
            # places its rows by the same bits (np_partition_id)
            pid.append(H.partition_id(
                OP._row_hash(DTable(rows, dt.live, dt.n, dt.device), keys),
                self.nshards))
        ex, valid, ok = EX.repartition(self.group, cols, live, pid,
                                       self.nshards, cap)
        self._note_ok(node, ok, kind)
        return [DTable({sym: Val(v.dtype, e[sym], e.get(f"{sym}$valid"),
                                 v.dictionary, e.get(f"{sym}$len"),
                                 e.get(f"{sym}$emask"))
                        for sym, v in dts[0].cols.items()},
                       vm, self.nshards * cap, self.device)
                for e, vm in zip(ex, valid)]

    @staticmethod
    def _co_located(side: DistTable, keys: list[str]) -> bool:
        """Is ``side`` already hash-partitioned on exactly these keys
        (connector bucketing, or an earlier exchange on them)?"""
        return side.part is not None and side.part == tuple(keys)

    def _join_distribution(self, node: N.Join) -> str:
        """broadcast | partitioned | hybrid: the cost model's decision
        (cost/model.decide_join_distribution)."""
        return decide_join_distribution(
            node.distribution,
            str(self.session.get("join_distribution_type")),
            node.build_rows,
            int(self.session.get("broadcast_join_threshold_rows")))

    def _salt_factor(self, node) -> int:
        """The join's salt fan-out: the plan-time annotation
        (cost/skew.py) capped by the session's ``join_salting`` (0 or 1
        disables) and by the shard count."""
        limit = int(self.session.get("join_salting") or 0)
        if limit <= 1 or self.nshards <= 1:
            return 1
        return max(1, min(int(node.salt_factor or 1), limit, self.nshards))

    @staticmethod
    def _with_salt(dt: DTable, salt: int) -> DTable:
        """Probe side of a salted exchange: a ``__salt__`` column that
        spreads each key's rows round-robin over ``salt`` sub-buckets."""
        cols = dict(dt.cols)
        cols["__salt__"] = Val(T.BIGINT, torch.remainder(
            torch.arange(dt.n, dtype=torch.int64, device=dt.device), salt))
        return DTable(cols, dt.live, dt.n, dt.device)

    @staticmethod
    def _tiled_build(dt: DTable, salt: int) -> DTable:
        """Build side of a salted exchange: every build row once per
        salt value, so each probe sub-bucket finds its copy on its own
        shard."""
        def tile(x):
            return None if x is None else x.repeat(
                (salt,) + (1,) * (x.dim() - 1))

        cols = {}
        for sym, v in dt.cols.items():
            v = _as_rows(v, dt.n)
            cols[sym] = Val(v.dtype, tile(v.data), tile(v.valid),
                            v.dictionary, tile(v.lengths),
                            tile(v.elem_valid))
        cols["__salt__"] = Val(T.BIGINT, torch.arange(
            salt, dtype=torch.int64, device=dt.device).repeat_interleave(
                dt.n))
        return DTable(cols, tile(dt.live_mask()), dt.n * salt, dt.device)

    @staticmethod
    def _salted_node(node: N.Join) -> N.Join:
        """The join over salted exchanges: the salt is one more equi
        criterion (a probe row matches only its sub-bucket's build
        copy), and a dense hint drops (a direct-address table holds one
        copy per key)."""
        return dataclasses.replace(
            node, criteria=list(node.criteria) + [("__salt__", "__salt__")],
            dense_key=None)

    @staticmethod
    def _strip_salt(dt: DTable) -> DTable:
        if "__salt__" not in dt.cols:
            return dt
        return DTable({s: v for s, v in dt.cols.items() if s != "__salt__"},
                      dt.live, dt.n, dt.device)

    # -- leaves ---------------------------------------------------------------

    def _r_tablescan(self, node: N.TableScan) -> DistTable:
        scan, shards = self.scans[id(node)]
        dts = []
        for arrays in shards:
            live = arrays["__live__"]
            cols = {sym: Val(scan.types[sym], arrays[sym],
                             arrays.get(f"{sym}$valid"),
                             scan.dictionaries[sym],
                             arrays.get(f"{sym}$len"),
                             arrays.get(f"{sym}$emask"))
                    for sym in node.assignments}
            dts.append(DTable(cols, live, live.shape[0], self.device))
        return DistTable(dts, SHARDED,
                         scan.part_cols if scan.bucketed else None)

    def _r_values(self, node: N.Values) -> DistTable:
        return DistTable([PlanInterpreter(
            {}, {}, self.session, self.device)._r_values(node)], REPLICATED)

    # -- elementwise: the distribution stays ----------------------------------

    def _r_filter(self, node: N.Filter) -> DistTable:
        src = self.run(node.source)
        return self._each(lambda dt: OP.apply_filter(dt, node.predicate),
                          src, part=src.part)

    def _r_project(self, node: N.Project) -> DistTable:
        from presto_tpu_torch.expr import ir
        src = self.run(node.source)
        part = None
        if src.part is not None:
            # the partition keys survive identity renames only
            renames = {e.name: s for s, e in node.assignments.items()
                       if isinstance(e, ir.ColumnRef)}
            mapped = tuple(renames.get(k) for k in src.part)
            if all(m is not None for m in mapped):
                part = mapped
        return self._each(lambda dt: OP.apply_project(dt, node.assignments),
                          src, part=part)

    def _r_unnest(self, node: N.Unnest) -> DistTable:
        src = self.run(node.source)
        return self._each(lambda dt: OP.apply_unnest(dt, node), src)

    # -- aggregation: partial per shard, merged replicated or repartitioned ---

    def _group_cap(self, node: N.Aggregate, n: int) -> int:
        """A grouped aggregate's table capacity over ``n`` input rows per
        shard (the local interpreter's rule: a planner hint is cut to
        twice the input, a sketch's first rung is small)."""
        most = next_pow2(2 * n)
        if any(c.fn in A.SKETCH_FNS for c in node.aggs.values()):
            most = min(most, SKETCH_FIRST_RUNG)
        return self._capacity(
            node, next_pow2(min(2 * n, 1 << 22)),
            override=int(self.session.get("groupby_table_size") or 0),
            most=most)

    def _aggregate(self, dts: list[DTable], node, cap: int, kind: str,
                   step=None):
        """``node`` per shard, or its ``step`` (a PARTIAL or FINAL
        copy) in its place; the ok flag keys on ``node``."""
        outs = [OP.apply_aggregate(dt, step or node, cap) for dt in dts]
        if node.group_keys:
            self._note_ok(node, [ok for _o, ok in outs], kind)
        return [o for o, _ok in outs]

    def _r_aggregate(self, node: N.Aggregate) -> DistTable:
        ov = int(self.session.get("groupby_table_size") or 0)
        src = self.run(node.source)
        n = src.dts[0].n
        cap = 1 if not node.group_keys else self._group_cap(node, n)
        if src.dist == REPLICATED:
            return DistTable(self._aggregate(src.dts, node, cap, "table"),
                             REPLICATED)
        if (node.group_keys and src.part is not None
                and set(src.part) <= set(node.group_keys)
                and node.step == N.AggStep.SINGLE):
            # equal group tuples are co-located already: aggregate on
            # each shard, no partial/final split and no exchange
            return DistTable(self._aggregate(src.dts, node, cap, "table"),
                             SHARDED, src.part)
        partial_node = dataclasses.replace(node, step=N.AggStep.PARTIAL)
        final_node = dataclasses.replace(node, step=N.AggStep.FINAL)
        if node.step == N.AggStep.PARTIAL:
            partial_node, final_node = node, None
        if (not self.session.get("partial_aggregation")
                and final_node is not None):
            # raw rows to one replicated aggregate (a debugging switch)
            return DistTable(self._aggregate(
                [_gather(self.group, src.dts)], node, cap, "table"),
                REPLICATED)
        partial = self._aggregate(src.dts, node, cap, "table",
                                  partial_node)
        if final_node is None:
            return DistTable([_gather(self.group, partial)], REPLICATED)
        est_groups = node.capacity or cap
        if node.group_keys and est_groups >= int(
                self.session.get("partitioned_agg_min_groups")):
            # many groups: repartition the partial states by group key,
            # merge each shard's groups there (O(groups / nshards) state
            # per shard)
            ex = self._repart(partial, node.group_keys, node, "agg_exch")
            fcap = self._capacity(
                node, next_pow2(2 * max(est_groups // self.nshards, 16)),
                "final", override=ov)
            return DistTable(self._aggregate(ex, node, fcap, "final",
                                             final_node),
                             SHARDED, tuple(node.group_keys))
        fcap = (1 if not node.group_keys else
                self._capacity(node, next_pow2(2 * cap), "final",
                               override=ov))
        return DistTable(self._aggregate(
            [_gather(self.group, partial)], node, fcap, "final",
            final_node), REPLICATED)

    # -- joins: broadcast or hash-repartitioned build and probe ---------------

    def _pairs(self, probe: list[DTable], build: list[DTable]):
        """(probe, build) per shard; a replicated side pairs with all."""
        if len(build) == 1:
            build = build * len(probe)
        return list(zip(probe, build))

    def _join(self, probe: list, build: list, node, cap: int, kind: str,
              join_node=None):
        """A unique-build join per shard pair (``join_node``, a salted
        copy, runs in ``node``'s place; the ok flag keys on ``node``)."""
        outs = [OP.apply_join(p, b, join_node or node, cap)
                for p, b in self._pairs(probe, build)]
        self._note_ok(node, [ok for _o, ok in outs], kind)
        return [self._strip_salt(o) for o, _ok in outs]

    def _expand_join(self, probe: list, build: list, node, out_cap: int,
                     kind: str, join_node=None):
        outs = [OP.apply_expand_join(p, b, join_node or node, out_cap)
                for p, b in self._pairs(probe, build)]
        self._note_ok(node, [ok for _o, ok in outs], kind)
        return [self._strip_salt(o) for o, _ok in outs]

    def _r_join(self, node: N.Join) -> DistTable:
        # build side first, so its keys can prune the probe scans
        right = self.run(node.right)
        if (node.join_type == N.JoinType.INNER
                and self.session.get("enable_dynamic_filtering")):
            self._collect_dyn_filters(node.criteria, right)
        left = self.run(node.left)
        lkeys = [lk for lk, _ in node.criteria]
        rkeys = [rk for _, rk in node.criteria]
        out_part = left.part
        dist = self._join_distribution(node)
        partitioned = bool(node.criteria and left.dist == SHARDED
                           and right.dist == SHARDED
                           and dist in ("partitioned", "hybrid"))
        if (partitioned and dist == "hybrid" and node.build_unique
                and node.join_type in (N.JoinType.INNER, N.JoinType.LEFT)
                and self.nshards > 1
                and int(self.session.get("skew_hot_key_threshold")
                        or 0) > 0):
            return self._hybrid_join(node, left, right, lkeys, rkeys)
        if node.join_type == N.JoinType.FULL and not partitioned:
            # a broadcast build would emit each unmatched build row once
            # per shard: gather both sides and join replicated
            probe, build = self.gathered(left), self.gathered(right)
            default = next_pow2(2 * (probe.n + build.n))
            out_cap = self._capacity(node, default, "out", most=default)
            return DistTable(self._expand_join([probe], [build], node,
                                               out_cap, "out"), REPLICATED)
        join_node = node
        if partitioned:
            # FIXED_HASH: both sides repartitioned by key hash, each
            # shard joins its key range (build memory O(build/nshards));
            # a side already partitioned on its keys skips its exchange;
            # a salted join spreads each key over sub-buckets (FULL keeps
            # the exact co-partition its unmatched tail needs)
            salt = (self._salt_factor(node)
                    if node.join_type != N.JoinType.FULL else 1)
            if salt > 1:
                probe = self._repart(
                    [self._with_salt(dt, salt) for dt in left.dts],
                    lkeys + ["__salt__"], node, "probe_exch")
                build = self._repart(
                    [self._tiled_build(dt, salt) for dt in right.dts],
                    rkeys + ["__salt__"], node, "build_exch")
                join_node = self._salted_node(node)
                out_part = None  # partitioned on (keys, salt)
            else:
                probe = (left.dts if self._co_located(left, lkeys)
                         else self._repart(left.dts, lkeys, node,
                                           "probe_exch"))
                build = (right.dts if self._co_located(right, rkeys)
                         else self._repart(right.dts, rkeys, node,
                                           "build_exch"))
                # a FULL join's unmatched build rows sit where their
                # BUILD key hashed: not partitioned by the probe keys
                out_part = (None if node.join_type == N.JoinType.FULL
                            else tuple(lkeys))
            tab_kind, out_kind = "ptable", "pout"
            # per-shard table: not the planner's global-sized hint
            cap = self._capacity(node, next_pow2(2 * max(
                (node.build_rows or build[0].n) // self.nshards, 16)),
                tab_kind)
            out_default = next_pow2(2 * (probe[0].n + build[0].n))
            out_most = None
        else:
            # FIXED_BROADCAST: the build side replicated
            probe = left.dts
            build = [self.gathered(right)]
            tab_kind, out_kind = "table", "out"
            default = next_pow2(2 * build[0].n)
            cap = self._capacity(node, default, most=default)
            out_default = next_pow2(2 * (probe[0].n + build[0].n))
            out_most = out_default
        if node.build_unique and node.join_type != N.JoinType.FULL:
            outs = self._join(probe, build, node, cap, tab_kind, join_node)
        else:
            out_cap = self._capacity(node, out_default, out_kind,
                                     most=out_most)
            outs = self._expand_join(probe, build, node, out_cap,
                                     out_kind, join_node)
        return DistTable(outs, left.dist, out_part)

    def _hybrid_join(self, node: N.Join, left: DistTable, right: DistTable,
                     lkeys, rkeys) -> DistTable:
        """Skew-aware hybrid distribution: heavy-hitter keys are found at
        run time by a group-wide count sketch over the probe keys. Hot
        keys keep their probe rows local and replicate their build rows
        (``all_gather``); the cold tail hash-partitions (salted when
        annotated). A probe row and its build row hash to the same
        sketch bucket, so they always take the same path; a collision
        only moves a cold key to the (also correct) broadcast path.
        Both halves preserve the probe side (INNER or LEFT over a unique
        build) and concatenate row-wise."""
        from presto_tpu_torch.cost.skew import SKETCH_BUCKETS
        threshold = int(self.session.get("skew_hot_key_threshold"))
        sb = SKETCH_BUCKETS  # a power of two: the hash's low bits
        probe_live, probe_key_ok, buckets = [], [], []
        for dt in left.dts:
            live = dt.live_mask()
            probe_live.append(live)
            probe_key_ok.append(OP._and_key_valid(dt, lkeys, live))
            buckets.append(OP._row_hash(dt, lkeys) & (sb - 1))
        counts = []
        for kv, b in zip(probe_key_ok, buckets):
            c = torch.zeros(sb + 1, dtype=torch.int32, device=self.device)
            c.index_add_(0, torch.where(kv, b, torch.full_like(b, sb)),
                         torch.ones_like(b, dtype=torch.int32))
            counts.append(c[:sb])
        gcounts = self.group.all_reduce(counts, "sum")[0]
        # a bucket pools ~rows/SKETCH_BUCKETS cold keys besides a heavy
        # hitter: compare against the threshold PLUS that background
        background = torch.div(torch.sum(gcounts), sb, rounding_mode="floor")
        hot_bucket = gcounts >= threshold + background
        probe_hot = [hot_bucket[b] & kv
                     for b, kv in zip(buckets, probe_key_ok)]
        build_live, build_hot = [], []
        for dt in right.dts:
            bl = OP._and_key_valid(dt, rkeys, dt.live_mask())
            build_live.append(bl)
            build_hot.append(hot_bucket[OP._row_hash(dt, rkeys) & (sb - 1)]
                             & bl)

        # hot build rows: compacted per shard (the planner's hot-key
        # estimate seeds the width), then gathered
        est_hot = int(node.hot_keys or 16)
        hot_cap = self._capacity(node, next_pow2(max(
            4 * est_hot // max(self.nshards, 1), 16)), "hot")
        hot = [OP.compact_dtable(DTable(dt.cols, h, dt.n, dt.device),
                                 hot_cap)
               for dt, h in zip(right.dts, build_hot)]
        self._note_ok(node, [ok for _d, ok in hot], "hot")
        hot_build = _gather(self.group, [d for d, _ok in hot])
        hcap = self._capacity(node, next_pow2(2 * hot_build.n), "htab")
        out_hot = self._join(
            [DTable(dt.cols, pl & ph, dt.n, dt.device)
             for dt, pl, ph in zip(left.dts, probe_live, probe_hot)],
            [hot_build], node, hcap, "htab")

        # cold tail: hot rows struck out of both sides, then the plain
        # partitioned join
        cold_probe = [DTable(dt.cols, pl & ~ph, dt.n, dt.device)
                      for dt, pl, ph in zip(left.dts, probe_live, probe_hot)]
        cold_build = [DTable(dt.cols, bl & ~bh, dt.n, dt.device)
                      for dt, bl, bh in zip(right.dts, build_live,
                                            build_hot)]
        join_node = node
        salt = self._salt_factor(node)
        if salt > 1:
            cp = self._repart([self._with_salt(dt, salt)
                               for dt in cold_probe],
                              lkeys + ["__salt__"], node, "probe_exch")
            cb = self._repart([self._tiled_build(dt, salt)
                               for dt in cold_build],
                              rkeys + ["__salt__"], node, "build_exch")
            join_node = self._salted_node(node)
        else:
            # striking rows out moves none: a co-located side keeps its
            # exchange skip
            cp = (cold_probe if self._co_located(left, lkeys)
                  else self._repart(cold_probe, lkeys, node, "probe_exch"))
            cb = (cold_build if self._co_located(right, rkeys)
                  else self._repart(cold_build, rkeys, node, "build_exch"))
        ccap = self._capacity(node, next_pow2(2 * max(
            (node.build_rows or cb[0].n) // self.nshards, 16)), "ptable")
        out_cold = self._join(cp, cb, node, ccap, "ptable", join_node)
        return DistTable([OP.concat_dtables([h, c])
                          for h, c in zip(out_hot, out_cold)], SHARDED)

    def _r_multijoin(self, node: N.MultiJoin) -> DistTable:
        """The fused star chain: every build runs first (each registers
        its dynamic filter, so the spine scan prunes against all of
        them); at most one large build co-partitions with the spine
        (one repartition of the spine), every other build replicates;
        then the fused walk runs on each shard."""
        builds: list[DistTable] = []
        for bnode, crit in zip(node.builds, node.criteria):
            builds.append(self.run(bnode))
            if self.session.get("enable_dynamic_filtering"):
                self._collect_dyn_filters(crit, builds[-1])
        spine = self.run(node.spine)
        mode = str(self.session.get("join_distribution_type"))
        thresh = int(self.session.get("broadcast_join_threshold_rows"))
        spine_syms = set(node.spine.output_symbols)
        part_idx, part_rows = None, -1
        if spine.dist == SHARDED:
            for i, (b, crit) in enumerate(zip(builds, node.criteria)):
                rows_i = (node.build_rows[i]
                          if i < len(node.build_rows) else None)
                dist_i = (node.distributions[i]
                          if i < len(node.distributions) else "automatic")
                d = decide_join_distribution(
                    dist_i if dist_i != "automatic" else None,
                    mode, rows_i, thresh)
                if (d in ("partitioned", "hybrid") and b.dist == SHARDED
                        and all(lk in spine_syms for lk, _ in crit)
                        and (rows_i or 0) > part_rows):
                    part_idx, part_rows = i, (rows_i or 0)
        spine_dts = spine.dts
        out_part = spine.part
        build_dts: list[list[DTable]] = []
        if part_idx is not None:
            crit = node.criteria[part_idx]
            plk = [lk for lk, _ in crit]
            prk = [rk for _, rk in crit]
            if not self._co_located(spine, plk):
                spine_dts = self._repart(spine.dts, plk, node, "probe_exch")
            out_part = tuple(plk)
        for i, b in enumerate(builds):
            if i == part_idx:
                build_dts.append(
                    b.dts if self._co_located(b, prk)
                    else self._repart(b.dts, prk, node,
                                      f"build{i}_exch"))
            else:
                build_dts.append([self.gathered(b)])
        default = next_pow2(2 * max(max((b[0].n for b in build_dts),
                                        default=1), 1))
        cap = self._capacity(node, default, most=default)
        outs = []
        for s, sp in enumerate(spine_dts):
            bs = [b[0] if len(b) == 1 else b[s] for b in build_dts]
            outs.append(OP.apply_multi_join(sp, bs, node,
                                            growth=max(1, cap // default)))
        self._note_ok(node, [ok for _o, ok in outs])
        outs = [o for o, _ok in outs]
        if spine.dist == REPLICATED:
            return DistTable(outs, REPLICATED)
        return DistTable(outs, SHARDED, out_part)

    def _r_semijoin(self, node: N.SemiJoin) -> DistTable:
        src = self.run(node.source)
        filt = self.replicated(node.filter_source)
        default = next_pow2(2 * filt.n)
        cap = self._capacity(node, default, most=default)
        outs = [OP.apply_semijoin(dt, filt, node, cap) for dt in src.dts]
        self._note_ok(node, [ok for _o, ok in outs])
        return DistTable([o for o, _ok in outs], src.dist, src.part)

    def _r_crossjoin(self, node: N.CrossJoin) -> DistTable:
        left = self.run(node.left)
        right = self.replicated(node.right)
        if node.scalar:
            return self._each(lambda dt: OP.apply_cross_scalar(dt, right),
                              left, part=left.part)
        # nested loop: the left side stays where it is, the right side
        # replicated, a product per shard
        ln = left.dts[0].n
        lcap = self._capacity(node, next_pow2(min(ln, 2 * max(
            (node.left_rows or ln) // max(self.nshards, 1), 16))), "left")
        rcap = self._capacity(node, next_pow2(
            min(right.n, 2 * (node.right_rows or right.n))), "right")
        ldts = left.dts
        if lcap < ln:
            outs = [OP.compact_dtable(dt, lcap) for dt in ldts]
            self._note_ok(node, [ok for _d, ok in outs], "left")
            ldts = [d for d, _ok in outs]
        if rcap < right.n:
            right, rok = OP.compact_dtable(right, rcap)
            self._note_ok(node, rok, "right")
        return DistTable([OP.apply_cross_general(dt, right) for dt in ldts],
                         left.dist, left.part)

    # -- operators whose result is replicated --------------------------------

    def _r_distinct(self, node: N.Distinct) -> DistTable:
        src = self.run(node.source)
        n = src.dts[0].n
        cap = self._capacity(node, next_pow2(min(2 * n, 1 << 22)),
                             most=next_pow2(2 * n))
        outs = [OP.apply_distinct(dt, cap) for dt in src.dts]
        self._note_ok(node, [ok for _o, ok in outs])
        if src.dist == REPLICATED:
            return DistTable([outs[0][0]], REPLICATED)
        # a distinct per shard shrinks the exchange, then the final one
        gathered = _gather(self.group, [o for o, _ok in outs])
        fcap = self._capacity(node, next_pow2(2 * cap), "final")
        out, ok = OP.apply_distinct(gathered, fcap)
        self._note_ok(node, ok, "final")
        return DistTable([out], REPLICATED)

    def _r_markdistinct(self, node: N.MarkDistinct) -> DistTable:
        src = self.run(node.source)
        if src.dist == REPLICATED:
            return self._each(lambda dt: OP.apply_mark_distinct(dt, node),
                              src)
        # a group-wide mark needs equal key tuples on one shard
        if src.part is not None and set(src.part) <= set(node.keys):
            ex, out_part = src.dts, src.part
        else:
            ex = self._repart(src.dts, node.keys, node, "mark_exch")
            out_part = tuple(node.keys)
        return DistTable([OP.apply_mark_distinct(dt, node) for dt in ex],
                         SHARDED, out_part)

    def _r_window(self, node: N.Window) -> DistTable:
        src = self.run(node.source)
        if src.dist == SHARDED and node.partition_by:
            # repartition by the window's partition keys; each shard
            # computes its partitions and the output stays sharded
            if src.part is not None and set(src.part) <= set(
                    node.partition_by):
                ex, part = src.dts, src.part
            else:
                ex = self._repart(src.dts, node.partition_by, node,
                                  "win_exch")
                part = tuple(node.partition_by)
            return DistTable([OP.apply_window(dt, node) for dt in ex],
                             SHARDED, part)
        return DistTable([OP.apply_window(self.gathered(src), node)],
                         REPLICATED)

    def _r_sort(self, node: N.Sort) -> DistTable:
        src = self.run(node.source)
        if src.dist == SHARDED and self.session.get("distributed_sort"):
            # merge exchange: each shard sorts its own rows, the
            # replicated stage only merges the presorted runs
            local = [OP.apply_sort(dt, node.orderings) for dt in src.dts]
            self.merges.append((self.node_order.get(id(node), id(node)),
                                self.nshards, local[0].n))
            merged = OP.merge_sorted_runs(_gather(self.group, local),
                                          node.orderings, self.nshards)
            return DistTable([merged], REPLICATED)
        return DistTable([OP.apply_sort(self.gathered(src), node.orderings)],
                         REPLICATED)

    def _r_topn(self, node: N.TopN) -> DistTable:
        src = self.run(node.source)
        if src.dist == SHARDED:
            # a TopN per shard, cut to ``count`` rows, then the final
            # TopN over nshards * count candidates
            local = [OP.head(OP.apply_topn(dt, node.count, node.orderings),
                             node.count) for dt in src.dts]
            return DistTable([OP.apply_topn(_gather(self.group, local),
                                            node.count, node.orderings)],
                             REPLICATED)
        return DistTable([OP.apply_topn(src.dt, node.count,
                                        node.orderings)], REPLICATED)

    def _r_limit(self, node: N.Limit) -> DistTable:
        src = self.run(node.source)
        take = node.count + node.offset
        if src.dist == SHARDED and take <= src.dts[0].n:
            # each shard's first ``count + offset`` live rows (live rows
            # first, stably), then the final limit over the candidates
            local = [OP.head(OP.apply_sort(OP.apply_limit(dt, take), []),
                             take) for dt in src.dts]
            return DistTable([OP.apply_limit(_gather(self.group, local),
                                             node.count, node.offset)],
                             REPLICATED)
        return DistTable([OP.apply_limit(self.gathered(src), node.count,
                                         node.offset)], REPLICATED)

    def _r_union(self, node: N.Union) -> DistTable:
        parts = [self.run(s) for s in node.inputs]
        if all(p.dist == SHARDED for p in parts):
            return DistTable([OP.apply_union(list(dts), node)
                              for dts in zip(*(p.dts for p in parts))],
                             SHARDED)
        return DistTable([OP.apply_union([self.gathered(p) for p in parts],
                                         node)], REPLICATED)

    def _r_exchange(self, node: N.Exchange) -> DistTable:
        src = self.run(node.source)
        if src.dist != SHARDED:
            return src
        if node.kind in (N.ExchangeType.GATHER, N.ExchangeType.REPLICATE):
            return DistTable([_gather(self.group, src.dts)], REPLICATED)
        if node.kind == N.ExchangeType.REPARTITION:
            return DistTable(self._repart(src.dts, node.partition_keys,
                                          node, "exch"), SHARDED)
        return src

    def _r_output(self, node: N.Output) -> DistTable:
        dt = self.replicated(node.source)
        return DistTable([DTable({s: dt.cols[s] for s in node.symbols},
                                 dt.live, dt.n, dt.device)], REPLICATED)


def _plan_exploits_partitioning(plan: N.PlanNode,
                                part: tuple[str, ...]) -> bool:
    """Could some operator skip an exchange because its keys match
    ``part`` (a join side, or an aggregate, window or mark-distinct key
    superset)?"""
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, N.Join) and node.criteria:
            if (tuple(lk for lk, _ in node.criteria) == part
                    or tuple(rk for _, rk in node.criteria) == part):
                return True
        elif isinstance(node, N.Aggregate) and node.group_keys:
            if set(part) <= set(node.group_keys):
                return True
        elif isinstance(node, N.Window) and node.partition_by:
            if set(part) <= set(node.partition_by):
                return True
        elif isinstance(node, N.MarkDistinct):
            if set(part) <= set(node.keys):
                return True
        stack.extend(node.sources())
    return False


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``, made on its device."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, torch.zeros((rows - x.shape[0],) + x.shape[1:],
                                     dtype=x.dtype, device=x.device)])


def _bucket_order(scan: ScanInput, nshards: int) -> tuple:
    """The host placement of a bucket-sharded scan: (rows per shard,
    [(row indices, placed rows, live mask) per shard]). Each row goes
    to the shard of its partitioning key's hash (np_partition_id: the
    bits of the device repartition), in table order; a row the table
    masks dead goes to shard 0, dead."""
    tbl, node = scan.host_table, scan.node
    hs = []
    for sym in scan.part_cols:
        col = tbl.columns[node.assignments[sym]]
        if scan.dictionaries.get(sym) is not None:
            hs.append(H.np_hash_string_column(col.data, col.dictionary,
                                              col.valid))
        else:
            hs.append(H.np_hash_int_column(col.data, col.valid))
    bucket = H.np_partition_id(H.np_combine_hashes(hs), nshards)
    base_live = None if tbl.mask is None else np.asarray(tbl.mask, bool)
    if base_live is not None:
        bucket = np.where(base_live, bucket, 0)
    counts = np.bincount(bucket, minlength=nshards)
    # rows per shard: a pow2 bucket of the fullest shard
    per = next_pow2(max(int(counts.max()), 1))
    # numpy's stable sort of a narrow integer is a radix sort
    narrow = np.uint8 if nshards <= 256 else np.uint16
    order = np.argsort(bucket.astype(narrow), kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    shards = []
    for s in range(nshards):
        rows = order[starts[s]:starts[s] + counts[s]]
        idx = np.zeros(per, dtype=np.int64)
        idx[:len(rows)] = rows
        live = np.zeros(per, dtype=bool)
        live[:len(rows)] = True if base_live is None else base_live[rows]
        shards.append((idx, len(rows), live))
    return per, shards


def _shard_scan_arrays(scan: ScanInput, group, bucketed: bool = False,
                       engine=None) -> list[dict]:
    """A scan's device arrays split over the group's shards: one dict
    per local shard, with its ``__live__`` mask, every shard the same
    number of rows.

    Block sharding (the default) gives shard s the rows [s*per,
    (s+1)*per) of the resident column, as views of the engine's copy
    (a repeat query uploads nothing); the last shard is padded on the
    device with dead zero rows. With ``bucketed`` (connector-defined
    partitioning), rows place by key hash, in an order computed on the
    host (``_bucket_order``; its index tensors are kept by the engine
    per table and shard count); each shard gathers its rows from the
    resident column."""
    n, s_count = scan.nrows, group.nshards
    dev = group.device
    out = []
    if not bucketed:
        per = -(-max(n, 1) // s_count)
        for s in group.local:
            lo = min(s * per, n)
            hi = min(lo + per, n)
            arrays = {sym: _pad_rows(a[lo:hi], per)
                      for sym, a in scan.arrays.items()}
            live = torch.arange(per, device=dev) < (hi - lo)
            if scan.live is not None:
                live = live & _pad_rows(scan.live[lo:hi], per)
            arrays["__live__"] = live
            out.append(arrays)
        return out
    key = (tuple(id(scan.host_table.columns[scan.node.assignments[sym]]
                    .data) for sym in scan.part_cols),
           id(scan.host_table.mask), s_count, str(dev))
    cache = None if engine is None else engine._shard_orders
    hit = None if cache is None else cache.get(key)
    if hit is None:
        per, placed = _bucket_order(scan, s_count)
        hit = (per, {s: (HS.upload(idx, dev, "shard-order"), count,
                         HS.upload(live, dev, "shard-order"))
                     for s, (idx, count, live) in enumerate(placed)
                     if s in group.local})
        if cache is not None:
            # the host arrays ride in the key's ids: pin them
            cache[key] = hit + (scan.host_table,)
    per, placed = hit[0], hit[1]
    for s in group.local:
        idx, count, live = placed[s]
        filled = torch.arange(per, device=dev) < count
        arrays = {}
        for sym, a in scan.arrays.items():
            g = a.index_select(0, idx)
            arrays[sym] = g.masked_fill(
                ~filled.reshape((per,) + (1,) * (a.dim() - 1)), 0)
        arrays["__live__"] = live
        out.append(arrays)
    return out


def _distributed_key(engine, plan: N.PlanNode, sharded: list, group,
                     backend: str) -> tuple:
    """The program-cache key of a distributed plan: the plan's
    fingerprint, every scan's shard shapes, dictionaries and placement,
    the session properties the interpreter reads, the shard count and
    the platform. The capacity memory keys on it, so capacities learned
    over 8 shards never seed a run over 2."""
    from presto_tpu_torch.exec import progcache as PC
    from presto_tpu_torch.plan.fingerprint import plan_fingerprint
    return (plan_fingerprint(plan),
            tuple((i, sym, tuple(a.shape), str(a.dtype))
                  for i, (_scan, shards) in enumerate(sharded)
                  for sym, a in shards[0].items()),
            PC.scan_dictionary_key([scan for scan, _ in sharded]),
            PC.trace_session_key(engine.session),
            tuple((i, scan.part_cols, scan.bucketed)
                  for i, (scan, _) in enumerate(sharded)),
            "distributed", group.nshards,
            PC.platform_fingerprint(str(group.device), backend))


def execute_plan_distributed(engine, plan: N.PlanNode, mesh,
                             profile: dict | None = None) -> Table:
    """Run a logical plan over the shard group ``mesh`` (a
    ``ShardGroup``; the keyword keeps the reference's name).
    ``profile`` (EXPLAIN ANALYZE) gets the run time and the group-wide
    live rows and distribution of every node.

    A distributed query skips streaming, spill, grouped execution and
    segmentation, as the reference's does. Its capacity vector is
    remembered under its key (``engine._caps_memory``), so a repeat
    query climbs no rung; with ``plan_templates`` on, the key is the
    template's, so a literal variant starts from it too; the persistent
    store (exec/progcache.py) carries the vector and the program's cost
    to a fresh engine under the same key, which holds the shard count.
    Sets ``engine.last_run`` (one program), ``engine.last_kernel_notes`` and
    ``engine.last_dist_meta``."""
    from presto_tpu_torch import kernels as K
    from presto_tpu_torch import templates as TPL
    from presto_tpu_torch.exec import progcache as PC
    from presto_tpu_torch.exec.cancel import checkpoint
    from presto_tpu_torch.exec.executor import _find_match_recognize
    from presto_tpu_torch.exec.spill import partitioning_symbols
    from presto_tpu_torch.exec.varlen import find_varlen_aggregate
    from presto_tpu_torch.obs import devprof
    from presto_tpu_torch.templates import runtime as TR

    group = mesh
    on = [(d.type, d.index or 0) for d in map(
        torch.device, (group.device, engine.device))]
    if on[0] != on[1]:
        raise ValueError(f"shard group on {group.device}, engine on "
                         f"{engine.device}")
    if (find_varlen_aggregate(plan) is not None
            or _find_match_recognize(plan) is not None):
        raise NotImplementedError(
            "variable-length aggregates and MATCH_RECOGNIZE run on one "
            "device only")
    engine.last_run = run = QueryRun()
    engine.last_kernel_notes = {}
    engine.last_streamed_blocks = 0
    run.programs.append(plan)
    run.passes.append(0)
    session = engine.session
    backend = K.resolve(session, group.device)

    tpl = None
    if profile is None and TPL.enabled(session):
        tpl = TPL.parameterize(plan)
    runs, values = ((plan, []) if tpl is None
                    else (tpl.plan, [p.value for p in tpl.params]))
    scans = collect_scans(runs, engine)
    use_part = bool(session.get("use_connector_partitioning"))
    sharded = []
    for scan in scans.values():
        scan.part_cols = partitioning_symbols(
            engine.catalogs[scan.node.catalog], scan.node)
        # bucket only when an operator can use the co-location: block
        # sharding is views, bucketing a gather of every column
        scan.bucketed = (use_part and scan.part_cols is not None
                         and _plan_exploits_partitioning(runs,
                                                         scan.part_cols))
        sharded.append((scan, _shard_scan_arrays(scan, group,
                                                 scan.bucketed, engine)))
    by_node = {id(scan.node): (scan, shards) for scan, shards in sharded}
    order = preorder_index(runs)

    base_key = _distributed_key(engine, runs, sharded, group, backend)
    fpr = PC.platform_fingerprint(str(group.device), backend)
    cache = engine._program_cache
    cache.configure(session)
    known = engine._caps_memory.get(base_key)
    run.from_memory.append(known is not None)
    if known is None:  # {} is a real answer: no override needed
        known = cache.load_caps(base_key, fpr)
    capacities = dict(known)
    entry = None
    cost = None
    t0 = time.perf_counter()
    for attempt in range(MAX_ATTEMPTS):
        checkpoint()
        run.passes[0] += 1
        t_pass = time.perf_counter()
        key = (base_key, PC.bucket_capacities(capacities))
        entry = cache.lookup(key, fpr)
        if tpl is not None and attempt == 0:
            TPL.note_lookup(hit=entry is not None, params=len(tpl.params))
        # the first pass of a program whose device cost neither the
        # process nor the program's entry knows counts it (obs/devprof),
        # which the process keeps
        if attempt == 0:
            cost = first_cost(base_key, entry)
        counting = attempt == 0 and cost is None
        interp = ShardedInterpreter(by_node, capacities, group, session,
                                    order)
        # the shards share each literal's and dictionary lookup's upload
        with K.use_backend(backend), TR.active(values), \
                HS.shared_uploads(), (
                    devprof.harvest() if counting
                    else contextlib.nullcontext()) as counted:
            out = interp.run(runs)
            if out.dist == SHARDED:  # a root below Output
                out = DistTable([_gather(group, out.dts)], REPLICATED)
            oks, counts = interp.reduced()
        if counting:
            cost = counted.summary()
        # one host sync for every flag of the pass
        oks_np = HS.fetch(oks, site="dist-ok-ladder")
        log_pass(t_pass, capacities, runs)
        if oks_np.all():
            break
        if entry is not None:
            cache.discard(key, fpr)
        grow_overflowed(capacities, interp.ok_keys, oks_np,
                        interp.used_capacity, RETRY_GROWTH)
    else:
        raise HashChainOverflow("hash table capacity retry limit exceeded")
    if entry is None:
        cache.insert(key, program_meta(out.dt.cols, interp, cost), fpr)
    if capacities != known:
        cache.store_caps(base_key, capacities, fpr)
    engine._caps_memory[base_key] = dict(capacities)
    devprof.remember_cost(PC.backend_free(base_key), cost)
    run.costs.append(cost)
    engine.last_kernel_notes.update(
        {(0, pos): tags for pos, tags in interp.kernel_used.items()})
    engine.last_backend = backend
    dist_of = {pos: dist for pos, dist, _c in interp.row_counts}
    # the result, its live mask and every node's rows: one more sync
    table = fetch_table(engine, plan, Program(
        out.dt, 0, [pos for pos, _d, _c in interp.row_counts], counts,
        plan, dict(interp.kernel_used), t0, entry is not None,
        tpl is not None, cost=cost), "dist-demux")
    run_s = time.perf_counter() - t0
    engine.last_dist_meta = {
        "used_capacity": dict(interp.used_capacity),
        "nshards": group.nshards,
        "node_dist": dist_of,
        "merged_runs": list(interp.merges)}
    if profile is not None:
        profile["run_s"] = run_s
        profile["node_rows"] = {
            pos: (rows, dist_of[pos])
            for (_i, pos), rows in run.node_rows.items()}
    return table
