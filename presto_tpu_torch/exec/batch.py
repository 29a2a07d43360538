"""Cross-query batched execution: one interpreter pass under
``torch.func.vmap`` for many parameter vectors of one plan template.

The port of ``presto_tpu/exec/batch.py``. Serving traffic is dominated
by literal variants of a few query shapes, and a plan template
(templates/) shares one plan across them. K concurrent queries on one
template fingerprint stack their bound parameter vectors along a new
leading axis, and the interpreter walks the template's plan ONCE under
``torch.func.vmap``: the scan columns are not batched (uploaded once),
the parameters are mapped, and every operator runs over all K lanes.
Under the vmap a parameter compiles to its lane's physical value as a
device tensor (expr/compile.py ``_c_parameter``; a VARCHAR parameter is
its code in a dictionary of the batch's values), and each kernel entry
runs its lane rule (kernels/lanes.py), one launch for all lanes, as
each Pallas kernel of the reference runs under JAX's batching rule.
Per-query slices demux into host Tables equal to serial execution.

The batched program keeps its own capacity memory and program-cache
lineage: the serial key grows a ``("batch", K)`` component, with the
same capacity ladder on top. The ok flags come back as one (K, k)
array and reduce over the lanes into ``grow_overflowed``: a table that
overflowed in ANY lane grows for the whole batch.

Batch widths are padded to powers of two, as in the reference: a group
of 3 pads its parameter stacks to 4 by repeating the last member's
binding, and only the first 3 lanes demux. (The reference pads so that
the number of compiled programs stays log-bounded; here it keeps the
capacity memory's keys few, and the folded kernel shapes the same for
jittering group sizes.)

Eligibility (:func:`batchable`) is the reference's: the plain single
program path only. Plans that would stream, spill, run grouped,
segment, carry MATCH_RECOGNIZE or aggregate varlen arrays run
serially.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from presto_tpu_torch.block import Table
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.obs.trace import TRACER
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch import types as T

_BATCHED = REGISTRY.counter(
    "presto_tpu_batched_queries_total",
    "queries executed through a cross-query vmapped batch dispatch")
_BATCH_SIZE = REGISTRY.histogram(
    "presto_tpu_batch_size_queries",
    "queries per cross-query batched device dispatch",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))

# the batch retry ladder mirrors prepare_plan's
_MAX_ATTEMPTS = 6


def batchable(engine, plan: N.PlanNode) -> bool:
    """Can ``plan`` take the plain single-program execute path? Only
    then may the serving layer batch it (the gates mirror
    exec.executor.execute_part's routes, checked cheaply: any doubt
    answers False and serial execution keeps its own gating)."""
    from presto_tpu_torch.exec.executor import (_find_match_recognize,
                                                _find_split)
    from presto_tpu_torch.exec.varlen import find_varlen_aggregate
    sess = engine.session
    if _find_match_recognize(plan) is not None:
        return False
    if find_varlen_aggregate(plan) is not None:
        return False
    if bool(sess.get("grouped_execution")):
        return False
    if int(sess.get("query_max_memory_bytes") or 0):
        return False  # could spill: the budget path owns it
    if _find_split(plan, engine) is not None:
        return False  # segmented: no single program to vmap
    block = int(sess.get("scan_block_rows") or 0)
    if block > 0 and _largest_scan_estimate(engine, plan) > block:
        return False  # could block-stream: the serial path decides
    return True


def _largest_scan_estimate(engine, plan: N.PlanNode) -> int:
    if isinstance(plan, N.TableScan):
        conn = engine.catalogs.get(plan.catalog)
        if conn is None:
            return 0
        try:
            return int(conn.row_count_estimate(plan.table))
        except Exception:  # noqa: BLE001 - unknown estimate = 0
            return 0
    return max((_largest_scan_estimate(engine, s)
                for s in plan.sources()), default=0)


def run_plan_batched(engine, templates: list) -> list[Table]:
    """Run K literal variants of one plan template as one vmapped
    interpreter pass; one host Table per variant, in input order.
    ``templates`` are templates/analysis.Template objects sharing one
    fingerprint, each with its own parameter values; each hoists at
    least one parameter. The scans' bytes are reserved in the engine's
    memory pool for the batch.

    Raises on any failure: the serving layer then runs each member
    serially."""
    from presto_tpu_torch.exec import executor as EX

    k = len(templates)
    plan = templates[0].plan
    if k < 2 or not templates[0].params:
        raise ValueError("batch needs >= 2 queries and >= 1 parameter")
    scans = EX.collect_scans(plan, engine)
    with EX.pool_tag(engine, "batch-") as tag:
        EX.reserve(engine, tag, EX.input_tensors(scans))
        return _run_batched(engine, templates, plan, scans)


def _run_batched(engine, templates: list, plan, scans) -> list[Table]:
    from presto_tpu_torch import kernels as K
    from presto_tpu_torch.exec import executor as EX
    from presto_tpu_torch.exec import progcache as PC
    from presto_tpu_torch.exec.cancel import checkpoint
    from presto_tpu_torch.obs import devprof
    from presto_tpu_torch.ops.hash import HashChainOverflow, grow_overflowed
    from presto_tpu_torch.templates import runtime as TR

    k = len(templates)
    backend = K.resolve(engine.session, engine.device)
    cache = engine._program_cache
    cache.configure(engine.session)
    # pad the batch width to the next power of two (module docstring):
    # padding lanes repeat the last member's binding, dropped at demux
    kp = 1 << (k - 1).bit_length()
    base_key = (EX._cache_key(engine, plan, scans, backend)
                + (("batch", kp),))
    fpr = PC.platform_fingerprint(str(engine.device), backend)
    known = engine._caps_memory.get(base_key)
    from_memory = known is not None
    if known is None:  # the persistent store's vector, or {}
        known = cache.load_caps(base_key, fpr)
    capacities = dict(known)
    dictionaries = _dictionaries(templates)
    params = [HS.upload(a, engine.device, "batch-params")
              for a in _stack_params(_pad(
                  [t.bind(dictionaries) for t in templates], kp),
                  templates[0].example_args())]
    order = EX.preorder_index(plan)
    EX.start_run(engine)
    run = engine.last_run
    run.programs.append(plan)
    run.passes.append(0)
    run.from_memory.append(from_memory)

    cost = None
    for attempt in range(_MAX_ATTEMPTS):
        checkpoint()
        run.passes[0] += 1
        t_pass = time.perf_counter()
        key = (base_key, PC.bucket_capacities(capacities))
        entry = cache.lookup(key, fpr)
        # the batch's first pass counts its device cost (obs/devprof:
        # the physical operations under the vmap) unless the process
        # or the batched program's entry knows it
        if attempt == 0:
            cost = EX.first_cost(base_key, entry)
        counting = attempt == 0 and cost is None
        seen: dict = {}

        def lane_pass(*values):
            # one lane's pass; vmap runs it once for all lanes
            interp = EX.PlanInterpreter(scans, capacities, engine.session,
                                        engine.device, order)
            interp.collect_rows = False
            with K.use_backend(backend), TR.active(list(values),
                                                   dictionaries):
                out = interp.run(plan)
            parts, slots = _flatten_outputs(out)
            seen.update(interp=interp, cols=dict(out.cols), slots=slots)
            oks = (torch.stack([o.reshape(()) for o in interp.ok_flags])
                   if interp.ok_flags else
                   torch.ones(0, dtype=torch.bool, device=engine.device))
            return out.live_mask(), parts, oks

        with TRACER.span("execute", cache_hit=entry is not None,
                         batch=kp), (devprof.harvest() if counting
                                     else contextlib.nullcontext()) as counted:
            live, parts, oks = torch.func.vmap(
                lane_pass, randomness="error")(*params)
        if counting:
            cost = counted.summary()
        interp = seen["interp"]
        oks_all = np.ones(0, dtype=bool)
        if oks.shape[-1]:
            # (K, k) ok flags: a table that overflowed in ANY lane
            # grows for the whole batch
            oks_all = np.asarray(HS.fetch(oks, site="batch-ok-ladder")
                                 ).all(axis=0)
        EX.log_pass(t_pass, capacities, plan)
        if oks_all.all():
            if entry is None:
                cache.insert(key, EX.program_meta(seen["cols"], interp,
                                                  cost), fpr)
            if capacities != known:
                cache.store_caps(base_key, capacities, fpr)
            engine._caps_memory[base_key] = dict(capacities)
            devprof.remember_cost(PC.backend_free(base_key), cost)
            run.costs.append(cost)
            engine.last_kernel_notes.update(
                {(0, pos): tags for pos, tags in interp.kernel_used.items()})
            engine.last_backend = backend
            _BATCHED.inc(k)
            _BATCH_SIZE.observe(float(k))
            return _demux(plan, seen["cols"], seen["slots"], live, parts, k)
        if entry is not None:
            cache.discard(key, fpr)
        grow_overflowed(capacities, interp.ok_keys, oks_all,
                        interp.used_capacity, EX.RETRY_GROWTH)
    raise HashChainOverflow(
        "batched hash table capacity retry limit exceeded")


def _dictionaries(templates: list) -> dict:
    """Per VARCHAR parameter, the sorted dictionary of the batch's
    values: each lane's physical value is its code there, and the
    compiled comparison aligns that dictionary with the column's, as it
    aligns a literal's."""
    out = {}
    for i, spec in enumerate(templates[0].params):
        if isinstance(spec.dtype, T.VarcharType):
            out[i] = np.array(sorted({str(t.params[i].value)
                                      for t in templates}), dtype=object)
    return out


def _pad(binds: list, kp: int) -> list:
    """Fill the padded batch's extra lanes with the last member's
    binding (their results are dropped at demux)."""
    return binds + [binds[-1]] * (kp - len(binds))


def _stack_params(binds: list[list], example: list) -> list[np.ndarray]:
    """Position-wise stack of the lanes' physical parameter vectors:
    the j-th parameter becomes a (K, ...) array mapped by the vmap's
    leading axis. Every lane's value has the shape and dtype of the
    template's ``example`` value (a lane that would widen the stack
    raises)."""
    out = []
    for j, want in enumerate(np.asarray(e) for e in example):
        lanes = [np.asarray(b[j]) for b in binds]
        if any(v.shape != want.shape or v.dtype != want.dtype
               for v in lanes):
            raise ValueError(f"parameter {j}: the lanes' values differ "
                             "from the template's shape or dtype")
        out.append(np.stack(lanes))
    return out


def _flatten_outputs(out) -> tuple[list, list]:
    """A pass's output columns as a flat tensor list (a vmap returns
    tensors only) and, per column, the positions of its [data, valid]
    (an ARRAY's lengths and element mask after), None where absent."""
    parts: list = []
    slots: list = []
    for v in out.cols.values():
        col = [v.data, v.valid] + ([v.lengths, v.elem_mask()]
                                   if v.is_array else [])
        pos = []
        for t in col:
            pos.append(None if t is None else len(parts))
            if t is not None:
                parts.append(t)
        slots.append(pos)
    return parts, slots


def _demux(plan: N.PlanNode, cols: dict, slots: list, live, parts,
           k: int) -> list[Table]:
    """Per-lane host Tables from one batched pass's outputs, fetched in
    one host sync: lane i of every (K, ...) output is what the serial
    program gives query i (exec.executor.host_table)."""
    from presto_tpu_torch.exec.executor import host_table

    live_np, parts_np = HS.fetch((live, parts), site="batch-demux")
    tables = []
    for lane in range(k):
        res = [[None if p is None else parts_np[p][lane] for p in pos]
               for pos in slots]
        tables.append(host_table(plan, cols, live_np[lane], res))
    return tables
