"""Hand-written CUDA kernels for the operator inner loops, and their
plain PyTorch versions.

The port of ``presto_tpu/kernels/__init__.py``. Each Pallas kernel of
the reference is a CUDA C++ kernel for Hopper here
(``csrc/*.cu``, built with nvcc at first use, kernels/build.py):

==============  ===================================  ====================
kernel          CUDA kernel                          plain PyTorch version
==============  ===================================  ====================
join_lookup     open-addressing build + probe        sorted-merge lookup
                (kernels/hashjoin.py)                (ops/hash.probe_runs)
multijoin       fused star-chain probe walk          the inline walk of
                (kernels/multijoin.py)               apply_multi_join
agg_sum         shared-memory / atomic segment sum   ``index_add_`` on int64
                (kernels/segagg.py)
agg_max,        register / lane-column / shared /    ``scatter_reduce_``
agg_min         global segment max and min, each     onto the identity
                atomic behind a read
                (kernels/segagg.py)
compact         single-pass look-back scan, then     cumsum positions +
                staged, coalesced row copies         ``index_copy_``
                (kernels/compact.py)
==============  ===================================  ====================

Selection is the ``kernel_backend`` session property:

- ``auto`` (default): ``cuda`` on a CUDA engine, ``torch`` on a CPU one;
- ``cuda``: the kernels. A wrapper takes the plain version only when
  the tensors it is given lie on the CPU; on CUDA tensors it launches
  its kernel or raises;
- ``torch``: the plain versions, on whatever device the engine runs.

Every execution notes ``backend:kernel`` against the plan node being
run, so a query shows which path ran.

Under ``torch.func.vmap`` (a cross-query batch, exec/batch.py) an
entry runs its lane rule (kernels/lanes.py): one call of the kernel,
or of its plain version, for all lanes.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

from presto_tpu_torch.kernels import compact as _compact
from presto_tpu_torch.kernels import hashjoin as _hashjoin
from presto_tpu_torch.kernels import multijoin as _multijoin
from presto_tpu_torch.kernels import segagg as _segagg

BACKENDS = ("auto", "cuda", "torch")

_ACTIVE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "presto_tpu_torch_kernel_backend", default="torch")
_USED: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "presto_tpu_torch_kernel_used", default=None)


# kernel name -> backend -> implementation
KERNELS: dict[str, dict[str, object]] = {
    "join_lookup": {"cuda": _hashjoin.lookup_join_cuda,
                    "torch": _hashjoin.lookup_join_torch},
    "agg_sum": {"cuda": _segagg.segment_sum_cuda,
                "torch": _segagg.segment_sum_torch},
    "agg_max": {"cuda": _segagg.segment_max_cuda,
                "torch": _segagg.segment_max_torch},
    "agg_min": {"cuda": _segagg.segment_min_cuda,
                "torch": _segagg.segment_min_torch},
    "compact": {"cuda": _compact.filter_compact_cuda,
                "torch": _compact.filter_compact_torch},
    "multijoin": {"cuda": _multijoin.walk_cuda,
                  "torch": _multijoin.walk_torch},
}


# a hash table's slot: key hash, build row and pad (csrc/common.cuh)
SLOT_BYTES = 16


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _segment_cost(data, segment_ids, num_segments: int):
    # each value and id read once, one slot per segment written
    width = data.numel() // max(data.shape[0], 1) if data.ndim > 1 else 1
    return (data.numel(),
            _nbytes(data, segment_ids) + int(num_segments) * 8 * width)


def _join_cost(build_hash, build_live, probe_hash, probe_live,
               capacity: int, max_probes: int = 0):
    # the build writes its table and the probe reads it; each probe row
    # writes its build row and found flag
    slots = _hashjoin.table_capacity(capacity)
    nb, np_ = build_hash.shape[0], probe_hash.shape[0]
    return (8 * (nb + np_),
            _nbytes(build_hash, build_live, probe_hash, probe_live)
            + 2 * slots * SLOT_BYTES + np_ * 5)


def _walk_cost(spine_live, walk, growth: int = 1, max_probes: int = 0):
    # each step builds its table and the spine probes it: hash columns
    # read once, the live mask and one int32 gather per step written
    n = spine_live.shape[0]
    steps = len(walk.build_live)
    slots = sum(2 * _hashjoin.table_capacity(2 * max(b.shape[0], 1))
                * SLOT_BYTES for b in walk.build_live)
    built = sum(b.shape[0] for b in walk.build_live)
    return (8 * (n * steps + built),
            _nbytes(spine_live, *walk.build_live, *walk.build_hash,
                    *walk.key_hash, *walk.key_valid)
            + slots + n * (1 + 4 * steps))


def _compact_cost(live, arrays: dict, capacity: int):
    # the mask read, at most ``capacity`` live rows read and the
    # capacity's rows written
    row = sum(a.element_size() * (a[0].numel() if a.ndim > 1 else 1)
              for a in arrays.values())
    return live.numel(), live.numel() + 2 * int(capacity) * row


# kernel name -> (its arguments -> (operations, bytes)): what
# obs/devprof counts for one call under a harvest, whichever backend runs
COSTS = {"agg_sum": _segment_cost, "agg_max": _segment_cost,
         "agg_min": _segment_cost, "join_lookup": _join_cost,
         "multijoin": _walk_cost, "compact": _compact_cost}


def run(name: str, backend: str, *args):
    """Call kernel ``name`` on ``backend``. Under a cost harvest
    (obs/devprof.harvest) the call counts by its ``COSTS`` formula, and
    the torch operations inside it count nothing."""
    from presto_tpu_torch.obs import devprof
    if not devprof.harvesting():
        return KERNELS[name][backend](*args)
    with devprof.count_kernel(*COSTS[name](*args)):
        return KERNELS[name][backend](*args)


def resolve(session, device) -> str:
    """The session's ``kernel_backend`` for an engine on ``device``."""
    value = str(session.get("kernel_backend") or "auto").lower()
    if value == "auto":
        return "cuda" if str(device).startswith("cuda") else "torch"
    if value not in ("cuda", "torch"):
        raise ValueError(
            f"kernel_backend must be one of {BACKENDS}, got {value!r}")
    return value


@contextlib.contextmanager
def use_backend(backend: str):
    """Install the resolved backend for one plan run."""
    tok = _ACTIVE.set(backend)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


@contextlib.contextmanager
def collect():
    """Collect the kernel notes of one plan node's run (nested nodes
    re-enter, so notes land on the nearest enclosing node)."""
    used: list[str] = []
    tok = _USED.set(used)
    try:
        yield used
    finally:
        _USED.reset(tok)


def dispatch(name: str, backend: str | None = None):
    """The entry of kernel ``name`` on ``backend`` (default the active
    one). Called on tensors that a vmap batches, it runs the kernel's
    lane rule (kernels/lanes.py); else the implementation itself. The
    implementations note themselves, for the path that actually ran."""
    backend = backend or _ACTIVE.get()

    def entry(*args):
        if _batched(args):
            # imported here: defining the custom ops imports much of
            # torch, which the serial route never needs
            from presto_tpu_torch.kernels import lanes
            return lanes.OPS[name](*args, backend=backend)
        return run(name, backend, *args)

    return entry


def _batched(args) -> bool:
    """Does any tensor in ``args`` (nested in lists, tuples, dicts and
    Vals) carry a vmap batch dimension?"""
    is_batched = torch._C._functorch.is_batchedtensor
    stack = list(args)
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            if is_batched(a):
                return True
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
        elif isinstance(a, dict):
            stack.extend(a.values())
        elif dataclasses.is_dataclass(a) and not isinstance(a, type):
            stack.extend(vars(a).values())
    return False


def note(tag: str) -> None:
    """Record one kernel execution (``backend:kernel``) against the
    collecting plan node. No-op outside a collection scope."""
    used = _USED.get()
    if used is not None and tag not in used:
        used.append(tag)
