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
agg_max,        warp / shared-memory / atomic        ``scatter_reduce_``
agg_min         segment max and min                  onto the identity
                (kernels/segagg.py)
compact         count, scan, stable scatter          cumsum positions +
                (kernels/compact.py)                 ``index_copy_``
==============  ===================================  ====================

Selection is the ``kernel_backend`` session property:

- ``auto`` (default): ``cuda`` on a CUDA engine, ``torch`` on a CPU one;
- ``cuda``: the kernels. A wrapper takes the plain version only when
  the tensors it is given lie on the CPU; on CUDA tensors it launches
  its kernel or raises;
- ``torch``: the plain versions, on whatever device the engine runs.

Every execution notes ``backend:kernel`` against the plan node being
run, so a query shows which path ran.
"""

from __future__ import annotations

import contextlib
import contextvars

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
    "multijoin": {"cuda": _multijoin.multijoin_cuda,
                  "torch": _multijoin.multijoin_torch},
}


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


def dispatch(name: str):
    """The active backend's implementation of kernel ``name``. The
    implementations note themselves, for the path that actually ran."""
    return KERNELS[name][_ACTIVE.get()]


def note(tag: str) -> None:
    """Record one kernel execution (``backend:kernel``) against the
    collecting plan node. No-op outside a collection scope."""
    used = _USED.get()
    if used is not None and tag not in used:
        used.append(tag)
