"""Engine-specific static analysis (stdlib ``ast`` only).

The port of ``presto_tpu/lint/``: the same thirteen rule families,
each guarding a place where this engine's bugs ship silently (the
reference defends the analogous seams with its PlanSanityChecker
pipeline, sql/planner/sanity/PlanSanityChecker.java). Eight are the
reference's rules with their scopes pointed at ``presto_tpu_torch/``;
five (tracer, kernels, tracekey, devicesync, retrace) are redesigned
for an eager PyTorch engine on CUDA:

- **tracer hygiene** (``lint/tracer.py``): inside functions a
  ``torch.func.vmap`` reaches (the cross-query lane pass of
  exec/batch.py, the ``register_vmap`` lane rules of kernels/lanes.py),
  Python-level inspection of a tensor — ``.item()``, ``int()``, an
  ``if`` on it, ``torch.nonzero``, boolean-mask indexing — raises on a
  batched tensor, and only on the batched path.
- **lock discipline** (``lint/locks.py``): an attribute written under
  ``with self._lock`` in one method and read bare in another is a latent
  race that only fires under load. The same lockset analysis powers
  **blocking-under-lock**: no network round-trip, plan execution, or
  device sync while holding a lock in ``server/``/``parallel/``/
  ``ft/`` — a device drain inside a coordinator lock serializes the
  whole serve path.
- **dispatch exhaustiveness** (``lint/dispatch.py``): a new ``PlanNode``
  subclass that one of the visitors (serde, printer, sanity,
  fingerprint, executor, stats) forgets fails only on the query shape
  that reaches it.
- **metric naming** (``lint/metrics.py``): registrations against the
  obs/metrics registry checked statically with the registry's own
  validator — a bad name on a rarely-hit path would otherwise only
  raise in production.
- **timeout discipline** (``lint/timeouts.py``): every
  ``urlopen``/``_urlopen`` call site must pass an explicit
  ``timeout=`` — an internal HTTP call without a deadline turns one
  dead peer into a hung thread the failure detector cannot see.
- **span discipline** (``lint/spans.py``): every ``obs.trace`` span
  must be opened via ``with`` (or ``ExitStack.enter_context``) — a
  hand-entered span leaks both an unfinished span and the ambient
  trace context on any exception before close.
- **pool discipline** (``lint/pools.py``): every ``MemoryPool.reserve``
  call site must pair with a ``free`` on all exit paths (a ``finally``
  in the same function) — a leaked reservation permanently shrinks the
  pool under exactly the load it governs.
- **field-level locksets** (``lint/races.py``): the Eraser-style
  refinement of lock discipline — every field's read/write sites must
  agree on WHICH lock guards it; written-under-A-read-under-B races
  are invisible to the boolean rule.
- **ambient-context handoff** (``lint/handoff.py``): thread-spawn
  sites in modules using ambient contextvars/thread-locals (trace
  context, cancel token, stats recorder, session override) must hand
  the state over explicitly or document why the thread is
  context-free.
- **kernel parity** (``lint/kernels.py``): every CUDA kernel is
  registered in the ``kernel_backend`` dispatch table beside its plain
  PyTorch version, with a cost formula (``COSTS``) and a lane rule
  (kernels/lanes.OPS) — an unregistered kernel is unreachable from
  the session property, invisible to parity testing, uncounted by the
  device observatory and unbatchable.
- **program-key provenance** (``lint/tracekey.py``): every ambient
  input a program's pass reads (session property, env var, mutable
  module global — tracked across aliases, parameters, and helper
  calls) must participate in the program-cache key (and so the
  capacity memory's) or carry a justified ``TRACE_KEY_EXEMPT`` entry,
  and every ``TRACE_RELEVANT_PROPERTIES`` entry must be genuinely read
  — the cache's soundness contract, machine-checked both ways.
- **device-sync boundary** (``lint/devicesync.py``): every
  host-blocking device read reachable from the execute-path roots
  (``.item()``, ``.tolist()``, ``.cpu()``, ``np.asarray`` of a CUDA
  tensor, ``int()`` of a 0-d one, ``torch.cuda.synchronize()``) must
  go through the counted ``exec/hostsync`` boundary or carry a
  justified ``DEVICE_SYNC_EXEMPT`` entry — one stray sync in a stage
  walk stalls the host until the stream drains; a host ``np.ndarray``
  or a CPU tensor is told apart and stays clean.
- **capacity-memory misses** (``lint/retrace.py``): data-dependent
  integers (``bincount().max()``, ``hostsync.fetch`` readbacks) must
  pass through ``next_pow2``/``bucket_*`` before reaching a cache-key
  component — an unbucketed value makes every query a miss that climbs
  the capacity ladder again. (Shape and branch sinks cost nothing in
  an eager engine and are not reported.)

Run ``python -m presto_tpu_torch.lint presto_tpu_torch/`` (exits
nonzero on findings; ``--changed`` scopes reporting to files changed
since HEAD for pre-commit runs; ``--sarif`` emits a SARIF 2.1.0 log
for CI diff annotation, in-source waivers exported as suppressed
results); suppress a single line with ``# lint: disable=rule-name``
plus a comment saying why. Stale suppressions — disables that no
longer suppress anything — are reported as ``stale-suppression``
findings by the runner itself.
"""

from presto_tpu_torch.lint.core import (Finding, Project, available_rules,
                                  run_lint)

# rule modules self-register on import
from presto_tpu_torch.lint import tracer as _tracer  # noqa: E402,F401
from presto_tpu_torch.lint import locks as _locks  # noqa: E402,F401
from presto_tpu_torch.lint import dispatch as _dispatch  # noqa: E402,F401
from presto_tpu_torch.lint import metrics as _metrics  # noqa: E402,F401
from presto_tpu_torch.lint import timeouts as _timeouts  # noqa: E402,F401
from presto_tpu_torch.lint import pools as _pools  # noqa: E402,F401
from presto_tpu_torch.lint import spans as _spans  # noqa: E402,F401
from presto_tpu_torch.lint import races as _races  # noqa: E402,F401
from presto_tpu_torch.lint import handoff as _handoff  # noqa: E402,F401
from presto_tpu_torch.lint import kernels as _kernels  # noqa: E402,F401
from presto_tpu_torch.lint import tracekey as _tracekey  # noqa: E402,F401
from presto_tpu_torch.lint import devicesync as _devicesync  # noqa: E402,F401
from presto_tpu_torch.lint import retrace as _retrace  # noqa: E402,F401

__all__ = ["Finding", "Project", "available_rules", "run_lint"]
