"""Fault-tolerant distributed execution (the Trino FTE analog).

Three pieces, threaded through the coordinator, worker, exchange, and
server layers:

- **retry discipline** (``ft/retry.py``): session ``retry_policy`` in
  {NONE, QUERY, TASK}; bounded attempts with exponential backoff +
  full jitter and a per-query deadline budget; one
  :func:`retrying_call` helper classifying transient vs application
  failures for every internal HTTP call.
- **spooled exchange** (``ft/spool.py``): buffered task output pages
  persisted worker-locally (atomic tmp+rename) and served through the
  existing exchange endpoints, so a TASK retry re-fetches a dead
  producer's pages instead of aborting the query.
- **deterministic fault injection** (``ft/faults.py``): named fault
  points armed via ``PRESTO_TPU_FAULTS`` or :func:`FAULTS.arm`,
  hash-seeded so chaos tests reproduce exactly.
"""

from presto_tpu_torch.ft.faults import (FAULT_POINTS, FAULTS, FaultRegistry,
                                  InjectedFault)
from presto_tpu_torch.ft.retry import (RETRY_POLICIES, BackoffPolicy,
                                 Deadline, DeadlineExceeded,
                                 ExchangeFetchError,
                                 backoff_from_session, is_transient,
                                 parse_exchange_failure, retrying_call)
from presto_tpu_torch.ft.spool import SpoolWriter, TaskSpool

__all__ = [
    "FAULT_POINTS", "FAULTS", "FaultRegistry", "InjectedFault",
    "RETRY_POLICIES", "BackoffPolicy", "Deadline", "DeadlineExceeded",
    "ExchangeFetchError", "backoff_from_session", "is_transient",
    "parse_exchange_failure", "retrying_call", "SpoolWriter",
    "TaskSpool",
]
