"""Bounded, token-paged, acknowledged task output buffers.

The multi-host data plane's producer side. The reference streams task
results as paged HTTP GETs with continuation tokens, acknowledges
delivered pages implicitly via the next request's token, and bounds
producer memory so a fast stage blocks instead of buffering an unbounded
intermediate (server/TaskResource.java:261-336 result paging,
operator/HttpPageBufferClient.java:321-411 token/ack client,
ExchangeClientConfig.java:45 buffer sizing). This engine produces a
fragment's whole output in one device program, so the bound applies at
the chunking stage: the producer slices its result into pages and
``add`` BLOCKS while unacknowledged bytes exceed the capacity — the
array-execution analog of a full OutputBuffer parking its producer.

Consumers poll ``page(partition, token)``: token T acknowledges every
page below T (freeing their bytes and unblocking the producer), and the
call long-polls briefly when the next page has not been produced yet, so
a downstream stage scheduled before its input exists simply waits on
the data plane instead of needing scheduler-level sequencing.
"""

from __future__ import annotations

import threading


class TaskFailed(RuntimeError):
    pass


class OutputBuffer:
    """One task's paged output across its partitions."""

    def __init__(self, nparts: int, capacity_bytes: int,
                 readers: int = 1, spool=None):
        """``readers``: consumers that will independently read EACH
        partition (broadcast build sides are read by every downstream
        task). A page's bytes free only once every reader's token has
        passed it — one consumer's acknowledgement must never drop a
        page another consumer has not fetched.

        ``spool``: optional ft.spool.SpoolWriter; every page is also
        persisted (before entering the in-memory buffer, so the
        durable copy exists even if the producer dies mid-add) and the
        completion/abort markers track the buffer lifecycle. The spool
        then serves pages this buffer has already freed — see the
        released-page contract on :meth:`page`."""
        self.nparts = nparts
        self.readers = max(1, int(readers))
        self.capacity = max(1, int(capacity_bytes))
        self.spool = spool
        self._pages: list[list[bytes | None]] = [[] for _ in
                                                 range(nparts)]
        # per (partition, reader) acknowledged-token position
        self._acked: list[list[int]] = [
            [0] * self.readers for _ in range(nparts)]
        self._freed: list[int] = [0] * nparts
        self._pending = 0  # unacknowledged bytes across partitions
        self._complete = False
        self._failed: str | None = None
        self._rows = [0] * nparts
        self._cv = threading.Condition()

    # -- producer side ---------------------------------------------------

    # a producer blocked this long with NO consumer progress aborts:
    # an orphaned query (coordinator death, missed DELETE) must not pin
    # its pages and thread forever (the reference's client-timeout
    # abort on OutputBuffer destinations)
    IDLE_ABORT_S = 300.0

    def add(self, partition: int, blob: bytes, rows: int) -> None:
        """Append one page; blocks while the buffer is over capacity
        (backpressure). Raises TaskFailed if the buffer was aborted or
        no consumer made progress for IDLE_ABORT_S."""
        # per-task page accounting (obs/qstats.py): the producer
        # thread IS the task thread, so the ambient recorder
        # attributes emitted (and spooled) pages — split by wire
        # codec — to this task
        from presto_tpu_torch.obs import qstats as QS
        from presto_tpu_torch.parallel.wire import payload_codec
        QS.note_emitted_page(len(blob), spooled=self.spool is not None,
                             codec=payload_codec(blob))
        if self.spool is not None:
            # durable copy first: a producer dying between spool and
            # buffer leaves a retryable page, never a phantom one.
            # The spool re-frames (not re-encodes) the same blob into
            # its mmap-servable Arrow-file form — the page's values
            # are serialized exactly once, here by the producer.
            self.spool.write(partition, blob)
        with self._cv:
            idle = 0.0
            while (self._pending + len(blob) > self.capacity
                   and self._pending > 0 and self._failed is None):
                before = self._pending
                self._cv.wait(timeout=1.0)
                if self._pending < before:
                    idle = 0.0
                else:
                    idle += 1.0
                    if idle >= self.IDLE_ABORT_S:
                        self._failed = ("consumer idle timeout: no "
                                        "page acknowledged for "
                                        f"{self.IDLE_ABORT_S:.0f}s")
                        self._cv.notify_all()
                        break
            if self._failed is not None:
                raise TaskFailed(self._failed)
            self._pages[partition].append(blob)
            self._rows[partition] += rows
            self._pending += len(blob)
            self._cv.notify_all()

    def set_complete(self) -> None:
        with self._cv:
            self._complete = True
            rows = list(self._rows)
            self._cv.notify_all()
        if self.spool is not None:
            self.spool.complete(rows)

    def fail(self, message: str) -> None:
        with self._cv:
            self._failed = message[:500]
            self._complete = True
            self._cv.notify_all()
        if self.spool is not None:
            # a failed attempt's pages must never feed a consumer
            self.spool.abort()

    # -- consumer side ---------------------------------------------------

    def page(self, partition: int, token: int, reader: int = 0,
             poll_s: float = 10.0):
        """(blob | None, next_token, complete): the page at ``token``
        for ``reader``, acknowledging its pages below the token (a page
        frees once EVERY reader acked past it). Long-polls up to
        ``poll_s`` when the page is not produced yet; (None, token,
        False) means retry, (None, token, True) means drained.

        A request BELOW the freed watermark (a retried consumer
        re-reading from token 0 after its first attempt acked pages
        away) raises TaskFailed instead of silently serving the None
        holes — the caller must fall back to the spool or re-run the
        producer, never drop rows."""
        reader = min(max(reader, 0), self.readers - 1)
        with self._cv:
            if self._failed is not None:
                raise TaskFailed(self._failed)
            if token < self._freed[partition]:
                raise TaskFailed(
                    f"page {token} of partition {partition} was "
                    "already acknowledged and released (retried "
                    "consumer must re-fetch from the spool)")
            pages = self._pages[partition]
            acked = self._acked[partition]
            if token > acked[reader]:
                acked[reader] = min(token, len(pages))
                low = min(acked)
                for i in range(self._freed[partition], low):
                    blob = pages[i]
                    if blob is not None:
                        self._pending -= len(blob)
                        pages[i] = None
                self._freed[partition] = max(self._freed[partition],
                                             low)
                self._cv.notify_all()
            deadline = poll_s
            while token >= len(pages) and not self._complete \
                    and self._failed is None and deadline > 0:
                self._cv.wait(timeout=0.05)
                deadline -= 0.05
            if self._failed is not None:
                raise TaskFailed(self._failed)
            if token < len(pages):
                return pages[token], token + 1, False
            return None, token, self._complete

    # -- lifecycle -------------------------------------------------------

    @property
    def complete(self) -> bool:
        with self._cv:
            return self._complete

    @property
    def pending_bytes(self) -> int:
        with self._cv:
            return self._pending

    def rows(self) -> list[int]:
        with self._cv:
            return list(self._rows)
