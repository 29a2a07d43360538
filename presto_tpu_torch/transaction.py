"""Transactions: session-scoped write scoping with rollback (a copy of
``presto_tpu/transaction.py``).

Analog of the reference's transaction subsystem
(transaction/InMemoryTransactionManager.java, TransactionBuilder;
SPI ConnectorTransactionHandle): START TRANSACTION / COMMIT / ROLLBACK
scope writes to the engine's mutable connectors. The engine executes
writes in place (reads inside the transaction see them — the
reference's read-committed-per-statement with a single writer
connector); ROLLBACK restores a copy-on-first-write snapshot taken the
first time each connector is touched inside the transaction.
"""

from __future__ import annotations


class TransactionError(RuntimeError):
    pass


class Transaction:
    def __init__(self):
        # connector id -> (connector, snapshot object)
        self._snapshots: dict[int, tuple[object, object]] = {}

    def touch(self, connector) -> None:
        """Snapshot a connector before its first write in this
        transaction (copy-on-first-write)."""
        key = id(connector)
        if key in self._snapshots:
            return
        snap = getattr(connector, "snapshot", None)
        if snap is None:
            raise TransactionError(
                f"connector {getattr(connector, 'name', '?')} does not "
                f"support transactions")
        self._snapshots[key] = (connector, snap())

    def rollback(self) -> None:
        for connector, snap in self._snapshots.values():
            connector.restore(snap)
        self._snapshots.clear()

    def commit(self) -> None:
        self._snapshots.clear()


class TransactionManager:
    """One active transaction per engine session (the reference scopes
    per session/query the same way for its auto-commit default)."""

    def __init__(self):
        self.current: Transaction | None = None

    def begin(self) -> None:
        if self.current is not None:
            raise TransactionError("transaction already in progress")
        self.current = Transaction()

    def commit(self) -> None:
        if self.current is None:
            raise TransactionError("no transaction in progress")
        self.current.commit()
        self.current = None

    def rollback(self) -> None:
        if self.current is None:
            raise TransactionError("no transaction in progress")
        self.current.rollback()
        self.current = None

    def touch(self, connector) -> None:
        """Called by the engine before any connector mutation."""
        if self.current is not None:
            self.current.touch(connector)
