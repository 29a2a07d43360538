"""Engine: the in-process query runner of the port.

The port of ``presto_tpu/engine.py`` for the main path: parse ->
analyze -> logical plan -> optimize -> ``exec/executor.execute_plan``,
all in one process, on one device. ``Engine()`` runs on the GPU and
raises when CUDA is not available; the CPU is used only when the
caller passes ``device="cpu"``.

Statements other than queries, EXPLAIN (without ANALYZE), SET SESSION,
SHOW CATALOGS and SHOW SESSION raise ``NotImplementedError`` in this
slice.
"""

from __future__ import annotations

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Table, _decode_column
from presto_tpu_torch.connectors.base import Connector
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES, Session


class AllowAllAccessControl:
    """Table-level authorization that allows everything."""

    def check_can_select(self, user: str, catalog: str, table: str) -> None:
        pass

    def check_can_write(self, user: str, catalog: str, table: str) -> None:
        pass


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device without CUDA raises: the
    engine never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "presto_tpu_torch.Engine runs on CUDA, and "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


class Engine:
    def __init__(self, session: Session | None = None, device=None):
        self.device = resolve_device(device)
        self.session = session or Session()
        self.catalogs: dict[str, Connector] = {}
        self.access_control = AllowAllAccessControl()
        # host array id -> (host ref, device tensor): scan columns go to
        # the device once per (table, column); the strong host ref pins
        # the id so a recycled address cannot alias
        self._dev_cache: dict[int, tuple[np.ndarray, torch.Tensor]] = {}
        self.last_warnings: list = []
        # per-node kernel notes and backend of the last query
        self.last_kernel_notes: dict = {}
        self.last_backend: str | None = None

    def register_catalog(self, name: str, connector: Connector) -> None:
        self.catalogs[name] = connector

    def device_array(self, a) -> torch.Tensor:
        """The device copy of a host scan array, uploaded once."""
        hit = self._dev_cache.get(id(a))
        if hit is not None and hit[0] is a:
            return hit[1]
        host = np.asarray(a)
        if host.dtype == object:
            raise NotImplementedError(
                "object-dtype host columns are not ported to "
                "presto_tpu_torch yet")
        if not host.flags.writeable:
            host = host.copy()
        dev = HS.upload(host, self.device, "scan-column")
        self._dev_cache[id(a)] = (a, dev)
        return dev

    # -- SQL entry points ---------------------------------------------------

    def _parse(self, sql: str):
        from presto_tpu_torch.sql.parser import parse_statement
        from presto_tpu_torch.sql.rewrite import rewrite_statement
        return rewrite_statement(parse_statement(sql), self)

    def _collecting(self, run):
        from presto_tpu_torch import warnings as W
        W.push(wc := W.WarningCollector())
        try:
            return run()
        finally:
            self.last_warnings = wc.list()
            W.pop()

    def execute(self, sql: str) -> list[tuple]:
        """Run SQL, return result rows as Python tuples."""
        from presto_tpu_torch.sql import ast as A

        def run():
            stmt = self._parse(sql)
            if isinstance(stmt, A.QueryStatement):
                return self._execute_query(stmt.query).to_pylist()
            return self._execute_statement(stmt)

        return self._collecting(run)

    def execute_table(self, sql: str) -> Table:
        """Run a SELECT, return the result as a host Table."""
        from presto_tpu_torch.sql import ast as A

        def run():
            stmt = self._parse(sql)
            if not isinstance(stmt, A.QueryStatement):
                raise ValueError("execute_table expects a SELECT query")
            return self._execute_query(stmt.query)

        return self._collecting(run)

    def plan_sql(self, sql: str):
        from presto_tpu_torch.plan.optimizer import optimize
        from presto_tpu_torch.plan.planner import LogicalPlanner
        from presto_tpu_torch.sql.analyzer import Analyzer
        from presto_tpu_torch.sql.parser import parse_statement
        stmt = parse_statement(sql)
        analysis = Analyzer(self).analyze(stmt)
        plan = LogicalPlanner(self, analysis).plan(stmt)
        return optimize(plan, self), analysis

    def explain(self, sql: str) -> str:
        from presto_tpu_torch.cost import explain_estimates
        from presto_tpu_torch.plan.printer import format_plan
        plan, _ = self.plan_sql(sql)
        return format_plan(plan, estimates=explain_estimates(plan, self))

    # -- internals ----------------------------------------------------------

    def _plan_query(self, query):
        from presto_tpu_torch.plan.optimizer import optimize
        from presto_tpu_torch.plan.planner import LogicalPlanner
        from presto_tpu_torch.plan.sanity import validate_plan
        from presto_tpu_torch.sql import ast as A
        plan = LogicalPlanner(self, None).plan(A.QueryStatement(query))
        plan = optimize(plan, self)
        validate_plan(plan)
        return plan

    def _execute_query(self, query) -> Table:
        from presto_tpu_torch.exec.executor import execute_plan
        return execute_plan(self, self._plan_query(query))

    def _execute_statement(self, stmt) -> list[tuple]:
        from presto_tpu_torch.plan.printer import format_plan
        from presto_tpu_torch.sql import ast as A

        if isinstance(stmt, A.ExplainStatement) and not stmt.analyze \
                and isinstance(stmt.statement, A.QueryStatement):
            from presto_tpu_torch.cost import explain_estimates
            plan = self._plan_query(stmt.statement.query)
            return [(format_plan(
                plan, estimates=explain_estimates(plan, self)),)]
        if isinstance(stmt, A.ShowCatalogs):
            return [(name,) for name in sorted(self.catalogs)]
        if isinstance(stmt, A.ShowSession):
            return [(name, str(self.session.get(name)), str(default),
                     typ.__name__, desc)
                    for name, (default, typ, desc) in sorted(
                        SYSTEM_SESSION_PROPERTIES.items())]
        if isinstance(stmt, A.SetSession):
            self.session.set(stmt.name, _literal_value(stmt.value))
            return []
        raise NotImplementedError(
            f"statement {type(stmt).__name__} is not ported to "
            "presto_tpu_torch yet")


def _literal_value(e):
    from presto_tpu_torch.sql import ast as A

    if isinstance(e, A.StringLiteral):
        return e.value
    if isinstance(e, A.NumericLiteral):
        return float(e.text) if "." in e.text else int(e.text)
    if isinstance(e, A.BooleanLiteral):
        return e.value
    if isinstance(e, A.Identifier):
        return e.name
    raise ValueError("SET SESSION value must be a literal")


def _table_to_host(table: Table):
    """Result Table -> (schema, host column arrays, validity masks) of
    its live rows. VARCHAR decodes to strings; other types keep their
    physical values (decimals stay scaled)."""
    schema: dict[str, T.DataType] = {}
    data: dict[str, np.ndarray] = {}
    valid: dict[str, np.ndarray | None] = {}
    mask = (np.ones(table.nrows, dtype=bool) if table.mask is None
            else np.asarray(table.mask))
    for name, col in table.columns.items():
        raw = np.asarray(col.data)[mask]
        schema[name] = col.dtype
        data[name] = (_decode_column(col.dtype, raw, col.dictionary)
                      if isinstance(col.dtype, T.VarcharType) else raw)
        valid[name] = None if col.valid is None \
            else np.asarray(col.valid)[mask]
    return schema, data, valid
