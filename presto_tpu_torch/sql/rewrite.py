"""Statement rewrites: SHOW/DESCRIBE desugar into plain SELECTs.

Analog of the reference's pre-analysis AST rewrites
(sql/rewrite/StatementRewrite.java + ShowQueriesRewrite.java): SHOW
TABLES / SHOW COLUMNS become queries over the information_schema
catalog, so they flow through the normal plan/execute path (and
benefit from every engine feature — WHERE, LIMIT inherited from the
protocol layer, access control on the metadata tables).
"""

from __future__ import annotations

from presto_tpu_torch.sql import ast as A
from presto_tpu_torch.sql.parser import parse_statement


def rewrite_statement(stmt: A.Statement, engine) -> A.Statement:
    """Returns the rewritten statement (possibly unchanged)."""
    if isinstance(stmt, A.ShowTables):
        catalog = stmt.catalog or engine.session.catalog
        return parse_statement(
            "select table_name as \"Table\" "
            "from information_schema.tables "
            f"where table_catalog = '{_q(catalog)}' "
            "order by table_name")
    if isinstance(stmt, A.ShowColumns):
        parts = stmt.table
        if len(parts) == 1:
            catalog, table = engine.session.catalog, parts[0]
        else:
            catalog, table = parts[0], parts[-1]
        return parse_statement(
            "select column_name as \"Column\", data_type as \"Type\" "
            "from information_schema.columns "
            f"where table_catalog = '{_q(catalog)}' "
            f"and table_name = '{_q(table)}' "
            "order by ordinal_position")
    return stmt


def _q(s: str) -> str:
    return s.replace("'", "''")
