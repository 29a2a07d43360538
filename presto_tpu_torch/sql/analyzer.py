"""Statement analysis entry point.

The reference splits analysis (sql/analyzer/StatementAnalyzer.java — name
resolution, type derivation, semantic checks recorded into an Analysis
side table) from planning. Here resolution and typing happen inside the
planner's scope machinery (plan/planner.py), so Analyzer is the thin
statement-level front: it classifies the statement, applies
SHOW/DESCRIBE-style rewrites (reference sql/rewrite/ShowQueriesRewrite.java)
and records session-level context.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch.sql import ast as A


class AnalysisError(Exception):
    pass


@dataclasses.dataclass
class Analysis:
    statement: A.Statement
    # filled by the planner as it resolves
    is_explain: bool = False
    explain_analyze: bool = False


class Analyzer:
    def __init__(self, engine):
        self.engine = engine

    def analyze(self, stmt: A.Statement) -> Analysis:
        analysis = Analysis(stmt)
        if isinstance(stmt, A.ExplainStatement):
            analysis.is_explain = True
            analysis.explain_analyze = stmt.analyze
            stmt = stmt.statement
        if isinstance(stmt, (A.QueryStatement, A.CreateTableAs,
                             A.InsertStatement)):
            return analysis
        if isinstance(stmt, (A.ShowTables, A.ShowColumns, A.ShowCatalogs,
                             A.ShowSession, A.SetSession, A.DropTable)):
            return analysis
        raise AnalysisError(
            f"unsupported statement: {type(stmt).__name__}")
