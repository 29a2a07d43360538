"""SQL frontend: lexer, parser, AST, analyzer.

The analog of the reference's core/trino-parser (ANTLR4 grammar
SqlBase.g4 + AstBuilder) and core/trino-main sql/analyzer. Hand-written
recursive descent instead of a parser generator: the grammar subset is
the TPC-H/TPC-DS query language (SELECT with joins, subqueries, grouping
sets, window functions, WITH, set operations) plus the session/DDL
statements the engine supports.
"""
