"""Test harness: sqlite oracle and assertion helpers.

Analog of the reference's testing/trino-testing H2QueryRunner
(H2QueryRunner.java:90) + QueryAssertions.java:51 — every SQL feature is
cross-checked against an independent engine running the same query on the
same data.
"""

from presto_tpu_torch.testing.oracle import SqliteOracle, assert_query

__all__ = ["SqliteOracle", "assert_query"]
