"""Hand-built TPC-H plans (handq.py)."""

from presto_tpu_torch.benchmarks.handq import q1_plan, q6_plan  # noqa: F401
