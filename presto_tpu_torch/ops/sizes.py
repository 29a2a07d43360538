"""Power-of-two sizing, the host half of the hash layer.

The planner, the cost model and the executor size every hash table and
output buffer to a power of two. This module keeps that rule apart
from the tensor code in :mod:`presto_tpu_torch.ops.hash`, so the plan
layer imports no device module.
"""

from __future__ import annotations


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()
