"""presto_tpu_torch — the SQL engine on PyTorch and CUDA.

The same engine as ``presto_tpu`` (SQL in, rows out, through the same
parser, planner, cost model and operators), with its device layer in
PyTorch: columns are tensors on one ``device``, and each hand-written
TPU kernel of the main path is a hand-written CUDA kernel for Hopper
(``kernels/csrc``), with a plain PyTorch version beside it.

``Engine()`` runs on the GPU and raises when CUDA is not available;
``Engine(device="cpu")`` runs the plain versions on the CPU.
"""

from presto_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    VARCHAR,
    DecimalType,
    DataType,
)
from presto_tpu_torch.block import Column, Table
from presto_tpu_torch.session import Session
from presto_tpu_torch.engine import Engine

__all__ = [
    "BIGINT",
    "BOOLEAN",
    "DATE",
    "DOUBLE",
    "INTEGER",
    "VARCHAR",
    "Column",
    "DataType",
    "DecimalType",
    "Engine",
    "Session",
    "Table",
]
