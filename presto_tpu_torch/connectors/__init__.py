"""Connectors: data sources pluggable under the engine.

The analog of the reference's SPI + plugin/ tree
(core/trino-spi/src/main/java/io/trino/spi/connector/Connector.java:45).
A Connector exposes schemas, row counts/stats, and materialises tables as
columnar ``Table`` objects ready for device upload.
"""

from presto_tpu_torch.connectors.base import Connector, TableStats
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.connectors.memory import MemoryConnector

__all__ = ["Connector", "TableStats", "TpchConnector", "TpcdsConnector",
           "MemoryConnector"]
