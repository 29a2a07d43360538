"""The TPC-DS suite through the port, rows held equal to the
reference engine's (floats within the oracle's tolerance, ROADMAP R2): presto_tpu_torch.Engine(device="cpu") over the
port's TpcdsConnector and presto_tpu.Engine over the reference's, both
at scale 0.003. The queries the reference's own tier 1 runs
(tests/test_tpcds.py: QUERIES less SLOW) run in tier 1 here; the
others, which the reference takes seconds to compile, run under
``slow``. Every query is also held against sqlite in
tests/test_torch_tpcds.py."""

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.connectors.tpcds import TpcdsConnector as RefTpcds
from presto_tpu.testing.oracle import rows_equal

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpcds import TpcdsConnector

from test_tpcds import QUERIES, SLOW

SCALE = 0.003


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel, and torch's default of one
    OpenMP thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port():
    e = TorchEngine(device="cpu")
    e.register_catalog("tpcds", TpcdsConnector(scale=SCALE))
    e.session.catalog = "tpcds"
    return e


@pytest.fixture(scope="module")
def reference():
    e = RefEngine()
    e.register_catalog("tpcds", RefTpcds(scale=SCALE))
    e.session.catalog = "tpcds"
    return e


def test_tier1_split_matches_the_reference_suite():
    assert len(set(QUERIES) - SLOW) == 27 and SLOW <= set(QUERIES)


@pytest.mark.parametrize("qname", [
    pytest.param(q, marks=pytest.mark.slow) if q in SLOW else q
    for q in sorted(QUERIES)])
def test_query_rows_equal_reference(qname, port, reference):
    # floats within the oracle's tolerance (ROADMAP R2): the reference's
    # window averages over decimals differ from the port's in the last
    # bit (q47, q57), where sqlite agrees with the port; every other
    # value compares exactly
    sql = QUERIES[qname]
    ok, msg = rows_equal(port.execute(sql), reference.execute(sql),
                         ordered="order by" in sql.lower())
    assert ok, msg
