"""The TPC-DS suite through the port: every query of
tests/test_tpcds.py through presto_tpu_torch.Engine(device="cpu") over
the port's own TpcdsConnector at scale 0.003, held against the sqlite
oracle (the reference suite's oracle, with its q36 rewrite).

The oracle loads the REFERENCE's connector over the same (scale, seed):
``SqliteOracle.load_connector`` decodes dictionaries and unscales
decimals by the reference's own type classes, so the port's connector
would load as raw codes and scaled integers. The two connectors make
identical data (tests/test_torch_tpcds_data.py). The rows against the
reference engine are in tests/test_torch_tpcds_reference.py."""

import pytest
import torch

from presto_tpu.connectors.tpcds import TpcdsConnector as RefTpcds
from presto_tpu.testing.oracle import SqliteOracle, assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpcds import TpcdsConnector

from test_tpcds import QUERIES, _sqlite_override

SCALE = 0.003  # as tests/test_tpcds.py


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
def ds_oracle():
    o = SqliteOracle()
    o.load_connector(RefTpcds(scale=SCALE))
    return o


def _notes(e) -> set[str]:
    return {t for tags in e.last_kernel_notes.values() for t in tags}


def test_suite_has_101_queries():
    assert len(QUERIES) == 101


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_query_rows_equal_oracle(qname, port, ds_oracle):
    assert_query(port, ds_oracle, QUERIES[qname],
                 sqlite_sql=_sqlite_override(qname))


@pytest.mark.parametrize("qname,kernel", [
    ("q42", "torch:join_lookup"),  # a star join on item's surrogate key
    ("q07", "torch:multijoin"),    # the fused 4-way demographics star
    ("q96", "torch:agg_sum"),      # a global count over the star
])
def test_star_joins_reach_the_kernel_entries(qname, kernel, port):
    port.execute(QUERIES[qname])
    assert kernel in _notes(port)


def test_a_chain_longer_than_the_walk_kernel_walks_in_pieces(
        port, monkeypatch):
    # the walk kernel holds MJ_MAX_STEPS steps (8); a longer MultiJoin
    # (q64 plans 9 at scale 0.1) walks in pieces, each piece's output the
    # next one's spine. With the limit at 2, q07's 4-way star walks in
    # two pieces and its rows stay the same
    from presto_tpu_torch.kernels import build as B
    whole = port.execute(QUERIES["q07"])
    assert "MultiJoin" in port.explain(QUERIES["q07"])
    monkeypatch.setattr(B, "MJ_MAX_STEPS", 2)
    assert port.execute(QUERIES["q07"]) == whole
    assert len(whole) > 0
