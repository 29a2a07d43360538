"""MATCH_RECOGNIZE in presto_tpu_torch (exec/match_recognize.py: the
DEFINE predicates and measures through the port's ExprCompiler, the
reference's host NFA over their fetched masks), held against
presto_tpu and the hand-computed rows of tests/test_match_recognize.py,
and against presto_tpu over a seeded random price series in several
partitions (NULL prices and tied timestamps excluded: the reference
orders NULLs and ties as numpy's lexsort does, and so does the port)."""

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.exec import hostsync as HS

import torch_array_cases as C


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name: str, data: dict) -> tuple:
    ref = C.memory_engine(RefEngine(), RefMemory(), RT,
                          {name: C.bigint_table(RT, data)})
    port = C.memory_engine(TorchEngine(device="cpu"), MemoryConnector(),
                           PT, {name: C.bigint_table(PT, data)})
    return ref, port


@pytest.fixture(scope="module")
def ticks():
    return _pair("ticks", C.TICKS)


@pytest.mark.parametrize("name", sorted(C.MR_HAND))
def test_hand_computed_matches(name, ticks):
    ref, port = ticks
    sql, want = C.MR_HAND[name]
    got = port.execute(sql)
    assert got == want
    assert got == ref.execute(sql)


def test_measures_come_back_in_one_fetch(ticks):
    _ref, port = ticks
    before = HS.SYNCS.by_site.get("match-measures", 0)
    port.execute(C.MR_HAND["v_shape"][0])
    assert HS.SYNCS.by_site.get("match-measures", 0) == before + 1


@pytest.fixture(scope="module")
def series():
    return _pair("series", C.random_series())


@pytest.mark.parametrize("name", sorted(C.MR_RANDOM_SQL))
def test_random_series_matches_the_reference(name, series):
    ref, port = series
    sql = C.MR_RANDOM_SQL[name]
    got = port.execute(sql)
    assert got, "no match: the series exercises nothing"
    assert got == ref.execute(sql)
