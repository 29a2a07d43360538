"""EXPLAIN ANALYZE in the port (presto_tpu_torch/exec/profile.py), held
against presto_tpu's on the same SQL at SF0.01: every annotated node's
actual rows and every segment's live rows and carrier width equal the
reference's, for Q3, Q5 and a segmented Q10; they equal the node rows
(``engine.last_run.node_rows``) of a plain run of the same query. The
times are ignored, and so are the estimates: the reference's cost
model consults a process-wide ledger of what earlier queries observed
(``obs.qstats``), which the port does not have yet (ROADMAP item 7)."""

import re

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.exec import executor as REX

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import executor as EX

from tpch_queries import QUERIES

NODE = re.compile(r"^(\s*\S.*?)  \[rows: (\d+)(?: \(est (\d+)\))?\]$",
                  re.M)
SEGMENT = re.compile(r"^Segment (\d+) \([\d.]+ ms, (\d+) live rows -> "
                     r"(s\d+\[\d+\])\)$", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair(tpch_tiny):
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    # the reference widens a templated plan's carriers to its width
    # memory (cap_floor), which the port leaves out: untemplated, its
    # carriers take the exact widths the port's take
    ref.session.set("plan_templates", False)
    port = TorchEngine(device="cpu")
    port.register_catalog("tpch", TorchTpch(scale=0.01))
    return ref, port


def plain_rows(engine) -> list[int]:
    """The node rows of the engine's last run, program by program, each
    program's nodes in preorder: the order EXPLAIN ANALYZE prints."""
    run = engine.last_run
    return [run.node_rows[(i, pos)]
            for i, plan in enumerate(run.programs)
            for pos, _node in enumerate(EX._preorder(plan))]


@pytest.mark.parametrize("qname,forced", [("q03", False), ("q05", False),
                                          ("q10", True)])
def test_explain_analyze_rows_equal_reference(pair, qname, forced,
                                              monkeypatch):
    ref, port = pair
    if forced:  # q10's joins become a segment at any scale
        monkeypatch.setattr(REX, "AGG_SPLIT_MIN_ROWS", 0)
        monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)
    sql = QUERIES[qname]
    want = ref.execute("explain analyze " + sql)[0][0]
    got = port.execute("explain analyze " + sql)[0][0]
    assert [(node, rows) for node, rows, _est in NODE.findall(got)] == \
        [(node, rows) for node, rows, _est in NODE.findall(want)]
    assert SEGMENT.findall(got) == SEGMENT.findall(want)
    assert len(SEGMENT.findall(got)) == \
        sum(map(len, port.last_run.segments))
    if forced:
        assert SEGMENT.findall(got)
    # the same rows as a plain run of the query
    shown = [int(rows) for _node, rows, _est in NODE.findall(got)]
    port.execute(sql)
    assert shown == plain_rows(port)


def test_explain_analyze_header_and_run(pair):
    _ref, port = pair
    text = port.execute("explain analyze select count(*) from nation "
                        "where n_regionkey = 1")[0][0]
    assert text.startswith("Query plan (execute ")
    assert "rows: 5" in text
    # the profiled run is the engine's last run
    assert len(port.last_run.programs) == 1
    assert port.last_run.passes == [1]


def test_explain_analyze_expects_a_query(pair):
    _ref, port = pair
    with pytest.raises(ValueError, match="expects a query"):
        port.execute("explain analyze set session spill_enabled = true")
