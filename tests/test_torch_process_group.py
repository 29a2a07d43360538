"""ProcessShardGroup (presto_tpu_torch/parallel/group.py) over a real
torch.distributed group: two CPU processes joined by gloo, one shard
each, run TPC-H q01, q03 under PARTITIONED joins and q05 at SF0.01.
Their rows and their collective calls and bytes per kind must equal
LocalShardGroup(2, "cpu") in this process. The group is spawned once
for the module; the workers import neither jax nor presto_tpu."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

CASES = [("q01", {}), ("q03", {"join_distribution_type": "PARTITIONED"}),
         ("q05", {})]

WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, "tests")
from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.parallel.group import COLLECTIVES, ProcessShardGroup
from tpch_queries import QUERIES

rank, url, cases = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=url, rank=rank, world_size=2)
group = ProcessShardGroup(None, "cpu")
assert group.nshards == 2 and group.local == [rank]
conn = TpchConnector(scale=0.01)
out = []
for qname, props in cases:
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    for k, v in props.items():
        e.session.set(k, v)
    COLLECTIVES.reset()
    rows = e.execute(QUERIES[qname], mesh=group)
    out.append({"rows": repr(rows), "collectives": COLLECTIVES.snapshot(),
                "kinds": sorted({k for _p, k in
                                 e.last_dist_meta["used_capacity"]})})
dist.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_results():
    url = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), url, json.dumps(CASES)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-4000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def local_results():
    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.parallel.group import COLLECTIVES, LocalShardGroup
    from tpch_queries import QUERIES
    group = LocalShardGroup(2, "cpu")
    conn = TpchConnector(scale=0.01)
    out = []
    for qname, props in CASES:
        e = Engine(device="cpu")
        e.register_catalog("tpch", conn)
        for k, v in props.items():
            e.session.set(k, v)
        COLLECTIVES.reset()
        rows = e.execute(QUERIES[qname], mesh=group)
        out.append({"rows": repr(rows),
                    "collectives": COLLECTIVES.snapshot(),
                    "kinds": sorted({k for _p, k in
                                     e.last_dist_meta["used_capacity"]})})
    return out


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[q for q, _ in CASES])
def test_gloo_group_equals_local_group(gloo_results, local_results, i):
    want = local_results[i]
    for rank, res in enumerate(gloo_results):
        got = res[i]
        # every rank gathers the replicated result
        assert got["rows"] == want["rows"], rank
        assert got["collectives"] == want["collectives"], rank
        assert got["kinds"] == want["kinds"], rank
    if CASES[i][1]:
        assert want["collectives"]["calls"]["all_to_all"] > 0
        assert {"probe_exch", "build_exch"} <= set(want["kinds"])
