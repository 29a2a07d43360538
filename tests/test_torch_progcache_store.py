"""The program cache's persistent store (presto_tpu_torch/exec/
progcache.py, ``PRESTO_TPU_PROGRAM_CACHE_DIR``) on the CPU: the
capacity sidecar's rows and the pass counts of a group-by climbing its
ladder, held against presto_tpu's compiles and ``.caps.json`` on the
same data; a fresh process that climbs no rung and counts no cost;
corrupt, stale and old-format files costing a counted error and a miss;
the digest and the platform fingerprint; two workers sharing a store;
the shard-group, batched and EXPLAIN ANALYZE ladders; the disk budget;
the store left unset; the pass log; and chip_smoke's store cases
rehearsed on the CPU."""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.obs.metrics import REGISTRY as REF_REGISTRY

from presto_tpu_torch import Engine
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.exec import progcache as PC
from presto_tpu_torch.obs import devprof
from presto_tpu_torch.obs.metrics import REGISTRY

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

# the probe: 5000 groups through a group-by table hinted at 64 slots
# climb 4 rungs (64 -> 256 -> 1024 -> 4096 -> 16384)
N_ROWS = 32768
N_GROUPS = 5000
TABLE_SIZE = 64
SQL = "select k, sum(v) from t group by k order by k limit 3"
FIRST_PASSES = 5

_HITS = REGISTRY.counter("presto_tpu_program_cache_hits_total")
_MISSES = REGISTRY.counter("presto_tpu_program_cache_misses_total")
_ERRORS = REGISTRY.counter("presto_tpu_program_cache_disk_errors_total")
_HARVESTS = REGISTRY.counter("presto_tpu_cost_harvests_total")
_RETRIES = REGISTRY.counter("presto_tpu_capacity_overflow_retries_total")
_REF_COMPILED = REF_REGISTRY.counter("presto_tpu_programs_compiled_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def store(tmp_path, monkeypatch) -> Path:
    """The port's store in a fresh directory, costs forgotten."""
    path = tmp_path / "store"
    monkeypatch.setenv(PC.ENV_DIR, str(path))
    devprof.forget_costs()
    return path


def _columns() -> dict:
    return {"k": np.arange(N_ROWS) % N_GROUPS, "v": np.arange(N_ROWS)}


def _conn() -> MemoryConnector:
    conn = MemoryConnector()
    conn.create_table("t", {"k": T.BIGINT, "v": T.BIGINT}, _columns())
    return conn


def _engine(conn=None, **props) -> Engine:
    e = Engine(device="cpu")
    e.register_catalog("mem", conn or _conn())
    e.session.catalog = "mem"
    e.execute(f"set session groupby_table_size = {TABLE_SIZE}")
    for name, value in props.items():
        e.session.set(name, value)
    return e


def _plain(rows) -> list:
    return [tuple(int(v) for v in r) for r in rows]


def _files(path: Path, suffix: str) -> list[str]:
    return sorted(glob.glob(str(path / f"*{suffix}")))


def _sidecar_rows(path: Path) -> list:
    (caps,) = _files(path, ".caps.json")
    with open(caps, encoding="utf-8") as f:
        return json.load(f)


def _disk_hits() -> float:
    return _HITS.value(tier="disk")


# -- 1. a group-by's ladder, held against presto_tpu -----------------------

def test_sidecar_and_passes_equal_reference(tmp_path, monkeypatch):
    """presto_tpu and the port on the same table, each on a store of
    its own: the port's sidecar rows equal the reference's .caps.json;
    the port's first engine takes as many passes as the reference's
    compiles; a second port engine takes 1 pass (the reference's
    compiles at most 1: its AOT store cannot serialize on this CPU, its
    sidecar still works); the rows are equal."""
    monkeypatch.setenv(PC.ENV_DIR, str(tmp_path / "ref"))
    ref_conn = RefMemory()
    ref_conn.create_table("t", {"k": RT.BIGINT, "v": RT.BIGINT}, _columns())

    def ref_engine():
        e = RefEngine()
        e.register_catalog("mem", ref_conn)
        e.session.catalog = "mem"
        e.execute(f"set session groupby_table_size = {TABLE_SIZE}")
        return e

    c0 = _REF_COMPILED.value()
    want = ref_engine().execute(SQL)
    ref_first = _REF_COMPILED.value() - c0
    c0 = _REF_COMPILED.value()
    assert ref_engine().execute(SQL) == want
    assert _REF_COMPILED.value() - c0 <= 1

    monkeypatch.setenv(PC.ENV_DIR, str(tmp_path / "port"))
    devprof.forget_costs()
    conn = _conn()
    first = _engine(conn)
    got = first.execute(SQL)
    assert first.last_run.passes == [ref_first] == [FIRST_PASSES]
    assert _sidecar_rows(tmp_path / "port") \
        == _sidecar_rows(tmp_path / "ref") == [[2, "table", 16384]]
    second = _engine(conn)
    h0 = _disk_hits()
    assert second.execute(SQL) == got
    assert second.last_run.passes == [1]
    assert second.last_run.from_memory == [False]
    assert _disk_hits() - h0 == 1
    assert _plain(got) == _plain(want)


# -- 2. a fresh process ------------------------------------------------------

_CHILD = f"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from presto_tpu_torch import Engine, types as T
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.obs.metrics import REGISTRY
conn = MemoryConnector()
conn.create_table("t", {{"k": T.BIGINT, "v": T.BIGINT}},
                  {{"k": np.arange({N_ROWS}) % {N_GROUPS},
                    "v": np.arange({N_ROWS})}})
e = Engine(device="cpu")
e.register_catalog("mem", conn)
e.session.catalog = "mem"
e.execute("set session groupby_table_size = {TABLE_SIZE}")
rows = e.execute({SQL!r})
print(json.dumps({{
    "rows": [[int(v) for v in r] for r in rows],
    "passes": e.last_run.passes, "costs": e.last_run.costs,
    "disk_hits": REGISTRY.counter(
        "presto_tpu_program_cache_hits_total").value(tier="disk"),
    "harvests": REGISTRY.counter("presto_tpu_cost_harvests_total").total()}}))
"""


def _run_child(store_dir: Path, hashseed: int) -> dict:
    env = dict(os.environ, PYTHONHASHSEED=str(hashseed))
    env[PC.ENV_DIR] = str(store_dir)
    proc = subprocess.run([sys.executable, "-c", _CHILD],
                          capture_output=True, text=True, timeout=240,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fresh_process_climbs_no_rung_and_counts_nothing(tmp_path):
    """Two processes, one after the other, on one store (and under
    different hash seeds: the key's text is the same in both). The
    cold one climbs the ladder and counts its program's cost; the warm
    one takes one pass, hits the store, counts nothing and returns the
    cold one's rows and cost."""
    cold = _run_child(tmp_path, 1)
    assert cold["passes"] == [FIRST_PASSES]
    assert cold["harvests"] >= 1 and cold["disk_hits"] == 0
    warm = _run_child(tmp_path, 2)
    assert warm["passes"] == [1]
    assert warm["disk_hits"] >= 1
    assert warm["harvests"] == 0
    assert warm["rows"] == cold["rows"]
    assert warm["costs"] == cold["costs"] and cold["costs"][0]


# -- 3. corrupt and stale files ----------------------------------------------

def _truncate(path: str) -> None:
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:max(len(blob) // 3, 1)])


def _rewrite(field: str, value):
    def edit(path: str) -> None:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        doc[field] = value
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
    return edit


@pytest.mark.parametrize("suffix,damage,passes", [
    (".prog.json", _truncate, 1),
    (".prog.json", _rewrite("key", "('another', 'key')"), 1),
    (".prog.json", _rewrite("format", "cost1"), 1),
    (".prog.json", _rewrite("meta", {"out": 3}), 1),
    (".caps.json", _truncate, FIRST_PASSES),
    (".caps.json", lambda p: Path(p).write_text('[["x"]]'), FIRST_PASSES),
], ids=["entry-truncated", "entry-other-key", "entry-old-format",
        "entry-malformed", "sidecar-truncated", "sidecar-malformed"])
def test_bad_file_costs_an_error_and_a_miss(store, monkeypatch, suffix,
                                             damage, passes):
    """A damaged entry or sidecar: the read counts a load error and a
    miss, the file is unlinked, the rows are equal (a bad entry: its
    program starts at the sidecar's vector, 1 pass; a bad sidecar: the
    ladder from the start), the next success writes it again, and the
    next engine hits the store again."""
    conn = _conn()
    want = _engine(conn).execute(SQL)
    (path,) = _files(store, suffix)
    damage(path)
    unlinked = []
    real = PC.ProgramCache._unlink

    def spy(p):
        unlinked.append(p)
        real(p)
    monkeypatch.setattr(PC.ProgramCache, "_unlink", staticmethod(spy))
    e0, m0 = _ERRORS.value(op="load"), _MISSES.value()
    e = _engine(conn)
    assert e.execute(SQL) == want
    assert e.last_run.passes == [passes]
    assert _ERRORS.value(op="load") - e0 == 1
    assert _MISSES.value() - m0 >= 1
    assert unlinked == [path]
    assert _files(store, suffix) == [path]  # written again
    h0 = _disk_hits()
    again = _engine(conn)
    assert again.execute(SQL) == want
    assert again.last_run.passes == [1]
    assert _disk_hits() - h0 == 1


def test_too_small_a_stored_vector_only_starts_lower(store):
    """New data of the same shape (more groups in as many rows) finds
    the stored vector too small: the fresh engine starts there, its ok
    flags grow it, the outgrown entry is dropped from both tiers, the
    sidecar names the new vector and the rows are right."""
    want = _engine().execute(SQL)
    (old_entry,) = _files(store, ".prog.json")
    conn = MemoryConnector()
    conn.create_table("t", {"k": T.BIGINT, "v": T.BIGINT},
                      {"k": np.arange(N_ROWS) % (4 * N_GROUPS),
                       "v": np.arange(N_ROWS)})
    e = _engine(conn)
    got = e.execute(SQL)
    assert e.last_run.passes == [2]
    assert _plain(got) == [(k, sum(range(k, N_ROWS, 4 * N_GROUPS)))
                           for k in range(3)]
    assert _plain(got) != _plain(want)
    assert old_entry not in _files(store, ".prog.json")
    assert _sidecar_rows(store) == [[2, "table", 65536]]
    again = _engine(conn)
    assert again.execute(SQL) == got and again.last_run.passes == [1]


# -- 4. the digest and the fingerprint ---------------------------------------

@pytest.fixture
def fresh_fingerprints():
    PC.platform_fingerprint.cache_clear()
    yield
    PC.platform_fingerprint.cache_clear()


def test_digest_tracks_the_platform(monkeypatch, fresh_fingerprints):
    """The digest changes with torch's version, the device's name, the
    kernel backend and the format tag, each of which the fingerprint
    holds."""
    key = ("fp", (), ())
    fp = PC.platform_fingerprint("cpu", "torch")
    assert PC.PROGRAM_FORMAT in fp and "kernels-torch" in fp
    assert torch.__version__ in fp and torch.version.cuda in fp
    base = PC.entry_digest(key, fp)
    assert base == PC.entry_digest(key, PC.platform_fingerprint(
        "cpu", "torch"))
    assert base != PC.entry_digest(key, PC.platform_fingerprint(
        "cpu", "cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    names = {}
    for card in ("NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda _dev, card=card: card)
        PC.platform_fingerprint.cache_clear()
        names[card] = PC.entry_digest(key, PC.platform_fingerprint(
            "cuda:0", "cuda"))
    assert len(set(names.values())) == 2
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    PC.platform_fingerprint.cache_clear()
    assert PC.entry_digest(key, PC.platform_fingerprint(
        "cpu", "torch")) != base
    monkeypatch.undo()
    monkeypatch.setattr(PC, "PROGRAM_FORMAT", "meta0")
    PC.platform_fingerprint.cache_clear()
    assert PC.entry_digest(key, PC.platform_fingerprint(
        "cpu", "torch")) != base


def test_torch_backend_never_reads_an_auto_entry(store):
    """Entries written under kernel_backend=auto are not read by a
    kernel_backend=torch run (the backend is in the key): it climbs
    its own ladder, with the same rows, and writes its own files."""
    conn = _conn()
    want = _engine(conn).execute(SQL)
    h0 = _disk_hits()
    e = _engine(conn, kernel_backend="torch")
    assert e.execute(SQL) == want
    assert e.last_run.passes == [FIRST_PASSES]
    assert _disk_hits() == h0
    assert len(_files(store, ".caps.json")) == 2
    assert len(_files(store, ".prog.json")) == 2


# -- 5. two workers sharing the store ----------------------------------------

def test_two_workers_share_the_store(store):
    """presto_tpu's test_two_worker_cluster_shares_disk_store counted in
    passes: a fragment whose first task climbs its ladder on one worker
    takes one pass per program on the other (its first task of it),
    every pass a disk hit, no rung, no cost counted."""
    from presto_tpu_torch.exec.streaming import _find_streamable
    from presto_tpu_torch.parallel.coordinator import RemoteWorker
    from presto_tpu_torch.parallel.wire import bytes_to_columns
    from presto_tpu_torch.parallel.worker import WorkerServer
    from presto_tpu_torch.plan import nodes as N
    from presto_tpu_torch.plan.serde import fragment_to_dict

    conn = _conn()  # an even split: both shards have equal shapes
    local = _engine(conn)
    plan, _ = local.plan_sql("select k, sum(v) from t group by k")
    agg, _scan = _find_streamable(plan)
    frag = fragment_to_dict(dataclasses.replace(
        agg, step=N.AggStep.PARTIAL, capacity=TABLE_SIZE))
    workers = [WorkerServer({"mem": conn}, node_id=f"pw{i}",
                            device="cpu").start() for i in range(2)]
    try:
        remotes = [RemoteWorker(w.uri) for w in workers]
        r0 = _RETRIES.total()
        out0 = remotes[0].post_task_any(
            {"fragment": frag, "shard": 0, "nshards": 2})
        assert _RETRIES.total() - r0 >= 1
        r0, h0, c0 = _RETRIES.total(), _disk_hits(), _HARVESTS.total()
        lookups0 = _HITS.total() + _MISSES.value()
        out1 = remotes[1].post_task_any(
            {"fragment": frag, "shard": 1, "nshards": 2})
        assert _RETRIES.total() == r0
        assert _HARVESTS.total() == c0
        hits = _disk_hits() - h0
        # one pass per program: each lookup a disk hit
        assert hits >= 1
        assert _HITS.total() + _MISSES.value() - lookups0 == hits
        assert bytes_to_columns(out0)[1] > 0
        assert bytes_to_columns(out1)[1] > 0
    finally:
        for w in workers:
            w.stop()


# -- 6. the other ladders ----------------------------------------------------

def test_shard_group_starts_at_the_stored_vector(store):
    """Under LocalShardGroup(2) a fresh engine starts at the vector the
    first stored, under the distributed key; a group over 4 shards does
    not read the 2-shard vector."""
    from presto_tpu_torch.parallel.group import LocalShardGroup

    conn = _conn()
    sql = "select k, sum(v) from t group by k"
    first = _engine(conn)
    want = sorted(first.execute(sql, mesh=LocalShardGroup(2, "cpu")))
    assert first.last_run.passes[0] > 1
    e = _engine(conn)
    h0 = _disk_hits()
    assert sorted(e.execute(sql, mesh=LocalShardGroup(2, "cpu"))) == want
    assert e.last_run.passes == [1]
    assert _disk_hits() - h0 == 1
    four = _engine(conn)
    h0 = _disk_hits()
    assert sorted(four.execute(sql, mesh=LocalShardGroup(4, "cpu"))) == want
    assert four.last_run.passes[0] > 1
    assert _disk_hits() == h0


def test_batched_group_starts_at_the_stored_vector(store):
    """exec/batch.py under its ("batch", K) key: a fresh engine's
    batched run of the same group takes one pass and hits the store."""
    from presto_tpu_torch import templates as TPL
    from presto_tpu_torch.exec import batch as B

    conn = _conn()
    sqls = [f"select k, sum(v) from t where v >= {i} group by k"
            for i in (1, 2, 3)]

    def batched(e):
        return B.run_plan_batched(
            e, [TPL.parameterize(e.plan_sql(s)[0]) for s in sqls])

    first = _engine(conn)
    want = [sorted(t.to_pylist()) for t in batched(first)]
    assert first.last_run.passes[0] > 1
    e = _engine(conn)
    h0, c0 = _disk_hits(), _HARVESTS.total()
    devprof.forget_costs()
    got = batched(e)
    assert e.last_run.passes == [1]
    assert _disk_hits() - h0 == 1 and _HARVESTS.total() == c0
    assert [sorted(t.to_pylist()) for t in got] == want


def test_explain_analyze_reaches_the_store(store):
    """EXPLAIN ANALYZE runs through prepare_plan: a fresh engine's
    profile shows one pass where the first engine's showed the whole
    ladder."""
    conn = _conn()
    text = _engine(conn).execute("explain analyze " + SQL)[0][0]
    assert f"{FIRST_PASSES} passes" in text
    h0 = _disk_hits()
    e = _engine(conn)
    text = e.execute("explain analyze " + SQL)[0][0]
    assert "(execute " in text and " 1 pass)" in text
    assert e.last_run.passes == [1]
    assert _disk_hits() - h0 == 1


# -- 7. the budget, and the store unset --------------------------------------

def test_disk_budget_prunes_the_oldest_files(tmp_path, monkeypatch):
    """Past PRESTO_TPU_PROGRAM_CACHE_DISK_BYTES the oldest files go,
    after an entry is written; the newest stay."""
    cache = PC.ProgramCache(disk_dir=str(tmp_path))
    meta = {"out": [], "ok_keys": [], "used_capacity": {}, "kernels": {},
            "cost": None}
    for i in range(6):
        cache.insert(("k", i), meta)
    files = _files(tmp_path, ".prog.json")
    assert len(files) == 6
    for age, path in enumerate(reversed(files)):
        os.utime(path, (1e9 - age, 1e9 - age))
    size = os.path.getsize(files[0])
    monkeypatch.setattr(PC, "DISK_BYTES_LIMIT", 3 * size + size // 2)
    oldest = sorted(files, key=os.path.getmtime)
    cache.insert(("k", 6), meta)
    left = _files(tmp_path, ".prog.json")
    assert len(left) == 3
    assert not set(oldest[:4]) & set(left)
    assert cache.lookup(("k", 6)) == meta


def test_unset_writes_nothing_and_keeps_todays_passes(tmp_path,
                                                      monkeypatch):
    """With the variable unset no file is written anywhere the engine
    could reach, and every new engine climbs the whole ladder, as
    before the store."""
    monkeypatch.delenv(PC.ENV_DIR, raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    conn = _conn()
    rows = None
    for _ in range(2):
        e = _engine(conn)
        assert e._program_cache.stats()["disk_dir"] is None
        got = e.execute(SQL)
        assert e.last_run.passes == [FIRST_PASSES]
        assert rows is None or got == rows
        rows = got
        # the engine's own memory still spares the repeat its ladder
        assert e.execute(SQL) == rows and e.last_run.passes == [1]
    assert os.listdir(tmp_path) == []


def test_pass_log(store, monkeypatch, capfd):
    """PRESTO_TPU_LOG_COMPILES prints one stderr line per pass of a
    cached program, with its seconds, capacities and root node."""
    monkeypatch.setenv("PRESTO_TPU_LOG_COMPILES", "1")
    _engine().execute(SQL)
    lines = [ln for ln in capfd.readouterr().err.splitlines()
             if ln.startswith("[pass] ")]
    assert len(lines) == FIRST_PASSES
    assert lines[0].endswith("caps={} root=Output")
    assert "caps={(2, 'table'): 16384} root=Output" in lines[-1]


# -- 8. chip_smoke's store cases on the CPU ----------------------------------

def test_chip_smoke_store_cases_on_the_cpu(tmp_path, monkeypatch):
    """Phase 4's last case and phase 14 of chip_smoke.py at a tiny
    TPC-DS scale, every engine on the CPU (its card calls stubbed; a
    child runs in this process, its costs forgotten first, where the
    card's runs in a fresh one): the new engine's first passes climb
    no rung, hit the store and count nothing; the warm child returns
    the cold one's rows and costs after the cold one climbed at least
    STORE_MIN_RUNGS rungs."""
    import presto_tpu_torch
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)

    class CpuEngine(Engine):
        def __init__(self, *args, device=None, **kw):
            super().__init__(*args, device="cpu", **kw)

    monkeypatch.setattr(presto_tpu_torch, "Engine", CpuEngine)
    monkeypatch.delenv(PC.ENV_DIR, raising=False)

    def child(store_dir):
        with CS.program_store(store_dir):
            devprof.forget_costs()
            return CS.store_child(0.01, CS.TPCDS_SEED)

    out = CS.store_phase(child)
    assert sum(g["rungs"] for g in out["cold"]["queries"].values()) \
        >= CS.STORE_MIN_RUNGS
    assert not any(g["rungs"] for g in out["warm"]["queries"].values())

    conn = TpcdsConnector(scale=0.01, seed=CS.TPCDS_SEED)
    queries = CS.tpcds_queries()
    store_dir = str(tmp_path / "store")
    with CS.program_store(store_dir):
        engine = CpuEngine()
    engine.register_catalog("tpcds", conn)
    engine.session.catalog = "tpcds"
    cold = {q: queries[q] for q in CS.STORE_QUERIES}
    rows, secs, notes = CS.run_queries(engine, cold, "cuda")
    CS.store_warm_case(conn, queries, rows, secs, notes, store_dir)
    # every other phase keeps the store off
    assert PC.ENV_DIR not in os.environ
    with pytest.raises(AssertionError, match="rows differ"):
        CS.store_warm_case(conn, queries, {**rows, "q02": rows["q02"][1:]},
                           secs, notes, store_dir)
