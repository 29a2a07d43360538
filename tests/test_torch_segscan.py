"""presto_tpu_torch.ops.segscan against presto_tpu.ops.segscan: the
sorted aggregate's order scans (seg_max, seg_min, seg_argbest,
broadcast_last) and the generic doubling scan, per row and exactly,
over the same hash-sorted groups."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from presto_tpu.ops import hash as RH
from presto_tpu.ops import segscan as RS
from presto_tpu_torch.ops import hash as PH
from presto_tpu_torch.ops import segscan as PS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel, and torch's default of one
    OpenMP thread per core in every worker oversubscribes the host
    (its spinning threads slowed the whole suite several times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _groups(n, ngroups, seed, live_frac=0.8):
    """The same SortedGroups on both sides, and per-row values in that
    sorted order (int64 with the extremes, and float64)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, ngroups, n)
    # the reference carries hashes as uint64, the port as int64 bits
    h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    live = rng.random(n) < live_frac
    rs = RH.SortedGroups(jnp.asarray(h), jnp.asarray(live))
    ps = PH.SortedGroups(_t(h.view(np.int64)), _t(live))
    vals = rng.integers(-(1 << 62), 1 << 62, n)
    vals[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0][:n]
    return rs, ps, vals, rng.normal(size=n)


@pytest.mark.parametrize("n,ngroups", [(1, 1), (17, 3), (3000, 40),
                                       (4096, 4096)])
def test_seg_max_min_match_reference(n, ngroups):
    rs, ps, ints, floats = _groups(n, ngroups, seed=n)
    for vals in (ints, floats):
        for rf, pf in ((RS.seg_max, PS.seg_max), (RS.seg_min, PS.seg_min)):
            want = np.asarray(rf(jnp.asarray(vals), rs))
            np.testing.assert_array_equal(pf(_t(vals), ps).numpy(), want)


@pytest.mark.parametrize("maximize", [True, False])
def test_seg_argbest_matches_reference(maximize):
    rs, ps, ints, floats = _groups(2500, 60, seed=5)
    # few distinct values: ties, where the earliest row must win
    best = ints % 7
    payload = (floats, np.arange(2500, dtype=np.int32))
    wb, wp = RS.seg_argbest(jnp.asarray(best),
                            tuple(jnp.asarray(p) for p in payload), rs,
                            maximize)
    gb, gp = PS.seg_argbest(_t(best), tuple(_t(p) for p in payload), ps,
                            maximize)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    for g, w in zip(gp, wp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("live_frac", [0.0, 0.5, 1.0])
def test_broadcast_last_matches_reference(live_frac):
    rs, ps, ints, floats = _groups(3000, 70, seed=9, live_frac=live_frac)
    for vals in (ints, floats, np.stack([ints, ints // 3], axis=1)):
        want = np.asarray(RS.broadcast_last(jnp.asarray(vals), rs))
        np.testing.assert_array_equal(
            PS.broadcast_last(_t(vals), ps).numpy(), want)


def test_seg_scan_with_a_two_leaf_state():
    # a running (sum, max) pair through the generic doubling scan
    rs, ps, ints, _ = _groups(1000, 25, seed=2)
    small = ints % 1000

    def rcomb(a, b):
        return (a[0] + b[0], jnp.maximum(a[1], b[1]))

    def pcomb(a, b):
        return (a[0] + b[0], torch.maximum(a[1], b[1]))
    want = RS.seg_scan(rcomb, (jnp.asarray(small), jnp.asarray(ints)), rs)
    got = PS.seg_scan(pcomb, (_t(small), _t(ints)), ps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(),
                                  PS.seg_sum(_t(small), ps).numpy())
