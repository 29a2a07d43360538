"""presto_tpu_torch.expr.aggregates against presto_tpu.expr.aggregates
for min, max and arbitrary: fold and merge over slot ids (the segment
max/min entries) and scan_fold and scan_merge over hash-sorted groups
(the order scans), short integers and LONG decimals (the two-pass
limb extremum), with empty groups and rows whose weight is off. The
same numpy inputs go to both sides; states compare exactly."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from presto_tpu.expr import aggregates as RA
from presto_tpu.ops import hash as RH
from presto_tpu_torch.expr import aggregates as PA
from presto_tpu_torch.ops import hash as PH

FNS = ["min", "max", "arbitrary"]


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



def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(n=1500, k=64, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    hi = rng.integers(-3, 3, n).astype(np.int64)  # many high-limb ties
    lo[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1]
    w = rng.random(n) > 0.2
    slots = rng.integers(0, k // 2, n).astype(np.int32)  # upper half empty
    return lo, hi, w, slots, k


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]), f)


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("fn", FNS)
def test_fold_and_merge_match_reference(fn, long):
    lo, hi, w, slots, k = _inputs(seed=len(fn) + long)
    d2 = hi if long else None
    want = RA.fold(fn, jnp.asarray(lo), jnp.asarray(w), jnp.asarray(slots),
                   k, data2=None if d2 is None else jnp.asarray(d2))
    got = PA.fold(fn, _t(lo), _t(w), _t(slots), k,
                  data2=None if d2 is None else _t(d2))
    _same(got, want)
    # merge the per-slot states into 8 final groups
    mslots = (np.arange(k) % 8).astype(np.int32)
    live = np.arange(k) % 5 != 0
    want_m = RA.merge(fn, want, jnp.asarray(mslots), 8, jnp.asarray(live))
    got_m = PA.merge(fn, got, _t(mslots), 8, _t(live))
    _same(got_m, want_m)
    for r, p in ((want, got), (want_m, got_m)):
        rv, rok = RA.finalize(fn, r, None, None)
        pv, pok = PA.finalize(fn, p, None, None)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("fn", FNS)
def test_scan_fold_and_scan_merge_match_reference(fn, long):
    lo, hi, w, slots, _k = _inputs(seed=7 + long)
    h = slots.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    live = np.ones(len(h), bool)
    live[::11] = False
    rs = RH.SortedGroups(jnp.asarray(h), jnp.asarray(live))
    ps = PH.SortedGroups(_t(h.view(np.int64)), _t(live))
    d2 = hi if long else None
    want = RA.scan_fold(fn, jnp.asarray(lo), jnp.asarray(w), rs,
                        data2=None if d2 is None else jnp.asarray(d2))
    got = PA.scan_fold(fn, _t(lo), _t(w), ps,
                       data2=None if d2 is None else _t(d2))
    _same(got, want)
    want_m = RA.scan_merge(fn, want, jnp.asarray(w), rs)
    got_m = PA.scan_merge(fn, got, _t(w), ps)
    _same(got_m, want_m)
