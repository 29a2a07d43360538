"""A launch's byte count comes from its arguments alone: the same
whichever backend runs it, here both on CPU tensors through the one
wrapper the traced run installs, and as written for the join and for a
compaction with few live rows."""

from __future__ import annotations

import pytest
import torch

from harness import record


def _calls():
    g = torch.Generator().manual_seed(5)
    from presto_tpu_torch.kernels.multijoin import Walk
    n, nb = 4096, 512
    spine = torch.rand(n, generator=g) < 0.7
    key = torch.randint(0, 600, (n,), generator=g)
    bkey = torch.arange(nb)
    blive = torch.rand(nb, generator=g) < 0.9
    live = torch.rand(n, generator=g) < 0.03
    walk = Walk(build_live=[blive], build_hash=[bkey * 7919],
                build_step=[0], key_hash=[key * 7919], key_valid=[],
                key_step=[0], key_source=[-1], key_valid_at=[-1])
    return {
        "agg_sum": (torch.randint(0, 100, (n,), generator=g),
                    torch.randint(-1, 9, (n,), generator=g,
                                  dtype=torch.int32), 8),
        "agg_max": (torch.randint(0, 100, (n,), generator=g),
                    torch.randint(0, 9, (n,), generator=g,
                                  dtype=torch.int32), 8),
        "agg_min": (torch.randint(0, 100, (n,), generator=g,
                                  dtype=torch.int32),
                    torch.randint(0, 9, (n,), generator=g,
                                  dtype=torch.int32), 8),
        "join_lookup": (bkey * 7919, blive, key * 7919, spine, 1024, 64),
        "multijoin": (spine, walk, 1, 64),
        "compact": (live, {"a": torch.arange(n), "b": torch.ones(n, 2)},
                    256),
    }


@pytest.mark.parametrize("name", ["agg_sum", "agg_max", "agg_min",
                                  "join_lookup", "multijoin", "compact"])
def test_count_is_the_same_on_both_backends(name):
    from presto_tpu_torch import kernels as K
    args = _calls()[name]
    counted = {}
    for backend in ("cuda", "torch"):
        with record.Launches("cpu") as rec:
            K.run(name, backend, *args)
        assert rec.count[name] == 1
        counted[backend] = rec.bytes()[name]
    assert counted["cuda"] == counted["torch"] > 0


def test_join_as_written():
    """Masks of 3 build and 5 probe rows; hashes of the 2 live build and
    3 live probe rows; a build row (4 bytes) and a flag a probe row."""
    from presto_tpu_torch import kernels as K
    bh = torch.tensor([10, 20, 30])
    bl = torch.tensor([True, False, True])
    ph = torch.tensor([10, 30, 40, 20, 10])
    pl = torch.tensor([True, True, False, True, False])
    with record.Launches("cpu") as rec:
        K.run("join_lookup", "torch", bh, bl, ph, pl, 8, 16)
    assert rec.bytes()["join_lookup"] == 3 + 5 + 8 * (2 + 3) + 5 * 5


def test_compact_with_few_live_rows():
    """The mask, then each live row read and written once: two of a
    thousand rows live, 8 + 16 bytes a row, into a capacity of 64 (its
    padding does not count)."""
    from presto_tpu_torch import kernels as K
    live = torch.zeros(1000, dtype=torch.bool)
    live[[17, 900]] = True
    arrays = {"x": torch.arange(1000),
              "y": torch.zeros(1000, 2, dtype=torch.int64)}
    with record.Launches("cpu") as rec:
        out = K.run("compact", "torch", live, arrays, 64)
    assert out["x"][:2].tolist() == [17, 900]
    assert rec.bytes()["compact"] == 1000 + 2 * 2 * (8 + 16)
    # more live rows than the capacity: only the kept ones count
    live[:] = True
    with record.Launches("cpu") as rec:
        K.run("compact", "torch", live, arrays, 64)
    assert rec.bytes()["compact"] == 1000 + 2 * 64 * (8 + 16)


def test_wrappers_come_off():
    from presto_tpu_torch import kernels as K
    before = {n: dict(v) for n, v in K.KERNELS.items()}
    with record.Launches("cpu"):
        assert K.KERNELS["compact"]["cuda"] is not before["compact"]["cuda"]
    assert {n: dict(v) for n, v in K.KERNELS.items()} == before


def test_a_launch_that_raises_is_noted_and_not_counted():
    from presto_tpu_torch import kernels as K
    with record.Launches("cpu") as rec:
        with pytest.raises(Exception):
            K.run("compact", "torch", None, {}, 4)
    assert rec.names == ["compact"] and rec.failed == [0]
    assert rec.bytes() == {}
