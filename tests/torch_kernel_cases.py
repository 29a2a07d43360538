"""Inputs shared by the port's kernel tests on the CPU
(tests/test_torch_kernels.py, against the JAX package) and on the card
(tests/test_torch_cuda.py, against the plain versions). They are made
with numpy from a seed, so both files hold the kernels to the same
cases."""

import numpy as np

# segment_max/min's routing boundaries (csrc/segment_cmp.cu): registers
# to k = 8, lane columns of shared memory to 32, shared-memory partials
# to 6144 (one copy a warp while they fit 48 KB, so to k = 768), global
# atomics past it
CMP_BOUNDARY_KS = [1, 2, 7, 8, 9, 31, 32, 33, 768, 769, 6144, 6145]
CMP_DTYPES = {"uint8": np.uint8, "int8": np.int8, "int16": np.int16,
              "int32": np.int32, "int64": np.int64}


def padded_k(k: int) -> int:
    """k rounded up to a power of two: the partials of the small-k
    paths."""
    return 1 << (k - 1).bit_length()


def cmp_boundary_inputs(dtype, n: int, k: int, seed: int):
    """Values over the dtype's whole range with both extremes in segment
    0; ids in [0, k) with -1 and k (both drop) and KP - 1 (drops unless
    k is a power of two) sprinkled in, and segment k - 2 left empty."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    ids = rng.integers(0, k, n).astype(np.int32)
    if k > 2:
        ids[ids == k - 2] = k - 1
    ids[3::7] = -1
    ids[5::11] = k
    ids[6::13] = padded_k(k) - 1
    x[:2] = [info.max, info.min]
    ids[:2] = 0
    return x, ids


# filter_compact at its edges: no row live, every row live, a live count
# equal to the capacity and one past it, and more columns than one
# launch takes (build.COMPACT_MAX_COLS = 32)
COMPACT_EDGES = ["none_live", "all_live", "live_at_capacity",
                 "live_past_capacity", "many_columns"]


def compact_edge_inputs(case: str, n: int, seed: int):
    """(live, arrays, capacity): columns of 1, 2, 4, 8, 16 and 24 bytes
    a row (bool, uint8, int16, int32, float32, int64, float64, [n, 2]
    and [n, 3] int64), forty of them for ``many_columns``."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) < 0.3
    if case == "none_live":
        live[:] = False
    elif case == "all_live":
        live[:] = True
    nlive = int(live.sum())
    capacity = {"none_live": n // 2, "all_live": n,
                "live_at_capacity": nlive,
                "live_past_capacity": nlive - 1}.get(case, n // 2)

    def column(j: int):
        kind = j % 9
        if kind == 0:
            return rng.random(n) > 0.5
        if kind == 1:
            return rng.integers(0, 256, n).astype(np.uint8)
        if kind == 2:
            return rng.integers(-(1 << 15), 1 << 15, n).astype(np.int16)
        if kind == 3:
            return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
        if kind == 4:
            return rng.normal(size=n).astype(np.float32)
        if kind == 5:
            return rng.integers(-(1 << 62), 1 << 62, n)
        if kind == 6:
            return rng.normal(size=n)
        return rng.integers(-(1 << 62), 1 << 62, (n, kind - 5))
    ncols = 40 if case == "many_columns" else 9
    arrays = {f"c{j}": column(j) for j in range(ncols)}
    return live, arrays, capacity
