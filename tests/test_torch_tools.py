"""The port's measurement scripts, on the CPU: which hand-written kernel
``profile_port.py --kernels`` charges a profiled CUDA function to, the
names templated kernels included, and its per-wrapper share; and the
keys ``kernel_ab.py`` gives each timed case."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def profile_port():
    sys.path.insert(0, str(REPO))
    try:
        import profile_port
    finally:
        sys.path.remove(str(REPO))
    return profile_port


@pytest.mark.parametrize("event,wrapper", [
    ("void (anonymous namespace)::probe_table_kernel(pt::Slot const*, "
     "unsigned int, unsigned long long const*, bool const*, long long, "
     "int, int*, bool*, int*)", "probe_table"),
    ("void (anonymous namespace)::multijoin_walk_kernel<3>(pt::MjDesc, "
     "bool const*, long long, int, int*, bool*, int*)", "multijoin_walk"),
    ("void (anonymous namespace)::multijoin_walk_kernel<8>(pt::MjDesc)",
     "multijoin_walk"),
    ("void (anonymous namespace)::build_part_kernel(long long const*)",
     "build_table"),
    ("void (anonymous namespace)::part_count_kernel(long long const*)",
     "build_table"),
    ("void (anonymous namespace)::seg_sum_reg<long long, 8>(long long "
     "const*)", "segment_sum"),
    ("void (anonymous namespace)::seg_cmp_shared<int, true>(int const*)",
     "segment_max"),
    ("void (anonymous namespace)::seg_cmp_global<int, false>(int const*)",
     "segment_min"),
    ("void (anonymous namespace)::scatter_kernel(int)", "filter_compact"),
    ("void (anonymous namespace)::seg_cmp_reg<long long, 8, true>(long "
     "long const*, int const*, long long, long long, long long, int, long "
     "long, long long*)", "segment_max"),
    ("void (anonymous namespace)::seg_cmp_reg<int, 1, false>(int const*)",
     "segment_min"),
    ("void (anonymous namespace)::seg_cmp_lanes<short, 32, true>(short "
     "const*)", "segment_max"),
    ("void (anonymous namespace)::seg_cmp_lanes<int, 16, false>(int const*)",
     "segment_min"),
    ("void (anonymous namespace)::seg_cmp_shared<long long, false>(long "
     "long const*)", "segment_min"),
    ("void (anonymous namespace)::compact_kernel<true>(bool const*, long "
     "long, pt::CompactDesc, long long, long long, unsigned long long*)",
     "filter_compact"),
    ("void (anonymous namespace)::compact_kernel<false>(bool const*)",
     "filter_compact"),
    ("void (anonymous namespace)::zero_tail_kernel(pt::CompactDesc, long "
     "long, unsigned long long const*)", "filter_compact"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
])
def test_profile_port_charges_each_kernel(profile_port, event, wrapper):
    assert profile_port.kernel_of(event) == wrapper


def test_profile_port_kernel_share_charges_each_wrapper(profile_port):
    # every launch of a wrapper's CUDA functions is charged to that
    # wrapper's row, beside its wrapper launches; other events to none
    from torch.autograd import DeviceType

    class Event:
        def __init__(self, key, us, count):
            self.key, self.self_device_time_total = key, us
            self.count, self.device_type = count, DeviceType.CUDA
    events = [Event("void (anonymous namespace)::part_count_kernel(int)",
                    250, 2),
              Event("void (anonymous namespace)::build_part_kernel(int)",
                    500, 2),
              Event("void (anonymous namespace)::multijoin_walk_kernel<3>"
                    "(pt::MjDesc)", 2000, 1),
              Event("void at::native::vectorized_elementwise_kernel<4>"
                    "(int)", 900, 5)]
    share = profile_port.kernel_share(events, {"multijoin_walk": 1,
                                               "build_table": 2,
                                               "probe_table": 0})
    assert share["build_table"] == {
        "ms": 0.75, "device_launches": 4, "launches": 2,
        "functions": {"part_count_kernel": 0.25, "build_part_kernel": 0.5}}
    assert share["multijoin_walk"]["ms"] == 2.0
    assert share["multijoin_walk"]["functions"] == {
        "multijoin_walk_kernel": 2.0}
    assert share["probe_table"]["ms"] == 0.0
    assert set(share) == {"multijoin_walk", "build_table", "probe_table"}


@pytest.mark.parametrize("name,case,key", [
    ("segment_max", {"case": "k=6 int32", "k": 6, "ms": 1.0},
     "segment_max k=6 int32"),
    ("segment_min", {"case": "k=1048576 sorted", "k": 1 << 20},
     "segment_min k=1048576 sorted"),
    ("segment_sum", {"k": 32, "ms": 1.0}, "segment_sum k=32"),
    ("filter_compact", {"ms": 1.0, "gather_floor_ms": 0.5},
     "filter_compact"),
])
def test_kernel_ab_case_keys(name, case, key):
    # every timed case of the kernel phase has a key of its own, so the
    # int32 and sorted cases of one k do not overwrite each other
    sys.path.insert(0, str(REPO))
    try:
        import kernel_ab
    finally:
        sys.path.remove(str(REPO))
    assert kernel_ab.case_key(name, case) == key
