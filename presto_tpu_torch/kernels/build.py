"""Build the CUDA kernels (``csrc/*.cu``) with nvcc and load them.

The sources compile at first use, one ``nvcc -c`` per source started
together, into one shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so the build takes seconds). The
library lands in ``build/presto_tpu_torch/`` at the repository root,
named by a digest of the sources and flags, so an edited source
rebuilds and an unchanged one loads the library already built.

Every wrapper launches through :data:`LIBRARY` and counts its launches
in :data:`LAUNCHES`, so a run can show which kernels the main path went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "presto_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# multijoin_walk's descriptor layout (csrc/multijoin.cu; checked
# against the library at load). The walk takes it by value as one
# kernel parameter, so it is packed on the host and never copied to the
# device by the wrapper.
MJ_MAX_STEPS = 8
MJ_MAX_KEYS = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class MjKey(ctypes.Structure):
    """One probe key: ``source`` -1 for the spine, else the earlier
    build step whose matched row indexes the key's column; ``hash`` and
    ``valid`` (0 = no nulls) are device addresses."""
    _fields_ = [("source", _L), ("hash", _P), ("valid", _P)]


class MjStep(ctypes.Structure):
    """One walk step: its table's address, the slot mask, its keys."""
    _fields_ = [("table", _P), ("mask", _L), ("nkeys", _L),
                ("keys", MjKey * MJ_MAX_KEYS)]


class MjDesc(ctypes.Structure):
    """The walk's kernel parameter: MJ_MAX_STEPS steps, 960 bytes."""
    _fields_ = [("steps", MjStep * MJ_MAX_STEPS)]


# filter_compact's column descriptors (csrc/compact.cu; checked against
# the library at load), passed by value like MjDesc: at most
# COMPACT_MAX_COLS columns a launch.
COMPACT_MAX_COLS = 32


class CompactCol(ctypes.Structure):
    """One column: the device addresses of its rows and of its output
    rows, and the bytes of one row."""
    _fields_ = [("src", _P), ("dst", _P), ("row_bytes", _L)]


class CompactDesc(ctypes.Structure):
    """The compaction's kernel parameter: COMPACT_MAX_COLS columns, 776
    bytes."""
    _fields_ = [("ncols", _L), ("cols", CompactCol * COMPACT_MAX_COLS)]


def compact_layout() -> tuple[int, ...]:
    """The layout ``pt_compact_layout`` reports for the structs above:
    the column limit, then CompactDesc's size and field offsets,
    CompactCol's size and field offsets."""
    return (COMPACT_MAX_COLS, ctypes.sizeof(CompactDesc),
            CompactDesc.ncols.offset, CompactDesc.cols.offset,
            ctypes.sizeof(CompactCol), CompactCol.src.offset,
            CompactCol.dst.offset, CompactCol.row_bytes.offset)


def mj_layout() -> tuple[int, ...]:
    """The layout ``pt_multijoin_layout`` reports for the structs above:
    the limits, then MjDesc's size, MjStep's size and field offsets,
    MjKey's size and field offsets."""
    return (MJ_MAX_STEPS, MJ_MAX_KEYS, ctypes.sizeof(MjDesc),
            ctypes.sizeof(MjStep), MjStep.table.offset, MjStep.mask.offset,
            MjStep.nkeys.offset, MjStep.keys.offset, ctypes.sizeof(MjKey),
            MjKey.source.offset, MjKey.hash.offset, MjKey.valid.offset)


_SIGNATURES = {
    "pt_segment_sum": [_P, _I, _P, _L, _I, _L, _L, _P, _P],
    "pt_segment_cmp": [_P, _I, _P, _L, _I, _I, _L, _L, _P, _P],
    "pt_filter_compact": [_P, _L, _P, _L, _P, _I, _P],
    "pt_compact_tile_rows": [],
    "pt_compact_layout": [_P, _I],
    "pt_build_part_counters": [],
    "pt_build_table": [_P, _P, _L, _P, _L, _I, _P, _P, _P, _P, _P],
    "pt_probe_table": [_P, _L, _P, _P, _L, _I, _P, _P, _P, _P],
    "pt_multijoin_walk": [_P, _I, _P, _L, _I, _P, _P, _P, _P],
    "pt_multijoin_layout": [_P, _I],
}


class LaunchCounts:
    """Launches per kernel. Each wrapper adds one where it launches
    its kernel, and nowhere else."""

    NAMES = ("segment_sum", "segment_max", "segment_min", "build_table",
             "probe_table", "multijoin_walk", "filter_compact")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = dict.fromkeys(self.NAMES, 0)

    def add(self, name: str) -> None:
        with self._lock:
            self.counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.counts = dict.fromkeys(self.NAMES, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counts)


LAUNCHES = LaunchCounts()

# lint/kernels.py kernel-parity rule: *_cuda functions outside the
# dispatch table must justify themselves
KERNEL_DISPATCH_EXEMPT = {
    "require_cuda": "the argument check every wrapper makes before it "
                    "launches (contiguous CUDA tensors on one device); "
                    "it launches nothing",
}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "presto_tpu_torch build from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one shared
    library; returns its path. Raises with nvcc's output on failure."""
    sources = sorted(CSRC.glob("*.cu"))
    target = BUILD_DIR / f"libpresto_tpu_torch_{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        staged = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(staged),
             *[str(obj) for _s, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(staged, target)  # atomic against a concurrent build
    return target


def _check_layout(report, want: tuple[int, ...], what: str) -> None:
    """Raise unless the library's ``report`` of a descriptor layout is
    the host's ``want``."""
    got = (ctypes.c_longlong * len(want))()
    count = report(got, len(want))
    if count != len(want) or tuple(got) != want:
        raise RuntimeError(f"{what} descriptor layout mismatch: library "
                           f"{tuple(got)[:count]}, host {want}")


class KernelLibrary:
    """The loaded shared library; builds it on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.path: Path | None = None
        self.build_seconds: float | None = None
        self.compact_tile_rows = 0  # rows per filter_compact tile
        self.build_part_counters = 0  # ints of a partitioned build

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                self.path = build_library()
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _check_layout(lib.pt_multijoin_layout, mj_layout(),
                              "multijoin")
                _check_layout(lib.pt_compact_layout, compact_layout(),
                              "compact")
                self.compact_tile_rows = lib.pt_compact_tile_rows()
                self.build_part_counters = lib.pt_build_part_counters()
                self._lib = lib
                self.build_seconds = time.perf_counter() - t0
            return self._lib


LIBRARY = KernelLibrary()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise when a launch reported an error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require_cuda(name: str, **tensors: torch.Tensor) -> None:
    """Every tensor is a contiguous CUDA tensor on one device."""
    devices = set()
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def require_dtype(name: str, arg: str, t: torch.Tensor,
                  *dtypes: torch.dtype) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {arg} has dtype {t.dtype}, expected "
                         f"one of {dtypes}")
