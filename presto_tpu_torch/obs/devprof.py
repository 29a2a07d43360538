"""Device-cost observatory: the cost of a program's first pass, per-node
cost attribution, roofline ratios, and on-demand ``torch.profiler``
capture.

The port of ``presto_tpu/obs/devprof.py``. The reference reads XLA's
``cost_analysis()`` and ``memory_analysis()`` once per compile. The port
compiles nothing: :func:`harvest` counts the operations of one
interpreter pass instead, run on a program's first pass in the process
(``exec/executor.prepare_plan``), and the summary stays in the
process's memory of costs (:func:`known_cost`), so every later run
still attributes. The count is a model, not a measurement:
each aten operation counts its output elements as operations and its
tensor inputs' and outputs' bytes as bytes (views count nothing), and a
kernel entry (``kernels.run``) counts by its kernel's formula
(``kernels.COSTS``, the bytes of PERF.md's bounds) and not by the
operations inside it, on either kernel backend.

Attribution splits one program's figures across its plan nodes
(node-kind FLOP factors x rows-through), which makes "which operator
dominates" answerable from SQL and fixes the rows-proportional wall
split that let a cheap-wide scan absorb an expensive-narrow join's wall.

Roofline ratios compare each node's arithmetic intensity (flops/byte)
against the device balance point ``peak_flops / peak_bw``
(``PRESTO_TPU_DEVICE_PEAK_FLOPS`` / ``PRESTO_TPU_DEVICE_PEAK_BW``; the
host-CPU defaults of the reference, or the card's on a CUDA engine):
ratio >= 1 means compute-bound at peak, < 1 memory-bound.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import tempfile
import threading
import time

from presto_tpu_torch.obs.metrics import REGISTRY

ENV_PEAK_FLOPS = "PRESTO_TPU_DEVICE_PEAK_FLOPS"
ENV_PEAK_BW = "PRESTO_TPU_DEVICE_PEAK_BW"
ENV_PROFILE_DIR = "PRESTO_TPU_PROFILE_DIR"

# Conservative single-socket host-CPU peaks (one AVX2 core feeding
# from DRAM); override per deployment with the env vars above.
_DEFAULT_PEAK_FLOPS = 5.0e10  # 50 GFLOP/s
_DEFAULT_PEAK_BW = 2.0e10     # 20 GB/s
# NVIDIA H100 80GB HBM3 (SXM5, 700 W), from its data sheet. Bytes: the
# HBM3 rate, the one PERF.md's kernel bounds use. Operations: the FP32
# rate of the CUDA cores (132 SMs x 128 lanes x 2 per fused multiply-add
# x 1.98 GHz boost), the rate outside the tensor cores: the engine's
# operations are integer and float element-wise work, compares, hashes
# and gathers, none of them a matrix product.
CUDA_PEAK_FLOPS = 6.7e13  # 67 TFLOP/s
CUDA_PEAK_BW = 3.35e12    # 3.35 TB/s

_CAPTURES = REGISTRY.counter(
    "presto_tpu_profile_captures_total",
    "Device profiler capture attempts by result (started/failed).")
_HARVESTS = REGISTRY.counter(
    "presto_tpu_cost_harvests_total",
    "programs whose first pass was counted for their device cost "
    "(obs/devprof.harvest)")


# -- first-pass harvest ------------------------------------------------------

_COUNTER: contextvars.ContextVar["_Counter | None"] = contextvars.ContextVar(
    "presto_tpu_torch_cost_counter", default=None)


class _Counter:
    """Operations and bytes of the torch calls made on this thread."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.kernels = 0
        self.quiet = 0  # > 0 inside a kernel entry counted by formula

    def summary(self) -> dict | None:
        out = {"ops": self.ops, "kernels": self.kernels}
        if self.flops > 0:
            out["flops"] = float(self.flops)
        if self.bytes > 0:
            out["bytes"] = float(self.bytes)
        return out if self.flops > 0 else None


def _tensor_bytes(values) -> tuple[int, int]:
    """(bytes, elements) of the tensors in ``values`` and in the lists
    and tuples among them (an aten operation's arguments or results)."""
    import torch
    nbytes = elems = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            n = v.numel()
            nbytes += n * v.element_size()
            elems += n
        elif isinstance(v, (list, tuple)):
            for t in v:
                if isinstance(t, torch.Tensor):
                    n = t.numel()
                    nbytes += n * t.element_size()
                    elems += n
    return nbytes, elems


# per aten operation: is it counted? A view (it returns an alias of an
# input it does not write: no data moves) is not, nor is a kernel
# entry's custom op, which counts itself (kernels.run)
_COUNTED: dict = {}


def _counted(func) -> bool:
    counted = _COUNTED.get(func)
    if counted is None:
        counted = func.namespace != "presto_tpu_torch" and not any(
            ret.alias_info is not None and not ret.alias_info.is_write
            for ret in func._schema.returns)
        _COUNTED[func] = counted
    return counted


def _counting_mode(counter: _Counter):
    from torch.utils._python_dispatch import TorchDispatchMode

    def dispatch(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if counter.quiet or not _counted(func):
            return out
        in_bytes, _ = _tensor_bytes(args)
        if kwargs:
            in_bytes += _tensor_bytes(kwargs.values())[0]
        out_bytes, out_elems = _tensor_bytes(
            out if isinstance(out, (list, tuple)) else (out,))
        counter.ops += 1
        counter.flops += out_elems
        counter.bytes += in_bytes + out_bytes
        return out

    class _Counting(TorchDispatchMode):
        pass

    # set after the class is made: a ``__torch_dispatch__`` in the class
    # body is wrapped to keep torch.compile out of it, and the wrapper's
    # first call imports torch._dynamo (and sympy), seconds once a
    # process; the port compiles nothing
    _Counting.__torch_dispatch__ = dispatch
    return _Counting()


@contextlib.contextmanager
def harvest():
    """Count the torch operations run on this thread inside the block
    (a ``TorchDispatchMode``: the mode stack is per thread, and it sees
    the physical operations of a ``torch.func.vmap``). Yields a counter
    whose ``summary()`` is the plain, picklable cost dict
    ``{"flops", "bytes", "ops", "kernels"}``, or None when nothing was
    counted."""
    _HARVESTS.inc()
    counter = _Counter()
    tok = _COUNTER.set(counter)
    try:
        with _counting_mode(counter):
            yield counter
    finally:
        _COUNTER.reset(tok)


def count_kernel(flops: float, nbytes: float):
    """A kernel entry's cost, counted once under a harvest, with the
    torch operations inside the entry left out (``kernels.run``).
    Returns a context manager for the entry's call."""
    counter = _COUNTER.get()
    if counter is None:
        return contextlib.nullcontext()
    if not counter.quiet:
        counter.kernels += 1
        counter.flops += float(flops)
        counter.bytes += float(nbytes)
    return _quiet(counter)


@contextlib.contextmanager
def _quiet(counter: _Counter):
    counter.quiet += 1
    try:
        yield
    finally:
        counter.quiet -= 1


def harvesting() -> bool:
    """Is a harvest counting on this thread?"""
    return _COUNTER.get() is not None


# Each program's cost for the process, under its program-cache key
# without the kernel backend (exec/progcache.backend_free): the key
# holds the plan, its scans' shapes and dictionaries and the device, so
# a program counted once is known to every engine and both backends
# that run it on the same data; bounded, oldest out first
_KNOWN_LOCK = threading.Lock()
_KNOWN: dict = {}
KNOWN_PROGRAMS = 4096


def known_cost(key) -> dict | None:
    """The cost counted for the program under ``key``, or None."""
    with _KNOWN_LOCK:
        return _KNOWN.get(key)


def remember_cost(key, cost: dict | None) -> None:
    """Keep ``cost`` as the program's under ``key``."""
    if cost is None:
        return
    with _KNOWN_LOCK:
        _KNOWN.pop(key, None)
        _KNOWN[key] = cost
        while len(_KNOWN) > KNOWN_PROGRAMS:
            _KNOWN.pop(next(iter(_KNOWN)))


def forget_costs() -> None:
    """Forget every program's cost: the next first pass of each counts
    again."""
    with _KNOWN_LOCK:
        _KNOWN.clear()


def device_peaks(device=None) -> tuple[float, float]:
    """(peak_flops_per_s, peak_bytes_per_s) from the env overrides,
    falling back to the card's figures on a CUDA ``device`` and to the
    host-CPU defaults otherwise (or on absence or garbage)."""
    cuda = device is not None and str(device).startswith("cuda")
    flops_default = CUDA_PEAK_FLOPS if cuda else _DEFAULT_PEAK_FLOPS
    bw_default = CUDA_PEAK_BW if cuda else _DEFAULT_PEAK_BW

    def _env(name: str, default: float) -> float:
        try:
            v = float(os.environ.get(name, "") or 0.0)
        except ValueError:
            return default
        return v if v > 0 else default
    return (_env(ENV_PEAK_FLOPS, flops_default),
            _env(ENV_PEAK_BW, bw_default))


# -- per-node attribution ----------------------------------------------------

# Relative FLOPs-per-row-through by plan-node kind: a join row costs
# hash+probe work that a scan row does not, which is exactly the skew
# the rows-proportional split got wrong.
_FLOP_FACTOR = {
    "TableScan": 1.0, "Filter": 1.0, "Exchange": 1.0, "Limit": 1.0,
    "Project": 2.0, "Unnest": 2.0, "Values": 1.0,
    "Sort": 4.0, "TopN": 4.0,
    "Aggregate": 6.0, "Distinct": 6.0, "Window": 6.0,
    "Join": 8.0, "SemiJoin": 8.0, "MultiJoin": 12.0,
}
_DEFAULT_FLOP_FACTOR = 2.0


def flop_weight(node_type: str, in_rows: int, out_rows: int) -> float:
    """Wall/flops split weight for one node: kind factor x rows-through
    (+1 keeps zero-row nodes attributable)."""
    factor = _FLOP_FACTOR.get(node_type, _DEFAULT_FLOP_FACTOR)
    return factor * (max(0, in_rows) + max(0, out_rows) + 1)


def program_bytes(cost: dict) -> float:
    """Total bytes moved by the program: the harvest's counted bytes
    when present, else an arg+out+temp footprint."""
    b = float(cost.get("bytes") or 0.0)
    if b > 0:
        return b
    return float((cost.get("arg_bytes") or 0)
                 + (cost.get("out_bytes") or 0)
                 + (cost.get("temp_bytes") or 0))


def attribute(cost: dict | None,
              nodes: list[tuple[str, int, int, int]],
              device=None) -> tuple[list[dict], list[float] | None]:
    """Apportion one program's device cost across its plan nodes.

    ``nodes`` is ``[(node_type, in_rows, out_rows, output_bytes)]`` in
    operator order; ``device`` picks the default peaks
    (:func:`device_peaks`). Returns ``(per_node, weights)``:
    ``per_node`` is a list of ``{"flops", "hbmBytes", "intensity",
    "roofline"}`` dicts (empty dicts when no usable cost), ``weights``
    the flops-share wall-split weights (None when the caller should
    fall back to the rows-proportional split)."""
    if not nodes:
        return [], None
    total_flops = float((cost or {}).get("flops") or 0.0)
    total_bytes = program_bytes(cost or {})
    if total_flops <= 0:
        return [{} for _ in nodes], None
    fw = [flop_weight(nt, i, o) for nt, i, o, _b in nodes]
    fw_sum = sum(fw) or 1.0
    # data movement tracks rows-through, without the kind factor
    bw = [float(max(0, i) + max(0, o) + 1) for _nt, i, o, _b in nodes]
    bw_sum = sum(bw) or 1.0
    peak_flops, peak_bw = device_peaks(device)
    ridge = peak_flops / peak_bw if peak_bw > 0 else 1.0
    per_node: list[dict] = []
    for w, b in zip(fw, bw):
        flops = max(1, round(total_flops * w / fw_sum))
        nbytes = max(1, round(total_bytes * b / bw_sum)) \
            if total_bytes > 0 else 1
        intensity = flops / nbytes
        per_node.append({
            "flops": int(flops),
            "hbmBytes": int(nbytes),
            "intensity": round(float(intensity), 4),
            "roofline": round(float(intensity / ridge), 4),
        })
    return per_node, fw


# -- on-demand torch.profiler capture ----------------------------------------

_PROF_LOCK = threading.Lock()
# Kineto is process-global: one capture at a time. The capture runs on
# a thread of its own, so a start and a stop may come from different
# threads (each HTTP request has one), and it records every thread's
# operations
_PROF: dict = {"active": False, "dir": None, "stop": None, "thread": None,
               "result": None}

TRACE_FILE = "trace.json"


def profile_base_dir() -> str:
    return (os.environ.get(ENV_PROFILE_DIR)
            or os.path.join(tempfile.gettempdir(),
                            "presto_tpu_profiles"))


def capturing() -> bool:
    with _PROF_LOCK:
        return bool(_PROF["active"])


def _profiler(cuda: bool):
    """A Kineto profile of every thread's CPU activity (and the CUDA
    activity when ``cuda``): the ``torch.autograd.profiler.profile``
    that ``torch.profiler.profile`` drives, taken directly, since the
    wrapper's start imports torch._inductor (and torch._dynamo): seconds
    the first capture of a process would pay."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd.profiler import profile
    return profile(use_cpu=True, use_device="cuda" if cuda else None,
                   use_kineto=True, experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _run_capture(prof, started: threading.Event, stop: threading.Event,
                 result: dict, path: str) -> None:
    try:
        prof.__enter__()
    except Exception as exc:  # noqa: BLE001 - reported by start_capture
        result["error"] = f"{type(exc).__name__}: {exc}"
        started.set()
        return
    started.set()
    stop.wait()
    try:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
    except Exception as exc:  # noqa: BLE001 - reported by stop_capture
        result["error"] = f"{type(exc).__name__}: {exc}"


def start_capture(tag: str = "manual", cuda: bool | None = None) -> dict:
    """Start a ``torch.profiler`` capture into a fresh subdirectory of
    ``PRESTO_TPU_PROFILE_DIR``, with the CUDA activity when ``cuda``
    (default: whether CUDA is available). Idempotent: a second start
    while one is live reports the live capture instead of erroring."""
    import torch
    if cuda is None:
        cuda = torch.cuda.is_available()
    with _PROF_LOCK:
        if _PROF["active"]:
            return {"profiling": True, "dir": _PROF["dir"],
                    "started": False}
        safe_tag = "".join(c if c.isalnum() or c in "-_." else "_"
                           for c in str(tag))[:80] or "capture"
        d = os.path.join(
            profile_base_dir(),
            f"{safe_tag}-{int(time.time() * 1000)}-{os.getpid()}")
        result: dict = {}
        started, stop = threading.Event(), threading.Event()
        try:
            os.makedirs(d, exist_ok=True)
            thread = threading.Thread(
                target=_run_capture, name="presto-tpu-profiler",
                args=(_profiler(cuda), started, stop, result,
                      os.path.join(d, TRACE_FILE)), daemon=True)
            thread.start()
            started.wait()
            if "error" in result:
                raise RuntimeError(result["error"])
        except Exception as exc:  # noqa: BLE001 - host may lack profiler
            _CAPTURES.inc(result="failed")
            return {"profiling": False, "started": False,
                    "error": f"{type(exc).__name__}: {exc}"}
        _PROF.update(active=True, dir=d, stop=stop, thread=thread,
                     result=result)
        _CAPTURES.inc(result="started")
        return {"profiling": True, "dir": d, "started": True}


def stop_capture() -> dict:
    """Stop the live capture and write its Chrome trace
    (``trace.json``, Perfetto-loadable); returns the artifact directory,
    or None when no capture was live."""
    with _PROF_LOCK:
        if not _PROF["active"]:
            return {"profiling": False, "artifact": None}
        d, stop, thread, result = (_PROF["dir"], _PROF["stop"],
                                   _PROF["thread"], _PROF["result"])
        _PROF.update(active=False, dir=None, stop=None, thread=None,
                     result=None)
        stop.set()
        thread.join()
        if "error" in result:
            return {"profiling": False, "artifact": None,
                    "error": result["error"]}
        return {"profiling": False, "artifact": d}


@contextlib.contextmanager
def maybe_capture(enabled: bool, tag: str = "query",
                  cuda: bool | None = None):
    """Wrap one query's execution in a capture when the
    ``device_profile`` session property asks for it. Yields the
    artifact directory (known up front — callers stamp it into the
    query record before running) or None when disabled, unsupported,
    or another capture already owns the process's profiler."""
    if not enabled:
        yield None
        return
    res = start_capture(tag, cuda)
    if not res.get("started"):
        yield None
        return
    try:
        yield res["dir"]
    finally:
        stop_capture()
