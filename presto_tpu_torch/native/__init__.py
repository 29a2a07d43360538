"""Native runtime components (C++), bound via ctypes.

The port of ``presto_tpu/native``: the page codec of the multi-host
data plane (a from-scratch LZ77 codec + CRC-32C, see
src/pageserde.cpp), byte-identical to the reference's.

The shared library builds lazily with g++ on first use into
``build/presto_tpu_torch/`` at the repository root (ignored by git,
beside the CUDA kernels of ``kernels/build.py``), named by a hash of
the source. Everything degrades gracefully: ``codec()`` returns
``None`` when no toolchain is available and callers fall back to the
pure-Python wire format. ``BUILD_SECONDS`` holds the time the build
took in this process (0.0 when the library was already built).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "pageserde.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "presto_tpu_torch")
BUILD_SECONDS = 0.0

_lock = threading.Lock()
_codec: "PageCodec | None | bool" = False  # False = not yet attempted


def _lib_path() -> str:
    """Artifact name keyed by a hash of the source: a stale binary can
    never be picked up (mtimes are not preserved across git checkouts,
    so an mtime staleness check is unreliable)."""
    import hashlib
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libpageserde-{digest}.so")


def _build() -> str | None:
    """Compile the shared library if missing; returns its path."""
    global BUILD_SECONDS
    try:
        lib = _lib_path()
        if not os.path.exists(lib):
            t0 = time.perf_counter()
            os.makedirs(BUILD_DIR, exist_ok=True)
            # pid-unique temp: concurrent workers building at once must
            # not interleave writes into one file
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
            BUILD_SECONDS = time.perf_counter() - t0
            # drop artifacts of superseded source versions; .so only —
            # another process's in-flight .tmp must not be removed
            import glob
            for stale in glob.glob(
                    os.path.join(BUILD_DIR, "libpageserde*.so")):
                if os.path.abspath(stale) != os.path.abspath(lib):
                    try:
                        os.remove(stale)
                    except OSError:
                        pass
        return lib
    except Exception:
        return None


class PageCodec:
    """ctypes wrapper over the native ppage codec."""

    def __init__(self, lib_path: str):
        lib = ctypes.CDLL(lib_path)
        lib.ppage_bound.restype = ctypes.c_size_t
        lib.ppage_bound.argtypes = [ctypes.c_size_t]
        lib.ppage_compress.restype = ctypes.c_size_t
        lib.ppage_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t]
        lib.ppage_decompress.restype = ctypes.c_size_t
        lib.ppage_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t]
        lib.ppage_crc32c.restype = ctypes.c_uint32
        lib.ppage_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        self._lib = lib

    def compress(self, data: bytes) -> bytes:
        n = len(data)
        cap = self._lib.ppage_bound(n)
        buf = ctypes.create_string_buffer(cap)
        size = self._lib.ppage_compress(data, n, buf, cap)
        if size == 0 and n:
            raise RuntimeError("ppage_compress failed")
        return buf.raw[:size]

    def decompress(self, data: bytes, orig_size: int) -> bytes:
        buf = ctypes.create_string_buffer(max(orig_size, 1))
        size = self._lib.ppage_decompress(
            data, len(data), buf, orig_size)
        if size != orig_size:
            raise ValueError("ppage: corrupt block "
                             f"(got {size}, want {orig_size})")
        return buf.raw[:orig_size]

    def crc32c(self, data: bytes) -> int:
        return int(self._lib.ppage_crc32c(data, len(data)))


def codec() -> PageCodec | None:
    """The process-wide native codec, or None when unavailable
    (toolchain missing, build failure, PRESTO_TPU_NO_NATIVE=1)."""
    global _codec
    if _codec is False:
        with _lock:
            if _codec is False:
                if os.environ.get("PRESTO_TPU_NO_NATIVE") == "1":
                    _codec = None
                else:
                    path = _build()
                    try:
                        # load failure (stale/corrupt/wrong-arch .so)
                        # degrades to the pure-Python wire format
                        _codec = PageCodec(path) if path else None
                    except OSError:
                        _codec = None
    return _codec  # type: ignore[return-value]
