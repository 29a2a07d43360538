"""Binary columnar wire formats for the multi-host data plane.

Two page codecs, negotiated per request (PAPERS.md 2204.03032: at
exchange rates the serde, not the transport, is what leaves the link
idle):

- ``arrow`` (the default whenever pyarrow is importable): each page is
  ONE Arrow ``RecordBatch`` serialized as an IPC stream. numpy columns
  wrap into Arrow arrays ZERO-COPY (``pa.array`` over the primitive
  buffer); dictionary-encoded varchar columns map to Arrow dictionary
  arrays (code -1 padding rides as a null index and round-trips back to
  -1); LONG-decimal limb pairs ``[n, 2]`` ship as
  ``FixedSizeList<int64>[2]`` over the flattened limb buffer; boolean
  data and ``valid``/``__live__`` masks ship as uint8 siblings (Arrow's
  bit-packed booleans would force a pack/unpack copy each way) and view
  back to bool. The logical SQL type and the physical numpy dtype ride
  in the schema metadata, so readers reconstruct exact ``Column``s with
  ``zero_copy_only`` numpy views wherever the dtype allows. The spool
  re-frames the same batches as Arrow IPC *files* (``ARROW1`` magic)
  for mmap serving; readers here accept both framings.
- ``npz`` (fallback + mixed-version compatibility): the original framed
  ``np.savez`` container, compressed by the native C++ page codec with
  a CRC-32C integrity check (presto_tpu_torch/native) when available.

Readers sniff the payload magic, so any reader handles any codec; the
``Accept`` negotiation in the exchange endpoints exists so an
npz-only consumer in a mixed-version cluster is served a transcoded
page instead of bytes it cannot parse. ``PRESTO_TPU_WIRE=arrow|npz``
forces the producer-side codec process-wide; the session property
``exchange_wire_codec`` overrides per query.
"""

from __future__ import annotations

import io
import json
import os
import struct
import time

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table
from presto_tpu_torch.obs.metrics import REGISTRY

WIRE_ARROW = "arrow"
WIRE_NPZ = "npz"
WIRE_CODECS = (WIRE_ARROW, WIRE_NPZ)

# arrow page frame: 4-byte magic then a raw Arrow IPC *stream*
ARROW_STREAM_MAGIC = b"ARW1"
# Arrow IPC *file* payloads (the spool's mmap-servable page form) are
# served verbatim off the page cache; the format's own leading magic is
# the discriminator
ARROW_FILE_MAGIC = b"ARROW1\x00\x00"

# content types for the exchange Accept negotiation
CONTENT_TYPES = {
    WIRE_ARROW: "application/vnd.presto-tpu.arrow",
    WIRE_NPZ: "application/vnd.presto-tpu.npz",
}

_ENCODE_SECONDS = REGISTRY.histogram(
    "presto_tpu_wire_encode_seconds",
    "page serialization wall time, by codec")
_DECODE_SECONDS = REGISTRY.histogram(
    "presto_tpu_wire_decode_seconds",
    "page deserialization wall time, by codec")
_TRANSCODED = REGISTRY.counter(
    "presto_tpu_wire_transcoded_pages_total",
    "exchange pages transcoded between codecs for an Accept-"
    "negotiating consumer (mixed-version clusters)")

# framed-page header: magic | u8 flags | u64 raw size | u32 crc32c(body)
# | u32 crc32c(header[:13]) — the header carries its own checksum so a
# corrupted raw_size cannot drive an unbounded allocation
_MAGIC = b"PPG1"
_HEADER = struct.Struct("<4sBQII")

_PA = None
_PA_CHECKED = False


def _pyarrow():
    """The pyarrow module, or None (container without it — the npz
    codec then carries everything, same wire contract)."""
    global _PA, _PA_CHECKED
    if not _PA_CHECKED:
        try:
            import pyarrow as pa
            _PA = pa
        except Exception:  # noqa: BLE001 - absent/broken install
            _PA = None
        _PA_CHECKED = True
    return _PA


def have_arrow() -> bool:
    return _pyarrow() is not None


def default_codec() -> str:
    """Producer-side codec: PRESTO_TPU_WIRE env override, else arrow
    when available. Read at call time so tests (and mixed-version
    rollouts) can flip it without re-importing."""
    env = os.environ.get("PRESTO_TPU_WIRE", "").strip().lower()
    if env == WIRE_NPZ:
        return WIRE_NPZ
    # explicit arrow and the unset default resolve the same way: an
    # arrow request on a pyarrow-less host degrades to npz (both
    # codecs are one wire contract; readers sniff)
    return WIRE_ARROW if have_arrow() else WIRE_NPZ


def resolve_codec(codec: str | None) -> str:
    if not codec:
        return default_codec()
    codec = str(codec).strip().lower()
    if codec not in WIRE_CODECS:
        raise ValueError(f"unknown wire codec {codec!r} "
                         f"(one of {WIRE_CODECS})")
    if codec == WIRE_ARROW and not have_arrow():
        return WIRE_NPZ
    return codec


def payload_codec(payload) -> str:
    """Sniff a page payload's codec (readers accept any; the exchange
    endpoints label served bytes with this)."""
    head = bytes(memoryview(payload)[:8])
    if head[:4] == ARROW_STREAM_MAGIC or head == ARROW_FILE_MAGIC:
        return WIRE_ARROW
    return WIRE_NPZ


def accept_header(codec: str | None = None) -> str:
    """The consumer's Accept line: the codecs THIS process can decode,
    preferred one first. A server holding a page in a non-accepted
    codec transcodes before serving."""
    preferred = resolve_codec(codec)
    if preferred == WIRE_ARROW:
        return (f"{CONTENT_TYPES[WIRE_ARROW]}, "
                f"{CONTENT_TYPES[WIRE_NPZ]};q=0.5")
    return CONTENT_TYPES[WIRE_NPZ]


def accepted_codecs(accept: str | None) -> tuple[str, ...]:
    """Codecs an Accept header admits. A MISSING header means an
    old-version consumer that predates the arrow codec: npz only —
    that asymmetry is the whole mixed-version story (current
    consumers always send the header)."""
    if accept is None:
        return (WIRE_NPZ,)
    accept = accept.lower()
    if "*/*" in accept:
        return WIRE_CODECS
    out = tuple(c for c in WIRE_CODECS if CONTENT_TYPES[c] in accept)
    return out or (WIRE_NPZ,)


# -- native-framed npz codec (the fallback wire) -----------------------------


def _frame(raw: bytes) -> bytes:
    from presto_tpu_torch.native import codec
    c = codec()
    if c is None:
        return raw
    body = c.compress(raw)
    if len(body) >= len(raw):  # incompressible: don't pay decompression
        return raw
    head = struct.pack("<4sBQ", _MAGIC, 1, len(raw))
    return head + struct.pack(
        "<II", c.crc32c(body), c.crc32c(head)) + body


def _deframe(payload: bytes) -> bytes:
    if payload[:4] != _MAGIC:
        return payload  # legacy / uncompressed npz
    from presto_tpu_torch.native import codec
    c = codec()
    if c is None:
        raise RuntimeError(
            "received a native-compressed page but the native codec is "
            "unavailable on this host")
    if len(payload) < _HEADER.size:
        raise ValueError("page frame truncated")
    _m, _flags, raw_size, crc, hcrc = _HEADER.unpack_from(payload)
    if c.crc32c(payload[:13]) != hcrc:
        raise ValueError("page header checksum mismatch")
    body = payload[_HEADER.size:]
    if c.crc32c(body) != crc:
        raise ValueError("page checksum mismatch (corrupt exchange frame)")
    return c.decompress(body, raw_size)


def _npz_encode(cols: dict[str, Column]) -> bytes:
    arrays: dict[str, np.ndarray] = {}
    names = []
    for name, col in cols.items():
        names.append(name)
        data = np.asarray(col.data)
        if data.dtype == object:
            # host-materialized strings (varlen aggregates): ship as
            # unicode + a None mask (np.savez cannot pickle-free an
            # object array) — mirrors the arrow codec's string column
            arrays[f"o:{name}"] = np.asarray(
                [("" if v is None else str(v)) for v in data],
                dtype="U")
            arrays[f"on:{name}"] = np.asarray(
                [v is None for v in data], dtype=bool)
        else:
            arrays[f"d:{name}"] = data
        if col.valid is not None:
            arrays[f"v:{name}"] = np.asarray(col.valid)
        if col.dictionary is not None:
            # object dictionaries ship as unicode arrays
            arrays[f"s:{name}"] = np.asarray(col.dictionary, dtype="U")
        arrays[f"t:{name}"] = np.frombuffer(
            str(col.dtype).encode(), dtype=np.uint8)
    arrays["__names__"] = np.asarray(names, dtype="U")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return _frame(buf.getvalue())


def _npz_decode(payload: bytes) -> tuple[dict[str, Column], int]:
    from presto_tpu_torch.types import parse_type

    payload = _deframe(bytes(payload))
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        names = [str(s) for s in z["__names__"]]
        cols: dict[str, Column] = {}
        nrows = 0
        for name in names:
            if f"o:{name}" in z:
                data = z[f"o:{name}"].astype(object)
                data[z[f"on:{name}"]] = None
            else:
                data = z[f"d:{name}"]
            valid = z[f"v:{name}"] if f"v:{name}" in z else None
            dictionary = None
            if f"s:{name}" in z:
                dictionary = z[f"s:{name}"].astype(object)
            dtype = parse_type(
                bytes(z[f"t:{name}"]).decode())
            cols[name] = Column(dtype, data, valid, dictionary)
            nrows = len(data)
    return cols, nrows


# -- arrow codec -------------------------------------------------------------

# schema-metadata keys: logical SQL type and physical numpy dtype per
# column (the wire carries PHYSICAL arrays; bool rides as uint8)
_META_TYPES = b"presto_tpu_types"
_META_PHYS = b"presto_tpu_phys"


def _arrow_batch(cols: dict[str, Column]):
    """One RecordBatch over the columns' physical buffers. Primitive
    data wraps zero-copy; only bit-incompatible forms copy (object
    strings, -1-coded dictionary indices get a null mask)."""
    pa = _pyarrow()
    arrays, fields = [], []
    types_meta: dict[str, str] = {}
    phys_meta: dict[str, str] = {}
    for name, col in cols.items():
        data = np.asarray(col.data)
        types_meta[name] = str(col.dtype)
        phys_meta[name] = data.dtype.str
        if col.dictionary is not None:
            # safe=False: codes ship VERBATIM in the index buffer
            # (zero-copy both ways). -1 padding (outer-join fill) and
            # over-range sentinels are legitimate on this wire —
            # decoders clip at string-materialization time, exactly
            # as they did for the npz codec — and Arrow's bounds
            # validation would reject them
            idx = pa.array(np.ascontiguousarray(data))
            dictionary = pa.array(
                [str(s) for s in col.dictionary], type=pa.string())
            arr = pa.DictionaryArray.from_arrays(idx, dictionary,
                                                 safe=False)
        elif data.ndim == 2:
            # LONG-decimal limb pairs [n, k]: FixedSizeList<int64>[k]
            # over the flattened limb buffer (a contiguous [n, k]
            # reshapes to [n*k] as a view — zero copy)
            flat = np.ascontiguousarray(data).reshape(-1)
            arr = pa.FixedSizeListArray.from_arrays(
                pa.array(flat), data.shape[1])
        elif data.dtype == np.bool_:
            # uint8 view, not Arrow's bit-packed booleans: the pack
            # would copy on encode AND the unpack on decode
            arr = pa.array(np.ascontiguousarray(data).view(np.uint8))
        elif data.dtype == object:
            # host-materialized strings (varlen aggregates): real
            # Arrow strings, decoded back to an object array
            arr = pa.array(
                [None if v is None else str(v) for v in data],
                type=pa.string())
        else:
            arr = pa.array(np.ascontiguousarray(data))
        arrays.append(arr)
        fields.append(pa.field(f"d:{name}", arr.type))
        if col.valid is not None:
            v = pa.array(np.ascontiguousarray(
                np.asarray(col.valid)).view(np.uint8))
            arrays.append(v)
            fields.append(pa.field(f"v:{name}", v.type))
    schema = pa.schema(fields, metadata={
        _META_TYPES: json.dumps(types_meta).encode(),
        _META_PHYS: json.dumps(phys_meta).encode()})
    return pa.record_batch(arrays, schema=schema)


def _arrow_encode(cols: dict[str, Column]) -> bytes:
    pa = _pyarrow()
    batch = _arrow_batch(cols)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as writer:
        writer.write_batch(batch)
    return ARROW_STREAM_MAGIC + sink.getvalue().to_pybytes()


def _np_view(arr, want: np.dtype) -> np.ndarray:
    """Arrow array -> numpy in the exact physical dtype, zero-copy
    wherever the layout allows (no nulls, same itemsize)."""
    if arr.null_count == 0:
        out = arr.to_numpy(zero_copy_only=True)
    else:
        out = arr.to_numpy(zero_copy_only=False)
    if out.dtype != want:
        if out.dtype.itemsize == want.itemsize:
            out = out.view(want)  # uint8 -> bool and friends
        else:
            out = out.astype(want)
    return out


def _column_from_arrow(arr, dtype: T.DataType, phys: str,
                       valid_arr) -> Column:
    pa = _pyarrow()
    want = np.dtype(phys)
    dictionary = None
    if isinstance(arr.type, pa.DictionaryType):
        data = _np_view(arr.indices, want)
        dictionary = np.asarray(arr.dictionary).astype(object)
    elif pa.types.is_fixed_size_list(arr.type):
        k = arr.type.list_size
        flat = _np_view(arr.flatten(), want)
        data = flat.reshape(-1, k)
    elif pa.types.is_string(arr.type) or pa.types.is_large_string(
            arr.type):
        data = np.asarray(
            arr.to_numpy(zero_copy_only=False)).astype(object)
    else:
        data = _np_view(arr, want)
    valid = None
    if valid_arr is not None:
        valid = _np_view(valid_arr, np.dtype(np.bool_))
    return Column(dtype, data, valid, dictionary)


def _arrow_batches(payload):
    """Every RecordBatch in an arrow payload (stream or file framing),
    zero-copy over the payload's buffer."""
    pa = _pyarrow()
    if pa is None:
        raise RuntimeError(
            "received an arrow wire page but pyarrow is unavailable "
            "on this host (set PRESTO_TPU_WIRE=npz cluster-wide)")
    view = memoryview(payload)
    if bytes(view[:8]) == ARROW_FILE_MAGIC:
        reader = pa.ipc.open_file(pa.py_buffer(view))
        return [reader.get_batch(i) for i in range(reader.num_record_batches)]
    reader = pa.ipc.open_stream(pa.py_buffer(view[4:]))
    return list(reader)


def _columns_from_batch(batch) -> tuple[dict[str, Column], int]:
    from presto_tpu_torch.types import parse_type

    types_meta = json.loads(batch.schema.metadata[_META_TYPES])
    phys_meta = json.loads(batch.schema.metadata[_META_PHYS])
    names = {f.name: i for i, f in enumerate(batch.schema)}
    cols: dict[str, Column] = {}
    for name, tstr in types_meta.items():
        arr = batch.column(names[f"d:{name}"])
        valid_arr = None
        vkey = f"v:{name}"
        if vkey in names:
            valid_arr = batch.column(names[vkey])
        cols[name] = _column_from_arrow(
            arr, parse_type(tstr), phys_meta[name], valid_arr)
    return cols, batch.num_rows


def _arrow_decode(payload) -> tuple[dict[str, Column], int]:
    batches = _arrow_batches(payload)
    if not batches:
        return {}, 0
    if len(batches) == 1:
        return _columns_from_batch(batches[0])
    parts = [_columns_from_batch(b) for b in batches]
    return concat_columns([p[0] for p in parts]), sum(
        p[1] for p in parts)


def arrow_file_bytes(payload) -> bytes | None:
    """Re-frame an ``ARW1`` stream page as an Arrow IPC FILE (the
    spool's mmap-servable form). The batches' buffers are referenced,
    not parsed — no value decode. None when the payload is not an
    arrow stream page (npz pages spool verbatim)."""
    pa = _pyarrow()
    if pa is None or payload_codec(payload) != WIRE_ARROW:
        return None
    view = memoryview(payload)
    if bytes(view[:8]) == ARROW_FILE_MAGIC:
        return bytes(view)  # already file-framed
    batches = _arrow_batches(payload)
    if not batches:
        return None
    sink = pa.BufferOutputStream()
    with pa.ipc.new_file(sink, batches[0].schema) as writer:
        for b in batches:
            writer.write_batch(b)
    return sink.getvalue().to_pybytes()


# -- public codec API --------------------------------------------------------


def columns_to_bytes(cols: dict[str, Column],
                     codec: str | None = None) -> bytes:
    """Serialize a {name: Column} payload with ``codec`` (None = the
    negotiated default)."""
    codec = resolve_codec(codec)
    t0 = time.perf_counter()
    if codec == WIRE_ARROW:
        out = _arrow_encode(cols)
    else:
        out = _npz_encode(cols)
    _ENCODE_SECONDS.observe(time.perf_counter() - t0, codec=codec)
    return out


def table_to_bytes(table: Table, compact: bool = True,
                   codec: str | None = None) -> bytes:
    """Serialize a Table (optionally dropping dead rows)."""
    cols = table.columns
    if compact and table.mask is not None:
        from presto_tpu_torch.parallel.exchange_host import slice_columns
        cols = slice_columns(cols, np.asarray(table.mask))
    return columns_to_bytes(cols, codec=codec)


def bytes_to_columns(payload) -> tuple[dict[str, Column], int]:
    """Deserialize into {name: Column} + row count. The codec is
    sniffed from the payload; arrow pages reconstruct with zero-copy
    numpy views wherever the dtype allows (the arrays are then
    READ-ONLY — downstream assembly/compaction copies them out)."""
    codec = payload_codec(payload)
    t0 = time.perf_counter()
    if codec == WIRE_ARROW:
        out = _arrow_decode(payload)
    else:
        out = _npz_decode(payload)
    _DECODE_SECONDS.observe(time.perf_counter() - t0, codec=codec)
    return out


def transcode(payload, codec: str) -> bytes:
    """Re-encode a page for a consumer whose Accept excludes the
    stored codec (mixed-version clusters)."""
    if payload_codec(payload) == codec:
        return payload
    cols, _ = bytes_to_columns(payload)
    _TRANSCODED.inc()
    return columns_to_bytes(cols, codec=codec)


def compact_page_dictionaries(cols: dict[str, Column]
                              ) -> dict[str, Column]:
    """Narrow each string column's dictionary to the entries its page
    actually references — page slicing keeps the full dictionary, and
    serializing it whole into EVERY page would multiply the transfer
    (and the consumer's buffered bytes) by the page count."""
    out = {}
    for name, c in cols.items():
        if c.dictionary is None or len(c.dictionary) <= 16:
            out[name] = c
            continue
        codes = np.asarray(c.data)
        used = np.unique(np.clip(codes, 0, len(c.dictionary) - 1))
        if len(used) >= len(c.dictionary):
            out[name] = c
            continue
        remap = np.searchsorted(used, np.clip(codes, 0,
                                              len(c.dictionary) - 1))
        out[name] = Column(c.dtype, remap.astype(codes.dtype),
                           c.valid, c.dictionary[used])
    return out


# -- multi-page assembly -----------------------------------------------------


def pages_to_columns(blobs: list) -> tuple[dict[str, Column], int]:
    """Decode + assemble a multi-page fetch into contiguous columns.

    The old path deserialized each page into its own arrays and THEN
    concatenated — two full copies of every byte, per column, per
    fetch. Here arrow pages decode to zero-copy views over the fetched
    bytes and the assembly is ONE preallocated fill per column
    (concat_columns); a single-page fetch returns the views untouched.
    Pages may mix codecs (mid-rollout clusters)."""
    parts = [bytes_to_columns(b) for b in blobs]
    parts = [p for p in parts if p[0]]
    if not parts:
        return {}, 0
    nrows = sum(p[1] for p in parts)
    if len(parts) == 1:
        return parts[0][0], nrows
    return concat_columns([p[0] for p in parts]), nrows


def concat_columns(parts: list[dict[str, Column]]) -> dict[str, Column]:
    """Concatenate same-schema column payloads (partition pulls from
    several peers), unifying string dictionaries. Each output array is
    allocated ONCE at the total length and filled by slice — no
    pairwise concat cascade, and the 2-D decimal limb layout rides the
    same path."""
    if not parts:
        return {}
    if len(parts) == 1:
        return parts[0]
    out: dict[str, Column] = {}
    counts = [len(np.asarray(next(iter(p.values())).data))
              for p in parts] if parts[0] else []
    total = sum(counts)
    for name in parts[0]:
        cols = [p[name] for p in parts]
        dtype = cols[0].dtype
        datas = [np.asarray(c.data) for c in cols]
        if isinstance(dtype, T.VarcharType) and any(
                c.dictionary is not None for c in cols):
            # remap codes onto the union dictionary
            dicts = [c.dictionary if c.dictionary is not None
                     else np.asarray([], object) for c in cols]
            union = np.unique(np.concatenate(
                [d.astype("U") for d in dicts])) if dicts else []
            data = np.empty(total, dtype=datas[0].dtype)
            pos = 0
            for codes, d in zip(datas, dicts):
                if len(d):
                    remap = np.searchsorted(union, d.astype("U"))
                    safe = np.clip(codes, 0, max(len(d) - 1, 0))
                    data[pos:pos + len(codes)] = \
                        remap[safe].astype(codes.dtype)
                else:
                    data[pos:pos + len(codes)] = codes
                pos += len(codes)
            dictionary = union.astype(object)
        else:
            shape = (total,) + datas[0].shape[1:]
            data = np.empty(shape, dtype=datas[0].dtype)
            pos = 0
            for d in datas:
                data[pos:pos + len(d)] = d
                pos += len(d)
            dictionary = cols[0].dictionary
        if any(c.valid is not None for c in cols):
            valid = np.empty(total, dtype=bool)
            pos = 0
            for c, d in zip(cols, datas):
                n = len(d)
                valid[pos:pos + n] = (np.asarray(c.valid)
                                      if c.valid is not None else True)
                pos += n
        else:
            valid = None
        out[name] = Column(dtype, data, valid, dictionary)
    return out
