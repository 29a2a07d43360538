"""From-scratch Parquet reader: the engine's first contact with
non-synthetic data (reference lib/trino-parquet — metadata reader
ParquetMetadataReader.java, page codec ParquetCompressionUtils.java,
RLE/bit-packed hybrid RunLengthBitPackingHybridDecoder.java).

Scope (the format's core, covering what pyarrow and most writers emit
for flat tables):
- Thrift COMPACT protocol metadata decoding (no thrift dependency —
  the protocol is a few varint rules, implemented in _CompactReader)
- flat schemas: required/optional primitive columns (nested lists/maps
  are rejected with a clear error)
- data page V1 and V2, PLAIN and RLE_DICTIONARY/PLAIN_DICTIONARY
  encodings, RLE/bit-packed hybrid definition levels
- physical types BOOLEAN/INT32/INT64/FLOAT/DOUBLE/BYTE_ARRAY/
  FIXED_LEN_BYTE_ARRAY with DATE/DECIMAL/UTF8 logical interpretation
- UNCOMPRESSED and SNAPPY column chunks (own snappy decoder — the
  raw-format LZ77 with 4 tag kinds)

Values decode into numpy columns ready for the engine's Block layer;
level/index unpacking is vectorized (np.unpackbits reshapes) rather
than per-value loops.

The port of ``presto_tpu/formats/parquet.py``: host code (numpy and
``struct``), whose columns the scan uploads through
``exec/hostsync.upload``. It converts a dictionary page's values to the
engine's representation once and indexes the converted dictionary, and
it converts fixed-length decimals with numpy byte arithmetic and an
overlapping snappy copy by repeating its period; every value is the
reference reader's (tests/test_torch_parquet.py holds them equal).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from presto_tpu_torch import types as T

MAGIC = b"PAR1"

# parquet physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
# page types
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
# encodings
ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_RLE_DICTIONARY = 8
# codecs
CODEC_UNCOMPRESSED = 0
CODEC_SNAPPY = 1


class ParquetError(RuntimeError):
    pass


# --------------------------------------------------------------------------
# Thrift compact protocol


class _CompactReader:
    """Minimal Thrift compact-protocol struct reader: produces
    {field_id: python value} dicts with nested structs/lists."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def _varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self._byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def _zigzag(self) -> int:
        v = self._varint()
        return (v >> 1) ^ -(v & 1)

    def _binary(self) -> bytes:
        n = self._varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _value(self, ftype: int):
        if ftype == 1:
            return True
        if ftype == 2:
            return False
        if ftype == 3:
            return self._zigzag()
        if ftype in (4, 5, 6):
            return self._zigzag()
        if ftype == 7:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ftype == 8:
            return self._binary()
        if ftype in (9, 10):
            return self._list()
        if ftype == 12:
            return self.struct()
        raise ParquetError(f"thrift compact type {ftype}")

    def _list(self):
        head = self._byte()
        size = head >> 4
        etype = head & 0x0F
        if size == 15:
            size = self._varint()
        if etype in (1, 2):  # bool elements carry values in-band
            return [self._byte() == 1 for _ in range(size)]
        return [self._value(etype) for _ in range(size)]

    def struct(self) -> dict:
        out: dict[int, object] = {}
        fid = 0
        while True:
            head = self._byte()
            if head == 0:
                return out
            delta = head >> 4
            ftype = head & 0x0F
            fid = fid + delta if delta else self._zigzag()
            out[fid] = self._value(ftype)


# --------------------------------------------------------------------------
# Snappy (raw format)


def snappy_decompress(src: bytes) -> bytes:
    """Raw-snappy decoder: varint uncompressed length, then literal /
    copy tags (the format has exactly four element kinds)."""
    pos = 0
    out_len = 0
    shift = 0
    while True:
        b = src[pos]
        pos += 1
        out_len |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray(out_len)
    opos = 0
    n = len(src)
    while pos < n:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                extra = ln - 60
                ln = int.from_bytes(src[pos:pos + extra], "little") + 1
                pos += extra
            out[opos:opos + ln] = src[pos:pos + ln]
            pos += ln
            opos += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + 2], "little")
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        start = opos - off
        if off >= ln:  # non-overlapping: one slice copy
            out[opos:opos + ln] = out[start:start + ln]
            opos += ln
        else:  # overlapping run: the last ``off`` bytes repeat
            period = bytes(out[start:opos])
            out[opos:opos + ln] = (period * (ln // off + 1))[:ln]
            opos += ln
    return bytes(out)


def _decompress(codec: int, data: bytes, uncompressed_size: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return data
    if codec == CODEC_SNAPPY:
        return snappy_decompress(data)
    raise ParquetError(f"unsupported compression codec {codec}")


# --------------------------------------------------------------------------
# RLE / bit-packed hybrid


def rle_bp_decode(buf: bytes, bit_width: int, count: int) -> np.ndarray:
    """Decode ``count`` values from an RLE/bit-packed hybrid run
    (reference RunLengthBitPackingHybridDecoder.java). The headers are
    read one run at a time; the bit-packed runs' bytes then unpack
    together (np.unpackbits, then np.packbits into whole words)."""
    if bit_width == 0:
        return np.zeros(count, np.int64)
    out = np.empty(count, np.int64)
    filled = 0
    pos = 0
    byte_w = (bit_width + 7) // 8
    packed = []  # (first row, rows taken, byte offset, bytes)
    while filled < count:
        header = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if header & 1:  # bit-packed: (header>>1) groups of 8
            groups = header >> 1
            nbytes = groups * bit_width
            take = min(groups * 8, count - filled)
            packed.append((filled, take, pos, nbytes))
            pos += nbytes
            filled += take
        else:  # RLE run
            run = header >> 1
            v = int.from_bytes(buf[pos:pos + byte_w], "little")
            pos += byte_w
            take = min(run, count - filled)
            out[filled:filled + take] = v
            filled += take
    if packed:
        raw = np.concatenate([np.frombuffer(buf, np.uint8, nbytes, at)
                              for _f, _t, at, nbytes in packed])
        decoded = _unpack_words(raw, bit_width)
        first = 0
        for row, take, _at, nbytes in packed:
            out[row:row + take] = decoded[first:first + take]
            first += nbytes * 8 // bit_width
    return out


def _unpack_words(raw: np.ndarray, bit_width: int) -> np.ndarray:
    """Little-endian ``bit_width``-bit values packed back to back in
    ``raw``, as int64 (a 64-bit value keeps its bit pattern). Up to 57
    bits a value lies in the 8 bytes from its first: each is read as
    one word, shifted and masked."""
    count = len(raw) * 8 // bit_width
    if bit_width > 57:
        bits = np.unpackbits(raw, bitorder="little")[:count * bit_width]
        bits = np.concatenate(
            [bits.reshape(count, bit_width),
             np.zeros((count, 64 - bit_width), np.uint8)], axis=1)
        words = np.packbits(bits, axis=1, bitorder="little")
        return words.view("<u8").reshape(-1).astype(np.int64)
    start = np.arange(count, dtype=np.int64) * bit_width
    padded = np.concatenate([raw, np.zeros(8, np.uint8)])
    words = padded[(start >> 3)[:, None] + np.arange(8)].view("<u8")
    words = words.reshape(-1) >> (start & 7).astype(np.uint64)
    return (words & np.uint64((1 << bit_width) - 1)).astype(np.int64)


# --------------------------------------------------------------------------
# value decoding


def _plain_values(ptype: int, buf: bytes, n: int, type_length: int):
    if ptype == INT32:
        return np.frombuffer(buf, "<i4", n)
    if ptype == INT64:
        return np.frombuffer(buf, "<i8", n)
    if ptype == FLOAT:
        return np.frombuffer(buf, "<f4", n)
    if ptype == DOUBLE:
        return np.frombuffer(buf, "<f8", n)
    if ptype == BOOLEAN:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8),
                             bitorder="little")
        return bits[:n].astype(bool)
    if ptype == BYTE_ARRAY:
        out = np.empty(n, object)
        pos = 0
        for i in range(n):
            ln = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            out[i] = buf[pos:pos + ln]
            pos += ln
        return out
    if ptype == FIXED:
        out = np.empty(n, object)
        for i in range(n):
            out[i] = buf[i * type_length:(i + 1) * type_length]
        return out
    raise ParquetError(f"unsupported physical type {ptype}")


@dataclasses.dataclass
class _SchemaCol:
    name: str
    ptype: int
    optional: bool
    type_length: int
    converted: int | None
    scale: int
    precision: int
    logical: dict | None


def _engine_type(col: _SchemaCol) -> T.DataType:
    # LogicalType union field ids (parquet.thrift): 1 STRING, 5
    # DECIMAL, 6 DATE, 8 TIMESTAMP; ConvertedType enum: 0 UTF8,
    # 5 DECIMAL, 6 DATE, 9/10 TIMESTAMP_(MILLIS|MICROS)
    lt = col.logical or {}
    if 6 in lt or col.converted == 6:
        return T.DATE
    if 1 in lt or col.converted == 0:
        return T.VARCHAR
    if 5 in lt or col.converted == 5:
        return T.DecimalType(col.precision or 38, col.scale or 0)
    if (8 in lt or col.converted in (9, 10)) and col.ptype == INT64:
        return T.TIMESTAMP
    return {
        BOOLEAN: T.BOOLEAN, INT32: T.INTEGER, INT64: T.BIGINT,
        FLOAT: T.DOUBLE, DOUBLE: T.DOUBLE, BYTE_ARRAY: T.VARCHAR,
        FIXED: T.VARCHAR,
    }.get(col.ptype, T.VARCHAR)


class ParquetFile:
    """One Parquet file's metadata + column readers."""

    def __init__(self, path: str):
        import mmap

        self.path = path
        with open(path, "rb") as f:
            # map instead of slurping: footer-only operations (schema,
            # stats, row counts — every plan-time call) touch just the
            # file tail, and the OS pages data in as chunks decode
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if data[:4] != MAGIC or data[-4:] != MAGIC:
            raise ParquetError(f"{path}: not a parquet file")
        footer_len = int.from_bytes(data[-8:-4], "little")
        meta = _CompactReader(data[len(data) - 8 - footer_len:]).struct()
        self._data = data
        self.num_rows = int(meta.get(3, 0))
        self.columns: list[_SchemaCol] = []
        schema = meta.get(2, [])
        root = schema[0] if schema else {}
        if int(root.get(5, 0)) != len(schema) - 1:
            raise ParquetError(
                f"{path}: nested schemas are not supported (flat "
                "primitive columns only)")
        for el in schema[1:]:
            if 5 in el and el[5]:
                raise ParquetError(
                    f"{path}: nested column "
                    f"{el.get(4, b'?').decode()} unsupported")
            self.columns.append(_SchemaCol(
                name=el[4].decode(),
                ptype=int(el[1]),
                optional=int(el.get(3, 0)) == 1,
                type_length=int(el.get(2, 0)),
                converted=(int(el[6]) if 6 in el else None),
                scale=int(el.get(7, 0)),
                precision=int(el.get(8, 0)),
                logical=el.get(10)))
        self.row_groups = meta.get(4, [])

    def schema(self) -> dict[str, T.DataType]:
        return {c.name: _engine_type(c) for c in self.columns}

    def column_stats(self, name: str):
        """Per-row-group (min, max) for integer-physical columns, or
        None entries where statistics are absent (footer
        ColumnMetaData.statistics, fields 5/6 min_value/max_value with
        the deprecated 1/2 fallback) — the input to row-group pruning
        (reference parquet predicate/TupleDomainParquetPredicate)."""
        idx = next((i for i, c in enumerate(self.columns)
                    if c.name == name), None)
        if idx is None:
            raise ParquetError(f"{self.path}: no column {name}")
        col = self.columns[idx]
        if col.ptype not in (INT32, INT64):
            return [None] * len(self.row_groups)
        # only UNIT-EXACT logical types: the engine compares stats
        # against physical literals (epoch days, scaled ints), but
        # TIMESTAMP stats stay in the file's millis/nanos unit while
        # engine literals are micros — pruning on them would drop
        # matching row groups
        et = _engine_type(col)
        if not isinstance(et, (T.BigintType, T.IntegerType,
                               T.DateType)):
            return [None] * len(self.row_groups)
        width = 4 if col.ptype == INT32 else 8
        out = []
        for rg in self.row_groups:
            st = rg[1][idx][3].get(12)
            if not st:
                out.append(None)
                continue
            mx = st.get(5, st.get(1))
            mn = st.get(6, st.get(2))
            if mn is None or mx is None or len(mn) != width \
                    or len(mx) != width:
                out.append(None)
                continue
            out.append((int.from_bytes(mn, "little", signed=True),
                        int.from_bytes(mx, "little", signed=True)))
        return out

    def read_column(self, name: str, row_groups=None):
        """(values np.ndarray, valid bool[n] | None) across the
        selected row groups (None = all)."""
        idx = next((i for i, c in enumerate(self.columns)
                    if c.name == name), None)
        if idx is None:
            raise ParquetError(f"{self.path}: no column {name}")
        col = self.columns[idx]
        vals_parts = []
        valid_parts = []
        any_null = False
        groups = (self.row_groups if row_groups is None
                  else [self.row_groups[i] for i in row_groups])
        for rg in groups:
            chunk = rg[1][idx]
            cmeta = chunk[3]
            vals, valid = self._read_chunk(col, cmeta)
            vals_parts.append(vals)
            if valid is None:
                valid_parts.append(np.ones(len(vals), bool))
            else:
                any_null = True
                valid_parts.append(valid)
        values = (np.concatenate(vals_parts) if vals_parts
                  else np.empty(0))
        valid = np.concatenate(valid_parts) if valid_parts else None
        return values, (valid if any_null else None)

    def read_strings(self, name: str, row_groups=None):
        """A VARCHAR column as (dictionary, codes, valid | None) across
        the selected row groups: ``dictionary`` joins each chunk's
        converted dictionary (and the values of its PLAIN pages, as
        they come), ``codes`` indexes it per row; a null row's code is
        -1, or -2 in a chunk with no present value (where
        ``read_column`` fills ``b""`` instead of None). Row i's value
        is ``read_column``'s: no per-row conversion."""
        idx = next((i for i, c in enumerate(self.columns)
                    if c.name == name), None)
        if idx is None:
            raise ParquetError(f"{self.path}: no column {name}")
        col = self.columns[idx]
        dicts: list = []
        codes: list = []
        valids: list = []
        offset = 0
        groups = (self.row_groups if row_groups is None
                  else [self.row_groups[i] for i in row_groups])
        for rg in groups:
            d, c, valid = self._read_chunk(col, rg[1][idx][3], coded=True)
            dicts.append(d)
            codes.append(np.where(c >= 0, c + offset, c))
            valids.append(valid if valid is not None
                          else np.ones(len(c), bool))
            offset += len(d)
        dictionary = (np.concatenate(dicts) if dicts
                      else np.empty(0, object))
        codes_all = (np.concatenate(codes) if codes
                     else np.empty(0, np.int64))
        valid_all = np.concatenate(valids) if valids else None
        if valid_all is not None and valid_all.all():
            valid_all = None
        return dictionary, codes_all, valid_all

    def _read_chunk(self, col: _SchemaCol, cmeta: dict,
                    coded: bool = False):
        codec = int(cmeta.get(4, 0))
        num_values = int(cmeta.get(5, 0))
        start = int(cmeta.get(11, cmeta.get(9, 0)) or cmeta.get(9, 0))
        pos = start
        etype = _engine_type(col)
        dictionary = None
        values = []
        valids = []
        got = 0
        while got < num_values:
            rd = _CompactReader(self._data, pos)
            header = rd.struct()
            body_start = rd.pos
            ptype = int(header.get(1, 0))
            comp_size = int(header.get(3, 0))
            uncomp_size = int(header.get(2, 0))
            body = self._data[body_start:body_start + comp_size]
            pos = body_start + comp_size
            if ptype == DICTIONARY_PAGE:
                dh = header.get(7, {})
                n = int(dh.get(1, 0))
                raw = _decompress(codec, body, uncomp_size)
                # converted once; its data pages index the result
                dictionary = _convert(col, etype, _plain_values(
                    col.ptype, raw, n, col.type_length))
                continue
            if ptype == DATA_PAGE:
                dh = header.get(5, {})
                n = int(dh.get(1, 0))
                enc = int(dh.get(2, 0))
                raw = _decompress(codec, body, uncomp_size)
                vpos = 0
                valid = None
                if col.optional:
                    ln = int.from_bytes(raw[:4], "little")
                    levels = rle_bp_decode(raw[4:4 + ln], 1, n)
                    valid = levels.astype(bool)
                    vpos = 4 + ln
                npresent = int(valid.sum()) if valid is not None else n
                vals = self._decode_values(
                    col, enc, raw[vpos:], npresent, dictionary, coded)
                values.append((vals, valid, n))
                got += n
                continue
            if ptype == DATA_PAGE_V2:
                dh = header.get(8, {})
                n = int(dh.get(1, 0))
                nnull = int(dh.get(2, 0))
                enc = int(dh.get(4, 0))
                dl_len = int(dh.get(5, 0))
                rl_len = int(dh.get(6, 0))
                compressed = bool(dh.get(7, True))
                levels = self._data[body_start:body_start + rl_len
                                    + dl_len]
                vbody = body[rl_len + dl_len:]
                raw = (_decompress(codec, vbody,
                                   uncomp_size - rl_len - dl_len)
                       if compressed else vbody)
                valid = None
                if col.optional:
                    lv = rle_bp_decode(
                        levels[rl_len:rl_len + dl_len], 1, n)
                    valid = lv.astype(bool)
                npresent = n - nnull
                vals = self._decode_values(col, enc, raw, npresent,
                                           dictionary, coded)
                values.append((vals, valid, n))
                got += n
                continue
            raise ParquetError(f"unsupported page type {ptype}")
        if coded:
            return self._assemble_coded(col, values)
        return self._assemble(col, values)

    def _decode_values(self, col: _SchemaCol, enc: int, raw: bytes,
                       n: int, dictionary, coded: bool = False):
        """One data page's present values, converted to the engine's
        physical representation (``dictionary`` is converted already);
        ``coded``: (a dictionary, indices into it) instead."""
        if enc == ENC_PLAIN:
            vals = _convert(col, _engine_type(col), _plain_values(
                col.ptype, raw, n, col.type_length))
            return (vals, np.arange(n)) if coded else vals
        if enc in (ENC_PLAIN_DICTIONARY, ENC_RLE_DICTIONARY):
            if dictionary is None:
                raise ParquetError("dictionary page missing")
            width = raw[0]
            idxs = rle_bp_decode(raw[1:], width, n)
            return (dictionary, idxs) if coded else dictionary[idxs]
        if enc == ENC_RLE and col.ptype == BOOLEAN:
            # boolean values as an RLE/bit-packed run, 4-byte length
            # prefixed (format spec: RLE data encoding)
            ln = int.from_bytes(raw[:4], "little")
            return _convert(col, _engine_type(col), rle_bp_decode(
                raw[4:4 + ln], 1, n).astype(bool))
        raise ParquetError(f"unsupported encoding {enc}")

    def _assemble(self, col: _SchemaCol, pages):
        """Scatter the pages' present values, each page converted to
        the engine's physical representation, to row positions."""
        total = sum(n for _, _, n in pages)
        valid_all = None
        if col.optional and any(v is not None for _, v, _ in pages):
            valid_all = np.concatenate([
                v if v is not None else np.ones(n, bool)
                for _, v, n in pages])
        vals = (np.concatenate([np.asarray(v) for v, _, _ in pages])
                if pages else _convert(col, _engine_type(col), np.empty(0)))
        if valid_all is None or valid_all.all():
            return vals, None
        # scatter present values into the full row vector
        if vals.dtype == object:
            full = np.empty(total, object)
            full[:] = b"" if isinstance(
                vals[0] if len(vals) else b"", bytes) else None
        else:
            full = np.zeros(
                total,
                vals.dtype if vals.ndim == 1 else vals.dtype)
            if vals.ndim == 2:
                full = np.zeros((total, vals.shape[1]), vals.dtype)
        full[valid_all] = vals
        return full, valid_all


    @staticmethod
    def _assemble_coded(col: _SchemaCol, pages):
        """(dictionary, codes, valid) of one chunk from its pages'
        (dictionary, indices) pairs: each distinct page dictionary
        once, the codes offset into the joined one, and a null row's
        code -1, or -2 when the chunk has no present value."""
        valid_all = None
        if col.optional and any(v is not None for _, v, _ in pages):
            valid_all = np.concatenate([
                v if v is not None else np.ones(n, bool)
                for _, v, n in pages])
        dicts: list = []
        codes: list = []
        offsets: dict[int, int] = {}
        size = 0
        for (d, idxs), _v, _n in pages:
            if id(d) not in offsets:
                offsets[id(d)] = size
                dicts.append(d)
                size += len(d)
            codes.append(np.asarray(idxs, np.int64) + offsets[id(d)])
        dictionary = np.concatenate(dicts) if dicts else np.empty(0, object)
        present = (np.concatenate(codes) if codes
                   else np.empty(0, np.int64))
        if valid_all is None or valid_all.all():
            return dictionary, present, None
        full = np.full(len(valid_all), -1 if len(present) else -2,
                       np.int64)
        full[valid_all] = present
        return dictionary, full, valid_all


def _fixed_words(present: np.ndarray, width: int):
    """The low and high int64 words of FIXED_LEN_BYTE_ARRAY values of
    ``width`` bytes (at most 16), each a big-endian two's complement
    integer, as ``int.from_bytes(b, "big", signed=True)`` reads it."""
    n = len(present)
    raw = np.frombuffer(b"".join(present), np.uint8).reshape(n, width)
    fill = np.where(raw[:, :1] >= 0x80, 0xFF, 0).astype(np.uint8)
    full = np.concatenate([np.repeat(fill, 16 - width, axis=1), raw],
                          axis=1)
    words = np.ascontiguousarray(full).view(">i8").astype(np.int64)
    return words[:, 1], words[:, 0]


def _convert(col: _SchemaCol, etype: T.DataType, present: np.ndarray):
    if isinstance(etype, T.DecimalType):
        if col.ptype in (INT32, INT64):
            if etype.is_long:
                x = present.astype(np.int64)
                return np.stack([x, x >> 63], axis=1)
            return present.astype(np.int64)
        if col.ptype == FIXED and 0 < col.type_length <= 16:
            lo, hi = _fixed_words(present, col.type_length)
            return np.stack([lo, hi], axis=1) if etype.is_long else lo
        # BYTE_ARRAY: big-endian two's complement of any width
        scaled = np.array([int.from_bytes(b, "big", signed=True)
                           for b in present], object)
        if etype.is_long:
            out = np.empty((len(scaled), 2), np.int64)
            for i, v in enumerate(scaled):
                m = int(v) & ((1 << 128) - 1)
                lo = m & ((1 << 64) - 1)
                hi = (m >> 64) & ((1 << 64) - 1)
                out[i, 0] = lo - (1 << 64) if lo >= 1 << 63 else lo
                out[i, 1] = hi - (1 << 64) if hi >= 1 << 63 else hi
            return out
        return np.asarray([int(v) for v in scaled], np.int64)
    if isinstance(etype, T.DateType):
        return present.astype(np.int32)
    if isinstance(etype, T.TimestampType):
        x = present.astype(np.int64)
        unit = ((col.logical or {}).get(8) or {}).get(2, {})
        if col.converted == 9 or 1 in unit:  # millis -> micros
            return x * 1000
        if 3 in unit:  # nanos -> micros
            return x // 1000
        return x  # micros
    if isinstance(etype, T.VarcharType):
        return np.array([b.decode("utf-8", "replace")
                         for b in present], object)
    if isinstance(etype, T.DoubleType):
        return present.astype(np.float64)
    if isinstance(etype, T.BooleanType):
        return present.astype(bool)
    return present.astype(np.int64)
