// Native page codec for the multi-host data plane.
//
// The reference engine ships exchange pages as LZ4-compressed
// SerializedPage frames with checksums (core
// execution/buffer/PagesSerde.java:41,64 — compressed block + xxhash;
// operator/ExchangeClient.java pulls them). This is the tpu-framework
// analog: a from-scratch LZ77 byte codec ("ppage") plus a CRC-32C
// checksum, compiled to a shared library and bound via ctypes
// (presto_tpu/native/__init__.py). Columnar numpy buffers compress
// extremely well under LZ77 (sorted keys, dictionary codes, validity
// bitmaps), which is what the wire format feeds it.
//
// Format (ppage block):
//   sequence*: varint L  (literal run length)
//              L literal bytes
//              varint M  (match length; 0 terminates the block when the
//                         remaining literals are exhausted)
//              uint16 O  (little-endian match offset, 1..65535)
//   The final sequence carries M = 0 and no offset.
// Varints are LEB128 (7 bits per byte, high bit = continue).
//
// Compression is greedy single-pass with a 4-byte rolling hash table:
// the standard LZ77 scheme every fast byte codec uses. Worst-case
// output is bounded by input + input/128 + 16 (pure-literal blocks).

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int kHashBits = 16;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kMinMatch = 4;
constexpr uint32_t kMaxOffset = 65535;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v) {
  // Knuth multiplicative hash on the 4-byte window.
  return (v * 2654435761u) >> (32 - kHashBits);
}

inline uint8_t* put_varint(uint8_t* dst, size_t v) {
  while (v >= 0x80) {
    *dst++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *dst++ = static_cast<uint8_t>(v);
  return dst;
}

inline const uint8_t* get_varint(const uint8_t* src, const uint8_t* end,
                                 size_t* out) {
  size_t v = 0;
  int shift = 0;
  while (src < end) {
    uint8_t b = *src++;
    v |= static_cast<size_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return src;
    }
    shift += 7;
    if (shift > 56) break;  // corrupt
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Upper bound on compressed size for a given input size.
size_t ppage_bound(size_t n) { return n + n / 128 + 16; }

// Compress src[0..n) into dst (capacity >= ppage_bound(n)).
// Returns compressed size, or 0 on error (capacity too small).
size_t ppage_compress(const uint8_t* src, size_t n, uint8_t* dst,
                      size_t cap) {
  if (cap < ppage_bound(n)) return 0;
  uint8_t* out = dst;
  if (n < kMinMatch + 4) {  // tiny input: single literal run
    out = put_varint(out, n);
    std::memcpy(out, src, n);
    out += n;
    out = put_varint(out, 0);
    return static_cast<size_t>(out - dst);
  }

  static thread_local uint32_t table[kHashSize];
  std::memset(table, 0, sizeof(table));

  const uint8_t* ip = src;
  const uint8_t* anchor = src;
  const uint8_t* const iend = src + n;
  const uint8_t* const mlimit = iend - 4;  // last position we can hash

  size_t miss = 0;  // acceleration: skip faster through incompressible runs
  while (ip < mlimit) {
    uint32_t h = hash32(load32(ip));
    size_t cand = table[h];
    table[h] = static_cast<uint32_t>(ip - src);
    const uint8_t* match = src + cand;
    size_t off = static_cast<size_t>(ip - match);
    if (off == 0 || off > kMaxOffset || load32(match) != load32(ip)) {
      ip += 1 + (miss++ >> 6);
      continue;
    }
    miss = 0;
    // extend the match forward
    const uint8_t* p = ip + 4;
    const uint8_t* m = match + 4;
    while (p < iend && *p == *m) {
      ++p;
      ++m;
    }
    size_t mlen = static_cast<size_t>(p - ip);
    if (mlen < kMinMatch) {
      ++ip;
      continue;
    }
    // emit literals since anchor, then the match
    size_t lit = static_cast<size_t>(ip - anchor);
    out = put_varint(out, lit);
    std::memcpy(out, anchor, lit);
    out += lit;
    out = put_varint(out, mlen);
    *out++ = static_cast<uint8_t>(off & 0xff);
    *out++ = static_cast<uint8_t>(off >> 8);
    // seed the table inside the match so long runs keep matching
    const uint8_t* seed_end = (p - 3 < mlimit) ? p - 3 : mlimit;
    for (const uint8_t* q = ip + 1; q < seed_end; q += 13)
      table[hash32(load32(q))] = static_cast<uint32_t>(q - src);
    ip = p;
    anchor = p;
  }
  // trailing literals
  size_t lit = static_cast<size_t>(iend - anchor);
  out = put_varint(out, lit);
  std::memcpy(out, anchor, lit);
  out += lit;
  out = put_varint(out, 0);
  return static_cast<size_t>(out - dst);
}

// Decompress src[0..n) into dst (capacity = exact original size).
// Returns bytes written, or 0 on corrupt input / capacity mismatch.
size_t ppage_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                        size_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;

  for (;;) {
    size_t lit;
    ip = get_varint(ip, iend, &lit);
    if (!ip || lit > static_cast<size_t>(iend - ip) ||
        lit > static_cast<size_t>(oend - op))
      return 0;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    size_t mlen;
    ip = get_varint(ip, iend, &mlen);
    if (!ip) return 0;
    if (mlen == 0) break;  // terminator
    if (iend - ip < 2) return 0;
    size_t off = static_cast<size_t>(ip[0]) |
                 (static_cast<size_t>(ip[1]) << 8);
    ip += 2;
    if (off == 0 || off > static_cast<size_t>(op - dst) ||
        mlen > static_cast<size_t>(oend - op))
      return 0;
    const uint8_t* m = op - off;
    if (off >= mlen) {
      std::memcpy(op, m, mlen);
    } else {
      // overlapping copy byte-by-byte (RLE when off < mlen)
      for (size_t i = 0; i < mlen; ++i) op[i] = m[i];
    }
    op += mlen;
  }
  return static_cast<size_t>(op - dst);
}

// CRC-32C (Castagnoli), bitwise-reflected table algorithm — page
// integrity check (the reference frames carry xxhash64; CRC-32C is the
// same role).
uint32_t ppage_crc32c(const uint8_t* src, size_t n) {
  static thread_local uint32_t table[256];
  static thread_local bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c >> 1) ^ (0x82f63b78u & (0u - (c & 1)));
      table[i] = c;
    }
    init = true;
  }
  uint32_t crc = 0xffffffffu;
  for (size_t i = 0; i < n; ++i)
    crc = (crc >> 8) ^ table[(crc ^ src[i]) & 0xff];
  return crc ^ 0xffffffffu;
}

}  // extern "C"
