// Zstandard frame decoding (RFC 8878) for fourm_torch/utils/orbax.py, which
// reads the OCDBT / zarr checkpoints that orbax writes with zstd: the frame
// header (window descriptor, single-segment flag, dictionary ID, content size
// present or absent); raw, RLE and compressed blocks; literals sections that
// are raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the previous
// block's Huffman table); sequences whose literal-length, match-length and
// offset codes come from the predefined, an RLE, an FSE-described or the
// previous block's table; the three repeat offsets; concatenated and
// skippable frames; and the optional content checksum (the low 32 bits of
// XXH64, seed 0), which is checked. A frame that names a dictionary is
// refused. Beside it, CRC-32C (Castagnoli), which OCDBT puts at the end of
// each manifest and b-tree node.
//
// Exposed C ABI (bound in fourm_torch/native/__init__.py):
//   zstd_content_size(src, n, err, errcap) -> the summed content size of all
//     frames, -2 when a frame does not declare it, or -1 with err set
//   zstd_decode(src, n, dst, cap, err, errcap) -> the bytes written, -2 when
//     they do not fit in cap, or -1 with err set
//   crc32c(src, n) -> the CRC-32C of n bytes

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ZstdError : std::runtime_error {
  explicit ZstdError(const std::string& s) : std::runtime_error(s) {}
};
struct OutputFull {};

[[noreturn]] void fail(const std::string& s) { throw ZstdError(s); }

inline uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
inline uint64_t rd64(const uint8_t* p) { return rd32(p) | (uint64_t(rd32(p + 4)) << 32); }
inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

// ------------------------------------------------------------------ XXH64

const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
               P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
               P5 = 0x27D4EB2F165667C5ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64_impl(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ----------------------------------------------------------------- CRC-32C

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};
const Crc32cTable kCrc;

uint32_t crc32c_impl(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; p += 8, n -= 8) {  // slicing by 8
    uint64_t v = rd64(p) ^ c;
    c = kCrc.t[7][v & 0xFF] ^ kCrc.t[6][(v >> 8) & 0xFF] ^ kCrc.t[5][(v >> 16) & 0xFF] ^
        kCrc.t[4][(v >> 24) & 0xFF] ^ kCrc.t[3][(v >> 32) & 0xFF] ^
        kCrc.t[2][(v >> 40) & 0xFF] ^ kCrc.t[1][(v >> 48) & 0xFF] ^ kCrc.t[0][v >> 56];
  }
  for (; n; --n, ++p) c = (c >> 8) ^ kCrc.t[0][(c ^ *p) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------ bit readers

// Forward little-endian bit reader (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++bit) {
      if (bit >= n * 8) fail("an FSE table description runs past its section");
      v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  void unread(int nb) { bit -= nb; }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bit reader of the entropy-coded streams: the stream is read from
// its last bit down; the last byte's highest set bit marks where it starts.
// Bits below the stream's start read as 0 (the offset goes negative).
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t off;
  BackBits(const uint8_t* src, size_t len) : p(src), n(len) {
    if (len == 0) fail("an empty entropy-coded stream");
    if (src[len - 1] == 0) fail("an entropy-coded stream whose last byte is 0 (no end mark)");
    off = int64_t(len) * 8 - (8 - highbit(src[len - 1]));
  }
  uint64_t read(int nb) {
    if (nb == 0) return 0;
    off -= nb;
    int64_t o = off;
    int want = nb;
    if (o < 0) {
      want += int(o);
      o = 0;
      if (want <= 0) return 0;
    }
    size_t byte = size_t(o) >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n)
      std::memcpy(&v, p + byte, 8);
    else
      std::memcpy(&v, p + byte, n - byte);
    v >>= (o & 7);
    v &= (want >= 64) ? ~0ULL : ((1ULL << want) - 1);
    if (off < 0) v <<= -off;
    return v;
  }
};

// ---------------------------------------------------------------- FSE

struct Fse {
  int log = -1;  // -1: no table yet
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;

  void build(const int16_t* freq, int nsym, int acc) {
    size_t size = size_t(1) << acc;
    log = acc;
    sym.assign(size, 0);
    nbits.assign(size, 0);
    base.assign(size, 0);
    std::vector<uint16_t> next(nsym, 0);
    size_t high = size;
    for (int s = 0; s < nsym; ++s)
      if (freq[s] == -1) {
        if (high == 0) fail("an FSE table with too many low-probability symbols");
        sym[--high] = uint8_t(s);
        next[s] = 1;
      }
    size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; ++s) {
      if (freq[s] <= 0) continue;
      next[s] = uint16_t(freq[s]);
      for (int i = 0; i < freq[s]; ++i) {
        sym[pos] = uint8_t(s);
        do pos = (pos + step) & mask;
        while (pos >= high);
      }
    }
    if (pos != 0) fail("an FSE table whose probabilities do not fill it");
    for (size_t i = 0; i < size; ++i) {
      uint32_t d = next[sym[i]]++;
      nbits[i] = uint8_t(acc - highbit(d));
      base[i] = uint16_t((d << nbits[i]) - size);
    }
  }
  void rle(uint8_t s) {
    log = 0;
    sym.assign(1, s);
    nbits.assign(1, 0);
    base.assign(1, 0);
  }
  // the table description at src (forward bits); -> the bytes it took
  size_t read_description(const uint8_t* src, size_t n, int max_log, int max_sym) {
    FwdBits in{src, n};
    int acc = 5 + int(in.read(4));
    if (acc > max_log) fail("an FSE accuracy log of " + std::to_string(acc) + " (at most " +
                            std::to_string(max_log) + " here)");
    int32_t remaining = 1 << acc;
    int16_t freq[256];
    int s = 0;
    while (remaining > 0 && s <= max_sym) {
      int bits = highbit(uint64_t(remaining) + 1) + 1;
      uint32_t val = in.read(bits);
      uint32_t lower = (1u << (bits - 1)) - 1;
      uint32_t threshold = (1u << bits) - 1 - (uint32_t(remaining) + 1);
      if ((val & lower) < threshold) {
        in.unread(1);
        val &= lower;
      } else if (val > lower) {
        val -= threshold;
      }
      int16_t proba = int16_t(int(val) - 1);
      remaining -= proba < 0 ? -proba : proba;
      freq[s++] = proba;
      if (proba == 0) {
        int rep = int(in.read(2));
        while (true) {
          for (int i = 0; i < rep && s <= max_sym; ++i) freq[s++] = 0;
          if (rep != 3) break;
          rep = int(in.read(2));
        }
      }
    }
    if (remaining != 0) fail("an FSE table description whose probabilities do not sum up");
    build(freq, s, acc);
    return in.bytes_used();
  }
  uint32_t init(BackBits& b) const { return uint32_t(b.read(log)); }
  uint8_t peek(uint32_t st) const { return sym[st]; }
  uint32_t update(uint32_t st, BackBits& b) const { return base[st] + uint32_t(b.read(nbits[st])); }
};

// ------------------------------------------------------------- Huffman

struct Huff {
  int max_bits = 0;  // 0: no table yet
  std::vector<uint8_t> sym, nbits;

  void from_weights(const uint8_t* w, int nw) {
    // the last symbol's weight is implied: it completes the sum to a power of 2
    uint32_t sum = 0;
    for (int i = 0; i < nw; ++i) {
      if (w[i] > 11) fail("a Huffman weight above 11");
      if (w[i]) sum += 1u << (w[i] - 1);
    }
    if (sum == 0) fail("a Huffman table with no weights");
    int mb = highbit(sum) + 1;
    uint32_t left = (1u << mb) - sum;
    if (left & (left - 1)) fail("Huffman weights whose sum cannot be completed");
    if (mb > 11) fail("a Huffman table deeper than 11 bits");
    std::vector<uint8_t> bits(nw + 1);
    int nsym = nw + 1;
    for (int i = 0; i < nw; ++i) bits[i] = w[i] ? uint8_t(mb + 1 - w[i]) : 0;
    bits[nw] = uint8_t(mb + 1 - (highbit(left) + 1));
    max_bits = mb;
    size_t size = size_t(1) << mb;
    sym.assign(size, 0);
    nbits.assign(size, 0);
    uint32_t count[13] = {0}, idx[13] = {0};
    for (int i = 0; i < nsym; ++i) count[bits[i]]++;
    idx[mb] = 0;
    for (int i = mb; i >= 1; --i) {
      idx[i - 1] = idx[i] + count[i] * (1u << (mb - i));
      std::memset(&nbits[idx[i]], i, idx[i - 1] - idx[i]);
    }
    if (idx[0] != size) fail("a corrupt Huffman table");
    for (int i = 0; i < nsym; ++i) {
      if (!bits[i]) continue;
      uint32_t len = 1u << (mb - bits[i]);
      std::memset(&sym[idx[bits[i]]], i, len);
      idx[bits[i]] += len;
    }
  }
  // the tree description at src; -> the bytes it took
  size_t read_description(const uint8_t* src, size_t n) {
    if (n < 1) fail("a Huffman tree description past its section");
    uint8_t hdr = src[0];
    uint8_t w[256];
    int nw = 0;
    if (hdr >= 128) {  // direct: 4 bits a weight
      nw = hdr - 127;
      size_t bytes = (nw + 1) / 2;
      if (1 + bytes > n) fail("a Huffman tree description past its section");
      for (int i = 0; i < nw; ++i) {
        uint8_t b = src[1 + i / 2];
        w[i] = (i & 1) ? (b & 15) : (b >> 4);
      }
      from_weights(w, nw);
      return 1 + bytes;
    }
    // FSE-compressed weights: two interleaved states
    size_t csize = hdr;
    if (1 + csize > n) fail("a Huffman tree description past its section");
    Fse t;
    size_t used = t.read_description(src + 1, csize, 6, 255);
    if (used >= csize) fail("Huffman weights with no bitstream");
    BackBits b(src + 1 + used, csize - used);
    uint32_t s1 = t.init(b), s2 = t.init(b);
    while (true) {
      if (nw >= 255) fail("too many Huffman weights");
      w[nw++] = t.peek(s1);
      s1 = t.update(s1, b);
      if (b.off < 0) {
        w[nw++] = t.peek(s2);
        break;
      }
      if (nw >= 255) fail("too many Huffman weights");
      w[nw++] = t.peek(s2);
      s2 = t.update(s2, b);
      if (b.off < 0) {
        w[nw++] = t.peek(s1);
        break;
      }
    }
    from_weights(w, nw);
    return 1 + csize;
  }
  void decode_stream(const uint8_t* src, size_t n, uint8_t* out, size_t count) const {
    BackBits b(src, n);
    uint32_t mask = (1u << max_bits) - 1;
    uint32_t st = uint32_t(b.read(max_bits));
    size_t i = 0;
    while (b.off > -max_bits) {
      if (i >= count) fail("a Huffman stream with more literals than declared");
      out[i++] = sym[st];
      int nb = nbits[st];
      st = ((st << nb) + uint32_t(b.read(nb))) & mask;
    }
    if (b.off != -max_bits || i != count) fail("a corrupt Huffman literals stream");
  }
};

// ------------------------------------------------------- sequence tables

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,  2,  2,
                             3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  Huff huff;
  Fse ll, ml, of;
  uint64_t rep[3] = {1, 4, 8};
};

// one of the three sequence tables per its mode; -> the bytes it took
size_t read_table(Fse& t, int mode, const uint8_t* src, size_t n, const int16_t* def,
                  int ndef, int def_log, int max_log, int max_sym, const char* name) {
  switch (mode) {
    case 0:
      t.build(def, ndef, def_log);
      return 0;
    case 1:
      if (n < 1) fail(std::string("the RLE ") + name + " code past its block");
      if (src[0] > max_sym) fail(std::string("an RLE ") + name + " code out of range");
      t.rle(src[0]);
      return 1;
    case 2:
      return t.read_description(src, n, max_log, max_sym);
    default:
      if (t.log < 0) fail(std::string("a repeat ") + name + " table with no table before it");
      return 0;
  }
}

// --------------------------------------------------------------- output

struct Out {
  uint8_t* dst;
  size_t cap;
  size_t pos = 0;
  void need(size_t k) {
    if (k > cap - pos) throw OutputFull();
  }
};

void decode_block(const uint8_t* src, size_t n, FrameState& fs, Out& out, size_t frame_start,
                  size_t block_max) {
  // ---- literals
  if (n < 1) fail("an empty compressed block");
  int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t regen, csize = 0, hdr;
  bool four = false;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      hdr = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      hdr = 2;
      if (n < 2) fail("a literals header past its block");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      hdr = 3;
      if (n < 3) fail("a literals header past its block");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
  } else {
    hdr = sf < 2 ? 3 : (sf == 2 ? 4 : 5);
    if (n < hdr) fail("a literals header past its block");
    four = sf != 0;
    uint64_t v = 0;
    for (size_t i = 0; i < hdr; ++i) v |= uint64_t(src[i]) << (8 * i);
    int w = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
    regen = (v >> 4) & ((1u << w) - 1);
    csize = (v >> (4 + w)) & ((1u << w) - 1);
  }
  if (regen > block_max) fail("a literals section larger than the block size");
  std::vector<uint8_t> lit(regen);
  size_t p = hdr;
  if (ltype == 0) {
    if (p + regen > n) fail("raw literals past their block");
    std::memcpy(lit.data(), src + p, regen);
    p += regen;
  } else if (ltype == 1) {
    if (p + 1 > n) fail("RLE literals past their block");
    std::memset(lit.data(), src[p], regen);
    p += 1;
  } else {
    if (p + csize > n) fail("compressed literals past their block");
    const uint8_t* ls = src + p;
    size_t ln = csize;
    if (ltype == 2) {
      size_t used = fs.huff.read_description(ls, ln);
      ls += used;
      ln -= used;
    } else if (fs.huff.max_bits == 0) {
      fail("treeless literals with no Huffman table before them");
    }
    if (!four) {
      fs.huff.decode_stream(ls, ln, lit.data(), regen);
    } else {
      if (ln < 6) fail("a 4-stream literals section without its jump table");
      size_t s1 = ls[0] | (ls[1] << 8), s2 = ls[2] | (ls[3] << 8), s3 = ls[4] | (ls[5] << 8);
      if (6 + s1 + s2 + s3 > ln) fail("a literals jump table past its section");
      size_t s4 = ln - 6 - s1 - s2 - s3;
      size_t q = (regen + 3) / 4;
      if (3 * q > regen) fail("a 4-stream literals section too small for 4 streams");
      const uint8_t* b = ls + 6;
      fs.huff.decode_stream(b, s1, lit.data(), q);
      fs.huff.decode_stream(b + s1, s2, lit.data() + q, q);
      fs.huff.decode_stream(b + s1 + s2, s3, lit.data() + 2 * q, q);
      fs.huff.decode_stream(b + s1 + s2 + s3, s4, lit.data() + 3 * q, regen - 3 * q);
    }
    p += csize;
  }
  // ---- sequences
  if (p >= n) fail("a block without its sequences section");
  size_t nseq;
  uint8_t b0 = src[p];
  if (b0 == 0) {
    nseq = 0;
    p += 1;
  } else if (b0 < 128) {
    nseq = b0;
    p += 1;
  } else if (b0 < 255) {
    if (p + 2 > n) fail("a sequence count past its block");
    nseq = (size_t(b0 - 128) << 8) + src[p + 1];
    p += 2;
  } else {
    if (p + 3 > n) fail("a sequence count past its block");
    nseq = src[p + 1] + (size_t(src[p + 2]) << 8) + 0x7F00;
    p += 3;
  }
  size_t li = 0;
  if (nseq) {
    if (p >= n) fail("a block without its symbol compression modes");
    uint8_t modes = src[p++];
    if (modes & 3) fail("reserved bits set in the symbol compression modes");
    p += read_table(fs.ll, modes >> 6, src + p, n - p, kLLDefault, 36, 6, 9, 35, "literal length");
    p += read_table(fs.of, (modes >> 4) & 3, src + p, n - p, kOFDefault, 29, 5, 8, 31, "offset");
    p += read_table(fs.ml, (modes >> 2) & 3, src + p, n - p, kMLDefault, 53, 6, 9, 52,
                    "match length");
    if (p > n) fail("sequence tables past their block");
    BackBits b(src + p, n - p);
    uint32_t sll = fs.ll.init(b), sof = fs.of.init(b), sml = fs.ml.init(b);
    for (size_t i = 0; i < nseq; ++i) {
      uint8_t ofc = fs.of.peek(sof), llc = fs.ll.peek(sll), mlc = fs.ml.peek(sml);
      if (llc > 35 || mlc > 52 || ofc > 31) fail("a sequence code out of range");
      uint64_t ofv = (uint64_t(1) << ofc) + b.read(ofc);
      uint64_t ml = kMLBase[mlc] + b.read(kMLBits[mlc]);
      uint64_t ll = kLLBase[llc] + b.read(kLLBits[llc]);
      if (i + 1 < nseq) {
        sll = fs.ll.update(sll, b);
        sml = fs.ml.update(sml, b);
        sof = fs.of.update(sof, b);
      }
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = off;
      } else {
        uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = fs.rep[0];
        } else {
          off = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
          if (idx > 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = off;
        }
      }
      if (ll > regen - li) fail("a sequence with more literals than the section holds");
      out.need(ll + ml);
      std::memcpy(out.dst + out.pos, lit.data() + li, ll);
      out.pos += ll;
      li += ll;
      if (off == 0 || off > out.pos - frame_start)
        fail("a match offset before the frame's start (a dictionary would be needed)");
      uint8_t* d = out.dst + out.pos;
      const uint8_t* s = d - off;
      if (off >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (uint64_t k = 0; k < ml; ++k) d[k] = s[k];
      }
      out.pos += ml;
    }
    if (b.off != 0) fail("a sequences bitstream not consumed to its end");
  } else if (p != n) {
    fail("bytes after a block's empty sequences section");
  }
  size_t rest = regen - li;
  out.need(rest);
  std::memcpy(out.dst + out.pos, lit.data() + li, rest);
  out.pos += rest;
}

struct Header {
  size_t hdr = 0;            // bytes of magic + header
  int64_t content = -1;      // -1: not declared
  bool checksum = false;
  uint64_t window = 0;
};

Header read_header(const uint8_t* src, size_t n) {
  Header h;
  if (n < 5) fail("a truncated zstd frame header");
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6, did_flag = fhd & 3;
  bool single = (fhd >> 5) & 1;
  if (fhd & 8) fail("the reserved bit of a zstd frame header is set");
  h.checksum = (fhd >> 2) & 1;
  size_t p = 5;
  if (!single) {
    if (p >= n) fail("a truncated zstd frame header");
    uint8_t wd = src[p++];
    int exp = wd >> 3, mant = wd & 7;
    uint64_t base = uint64_t(1) << (10 + exp);
    h.window = base + (base / 8) * mant;
  }
  static const int did_bytes[4] = {0, 1, 2, 4};
  int db = did_bytes[did_flag];
  if (p + db > n) fail("a truncated zstd frame header");
  uint32_t did = 0;
  for (int i = 0; i < db; ++i) did |= uint32_t(src[p + i]) << (8 * i);
  p += db;
  if (did != 0)
    fail("a zstd frame that needs dictionary " + std::to_string(did) +
         " (dictionaries are not supported)");
  int fb = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (p + fb > n) fail("a truncated zstd frame header");
  if (fb) {
    uint64_t v = 0;
    for (int i = 0; i < fb; ++i) v |= uint64_t(src[p + i]) << (8 * i);
    if (fb == 2) v += 256;
    h.content = int64_t(v);
  }
  p += fb;
  if (single) h.window = uint64_t(h.content);
  h.hdr = p;
  return h;
}

const uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t m) { return (m & 0xFFFFFFF0u) == 0x184D2A50u; }

// walks the frames; with out == nullptr only the content sizes are summed
int64_t run(const uint8_t* src, size_t n, Out* out) {
  size_t p = 0;
  int64_t total = 0;
  bool unknown = false;
  if (n == 0) fail("no zstd frame");
  while (p < n) {
    if (n - p < 4) fail("trailing bytes after the last zstd frame");
    uint32_t m = rd32(src + p);
    if (skippable(m)) {
      if (n - p < 8) fail("a truncated skippable frame");
      uint64_t sz = rd32(src + p + 4);
      if (sz > n - p - 8) fail("a skippable frame past the end of the data");
      p += 8 + sz;
      continue;
    }
    if (m != kMagic) {
      char buf[96];
      std::snprintf(buf, sizeof buf, "not a zstd frame (magic 0x%08x at byte %zu)", m, p);
      fail(buf);
    }
    Header h = read_header(src + p, n - p);
    if (h.content < 0) unknown = true; else total += h.content;
    p += h.hdr;
    size_t frame_start = out ? out->pos : 0;
    size_t block_max = h.window < (128u << 10) ? size_t(h.window) : (128u << 10);
    FrameState fs;
    bool last = false;
    while (!last) {
      if (n - p < 3) fail("a truncated zstd block header");
      uint32_t bh = src[p] | (src[p + 1] << 8) | (src[p + 2] << 16);
      p += 3;
      last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("a zstd block of the reserved type");
      size_t csz = type == 1 ? 1 : size;
      if (csz > n - p) fail("a zstd block past the end of the data");
      if (out) {
        if (type == 0) {
          out->need(size);
          std::memcpy(out->dst + out->pos, src + p, size);
          out->pos += size;
        } else if (type == 1) {
          out->need(size);
          std::memset(out->dst + out->pos, src[p], size);
          out->pos += size;
        } else {
          if (size > block_max) fail("a compressed block larger than the block size");
          decode_block(src + p, size, fs, *out, frame_start, block_max);
        }
      }
      p += csz;
    }
    if (out && h.content >= 0 && int64_t(out->pos - frame_start) != h.content)
      fail("a zstd frame whose content is " + std::to_string(out->pos - frame_start) +
           " bytes, its header says " + std::to_string(h.content));
    if (h.checksum) {
      if (n - p < 4) fail("a zstd frame without its content checksum");
      if (out) {
        uint32_t want = rd32(src + p);
        uint32_t got = uint32_t(xxh64_impl(out->dst + frame_start, out->pos - frame_start, 0));
        if (want != got) {
          char buf[96];
          std::snprintf(buf, sizeof buf,
                        "zstd content checksum mismatch (frame says %08x, content gives %08x)",
                        want, got);
          fail(buf);
        }
      }
      p += 4;
    }
  }
  return unknown ? -2 : total;
}

void set_err(char* err, int64_t cap, const char* msg) {
  if (err && cap > 0) {
    std::strncpy(err, msg, size_t(cap) - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

int64_t zstd_content_size(const uint8_t* src, int64_t n, char* err, int64_t errcap) {
  try {
    return run(src, size_t(n), nullptr);
  } catch (const ZstdError& e) {
    set_err(err, errcap, e.what());
    return -1;
  }
}

int64_t zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err,
                    int64_t errcap) {
  Out out{dst, size_t(cap)};
  try {
    run(src, size_t(n), &out);
    return int64_t(out.pos);
  } catch (const OutputFull&) {
    return -2;
  } catch (const ZstdError& e) {
    set_err(err, errcap, e.what());
    return -1;
  } catch (const std::bad_alloc&) {
    set_err(err, errcap, "out of memory");
    return -1;
  }
}

uint32_t crc32c(const uint8_t* src, int64_t n) { return crc32c_impl(src, size_t(n)); }

}  // extern "C"
