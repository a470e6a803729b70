// Baseline and progressive JPEG decoding for fourm_torch/data/image_io.py,
// equal byte for byte to what Pillow gives (Pillow's JPEG plugin decodes
// through libjpeg-turbo with its defaults): Huffman entropy decoding with
// restart intervals; DC / AC first and refinement scans of progressive files,
// whose coefficients are all buffered and decoded once every scan is read;
// the integer "islow" inverse DCT of jidctint.c with its range limit; the
// fancy (triangle) upsampling of jdsample.c for h2v1 and h2v2 chroma, box
// replication where the chroma is at most 2 samples wide; and the integer
// tables of jdcolor.c's ycc_rgb_convert. One component decodes as mode L,
// three as RGB (YCbCr, or RGB by an Adobe marker with transform 0 or the
// component ids 'R', 'G', 'B', as libjpeg guesses the colour space).
//
// What libjpeg-turbo decodes otherwise, or what Pillow does not take, raises
// with the feature named: arithmetic coding, lossless and hierarchical
// files, a precision other than 8 bits, four components (CMYK / YCCK),
// sampling factors other than 4:4:4, 4:2:2 (h2v1) and 4:2:0 (h2v2), a
// progressive file whose coefficients are not all refined to their last bit
// (libjpeg-turbo block-smooths those), and a truncated file. EXIF
// orientation is not applied (Image.open does not apply it).
//
// Exposed C ABI (bound in fourm_torch/native/__init__.py):
//   jpeg_info(data, n, dims[3], err, errcap) -> 0, or -1 with err set
//     dims: height, width, components
//   jpeg_decode(data, n, out, outcap, err, errcap) -> 0, or -1 with err set
//     out: height * width * components bytes, row-major, interleaved

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  explicit JpegError(const std::string& s) : std::runtime_error(s) {}
};

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // extra entries: a corrupt run past 63 lands here, as in jpeg_natural_order
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // canonical decoding: maxcode / valptr per length, and an 8-bit lookahead
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  int16_t look_nbits[256];
  uint8_t look_sym[256];

  void build(const uint8_t* bits, const uint8_t* hv, int nvals) {
    std::memcpy(vals, hv, nvals);
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) throw JpegError("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    for (int i = 0; i < 256; i++) look_nbits[i] = 0;
    p = 0;
    for (int l = 1; l <= 8; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; ctr--) {
          look_nbits[lookbits] = (int16_t)l;
          look_sym[lookbits] = vals[p];
          lookbits++;
        }
      }
    }
    defined = true;
  }
};

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
};
YccTables ycc_tables();

struct Component {
  int id, h, v, tq;
  int width_in_blocks, height_in_blocks;  // of the image
  int blocks_w, blocks_h;                 // allocated: whole MCUs
  int down_w, down_h;                     // downsampled_width / _height
  std::vector<int16_t> coef;              // blocks_h * blocks_w * 64
  uint16_t qt[64];                        // latched at the first scan
  bool latched = false;
  int coef_bits[64];                      // progressive: -1 never seen
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
  int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * blocks_w + bx) * 64; }
};

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : data_(d), n_(n) {}

  int height = 0, width = 0, ncomp = 0;

  void read_header() {
    if (n_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8) throw JpegError("not a JPEG file (no SOI)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
        return;
      }
      handle_marker(m);
    }
  }

  void decode(uint8_t* out) {
    // scans until EOI
    bool any_scan = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        read_sos();
        any_scan = true;
        continue;
      }
      handle_marker(m);
    }
    if (!any_scan) throw JpegError("no scan before EOI");
    if (progressive_) {
      for (int c = 0; c < ncomp; c++) {
        if (comp_[c].coef_bits[0] < 0) throw JpegError("a component's DC was never sent");
        for (int k = 1; k < 64; k++)
          if (comp_[c].coef_bits[k] != 0)
            throw JpegError("progressive file whose coefficients are not all refined to "
                            "their last bit (libjpeg-turbo block-smooths it)");
      }
    }
    output(out);
  }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  Component comp_[3];
  int max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  bool progressive_ = false, saw_frame_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  // bit reader
  uint64_t bitbuf_ = 0;
  int bits_ = 0;
  bool marker_hit_ = false;  // the reader stopped at a marker (or the end)
  bool eod_ = false;         // ... at the end of the data
  int64_t zero_bits_ = 0;    // zero bits fed past a marker or the end, still in the buffer
  int eobrun_ = 0;

  uint8_t byte() {
    if (pos_ >= n_) throw JpegError("truncated file (data ends inside a marker segment)");
    return data_[pos_++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }

  int next_marker() {
    // skip anything that is not a marker (libjpeg warns about it), then fill bytes
    for (;;) {
      if (pos_ >= n_) throw JpegError("truncated file (no EOI marker)");
      uint8_t b = data_[pos_++];
      if (b != 0xFF) continue;
      while (pos_ < n_ && data_[pos_] == 0xFF) pos_++;
      if (pos_ >= n_) throw JpegError("truncated file (no EOI marker)");
      uint8_t m = data_[pos_++];
      if (m != 0) return m;
    }
  }

  void skip_segment() {
    int len = u16();
    if (len < 2 || pos_ + (len - 2) > n_) throw JpegError("truncated file (marker segment)");
    pos_ += len - 2;
  }

  void handle_marker(int m) {
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (saw_frame_) throw JpegError("a second frame header (SOF)");
      read_sof(m);
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      throw JpegError("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
    } else if (m == 0xC5 || m == 0xC6) {
      throw JpegError("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
    } else if (m == 0xC9 || m == 0xCA || m == 0xCD || m == 0xCE || m == 0xCC) {
      throw JpegError("arithmetic coding is not supported");
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      if (u16() != 4) throw JpegError("bad DRI length");
      restart_interval_ = u16();
    } else if (m == 0xE0) {
      size_t start = pos_;
      int len = u16();
      if (len >= 7 && pos_ + 5 <= n_ && std::memcmp(data_ + pos_, "JFIF\0", 5) == 0)
        saw_jfif_ = true;
      pos_ = start;
      skip_segment();
    } else if (m == 0xEE) {
      size_t start = pos_;
      int len = u16();
      if (len >= 14 && pos_ + 12 <= n_ && std::memcmp(data_ + pos_, "Adobe", 5) == 0) {
        saw_adobe_ = true;
        adobe_transform_ = data_[pos_ + 11];
      }
      pos_ = start;
      skip_segment();
    } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {
      skip_segment();
    } else if (m >= 0xD0 && m <= 0xD7) {
      // a stray RST outside a scan: libjpeg ignores it
    } else if (m == 0xDC) {
      throw JpegError("DNL marker is not supported");
    } else if (m == 0xD8) {
      throw JpegError("a second SOI marker");
    } else if (m == 0xD9) {
      throw JpegError("EOI before the frame header");
    } else {
      skip_segment();
    }
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw JpegError("bad quantization table index");
      for (int i = 0; i < 64; i++) qt_[tq][kNatural[i]] = (uint16_t)(pq ? u16() : byte());
      qt_defined_[tq] = true;
      len -= 1 + 64 * (pq ? 2 : 1);
    }
    if (len != 0) throw JpegError("bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw JpegError("bad Huffman table index");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = byte();
        count += bits[i];
      }
      if (count > 256 || count > len - 17) throw JpegError("bad Huffman table");
      uint8_t hv[256];
      for (int i = 0; i < count; i++) {
        hv[i] = byte();
        // jdhuff.c jpeg_make_d_derived_tbl: a DC symbol is a bit count, 0-15
        if (tc == 0 && hv[i] > 15) throw JpegError("bad Huffman table");
      }
      (tc ? ac_ : dc_)[th].build(bits, hv, count);
      len -= 17 + count;
    }
    if (len != 0) throw JpegError("bad DHT length");
  }

  void read_sof(int m) {
    saw_frame_ = true;
    progressive_ = (m == 0xC2);
    int len = u16();
    int precision = byte();
    if (precision != 8)
      throw JpegError(std::to_string(precision) + "-bit samples are not supported (8 only)");
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0) throw JpegError("a height of 0 (DNL) is not supported");
    if (width == 0) throw JpegError("empty image");
    if (ncomp == 4) throw JpegError("four components (CMYK / YCCK) are not supported");
    if (ncomp != 1 && ncomp != 3)
      throw JpegError(std::to_string(ncomp) + " components are not supported");
    if (len != 8 + 3 * ncomp) throw JpegError("bad SOF length");
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp_[c];
      k.id = byte();
      int hv = byte();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = byte();
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        throw JpegError("bad SOF component");
      max_h_ = std::max(max_h_, k.h);
      max_v_ = std::max(max_v_, k.v);
    }
    if (ncomp == 3) {
      for (int c = 0; c < 3; c++) {
        int rh = max_h_ / comp_[c].h, rv = max_v_ / comp_[c].v;
        bool ok = max_h_ % comp_[c].h == 0 && max_v_ % comp_[c].v == 0 &&
                  ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2));
        if (!ok)
          throw JpegError("sampling factors " + std::to_string(comp_[0].h) + "x" +
                          std::to_string(comp_[0].v) + "," + std::to_string(comp_[1].h) + "x" +
                          std::to_string(comp_[1].v) + "," + std::to_string(comp_[2].h) + "x" +
                          std::to_string(comp_[2].v) +
                          " are not supported (4:4:4, 4:2:2 and 4:2:0 are)");
      }
    }
    mcus_x_ = (width + 8 * max_h_ - 1) / (8 * max_h_);
    mcus_y_ = (height + 8 * max_v_ - 1) / (8 * max_v_);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp_[c];
      k.width_in_blocks = (int)(((int64_t)width * k.h + 8 * max_h_ - 1) / (8 * max_h_));
      k.height_in_blocks = (int)(((int64_t)height * k.v + 8 * max_v_ - 1) / (8 * max_v_));
      k.down_w = (int)(((int64_t)width * k.h + max_h_ - 1) / max_h_);
      k.down_h = (int)(((int64_t)height * k.v + max_v_ - 1) / max_v_);
      k.blocks_w = mcus_x_ * k.h;
      k.blocks_h = mcus_y_ * k.v;
      if (ncomp == 1) {
        k.blocks_w = k.width_in_blocks;
        k.blocks_h = k.height_in_blocks;
      }
      k.coef.assign((size_t)k.blocks_w * k.blocks_h * 64, 0);
      for (int i = 0; i < 64; i++) k.coef_bits[i] = -1;
    }
  }

  // ---------------------------------------------------------------- bits

  void fill() {
    while (bits_ <= 56) {
      uint8_t b = 0;
      if (!marker_hit_) {
        if (pos_ >= n_) {
          marker_hit_ = true;
          eod_ = true;
        } else if (data_[pos_] == 0xFF) {
          size_t q = pos_ + 1;
          while (q < n_ && data_[q] == 0xFF) q++;  // fill bytes
          if (q < n_ && data_[q] == 0x00) {
            b = 0xFF;
            pos_ = q + 1;
          } else {
            marker_hit_ = true;  // leave pos_ at the marker; feed zeros
            eod_ = q >= n_;
          }
        } else {
          b = data_[pos_++];
        }
      }
      if (marker_hit_) zero_bits_ += 8;
      bitbuf_ |= (uint64_t)b << (56 - bits_);
      bits_ += 8;
    }
  }
  inline void check_consumed() {
    // bits taken past the end of the data: the file is truncated
    if (eod_ && zero_bits_ > bits_) throw JpegError("truncated file (data ends inside a scan)");
  }

  inline int get_bits(int n) {
    if (n == 0) return 0;
    if (bits_ < n) fill();
    int v = (int)(bitbuf_ >> (64 - n));
    bitbuf_ <<= n;
    bits_ -= n;
    if (eod_) check_consumed();
    return v;
  }
  inline int get_bit() { return get_bits(1); }

  inline int decode_huff(const Huffman& h) {
    if (bits_ < 16) fill();
    int look = (int)(bitbuf_ >> 56);
    int nb = h.look_nbits[look];
    if (nb) {
      bitbuf_ <<= nb;
      bits_ -= nb;
      if (eod_) check_consumed();
      return h.look_sym[look];
    }
    int l = 9;
    int code = (int)(bitbuf_ >> (64 - 9));
    while (l <= 16 && code > h.maxcode[l]) {
      l++;
      code = (int)(bitbuf_ >> (64 - l));
    }
    if (l > 16) throw JpegError("corrupt data: bad Huffman code");
    bitbuf_ <<= l;
    bits_ -= l;
    if (eod_) check_consumed();
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }

  // HUFF_EXTEND: an s-bit value read as a signed coefficient
  static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v + (int)((~0u) << s) + 1 : v;
  }

  void reset_bits() {
    bitbuf_ = 0;
    bits_ = 0;
    zero_bits_ = 0;
    marker_hit_ = false;
    eod_ = false;
  }

  void restart(int ns, Component** sc) {
    // discard the rest of the byte, then expect RSTn at the reader's position
    reset_bits();
    size_t q = pos_;
    while (q < n_ && data_[q] == 0xFF) q++;
    if (q >= n_) throw JpegError("truncated file (data ends at a restart marker)");
    if (q > pos_ && data_[q] >= 0xD0 && data_[q] <= 0xD7) {
      pos_ = q + 1;
    } else {
      throw JpegError("corrupt data: a restart marker is missing");
    }
    for (int i = 0; i < ns; i++) sc[i]->last_dc = 0;
    eobrun_ = 0;
  }

  // ---------------------------------------------------------------- scans

  void read_sos() {
    if (!saw_frame_) throw JpegError("a scan before the frame header");
    int len = u16();
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) throw JpegError("bad SOS");
    Component* sc[3];
    for (int i = 0; i < ns; i++) {
      int cid = byte(), t = byte();
      int c = 0;
      while (c < ncomp && comp_[c].id != cid) c++;
      if (c == ncomp) throw JpegError("a scan names an unknown component");
      sc[i] = &comp_[c];
      sc[i]->dc_tbl = t >> 4;
      sc[i]->ac_tbl = t & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) throw JpegError("bad Huffman table index");
    }
    int ss = byte(), se = byte(), ahal = byte();
    int ah = ahal >> 4, al = ahal & 15;
    if (!progressive_ && (ss != 0 || se != 63 || ah != 0 || al != 0))
      throw JpegError("bad sequential scan parameters");
    if (progressive_) {
      bool bad = ss > se || se > 63 || al > 13 || (ah != 0 && ah != al + 1);
      if (ss == 0 && se != 0) bad = true;
      if (ss != 0 && ns != 1) bad = true;
      if (bad) throw JpegError("bad progressive scan parameters");
    }
    for (int i = 0; i < ns; i++) {
      Component& k = *sc[i];
      if (!k.latched) {
        if (!qt_defined_[k.tq]) throw JpegError("a component's quantization table is missing");
        std::memcpy(k.qt, qt_[k.tq], sizeof(k.qt));
        k.latched = true;
      }
      bool need_dc = !progressive_ || (ss == 0 && ah == 0);
      bool need_ac = !progressive_ || ss > 0;
      if (need_dc && !dc_[k.dc_tbl].defined) throw JpegError("a DC Huffman table is missing");
      if (need_ac && !ac_[k.ac_tbl].defined) throw JpegError("an AC Huffman table is missing");
      if (progressive_)
        for (int c = ss; c <= se; c++) k.coef_bits[c] = al;
      k.last_dc = 0;
    }
    eobrun_ = 0;
    reset_bits();

    // MCU geometry: one component scans its blocks; more scan whole MCUs
    int mx, my;
    if (ns == 1) {
      mx = sc[0]->width_in_blocks;
      my = sc[0]->height_in_blocks;
    } else {
      mx = mcus_x_;
      my = mcus_y_;
    }
    int todo = restart_interval_;
    for (int y = 0; y < my; y++) {
      for (int x = 0; x < mx; x++) {
        if (restart_interval_) {
          if (todo == 0) {
            restart(ns, sc);
            todo = restart_interval_;
          }
          todo--;
        }
        if (ns == 1) {
          decode_block(*sc[0], sc[0]->block(y, x), ss, se, ah, al);
        } else {
          for (int i = 0; i < ns; i++) {
            Component& k = *sc[i];
            for (int by = 0; by < k.v; by++)
              for (int bx = 0; bx < k.h; bx++)
                decode_block(k, k.block(y * k.v + by, x * k.h + bx), ss, se, ah, al);
          }
        }
      }
    }
    // the next marker follows the scan's last byte (and its padding bits)
  }

  void decode_block(Component& k, int16_t* blk, int ss, int se, int ah, int al) {
    if (!progressive_) {
      int s = decode_huff(dc_[k.dc_tbl]);
      int diff = s ? extend(get_bits(s), s) : 0;
      k.last_dc += diff;
      blk[0] = (int16_t)k.last_dc;
      const Huffman& ac = ac_[k.ac_tbl];
      for (int i = 1; i < 64; i++) {
        int rs = decode_huff(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          i += r;
          int v = extend(get_bits(s), s);
          blk[kNatural[i]] = (int16_t)v;
        } else {
          if (r != 15) break;
          i += 15;
        }
      }
      return;
    }
    if (ss == 0) {
      if (ah == 0) {
        int s = decode_huff(dc_[k.dc_tbl]);
        int diff = s ? extend(get_bits(s), s) : 0;
        k.last_dc += diff;
        blk[0] = (int16_t)((unsigned)k.last_dc << al);
      } else {
        if (get_bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
      }
      return;
    }
    const Huffman& ac = ac_[k.ac_tbl];
    if (ah == 0) {
      if (eobrun_ > 0) {
        eobrun_--;
        return;
      }
      for (int i = ss; i <= se; i++) {
        int rs = decode_huff(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          i += r;
          int v = extend(get_bits(s), s);
          blk[kNatural[i]] = (int16_t)((unsigned)v << al);
        } else {
          if (r == 15) {
            i += 15;
          } else {
            eobrun_ = 1 << r;
            if (r) eobrun_ += get_bits(r);
            eobrun_--;
            break;
          }
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun_ == 0) {
      for (; i <= se; i++) {
        int rs = decode_huff(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            if (get_bit()) {
              if ((*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
            }
          } else {
            if (--r < 0) break;
          }
          i++;
        } while (i <= se);
        if (s) blk[kNatural[i]] = (int16_t)s;
      }
    }
    if (eobrun_ > 0) {
      for (; i <= se; i++) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0) {
          if (get_bit()) {
            if ((*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          }
        }
      }
      eobrun_--;
    }
  }

  // ---------------------------------------------------------------- output

  static inline uint8_t range_limit(int x) {
    // jdmaster.c prepare_range_limit_table, post-IDCT part: x & 1023 read
    // as a signed 10-bit value, plus CENTERJSAMPLE, clamped
    int v = x & 1023;
    if (v >= 512) v -= 1024;
    v += 128;
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    // jidctint.c jpeg_idct_islow
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
          ip[56] == 0) {
        int dc = (int)((unsigned)(ip[0] * (int)qp[0]) << PASS1_BITS);
        for (int r = 0; r < 8; r++) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = ip[16] * (int64_t)qp[16], z3 = ip[48] * (int64_t)qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * (int64_t)qp[0];
      z3 = ip[32] * (int64_t)qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * (int64_t)qp[56];
      tmp1 = ip[40] * (int64_t)qp[40];
      tmp2 = ip[24] * (int64_t)qp[24];
      tmp3 = ip[8] * (int64_t)qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS - PASS1_BITS;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      wp[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
      wp[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
      wp[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
      wp[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
      wp[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
      wp[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
      wp[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
      wp[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
    }
    for (int r = 0; r < 8; r++) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
          wp[7] == 0) {
        const int sh = PASS1_BITS + 3;
        uint8_t v = range_limit((int)(((int64_t)wp[0] + (1 << (sh - 1))) >> sh));
        for (int c = 0; c < 8; c++) op[c] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS + PASS1_BITS + 3;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      op[0] = range_limit((int)((tmp10 + tmp3 + rnd) >> sh));
      op[7] = range_limit((int)((tmp10 - tmp3 + rnd) >> sh));
      op[1] = range_limit((int)((tmp11 + tmp2 + rnd) >> sh));
      op[6] = range_limit((int)((tmp11 - tmp2 + rnd) >> sh));
      op[2] = range_limit((int)((tmp12 + tmp1 + rnd) >> sh));
      op[5] = range_limit((int)((tmp12 - tmp1 + rnd) >> sh));
      op[3] = range_limit((int)((tmp13 + tmp0 + rnd) >> sh));
      op[4] = range_limit((int)((tmp13 - tmp0 + rnd) >> sh));
    }
  }

  // a component's samples: blocks_w * 8 wide, blocks_h * 8 tall
  std::vector<uint8_t> samples(Component& k, int& stride) {
    stride = k.blocks_w * 8;
    std::vector<uint8_t> plane((size_t)stride * k.blocks_h * 8);
    for (int by = 0; by < k.blocks_h; by++)
      for (int bx = 0; bx < k.blocks_w; bx++)
        idct_islow(k.block(by, bx), k.qt, plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
    return plane;
  }

  // jdsample.c: the component upsampled to (at least) the image's width and
  // height; fancy triangle filters for h2v1 / h2v2 wider than 2 samples
  std::vector<uint8_t> upsample(Component& k, const std::vector<uint8_t>& in, int stride,
                                int& ostride) {
    int rh = max_h_ / k.h, rv = max_v_ / k.v;
    int dw = k.down_w, dh = k.down_h;
    if (rh == 1 && rv == 1) {
      ostride = stride;
      return in;
    }
    ostride = dw * rh;
    std::vector<uint8_t> out((size_t)ostride * dh * rv);
    auto row = [&](int r) {  // rows past either edge repeat the edge row (jdmainct.c)
      return in.data() + (size_t)(r < 0 ? 0 : r >= dh ? dh - 1 : r) * stride;
    };
    bool fancy = dw > 2;
    if (rv == 1) {  // h2v1
      for (int r = 0; r < dh; r++) {
        const uint8_t* ip = row(r);
        uint8_t* op = out.data() + (size_t)r * ostride;
        if (!fancy) {
          for (int c = 0; c < dw; c++) op[2 * c] = op[2 * c + 1] = ip[c];
          continue;
        }
        int v = ip[0];
        op[0] = (uint8_t)v;
        op[1] = (uint8_t)((v * 3 + ip[1] + 2) >> 2);
        for (int c = 1; c < dw - 1; c++) {
          v = ip[c] * 3;
          op[2 * c] = (uint8_t)((v + ip[c - 1] + 1) >> 2);
          op[2 * c + 1] = (uint8_t)((v + ip[c + 1] + 2) >> 2);
        }
        v = ip[dw - 1];
        op[2 * dw - 2] = (uint8_t)((v * 3 + ip[dw - 2] + 1) >> 2);
        op[2 * dw - 1] = (uint8_t)v;
      }
      return out;
    }
    // h2v2
    for (int r = 0; r < dh; r++) {
      for (int half = 0; half < 2; half++) {
        const uint8_t* i0 = row(r);
        const uint8_t* i1 = row(half ? r + 1 : r - 1);
        uint8_t* op = out.data() + (size_t)(2 * r + half) * ostride;
        if (!fancy) {
          for (int c = 0; c < dw; c++) op[2 * c] = op[2 * c + 1] = i0[c];
          continue;
        }
        int thiscol = i0[0] * 3 + i1[0];
        int nextcol = i0[1] * 3 + i1[1];
        op[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
        op[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int c = 1; c < dw - 1; c++) {
          nextcol = i0[c + 1] * 3 + i1[c + 1];
          op[2 * c] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          op[2 * c + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        op[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        op[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
      }
    }
    return out;
  }

  void output(uint8_t* out) {
    std::vector<uint8_t> planes[3];
    int strides[3];
    for (int c = 0; c < ncomp; c++) {
      int s;
      std::vector<uint8_t> p = samples(comp_[c], s);
      planes[c] = ncomp == 1 ? std::move(p) : upsample(comp_[c], p, s, strides[c]);
      if (ncomp == 1) strides[c] = s;
    }
    if (ncomp == 1) {
      for (int y = 0; y < height; y++)
        std::memcpy(out + (size_t)y * width, planes[0].data() + (size_t)y * strides[0], width);
      return;
    }
    bool rgb = false;  // jdapimin.c default_decompress_parms
    if (saw_jfif_) {
      rgb = false;
    } else if (saw_adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
    }
    if (rgb) {
      for (int y = 0; y < height; y++) {
        uint8_t* op = out + (size_t)y * width * 3;
        for (int x = 0; x < width; x++)
          for (int c = 0; c < 3; c++) op[3 * x + c] = planes[c][(size_t)y * strides[c] + x];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    static const YccTables t = ycc_tables();
    const int *cr_r = t.cr_r, *cb_b = t.cb_b;
    const int64_t *cr_g = t.cr_g, *cb_g = t.cb_g;
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < height; y++) {
      const uint8_t* yp = planes[0].data() + (size_t)y * strides[0];
      const uint8_t* cbp = planes[1].data() + (size_t)y * strides[1];
      const uint8_t* crp = planes[2].data() + (size_t)y * strides[2];
      uint8_t* op = out + (size_t)y * width * 3;
      for (int x = 0; x < width; x++) {
        int yy = yp[x], cb = cbp[x], cr = crp[x];
        op[3 * x] = clamp(yy + cr_r[cr]);
        op[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        op[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};

YccTables ycc_tables() {
  YccTables t;
  const int SCALEBITS = 16;
  const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
  auto FIX = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
  for (int i = 0, x = -128; i <= 255; i++, x++) {
    t.cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    t.cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    t.cr_g[i] = -FIX(0.71414) * x;
    t.cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
  }
  return t;
}

void set_err(char* err, int64_t cap, const std::string& msg) {
  if (cap <= 0) return;
  std::snprintf(err, (size_t)cap, "%s", msg.c_str());
}

}  // namespace

extern "C" int64_t jpeg_info(const uint8_t* data, int64_t n, int64_t* dims, char* err,
                             int64_t errcap) {
  try {
    Decoder d(data, (size_t)n);
    d.read_header();
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = d.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return -1;
  }
}

extern "C" int64_t jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t outcap,
                               char* err, int64_t errcap) {
  try {
    Decoder d(data, (size_t)n);
    d.read_header();
    if ((int64_t)d.height * d.width * d.ncomp > outcap) throw JpegError("output buffer too small");
    d.decode(out);
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return -1;
  }
}
