// Host-side image decoding for the port's image-folder loaders
// (data/codec.py): JPEG and the pixel half of PNG, with a plain C interface
// loaded through ctypes. Nothing here keeps global state, so loader threads
// decode in parallel (ctypes releases the interpreter lock during a call).
//
// The JPEG path computes what libjpeg(-turbo) gives with its defaults, as
// Pillow's Image.open(path).convert("RGB") uses them:
//   * Huffman baseline (SOF0), extended sequential (SOF1) and progressive
//     (SOF2) frames, 8-bit samples, restart intervals;
//   * 1 (grey), 3 (YCbCr, or RGB by the Adobe transform / component ids) or
//     4 (CMYK / YCCK, inverted as Pillow reads them, then Pillow's CMYK ->
//     RGB) components;
//   * dequantization and the integer "islow" IDCT (jidctint.c), its output
//     saturated to 0..255 as the SIMD versions of it do;
//   * fancy upsampling (jdsample.c h2v1_fancy_upsample, h1v2_fancy_upsample,
//     h2v2_fancy_upsample; plain replication where libjpeg uses it);
//   * the table-driven YCbCr -> RGB of jdcolor.c.
// Arithmetic coding, 12-bit and lossless/hierarchical frames, a missing
// image height (DNL), and truncated or corrupt entropy-coded data are
// refused with an error code (gl_error_string names the reason). So is a
// progressive image whose scans leave some of the first AC coefficients
// unrefined: libjpeg smooths such blocks (jdcoefct.c decompress_smooth_data),
// which this decoder does not.
//
// The PNG path takes the inflated IDAT stream (zlib stays in Python),
// unfilters it (None/Sub/Up/Average/Paeth), de-interlaces Adam7 and maps
// every colour type and bit depth to RGB as Pillow's convert("RGB") does.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kNotJpeg,
  kTruncated,
  kArithmetic,
  kPrecision,
  kLossless,
  kHierarchical,
  kComponents,
  kSampling,
  kBadMarker,
  kBadHuffman,
  kBadTable,
  kNoFrame,
  kCorrupt,
  kSmoothing,
  kDnl,
  kSize,
  kPngData,
  kPngFilter,
  kPngFormat,
  kCount,
};

const char* const kMessages[] = {
    "ok",
    "not a JPEG stream (no SOI marker)",
    "truncated file: the data ends before the image does",
    "arithmetic-coded JPEG is not supported",
    "JPEG sample precision other than 8 bits (e.g. 12-bit) is not supported",
    "lossless JPEG is not supported",
    "hierarchical (differential) JPEG is not supported",
    "JPEG component count other than 1, 3 or 4, or a scan naming an unknown component",
    "JPEG sampling factors that libjpeg cannot upsample by an integer ratio",
    "misplaced or unknown JPEG marker",
    "corrupt JPEG Huffman code or table",
    "corrupt JPEG quantization table, or a component whose table is missing",
    "JPEG without a frame header (SOF) before its first scan",
    "corrupt JPEG entropy-coded data (a scan overran its data or a restart marker is out of order)",
    "progressive JPEG whose scans leave AC coefficients unrefined (libjpeg would smooth its blocks)",
    "JPEG whose height is defined by a DNL marker is not supported",
    "image size does not match the caller's buffer",
    "PNG image data is shorter than its header promises",
    "PNG row with an unknown filter type",
    "PNG bit depth and colour type do not combine",
};

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // guard entries for a corrupt run past the end of a block
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Fail {
  int status;
};

[[noreturn]] void fail(int status) { throw Fail{status}; }

inline int clamp8(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// ---------------------------------------------------------------- Huffman

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t fast_len[1 << kLookBits];
  uint8_t fast_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memset(fast_len, 0, sizeof(fast_len));
    std::memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      // the length's codes must fit in it, and none may be all ones (libjpeg's
      // jpeg_make_d_derived_tbl); checked before any entry below is written,
      // so no lookahead index passes (1 << kLookBits) - 1
      if (counts[len - 1] && code + counts[len - 1] >= (1 << len)) fail(kBadHuffman);
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int j = 0; j < (1 << shift); ++j) {
            fast_len[(code << shift) | j] = static_cast<uint8_t>(len);
            fast_val[(code << shift) | j] = symbols[k];
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// ---------------------------------------------------------------- bit reader

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;   // left-aligned
  int count = 0;      // bits in buf
  int real = 0;       // of those, bits of data (the rest is zero padding)
  int marker = 0;     // a marker met inside the entropy-coded data
  bool overrun = false;

  BitReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  void fill() {
    while (count <= 56) {
      uint32_t byte = 0;
      bool data = false;
      if (!marker && p < end) {
        byte = *p++;
        data = true;
        if (byte == 0xFF) {
          while (p < end && *p == 0xFF) ++p;  // fill bytes
          if (p >= end) {
            data = false;
            byte = 0;
          } else if (*p == 0) {
            ++p;  // stuffed zero: a data byte 0xFF
          } else {
            marker = *p++;
            data = false;
            byte = 0;
          }
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - count);
      count += 8;
      if (data) real += 8;
    }
  }
  uint32_t peek(int n) {
    if (count < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    count -= n;
    real -= n;
    if (real < 0) {
      overrun = true;
      real = 0;
    }
  }
  uint32_t bits(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  int bit() { return static_cast<int>(bits(1)); }
  // discard the rest of the current byte-aligned data (restart / scan end)
  void reset() {
    buf = 0;
    count = 0;
    real = 0;
  }

  int decode(const HuffTable& h) {
    uint32_t look = peek(kLookBits);
    int len = h.fast_len[look];
    if (len) {
      skip(len);
      return h.fast_val[look];
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(peek(l));
    while (code > h.maxcode[l]) {
      if (++l > 16) fail(kBadHuffman);
      code = static_cast<int32_t>(peek(l));
    }
    skip(l);
    int idx = code + h.valoffset[l];
    if (idx < 0 || idx > 255) fail(kBadHuffman);
    return h.vals[idx];
  }
};

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
}

// ---------------------------------------------------------------- JPEG

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;   // blocks allocated across and down (whole MCUs)
  int dw = 0, dh = 0;   // downsampled size in samples
  int dc_pred = 0, td = 0, ta = 0;
  bool latched = false;
  uint16_t quant[64];   // natural order, latched at the component's first scan
  int coef_bits[64];
  std::vector<int16_t> coefs;
  int16_t* block(int bx, int by) { return &coefs[(static_cast<size_t>(by) * bw + bx) * 64]; }
};

struct Jpeg {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int eobrun = 0;
  int pending = 0;  // a marker the entropy decoder read past
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];

  Jpeg(const uint8_t* d, size_t n) : data(d), end(d + n), p(d) {}

  int u8() {
    if (p >= end) fail(kTruncated);
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // next marker code, skipping garbage between segments as libjpeg does
  int next_marker() {
    if (pending) {
      int m = pending;
      pending = 0;
      return m;
    }
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do c = u8(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void read_dqt(int len) {
    const uint8_t* stop = p + len;
    if (stop > end) fail(kTruncated);
    while (p < stop) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail(kBadTable);
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    if (p != stop) fail(kBadTable);
  }

  void read_dht(int len) {
    const uint8_t* stop = p + len;
    if (stop > end) fail(kTruncated);
    while (p < stop) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail(kBadHuffman);
      uint8_t counts[16], symbols[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = static_cast<uint8_t>(u8());
      if (total > 256) fail(kBadHuffman);
      for (int i = 0; i < total; ++i) symbols[i] = static_cast<uint8_t>(u8());
      (tc ? ac : dc)[th].build(counts, symbols, total);
    }
    if (p != stop) fail(kBadHuffman);
  }

  void read_app(int marker, int len) {
    if (p + len > end) fail(kTruncated);
    if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    p += len;
  }

  void read_sof(int marker, int len) {
    if (frame) fail(kBadMarker);
    if (marker == 0xC3) fail(kLossless);
    if (marker >= 0xC5 && marker <= 0xC7) fail(kHierarchical);
    if (marker >= 0xC9 && marker <= 0xCB) fail(kArithmetic);
    if (marker >= 0xCD) fail(kHierarchical);
    const uint8_t* stop = p + len;
    if (u8() != 8) fail(kPrecision);
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail(kDnl);
    if (width == 0) fail(kBadMarker);
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) fail(kComponents);
    if (len != 6 + 3 * ncomp) fail(kBadMarker);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = u8();
      int hv = u8();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = u8();
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) fail(kSampling);
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    p = stop;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.dw = static_cast<int>((static_cast<long>(width) * k.h + hmax - 1) / hmax);
      k.dh = static_cast<int>((static_cast<long>(height) * k.v + vmax - 1) / vmax);
      k.coefs.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
    }
    progressive = marker == 0xC2;
    frame = true;
  }

  // ---- entropy decoding of one block, per kind of scan

  void block_baseline(BitReader& br, Component& k, int16_t* blk) {
    int t = br.decode(dc[k.td]);
    if (t > 16) fail(kBadHuffman);
    k.dc_pred += extend(br.bits(t), t);
    blk[0] = static_cast<int16_t>(k.dc_pred);
    const HuffTable& h = ac[k.ta];
    for (int i = 1; i < 64; ++i) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) fail(kCorrupt);
        blk[kNatural[i]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void block_dc_first(BitReader& br, Component& k, int16_t* blk, int al) {
    int t = br.decode(dc[k.td]);
    if (t > 16) fail(kBadHuffman);
    k.dc_pred += extend(br.bits(t), t);
    blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(k.dc_pred) << al));
  }

  void block_dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void block_ac_first(BitReader& br, Component& k, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const HuffTable& h = ac[k.ta];
    for (int i = ss; i <= se; ++i) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) fail(kCorrupt);
        blk[kNatural[i]] = static_cast<int16_t>(
            static_cast<int>(static_cast<unsigned>(extend(br.bits(s), s)) << al));
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += static_cast<int>(br.bits(r));
        --eobrun;
        break;
      }
    }
  }

  void block_ac_refine(BitReader& br, Component& k, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun == 0) {
      const HuffTable& h = ac[k.ta];
      for (; i <= se; ++i) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail(kCorrupt);
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.bits(r));
          break;
        }
        do {
          int16_t* c = &blk[kNatural[i]];
          if (*c != 0) {
            if (br.bit() && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          } else {
            if (--r < 0) break;
          }
          ++i;
        } while (i <= se);
        if (s) {
          if (i > 63) fail(kCorrupt);
          blk[kNatural[i]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = &blk[kNatural[i]];
        if (*c != 0 && br.bit() && (*c & p1) == 0)
          *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  // ---- one scan

  void read_sos(int len) {
    if (!frame) fail(kNoFrame);
    const uint8_t* stop = p + len;
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail(kBadMarker);
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) fail(kComponents);
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) fail(kBadHuffman);
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    p = stop;
    if (progressive) {
      bool dc_scan = ss == 0;
      if (dc_scan ? se != 0 : (se < ss || se > 63 || ns != 1)) fail(kCorrupt);
      if (al > 13 || (ah && ah - 1 != al)) fail(kCorrupt);
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      // libjpeg ignores these fields of a sequential scan (a warning at most)
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (!k.latched) {
        if (!qt_defined[k.tq]) fail(kBadTable);
        std::memcpy(k.quant, qt[k.tq], sizeof(k.quant));
        k.latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[k.td].defined) || (need_ac && !ac[k.ta].defined)) fail(kBadHuffman);
      for (int c = ss; c <= se; ++c) k.coef_bits[c] = al;
      k.dc_pred = 0;
    }
    eobrun = 0;

    BitReader br(p, end);
    int kind = !progressive ? 0 : (ss == 0 ? (ah == 0 ? 1 : 2) : (ah == 0 ? 3 : 4));
    auto one = [&](Component& k, int bx, int by) {
      int16_t* blk = k.block(bx, by);
      switch (kind) {
        case 0: block_baseline(br, k, blk); break;
        case 1: block_dc_first(br, k, blk, al); break;
        case 2: block_dc_refine(br, blk, al); break;
        case 3: block_ac_first(br, k, blk, ss, se, al); break;
        default: block_ac_refine(br, k, blk, ss, se, al); break;
      }
    };
    long units, across;
    if (ns == 1) {
      Component& k = *sc[0];
      across = (k.dw + 7) / 8;
      units = across * ((k.dh + 7) / 8);
    } else {
      across = mcux;
      units = static_cast<long>(mcux) * mcuy;
    }
    int next_rst = 0;
    for (long u = 0; u < units; ++u) {
      if (restart_interval && u > 0 && u % restart_interval == 0) {
        if (br.overrun) fail(kCorrupt);
        br.reset();
        int m = br.marker;
        if (!m) {  // the marker after the interval's last byte
          p = br.p;
          m = next_marker();
          br.p = p;
        }
        if (m != 0xD0 + next_rst) fail(kCorrupt);
        next_rst = (next_rst + 1) & 7;
        br.marker = 0;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun = 0;
      }
      long ux = u % across, uy = u / across;
      if (ns == 1) {
        one(*sc[0], static_cast<int>(ux), static_cast<int>(uy));
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& k = *sc[i];
          for (int y = 0; y < k.v; ++y)
            for (int x = 0; x < k.h; ++x)
              one(k, static_cast<int>(ux * k.h + x), static_cast<int>(uy * k.v + y));
        }
      }
    }
    if (br.overrun) fail(br.p >= end && !br.marker ? kTruncated : kCorrupt);
    // the segment after the scan starts at the marker that ended its data
    p = br.p;
    pending = br.marker;
  }

  void parse(bool header_only) {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) fail(kNotJpeg);
    p += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RST: libjpeg skips it
      if (m == 0x01) continue;               // TEM
      int len = u16() - 2;
      if (len < 0) fail(kBadMarker);
      if (p + len > end) fail(kTruncated);
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m, len);
        if (header_only) return;
      } else if (m == 0xC4) {
        read_dht(len);
      } else if (m == 0xCC) {
        fail(kArithmetic);
      } else if (m == 0xDB) {
        read_dqt(len);
      } else if (m == 0xDD) {
        if (len != 2) fail(kBadMarker);
        restart_interval = u16();
      } else if (m == 0xDA) {
        read_sos(len);
      } else if (m == 0xDC) {
        fail(kDnl);
      } else if (m == 0xDE || m == 0xDF) {
        fail(kHierarchical);
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
        read_app(m, len);
      } else {
        p += len;  // JPG extensions and other reserved segments: skipped
      }
    }
    if (!frame) fail(kNoFrame);
    if (header_only) return;
    if (progressive) {
      for (int c = 0; c < ncomp; ++c) {
        if (comp[c].coef_bits[0] < 0) continue;  // no DC: libjpeg does not smooth
        for (int i = 1; i < 10; ++i)
          if (comp[c].coef_bits[i] != 0) fail(kSmoothing);
      }
    }
    for (int c = 0; c < ncomp; ++c)
      if (!comp[c].latched) fail(kTruncated);  // a component no scan carried
  }
};

// ---- jidctint.c jpeg_idct_islow

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                  F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dcval = static_cast<int>(static_cast<int64_t>(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
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
    const int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  auto put = [](int64_t v) { return static_cast<uint8_t>(clamp8(static_cast<int>(v) + 128)); };
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = put(descale(wp[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
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
    op[0] = put(descale(tmp10 + tmp3, sh));
    op[7] = put(descale(tmp10 - tmp3, sh));
    op[1] = put(descale(tmp11 + tmp2, sh));
    op[6] = put(descale(tmp11 - tmp2, sh));
    op[2] = put(descale(tmp12 + tmp1, sh));
    op[5] = put(descale(tmp12 - tmp1, sh));
    op[3] = put(descale(tmp13 + tmp0, sh));
    op[4] = put(descale(tmp13 - tmp0, sh));
  }
}

// ---- jdsample.c: one component's samples at the output resolution
// (width dw * fh, height dh * fv; rows and columns past the downsampled size
// are never read: the context at the edges repeats the last sample)

std::vector<uint8_t> upsample(const uint8_t* in, int stride, int dw, int dh, int fh, int fv) {
  const int ow = dw * fh, oh = dh * fv;
  std::vector<uint8_t> out(static_cast<size_t>(ow) * oh);
  auto row = [&](int r) { return in + static_cast<size_t>(std::min(std::max(r, 0), dh - 1)) * stride; };
  if (fh == 2 && fv == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int r = 0; r < dh; ++r) {
      const uint8_t* s = row(r);
      uint8_t* o = &out[static_cast<size_t>(r) * ow];
      for (int i = 0; i < dw; ++i) {
        int x = 3 * s[i];
        o[2 * i] = static_cast<uint8_t>((x + s[std::max(i - 1, 0)] + 1) >> 2);
        o[2 * i + 1] = static_cast<uint8_t>((x + s[std::min(i + 1, dw - 1)] + 2) >> 2);
      }
    }
  } else if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    for (int r = 0; r < dh; ++r) {
      const uint8_t* s0 = row(r);
      for (int v = 0; v < 2; ++v) {
        const uint8_t* s1 = row(v ? r + 1 : r - 1);
        int bias = v ? 2 : 1;
        uint8_t* o = &out[static_cast<size_t>(2 * r + v) * ow];
        for (int i = 0; i < dw; ++i) o[i] = static_cast<uint8_t>((3 * s0[i] + s1[i] + bias) >> 2);
      }
    }
  } else if (fh == 2 && fv == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> sum(dw);
    for (int r = 0; r < dh; ++r) {
      const uint8_t* s0 = row(r);
      for (int v = 0; v < 2; ++v) {
        const uint8_t* s1 = row(v ? r + 1 : r - 1);
        for (int i = 0; i < dw; ++i) sum[i] = 3 * s0[i] + s1[i];
        uint8_t* o = &out[static_cast<size_t>(2 * r + v) * ow];
        for (int i = 0; i < dw; ++i) {
          int x = 3 * sum[i];
          o[2 * i] = static_cast<uint8_t>((x + sum[std::max(i - 1, 0)] + 8) >> 4);
          o[2 * i + 1] = static_cast<uint8_t>((x + sum[std::min(i + 1, dw - 1)] + 7) >> 4);
        }
      }
    }
  } else {  // fullsize, h2v1_upsample, h2v2_upsample, int_upsample: replication
    for (int r = 0; r < oh; ++r) {
      const uint8_t* s = in + static_cast<size_t>(r / fv) * stride;
      uint8_t* o = &out[static_cast<size_t>(r) * ow];
      for (int i = 0; i < ow; ++i) o[i] = s[i / fh];
    }
  }
  return out;
}

// ---- jdcolor.c build_ycc_rgb_table

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

void decode_jpeg(const uint8_t* data, size_t n, uint8_t* out, int width, int height) {
  Jpeg j(data, n);
  j.parse(false);
  if (j.width != width || j.height != height) fail(kSize);
  const int nc = j.ncomp;
  std::vector<uint8_t> planes[4];
  int ow[4];
  for (int c = 0; c < nc; ++c) {
    Component& k = j.comp[c];
    if (j.hmax % k.h || j.vmax % k.v) fail(kSampling);
    const int stride = k.bw * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride) * k.bh * 8);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(k.block(bx, by), k.quant, &plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                   stride);
    planes[c] = upsample(plane.data(), stride, k.dw, k.dh, j.hmax / k.h, j.vmax / k.v);
    ow[c] = k.dw * (j.hmax / k.h);
  }
  auto at = [&](int c, int x, int y) { return planes[c][static_cast<size_t>(y) * ow[c] + x]; };
  uint8_t* o = out;
  if (nc == 1) {
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x, o += 3) o[0] = o[1] = o[2] = at(0, x, y);
    return;
  }
  // libjpeg's colour space of the stored components (jdapimin.c
  // default_decompress_parms): JFIF first, then the Adobe transform, then
  // the component ids
  bool ycc;
  if (nc == 3) {
    if (j.jfif) ycc = true;
    else if (j.adobe) ycc = j.adobe_transform != 0;
    else ycc = !(j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B');
  } else {
    ycc = j.adobe && j.adobe_transform != 0;  // YCCK
  }
  static const YccTables t;
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x, o += 3) {
      int c0 = at(0, x, y), c1 = at(1, x, y), c2 = at(2, x, y);
      int r = c0, g = c1, b = c2;
      if (ycc) {
        r = clamp8(c0 + t.cr_r[c2]);
        g = clamp8(c0 + static_cast<int>((t.cb_g[c1] + t.cr_g[c2]) >> 16));
        b = clamp8(c0 + t.cb_b[c1]);
      }
      if (nc == 4) {
        // libjpeg's CMYK (YCCK -> CMYK inverts R, G, B), Pillow's inversion
        // of every JPEG's CMYK ("CMYK;I"), then Pillow's cmyk2rgb
        int cmyk[4] = {ycc ? r : 255 - r, ycc ? g : 255 - g, ycc ? b : 255 - b,
                       255 - at(3, x, y)};
        int nk = 255 - cmyk[3];
        int rgb[3];
        for (int i = 0; i < 3; ++i) {
          int tmp = cmyk[i] * nk + 128;
          rgb[i] = clamp8(nk - (((tmp >> 8) + tmp) >> 8));
        }
        r = rgb[0];
        g = rgb[1];
        b = rgb[2];
      }
      o[0] = static_cast<uint8_t>(r);
      o[1] = static_cast<uint8_t>(g);
      o[2] = static_cast<uint8_t>(b);
    }
  }
}

// ---------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void decode_png(const uint8_t* raw, size_t n, int w, int h, int depth, int ctype, int interlace,
                const uint8_t* palette, uint8_t* out) {
  int channels;
  switch (ctype) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: fail(kPngFormat);
  }
  bool ok = (ctype == 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16)) ||
            (ctype == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
            ((ctype == 2 || ctype == 4 || ctype == 6) && (depth == 8 || depth == 16));
  if (!ok) fail(kPngFormat);
  const int bits_pp = channels * depth;
  const int bpp = std::max(1, bits_pp / 8);
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kAdam7 : kWhole;
  const int npass = interlace ? 7 : 1;
  size_t pos = 0;
  for (int pi = 0; pi < npass; ++pi) {
    const int x0 = passes[pi][0], y0 = passes[pi][1], dx = passes[pi][2], dy = passes[pi][3];
    const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    const size_t rowbytes = (static_cast<size_t>(pw) * bits_pp + 7) / 8;
    std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
    for (int r = 0; r < ph; ++r) {
      if (pos + 1 + rowbytes > n) fail(kPngData);
      const int filter = raw[pos++];
      const uint8_t* src = raw + pos;
      pos += rowbytes;
      for (size_t i = 0; i < rowbytes; ++i) {
        int a = i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0;
        int b = prev[i];
        int c = i >= static_cast<size_t>(bpp) ? prev[i - bpp] : 0;
        int x = src[i];
        switch (filter) {
          case 0: break;
          case 1: x += a; break;
          case 2: x += b; break;
          case 3: x += (a + b) >> 1; break;
          case 4: x += paeth(a, b, c); break;
          default: fail(kPngFilter);
        }
        cur[i] = static_cast<uint8_t>(x);
      }
      const int y = y0 + r * dy;
      for (int i = 0; i < pw; ++i) {
        uint8_t* o = out + (static_cast<size_t>(y) * w + x0 + static_cast<size_t>(i) * dx) * 3;
        int s[4];
        if (depth < 8) {
          const size_t bit = static_cast<size_t>(i) * depth;
          s[0] = (cur[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
        } else {
          const int step = depth / 8;
          for (int ch = 0; ch < channels; ++ch) {
            const uint8_t* q = &cur[(static_cast<size_t>(i) * channels + ch) * step];
            // 16-bit grey reaches RGB clamped (Pillow's I;16), the rest by
            // their high bytes (Pillow's ";16B" raw modes)
            s[ch] = step == 1 ? q[0] : (ctype == 0 ? std::min((q[0] << 8) | q[1], 255) : q[0]);
          }
        }
        if (ctype == 3) {
          o[0] = palette[3 * s[0]];
          o[1] = palette[3 * s[0] + 1];
          o[2] = palette[3 * s[0] + 2];
        } else if (ctype == 0 || ctype == 4) {
          int g = s[0];
          if (ctype == 0 && depth < 8) g = depth == 1 ? g * 255 : (depth == 2 ? g * 85 : g * 17);
          o[0] = o[1] = o[2] = static_cast<uint8_t>(g);
        } else {
          o[0] = static_cast<uint8_t>(s[0]);
          o[1] = static_cast<uint8_t>(s[1]);
          o[2] = static_cast<uint8_t>(s[2]);
        }
      }
      std::swap(prev, cur);
    }
  }
}

template <typename F>
int guarded(F f) {
  try {
    f();
    return kOk;
  } catch (const Fail& e) {
    return e.status;
  } catch (...) {
    return kCorrupt;
  }
}

}  // namespace

extern "C" {

// Size of a JPEG stream's frame; 0 on success, else a status for
// gl_error_string.
int gl_jpeg_info(const uint8_t* data, size_t n, int* width, int* height, int* components) {
  return guarded([&] {
    Jpeg j(data, n);
    j.parse(true);
    *width = j.width;
    *height = j.height;
    *components = j.ncomp;
  });
}

// Decode a JPEG stream to RGB uint8 [height, width, 3].
int gl_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int width, int height) {
  return guarded([&] { decode_jpeg(data, n, out, width, height); });
}

// Unfilter an inflated PNG IDAT stream and map it to RGB uint8 [h, w, 3];
// palette holds 256 RGB entries.
int gl_png_unfilter(const uint8_t* raw, size_t n, int w, int h, int depth, int ctype,
                    int interlace, const uint8_t* palette, uint8_t* out) {
  return guarded([&] { decode_png(raw, n, w, h, depth, ctype, interlace, palette, out); });
}

const char* gl_error_string(int status) {
  return status >= 0 && status < kCount ? kMessages[status] : "unknown status";
}

}  // extern "C"
