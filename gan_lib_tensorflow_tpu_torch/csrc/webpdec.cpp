// Host-side WebP decoding for the port's image-folder loaders
// (data/codec.py), with a plain C interface loaded through ctypes. Nothing
// here keeps global state, so loader threads decode in parallel.
//
// It computes what Pillow's Image.open(path).convert("RGB") gives for a
// WebP file: Pillow opens every WebP through libwebp's animation decoder,
// whose first frame is composited onto a canvas zero-filled to (0,0,0,0)
// and decoded as non-premultiplied RGBA; convert("RGB") keeps its RGB.
// gl_webp_decode writes that RGBA canvas. Written from the public
// specifications:
//   * the RIFF container, the extended format (VP8X; ICCP, EXIF, XMP and
//     unknown chunks skipped; ANIM/ANMF, frame 0 only; ALPH) and the
//     lossless bitstream (VP8L) of RFC 9649: simple and normal prefix
//     codes, LZ77 backward references with the 120-entry distance map, the
//     color cache, meta prefix codes, and the predictor (modes 0-13),
//     cross-color, subtract-green and color-indexing (with pixel bundling)
//     transforms;
//   * lossy VP8 key frames of RFC 6386: the boolean decoder, segments,
//     quantizer and loop-filter deltas, coefficient probability updates,
//     1/2/4/8 token partitions, 16x16, 4x4 and chroma intra prediction, the
//     inverse DCT and WHT, and the normal and simple loop filters (inner
//     edges skipped in a 16x16-predicted macroblock without coefficients);
//   * the YUV -> RGB step as libwebp does it by default: the "fancy"
//     upsampler (a 9-3-3-1 filter over the chroma samples, the first and
//     last rows mirrored) and 14-bit fixed-point BT.601 coefficients. The
//     VP8 planes are exact by the RFC; this step fixes the last bit;
//   * the alpha plane (ALPH): raw or VP8L-compressed (the green channel),
//     unfiltered by none/horizontal/vertical/gradient, with no level
//     dequantization (the decoder's dithering is off by default).
// A truncated or corrupt file, a VP8 frame that is not a key frame, and
// anything the format does not allow are refused with an error code
// (gl_error_string names the reason), as libwebp refuses them: the file's
// structure is checked as libwebp's demuxer checks it (Reader, parse).
// Where a corrupt stream still decodes, the decoder follows what libwebp
// does on a 64-bit x86 host (the boolean decoder's 7-byte refill, its
// branch-free read of a coefficient's sign, 16-bit sums in the inverse DCT
// of a block of more than three coefficients, the image chunk read with its
// padding byte), so that such a file decodes to Pillow's garbage too; for
// any stream an encoder writes these are the RFC's results.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kNotWebp,
  kTruncated,
  kContainer,
  kLosslessHeader,
  kLosslessData,
  kLossyHeader,
  kNotKeyFrame,
  kLossyData,
  kAlpha,
  kSize,
  kCount,
};

const char* const kMessages[] = {
    "ok",
    "not a WebP file (no RIFF/WEBP header)",
    "truncated WebP file: the data ends before its RIFF size or a chunk does",
    "corrupt WebP container (a chunk is missing, misplaced or of the wrong size)",
    "corrupt VP8L (lossless) header",
    "corrupt VP8L (lossless) bitstream",
    "corrupt VP8 (lossy) frame header",
    "VP8 frame is not a displayable key frame",
    "corrupt VP8 (lossy) data (a partition ends early)",
    "corrupt WebP alpha (ALPH) chunk",
    "image size does not match the caller's buffer",
};

struct Fail {
  int status;
};

[[noreturn]] void fail(int status) { throw Fail{status}; }

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }
inline int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
inline int div_round_up(int n, int bits) { return (n + (1 << bits) - 1) >> bits; }

// What a decode met, for tests that check which parts of the format a file
// exercises (gl_webp_decode's features): each field a bit mask or a value.
struct Features {
  uint32_t lossless = 0;    // 1 << transform type (0-3); 16 color cache; 32 meta codes;
                            // 64 simple code; 128 normal code; 256 backward reference;
                            // 512 pixel bundling
  uint32_t predictors = 0;  // 1 << predictor mode used
  int filter = 0;           // VP8 loop filter: 0 none, 1 simple, 2 normal
  int partitions = 0;       // VP8 token partitions
  int segments = 0;         // VP8 segment map in use
  int sharpness = 0;        // VP8 filter sharpness
  int alpha = 0;            // ALPH: 1 + method, | filter << 4
  uint32_t flags = 0;       // 1 animation; 2 extended format (VP8X); 4 4x4 modes;
                            // 8 16x16 modes; 16 skipped macroblocks
};

// ------------------------------------------------------------- VP8L bits

// Bits are read least significant first. Reading past the end yields
// zeros; a stream that needs more bits than it holds is refused when its
// image is complete.
class LosslessBits {
 public:
  LosslessBits(const uint8_t* data, size_t n) : data_(data), n_(n) {}

  uint32_t peek(int nbits) const {
    return static_cast<uint32_t>(window() >> (pos_ & 7)) & ((1u << nbits) - 1);
  }
  void skip(int nbits) { pos_ += nbits; }
  uint32_t read(int nbits) {
    const uint32_t v = nbits ? peek(nbits) : 0;
    pos_ += nbits;
    return v;
  }
  // the stream read no further than its last byte
  void check_end() const {
    if (pos_ > 8 * static_cast<uint64_t>(n_)) fail(kLosslessData);
  }

 private:
  uint64_t window() const {
    const size_t byte = pos_ >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n_) {
      std::memcpy(&v, data_ + byte, 8);  // little-endian hosts
    } else {
      for (size_t i = 0; byte + i < n_ && i < 8; ++i) v |= uint64_t(data_[byte + i]) << (8 * i);
    }
    return v;
  }

  const uint8_t* data_;
  size_t n_;
  uint64_t pos_ = 0;
};

// A canonical prefix code, read bit by bit with its first bit first. Codes
// of up to kRootBits bits are looked up at once; longer ones walk the
// canonical counts. A code of one symbol takes no bits.
class PrefixCode {
 public:
  static constexpr int kMaxLength = 15;
  static constexpr int kRootBits = 9;

  // false if the lengths do not make a complete code (or make none)
  bool build(const uint8_t* lengths, int alphabet) {
    std::memset(count_, 0, sizeof(count_));
    int nonzero = 0, only = 0;
    for (int s = 0; s < alphabet; ++s) {
      if (lengths[s] > kMaxLength) return false;
      ++count_[lengths[s]];
      if (lengths[s]) ++nonzero, only = s;
    }
    if (nonzero == 0) return false;
    single_ = nonzero == 1 ? only : -1;
    if (single_ >= 0) return true;
    int left = 1;  // Kraft: the code space must be used exactly
    for (int len = 1; len <= kMaxLength; ++len) {
      left = 2 * left - count_[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int offset[kMaxLength + 2] = {0};
    for (int len = 1; len <= kMaxLength; ++len) offset[len + 1] = offset[len] + count_[len];
    sorted_.assign(nonzero, 0);
    for (int s = 0; s < alphabet; ++s)
      if (lengths[s]) sorted_[offset[lengths[s]]++] = static_cast<uint16_t>(s);
    root_.assign(1 << kRootBits, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= kMaxLength; ++len, code <<= 1) {
      for (int i = 0; i < count_[len]; ++i, ++code, ++k) {
        if (len > kRootBits) continue;
        int rev = 0;  // the code's bits in stream order
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < (1 << kRootBits); j += 1 << len)
          root_[j] = static_cast<uint32_t>(sorted_[k]) | (len << 16);
      }
    }
    return true;
  }

  int read(LosslessBits& br) const {
    if (single_ >= 0) return single_;
    const uint32_t e = root_[br.peek(kRootBits)];
    if (e >> 16) {
      br.skip(e >> 16);
      return e & 0xffff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxLength; ++len) {
      code |= br.read(1);
      const int n = count_[len];
      if (code - first < n) return sorted_[index + code - first];
      index += n;
      first = (first + n) << 1;
      code <<= 1;
    }
    fail(kLosslessData);
  }

 private:
  int single_ = -1;
  int count_[kMaxLength + 1];
  std::vector<uint16_t> sorted_;
  std::vector<uint32_t> root_;
};

constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
constexpr int kCodeLengthCodes = 19;
const uint8_t kCodeLengthOrder[kCodeLengthCodes] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                                    7, 8, 9, 10, 11, 12, 13, 14, 15};
// RFC 9649 section 4.2.2: distance codes 1..120 as (dx, dy), packed as
// dy << 4 | (8 - dx)
const uint8_t kDistanceMap[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

enum TransformType { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };

struct Transform {
  int type;
  int bits;    // tile size (predictor, cross-color) or pixel bundling (color indexing)
  int xsize;   // the width of the image the transform outputs
  std::vector<uint32_t> data;  // tile data, or the 1 << (8 >> bits) palette entries
};

// one group of the five prefix codes: green+length+cache, red, blue,
// alpha, distance
struct CodeGroup {
  PrefixCode codes[5];
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

// RFC 9649 Select(L, T, TL): the estimate closer to L + T - TL
inline uint32_t select(uint32_t top, uint32_t left, uint32_t top_left) {
  int d = 0;
  for (int s = 0; s < 32; s += 8)
    d += sub3((top >> s) & 0xff, (left >> s) & 0xff, (top_left >> s) & 0xff);
  return d <= 0 ? top : left;
}

inline uint32_t clamp_add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= uint32_t(clip255(int((a >> s) & 0xff) + int((b >> s) & 0xff) - int((c >> s) & 0xff)))
           << s;
  return out;
}

inline uint32_t clamp_add_subtract_half(uint32_t a, uint32_t b) {
  const uint32_t avg = a;
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = (avg >> s) & 0xff, y = (b >> s) & 0xff;
    out |= uint32_t(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}

uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamp_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamp_add_subtract_half(average2(left, top[0]), top[-1]);
    default: return 0xff000000u;  // 0, and 14-15, which the format leaves unused
  }
}

inline int color_delta(int8_t t, int8_t c) { return (int(t) * int(c)) >> 5; }

class Lossless {
 public:
  Lossless(LosslessBits& br, Features* seen) : br_(br), seen_(seen) {}

  // A complete image stream of xsize x ysize ARGB pixels: the main image
  // (transforms and meta prefix codes allowed) or one of its sub-images.
  std::vector<uint32_t> image_stream(int xsize, int ysize, bool main) {
    std::vector<Transform> transforms;
    int width = xsize;
    if (main) {
      int seen = 0;
      while (br_.read(1)) {
        Transform t;
        t.type = br_.read(2);
        if (seen & (1 << t.type)) fail(kLosslessData);  // each transform at most once
        seen |= 1 << t.type;
        t.xsize = width;
        t.bits = 0;
        if (t.type == kPredictor || t.type == kCrossColor) {
          t.bits = br_.read(3) + 2;
          t.data = image_stream(div_round_up(width, t.bits), div_round_up(ysize, t.bits), false);
        } else if (t.type == kColorIndexing) {
          const int n = br_.read(8) + 1;
          t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
          std::vector<uint32_t> palette = image_stream(n, 1, false);
          t.data.assign(size_t(1) << (8 >> t.bits), 0);  // unused entries transparent black
          for (int i = 0; i < n; ++i) t.data[i] = i ? add_pixels(palette[i], t.data[i - 1]) : palette[0];
          width = div_round_up(width, t.bits);
        }
        seen_->lossless |= (1u << t.type) | (t.type == kColorIndexing && t.bits ? 512 : 0);
        if (t.type == kPredictor)
          for (uint32_t m : t.data) seen_->predictors |= 1u << ((m >> 8) & 0xf);
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = br_.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail(kLosslessData);
      seen_->lossless |= 16;
    }
    int meta_bits = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (main && br_.read(1)) {
      meta_bits = br_.read(3) + 2;
      seen_->lossless |= 32;
      meta = image_stream(div_round_up(width, meta_bits), div_round_up(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        groups = std::max(groups, int(m) + 1);
      }
    }
    std::vector<CodeGroup> codes(groups);
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int alphabets[5] = {kNumLiteral + kNumLength + cache_size, kNumLiteral, kNumLiteral,
                              kNumLiteral, kNumDistance};
    for (CodeGroup& g : codes)
      for (int i = 0; i < 5; ++i) read_code(alphabets[i], &g.codes[i]);
    std::vector<uint32_t> pixels =
        decode_pixels(width, ysize, codes, meta, meta_bits, cache_bits);
    br_.check_end();
    for (size_t i = transforms.size(); i-- > 0;) pixels = inverse(transforms[i], pixels, ysize);
    return pixels;
  }

 private:
  void read_code(int alphabet, PrefixCode* code) {
    std::vector<uint8_t> lengths(std::max(alphabet, kNumLiteral), 0);
    if (br_.read(1)) {  // simple code: one or two symbols
      seen_->lossless |= 64;
      const int n = br_.read(1) + 1;
      const int first = br_.read(br_.read(1) ? 8 : 1);
      lengths[first] = 1;
      if (n == 2) lengths[br_.read(8)] = 1;
    } else {
      seen_->lossless |= 128;
      uint8_t cl_lengths[kCodeLengthCodes] = {0};
      const int n = br_.read(4) + 4;
      for (int i = 0; i < n; ++i) cl_lengths[kCodeLengthOrder[i]] = br_.read(3);
      PrefixCode cl;
      if (!cl.build(cl_lengths, kCodeLengthCodes)) fail(kLosslessData);
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * br_.read(3);
        max_symbol = 2 + br_.read(nbits);
        if (max_symbol > alphabet) fail(kLosslessData);
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(br_);
        if (len < 16) {
          lengths[symbol++] = static_cast<uint8_t>(len);
          if (len) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int repeat = br_.read(kExtra[len - 16]) + kOffset[len - 16];
          if (symbol + repeat > alphabet) fail(kLosslessData);
          const int value = len == 16 ? prev : 0;
          for (int i = 0; i < repeat; ++i) lengths[symbol++] = static_cast<uint8_t>(value);
        }
      }
    }
    br_.check_end();
    if (!code->build(lengths.data(), alphabet)) fail(kLosslessData);
  }

  int prefix_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + br_.read(extra) + 1;
  }

  std::vector<uint32_t> decode_pixels(int width, int height, const std::vector<CodeGroup>& codes,
                                      const std::vector<uint32_t>& meta, int meta_bits,
                                      int cache_bits) {
    const size_t total = size_t(width) * height;
    std::vector<uint32_t> out(total);
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0, 0);
    const int meta_width = meta_bits ? div_round_up(width, meta_bits) : 0;
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(argb * 0x1e35a7bdu) >> (32 - cache_bits)] = argb;
    };
    size_t pos = 0;
    int col = 0, row = 0;
    while (pos < total) {
      const CodeGroup& g =
          meta_bits ? codes[meta[(row >> meta_bits) * meta_width + (col >> meta_bits)]] : codes[0];
      const int green = g.codes[0].read(br_);
      if (green < kNumLiteral) {
        const uint32_t red = g.codes[1].read(br_);
        const uint32_t blue = g.codes[2].read(br_);
        const uint32_t alpha = g.codes[3].read(br_);
        const uint32_t argb = (alpha << 24) | (red << 16) | (uint32_t(green) << 8) | blue;
        out[pos++] = argb;
        insert(argb);
        if (++col == width) col = 0, ++row;
      } else if (green < kNumLiteral + kNumLength) {
        const int length = prefix_value(green - kNumLiteral);
        const int code = prefix_value(g.codes[4].read(br_));
        size_t dist;
        if (code > 120) {
          dist = code - 120;
        } else {
          const int m = kDistanceMap[code - 1];
          const long d = long(m >> 4) * width + (8 - (m & 0xf));
          dist = d >= 1 ? size_t(d) : 1;
        }
        if (dist > pos || size_t(length) > total - pos) fail(kLosslessData);
        seen_->lossless |= 256;
        for (int i = 0; i < length; ++i, ++pos) {
          out[pos] = out[pos - dist];
          insert(out[pos]);
        }
        col += length;
        while (col >= width) col -= width, ++row;
      } else {
        const int key = green - kNumLiteral - kNumLength;
        if (key >= int(cache.size())) fail(kLosslessData);
        const uint32_t argb = cache[key];
        out[pos++] = argb;
        insert(argb);
        if (++col == width) col = 0, ++row;
      }
      br_.check_end();
    }
    return out;
  }

  std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in, int height) {
    const int w = t.xsize;
    switch (t.type) {
      case kPredictor: {
        const int tiles = div_round_up(w, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* row = in.data() + size_t(y) * w;
          const uint32_t* top = row - w;
          for (int x = 0; x < w; ++x) {
            int mode;
            if (y == 0) {
              mode = x == 0 ? 0 : 1;
            } else if (x == 0) {
              mode = 2;
            } else {
              mode = (t.data[(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf;
            }
            // the top-right of the last column is the row's first pixel,
            // which follows the row above in memory
            row[x] = add_pixels(row[x], predict(mode, x ? row[x - 1] : 0, top + x));
          }
        }
        return std::move(in);
      }
      case kCrossColor: {
        const int tiles = div_round_up(w, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* row = in.data() + size_t(y) * w;
          for (int x = 0; x < w; ++x) {
            const uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
            const int8_t green_to_red = int8_t(m & 0xff);
            const int8_t green_to_blue = int8_t((m >> 8) & 0xff);
            const int8_t red_to_blue = int8_t((m >> 16) & 0xff);
            const uint32_t argb = row[x];
            const int8_t green = int8_t((argb >> 8) & 0xff);
            int red = (argb >> 16) & 0xff;
            int blue = argb & 0xff;
            red = (red + color_delta(green_to_red, green)) & 0xff;
            blue += color_delta(green_to_blue, green);
            blue = (blue + color_delta(red_to_blue, int8_t(red))) & 0xff;
            row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
          }
        }
        return std::move(in);
      }
      case kSubtractGreen: {
        for (uint32_t& argb : in) {
          const uint32_t green = (argb >> 8) & 0xff;
          const uint32_t red_blue = ((argb & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
          argb = (argb & 0xff00ff00u) | red_blue;
        }
        return std::move(in);
      }
      default: {  // color indexing
        const int packed_w = div_round_up(w, t.bits);
        const int per_byte = 1 << t.bits, bits_per_pixel = 8 >> t.bits;
        const uint32_t mask = (1u << bits_per_pixel) - 1;
        std::vector<uint32_t> out(size_t(w) * height);
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = in.data() + size_t(y) * packed_w;
          uint32_t* dst = out.data() + size_t(y) * w;
          for (int x = 0; x < w; ++x) {
            const uint32_t packed = (src[x >> t.bits] >> 8) & 0xff;
            const uint32_t index = (packed >> (bits_per_pixel * (x & (per_byte - 1)))) & mask;
            dst[x] = t.data[index];
          }
        }
        return out;
      }
    }
  }

  LosslessBits& br_;
  Features* seen_;
};

// A VP8L bitstream (RFC 9649 section 3: signature, 14-bit width - 1 and
// height - 1, alpha hint, version 0) -> ARGB.
void lossless_size(const uint8_t* data, size_t n, int* width, int* height) {
  if (n < 5 || data[0] != 0x2f) fail(kLosslessHeader);
  const uint32_t bits = le32(data + 1);
  *width = int(bits & 0x3fff) + 1;
  *height = int((bits >> 14) & 0x3fff) + 1;
  if ((bits >> 29) != 0) fail(kLosslessHeader);  // version
}

std::vector<uint32_t> decode_lossless(const uint8_t* data, size_t n, int width, int height,
                                      Features* seen) {
  int w, h;
  lossless_size(data, n, &w, &h);
  if (w != width || h != height) fail(kContainer);
  LosslessBits br(data + 5, n - 5);
  Lossless dec(br, seen);
  return dec.image_stream(w, h, true);
}

// ------------------------------------------------------- VP8 boolean decoder

// RFC 6386 section 7. The value window is refilled as libwebp refills it
// on a 64-bit host: 7 bytes at once while 8 remain, then byte by byte.
// For a stream an encoder wrote that is the RFC's decoder; on a corrupt
// one (a value above the range) it keeps libwebp's bits. Reading past the
// end supplies one zero byte and marks the reader at its end: the
// macroblock (or mode row) that needed it is refused.
class BoolDecoder {
 public:
  BoolDecoder() = default;
  BoolDecoder(const uint8_t* data, size_t n) : p_(data), end_(data + n) { load(); }

  int bit(int prob) {
    if (bits_ < 0) load();
    const uint32_t split = (range_ * uint32_t(prob)) >> 8;
    const uint32_t value = uint32_t(value_ >> bits_);
    int b;
    uint32_t range;
    if (value > split) {
      range = range_ - split;
      value_ -= uint64_t(split + 1) << bits_;
      b = 1;
    } else {
      range = split + 1;
      b = 0;
    }
    int shift = 0;  // renormalize to [128, 255]
    while ((range << shift) < 128) ++shift;
    range_ = (range << shift) - 1;
    bits_ -= shift;
    return b;
  }
  int value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= bit(0x80) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    const int v = value(nbits);
    return bit(0x80) ? -v : v;
  }
  bool at_end() const { return eof_; }
  // +v or -v by one bit of probability 1/2, as libwebp's VP8GetSigned reads
  // a coefficient's sign: the bit is the sign of the 32-bit difference
  // split - value, not the comparison value > split. The two agree while
  // value <= range, as in any stream an encoder writes; a corrupt stream
  // can push value past split by more than 2^31 (a partition whose first
  // byte is over the range leaves every later bit 1, and the coefficients
  // grow until a Y2 block overflows 16 bits), and then the bit is 0 here
  // and 1 in bit(0x80).
  int sign(int v) {
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = uint32_t(value_ >> pos);
    const int32_t mask = int32_t(split - value) >> 31;  // -1: negative
    bits_ -= 1;
    range_ = (range_ + uint32_t(mask)) | 1;
    value_ -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }

 private:
  void load() {
    if (end_ - p_ >= 8) {
      uint64_t bytes = 0;
      for (int i = 0; i < 7; ++i) bytes = (bytes << 8) | p_[i];
      p_ += 7;
      value_ = (value_ << 56) | bytes;
      bits_ += 56;
    } else if (p_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *p_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }

  const uint8_t* p_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 255 - 1;  // the range less one
  int bits_ = -8;             // bits of value_ below its 8-bit window
  bool eof_ = false;
};

// ------------------------------------------------------------ VP8 tables


// RFC 6386 section 14.1 dc_qlookup and ac_qlookup
const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
    18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
    44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
    59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
    75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
    91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
    78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// coefficient position -> band, with a sentinel for position 16
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// extra bits of the DCT_CAT3..DCT_CAT6 tokens (RFC 6386 section 13.2)
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// intra modes, in the RFC's order of the 4x4 ones; a 16x16 or chroma mode
// is stored as the 4x4 mode it stands for in the contexts
enum { B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU };
const int8_t kBModeTree[18] = {-B_DC, 2, -B_TM, 4, -B_VE, 6, 8, 12, -B_HE,
                               10, -B_RD, -B_VR, -B_LD, 14, -B_VL, 16, -B_HD, -B_HU};
// RFC 6386 section 13.5 default_coeff_probs [type][band][context][node]
const uint8_t kCoeffProbs0[4][8][3][11] = {
    {  // block type 0
        {  // band 0
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {  // band 1
            {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
            {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
            {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128},
        },
        {  // band 2
            {1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
            {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
            {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128},
        },
        {  // band 3
            {1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
            {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
            {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128},
        },
        {  // band 4
            {1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
            {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
            {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128},
        },
        {  // band 5
            {1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
            {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
            {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128},
        },
        {  // band 6
            {1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
            {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
            {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128},
        },
        {  // band 7
            {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
    {  // block type 1
        {  // band 0
            {198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
            {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
            {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128},
        },
        {  // band 1
            {1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
            {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
            {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128},
        },
        {  // band 2
            {1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
            {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
            {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128},
        },
        {  // band 3
            {1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
            {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
            {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128},
        },
        {  // band 4
            {1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
            {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
            {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128},
        },
        {  // band 5
            {1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
            {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
            {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128},
        },
        {  // band 6
            {1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
            {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
            {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128},
        },
        {  // band 7
            {1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
            {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128},
        },
    },
    {  // block type 2
        {  // band 0
            {253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
            {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
            {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128},
        },
        {  // band 1
            {1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
            {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
            {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128},
        },
        {  // band 2
            {1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
            {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
            {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128},
        },
        {  // band 3
            {1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
            {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
            {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128},
        },
        {  // band 4
            {1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
            {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {  // band 5
            {1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {  // band 6
            {1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
            {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
            {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {  // band 7
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
    {  // block type 3
        {  // band 0
            {202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
            {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
            {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128},
        },
        {  // band 1
            {1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
            {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
            {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128},
        },
        {  // band 2
            {1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
            {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
            {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128},
        },
        {  // band 3
            {1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
            {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
            {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128},
        },
        {  // band 4
            {1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
            {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
            {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128},
        },
        {  // band 5
            {1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
            {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
            {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128},
        },
        {  // band 6
            {1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
            {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
            {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128},
        },
        {  // band 7
            {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
};

// RFC 6386 section 13.4 coeff_update_probs
const uint8_t kCoeffUpdateProbs[4][8][3][11] = {
    {  // block type 0
        {  // band 0
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 1
            {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 2
            {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 3
            {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 4
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 5
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 6
            {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
            {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 7
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {  // block type 1
        {  // band 0
            {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
            {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255},
        },
        {  // band 1
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 2
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 3
            {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 4
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 5
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 6
            {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 7
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {  // block type 2
        {  // band 0
            {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
            {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255},
        },
        {  // band 1
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255},
        },
        {  // band 2
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 3
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 4
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 5
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 6
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 7
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {  // block type 3
        {  // band 0
            {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 1
            {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255},
        },
        {  // band 2
            {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 3
            {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 4
            {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 5
            {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 6
            {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {  // band 7
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
};

// RFC 6386 section 11.5 kf_bmode_probs [above mode][left mode], in the
// RFC's mode order (B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU)
const uint8_t kBModeProbs[10][10][9] = {
    {  // above 0
        {231, 120, 48, 89, 115, 113, 120, 152, 112},
        {152, 179, 64, 126, 170, 118, 46, 70, 95},
        {175, 69, 143, 80, 85, 82, 72, 155, 103},
        {56, 58, 10, 171, 218, 189, 17, 13, 152},
        {144, 71, 10, 38, 171, 213, 144, 34, 26},
        {114, 26, 17, 163, 44, 195, 21, 10, 173},
        {121, 24, 80, 195, 26, 62, 44, 64, 85},
        {170, 46, 55, 19, 136, 160, 33, 206, 71},
        {63, 20, 8, 114, 114, 208, 12, 9, 226},
        {81, 40, 11, 96, 182, 84, 29, 16, 36},
    },
    {  // above 1
        {134, 183, 89, 137, 98, 101, 106, 165, 148},
        {72, 187, 100, 130, 157, 111, 32, 75, 80},
        {66, 102, 167, 99, 74, 62, 40, 234, 128},
        {41, 53, 9, 178, 241, 141, 26, 8, 107},
        {104, 79, 12, 27, 217, 255, 87, 17, 7},
        {74, 43, 26, 146, 73, 166, 49, 23, 157},
        {65, 38, 105, 160, 51, 52, 31, 115, 128},
        {87, 68, 71, 44, 114, 51, 15, 186, 23},
        {47, 41, 14, 110, 182, 183, 21, 17, 194},
        {66, 45, 25, 102, 197, 189, 23, 18, 22},
    },
    {  // above 2
        {88, 88, 147, 150, 42, 46, 45, 196, 205},
        {43, 97, 183, 117, 85, 38, 35, 179, 61},
        {39, 53, 200, 87, 26, 21, 43, 232, 171},
        {56, 34, 51, 104, 114, 102, 29, 93, 77},
        {107, 54, 32, 26, 51, 1, 81, 43, 31},
        {39, 28, 85, 171, 58, 165, 90, 98, 64},
        {34, 22, 116, 206, 23, 34, 43, 166, 73},
        {68, 25, 106, 22, 64, 171, 36, 225, 114},
        {34, 19, 21, 102, 132, 188, 16, 76, 124},
        {62, 18, 78, 95, 85, 57, 50, 48, 51},
    },
    {  // above 3
        {193, 101, 35, 159, 215, 111, 89, 46, 111},
        {60, 148, 31, 172, 219, 228, 21, 18, 111},
        {112, 113, 77, 85, 179, 255, 38, 120, 114},
        {40, 42, 1, 196, 245, 209, 10, 25, 109},
        {100, 80, 8, 43, 154, 1, 51, 26, 71},
        {88, 43, 29, 140, 166, 213, 37, 43, 154},
        {61, 63, 30, 155, 67, 45, 68, 1, 209},
        {142, 78, 78, 16, 255, 128, 34, 197, 171},
        {41, 40, 5, 102, 211, 183, 4, 1, 221},
        {51, 50, 17, 168, 209, 192, 23, 25, 82},
    },
    {  // above 4
        {125, 98, 42, 88, 104, 85, 117, 175, 82},
        {95, 84, 53, 89, 128, 100, 113, 101, 45},
        {75, 79, 123, 47, 51, 128, 81, 171, 1},
        {57, 17, 5, 71, 102, 57, 53, 41, 49},
        {115, 21, 2, 10, 102, 255, 166, 23, 6},
        {38, 33, 13, 121, 57, 73, 26, 1, 85},
        {41, 10, 67, 138, 77, 110, 90, 47, 114},
        {101, 29, 16, 10, 85, 128, 101, 196, 26},
        {57, 18, 10, 102, 102, 213, 34, 20, 43},
        {117, 20, 15, 36, 163, 128, 68, 1, 26},
    },
    {  // above 5
        {138, 31, 36, 171, 27, 166, 38, 44, 229},
        {67, 87, 58, 169, 82, 115, 26, 59, 179},
        {63, 59, 90, 180, 59, 166, 93, 73, 154},
        {40, 40, 21, 116, 143, 209, 34, 39, 175},
        {57, 46, 22, 24, 128, 1, 54, 17, 37},
        {47, 15, 16, 183, 34, 223, 49, 45, 183},
        {46, 17, 33, 183, 6, 98, 15, 32, 183},
        {65, 32, 73, 115, 28, 128, 23, 128, 205},
        {40, 3, 9, 115, 51, 192, 18, 6, 223},
        {87, 37, 9, 115, 59, 77, 64, 21, 47},
    },
    {  // above 6
        {104, 55, 44, 218, 9, 54, 53, 130, 226},
        {64, 90, 70, 205, 40, 41, 23, 26, 57},
        {54, 57, 112, 184, 5, 41, 38, 166, 213},
        {30, 34, 26, 133, 152, 116, 10, 32, 134},
        {75, 32, 12, 51, 192, 255, 160, 43, 51},
        {39, 19, 53, 221, 26, 114, 32, 73, 255},
        {31, 9, 65, 234, 2, 15, 1, 118, 73},
        {88, 31, 35, 67, 102, 85, 55, 186, 85},
        {56, 21, 23, 111, 59, 205, 45, 37, 192},
        {55, 38, 70, 124, 73, 102, 1, 34, 98},
    },
    {  // above 7
        {102, 61, 71, 37, 34, 53, 31, 243, 192},
        {69, 60, 71, 38, 73, 119, 28, 222, 37},
        {68, 45, 128, 34, 1, 47, 11, 245, 171},
        {62, 17, 19, 70, 146, 85, 55, 62, 70},
        {75, 15, 9, 9, 64, 255, 184, 119, 16},
        {37, 43, 37, 154, 100, 163, 85, 160, 1},
        {63, 9, 92, 136, 28, 64, 32, 201, 85},
        {86, 6, 28, 5, 64, 255, 25, 248, 1},
        {56, 8, 17, 132, 137, 255, 55, 116, 128},
        {58, 15, 20, 82, 135, 57, 26, 121, 40},
    },
    {  // above 8
        {164, 50, 31, 137, 154, 133, 25, 35, 218},
        {51, 103, 44, 131, 131, 123, 31, 6, 158},
        {86, 40, 64, 135, 148, 224, 45, 183, 128},
        {22, 26, 17, 131, 240, 154, 14, 1, 209},
        {83, 12, 13, 54, 192, 255, 68, 47, 28},
        {45, 16, 21, 91, 64, 222, 7, 1, 197},
        {56, 21, 39, 155, 60, 138, 23, 102, 213},
        {85, 26, 85, 85, 128, 128, 32, 146, 171},
        {18, 11, 7, 63, 144, 171, 4, 4, 246},
        {35, 27, 10, 146, 174, 171, 12, 26, 128},
    },
    {  // above 9
        {190, 80, 35, 99, 180, 80, 126, 54, 45},
        {85, 126, 47, 87, 176, 51, 41, 20, 32},
        {101, 75, 128, 139, 118, 146, 116, 128, 85},
        {56, 41, 15, 176, 236, 85, 37, 9, 62},
        {146, 36, 19, 30, 171, 255, 97, 27, 20},
        {71, 30, 17, 119, 118, 255, 17, 18, 138},
        {101, 38, 60, 138, 55, 70, 43, 26, 142},
        {138, 45, 61, 62, 219, 1, 81, 188, 64},
        {32, 41, 20, 117, 151, 142, 20, 21, 163},
        {112, 19, 12, 61, 195, 128, 48, 4, 24},
    },
};

// ---------------------------------------------------------------- VP8

struct Quant {
  int y1[2], y2[2], uv[2];  // DC and AC factors
};

struct FilterInfo {
  int limit = 0;   // 0: no filtering
  int ilevel = 0;  // interior limit
  int hev_thresh = 0;
  bool inner = false;
};

struct MacroBlock {
  int segment = 0;
  bool skip = false;
  bool is_i4x4 = false;
  uint8_t modes[16];  // the 16 4x4 modes, or modes[0] for 16x16
  uint8_t uv_mode = B_DC;
  int16_t coeffs[384];  // 16 Y blocks, 4 U, 4 V
  uint8_t kind[24];     // each block's: 0 zero, 1 DC only, 2 three coefficients, 3 more
};

inline int clip_index(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

constexpr int kStride = 32;  // the work buffers' row stride

// The RFC's 4x4 inverse DCT, added to the 4x4 prediction at dst. With
// `lanes16` the sums wrap to 16 bits after each pass, as libwebp's SSE2
// transform computes them on x86 hosts (the one Pillow runs there) for a
// block of more than three coefficients: the same result for any stream
// an encoder writes, and the same garbage for a corrupt one whose
// coefficients overflow 16 bits.
void inverse_dct_add(const int16_t* in, uint8_t* dst, bool lanes16) {
  constexpr int kC1 = 20091, kC2 = 35468;  // cos(pi/8) * sqrt(2) - 1, sin(pi/8) * sqrt(2)
  auto mul1 = [](int a) { return ((a * kC1) >> 16) + a; };
  auto mul2 = [](int a) { return (a * kC2) >> 16; };
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // columns
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  auto lane = [lanes16](int v) { return lanes16 ? int(int16_t(v)) : v; };
  if (lanes16)
    for (int& t : tmp) t = lane(t);
  for (int i = 0; i < 4; ++i, dst += kStride) {  // rows
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    dst[0] = static_cast<uint8_t>(clip255(dst[0] + (lane(a + d) >> 3)));
    dst[1] = static_cast<uint8_t>(clip255(dst[1] + (lane(b + c) >> 3)));
    dst[2] = static_cast<uint8_t>(clip255(dst[2] + (lane(b - c) >> 3)));
    dst[3] = static_cast<uint8_t>(clip255(dst[3] + (lane(a - d) >> 3)));
  }
}

// the inverse Walsh-Hadamard transform of the Y2 block into the DC of each
// of the 16 Y blocks
void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3];
    const int a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2];
    const int a3 = dc - tmp[4 * i + 3];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

// dst[x + y * kStride] = top[x] + left[y] - top_left, clipped
void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kStride;
  for (int y = 0; y < size; ++y, dst += kStride)
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip255(top[x] + dst[-1] - top[-1]));
}

void fill(uint8_t* dst, int size, int value) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * kStride, value, size);
}

// 16x16 luma or 8x8 chroma prediction; has_top/has_left only matter to DC
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_VE:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * kStride, dst - kStride, size);
      break;
    case B_HE:
      for (int y = 0; y < size; ++y) std::memset(dst + y * kStride, dst[y * kStride - 1], size);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    default: {  // DC, from the edges the frame has
      int sum = 0;
      if (has_top)
        for (int i = 0; i < size; ++i) sum += dst[i - kStride];
      if (has_left)
        for (int i = 0; i < size; ++i) sum += dst[i * kStride - 1];
      int dc;
      if (has_top && has_left) {
        dc = (sum + size) >> (shift + 1);
      } else if (has_top || has_left) {
        dc = (sum + size / 2) >> shift;
      } else {
        dc = 0x80;
      }
      fill(dst, size, dc);
    }
  }
}

#define DST(x, y) dst[(x) + (y) * kStride]

void predict_4x4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kStride;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + kStride], K = dst[-1 + 2 * kStride],
            L = dst[-1 + 3 * kStride];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * kStride];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * kStride, v, 4);
      break;
    }
    case B_HE: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * kStride, v[y], 4);
      break;
    }
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

#undef DST

// ------------------------------------------------------------ loop filter

inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }
inline uint8_t clip1(int v) { return static_cast<uint8_t>(clip255(v)); }

// the common adjustment with the outer taps: p0 and q0 change
inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
}

// the subblock filter without high edge variance: p1..q1 change
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip1(p1 + a3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a3);
}

// the macroblock-edge filter without high edge variance: p2..q2 change
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip1(p2 + a3);
  p[-2 * step] = clip1(p1 + a2);
  p[-step] = clip1(p0 + a1);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a2);
  p[2 * step] = clip1(q2 - a3);
}

inline bool high_edge_variance(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}

// the RFC's 2 * |p0 - q0| + |p1 - q1| / 2 <= limit, doubled
inline bool simple_needs_filter(const uint8_t* p, int step, int limit2) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= limit2;
}

inline bool normal_needs_filter(const uint8_t* p, int step, int limit2, int ilevel) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > limit2) return false;
  return std::abs(p3 - p2) <= ilevel && std::abs(p2 - p1) <= ilevel &&
         std::abs(p1 - p0) <= ilevel && std::abs(q3 - q2) <= ilevel &&
         std::abs(q2 - q1) <= ilevel && std::abs(q1 - q0) <= ilevel;
}

// one edge of `size` pixels: `step` crosses it, `along` follows it
void simple_edge(uint8_t* p, int step, int along, int size, int limit) {
  for (int i = 0; i < size; ++i, p += along)
    if (simple_needs_filter(p, step, 2 * limit + 1)) filter2(p, step);
}

void normal_edge(uint8_t* p, int step, int along, int size, int limit, int ilevel, int hev,
                 bool mb_edge) {
  for (int i = 0; i < size; ++i, p += along) {
    if (!normal_needs_filter(p, step, 2 * limit + 1, ilevel)) continue;
    if (high_edge_variance(p, step, hev)) {
      filter2(p, step);
    } else if (mb_edge) {
      filter6(p, step);
    } else {
      filter4(p, step);
    }
  }
}

// ------------------------------------------------------------ the frame

class Lossy {
 public:
  // n bytes of data, of which the chunk's own payload is the first
  // chunk_size (its padding byte, when there is one, follows)
  Lossy(const uint8_t* data, size_t n, size_t chunk_size)
      : data_(data), n_(n), chunk_size_(chunk_size) {}

  // the frame tag and key frame header: fills width and height
  void parse_size() {
    if (n_ < 10) fail(kLossyHeader);
    const uint32_t tag = le24(data_);
    if (tag & 1) fail(kNotKeyFrame);
    if (((tag >> 1) & 7) > 3) fail(kLossyHeader);  // profile
    if (!((tag >> 4) & 1)) fail(kNotKeyFrame);     // not shown
    first_part_ = tag >> 5;
    if (data_[3] != 0x9d || data_[4] != 0x01 || data_[5] != 0x2a) fail(kLossyHeader);
    width = le16(data_ + 6) & 0x3fff;
    height = le16(data_ + 8) & 0x3fff;
    if (!width || !height || first_part_ >= chunk_size_) fail(kLossyHeader);
  }

  // decode the frame into Y, U, V planes of whole macroblocks
  void decode(Features* seen) {
    parse_size();
    mb_w_ = (width + 15) >> 4;
    mb_h_ = (height + 15) >> 4;
    if (first_part_ > n_ - 10) fail(kLossyHeader);
    br_ = BoolDecoder(data_ + 10, first_part_);
    parse_header(data_ + 10 + first_part_, n_ - 10 - first_part_);
    y_stride = mb_w_ * 16;
    uv_stride = mb_w_ * 8;
    Y.assign(size_t(y_stride) * mb_h_ * 16, 0);
    U.assign(size_t(uv_stride) * mb_h_ * 8, 0);
    V.assign(size_t(uv_stride) * mb_h_ * 8, 0);
    std::vector<uint8_t> intra_top(4 * mb_w_, B_DC);
    std::vector<uint8_t> nz_top(mb_w_), nz_dc_top(mb_w_);
    filters_.assign(size_t(mb_w_) * mb_h_, FilterInfo());
    MacroBlock mb;
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
      uint8_t intra_left[4] = {B_DC, B_DC, B_DC, B_DC};
      uint8_t nz_left = 0, nz_dc_left = 0;
      std::vector<MacroBlock> row(mb_w_);
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x)
        parse_modes(&row[mb_x], intra_top.data() + 4 * mb_x, intra_left);
      if (br_.at_end()) fail(kLossyData);
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MacroBlock& m = row[mb_x];
        bool all_zero;
        if (!m.skip) {
          all_zero = parse_residuals(&m, tokens, &nz_top[mb_x], &nz_dc_top[mb_x], &nz_left,
                                     &nz_dc_left);
        } else {
          std::memset(m.coeffs, 0, sizeof(m.coeffs));
          std::memset(m.kind, 0, sizeof(m.kind));
          nz_top[mb_x] = nz_left = 0;
          if (!m.is_i4x4) nz_dc_top[mb_x] = nz_dc_left = 0;
          all_zero = true;
        }
        if (tokens.at_end()) fail(kLossyData);
        if (filter_type_) {
          FilterInfo& f = filters_[size_t(mb_y) * mb_w_ + mb_x];
          f = strengths_[m.segment][m.is_i4x4];
          f.inner = m.is_i4x4 || !all_zero;
        }
        seen->flags |= (m.is_i4x4 ? 4 : 8) | (m.skip ? 16 : 0);
        reconstruct(m, mb_x, mb_y);
      }
    }
    seen->filter = filter_type_;
    seen->partitions = num_parts_;
    seen->segments = update_map_;
    seen->sharpness = sharpness_;
    if (filter_type_) loop_filter();
  }

  int width = 0, height = 0;
  int y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> Y, U, V;

 private:
  void parse_header(const uint8_t* rest, size_t rest_n) {
    br_.bit(0x80);  // color space: 0 (YUV) is the only one
    br_.bit(0x80);  // clamping type: the decoder always clamps
    // segments
    use_segment_ = br_.bit(0x80);
    bool absolute = true;  // segment values without an update: absolute zeros
    int seg_quant[4] = {0}, seg_filter[4] = {0};
    if (use_segment_) {
      update_map_ = br_.bit(0x80);
      if (br_.bit(0x80)) {  // update the segment data
        absolute = br_.bit(0x80);
        for (int& q : seg_quant) q = br_.bit(0x80) ? br_.signed_value(7) : 0;
        for (int& f : seg_filter) f = br_.bit(0x80) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int& p : segment_probs_) p = br_.bit(0x80) ? br_.value(8) : 255;
    }
    // loop filter
    const bool simple = br_.bit(0x80);
    const int level = br_.value(6);
    const int sharpness = sharpness_ = br_.value(3);
    int ref_delta0 = 0, mode_delta0 = 0;
    const bool use_deltas = br_.bit(0x80);
    if (use_deltas && br_.bit(0x80)) {  // update the deltas
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) {
          const int d = br_.signed_value(6);
          if (i == 0) ref_delta0 = d;  // intra frame: the first reference delta
        }
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) {
          const int d = br_.signed_value(6);
          if (i == 0) mode_delta0 = d;  // B_PRED: the first mode delta
        }
    }
    filter_type_ = level == 0 ? 0 : simple ? 1 : 2;
    // token partitions
    num_parts_ = 1 << br_.value(2);
    const size_t sizes_n = 3 * size_t(num_parts_ - 1);
    if (rest_n < sizes_n) fail(kLossyData);
    const uint8_t* part = rest + sizes_n;
    size_t left = rest_n - sizes_n;
    for (int p = 0; p < num_parts_ - 1; ++p) {
      size_t size = le24(rest + 3 * p);
      if (size > left) size = left;
      parts_[p] = BoolDecoder(part, size);
      part += size;
      left -= size;
    }
    if (left == 0) fail(kLossyData);  // the last partition holds no data
    parts_[num_parts_ - 1] = BoolDecoder(part, left);
    // quantizers
    const int base_q = br_.value(7);
    const int dy1_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dy2_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dy2_ac = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int duv_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int duv_ac = br_.bit(0x80) ? br_.signed_value(4) : 0;
    for (int s = 0; s < 4; ++s) {
      int q = base_q;
      if (use_segment_) q = seg_quant[s] + (absolute ? 0 : base_q);
      Quant& m = quant_[s];
      m.y1[0] = kDcTable[clip_index(q + dy1_dc, 127)];
      m.y1[1] = kAcTable[clip_index(q, 127)];
      m.y2[0] = kDcTable[clip_index(q + dy2_dc, 127)] * 2;
      m.y2[1] = std::max(kAcTable[clip_index(q + dy2_ac, 127)] * 155 / 100, 8);
      m.uv[0] = kDcTable[clip_index(q + duv_dc, 117)];
      m.uv[1] = kAcTable[clip_index(q + duv_ac, 127)];
    }
    br_.bit(0x80);  // refresh_entropy_probs: meaningless in a lone key frame
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            probs_[t][b][c][p] = static_cast<uint8_t>(
                br_.bit(kCoeffUpdateProbs[t][b][c][p]) ? br_.value(8) : kCoeffProbs0[t][b][c][p]);
    use_skip_ = br_.bit(0x80);
    if (use_skip_) skip_prob_ = br_.value(8);
    // filter strengths per segment and 16x16 / 4x4 prediction
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment_) base = seg_filter[s] + (absolute ? 0 : level);
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& f = strengths_[s][i4x4];
        int lvl = base;
        if (use_deltas) lvl += ref_delta0 + (i4x4 ? mode_delta0 : 0);
        lvl = clip_index(lvl, 63);
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          f.ilevel = ilevel;
          f.limit = 2 * lvl + ilevel;
          f.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
      }
    }
  }

  void parse_modes(MacroBlock* m, uint8_t* top, uint8_t* left) {
    m->segment = update_map_ ? (!br_.bit(segment_probs_[0]) ? br_.bit(segment_probs_[1])
                                                             : br_.bit(segment_probs_[2]) + 2)
                             : 0;
    m->skip = use_skip_ ? br_.bit(skip_prob_) : false;
    m->is_i4x4 = !br_.bit(145);
    if (!m->is_i4x4) {
      const int mode = br_.bit(156) ? (br_.bit(128) ? B_TM : B_HE) : (br_.bit(163) ? B_VE : B_DC);
      m->modes[0] = static_cast<uint8_t>(mode);
      std::memset(top, mode, 4);
      std::memset(left, mode, 4);
    } else {
      for (int y = 0; y < 4; ++y) {
        int mode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModeProbs[top[x]][mode];
          int i = 0;
          do {
            i = kBModeTree[i + br_.bit(prob[i >> 1])];
          } while (i > 0);
          mode = -i;
          top[x] = static_cast<uint8_t>(mode);
          m->modes[4 * y + x] = static_cast<uint8_t>(mode);
        }
        left[y] = static_cast<uint8_t>(mode);
      }
    }
    m->uv_mode = !br_.bit(142) ? B_DC : !br_.bit(114) ? B_VE : br_.bit(183) ? B_TM : B_HE;
  }

  int large_value(BoolDecoder& br, const uint8_t* p) {
    if (!br.bit(p[3])) {
      if (!br.bit(p[4])) return 2;
      return 3 + br.bit(p[5]);
    }
    if (!br.bit(p[6])) {
      if (!br.bit(p[7])) return 5 + br.bit(159);  // DCT_CAT1
      const int v = 7 + 2 * br.bit(165);          // DCT_CAT2
      return v + br.bit(145);
    }
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    int v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    return v + 3 + (8 << cat);
  }

  // the tokens of one 4x4 block from position n: returns the position
  // after its last non-zero coefficient (n if none)
  int coefficients(BoolDecoder& br, int type, int ctx, const int dq[2], int n, int16_t* out) {
    const uint8_t* p = probs_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;  // end of block
      while (!br.bit(p[1])) {       // a zero
        p = probs_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = probs_[type][kBands[n + 1]][1];
      } else {
        v = large_value(br, p);
        p = probs_[type][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(br.sign(v) * dq[n > 0]);
    }
    return 16;
  }

  // the macroblock's coefficients, dequantized, with the Y2 block already
  // turned into the Y DCs, and the kind of each block (by the position
  // after its last token and its DC). Returns true if every block is of
  // kind 0: the loop filter then skips the inner edges of a
  // 16x16-predicted macroblock. The non-zero contexts are one bit per 4x4
  // block: 4 Y, 2 U and 2 V columns (top) or rows (left).
  bool parse_residuals(MacroBlock* m, BoolDecoder& br, uint8_t* nz_top, uint8_t* nz_dc_top,
                       uint8_t* nz_left, uint8_t* nz_dc_left) {
    int16_t* dst = m->coeffs;
    std::memset(dst, 0, sizeof(m->coeffs));
    const Quant& q = quant_[m->segment];
    auto kind = [](int nz, int dc) { return nz > 3 ? 3 : nz > 1 ? 2 : dc != 0; };
    bool any = false;
    int first, ac_type;
    if (!m->is_i4x4) {
      int16_t dc[16] = {0};
      const int nz = coefficients(br, 1, *nz_dc_top + *nz_dc_left, q.y2, 0, dc);
      *nz_dc_top = *nz_dc_left = nz > 0;
      inverse_wht(dc, dst);
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    int tnz = *nz_top & 0x0f, lnz = *nz_left & 0x0f;
    int out_top = 0, out_left = 0;
    for (int y = 0; y < 4; ++y) {
      int l = (lnz >> y) & 1;
      for (int x = 0; x < 4; ++x) {
        const int t = (tnz >> x) & 1;
        int16_t* block = dst + 16 * (4 * y + x);
        const int nz = coefficients(br, ac_type, l + t, q.y1, first, block);
        l = nz > first;
        tnz = (tnz & ~(1 << x)) | (l << x);
        m->kind[4 * y + x] = static_cast<uint8_t>(kind(nz, block[0]));  // DC from Y2 under 16x16
        any |= m->kind[4 * y + x] != 0;
      }
      out_left |= l << y;
    }
    out_top = tnz;
    for (int ch = 0; ch < 2; ++ch) {  // U, then V
      int ctnz = (*nz_top >> (4 + 2 * ch)) & 3, clnz = (*nz_left >> (4 + 2 * ch)) & 3;
      for (int y = 0; y < 2; ++y) {
        int l = (clnz >> y) & 1;
        for (int x = 0; x < 2; ++x) {
          const int t = (ctnz >> x) & 1;
          int16_t* block = dst + 256 + 64 * ch + 16 * (2 * y + x);
          const int nz = coefficients(br, 2, l + t, q.uv, 0, block);
          l = nz > 0;
          ctnz = (ctnz & ~(1 << x)) | (l << x);
          const int b = 16 + 4 * ch + 2 * y + x;
          m->kind[b] = static_cast<uint8_t>(kind(nz, block[0]));
          any |= m->kind[b] != 0;
        }
        clnz = (clnz & ~(1 << y)) | (l << y);
      }
      out_top |= ctnz << (4 + 2 * ch);
      out_left |= clnz << (4 + 2 * ch);
    }
    *nz_top = static_cast<uint8_t>(out_top);
    *nz_left = static_cast<uint8_t>(out_left);
    return !any;
  }

  // predict and add the residuals of one macroblock, from the unfiltered
  // pixels around it (127 above the frame, 129 left of it)
  void reconstruct(const MacroBlock& m, int mb_x, int mb_y) {
    uint8_t ybuf[kStride * 17], ubuf[kStride * 9], vbuf[kStride * 9];
    uint8_t* y = ybuf + kStride + 1;  // (0, 0) of the macroblock
    uint8_t* u = ubuf + kStride + 1;
    uint8_t* v = vbuf + kStride + 1;
    const int x0 = mb_x * 16, y0 = mb_y * 16;
    // the row above, with the top-left corner and (luma) four to the right
    if (mb_y == 0) {
      std::memset(y - kStride - 1, 127, 21);
      std::memset(u - kStride - 1, 127, 9);
      std::memset(v - kStride - 1, 127, 9);
    } else {
      const uint8_t* ay = &Y[size_t(y0 - 1) * y_stride + x0];
      const uint8_t* au = &U[size_t(mb_y * 8 - 1) * uv_stride + mb_x * 8];
      const uint8_t* av = &V[size_t(mb_y * 8 - 1) * uv_stride + mb_x * 8];
      std::memcpy(y - kStride, ay, 16);
      std::memcpy(u - kStride, au, 8);
      std::memcpy(v - kStride, av, 8);
      if (mb_x < mb_w_ - 1) {
        std::memcpy(y - kStride + 16, ay + 16, 4);
      } else {
        std::memset(y - kStride + 16, ay[15], 4);
      }
      y[-kStride - 1] = mb_x ? ay[-1] : 129;
      u[-kStride - 1] = mb_x ? au[-1] : 129;
      v[-kStride - 1] = mb_x ? av[-1] : 129;
    }
    for (int r = 0; r < 16; ++r) y[r * kStride - 1] = mb_x ? Y[size_t(y0 + r) * y_stride + x0 - 1] : 129;
    for (int r = 0; r < 8; ++r) {
      const size_t at = size_t(mb_y * 8 + r) * uv_stride + mb_x * 8 - 1;
      u[r * kStride - 1] = mb_x ? U[at] : 129;
      v[r * kStride - 1] = mb_x ? V[at] : 129;
    }
    if (m.is_i4x4) {
      // the blocks of the right column take the pixels above and to the
      // right of the macroblock as their top-right
      for (int r = 3; r < 15; r += 4) std::memcpy(y + r * kStride + 16, y - kStride + 16, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = y + (n >> 2) * 4 * kStride + (n & 3) * 4;
        predict_4x4(dst, m.modes[n]);
        if (m.kind[n]) inverse_dct_add(m.coeffs + 16 * n, dst, m.kind[n] == 3);
      }
    } else {
      predict_block(y, 16, m.modes[0], mb_y > 0, mb_x > 0);
      for (int n = 0; n < 16; ++n)
        if (m.kind[n])
          inverse_dct_add(m.coeffs + 16 * n, y + (n >> 2) * 4 * kStride + (n & 3) * 4,
                          m.kind[n] == 3);
    }
    predict_block(u, 8, m.uv_mode, mb_y > 0, mb_x > 0);
    predict_block(v, 8, m.uv_mode, mb_y > 0, mb_x > 0);
    for (int ch = 0; ch < 2; ++ch) {  // a chroma plane's four blocks go together
      const uint8_t* kinds = m.kind + 16 + 4 * ch;
      const bool ac = std::max({kinds[0], kinds[1], kinds[2], kinds[3]}) >= 2;
      for (int n = 0; n < 4; ++n) {
        const int16_t* in = m.coeffs + 256 + 64 * ch + 16 * n;
        uint8_t* dst = (ch ? v : u) + (n >> 1) * 4 * kStride + (n & 1) * 4;
        if (ac || in[0]) inverse_dct_add(in, dst, ac);
      }
    }
    for (int r = 0; r < 16; ++r) std::memcpy(&Y[size_t(y0 + r) * y_stride + x0], y + r * kStride, 16);
    for (int r = 0; r < 8; ++r) {
      std::memcpy(&U[size_t(mb_y * 8 + r) * uv_stride + mb_x * 8], u + r * kStride, 8);
      std::memcpy(&V[size_t(mb_y * 8 + r) * uv_stride + mb_x * 8], v + r * kStride, 8);
    }
  }

  // every macroblock in raster order: its left edge, inner vertical edges,
  // top edge, inner horizontal edges (chroma too under the normal filter)
  void loop_filter() {
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = filters_[size_t(mb_y) * mb_w_ + mb_x];
        if (f.limit == 0) continue;
        uint8_t* y = &Y[size_t(mb_y) * 16 * y_stride + mb_x * 16];
        const int ys = y_stride;
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_edge(y, 1, ys, 16, f.limit + 4);
          if (f.inner)
            for (int i = 4; i < 16; i += 4) simple_edge(y + i, 1, ys, 16, f.limit);
          if (mb_y > 0) simple_edge(y, ys, 1, 16, f.limit + 4);
          if (f.inner)
            for (int i = 4; i < 16; i += 4) simple_edge(y + i * ys, ys, 1, 16, f.limit);
          continue;
        }
        const int uvs = uv_stride;
        uint8_t* u = &U[size_t(mb_y) * 8 * uvs + mb_x * 8];
        uint8_t* v = &V[size_t(mb_y) * 8 * uvs + mb_x * 8];
        const int lim = f.limit, il = f.ilevel, hev = f.hev_thresh;
        if (mb_x > 0) {
          normal_edge(y, 1, ys, 16, lim + 4, il, hev, true);
          normal_edge(u, 1, uvs, 8, lim + 4, il, hev, true);
          normal_edge(v, 1, uvs, 8, lim + 4, il, hev, true);
        }
        if (f.inner) {
          for (int i = 4; i < 16; i += 4) normal_edge(y + i, 1, ys, 16, lim, il, hev, false);
          normal_edge(u + 4, 1, uvs, 8, lim, il, hev, false);
          normal_edge(v + 4, 1, uvs, 8, lim, il, hev, false);
        }
        if (mb_y > 0) {
          normal_edge(y, ys, 1, 16, lim + 4, il, hev, true);
          normal_edge(u, uvs, 1, 8, lim + 4, il, hev, true);
          normal_edge(v, uvs, 1, 8, lim + 4, il, hev, true);
        }
        if (f.inner) {
          for (int i = 4; i < 16; i += 4) normal_edge(y + i * ys, ys, 1, 16, lim, il, hev, false);
          normal_edge(u + 4 * uvs, uvs, 1, 8, lim, il, hev, false);
          normal_edge(v + 4 * uvs, uvs, 1, 8, lim, il, hev, false);
        }
      }
    }
  }

  const uint8_t* data_;
  size_t n_, chunk_size_;
  uint32_t first_part_ = 0;
  int mb_w_ = 0, mb_h_ = 0;
  BoolDecoder br_;
  BoolDecoder parts_[8];
  int num_parts_ = 1;
  bool use_segment_ = false, update_map_ = false, use_skip_ = false;
  int segment_probs_[3] = {255, 255, 255};
  int skip_prob_ = 0;
  int filter_type_ = 0;  // 0 none, 1 simple, 2 normal
  int sharpness_ = 0;
  Quant quant_[4];
  FilterInfo strengths_[4][2];
  std::vector<FilterInfo> filters_;
  uint8_t probs_[4][8][3][11];
};

// ------------------------------------------------------------ YUV -> RGB

// BT.601 in 14-bit fixed point, as libwebp's VP8YUVToR/G/B compute it
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t clip8(int v) {
  constexpr int kMask = (256 << 6) - 1;
  return static_cast<uint8_t>((v & ~kMask) == 0 ? (v >> 6) : (v < 0 ? 0 : 255));
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One pair of output rows of the "fancy" upsampler: the chroma of each
// pixel is 9/16 of its nearest sample, 3/16 of each of the two next
// nearest and 1/16 of the farthest, computed through the two diagonals.
// (tu, tv) is the chroma row nearer to the top row, (cu, cv) the one
// nearer to the bottom row; bottom_y may be null.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* tu,
                   const uint8_t* tv, const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst,
                   uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = tu[x], t_v = tv[x], c_u = cu[x], c_v = cv[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + 4 * (2 * x - 1));
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 4 * (2 * x));
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + 4 * (2 * x - 1));
      yuv_to_rgb(bottom_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1,
                 bottom_dst + 4 * (2 * x));
    }
    tl_u = t_u, tl_v = t_v, l_u = c_u, l_v = c_v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + 4 * (len - 1));
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + 4 * (len - 1));
  }
}

// The decoded planes -> RGB of the RGBA rows at out (stride in bytes):
// output row 0 takes chroma row 0 alone; rows 2k-1 and 2k take chroma rows
// k-1 and k; the last row of an even height takes the last chroma row
// alone.
void yuv_to_rgba(const Lossy& f, uint8_t* out, size_t stride) {
  const int w = f.width, h = f.height;
  const uint8_t* y = f.Y.data();
  const uint8_t* u = f.U.data();
  const uint8_t* v = f.V.data();
  upsample_pair(y, nullptr, u, v, u, v, out, nullptr, w);
  int row = 0;
  for (; row + 2 < h; row += 2) {
    const uint8_t* tu = u;
    const uint8_t* tv = v;
    u += f.uv_stride;
    v += f.uv_stride;
    y += 2 * f.y_stride;
    out += 2 * stride;
    upsample_pair(y - f.y_stride, y, tu, tv, u, v, out - stride, out, w);
  }
  if (!(h & 1)) upsample_pair(y + f.y_stride, nullptr, u, v, u, v, out + stride, nullptr, w);
}

// ------------------------------------------------------------ alpha

// An ALPH chunk (RFC 9649 section 2.7.1.2) -> the frame's alpha plane.
std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t n, int width, int height,
                                  Features* seen) {
  if (n < 1) fail(kAlpha);
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int preprocessing = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || preprocessing > 1 || reserved) fail(kAlpha);
  seen->alpha = (1 + method) | (filter << 4);
  const size_t count = size_t(width) * height;
  std::vector<uint8_t> alpha(count);
  if (method == 0) {
    if (n - 1 < count) fail(kAlpha);
    std::memcpy(alpha.data(), data + 1, count);
  } else {  // a VP8L image stream without its header: alpha is its green
    LosslessBits br(data + 1, n - 1);
    Lossless dec(br, seen);
    std::vector<uint32_t> argb;
    try {
      argb = dec.image_stream(width, height, true);
    } catch (const Fail&) {
      fail(kAlpha);
    }
    for (size_t i = 0; i < count; ++i) alpha[i] = (argb[i] >> 8) & 0xff;
  }
  // unfilter: each row predicted from the left, above or both; the first
  // row always from the left, and the first pixel of a row from above
  for (int y = 0; y < height && filter; ++y) {
    uint8_t* row = alpha.data() + size_t(y) * width;
    const uint8_t* prev = y ? row - width : nullptr;
    if (!prev || filter == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = static_cast<uint8_t>(row[x] + pred);
    } else if (filter == 2) {
      for (int x = 0; x < width; ++x) row[x] = static_cast<uint8_t>(row[x] + prev[x]);
    } else {
      int left = prev[0], top_left = prev[0];
      for (int x = 0; x < width; ++x) {
        const int top = prev[x];
        left = static_cast<uint8_t>(row[x] + clip255(left + top - top_left));
        top_left = top;
        row[x] = static_cast<uint8_t>(left);
      }
    }
  }
  return alpha;
}

// ------------------------------------------------------------ container

struct Chunk {
  uint32_t tag = 0;
  const uint8_t* data = nullptr;
  size_t size = 0;    // the payload's
  size_t padded = 0;  // with its padding byte
};

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | (uint32_t(uint8_t(s[1])) << 8) |
         (uint32_t(uint8_t(s[2])) << 16) | (uint32_t(uint8_t(s[3])) << 24);
}

// one frame: an optional ALPH and its VP8, or a VP8L
struct Frame {
  int x = 0, y = 0, width = 0, height = 0;
  Chunk alpha, image;          // tag 0 where absent
  bool alpha_after_image = false;
  bool lossless_alpha = false;  // a VP8L image's alpha hint
};

// The chunks of a file as libwebp's demuxer reads them (Pillow opens
// every WebP through it): one flat run of chunks up to the RIFF end, an
// ANMF contributing its 16-byte frame header and the chunks after it.
class Reader {
 public:
  Reader(const uint8_t* data, size_t end) : data_(data), end_(end) {}

  bool at_end() const { return pos_ == end_; }
  // the next chunk's header, not consumed
  Chunk peek() const {
    if (end_ - pos_ < 8) fail(kTruncated);
    Chunk c;
    c.tag = le32(data_ + pos_);
    c.size = le32(data_ + pos_ + 4);
    c.padded = c.size + (c.size & 1);
    c.data = data_ + pos_ + 8;
    if (c.padded > end_ - pos_ - 8) fail(c.size > end_ ? kContainer : kTruncated);
    return c;
  }
  void skip(const Chunk& c) { pos_ += 8 + c.padded; }
  void skip_bytes(size_t n) { pos_ += n; }
  size_t pos() const { return pos_; }

 private:
  const uint8_t* data_;
  size_t end_;
  size_t pos_ = 12;
};

// the image's size from its header, which must be valid (WebPGetFeatures):
// a VP8 key frame that is shown, or a VP8L stream of version 0
void frame_size(Frame* f) {
  const Chunk& image = f->image;
  if (image.tag == fourcc("VP8L")) {
    lossless_size(image.data, image.size, &f->width, &f->height);
    f->lossless_alpha = (le32(image.data + 1) >> 28) & 1;
  } else {
    Lossy lossy(image.data, image.padded, image.size);
    lossy.parse_size();
    f->width = lossy.width;
    f->height = lossy.height;
  }
}

bool is_image(uint32_t tag) { return tag == fourcc("VP8 ") || tag == fourcc("VP8L"); }

// A frame's chunks, as the demuxer stores them: an ALPH and an image in
// either order (a VP8L after an ALPH is an error); a second ALPH or image,
// or any other chunk, ends the frame and is left unread.
void store_frame(Reader& r, Frame* f) {
  while (!r.at_end()) {
    const Chunk c = r.peek();
    if (c.tag == fourcc("ALPH") && !f->alpha.tag) {
      f->alpha = c;
      f->alpha_after_image = f->image.tag != 0;
    } else if (is_image(c.tag) && !f->image.tag) {
      if (c.tag == fourcc("VP8L") && f->alpha.tag) fail(kContainer);  // VP8L has its own alpha
      f->image = c;
      frame_size(f);
    } else {
      return;
    }
    r.skip(c);
  }
}

struct Parsed {
  int canvas_w = 0, canvas_h = 0;
  bool animation = false, extended = false;
  bool has_alpha = false;  // as WebPGetFeatures reports it: Pillow's RGBA, else RGB
  Frame frame;             // the first frame, the one decoded
};

// WebPGetFeatures' alpha of a still image in the extended format: the
// VP8L hint for a lossless image, else the flag or an ALPH chunk among
// those before the image
bool still_has_alpha(const uint8_t* data, size_t end, bool flag) {
  Reader r(data, end);
  r.skip(r.peek());  // VP8X
  bool alph = false;
  while (!r.at_end()) {
    const Chunk c = r.peek();
    if (is_image(c.tag)) {
      if (c.tag != fourcc("VP8L")) return flag || alph;
      Frame f;
      f.image = c;
      frame_size(&f);
      return f.lossless_alpha || alph;
    }
    alph |= c.tag == fourcc("ALPH");
    r.skip(c);
  }
  return flag || alph;
}

// The file's frames, checked as the demuxer checks a complete file.
Parsed parse(const uint8_t* data, size_t n) {
  if (n < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4)) fail(kNotWebp);
  const uint32_t riff = le32(data + 4);
  if (riff < 8) fail(kContainer);
  if (size_t(riff) + 8 > n) fail(kTruncated);
  const size_t end = size_t(riff) + 8;
  Reader r(data, end);
  Parsed p;
  const Chunk first = r.peek();
  if (is_image(first.tag)) {  // a simple file: one image, no alpha chunk
    store_frame(r, &p.frame);
    p.frame.alpha = Chunk();
    p.canvas_w = p.frame.width;
    p.canvas_h = p.frame.height;
    p.has_alpha = p.frame.lossless_alpha;
    return p;
  }
  if (first.tag != fourcc("VP8X") || first.size < 10) fail(kContainer);
  p.extended = true;
  const int flags = first.data[0];
  if (flags & ~0x3e) fail(kContainer);  // reserved bits
  p.animation = flags & 0x02;
  const bool alpha_flag = flags & 0x10;
  p.canvas_w = int(le24(first.data + 4)) + 1;
  p.canvas_h = int(le24(first.data + 7)) + 1;
  if (uint64_t(p.canvas_w) * uint64_t(p.canvas_h) >= (uint64_t(1) << 32)) fail(kContainer);
  r.skip(first);
  if (r.at_end()) fail(kTruncated);
  bool anim = false, have_frame = false;
  while (!r.at_end()) {
    const Chunk c = r.peek();
    if (c.tag == fourcc("VP8X")) fail(kContainer);
    if (c.tag == fourcc("ALPH") || is_image(c.tag)) {  // the still image
      if (anim || p.animation || have_frame) fail(kContainer);
      store_frame(r, &p.frame);
      if (!alpha_flag) p.frame.alpha = Chunk();  // the demuxer drops it
      have_frame = true;
      continue;
    }
    if (c.tag == fourcc("ANIM")) {
      if (c.padded < 6) fail(kContainer);
      anim = true;
      r.skip(c);
    } else if (c.tag == fourcc("ANMF")) {
      if (!anim || c.padded < 16) fail(kContainer);
      Frame f;
      f.x = 2 * int(le24(c.data));
      f.y = 2 * int(le24(c.data + 3));
      const size_t start = r.pos();
      r.skip_bytes(8 + 16);
      store_frame(r, &f);
      if (r.pos() - start - 8 > c.padded) fail(kContainer);  // past the ANMF's payload
      if (p.animation) {
        // a frame of a complete file: whole, its alpha first, on the canvas
        if (!f.image.tag || f.alpha_after_image) fail(kContainer);
        if (f.x + f.width > p.canvas_w || f.y + f.height > p.canvas_h) fail(kContainer);
        if (!have_frame) p.frame = f;
        have_frame = true;
      }
    } else {
      r.skip(c);  // ICCP, EXIF, XMP and unknown chunks
    }
  }
  if (!have_frame || !p.frame.image.tag) fail(kContainer);
  if (p.animation) {
    p.has_alpha = alpha_flag;
    return p;
  }
  if (p.frame.alpha.tag && p.frame.alpha_after_image) fail(kContainer);
  if (p.frame.width != p.canvas_w || p.frame.height != p.canvas_h) fail(kContainer);
  p.has_alpha = still_has_alpha(data, end, alpha_flag);
  return p;
}

// frame 0 of the file, composited onto a zero canvas, as RGBA; the alpha
// is 255 where Pillow's mode is RGB
void decode_webp(const uint8_t* data, size_t n, uint8_t* out, int width, int height,
                 Features* seen) {
  Parsed p = parse(data, n);
  seen->flags |= (p.animation ? 1 : 0) | (p.extended ? 2 : 0);
  if (p.canvas_w != width || p.canvas_h != height) fail(kSize);
  const size_t stride = size_t(width) * 4;
  std::memset(out, 0, stride * height);
  const Frame& f = p.frame;
  uint8_t* dst = out + size_t(f.y) * stride + size_t(f.x) * 4;
  // the image decoders read the chunk with its padding byte, as libwebp's
  // demuxer hands it to them: a stream may run into that byte
  if (f.image.tag == fourcc("VP8L")) {
    const std::vector<uint32_t> argb =
        decode_lossless(f.image.data, f.image.padded, f.width, f.height, seen);
    for (int y = 0; y < f.height; ++y) {
      uint8_t* row = dst + y * stride;
      for (int x = 0; x < f.width; ++x) {
        const uint32_t v = argb[size_t(y) * f.width + x];
        row[4 * x + 0] = (v >> 16) & 0xff;
        row[4 * x + 1] = (v >> 8) & 0xff;
        row[4 * x + 2] = v & 0xff;
        row[4 * x + 3] = v >> 24;
      }
    }
  } else {
    Lossy lossy(f.image.data, f.image.padded, f.image.size);
    lossy.decode(seen);
    std::vector<uint8_t> alpha;
    if (f.alpha.tag) alpha = decode_alpha(f.alpha.data, f.alpha.size, f.width, f.height, seen);
    yuv_to_rgba(lossy, dst, stride);
    for (int y = 0; y < f.height; ++y)
      for (int x = 0; x < f.width; ++x)
        dst[y * stride + 4 * x + 3] = alpha.empty() ? 255 : alpha[size_t(y) * f.width + x];
  }
  if (!p.has_alpha)
    for (size_t i = 3; i < stride * height; i += 4) out[i] = 255;
}

template <typename F>
int guarded(F f) {
  try {
    f();
    return kOk;
  } catch (const Fail& e) {
    return e.status;
  } catch (...) {
    return kLosslessData;
  }
}

}  // namespace

extern "C" {

// The canvas size of a WebP file; 0 on success, else a status for
// gl_error_string.
int gl_webp_info(const uint8_t* data, size_t n, int* width, int* height) {
  return guarded([&] {
    const Parsed p = parse(data, n);
    *width = p.canvas_w;
    *height = p.canvas_h;
  });
}

// Decode a WebP file's first frame on its canvas to RGBA uint8
// [height, width, 4], with the alpha 255 where Pillow's mode is RGB. When
// features is not null, report in features[8] the parts of the format the
// decode met: lossless, predictors, filter, partitions, segments,
// sharpness, alpha, flags (the fields of Features).
int gl_webp_decode(const uint8_t* data, size_t n, uint8_t* out, int width, int height,
                   int32_t* features) {
  Features seen;
  const int status = guarded([&] { decode_webp(data, n, out, width, height, &seen); });
  if (features) {
    const int32_t values[8] = {int32_t(seen.lossless), int32_t(seen.predictors), seen.filter,
                               seen.partitions, seen.segments, seen.sharpness, seen.alpha,
                               int32_t(seen.flags)};
    std::memcpy(features, values, sizeof(values));
  }
  return status;
}

const char* gl_error_string(int status) {
  return status >= 0 && status < kCount ? kMessages[status] : "unknown status";
}

}  // extern "C"
