// Image decoding and resizing for the hoig_torch input pipeline, built into
// one library with warp.cc (hoig_torch/runtime/__init__.py) and called
// through a plain C ABI by ctypes.
//
// The JAX package reads its frames, masks and textures with OpenCV
// (cv2.imread with IMREAD_COLOR, cv2.resize with INTER_LINEAR), which
// decodes JPEG with libjpeg-turbo and PNG with libpng. The port depends on
// none of them; these are their counterparts, written to give the same
// bits:
//
//   hoig_jpeg_header     : size and EXIF orientation of a JPEG.
//   hoig_jpeg_decode_bgr : baseline / extended-sequential Huffman JPEG
//                          (SOF0, SOF1), 8-bit, 1 or 3 components, any mix
//                          of 1x and 2x sampling per axis, restart
//                          intervals -> (H, W, 3) uint8 BGR. libjpeg-
//                          turbo's default arithmetic step by step: the
//                          accurate integer IDCT (jidctint.c, CONST_BITS
//                          13, PASS1_BITS 2, its range-limit table), fancy
//                          upsampling (jdsample.c: h2v1, h1v2, h2v2 with
//                          their alternating rounding biases; box
//                          upsampling where a 2x component is at most 2
//                          samples wide) and the YCbCr tables of jdcolor.c
//                          (SCALEBITS 16). Progressive, arithmetic-coded,
//                          lossless, 12-bit and CMYK files, a truncated or
//                          corrupt stream, all raise: libjpeg-turbo pads a
//                          truncated stream with zeros and only warns.
//   hoig_png_unfilter    : undoes the five PNG scanline filters.
//   hoig_resize_linear_u8: OpenCV's INTER_LINEAR resize of uint8 images:
//                          fixed-point coefficients scaled by 2^11, half-
//                          pixel centres, the vertical pass's rounding,
//                          and its shortcut of an exact 2x downscale in
//                          both axes through INTER_AREA.
//
// All integer arithmetic except the resize coefficients (float and double,
// as OpenCV computes them, each product rounded on its own: the pragma
// below keeps -march=native from contracting them into FMAs, which
// OpenCV's baseline build does not use), so the host and the flags do not
// change the bits. Every entry point returns 0, or 1 with a message in
// `err`.

#pragma GCC optimize("fp-contract=off")

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError(msg); }

std::string hex_marker(int m) {
  char buf[16];
  snprintf(buf, sizeof buf, "0xFF%02X", m & 0xFF);
  return buf;
}

int report(const std::exception& e, char* err, int err_len) {
  if (err && err_len > 0) {
    snprintf(err, (size_t)err_len, "%s", e.what());
  }
  return 1;
}

// ------------------------------------------------------------------ JPEG

// jpeg_natural_order: zigzag position -> row-major position in the block
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer code)
  uint8_t look_sym[512];
  int32_t maxcode[17];    // largest code of each length, -1 where none
  int32_t valoffset[17];
  uint8_t vals[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;     // the current scan's table selectors
  int dw = 0, dh = 0;     // downsampled width and height
  int bw = 0, bh = 0;     // the padded block grid
  bool scanned = false;
  int32_t quant[64];      // natural order, latched at the first scan
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples after the IDCT
};

struct Jpeg {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  int orientation = 1;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  bool qdefined[4] = {false, false, false, false};
  int32_t qtable[4][64];  // natural order
  Huffman dc[4], ac[4];
  Component comp[3];
};

int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// the next marker code, past any 0xFF fill bytes
int next_marker(Jpeg& j) {
  if (j.pos + 2 > j.size) fail("truncated: the data ends before the next marker");
  if (j.data[j.pos] != 0xFF) {
    fail("corrupt: expected a marker at byte " + std::to_string(j.pos));
  }
  while (j.pos < j.size && j.data[j.pos] == 0xFF) ++j.pos;
  if (j.pos >= j.size) fail("truncated: the data ends inside a marker");
  return j.data[j.pos++];
}

// the payload of a marker segment (after its length field); advances pos
const uint8_t* segment(Jpeg& j, int marker, int* len) {
  if (j.pos + 2 > j.size) fail("truncated: marker " + hex_marker(marker) + " has no length");
  const int n = u16(j.data + j.pos);
  if (n < 2 || j.pos + (size_t)n > j.size) {
    fail("truncated: marker " + hex_marker(marker) + " segment runs past the data");
  }
  const uint8_t* p = j.data + j.pos + 2;
  *len = n - 2;
  j.pos += (size_t)n;
  return p;
}

void parse_exif(Jpeg& j, const uint8_t* p, int len) {
  // OpenCV parses the first APP1 segment from its seventh byte on
  // ("Exif\0\0" skipped unchecked) and keeps orientation 1 where the TIFF
  // header or IFD0 does not hold up
  if (len <= 6) return;
  const uint8_t* t = p + 6;
  const int n = len - 6;
  if (n < 8) return;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return;
  auto rd16 = [&](int off) -> int {
    return le ? (t[off] | (t[off + 1] << 8)) : ((t[off] << 8) | t[off + 1]);
  };
  auto rd32 = [&](int off) -> uint32_t {
    return le ? (uint32_t)t[off] | ((uint32_t)t[off + 1] << 8) | ((uint32_t)t[off + 2] << 16) |
                    ((uint32_t)t[off + 3] << 24)
              : ((uint32_t)t[off] << 24) | ((uint32_t)t[off + 1] << 16) |
                    ((uint32_t)t[off + 2] << 8) | (uint32_t)t[off + 3];
  };
  if (rd16(2) != 42) return;
  const uint32_t ifd = rd32(4);
  if (ifd + 2 > (uint32_t)n) return;
  const int count = rd16((int)ifd);
  for (int i = 0; i < count; ++i) {
    const uint32_t e = ifd + 2 + 12 * (uint32_t)i;
    if (e + 12 > (uint32_t)n) return;
    if (rd16((int)e) == 0x0112) {
      j.orientation = rd16((int)e + 8);
      return;
    }
  }
}

void parse_app(Jpeg& j, int marker, const uint8_t* p, int len, bool* saw_app1) {
  if (marker == 0xE0 && len >= 5 && memcmp(p, "JFIF\0", 5) == 0) j.jfif = true;
  if (marker == 0xEE && len >= 12 && memcmp(p, "Adobe", 5) == 0) {
    j.adobe = true;
    j.adobe_transform = p[11];
  }
  if (marker == 0xE1 && !*saw_app1) {
    *saw_app1 = true;
    parse_exif(j, p, len);
  }
}

void parse_dqt(Jpeg& j, const uint8_t* p, int len) {
  int i = 0;
  while (i < len) {
    const int pq = p[i] >> 4, tq = p[i] & 15;
    ++i;
    if (tq > 3 || pq > 1) fail("corrupt: bad quantization table header");
    const int need = pq ? 128 : 64;
    if (i + need > len) fail("corrupt: quantization table runs past its segment");
    for (int k = 0; k < 64; ++k) {
      const int q = pq ? u16(p + i + 2 * k) : p[i + k];
      j.qtable[tq][kNatural[k]] = q;
    }
    j.qdefined[tq] = true;
    i += need;
  }
}

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals, bool is_dc) {
  memset(h.look_len, 0, sizeof h.look_len);
  memcpy(h.vals, vals, (size_t)nvals);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = counts[l - 1];
    h.valoffset[l] = k - code;
    for (int i = 0; i < n; ++i, ++code, ++k) {
      if (l <= 9) {
        const int lo = code << (9 - l), hi = (code + 1) << (9 - l);
        for (int c = lo; c < hi; ++c) {
          h.look_len[c] = (uint8_t)l;
          h.look_sym[c] = vals[k];
        }
      }
    }
    h.maxcode[l] = n ? code - 1 : -1;
    // no code may be all ones (jdhuff.c, jpeg_make_d_derived_tbl)
    if (code >= (1 << l)) fail("corrupt: bad Huffman table");
    code <<= 1;
  }
  if (is_dc) {
    for (int i = 0; i < nvals; ++i) {
      if (vals[i] > 15) fail("corrupt: bad DC Huffman table");
    }
  }
  h.defined = true;
}

void parse_dht(Jpeg& j, const uint8_t* p, int len) {
  int i = 0;
  while (i < len) {
    if (i + 17 > len) fail("corrupt: Huffman table runs past its segment");
    const int tc = p[i] >> 4, th = p[i] & 15;
    if (tc > 1 || th > 3) fail("corrupt: bad Huffman table header");
    const uint8_t* counts = p + i + 1;
    int nvals = 0;
    for (int l = 0; l < 16; ++l) nvals += counts[l];
    if (nvals > 256 || i + 17 + nvals > len) fail("corrupt: bad Huffman table size");
    build_huffman(tc ? j.ac[th] : j.dc[th], counts, p + i + 17, nvals, tc == 0);
    i += 17 + nvals;
  }
}

void parse_sof(Jpeg& j, int marker, const uint8_t* p, int len) {
  if (j.frame) fail("corrupt: a second frame header (" + hex_marker(marker) + ")");
  if (len < 6) fail("corrupt: short frame header");
  const int precision = p[0];
  if (precision != 8) {
    fail(std::to_string(precision) + "-bit samples (frame marker " + hex_marker(marker) +
         "): only 8-bit JPEG is read");
  }
  j.height = u16(p + 1);
  j.width = u16(p + 3);
  j.ncomp = p[5];
  if (j.height == 0) fail("the frame height comes in a DNL marker, which is not supported");
  if (j.width == 0) fail("corrupt: frame width 0");
  if (j.ncomp == 4) fail("4 components (CMYK or YCCK): only grey and YCbCr JPEG are read");
  if (j.ncomp != 1 && j.ncomp != 3) {
    fail(std::to_string(j.ncomp) + " components: only grey and YCbCr JPEG are read");
  }
  if (len < 6 + 3 * j.ncomp) fail("corrupt: short frame header");
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.id = p[6 + 3 * c];
    k.h = p[7 + 3 * c] >> 4;
    k.v = p[7 + 3 * c] & 15;
    k.tq = p[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) {
      fail("corrupt: bad component sampling or table");
    }
    j.hmax = std::max(j.hmax, k.h);
    j.vmax = std::max(j.vmax, k.v);
  }
  j.mcus_x = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcus_y = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    const int rh = j.hmax / k.h, rv = j.vmax / k.v;
    if (j.ncomp > 1 && (j.hmax % k.h || j.vmax % k.v || rh > 2 || rv > 2)) {
      fail("component sampling " + std::to_string(k.h) + "x" + std::to_string(k.v) +
           " of a " + std::to_string(j.hmax) + "x" + std::to_string(j.vmax) +
           " frame: only 1x and 2x subsampling per axis is read");
    }
    k.dw = (int)(((long)j.width * k.h + j.hmax - 1) / j.hmax);
    k.dh = (int)(((long)j.height * k.v + j.vmax - 1) / j.vmax);
    k.bw = j.mcus_x * k.h;
    k.bh = j.mcus_y * k.v;
    k.coef.assign((size_t)k.bw * k.bh * 64, 0);
  }
  j.frame = true;
}

// Entropy-coded data: a 64-bit window filled a byte at a time, 0xFF00
// unstuffed. At a marker or the end of the data it is filled with zero
// bits, counted in `pad`; taking any of them means the stream is truncated.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;
  int pad = 0;
  bool stopped = false;

  void fill() {
    while (n <= 56) {
      int b = 0;
      if (!stopped && p < end && !(p[0] == 0xFF && !(p + 1 < end && p[1] == 0x00))) {
        b = *p;
        p += (b == 0xFF) ? 2 : 1;
      } else {
        stopped = true;
        pad += 8;
      }
      buf |= (uint64_t)b << (56 - n);
      n += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    const int v = (int)(buf >> (64 - k));
    buf <<= k;
    n -= k;
    return v;
  }
  void check() const {
    if (n < pad) fail("truncated or corrupt: the entropy-coded data ends early");
  }
  // drop the partial byte; the bytes up to the next marker must be spent
  void align() {
    if (n - pad >= 8) fail("corrupt: extraneous bytes in the entropy-coded data");
    buf = 0;
    n = 0;
    pad = 0;
    stopped = false;
    while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;
    if (!(p + 1 < end && p[0] == 0xFF && p[1] != 0x00)) {
      fail("truncated or corrupt: no marker after the entropy-coded data");
    }
  }
};

inline int decode_symbol(Bits& b, const Huffman& h) {
  if (b.n < 16) b.fill();
  const int look = (int)(b.buf >> 55);
  const int l = h.look_len[look];
  if (l) {
    b.buf <<= l;
    b.n -= l;
    return h.look_sym[look];
  }
  const int code16 = (int)(b.buf >> 48);
  for (int k = 10; k <= 16; ++k) {
    const int c = code16 >> (16 - k);
    if (c <= h.maxcode[k]) {
      b.buf <<= k;
      b.n -= k;
      return h.vals[h.valoffset[k] + c];
    }
  }
  fail("corrupt: bad Huffman code");
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s)) + 1 : v; }

void decode_block(Bits& b, const Huffman& dc, const Huffman& ac, int* pred, int16_t* blk) {
  const int t = decode_symbol(b, dc);
  const int diff = t ? extend(b.get(t), t) : 0;
  *pred += diff;
  blk[0] = (int16_t)*pred;
  for (int k = 1; k < 64;) {
    const int rs = decode_symbol(b, ac);
    const int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) fail("corrupt: AC coefficients run past the block");
      blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
      ++k;
    } else {
      if (r != 15) break;
      k += 16;
    }
  }
  b.check();
}

void decode_scan(Jpeg& j, const uint8_t* p, int len) {
  if (!j.frame) fail("corrupt: scan before the frame header");
  if (len < 1) fail("corrupt: short scan header");
  const int ns = p[0];
  if (ns < 1 || ns > j.ncomp || len < 4 + 2 * ns) fail("corrupt: bad scan header");
  int idx[3];
  for (int i = 0; i < ns; ++i) {
    const int cid = p[1 + 2 * i];
    int c = 0;
    while (c < j.ncomp && j.comp[c].id != cid) ++c;
    if (c == j.ncomp) fail("corrupt: scan names an unknown component");
    Component& k = j.comp[c];
    k.td = p[2 + 2 * i] >> 4;
    k.ta = p[2 + 2 * i] & 15;
    if (k.td > 3 || k.ta > 3 || !j.dc[k.td].defined || !j.ac[k.ta].defined) {
      fail("corrupt: scan uses an undefined Huffman table");
    }
    if (!k.scanned) {
      if (!j.qdefined[k.tq]) fail("corrupt: component uses an undefined quantization table");
      memcpy(k.quant, j.qtable[k.tq], sizeof k.quant);
      k.scanned = true;
    }
    idx[i] = c;
  }
  const int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], a = p[3 + 2 * ns];
  if (ss != 0 || se != 63 || a != 0) fail("corrupt: spectral selection in a sequential scan");

  Bits b{j.data + j.pos, j.data + j.size};
  int pred[3] = {0, 0, 0};
  int togo = j.restart_interval, next_rst = 0;
  auto restart = [&]() {
    b.align();
    if (b.p[1] != 0xD0 + next_rst) {
      fail("corrupt: expected RST" + std::to_string(next_rst) + ", found marker " +
           hex_marker(b.p[1]));
    }
    b.p += 2;
    next_rst = (next_rst + 1) & 7;
    pred[0] = pred[1] = pred[2] = 0;
    togo = j.restart_interval;
  };
  if (ns == 1) {
    Component& k = j.comp[idx[0]];
    const int nbx = (k.dw + 7) / 8, nby = (k.dh + 7) / 8;
    for (int by = 0; by < nby; ++by) {
      for (int bx = 0; bx < nbx; ++bx) {
        if (j.restart_interval) {
          if (togo == 0) restart();
          --togo;
        }
        decode_block(b, j.dc[k.td], j.ac[k.ta], &pred[0],
                     &k.coef[((size_t)by * k.bw + bx) * 64]);
      }
    }
  } else {
    for (int my = 0; my < j.mcus_y; ++my) {
      for (int mx = 0; mx < j.mcus_x; ++mx) {
        if (j.restart_interval) {
          if (togo == 0) restart();
          --togo;
        }
        for (int i = 0; i < ns; ++i) {
          Component& k = j.comp[idx[i]];
          for (int v = 0; v < k.v; ++v) {
            for (int h = 0; h < k.h; ++h) {
              const size_t by = (size_t)my * k.v + v, bx = (size_t)mx * k.h + h;
              decode_block(b, j.dc[k.td], j.ac[k.ta], &pred[i], &k.coef[(by * k.bw + bx) * 64]);
            }
          }
        }
      }
    }
  }
  b.align();
  j.pos = (size_t)(b.p - j.data);
}

// jdmaster.c's sample_range_limit seen from the IDCT: idct_limit[x & 1023]
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      if (x < 128) t[x] = (uint8_t)(x + 128);
      else if (x < 512) t[x] = 255;
      else if (x < 896) t[x] = 0;
      else t[x] = (uint8_t)(x - 896);
    }
  }
};
const RangeLimit kLimit;

// jidctint.c: jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      const int dc = (int)(((int64_t)ip[0] * qp[0]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      const uint8_t v = kLimit.t[(int)descale(wp[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kLimit.t[(int)descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kLimit.t[(int)descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kLimit.t[(int)descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kLimit.t[(int)descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kLimit.t[(int)descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kLimit.t[(int)descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kLimit.t[(int)descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kLimit.t[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

void idct_component(Component& k) {
  const size_t stride = (size_t)k.bw * 8;
  k.plane.assign(stride * k.bh * 8, 0);
  for (int by = 0; by < k.bh; ++by) {
    for (int bx = 0; bx < k.bw; ++bx) {
      idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], k.quant,
                 &k.plane[(size_t)by * 8 * stride + (size_t)bx * 8], stride);
    }
  }
}

// One row of a component at the frame's resolution, into `out` (at least
// 2 * dw samples), as jdsample.c's upsamplers give it. Row y of the output;
// rows of the component past dh repeat its last row and the row above the
// first is the first (jdmainct.c's context rows).
const uint8_t* upsample_row(const Jpeg& j, const Component& k, int y, uint8_t* out) {
  const size_t stride = (size_t)k.bw * 8;
  const int rh = j.hmax / k.h, rv = j.vmax / k.v;
  const uint8_t* plane = k.plane.data();
  if (rh == 1 && rv == 1) return plane + (size_t)y * stride;
  const int dw = k.dw;
  if (rv == 1) {  // h2v1
    const uint8_t* in = plane + (size_t)y * stride;
    if (dw <= 2) {
      for (int i = 0; i < dw; ++i) out[2 * i] = out[2 * i + 1] = in[i];
      return out;
    }
    out[0] = in[0];
    out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < dw - 1; ++i) {
      const int v = in[i] * 3;
      out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
      out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
    }
    out[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = in[dw - 1];
    return out;
  }
  const int i = y / 2;
  const bool upper = (y & 1) == 0;
  const int nb = upper ? std::max(i - 1, 0) : std::min(i + 1, k.dh - 1);
  const uint8_t* in0 = plane + (size_t)std::min(i, k.dh - 1) * stride;
  const uint8_t* in1 = plane + (size_t)nb * stride;
  if (rh == 1) {  // h1v2
    const int bias = upper ? 1 : 2;
    for (int c = 0; c < dw; ++c) out[c] = (uint8_t)((in0[c] * 3 + in1[c] + bias) >> 2);
    return out;
  }
  // h2v2
  if (dw <= 2) {
    for (int c = 0; c < dw; ++c) out[2 * c] = out[2 * c + 1] = in0[c];
    return out;
  }
  int this_sum = in0[0] * 3 + in1[0];
  int next_sum = in0[1] * 3 + in1[1];
  out[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
  out[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int c = 2; c < dw; ++c) {
    next_sum = in0[c] * 3 + in1[c];
    out[2 * c - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * c - 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
  return out;
}

// jdcolor.c's YCbCr -> RGB tables
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = (int64_t)1 << (kScaleBits - 1);
inline int64_t fix(double x) { return (int64_t)(x * (double)(1L << kScaleBits) + 0.5); }

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = (int)((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void parse_headers(Jpeg& j, bool stop_at_scan) {
  if (j.size < 2 || j.data[0] != 0xFF || j.data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
  j.pos = 2;
  bool saw_app1 = false, saw_scan = false;
  for (;;) {
    const int m = next_marker(j);
    if (m == 0xD9) {  // EOI
      if (!saw_scan) fail("corrupt: EOI before any scan");
      break;
    }
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // a stray RSTn, TEM: no payload
    int len = 0;
    const uint8_t* p = segment(j, m, &len);
    if (m == 0xC0 || m == 0xC1) {
      parse_sof(j, m, p, len);
    } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
      fail("progressive JPEG (frame marker " + hex_marker(m) + ") is not supported");
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      fail("lossless JPEG (frame marker " + hex_marker(m) + ") is not supported");
    } else if (m == 0xC5 || m == 0xCD) {
      fail("hierarchical JPEG (frame marker " + hex_marker(m) + ") is not supported");
    } else if (m == 0xC9 || m == 0xCC) {
      fail("arithmetic-coded JPEG (marker " + hex_marker(m) + ") is not supported");
    } else if (m == 0xC4) {
      parse_dht(j, p, len);
    } else if (m == 0xDB) {
      parse_dqt(j, p, len);
    } else if (m == 0xDD) {
      if (len < 2) fail("corrupt: short DRI segment");
      j.restart_interval = u16(p);
    } else if (m >= 0xE0 && m <= 0xEF) {
      parse_app(j, m, p, len, &saw_app1);
    } else if (m == 0xFE) {
      // comment
    } else if (m == 0xDA) {
      if (!j.frame) fail("corrupt: scan before the frame header");
      if (stop_at_scan) return;
      decode_scan(j, p, len);
      saw_scan = true;
    } else if (m == 0xDC) {
      fail("DNL marker (0xFFDC) is not supported");
    } else {
      fail("unknown marker " + hex_marker(m));
    }
  }
}

void decode_jpeg(Jpeg& j, uint8_t* out) {
  parse_headers(j, false);
  if (j.ncomp == 3) {
    bool rgb;
    if (j.jfif) rgb = false;
    else if (j.adobe) rgb = j.adobe_transform == 0;
    else rgb = j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B';
    if (rgb) fail("RGB-coded JPEG (no YCbCr transform): only grey and YCbCr JPEG are read");
  }
  for (int c = 0; c < j.ncomp; ++c) {
    if (!j.comp[c].scanned) fail("truncated: component " + std::to_string(c) + " has no scan");
    idct_component(j.comp[c]);
  }
  const int w = j.width;
  if (j.ncomp == 1) {
    const Component& k = j.comp[0];
    for (int y = 0; y < j.height; ++y) {
      const uint8_t* in = k.plane.data() + (size_t)y * k.bw * 8;
      uint8_t* o = out + (size_t)y * w * 3;
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return;
  }
  std::vector<uint8_t> rows[3];
  for (int c = 0; c < 3; ++c) rows[c].assign((size_t)j.comp[c].bw * 8 * 2 + 16, 0);
  for (int y = 0; y < j.height; ++y) {
    const uint8_t* yy = upsample_row(j, j.comp[0], y, rows[0].data());
    const uint8_t* cb = upsample_row(j, j.comp[1], y, rows[1].data());
    const uint8_t* cr = upsample_row(j, j.comp[2], y, rows[2].data());
    uint8_t* o = out + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      const int l = yy[x], b = cb[x], r = cr[x];
      o[3 * x] = clamp255(l + kColor.cb_b[b]);
      o[3 * x + 1] = clamp255(l + (int)((kColor.cb_g[b] + kColor.cr_g[r]) >> kScaleBits));
      o[3 * x + 2] = clamp255(l + kColor.cr_r[r]);
    }
  }
}

// ------------------------------------------------------------------- PNG

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

void png_unfilter(const uint8_t* raw, int height, int stride, int bpp, uint8_t* out) {
  std::vector<uint8_t> zero((size_t)stride, 0);
  const uint8_t* prev = zero.data();
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = raw + (size_t)y * (stride + 1);
    const int kind = line[0];
    ++line;
    uint8_t* cur = out + (size_t)y * stride;
    switch (kind) {
      case 0:
        memcpy(cur, line, (size_t)stride);
        break;
      case 1:  // sub
        for (int i = 0; i < stride; ++i) {
          cur[i] = (uint8_t)(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        }
        break;
      case 2:  // up
        for (int i = 0; i < stride; ++i) cur[i] = (uint8_t)(line[i] + prev[i]);
        break;
      case 3:  // average
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = (uint8_t)(line[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(line[i] + paeth(a, prev[i], c));
        }
        break;
      default:
        fail("scanline " + std::to_string(y) + " has filter type " + std::to_string(kind));
    }
    prev = cur;
  }
}

// ---------------------------------------------------------------- resize

constexpr int kCoefBits = 11, kCoefScale = 1 << kCoefBits;  // INTER_RESIZE_COEF_BITS

inline int16_t round_coef(float x) { return (int16_t)std::lrint(x * (float)kCoefScale); }

// OpenCV's saturate_cast<int>(double) and the test of an integer scale
inline bool integer_scale(double scale, int k) {
  return std::fabs(scale - (double)k) < 2.220446049250313e-16;
}

void resize_area2(const uint8_t* src, int w, int ch, uint8_t* dst, int oh, int ow) {
  const size_t sstep = (size_t)w * ch;
  for (int y = 0; y < oh; ++y) {
    const uint8_t* s0 = src + (size_t)(2 * y) * sstep;
    const uint8_t* s1 = s0 + sstep;
    uint8_t* d = dst + (size_t)y * ow * ch;
    for (int x = 0; x < ow; ++x) {
      for (int c = 0; c < ch; ++c) {
        const int i = 2 * x * ch + c;
        const int sum = s0[i] + s0[i + ch] + s1[i] + s1[i + ch];
        // OpenCV's fast 2x path rounds half up for 1, 3 and 4 channels;
        // two channels take the generic path, sum * 0.25f rounded to even
        d[x * ch + c] = ch == 2 ? (uint8_t)std::lrint((float)sum * 0.25f) : (uint8_t)((sum + 2) >> 2);
      }
    }
  }
}

void resize_linear(const uint8_t* src, int h, int w, int ch, uint8_t* dst, int oh, int ow) {
  const double scale_x = 1.0 / ((double)ow / w), scale_y = 1.0 / ((double)oh / h);
  std::vector<int> xofs(ow);
  std::vector<int16_t> alpha(2 * (size_t)ow);
  for (int dx = 0; dx < ow; ++dx) {
    float fx = (float)((dx + 0.5) * scale_x - 0.5);
    int sx = (int)std::floor(fx);
    fx -= (float)sx;
    if (sx < 0) fx = 0.f, sx = 0;
    if (sx >= w - 1) fx = 0.f, sx = w - 1;
    xofs[dx] = sx;
    alpha[2 * dx] = round_coef(1.f - fx);
    alpha[2 * dx + 1] = round_coef(fx);
  }
  std::vector<int> yofs(oh);
  std::vector<int16_t> beta(2 * (size_t)oh);
  for (int dy = 0; dy < oh; ++dy) {
    float fy = (float)((dy + 0.5) * scale_y - 0.5);
    const int sy = (int)std::floor(fy);
    fy -= (float)sy;
    yofs[dy] = sy;
    beta[2 * dy] = round_coef(1.f - fy);
    beta[2 * dy + 1] = round_coef(fy);
  }
  const size_t width = (size_t)ow * ch;
  std::vector<int> rows(2 * width);
  int* r0 = rows.data();
  int* r1 = r0 + width;
  auto hresize = [&](int sy, int* d) {
    const uint8_t* s = src + (size_t)sy * w * ch;
    for (int dx = 0; dx < ow; ++dx) {
      const int sx = xofs[dx];
      const int a0 = alpha[2 * dx], a1 = alpha[2 * dx + 1];
      const uint8_t* p = s + (size_t)sx * ch;
      for (int c = 0; c < ch; ++c) {
        // past the last source column OpenCV takes the sample alone
        d[(size_t)dx * ch + c] = sx + 1 < w ? p[c] * a0 + p[c + ch] * a1 : p[c] * kCoefScale;
      }
    }
  };
  for (int dy = 0; dy < oh; ++dy) {
    const int sy = yofs[dy];
    const int y0 = std::min(std::max(sy, 0), h - 1), y1 = std::min(std::max(sy + 1, 0), h - 1);
    hresize(y0, r0);
    hresize(y1, r1);
    const int b0 = beta[2 * dy], b1 = beta[2 * dy + 1];
    uint8_t* d = dst + (size_t)dy * width;
    for (size_t x = 0; x < width; ++x) {
      // VResizeLinear<uchar, int, short, ...>: the SIMD path's pmulhw
      const int v = (((b0 * (r0[x] >> 4)) >> 16) + ((b1 * (r1[x] >> 4)) >> 16) + 2) >> 2;
      d[x] = clamp255(v);
    }
  }
}

}  // namespace

extern "C" {

int hoig_jpeg_header(const uint8_t* data, size_t size, int* height, int* width,
                     int* orientation, char* err, int err_len) {
  try {
    Jpeg j;
    j.data = data;
    j.size = size;
    parse_headers(j, true);
    *height = j.height;
    *width = j.width;
    *orientation = j.orientation;
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, err_len);
  }
}

int hoig_jpeg_decode_bgr(const uint8_t* data, size_t size, uint8_t* out, int height, int width,
                         char* err, int err_len) {
  try {
    Jpeg j;
    j.data = data;
    j.size = size;
    decode_jpeg(j, out);
    if (j.height != height || j.width != width) fail("corrupt: the frame size changed");
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, err_len);
  }
}

int hoig_png_unfilter(const uint8_t* raw, int height, int stride, int bpp, uint8_t* out,
                      char* err, int err_len) {
  try {
    png_unfilter(raw, height, stride, bpp, out);
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, err_len);
  }
}

int hoig_resize_linear_u8(const uint8_t* src, int h, int w, int ch, uint8_t* dst, int oh,
                          int ow, char* err, int err_len) {
  try {
    if (h < 1 || w < 1 || oh < 1 || ow < 1 || ch < 1 || ch > 4) {
      fail("resize of a " + std::to_string(h) + "x" + std::to_string(w) + "x" +
           std::to_string(ch) + " image to " + std::to_string(oh) + "x" + std::to_string(ow));
    }
    if (oh == h && ow == w) {
      memcpy(dst, src, (size_t)h * w * ch);
      return 0;
    }
    const double sx = 1.0 / ((double)ow / w), sy = 1.0 / ((double)oh / h);
    if (integer_scale(sx, 2) && integer_scale(sy, 2)) {
      resize_area2(src, w, ch, dst, oh, ow);
    } else {
      resize_linear(src, h, w, ch, dst, oh, ow);
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, err_len);
  }
}

}  // extern "C"
