// Baseline JPEG decoding and OpenCV-style bilinear resizing on the host.
//
// The decoder follows libjpeg-turbo's arithmetic step for step, so that its
// pixels equal cv2.imread's (which decodes through libjpeg-turbo):
//   - Huffman decoding of baseline and extended-sequential 8-bit scans,
//     interleaved or not, with restart markers;
//   - the integer "islow" inverse DCT of jidctint.c, with its range-limit
//     table (jdmaster.c prepare_range_limit_table);
//   - "fancy" triangle upsampling of h2v1 and h2v2 chroma (jdsample.c), with
//     the edge rows and columns replicated as jdmainct.c's context rows do,
//     and plain replication where the chroma is 2 samples wide or less;
//   - the fixed-point YCbCr->RGB tables of jdcolor.c.
// Progressive, arithmetic-coded, lossless, 12-bit and 4-component files are
// refused (FOD_JPEG_* error codes), as are sampling layouts other than 4:4:4,
// 4:2:2 and 4:2:0.
//
// The normalization is the ImageNet one, (x / 255 - mean) / std, bit for bit
// as numpy computes it in float32.
//
// The resizes are cv2.resize(..., INTER_LINEAR): the float path computes
// cv2's float coefficients, the uint8 path its 11-bit fixed-point ones and
// the vertical pass as its vector code does; an exact 2x reduction is the
// 2x2 mean, as cv2 switches to INTER_AREA there.
//
// Plain C entry points, loaded with ctypes (which releases the GIL), so a
// thread pool decodes in parallel. Built with g++ by ops/_kernels.py.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  FOD_JPEG_OK = 0,
  FOD_JPEG_CORRUPT = 1,
  FOD_JPEG_PROGRESSIVE = 2,
  FOD_JPEG_ARITHMETIC = 3,
  FOD_JPEG_COMPONENTS = 4,
  FOD_JPEG_SAMPLING = 5,
  FOD_JPEG_PRECISION = 6,
};

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for corrupt data (jpeg_natural_order's safety margin)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  // canonical decoding tables (jdhuff.c jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  bool present = false;
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;             // Huffman table selectors of the current scan
  int width_in_blocks = 0, height_in_blocks = 0;
  int blocks_per_row = 0, block_rows = 0;  // allocated (MCU-padded)
  int downsampled_width = 0, downsampled_height = 0;
  std::vector<int16_t> coef;      // blocks in raster order, 64 each
  std::vector<uint8_t> pixels;    // blocks_per_row*8 x block_rows*8
  int dc_pred = 0;
};

struct Decoder {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;
  uint16_t qt[4][64];  // natural order
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0;
  Component comp[4];
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool saw_sof = false, adobe = false, jfif = false;
  int adobe_transform = -1;
  // entropy decoder state (jdhuff.c's bit buffer)
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  int u8() { return pos < size ? data[pos++] : -1; }
  int u16() {
    int a = u8(), b = u8();
    return (a < 0 || b < 0) ? -1 : (a << 8) | b;
  }

  // --- entropy-coded bits ---------------------------------------------------
  void fill() {
    while (bitcnt <= 24) {
      int byte = 0;
      if (!hit_marker && pos < size) {
        byte = data[pos];
        if (byte == 0xFF) {
          int next = pos + 1 < size ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // a marker: feed zeros, as libjpeg does
            byte = 0;
          }
        } else {
          pos++;
        }
      } else {
        hit_marker = true;
      }
      bitbuf |= static_cast<uint32_t>(byte) << (24 - bitcnt);
      bitcnt += 8;
    }
  }
  int bits(int n) {
    if (n == 0) return 0;
    if (bitcnt < n) fill();
    int v = static_cast<int>(bitbuf >> (32 - n));
    bitbuf <<= n;
    bitcnt -= n;
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huffman& t) {
    if (bitcnt < 16) fill();
    int code = 0;
    for (int l = 1; l <= 16; l++) {
      code = (code << 1) | bit();
      if (code <= t.maxcode[l]) return t.huffval[(code + t.valoffset[l]) & 0xFF];
    }
    return 0;  // corrupt data: libjpeg warns and takes 0
  }
  static int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
  }
  // at a restart boundary: drop the partial byte, read RSTn, reset the DC
  // predictions
  void restart() {
    reset_bits();
    if (hit_marker || (pos + 1 < size && data[pos] == 0xFF)) {
      // skip to the marker and over it if it is a restart marker
      while (pos < size && data[pos] != 0xFF) pos++;
      while (pos + 1 < size && data[pos] == 0xFF && data[pos + 1] == 0xFF) pos++;
      if (pos + 1 < size && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) pos += 2;
    }
    hit_marker = false;
    for (int c = 0; c < ncomp; c++) comp[c].dc_pred = 0;
  }

  // --- markers --------------------------------------------------------------
  int read_dqt(int len) {
    int64_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) return FOD_JPEG_CORRUPT;
      for (int k = 0; k < 64; k++) {
        int v = pq ? u16() : u8();
        if (v < 0) return FOD_JPEG_CORRUPT;
        qt[tq][kNaturalOrder[k]] = static_cast<uint16_t>(v);
      }
      qt_present[tq] = true;
    }
    return pos == end ? FOD_JPEG_OK : FOD_JPEG_CORRUPT;
  }
  int read_dht(int len) {
    int64_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) return FOD_JPEG_CORRUPT;
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) {
        counts[l] = u8();
        if (counts[l] < 0) return FOD_JPEG_CORRUPT;
        total += counts[l];
      }
      if (total > 256) return FOD_JPEG_CORRUPT;
      Huffman& t = tc ? ac[th] : dc[th];
      for (int i = 0; i < total; i++) {
        int v = u8();
        if (v < 0) return FOD_JPEG_CORRUPT;
        t.huffval[i] = static_cast<uint8_t>(v);
      }
      int code = 0, p = 0;
      for (int l = 1; l <= 16; l++) {
        if (counts[l]) {
          t.valoffset[l] = p - code;
          code += counts[l];
          p += counts[l];
          t.maxcode[l] = code - 1;
        } else {
          t.maxcode[l] = -1;
        }
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;
      t.present = true;
    }
    return pos == end ? FOD_JPEG_OK : FOD_JPEG_CORRUPT;
  }
  int read_sof(int marker, int len) {
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
      return FOD_JPEG_PROGRESSIVE;
    if (marker >= 0xC9) return FOD_JPEG_ARITHMETIC;
    if (marker == 0xC3 || marker == 0xC7) return FOD_JPEG_PRECISION;  // lossless
    if (marker != 0xC0 && marker != 0xC1) return FOD_JPEG_CORRUPT;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8) return FOD_JPEG_PRECISION;
    if (height <= 0 || width <= 0 || ncomp <= 0) return FOD_JPEG_CORRUPT;
    if (ncomp != 1 && ncomp != 3) return FOD_JPEG_COMPONENTS;
    if (len != 8 + 3 * ncomp) return FOD_JPEG_CORRUPT;
    hmax = vmax = 1;
    for (int c = 0; c < ncomp; c++) {
      comp[c].id = u8();
      int hv = u8();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = u8();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 || comp[c].tq > 3)
        return FOD_JPEG_CORRUPT;
      if (comp[c].h > hmax) hmax = comp[c].h;
      if (comp[c].v > vmax) vmax = comp[c].v;
    }
    if (ncomp == 1) {
      comp[0].h = comp[0].v = hmax = vmax = 1;  // a single component is never subsampled
    } else {
      // 4:4:4, 4:2:2 or 4:2:0: luma (hmax, vmax) in {1,2} x {1,2} with v <= h,
      // chroma 1x1
      bool ok = comp[0].h == hmax && comp[0].v == vmax && hmax <= 2 && vmax <= hmax;
      for (int c = 1; c < ncomp; c++) ok = ok && comp[c].h == 1 && comp[c].v == 1;
      if (!ok) return FOD_JPEG_SAMPLING;
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      k.downsampled_width = (width * k.h + hmax - 1) / hmax;
      k.downsampled_height = (height * k.v + vmax - 1) / vmax;
      k.width_in_blocks = (k.downsampled_width + 7) / 8;
      k.height_in_blocks = (k.downsampled_height + 7) / 8;
      k.blocks_per_row = mcux * k.h;
      k.block_rows = mcuy * k.v;
      k.coef.assign(static_cast<size_t>(k.blocks_per_row) * k.block_rows * 64, 0);
    }
    saw_sof = true;
    return FOD_JPEG_OK;
  }

  int16_t* block(Component& k, int by, int bx) {
    return &k.coef[(static_cast<size_t>(by) * k.blocks_per_row + bx) * 64];
  }

  void decode_block(Component& k, int16_t* out) {
    int t = decode(dc[k.td]);
    int diff = t ? extend(bits(t), t) : 0;
    k.dc_pred += diff;
    out[0] = static_cast<int16_t>(k.dc_pred);
    const Huffman& a = ac[k.ta];
    for (int i = 1; i < 64; i++) {
      int rs = decode(a);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        out[kNaturalOrder[i]] = static_cast<int16_t>(extend(bits(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  int read_sos(int len) {
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) return FOD_JPEG_CORRUPT;
    Component* scan[4];
    for (int i = 0; i < ns; i++) {
      int id = u8(), tdta = u8();
      scan[i] = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == id) scan[i] = &comp[c];
      if (!scan[i]) return FOD_JPEG_CORRUPT;
      scan[i]->td = tdta >> 4;
      scan[i]->ta = tdta & 15;
      if (scan[i]->td > 3 || scan[i]->ta > 3 || !dc[scan[i]->td].present ||
          !ac[scan[i]->ta].present)
        return FOD_JPEG_CORRUPT;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) return FOD_JPEG_PROGRESSIVE;
    reset_bits();
    hit_marker = false;
    for (int c = 0; c < ncomp; c++) comp[c].dc_pred = 0;
    int mcus_done = 0;
    auto boundary = [&]() {
      mcus_done++;
      if (restart_interval && mcus_done % restart_interval == 0) restart();
    };
    if (ns == 1) {  // non-interleaved: one block an MCU, the component's own grid
      Component& k = *scan[0];
      for (int by = 0; by < k.height_in_blocks; by++)
        for (int bx = 0; bx < k.width_in_blocks; bx++) {
          decode_block(k, block(k, by, bx));
          boundary();
        }
    } else {
      int mcux = (width + 8 * hmax - 1) / (8 * hmax);
      int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          for (int i = 0; i < ns; i++) {
            Component& k = *scan[i];
            for (int y = 0; y < k.v; y++)
              for (int x = 0; x < k.h; x++)
                decode_block(k, block(k, my * k.v + y, mx * k.h + x));
          }
          boundary();
        }
    }
    // leave pos at the next marker
    reset_bits();
    while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                               !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      pos++;
    return FOD_JPEG_OK;
  }

  int parse(bool header_only) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return FOD_JPEG_CORRUPT;
    pos = 2;
    bool any_scan = false;
    while (pos < size) {
      int ff = u8();
      if (ff != 0xFF) continue;  // garbage between markers, as libjpeg skips it
      int marker = u8();
      while (marker == 0xFF) marker = u8();
      if (marker < 0) break;
      if (marker == 0xD9) break;                            // EOI
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      int len = u16();
      if (len < 2 || pos + len - 2 > size) return FOD_JPEG_CORRUPT;
      int64_t next = pos + len - 2;
      int err = FOD_JPEG_OK;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
          marker != 0xCC) {
        err = read_sof(marker, len);
        if (err == FOD_JPEG_OK && header_only) return FOD_JPEG_OK;
      } else if (marker == 0xC4) {
        err = read_dht(len);
      } else if (marker == 0xCC) {
        err = FOD_JPEG_ARITHMETIC;
      } else if (marker == 0xDB) {
        err = read_dqt(len);
      } else if (marker == 0xDD) {
        restart_interval = u16();
      } else if (marker == 0xDA) {
        if (!saw_sof) return FOD_JPEG_CORRUPT;
        err = read_sos(len);
        if (err) return err;
        any_scan = true;
        continue;  // read_sos left pos at the next marker
      } else if (marker == 0xE0 && len >= 7) {
        jfif = data[pos] == 'J' && data[pos + 1] == 'F' && data[pos + 2] == 'I' &&
               data[pos + 3] == 'F' && data[pos + 4] == 0;
      } else if (marker == 0xEE && len >= 14) {
        if (std::memcmp(data + pos, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[pos + 11];
        }
      }
      if (err) return err;
      pos = next;
    }
    if (!saw_sof || (!header_only && !any_scan)) return FOD_JPEG_CORRUPT;
    for (int c = 0; c < ncomp && !header_only; c++)
      if (!qt_present[comp[c].tq]) return FOD_JPEG_CORRUPT;
    return FOD_JPEG_OK;
  }
};

// --- inverse DCT (jidctint.c jpeg_idct_islow) -------------------------------
const int kConstBits = 13, kPass1Bits = 2;
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t table[5 * 256 + 128];
  uint8_t* sample;  // sample_range_limit: [-256, 640)
  uint8_t* idct;    // sample + 128, indexed by (x & 1023)
  RangeLimit() {
    uint8_t* t = table + 256;
    sample = t;
    std::memset(t - 256, 0, 256);
    for (int i = 0; i < 256; i++) t[i] = static_cast<uint8_t>(i);
    t += 128;
    for (int i = 128; i < 512; i++) t[i] = 255;
    std::memset(t + 512, 0, 512 - 128);
    std::memcpy(t + 1024 - 128, sample, 128);
    idct = t;
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* range = kRange.idct;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (in[0] * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * qq[16], z3 = in[48] * qq[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = in[0] * qq[0];
    z3 = in[32] * qq[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qq[56];
    tmp1 = in[40] * qq[40];
    tmp2 = in[24] * qq[24];
    tmp3 = in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 = tmp0 * 2446;
    tmp1 = tmp1 * 16819;
    tmp2 = tmp2 * 25172;
    tmp3 = tmp3 * 12299;
    z1 = z1 * -7373;
    z2 = z2 * -20995;
    z3 = z3 * -16069;
    z4 = z4 * -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = range[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 = tmp0 * 2446;
    tmp1 = tmp1 * 16819;
    tmp2 = tmp2 * 25172;
    tmp3 = tmp3 * 12299;
    z1 = z1 * -7373;
    z2 = z2 * -20995;
    z3 = z3 * -16069;
    z4 = z4 * -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = range[static_cast<int>(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = range[static_cast<int>(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = range[static_cast<int>(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = range[static_cast<int>(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = range[static_cast<int>(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = range[static_cast<int>(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = range[static_cast<int>(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = range[static_cast<int>(descale(tmp13 - tmp0, n)) & 1023];
  }
}

// --- upsampling (jdsample.c) --------------------------------------------------
// One output row of a component upsampled to full width into `out` (width
// `width`): h2 doubles columns, and with v2 the row takes its vertical
// context from the nearer and the next-nearer input row.
void upsample_row(const Component& k, int out_row, int hmax, int vmax, int width,
                  uint8_t* out, std::vector<int>& colsum) {
  const int stride = k.blocks_per_row * 8;
  const int dw = k.downsampled_width, dh = k.downsampled_height;
  const bool h2 = hmax == 2 && k.h == 1, v2 = vmax == 2 && k.v == 1;
  const int in_row = v2 ? out_row / 2 : out_row;
  const uint8_t* in0 = k.pixels.data() + static_cast<size_t>(in_row) * stride;
  if (!h2) {  // 4:4:4 (v2 needs h2 here: 4:4:0 is refused)
    std::memcpy(out, in0, width);
    return;
  }
  const bool fancy = dw > 2;
  if (!v2) {
    if (!fancy) {
      for (int x = 0; x < width; x++) out[x] = in0[x / 2];
      return;
    }
    // h2v1_fancy_upsample
    std::vector<uint8_t> row(2 * dw);
    uint8_t* o = row.data();
    const uint8_t* in = in0;
    int inv = *in++;
    *o++ = static_cast<uint8_t>(inv);
    *o++ = static_cast<uint8_t>((inv * 3 + in[0] + 2) >> 2);
    for (int c = dw - 2; c > 0; c--) {
      inv = (*in++) * 3;
      *o++ = static_cast<uint8_t>((inv + in[-2] + 1) >> 2);
      *o++ = static_cast<uint8_t>((inv + in[0] + 2) >> 2);
    }
    inv = *in;
    *o++ = static_cast<uint8_t>((inv * 3 + in[-1] + 1) >> 2);
    *o++ = static_cast<uint8_t>(inv);
    std::memcpy(out, row.data(), width);
    return;
  }
  if (!fancy) {
    for (int x = 0; x < width; x++) out[x] = in0[x / 2];
    return;
  }
  // h2v2_fancy_upsample: the context row above for even output rows, below
  // for odd ones; rows outside the component replicate its edge rows
  int other = (out_row % 2 == 0) ? in_row - 1 : in_row + 1;
  if (other < 0) other = 0;
  if (other > dh - 1) other = dh - 1;
  const uint8_t* in1 = k.pixels.data() + static_cast<size_t>(other) * stride;
  colsum.resize(dw);
  for (int c = 0; c < dw; c++) colsum[c] = in0[c] * 3 + in1[c];
  std::vector<uint8_t> row(2 * dw);
  uint8_t* o = row.data();
  int thiscolsum = colsum[0], nextcolsum = colsum[1], lastcolsum;
  *o++ = static_cast<uint8_t>((thiscolsum * 4 + 8) >> 4);
  *o++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
  lastcolsum = thiscolsum;
  thiscolsum = nextcolsum;
  for (int c = 2; c < dw; c++) {
    nextcolsum = colsum[c];
    *o++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
    *o++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
    lastcolsum = thiscolsum;
    thiscolsum = nextcolsum;
  }
  *o++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
  *o++ = static_cast<uint8_t>((thiscolsum * 4 + 7) >> 4);
  std::memcpy(out, row.data(), width);
}

// --- colour conversion (jdcolor.c build_ycc_rgb_table) ------------------------
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int32_t half = int32_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

}  // namespace

extern "C" {

// (height, width, components) of a JPEG, or an FOD_JPEG_* error code.
int fod_jpeg_header(const uint8_t* data, int64_t size, int* height, int* width, int* ncomp) {
  Decoder d;
  d.data = data;
  d.size = size;
  int err = d.parse(true);
  if (err) return err;
  *height = d.height;
  *width = d.width;
  *ncomp = d.ncomp;
  return FOD_JPEG_OK;
}

// Decode into `out`, (height, width, 3) RGB uint8, as cv2.imread(IMREAD_COLOR)
// followed by BGR->RGB (a grayscale file gives three equal channels).
int fod_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int height, int width) {
  Decoder d;
  d.data = data;
  d.size = size;
  int err = d.parse(false);
  if (err) return err;
  if (d.height != height || d.width != width) return FOD_JPEG_CORRUPT;
  for (int c = 0; c < d.ncomp; c++) {
    Component& k = d.comp[c];
    const int stride = k.blocks_per_row * 8;
    k.pixels.assign(static_cast<size_t>(stride) * k.block_rows * 8, 0);
    const uint16_t* q = d.qt[k.tq];
    for (int by = 0; by < k.height_in_blocks; by++)
      for (int bx = 0; bx < k.width_in_blocks; bx++)
        idct_islow(d.block(k, by, bx), q, k.pixels.data() + (size_t(by) * 8) * stride + bx * 8,
                   stride);
  }
  std::vector<uint8_t> rows(3 * static_cast<size_t>(width));
  std::vector<int> colsum;
  const uint8_t* limit = kRange.sample;
  // RGB components (an Adobe marker with transform 0, or the ids 'R','G','B')
  // are not converted, as libjpeg's default colour space says
  bool rgb = d.ncomp == 3 && !d.jfif &&
             (d.adobe ? d.adobe_transform == 0
                      : d.comp[0].id == 'R' && d.comp[1].id == 'G' && d.comp[2].id == 'B');
  for (int y = 0; y < height; y++) {
    uint8_t* o = out + static_cast<size_t>(y) * width * 3;
    if (d.ncomp == 1) {
      const Component& k = d.comp[0];
      const uint8_t* in = k.pixels.data() + static_cast<size_t>(y) * k.blocks_per_row * 8;
      for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
      continue;
    }
    for (int c = 0; c < 3; c++)
      upsample_row(d.comp[c], y, d.hmax, d.vmax, width, rows.data() + c * width, colsum);
    const uint8_t *Y = rows.data(), *cb = rows.data() + width, *cr = rows.data() + 2 * width;
    if (rgb) {
      for (int x = 0; x < width; x++) {
        o[3 * x] = Y[x];
        o[3 * x + 1] = cb[x];
        o[3 * x + 2] = cr[x];
      }
      continue;
    }
    for (int x = 0; x < width; x++) {
      int yy = Y[x];
      o[3 * x] = limit[yy + kYcc.cr_r[cr[x]]];
      o[3 * x + 1] = limit[yy + static_cast<int>((kYcc.cb_g[cb[x]] + kYcc.cr_g[cr[x]]) >> 16)];
      o[3 * x + 2] = limit[yy + kYcc.cb_b[cb[x]]];
    }
  }
  return FOD_JPEG_OK;
}

}  // extern "C"

// --- cv2.resize(..., INTER_LINEAR) -------------------------------------------
namespace {

struct Axis {
  std::vector<int> ofs;      // first source index of each output index (fixed point)
  std::vector<int> ofs_f;    // the same for the float path
  std::vector<float> a0, a1; // float coefficients
  std::vector<int16_t> i0, i1;  // 11-bit fixed-point coefficients
  int border_from;           // x: output index from which the source is clamped
};

inline int16_t fixed(float v) {  // saturate_cast<short>(v * 2048), round half to even
  return static_cast<int16_t>(std::nearbyint(v * 2048.0f));
}

// resize.cpp's coefficient loops: x clamps the index and zeroes the weight at
// the borders; y keeps the weights and clamps the rows at fetch time.
Axis make_axis(int src, int dst, bool is_x) {
  Axis a;
  a.ofs.resize(dst);
  a.ofs_f.resize(dst);
  a.a0.resize(dst);
  a.a1.resize(dst);
  a.i0.resize(dst);
  a.i1.resize(dst);
  a.border_from = dst;
  const double scale = 1.0 / (static_cast<double>(dst) / src);
  for (int d = 0; d < dst; d++) {
    // the fixed-point path rounds the source coordinate to float first; the
    // float path keeps it in double (measured against cv2: float coordinates
    // leave it 2.4e-4 off, double ones 2.4e-7)
    const double exact = (d + 0.5) * scale - 0.5;
    float f = static_cast<float>(exact);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    int sd = static_cast<int>(std::floor(exact));
    double fd = exact - sd;
    if (is_x) {
      if (s < 0) f = 0, s = 0;
      if (sd < 0) fd = 0, sd = 0;
      if (s + 1 >= src) {
        if (a.border_from == dst) a.border_from = d;
        if (s >= src - 1) f = 0, s = src - 1;
      }
      if (sd >= src - 1) fd = 0, sd = src - 1;
    }
    a.ofs[d] = s;
    a.ofs_f[d] = sd;
    a.a0[d] = static_cast<float>(1.0 - fd);
    a.a1[d] = static_cast<float>(fd);
    a.i0[d] = fixed(1.f - f);
    a.i1[d] = fixed(f);
  }
  return a;
}

inline int clip_row(int r, int h) { return r < 0 ? 0 : (r >= h ? h - 1 : r); }

}  // namespace

extern "C" {

// src (sh, sw, cn) -> dst (dh, dw, cn), both contiguous uint8.
void fod_resize_linear_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh,
                          int dw) {
  if (sw == 2 * dw && sh == 2 * dh) {  // cv2 takes INTER_AREA's 2x2 mean here
    for (int y = 0; y < dh; y++)
      for (int x = 0; x < dw; x++)
        for (int c = 0; c < cn; c++) {
          const uint8_t* s = src + (static_cast<size_t>(2 * y) * sw + 2 * x) * cn + c;
          int sum = s[0] + s[cn] + s[sw * cn] + s[sw * cn + cn];
          dst[(static_cast<size_t>(y) * dw + x) * cn + c] = static_cast<uint8_t>((sum + 2) >> 2);
        }
    return;
  }
  Axis ax = make_axis(sw, dw, true), ay = make_axis(sh, dh, false);
  const int row = dw * cn;
  std::vector<int> h0(row), h1(row);
  auto hpass = [&](int sy, std::vector<int>& out) {
    const uint8_t* s = src + static_cast<size_t>(sy) * sw * cn;
    for (int x = 0; x < dw; x++)
      for (int c = 0; c < cn; c++) {
        int sx = ax.ofs[x] * cn + c;
        out[x * cn + c] = x < ax.border_from ? s[sx] * ax.i0[x] + s[sx + cn] * ax.i1[x]
                                             : s[sx] * 2048;
      }
  };
  int have0 = -1, have1 = -1;
  for (int y = 0; y < dh; y++) {
    int r0 = clip_row(ay.ofs[y], sh), r1 = clip_row(ay.ofs[y] + 1, sh);
    if (r0 == have1) {
      std::swap(h0, h1);
      have0 = have1;
      have1 = -1;
    }
    if (r0 != have0) hpass(r0, h0), have0 = r0;
    if (r1 != have1) hpass(r1, h1), have1 = r1;
    const int b0 = ay.i0[y], b1 = ay.i1[y];
    uint8_t* o = dst + static_cast<size_t>(y) * row;
    for (int x = 0; x < row; x++) {
      // VResizeLinearVec_32s8u: (S >> 4) * beta >> 16 per row, then a rounding
      // shift by 2
      int v = (((h0[x] >> 4) * b0) >> 16) + (((h1[x] >> 4) * b1) >> 16);
      v = (v + 2) >> 2;
      o[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// src (sh, sw, cn) -> dst (dh, dw, cn), both contiguous float32.
void fod_resize_linear_f32(const float* src, int sh, int sw, int cn, float* dst, int dh, int dw) {
  if (sw == 2 * dw && sh == 2 * dh) {
    for (int y = 0; y < dh; y++)
      for (int x = 0; x < dw; x++)
        for (int c = 0; c < cn; c++) {
          const float* s = src + (static_cast<size_t>(2 * y) * sw + 2 * x) * cn + c;
          float sum = 0.f;
          sum += s[0] + s[cn] + s[sw * cn] + s[sw * cn + cn];
          dst[(static_cast<size_t>(y) * dw + x) * cn + c] = sum * 0.25f;
        }
    return;
  }
  Axis ax = make_axis(sw, dw, true), ay = make_axis(sh, dh, false);
  const int row = dw * cn;
  std::vector<float> h0(row), h1(row);
  auto hpass = [&](int sy, std::vector<float>& out) {
    const float* s = src + static_cast<size_t>(sy) * sw * cn;
    for (int x = 0; x < dw; x++)
      for (int c = 0; c < cn; c++) {
        int sx = ax.ofs_f[x] * cn + c;
        out[x * cn + c] = ax.ofs_f[x] < sw - 1 ? s[sx] * ax.a0[x] + s[sx + cn] * ax.a1[x] : s[sx];
      }
  };
  int have0 = -1, have1 = -1;
  for (int y = 0; y < dh; y++) {
    int r0 = clip_row(ay.ofs_f[y], sh), r1 = clip_row(ay.ofs_f[y] + 1, sh);
    if (r0 == have1) {
      std::swap(h0, h1);
      have0 = have1;
      have1 = -1;
    }
    if (r0 != have0) hpass(r0, h0), have0 = r0;
    if (r1 != have1) hpass(r1, h1), have1 = r1;
    const float b0 = ay.a0[y], b1 = ay.a1[y];
    float* o = dst + static_cast<size_t>(y) * row;
    for (int x = 0; x < row; x++) o[x] = h0[x] * b0 + h1[x] * b1;
  }
}

}  // extern "C"

extern "C" {

// (x / 255 - mean[c]) / std[c] over n pixels of cn channels, float32, in the
// order and rounding of numpy's remap_and_normalize (one f32 op at a time).
void fod_normalize_u8(const uint8_t* src, int64_t n, int cn, const float* mean, const float* std,
                      float* dst) {
  for (int64_t i = 0; i < n; i++)
    for (int c = 0; c < cn; c++) {
      float x = static_cast<float>(src[i * cn + c]) / 255.0f;
      dst[i * cn + c] = (x - mean[c]) / std[c];
    }
}

}  // extern "C"
