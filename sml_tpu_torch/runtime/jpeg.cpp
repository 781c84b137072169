// The entropy stage of the port's baseline JPEG decoder: markers and Huffman
// decoding into 8x8 blocks of int16 coefficients, on a pool of host threads.
//
// The pixel stage (dequantisation, the ISLOW inverse DCT, chroma upsampling and
// the YCbCr -> RGB conversion, as libjpeg-turbo's default decode path computes
// them) runs on the card in sml_tpu_torch/csrc/jpeg_pixels.cu, or in its plain
// PyTorch version (sml_tpu_torch/ops/kernels/jpeg.py) on the CPU; only the
// coefficients cross to the card.  sml_tpu_torch/data/jpeg.py drives both.
//
// What it reads: SOI; APPn and COM (skipped; APP0 "JFIF" and APP14 "Adobe" are
// noted for the colour space); DQT with 8- and 16-bit entries; SOF0 and SOF1 at
// 8 bits; DHT; DRI and RST0-7; one SOS holding every component; EOI.  Byte
// stuffing (FF 00), fill bytes before a marker, extend() of signed values, EOB
// and ZRL, and the DC predictions reset at every restart marker.  Huffman codes
// of up to LOOKAHEAD bits are read through a table, as libjpeg's jdhuff.c does.
//
// What it refuses, by name: progressive (SOF2), lossless (SOF3), hierarchical
// (SOF5-7), arithmetic coding (SOF9-11, SOF13-15, DAC), precision other than 8
// bits, 2 or 4 components, an RGB colour space (Adobe transform 0, or component
// ids 'R' 'G' 'B'), a scan that holds fewer components than the frame (a
// multi-scan file), luma sampling other than 1x1, 2x1, 1x2 or 2x2, chroma
// sampling other than 1x1, a bad Huffman code, a missing restart marker, and
// entropy data that ends before its last block (a truncated file).
//
// Exposed C ABI (every function returns 0, or 1 + the index of the first file,
// in list order, that failed, with its message in err):
//   jpg_header_ints()                          -> ints of one file's header
//   jpg_read_headers(n, paths, threads, hdr, err, err_len)
//       fills hdr[n][HDR_INTS]: width, height, components, hmax, vmax, restart
//       interval, coefficients, 0; per component h, v, blocks across, blocks
//       down; per component its 64 quantisation values in natural order
//   jpg_decode(n, paths, threads, hdr, offsets, coef, err, err_len)
//       decodes file i into coef + offsets[i]: each component's blocks in
//       raster order, 64 coefficients each in natural (de-zigzagged) order;
//       the file must still have the header hdr[i]
//
// Build: g++ -O2 -shared -fPIC -pthread jpeg.cpp -o libjpeg.so
// (sml_tpu_torch/runtime/__init__.py builds it at first use)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kLookahead = 9;             // bits of the Huffman lookup table
constexpr int kMaxComps = 3;
// header layout, in int32
constexpr int kWidth = 0, kHeight = 1, kComps = 2, kHmax = 3, kVmax = 4, kRestart = 5,
              kCoefs = 6, kComp = 8, kQuant = 20, kHeaderInts = kQuant + 64 * kMaxComps;

// zigzag position -> natural position, with 16 extra entries so that a run past
// the end of a block lands on position 63, as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Fail {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Fail{what}; }

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookahead];      // 0: the code is longer than kLookahead
  uint8_t look_sym[1 << kLookahead];
  int32_t maxcode[18];                    // largest code of each length, -1 if none
  int32_t valoffset[18];                  // symbol index = code + valoffset[length]
  uint8_t symbols[256];

  void build(const uint8_t* counts, const uint8_t* vals, int nvals) {
    std::memcpy(symbols, vals, nvals);
    std::memset(look_len, 0, sizeof look_len);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      int n = counts[len - 1];
      if (n == 0) {
        maxcode[len] = -1;
      } else {
        valoffset[len] = k - code;
        for (int i = 0; i < n; ++i, ++code, ++k) {
          if (len <= kLookahead) {
            int shift = kLookahead - len;
            for (int fill = 0; fill < (1 << shift); ++fill) {
              look_len[(code << shift) | fill] = (uint8_t)len;
              look_sym[(code << shift) | fill] = vals[k];
            }
          }
        }
        maxcode[len] = code - 1;
      }
      if (code > (1 << len)) fail("bad Huffman table (more codes than its lengths allow)");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;             // ends the slow path's search
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;                     // blocks across and down in the coefficients
  int td = 0, ta = 0;                     // Huffman tables of the scan
  int64_t offset = 0;                     // first coefficient of this component
};

// Bits of the entropy-coded segment, most significant first.  The buffer holds
// `bits` real bits; at a marker or the end of the data it stops taking bytes,
// and a read that needs more real bits than are left fails.
struct Bits {
  Bits(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}

  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool stopped = false;

  void fill() {
    while (bits <= 56 && !stopped) {
      if (p >= end) { stopped = true; break; }
      uint8_t b = *p;
      if (b == 0xFF) {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) ++q;          // fill bytes
        if (q >= end) { stopped = true; break; }
        if (*q != 0x00) { p = q - 1; stopped = true; break; }   // a marker
        p = q + 1;                                  // FF 00: a data byte FF
      } else {
        ++p;
      }
      buf |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }

  int get(int n) {                                  // n in 1..16
    if (bits < n) fill();
    if (bits < n) fail("entropy data ends early (truncated file?)");
    int v = (int)(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }

  int decode(const Huffman& t) {
    if (bits < 16) fill();
    int look = (int)(buf >> (64 - kLookahead));
    int len = t.look_len[look];
    int sym;
    if (len) {
      sym = t.look_sym[look];
    } else {
      len = kLookahead + 1;
      int code = (int)(buf >> (64 - len));
      while (code > t.maxcode[len]) {
        ++len;
        code = (int)(buf >> (64 - len));
      }
      if (len > 16) fail("bad Huffman code");
      sym = t.symbols[code + t.valoffset[len]];
    }
    if (len > bits) fail("entropy data ends early (truncated file?)");
    buf <<= len;
    bits -= len;
    return sym;
  }

  // at a restart: drop the padding bits and read the marker RSTn
  void restart(int n) {
    buf = 0;
    bits = 0;
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) fail("entropy data ends early (truncated file?)");
    if (*p != 0xD0 + n)
      fail("expected restart marker RST" + std::to_string(n) + ", found marker " +
           std::to_string(*p));
    ++p;
    stopped = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Parser {
  Parser(const uint8_t* d, size_t n) : data(d), size(n) {}

  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, restart = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  Component comp[kMaxComps];
  int scan[kMaxComps] = {0, 0, 0};                              // scan order -> frame component
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  int u8() {
    if (pos >= size) fail("file ends inside a marker segment (truncated file?)");
    return data[pos++];
  }
  int u16() { int hi = u8(); return (hi << 8) | u8(); }

  int next_marker() {
    // markers may be preceded by any number of fill bytes 0xFF
    if (u8() != 0xFF) fail("expected a marker");
    int m;
    do { m = u8(); } while (m == 0xFF);
    return m;
  }

  void segment_end(size_t start, int len) {
    if (pos != start + (size_t)len) fail("marker segment of the wrong length");
  }

  void read_dqt() {
    size_t start = pos;
    int len = u16();
    while (pos < start + (size_t)len) {
      int pq_tq = u8(), pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT segment");
      for (int k = 0; k < 64; ++k)
        quant[tq][kNatural[k]] = (uint16_t)(pq ? u16() : u8());
      quant_defined[tq] = true;
    }
    segment_end(start, len);
  }

  void read_dht() {
    size_t start = pos;
    int len = u16();
    while (pos < start + (size_t)len) {
      int tc_th = u8(), tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT segment");
      uint8_t counts[16], vals[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) { counts[i] = (uint8_t)u8(); total += counts[i]; }
      if (total > 256) fail("bad DHT segment");
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)u8();
      (tc ? ac[th] : dc[th]).build(counts, vals, total);
    }
    segment_end(start, len);
  }

  void read_app(int marker) {
    size_t start = pos;
    int len = u16();
    if (len < 2 || start + (size_t)len > size) fail("marker segment runs past the file");
    const uint8_t* body = data + start + 2;
    size_t n = (size_t)len - 2;
    if (marker == 0xE0 && n >= 5 && std::memcmp(body, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = body[11];
    }
    pos = start + (size_t)len;
  }

  void read_sof(int marker) {
    if (frame) fail("a second frame header");
    size_t start = pos;
    int len = u16();
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit precision JPEG (SOF" +
           std::to_string(marker - 0xC0) + ") is not supported");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail("height defined by a DNL marker is not supported");
    if (width == 0) fail("zero image width");
    if (ncomp == 4) fail("4-component JPEG (CMYK or YCCK) is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG is not supported");
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = u8();
      int hv = u8();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = u8();
      if (comp[c].tq > 3 || comp[c].h < 1 || comp[c].v < 1) fail("bad frame header");
    }
    segment_end(start, len);
    if (ncomp == 1) {
      comp[0].h = comp[0].v = 1;     // a lone component is never subsampled
    } else {
      bool luma = comp[0].h <= 2 && comp[0].v <= 2;
      bool chroma = comp[1].h == 1 && comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1;
      if (!luma || !chroma)
        fail("sampling factors " + std::to_string(comp[0].h) + "x" + std::to_string(comp[0].v) +
             ", " + std::to_string(comp[1].h) + "x" + std::to_string(comp[1].v) + ", " +
             std::to_string(comp[2].h) + "x" + std::to_string(comp[2].v) +
             " are not supported (luma 1x1, 2x1, 1x2 or 2x2 with 1x1 chroma)");
    }
    hmax = comp[0].h;
    vmax = comp[0].v;
    int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    int64_t offset = 0;
    for (int c = 0; c < ncomp; ++c) {
      if (ncomp == 1) {
        comp[c].bw = (width + 7) / 8;
        comp[c].bh = (height + 7) / 8;
      } else {
        comp[c].bw = mcux * comp[c].h;
        comp[c].bh = mcuy * comp[c].v;
      }
      comp[c].offset = offset;
      offset += (int64_t)comp[c].bw * comp[c].bh * 64;
    }
    frame = true;
  }

  void check_colour_space() {
    if (ncomp != 3) return;
    bool rgb;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    if (rgb)
      fail(adobe && !jfif ? "Adobe transform 0 (RGB colour space) is not supported"
                          : "RGB colour space (component ids R, G, B) is not supported");
  }

  void read_sos() {
    if (!frame) fail("scan before the frame header");
    size_t start = pos;
    int len = u16();
    int ns = u8();
    if (ns != ncomp)
      fail("multi-scan JPEG (a scan of " + std::to_string(ns) + " of " +
           std::to_string(ncomp) + " components) is not supported");
    bool seen[kMaxComps] = {false, false, false};
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      int c = 0;
      while (c < ncomp && comp[c].id != id) ++c;
      if (c == ncomp || seen[c]) fail("scan names an unknown or repeated component");
      seen[c] = true;
      scan[i] = c;
      comp[c].td = t >> 4;
      comp[c].ta = t & 15;
      if (comp[c].td > 3 || comp[c].ta > 3) fail("bad scan header");
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("scan is not a baseline sequential scan");
    segment_end(start, len);
    for (int c = 0; c < ncomp; ++c)
      if (!quant_defined[comp[c].tq]) fail("quantisation table not defined");
    check_colour_space();
  }

  // markers up to and including the SOS
  void headers() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1) read_sof(m);
      else if (m == 0xC2) fail("progressive JPEG (SOF2) is not supported");
      else if (m == 0xC3) fail("lossless JPEG (SOF3) is not supported");
      else if (m >= 0xC5 && m <= 0xC7)
        fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
      else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF))
        fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
      else if (m == 0xCC) fail("arithmetic-coded JPEG (DAC) is not supported");
      else if (m == 0xC4) read_dht();
      else if (m == 0xDB) read_dqt();
      else if (m == 0xDD) {
        size_t start = pos;
        int len = u16();
        restart = u16();
        segment_end(start, len);
      } else if (m == 0xDA) { read_sos(); return; }
      else if (m == 0xD9) fail("EOI before any scan");
      else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) read_app(m);
      else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // markers without a segment: ignored, as libjpeg ignores a stray one
      } else if (m == 0xDC) fail("DNL marker is not supported");
      else read_app(m);           // any other segment is skipped by its length
    }
  }

  void header_ints(int32_t* h) const {
    std::memset(h, 0, sizeof(int32_t) * kHeaderInts);
    h[kWidth] = width;
    h[kHeight] = height;
    h[kComps] = ncomp;
    h[kHmax] = hmax;
    h[kVmax] = vmax;
    h[kRestart] = restart;
    int64_t coefs = 0;
    for (int c = 0; c < ncomp; ++c) {
      h[kComp + 4 * c + 0] = comp[c].h;
      h[kComp + 4 * c + 1] = comp[c].v;
      h[kComp + 4 * c + 2] = comp[c].bw;
      h[kComp + 4 * c + 3] = comp[c].bh;
      for (int k = 0; k < 64; ++k) h[kQuant + 64 * c + k] = quant[comp[c].tq][k];
      coefs += (int64_t)comp[c].bw * comp[c].bh * 64;
    }
    if (coefs > INT32_MAX) fail("image too large");
    h[kCoefs] = (int32_t)coefs;
  }

  void block(Bits& br, const Component& c, int* pred, int16_t* out) {
    const Huffman& dct = dc[c.td];
    const Huffman& act = ac[c.ta];
    int s = br.decode(dct);
    if (s > 15) fail("bad DC difference size");
    int diff = s ? extend(br.get(s), s) : 0;
    *pred += diff;
    out[0] = (int16_t)*pred;
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        out[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;              // EOB
        k += 15;                         // ZRL
      }
    }
  }

  // the entropy-coded data of the scan into coef (zeroed here)
  void scan_data(int16_t* coef) {
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[scan[i]];
      if (!dc[c.td].defined || !ac[c.ta].defined) fail("Huffman table not defined");
    }
    int64_t total = 0;
    for (int c = 0; c < ncomp; ++c) total += (int64_t)comp[c].bw * comp[c].bh * 64;
    std::memset(coef, 0, sizeof(int16_t) * total);
    Bits br(data + pos, data + size);
    int pred[kMaxComps] = {0, 0, 0};
    int mcux, mcuy;
    if (ncomp == 1) { mcux = comp[0].bw; mcuy = comp[0].bh; }
    else { mcux = comp[0].bw / comp[0].h; mcuy = comp[0].bh / comp[0].v; }
    int64_t mcus = (int64_t)mcux * mcuy;
    int rst = 0;
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart && m && m % restart == 0) {
        br.restart(rst);
        rst = (rst + 1) & 7;
        pred[0] = pred[1] = pred[2] = 0;
      }
      int my = (int)(m / mcux), mx = (int)(m % mcux);
      for (int i = 0; i < ncomp; ++i) {
        const Component& c = comp[scan[i]];
        int16_t* base = coef + c.offset;
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h) {
            int by = my * c.v + v, bx = mx * c.h + h;
            block(br, c, &pred[scan[i]], base + ((int64_t)by * c.bw + bx) * 64);
          }
      }
    }
    // what follows the scan: EOI, or the end of the data (libjpeg supplies a
    // missing EOI); a second scan is refused
    const uint8_t* p = br.p;
    while (p < data + size && *p != 0xFF) ++p;
    while (p + 1 < data + size && p[1] == 0xFF) ++p;
    if (p + 1 < data + size) {
      int m = p[1];
      if (m == 0xDA) fail("multi-scan JPEG (a second scan) is not supported");
      if (m == 0xDC) fail("DNL marker is not supported");
    }
  }
};

bool read_file(const char* path, std::vector<uint8_t>& out, std::string& err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { err = "cannot open the file"; return false; }
  out.clear();
  uint8_t chunk[65536];
  size_t n;
  while ((n = std::fread(chunk, 1, sizeof chunk, f)) > 0) out.insert(out.end(), chunk, chunk + n);
  bool bad = std::ferror(f);
  std::fclose(f);
  if (bad) { err = "read error"; return false; }
  return true;
}

// runs job(i, bytes) for every file on `threads` threads; returns 1 + the first
// failing index (by list order) with its message in err, or 0
template <class Job>
int for_each_file(int n, const char* const* paths, int threads, char* err, int err_len,
                  Job job) {
  std::vector<std::string> errors(n);
  std::vector<char> failed(n, 0);
  std::atomic<int> next{0};
  auto worker = [&] {
    std::vector<uint8_t> bytes;
    for (int i = next++; i < n; i = next++) {
      std::string e;
      if (!read_file(paths[i], bytes, e)) {
        errors[i] = e;
        failed[i] = 1;
        continue;
      }
      try {
        job(i, bytes);
      } catch (const Fail& f) {
        errors[i] = f.what;
        failed[i] = 1;
      } catch (const std::exception& ex) {
        errors[i] = ex.what();
        failed[i] = 1;
      }
    }
  };
  threads = std::max(1, std::min(threads, n));
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  for (int i = 0; i < n; ++i)
    if (failed[i]) {
      if (err_len > 0) {
        std::strncpy(err, errors[i].c_str(), (size_t)err_len - 1);
        err[err_len - 1] = 0;
      }
      return i + 1;
    }
  return 0;
}

}  // namespace

extern "C" {

int jpg_header_ints() { return kHeaderInts; }

int jpg_read_headers(int n, const char* const* paths, int threads, int32_t* hdr, char* err,
                     int err_len) {
  return for_each_file(n, paths, threads, err, err_len,
                       [&](int i, const std::vector<uint8_t>& bytes) {
                         Parser p(bytes.data(), bytes.size());
                         p.headers();
                         p.header_ints(hdr + (int64_t)i * kHeaderInts);
                       });
}

int jpg_decode(int n, const char* const* paths, int threads, const int32_t* hdr,
               const int64_t* offsets, int16_t* coef, char* err, int err_len) {
  return for_each_file(n, paths, threads, err, err_len,
                       [&](int i, const std::vector<uint8_t>& bytes) {
                         Parser p(bytes.data(), bytes.size());
                         p.headers();
                         int32_t now[kHeaderInts];
                         p.header_ints(now);
                         if (std::memcmp(now, hdr + (int64_t)i * kHeaderInts, sizeof now) != 0)
                           fail("the file changed between reading its header and decoding it");
                         p.scan_data(coef + offsets[i]);
                       });
}

}  // extern "C"
