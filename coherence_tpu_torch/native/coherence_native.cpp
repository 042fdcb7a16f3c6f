// Native host library of coherence_tpu_torch: the port's copy of the six
// entry-point families of coherence_tpu/native/coherence_native.cpp that
// the port calls (blit_masked_rgb, bezier_subdivide_batch, edge_spans_*,
// expand_1x_*, expand_aa_*, jbig2_generic_region): the last five
// unchanged, the blit taking its sprite as one uint8 plane; and the port's
// own brush_stroke_table and brush_strip_lists, the host lists of the
// brush_stamp kernel, and sprite_band_spans, those of the sprite_raster
// kernel.
//
// The bezier subdivision and the scanline sweep are the per-scene host
// geometry stage (polygon.ml:107-127 subdivision, polygon.ml:306-512 sweep):
// pure float64/int64 transcriptions of the NumPy formulations in the JAX
// package's geometry/path.py and raster/scanline.py, bit-identical by
// construction.  They MUST be compiled with -ffp-contract=off: an FMA
// contraction of a*b+c changes double rounding against NumPy.
//
// Exposed with a plain C ABI for ctypes; built by native_lib.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <array>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Masked RGB blit (gui/window.py plot_sprite; wxgui.ml:370-424): fb (FH, FW,
// 3) u8 target; src (h, w, 4) u8 holds r, g, b and, in its fourth channel,
// the mask.  Writes src rgb where the mask is set, at (ox, oy), clipped.
// The JAX package's entry point takes (h, w, 4) i32 colours and a separate
// u8 mask; here a sprite comes off the device in one copy as one u8 plane.
// ---------------------------------------------------------------------------

void blit_masked_rgb(uint8_t* fb, int32_t FH, int32_t FW, const uint8_t* src,
                     int32_t h, int32_t w, int32_t oy, int32_t ox) {
  int32_t y_lo = std::max(0, -oy), y_hi = std::min(h, FH - oy);
  int32_t x_lo = std::max(0, -ox), x_hi = std::min(w, FW - ox);
  for (int32_t y = y_lo; y < y_hi; ++y) {
    uint8_t* frow = fb + ((int64_t)(oy + y) * FW + ox) * 3;
    const uint8_t* srow = src + (int64_t)y * w * 4;
    for (int32_t x = x_lo; x < x_hi; ++x) {
      if (srow[x * 4 + 3]) {
        frow[x * 3] = srow[x * 4];
        frow[x * 3 + 1] = srow[x * 4 + 1];
        frow[x * 3 + 2] = srow[x * 4 + 2];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Bezier subdivision (geometry/path.py bezier_subdivide; polygon.ml:107-127).
// ctrl: (n, 8) float64 control points [x1 y1 x2 y2 x3 y3 x4 y4]; out:
// (cap, 4) float64 chords [ax ay bx by] in DFS left-to-right order; counts:
// (n,) chords per bezier.  Returns the TOTAL chord count — callers re-call
// with a larger `out` when it exceeds cap (only the first cap chords are
// written).  Float semantics match CPython exactly: ** 2 is pow (correctly
// rounded on glibc), midpoints are (a + b) / 2, the flatness predicate
// treats nan/inf/zero/subnormal distances as flat.
// ---------------------------------------------------------------------------

static inline double dist_point_line(double cx, double cy, double ax, double ay,
                                     double bx, double by) {
  double l = std::sqrt(std::pow(bx - ax, 2.0) + std::pow(by - ay, 2.0));
  if (l == 0.0 || !std::isfinite(l)) return NAN;
  double s = ((ay - cy) * (bx - ax) - (ax - cx) * (by - ay)) / (l * l);
  return std::fabs(s) * l;
}

static inline bool dist_normal(double d) {
  return std::isfinite(d) && d != 0.0 && std::fabs(d) >= 2.2250738585072014e-308;
}

int64_t bezier_subdivide_batch(const double* ctrl, int64_t n, double eps,
                               double* out, int64_t cap, int64_t* counts) {
  std::vector<std::array<double, 8>> stack;
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double* c = ctrl + 8 * i;
    int64_t cnt = 0;
    stack.clear();
    stack.push_back({c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]});
    while (!stack.empty()) {
      std::array<double, 8> q = stack.back();
      stack.pop_back();
      double ax = q[0], ay = q[1], bx = q[2], by = q[3];
      double cx = q[4], cy = q[5], dx = q[6], dy = q[7];
      double d1 = dist_point_line(bx, by, ax, ay, dx, dy);
      double d2 = dist_point_line(cx, cy, ax, ay, dx, dy);
      bool flat = (dist_normal(d1) && dist_normal(d2)) ? (d1 < eps && d2 < eps)
                                                       : true;
      if (flat) {
        if (total < cap) {
          out[4 * total] = ax;
          out[4 * total + 1] = ay;
          out[4 * total + 2] = dx;
          out[4 * total + 3] = dy;
        }
        ++total;
        ++cnt;
      } else {
        double l2x = (ax + bx) / 2.0, l2y = (ay + by) / 2.0;
        double hx = (bx + cx) / 2.0, hy = (by + cy) / 2.0;
        double l3x = (l2x + hx) / 2.0, l3y = (l2y + hy) / 2.0;
        double r3x = (cx + dx) / 2.0, r3y = (cy + dy) / 2.0;
        double r2x = (hx + r3x) / 2.0, r2y = (hy + r3y) / 2.0;
        double l4x = (l3x + r2x) / 2.0, l4y = (l3y + r2y) / 2.0;
        // Right pushed first so the left half pops first (in-order chords).
        stack.push_back({l4x, l4y, r2x, r2y, r3x, r3y, dx, dy});
        stack.push_back({ax, ay, l2x, l2y, l3x, l3y, l4x, l4y});
      }
    }
    counts[i] = cnt;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Scanline sweep (raster/scanline.py _edge_spans; polygon.ml:306-512).
// Edges are (n, 4) int64 subbin [x0, y0, x1, y1]; pixel row y covers
// subbins [32y-47 .. 32y+16].  Two-call protocol: edge_spans_count returns
// the exact coverage-span count T (one span per active (edge, row) pair
// after the row clip); edge_spans_fill writes the coverage spans (cov_*,
// capacity T) and the winding crossing spans (cross_*, capacity 2T is
// always sufficient: each family emits < its crossing count <= T), in the
// EXACT array order of the NumPy formulation (edge-major coverage; top
// crossings sorted by (row, x) stable then bottom ones).
// ---------------------------------------------------------------------------

static inline int64_t floordiv64(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// Pixel bin of subbin n: trunc-toward-zero of (n + 31) / 32 (coord.ml:44).
static inline int64_t pix_of_sub64(int64_t nn) { return (nn + 31) / 32; }

int64_t edge_spans_count(const int64_t* edges, int64_t n,
                         int64_t clip_lo, int64_t clip_hi) {
  int64_t T = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t ey0 = edges[4 * i + 1], ey1 = edges[4 * i + 3];
    int64_t ymin = std::min(ey0, ey1), ymax = std::max(ey0, ey1);
    int64_t ylo = std::max(-floordiv64(-(ymin - 16), 32), clip_lo);
    int64_t yhi = std::min(floordiv64(ymax + 47, 32), clip_hi);
    if (yhi >= ylo) T += yhi - ylo + 1;
  }
  return T;
}

struct CrossPt {
  int64_t r, x;
  int32_t d;
};

static int64_t emit_crossing_spans(std::vector<CrossPt>& v, int32_t nonzero,
                                   int64_t ext, int64_t* rows, int64_t* s,
                                   int64_t* e, int64_t off) {
  std::stable_sort(v.begin(), v.end(), [](const CrossPt& a, const CrossPt& b) {
    return a.r != b.r ? a.r < b.r : a.x < b.x;
  });
  int64_t m = 0, wind = 0, idx_in_row = 0;
  for (size_t i = 0; i < v.size(); ++i) {
    if (i == 0 || v[i].r != v[i - 1].r) {
      wind = 0;
      idx_in_row = 0;
    }
    wind += v[i].d;
    bool same_next = (i + 1 < v.size()) && v[i + 1].r == v[i].r;
    bool emit = nonzero ? (same_next && wind != 0)
                        : (same_next && (idx_in_row % 2 == 0));
    if (emit) {
      rows[off + m] = v[i].r;
      s[off + m] = pix_of_sub64(v[i].x - ext);
      e[off + m] = pix_of_sub64(v[i + 1].x + ext);
      ++m;
    }
    ++idx_in_row;
  }
  return m;
}

void edge_spans_fill(const int64_t* edges, int64_t n, int32_t nonzero,
                     int64_t crossing_ext, int64_t clip_lo, int64_t clip_hi,
                     int64_t* cov_rows, int64_t* cov_s, int64_t* cov_e,
                     int64_t* cross_rows, int64_t* cross_s, int64_t* cross_e,
                     int64_t* out_counts) {
  std::vector<CrossPt> tops, bots;
  int64_t ncov = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t ex0 = edges[4 * i], ey0 = edges[4 * i + 1];
    int64_t ex1 = edges[4 * i + 2], ey1 = edges[4 * i + 3];
    int64_t ymin = std::min(ey0, ey1), ymax = std::max(ey0, ey1);
    bool up = ey1 > ey0, down = ey0 > ey1;
    int64_t x0in = down ? ex1 : (up ? ex0 : std::min(ex0, ex1));
    int64_t x1in = down ? ex0 : (up ? ex1 : std::max(ex0, ex1));
    int32_t dir = up ? 1 : -1;
    double denom = (double)(ymax - ymin);
    double grad = denom == 0.0 ? 0.0 : (double)(x1in - x0in) / denom;
    int64_t ylo = std::max(-floordiv64(-(ymin - 16), 32), clip_lo);
    int64_t yhi = std::min(floordiv64(ymax + 47, 32), clip_hi);
    for (int64_t row = ylo; row <= yhi; ++row) {
      int64_t top = 32 * row - 47;
      int64_t bot = top + 63;
      bool has_top = ymin < top;
      bool has_bot = ymax > bot;
      int64_t x_t = 0, x_b = 0;
      if (has_top) {
        x_t = (int64_t)std::trunc(
            (double)x0in + grad * ((double)(top - 1 - ymin) + 0.25) + 0.5);
        tops.push_back({row, x_t, dir});
      }
      if (has_bot) {
        // Top-and-bottom clipped edges compound the already-rounded top
        // crossing (polygon.ml:365-385); (2*32 - 1) + 0.25 == 63.25.
        x_b = has_top
                  ? (int64_t)std::trunc((double)x_t + grad * 63.25 + 0.5)
                  : (int64_t)std::trunc(
                        (double)x0in + grad * ((double)(bot - ymin) + 0.25) + 0.5);
        bots.push_back({row, x_b, dir});
      }
      int64_t a = has_top ? x_t : x0in;
      int64_t b = has_bot ? x_b : x1in;
      cov_rows[ncov] = row;
      cov_s[ncov] = pix_of_sub64(std::min(a, b) - 16);
      cov_e[ncov] = pix_of_sub64(std::max(a, b) + 16);
      ++ncov;
    }
  }
  int64_t m = emit_crossing_spans(tops, nonzero, crossing_ext, cross_rows,
                                  cross_s, cross_e, 0);
  m += emit_crossing_spans(bots, nonzero, crossing_ext, cross_rows, cross_s,
                           cross_e, m);
  out_counts[0] = ncov;
  out_counts[1] = m;
}

// ---------------------------------------------------------------------------
// Tile assignment of pixel spans (raster/tile_raster._expand_1x/_expand_aa
// + _group_slices), fused: expand each span to the tiles it overlaps and
// bucket-sort the expansions by tile id STABLY (the per-tile entry order
// matches NumPy's stable argsort of the expansion order, so staged span
// arrays are bit-identical).  Two-call protocol: *_count returns the total
// expansion count; *_grouped fills caller buffers of that capacity plus a
// (n_tiles, 3) group table [tile, lo, hi] and returns the group count.
// ---------------------------------------------------------------------------

int64_t expand_1x_count(const int64_t* rows, const int64_t* ss,
                        const int64_t* ee, int64_t T, int64_t nty,
                        int64_t ntx, int64_t tile_h, int64_t tile_w) {
  int64_t total = 0;
  for (int64_t i = 0; i < T; ++i) {
    int64_t band = floordiv64(rows[i] - 1, tile_h);
    if (band < 0 || band >= nty || ee[i] < 1) continue;
    int64_t lo = std::max(floordiv64(ss[i] - 1, tile_w), (int64_t)0);
    int64_t hi = std::min(floordiv64(ee[i] - 1, tile_w), ntx - 1);
    if (hi >= lo) total += hi - lo + 1;
  }
  return total;
}

int64_t expand_1x_grouped(const int64_t* rows, const int64_t* ss,
                          const int64_t* ee, int64_t T, int64_t nty,
                          int64_t ntx, int64_t tile_h, int64_t tile_w,
                          int64_t* out_r, int64_t* out_s, int64_t* out_e,
                          int64_t* groups, int64_t* n_groups) {
  const int64_t n_tiles = nty * ntx;
  std::vector<int64_t> counts((size_t)n_tiles, 0);
  for (int64_t i = 0; i < T; ++i) {
    int64_t band = floordiv64(rows[i] - 1, tile_h);
    if (band < 0 || band >= nty || ee[i] < 1) continue;
    int64_t lo = std::max(floordiv64(ss[i] - 1, tile_w), (int64_t)0);
    int64_t hi = std::min(floordiv64(ee[i] - 1, tile_w), ntx - 1);
    for (int64_t tx = lo; tx <= hi; ++tx) ++counts[(size_t)(band * ntx + tx)];
  }
  std::vector<int64_t> offs((size_t)n_tiles, 0);
  int64_t total = 0, ng = 0;
  for (int64_t t = 0; t < n_tiles; ++t) {
    offs[(size_t)t] = total;
    if (counts[(size_t)t]) {
      groups[3 * ng] = t;
      groups[3 * ng + 1] = total;
      groups[3 * ng + 2] = total + counts[(size_t)t];
      ++ng;
    }
    total += counts[(size_t)t];
  }
  for (int64_t i = 0; i < T; ++i) {
    int64_t band = floordiv64(rows[i] - 1, tile_h);
    if (band < 0 || band >= nty || ee[i] < 1) continue;
    int64_t lo = std::max(floordiv64(ss[i] - 1, tile_w), (int64_t)0);
    int64_t hi = std::min(floordiv64(ee[i] - 1, tile_w), ntx - 1);
    int64_t r_rel = rows[i] - (band * tile_h + 1);
    for (int64_t tx = lo; tx <= hi; ++tx) {
      int64_t col0 = tx * tile_w + 1;
      int64_t& o = offs[(size_t)(band * ntx + tx)];
      out_r[o] = r_rel;
      out_s[o] = std::max(ss[i] - col0, (int64_t)0);
      out_e[o] = std::min(ee[i] - col0, tile_w - 1);
      ++o;
    }
  }
  *n_groups = ng;
  return total;
}

// AA expansion: scaled spans to edge-tile t-plane windows (rows
// [hstep*ty - hpad, hstep*ty + hstep - 1], cols [wstep*tx - hpad,
// wstep*tx + wstep - 1]); candidate bands cand = 0 then 1, matching the
// NumPy concatenation order.  edge_tiles: (nty*ntx,) u8 filter.
static inline bool aa_row_tile(int64_t row, int64_t cand, int64_t nty,
                               int64_t hstep, int64_t hpad, int64_t* ty) {
  int64_t t = floordiv64(row + hpad, hstep) - cand;
  *ty = t;
  return t >= 0 && t < nty && hstep * t - hpad <= row &&
         row <= hstep * t + hstep - 1;
}

int64_t expand_aa_count(const int64_t* rows, const int64_t* ss,
                        const int64_t* ee, int64_t T, int64_t nty,
                        int64_t ntx, int64_t hstep, int64_t wstep,
                        int64_t hpad, const uint8_t* edge_tiles) {
  int64_t total = 0;
  for (int64_t cand = 0; cand < 2; ++cand) {
    for (int64_t i = 0; i < T; ++i) {
      int64_t ty;
      if (!aa_row_tile(rows[i], cand, nty, hstep, hpad, &ty)) continue;
      int64_t lo = std::max(-floordiv64(-(ss[i] - (wstep - 1)), wstep),
                            (int64_t)0);
      int64_t hi = std::min(floordiv64(ee[i] + hpad, wstep), ntx - 1);
      for (int64_t tx = lo; tx <= hi; ++tx)
        if (edge_tiles[ty * ntx + tx]) ++total;
    }
  }
  return total;
}

int64_t expand_aa_grouped(const int64_t* rows, const int64_t* ss,
                          const int64_t* ee, int64_t T, int64_t nty,
                          int64_t ntx, int64_t hstep, int64_t wstep,
                          int64_t hpad, int64_t ttw, const uint8_t* edge_tiles,
                          int64_t* out_r, int64_t* out_s, int64_t* out_e,
                          int64_t* groups, int64_t* n_groups) {
  const int64_t n_tiles = nty * ntx;
  std::vector<int64_t> counts((size_t)n_tiles, 0);
  for (int64_t cand = 0; cand < 2; ++cand) {
    for (int64_t i = 0; i < T; ++i) {
      int64_t ty;
      if (!aa_row_tile(rows[i], cand, nty, hstep, hpad, &ty)) continue;
      int64_t lo = std::max(-floordiv64(-(ss[i] - (wstep - 1)), wstep),
                            (int64_t)0);
      int64_t hi = std::min(floordiv64(ee[i] + hpad, wstep), ntx - 1);
      for (int64_t tx = lo; tx <= hi; ++tx)
        if (edge_tiles[ty * ntx + tx]) ++counts[(size_t)(ty * ntx + tx)];
    }
  }
  std::vector<int64_t> offs((size_t)n_tiles, 0);
  int64_t total = 0, ng = 0;
  for (int64_t t = 0; t < n_tiles; ++t) {
    offs[(size_t)t] = total;
    if (counts[(size_t)t]) {
      groups[3 * ng] = t;
      groups[3 * ng + 1] = total;
      groups[3 * ng + 2] = total + counts[(size_t)t];
      ++ng;
    }
    total += counts[(size_t)t];
  }
  for (int64_t cand = 0; cand < 2; ++cand) {
    for (int64_t i = 0; i < T; ++i) {
      int64_t ty;
      if (!aa_row_tile(rows[i], cand, nty, hstep, hpad, &ty)) continue;
      int64_t lo = std::max(-floordiv64(-(ss[i] - (wstep - 1)), wstep),
                            (int64_t)0);
      int64_t hi = std::min(floordiv64(ee[i] + hpad, wstep), ntx - 1);
      int64_t tr0 = hstep * ty - hpad;
      for (int64_t tx = lo; tx <= hi; ++tx) {
        if (!edge_tiles[ty * ntx + tx]) continue;
        int64_t tc0 = wstep * tx - hpad;
        int64_t& o = offs[(size_t)(ty * ntx + tx)];
        out_r[o] = rows[i] - tr0;
        out_s[o] = std::min(std::max(ss[i] - tc0, (int64_t)0), ttw - 1);
        out_e[o] = std::min(std::max(ee[i] - tc0, (int64_t)0), ttw - 1);
        ++o;
      }
    }
  }
  *n_groups = ng;
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JBIG2 generic-region decoding (T.88 Annex E MQ decoder + 6.2.5.7).
// The per-pixel sequential arithmetic decode of scanned pages (megapixels)
// is JBIG2's one hot loop; this is a transcription of io/jbig2.py's
// MQDecoder/decode_generic (kept bit-identical — tests/test_jbig2.py fuzzes
// native vs Python).  Standalone regions only: symbol dictionaries share MQ
// state across symbols and stay in Python (their bitmaps are tiny).
// ---------------------------------------------------------------------------

namespace {

struct MQQe { uint16_t qe; uint8_t nmps, nlps, sw; };
static const MQQe kQe[47] = {
  {0x5601,1,1,1},{0x3401,2,6,0},{0x1801,3,9,0},{0x0AC1,4,12,0},
  {0x0521,5,29,0},{0x0221,38,33,0},{0x5601,7,6,1},{0x5401,8,14,0},
  {0x4801,9,14,0},{0x3801,10,14,0},{0x3001,11,17,0},{0x2401,12,18,0},
  {0x1C01,13,20,0},{0x1601,29,21,0},{0x5601,15,14,1},{0x5401,16,14,0},
  {0x5101,17,15,0},{0x4801,18,16,0},{0x3801,19,17,0},{0x3401,20,18,0},
  {0x3001,21,19,0},{0x2801,22,19,0},{0x2401,23,20,0},{0x2201,24,21,0},
  {0x1C01,25,22,0},{0x1801,26,23,0},{0x1601,27,24,0},{0x1401,28,25,0},
  {0x1201,29,26,0},{0x1101,30,27,0},{0x0AC1,31,28,0},{0x09C1,32,29,0},
  {0x08A1,33,30,0},{0x0521,34,31,0},{0x0441,35,32,0},{0x02A1,36,33,0},
  {0x0221,37,34,0},{0x0141,38,35,0},{0x0111,39,36,0},{0x0085,40,37,0},
  {0x0049,41,38,0},{0x0025,42,39,0},{0x0015,43,40,0},{0x0009,44,41,0},
  {0x0005,45,42,0},{0x0001,45,43,0},{0x5601,46,46,0},
};

struct MQDec {
  const uint8_t* data;
  int64_t len, bp;
  uint32_t c, a;
  int32_t ct;

  void bytein() {
    uint8_t b = bp < len ? data[bp] : 0xFF;
    if (b == 0xFF) {
      uint8_t b1 = bp + 1 < len ? data[bp + 1] : 0xFF;
      if (b1 > 0x8F) { c += 0xFF00; ct = 8; }
      else { ++bp; c += (uint32_t)b1 << 9; ct = 7; }
    } else {
      ++bp;
      uint8_t b1 = bp < len ? data[bp] : 0xFF;
      c += (uint32_t)b1 << 8; ct = 8;
    }
  }

  void init(const uint8_t* d, int64_t n) {
    data = d; len = n; bp = 0;
    c = (uint32_t)(n > 0 ? d[0] : 0xFF) << 16;
    bytein();
    c <<= 7; ct -= 7; a = 0x8000;
  }

  int decode(uint8_t* cx_i, uint8_t* cx_mps, uint32_t label) {
    uint8_t i = cx_i[label], mps = cx_mps[label];
    const MQQe& q = kQe[i];
    int d;
    a -= q.qe;
    if (((c >> 16) & 0xFFFF) < q.qe) {
      if (a < q.qe) { d = mps; cx_i[label] = q.nmps; }
      else {
        d = 1 - mps;
        if (q.sw) cx_mps[label] = 1 - mps;
        cx_i[label] = q.nlps;
      }
      a = q.qe;
    } else {
      c -= (uint32_t)q.qe << 16;
      if (a & 0x8000) return mps;
      if (a < q.qe) {
        d = 1 - mps;
        if (q.sw) cx_mps[label] = 1 - mps;
        cx_i[label] = q.nlps;
      } else { d = mps; cx_i[label] = q.nmps; }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1; c <<= 1; --ct;
    } while (!(a & 0x8000));
    a &= 0xFFFF;
    return d;
  }
};

static const int8_t kGenTemplates[4][12][2] = {
  {{-1,-2},{0,-2},{1,-2},{-2,-1},{-1,-1},{0,-1},{1,-1},{2,-1},{-4,0},{-3,0},{-2,0},{-1,0}},
  {{-1,-2},{0,-2},{1,-2},{2,-2},{-2,-1},{-1,-1},{0,-1},{1,-1},{2,-1},{-3,0},{-2,0},{-1,0}},
  {{-1,-2},{0,-2},{1,-2},{-2,-1},{-1,-1},{0,-1},{1,-1},{-2,0},{-1,0},{0,0},{0,0},{0,0}},
  {{-3,-1},{-2,-1},{-1,-1},{0,-1},{1,-1},{-4,0},{-3,0},{-2,0},{-1,0},{0,0},{0,0},{0,0}},
};
static const int kGenTemplateN[4] = {12, 12, 9, 9};
static const uint32_t kTpgdCtx[4] = {0x9B25, 0x0795, 0x00E5, 0x0195};

}  // namespace

extern "C" {

// Decode one arithmetic generic region from fresh MQ/context state.
// at: atn pairs of (dx, dy) int8.  out: h*w bytes (0/1).  Returns 0 on
// success, negative on bad arguments.
int32_t jbig2_generic_region(const uint8_t* data, int64_t len,
                             int32_t w, int32_t h, int32_t tmpl,
                             const int8_t* at, int32_t atn,
                             int32_t tpgdon, uint8_t* out) {
  if (tmpl < 0 || tmpl > 3 || w <= 0 || h <= 0 || atn < 0 || atn > 4)
    return -1;
  // Assemble template + AT pixels and sort by (dy, dx) — the context order
  // of io/jbig2.py:_context_pixels.
  int n = kGenTemplateN[tmpl];
  std::array<std::array<int, 2>, 16> pts{};
  for (int k = 0; k < n; ++k) {
    pts[(size_t)k][0] = kGenTemplates[tmpl][k][0];
    pts[(size_t)k][1] = kGenTemplates[tmpl][k][1];
  }
  for (int k = 0; k < atn; ++k) {
    pts[(size_t)(n + k)][0] = at[2 * k];
    pts[(size_t)(n + k)][1] = at[2 * k + 1];
  }
  n += atn;
  std::sort(pts.begin(), pts.begin() + n,
            [](const std::array<int, 2>& p, const std::array<int, 2>& q) {
              return p[1] != q[1] ? p[1] < q[1] : p[0] < q[0];
            });
  std::vector<uint8_t> cx_i((size_t)1 << 16, 0), cx_mps((size_t)1 << 16, 0);
  MQDec mq;
  mq.init(data, len);
  std::memset(out, 0, (size_t)w * (size_t)h);
  int ltp = 0;
  for (int32_t y = 0; y < h; ++y) {
    if (tpgdon) {
      if (mq.decode(cx_i.data(), cx_mps.data(), kTpgdCtx[tmpl])) ltp ^= 1;
      if (ltp) {
        if (y > 0)
          std::memcpy(out + (size_t)y * w, out + (size_t)(y - 1) * w, (size_t)w);
        continue;
      }
    }
    for (int32_t x = 0; x < w; ++x) {
      uint32_t ctxv = 0;
      for (int k = 0; k < n; ++k) {
        int xx = x + pts[(size_t)k][0], yy = y + pts[(size_t)k][1];
        uint32_t bit = 0;
        if (yy >= 0 && yy < h && xx >= 0 && xx < w &&
            (yy < y || (yy == y && xx < x)))
          bit = out[(size_t)yy * w + xx];
        ctxv = (ctxv << 1) | bit;
      }
      out[(size_t)y * w + x] =
          (uint8_t)mq.decode(cx_i.data(), cx_mps.data(), ctxv);
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// brush_stamp's stroke table (kernels/csrc/brush_stamp.cu; called by
// kernels.brush_plane_lists and brush_piece_lists).  For s (bhb, bwb) int32
// brushes: strokes[k * stroke_words + 0 .. 3] = the nonzero extent (ky0,
// kx0, kh, kw) of brush k, the rows and columns that hold a nonzero texel
// (all 0 where none does), and [6] the byte offset of its cropped (kh, kw)
// patch in `patches`: each distinct crop once, in stroke order, on 16 bytes
// and zero-padded to a multiple of 16 (the kernel stages a patch 16 bytes a
// copy).  `patches` holds at least s * bhb * bwb rounded up to 16 bytes a
// stroke.  Returns the bytes of `patches` used, or -1 where a texel lies
// outside 0..255 (nothing else is written then).
// ---------------------------------------------------------------------------

extern "C" {

int64_t brush_stroke_table(const int32_t* brushes, int32_t s, int32_t bhb, int32_t bwb, int32_t* strokes,
                           int32_t stroke_words, uint8_t* patches) {
  const int64_t plane = (int64_t)bhb * bwb;
  uint32_t bits = 0;  // a texel outside 0..255 sets a bit above the low 8 (one pass with no branch)
  for (int64_t q = 0; q < s * plane; ++q) bits |= (uint32_t)brushes[q];
  if (bits > 255u) return -1;
  thread_local std::vector<int32_t> cols;  // each column's OR over the rows
  int64_t used = 0;
  for (int32_t k = 0; k < s; ++k) {
    const int32_t* b = brushes + k * plane;
    int32_t y0 = bhb, y1 = -1, x0 = 0, x1 = bwb - 1;
    cols.assign((size_t)bwb, 0);
    int32_t* col = cols.data();
    for (int32_t y = 0; y < bhb; ++y) {
      const int32_t* row = b + (int64_t)y * bwb;
      int32_t any = 0;
      for (int32_t x = 0; x < bwb; ++x) any |= row[x], col[x] |= row[x];
      if (any) y0 = std::min(y0, y), y1 = y;
    }
    while (x0 < bwb && !col[x0]) ++x0;
    while (x1 > x0 && !col[x1]) --x1;
    int32_t* st = strokes + (int64_t)k * stroke_words;
    const int32_t kh = y1 < 0 ? 0 : y1 - y0 + 1, kw = y1 < 0 ? 0 : x1 - x0 + 1;
    st[0] = kh ? y0 : 0, st[1] = kh ? x0 : 0, st[2] = kh, st[3] = kw;
    uint8_t* crop = patches + used;  // written at the end, kept only if no earlier crop equals it
    for (int32_t y = 0; y < kh; ++y) {
      for (int32_t x = 0; x < kw; ++x) crop[(int64_t)y * kw + x] = (uint8_t)b[(int64_t)(y0 + y) * bwb + x0 + x];
    }
    const int64_t bytes = (int64_t)kh * kw, padded = (bytes + 15) / 16 * 16;
    std::memset(crop + bytes, 0, (size_t)(padded - bytes));
    int64_t at = used;
    for (int32_t j = 0; j < k; ++j) {  // an earlier stroke's crop of the same shape and bytes
      const int32_t* sj = strokes + (int64_t)j * stroke_words;
      if (sj[2] == kh && sj[3] == kw && std::memcmp(patches + sj[6], crop, (size_t)bytes) == 0) {
        at = sj[6];
        break;
      }
    }
    st[6] = (int32_t)at;
    if (at == used) used += padded;
  }
  return used;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// brush_stamp's lists (kernels/csrc/brush_stamp.cu; called by
// kernels.brush_plane_lists and brush_piece_lists).  The blocks of a launch
// each own an 8x128 strip of a 64x128 bin, and read the bin's lists: with
// meta == nullptr (plane mode) block b owns strip (b / tiles_x) % strips_y,
// b % tiles_x of plane b / (strips_y * tiles_x), its bin the plane's
// 64x128 tile around it; else (piece mode) strip b % 8 of the window
// meta[b / 8] = (stroke, row, col), its bin the window.  Stroke k's stamp i
// is (row, col) = corners[k, i], used where valid[k, i]; its window is the
// stroke's patch extent (kh, kw) at the corner plus (ky0, kx0) (strokes:
// brush_stroke_table).  Its stamp point points[k, i] (points ==
// nullptr: none), used where it lies in the (hp, wp) plane, has the (2 hr +
// 1) x (2 wr + 1) window around it.
//
// A bin's stamp list holds the stamps whose window touches it, in stamp
// order, each as its entry: the window's corner relative to the bin, row &
// 0xFFFF | col << 16; its point list likewise the points, each the point
// relative to the bin.  Blocks in one bin (its eight strips; padding pieces
// repeat a window) share its lists.  Writes the stamp lists, then the point
// lists, to `entries`, and for each of the ranges_rows blocks b
// ranges[4 * b .. 4 * b + 3] = (first, end) of its stamp list and (first,
// end) of its point list, point entries counted from the first point
// entry; `counts` = (stamp entries, point entries).  The entries are
// written only when they number at most `cap`.  Returns their number; -1
// on bad arguments (ranges_rows not the launch's blocks among them); -2 -
// (k * n + i) for the first valid stamp whose (bhb, bwb) padded patch
// leaves the plane.
//
// The bins of one alignment (row mod 64, col mod 128) lie on a grid, and
// each bin a block reads gets a list number: every record visits only the
// grid cells its window covers, keeping (list, entry) pairs in record
// order, and a counting sort places them list by list.
// ---------------------------------------------------------------------------

extern "C" {

int64_t brush_strip_lists(const int32_t* corners, const uint8_t* valid, const int32_t* points, int32_t s, int32_t n,
                          const int32_t* strokes, int32_t stroke_words, int32_t bhb, int32_t bwb, const int32_t* meta,
                          int64_t pieces, int32_t hp, int32_t wp, int32_t* ranges, int64_t ranges_rows, int64_t* counts,
                          int32_t* entries, int64_t cap) {
  constexpr int kSh = 6, kSw = 7;  // a bin: 2^6 rows, 2^7 columns (kernels.BRUSH_BIN)
  constexpr int32_t kStripH = 8, kStrips = 8;  // a block's strip (kernels.BRUSH_BLOCK); strips a bin
  if (s < 0 || n < 0 || pieces < 0 || hp < 0 || wp < 0) return -1;
  const int32_t last_y = hp - bhb, last_x = wp - bwb;  // a valid corner lies in 0..last
  const auto outside = [&](int64_t q) {
    return valid[q] & ((uint32_t)corners[2 * q] > (uint32_t)last_y | (uint32_t)corners[2 * q + 1] > (uint32_t)last_x |
                       (last_y < 0) | (last_x < 0));
  };
  int any_outside = 0;  // one pass with no branch, then the first at fault
  for (int64_t q = 0; q < (int64_t)s * n; ++q) any_outside |= outside(q);
  for (int64_t q = 0; any_outside && q < (int64_t)s * n; ++q) {
    if (outside(q)) return -2 - q;
  }
  const int32_t strips_y = (hp + kStripH - 1) / kStripH, tiles_x = (wp + (1 << kSw) - 1) >> kSw;
  const int32_t bins_y = (strips_y + kStrips - 1) / kStrips;
  const int64_t blocks = meta ? pieces * kStrips : (int64_t)s * strips_y * tiles_x;
  const int64_t bins = meta ? pieces : (int64_t)s * bins_y * tiles_x;
  if (blocks != ranges_rows) return -1;
  // Scratch kept from call to call (a build makes many launches): no allocation once it has grown.
  struct Grid { int32_t gy, gx, rows, cols; std::vector<int32_t> cell_list; };
  thread_local std::vector<int32_t> bs_, by_, bx_, grid_of_, list_of_, list_y_, list_x_, pairs_;
  thread_local std::vector<int64_t> start_;
  thread_local std::vector<Grid> grids_;
  // Bound once: each use of a thread_local itself looks its address up.
  std::vector<int32_t> &bs = bs_, &by = by_, &bx = bx_, &grid_of = grid_of_, &list_of = list_of_, &list_y = list_y_,
                       &list_x = list_x_, &pairs = pairs_;
  std::vector<int64_t>& start = start_;
  std::vector<Grid>& grids = grids_;
  bs.resize((size_t)bins), by.resize((size_t)bins), bx.resize((size_t)bins);  // each bin's plane and corner
  for (int64_t k = 0; k < bins; ++k) {
    if (meta) {
      bs[k] = meta[3 * k], by[k] = meta[3 * k + 1], bx[k] = meta[3 * k + 2];
    } else {
      const int64_t at = k % ((int64_t)bins_y * tiles_x);
      bs[k] = (int32_t)(k / ((int64_t)bins_y * tiles_x)), by[k] = (int32_t)(at / tiles_x << kSh);
      bx[k] = (int32_t)(at % tiles_x << kSw);
    }
    if (bs[k] < 0 || bs[k] >= s) return -1;
  }
  // Each alignment's grid; cell_list[cell] the list of the bin there, else -1 (bins that repeat a window share it).
  grids.clear(), list_y.clear(), list_x.clear();
  grid_of.resize((size_t)bins), list_of.resize((size_t)bins);
  for (int64_t k = 0; k < bins; ++k) {
    const int32_t gy = by[k] & ((1 << kSh) - 1), gx = bx[k] & ((1 << kSw) - 1);
    size_t g = 0;
    while (g < grids.size() && (grids[g].gy != gy || grids[g].gx != gx)) ++g;
    if (g == grids.size()) grids.push_back({gy, gx, 0, 0, {}});
    grid_of[k] = (int32_t)g;
    grids[g].rows = std::max(grids[g].rows, ((by[k] - gy) >> kSh) + 1);
    grids[g].cols = std::max(grids[g].cols, ((bx[k] - gx) >> kSw) + 1);
  }
  for (Grid& g : grids) g.cell_list.assign((size_t)s * g.rows * g.cols, -1);
  for (int64_t k = 0; k < bins; ++k) {
    Grid& g = grids[(size_t)grid_of[k]];
    int32_t& list = g.cell_list[((size_t)bs[k] * g.rows + ((by[k] - g.gy) >> kSh)) * g.cols + ((bx[k] - g.gx) >> kSw)];
    if (list < 0) {
      list = (int32_t)list_y.size();
      list_y.push_back(by[k]), list_x.push_back(bx[k]);
    }
    list_of[k] = list;
  }
  thread_local std::vector<int32_t> block_list_;  // the list block b reads, its bin's (no division a block)
  std::vector<int32_t>& block_list = block_list_;
  block_list.resize((size_t)blocks);
  if (meta) {
    for (int64_t b = 0; b < blocks; ++b) block_list[(size_t)b] = list_of[(size_t)(b / kStrips)];
  } else {
    int32_t* out = block_list.data();
    for (int32_t k = 0; k < s; ++k) {
      for (int32_t sy = 0; sy < strips_y; ++sy) {
        const int32_t* bin_row = list_of.data() + ((int64_t)k * bins_y + sy / kStrips) * tiles_x;
        out = std::copy(bin_row, bin_row + tiles_x, out);
      }
    }
  }
  const size_t lists = list_y.size();
  start.assign(2 * (lists + 1), 0);  // per kind: at[l + 1] counts list l, then at[l] is its first entry
  if (pairs.size() < (size_t)8 * s * n + 64) pairs.resize((size_t)8 * s * n + 64);  // (list, entry) in record order
  size_t used = 0, kind_end[2] = {0, 0};
  const int32_t *ly = list_y.data(), *lx = list_x.data();
  for (int kind = 0; kind < 2; ++kind) {
    const int32_t* records = kind ? points : corners;
    int64_t* at = start.data() + kind * (lists + 1);
    for (int32_t k = 0; records && k < s; ++k) {
      const int32_t* st = strokes + (int64_t)k * stroke_words;
      const int32_t dy = kind ? -st[5] : st[0], dx = kind ? -st[4] : st[1];  // record to window corner
      const int32_t h = kind ? 2 * st[5] + 1 : st[2], w = kind ? 2 * st[4] + 1 : st[3];
      if (h <= 0 || w <= 0) continue;
      const int32_t* rec = records + 2 * (int64_t)k * n;
      const uint8_t* ok = valid + (int64_t)k * n;
      for (const Grid& g : grids) {
        const int32_t* cells = g.cell_list.data() + (size_t)k * g.rows * g.cols;
        const int32_t last_row = g.rows - 1, last_col = g.cols - 1, gy = g.gy - dy, gx = g.gx - dx;
        if (used + 8 * (size_t)n + 8 > pairs.size()) pairs.resize(2 * pairs.size() + 8 * (size_t)n + 8);
        for (int32_t i = 0; i < n; ++i) {
          const int32_t ry = rec[2 * i], rx = rec[2 * i + 1];
          if (kind ? (uint32_t)ry >= (uint32_t)hp || (uint32_t)rx >= (uint32_t)wp : !ok[i]) continue;
          const int32_t ey = ry + (kind ? 0 : dy), ex = rx + (kind ? 0 : dx);  // what the entry holds
          const int32_t r0 = std::max((ry - gy) >> kSh, 0), r1 = std::min((ry - gy + h - 1) >> kSh, last_row);
          const int32_t c0 = std::max((rx - gx) >> kSw, 0), c1 = std::min((rx - gx + w - 1) >> kSw, last_col);
          if (r0 > r1 || c0 > c1) continue;
          const size_t most = 2 * (size_t)(r1 - r0 + 1) * (size_t)(c1 - c0 + 1);
          if (used + most > pairs.size()) pairs.resize(2 * pairs.size() + most);
          int32_t* out = pairs.data() + used;
          for (int32_t gr = r0; gr <= r1; ++gr) {
            const int32_t* row = cells + gr * g.cols;
            for (int32_t gc = c0; gc <= c1; ++gc) {
              const int32_t list = row[gc], l = std::max(list, 0);
              out[0] = list;
              out[1] = (int32_t)(((uint32_t)(ey - ly[l]) & 0xFFFFu) | ((uint32_t)(ex - lx[l]) << 16));
              ++at[list + 1];  // at[0] counts the cells no block owns
              out += 2 * (list >= 0);
            }
          }
          used = (size_t)(out - pairs.data());
        }
      }
    }
    at[0] = 0;
    for (size_t l = 0; l < lists; ++l) at[l + 1] += at[l];
    for (int64_t b = 0; b < blocks; ++b) {
      const int32_t list = block_list[(size_t)b];
      ranges[4 * b + 2 * kind] = (int32_t)at[list], ranges[4 * b + 2 * kind + 1] = (int32_t)at[list + 1];
    }
    kind_end[kind] = used / 2;
  }
  counts[0] = (int64_t)kind_end[0], counts[1] = (int64_t)(kind_end[1] - kind_end[0]);
  const int64_t total = (int64_t)(used / 2);
  if (total > cap) return total;
  for (int kind = 0; kind < 2; ++kind) {
    int64_t* at = start.data() + kind * (lists + 1);
    int32_t* out = entries + (kind ? kind_end[0] : 0);
    for (size_t q = kind ? kind_end[0] : 0; q < kind_end[kind]; ++q) out[at[pairs[2 * q]]++] = pairs[2 * q + 1];
  }
  return total;
}

// ---------------------------------------------------------------------------
// The sprite_raster kernel's span lists (kernels.sprite_raster_lists): one
// span family of n members, member m's counts[m] inclusive spans in its
// arrays rows, starts, ends (ptrs[3 m .. 3 m + 2], int64 addresses), in the
// member's plane (planes[4 m ..]: its origin row r0, height h, origin column
// c0, width w).  A span whose row lies outside 0..h-1 is dropped (the
// scatter drops it); the others are sorted by their 16-row group (row >> 4)
// with a counting sort, in any order inside a group, and packed into out
// as one uint64 each, (row & 511) << 54 | start << 27 | (end + 1), the
// columns clipped to 0..w (the scatter clips them): a kernel's unit reads
// the groups of its rows and knows their rows from its own band (kernels.py
// says how).  first receives, member by member, the index in out of each of
// its ceil(h / 16) groups' first span and then its end (ceil(h / 16) + 1
// entries).  The members are counted, then placed, by up to `threads`
// threads (each a run of members with about as many spans).  Returns the
// spans packed.  The caller checks that w < 2^27.
// ---------------------------------------------------------------------------
int64_t sprite_band_spans(const uint64_t* ptrs, const int64_t* counts, const int64_t* planes, int64_t n,
                          int32_t threads, uint64_t* out, int64_t* first) {
  std::vector<int64_t> at(n + 1, 0), firsts(n + 1, 0);  // each member's first span in out, its first group in first
  for (int64_t m = 0; m < n; ++m) firsts[m + 1] = firsts[m] + ((planes[4 * m + 1] + 15) >> 4) + 1;
  auto rows_of = [&](int64_t m) { return reinterpret_cast<const int64_t*>(ptrs[3 * m]); };
  // Group g's spans counted at first[g + 1], their kept total at at[m + 1].
  auto count = [&](int64_t m0, int64_t m1) {
    for (int64_t m = m0; m < m1; ++m) {
      const int64_t* rows = rows_of(m);
      const int64_t r0 = planes[4 * m], h = planes[4 * m + 1];
      int64_t* cnt = first + firsts[m];
      std::fill(cnt, first + firsts[m + 1], (int64_t)0);
      for (int64_t k = 0; k < counts[m]; ++k) {
        const int64_t r = rows[k] - r0;
        if (r >= 0 && r < h) ++cnt[(r >> 4) + 1];
      }
      int64_t kept = 0;
      for (int64_t* c = cnt + 1; c < first + firsts[m + 1]; ++c) kept += *c;
      at[m + 1] = kept;
    }
  };
  auto place = [&](int64_t m0, int64_t m1) {
    std::vector<int64_t> cursor;
    for (int64_t m = m0; m < m1; ++m) {
      const int64_t* rows = rows_of(m);
      const int64_t* starts = reinterpret_cast<const int64_t*>(ptrs[3 * m + 1]);
      const int64_t* ends = reinterpret_cast<const int64_t*>(ptrs[3 * m + 2]);
      const int64_t r0 = planes[4 * m], h = planes[4 * m + 1], c0 = planes[4 * m + 2], w = planes[4 * m + 3];
      int64_t* f = first + firsts[m];
      const int64_t groups = firsts[m + 1] - firsts[m] - 1;
      f[0] = at[m];
      for (int64_t g = 0; g < groups; ++g) f[g + 1] += f[g];
      cursor.assign(f, f + groups);
      for (int64_t k = 0; k < counts[m]; ++k) {
        const int64_t r = rows[k] - r0;
        if (r < 0 || r >= h) continue;
        const int64_t a = std::min(std::max(starts[k] - c0, (int64_t)0), w);
        const int64_t b = std::min(std::max(ends[k] + 1 - c0, (int64_t)0), w);
        out[cursor[r >> 4]++] = ((uint64_t)(r & 511) << 54) | ((uint64_t)a << 27) | (uint64_t)b;
      }
    }
  };
  // Runs of members with about as many spans each, one a thread.
  int64_t total = 0;
  for (int64_t m = 0; m < n; ++m) total += counts[m];
  const int64_t t = std::max<int64_t>(1, std::min<int64_t>(threads, n));
  std::vector<int64_t> cut(t + 1, n);
  cut[0] = 0;
  for (int64_t m = 0, seen = 0, j = 1; m < n && j < t; ++m) {
    seen += counts[m];
    if (seen * t >= total * j) cut[j++] = m + 1;
  }
  auto in_threads = [&](auto fn) {
    std::vector<std::thread> pool;
    for (int64_t j = 1; j < t; ++j) pool.emplace_back(fn, cut[j], cut[j + 1]);
    fn(cut[0], cut[1]);
    for (std::thread& th : pool) th.join();
  };
  in_threads(count);
  for (int64_t m = 0; m < n; ++m) at[m + 1] += at[m];
  in_threads(place);
  return at[n];
}

}  // extern "C"
