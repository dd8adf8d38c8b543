// fastops: native host-side kernels of desenet_tpu_torch's data path.
//
// The port's own copy of the JAX package's native/fastops.cpp. The Python
// loader threads call these C routines through ctypes
// (desenet_tpu_torch/native.py); they hold no Python lock and parallelize
// with OpenMP:
//
//   assemble_batch      pack N HWC uint8 samples into one contiguous batch
//   rasterize_polygons  scanline polygon -> class-id mask fill, bit-equal
//                       to PIL's ImageDraw.polygon
//   rasterize_batch     the same over a batch of masks
//   decode_jpeg_scaled  libjpeg decode at a DCT scale (with libjpeg only)
//   assemble_batch_s2d4 assemble_batch in the phase stem's
//                       space-to-depth-4 layout
//
// Built by desenet_tpu_torch/native.py with the host compiler at first use:
// -O3 -fPIC -fopenmp -std=c++17 -ffp-contract=off, plus -DDESENET_HAVE_JPEG
// -ljpeg where jpeglib.h preprocesses.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

#if defined(DESENET_HAVE_JPEG)
#include <jpeglib.h>
#endif

extern "C" {

// dst: (n, h*w*c) contiguous; srcs: array of n pointers to h*w*c blocks.
void assemble_batch(uint8_t* dst, const uint8_t** srcs, int64_t n,
                    int64_t bytes_per_sample) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * bytes_per_sample, srcs[i], bytes_per_sample);
  }
}

// PIL-exact polygon fill (Pillow 12 ImageDraw.polygon(outline=ink, fill=ink)
// semantics — the reference's label-truth definition, general.py:490-510).
// Bit-identical to PIL on simple polygons (tests/test_torch_native.py
// holds it against PIL and the JAX package's library): coordinates truncate to int; scanline intersections
// at integer rows over half-open [ymin, ymax) edges in float32; extremum
// corners of same-lean adjacent edges extend toward the adjacent row's span;
// spans fill [ROUND_UP(x0), ROUND_DOWN(x1)] with zero-symmetric rounding and
// Pillow's asymmetric clipping. Self-intersecting/duplicate-vertex polygons
// are refused (return 0) — the Python wrapper falls back to PIL for those.

static inline int64_t round_up_sym(float f) {
  return (f >= 0.0f) ? (int64_t)std::floor(f + 0.5f)
                     : -(int64_t)std::floor(-f + 0.5f);
}
static inline int64_t round_down_sym(float f) {
  return (f >= 0.0f) ? (int64_t)std::ceil(f - 0.5f)
                     : -(int64_t)std::ceil(-f - 0.5f);
}

static inline double cross3(int64_t ox, int64_t oy, int64_t px, int64_t py,
                            int64_t qx, int64_t qy) {
  return (double)(px - ox) * (double)(qy - oy) -
         (double)(py - oy) * (double)(qx - ox);
}

// Strict proper-crossing test between non-adjacent segments.
static int polygon_is_simple(const int64_t* X, const int64_t* Y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = i + 1; j < n; ++j) {
      if (X[i] == X[j] && Y[i] == Y[j]) return 0;  // duplicate vertex
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    int64_t i2 = (i + 1) % n;
    for (int64_t j = i + 1; j < n; ++j) {
      if (j == i + 1 || (i == 0 && j == n - 1)) continue;
      int64_t j2 = (j + 1) % n;
      double d1 = cross3(X[j], Y[j], X[j2], Y[j2], X[i], Y[i]);
      double d2 = cross3(X[j], Y[j], X[j2], Y[j2], X[i2], Y[i2]);
      double d3 = cross3(X[i], Y[i], X[i2], Y[i2], X[j], Y[j]);
      double d4 = cross3(X[i], Y[i], X[i2], Y[i2], X[j2], Y[j2]);
      if (((d1 > 0) != (d2 > 0)) && ((d3 > 0) != (d4 > 0))) return 0;
    }
  }
  return 1;
}

static void pil_hline(int32_t* mask, int64_t h, int64_t w, int64_t y,
                      int64_t xa, int64_t xb, int32_t cls_id) {
  if (y < 0 || y >= h) return;
  if (xa > xb) return;           // inverted span: nothing
  if (xa >= w || xb < 0) return; // entirely right / entirely left
  if (xa < 0) xa = 0;
  if (xb >= w) xb = w - 1;
  for (int64_t x = xa; x <= xb; ++x) mask[y * w + x] = cls_id;
}

struct PEdge {
  float x0, dxdy;
  int64_t y0, ymin, ymax;
};

static int fill_polygon(int32_t* mask, int64_t h, int64_t w, const float* pts,
                        int64_t npts, int32_t cls_id) {
  if (npts < 3) return 1;  // PIL via reference: <3 points ignored
  std::vector<int64_t> X(npts), Y(npts);
  for (int64_t i = 0; i < npts; ++i) {
    X[i] = (int64_t)pts[2 * i];      // C truncation toward zero, like PIL
    Y[i] = (int64_t)pts[2 * i + 1];
  }
  if (!polygon_is_simple(X.data(), Y.data(), npts)) return 0;

  int64_t gy_min = Y[0], gy_max = Y[0];
  for (int64_t i = 1; i < npts; ++i) {
    gy_min = std::min(gy_min, Y[i]);
    gy_max = std::max(gy_max, Y[i]);
  }
  const int64_t gy_max_c = std::min(gy_max, h);  // Pillow clips to ysize

  std::vector<PEdge> edges;
  std::vector<int64_t> edge_of(npts, -1);
  for (int64_t i = 0; i < npts; ++i) {
    int64_t j = (i + 1) % npts;
    if (Y[i] == Y[j]) {  // horizontal edge: direct hline
      pil_hline(mask, h, w, Y[i], std::min(X[i], X[j]),
                std::max(X[i], X[j]), cls_id);
      continue;
    }
    edge_of[i] = (int64_t)edges.size();
    PEdge e;
    e.x0 = (float)X[i];
    e.y0 = Y[i];
    e.ymin = std::min(Y[i], Y[j]);
    e.ymax = std::max(Y[i], Y[j]);
    e.dxdy = (float)(X[j] - X[i]) / (float)(Y[j] - Y[i]);
    edges.push_back(e);
  }

  auto x_at = [](const PEdge& e, int64_t y) -> float {
    return e.x0 + (float)(y - e.y0) * e.dxdy;
  };

  std::vector<float> xs;
  const int64_t y_lo = std::max(gy_min, (int64_t)0);
  const int64_t y_hi = std::min(gy_max_c, h - 1);
  for (int64_t y = y_lo; y <= y_hi; ++y) {
    xs.clear();
    for (const PEdge& e : edges) {
      if (e.ymin <= y && y < e.ymax) xs.push_back(x_at(e, y));
    }
    // extremum corners between adjacent non-horizontal edges at this row
    for (int64_t i = 0; i < npts; ++i) {
      int64_t j = (i + 1) % npts;
      if (edge_of[i] < 0 || edge_of[j] < 0) continue;
      if (Y[j] != y) continue;
      const PEdge& e1 = edges[edge_of[i]];
      const PEdge& e2 = edges[edge_of[j]];
      const bool bottom = (e1.ymax == y && e2.ymax == y);
      const bool top = (e1.ymin == y && e2.ymin == y);
      if (!bottom && !top) continue;  // through-vertex: main rule covers it
      const float vx = (float)X[j];
      const bool same = (e1.dxdy > 0) == (e2.dxdy > 0);
      if (!same) {
        if (bottom) {  // V vertex: degenerate point pair
          xs.push_back(vx);
          xs.push_back(vx);
        }
        continue;  // top V: both edges already counted by the main rule
      }
      const int64_t off = (y == gy_max_c) ? -1 : 1;
      const float a = x_at(e1, y + off), b = x_at(e2, y + off);
      // extension endpoint pre-rounds with plain floor(f + 0.5)
      const bool right = (bottom && e1.dxdy < 0) || (top && e1.dxdy > 0);
      if (right) {
        float ext = std::floor(std::min(a, b) - 1.0f + 0.5f);
        xs.push_back(vx);
        xs.push_back(std::max(vx, ext));
      } else {
        float ext = std::floor(std::max(a, b) + 1.0f + 0.5f);
        xs.push_back(std::min(vx, ext));
        xs.push_back(vx);
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      pil_hline(mask, h, w, y, round_up_sym(xs[k]), round_down_sym(xs[k + 1]),
                cls_id);
    }
  }
  return 1;
}

// polys: concatenated (x, y) float32 pairs; counts[i] = #points of poly i;
// cls_ids[i] = class id. Mask must be zero-initialized by the caller.
// Returns the number of polygons filled natively. If any polygon is
// degenerate (self-intersecting / duplicate vertices), stops and returns a
// value < n_polys — the caller must re-render the whole mask with PIL to
// preserve the later-polygon-overwrites ordering.
int64_t rasterize_polygons(int32_t* mask, int64_t h, int64_t w,
                           const float* polys, const int64_t* counts,
                           const int32_t* cls_ids, int64_t n_polys) {
  int64_t off = 0;
  for (int64_t p = 0; p < n_polys; ++p) {
    if (!fill_polygon(mask, h, w, polys + 2 * off, counts[p], cls_ids[p])) {
      return p;
    }
    off += counts[p];
  }
  return n_polys;
}

// Batched variant: one mask per (h, w) plane, polygons grouped per image.
// ok_flags[i] = 1 if image i was fully rendered natively, 0 if it contains a
// degenerate polygon (caller re-renders that image with PIL).
void rasterize_batch(int32_t* masks, int64_t b, int64_t h, int64_t w,
                     const float* polys, const int64_t* counts,
                     const int32_t* cls_ids, const int64_t* polys_per_img,
                     int8_t* ok_flags) {
  std::vector<int64_t> poly_start(b + 1, 0), pt_start(b + 1, 0);
  for (int64_t i = 0; i < b; ++i) {
    poly_start[i + 1] = poly_start[i] + polys_per_img[i];
  }
  for (int64_t i = 0; i < b; ++i) {
    int64_t pts = 0;
    for (int64_t p = poly_start[i]; p < poly_start[i + 1]; ++p) {
      pts += counts[p];
    }
    pt_start[i + 1] = pt_start[i] + pts;
  }
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < b; ++i) {
    int64_t off = pt_start[i];
    int8_t ok = 1;
    for (int64_t p = poly_start[i]; p < poly_start[i + 1]; ++p) {
      if (!fill_polygon(masks + i * h * w, h, w, polys + 2 * off, counts[p],
                        cls_ids[p])) {
        ok = 0;
        break;
      }
      off += counts[p];
    }
    ok_flags[i] = ok;
  }
}

#if defined(DESENET_HAVE_JPEG)

// libjpeg's default error handler exit()s the process; trampoline back out.
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

static void jpeg_err_silent(j_common_ptr, int) {}

// Scaled JPEG decode (the reference has no equivalent: PIL decodes full-res
// then LANCZOS-resizes, mixed_datasets.py:624-640 — measured 4x slower than
// DCT-domain scaling + area resize on 1280px sources, in the JAX
// package's measurement). Decodes `data` at the
// largest libjpeg M/8 fraction whose LONG side stays >= target_long (so the
// caller's final resize is a downscale), RGB output.
//
// out must hold out_cap bytes. Returns 1 on success, 0 on any failure
// (corrupt stream, buffer too small, non-JPEG) — the dataset then decodes
// that image with PIL. CMYK/grayscale sources are up-converted by libjpeg.
int decode_jpeg_scaled(const uint8_t* data, int64_t len, int32_t target_long,
                       uint8_t* out, int64_t out_cap, int32_t* out_w,
                       int32_t* out_h, int32_t* full_w, int32_t* full_h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  err.mgr.emit_message = jpeg_err_silent;  // no stderr warnings from workers
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  *full_w = (int32_t)cinfo.image_width;
  *full_h = (int32_t)cinfo.image_height;
  const int32_t long_side =
      std::max(*full_w, *full_h) > 0 ? std::max(*full_w, *full_h) : 1;

  // smallest M/8 with ceil(long*M/8) >= target (libjpeg-turbo supports
  // M=1..16; plain libjpeg only 1/2/4/8 — calc_output_dimensions rounds to
  // what the library actually implements, so probe downward)
  cinfo.out_color_space = JCS_RGB;
  // speed knobs for the opt-in fast path (already documented as not
  // pixel-equal to PIL/LANCZOS): merged/non-fancy chroma upsampling and
  // the AAN float IDCT are each worth ~15-25% on 4:2:0 sources
  cinfo.do_fancy_upsampling = FALSE;
  cinfo.dct_method = JDCT_FASTEST;
  cinfo.scale_denom = 8;
  int32_t m = 8;
  if (target_long > 0 && target_long < long_side) {
    for (m = 1; m < 8; ++m) {
      if ((int64_t)long_side * m >= (int64_t)target_long * 8) break;
    }
  }
  for (; m <= 8; ++m) {
    cinfo.scale_num = (unsigned)m;
    jpeg_calc_output_dimensions(&cinfo);
    if ((int32_t)std::max(cinfo.output_width, cinfo.output_height) >=
        std::min(target_long, long_side)) {
      break;
    }
  }
  if ((int64_t)cinfo.output_width * cinfo.output_height * 3 > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  *out_w = (int32_t)cinfo.output_width;
  *out_h = (int32_t)cinfo.output_height;
  const int64_t stride = (int64_t)cinfo.output_width * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (int64_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 1;
}

int has_jpeg() { return 1; }

#else  // !DESENET_HAVE_JPEG

int decode_jpeg_scaled(const uint8_t*, int64_t, int32_t, uint8_t*, int64_t,
                       int32_t*, int32_t*, int32_t*, int32_t*) {
  return 0;
}

int has_jpeg() { return 0; }

#endif

// Pack N HWC uint8 samples into one contiguous batch in space-to-depth-4
// layout (n, h/4, w/4, 16c), channel order (pr, pc, ci) — the input format
// of the phase stem (desenet_tpu_torch/models/layers.py PhaseStemA). The
// permutation is folded into the batch memcpy: same bytes moved as
// assemble_batch, in 4c-byte runs. h, w must be divisible by 4 (the Python
// wrapper checks).
void assemble_batch_s2d4(uint8_t* dst, const uint8_t** srcs, int64_t n,
                         int64_t h, int64_t w, int64_t c) {
  const int64_t hq = h / 4, wq = w / 4;
  const int64_t run = 4 * c;              // one (pr, x) run: 4 pixels
  const int64_t dst_px = 16 * c;          // output channels per (y, x)
  const int64_t dst_sample = hq * wq * dst_px;
#pragma omp parallel for schedule(static) collapse(2)
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t y = 0; y < hq; ++y) {
      const uint8_t* src = srcs[i];
      uint8_t* drow = dst + i * dst_sample + y * wq * dst_px;
      for (int64_t pr = 0; pr < 4; ++pr) {
        const uint8_t* srow = src + ((4 * y + pr) * w) * c;
        uint8_t* dbase = drow + pr * run;
        for (int64_t x = 0; x < wq; ++x) {
          std::memcpy(dbase + x * dst_px, srow + x * run, run);
        }
      }
    }
  }
}

int fastops_version() { return 4; }

}  // extern "C"
