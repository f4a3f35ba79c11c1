// Host glyph rasteriser: OpenCV 5's TrueType putText raster, value for value.
//
// OpenCV 5 draws text with a modified stb_truetype (public domain, Sean
// Barrett): quadratic outlines flattened to within 0.35 px
// (stbtt_FlattenCurves), then the signed-area scanline rasteriser of
// stb_truetype's version 2 (stbtt__rasterize, stbtt__rasterize_sorted_edges,
// stbtt__fill_active_edges_new), with the clamps of stb_truetype 1.26.
// OpenCV's change is where the glyph sits: the bitmap is the glyph box grown
// by `pad` pixels on every side and the outline is shifted by (pad, pad).
// The float arithmetic below follows stb's expression by expression: the
// edges' positions accumulate row by row, so a reordered sum or a fused
// multiply-add would move a pixel by a level now and then.  The library is
// built with -ffp-contract=off for that reason.
//
// The C interface (crt_glyph_raster) takes the vertices of one glyph as
// (type, x, y, cx, cy) int32 rows: type 1 starts a contour at (x, y), 2 is
// a line to (x, y) and 3 a quadratic curve to (x, y) through (cx, cy), in
// font units (OpenCV keeps them as int16).  It returns 0 on success.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Point {
  float x, y;
};

struct Edge {
  float x0, y0, x1, y1;
  int invert;
};

struct Active {
  float fx, fdx, fdy, direction, sy, ey;
};

void tesselate_curve(std::vector<Point>& pts, float x0, float y0, float x1, float y1, float x2,
                     float y2, float flatness_sq, int n) {
  // midpoint against the chord's midpoint
  float mx = (x0 + 2 * x1 + x2) / 4;
  float my = (y0 + 2 * y1 + y2) / 4;
  float dx = (x0 + x2) / 2 - mx;
  float dy = (y0 + y2) / 2 - my;
  if (n > 16) return;
  if (dx * dx + dy * dy > flatness_sq) {
    tesselate_curve(pts, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flatness_sq, n + 1);
    tesselate_curve(pts, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flatness_sq, n + 1);
  } else {
    pts.push_back({x2, y2});
  }
}

// stbtt_FlattenCurves: the points of each contour and their counts
void flatten(const int32_t* v, int nv, float objspace_flatness, std::vector<Point>& pts,
             std::vector<int>& lengths) {
  float flatness_sq = objspace_flatness * objspace_flatness;
  float x = 0, y = 0;
  int start = 0;
  bool open = false;
  for (int i = 0; i < nv; ++i) {
    const int32_t* r = v + 5 * i;
    switch (r[0]) {
      case 1:
        if (open) lengths.push_back(int(pts.size()) - start);
        open = true;
        start = int(pts.size());
        x = float(r[1]), y = float(r[2]);
        pts.push_back({x, y});
        break;
      case 2:
        x = float(r[1]), y = float(r[2]);
        pts.push_back({x, y});
        break;
      case 3:
        tesselate_curve(pts, x, y, float(r[3]), float(r[4]), float(r[1]), float(r[2]),
                        flatness_sq, 0);
        x = float(r[1]), y = float(r[2]);
        break;
    }
  }
  if (open) lengths.push_back(int(pts.size()) - start);
}

inline bool edge_less(const Edge& a, const Edge& b) { return a.y0 < b.y0; }

void sort_edges_ins_sort(Edge* p, int n) {
  for (int i = 1; i < n; ++i) {
    Edge t = p[i];
    int j = i;
    while (j > 0) {
      if (!edge_less(t, p[j - 1])) break;
      p[j] = p[j - 1];
      --j;
    }
    if (i != j) p[j] = t;
  }
}

void sort_edges_quicksort(Edge* p, int n) {
  while (n > 12) {
    Edge t;
    int m = n >> 1;
    bool c01 = edge_less(p[0], p[m]);
    bool c12 = edge_less(p[m], p[n - 1]);
    if (c01 != c12) {
      bool c = edge_less(p[0], p[n - 1]);
      int z = (c == c12) ? 0 : n - 1;
      t = p[z];
      p[z] = p[m];
      p[m] = t;
    }
    t = p[0];
    p[0] = p[m];
    p[m] = t;
    int i = 1, j = n - 1;
    for (;;) {
      for (;; ++i)
        if (!edge_less(p[i], p[0])) break;
      for (;; --j)
        if (!edge_less(p[0], p[j])) break;
      if (i >= j) break;
      t = p[i];
      p[i] = p[j];
      p[j] = t;
      ++i;
      --j;
    }
    if (j < n - i) {
      sort_edges_quicksort(p, j);
      p = p + i;
      n = n - i;
    } else {
      sort_edges_quicksort(p + i, n - i);
      n = j;
    }
  }
}

void handle_clipped_edge(float* scanline, int x, const Active& e, float x0, float y0, float x1,
                         float y1) {
  if (y0 == y1) return;
  if (y0 > e.ey) return;
  if (y1 < e.sy) return;
  if (y0 < e.sy) {
    x0 += (x1 - x0) * (e.sy - y0) / (y1 - y0);
    y0 = e.sy;
  }
  if (y1 > e.ey) {
    x1 += (x1 - x0) * (e.ey - y1) / (y1 - y0);
    y1 = e.ey;
  }
  if (x0 <= x && x1 <= x)
    scanline[x] += e.direction * (y1 - y0);
  else if (x0 >= x + 1 && x1 >= x + 1)
    ;
  else
    scanline[x] += e.direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

inline float sized_trapezoid_area(float height, float top_width, float bottom_width) {
  return (top_width + bottom_width) / 2.0f * height;
}

inline float position_trapezoid_area(float height, float tx0, float tx1, float bx0, float bx1) {
  return sized_trapezoid_area(height, tx1 - tx0, bx1 - bx0);
}

inline float sized_triangle_area(float height, float width) { return height * width / 2; }

void fill_active_edges(float* scanline, float* scanline_fill, int len,
                       const std::vector<Active*>& active, float y_top) {
  float y_bottom = y_top + 1;
  for (const Active* ep : active) {
    const Active& e = *ep;
    if (e.fdx == 0) {
      float x0 = e.fx;
      if (x0 < len) {
        if (x0 >= 0) {
          handle_clipped_edge(scanline, int(x0), e, x0, y_top, x0, y_bottom);
          handle_clipped_edge(scanline_fill - 1, int(x0) + 1, e, x0, y_top, x0, y_bottom);
        } else {
          handle_clipped_edge(scanline_fill - 1, 0, e, x0, y_top, x0, y_bottom);
        }
      }
      continue;
    }
    float x0 = e.fx;
    float dx = e.fdx;
    float xb = x0 + dx;
    float x_top, x_bottom;
    float sy0, sy1;
    float dy = e.fdy;
    if (e.sy > y_top) {
      x_top = x0 + dx * (e.sy - y_top);
      sy0 = e.sy;
    } else {
      x_top = x0;
      sy0 = y_top;
    }
    if (e.ey < y_bottom) {
      x_bottom = x0 + dx * (e.ey - y_top);
      sy1 = e.ey;
    } else {
      x_bottom = xb;
      sy1 = y_bottom;
    }
    if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
      if (int(x_top) == int(x_bottom)) {
        int x = int(x_top);
        float height = (sy1 - sy0) * e.direction;
        scanline[x] += position_trapezoid_area(height, x_top, x + 1.0f, x_bottom, x + 1.0f);
        scanline_fill[x] += height;
      } else {
        if (x_top > x_bottom) {
          // flip the row vertically; the signed area is the same
          float t;
          sy0 = y_bottom - (sy0 - y_top);
          sy1 = y_bottom - (sy1 - y_top);
          t = sy0, sy0 = sy1, sy1 = t;
          t = x_bottom, x_bottom = x_top, x_top = t;
          dx = -dx;
          dy = -dy;
          t = x0, x0 = xb, xb = t;
        }
        int x1 = int(x_top);
        int x2 = int(x_bottom);
        float y_crossing = y_top + dy * (x1 + 1 - x0);
        float y_final = y_top + dy * (x2 - x0);
        if (y_crossing > y_bottom) y_crossing = y_bottom;
        float sign = e.direction;
        float area = sign * (y_crossing - sy0);
        scanline[x1] += sized_triangle_area(area, x1 + 1 - x_top);
        if (y_final > y_bottom) {
          int denom = x2 - (x1 + 1);
          y_final = y_bottom;
          if (denom != 0) dy = (y_final - y_crossing) / denom;
        }
        float step = sign * dy * 1;
        for (int x = x1 + 1; x < x2; ++x) {
          scanline[x] += area + step / 2;
          area += step;
        }
        scanline[x2] += area + sign * position_trapezoid_area(sy1 - y_final, float(x2),
                                                              x2 + 1.0f, x_bottom, x2 + 1.0f);
        scanline_fill[x2] += sign * (sy1 - sy0);
      }
    } else {
      // the edge leaves the bitmap's columns: stb's brute-force clipping
      for (int x = 0; x < len; ++x) {
        float ya = y_top;
        float xa1 = float(x);
        float xa2 = float(x + 1);
        float x3 = xb;
        float y3 = y_bottom;
        float y1 = (x - x0) / dx + y_top;
        float y2 = (x + 1 - x0) / dx + y_top;
        if (x0 < xa1 && x3 > xa2) {
          handle_clipped_edge(scanline, x, e, x0, ya, xa1, y1);
          handle_clipped_edge(scanline, x, e, xa1, y1, xa2, y2);
          handle_clipped_edge(scanline, x, e, xa2, y2, x3, y3);
        } else if (x3 < xa1 && x0 > xa2) {
          handle_clipped_edge(scanline, x, e, x0, ya, xa2, y2);
          handle_clipped_edge(scanline, x, e, xa2, y2, xa1, y1);
          handle_clipped_edge(scanline, x, e, xa1, y1, x3, y3);
        } else if (x0 < xa1 && x3 > xa1) {
          handle_clipped_edge(scanline, x, e, x0, ya, xa1, y1);
          handle_clipped_edge(scanline, x, e, xa1, y1, x3, y3);
        } else if (x3 < xa1 && x0 > xa1) {
          handle_clipped_edge(scanline, x, e, x0, ya, xa1, y1);
          handle_clipped_edge(scanline, x, e, xa1, y1, x3, y3);
        } else if (x0 < xa2 && x3 > xa2) {
          handle_clipped_edge(scanline, x, e, x0, ya, xa2, y2);
          handle_clipped_edge(scanline, x, e, xa2, y2, x3, y3);
        } else if (x3 < xa2 && x0 > xa2) {
          handle_clipped_edge(scanline, x, e, x0, ya, xa2, y2);
          handle_clipped_edge(scanline, x, e, xa2, y2, x3, y3);
        } else {
          handle_clipped_edge(scanline, x, e, x0, ya, x3, y3);
        }
      }
    }
  }
}

// stbtt__rasterize (invert = 1, vsubsample = 1) and
// stbtt__rasterize_sorted_edges, version 2
void rasterize(uint8_t* out, int w, int h, const std::vector<Point>& pts,
               const std::vector<int>& lengths, float scale_x, float scale_y, float shift_x,
               float shift_y, int off_x, int off_y) {
  float y_scale_inv = -scale_y;
  std::vector<Edge> e;
  e.reserve(pts.size() + 1);
  int m = 0;
  for (int len : lengths) {
    const Point* p = pts.data() + m;
    m += len;
    int j = len - 1;
    for (int k = 0; k < len; j = k++) {
      int a = k, b = j;
      if (p[j].y == p[k].y) continue;
      Edge ed;
      ed.invert = 0;
      if (p[j].y > p[k].y) {
        ed.invert = 1;
        a = j, b = k;
      }
      ed.x0 = p[a].x * scale_x + shift_x;
      ed.y0 = (p[a].y * y_scale_inv + shift_y) * 1;
      ed.x1 = p[b].x * scale_x + shift_x;
      ed.y1 = (p[b].y * y_scale_inv + shift_y) * 1;
      e.push_back(ed);
    }
  }
  int n = int(e.size());
  sort_edges_quicksort(e.data(), n);
  sort_edges_ins_sort(e.data(), n);
  Edge sentinel{};
  sentinel.y0 = float(off_y + h) + 1;
  e.push_back(sentinel);

  std::vector<float> buf(2 * size_t(w) + 1);
  float* scanline = buf.data();
  float* scanline2 = scanline + w;
  std::vector<Active> pool;
  pool.reserve(n);
  std::vector<Active*> active;  // front first, as stb's linked list
  const Edge* ep = e.data();
  int y = off_y;
  for (int j = 0; j < h; ++j) {
    float scan_y_top = y + 0.0f;
    float scan_y_bottom = y + 1.0f;
    std::memset(scanline, 0, w * sizeof(float));
    std::memset(scanline2, 0, (w + 1) * sizeof(float));
    size_t keep = 0;
    for (Active* z : active)
      if (!(z->ey <= scan_y_top)) active[keep++] = z;
    active.resize(keep);
    while (ep->y0 <= scan_y_bottom) {
      if (ep->y0 != ep->y1) {
        float dxdy = (ep->x1 - ep->x0) / (ep->y1 - ep->y0);
        pool.push_back(Active{});
        Active* z = &pool.back();
        z->fdx = dxdy;
        z->fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
        z->fx = ep->x0 + dxdy * (scan_y_top - ep->y0);
        z->fx -= off_x;
        z->direction = ep->invert ? 1.0f : -1.0f;
        z->sy = ep->y0;
        z->ey = ep->y1;
        if (j == 0 && off_y != 0 && z->ey < scan_y_top) z->ey = scan_y_top;
        active.insert(active.begin(), z);
      }
      ++ep;
    }
    if (!active.empty()) fill_active_edges(scanline, scanline2 + 1, w, active, scan_y_top);
    float sum = 0;
    for (int i = 0; i < w; ++i) {
      sum += scanline2[i];
      float k = scanline[i] + sum;
      k = float(std::fabs(k)) * 255 + 0.5f;
      int v = int(k);
      if (v > 255) v = 255;
      out[size_t(j) * w + i] = uint8_t(v);
    }
    for (Active* z : active) z->fx += z->fdx;
    ++y;
  }
}

}  // namespace

extern "C" {

// Rasterise `nv` vertex rows into the (h, w) u8 bitmap `out`, whose pixel
// (0, 0) is the glyph-space pixel (off_x, off_y) after the outline is
// scaled by `scale` (y flipped) and shifted by (shift, shift).
int crt_glyph_raster(const int32_t* verts, int nv, float scale, float shift, int off_x,
                     int off_y, int w, int h, uint8_t* out) {
  if (w <= 0 || h <= 0 || nv < 0) return 1;
  std::vector<Point> pts;
  std::vector<int> lengths;
  flatten(verts, nv, 0.35f / scale, pts, lengths);
  rasterize(out, w, h, pts, lengths, scale, scale, shift, shift, off_x, off_y);
  return 0;
}

}  // extern "C"
