// Particle-field rasterizer of the port's image export (utils/raster.py): the
// same code as the JAX package's native/rasterizer.cpp, kept in the port so
// that the port builds it itself. Filled circles at physical radius with a
// black border of width 0.1*r, painter's order, and boundary line segments,
// with analytic pixel coverage for anti-aliasing. Host code, built by g++ and
// loaded with ctypes; it runs on the CPU after the snapshot is read off the
// device.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// img: H*W*3 float32, row-major, origin top-left. World->pixel transform:
//   px = W/2 + x*scale ; py = H/2 - y*scale  (y-flip like cairo_renderer.rs:49-51)
void fill_canvas(float* img, int W, int H, float r, float g, float b) {
    const float c[3] = {r, g, b};
    for (long i = 0; i < (long)W * H; ++i) {
        img[i * 3 + 0] = c[0];
        img[i * 3 + 1] = c[1];
        img[i * 3 + 2] = c[2];
    }
}

static inline float clampf(float v, float lo, float hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// coverage of a pixel center at (signed) distance d inside a disk boundary:
// 1 inside, 0 outside, linear ramp over one pixel
static inline float edge_cov(float d) { return clampf(0.5f - d, 0.0f, 1.0f); }

void draw_circles(float* img, int W, int H,
                  const float* pos,     // n x 2 world coords
                  const float* radius,  // n
                  const float* rgb,     // n x 3 fill colors
                  long n, float scale, float border_frac,
                  float border_r, float border_g, float border_b) {
    for (long i = 0; i < n; ++i) {
        const float cx = 0.5f * W + pos[i * 2 + 0] * scale;
        const float cy = 0.5f * H - pos[i * 2 + 1] * scale;
        const float rr = radius[i] * scale;
        if (!(rr > 0.0f)) continue;
        const float bw = rr * border_frac;          // stroke width (0.1 * r)
        const float rout = rr + 0.5f * bw;          // stroke straddles the arc
        const float rin = rr - 0.5f * bw;
        const int x0 = std::max(0, (int)std::floor(cx - rout - 1.0f));
        const int x1 = std::min(W - 1, (int)std::ceil(cx + rout + 1.0f));
        const int y0 = std::max(0, (int)std::floor(cy - rout - 1.0f));
        const int y1 = std::min(H - 1, (int)std::ceil(cy + rout + 1.0f));
        const float fr = rgb[i * 3 + 0], fg = rgb[i * 3 + 1], fb = rgb[i * 3 + 2];
        for (int py = y0; py <= y1; ++py) {
            for (int px = x0; px <= x1; ++px) {
                const float dx = (float)px + 0.5f - cx;
                const float dy = (float)py + 0.5f - cy;
                const float d = std::sqrt(dx * dx + dy * dy);
                // fill disk of radius rr, then stroke ring [rin, rout]
                const float cov_fill = edge_cov(d - rr);
                const float cov_ring = edge_cov(d - rout) * edge_cov(rin - d);
                if (cov_fill <= 0.0f && cov_ring <= 0.0f) continue;
                float* p = img + ((long)py * W + px) * 3;
                if (cov_fill > 0.0f) {
                    p[0] += (fr - p[0]) * cov_fill;
                    p[1] += (fg - p[1]) * cov_fill;
                    p[2] += (fb - p[2]) * cov_fill;
                }
                if (cov_ring > 0.0f) {
                    p[0] += (border_r - p[0]) * cov_ring;
                    p[1] += (border_g - p[1]) * cov_ring;
                    p[2] += (border_b - p[2]) * cov_ring;
                }
            }
        }
    }
}

void draw_lines(float* img, int W, int H,
                const float* segs,  // n x 4: x0,y0,x1,y1 world coords
                long n, float scale, float width_world,
                float r, float g, float b) {
    const float hw = 0.5f * width_world * scale;
    for (long i = 0; i < n; ++i) {
        const float ax = 0.5f * W + segs[i * 4 + 0] * scale;
        const float ay = 0.5f * H - segs[i * 4 + 1] * scale;
        const float bx = 0.5f * W + segs[i * 4 + 2] * scale;
        const float by = 0.5f * H - segs[i * 4 + 3] * scale;
        const float minx = std::min(ax, bx) - hw - 1, maxx = std::max(ax, bx) + hw + 1;
        const float miny = std::min(ay, by) - hw - 1, maxy = std::max(ay, by) + hw + 1;
        const int x0 = std::max(0, (int)std::floor(minx));
        const int x1 = std::min(W - 1, (int)std::ceil(maxx));
        const int y0 = std::max(0, (int)std::floor(miny));
        const int y1 = std::min(H - 1, (int)std::ceil(maxy));
        const float ux = bx - ax, uy = by - ay;
        const float len2 = std::max(ux * ux + uy * uy, 1e-12f);
        for (int py = y0; py <= y1; ++py) {
            for (int px = x0; px <= x1; ++px) {
                const float qx = (float)px + 0.5f - ax;
                const float qy = (float)py + 0.5f - ay;
                const float t = clampf((qx * ux + qy * uy) / len2, 0.0f, 1.0f);
                const float dx = qx - t * ux, dy = qy - t * uy;
                const float d = std::sqrt(dx * dx + dy * dy);
                const float cov = edge_cov(d - hw);
                if (cov <= 0.0f) continue;
                float* p = img + ((long)py * W + px) * 3;
                p[0] += (r - p[0]) * cov;
                p[1] += (g - p[1]) * cov;
                p[2] += (b - p[2]) * cov;
            }
        }
    }
}

}  // extern "C"
