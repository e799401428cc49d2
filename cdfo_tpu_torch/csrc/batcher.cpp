// Native training-batch sampler for the CVCP side-info pipeline (a copy of
// the JAX package's native/batcher.cpp, with the same C interface).
//
// Replaces the reference's DataLoader worker processes (4x python
// __getitem__ with numpy crop/augment/ToTensor, train_LD_37.py:303-320)
// with a single multithreaded C++ pass over the packed uint8/int8 arrays:
// crop + flip/rot augmentation with MV sign fixups + center-MV expansion
// (the LD expansion only) + dtype scaling, writing model-ready float32 NHWC
// buffers.
//
// Built at first use by cdfo_tpu_torch/data/native.py (g++ -O3
// -march=native -fopenmp -shared -fPIC) and loaded there with ctypes.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <random>

namespace {

struct Geo {
  bool hflip, vflip, rot90;
};

// map output crop coordinate -> source coordinate inside the crop
inline void src_coord(const Geo& g, int cr, int y, int x, int* sy, int* sx) {
  int yy = y, xx = x;
  if (g.rot90) {  // output[y][x] = in[x][y] applied LAST in numpy chain;
    int t = yy; yy = xx; xx = t;
  }
  // numpy applies hflip then vflip then rot90 (transpose). Inverting:
  // in-chain coords before transpose are (yy, xx); before vflip: maybe
  // mirrored; before hflip: maybe mirrored.
  if (g.vflip) yy = cr - 1 - yy;
  if (g.hflip) xx = cr - 1 - xx;
  *sy = yy; *sx = xx;
}

}  // namespace

extern "C" {

// All arrays are C-contiguous.
// lr, pm, uf: uint8 (S, T, H, W); rm: int8 (S, T, H, W)
// hr: uint8 (S, T, 4H, 4W)
// mv0, mv1: int8 (S, T, H, W, 3)
// outputs (batch B, crop CR, frames N):
//  out_lr/pm/rm/uf: float32 (B, N, CR, CR, 1)
//  out_hr: float32 (B, 4CR, 4CR, 1)
//  out_mv0/mv1: float32 (B, N, CR, CR, 2)
void sample_batch(
    const uint8_t* lr, const uint8_t* hr, const uint8_t* pm,
    const int8_t* rm, const uint8_t* uf,
    const int8_t* mv0, const int8_t* mv1,
    int S, int T, int H, int W,
    int B, int N, int CR,
    uint64_t seed, int augment, int zero_mvl1,
    float* out_lr, float* out_hr, float* out_pm, float* out_rm,
    float* out_uf, float* out_mv0, float* out_mv1) {
  const int HR_H = 4 * H, HR_W = 4 * W;
  const int CR4 = 4 * CR;
  const float inv255 = 1.0f / 255.0f;

#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < B; ++b) {
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ull * (b + 1));
    auto randint = [&](int lo, int hi) {  // [lo, hi)
      return lo + (int)(rng() % (uint64_t)(hi - lo));
    };
    const int s = randint(0, S);
    const int start = (T > N) ? randint(0, T - N + 1) : 0;
    const int center = start + N / 2;
    const int top = (H > CR) ? randint(0, H - CR) : 0;
    const int left = (W > CR) ? randint(0, W - CR) : 0;
    Geo g{false, false, false};
    if (augment) {
      g.hflip = (rng() & 1) != 0;
      g.vflip = (rng() & 1) != 0;
      g.rot90 = (rng() & 1) != 0;
    }

    // ---- images (lr/pm/rm/uf), all N frames --------------------------
    for (int f = 0; f < N; ++f) {
      const size_t base = (((size_t)s * T) + (start + f)) * H * W;
      float* olr = out_lr + ((((size_t)b * N) + f) * CR * CR);
      float* opm = out_pm + ((((size_t)b * N) + f) * CR * CR);
      float* orm = out_rm + ((((size_t)b * N) + f) * CR * CR);
      float* ouf = out_uf + ((((size_t)b * N) + f) * CR * CR);
      for (int y = 0; y < CR; ++y) {
        for (int x = 0; x < CR; ++x) {
          int sy, sx;
          src_coord(g, CR, y, x, &sy, &sx);
          const size_t si = base + (size_t)(top + sy) * W + (left + sx);
          const size_t oi = (size_t)y * CR + x;
          olr[oi] = lr[si] * inv255;
          opm[oi] = pm[si] * inv255;
          orm[oi] = rm[si] * inv255;
          ouf[oi] = uf[si] * inv255;
        }
      }
    }

    // ---- HR center frame ---------------------------------------------
    {
      const size_t base = (((size_t)s * T) + center) * (size_t)HR_H * HR_W;
      float* ohr = out_hr + (size_t)b * CR4 * CR4;
      for (int y = 0; y < CR4; ++y) {
        for (int x = 0; x < CR4; ++x) {
          int sy, sx;
          src_coord(g, CR4, y, x, &sy, &sx);
          const size_t si = base + (size_t)(top * 4 + sy) * HR_W
                            + (left * 4 + sx);
          ohr[(size_t)y * CR4 + x] = hr[si] * inv255;
        }
      }
    }

    // ---- center-frame MV -> expanded per-frame flows ------------------
    // replicates TrainBatcher: xy-swap, augment sign/axis fixups, expand
    // (scale d for past, -d for future), /4/32
    auto expand_mv = [&](const int8_t* mv, float* out, bool zero) {
      for (int y = 0; y < CR; ++y) {
        for (int x = 0; x < CR; ++x) {
          float fx = 0.f, fy = 0.f;
          if (!zero) {
            int sy, sx;
            src_coord(g, CR, y, x, &sy, &sx);
            const size_t si =
                ((((size_t)s * T) + center) * H * W
                 + (size_t)(top + sy) * W + (left + sx)) * 3;
            // raw field is [dy, dx, refoff]; xy-swap -> (dx, dy)
            float dx = (float)mv[si + 1];
            float dy = (float)mv[si + 0];
            float off = (float)mv[si + 2];
            // augment fixups operate on the swapped (dx, dy)
            if (g.hflip) dx = -dx;
            if (g.vflip) dy = -dy;
            if (g.rot90) { float t = dx; dx = dy; dy = t; }
            if (off != 0.0f) {
              fx = dx / (-off);
              fy = dy / (-off);
              if (!std::isfinite(fx)) fx = 0.f;
              if (!std::isfinite(fy)) fy = 0.f;
            } else if (dx != 0.0f || dy != 0.0f) {
              // x/0 -> +-inf passes through in the reference; 0/0 -> 0
              fx = dx > 0 ? INFINITY : (dx < 0 ? -INFINITY : 0.f);
              fy = dy > 0 ? INFINITY : (dy < 0 ? -INFINITY : 0.f);
            }
          }
          for (int f = 0; f < N; ++f) {
            const int c = N / 2;
            float scale = (f < c) ? (float)(c - f) : -(float)(f - c);
            // frame c has zero flow (scale 0)
            const size_t oi =
                ((((size_t)b * N) + f) * CR * CR + (size_t)y * CR + x) * 2;
            out[oi + 0] = fx * scale / 128.0f;
            out[oi + 1] = fy * scale / 128.0f;
          }
        }
      }
    };
    expand_mv(mv0, out_mv0, false);
    expand_mv(mv1, out_mv1, zero_mvl1 != 0);
  }
}

}  // extern "C"
