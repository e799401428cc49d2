// Upsample head, hand-written for Hopper (sm_90a):
//   out = conv_last(lrelu(PS2(upconv2(lrelu(PS2(upconv1(t))))))) + up4(lr)
// with PS2 the PixelShuffle(2) (input channel c*4 + dy*2 + dx -> channel c
// at subpixel (dy, dx)) and up4 the bilinear x4 resize (align_corners =
// False, border clamp). Output float32 (B, 4H, 4W).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_head.py::fused_head_hcw
// (kernel body _kernel), which fused_vjp.head_fused launches once per
// align_reconstruct call.
//
// What bounds it: ~107 K MAC per 1x pixel (64->256 at 1x, 4 x 64->256 at
// 2x, 16 x 9 x 64 for conv_last at 4x); the eager version is memory-bound
// instead: it writes and re-reads the 2x (256 ch) and 4x (64 ch)
// intermediates, ~0.27 GB per 272 x 480 frame for the 4x one alone. Here
// neither leaves the SM.
//
// Design: one CTA of 8 warps per TH x TW 1x tile (8 x 8 in bf16, 4 x 8 in
// fp32, by shared memory). The tile and a 1-pixel 1x halo of t are loaded;
// for each first-stage phase p1 = (dy1, dx1) in turn, the 64 channels of
// that phase are computed (upconv1 with its rows permuted phase-major by
// the wrapper), then all 256 second-stage channels, whose phase p2 = (dy2,
// dx2) and channel c land at 4x pixel (4i + 2dy1 + dy2, 4j + 2dx1 + dx2).
// Only the (4TH+2) x (4TW+2) window of the 4x feature that conv_last reads
// is kept, in shared memory, zeroed outside the image. conv_last (64 -> 1)
// runs on the CUDA cores, one 4x pixel per thread at a time, and adds the
// bilinear x4 base of the LR frame, read with clamped indices.

#include "conv3x3_tile.cuh"

namespace {

using namespace cdfo;

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int H = 8, W = 8; };
template <> struct Tile<float> { static constexpr int H = 4, W = 8; };

template <typename T>
constexpr int smem_pixels() {
  constexpr int TH = Tile<T>::H, TW = Tile<T>::W;
  return 2 * (TH + 2) * (TW + 2) + (4 * TH + 2) * (4 * TW + 2);
}
template <typename T>
constexpr int smem_bytes() {
  return smem_pixels<T>() * Pitch<T>::value * static_cast<int>(sizeof(T)) + 9 * C * 4;
}

// bilinear x4 weights of LR rows m-1, m, m+1 for 4x phase r (source row
// (4m + r + 0.5) / 4 - 0.5)
__constant__ float kUp4[4][3] = {{0.375f, 0.625f, 0.f}, {0.125f, 0.875f, 0.f},
                                 {0.f, 0.875f, 0.125f}, {0.f, 0.625f, 0.375f}};

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_kernel(const T* __restrict__ t, const T* __restrict__ lr, const T* __restrict__ w1,
            const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
            const T* __restrict__ wl, const T* __restrict__ bl, float* __restrict__ out, int h,
            int wd) {
  constexpr int TH = Tile<T>::H, TW = Tile<T>::W, P = Pitch<T>::value;
  constexpr int HW = TW + 2;                 // halo window width (1x)
  constexpr int NP = (TH + 2) * HW;          // halo window pixels
  constexpr int IH = 4 * TH + 2, IW = 4 * TW + 2;  // 4x window, origin (4r0-1, 4c0-1)
  extern __shared__ uint4 cdfo_smem[];
  T* ts = reinterpret_cast<T*>(cdfo_smem);   // t window, origin (r0-1, c0-1)
  T* as = ts + NP * P;                       // one first-stage phase
  T* im = as + NP * P;                       // 4x feature window
  float* wls = reinterpret_cast<float*>(im + IH * IW * P);   // conv_last [tap][c]
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_window(ts, t + static_cast<long long>(b) * h * wd * C, h, wd, r0 - 1, c0 - 1, TH + 2,
              HW, false);
  for (int i = threadIdx.x; i < 9 * C; i += blockDim.x) wls[i] = to_f(wl[i]);
  __syncthreads();

  constexpr int MT = (NP + 15) / 16;   // m-tiles of the halo window, taken in pairs
  constexpr int PAIRS = (MT + 1) / 2;
  const Weights<T> wt1{w1, 4 * C, C}, wt2{w2, 4 * C, C};
  for (int p1 = 0; p1 < 4; ++p1) {
    // first stage, phase p1: as = lrelu(w1[p1] . t + b1[p1])
    for (int pr = warp; pr < PAIRS; pr += WARPS) {
      const int m0 = 2 * pr, m1 = min(m0 + 1, MT - 1);
      const ATile<T> a[2] = {a_tile<1>(ts, HW, HW, NP, m0, lane),
                             a_tile<1>(ts, HW, HW, NP, m1, lane)};
      float acc[2][8][4];
      zero(acc);
      conv_tiles<1, 1, 2, 8>(acc, a, wt1, p1 * C, 0, lane);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        for_each_pair(acc[m], m ? m1 : m0, 0, NP, lane, [&](int p, int n, float v0, float v1) {
          const float2 bb = load2(b1 + p1 * C + n);
          store2(as + p * P + n, lrelu(v0 + bb.x), lrelu(v1 + bb.y));
        });
      }
    }
    __syncthreads();
    // second stage: 4 phases p2 of 64 channels each, into the 4x window
    const int dy1 = p1 >> 1, dx1 = p1 & 1;
    for (int task = warp; task < 4 * PAIRS; task += WARPS) {
      const int pr = task >> 2, p2 = task & 3;
      const int m0 = 2 * pr, m1 = min(m0 + 1, MT - 1);
      const ATile<T> a[2] = {a_tile<1>(as, HW, HW, NP, m0, lane),
                             a_tile<1>(as, HW, HW, NP, m1, lane)};
      float acc[2][8][4];
      zero(acc);
      conv_tiles<1, 1, 2, 8>(acc, a, wt2, p2 * C, 0, lane);
      const int ry = 2 * dy1 + (p2 >> 1), rx = 2 * dx1 + (p2 & 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        for_each_pair(acc[m], m ? m1 : m0, 0, NP, lane, [&](int p, int n, float v0, float v1) {
          const int i = p / HW, j = p % HW;
          const int ly = 4 * i + ry - 3, lx = 4 * j + rx - 3;
          if (ly >= 0 && ly < IH && lx >= 0 && lx < IW) {
            const bool in = inside(r0 - 1 + i, c0 - 1 + j, h, wd);
            const float2 bb = load2(b2 + p2 * C + n);
            store2(im + (ly * IW + lx) * P + n, in ? lrelu(v0 + bb.x) : 0.f,
                   in ? lrelu(v1 + bb.y) : 0.f);
          }
        });
      }
    }
    __syncthreads();
  }

  // conv_last at 4x + bilinear x4 base; output pixel (4r0 + oy, 4c0 + ox)
  const T* lrb = lr + static_cast<long long>(b) * h * wd;
  const long long ow = 4LL * wd;
  for (int q = threadIdx.x; q < 16 * TH * TW; q += blockDim.x) {
    const int oy = q / (4 * TW), ox = q % (4 * TW);
    const int y = 4 * r0 + oy, x = 4 * c0 + ox;
    if (y >= 4 * h || x >= 4 * wd) continue;
    float acc = to_f(*bl);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const T* px = im + ((oy + tap / 3) * IW + ox + tap % 3) * P;
      const float* wt = wls + tap * C;
#pragma unroll 8
      for (int c = 0; c < C; c += 2) {
        const float2 v = load2(px + c);
        acc = fmaf(v.x, wt[c], fmaf(v.y, wt[c + 1], acc));
      }
    }
    const int m = y >> 2, n = x >> 2, ry = y & 3, rx = x & 3;
    float base = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int yy = min(max(m - 1 + i, 0), h - 1);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int xx = min(max(n - 1 + j, 0), wd - 1);
        const float wgt = kUp4[ry][i] * kUp4[rx][j];
        if (wgt != 0.f) base = fmaf(wgt, to_f(lrb[static_cast<long long>(yy) * wd + xx]), base);
      }
    }
    out[static_cast<long long>(b) * 4 * h * ow + y * ow + x] = acc + base;
  }
}

template <typename T>
cudaError_t launch(const void* t, const void* lr, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* wl, const void* bl, void* out, int batch, int h,
                   int wd, cudaStream_t stream) {
  const cudaError_t err = allow_smem(head_kernel<T>, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + Tile<T>::W - 1) / Tile<T>::W, (h + Tile<T>::H - 1) / Tile<T>::H, batch);
  CDFO_LAUNCH(head_kernel<T>, grid, smem_bytes<T>(), stream, static_cast<const T*>(t),
              static_cast<const T*>(lr), static_cast<const T*>(w1), static_cast<const T*>(b1),
              static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(wl),
              static_cast<const T*>(bl),
              static_cast<float*>(out), h, wd);
  return cudaGetLastError();
}

}  // namespace

// t: (batch, h, wd, 64) NHWC trunk output; lr: (batch, h, wd) LR frame;
// w1, w2: 1x1 weights (256 out x 64 in) with rows permuted phase-major (row
// p*64 + c is torch's output channel c*4 + p) in the Weights layout of
// conv3x3_tile.cuh, b1, b2: [256] likewise; wl:
// [9 taps][64] conv_last weights; bl: its bias [1]; out: (batch, 4h, 4wd)
// float32. t, lr and the weights share one dtype (is_bf16: 1 for bfloat16,
// 0 for float32). Returns a cudaError_t.
extern "C" int cdfo_fused_head(const void* t, const void* lr, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* wl, const void* bl,
                               void* out, int is_bf16, int batch, int h, int wd, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(t, lr, w1, b1, w2, b2, wl, bl, out, batch, h, wd, s)
                 : launch<float>(t, lr, w1, b1, w2, b2, wl, bl, out, batch, h, wd, s);
}
