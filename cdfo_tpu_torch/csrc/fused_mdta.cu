// The MDTA round of the GCPI embed as two passes, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels cdfo_tpu/ops/fused_mdta.py::mdta_stage1 and
// ::mdta_stage2, which PartitionTransformerSA2Fast launches three times
// each per embed call (one pair per round).
//
// Stage 1: v, stats = LN1 -> qkv 1x1 (64 -> 192) -> depthwise 3x3 ->
// [sum q^T k, sum q^T q, sum k^T k]. Stage 2: t = x + proj(A v); out = t +
// conv3x3(LN2 t) + b + x2.
//
// What bounds them: per pixel, stage 1 does 64x192 + 192x9 + 3x64x64 MACs
// (~50 KFLOP) against 256 B of x in and v out in bf16 (~190 FLOP/B) and
// stage 2 2x64x64 + 64x64x9 MACs (~90 KFLOP) against 512 B (x, v, x2 in,
// out), both under the card's ~295 FLOP/B bf16 balance point, so on paper
// memory-bound; the eager round writes and re-reads ~15 full-resolution
// tensors (LN, qkv, depthwise, the head split, attention, projection, LN2,
// the conv and its skips). Each stage here reads its inputs once (plus a
// one-pixel halo) and writes its outputs once; qkv, LN2(t) and t never
// leave shared memory.
//
// Design: one CTA of 8 warps per TH x TW output tile with a one-pixel halo
// window in shared memory. The 1x1 convolutions run as implicit GEMMs over
// the window on conv3x3_tile.cuh's tile routine (bf16 mma.sync, fp32
// CUDA-core twin); the depthwise 3x3 and the LayerNorms in fp32 on the
// CUDA cores, one pixel per thread. Stage 1's statistics need every pixel:
// a block walks every `parts`-th tile of its image, keeps its gram sums in
// registers (gram_tile.cuh) and writes one partial; a second launch adds
// the partials in a fixed order. Rounding follows the TPU kernels: LN1(x),
// qkv, q, k, v, A v, t (for the residual) and LN2(t) to the working type,
// everything else in fp32.

#include "gram_tile.cuh"

namespace {

using namespace cdfo;

constexpr int TH = 8, TW = 16;                 // output tile
constexpr int WH = TH + 2, WW = TW + 2;        // window with the halo
constexpr int WPIX = WH * WW, NPIX = TH * TW;  // 180, 128
constexpr int C3 = 3 * C;

// qkv: 192 channels plus padding per window pixel
template <typename T> struct QkvPitch;
template <> struct QkvPitch<float> { static constexpr int value = 196; };
template <> struct QkvPitch<bf16> { static constexpr int value = 200; };

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, bf16) {
  return __bfloat162float(__float2bfloat16(x));
}

// LayerNorm over the 64 channels of each of the n pixels at `src` (f32
// values at pitch sp, or T), E[x^2] - mu^2 as the TPU kernel; the result,
// zeroed where keep(pixel) is false, goes to dst (pitch Pitch<T>).
template <typename S, typename T, typename Keep>
__device__ void layer_norm(const S* src, int sp, T* dst, int n, const float* __restrict__ lnw,
                           const float* __restrict__ lnb, Keep&& keep) {
  constexpr int P = Pitch<T>::value;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const S* s = src + p * sp;
    float sum = 0.f, sq = 0.f;
    for (int c = 0; c < C; c += 2) {
      const float2 u = load2(s + c);
      sum += u.x + u.y;
      sq += u.x * u.x + u.y * u.y;
    }
    const float mu = sum * (1.f / C);
    const float rs = 1.f / sqrtf(sq * (1.f / C) - mu * mu + 1e-5f);
    const bool in = keep(p);
    for (int c = 0; c < C; c += 2) {
      const float2 u = load2(s + c);
      store2(dst + p * P + c, in ? (u.x - mu) * rs * __ldg(lnw + c) + __ldg(lnb + c) : 0.f,
             in ? (u.y - mu) * rs * __ldg(lnw + c + 1) + __ldg(lnb + c + 1) : 0.f);
    }
  }
}

// A 1x1 convolution over all WPIX window pixels of `in` to N = 64 * ng
// channels: epi(pixel, channel, v0, v1) gets the fp32 sums. Each warp takes
// (m-tile, 32-channel group) pairs.
template <typename T, typename Epi>
__device__ __forceinline__ void window_1x1(const T* in, const Weights<T>& w, int warp, int lane,
                                           Epi&& epi) {
  constexpr int MTS = (WPIX + 15) / 16;
  const int groups = w.n / 32;
  for (int job = warp; job < MTS * groups; job += WARPS) {
    const int mt = job / groups, n0 = (job % groups) * 32;
    const ATile<T> a[1] = {a_tile<1>(in, WW, WW, WPIX, mt, lane)};
    float acc[1][4][4];
    zero(acc);
    conv_tiles<1, 1, 1, 4>(acc, a, w, n0, 0, lane);
    for_each_pair(acc[0], mt, n0, WPIX, lane, epi);
  }
}

template <typename T>
constexpr int s1_smem() {
  constexpr int P = Pitch<T>::value;
  constexpr int a = WPIX * P, b = 2 * NPIX * P;
  return ((a > b ? a : b) + WPIX * QkvPitch<T>::value) * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mdta1_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
             const float* __restrict__ lnb, const T* __restrict__ wqkv,
             const float* __restrict__ taps, T* __restrict__ v, float* __restrict__ ws, int h,
             int wd, int parts) {
  constexpr int P = Pitch<T>::value, QP = QkvPitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* xs = reinterpret_cast<T*>(cdfo_smem);  // LN1(x) window, then q | k of the tile
  T* qs = xs;
  T* ks = xs + NPIX * P;
  T* qkv = xs + (WPIX * P > 2 * NPIX * P ? WPIX * P : 2 * NPIX * P);
  const int img = blockIdx.y, part = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_w = (wd + TW - 1) / TW, tiles = tiles_w * ((h + TH - 1) / TH);
  const long long base = static_cast<long long>(img) * h * wd * C;
  float acc[3][4][4];
  zero_grams(acc);

  for (int tile = part; tile < tiles; tile += parts) {
    const int r0 = (tile / tiles_w) * TH, c0 = (tile % tiles_w) * TW;
    __syncthreads();  // the previous tile's grams are done with qs, ks
    load_window(xs, x + base, h, wd, r0 - 1, c0 - 1, WH, WW, false);
    __syncthreads();
    layer_norm(xs, P, xs, WPIX, lnw, lnb, [](int) { return true; });
    __syncthreads();
    // qkv = LN1(x) W_qkv^T, zero outside the image, rounded to T
    window_1x1(xs, Weights<T>{wqkv, C3, C}, warp, lane, [&](int p, int n, float v0, float v1) {
      const bool in = inside(r0 - 1 + p / WW, c0 - 1 + p % WW, h, wd);
      store2(qkv + p * QP + n, in ? v0 : 0.f, in ? v1 : 0.f);
    });
    __syncthreads();
    // depthwise 3x3 with fp32 taps: q, k (zero outside the image) to shared
    // memory for the grams, v to device memory
    for (int i = threadIdx.x; i < NPIX * (C3 / 2); i += THREADS) {
      const int p = i / (C3 / 2), ch = 2 * (i % (C3 / 2));
      const int py = p / TW, px = p % TW;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float2 u = load2(qkv + ((py + dy) * WW + px + dx) * QP + ch);
          s0 = fmaf(__ldg(taps + ch * 9 + 3 * dy + dx), u.x, s0);
          s1 = fmaf(__ldg(taps + (ch + 1) * 9 + 3 * dy + dx), u.y, s1);
        }
      const int y = r0 + py, xx = c0 + px;
      const bool in = y < h && xx < wd;
      if (ch < C) {
        store2(qs + p * P + ch, in ? s0 : 0.f, in ? s1 : 0.f);
      } else if (ch < 2 * C) {
        store2(ks + p * P + ch - C, in ? s0 : 0.f, in ? s1 : 0.f);
      } else if (in) {
        store2(v + base + (static_cast<long long>(y) * wd + xx) * C + ch - 2 * C, s0, s1);
      }
    }
    __syncthreads();
    // the statistics of the rounded q and k
    gram3(acc, qs, ks, NPIX, warp, lane);
  }
  store_grams(acc, ws + (static_cast<long long>(img) * parts + part) * 3 * GRAM, warp, lane);
}

template <typename T>
constexpr int s2_smem() {
  return 2 * WPIX * Pitch<T>::value * static_cast<int>(sizeof(T)) +
         WPIX * Pitch<float>::value * static_cast<int>(sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mdta2_kernel(const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ x2,
             const T* __restrict__ amat, const T* __restrict__ wproj,
             const float* __restrict__ lnw, const float* __restrict__ lnb,
             const T* __restrict__ wconv, const T* __restrict__ bconv, T* __restrict__ out, int h,
             int wd) {
  constexpr int P = Pitch<T>::value, FP = Pitch<float>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* as = reinterpret_cast<T*>(cdfo_smem);  // v window, then LN2(t)
  T* os = as + WPIX * P;                     // A v, rounded
  float* ts = reinterpret_cast<float*>(os + WPIX * P);  // t in fp32
  const int img = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(img) * h * wd * C;
  auto in_window = [&](int p) { return inside(r0 - 1 + p / WW, c0 - 1 + p % WW, h, wd); };

  load_window(as, v + base, h, wd, r0 - 1, c0 - 1, WH, WW, false);
  __syncthreads();
  // o = v A^T (this image's matrix), rounded to T
  window_1x1(as, Weights<T>{amat + static_cast<long long>(img) * GRAM, C, C}, warp, lane,
             [&](int p, int n, float v0, float v1) { store2(os + p * P + n, v0, v1); });
  __syncthreads();
  // t = x + o W_proj^T in fp32, zero outside the image
  window_1x1(os, Weights<T>{wproj, C, C}, warp, lane, [&](int p, int n, float v0, float v1) {
    const int y = r0 - 1 + p / WW, xx = c0 - 1 + p % WW;
    float2 t = make_float2(0.f, 0.f);
    if (inside(y, xx, h, wd)) {
      const float2 xv = load2(x + base + (static_cast<long long>(y) * wd + xx) * C + n);
      t = make_float2(xv.x + v0, xv.y + v1);
    }
    store2(ts + p * FP + n, t.x, t.y);
  });
  __syncthreads();
  // LN2 of the fp32 t, rounded to T, zero outside the image (the conv's
  // zero padding)
  layer_norm(ts, FP, as, WPIX, lnw, lnb, in_window);
  __syncthreads();
  // out = conv3x3(LN2 t) + b + t (rounded to T) + x2; warp w: m-tile w
  static_assert(NPIX == 16 * WARPS, "one m-tile per warp");
  const ATile<T> a[1] = {a_tile<1>(as, WW, TW, NPIX, warp, lane)};
  float acc[1][8][4];
  zero(acc);
  conv_tiles<3, 3, 1, 8>(acc, a, Weights<T>{wconv, C, C}, 0, 0, lane);
  for_each_pair(acc[0], warp, 0, NPIX, lane, [&](int p, int n, float v0, float v1) {
    const int py = p / TW, px = p % TW, y = r0 + py, xx = c0 + px;
    if (y < h && xx < wd) {
      const long long o = base + (static_cast<long long>(y) * wd + xx) * C + n;
      const float2 t = load2(ts + ((py + 1) * WW + px + 1) * FP + n);
      const float2 b = load2(bconv + n), s = load2(x2 + o);
      store2(out + o, v0 + b.x + round_to(t.x, T()) + s.x, v1 + b.y + round_to(t.y, T()) + s.y);
    }
  });
}

int tiles_of(int h, int wd) { return ((h + TH - 1) / TH) * ((wd + TW - 1) / TW); }

template <typename T>
cudaError_t launch1(const void* x, const void* lnw, const void* lnb, const void* wqkv,
                    const void* taps, void* v, void* ws, void* stats, int batch, int h, int wd,
                    int parts, cudaStream_t stream) {
  const cudaError_t err = allow_smem(mdta1_kernel<T>, s1_smem<T>());
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(mdta1_kernel<T>, dim3(parts, batch), s1_smem<T>(), stream,
              static_cast<const T*>(x), static_cast<const float*>(lnw),
              static_cast<const float*>(lnb), static_cast<const T*>(wqkv),
              static_cast<const float*>(taps), static_cast<T*>(v), static_cast<float*>(ws), h,
              wd, parts);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return e1;
  return launch_reduce(static_cast<const float*>(ws), parts, 3 * GRAM, 3 * GRAM,
                       static_cast<float*>(stats), nullptr, batch, stream);
}

template <typename T>
cudaError_t launch2(const void* x, const void* v, const void* x2, const void* amat,
                    const void* wproj, const void* lnw, const void* lnb, const void* wconv,
                    const void* bconv, void* out, int batch, int h, int wd, cudaStream_t stream) {
  const cudaError_t err = allow_smem(mdta2_kernel<T>, s2_smem<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, batch);
  CDFO_LAUNCH(mdta2_kernel<T>, grid, s2_smem<T>(), stream, static_cast<const T*>(x),
              static_cast<const T*>(v), static_cast<const T*>(x2), static_cast<const T*>(amat),
              static_cast<const T*>(wproj), static_cast<const float*>(lnw),
              static_cast<const float*>(lnb), static_cast<const T*>(wconv),
              static_cast<const T*>(bconv), static_cast<T*>(out), h, wd);
  return cudaGetLastError();
}

}  // namespace

// The float32 scratch cdfo_mdta_stage1 needs for `batch` images of h x wd
// on the current device, in floats; -1 if there is none.
extern "C" int cdfo_mdta_stage1_workspace(int batch, int h, int wd) {
  if (batch <= 0 || h <= 0 || wd <= 0) return -1;
  return workspace_floats(tiles_of(h, wd), batch, batch, 3 * GRAM);
}

// x, v: (batch, h, wd, 64) NHWC of one dtype (is_bf16: 1 bfloat16, 0
// float32); lnw, lnb: [64] float32; wqkv: the qkv 1x1 (192 out, 64 in) in
// ops/cuda_build.py::kernel_weights' layout; taps: [192][9] float32
// (3*dy + dx); ws: ws_floats of float32 scratch, as
// cdfo_mdta_stage1_workspace sizes it ([batch][parts][3][64][64]); stats:
// [batch][3][64][64] float32 out. Two launches (partials, reduction).
// Returns a cudaError_t.
extern "C" int cdfo_mdta_stage1(const void* x, const void* lnw, const void* lnb, const void* wqkv,
                                const void* taps, void* v, void* ws, int ws_floats, void* stats,
                                int is_bf16, int batch, int h, int wd, void* stream) {
  const int parts = parts_of(ws_floats, batch, 3 * GRAM);
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0 || parts <= 0) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch1<bf16>(x, lnw, lnb, wqkv, taps, v, ws, stats, batch, h, wd, parts, s)
                 : launch1<float>(x, lnw, lnb, wqkv, taps, v, ws, stats, batch, h, wd, parts, s);
}

// x, v, x2, out: (batch, h, wd, 64) NHWC; amat: [batch] per-image 64 x 64
// attention matrices (out, in) in kernel_weights' layout, one image per
// tap; wproj: the 1x1 projection, wconv: the 3x3 conv in that layout; bconv:
// [64]; all of one dtype. lnw, lnb: [64] float32. Returns a cudaError_t.
extern "C" int cdfo_mdta_stage2(const void* x, const void* v, const void* x2, const void* amat,
                                const void* wproj, const void* lnw, const void* lnb,
                                const void* wconv, const void* bconv, void* out, int is_bf16,
                                int batch, int h, int wd, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch2<bf16>(x, v, x2, amat, wproj, lnw, lnb, wconv, bconv, out, batch, h, wd,
                                 s)
                 : launch2<float>(x, v, x2, amat, wproj, lnw, lnb, wconv, bconv, out, batch, h,
                                  wd, s);
}
