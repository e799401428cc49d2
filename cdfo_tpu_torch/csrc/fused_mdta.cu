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
// memory-bound (stage 1: 0.040 ms at (4, 272, 480, 64)); the eager round
// writes and re-reads ~15 full-resolution tensors (LN, qkv, depthwise, the
// head split, attention, projection, LN2, the conv and its skips). Each
// stage here reads its inputs once (plus a halo) and writes its outputs
// once; qkv, LN2(t) and t never leave the SM. Rounding follows the TPU
// kernels: LN1(x), qkv, q, k, v, A v, t (for the residual) and LN2(t) to
// the working type, everything else in fp32. Stage 1's statistics need
// every pixel: each block keeps its gram sums in registers and writes one
// partial, and a second launch adds the partials in a fixed order
// (gram_tile.cuh), so a result repeats bit for bit.
//
// Stage 1 in bfloat16 (the main path) is a walk on wgmma (`wgmma_tile.cuh`).
// The first design (one 8 x 16 tile at a time, six barrier phases in
// series, LN1 one pixel a thread over 180 of 256 threads at an 8-way bank
// conflict, qkv on mma.sync over the 10 x 18 halo window, 1.41x the
// interior) ran at 24x its bound. Now:
// - A persistent walk down column strips. A strip is 62 output columns, so
//   a window row with its halo is 64 pixels, one m64 tile. Each block
//   walks a contiguous run of rows of one image (sms / batch blocks an
//   image, so one block an SM), one window row a step: LN1 of the new x
//   row (8 lanes a pixel, 16-byte chunks, shuffle sums), its qkv on wgmma
//   (each warpgroup m64n96, W_qkv resident) rounded into a ring of three
//   qkv rows (float32 values, so the depthwise reads them without
//   unpacking), then the depthwise 3x3 of the output row between them.
//   The vertical halo is computed once per walk (two rows), the horizontal
//   one 64 / 62.
// - The depthwise is the bulk of a step (36 fp32 FMAs a pixel and channel
//   quadruple). Read tap by tap from shared memory it cost ~14k
//   wavefronts a step; each thread instead keeps its four channels' taps
//   in registers and slides along a run of ~12 pixels, reading one new
//   window column (3 x 16 bytes) a pixel.
// - The grams on wgmma with the pixels as K: the output row's q and k go
//   to two 128-byte swizzled tiles (zero on the halo and outside the
//   image), read MN-major as A (q or k, one per warpgroup: a select, one
//   code path) and B ([k | q], two 64-column blocks): warpgroup 0 sums q^T
//   k and q^T q, warpgroup 1 k^T k (and k^T q, dropped). The accumulators
//   stay in registers for the whole walk; the products of a row run in
//   the wgmma group of the next row's qkv.
// - The next x row arrives by cp.async during the step.
// Stage 2 in bfloat16 is a walk on wgmma too. The first design (one CTA of
// 8 warps per 8 x 16 tile over a 10 x 18 window, so both 1x1s ran over
// 1.41x the pixels the outputs need, four barrier phases in series, all
// three products on mma.sync with every weight fragment from device memory
// in every warp, LN2 one pixel a thread from an fp32 t window) ran at 8x
// its bound. Now the 62-column strip walk of `wgmma_tile.cuh`
// (`StripStep`, one CTA an SM over every image), two window rows a step,
// one per warpgroup:
// - o = v A^T on SS wgmma m64n64 (this image's A resident, 8 KB, fetched
//   with the first rows of each walk), rounded into register A after its
//   wait, then the projection as RS wgmma m64n64 (W_proj resident); t = x
//   + proj is formed in fp32 in the accumulators (zero outside the image,
//   as v and x are there).
// - LN2 straight from the accumulators: a pixel's 64 channels sit in the 4
//   lanes of a quad, so two shfl_xor steps give mu and E[x^2]. LN2(t) is
//   rounded (zero outside the image: the conv's padding) into a ring of 4
//   swizzled window rows, t rounded into a ring of 3 for the residual.
// - The output row's 3x3 is `conv3x3_row` over the LN2 ring (the 72 KB of
//   conv weights resident); its epilogue adds b + t (rounded) + x2 in fp32
//   and stores bf16 once. The vertical halo is computed once per walk (its
//   warm-up step runs the 1x1s and LN2 of its two rows and no conv).
// - The rows arrive by the TMA unit (`tma_load_row`, zero outside the
//   image): x2's a step ahead, v's and x's (one buffer) once the step
//   before is done with them, before its conv. (Fetched by cp.async, a
//   step's 3072 16-byte copies took ~2.5k cycles to issue.) The output
//   row, rounded in place of x2's, leaves by the TMA unit too
//   (`tma_store_row`).
// Stage 1 and stage 2 in float32 (the twins for the float32 checks) keep
// the first design: one CTA of 8 warps per TH x TW output tile with a
// one-pixel halo window in shared memory, the 1x1 convolutions as implicit
// GEMMs over the window on conv3x3_tile.cuh's tile routine (fp32 on the
// CUDA cores), the depthwise 3x3 and the LayerNorms in fp32, one pixel per
// thread; stage 1's float32 blocks walk every `parts`-th tile of their
// image.

#include "gram_tile.cuh"
#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 walks, summed over a CTA's
// steps. Stage 1: the wait for x's row at the step's barrier, LN1, the
// products (qkv and the last row's grams) with the ring stores, the
// depthwise with the q, k and v stores, the fence and barrier after LN1.
// Stage 2: the wait for the step's rows at its barrier, o and the
// projection, t and LN2 with the ring stores, the fence and barrier before
// the conv, the conv's products, its epilogue and the store's issue.
#include "phase_clocks.cuh"

namespace {

using namespace cdfo;

constexpr int TH = 8, TW = 16;                 // output tile
constexpr int WH = TH + 2, WW = TW + 2;        // window with the halo
constexpr int WPIX = WH * WW, NPIX = TH * TW;  // 180, 128
constexpr int C3 = 3 * C;

// qkv: 192 channels plus padding per window pixel
template <typename T> struct QkvPitch;
template <> struct QkvPitch<float> { static constexpr int value = 196; };

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

// ---- stage 1, bfloat16: the walk on wgmma ----------------------------------

constexpr int SW = 62;                  // output columns of a strip
constexpr int WIN = SW + 2;             // window pixels of a row: one m64 tile
constexpr int QP = 200;                 // floats per pixel of a qkv ring row (conflict-free pairs)
constexpr int WQ_BYTES = C3 * C * 2;    // W_qkv, resident
constexpr int TILE = WIN * C;           // bf16 of a window row of 64 channels
constexpr int SMEM1_BF16 =
    1024 + WQ_BYTES + 4 * TILE * 2 + 3 * WIN * QP * 4 + 16;
// the depthwise: 48 four-channel chunks x 5 runs of output pixels
constexpr int RUNS = 5;
static_assert(RUNS * C3 / 4 < THREADS, "threads left for the halo pixels");
static_assert(WQ_BYTES % 1024 == 0 && (TILE * 2) % 1024 == 0, "1024-byte aligned tiles");
static_assert(SMEM1_BF16 <= 232448, "one block's shared memory");

__global__ void __launch_bounds__(THREADS, 1)
mdta1_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ lnw,
                   const float* __restrict__ lnb, const bf16* __restrict__ wq,
                   const float* __restrict__ taps, bf16* __restrict__ v, float* __restrict__ ws,
                   int h, int wd, int parts) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* wqs = reinterpret_cast<bf16*>(base);   // W_qkv [192 n][64 k], swizzled
  bf16* ln = wqs + C3 * C;                      // LN1(x) of a window row, swizzled
  bf16* kt = ln + TILE;                         // k of an output row, swizzled
  bf16* qt = kt + TILE;                         // q, TILE after k: B's second block
  bf16* xs = qt + TILE;                         // x of a window row, pixel-major
  float* ring = reinterpret_cast<float*>(xs + TILE);   // qkv of 3 window rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 3 * WIN * QP);

  const int img = blockIdx.y, part = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int strips = (wd + SW - 1) / SW;
  const long long units = static_cast<long long>(strips) * h;
  const long long u0 = part * units / parts, u1 = (part + 1) * units / parts;
  const bf16* xb = x + static_cast<long long>(img) * h * wd * C;
  bf16* vb = v + static_cast<long long>(img) * h * wd * C;
  // this warpgroup's grams, over the whole walk: A^T [k | q] with A = q
  // (warpgroup 0: q^T k, q^T q) or k (warpgroup 1: k^T k, then k^T q,
  // which is dropped)
  float gacc[16][4];
  zero1(gacc);

  if (u0 < u1) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
      mbar_expect_tx(bar, WQ_BYTES);
      bulk_copy(wqs, wq, WQ_BYTES, bar);
    }
    auto zero_qk = [&] {
      for (int i = threadIdx.x; i < 2 * TILE / 8; i += THREADS) {
        reinterpret_cast<uint4*>(kt)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    };
    zero_qk();
    // LayerNorm: 8 lanes a pixel, this lane's channels 8 cc .. 8 cc + 7
    const int cc = threadIdx.x & 7;
    float lw[8], lb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lw[i] = __ldg(lnw + 8 * cc + i);
      lb[i] = __ldg(lnb + 8 * cc + i);
    }
    __syncthreads();

    // A walk: output rows [a, e) of the strip at column c0; it runs the
    // window rows a - 1 .. e (LN1, qkv) and the output rows' depthwise
    struct Walk {
      int c0, a, e;
    };
    auto walk_at = [&](long long u) {
      const int i = static_cast<int>(u % h);
      Walk wk;
      wk.c0 = static_cast<int>(u / h) * SW;
      wk.a = i;
      wk.e = static_cast<int>(u1 - u < h - i ? i + (u1 - u) : h);
      return wk;
    };
    // x of window row j (columns c0 - 1 .. c0 + 62), zero outside the image
    auto fetch = [&](const Walk& wk, int j) {
      for (int i = threadIdx.x; i < WIN * 8; i += THREADS) {
        const int c8 = i & 7, m = i >> 3, xx = wk.c0 - 1 + m;
        const bool in = j >= 0 && j < h && xx >= 0 && xx < wd;
        cp_async16_or_zero(xs + m * C + 8 * c8,
                           xb + (in ? (static_cast<long long>(j) * wd + xx) * C + 8 * c8 : 0), in);
      }
      cp_async_commit();
    };
    auto ring_row = [&](int j) { return ring + ((j + 3) % 3) * WIN * QP; };
    // LN1(x) of the window row in xs, E[x^2] - mu^2, rounded, to `ln`
    auto layer_norm1 = [&] {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = (threadIdx.x >> 3) + 32 * r;
        float f[8];
        load8(xs + p * C + 8 * cc, f);
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s += f[i];
          q += f[i] * f[i];
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          q += __shfl_xor_sync(0xffffffffu, q, o);
        }
        const float mu = s * (1.f / C);
        const float rs = rsqrtf(q * (1.f / C) - mu * mu + 1e-5f);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = (f[i] - mu) * rs * lw[i] + lb[i];
        store8(ln + p * C + ((cc ^ p) & 7) * 8, f);
      }
    };
    // the grams of the q, k tiles (both warpgroups on one code path: the
    // A tile is a select)
    const uint64_t gad = wgmma_desc(wg ? kt : qt, 1024), gbd = wgmma_desc(kt, TILE * 2);
    auto grams = [&] {
#pragma unroll
      for (int kk = 0; kk < WIN / 16; ++kk) {
        wgmma_ss_64x128_tt(gacc, gad + 128 * kk, gbd + 128 * kk);
      }
    };
    // qkv of window row j = LN1(x) W_qkv^T (this warpgroup's 96 channels),
    // after the grams of the tiles the last depthwise left; rounded, zero
    // outside the image, into the ring
    auto products = [&](const Walk& wk, int j) {
      float acc[12][4];   // the first k-step overwrites it
      keep(gacc);
      const uint64_t ad = wgmma_desc(ln), bd = wgmma_desc(wqs + 96 * wg * C);
      wgmma_fence();
      grams();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x96(acc, ad + 2 * kk, bd + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(gacc);
      const int m0 = 16 * wl + g, x0 = wk.c0 - 1 + m0;
      const bool row_in = j >= 0 && j < h;
      const bool in0 = row_in && x0 >= 0 && x0 < wd, in8 = row_in && x0 + 8 < wd;
      float* rr = ring_row(j) + m0 * QP + 96 * wg + t2;
#pragma unroll
      for (int jj = 0; jj < 12; ++jj) {
        *reinterpret_cast<float2*>(rr + 8 * jj) =
            in0 ? make_float2(round_to(acc[jj][0], bf16()), round_to(acc[jj][1], bf16()))
                : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(rr + 8 * QP + 8 * jj) =
            in8 ? make_float2(round_to(acc[jj][2], bf16()), round_to(acc[jj][3], bf16()))
                : make_float2(0.f, 0.f);
      }
    };
    // the depthwise 3x3 of output row k in fp32: q and k rounded into their
    // tiles (zero on the halo pixels and outside the image), v rounded to
    // device memory. Thread (run, c4) < RUNS * 48 slides along its run of
    // output pixels with its four channels' taps in registers, reading one
    // new window column (3 rows) a pixel; the last 16 threads zero the
    // halo pixels' q and k.
    const int c4 = threadIdx.x % (C3 / 4), run = threadIdx.x / (C3 / 4);
    float tw[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tw[tap][e] = run < RUNS ? __ldg(taps + tap * C3 + 4 * c4 + e) : 0.f;
      }
    auto depthwise = [&](const Walk& wk, int k) {
      if (run >= RUNS) {
        for (int i = threadIdx.x - RUNS * (C3 / 4); i < 32; i += THREADS - RUNS * (C3 / 4)) {
          const int m = i & 16 ? WIN - 1 : 0;
          reinterpret_cast<uint4*>(i & 8 ? kt : qt)[m * 8 + (i & 7)] = make_uint4(0u, 0u, 0u, 0u);
        }
        return;
      }
      const float* rows[3] = {ring_row(k - 1), ring_row(k), ring_row(k + 1)};
      const int m0 = 1 + run * SW / RUNS, m1 = 1 + (run + 1) * SW / RUNS;
      float col[3][3][4];   // window columns, [column % 3][row][channel]
      auto load_col = [&](float (&cl)[3][4], int m) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4 u = *reinterpret_cast<const float4*>(rows[dy] + m * QP + 4 * c4);
          cl[dy][0] = u.x;
          cl[dy][1] = u.y;
          cl[dy][2] = u.z;
          cl[dy][3] = u.w;
        }
      };
      load_col(col[0], m0 - 1);
      load_col(col[1], m0);
      // unrolled over the longest run, so that the columns rotate by index
#pragma unroll
      for (int u = 0; u < (SW + RUNS - 1) / RUNS; ++u) {
        const int m = m0 + u;
        if (m >= m1) break;
        load_col(col[(u + 2) % 3], m + 1);
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[e] = fmaf(tw[3 * dy + dx][e], col[(u + dx) % 3][dy][e], s[e]);
            }
        const int xx = wk.c0 - 1 + m;
        const bool valid = xx < wd;
        const uint2 r = make_uint2(valid ? pack_bf16x2(s[0], s[1]) : 0u,
                                   valid ? pack_bf16x2(s[2], s[3]) : 0u);
        if (c4 < 32) {
          bf16* tile = c4 < 16 ? qt : kt;
          *reinterpret_cast<uint2*>(tile + m * C + ((((c4 & 15) >> 1) ^ m) & 7) * 8 +
                                    4 * (c4 & 1)) = r;
        } else if (valid) {
          *reinterpret_cast<uint2*>(vb + (static_cast<long long>(k) * wd + xx) * C +
                                    4 * (c4 - 32)) = r;
        }
      }
    };

    Walk wk = walk_at(u0);
    long long u = u0;   // the walk's first unit
    int j = wk.a - 1;
    fetch(wk, j);
    mbar_wait(bar, 0);
    PHASE_START
#pragma unroll 1
    while (true) {
      cp_async_wait_n<0>();
      __syncthreads();
      PHASE(0)
      layer_norm1();
      PHASE(1)
      async_fence();
      __syncthreads();
      PHASE(4)
      // the next row: this walk's, or the first of the next walk
      const bool last = j == wk.e;
      const long long nu = u + (wk.e - wk.a);
      Walk nw = wk;
      int nj = j + 1;
      if (last && nu < u1) {
        nw = walk_at(nu);
        nj = nw.a - 1;
      }
      if (!last || nu < u1) fetch(nw, nj);
      products(wk, j);
      __syncthreads();
      PHASE(2)
      if (j - 1 >= wk.a) depthwise(wk, j - 1);
      PHASE(3)
      if (last) {
        // the grams of the walk's last row, then clean tiles for the next
        async_fence();
        __syncthreads();
        keep(gacc);
        wgmma_fence();
        grams();
        wgmma_commit();
        wgmma_wait<0>();
        keep(gacc);
        __syncthreads();
        zero_qk();
        PHASE(2)
        if (nu >= u1) break;
        u = nu;
      }
      wk = nw;
      j = nj;
      PHASE_STEP
    }
    PHASE_END
  }
  // this CTA's partial: warpgroup 0 holds q^T k and q^T q, 1 k^T k
  float* dst = ws + (static_cast<long long>(img) * parts + part) * 3 * GRAM;
  const int c = 16 * wl + g;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int gram = wg == 0 ? jj / 8 : 2;
    if (wg == 1 && jj >= 8) continue;
    float* o = dst + gram * GRAM + c * C + 8 * (jj % 8) + t2;
    store2(o, gacc[jj][0], gacc[jj][1]);
    store2(o + 8 * C, gacc[jj][2], gacc[jj][3]);
  }
}

// ---- stage 2, bfloat16: the walk on wgmma ----------------------------------

constexpr int CONV_BYTES = 9 * C * C * 2;   // the conv's 9 taps, resident
constexpr int MAT_BYTES = C * C * 2;        // a 64 x 64 matrix (W_proj, A)
constexpr int ROW_BYTES = TILE * 2;         // a 64-pixel window row
// conv taps | W_proj | A of the walk's image | LN2(t) ring (+ 8 pixel rows:
// the taps' overread, alignment) | t ring | v, x rows of a step | x2 rows,
// then the output rows in their place, [2 steps][2 rows] | mbarriers: the
// conv's, W_proj's, v and x's, x2's two
constexpr int SMEM2_BF16 = 1024 + CONV_BYTES + 2 * MAT_BYTES + (4 * TILE + 8 * C) * 2 +
                           3 * ROW_BYTES + 4 * ROW_BYTES + 4 * ROW_BYTES + 40;
static_assert(CONV_BYTES % 1024 == 0 && MAT_BYTES % 1024 == 0, "1024-byte aligned tiles");
static_assert(SMEM2_BF16 <= 232448, "one block's shared memory");

__global__ void __launch_bounds__(THREADS, 1)
mdta2_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tx2,
                   const __grid_constant__ CUtensorMap tamat,
                   const __grid_constant__ CUtensorMap tout, const bf16* __restrict__ wproj,
                   const float* __restrict__ lnw, const float* __restrict__ lnb,
                   const bf16* __restrict__ wconv, const bf16* __restrict__ bconv, int batch,
                   int h, int wd) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* wc = reinterpret_cast<bf16*>(base);   // conv [9 taps][64 n][64 k], swizzled
  bf16* wp = wc + 9 * C * C;                   // W_proj [64 n][64 k], swizzled
  bf16* am = wp + C * C;                       // A of the walk's image [64 n][64 k], swizzled
  bf16* ln = am + C * C;                       // LN2(t) of 4 window rows, swizzled
  bf16* tr = ln + 4 * TILE + 8 * C;            // t, rounded, of 3 window rows, swizzled
  bf16* vx = tr + 3 * TILE;                    // v rows j, j + 1, then x rows j, j + 1
  bf16* x2s = vx + 4 * TILE;                   // x2 rows, then the output rows [2 steps][2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(x2s + 4 * TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int strips = (wd + STRIP - 1) / STRIP;
  const long long total = static_cast<long long>(batch) * strips * h;
  const long long g0 = blockIdx.x * total / gridDim.x, g1 = (blockIdx.x + 1) * total / gridDim.x;
  if (g0 >= g1) return;

  // v's and x's window rows j, j + 1 of step s and, at a walk's warm-up,
  // its image's A, by the TMA unit on mbarrier 2
  auto fetch_vx = [&](const StripStep& s) {
    const bool warm = s.j < s.a;
    mbar_expect_tx(bars + 2, 4 * ROW_BYTES + (warm ? MAT_BYTES : 0));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tma_load_row(vx + r * TILE, &tv, s.c0 - 1, s.j + r, s.b, bars + 2);
      tma_load_row(vx + (2 + r) * TILE, &tx, s.c0 - 1, s.j + r, s.b, bars + 2);
    }
    if (warm) tma_load_row(am, &tamat, 0, 0, s.b, bars + 2);
  };
  // x2's rows of step t's output rows j - 1, j (a warm-up's are not used)
  // into set t % 2, on mbarrier 3 + t % 2
  auto fetch_x2 = [&](const StripStep& s, int t) {
    uint64_t* bar = bars + 3 + (t & 1);
    mbar_expect_tx(bar, 2 * ROW_BYTES);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tma_load_row(x2s + (2 * (t & 1) + r) * TILE, &tx2, s.c0, s.j - 1 + r, s.b, bar);
    }
  };

  StripStep s = strip_walk_at(g0, g1, h, strips), n;
  bool more = strip_next(s, g1, h, strips, n);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, CONV_BYTES);
    bulk_copy(wc, wconv, CONV_BYTES, bars);
    mbar_expect_tx(bars + 1, MAT_BYTES);
    bulk_copy(wp, wproj, MAT_BYTES, bars + 1);
    fetch_vx(s);
    fetch_x2(s, 0);
  }
  // LN2's weight and bias and the conv's bias on this lane's channels
  // 8 jj + t2, + 1
  float2 lw[8], lb[8], bc[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    lw[jj] = load2(lnw + 8 * jj + t2);
    lb[jj] = load2(lnb + 8 * jj + t2);
    bc[jj] = load2(bconv + 8 * jj + t2);
  }
  __syncthreads();
  mbar_wait(bars, 0);
  mbar_wait(bars + 1, 0);

  int t = 0;   // the CTA's step count: window row j + r is LN2 ring row 2t + r
  PHASE_START
#pragma unroll 1
  while (true) {
    mbar_wait(bars + 2, static_cast<uint32_t>(t & 1));
    mbar_wait(bars + 3 + (t & 1), static_cast<uint32_t>((t >> 1) & 1));
    bulk_wait_read();   // the last step's output rows have left shared memory
    __syncthreads();
    PHASE(0)
    if (threadIdx.x == 0 && more) fetch_x2(n, t + 1);
    {
      // window row j + wg: o = v A^T, rounded into register A, then proj
      float acc[8][4];
      const uint64_t vd = wgmma_desc(vx + wg * TILE), ad = wgmma_desc(am);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(acc, vd + 2 * kk, ad + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      uint32_t oa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          oa[kk][2 * u] = pack_bf16x2(acc[2 * kk + u][0], acc[2 * kk + u][1]);
          oa[kk][2 * u + 1] = pack_bf16x2(acc[2 * kk + u][2], acc[2 * kk + u][3]);
        }
      const uint64_t pd = wgmma_desc(wp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64(acc, oa[kk], pd + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(oa);
      PHASE(1)
      // t = x + proj(o) in fp32 (zero outside the image, as v and x are);
      // LN2(t) with E[x^2] - mu^2 over the quad's 64 channels, rounded,
      // zero outside the image, and t rounded, into their rings
      const int jr = s.j + wg;
      const bool row_in = jr >= 0 && jr < h;
      bf16* xr = vx + (2 + wg) * TILE;
      bf16* lnr = ln + ((2 * t + wg) & 3) * TILE;
      bf16* trr = tr + ((2 * t + wg) % 3) * TILE;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 16 * wl + g + 8 * half, xx = s.c0 - 1 + m;
        const bool in = row_in && xx >= 0 && xx < wd;
        float sum = 0.f, sq = 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 xv = load2(swizzled(xr, m, 8 * jj + t2));
          acc[jj][2 * half] += xv.x;
          acc[jj][2 * half + 1] += xv.y;
          const float a0 = acc[jj][2 * half], a1 = acc[jj][2 * half + 1];
          sum += a0 + a1;
          sq += a0 * a0 + a1 * a1;
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
          sq += __shfl_xor_sync(0xffffffffu, sq, o);
        }
        const float mu = sum * (1.f / C);
        const float rs = rsqrtf(sq * (1.f / C) - mu * mu + 1e-5f);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float a0 = acc[jj][2 * half], a1 = acc[jj][2 * half + 1];
          store2(swizzled(trr, m, 8 * jj + t2), a0, a1);
          store2(swizzled(lnr, m, 8 * jj + t2), in ? (a0 - mu) * rs * lw[jj].x + lb[jj].x : 0.f,
                 in ? (a1 - mu) * rs * lw[jj].y + lb[jj].y : 0.f);
        }
      }
      PHASE(2)
    }
    async_fence();
    __syncthreads();
    PHASE(3)
    // the 1x1s are done with v, x and A: the next step's
    if (threadIdx.x == 0 && more) fetch_vx(n);
    if (s.j >= s.a) {   // past the walk's warm-up (the same branch for the whole CTA)
      // this warpgroup's output row y = j - 1 + wg, from LN2 rows y - 1 .. y + 1
      float acc[8][4];
      conv3x3_row(acc, ln + ((2 * t - 2 + wg) & 3) * TILE, ln + ((2 * t - 1 + wg) & 3) * TILE,
                  ln + ((2 * t + wg) & 3) * TILE, wc);
      wgmma_wait<0>();
      keep(acc);
      PHASE(4)
      // out = acc + b + t (rounded) + x2, rounded once, in place of the x2
      // row; then one thread of the warpgroup stores the row's 62 pixels by
      // the TMA unit (those past the image are skipped)
      const int y = s.j - 1 + wg;
      bf16* trr = tr + ((2 * t - 1 + wg) % 3) * TILE;
      bf16* row = x2s + (2 * (t & 1) + wg) * TILE;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = 16 * wl + g + 8 * half;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          bf16* p = swizzled(row, q, 8 * jj + t2);
          const float2 tv = load2(swizzled(trr, q + 1, 8 * jj + t2));
          const float2 sv = load2(p);
          store2(p, acc[jj][2 * half] + bc[jj].x + tv.x + sv.x,
                 acc[jj][2 * half + 1] + bc[jj].y + tv.y + sv.y);
        }
      }
      async_fence();
      warpgroup_sync(wg);
      if ((threadIdx.x & 127) == 0 && y < s.e) {
        tma_store_row(&tout, row, s.c0, y, s.b);
        bulk_commit();
      }
      PHASE(5)
    }
    if (!more) break;
    s = n;
    more = strip_next(s, g1, h, strips, n);
    ++t;
    PHASE_STEP
  }
  bulk_wait_read();
  PHASE_END
}

int tiles_of(int h, int wd) { return ((h + TH - 1) / TH) * ((wd + TW - 1) / TW); }

cudaError_t launch1(const void* x, const void* lnw, const void* lnb, const void* wqkv,
                    const void* taps, void* v, void* ws, void* stats, int is_bf16, int batch,
                    int h, int wd, int parts, cudaStream_t stream) {
  if (is_bf16) {
    const cudaError_t err = allow_smem(mdta1_wgmma_kernel, SMEM1_BF16);
    if (err != cudaSuccess) return err;
    CDFO_LAUNCH(mdta1_wgmma_kernel, dim3(parts, batch), SMEM1_BF16, stream,
                static_cast<const bf16*>(x), static_cast<const float*>(lnw),
                static_cast<const float*>(lnb), static_cast<const bf16*>(wqkv),
                static_cast<const float*>(taps), static_cast<bf16*>(v), static_cast<float*>(ws),
                h, wd, parts);
  } else {
    using T = float;
    const cudaError_t err = allow_smem(mdta1_kernel<T>, s1_smem<T>());
    if (err != cudaSuccess) return err;
    CDFO_LAUNCH(mdta1_kernel<T>, dim3(parts, batch), s1_smem<T>(), stream,
                static_cast<const T*>(x), static_cast<const float*>(lnw),
                static_cast<const float*>(lnb), static_cast<const T*>(wqkv),
                static_cast<const float*>(taps), static_cast<T*>(v), static_cast<float*>(ws), h,
                wd, parts);
  }
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return e1;
  return launch_reduce(static_cast<const float*>(ws), parts, 3 * GRAM, 3 * GRAM,
                       static_cast<float*>(stats), nullptr, batch, stream);
}

cudaError_t launch2(const void* x, const void* v, const void* x2, const void* amat,
                    const void* wproj, const void* lnw, const void* lnb, const void* wconv,
                    const void* bconv, void* out, int is_bf16, int batch, int h, int wd,
                    cudaStream_t stream) {
  if (is_bf16) {
    cudaError_t err = allow_smem(mdta2_wgmma_kernel, SMEM2_BF16);
    if (err != cudaSuccess) return err;
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorInvalidValue;
    CUtensorMap tx, tv, tx2, tamat, tout;
    if ((err = nhwc_tensor_map(&tx, x, batch, h, wd, STRIP_WIN)) != cudaSuccess ||
        (err = nhwc_tensor_map(&tv, v, batch, h, wd, STRIP_WIN)) != cudaSuccess ||
        (err = nhwc_tensor_map(&tx2, x2, batch, h, wd, STRIP_WIN)) != cudaSuccess ||
        (err = nhwc_tensor_map(&tamat, amat, batch, 1, C, C)) != cudaSuccess ||
        (err = nhwc_tensor_map(&tout, out, batch, h, wd, STRIP)) != cudaSuccess) {
      return err;
    }
    const long long units = static_cast<long long>(batch) * ((wd + STRIP - 1) / STRIP) * h;
    const dim3 grid(static_cast<unsigned>(units < sms ? units : sms));
    CDFO_LAUNCH(mdta2_wgmma_kernel, grid, SMEM2_BF16, stream, tx, tv, tx2, tamat, tout,
                static_cast<const bf16*>(wproj), static_cast<const float*>(lnw),
                static_cast<const float*>(lnb), static_cast<const bf16*>(wconv),
                static_cast<const bf16*>(bconv), batch, h, wd);
    return cudaGetLastError();
  }
  using T = float;
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
// of the dtype is_bf16 names on the current device, in floats; -1 if there
// is none. bfloat16: one walk per SM, sms / batch of them an image (at
// least 1, at most one per strip row); float32: workspace_floats' two
// blocks an SM over the 8 x 16 tiles.
extern "C" int cdfo_mdta_stage1_workspace(int batch, int h, int wd, int is_bf16) {
  if (batch <= 0 || h <= 0 || wd <= 0) return -1;
  if (!is_bf16) return workspace_floats(tiles_of(h, wd), batch, batch, 3 * GRAM);
  const int sms = sm_count();
  if (sms <= 0) return -1;
  const long long units = static_cast<long long>((wd + SW - 1) / SW) * h;
  long long parts = sms / batch;
  parts = parts < 1 ? 1 : parts > units ? units : parts > 65535 ? 65535 : parts;
  const long long n = parts * batch * 3 * GRAM;
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// x, v: (batch, h, wd, 64) NHWC of one dtype (is_bf16: 1 bfloat16, 0
// float32); lnw, lnb: [64] float32; ws: ws_floats of float32 scratch, as
// cdfo_mdta_stage1_workspace sizes it ([batch][parts][3][64][64]); stats:
// [batch][3][64][64] float32 out. float32: wqkv the qkv 1x1 (192 out, 64
// in) in ops/cuda_build.py::kernel_weights' layout, taps [192][9] float32
// (3*dy + dx); bfloat16: wqkv the (192 n, 64 k) 128-byte swizzled tile of
// ops/fused_mdta.py::pack_stage1_weights, taps [9][192] float32. Two launches (partials, reduction). Returns a cudaError_t.
extern "C" int cdfo_mdta_stage1(const void* x, const void* lnw, const void* lnb, const void* wqkv,
                                const void* taps, void* v, void* ws, int ws_floats, void* stats,
                                int is_bf16, int batch, int h, int wd, void* stream) {
  const int parts = parts_of(ws_floats, batch, 3 * GRAM);
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0 || parts <= 0) {
    return cudaErrorInvalidValue;
  }
  return launch1(x, lnw, lnb, wqkv, taps, v, ws, stats, is_bf16, batch, h, wd, parts,
                 static_cast<cudaStream_t>(stream));
}

// x, v, x2, out: (batch, h, wd, 64) NHWC (bfloat16: 16-byte aligned);
// bconv: [64]; all of one dtype (is_bf16: 1 bfloat16, 0 float32). lnw, lnb: [64] float32. float32: amat
// the [batch] per-image 64 x 64 attention matrices (out, in) in
// kernel_weights' layout, one image per tap, wproj the 1x1 projection and
// wconv the 3x3 conv in that layout; bfloat16: amat (batch, 64 out, 64 in)
// as it is, wproj and wconv the swizzled tiles of
// ops/fused_mdta.py::pack_stage2_weights. Returns a cudaError_t.
extern "C" int cdfo_mdta_stage2(const void* x, const void* v, const void* x2, const void* amat,
                                const void* wproj, const void* lnw, const void* lnb,
                                const void* wconv, const void* bconv, void* out, int is_bf16,
                                int batch, int h, int wd, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0) return cudaErrorInvalidValue;
  return launch2(x, v, x2, amat, wproj, lnw, lnb, wconv, bconv, out, is_bf16, batch, h, wd,
                 static_cast<cudaStream_t>(stream));
}
