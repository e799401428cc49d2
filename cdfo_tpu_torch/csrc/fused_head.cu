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
// What bounds it: ~91 K multiply-adds per 1x pixel (64->256 at 1x, 4 x
// 64->256 at 2x, 16 x 9 x 64 for conv_last at 4x), 0.096 ms of bf16
// tensor-core time at (4, 272, 480, 64); its bytes (t and lr in, 64 B of
// float32 out per 1x pixel) take less. The eager version writes and
// re-reads the 2x (256 ch) and 4x (64 ch) intermediates, ~0.27 GB per
// 272 x 480 frame for the 4x one alone. Here neither leaves the SM.
//
// bfloat16 (the main path), on wgmma (`wgmma_tile.cuh`). The first design
// (one 8 x 8 tile per CTA with a one-pixel halo, the 1x1 stages on
// mma.sync over the 10 x 10 window, conv_last on the CUDA cores from a
// 166 KB 4x window at an 8-way bank conflict) ran at 46x its bound. Now:
// - conv_last on the tensor cores as 9 tap partials: for each 4x pixel p,
//   z_tap(p) = sum_c wl[tap][c] f(p, c), one m64n16k16 product (N = 9 taps
//   padded to 16) per 64 pixels, then out(q) = bl + sum_tap z_tap(q +
//   d_tap) + up4(lr)(q), a 9-term shift-add in fp32. z is 36 bytes a 4x
//   pixel where the 4x feature was 128.
// - The three products chained through registers (the P.V trick of
//   fused_attention.cu): A of stage 1 is a window row of t in shared
//   memory; its accumulators, + bias, lrelu, rounded to bf16, are the
//   register A of stage 2 for each first-stage phase p1; stage 2's, +
//   bias, lrelu, rounded, zero outside the image, the register A of the
//   tap product. The 2x and 4x features never reach shared memory. W1, W2
//   (4 phase blocks of 64 x 64 each) and the 16 x 64 tap matrix stay
//   resident, one bulk copy per CTA (ops/fused_head.py::stage_head_weights).
// - A persistent walk down column strips. A strip is 62 output columns,
//   so a window row with its one-pixel halo is 64 pixels, one m64 tile.
//   Each CTA (one per SM) walks a contiguous run of 1x rows down the
//   strips, one row a step: warpgroup wg takes the phases p1 = 2wg, 2wg + 1
//   (4x rows 4k + 2wg, + 1), and the step's z rows go to a ring of 10 4x
//   rows, so that the vertical halo is never recomputed: a walk of n rows
//   costs n + 2 steps (the row above and the row below). The next t row
//   arrives by cp.async during the step, and the LR rows of the base one
//   step ahead. Warpgroup 0 adds up its half of the rows the step before
//   finished ahead of its products, warpgroup 1 after its own, so that one
//   warpgroup's shift-add runs beside the other's products. The products
//   are 1.03x what the outputs need (64 pixels for 62 columns) plus those
//   two rows a walk.
// - An accumulator becomes a register A only after its wait (a register A
//   written while a product is in flight serializes every wgmma), so a
//   warpgroup runs its two phases p1 side by side in each wait group, 6
//   groups a step. What bounds a step then is those conversions (bias,
//   lrelu, round, mask: 320 values a thread a step), not the tensor cores:
//   the first k-step of every sum overwrites its accumulators (scale_d = 0)
//   and lrelu is max(x, 0.1x), ~4 instructions a value.
// float32 (the twin for the float32 checks) keeps the first design in
// 4 x 8 tiles, its products on the CUDA cores.

#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 walk, summed over a CTA's
// steps: the wait for t's row at the step's barrier, the shift-add and
// stores of the rows the last step finished, the products and z stores.
#include "phase_clocks.cuh"

namespace {

using namespace cdfo;

// ---- float32: one CTA per 4 x 8 tile ---------------------------------------

template <typename T> struct Tile;
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

// ---- bfloat16: the walk on wgmma -------------------------------------------

constexpr int SW = 62;                    // output columns of a strip
constexpr int WIN = SW + 2;               // window pixels of a row: one m64 tile
constexpr int ZR = 10;                    // 4x rows of the z ring
constexpr int ZC = 4 * WIN;               // 4x columns of a z row
constexpr int ZP = ZR * ZC + 1;           // floats per tap plane (2-way stores, not 4)
constexpr int NTAP = 9;
constexpr int STAGE = C * C;              // bf16 of a 64 x 64 phase block
constexpr int WELEMS = 8 * STAGE + 16 * C;   // W1, W2 phase blocks, the tap matrix
constexpr int TROW = WIN * C;             // bf16 of a t window row
constexpr int SMEM_BF16 =
    1024 + WELEMS * 2 + 2 * TROW * 2 + 8 * C * 4 + 2 * 4 * WIN * 4 + 16 + NTAP * ZP * 4;
static_assert(THREADS == 4 * WIN, "a thread stages one LR value a step");
static_assert(ZR >= 10, "a step's z rows stay clear of the rows the last shift-add reads");
static_assert((WELEMS * 2) % 1024 == 0 && (TROW * 2) % 1024 == 0, "1024-byte aligned tiles");
static_assert(SMEM_BF16 <= 232448, "one block's shared memory");

// lrelu(acc + bias) (zero where !in), rounded to bf16, as the register A
// of the next product: k-step kk takes accumulator n-tiles 2kk, 2kk + 1
// (this lane's rows g and g + 8 of the warp's 16 hold columns 8j + t2, +1);
// lrelu(x) = max(x, 0.1 x), the same value in two instructions
__device__ __forceinline__ void to_a(const float (&acc)[8][4], const float* bias, int t2,
                                     bool in0, bool in8, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = 2 * kk + u;
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + t2);
      const float v0 = acc[j][0] + b.x, v1 = acc[j][1] + b.y;
      const float v2 = acc[j][2] + b.x, v3 = acc[j][3] + b.y;
      a[kk][2 * u] = in0 ? pack_bf16x2(fmaxf(v0, 0.1f * v0), fmaxf(v1, 0.1f * v1)) : 0u;
      a[kk][2 * u + 1] = in8 ? pack_bf16x2(fmaxf(v2, 0.1f * v2), fmaxf(v3, 0.1f * v3)) : 0u;
    }
}

__global__ void __launch_bounds__(THREADS, 1)
head_wgmma_kernel(const bf16* __restrict__ t, const bf16* __restrict__ lr,
                  const bf16* __restrict__ w, const bf16* __restrict__ b1,
                  const bf16* __restrict__ b2, const bf16* __restrict__ bl,
                  float* __restrict__ out, int batch, int h, int wd) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* ws = reinterpret_cast<bf16*>(base);   // W1 [4][64 n][64 k], W2 likewise, taps [16][64]
  bf16* ts = ws + WELEMS;                      // two t window rows, swizzled
  float* bs = reinterpret_cast<float*>(ts + 2 * TROW);   // b1 [4][64], b2 [4][64]
  float* lrs = bs + 8 * C;   // two sets of LR rows k - 2 .. k + 1, columns c0 - 1 ..
  uint64_t* bar = reinterpret_cast<uint64_t*>(lrs + 2 * 4 * WIN);
  float* z = reinterpret_cast<float*>(bar + 2);   // [tap][ring row][4x column]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int strips = (wd + SW - 1) / SW;
  const long long total = static_cast<long long>(batch) * strips * h;
  const long long g0 = blockIdx.x * total / gridDim.x, g1 = (blockIdx.x + 1) * total / gridDim.x;
  if (g0 >= g1) return;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, WELEMS * 2);
    bulk_copy(ws, w, WELEMS * 2, bar);
  }
  for (int i = threadIdx.x; i < 8 * C; i += THREADS) {
    bs[i] = __bfloat162float(i < 4 * C ? b1[i] : b2[i - 4 * C]);
  }
  const float blv = __bfloat162float(*bl);
  __syncthreads();

  // A walk: 1x rows [a, e) of the strip at column c0 of image b; it runs
  // the products of rows a - 1 .. e and the shift-adds of 4x row groups
  // a .. e (group k: 4x rows 4k - 1 .. 4k + 2, those of [4a, 4e) stored)
  struct Walk {
    int b, c0, a, e;
  };
  auto walk_at = [&](long long u) {
    const long long sb = u / h;
    const int i = static_cast<int>(u % h);
    Walk wk;
    wk.b = static_cast<int>(sb / strips);
    wk.c0 = static_cast<int>(sb % strips) * SW;
    wk.a = i;
    wk.e = static_cast<int>(g1 - u < h - i ? i + (g1 - u) : h);
    return wk;
  };
  // t's window row k of a walk (1x columns c0 - 1 .. c0 + 62) into slot
  // `slot`, swizzled, zero outside the image; one cp.async group
  auto fetch = [&](const Walk& wk, int k, int slot) {
    bf16* dst = ts + slot * TROW;
    const bf16* src = t + static_cast<long long>(wk.b) * h * wd * C;
    for (int i = threadIdx.x; i < WIN * 8; i += THREADS) {
      const int v = i & 7, m = i >> 3, x = wk.c0 - 1 + m;
      const bool in = k >= 0 && k < h && x >= 0 && x < wd;
      cp_async16_or_zero(dst + m * C + ((v ^ m) & 7) * 8,
                         src + (in ? (static_cast<long long>(k) * wd + x) * C + 8 * v : 0), in);
    }
    cp_async_commit();
  };
  // z ring row of 4x row y (y >= -4)
  auto zrow = [](int y) { return ((y + 4 * ZR) % ZR) * ZC; };
  // this thread's value of the LR rows that 4x row group k's base reads:
  // row k - 2 + tid / 64, column c0 - 1 + tid % 64, both clamped into the
  // image (the bilinear border rule)
  auto lr_value = [&](const Walk& wk, int k) {
    const int yy = min(max(k - 2 + static_cast<int>(threadIdx.x) / WIN, 0), h - 1);
    const int xx = min(max(wk.c0 - 1 + static_cast<int>(threadIdx.x) % WIN, 0), wd - 1);
    return __bfloat162float(lr[(static_cast<long long>(wk.b) * h + yy) * wd + xx]);
  };
  // out = bl + sum_tap z_tap(q + d_tap) + up4(lr)(q) for 4x row group k
  // (rows 4k - 1 .. 4k + 2): warpgroup `half` takes rows 2 half, 2 half + 1
  // of it, a thread columns x and x + 128 (x its index in the warpgroup),
  // so that every ring row, LR row and bilinear phase is fixed at compile
  // time
  auto shift_add = [&](const Walk& wk, int k, auto half) {
    int zo[6];   // ring rows of 4x rows 4k - 2 .. 4k + 3
#pragma unroll
    for (int r = 0; r < 6; ++r) zo[r] = zrow(4 * k - 2 + r);
    const float* lk = lrs + (k & 1) * 4 * WIN;
    float* ob = out + static_cast<long long>(wk.b) * 16 * h * wd;
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const int x = (threadIdx.x & 127) + 128 * cx, xx = 4 * wk.c0 + x;
      if (x >= 4 * SW || xx >= 4 * wd) continue;
      // up4: 4x phase r samples 1x position (2r - 3) / 8 from its pixel:
      // pixels lo, lo + 1 with lo = -1 (r < 2) or 0, weights 1 - f, f
      const int rx = x & 3;
      const float fx = ((2 * rx + 5) & 7) * 0.125f;
      const float* lc = lk + (x >> 2) + (rx >= 2);
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        constexpr int base_row = 2 * decltype(half)::value;
        const int rr = base_row + r2, y = 4 * k - 1 + rr;
        if (y < 4 * wk.a || y >= 4 * wk.e) continue;
        float acc = blv;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) acc += z[(3 * ky + kx) * ZP + zo[rr + ky] + x + 3 + kx];
        const int ry = (rr + 3) & 3;   // y & 3
        const float fy = ((2 * ry + 5) & 7) * 0.125f;
        const float* l0 = lc + ((rr + 3) / 4 + 1 - (ry < 2)) * WIN;   // LR row y / 4 - lo - (k - 2)
        const float top = (1.f - fx) * l0[0] + fx * l0[1];
        const float bot = (1.f - fx) * l0[WIN] + fx * l0[WIN + 1];
        ob[static_cast<long long>(y) * 4 * wd + xx] = acc + ((1.f - fy) * top + fy * bot);
      }
    }
  };
  using Lower = std::integral_constant<int, 0>;
  using Upper = std::integral_constant<int, 1>;
  // The products of 1x row k: this warpgroup's phases p1 = 2 wg + e, e =
  // 0, 1, side by side in each wait group (two independent chains), each
  // stage 1 -> stage 2 (4 phases p2) -> taps, z to the ring
  auto products = [&](const Walk& wk, int k, int slot) {
    const uint64_t adesc = wgmma_desc(ts + slot * TROW);
    const uint64_t w1d = wgmma_desc(ws + 2 * wg * STAGE);   // phase 2 wg; + 512 a phase
    const uint64_t w2d = wgmma_desc(ws + 4 * STAGE), tdesc = wgmma_desc(ws + 8 * STAGE);
    const int m0 = 16 * wl + g, x0 = wk.c0 - 1 + m0;
    const bool row_in = k >= 0 && k < h;
    const bool in0 = row_in && x0 >= 0 && x0 < wd, in8 = row_in && x0 + 8 < wd;
    float acc[2][8][4], zt[2][2][4];
    uint32_t a1[2][4][4], a2[2][4][4];
    // stage 1, both phases; its accumulators become stage 2's register A
    // (the first k-step of every sum overwrites its accumulators)
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_64x64(acc[e], adesc + 2 * kk, w1d + 512 * e + 2 * kk, kk);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      keep(acc[e]);
      to_a(acc[e], bs + (2 * wg + e) * C, t2, true, true, a1[e]);
    }
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64(acc[e], a1[e][kk], w2d + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(a1);
#pragma unroll
    for (int p2 = 0; p2 < 4; ++p2) {
      // stage 2 of phase p2 -> the taps' register A; stage 2's next phase
      // runs behind the taps
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        keep(acc[e]);
        to_a(acc[e], bs + 4 * C + p2 * C, t2, in0, in8, a2[e]);
      }
      wgmma_fence();
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_64x16(zt[e], a2[e][kk], tdesc + 2 * kk, kk);
      if (p2 < 3) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_64x64(acc[e], a1[e][kk], w2d + 512 * (p2 + 1) + 2 * kk, kk);
          }
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(zt);
      keep(a1);
      keep(a2);
      // z of 4x row 4k + 2 wg + dy2, columns 4m + 2e + dx2 (m: the
      // window pixel), taps t2, t2 + 1 and (lane t = 0) 8
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int y = 4 * k + 2 * wg + (p2 >> 1), col = 4 * m0 + 2 * e + (p2 & 1);
        float* zp = z + zrow(y) + col;
        zp[t2 * ZP] = zt[e][0][0];
        zp[(t2 + 1) * ZP] = zt[e][0][1];
        zp[t2 * ZP + 32] = zt[e][0][2];
        zp[(t2 + 1) * ZP + 32] = zt[e][0][3];
        if (t2 == 0) {
          zp[8 * ZP] = zt[e][1][0];
          zp[8 * ZP + 32] = zt[e][1][2];
        }
      }
    }
  };

  Walk wk = walk_at(g0);
  long long u = g0;   // the walk's first unit
  int k = wk.a - 1, slot = 0;
  fetch(wk, k, slot);
  mbar_wait(bar, 0);
  PHASE_START
#pragma unroll 1
  while (true) {
    cp_async_wait_n<0>();
    async_fence();
    __syncthreads();
    PHASE(0)
    // the next row: this walk's, or the first of the next walk
    const bool last = k == wk.e;
    const long long nu = u + (wk.e - wk.a);
    Walk nw = wk;
    int nk = k + 1;
    if (last && nu < g1) {
      nw = walk_at(nu);
      nk = nw.a - 1;
    }
    if (!last || nu < g1) fetch(nw, nk, slot ^ 1);
    // the LR values of this row's group, loaded now and stored after the
    // products (the shift-adds of this step read the other set)
    const float lrv = lr_value(wk, k);
    // warpgroup 0 adds its half of the last group up before the products,
    // warpgroup 1 after them, so that one's products run beside the
    // other's shift-add (the products stay on one code path)
    const bool add = k - 1 >= wk.a;
    if (add && wg == 0) shift_add(wk, k - 1, Lower());
    PHASE(1)
    products(wk, k, slot);
    PHASE(2)
    if (add && wg == 1) shift_add(wk, k - 1, Upper());
    lrs[(k & 1) * 4 * WIN + threadIdx.x] = lrv;
    PHASE(1)
    if (last) {
      __syncthreads();
      if (wg == 0) {
        shift_add(wk, k, Lower());
      } else {
        shift_add(wk, k, Upper());
      }
      PHASE(1)
      if (nu >= g1) break;
      u = nu;
    }
    wk = nw;
    k = nk;
    slot ^= 1;
    PHASE_STEP
  }
  PHASE_END
}

cudaError_t launch_f32(const void* t, const void* lr, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* wl, const void* bl, void* out,
                       int batch, int h, int wd, cudaStream_t stream) {
  using T = float;
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

cudaError_t launch_bf16(const void* t, const void* lr, const void* w, const void* b1,
                        const void* b2, const void* bl, void* out, int batch, int h, int wd,
                        cudaStream_t stream) {
  const cudaError_t err = allow_smem(head_wgmma_kernel, SMEM_BF16);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const long long units = static_cast<long long>(batch) * ((wd + SW - 1) / SW) * h;
  const dim3 grid(static_cast<unsigned>(units < sms ? units : sms));
  CDFO_LAUNCH(head_wgmma_kernel, grid, SMEM_BF16, stream, static_cast<const bf16*>(t),
              static_cast<const bf16*>(lr), static_cast<const bf16*>(w),
              static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
              static_cast<const bf16*>(bl), static_cast<float*>(out), batch, h, wd);
  return cudaGetLastError();
}

}  // namespace

// t: (batch, h, wd, 64) NHWC trunk output; lr: (batch, h, wd) LR frame;
// b1, b2: the upconvs' biases [256] with channels permuted phase-major
// (entry p*64 + c is torch's output channel c*4 + p); bl: conv_last's bias
// [1]; out: (batch, 4h, 4wd) float32. float32 (is_bf16 0): w1, w2 the 1x1
// weights (256 out x 64 in) with rows permuted phase-major in the Weights
// layout of conv3x3_tile.cuh, wl the [9 taps][64] conv_last weights.
// bfloat16 (is_bf16 1): w1 the weight stages of
// ops/fused_head.py::stage_head_weights (W1's and W2's phase blocks and the
// tap matrix, 128-byte swizzled), w2 and wl unused. t, lr and the weights
// share one dtype. Returns a cudaError_t.
extern "C" int cdfo_fused_head(const void* t, const void* lr, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* wl, const void* bl,
                               void* out, int is_bf16, int batch, int h, int wd, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(t, lr, w1, b1, b2, bl, out, batch, h, wd, s)
                 : launch_f32(t, lr, w1, b1, w2, b2, wl, bl, out, batch, h, wd, s);
}
