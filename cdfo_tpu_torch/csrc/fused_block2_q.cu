// The int8 SCNet Block_, hand-written for Hopper (sm_90a): the Block_ of
// fused_block2.cu,
//   out = x + body(x) + kd(fold(body1(up2(ku x)))) + up2(ku(body(kd(down2 x))))
// with conv1 at 1x and 2x, conv2 at 1x and the down2-folded conv2 as
// int8 x int8 -> int32 tensor-core products, and the 0.5x branch, the 1x1
// convs, the resizes and the residual in the working type T (bfloat16, or
// float32 for the card-vs-CPU checks).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_block2_q.py::scale_block_hcw_q
// (kernel body _kernel), which the int8 trunk launches 21 times per call.
// The quantization scheme is that file's (see ops/fused_block2_q.py):
// int8 weights per output channel from the host; per step the masked input
// window xm quantized with its own amax and the 2x planes u with amax(z);
// the lrelu'd conv1 outputs y1, y2 quantized with a lagged running scale
// (1.25 x the largest amax of the earlier steps of the strip, step 0 from
// the analytic bound); int32 sums dequantised by s_act * s_w[channel].
// Where the TPU kernel clips y values past the lagged scale, a step whose
// y1 or y2 values pass it runs again with that scale set to their own
// amax (the amax is the values', which the scale does not change), so
// nothing clips: the TPU's clipping, at the top and bottom rows where y1
// outgrows the lag, cost the int8 trunk its 0.05 dB budget on a trained
// model (PERF.md). A step done again costs a second pass of all its work;
// in bfloat16 the walk lists such steps for a launch of their own (run in
// the walk, they cost more: PERF.md), float32 runs them again in place.
// Every float step that sets a quantized value is written without fused
// multiply-add, so that it rounds as the plain version does.
//
// What bounds it: operations, as fused_block2.cu (~1.27 TOP per call at
// 4 x 272 x 480, 94% of them int8, whose tensor-core peak, 1979 TOP/s, only
// wgmma reaches: through mma.sync int8 runs no faster per multiply-add
// than bf16).
//
// bfloat16 (the main path): a walk down each strip on s8 wgmma, after the
// 0.5x branch on bf16 wgmma (from `wgmma_tile.cuh`: wgmma_ss_s8_64x64,
// wgmma_s8_64x32 and the swizzle-free descriptor wgmma_desc_plain for the
// walk; wgmma_ss_64x120, wgmma_ss_64x80, wgmma_64x64, the 128-byte swizzled
// wgmma_desc and the transposing stmatrix stores for the 0.5x branch; for
// both the bulk-copy ring on mbarriers and async_fence). The first design
// (one CTA of 8 warps walking an 8-pixel column strip, mma.sync, conv2's
// and the fold's weights read as fragments from L1/L2 by every warp, three
// block reductions a step) ran at 10.3x its bound. What was measured (PERF.md, the int8 `Block_`'s redesign):
// - Two passes, every step its own CTA: the lag makes the steps of a strip
//   a chain only through two scalars (a step's y1 and y2 before
//   quantization depend on x alone), so pass 1 computed every step's
//   prologue, conv1 and amaxes at once and pass 2 every step with the
//   prefix max of its strip's. Rejected: a step fills the shared memory,
//   so each SM runs one CTA either way and 8160 CTAs buy no overlap, while
//   pass 1 repeats the prologue and conv1 (9.6 ms against 7.1).
// - Kept: one CTA per strip walks its steps (240 CTAs, two rounds on 132
//   SMs), carrying the running amaxes, each step's own taken from the
//   values it quantizes: no step is computed twice.
// - Also measured and rejected: the fold and conv2 as ss m64n48k32 tiles
//   (y2 as four parity grids, so that the stride-2 fold is a tile): the
//   accumulators spilled at 255 registers and ptxas serialized the wgmma.
// - What the walk's steps were then bound by, and the repairs: a shared
//   atomic count per stage and warp before each refill (now one per group
//   of stages, taken before the next group's fragments load, and conv1's 9
//   stages counted once a chunk); conv1's scales and biases read from
//   device memory in the quantizing epilogue (now in shared memory); and
//   2-byte y stores (the stage's mid channels now come in the order that
//   gives a lane 4 bytes of a pixel's 16-byte chunk). Neither the weight
//   copies nor the fold's products were the limit (removing either left the
//   fold's cycles within ~10%).
// A call is three launches. The 0.5x branch (`half_branch_kernel`: no
// quantization in it, bf16 wgmma with the dequantised conv1 and conv2
// streamed through a bulk-copy ring, one CTA per 16 x 16 tile of the 0.5x
// image) writes e = ku(conv2(y5) + b2) + bu to device memory (on an
// H100, PERF.md: 0.51 ms of a 4.42 ms call as a launch on mma.sync with its
// weights read as fragments from L1/L2, ~0.28 ms on wgmma). The walk then
// runs per step the prologue (xq, us), and per chunk of 64 mid channels
// conv1 at 2x and 1x, its quantizing epilogue into the chunk's y windows,
// the chunk's fold and conv2 (int32 partial sums in shared memory); then
// the epilogue (kd, up2(e), x). The third launch runs the steps the walk
// listed as past their lagged scale again, one CTA an SM.
// conv1 runs in window coordinates with both operands in shared memory:
// the int8 windows keep each pixel's 16-byte channel chunk in a plane of
// its own, which the swizzle-free K-major descriptor reads as a tile from
// any pixel (the 64-byte rows of 64 int8 channels fit neither
// fused_block2.cu's 128-byte swizzle nor, without relying on how the
// swizzle meets an unaligned start, the 64-byte one); pixels are A (m64),
// the stage's 64 mid channels B. The fold and conv2 take A from the y
// windows by ldmatrix into registers (the fold's stride 2 is no tile), B
// the stage's 32 output channels of the warpgroup, a group of stages
// loading while the one before it is in flight. Every int8 weight (per chunk conv1's 9 taps, the
// fold's 16 and conv2's 9: 136 stages of 4 KB a step) streams through a
// ring of 24 on mbarriers, packed once on the host (ops/fused_block2_q.py::
// stage_weights_q). Both warpgroups take every wgmma on one code path.
// float32 (the twin for the float32 checks) keeps the first design below.

#include <climits>

#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bfloat16 walk, summed over its
// steps (PHASE_STEP counts them).
#include "phase_clocks.cuh"

namespace {

using namespace cdfo;

constexpr int S = 8;
constexpr int X1 = S + 4, U = 2 * S + 4, D = S / 2 + 6;
constexpr int Y1 = S + 2, Y2 = 2 * S + 2, Y5 = S / 2 + 4, E = S / 2 + 2;
constexpr int CM = 4 * C;                // mid channels
constexpr int PQ = Pitch<s8>::value;     // bytes per int8 pixel
constexpr int SP = C + 8;                // partial sums: words per pixel
constexpr float LAG_MARGIN = 1.25f;

template <typename T>
struct Geo {
  static constexpr int P = Pitch<T>::value;
  static constexpr int B = static_cast<int>(sizeof(T));
  static constexpr int XS = X1 * X1 * P * B, DS = D * D * P * B, Y5S = Y5 * Y5 * P * B;
  static constexpr int XQ = X1 * X1 * PQ, UQ = U * U * PQ, Y1Q = Y1 * Y1 * PQ, Y2Q = Y2 * Y2 * PQ;
  // partial sums of conv2(y1) and fold(y2) (int32) and conv2(y5) (fp32)
  static constexpr int SUMS = (2 * S * S + E * E) * SP * 4;
  // conv1 chunk weights are staged a row of 3 taps at a time (one tap in
  // float32, whose windows leave less room), in two buffers
  static constexpr int TAPS = B == 2 ? 3 : 1;
  static constexpr int STAGE = 2 * TAPS * C * C;
  static constexpr int RED = 4 * WARPS * 4;
  static constexpr int BYTES = XS + DS + Y5S + XQ + UQ + Y1Q + Y2Q + SUMS + STAGE + RED;
  static_assert(XS <= SUMS && DS <= SUMS, "z and mean(x) live in the partial sums");
  static_assert(S * S * P * B <= UQ, "fold + b2 lives in us");
  static_assert(E * E <= Y5 * Y5 && E * E <= D * D, "epilogue buffers");
  static_assert(XS % 16 == 0 && DS % 16 == 0 && Y5S % 16 == 0 && XQ % 16 == 0 && UQ % 16 == 0 &&
                    Y1Q % 16 == 0 && Y2Q % 16 == 0 && SUMS % 16 == 0,
                "16-byte aligned windows");
};

// round(v * inv) as a float, before clipping
__device__ __forceinline__ float scaled(float v, float inv) { return rintf(__fmul_rn(v, inv)); }
__device__ __forceinline__ float clip127(float q) { return fminf(fmaxf(q, -127.f), 127.f); }
__device__ __forceinline__ uint32_t byte_of(float q) {
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}
__device__ __forceinline__ uint32_t pack4(const float* q) {
  return byte_of(q[0]) | (byte_of(q[1]) << 8) | (byte_of(q[2]) << 16) | (byte_of(q[3]) << 24);
}
// the quantization scale of an amax, and its reciprocal
__device__ __forceinline__ void scale_of(float amax, float& s, float& inv) {
  s = fmaxf(amax, 1e-8f) / 127.f;
  inv = 1.f / s;
}

// v[i] over the CTA: the maximum where is_max[i], else the sum; every
// thread gets the same value. `red` holds N * WARPS floats.
template <int N>
__device__ void block_reduce(float (&v)[N], const bool (&is_max)[N], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, v[i], o);
      v[i] = is_max[i] ? fmaxf(v[i], other) : v[i] + other;
    }
    if (lane == 0) red[i * WARPS + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float r = red[i * WARPS];
    for (int w = 1; w < WARPS; ++w) r = is_max[i] ? fmaxf(r, red[i * WARPS + w]) : r + red[i * WARPS + w];
    v[i] = r;
  }
  __syncthreads();
}

// ---- float32: the first design, one CTA walking a strip ------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
block_q_kernel(const T* __restrict__ x, const s8* __restrict__ w1q, const float* __restrict__ s1,
               const T* __restrict__ b1, const s8* __restrict__ w2q, const float* __restrict__ s2,
               const T* __restrict__ b2, const s8* __restrict__ wfq, const float* __restrict__ sf,
               const T* __restrict__ w1b, const T* __restrict__ w2b, const T* __restrict__ wdn,
               const T* __restrict__ bdn, const T* __restrict__ wup, const T* __restrict__ bup,
               const float* __restrict__ bnd, T* __restrict__ out, float* __restrict__ counts,
               int h, int wd, int strips) {
  using G = Geo<T>;
  constexpr int P = G::P;
  extern __shared__ uint4 cdfo_smem[];
  T* xs = reinterpret_cast<T*>(cdfo_smem);
  T* ds = xs + X1 * X1 * P;
  T* y5 = ds + D * D * P;
  s8* xq = reinterpret_cast<s8*>(y5 + Y5 * Y5 * P);
  s8* us = xq + G::XQ;
  s8* y1 = us + G::UQ;
  s8* y2 = y1 + G::Y1Q;
  float* sum_b = reinterpret_cast<float*>(y2 + G::Y2Q);   // conv2(y1), S x S, int32
  float* sum_f = sum_b + S * S * SP;                      // fold(y2), S x S, int32
  float* sum_5 = sum_f + S * S * SP;                      // conv2(y5), E x E, fp32
  s8* wst = reinterpret_cast<s8*>(sum_5 + E * E * SP);    // staged conv1 taps
  float* red = reinterpret_cast<float*>(wst + G::STAGE);
  T* zs = reinterpret_cast<T*>(sum_b);   // prologue: ku x + bu at 1x, window of xs
  T* dm = reinterpret_cast<T*>(sum_b);   // prologue: down2(x) at 0.5x, window of ds
  T* fs = reinterpret_cast<T*>(us);      // epilogue: fold + b2 at 1x, S x S
  T* bs = y5;                            // epilogue: conv2(y5) + b2 at 0.5x, E x E, origin r0/2-1
  T* es = ds;                            // epilogue: ku bs + bu

  const int hh = h / 2, wh = wd / 2;   // the 0.5x image
  const int c0 = blockIdx.x * S, s0 = c0 / 2;
  const long long img = static_cast<long long>(blockIdx.z) * h * wd * C;
  const T* xb = x + img;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Weights<s8> wt2{w2q, C, CM}, wtf{wfq, C, CM};   // (conv1's are staged from w1q)
  const Weights<T> wt1b{w1b, CM, C}, wt2b{w2b, C, CM}, wtd{wdn, C, C}, wtu{wup, C, C};
  const float rs1 = bnd[0], b1max = bnd[1], rn1 = bnd[2];

  // a 1x1 conv (64 -> 64) + bias over an n x n window, two m-tiles per
  // warp; each(v0, v1) sees every value once, in fp32, before the store
  auto conv1x1 = [&](const T* in, int n, const Weights<T>& wt, const T* bias, T* dst, auto&& keep,
                     auto&& each) {
    const int np = n * n, mts = (np + 15) / 16;
    for (int mt = 2 * warp; mt < mts; mt += 2 * WARPS) {
      const int mt1 = min(mt + 1, mts - 1);
      const ATile<T> a[2] = {a_tile<1>(in, n, n, np, mt, lane), a_tile<1>(in, n, n, np, mt1, lane)};
      float acc[2][8][4];
      zero(acc);
      conv_tiles<1, 1, 2, 8>(acc, a, wt, 0, 0, lane);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && mt1 == mt) continue;
        for_each_pair(acc[m], m ? mt1 : mt, 0, np, lane, [&](int p, int c, float v0, float v1) {
          const float2 bb = load2(bias + c);
          const bool k = keep(p);
          const float f0 = k ? __fadd_rn(v0, bb.x) : 0.f, f1 = k ? __fadd_rn(v1, bb.y) : 0.f;
          each(f0, f1);
          store2(dst + p * P + c, f0, f1);
        });
      }
    }
  };
  auto all = [](int) { return true; };
  auto nothing = [](float, float) {};

  float run1 = 0.f, run2 = 0.f;     // largest y1 / y2 amax of the steps so far
  float clip1 = 0.f, clip2 = 0.f;   // this thread's y1 / y2 values past the lagged scale
  // a step run again: its y1 / y2 amax, the scale it quantizes at (< 0:
  // the lagged one)
  float own1 = -1.f, own2 = -1.f;
  const int nsteps = (h + S - 1) / S;

#pragma unroll 1
  for (int step = 0; step < nsteps; ++step) {
    const int r0 = step * S, q0 = r0 / 2;

    // ---- prologue: xs, z = ku x + bu, the amaxes of z and xm --------------
    load_window(xs, xb, h, wd, r0 - 2, c0 - 2, X1, X1, true);
    __syncthreads();
    float st[4] = {0.f, 0.f, 0.f, 0.f};   // amax z, amax xm, sum z^2, sum xm^2
    conv1x1(xs, X1, wtu, bup, zs, all, [&](float f0, float f1) {
      st[0] = fmaxf(st[0], fmaxf(fabsf(f0), fabsf(f1)));
      st[2] += f0 * f0 + f1 * f1;
    });
    for (int i = threadIdx.x; i < X1 * X1 * (C / 8); i += blockDim.x) {
      const int pix = i / (C / 8), c = 8 * (i % (C / 8));
      if (!inside(r0 - 2 + pix / X1, c0 - 2 + pix % X1, h, wd)) continue;
      float v[8];
      load8(xs + pix * P + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st[1] = fmaxf(st[1], fabsf(v[j]));
        st[3] += v[j] * v[j];
      }
    }
    {
      const bool is_max[4] = {true, true, false, false};
      block_reduce(st, is_max, red);
    }
    const int vr = max(min(r0 + S + 2, h) - max(r0 - 2, 0), 0);
    const int vc = max(min(c0 + S + 2, wd) - max(c0 - 2, 0), 0);
    const float z_rms = sqrtf(st[2] / static_cast<float>(X1 * X1 * C));
    const float x_rms = sqrtf(st[3] / fmaxf(static_cast<float>(vr * vc * C), 1.f));
    float s_u, inv_u, s_xm, inv_xm, s_y1, inv_y1, s_y2, inv_y2;
    scale_of(st[0], s_u, inv_u);
    scale_of(st[1], s_xm, inv_xm);
    // lagged y scales; step 0 starts from min(hard bound, 5 sigma) + max|b1|
    auto boot = [&](float in_max, float in_rms) {
      return __fadd_rn(fminf(__fmul_rn(rs1, in_max), __fmul_rn(__fmul_rn(5.f, rn1), in_rms)), b1max);
    };
    scale_of(own2 >= 0.f  ? own2
             : step == 0 ? boot(st[0], z_rms)
                         : __fmul_rn(LAG_MARGIN, run2),
             s_y2, inv_y2);
    scale_of(own1 >= 0.f  ? own1
             : step == 0 ? boot(st[1], x_rms)
                         : __fmul_rn(LAG_MARGIN, run1),
             s_y1, inv_y1);

    // xq = quantized xm
    for (int i = threadIdx.x; i < X1 * X1 * (C / 8); i += blockDim.x) {
      const int pix = i / (C / 8), c = 8 * (i % (C / 8));
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (inside(r0 - 2 + pix / X1, c0 - 2 + pix % X1, h, wd)) {
        load8(xs + pix * P + c, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = clip127(scaled(v[j], inv_xm));
      }
      *reinterpret_cast<uint2*>(xq + pix * PQ + c) = make_uint2(pack4(v), pack4(v + 4));
    }
    // us = quantized up2(z) on the 2x window; z's window holds clamped rows
    // and columns, which is the bilinear border rule. 2x row 2r0-2+qy blends
    // z window rows a = qy/2 + (qy&1) and a+1 with weights 0.25/0.75 (even)
    // or 0.75/0.25, H first, then W.
    for (int i = threadIdx.x; i < U * U * (C / 8); i += blockDim.x) {
      const int pix = i / (C / 8), c = 8 * (i % (C / 8));
      const int qy = pix / U, qx = pix % U;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (inside(2 * r0 - 2 + qy, 2 * c0 - 2 + qx, 2 * h, 2 * wd)) {
        const int a = (qy >> 1) + (qy & 1), bcol = (qx >> 1) + (qx & 1);
        const float wa = (qy & 1) ? 0.75f : 0.25f, wb = (qx & 1) ? 0.75f : 0.25f;
        const T* z = zs + (a * X1 + bcol) * P + c;
        float z00[8], z01[8], z10[8], z11[8];
        load8(z, z00);
        load8(z + P, z01);
        load8(z + X1 * P, z10);
        load8(z + X1 * P + P, z11);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float h0 = __fadd_rn(__fmul_rn(wa, z00[j]), __fmul_rn(1.f - wa, z10[j]));
          const float h1 = __fadd_rn(__fmul_rn(wa, z01[j]), __fmul_rn(1.f - wa, z11[j]));
          const float u = __fadd_rn(__fmul_rn(wb, h0), __fmul_rn(1.f - wb, h1));
          v[j] = clip127(scaled(u, inv_u));
        }
      }
      *reinterpret_cast<uint2*>(us + pix * PQ + c) = make_uint2(pack4(v), pack4(v + 4));
    }
    __syncthreads();
    // dm = down2(x): 2x2 means of x at the 0.5x window, zero outside
    for (int i = threadIdx.x; i < D * D * (C / 8); i += blockDim.x) {
      const int pix = i / (C / 8), c = 8 * (i % (C / 8));
      const int j = q0 - 3 + pix / D, k = s0 - 3 + pix % D;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (inside(j, k, hh, wh)) {
        const T* p = xb + (static_cast<long long>(2 * j) * wd + 2 * k) * C + c;
        float a[8], bq[8], cq[8], dq[8];
        load8(p, a);
        load8(p + C, bq);
        load8(p + static_cast<long long>(wd) * C, cq);
        load8(p + static_cast<long long>(wd) * C + C, dq);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) v[jj] = 0.25f * (a[jj] + bq[jj] + cq[jj] + dq[jj]);
      }
      store8(dm + pix * P + c, v);
    }
    __syncthreads();
    // d = kd dm + bd, zero outside the 0.5x image
    conv1x1(dm, D, wtd, bdn, ds,
            [&](int p) { return inside(q0 - 3 + p / D, s0 - 3 + p % D, hh, wh); }, nothing);
    __syncthreads();

    // ---- the 4 mid-channel chunks -----------------------------------------
    constexpr int N2 = (Y2 * Y2 + 15) / 16, N1 = (Y1 * Y1 + 15) / 16, NQ = N2 + N1;
    constexpr int MT1 = 4;
    static_assert(NQ <= MT1 * WARPS, "one int8 conv1 task per warp");
    static_assert(Y5 * Y5 == 16 * (WARPS / 2), "two warps per y5 m-tile");
    constexpr int NF = S * S / 16, NE = (E * E + 15) / 16;
    static_assert(NF == 4 && NE <= 4, "conv2 phase fits 8 warps");
    float amax1 = 0.f, amax2 = 0.f;
    // One m-tile of lrelu(dequantised conv1 + b1), zeroed outside the image
    // at the window's scale (width x width pixels), quantized with the
    // step's scale; values past +-127 (only at the lagged scale) are
    // counted where the step owns the pixel, then clipped. sw, bias: this
    // lane's conv1 weight scales and
    // biases of the chunk; s_act: the scale of the window that conv1 read.
    const int t2 = (lane & 3) * 2;
    auto put = [&](auto width, s8* dst, int y0, int x0, int hs, int ws, int mt,
                   const int (&acc)[8][4], const float2 (&sw)[8], const float2 (&bias)[8],
                   float s_act, float inv, float& amax, float& clips) {
      constexpr int W_ = decltype(width)::value;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + (lane >> 2) + 8 * half;
        if (p >= W_ * W_) continue;
        const int py = p / W_, px = p % W_;
        const bool in = inside(y0 + py, x0 + px, hs, ws);
        s8* row = dst + p * PQ + t2;
        int over = 0;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float d0 = __fmul_rn(__int2float_rn(acc[nt][2 * half]), __fmul_rn(sw[nt].x, s_act));
          const float d1 = __fmul_rn(__int2float_rn(acc[nt][2 * half + 1]), __fmul_rn(sw[nt].y, s_act));
          const float f0 = in ? lrelu(__fadd_rn(d0, bias[nt].x)) : 0.f;
          const float f1 = in ? lrelu(__fadd_rn(d1, bias[nt].y)) : 0.f;
          amax = fmaxf(amax, fmaxf(fabsf(f0), fabsf(f1)));
          const int q0 = __float2int_rn(__fmul_rn(f0, inv)), q1 = __float2int_rn(__fmul_rn(f1, inv));
          const int c0 = min(max(q0, -127), 127), c1 = min(max(q1, -127), 127);
          over += (c0 != q0) + (c1 != q1);
          *reinterpret_cast<uint16_t*>(row + nt * 8) =
              static_cast<uint16_t>((c0 & 0xff) | ((c1 & 0xff) << 8));
        }
        if (py >= 1 && py <= W_ - 2 && px >= 1 && px <= W_ - 2) clips += static_cast<float>(over);
      }
    };
    // acc <-> partial sums (load: add the chunks so far; ch == 0 starts at 0)
    auto sums = [&](auto& acc, auto* buf, const int (&mts)[2], int n0, int np, bool load) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        for_each_pair(acc[m], mts[m], n0, np, lane, [&](int p, int n, auto& v0, auto& v1) {
          auto* q = buf + p * SP + n;
          if (load) {
            v0 += q[0];
            v1 += q[1];
          } else {
            q[0] = v0;
            q[1] = v1;
          }
        });
      }
    };

#pragma unroll 1
    for (int ch = 0; ch < 4; ++ch) {
      const T* b1c = b1 + ch * C;
      {
        // int8 conv1: warps 0-6 take 4 m-tiles of y2 / y1 each; all 8 warps
        // walk the 9 taps in step, each tap's chunk weights (2 k-tiles x 8
        // n-tiles of fragments, 4 KB) copied once per CTA into shared memory
        // while the previous row of taps computes
        const bool busy = warp * MT1 < NQ;
        ATile<s8> a[MT1];
        int f[MT1];
#pragma unroll
        for (int m = 0; m < MT1; ++m) {
          f[m] = min(warp * MT1 + m, NQ - 1);
          a[m] = f[m] < N2 ? a_tile<1>(us, U, Y2, Y2 * Y2, f[m], lane)
                           : a_tile<1>(xq, X1, Y1, Y1 * Y1, f[m] - N2, lane);
        }
        int acc[MT1][8][4];
        zero(acc);
        constexpr int TAPS = G::TAPS;
        auto stage = [&](int group, int buf) {
          const int i = threadIdx.x, kt = i >> 7, j = i & 127;
#pragma unroll
          for (int t = 0; t < TAPS; ++t) {
            cp_async16(wst + (buf * TAPS + t) * C * C + kt * 2048 + j * 16,
                       w1q + (((group * TAPS + t) * 2 + kt) * (CM / 8) + ch * 8) * 256 + j * 16);
          }
          cp_async_commit();
        };
        stage(0, 0);
#pragma unroll 1
        for (int group = 0; group < 9 / TAPS; ++group) {
          cp_async_wait();
          __syncthreads();
          if (group + 1 < 9 / TAPS) stage(group + 1, (group + 1) & 1);
          if (busy) {
#pragma unroll
            for (int t = 0; t < TAPS; ++t) {
              const int tap = group * TAPS + t;
              int off[MT1];
#pragma unroll
              for (int m = 0; m < MT1; ++m) off[m] = ((tap / 3) * a[m].in_w + tap % 3) * PQ;
              mma_tap_smem<MT1, 8>(acc, a, off, wst + ((group & 1) * TAPS + t) * C * C, lane);
            }
          }
        }
        if (busy) {
          float2 bias[8], sw[8];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            bias[nt] = load2(b1c + nt * 8 + t2);
            sw[nt] = load2(s1 + ch * C + nt * 8 + t2);
          }
#pragma unroll
          for (int m = 0; m < MT1; ++m) {
            if (m > 0 && f[m] == f[m - 1]) continue;
            if (f[m] < N2) {
              put(std::integral_constant<int, Y2>{}, y2, 2 * r0 - 1, 2 * c0 - 1, 2 * h, 2 * wd, f[m],
                  acc[m], sw, bias, s_u, inv_y2, amax2, clip2);
            } else {
              put(std::integral_constant<int, Y1>{}, y1, r0 - 1, c0 - 1, h, wd, f[m] - N2, acc[m], sw,
                  bias, s_xm, inv_y1, amax1, clip1);
            }
          }
        }
      }
      {
        // y5 = lrelu(conv1 ds + b1) in T: m-tile warp / 2, 32 channels each
        const int mt = warp >> 1, n0 = (warp & 1) * 32;
        const ATile<T> a[1] = {a_tile<1>(ds, D, Y5, Y5 * Y5, mt, lane)};
        float acc[1][4][4];
        zero(acc);
        conv_tiles<3, 3, 1, 4>(acc, a, wt1b, ch * C + n0, 0, lane);
        for_each_pair(acc[0], mt, n0, Y5 * Y5, lane, [&](int p, int n, float v0, float v1) {
          const bool in = inside(q0 - 2 + p / Y5, s0 - 2 + p % Y5, hh, wh);
          const float2 bb = load2(b1c + n);
          store2(y5 + p * P + n, in ? lrelu(v0 + bb.x) : 0.f, in ? lrelu(v1 + bb.y) : 0.f);
        });
      }
      __syncthreads();
      // conv2 phase: warps 0-3 a pair of fold m-tiles x 32 channels, warps
      // 4-5 a pair of body m-tiles, warps 6-7 a pair of 0.5x m-tiles (x 64
      // channels; the odd count repeats its last m-tile)
      if (warp < 4) {
        const int m0 = 2 * (warp >> 1), n0 = (warp & 1) * 32;
        const int mts[2] = {m0, m0 + 1};
        const ATile<s8> a[2] = {a_tile<2>(y2, Y2, S, S * S, m0, lane),
                                a_tile<2>(y2, Y2, S, S * S, m0 + 1, lane)};
        int acc[2][4][4];
        zero(acc);
        int* buf = reinterpret_cast<int*>(sum_f);
        if (ch > 0) sums(acc, buf, mts, n0, S * S, true);
        conv_tiles<4, 4, 2, 4>(acc, a, wtf, n0, ch * C, lane);
        sums(acc, buf, mts, n0, S * S, false);
      } else if (warp < 6) {
        const int m0 = 2 * (warp & 1);
        const int mts[2] = {m0, m0 + 1};
        const ATile<s8> a[2] = {a_tile<1>(y1, Y1, S, S * S, m0, lane),
                                a_tile<1>(y1, Y1, S, S * S, m0 + 1, lane)};
        int acc[2][8][4];
        zero(acc);
        int* buf = reinterpret_cast<int*>(sum_b);
        if (ch > 0) sums(acc, buf, mts, 0, S * S, true);
        conv_tiles<3, 3, 2, 8>(acc, a, wt2, 0, ch * C, lane);
        sums(acc, buf, mts, 0, S * S, false);
      } else if (2 * (warp & 1) < NE) {
        const int m0 = 2 * (warp & 1), m1 = min(m0 + 1, NE - 1);
        const int mts[2] = {m0, m1};
        const ATile<T> a[2] = {a_tile<1>(y5, Y5, E, E * E, m0, lane),
                               a_tile<1>(y5, Y5, E, E * E, m1, lane)};
        float acc[2][8][4];
        zero(acc);
        if (ch > 0) sums(acc, sum_5, mts, 0, E * E, true);
        conv_tiles<3, 3, 2, 8>(acc, a, wt2b, 0, ch * C, lane);
        sums(acc, sum_5, mts, 0, E * E, false);
      }
      __syncthreads();
    }

    // ---- epilogue -----------------------------------------------------------
    // fs = dequantised fold + b2 and bs = conv2(y5) + b2, rounded to T
    for (int i = threadIdx.x; i < (S * S + E * E) * (C / 2); i += blockDim.x) {
      const int pix = i / (C / 2), c = 2 * (i % (C / 2));
      const float2 bb = load2(b2 + c);
      if (pix < S * S) {
        const int* v = reinterpret_cast<const int*>(sum_f) + pix * SP + c;
        store2(fs + pix * P + c,
               __fadd_rn(__fmul_rn(__int2float_rn(v[0]), __fmul_rn(__ldg(sf + c), s_y2)), bb.x),
               __fadd_rn(__fmul_rn(__int2float_rn(v[1]), __fmul_rn(__ldg(sf + c + 1), s_y2)), bb.y));
      } else {
        const int p = pix - S * S;
        const float* v = sum_5 + p * SP + c;
        store2(bs + p * P + c, v[0] + bb.x, v[1] + bb.y);
      }
    }
    __syncthreads();
    conv1x1(bs, E, wtu, bup, es, all, nothing);
    __syncthreads();
    // out = ((conv2(y1) + b2) + (kd fs + bd) + up2(es)) + x: warp w takes
    // m-tile w / 2 and 32 channels
    {
      static_assert(NF == WARPS / 2, "two warps per output m-tile");
      const int mt = warp >> 1, n0 = (warp & 1) * 32;
      const ATile<T> a[1] = {a_tile<1>(fs, S, S, S * S, mt, lane)};
      float acc[1][4][4];
      zero(acc);
      conv_tiles<1, 1, 1, 4>(acc, a, wtd, n0, 0, lane);
      {
        for_each_pair(acc[0], mt, n0, S * S, lane, [&](int p, int n, float v0, float v1) {
          const int py = p / S, px = p % S;
          const int y = r0 + py, xx = c0 + px;
          if (y >= h || xx >= wd) return;
          // 0.5x -> 1x: rows ja (weight wa) and jb of e, clamped, in e's
          // window (origin q0 - 1); columns likewise
          const int pyr = y & 1, pxr = xx & 1;
          const float wa = pyr ? 0.75f : 0.25f, wb = pxr ? 0.75f : 0.25f;
          const int ja = min(max((y >> 1) - 1 + pyr, 0), hh - 1) - (q0 - 1);
          const int jb = min(max((y >> 1) + pyr, 0), hh - 1) - (q0 - 1);
          const int ka = min(max((xx >> 1) - 1 + pxr, 0), wh - 1) - (s0 - 1);
          const int kb = min(max((xx >> 1) + pxr, 0), wh - 1) - (s0 - 1);
          const float2 eaa = load2(es + (ja * E + ka) * P + n), eab = load2(es + (ja * E + kb) * P + n);
          const float2 eba = load2(es + (jb * E + ka) * P + n), ebb = load2(es + (jb * E + kb) * P + n);
          const float ha0 = wa * eaa.x + (1.f - wa) * eba.x, ha1 = wa * eaa.y + (1.f - wa) * eba.y;
          const float hb0 = wa * eab.x + (1.f - wa) * ebb.x, hb1 = wa * eab.y + (1.f - wa) * ebb.y;
          const int* sb = reinterpret_cast<const int*>(sum_b) + p * SP + n;
          const float2 bb2 = load2(b2 + n), bbd = load2(bdn + n);
          const float body0 =
              __fadd_rn(__fmul_rn(__int2float_rn(sb[0]), __fmul_rn(__ldg(s2 + n), s_y1)), bb2.x);
          const float body1 =
              __fadd_rn(__fmul_rn(__int2float_rn(sb[1]), __fmul_rn(__ldg(s2 + n + 1), s_y1)), bb2.y);
          const float2 xv = load2(xs + ((py + 2) * X1 + px + 2) * P + n);
          const long long o = (static_cast<long long>(y) * wd + xx) * C + n;
          store2(out + img + o,
                 body0 + (v0 + bbd.x) + (wb * ha0 + (1.f - wb) * hb0) + xv.x,
                 body1 + (v1 + bbd.y) + (wb * ha1 + (1.f - wb) * hb1) + xv.y);
        });
      }
    }
    // the step's amaxes; its two barriers also end the step (the next one
    // overwrites xs and the partial sums). A step whose y1 or y2 values
    // passed +-127 at the lagged scale runs again (fs and es took the
    // windows it quantized) with that scale set to their own amax.
    {
      float am[2] = {amax1, amax2};
      const bool is_max[2] = {true, true};
      block_reduce(am, is_max, red);
      const bool over1 = __float2int_rn(__fmul_rn(am[0], inv_y1)) > 127;
      const bool over2 = __float2int_rn(__fmul_rn(am[1], inv_y2)) > 127;
      if (own1 < 0.f && own2 < 0.f && (over1 || over2)) {
        own1 = over1 ? am[0] : -1.f;
        own2 = over2 ? am[1] : -1.f;
        --step;
      } else {
        own1 = own2 = -1.f;
        run1 = fmaxf(run1, am[0]);
        run2 = fmaxf(run2, am[1]);
      }
    }
  }
  if (counts != nullptr) {
    float cl[2] = {clip1, clip2};
    const bool is_max[2] = {false, false};
    block_reduce(cl, is_max, red);
    if (threadIdx.x == 0) {
      float* dst = counts + (static_cast<long long>(blockIdx.z) * strips + blockIdx.x) * 2;
      dst[0] = cl[0];
      dst[1] = cl[1];
    }
  }
}

// ---- bfloat16 (the main path): a walk down each strip on s8 wgmma --------------

// The windows of one step, image origin in brackets; the int8 ones keep
// each pixel's 16-byte channel chunk c in plane c (`wgmma_desc_plain`), the
// planes sized for the conv1 taps' reads past the window's last pixel:
//   xs  bf16 12^2 (pitch)        x, clamped at the image border  [r0-2]
//   xq  s8   12^2 -> 160 pixels  quantized xm (x zeroed outside) [r0-2]
//   us  s8   20^2 -> 432 pixels  quantized up2(ku x + bu)        [2r0-2]
//   y2  s8   18^2 x 64 channels  quantized lrelu(conv1 us), a chunk [2r0-1]
//   y1  s8   10^2 x 64 channels  quantized lrelu(conv1 xq), a chunk [r0-1]
// (z = ku x + bu lives in y2, fold + b2 in us), and the int32 partial sums
// of the fold and conv2 over the chunks so far.
constexpr int XQP = 160, USP = 432, Y1P = Y1 * Y1, Y2P = Y2 * Y2;
constexpr int PB = Pitch<bf16>::value;
constexpr int QRING = 24;                // weight stages in flight
constexpr int QSTAGE = C * C;            // bytes a stage: 64 n x 64 k
constexpr int SPC = 9 + 16 + 9;          // stages a chunk: conv1's taps, the fold's, conv2's
constexpr int STAGES_Q = 4 * SPC;        // stages a step
constexpr int SUMP = C + 8;              // partial sums: words a pixel

struct QGeo {
  static constexpr int RING = QRING * QSTAGE;
  static constexpr int XS = X1 * X1 * PB * 2, ZS = XS;
  static constexpr int XQ = 4 * XQP * 16, US = 4 * USP * 16;
  static constexpr int Y2B = 4 * Y2P * 16, Y1B = 4 * Y1P * 16;
  static constexpr int SUMS = 2 * S * S * SUMP * 4;
  static constexpr int BARS = QRING * 8 + QRING * 4 + 4 * WARPS * 4 + 2 * CM * 4;
  static constexpr int BYTES = RING + XS + XQ + US + Y2B + Y1B + SUMS + BARS;
  static_assert(ZS <= Y2B && S * S * PB * 2 <= US, "z lives in y2, fold + b2 in us");
  static_assert(X1 * X1 <= XQP && 5 * 64 + 63 + 2 * U + 2 < USP && 64 + 63 + 2 * X1 + 2 < XQP,
                "the conv1 taps' reads stay in their planes");
  static_assert(BYTES <= 232448, "one block's shared memory");
};

// a 1x1 conv (64 -> 64) + bias over an n x n bfloat16 window (pitch
// layout), two m-tiles per warp; keep(p): the pixel's value, else 0;
// each(v0, v1) sees every value once, in fp32, before the store to dst(p, c)
template <typename Dst, typename Keep, typename Each>
__device__ void conv1x1_bf16(const bf16* in, int n, const Weights<bf16>& wt, const bf16* bias,
                             Dst&& dst, Keep&& keep, Each&& each) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int np = n * n, mts = (np + 15) / 16;
  for (int mt = 2 * warp; mt < mts; mt += 2 * WARPS) {
    const int mt1 = min(mt + 1, mts - 1);
    const ATile<bf16> a[2] = {a_tile<1>(in, n, n, np, mt, lane),
                              a_tile<1>(in, n, n, np, mt1, lane)};
    float acc[2][8][4];
    zero(acc);
    conv_tiles<1, 1, 2, 8>(acc, a, wt, 0, 0, lane);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 1 && mt1 == mt) continue;
      for_each_pair(acc[m], m ? mt1 : mt, 0, np, lane, [&](int p, int c, float v0, float v1) {
        const float2 bb = load2(bias + c);
        const bool k = keep(p);
        const float f0 = k ? __fadd_rn(v0, bb.x) : 0.f, f1 = k ? __fadd_rn(v1, bb.y) : 0.f;
        each(f0, f1);
        store2(dst(p, c), f0, f1);
      });
    }
  }
}

// The 0.5x branch, which no quantization touches: e = ku(conv2(y5) + b2)
// + bu with y5 = lrelu(conv1 d + b1), d = kd down2(x) + bd, in bf16 with
// the dequantised conv1 and conv2, one CTA per HT x HT tile of the 0.5x
// image, into device memory for the walk. A launch of its own: it needs
// no scale, so its 540 CTAs (at 4 x 272 x 480) fill the card, where the
// walk's strips run their steps in order. Both 3x3 convs on bf16 wgmma,
// as fused_block2.cu runs its own, their weights (per chunk of 64 mid
// channels conv1's 9 taps and conv2's 9, 8 KB each: ops/fused_block2_q.py::
// stage_half_weights) streamed by bulk copies through a ring of HRING
// stages on mbarriers, the last warp done with a stage refilling its slot:
// - conv1 in window coordinates over the swizzled d window (HD wide):
//   weights as A (m64: the chunk's mid channels), positions as B, the 400
//   positions from the window's first 200 a warpgroup (N = 120 + 80, one
//   code path); the positions past y5's 18 columns and rows (1.23x y5's
//   324) are computed and dropped. The y5 stores are transposing stmatrix.
// - conv2: warpgroup wg takes output pixels 128 wg .. 128 wg + 127 (two
//   m64 tiles, A by ldmatrix from y5), the stage's 64 output channels as
//   B; its sums stay in registers across the chunks.
// The 1x1 convs kd and ku run on mma.sync (conv3x3_tile.cuh).
constexpr int HT = 16, HD = HT + 4, HY = HT + 2;   // e tile; d [q0-2], y5 [q0-1] windows
constexpr int HRING = 8;                           // stages in flight
constexpr int HSPC = 18;                           // stages a chunk
constexpr int HQ = 200;                            // conv1 positions a warpgroup
struct HGeo {
  static constexpr int RING = HRING * C * C * 2;
  static constexpr int DS = HD * HD * C * 2, Y5 = HY * HY * C * 2, DM = HD * HD * PB * 2;
  // 1024 bytes for the alignment; mbarriers and counts; a row that takes
  // the stores of dropped positions
  static constexpr int BYTES = 1024 + RING + DS + Y5 + DM + HRING * 12 + C * 2;
  static_assert(RING % 1024 == 0 && DS % 1024 == 0, "ring and d 1024-byte aligned");
  static_assert((HY - 1) * HD + HY <= 2 * HQ && 2 * HQ + 2 * HD + 2 <= HD * HD + HY * HY,
                "conv1's positions cover y5, their reads stay in d and y5");
  static_assert((RING + DS + Y5 + DM + HRING * 12) % 16 == 0, "16-byte aligned trash row");
  static_assert(BYTES <= 232448, "one block's shared memory");
};

__global__ void __launch_bounds__(THREADS, 1)
half_branch_kernel(const bf16* __restrict__ x, const bf16* __restrict__ stages,
                   const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                   const bf16* __restrict__ wdn, const bf16* __restrict__ bdn,
                   const bf16* __restrict__ wup, const bf16* __restrict__ bup,
                   bf16* __restrict__ e, int h, int wd) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* ds = ring + HRING * C * C;   // d, swizzled
  bf16* y5 = ds + HD * HD * C;       // one chunk of y5, swizzled
  bf16* dm = y5 + HY * HY * C;       // down2(x) (pitch), then conv2(y5) + b2
  uint64_t* bars = reinterpret_cast<uint64_t*>(dm + HD * HD * PB);
  unsigned* used = reinterpret_cast<unsigned*>(bars + HRING);
  bf16* trash = reinterpret_cast<bf16*>(used + HRING);
  const int hh = h / 2, wh = wd / 2;
  const int q0 = blockIdx.y * HT, s0 = blockIdx.x * HT;
  const bf16* xb = x + static_cast<long long>(blockIdx.z) * h * wd * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wl = warp & 3;
  constexpr int NST = 4 * HSPC;

  auto load_stage = [&](int js) {
    const int slot = js % HRING;
    mbar_expect_tx(bars + slot, C * C * 2);
    bulk_copy(ring + slot * C * C, stages + static_cast<long long>(js) * C * C, C * C * 2,
              bars + slot);
  };
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < HRING; ++slot) {
      mbar_init(bars + slot, 1);
      used[slot] = 0;
    }
    mbar_init_fence();
    for (int js = 0; js < HRING; ++js) load_stage(js);
  }
  auto ready = [&](int js) {
    mbar_wait(bars + js % HRING, (js / HRING) & 1);
    return ring + (js % HRING) * C * C;
  };
  auto release = [&](int js) {
    __syncwarp();
    if (lane == 0 && atomicAdd(used + js % HRING, 1u) == WARPS - 1) {
      used[js % HRING] = 0;
      if (js + HRING < NST) load_stage(js + HRING);
    }
  };

  // dm = down2(x): 2x2 means of x, zero outside the 0.5x image
  for (int i = threadIdx.x; i < HD * HD * (C / 8); i += blockDim.x) {
    const int pix = i / (C / 8), c = 8 * (i % (C / 8));
    const int j = q0 - 2 + pix / HD, k = s0 - 2 + pix % HD;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (inside(j, k, hh, wh)) {
      const bf16* p = xb + (static_cast<long long>(2 * j) * wd + 2 * k) * C + c;
      float a[8], bq[8], cq[8], dq[8];
      load8(p, a);
      load8(p + C, bq);
      load8(p + static_cast<long long>(wd) * C, cq);
      load8(p + static_cast<long long>(wd) * C + C, dq);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) v[jj] = 0.25f * (a[jj] + bq[jj] + cq[jj] + dq[jj]);
    }
    store8(dm + pix * PB + c, v);
  }
  __syncthreads();
  // d = kd dm + bd, zero outside the 0.5x image, into the swizzled window
  conv1x1_bf16(
      dm, HD, Weights<bf16>{wdn, C, C}, bdn, [&](int p, int c) { return swizzled(ds, p, c); },
      [&](int p) { return inside(q0 - 2 + p / HD, s0 - 2 + p % HD, hh, wh); }, [](float, float) {});
  async_fence();
  __syncthreads();

  // conv1's positions: this warpgroup's qa .. qa + 119 and qb .. qb + 79;
  // conv2's A rows (ldmatrix): output pixel 128 wg + 64 m + 16 wl + row as
  // a y5 pixel, and the 8-channel half of a k16 step
  const int qa = HQ * wg, qb = qa + 120;
  int apix[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int p = 128 * wg + 64 * m + 16 * wl + (lane & 7) + 8 * ((lane >> 3) & 1);
    apix[m] = (p / HT) * HY + p % HT;
  }
  const int akc = 8 * (lane >> 4);
  float acc5[2][8][4];   // conv2's sums: this warpgroup's two m64 tiles
#pragma unroll
  for (int m = 0; m < 2; ++m) zero1(acc5[m]);
#pragma unroll 1
  for (int ch = 0; ch < 4; ++ch) {
    const int j0 = ch * HSPC;
    {
      float acc0[15][4], acc1[10][4];
      zero1(acc0);
      zero1(acc1);
      keep(acc0);
      keep(acc1);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * HD + tap % 3;
        const uint64_t bd0 = wgmma_desc(ds + (qa + off) * C), bd1 = wgmma_desc(ds + (qb + off) * C);
        const uint64_t ad = wgmma_desc(ready(j0 + tap));
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_ss_64x120(acc0, ad + 2 * k, bd0 + 2 * k);
          wgmma_ss_64x80(acc1, ad + 2 * k, bd1 + 2 * k);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (tap > 0) release(j0 + tap - 1);
      }
      wgmma_wait<0>();
      keep(acc0);
      keep(acc1);
      release(j0 + 8);
      if (ch > 0) __syncthreads();   // the last chunk's conv2 has read y5
      const float2 bias = make_float2(to_f(b1[ch * C + 16 * wl + (lane >> 2)]),
                                      to_f(b1[ch * C + 16 * wl + (lane >> 2) + 8]));
      store_lrelu_window(acc0, qa, HD, HY, y5, q0 - 1, s0 - 1, hh, wh, bias, trash);
      store_lrelu_window(acc1, qb, HD, HY, y5, q0 - 1, s0 - 1, hh, wh, bias, trash);
    }
    __syncthreads();
    // conv2 over the chunk: stages j0 + 9 + tap, two at a time (the last
    // alone), every A fragment loaded before the products issue
    auto conv2 = [&](int tap0, auto two) {
      constexpr int NS = decltype(two)::value ? 2 : 1;
      uint32_t af[NS][2][C / 16][4];
      uint64_t bd[NS];
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const int tap = tap0 + st, off = (tap / 3) * HY + tap % 3;
        bd[st] = wgmma_desc(ready(j0 + 9 + tap));
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int kt = 0; kt < C / 16; ++kt) {
            ldsm_x4(af[st][m][kt], swizzled(y5, apix[m] + off, 16 * kt + akc));
          }
      }
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < NS; ++st)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int kt = 0; kt < C / 16; ++kt) wgmma_64x64(acc5[m], af[st][m][kt], bd[st] + 2 * kt);
      wgmma_commit();
      wgmma_wait<0>();
      keep(af);
      keep(acc5);
#pragma unroll
      for (int st = 0; st < NS; ++st) release(j0 + 9 + tap0 + st);
    };
#pragma unroll 1
    for (int tp = 0; tp < 8; tp += 2) conv2(tp, std::true_type{});
    conv2(8, std::false_type{});
  }

  // ss = conv2(y5) + b2, rounded, in dm's place (pitch layout); this lane:
  // pixels 128 wg + 64 m + 16 wl + g and + 8, channels 8j + 2t and + 1
  bf16* ss = dm;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb = load2(b2 + 8 * j + t2);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store2(ss + (128 * wg + 64 * m + 16 * wl + g + 8 * half) * PB + 8 * j + t2,
               acc5[m][j][2 * half] + bb.x, acc5[m][j][2 * half + 1] + bb.y);
      }
  }
  __syncthreads();
  // e = ku ss + bu: warp w takes m-tiles 2w, 2w + 1 of the 16 x 16 tile
  {
    static_assert(HT * HT == 32 * WARPS, "two m-tiles a warp");
    const int mt = 2 * warp;
    const ATile<bf16> a[2] = {a_tile<1>(ss, HT, HT, HT * HT, mt, lane),
                              a_tile<1>(ss, HT, HT, HT * HT, mt + 1, lane)};
    float acc[2][8][4];
    zero(acc);
    conv_tiles<1, 1, 2, 8>(acc, a, Weights<bf16>{wup, C, C}, 0, 0, lane);
    bf16* eb = e + static_cast<long long>(blockIdx.z) * hh * wh * C;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      for_each_pair(acc[m], mt + m, 0, HT * HT, lane, [&](int p, int n, float v0, float v1) {
        const int j = q0 + p / HT, k = s0 + p % HT;
        if (j >= hh || k >= wh) return;
        const float2 bb = load2(bup + n);
        store2(eb + (static_cast<long long>(j) * wh + k) * C + n, v0 + bb.x, v1 + bb.y);
      });
    }
  }
}

// round(f * inv), clamped to +-128 first (any value past +-127.5 clips
// either way), by the 1.5 x 2^23 trick: round to nearest even, as
// __float2int_rn, without a conversion
__device__ __forceinline__ int quant_rn(float f, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(f, inv), -128.f), 128.f);
  return __float_as_int(__fadd_rn(v, 12582912.f)) - 0x4B400000;
}

// f(integral_constant<int, I>) for I = B .. E - 1
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// One CTA walks the 8 x 8 steps of the 8-pixel column strip at c0 = 8
// blockIdx.x of image blockIdx.z from the top, carrying the two running
// amaxes; COUNT: also counts the y1 / y2 values past the lagged scale into
// `counts`. A step whose y1 or y2 values pass the lagged scale is listed in
// `redo` ([0]: the count, then per step its image, strip, step and the two
// y scales, with the one passed set to the values' own amax), and REDO,
// the second launch, runs the listed steps again, one at a time, CTA i
// taking entries i, i + gridDim.x, ... (a step's output depends on its own
// scales alone). Redone in the walk, a step would lengthen its strip's
// walk and the round of CTAs it runs in.
template <bool COUNT, bool REDO>
__global__ void __launch_bounds__(THREADS, 1)
block_q_walk(const bf16* __restrict__ x, const s8* __restrict__ stages,
             const float* __restrict__ s1, const bf16* __restrict__ b1,
             const float* __restrict__ s2, const bf16* __restrict__ b2,
             const float* __restrict__ sf, const bf16* __restrict__ wdn,
             const bf16* __restrict__ bdn, const bf16* __restrict__ wup,
             const bf16* __restrict__ bup, const float* __restrict__ bnd,
             const bf16* __restrict__ e, bf16* __restrict__ out, float* __restrict__ counts,
             int* __restrict__ redo, int h, int wd) {
  using G = QGeo;
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  s8* ring = reinterpret_cast<s8*>(base);
  bf16* xs = reinterpret_cast<bf16*>(base + G::RING);
  s8* xq = reinterpret_cast<s8*>(xs) + G::XS;
  s8* us = xq + G::XQ;
  s8* y2 = us + G::US;
  s8* y1 = y2 + G::Y2B;
  int* sums = reinterpret_cast<int*>(y1 + G::Y1B);   // fold, then conv2: S x S x SUMP
  uint64_t* bars = reinterpret_cast<uint64_t*>(sums + 2 * S * S * SUMP);
  unsigned* used = reinterpret_cast<unsigned*>(bars + QRING);
  float* red = reinterpret_cast<float*>(used + QRING);
  float* s1s = red + 4 * WARPS;   // conv1's weight scales and biases, float32
  float* b1s = s1s + CM;
  bf16* zs = reinterpret_cast<bf16*>(y2);   // prologue: ku x + bu, window of xs
  bf16* fs = reinterpret_cast<bf16*>(us);   // epilogue: fold + b2, S x S

  const int strips = (wd + S - 1) / S;
  int nsteps = (h + S - 1) / S;   // REDO: this CTA's listed steps
  if constexpr (REDO) {
    const int n = redo[0], i = static_cast<int>(blockIdx.x);
    nsteps = n > i ? (n - i + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x) : 0;
    if (nsteps == 0) return;
  }
  int c0 = blockIdx.x * S, b = blockIdx.z;   // REDO: the listed step's
  const long long strip_id = static_cast<long long>(b) * strips + blockIdx.x;
  long long img = static_cast<long long>(b) * h * wd * C;
  const bf16* xb = x + img;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int nst = STAGES_Q * nsteps;

  // the weight stages (ops/fused_block2_q.py::stage_weights_q, once per
  // step, chunk by chunk) through the ring, as fused_block2.cu streams its
  // own
  auto load_stage = [&](int js) {
    const int slot = js % QRING;
    mbar_expect_tx(bars + slot, QSTAGE);
    bulk_copy(ring + slot * QSTAGE, stages + static_cast<long long>(js % STAGES_Q) * QSTAGE,
              QSTAGE, bars + slot);
  };
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < QRING; ++slot) {
      mbar_init(bars + slot, 1);
      used[slot] = 0;
    }
    mbar_init_fence();
    for (int js = 0; js < QRING && js < nst; ++js) load_stage(js);
  }
  for (int i = threadIdx.x; i < CM; i += blockDim.x) {
    s1s[i] = s1[i];
    b1s[i] = to_f(b1[i]);
  }
  __syncthreads();
  // stages js .. js + n - 1, which every warp releases together: the last
  // warp done with them (one count, in the first one's slot) refills their
  // slots
  // slots; `count` takes the warp's count, `refill` acts on it, so that a
  // caller can put work between the two
  auto count = [&](int js) {
    __syncwarp();
    return lane == 0 ? atomicAdd(used + js % QRING, 1u) : 0u;
  };
  auto refill = [&](int js, int n, unsigned counted) {
    if (lane == 0 && counted == WARPS - 1) {
      used[js % QRING] = 0;
      for (int i = 0; i < n; ++i) {
        if (js + i + QRING < nst) load_stage(js + i + QRING);
      }
    }
  };
  auto release = [&](int js, int n) { refill(js, n, count(js)); };
  auto ready = [&](int js) {
    const int slot = js % QRING;
    mbar_wait(bars + slot, (js / QRING) & 1);
    return ring + slot * QSTAGE;
  };

  // conv1's m-tiles: m = 0, 1, 2 of y2 (tile 3 wg + m), m = 3 of y1 (tile
  // wg), the same kinds in both warpgroups; their A descriptors at tap (0,
  // 0), k step 0; and this thread's 8 accumulator rows (m-tile i / 2, row
  // 16 wl + g + 8 (i % 2)): the byte offset of its y pixel in its window's
  // first plane, its (row, column) there, and bits i of `keep_rows`
  // (inside the y window) and `own` (a pixel of the step's own, whose
  // values past the lagged scale count); `in_rows` (inside the image too)
  // is the step's
  uint64_t jdesc[4];
  int yoff[8], ypix[8];
  unsigned keep_rows = 0, own = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const bool is2 = m < 3;
    const int q0 = is2 ? 64 * (3 * wg + m) : 64 * wg, in_w = is2 ? U : X1, W_ = is2 ? Y2 : Y1;
    jdesc[m] = wgmma_desc_plain((is2 ? us : xq) + 16 * q0, is2 ? USP * 16 : XQP * 16, 128);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * m + half;
      const int q = q0 + 16 * wl + g + 8 * half, oy = q / in_w, ox = q - oy * in_w;
      const bool kept = oy < W_ && ox < W_;
      yoff[i] = (oy * W_ + ox) * 16;
      ypix[i] = (oy << 8) | ox;
      keep_rows |= static_cast<unsigned>(kept) << i;
      own |= static_cast<unsigned>(kept && oy >= 1 && oy <= W_ - 2 && ox >= 1 && ox <= W_ - 2) << i;
    }
  }
  const float rs1 = bnd[0], b1max = bnd[1], rn1 = bnd[2];
  float run1 = 0.f, run2 = 0.f;   // the largest y1 / y2 amax of the steps so far
  int clip1 = 0, clip2 = 0;       // this thread's y1 / y2 values past the lagged scale

  PHASE_START
#pragma unroll 1
  for (int it = 0; it < nsteps; ++it) {
    int step = it;
    float sy1 = 0.f, sy2 = 0.f;   // REDO: the listed y1 / y2 scales
    if constexpr (REDO) {
      const int* entry = redo + 1 + 5 * (blockIdx.x + it * gridDim.x);
      b = entry[0];
      c0 = entry[1] * S;
      step = entry[2];
      sy1 = __int_as_float(entry[3]);
      sy2 = __int_as_float(entry[4]);
      img = static_cast<long long>(b) * h * wd * C;
      xb = x + img;
    }
    const int r0 = step * S, js0 = it * STAGES_Q;
    // ---- prologue: the float32 kernel's arithmetic -----------------------------
    load_window(xs, xb, h, wd, r0 - 2, c0 - 2, X1, X1, true);
    __syncthreads();
    float st[4] = {0.f, 0.f, 0.f, 0.f};   // amax z, amax xm, sum z^2, sum xm^2
    conv1x1_bf16(xs, X1, Weights<bf16>{wup, C, C}, bup,
                 [&](int p, int c) { return zs + p * PB + c; }, [](int) { return true; },
                 [&](float f0, float f1) {
                   st[0] = fmaxf(st[0], fmaxf(fabsf(f0), fabsf(f1)));
                   st[2] += f0 * f0 + f1 * f1;
                 });
    for (int i = threadIdx.x; i < X1 * X1 * (C / 8); i += blockDim.x) {
      const int pix = i / (C / 8), c = 8 * (i % (C / 8));
      if (!inside(r0 - 2 + pix / X1, c0 - 2 + pix % X1, h, wd)) continue;
      float v[8];
      load8(xs + pix * PB + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st[1] = fmaxf(st[1], fabsf(v[j]));
        st[3] += v[j] * v[j];
      }
    }
    {
      const bool is_max[4] = {true, true, false, false};
      block_reduce(st, is_max, red);
    }
    float s_u, inv_u, s_xm, inv_xm, s_y1, inv_y1, s_y2, inv_y2;
    scale_of(st[0], s_u, inv_u);
    scale_of(st[1], s_xm, inv_xm);
    {
      // lagged y scales: 1.25 x the largest amax of the strip's earlier
      // steps; step 0 from min(hard bound, 5 sigma) + max|b1|
      const int vr = max(min(r0 + S + 2, h) - max(r0 - 2, 0), 0);
      const int vc = max(min(c0 + S + 2, wd) - max(c0 - 2, 0), 0);
      const float z_rms = sqrtf(st[2] / static_cast<float>(X1 * X1 * C));
      const float x_rms = sqrtf(st[3] / fmaxf(static_cast<float>(vr * vc * C), 1.f));
      auto boot = [&](float in_max, float in_rms) {
        return __fadd_rn(fminf(__fmul_rn(rs1, in_max), __fmul_rn(__fmul_rn(5.f, rn1), in_rms)),
                         b1max);
      };
      if constexpr (REDO) {
        s_y1 = sy1;
        inv_y1 = 1.f / sy1;
        s_y2 = sy2;
        inv_y2 = 1.f / sy2;
      } else {
        scale_of(step == 0 ? boot(st[0], z_rms) : __fmul_rn(LAG_MARGIN, run2), s_y2, inv_y2);
        scale_of(step == 0 ? boot(st[1], x_rms) : __fmul_rn(LAG_MARGIN, run1), s_y1, inv_y1);
      }
    }
    // xq = quantized xm, us = quantized up2(z) (z's window holds clamped rows
    // and columns, the bilinear border rule; 2x row 2r0-2+qy blends z rows
    // a = qy/2 + (qy&1) and a+1 with weights 0.25/0.75 or 0.75/0.25, H first)
    for (int i = threadIdx.x; i < X1 * X1 * (C / 8); i += blockDim.x) {
      const int pix = i / (C / 8), c = 8 * (i % (C / 8));
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (inside(r0 - 2 + pix / X1, c0 - 2 + pix % X1, h, wd)) {
        load8(xs + pix * PB + c, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = clip127(scaled(v[j], inv_xm));
      }
      *reinterpret_cast<uint2*>(xq + (c >> 4) * XQP * 16 + pix * 16 + (c & 15)) =
          make_uint2(pack4(v), pack4(v + 4));
    }
    for (int i = threadIdx.x; i < U * U * (C / 8); i += blockDim.x) {
      const int pix = i / (C / 8), c = 8 * (i % (C / 8));
      const int qy = pix / U, qx = pix % U;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (inside(2 * r0 - 2 + qy, 2 * c0 - 2 + qx, 2 * h, 2 * wd)) {
        const int a = (qy >> 1) + (qy & 1), bcol = (qx >> 1) + (qx & 1);
        const float wa = (qy & 1) ? 0.75f : 0.25f, wb = (qx & 1) ? 0.75f : 0.25f;
        const bf16* z = zs + (a * X1 + bcol) * PB + c;
        float z00[8], z01[8], z10[8], z11[8];
        load8(z, z00);
        load8(z + PB, z01);
        load8(z + X1 * PB, z10);
        load8(z + X1 * PB + PB, z11);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float h0 = __fadd_rn(__fmul_rn(wa, z00[j]), __fmul_rn(1.f - wa, z10[j]));
          const float h1 = __fadd_rn(__fmul_rn(wa, z01[j]), __fmul_rn(1.f - wa, z11[j]));
          const float u = __fadd_rn(__fmul_rn(wb, h0), __fmul_rn(1.f - wb, h1));
          v[j] = clip127(scaled(u, inv_u));
        }
      }
      *reinterpret_cast<uint2*>(us + (c >> 4) * USP * 16 + pix * 16 + (c & 15)) =
          make_uint2(pack4(v), pack4(v + 4));
    }
    async_fence();
    __syncthreads();
    PHASE(0)

    // ---- conv1 at 2x and 1x, s8 x s8 -> s32 on wgmma ---------------------------
    // In window coordinates: output position q = y * Win + x of an input
    // window Win wide reads input pixel q + ky Win + kx at tap (ky, kx), so
    // 64 consecutive positions are a K-major A tile from any pixel (the
    // planes' descriptor). Eight m64 tiles per chunk: y2's 18 x 20 positions
    // over us (6 tiles) and y1's 10 x 12 over xq (2), four a warpgroup on
    // one code path; B is the stage, the chunk's 64 mid channels x 64 in.
    // The columns past the y window and the positions past its last row are
    // computed and dropped.
    unsigned in_rows = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int oy = ypix[i] >> 8, ox = ypix[i] & 255;
      const bool in = i < 6 ? inside(2 * r0 - 1 + oy, 2 * c0 - 1 + ox, 2 * h, 2 * wd)
                            : inside(r0 - 1 + oy, c0 - 1 + ox, h, wd);
      in_rows |= static_cast<unsigned>(in && ((keep_rows >> i) & 1u)) << i;
    }
    float amax1 = 0.f, amax2 = 0.f;   // this thread's y1 / y2 amax of the step
    int accf[4][4], accb[4][4];       // the fold's and conv2's sums: pixels 16 wl + g, + 8
    // acc <-> partial sums (this lane's pixels, channels 32 wg + 8j + 2t, + 1)
    auto sum_io = [&](int (&acc)[4][4], int* buf, bool load_) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int2* q = reinterpret_cast<int2*>(buf + (16 * wl + g + 8 * half) * SUMP + 32 * wg + 8 * j +
                                            t2);
          if (load_) {
            const int2 v = *q;
            acc[j][2 * half] = v.x;
            acc[j][2 * half + 1] = v.y;
          } else {
            *q = make_int2(acc[j][2 * half], acc[j][2 * half + 1]);
          }
        }
    };
#pragma unroll 1
    for (int ch = 0; ch < 4; ++ch) {
      int acc[4][8][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][j][i] = 0;
      keep(acc);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int js = js0 + ch * SPC + tap;
        const uint64_t bd = wgmma_desc_plain(ready(js), 1024, 128);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int in_w = m < 3 ? U : X1, lead = m < 3 ? USP * 16 : XQP * 16;
            wgmma_ss_s8_64x64(acc[m], jdesc[m] + (tap / 3) * in_w + tap % 3 + k * (lead >> 3),
                              bd + 128 * k);
          }
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      keep(acc);
      release(js0 + ch * SPC, 9);   // refilled under the epilogue
      PHASE(1)
      if (ch > 0) __syncthreads();   // the last chunk's fold and conv2 read the y windows
      PHASE(6)
      // y = lrelu(dequantised conv1 + b1), zeroed outside the image at the
      // window's scale, quantized with the step's scale into the y window;
      // values past +-127 (only at the lagged scale) are counted where the
      // step owns the pixel, then clipped. The stage's mid channels come in
      // the order that gives this lane (t = lane % 4) bytes 4t .. 4t + 3 of
      // each 16-byte chunk kc of a pixel: accumulator column 8j + 2t + e is
      // channel 16 (j / 2) + 4t + 2 (j % 2) + e
      // (ops/fused_block2_q.py::stage_weights_q), so a lane stores 4 bytes
      // at a time.
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        float cu[4], cx[4], bs[4];   // per byte: the 2x and 1x dequantization, the bias
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = ch * C + 16 * kc + 2 * t2 + 2 * jj;
          const float2 sw = *reinterpret_cast<const float2*>(s1s + n);
          const float2 bias = *reinterpret_cast<const float2*>(b1s + n);
          cu[2 * jj] = __fmul_rn(sw.x, s_u);
          cu[2 * jj + 1] = __fmul_rn(sw.y, s_u);
          cx[2 * jj] = __fmul_rn(sw.x, s_xm);
          cx[2 * jj + 1] = __fmul_rn(sw.y, s_xm);
          bs[2 * jj] = bias.x;
          bs[2 * jj + 1] = bias.y;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool is2 = i < 6, in = (in_rows >> i) & 1u;
          uint32_t word = 0;
          int over = 0;
          float big = 0.f;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int a = acc[i >> 1][2 * kc + (bb >> 1)][2 * (i & 1) + (bb & 1)];
            const float y =
                lrelu(__fadd_rn(__fmul_rn(__int2float_rn(a), is2 ? cu[bb] : cx[bb]), bs[bb]));
            const float f = in ? y : 0.f;
            const int q = quant_rn(f, is2 ? inv_y2 : inv_y1);
            const int k = min(max(q, -127), 127);
            over += k != q;
            big = fmaxf(big, fabsf(f));
            word |= static_cast<uint32_t>(k & 0xff) << (8 * bb);
          }
          if (is2) {
            amax2 = fmaxf(amax2, big);
          } else {
            amax1 = fmaxf(amax1, big);
          }
          if (COUNT && ((own >> i) & 1u)) {
            if (is2) {
              clip2 += over;
            } else {
              clip1 += over;
            }
          }
          if ((keep_rows >> i) & 1u) {
            *reinterpret_cast<uint32_t*>((is2 ? y2 + kc * 16 * Y2P : y1 + kc * 16 * Y1P) + yoff[i] +
                                         2 * t2) = word;
          }
        }
      }
      PHASE(2)
      __syncthreads();
      PHASE(6)

      // ---- the chunk's fold (y2, 16 taps) and conv2 (y1, 9 taps), s8 on wgmma --
      // A: this warp's 16 output pixels of the 8 x 8 step by ldmatrix from
      // the y windows into registers (stride 2 for the fold); B: the stage's
      // output channels 32 wg .. 32 wg + 31, so both warpgroups take one
      // code path. The stages go in 7 groups, the fold's taps 4 at a time
      // and conv2's 4, 4 and 1; a group's A fragments are loaded while the
      // group before it is in flight (two register buffers), then its
      // products issue, and the group before it is waited for. The int32
      // sums carry from chunk to chunk in shared memory.
      if (ch > 0) {
        sum_io(accf, sums, true);
        sum_io(accb, sums + S * S * SUMP, true);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) accf[j][i] = accb[j][i] = 0;
      }
      keep(accf);
      keep(accb);
      {
        const int p = 16 * wl + (lane & 7) + 8 * ((lane >> 3) & 1), py = p >> 3, px = p & 7;
        const int kc = lane >> 4;
        uint32_t af[2][4][2][4];
        uint64_t bd[2][4];
        // group k < 4: the fold's taps 4k ..; else conv2's 4 (k - 4) .. (the
        // last one alone)
        auto first = [&](auto k) {
          constexpr int K = decltype(k)::value;
          return js0 + ch * SPC + 9 + (K < 4 ? 4 * K : 16 + 4 * (K - 4));
        };
        auto load = [&](auto k) {
          constexpr int K = decltype(k)::value, ns = K == 6 ? 1 : 4;
#pragma unroll
          for (int s = 0; s < ns; ++s) {
            bd[K & 1][s] = wgmma_desc_plain(ready(first(k) + s), 1024, 128) + 32 * wg;
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const int plane = 2 * kk + kc;
              const s8* at;
              if constexpr (K < 4) {
                const int tap = 4 * K + s;
                at = y2 + plane * Y2P * 16 + ((2 * py + (tap >> 2)) * Y2 + 2 * px + (tap & 3)) * 16;
              } else {
                const int tap = 4 * (K - 4) + s;
                at = y1 + plane * Y1P * 16 + ((py + tap / 3) * Y1 + px + tap % 3) * 16;
              }
              ldsm_x4(af[K & 1][s][kk], at);
            }
          }
        };
        auto issue = [&](auto k) {
          constexpr int K = decltype(k)::value, ns = K == 6 ? 1 : 4;
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < ns; ++s)
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              if constexpr (K < 4) {
                wgmma_s8_64x32(accf, af[K & 1][s][kk], bd[K & 1][s] + 128 * kk);
              } else {
                wgmma_s8_64x32(accb, af[K & 1][s][kk], bd[K & 1][s] + 128 * kk);
              }
            }
          wgmma_commit();
        };
        // group k - 1's stages are counted released before group k + 1's
        // fragments load, and refilled after, so that the count's round
        // trip hides under the loads
        load(std::integral_constant<int, 0>{});
        issue(std::integral_constant<int, 0>{});
        load(std::integral_constant<int, 1>{});
        static_for<1, 7>([&](auto k) {
          constexpr int K = decltype(k)::value;
          issue(k);
          wgmma_wait<1>();
          keep(af[(K - 1) & 1]);
          const int js = first(std::integral_constant<int, K - 1>{});
          const unsigned counted = count(js);
          if constexpr (K + 1 < 7) load(std::integral_constant<int, K + 1>{});
          refill(js, 4, counted);
        });
        wgmma_wait<0>();
        keep(af);
        keep(accf);
        keep(accb);
        release(first(std::integral_constant<int, 6>{}), 1);
      }
      if (ch < 3) {
        sum_io(accf, sums, false);
        sum_io(accb, sums + S * S * SUMP, false);
      }
      PHASE(3)
    }

    // ---- epilogue --------------------------------------------------------------
    // fs = dequantised fold + b2, rounded; this lane: pixels 16 wl + g and
    // + 8, channels 32 wg + 8j + 2t and + 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 32 * wg + 8 * j + t2;
      const float2 bb = load2(b2 + n);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store2(fs + (16 * wl + g + 8 * half) * PB + n,
               __fadd_rn(__fmul_rn(__int2float_rn(accf[j][2 * half]),
                                   __fmul_rn(__ldg(sf + n), s_y2)),
                         bb.x),
               __fadd_rn(__fmul_rn(__int2float_rn(accf[j][2 * half + 1]),
                                   __fmul_rn(__ldg(sf + n + 1), s_y2)),
                         bb.y));
      }
    }
    __syncthreads();
    // out = ((conv2(y1) + b2) + (kd fs + bd) + up2(e)) + x, kd's tile laid
    // out as conv2's accumulators: m-tile wl, channels 32 wg ..
    {
      const ATile<bf16> a[1] = {a_tile<1>(fs, S, S, S * S, wl, lane)};
      float acck[1][4][4];
      zero(acck);
      conv_tiles<1, 1, 1, 4>(acck, a, Weights<bf16>{wdn, C, C}, 32 * wg, 0, lane);
      const int hh = h / 2, wh = wd / 2;
      const bf16* eb = e + static_cast<long long>(b) * hh * wh * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 32 * wg + 8 * j + t2;
        const float2 bb2 = load2(b2 + n), bbd = load2(bdn + n);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pp = 16 * wl + g + 8 * half, qy = pp / S, qx = pp % S;
          const int y = r0 + qy, xx = c0 + qx;
          if (y >= h || xx >= wd) continue;
          // 0.5x -> 1x: rows ja (weight wa) and jb of e, clamped; columns likewise
          const int pyr = y & 1, pxr = xx & 1;
          const float wa = pyr ? 0.75f : 0.25f, wb = pxr ? 0.75f : 0.25f;
          const int ja = min(max((y >> 1) - 1 + pyr, 0), hh - 1);
          const int jb = min(max((y >> 1) + pyr, 0), hh - 1);
          const int ka = min(max((xx >> 1) - 1 + pxr, 0), wh - 1);
          const int kb = min(max((xx >> 1) + pxr, 0), wh - 1);
          auto at = [&](int jj, int kk) {
            return load2(eb + (static_cast<long long>(jj) * wh + kk) * C + n);
          };
          const float2 eaa = at(ja, ka), eab = at(ja, kb), eba = at(jb, ka), ebb = at(jb, kb);
          const float ha0 = wa * eaa.x + (1.f - wa) * eba.x, ha1 = wa * eaa.y + (1.f - wa) * eba.y;
          const float hb0 = wa * eab.x + (1.f - wa) * ebb.x, hb1 = wa * eab.y + (1.f - wa) * ebb.y;
          const float body0 = __fadd_rn(
              __fmul_rn(__int2float_rn(accb[j][2 * half]), __fmul_rn(__ldg(s2 + n), s_y1)), bb2.x);
          const float body1 = __fadd_rn(
              __fmul_rn(__int2float_rn(accb[j][2 * half + 1]), __fmul_rn(__ldg(s2 + n + 1), s_y1)),
              bb2.y);
          const float2 xv = load2(xs + ((qy + 2) * X1 + qx + 2) * PB + n);
          const long long o = (static_cast<long long>(y) * wd + xx) * C + n;
          store2(out + img + o,
                 body0 + (acck[0][j][2 * half] + bbd.x) + (wb * ha0 + (1.f - wb) * hb0) + xv.x,
                 body1 + (acck[0][j][2 * half + 1] + bbd.y) + (wb * ha1 + (1.f - wb) * hb1) + xv.y);
        }
      }
    }
    PHASE(4)
    // the step's amaxes join the running ones; the reduction's barriers also
    // end the step (the next one overwrites xs, fs and the windows). A step
    // whose y1 or y2 values passed +-127 at the lagged scale goes on the
    // list for REDO.
    {
      float am[2] = {amax1, amax2};
      const bool is_max[2] = {true, true};
      block_reduce(am, is_max, red);
      run1 = fmaxf(run1, am[0]);
      run2 = fmaxf(run2, am[1]);
      if constexpr (!REDO) {
        const bool over1 = quant_rn(am[0], inv_y1) > 127, over2 = quant_rn(am[1], inv_y2) > 127;
        if ((over1 || over2) && threadIdx.x == 0) {
          float own1 = s_y1, own2 = s_y2, inv;
          if (over1) scale_of(am[0], own1, inv);
          if (over2) scale_of(am[1], own2, inv);
          int* entry = redo + 1 + 5 * atomicAdd(redo, 1);
          entry[0] = b;
          entry[1] = blockIdx.x;
          entry[2] = step;
          entry[3] = __float_as_int(own1);
          entry[4] = __float_as_int(own2);
        }
      }
    }
    PHASE(5)
    PHASE_STEP
  }
  PHASE_END
  if constexpr (COUNT) {
    float cl[2] = {static_cast<float>(clip1), static_cast<float>(clip2)};
    const bool is_max[2] = {false, false};
    block_reduce(cl, is_max, red);
    if (threadIdx.x == 0) {
      counts[strip_id * 2] = cl[0];
      counts[strip_id * 2 + 1] = cl[1];
    }
  }
}

template <typename T>
cudaError_t launch_f32(const void* const* p, void* out, float* counts, int batch, int h, int wd,
                       cudaStream_t stream) {
  const cudaError_t err = allow_smem(block_q_kernel<T>, Geo<T>::BYTES);
  if (err != cudaSuccess) return err;
  const int strips = (wd + S - 1) / S;
  const dim3 grid(strips, 1, batch);
  const auto t = [p](int i) { return static_cast<const T*>(p[i]); };
  const auto q = [p](int i) { return static_cast<const s8*>(p[i]); };
  const auto f = [p](int i) { return static_cast<const float*>(p[i]); };
  CDFO_LAUNCH(block_q_kernel<T>, grid, Geo<T>::BYTES, stream, t(0), q(1), f(2), t(3), q(4), f(5),
              t(6), q(7), f(8), t(9), t(10), t(11), t(12), t(13), t(14), f(15), static_cast<T*>(out),
              counts, h, wd, strips);
  return cudaGetLastError();
}

// the 0.5x branch into e, then the walk, then its listed steps again
cudaError_t launch_bf16(const void* const* p, void* out, float* counts, bf16* e, int* redo,
                        int batch, int h, int wd, cudaStream_t stream) {
  const auto t = [p](int i) { return static_cast<const bf16*>(p[i]); };
  const auto f = [p](int i) { return static_cast<const float*>(p[i]); };
  const s8* stages = static_cast<const s8*>(p[1]);
  cudaError_t err = allow_smem(half_branch_kernel, HGeo::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 hgrid((wd / 2 + HT - 1) / HT, (h / 2 + HT - 1) / HT, batch);
  CDFO_LAUNCH(half_branch_kernel, hgrid, HGeo::BYTES, stream, t(0), t(9), t(3), t(6), t(11),
              t(12), t(13), t(14), e, h, wd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto walk = counts != nullptr ? block_q_walk<true, false> : block_q_walk<false, false>;
  err = allow_smem(walk, QGeo::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(redo, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int strips = (wd + S - 1) / S;
  const dim3 grid(strips, 1, batch);
  CDFO_LAUNCH(walk, grid, QGeo::BYTES, stream, t(0), stages, f(2), t(3), f(5), t(6), f(8),
              t(11), t(12), t(13), t(14), f(15), e, static_cast<bf16*>(out), counts, redo, h, wd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto again = block_q_walk<false, true>;
  err = allow_smem(again, QGeo::BYTES);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const long long steps = static_cast<long long>(batch) * strips * ((h + S - 1) / S);
  const dim3 rgrid(static_cast<unsigned>(steps < sms ? steps : sms), 1, 1);
  CDFO_LAUNCH(again, rgrid, QGeo::BYTES, stream, t(0), stages, f(2), t(3), f(5), t(6), f(8),
              t(11), t(12), t(13), t(14), f(15), e, static_cast<bf16*>(out), nullptr, redo, h,
              wd);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, h, wd, 64) NHWC of the working type (is_bf16: 1 for
// bfloat16, 0 for float32), h and wd even. Float32: int8 weights in the s8
// Weights layout of conv3x3_tile.cuh: w1q [9][2][32][32][8], w2q
// [9][8][8][32][8], wfq [16][8][8][32][8] (the folded down2 . conv2, tap
// 4*ey + ex). Bfloat16: w1q holds the 136 weight stages of
// ops/fused_block2_q.py::stage_weights_q (conv1, then the fold and conv2,
// planes of 16-byte chunks) and w2q and wfq are NULL; w1b holds the 72
// stages of the dequantised conv1 and conv2 of ops/fused_block2_q.py::
// stage_half_weights and w2b is NULL (float32: w1b, w2b in the Weights
// layout). Both: float32 scales per output channel s1 [256], s2 [64], sf
// [64]; biases b1 [256], b2 [64] and the 1x1 convs wdn + bdn (down_0),
// wup + bup (up_0) of the working type in its Weights layout; bnd
// float32 [3]: max row sum of |W1|, max |b1|, max row 2-norm of W1.
// counts: null, or float32 [batch * ceil(wd / 8)][2], zeroed, that
// receives each strip's y1 and y2 values past the lagged scale.
// Bfloat16 only (else NULL): e, the 0.5x branch's output, workspace of
// [batch][h / 2][wd / 2][64] bfloat16; redo, int32 workspace of 1 + 5 x
// batch x ceil(wd / 8) x ceil(h / 8), the list of the steps the walk runs
// again. All device pointers. Returns a cudaError_t.
extern "C" int cdfo_fused_block2_q(const void* x, const void* w1q, const void* s1, const void* b1,
                                   const void* w2q, const void* s2, const void* b2,
                                   const void* wfq, const void* sf, const void* w1b,
                                   const void* w2b, const void* wdn, const void* bdn,
                                   const void* wup, const void* bup, const void* bnd, void* out,
                                   void* counts, void* e, void* redo, int is_bf16, int batch,
                                   int h, int wd, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0 || h % 2 != 0 || wd % 2 != 0) {
    return cudaErrorInvalidValue;
  }
  const void* p[16] = {x, w1q, s1, b1, w2q, s2, b2, wfq, sf, w1b, w2b, wdn, bdn, wup, bup, bnd};
  const auto s = static_cast<cudaStream_t>(stream);
  float* cnt = static_cast<float*>(counts);
  if (is_bf16) {
    if (e == nullptr || redo == nullptr) return cudaErrorInvalidValue;
    return launch_bf16(p, out, cnt, static_cast<bf16*>(e), static_cast<int*>(redo), batch, h,
                       wd, s);
  }
  return launch_f32<float>(p, out, cnt, batch, h, wd, s);
}
