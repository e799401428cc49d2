// The int8 SCNet Block_, hand-written for Hopper (sm_90a): the Block_ of
// fused_block2.cu,
//   out = x + body(x) + kd(fold(body1(up2(ku x)))) + up2(ku(body(kd(down2 x))))
// with conv1 at 1x and 2x, conv2 at 1x and the down2-folded conv2 as
// int8 x int8 -> int32 tensor-core products (mma.sync.m16n8k32), and the
// 0.5x branch, the 1x1 convs, the resizes and the residual in the working
// type T (bfloat16, or float32 for the card-vs-CPU checks).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_block2_q.py::scale_block_hcw_q
// (kernel body _kernel), which the int8 trunk launches 21 times per call.
// The quantization scheme is that file's (see ops/fused_block2_q.py):
// int8 weights per output channel from the host; per step the masked input
// window xm quantized with its own amax and the 2x planes u with amax(z);
// the lrelu'd conv1 outputs y1, y2 quantized with a lagged running scale
// (1.25 x the largest amax of the earlier steps of the strip, step 0 from
// the analytic bound); int32 sums dequantised by s_act * s_w[channel].
//
// What bounds it: operations, as fused_block2.cu (~1.27 TOP per call at
// 4 x 272 x 480, 94% of them int8 at twice the bf16 tensor-core peak). That
// peak is wgmma's: through mma.sync the int8 products run no faster per
// multiply-add than the exact kernel's bf16 ones (PERF.md), so this kernel
// is the scheme made right, and an s8 wgmma version the way to its rate.
//
// Design: the lag needs a serial order, which CTAs do not have. One CTA of
// 8 warps owns an 8-pixel column strip of one image and walks its 8 x 8
// steps from the top row down, carrying the two running amaxes in
// registers (the TPU kernel walks 16-row steps of the whole width; the
// plain version takes the geometry as an argument). Per step the windows
// of fused_block2.cu live in shared memory, the int8 ones at one byte per
// channel (image origin of each window in brackets):
//   xs  T   1x    12^2   x, clamped at the image border      [r0-2]
//   xq  s8  1x    12^2   quantized xm (x zeroed outside)     [r0-2]
//   us  s8  2x    20^2   quantized up2(ku x + bu)            [2r0-2]
//   ds  T   0.5x  10^2   kd down2(x) + bd, zeroed outside    [r0/2-3]
//   y1  s8  1x    10^2   quantized lrelu(conv1 xq), a chunk  [r0-1]
//   y2  s8  2x    18^2   quantized lrelu(conv1 us), a chunk  [2r0-1]
//   y5  T   0.5x  8^2    lrelu(conv1 ds), one chunk          [r0/2-2]
// The 256 mid channels are walked in 4 chunks of 64. Per chunk, 7 warps
// take 4 of the 28 int8 conv1 m-tiles each, the chunk's weights staged a
// row of taps at a time in shared memory; then the 8 warps share the 4 y5
// m-tiles (T, dequantised weights); then fold (warps 0-3, int8), conv2(y1)
// (warps 4-5, int8) and conv2(y5) (warps 6-7, T) add the chunk to partial
// sums in shared memory, int32 for the int8 products. Three block reductions per
// step give the amaxes; every float step that sets a quantized value is
// written without fused multiply-add, so that it rounds as the plain
// version does.

#include "conv3x3_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of each step of a strip's walk, summed
// over its steps.
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

  PHASE_START
  float run1 = 0.f, run2 = 0.f;     // largest y1 / y2 amax of the steps so far
  float clip1 = 0.f, clip2 = 0.f;   // this thread's clipped y1 / y2 values
  const int nsteps = (h + S - 1) / S;

#pragma unroll 1
  for (int step = 0; step < nsteps; ++step) {
    const int r0 = step * S, q0 = r0 / 2;

    // ---- prologue: xs, z = ku x + bu, the amaxes of z and xm --------------
    load_window(xs, xb, h, wd, r0 - 2, c0 - 2, X1, X1, true);
    __syncthreads();
    PHASE(0)
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
    PHASE(1)
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
    scale_of(step == 0 ? boot(st[0], z_rms) : __fmul_rn(LAG_MARGIN, run2), s_y2, inv_y2);
    scale_of(step == 0 ? boot(st[1], x_rms) : __fmul_rn(LAG_MARGIN, run1), s_y1, inv_y1);

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
    PHASE(2)
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

    PHASE(3)
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
    // lagged scale; values past +-127 are counted where the step owns the
    // pixel, then clipped. sw, bias: this lane's conv1 weight scales and
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
        PHASE(4)
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
      PHASE(5)
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
      PHASE(6)
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
      PHASE(7)
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
    PHASE(8)
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
    PHASE(9)
    // the step's y amaxes join the running ones; its two barriers also end
    // the step (the next one overwrites xs and the partial sums)
    {
      float am[2] = {amax1, amax2};
      const bool is_max[2] = {true, true};
      block_reduce(am, is_max, red);
      run1 = fmaxf(run1, am[0]);
      run2 = fmaxf(run2, am[1]);
    }
    PHASE(10)
  }
  PHASE_END
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

template <typename T>
cudaError_t launch(const void* const* p, void* out, float* counts, int batch, int h, int wd,
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

}  // namespace

// x, out: (batch, h, wd, 64) NHWC of the working type (is_bf16: 1 for
// bfloat16, 0 for float32), h and wd even. int8 weights in the s8 Weights
// layout of conv3x3_tile.cuh: w1q [9][2][32][32][8], w2q [9][8][8][32][8],
// wfq [16][8][8][32][8] (the folded down2 . conv2, tap 4*ey + ex), with
// float32 scales per output channel s1 [256], s2 [64], sf [64]; biases b1
// [256], b2 [64] and the dequantised conv1 / conv2 (w1b, w2b) and the 1x1
// convs wdn + bdn (down_0), wup + bup (up_0) of the working type in its
// Weights layout; bnd float32 [3]: max row sum of |W1|, max |b1|, max row
// 2-norm of W1. counts: null, or float32 [batch * ceil(wd / 8)][2] that
// receives each strip's clipped y1 and y2 values. All device pointers.
// Returns a cudaError_t.
extern "C" int cdfo_fused_block2_q(const void* x, const void* w1q, const void* s1, const void* b1,
                                   const void* w2q, const void* s2, const void* b2,
                                   const void* wfq, const void* sf, const void* w1b,
                                   const void* w2b, const void* wdn, const void* bdn,
                                   const void* wup, const void* bup, const void* bnd, void* out,
                                   void* counts, int is_bf16, int batch, int h, int wd,
                                   void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0 || h % 2 != 0 || wd % 2 != 0) {
    return cudaErrorInvalidValue;
  }
  const void* p[16] = {x, w1q, s1, b1, w2q, s2, b2, wfq, sf, w1b, w2b, wdn, bdn, wup, bup, bnd};
  const auto s = static_cast<cudaStream_t>(stream);
  float* cnt = static_cast<float*>(counts);
  return is_bf16 ? launch<bf16>(p, out, cnt, batch, h, wd, s)
                 : launch<float>(p, out, cnt, batch, h, wd, s);
}
