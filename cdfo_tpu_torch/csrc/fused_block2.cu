// The whole SCNet Block_, hand-written for Hopper (sm_90a):
//   out = x + body(x) + kd(fold(body1(up2(ku x)))) + up2(ku(body(kd(down2 x))))
// with body(t) = conv2(lrelu(conv1 t)) (3x3, 64 -> 256 -> 64, biases, lrelu
// slope 0.1), body1 its first half, ku/kd the up_0/down_0 1x1 convs, up2 /
// down2 bilinear 2x / 0.5x resizes (align_corners = False, border clamp)
// and fold = down2 . conv2 as one stride-2 4x4 conv (the host folds the
// weights, fused_block2.py::fold_down_conv2, + the conv2 bias).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_block2.py::scale_block_hcw
// (kernel body _kernel), which fused_vjp.block_fused launches 21 times per
// trunk call.
//
// What bounds it: operations. At 64 channels a Block_ is ~2.44 MFLOP per
// 1x pixel with the fold (conv1 at 1x, 2x and 0.5x; conv2 at 1x and 0.5x;
// the folded conv2 at 1x), ~1.27 TFLOP per call at 4 x 272 x 480, against
// 2 x 128 B of x and out per pixel. The eager version instead moves the 2x
// branch's 256-channel activation (~1 GB per call in bf16) and a dozen
// bias, activation and resize passes through device memory.
//
// Design: one CTA of 8 warps per S x S output tile (S = 8 in bf16, 4 in
// fp32, by shared memory); every off-scale intermediate stays in shared
// memory, as the TPU kernel keeps it in VMEM. Windows, by scale (image
// origin of each window in brackets):
//   xs  1x    (S+4)^2     x, zeroed outside the image        [r0-2]
//   us  2x    (2S+4)^2    up2(ku x + bu), zeroed outside     [2r0-2]
//   ds  0.5x  (S/2+6)^2   kd down2(x) + bd, zeroed outside   [r0/2-3]
//   y1  1x    (S+2)^2     lrelu(conv1 xs), one 64-ch chunk   [r0-1]
//   y2  2x    (2S+2)^2    lrelu(conv1 us), one chunk         [2r0-1]
//   y5  0.5x  (S/2+4)^2   lrelu(conv1 ds), one chunk         [r0/2-2]
// The 256 mid channels are walked in 4 chunks of 64: each chunk computes
// y1, y2 and y5 (conv1 rows of the chunk), then adds the chunk's part of
// conv2(y1), fold(y2) and conv2(y5) to fp32 partial sums kept in shared
// memory across chunks. In the conv1 phase a warp takes 4 m-tiles (bf16),
// which share each weight fragment, and each tap's weights are staged in
// shared memory once per CTA; in the conv2 phase the 8 warps split fold,
// body and 0.5x work into 8 tasks of about the same number of mma.
// The epilogue rounds fold + b2 and conv2(y5) + b2, applies kd and ku as
// 1x1 GEMMs, expands the 0.5x branch with the clamped bilinear 2x stencil
// and sums everything with x in fp32, rounding once. Intermediates are
// rounded to the working type where the TPU kernel rounds them (z, u, d,
// y, the folded and 0.5x conv2 sums, e).
//
// Odd H or W are refused by the wrapper: the reference Block_ itself is
// undefined there (down2 then up2 gives 2 * floor(H / 2) rows).

#include "conv3x3_tile.cuh"

namespace {

using namespace cdfo;

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int S = 8; };
template <> struct Tile<float> { static constexpr int S = 4; };

template <typename T>
struct Geo {
  static constexpr int S = Tile<T>::S;
  static constexpr int X1 = S + 4, U = 2 * S + 4, D = S / 2 + 6;
  static constexpr int Y1 = S + 2, Y2 = 2 * S + 2, Y5 = S / 2 + 4, E = S / 2 + 2;
  static constexpr int PIXELS = X1 * X1 + U * U + D * D + Y1 * Y1 + Y2 * Y2 + Y5 * Y5;
  // fp32 partial sums of conv2(y1), fold(y2) and conv2(y5) across chunks
  static constexpr int SUM_PIXELS = 2 * S * S + E * E;
  static constexpr int SUM_PITCH = C + 8;   // floats; conflict-free float2 fragment access
  // bf16: two buffers for one tap of a conv1 chunk's weights (64 x 64)
  static constexpr int STAGE = std::is_same<T, bf16>::value ? C * C : 0;
  static constexpr int BYTES = PIXELS * Pitch<T>::value * static_cast<int>(sizeof(T)) +
                               SUM_PIXELS * SUM_PITCH * 4 + 2 * STAGE * static_cast<int>(sizeof(T));
  // m-tiles per warp in the conv1 phase: bf16 shares each weight fragment
  // among 4; the fp32 twin keeps 1 (its CUDA-core products need the
  // registers)
  static constexpr int MT1 = std::is_same<T, bf16>::value ? 4 : 1;
  static_assert(X1 * X1 <= Y2 * Y2 && D * D <= Y2 * Y2, "z and mean(x) live in y2");
  static_assert(S * S <= Y1 * Y1 && E * E <= Y5 * Y5 && E * E <= D * D, "epilogue buffers");
  static_assert((S * S) % 16 == 0, "whole m-tiles of output pixels");
};

constexpr int CM = 4 * C;   // mid channels

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
block_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
             const T* __restrict__ w2, const T* __restrict__ b2, const T* __restrict__ wf,
             const T* __restrict__ wdn, const T* __restrict__ bdn, const T* __restrict__ wup,
             const T* __restrict__ bup, T* __restrict__ out, int h, int wd) {
  using G = Geo<T>;
  constexpr int S = G::S, X1 = G::X1, U = G::U, D = G::D;
  constexpr int Y1 = G::Y1, Y2 = G::Y2, Y5 = G::Y5, E = G::E, P = Pitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* xs = reinterpret_cast<T*>(cdfo_smem);
  T* us = xs + X1 * X1 * P;
  T* ds = us + U * U * P;
  T* y1 = ds + D * D * P;
  T* y2 = y1 + Y1 * Y1 * P;
  T* y5 = y2 + Y2 * Y2 * P;
  float* sum_b = reinterpret_cast<float*>(y5 + Y5 * Y5 * P);   // conv2(y1), S x S
  float* sum_f = sum_b + S * S * G::SUM_PITCH;                 // fold(y2), S x S
  float* sum_5 = sum_f + S * S * G::SUM_PITCH;                 // conv2(y5), E x E
  T* wst = reinterpret_cast<T*>(sum_5 + E * E * G::SUM_PITCH);  // staged conv1 taps
  T* zs = y2;   // prologue: ku x + bu at 1x, window of xs
  T* dm = y2;   // prologue: down2(x) at 0.5x, window of ds
  T* fs = y1;   // epilogue: fold + b2 at 1x, S x S
  T* bs = y5;   // epilogue: conv2(y5) + b2 at 0.5x, E x E, origin r0/2-1
  T* es = ds;   // epilogue: ku bs + bu

  const int hh = h / 2, wh = wd / 2;   // the 0.5x image
  const int r0 = blockIdx.y * S, c0 = blockIdx.x * S;
  const int q0 = r0 / 2, s0 = c0 / 2;   // 0.5x origin of the tile
  const long long img = static_cast<long long>(blockIdx.z) * h * wd * C;
  const T* xb = x + img;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // ---- prologue: xs (clamped for now), z = ku x + bu ---------------------
  load_window(xs, xb, h, wd, r0 - 2, c0 - 2, X1, X1, true);
  __syncthreads();
  const Weights<T> wt1{w1, CM, C}, wt2{w2, C, CM}, wtf{wf, C, CM}, wtd{wdn, C, C}, wtu{wup, C, C};
  // a 1x1 conv (64 -> 64) + bias over an n x n window, two m-tiles per warp
  auto conv1x1 = [&](const T* in, int n, const Weights<T>& wt, const T* bias, T* dst, auto&& keep) {
    const int np = n * n, mts = (np + 15) / 16;
    for (int mt = 2 * warp; mt < mts; mt += 2 * WARPS) {
      const int mt1 = min(mt + 1, mts - 1);
      const ATile<T> a[2] = {a_tile<1>(in, n, n, np, mt, lane), a_tile<1>(in, n, n, np, mt1, lane)};
      float acc[2][8][4];
      zero(acc);
      conv_tiles<1, 1, 2, 8>(acc, a, wt, 0, 0, lane);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        for_each_pair(acc[m], m ? mt1 : mt, 0, np, lane, [&](int p, int c, float v0, float v1) {
          const float2 bb = load2(bias + c);
          const bool k = keep(p);
          store2(dst + p * P + c, k ? v0 + bb.x : 0.f, k ? v1 + bb.y : 0.f);
        });
      }
    }
  };
  conv1x1(xs, X1, wtu, bup, zs, [](int) { return true; });
  __syncthreads();
  // u = up2(z) on the 2x window; z's window holds clamped rows and columns,
  // which is the bilinear border rule. 2x row 2r0-2+qy blends z window rows
  // a = qy/2 + (qy&1) and a+1 with weights 0.25/0.75 (even) or 0.75/0.25.
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
        const float r0v = wa * z00[j] + (1.f - wa) * z10[j];
        const float r1v = wa * z01[j] + (1.f - wa) * z11[j];
        v[j] = wb * r0v + (1.f - wb) * r1v;
      }
    }
    store8(us + pix * P + c, v);
  }
  mask_window(xs, h, wd, r0 - 2, c0 - 2, X1, X1);
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
          [&](int p) { return inside(q0 - 3 + p / D, s0 - 3 + p % D, hh, wh); });
  __syncthreads();

  // ---- the 4 mid-channel chunks -------------------------------------------
  // conv1 phase: the y2, y1 and y5 m-tiles share the chunk's conv1 weights,
  // so they form one list, taken MT1 at a time by each warp.
  constexpr int MT1 = G::MT1;
  constexpr int N2 = (Y2 * Y2 + 15) / 16, N1 = (Y1 * Y1 + 15) / 16, N5 = (Y5 * Y5 + 15) / 16;
  constexpr int NM = N2 + N1 + N5;
  auto y_tile = [&](int f) {
    if (f < N2) return a_tile<1>(us, U, Y2, Y2 * Y2, f, lane);
    if (f < N2 + N1) return a_tile<1>(xs, X1, Y1, Y1 * Y1, f - N2, lane);
    return a_tile<1>(ds, D, Y5, Y5 * Y5, f - N2 - N1, lane);
  };
  // bias[nt] = the conv1 biases of this lane's two channels of n-tile nt
  auto y_store = [&](int f, const float (&acc)[8][4], const float2 (&bias)[8]) {
    // lrelu(conv1 + b1), zeroed outside the image at the window's scale
    auto put = [&](T* dst, int np, int w_, int y0, int x0, int hs, int ws, int mt) {
      for_each_pair(acc, mt, 0, np, lane, [&](int p, int n, float v0, float v1) {
        const bool in = inside(y0 + p / w_, x0 + p % w_, hs, ws);
        const float2 bb = bias[n >> 3];
        store2(dst + p * P + n, in ? lrelu(v0 + bb.x) : 0.f, in ? lrelu(v1 + bb.y) : 0.f);
      });
    };
    if (f < N2) put(y2, Y2 * Y2, Y2, 2 * r0 - 1, 2 * c0 - 1, 2 * h, 2 * wd, f);
    else if (f < N2 + N1) put(y1, Y1 * Y1, Y1, r0 - 1, c0 - 1, h, wd, f - N2);
    else put(y5, Y5 * Y5, Y5, q0 - 2, s0 - 2, hh, wh, f - N2 - N1);
  };
  // conv2 phase: 8 tasks, one per warp, each adding one chunk to a piece of
  // the fp32 partial sums in shared memory: warps 0-3 a pair of fold
  // m-tiles x 32 channels, warps 4-5 a pair of body m-tiles, warps 6-7 a
  // pair of 0.5x m-tiles (x 64 channels; an odd count repeats its last
  // m-tile, computed and stored twice).
  constexpr int NF = S * S / 16, NE = (E * E + 15) / 16;
  static_assert(NF <= 4 && NE <= 4, "conv2 phase fits 8 warps");
  constexpr int SP = G::SUM_PITCH;
  // acc <-> partial sums (load: add the chunks so far; ch == 0 starts at 0)
  auto sums = [&](auto& acc, float* buf, const int (&mts)[2], int n0, int np, bool load) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      for_each_pair(acc[m], mts[m], n0, np, lane, [&](int p, int n, float& v0, float& v1) {
        float2* q = reinterpret_cast<float2*>(buf + p * SP + n);
        if (load) {
          const float2 old = *q;
          v0 += old.x;
          v1 += old.y;
        } else {
          *q = make_float2(v0, v1);
        }
      });
    }
  };

#pragma unroll 1
  for (int ch = 0; ch < 4; ++ch) {
    const T* b1c = b1 + ch * C;
    for (int task = warp; task * MT1 < NM; task += WARPS) {
      ATile<T> a[MT1];
      int f[MT1];
#pragma unroll
      for (int m = 0; m < MT1; ++m) {
        f[m] = min(task * MT1 + m, NM - 1);
        a[m] = y_tile(f[m]);
      }
      float acc[MT1][8][4];
      zero(acc);
      if constexpr (G::STAGE > 0) {
        // every warp has exactly one task: the 8 warps walk the 9 taps in
        // step, each tap's chunk weights (4 k-tiles x 8 n-tiles of
        // fragments, 8 KB) copied once per CTA into shared memory while the
        // previous tap computes
        static_assert(NM <= MT1 * WARPS, "one conv1 task per warp");
        auto stage = [&](int tap, int buf) {
          for (int i = threadIdx.x; i < 4 * 128; i += blockDim.x) {
            const int kt = i >> 7, j = i & 127;
            cp_async16(wst + buf * C * C + kt * 1024 + j * 8,
                       w1 + (tap * 4 + kt) * (CM * 16) + ch * 1024 + j * 8);
          }
          cp_async_commit();
        };
        stage(0, 0);
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          cp_async_wait();
          __syncthreads();
          if (tap + 1 < 9) stage(tap + 1, (tap + 1) & 1);
          int off[MT1];
#pragma unroll
          for (int m = 0; m < MT1; ++m) off[m] = ((tap / 3) * a[m].in_w + tap % 3) * P;
          mma_tap_smem<MT1, 8>(acc, a, off, wst + (tap & 1) * C * C, lane);
        }
      } else {
        conv_tiles<3, 3, MT1, 8>(acc, a, wt1, ch * C, 0, lane);
      }
      float2 bias[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bias[nt] = load2(b1c + nt * 8 + (lane & 3) * 2);
#pragma unroll
      for (int m = 0; m < MT1; ++m) {
        if (m == 0 || f[m] != f[m - 1]) y_store(f[m], acc[m], bias);
      }
    }
    __syncthreads();
    // (a warp whose pair starts past the m-tile count has no task)
    if (warp < 4 && 2 * (warp >> 1) < NF) {
      const int m0 = 2 * (warp >> 1), m1 = min(m0 + 1, NF - 1), n0 = (warp & 1) * 32;
      const int mts[2] = {m0, m1};
      const ATile<T> a[2] = {a_tile<2>(y2, Y2, S, S * S, m0, lane),
                             a_tile<2>(y2, Y2, S, S * S, m1, lane)};
      float acc[2][4][4];
      zero(acc);
      if (ch > 0) sums(acc, sum_f, mts, n0, S * S, true);
      conv_tiles<4, 4, 2, 4>(acc, a, wtf, n0, ch * C, lane);
      sums(acc, sum_f, mts, n0, S * S, false);
    } else if (warp >= 4 && 2 * (warp & 1) < (warp < 6 ? NF : NE)) {
      const bool body = warp < 6;
      const int cnt = body ? NF : NE;
      const int m0 = 2 * (warp & 1), m1 = min(m0 + 1, cnt - 1);
      const int mts[2] = {m0, m1};
      const ATile<T> a[2] = {
          body ? a_tile<1>(y1, Y1, S, S * S, m0, lane) : a_tile<1>(y5, Y5, E, E * E, m0, lane),
          body ? a_tile<1>(y1, Y1, S, S * S, m1, lane) : a_tile<1>(y5, Y5, E, E * E, m1, lane)};
      float acc[2][8][4];
      zero(acc);
      float* buf = body ? sum_b : sum_5;
      const int np = body ? S * S : E * E;
      if (ch > 0) sums(acc, buf, mts, 0, np, true);
      conv_tiles<3, 3, 2, 8>(acc, a, wt2, 0, ch * C, lane);
      sums(acc, buf, mts, 0, np, false);
    }
    __syncthreads();
  }

  // ---- epilogue -------------------------------------------------------------
  // fs = fold + b2 and bs = conv2(y5) + b2, rounded to the working type
  for (int i = threadIdx.x; i < (S * S + E * E) * (C / 2); i += blockDim.x) {
    const int pix = i / (C / 2), c = 2 * (i % (C / 2));
    const bool fold = pix < S * S;
    const int p = fold ? pix : pix - S * S;
    const float2 v = *reinterpret_cast<const float2*>((fold ? sum_f : sum_5) + p * SP + c);
    const float2 bb = load2(b2 + c);
    store2((fold ? fs : bs) + p * P + c, v.x + bb.x, v.y + bb.y);
  }
  __syncthreads();
  conv1x1(bs, E, wtu, bup, es, [](int) { return true; });
  __syncthreads();
  // out = x + conv2(y1) + b2 + kd fs + bd + up2(es), one m-tile pair per warp
  for (int mt = 2 * warp; mt < NF; mt += 2 * WARPS) {
    const int mt1 = min(mt + 1, NF - 1);
    const ATile<T> a[2] = {a_tile<1>(fs, S, S, S * S, mt, lane),
                           a_tile<1>(fs, S, S, S * S, mt1, lane)};
    float acc[2][8][4];
    zero(acc);
    conv_tiles<1, 1, 2, 8>(acc, a, wtd, 0, 0, lane);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      for_each_pair(acc[m], m ? mt1 : mt, 0, S * S, lane, [&](int p, int n, float v0, float v1) {
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
        const float2 body = *reinterpret_cast<const float2*>(sum_b + p * SP + n);
        const float2 bb2 = load2(b2 + n), bbd = load2(bdn + n);
        const float2 xv = load2(xs + ((py + 2) * X1 + px + 2) * P + n);
        const long long o = (static_cast<long long>(y) * wd + xx) * C + n;
        store2(out + img + o,
               v0 + body.x + bb2.x + bbd.x + wb * ha0 + (1.f - wb) * hb0 + xv.x,
               v1 + body.y + bb2.y + bbd.y + wb * ha1 + (1.f - wb) * hb1 + xv.y);
      });
    }
  }
}

template <typename T>
cudaError_t launch(const void* const* p, void* out, int batch, int h, int wd,
                   cudaStream_t stream) {
  const cudaError_t err = allow_smem(block_kernel<T>, Geo<T>::BYTES);
  if (err != cudaSuccess) return err;
  constexpr int S = Tile<T>::S;
  const dim3 grid((wd + S - 1) / S, (h + S - 1) / S, batch);
  const auto a = [p](int i) { return static_cast<const T*>(p[i]); };
  CDFO_LAUNCH(block_kernel<T>, grid, Geo<T>::BYTES, stream, a(0), a(1), a(2), a(3), a(4), a(5),
              a(6), a(7), a(8), a(9), static_cast<T*>(out), h, wd);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, h, wd, 64) NHWC, h and wd even; weights in the Weights
// layout of conv3x3_tile.cuh (taps x out x in): w1 [9][256][64], b1
// [256], w2 [9][64][256], b2 [64], wf [16][64][256] (the folded down2 .
// conv2, tap 4*ey + ex), wdn [64][64] + bdn [64] (down_0), wup [64][64] + bup
// [64] (up_0). All device pointers of one dtype (is_bf16: 1 for bfloat16, 0
// for float32). Returns a cudaError_t.
extern "C" int cdfo_fused_block2(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, const void* wf, const void* wdn, const void* bdn,
                                 const void* wup, const void* bup, void* out, int is_bf16,
                                 int batch, int h, int wd, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0 || h % 2 != 0 || wd % 2 != 0) {
    return cudaErrorInvalidValue;
  }
  const void* p[10] = {x, w1, b1, w2, b2, wf, wdn, bdn, wup, bup};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(p, out, batch, h, wd, s) : launch<float>(p, out, batch, h, wd, s);
}
