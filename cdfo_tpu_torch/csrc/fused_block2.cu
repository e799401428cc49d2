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
// fp32, by shared memory, which is full at S = 8); every off-scale
// intermediate stays in shared memory, as the TPU kernel keeps it in VMEM. Windows, by scale (image
// origin of each window in brackets):
//   xs  1x    (S+4)^2     x, zeroed outside the image        [r0-2]
//   us  2x    (2S+4)^2    up2(ku x + bu), zeroed outside     [2r0-2]
//   ds  0.5x  (S/2+6)^2   kd down2(x) + bd, zeroed outside   [r0/2-3]
//   y1  1x    (S+2)^2     lrelu(conv1 xs), one 64-ch chunk   [r0-1]
//   y2  2x    (2S+2)^2    lrelu(conv1 us), one chunk         [2r0-1]
//   y5  0.5x  (S/2+4)^2   lrelu(conv1 ds), one chunk         [r0/2-2]
// The 256 mid channels are walked in 4 chunks of 64: each chunk computes
// y1, y2 and y5 (conv1 rows of the chunk), then adds the chunk's part of
// conv2(y1), fold(y2) and conv2(y5) to fp32 partial sums kept across
// chunks.
//
// bfloat16 (the main path), on wgmma (`wgmma_tile.cuh`). What held the
// mma.sync kernel back: ~1.1 MB of weights per 8x8 tile (conv2's and the
// fold's B fragments from L1/L2 in every warp) and, per wgmma measurements
// of this kernel, conv1: half the CTA's cycles, its activation operand
// reloaded by ldmatrix for every 64-channel chunk and tap in 16-row pieces.
// - Weights: every weight a CTA needs arrives in shared memory as a stream
//   of 8 KB stages, one 64 x 64 tap of a chunk each (conv1's 9 taps, the
//   fold's 16, conv2's 9 per chunk: 136), by 1-D bulk copies through the
//   TMA unit into a ring of 4 stages on mbarriers; each warp counts itself
//   done with a stage and the last reader refills its slot, so the two
//   warpgroups never wait for each other at a stage.
// - conv1 in window coordinates, both operands from shared memory: the
//   input windows (xs, us, ds) are 128-byte pixel rows, 128-byte swizzled,
//   so that N consecutive output positions of a tap are a K-major wgmma
//   tile starting at any row (the swizzle follows the address): weights as
//   A (m64, the chunk's 64 mid channels), pixels as B (N = 120, 80, 80 a
//   warpgroup), the two warpgroups splitting the 560 positions of y2, y1
//   and y5 (the window width, 2 columns more than the output's, is
//   computed and dropped: 12% more products than the outputs need) on one
//   code path (ptxas serializes every wgmma of a kernel in which only one
//   warpgroup takes a path with them). Results go to the y windows
//   (swizzled too) by transposing stmatrix stores.
// - The fold (each warpgroup 32 of its 64 output channels, m64n32k16) and
//   conv2 (warpgroup 0 the body's 64 pixels, warpgroup 1 the 0.5x branch's
//   36, m64n64k16) with A from the y windows by ldmatrix into registers,
//   all of a pair of stages' fragments loaded before its products issue;
//   the fp32 partial sums in shared memory.
// Its time beside the mma.sync kernel's and the int8 kernel's is in
// `PERF.md` (`chip_smoke.py` phase 3).
// float32 (the twin for the float32 checks) keeps the first design: a
// warp takes 1 m-tile in the conv1 phase, the conv2 phase splits fold,
// body and 0.5x work into 8 tasks, B fragments from device memory, the
// products on the CUDA cores, all three sums in shared memory.
// The epilogue rounds fold + b2 and conv2(y5) + b2, applies kd and ku as
// 1x1 GEMMs, expands the 0.5x branch with the clamped bilinear 2x stencil
// and sums everything with x in fp32, rounding once. Intermediates are
// rounded to the working type where the TPU kernel rounds them (z, u, d,
// y, the folded and 0.5x conv2 sums, e).
//
// Odd H or W are refused by the wrapper: the reference Block_ itself is
// undefined there (down2 then up2 gives 2 * floor(H / 2) rows).

#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 route: prologue, conv1 with
// the y stores, fold and conv2 with the sums (the chunks' phases summed),
// epilogue.
#include "phase_clocks.cuh"

namespace {

using namespace cdfo;

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int S = 8; };
template <> struct Tile<float> { static constexpr int S = 4; };

template <typename T>
struct Geo {
  // bfloat16 takes the wgmma route: every weight tap staged in shared memory
  static constexpr bool TC = std::is_same<T, bf16>::value;
  static constexpr int S = Tile<T>::S;
  static constexpr int X1 = S + 4, U = 2 * S + 4, D = S / 2 + 6;
  static constexpr int Y1 = S + 2, Y2 = 2 * S + 2, Y5 = S / 2 + 4, E = S / 2 + 2;
  // the windows xs, us, ds, y1, y2, y5; the wgmma route keeps them in
  // 128-byte pixel rows, 128-byte swizzled (`win`), as wgmma reads a
  // K-major tile (and for ldmatrix without bank conflicts)
  static constexpr int PIXELS = X1 * X1 + U * U + D * D + Y1 * Y1 + Y2 * Y2 + Y5 * Y5;
  static constexpr int WIN_BYTES = PIXELS * (TC ? C : Pitch<T>::value) * int(sizeof(T));
  // fp32 partial sums across chunks of conv2(y1), fold(y2) and conv2(y5)
  static constexpr int SUM_PIXELS = 2 * S * S + E * E;
  static constexpr int SUM_PITCH = C + 8;   // floats; conflict-free float2 fragment access
  // the wgmma route's ring of weight stages (one 64 x 64 tap of a chunk,
  // 8 KB, 1024-byte aligned), their mbarriers and counts
  static constexpr int RING = TC ? 4 : 0;
  static constexpr int STAGE_BYTES = C * C * 2;
  // (the ring, the windows, each of xs, us, ds 1024-byte aligned, the sums,
  // then 64 bytes of mbarriers and counts and a row that takes the
  // stores of positions outside the y windows; 1024 for the alignment)
  static constexpr int RING_BYTES = TC ? RING * STAGE_BYTES + 64 + C * 2 + 1024 : 0;
  static_assert(RING * (8 + 4) <= 64, "mbarriers and counts");
  static_assert(!TC || (X1 * X1 * C * 2) % 1024 == 0 && (U * U * C * 2) % 1024 == 0,
                "us and ds 1024-byte aligned after xs");
  static constexpr int BYTES = WIN_BYTES + SUM_PIXELS * SUM_PITCH * 4 + RING_BYTES;
  // m-tiles per warp in the float32 conv1 phase (its CUDA-core products
  // need the registers)
  static constexpr int MT1 = 1;
  static_assert(X1 * X1 <= Y2 * Y2 && D * D <= Y2 * Y2, "z and mean(x) live in y2");
  static_assert(S * S <= Y1 * Y1 && E * E <= Y5 * Y5 && E * E <= D * D, "epilogue buffers");
  static_assert((S * S) % 16 == 0, "whole m-tiles of output pixels");
  static_assert(BYTES <= 232448, "one block's shared memory");
};

constexpr int CM = 4 * C;   // mid channels

// load_window and mask_window (conv3x3_tile.cuh) for a window of 128-byte
// pixel rows whose 16-byte chunk c sits at chunk c ^ (pixel & 7)
__device__ void load_window_sw(bf16* dst, const bf16* __restrict__ src, int h, int w, int y0,
                               int x0, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols * 8; i += blockDim.x) {
    const int v = i & 7, pix = i >> 3;
    const int y = min(max(y0 + pix / cols, 0), h - 1), x = min(max(x0 + pix % cols, 0), w - 1);
    *reinterpret_cast<uint4*>(dst + pix * C + ((v ^ pix) & 7) * 8) =
        __ldg(reinterpret_cast<const uint4*>(src + (static_cast<long long>(y) * w + x) * C) + v);
  }
}
__device__ void mask_window_sw(bf16* buf, int h, int w, int y0, int x0, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols * 8; i += blockDim.x) {
    const int pix = i >> 3;
    if (!inside(y0 + pix / cols, x0 + pix % cols, h, w)) {
      *reinterpret_cast<uint4*>(buf + pix * C + (i & 7) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

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
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  bf16* ring = nullptr;         // wgmma route: the weight stages, their
  uint64_t* bars = nullptr;     // mbarriers and the count of warps done
  unsigned* used = nullptr;     // with each
  if constexpr (G::TC) {
    base += (1024u - (shared_address(base) & 1023u)) & 1023u;
    ring = reinterpret_cast<bf16*>(base);
    base += G::RING * G::STAGE_BYTES;
  }
  constexpr int WP = G::TC ? C : P;   // a window pixel's elements
  T* xs = reinterpret_cast<T*>(base);
  T* us = xs + X1 * X1 * WP;
  T* ds = us + U * U * WP;
  T* y1 = ds + D * D * WP;
  T* y2 = y1 + Y1 * Y1 * WP;
  T* y5 = y2 + Y2 * Y2 * WP;
  float* sum_b = reinterpret_cast<float*>(y5 + Y5 * Y5 * WP);   // conv2(y1), S x S
  float* sum_f = sum_b + S * S * G::SUM_PITCH;                  // fold(y2), S x S
  float* sum_5 = sum_f + S * S * G::SUM_PITCH;                  // conv2(y5), E x E
  if constexpr (G::TC) {
    bars = reinterpret_cast<uint64_t*>(sum_5 + E * E * G::SUM_PITCH);
    used = reinterpret_cast<unsigned*>(bars + G::RING);
  }
  T* zs = y2;   // prologue: ku x + bu at 1x, window of xs
  T* dm = y2;   // prologue: down2(x) at 0.5x, window of ds
  T* fs = y1;   // epilogue: fold + b2 at 1x, S x S
  T* bs = y5;   // epilogue: conv2(y5) + b2 at 0.5x, E x E, origin r0/2-1
  T* es = ds;   // epilogue: ku bs + bu
  T* trash = reinterpret_cast<T*>(bars + 8);   // wgmma route, 64 bytes past the mbarriers
  // element c of window pixel p (the wgmma route's swizzled rows)
  auto win = [&](T* buf, int p, int c) -> T* {
    if constexpr (G::TC) {
      return swizzled(buf, p, c);
    } else {
      return buf + p * P + c;
    }
  };

  const int hh = h / 2, wh = wd / 2;   // the 0.5x image
  const int r0 = blockIdx.y * S, c0 = blockIdx.x * S;
  const int q0 = r0 / 2, s0 = c0 / 2;   // 0.5x origin of the tile
  const long long img = static_cast<long long>(blockIdx.z) * h * wd * C;
  const T* xb = x + img;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // wgmma route: w1 is the stream of weight stages (ops/fused_block2.py::
  // stage_weights), 34 a chunk; the first RING are copied in under the
  // prologue
  constexpr int SPC = 9 + 16 + 9, NSTAGES = 4 * SPC;
  auto load_stage = [&](int js) {
    const int slot = js & (G::RING - 1);
    mbar_expect_tx(bars + slot, G::STAGE_BYTES);
    bulk_copy(ring + slot * C * C, w1 + static_cast<long long>(js) * C * C, G::STAGE_BYTES,
              bars + slot);
  };
  if constexpr (G::TC) {
    if (threadIdx.x == 0) {
      for (int slot = 0; slot < G::RING; ++slot) {
        mbar_init(bars + slot, 1);
        used[slot] = 0;
      }
      mbar_init_fence();
      for (int js = 0; js < G::RING; ++js) load_stage(js);
    }
  }

  PHASE_START
  // ---- prologue: xs (clamped for now), z = ku x + bu ---------------------
  if constexpr (G::TC) {
    load_window_sw(xs, xb, h, wd, r0 - 2, c0 - 2, X1, X1);
  } else {
    load_window(xs, xb, h, wd, r0 - 2, c0 - 2, X1, X1, true);
  }
  __syncthreads();
  const Weights<T> wt1{w1, CM, C}, wt2{w2, C, CM}, wtf{wf, C, CM}, wtd{wdn, C, C}, wtu{wup, C, C};
  // a 1x1 conv (64 -> 64) + bias over an n x n window, two m-tiles per warp;
  // in_sw: the input is a swizzled window (wgmma route); dst(p, c): where
  // output pixel p, channel c goes
  auto conv1x1 = [&](const T* in, bool in_sw, int n, const Weights<T>& wt, const T* bias,
                     auto&& dst, auto&& keep) {
    const int np = n * n, mts = (np + 15) / 16;
    for (int mt = 2 * warp; mt < mts; mt += 2 * WARPS) {
      const int mt1 = min(mt + 1, mts - 1);
      float acc[2][8][4];
      zero(acc);
      if constexpr (G::TC) {
        if (in_sw) {
          // ldmatrix rows of the swizzled window, B fragments as mma_k16
          const int rows[2] = {min(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, np - 1),
                               min(mt1 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, np - 1)};
          const uint2* b = reinterpret_cast<const uint2*>(wt.p) + lane;
#pragma unroll
          for (int kt = 0; kt < C / 16; ++kt) {
            uint32_t af[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              ldsm_x4(af[m], win(const_cast<T*>(in), rows[m], 16 * kt + (lane >> 4) * 8));
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const uint2 bv = __ldg(b + (kt * 8 + nt) * 32);
#pragma unroll
              for (int m = 0; m < 2; ++m) {
                mma16816(acc[m][nt], af[m][0], af[m][1], af[m][2], af[m][3], bv.x, bv.y);
              }
            }
          }
        }
      }
      if (!G::TC || !in_sw) {
        const ATile<T> a[2] = {a_tile<1>(in, n, n, np, mt, lane), a_tile<1>(in, n, n, np, mt1, lane)};
        conv_tiles<1, 1, 2, 8>(acc, a, wt, 0, 0, lane);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        for_each_pair(acc[m], m ? mt1 : mt, 0, np, lane, [&](int p, int c, float v0, float v1) {
          const float2 bb = load2(bias + c);
          const bool k = keep(p);
          store2(dst(p, c), k ? v0 + bb.x : 0.f, k ? v1 + bb.y : 0.f);
        });
      }
    }
  };
  auto pitch = [&](T* buf) { return [=](int p, int c) { return buf + p * P + c; }; };
  conv1x1(xs, G::TC, X1, wtu, bup, pitch(zs), [](int) { return true; });
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
    store8(win(us, pix, c), v);
  }
  if constexpr (G::TC) {
    mask_window_sw(xs, h, wd, r0 - 2, c0 - 2, X1, X1);
  } else {
    mask_window(xs, h, wd, r0 - 2, c0 - 2, X1, X1);
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
  conv1x1(dm, false, D, wtd, bdn, [&](int p, int c) { return win(ds, p, c); },
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

  if constexpr (G::TC) {
    // Every product on wgmma, its weights streamed through the ring in the
    // order of stage_weights: per chunk the 9 conv1 taps, the fold's 16 and
    // conv2's 9, every stage read by both warpgroups. Each warp counts
    // itself done with a stage's slot (`used`); the last of the 8 refills
    // it with stage js + 4, so the warpgroups never wait for each other at
    // a stage (and none can run two stages of a slot ahead: it reads each
    // stage itself).
    const int wg = warp >> 2, wl = warp & 3;
    // this lane's ldmatrix row of m-tile mt of an out_w-wide output over a
    // window in_w wide at stride st (rows past n_pix repeat the last), and
    // its 16-byte chunk of k-step kt
    auto a_pixel = [&](int in_w, int out_w, int n_pix, int st, int mt) {
      const int row = min(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, n_pix - 1);
      return (row / out_w) * st * in_w + (row % out_w) * st;
    };
    auto a_chunk = [&](int kt) { return 16 * kt + (lane >> 4) * 8; };
    // acc (m-tile mt, channels n0 ..) += or -> the partial sums in buf
    auto sums = [&](auto& acc, float* buf, int mt, int n0, int np, bool load) {
      for_each_pair(acc, mt, n0, np, lane, [&](int p, int n, float& v0, float& v1) {
        float2* q = reinterpret_cast<float2*>(buf + p * SP + n);
        if (load) {
          v0 += q->x;
          v1 += q->y;
        } else {
          *q = make_float2(v0, v1);
        }
      });
    };
    auto release = [&](int js) {
      __syncwarp();
      const int slot = js & (G::RING - 1);
      if (lane == 0 && atomicAdd(used + slot, 1u) == WARPS - 1) {
        used[slot] = 0;
        if (js + G::RING < NSTAGES) load_stage(js + G::RING);
      }
    };
    // a y window's conv1 outputs (an accumulator set of one warpgroup)
    // as lrelu(acc + b1), zeroed outside the image
    auto store_y = [&](auto& acc, const auto& job, float2 bias) {
      store_lrelu_window(acc, job.q, job.in_w, job.out_w, job.y, job.y0, job.x0, job.hs, job.ws,
                         bias, trash);
    };
    // the fold's and conv2's stages js (and js + 1 with `two`): every A
    // fragment loaded by ldmatrix first, then the products in one commit
    // group, waited for once (no register a product reads is written while
    // one is in flight)
    auto run_stages = [&](int js, auto two, auto&& load_a, auto&& issue) {
      constexpr int NS = decltype(two)::value ? 2 : 1;
      uint32_t af[NS][C / 16][4];
      uint64_t desc[NS];
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const int slot = (js + st) & (G::RING - 1);
        mbar_wait(bars + slot, ((js + st) / G::RING) & 1);
        desc[st] = wgmma_desc(ring + slot * C * C);
#pragma unroll
        for (int kt = 0; kt < C / 16; ++kt) load_a(st, kt, af[st][kt]);
      }
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < NS; ++st)
#pragma unroll
        for (int kt = 0; kt < C / 16; ++kt) issue(af[st][kt], desc[st] + 2 * kt);
      wgmma_commit();
      wgmma_wait<0>();
      keep(af);
#pragma unroll
      for (int st = 0; st < NS; ++st) release(js + st);
    };
    PHASE(0)
#pragma unroll 1
    for (int ch = 0; ch < 4; ++ch) {
      const int j0 = ch * SPC;
      // conv1 in window coordinates: for output position q = y * Win + x
      // of a window Win wide, tap (ky, kx) reads input pixel q + ky * Win +
      // kx, so 8 consecutive positions read 8 consecutive 128-byte pixel
      // rows: a K-major wgmma tile from any row (the swizzle follows the
      // address), no ldmatrix. D = weights (A: the stage, 64 mid channels
      // x 64 in) . pixels (B: N positions). Each warpgroup takes three
      // jobs of 120, 80 and 80 positions (warpgroup 0: y2's 0-279;
      // warpgroup 1: y1, y2's 280-359, y5), one code path for both (a
      // wgmma in a path only one warpgroup takes is serialized); the x >=
      // Wout columns are computed and dropped. A tap's products stay in
      // flight while the next tap's stage is awaited.
      {
        const float2 bias = make_float2(to_f(b1[ch * C + 16 * wl + (lane >> 2)]),
                                        to_f(b1[ch * C + 16 * wl + (lane >> 2) + 8]));
        struct Job {
          T* in;       // input window
          int in_w;    // its width
          int q;       // first position
          T* y;        // output window
          int out_w;   // its width (and height)
          int y0, x0;  // its image origin
          int hs, ws;  // the image at its scale
        };
        const Job y2a{us, U, 0, y2, Y2, 2 * r0 - 1, 2 * c0 - 1, 2 * h, 2 * wd};
        const Job y1a{xs, X1, 0, y1, Y1, r0 - 1, c0 - 1, h, wd};
        const Job y5a{ds, D, 0, y5, Y5, q0 - 2, s0 - 2, hh, wh};
        Job jobs[3] = {wg ? y1a : y2a, wg ? y2a : y2a, wg ? y5a : y2a};
        jobs[1].q = wg ? 280 : 120;
        jobs[2].q = wg ? 0 : 200;
        float acc0[15][4], acc1[10][4], acc2[10][4];
        zero1(acc0);
        zero1(acc1);
        zero1(acc2);
        keep(acc0);
        keep(acc1);
        keep(acc2);
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int js = j0 + tap, slot = js & (G::RING - 1);
          const int ky = tap / 3, kx = tap % 3;
          uint64_t bd[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            bd[i] = wgmma_desc(jobs[i].in + (jobs[i].q + ky * jobs[i].in_w + kx) * C);
          }
          mbar_wait(bars + slot, (js / G::RING) & 1);
          const uint64_t ad = wgmma_desc(ring + slot * C * C);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            wgmma_ss_64x120(acc0, ad + 2 * k, bd[0] + 2 * k);
            wgmma_ss_64x80(acc1, ad + 2 * k, bd[1] + 2 * k);
            wgmma_ss_64x80(acc2, ad + 2 * k, bd[2] + 2 * k);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (tap > 0) release(js - 1);
        }
        wgmma_wait<0>();
        keep(acc0);
        keep(acc1);
        keep(acc2);
        release(j0 + 8);
        store_y(acc0, jobs[0], bias);
        store_y(acc1, jobs[1], bias);
        store_y(acc2, jobs[2], bias);
      }
      __syncthreads();
      PHASE(1)
      // fold: warp wl of each warpgroup takes m-tile wl of the S x S
      // output, channels 32 wg .. 32 wg + 31 (the stage's B rows from 32 wg)
      {
        const int pix = a_pixel(Y2, S, S * S, 2, wl);
        float acc[4][4];
        zero1(acc);
        if (ch > 0) sums(acc, sum_f, wl, 32 * wg, S * S, true);
        keep(acc);
#pragma unroll 1
        for (int tp = 0; tp < 16; tp += 2) {
          run_stages(
              j0 + 9 + tp, std::true_type{},
              [&](int st, int kt, uint32_t (&r)[4]) {
                const int tap = tp + st;
                ldsm_x4(r, win(y2, pix + (tap >> 2) * Y2 + (tap & 3), a_chunk(kt)));
              },
              [&](uint32_t (&r)[4], uint64_t d) {
                wgmma_64x32(acc, r, d + wg * (32 * 128 / 16));
              });
        }
        keep(acc);
        sums(acc, sum_f, wl, 32 * wg, S * S, false);
      }
      // conv2: warpgroup 0 the body's m-tile wl (y1), warpgroup 1 the 0.5x
      // branch's min(wl, NE - 1) (y5; a warp past NE repeats the last
      // m-tile and stores nothing), adding to the sums in shared memory
      {
        const int mt = wg ? min(wl, NE - 1) : wl;
        const bool dup = wg && wl >= NE;
        T* yb = wg ? y5 : y1;
        const int in_w = wg ? Y5 : Y1, np = wg ? E * E : S * S;
        const int pix = wg ? a_pixel(Y5, E, E * E, 1, mt) : a_pixel(Y1, S, S * S, 1, mt);
        float* buf = wg ? sum_5 : sum_b;
        float acc[8][4];
        zero1(acc);
        if (ch > 0 && !dup) sums(acc, buf, mt, 0, np, true);
        keep(acc);
        auto load = [&](int tap, int kt, uint32_t (&r)[4]) {
          ldsm_x4(r, win(yb, pix + (tap / 3) * in_w + tap % 3, a_chunk(kt)));
        };
        auto issue = [&](uint32_t (&r)[4], uint64_t d) { wgmma_64x64(acc, r, d); };
#pragma unroll 1
        for (int tp = 0; tp < 8; tp += 2) {
          run_stages(
              j0 + 25 + tp, std::true_type{},
              [&](int st, int kt, uint32_t (&r)[4]) { load(tp + st, kt, r); }, issue);
        }
        run_stages(
            j0 + 33, std::false_type{}, [&](int, int kt, uint32_t (&r)[4]) { load(8, kt, r); },
            issue);
        keep(acc);
        if (!dup) sums(acc, buf, mt, 0, np, false);
      }
      __syncthreads();
      PHASE(2)
    }
  } else {
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
        conv_tiles<3, 3, MT1, 8>(acc, a, wt1, ch * C, 0, lane);
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
  }

  // ---- epilogue -------------------------------------------------------------
  // fs = fold + b2 (fp32; the wgmma route wrote it above) and bs =
  // conv2(y5) + b2, rounded to the working type
  constexpr int NFS = S * S;
  for (int i = threadIdx.x; i < (NFS + E * E) * (C / 2); i += blockDim.x) {
    const int pix = i / (C / 2), c = 2 * (i % (C / 2));
    const bool fold = pix < NFS;
    const int p = fold ? pix : pix - NFS;
    const float2 v = *reinterpret_cast<const float2*>((fold ? sum_f : sum_5) + p * SP + c);
    const float2 bb = load2(b2 + c);
    store2((fold ? fs : bs) + p * P + c, v.x + bb.x, v.y + bb.y);
  }
  __syncthreads();
  conv1x1(bs, false, E, wtu, bup, pitch(es), [](int) { return true; });
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
        const float2 xv = load2(win(xs, (py + 2) * X1 + px + 2, n));
        const long long o = (static_cast<long long>(y) * wd + xx) * C + n;
        store2(out + img + o,
               v0 + body.x + bb2.x + bbd.x + wb * ha0 + (1.f - wb) * hb0 + xv.x,
               v1 + body.y + bb2.y + bbd.y + wb * ha1 + (1.f - wb) * hb1 + xv.y);
      });
    }
  }
  if constexpr (G::TC) {
    PHASE(3)
    PHASE_END
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
// [64] (up_0). bfloat16 takes in w1 the weight stages of
// ops/fused_block2.py::stage_weights ([4][34][64][64], swizzled) and
// NULL for w2 and wf. All device pointers of one dtype (is_bf16: 1 for bfloat16, 0
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
