// Alignment tail, out = RB2(RB1(gate[b] * x)) + center[b / nbr] with
// RB(t) = t + conv3x3(relu(conv3x3(t))), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_tail.py::resblock_pair_hcw
// (kernel body _kernel), which DualAttAlignment._tail_from_hcw launches
// once per align_reconstruct call on the 6k neighbour images.
//
// What bounds it: four 64->64 3x3 convs, 295 KFLOP per pixel, against
// 2 x 128 B of x and out plus 128 B of centre per pixel in bf16; the eager
// version writes and re-reads each conv's output, its bias add, relu and
// residual, ~16 passes over 6k full-resolution images, and the centre skip
// as a materialised broadcast. This kernel reads x and the centre once and
// writes out once; the CALayer gate is multiplied into the input tile and
// the centre is read as center[b / nbr], never broadcast. Each stage is
// zeroed outside the image (the next conv's zero padding) and rounded to
// the working type where the TPU kernel rounds: xm, y1, r1 and y2.
//
// bfloat16 (the main path), on wgmma (`wgmma_tile.cuh`). The first design
// (one CTA per 16 x 16 tile, `mma.sync` with every weight fragment from
// device memory in every warp, the halo chain 24^2 -> 22^2 -> 20^2 -> 18^2
// -> 16^2: 1.43x the products the outputs need) ran at 6.7x its bound.
// Now:
// - A persistent walk. 24-column strips of every image are cut into steps
//   of R = 8 output rows, and each CTA (one per SM) walks a contiguous run
//   of steps down the strips. Each of the four windows (xm, y1, r1, y2)
//   keeps R + 2 rows of 32 positions (the strip and 4 columns each side);
//   a step computes each stage's R new rows and then moves the last two
//   rows of every window to its top, so the vertical halo is computed once
//   per strip instead of once per tile. A run that starts inside a strip,
//   or at its top, first runs the step before it with zeroed windows and
//   no stores: from R >= 6 on, the two rows each window keeps are exact.
//   Products: 4 x 32 positions per output row of 24 pixels, 1.33x what the
//   outputs need (plus that warm-up step per run), against the tiles'
//   1.43x; a tile, whose windows shrink by a halo per stage, would cost
//   1.8x at the 16 x 16 tile the shared memory allows.
// - Window coordinates (fused_block2.cu): the windows are 128-byte pixel
//   rows, 128-byte swizzled, all 32 positions wide, so output position q of
//   any stage reads input positions q + 32 ky + kx: 64 consecutive
//   positions are a K-major wgmma tile from any pixel. Pixels are A (m64,
//   two per warpgroup, the 256 positions of a step's stage split between
//   the warpgroups on one code path) and the weight tap is B (n64); the
//   accumulators then hold two adjacent channels of a position per lane,
//   stored as 4-byte pairs into the next window or, for the last stage,
//   beside the centre's into device memory. The columns past a stage's
//   valid width are computed and dropped.
// - Weights: the 36 taps of a step (4 convs x 9) stream as 8 KB stages
//   by bulk copies into a ring of 4 on mbarriers, in order, the last warp
//   done with a slot refilling it (fused_block2.cu); a tap's products stay
//   in flight while the next tap's stage is awaited. The host packs the
//   stages once (ops/fused_tail.py::stage_tail_weights) and the model keeps
//   them.
// - Device memory behind the products: x's new rows for the next step are
//   fetched by cp.async into xm as soon as xm is done with (after the second
//   conv), and the step's centre pixels at its start, so that neither the
//   first nor the last stage waits for device memory (PERF.md: the
//   last stage 25k -> 13k cycles a step, xm 8.5k -> 4.7k).
// From wgmma_tile.cuh: wgmma_ss_64x64, wgmma_desc, the mbarrier and
// bulk-copy helpers, cp_async16_or_zero, cp_async_wait_n, async_fence.
// float32 (the twin for the float32 checks) keeps the first design in 8 x
// 8 tiles, its products on the CUDA cores.

#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 walk, summed over a CTA's
// steps: xm, the four convs with their stores, the row move.
#include "phase_clocks.cuh"

namespace {

using namespace cdfo;

// ---- float32: one CTA per 8 x 8 tile, the halo chain ---------------------

constexpr int FH = 8, FW = 8;   // the float32 tile

constexpr int smem_bytes_f32() {
  return ((FH + 8) * (FW + 8) + (FH + 6) * (FW + 6) + (FH + 4) * (FW + 4)) * Pitch<float>::value *
         static_cast<int>(sizeof(float));
}

// One conv stage over a rows x cols output window (in_w = cols + 2), one
// m-tile per warp at a time; epi(pixel, channel, v0, v1) gets the raw sums.
template <typename Epi>
__device__ __forceinline__ void stage_f32(const float* in, int rows, int cols, const float* w,
                                          int warp, int lane, Epi&& epi) {
  const int npix = rows * cols, mts = (npix + 15) / 16;
  for (int mt = warp; mt < mts; mt += WARPS) {
    const ATile<float> a[1] = {a_tile<1>(in, cols + 2, cols, npix, mt, lane)};
    float acc[1][8][4];
    zero(acc);
    conv_tiles<3, 3, 1, 8>(acc, a, Weights<float>{w, C, C}, 0, 0, lane);
    for_each_pair(acc[0], mt, 0, npix, lane, epi);
  }
}

__global__ void __launch_bounds__(THREADS)
tail_kernel_f32(const float* __restrict__ x, const float* __restrict__ center,
                const float* __restrict__ gate, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out, int h, int wd, int nbr) {
  constexpr int TH = FH, TW_ = FW, P = Pitch<float>::value;
  extern __shared__ uint4 cdfo_smem[];
  float* xm = reinterpret_cast<float*>(cdfo_smem);   // (TH+8) x (TW+8), origin (r0-4, c0-4)
  float* ys = xm + (TH + 8) * (TW_ + 8) * P;         // y1, then y2
  float* rs = ys + (TH + 6) * (TW_ + 6) * P;         // r1, origin (r0-2, c0-2)
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW_;
  const long long img = static_cast<long long>(b) * h * wd * C;
  const long long cimg = static_cast<long long>(b / nbr) * h * wd * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int WW = C * C;   // elements per 3x3 tap of one conv; a conv is 9 WW

  load_window(xm, x + img, h, wd, r0 - 4, c0 - 4, TH + 8, TW_ + 8, false);
  __syncthreads();
  for (int i = threadIdx.x; i < (TH + 8) * (TW_ + 8) * (C / 2); i += blockDim.x) {
    const int pix = i / (C / 2), c = 2 * (i % (C / 2));
    float* p = xm + pix * P + c;
    const float2 v = load2(p), g = load2(gate + b * C + c);
    store2(p, v.x * g.x, v.y * g.y);
  }
  __syncthreads();

  // y1 = relu(conv11(xm) + b11) on (TH+6) x (TW+6), origin (r0-3, c0-3)
  stage_f32(xm, TH + 6, TW_ + 6, w, warp, lane, [&](int p, int n, float v0, float v1) {
    const int y = r0 - 3 + p / (TW_ + 6), xx = c0 - 3 + p % (TW_ + 6);
    const float2 bb = load2(bias + n);
    const bool in = inside(y, xx, h, wd);
    store2(ys + p * P + n, in ? fmaxf(v0 + bb.x, 0.f) : 0.f, in ? fmaxf(v1 + bb.y, 0.f) : 0.f);
  });
  __syncthreads();
  // r1 = xm + conv12(y1) + b12 on (TH+4) x (TW+4), origin (r0-2, c0-2)
  stage_f32(ys, TH + 4, TW_ + 4, w + 9 * WW, warp, lane, [&](int p, int n, float v0, float v1) {
    const int py = p / (TW_ + 4), px = p % (TW_ + 4);
    const float2 bb = load2(bias + C + n);
    const float2 s = load2(xm + ((py + 2) * (TW_ + 8) + px + 2) * P + n);
    const bool in = inside(r0 - 2 + py, c0 - 2 + px, h, wd);
    store2(rs + p * P + n, in ? v0 + bb.x + s.x : 0.f, in ? v1 + bb.y + s.y : 0.f);
  });
  __syncthreads();
  // y2 = relu(conv21(r1) + b21) on (TH+2) x (TW+2), origin (r0-1, c0-1)
  stage_f32(rs, TH + 2, TW_ + 2, w + 18 * WW, warp, lane, [&](int p, int n, float v0, float v1) {
    const int y = r0 - 1 + p / (TW_ + 2), xx = c0 - 1 + p % (TW_ + 2);
    const float2 bb = load2(bias + 2 * C + n);
    const bool in = inside(y, xx, h, wd);
    store2(ys + p * P + n, in ? fmaxf(v0 + bb.x, 0.f) : 0.f, in ? fmaxf(v1 + bb.y, 0.f) : 0.f);
  });
  __syncthreads();
  // out = r1 + conv22(y2) + b22 + center[b / nbr] on TH x TW
  stage_f32(ys, TH, TW_, w + 27 * WW, warp, lane, [&](int p, int n, float v0, float v1) {
    const int py = p / TW_, px = p % TW_;
    const int y = r0 + py, xx = c0 + px;
    if (y < h && xx < wd) {
      const long long o = (static_cast<long long>(y) * wd + xx) * C + n;
      const float2 bb = load2(bias + 3 * C + n);
      const float2 s = load2(rs + ((py + 2) * (TW_ + 4) + px + 2) * P + n);
      const float2 cc = load2(center + cimg + o);
      store2(out + img + o, v0 + bb.x + s.x + cc.x, v1 + bb.y + s.y + cc.y);
    }
  });
}

// ---- bfloat16: the persistent walk on wgmma ------------------------------

constexpr int TW = 24;                  // output columns of a strip
constexpr int W0 = TW + 8;              // positions per window row
constexpr int R = 8;                    // output rows per step
constexpr int NPOS = R * W0;            // positions a stage computes per step
constexpr int WPIX = (R + 2) * W0 + 8;  // pixel rows per window (+ the taps' overread)
constexpr int RING = 4;                 // weight stages in flight
constexpr int STAGE = C * C;            // elements per stage (8 KB)
constexpr int TAPS = 36;                // stages per step: 4 convs x 9 taps
constexpr int CPIX = R * TW;            // pixel rows of the centre's staging buffer
constexpr int SMEM_BF16 = 1024 + RING * STAGE * 2 + 4 * WPIX * C * 2 + CPIX * C * 2 + 64;
static_assert(R >= 6, "the warm-up step leaves exact rows only from R = 6 on");
static_assert(NPOS == 4 * 64, "two m64 tiles per warpgroup");
static_assert((R * W0) % 8 == 0 && (WPIX * C * 2) % 1024 == 0, "swizzle phase and alignment");
static_assert(SMEM_BF16 <= 232448, "one block's shared memory");

// element c of pixel p of a window of 128-byte swizzled pixel rows
__device__ __forceinline__ bf16* sw(bf16* buf, int p, int c) {
  return buf + p * C + ((((c >> 3) ^ p) & 7) << 3) + (c & 7);
}

__global__ void __launch_bounds__(THREADS, 1)
tail_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ center,
                  const bf16* __restrict__ gate, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias, bf16* __restrict__ out, int batch, int h, int wd,
                  int nbr) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* xm = ring + RING * STAGE;   // window row k: image row r + 2 + k
  bf16* y1 = xm + WPIX * C;         // r + 1 + k
  bf16* r1 = y1 + WPIX * C;         // r + k
  bf16* y2 = r1 + WPIX * C;         // r - 1 + k
  bf16* cen = y2 + WPIX * C;        // the step's centre pixels, R x TW
  uint64_t* bars = reinterpret_cast<uint64_t*>(cen + CPIX * C);
  unsigned* used = reinterpret_cast<unsigned*>(bars + RING);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int strips = (wd + TW - 1) / TW, steps = (h + R - 1) / R;
  const long long total = static_cast<long long>(batch) * strips * steps;
  const long long g0 = blockIdx.x * total / gridDim.x, g1 = (blockIdx.x + 1) * total / gridDim.x;
  // the steps this CTA runs: its own and a warm-up before each walk it
  // starts (at g0 and at every strip top after it)
  const long long walks = g1 > g0 ? 1 + (g1 - 1) / steps - g0 / steps : 0;
  const long long nstages = TAPS * (g1 - g0 + walks);

  auto load_stage = [&](long long js) {
    const int slot = static_cast<int>(js & (RING - 1));
    mbar_expect_tx(bars + slot, STAGE * 2);
    bulk_copy(ring + slot * STAGE, w + (js % TAPS) * STAGE, STAGE * 2, bars + slot);
  };
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < RING; ++slot) {
      mbar_init(bars + slot, 1);
      used[slot] = 0;
    }
    mbar_init_fence();
    for (long long js = 0; js < RING && js < nstages; ++js) load_stage(js);
  }
  __syncthreads();
  // each warp counts itself done with a stage's slot; the last of the 8
  // refills it
  auto release = [&](long long js) {
    __syncwarp();
    const int slot = static_cast<int>(js & (RING - 1));
    if (lane == 0 && atomicAdd(used + slot, 1u) == WARPS - 1) {
      used[slot] = 0;
      if (js + RING < nstages) load_stage(js + RING);
    }
  };

  long long js = 0;   // the next weight stage
  PHASE_START
  // One conv stage: the NPOS positions of window `in` (this warpgroup's
  // two m-tiles), the 9 taps of the stream; epi(q, n, v0, v1) gets the raw
  // sums of position q, channels n and n + 1.
  auto conv = [&](const bf16* in, auto&& epi) {
    float acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
    keep(acc[0]);
    keep(acc[1]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int slot = static_cast<int>(js & (RING - 1));
      const int off = (tap / 3) * W0 + tap % 3;
      const uint64_t a0 = wgmma_desc(in + (128 * wg + off) * C);
      const uint64_t a1 = wgmma_desc(in + (128 * wg + 64 + off) * C);
      mbar_wait(bars + slot, static_cast<uint32_t>((js / RING) & 1));
      const uint64_t bd = wgmma_desc(ring + slot * STAGE);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_ss_64x64(acc[0], a0 + 2 * k, bd + 2 * k);
        wgmma_ss_64x64(acc[1], a1 + 2 * k, bd + 2 * k);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (tap > 0) release(js - 1);
      ++js;
    }
    wgmma_wait<0>();
    keep(acc[0]);
    keep(acc[1]);
    release(js - 1);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = 128 * wg + 64 * m + 16 * wl + g + 8 * half;
          epi(q, 8 * j + t2, acc[m][j][2 * half], acc[m][j][2 * half + 1]);
        }
  };
  auto put = [&](bf16* buf, int p, int n, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(sw(buf, p, n)) = __floats2bfloat162_rn(v0, v1);
  };
  auto get = [&](bf16* buf, int p, int n) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sw(buf, p, n)));
  };
  auto barrier = [] {
    async_fence();
    __syncthreads();
  };

  // x's rows of the xm window of a step at row r, rows k0 .. R + 1, by
  // cp.async as they are (zero outside the image), one group
  auto fetch_x = [&](const bf16* xb, int r, int c0, int k0) {
    for (int i = threadIdx.x; i < (R + 2 - k0) * W0 * 8; i += THREADS) {
      const int v = i & 7, pix = k0 * W0 + (i >> 3);
      const int y = r + 2 + pix / W0, xx = c0 - 4 + pix % W0;
      const bool in = inside(y, xx, h, wd);
      cp_async16_or_zero(xm + pix * C + ((v ^ pix) & 7) * 8,
                         xb + (in ? (static_cast<long long>(y) * wd + xx) * C + 8 * v : 0), in);
    }
    cp_async_commit();
  };

  // One step: output rows r .. r + R - 1 of columns c0 .. c0 + TW - 1 of
  // image b. `first`: the windows are zeroed and xm loaded whole (a
  // warm-up, whose outputs are not stored); else xm's top two rows are
  // the last step's and its other rows' x the last step fetched. `next`:
  // the step after this one continues the strip, and this one fetches x
  // for it once xm is free.
  auto step = [&](int b, int r, int c0, bool first, bool store, bool next) {
    const bf16* xb = x + static_cast<long long>(b) * h * wd * C;
    const bf16* cb = center + static_cast<long long>(b / nbr) * h * wd * C;
    const bf16* gb = gate + b * C;
    if (first) {
      for (int i = threadIdx.x; i < 4 * WPIX * 8; i += THREADS) {
        reinterpret_cast<uint4*>(xm)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      fetch_x(xb, r, c0, 0);
    }
    cp_async_wait_n<0>();
    __syncthreads();
    // the centre pixels of the step's outputs, for the last stage
    if (store) {
      for (int i = threadIdx.x; i < CPIX * 8; i += THREADS) {
        const int v = i & 7, pix = i >> 3;
        const int y = r + pix / TW, xx = c0 + pix % TW;
        const bool in = y < h && xx < wd;
        cp_async16_or_zero(cen + pix * C + ((v ^ pix) & 7) * 8,
                           cb + (in ? (static_cast<long long>(y) * wd + xx) * C + 8 * v : 0), in);
      }
    }
    cp_async_commit();
    // xm = x * gate[b], rounded, on the rows fetched (zero outside the image)
    for (int i = threadIdx.x; i < (first ? R + 2 : R) * W0 * 8; i += THREADS) {
      const int v = i & 7, pix = (first ? 0 : 2) * W0 + (i >> 3);
      bf16* p = xm + pix * C + ((v ^ pix) & 7) * 8;
      float f[8], gv[8];
      load8(p, f);
      load8(gb + 8 * v, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] *= gv[j];
      store8(p, f);
    }
    barrier();
    PHASE(0)
    // y1 = relu(conv11(xm) + b11): new rows 2 .. R + 1 of y1
    conv(xm, [&](int q, int n, float v0, float v1) {
      const float2 bb = load2(bias + n);
      const bool in = inside(r + 3 + q / W0, c0 - 3 + q % W0, h, wd);
      put(y1, q + 2 * W0, n, in ? fmaxf(v0 + bb.x, 0.f) : 0.f, in ? fmaxf(v1 + bb.y, 0.f) : 0.f);
    });
    barrier();
    PHASE(1)
    // r1 = xm + conv12(y1) + b12
    conv(y1, [&](int q, int n, float v0, float v1) {
      const float2 bb = load2(bias + C + n), s = get(xm, q + 2, n);
      const bool in = inside(r + 2 + q / W0, c0 - 2 + q % W0, h, wd);
      put(r1, q + 2 * W0, n, in ? v0 + bb.x + s.x : 0.f, in ? v1 + bb.y + s.y : 0.f);
    });
    barrier();
    // xm and y1 are done with: their rows R and R + 1 become rows 0 and 1
    // (R W0 is a multiple of 8, so the swizzle phase of each pixel row
    // stays), then x of the next step's rows 2 .. R + 1 is fetched
    for (int i = threadIdx.x; i < 2 * 2 * W0 * 8; i += THREADS) {
      uint4* wbuf = reinterpret_cast<uint4*>(i < 2 * W0 * 8 ? xm : y1);
      const int e = i % (2 * W0 * 8);
      wbuf[e] = wbuf[e + R * W0 * 8];
    }
    __syncthreads();
    if (next) fetch_x(xb, r + R, c0, 2);
    PHASE(2)
    // y2 = relu(conv21(r1) + b21)
    conv(r1, [&](int q, int n, float v0, float v1) {
      const float2 bb = load2(bias + 2 * C + n);
      const bool in = inside(r + 1 + q / W0, c0 - 1 + q % W0, h, wd);
      put(y2, q + 2 * W0, n, in ? fmaxf(v0 + bb.x, 0.f) : 0.f, in ? fmaxf(v1 + bb.y, 0.f) : 0.f);
    });
    barrier();
    PHASE(3)
    // out = r1 + conv22(y2) + b22 + center[b / nbr] (the centre fetched:
    // all but the newest cp.async group, the next step's x)
    if (next) {
      cp_async_wait_n<1>();
    } else {
      cp_async_wait_n<0>();
    }
    __syncthreads();
    conv(y2, [&](int q, int n, float v0, float v1) {
      const int y = r + q / W0, xx = c0 + q % W0;
      if (!store || q % W0 >= TW || y >= h || xx >= wd) return;
      const float2 bb = load2(bias + 3 * C + n), s = get(r1, q + 2, n);
      const float2 cc = get(cen, (q / W0) * TW + q % W0, n);
      const long long o = (static_cast<long long>(b) * h + y) * wd + xx;
      store2(out + o * C + n, v0 + bb.x + s.x + cc.x, v1 + bb.y + s.y + cc.y);
    });
    __syncthreads();
    PHASE(4)
    // rows R and R + 1 of r1 and y2 become rows 0 and 1
    for (int i = threadIdx.x; i < 2 * 2 * W0 * 8; i += THREADS) {
      uint4* wbuf = reinterpret_cast<uint4*>(i < 2 * W0 * 8 ? r1 : y2);
      const int e = i % (2 * W0 * 8);
      wbuf[e] = wbuf[e + R * W0 * 8];
    }
    __syncthreads();
    PHASE(5)
    PHASE_STEP
  };

#pragma unroll 1
  for (long long gs = g0; gs < g1; ++gs) {
    const int i = static_cast<int>(gs % steps);
    const long long sb = gs / steps;
    const int c0 = static_cast<int>(sb % strips) * TW, b = static_cast<int>(sb / strips);
    if (gs == g0 || i == 0) step(b, (i - 1) * R, c0, true, false, true);
    step(b, i * R, c0, false, true, gs + 1 < g1 && i + 1 < steps);
  }
  PHASE_END
}

cudaError_t launch_f32(const float* x, const float* center, const float* gate, const float* w,
                       const float* bias, float* out, int batch, int h, int wd, int nbr,
                       cudaStream_t stream) {
  const cudaError_t err = allow_smem(tail_kernel_f32, smem_bytes_f32());
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + FW - 1) / FW, (h + FH - 1) / FH, batch);
  CDFO_LAUNCH(tail_kernel_f32, grid, smem_bytes_f32(), stream, x, center, gate, w, bias, out, h,
              wd, nbr);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* x, const bf16* center, const bf16* gate, const bf16* w,
                        const bf16* bias, bf16* out, int batch, int h, int wd, int nbr,
                        cudaStream_t stream) {
  const cudaError_t err = allow_smem(tail_wgmma_kernel, SMEM_BF16);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const long long units = static_cast<long long>(batch) * ((wd + TW - 1) / TW) * ((h + R - 1) / R);
  const dim3 grid(static_cast<unsigned>(units < sms ? units : sms));
  CDFO_LAUNCH(tail_wgmma_kernel, grid, SMEM_BF16, stream, x, center, gate, w, bias, out, batch,
              h, wd, nbr);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, h, wd, 64) NHWC; center: (batch / nbr, h, wd, 64); gate:
// (batch, 64); bias: [4 convs: RB1.conv1, RB1.conv2, RB2.conv1,
// RB2.conv2][64]; w: float32 [4 convs][9 taps][64 out][64 in], bfloat16
// the weight stages of ops/fused_tail.py::stage_tail_weights ([36][64 out]
// [64 in], 128-byte swizzled). All device pointers of one dtype (is_bf16:
// 1 for bfloat16, 0 for float32). Returns a cudaError_t.
extern "C" int cdfo_fused_tail(const void* x, const void* center, const void* gate,
                               const void* w, const void* bias, void* out, int is_bf16,
                               int batch, int h, int wd, int nbr, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0 || nbr <= 0 || batch % nbr != 0) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(center),
                       static_cast<const bf16*>(gate), static_cast<const bf16*>(w),
                       static_cast<const bf16*>(bias), static_cast<bf16*>(out), batch, h, wd,
                       nbr, s);
  }
  return launch_f32(static_cast<const float*>(x), static_cast<const float*>(center),
                    static_cast<const float*>(gate), static_cast<const float*>(w),
                    static_cast<const float*>(bias), static_cast<float*>(out), batch, h, wd, nbr,
                    s);
}
