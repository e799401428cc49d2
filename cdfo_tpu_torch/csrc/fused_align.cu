// The dual MSA of the alignment as two passes over the neighbour images,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels cdfo_tpu/ops/fused_align.py::msa_stage1 and
// ::msa_stage2, which DualAttAlignment._fused_msa launches once each per
// align_reconstruct call on the 6k neighbour images.
//
// Stage 1: k = relu(w W_fA^T + p W_fB^T); [sum q^T k, sum q^T q, sum k^T
// k] and the per-channel sums of w and p, with q = center[b / nbr]. Stage
// 2: o = w awt + p apt; po = o W_proj^T; fo = relu(po W_fA^T + q W_fB^T)
// and the per-channel sum of fo.
//
// What bounds them: per neighbour pixel, stage 1 does 128x64 + 3x64x64
// MACs (~41 KFLOP) against 256 B of w and p in bf16 (plus the centre,
// read once per group of nbr neighbours) and stage 2 128x64 +
// 64x64 + 128x64 MACs (~41 KFLOP) against 384 B (w, p in, fo out), ~160
// and ~107 FLOP/B, under the card's ~295 FLOP/B bf16 balance point: both
// are memory-bound, at ~0.26 and ~0.39 ms for 24 images of 272 x 480. The
// eager version broadcasts the centre to every neighbour, concatenates,
// gates and sums v in full resolution and runs the grams in float32
// (~6 GB of traffic per step). Here each pass reads w, p once and the
// centre once per group of nbr neighbours; k, o and po never leave the
// SM, and the centre is read as center[b / nbr], never broadcast.
//
// Both stages in float32 (the twins for the float32 checks) keep the
// first design: a block takes one centre and every `parts`-th tile of 128
// consecutive pixels of it, and walks the nbr neighbours of that centre in
// turn (the centre tile comes from device memory for the first and from
// L2 for the others). The 1x1 convolutions are implicit GEMMs on
// conv3x3_tile.cuh's tile routine (fp32 on the CUDA cores), one 16-pixel
// m-tile per warp; the grams are gram_tile.cuh's. Each sum a block holds
// is written as one partial per (neighbour, block), and a second launch
// adds the partials in a fixed order. Rounding follows the TPU kernels: k,
// o and po to the working type, the sums in fp32, fo's sum from the fp32
// fo before fo is rounded.
//
// Stage 1 in bfloat16 (the main path) is a persistent walk on wgmma
// (`msa1_walk_kernel`). The first design (that tile routine on mma.sync)
// read W_f's fragments from device memory in every warp, ~1 KB a pixel
// against the 256 B of w and p it must read, loaded its tiles by
// synchronous copies behind three block barriers a tile (the centre's
// again for every neighbour) and ran the grams on mma.sync, q^T q once per
// neighbour: 4.7x its bound. Now:
// - The grid is groups of nbr CTAs, as many groups as the SMs hold side by
//   side. A group walks an even share of the units (centre, 128 pixels),
//   numbered centre-major, a unit a step, and its rank f takes neighbour
//   image f of the unit's centre: a CTA's grams are of one image at a time,
//   96 fp32 registers a thread, and stay in registers across its share of
//   a centre. The ranks read the same centre tile within a few steps of
//   each other: one read from device memory, the rest from L2. No CTA
//   waits on another, so the walk runs with nbr above the SM count too.
// - Loads by the TMA unit as stage 2's (w, p and the centre's q a stage),
//   a ring of four stages three steps ahead; W_f's two halves resident,
//   read from the (64, 128) weight as it is (its TMA loads swizzle it).
// - Each warpgroup takes 64 of the unit's pixels: k = [w p] W_f^T on
//   wgmma (SS, K = 128) while the CUDA cores sum w's and p's channels from
//   the same tiles; k, relu'd and rounded, goes in place of w; then the
//   grams with the pixels as K, both operands MN-major: q^T [k | q] (one
//   m64n128, q two tiles after k) and k^T k (m64n64). Both warpgroups run
//   one code path; a centre's first unit in the CTA starts the grams
//   (scale_d 0). The unit's stage is refilled after a block barrier.
// - When the walk leaves a centre, warpgroup 1's grams come through the
//   spent stage and the sums' partials through a small exchange; warpgroup
//   0 adds them in order and writes the group's partial of image f. A
//   second launch adds, in group order, the partials of the groups that
//   walked the image's centre. Deterministic.
// - Units are stepped as (centre, tile) counters: 64-bit divisions in the
//   step cost ~600 cycles of a ~3200-cycle step.
//
// Stage 2 in bfloat16 is a persistent walk on wgmma
// (`msa2_walk_kernel`). The first design (that tile routine, one 16-pixel
// m-tile per warp) fetched all three products' weight fragments from
// device memory in every warp, ~2.5 KB a pixel against the 384 B it must
// move, its tiles came in by synchronous loads behind four block barriers
// a tile with nothing in flight during the products, and fo left as
// 4-byte stores from the fragments: 4.5x its bound. Now:
// - One CTA an SM walks an even share of the units (centre, 128 pixels),
//   numbered centre-major; a unit is nbr steps, one per neighbour image b
//   of the centre, and each warpgroup takes 64 of the unit's pixels in
//   every step (one code path for both).
// - Loads by the TMA unit on 2-D maps of the images as (pixels, 64) rows
//   of 128 bytes, 128-byte swizzled, which is wgmma's K-major tile, zero
//   past the image (fo is zero there: no bias). A ring of three stages,
//   each the step's w and p tiles and its image's 128 -> 64 matrix [awt_b;
//   apt_b] (16 KB, swizzled by the TMA unit too; the matrices stay in L2),
//   kept two steps ahead on one mbarrier per stage; the centre's q tile
//   comes with a unit's first step into one of two buffers and stays for
//   its nbr steps. The matrices ride with the steps instead of staying
//   resident: the 6 of a centre (96 KB) beside W_proj and W_fuse (24 KB)
//   left no room for a ring of three.
// - The products chain through registers: o = [w p] [awt_b; apt_b] (SS,
//   K = 128 as two 64-channel tiles), rounded to bf16 as register A; po =
//   o W_proj^T (RS), rounded; fo = po W_fA^T (RS) + q W_fB^T (SS, q by
//   descriptor); relu. The rounding points are the TPU kernel's.
// - fo's channel sums from the fp32 values: quad shuffles over a warp's
//   rows, a [warp][64] exchange, then 64 threads add the 8 warps in order
//   into the CTA's running sum of each image of its centre, written out
//   when the walk leaves the centre; a second launch adds the CTAs that
//   walked a centre in order. Deterministic.
// - fo, rounded, goes in place of the stage's w tile (the products are done
//   with it) and leaves by a TMA store; a stage is refilled once its store
//   has read it.

#include "gram_tile.cuh"
#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 stage-2 walk, per step:
// the wait for the step's stage at its mbarrier, o = [w p] A_b, po = o
// W_proj, fo = po W_fA + q W_fB, the epilogue (sums, rounded fo to shared
// memory), the barrier with the store's and the next loads' issue and the
// running sums.
#include "phase_clocks.cuh"

namespace {

using namespace cdfo;

constexpr int NP = 128;   // pixels of a tile (8 m-tiles, one per warp)
static_assert(NP == 16 * WARPS, "one m-tile per warp");

// Copies pixels p0 .. p0+NP-1 of the image at src ((npix, 64) NHWC) to dst
// (pitch Pitch<T>), zero past the image.
template <typename T>
__device__ void load_tile(T* dst, const T* __restrict__ src, int p0, int npix) {
  constexpr int V = 16 / sizeof(T), VP = C / V, P = Pitch<T>::value;
  for (int i = threadIdx.x; i < NP * VP; i += blockDim.x) {
    const int pix = i / VP, vi = i % VP;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + pix < npix) {
      val = __ldg(reinterpret_cast<const uint4*>(src + static_cast<long long>(p0 + pix) * C) + vi);
    }
    *reinterpret_cast<uint4*>(dst + pix * P + vi * V) = val;
  }
}

// acc (16 pixels of m-tile `warp` x 64 channels) += a W_A^T + b W_B^T, with
// W = [W_A | W_B] a (64 out, 128 in) conv in kernel_weights' layout (tap
// `tap`).
template <typename T>
__device__ __forceinline__ void fuse_1x1(float (&acc)[1][8][4], const T* a, const T* b,
                                         const T* w, int tap, int warp, int lane) {
  const ATile<T> ta[1] = {a_tile<1>(a, NP, NP, NP, warp, lane)};
  const ATile<T> tb[1] = {a_tile<1>(b, NP, NP, NP, warp, lane)};
  const Weights<T> wt{w + static_cast<long long>(tap) * 2 * GRAM, C, 2 * C};
  conv_tiles<1, 1, 1, 8>(acc, ta, wt, 0, 0, lane);
  conv_tiles<1, 1, 1, 8>(acc, tb, wt, 0, C, lane);
}

template <typename T>
constexpr int s1_smem() {
  return 4 * NP * Pitch<T>::value * static_cast<int>(sizeof(T)) + THREADS * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
msa1_kernel(const T* __restrict__ w, const T* __restrict__ pr, const T* __restrict__ center,
            const T* __restrict__ wf, float* __restrict__ ws, int npix, int nbr, int parts) {
  constexpr int P = Pitch<T>::value, N = 3 * GRAM + 2 * C;
  extern __shared__ uint4 cdfo_smem[];
  T* qs = reinterpret_cast<T*>(cdfo_smem);
  T* wsm = qs + NP * P;
  T* psm = wsm + NP * P;
  T* ks = psm + NP * P;
  float* red = reinterpret_cast<float*>(ks + NP * P);
  const int grp = blockIdx.y, part = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (npix + NP - 1) / NP;
  const T* q_img = center + static_cast<long long>(grp) * npix * C;
  // the per-channel sum thread i keeps: channel i % 64 of w (i % 128 < 64)
  // or p, over tile pixels [64 (i / 128), 64 (i / 128) + 64)
  const int sum_ch = threadIdx.x & (C - 1), sum_half = threadIdx.x >> 7;
  const T* sum_src = (threadIdx.x & C) ? psm : wsm;

  for (int f = 0; f < nbr; ++f) {
    const long long b = static_cast<long long>(grp) * nbr + f;
    float acc[3][4][4];
    zero_grams(acc);
    float csum = 0.f;
    for (int tile = part; tile < tiles; tile += parts) {
      const int p0 = tile * NP;
      __syncthreads();  // the previous tile's grams are done with qs, ks
      load_tile(qs, q_img, p0, npix);
      load_tile(wsm, w + b * npix * C, p0, npix);
      load_tile(psm, pr + b * npix * C, p0, npix);
      __syncthreads();
      for (int i = 0; i < NP / 2; ++i) csum += to_f(sum_src[(sum_half * NP / 2 + i) * P + sum_ch]);
      // k = relu(w W_fA^T + p W_fB^T), zero past the image, rounded to T
      float kacc[1][8][4];
      zero(kacc);
      fuse_1x1(kacc, wsm, psm, wf, 0, warp, lane);
      for_each_pair(kacc[0], warp, 0, NP, lane, [&](int p, int n, float v0, float v1) {
        const bool in = p0 + p < npix;
        store2(ks + p * P + n, in ? fmaxf(v0, 0.f) : 0.f, in ? fmaxf(v1, 0.f) : 0.f);
      });
      __syncthreads();
      gram3(acc, qs, ks, NP, warp, lane);
    }
    float* dst = ws + (b * parts + part) * N;
    store_grams(acc, dst, warp, lane);
    // the two halves of each channel's sum, added in a fixed order
    __syncthreads();  // the previous neighbour's sums are read
    red[threadIdx.x] = csum;
    __syncthreads();
    if (threadIdx.x < 2 * C) dst[3 * GRAM + threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + 2 * C];
  }
}

template <typename T>
constexpr int s2_smem() {
  return 4 * NP * Pitch<T>::value * static_cast<int>(sizeof(T)) + WARPS * 8 * C * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
msa2_kernel(const T* __restrict__ w, const T* __restrict__ pr, const T* __restrict__ center,
            const T* __restrict__ wa, const T* __restrict__ wproj, const T* __restrict__ wf,
            T* __restrict__ fo, float* __restrict__ ws, int npix, int nbr, int parts) {
  constexpr int P = Pitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* qs = reinterpret_cast<T*>(cdfo_smem);
  T* wsm = qs + NP * P;   // w, then po
  T* psm = wsm + NP * P;
  T* os = psm + NP * P;
  float* red = reinterpret_cast<float*>(os + NP * P);  // [warp][g][64]
  const int grp = blockIdx.y, part = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int tiles = (npix + NP - 1) / NP;
  const T* q_img = center + static_cast<long long>(grp) * npix * C;

  for (int f = 0; f < nbr; ++f) {
    const long long b = static_cast<long long>(grp) * nbr + f;
    // this lane's sums of fo's channels 8nt + 2t, +1 over its pixels
    float gsum[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) gsum[nt][0] = gsum[nt][1] = 0.f;
    for (int tile = part; tile < tiles; tile += parts) {
      const int p0 = tile * NP;
      __syncthreads();  // the previous tile is done with every buffer
      load_tile(qs, q_img, p0, npix);
      load_tile(wsm, w + b * npix * C, p0, npix);
      load_tile(psm, pr + b * npix * C, p0, npix);
      __syncthreads();
      // each warp runs its own 16 pixels through the chain (its GEMMs read
      // and write only its m-tile's rows of the buffers)
      float acc[1][8][4];
      zero(acc);
      // o = w awt + p apt, rounded to T
      fuse_1x1(acc, wsm, psm, wa, static_cast<int>(b), warp, lane);
      for_each_pair(acc[0], warp, 0, NP, lane,
                    [&](int p, int n, float v0, float v1) { store2(os + p * P + n, v0, v1); });
      __syncthreads();
      // po = o W_proj^T, rounded to T, over w (no longer read)
      zero(acc);
      {
        const ATile<T> a[1] = {a_tile<1>(os, NP, NP, NP, warp, lane)};
        conv_tiles<1, 1, 1, 8>(acc, a, Weights<T>{wproj, C, C}, 0, 0, lane);
      }
      __syncthreads();
      for_each_pair(acc[0], warp, 0, NP, lane,
                    [&](int p, int n, float v0, float v1) { store2(wsm + p * P + n, v0, v1); });
      __syncthreads();
      // fo = relu(po W_fA^T + q W_fB^T): its sum from the fp32 values,
      // then rounded to T (the C-fragment walk of for_each_pair, with the
      // n-tile index known to the compiler so gsum stays in registers)
      zero(acc);
      fuse_1x1(acc, wsm, qs, wf, 0, warp, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int p = warp * 16 + g + 8 * hi;
          if (p0 + p < npix) {
            const float f0 = fmaxf(acc[0][nt][2 * hi], 0.f);
            const float f1 = fmaxf(acc[0][nt][2 * hi + 1], 0.f);
            gsum[nt][0] += f0;
            gsum[nt][1] += f1;
            store2(fo + (b * npix + p0 + p) * C + 8 * nt + t2, f0, f1);
          }
        }
      }
    }
    // fo's channel sums: [warp][g] partials of every lane, then per channel
    // in a fixed order
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      red[(warp * 8 + g) * C + 8 * nt + t2] = gsum[nt][0];
      red[(warp * 8 + g) * C + 8 * nt + t2 + 1] = gsum[nt][1];
    }
    __syncthreads();
    if (threadIdx.x < C) {
      float s = 0.f;
      for (int i = 0; i < WARPS * 8; ++i) s += red[i * C + threadIdx.x];
      ws[(b * parts + part) * C + threadIdx.x] = s;
    }
  }
}


// ---- stage 2, bfloat16: the walk on wgmma ----------------------------------

constexpr int UNIT = 128;                   // pixels of a unit: 64 per warpgroup
constexpr int TILE_BYTES = UNIT * C * 2;    // a unit's pixels of one image
constexpr int MAT_BYTES = C * C * 2;        // a 64 x 64 K-major tile
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2 * MAT_BYTES;   // w | p | awt_b^T | apt_b^T
// W_proj | W_fA | W_fB | q [2] | stages | the [2][warp][64] exchange of fo's
// sums | mbarriers (weights, stages) | the running sums [nbr][64]
constexpr int WALK_FIXED = 1024 + 3 * MAT_BYTES + 2 * TILE_BYTES + STAGES * STAGE_BYTES +
                           2 * WARPS * C * 4 + 8 * (1 + STAGES);
static_assert(TILE_BYTES % 1024 == 0 && MAT_BYTES % 1024 == 0, "1024-byte aligned tiles");

__host__ __device__ constexpr int walk_smem(int nbr) { return WALK_FIXED + nbr * C * 4; }

// the CTA that walks unit u when `total` units are split evenly over
// `parts` CTAs (CTA i takes [i total / parts, (i + 1) total / parts))
__host__ __device__ __forceinline__ int walk_part(long long u, long long total, int parts) {
  return static_cast<int>(((u + 1) * parts + total - 1) / total - 1);
}

// Units (centre, 128 pixels) numbered centre * tiles + tile; CTA i walks
// [i total / G, (i + 1) total / G) of them, nbr steps a unit. ws
// [batch][G][64]: the CTA's sum of fo over its pixels of each image (only
// the images of the centres it walks are written).
__global__ void __launch_bounds__(THREADS, 1)
msa2_walk_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tp,
                 const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tfo,
                 const __grid_constant__ CUtensorMap tm, const bf16* __restrict__ wproj,
                 const bf16* __restrict__ wf, float* __restrict__ ws, int npix, int centres,
                 int nbr) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* wp = reinterpret_cast<bf16*>(base);   // W_proj [64 n][64 k], swizzled
  bf16* wfa = wp + C * C;                      // W_fA, then W_fB
  bf16* qs = wfa + 2 * C * C;                  // q of two units [2][128 px][64]
  unsigned char* stages = reinterpret_cast<unsigned char*>(qs + 2 * UNIT * C);
  float* red = reinterpret_cast<float*>(stages + STAGES * STAGE_BYTES);   // [2][8][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * WARPS * C);      // weights, stages
  float* gsum = reinterpret_cast<float*>(bars + 1 + STAGES);              // [nbr][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const long long tiles = (npix + UNIT - 1) / UNIT, total = centres * tiles;
  const long long g0 = blockIdx.x * total / gridDim.x, g1 = (blockIdx.x + 1) * total / gridDim.x;
  const long long steps = (g1 - g0) * nbr;
  if (steps <= 0) return;
  auto stage = [&](long long t) { return stages + (t % STAGES) * STAGE_BYTES; };

  // step t's w, p and matrices (and, at a unit's first step, its q) into
  // stage t % 3 on its mbarrier
  auto fetch = [&](long long t) {
    const long long u = g0 + t / nbr;
    const int f = static_cast<int>(t % nbr), c = static_cast<int>(u / tiles);
    const int p0 = static_cast<int>(u % tiles) * UNIT, b = c * nbr + f;
    unsigned char* st = stage(t);
    uint64_t* bar = bars + 1 + t % STAGES;
    mbar_expect_tx(bar, STAGE_BYTES + (f == 0 ? TILE_BYTES : 0));
    tma_load_row(st, &tw, p0, 0, b, bar);
    tma_load_row(st + TILE_BYTES, &tp, p0, 0, b, bar);
    tma_load_row(st + 2 * TILE_BYTES, &tm, 0, 0, 2 * b, bar);
    tma_load_row(st + 2 * TILE_BYTES + MAT_BYTES, &tm, 0, 0, 2 * b + 1, bar);
    if (f == 0) tma_load_row(qs + ((u - g0) & 1) * UNIT * C, &tq, p0, 0, c, bar);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, 3 * MAT_BYTES);
    bulk_copy(wp, wproj, MAT_BYTES, bars);
    bulk_copy(wfa, wf, 2 * MAT_BYTES, bars);
    for (long long t = 0; t < STAGES - 1 && t < steps; ++t) fetch(t);
  }
  __syncthreads();
  mbar_wait(bars, 0);

  const uint64_t pd = wgmma_desc(wp), fad = wgmma_desc(wfa), fbd = wgmma_desc(wfa + C * C);
  PHASE_START
#pragma unroll 1
  for (long long t = 0; t < steps; ++t) {
    const long long u = g0 + t / nbr;
    const int f = static_cast<int>(t % nbr), c = static_cast<int>(u / tiles);
    unsigned char* st = stage(t);
    mbar_wait(bars + 1 + t % STAGES, static_cast<uint32_t>((t / STAGES) & 1));
    PHASE(0)
    bf16* wt = reinterpret_cast<bf16*>(st) + wg * 64 * C;   // this warpgroup's 64 pixels
    const bf16* pt = reinterpret_cast<const bf16*>(st + TILE_BYTES) + wg * 64 * C;
    const bf16* am = reinterpret_cast<const bf16*>(st + 2 * TILE_BYTES);
    const bf16* qt = qs + ((u - g0) & 1) * UNIT * C + wg * 64 * C;
    float acc[8][4];
    {
      // o = w awt_b + p apt_b
      const uint64_t wd = wgmma_desc(wt), ppd = wgmma_desc(pt);
      const uint64_t awd = wgmma_desc(am), apd = wgmma_desc(am + C * C);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(acc, wd + 2 * kk, awd + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(acc, ppd + 2 * kk, apd + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
    }
    PHASE(1)
    uint32_t oa[4][4];
    round_to_a(acc, oa);
    // po = o W_proj^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64(acc, oa[kk], pd + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(acc);
    keep(oa);
    PHASE(2)
    uint32_t pa[4][4];
    round_to_a(acc, pa);
    // fo = po W_fA^T + q W_fB^T
    {
      const uint64_t qd = wgmma_desc(qt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64(acc, pa[kk], fad + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(acc, qd + 2 * kk, fbd + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(pa);
    }
    PHASE(3)
    // relu; this lane's sums of channels 8j + t2, + 1 over its two pixels,
    // then over the warp's 16 (lanes of one t); fo rounded in place of w
    float cs[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaxf(acc[j][e], 0.f);
      cs[j][0] = acc[j][0] + acc[j][2];
      cs[j][1] = acc[j][1] + acc[j][3];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store2(swizzled(wt, 16 * wl + g + 8 * half, 8 * j + t2), acc[j][2 * half],
               acc[j][2 * half + 1]);
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], o);
    float* rd = red + (t & 1) * WARPS * C + warp * C;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rd[8 * j + t2] = cs[j][0];
        rd[8 * j + t2 + 1] = cs[j][1];
      }
    }
    async_fence();
    PHASE(4)
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store_row(&tfo, st, static_cast<int>(u % tiles) * UNIT, 0, c * nbr + f);
      bulk_commit();
      // step t - 1's store has read its stage: refill it with step t + 2
      bulk_wait_read<1>();
      if (t + STAGES - 1 < steps) fetch(t + STAGES - 1);
    }
    if (threadIdx.x < C) {
      // the step's sum, warps in order, into the running sum of image f
      // (the first unit of a centre in this CTA starts it)
      const float* rs = red + (t & 1) * WARPS * C + threadIdx.x;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += rs[w * C];
      float& run = gsum[f * C + threadIdx.x];
      run = (u == g0 || u % tiles == 0) ? s : run + s;
      // the CTA leaves the centre after this unit: its sums go out
      if (f == nbr - 1 && (u + 1 == g1 || (u + 1) % tiles == 0)) {
        for (int i = 0; i < nbr; ++i) {
          ws[(static_cast<long long>(c * nbr + i) * gridDim.x + blockIdx.x) * C + threadIdx.x] =
              gsum[i * C + threadIdx.x];
        }
      }
    }
    PHASE(5)
    PHASE_STEP
  }
  if (threadIdx.x == 0) bulk_wait_read();
  PHASE_END
}

// ---- stage 1, bfloat16: the walk on wgmma ----------------------------------

constexpr int S1_STAGES = 4;
constexpr int S1_STAGE_BYTES = 3 * TILE_BYTES;   // w | p | q of a unit
constexpr int S1_GAPX = 2 * 2 * 8 * C;           // the [wg][w, p][8][64] exchange of the sums
// W_fA | W_fB | stages | the sums' exchange | mbarriers (weights, stages)
constexpr int S1_WALK_SMEM =
    1024 + 2 * MAT_BYTES + S1_STAGES * S1_STAGE_BYTES + S1_GAPX * 4 + 8 * (1 + S1_STAGES);
static_assert(S1_STAGE_BYTES == 96 * 128 * 4, "a stage holds warpgroup 1's grams at a flush");
static_assert(S1_WALK_SMEM <= 232448, "one block's shared memory");

struct Unit {
  int c, tile;   // centre, 128-pixel tile
};

// Units (centre, 128 pixels) numbered centre * tiles + tile. The grid is
// `groups` groups of nbr CTAs; group i walks units [i total / groups,
// (i + 1) total / groups), and its rank f takes neighbour image f of each
// unit's centre, so each CTA's grams are of one image at a time and stay
// in registers. ws [batch][groups][3 * 64 * 64 + 128]: the group's sums
// over its pixels of each image ([q^T k, q^T q, k^T k], then the channel
// sums of w and of p; only the images of the centres it walks are
// written).
__global__ void __launch_bounds__(THREADS, 1)
msa1_walk_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tp,
                 const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap twf,
                 float* __restrict__ ws, int npix, int centres, int nbr) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* wfs = reinterpret_cast<bf16*>(base);   // W_fA, W_fB [64 n][64 k], swizzled
  unsigned char* stages = base + 2 * MAT_BYTES;
  float* gx = reinterpret_cast<float*>(stages + S1_STAGES * S1_STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(gx + S1_GAPX);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int r = threadIdx.x & 127;
  const int groups = static_cast<int>(gridDim.x) / nbr;
  const int grp = static_cast<int>(blockIdx.x) / nbr, f = static_cast<int>(blockIdx.x) % nbr;
  const int tiles = (npix + UNIT - 1) / UNIT;
  const long long total = static_cast<long long>(centres) * tiles;
  const long long g0 = grp * total / groups, g1 = (grp + 1) * total / groups;
  const int steps = static_cast<int>(g1 - g0);
  if (steps <= 0) return;
  auto stage = [&](int t) { return stages + (t % S1_STAGES) * S1_STAGE_BYTES; };
  // the units as (centre, tile), stepped along without divisions
  const Unit u0{static_cast<int>(g0 / tiles), static_cast<int>(g0 % tiles)};
  auto next = [&](Unit& x) {
    if (++x.tile == tiles) {
      x.tile = 0;
      ++x.c;
    }
  };

  // step t's unit x: w and p of image f of its centre, and the centre's q,
  // into stage t % 4 on its mbarrier
  auto fetch = [&](int t, const Unit& x) {
    const int p0 = x.tile * UNIT;
    unsigned char* st = stage(t);
    uint64_t* bar = bars + 1 + t % S1_STAGES;
    mbar_expect_tx(bar, S1_STAGE_BYTES);
    tma_load_row(st, &tw, p0, 0, x.c * nbr + f, bar);
    tma_load_row(st + TILE_BYTES, &tp, p0, 0, x.c * nbr + f, bar);
    tma_load_row(st + 2 * TILE_BYTES, &tq, p0, 0, x.c, bar);
  };
  Unit ahead = u0;   // thread 0: the next unit to fetch, that of step t + 4
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + S1_STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, 2 * MAT_BYTES);
    tma_load_row(wfs, &twf, 0, 0, 0, bars);
    tma_load_row(wfs + C * C, &twf, 1, 0, 0, bars);
    for (int t = 0; t < S1_STAGES && t < steps; ++t) {
      fetch(t, ahead);
      next(ahead);
    }
  }
  __syncthreads();
  mbar_wait(bars, 0);

  // the channel sums thread r of a warpgroup keeps: channels 8 sc .. 8 sc
  // + 7 of w (st_ = 0) or p over the warpgroup's pixels 8 sp .. 8 sp + 7
  // of each unit
  const int st_ = r >> 6, sc = r & 7, sp = (r >> 3) & 7;
  float csum[8];
  // this warpgroup's grams over its 64 pixels of each unit: q^T [k | q]
  // and k^T k
  float gqk[16][4], gkk[8][4];
  const uint64_t fad = wgmma_desc(wfs), fbd = wgmma_desc(wfs + C * C);
  PHASE_START
  Unit cur = u0;
#pragma unroll 1
  for (int t = 0; t < steps; ++t, next(cur)) {
    const bool first = t == 0 || cur.tile == 0;   // the CTA's first unit of the centre
    const bool last = t + 1 == steps || cur.tile + 1 == tiles;
    unsigned char* st = stage(t);
    mbar_wait(bars + 1 + t % S1_STAGES, static_cast<uint32_t>((t / S1_STAGES) & 1));
    PHASE(0)
    bf16* wt = reinterpret_cast<bf16*>(st) + wg * 64 * C;   // this warpgroup's 64 pixels
    const bf16* pt = reinterpret_cast<const bf16*>(st + TILE_BYTES) + wg * 64 * C;
    const bf16* qt = reinterpret_cast<const bf16*>(st + 2 * TILE_BYTES) + wg * 64 * C;
    float acc[8][4];
    {
      // k = [w p] [W_fA; W_fB]^T, while the CUDA cores take the sums of w
      // and p from the same tiles
      const uint64_t wd = wgmma_desc(wt), pd = wgmma_desc(pt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(acc, wd + 2 * kk, fad + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(acc, pd + 2 * kk, fbd + 2 * kk, 1);
      wgmma_commit();
      const bf16* src = st_ ? pt : wt;
#pragma unroll
      for (int e = 0; e < 8; ++e) csum[e] = first ? 0.f : csum[e];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v[8];
        load8(swizzled(const_cast<bf16*>(src), 8 * sp + i, 8 * sc), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) csum[e] += v[e];
      }
      wgmma_wait<0>();
      keep(acc);
    }
    warpgroup_sync(wg);   // the warpgroup is done reading w: k goes in its place
    PHASE(1)
    // k = relu, rounded (zero past the image, where w and p are)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store2(swizzled(wt, 16 * wl + g + 8 * half, 8 * j + t2), fmaxf(acc[j][2 * half], 0.f),
               fmaxf(acc[j][2 * half + 1], 0.f));
      }
    async_fence();
    warpgroup_sync(wg);
    PHASE(2)
    {
      // the grams with the pixels as K: q^T [k | q] (k in w's place, q
      // 2 tiles after it) and k^T k; a centre's first unit in the CTA
      // starts them
      const uint64_t qa = wgmma_desc(qt, 1024), kb = wgmma_desc(wt, 2 * TILE_BYTES);
      const uint64_t ka = wgmma_desc(wt, 1024);
      keep(gqk);
      keep(gkk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_64x128_tt(gqk, qa + 128 * kk, kb + 128 * kk, !first || kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_64x64_tt(gkk, ka + 128 * kk, ka + 128 * kk, !first || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(gqk);
      keep(gkk);
    }
    PHASE(3)
    __syncthreads();   // both warpgroups are done with the stage
    if (last) {
      // the CTA leaves the centre: warpgroup 1's grams through the spent
      // stage, the sums' partials through gx, then image f's partial out,
      // warpgroup 0's grams plus warpgroup 1's
      float* xb = reinterpret_cast<float*>(st);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) xb[(4 * i + e) * 128 + r] = gqk[i][e];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) xb[(64 + 4 * i + e) * 128 + r] = gkk[i][e];
      }
      float* gp = gx + ((wg * 2 + st_) * 8 + sp) * C + 8 * sc;
#pragma unroll
      for (int e = 0; e < 8; ++e) gp[e] = csum[e];
      __syncthreads();
      const long long b = static_cast<long long>(cur.c) * nbr + f;
      float* dst = ws + (b * groups + grp) * (3 * GRAM + 2 * C);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half, row = 16 * wl + g + 8 * half;
            store2(dst + (i >> 3) * GRAM + row * C + 8 * (i & 7) + t2,
                   gqk[i][e] + xb[(4 * i + e) * 128 + r],
                   gqk[i][e + 1] + xb[(4 * i + e + 1) * 128 + r]);
          }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half, row = 16 * wl + g + 8 * half;
            store2(dst + 2 * GRAM + row * C + 8 * i + t2,
                   gkk[i][e] + xb[(64 + 4 * i + e) * 128 + r],
                   gkk[i][e + 1] + xb[(64 + 4 * i + e + 1) * 128 + r]);
          }
        // the sums of w (r < 64) and p: warpgroups, then pixel groups, in order
        float s = 0.f;
#pragma unroll
        for (int w2 = 0; w2 < 2; ++w2)
#pragma unroll
          for (int i = 0; i < 8; ++i) s += gx[((w2 * 2 + (r >> 6)) * 8 + i) * C + (r & 63)];
        dst[3 * GRAM + r] = s;
      }
      async_fence();   // the stage's writes before its refill by the TMA unit
      __syncthreads();
    }
    if (threadIdx.x == 0 && t + S1_STAGES < steps) {
      fetch(t + S1_STAGES, ahead);
      next(ahead);
    }
    PHASE(4)
    PHASE_STEP
  }
  PHASE_END
}

// out[b][e] = the sum, in CTA order, of the partials [b][parts][n] of the
// CTAs that walked image b's centre (units of 128 pixels handed out as
// `walk_part` does): e < n_a into out_a [batch][n_a], the rest into out_b
// [batch][n - n_a]. Grid (ceil(n / THREADS), batch).
__global__ void __launch_bounds__(THREADS)
walk_reduce(const float* __restrict__ ws, float* __restrict__ out_a, float* __restrict__ out_b,
            int n, int n_a, int npix, int nbr, int centres, int parts) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const int b = blockIdx.y;
  const long long tiles = (npix + UNIT - 1) / UNIT, total = centres * tiles;
  const long long c = b / nbr;
  const int lo = walk_part(c * tiles, total, parts), hi = walk_part((c + 1) * tiles - 1, total, parts);
  float s = 0.f;
  for (int p = lo; p <= hi; ++p) s += ws[(static_cast<long long>(b) * parts + p) * n + e];
  if (e < n_a) {
    out_a[static_cast<long long>(b) * n_a + e] = s;
  } else {
    out_b[static_cast<long long>(b) * (n - n_a) + e - n_a] = s;
  }
}

// bfloat16 stage 1: the walk of `parts` groups of nbr CTAs, then the
// reduction of each image's group partials
cudaError_t launch1_walk(const void* w, const void* pr, const void* center, const void* wf,
                         void* ws, void* stats, void* gaps, int batch, int npix, int nbr,
                         int parts, cudaStream_t stream) {
  cudaError_t err = allow_smem(msa1_walk_kernel, S1_WALK_SMEM);
  if (err != cudaSuccess) return err;
  const int centres = batch / nbr;
  CUtensorMap tw, tp, tq, twf;
  // W_f (64 n, 128 k) as a (64 rows, 2 pixels) image: box (1 pixel, 64
  // rows) at pixel h is the swizzled tile of W_f's half h
  if ((err = nhwc_tensor_map(&tw, w, batch, 1, npix, UNIT)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tp, pr, batch, 1, npix, UNIT)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tq, center, centres, 1, npix, UNIT)) != cudaSuccess ||
      (err = nhwc_tensor_map(&twf, wf, 1, C, 2, 1, C)) != cudaSuccess) {
    return err;
  }
  CDFO_LAUNCH(msa1_walk_kernel, dim3(parts * nbr), S1_WALK_SMEM, stream, tw, tp, tq, twf,
              static_cast<float*>(ws), npix, centres, nbr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  CDFO_LAUNCH(walk_reduce, dim3((3 * GRAM + 2 * C + THREADS - 1) / THREADS, batch), 0, stream,
              static_cast<const float*>(ws), static_cast<float*>(stats), static_cast<float*>(gaps),
              3 * GRAM + 2 * C, 3 * GRAM, npix, nbr, centres, parts);
  return cudaGetLastError();
}

// float32 stage 1: the first design
cudaError_t launch1(const void* w, const void* pr, const void* center, const void* wf, void* ws,
                    void* stats, void* gaps, int batch, int npix, int nbr, int parts,
                    cudaStream_t stream) {
  using T = float;
  const cudaError_t err = allow_smem(msa1_kernel<T>, s1_smem<T>());
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(msa1_kernel<T>, dim3(parts, batch / nbr), s1_smem<T>(), stream,
              static_cast<const T*>(w), static_cast<const T*>(pr), static_cast<const T*>(center),
              static_cast<const T*>(wf), static_cast<float*>(ws), npix, nbr, parts);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return e1;
  return launch_reduce(static_cast<const float*>(ws), parts, 3 * GRAM + 2 * C, 3 * GRAM,
                       static_cast<float*>(stats), static_cast<float*>(gaps), batch, stream);
}

cudaError_t launch2(const void* w, const void* pr, const void* center, const void* wa,
                    const void* wproj, const void* wf, void* fo, void* ws, void* gap, int is_bf16,
                    int batch, int npix, int nbr, int parts, cudaStream_t stream) {
  if (is_bf16) {
    const int smem = walk_smem(nbr);
    cudaError_t err = allow_smem(msa2_walk_kernel, smem);
    if (err != cudaSuccess) return err;
    const int centres = batch / nbr;
    CUtensorMap tw, tp, tq, tfo, tm;
    if ((err = nhwc_tensor_map(&tm, wa, 2 * batch, 1, C, C)) != cudaSuccess ||
        (err = nhwc_tensor_map(&tw, w, batch, 1, npix, UNIT)) != cudaSuccess ||
        (err = nhwc_tensor_map(&tp, pr, batch, 1, npix, UNIT)) != cudaSuccess ||
        (err = nhwc_tensor_map(&tq, center, centres, 1, npix, UNIT)) != cudaSuccess ||
        (err = nhwc_tensor_map(&tfo, fo, batch, 1, npix, UNIT)) != cudaSuccess) {
      return err;
    }
    CDFO_LAUNCH(msa2_walk_kernel, dim3(parts), smem, stream, tw, tp, tq, tfo, tm,
                static_cast<const bf16*>(wproj),
                static_cast<const bf16*>(wf), static_cast<float*>(ws), npix, centres, nbr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    CDFO_LAUNCH(walk_reduce, dim3(1, batch), 0, stream, static_cast<const float*>(ws),
                static_cast<float*>(gap), nullptr, C, C, npix, nbr, centres, parts);
    return cudaGetLastError();
  }
  using T = float;
  const cudaError_t err = allow_smem(msa2_kernel<T>, s2_smem<T>());
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(msa2_kernel<T>, dim3(parts, batch / nbr), s2_smem<T>(), stream,
              static_cast<const T*>(w), static_cast<const T*>(pr), static_cast<const T*>(center),
              static_cast<const T*>(wa), static_cast<const T*>(wproj), static_cast<const T*>(wf),
              static_cast<T*>(fo), static_cast<float*>(ws), npix, nbr, parts);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return e1;
  return launch_reduce(static_cast<const float*>(ws), parts, C, C, static_cast<float*>(gap),
                       nullptr, batch, stream);
}

bool bad_shape(int batch, int h, int wd, int nbr) {
  return batch <= 0 || h <= 0 || wd <= 0 || nbr <= 0 || batch % nbr != 0 ||
         batch / nbr > 65535 || static_cast<long long>(h) * wd > (1LL << 31) / C;
}

// floats of one block's partial sums in stage 1 and stage 2
constexpr int S1_PART = 3 * GRAM + 2 * C, S2_PART = C;

int workspace(int batch, int h, int wd, int nbr, int per_part) {
  if (bad_shape(batch, h, wd, nbr)) return -1;
  return workspace_floats((h * wd + NP - 1) / NP, batch / nbr, batch, per_part);
}

// the bfloat16 walks: one partial per (image, walker), at most one walker
// a unit; a walker is `group` CTAs side by side (stage 2: 1, stage 1: nbr),
// as many as the SMs hold at once (at least one)
int walk_workspace(int batch, int h, int wd, int nbr, int per_part, int group) {
  const int sms = sm_count();
  if (bad_shape(batch, h, wd, nbr) || sms <= 0) return -1;
  const long long units = static_cast<long long>(batch / nbr) * ((h * wd + UNIT - 1) / UNIT);
  long long walkers = sms / group > 1 ? sms / group : 1;
  walkers = units < walkers ? units : walkers;
  const long long n = walkers * batch * per_part;
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

}  // namespace

// The float32 scratch cdfo_msa_stage1 and cdfo_msa_stage2 need for `batch`
// neighbour images of h x wd, nbr per centre, of the dtype (is_bf16: 1
// bfloat16, 0 float32), on the current device, in floats; -1 if there is
// none. bfloat16 sizes it for the walks: stage 1's [batch][groups][3 * 64
// * 64 + 128] (groups of nbr CTAs), stage 2's [batch][CTAs][64] (one CTA
// an SM).
extern "C" int cdfo_msa_stage1_workspace(int batch, int h, int wd, int nbr, int is_bf16) {
  return is_bf16 ? walk_workspace(batch, h, wd, nbr, S1_PART, nbr)
                 : workspace(batch, h, wd, nbr, S1_PART);
}

extern "C" int cdfo_msa_stage2_workspace(int batch, int h, int wd, int nbr, int is_bf16) {
  return is_bf16 ? walk_workspace(batch, h, wd, nbr, S2_PART, 1)
                 : workspace(batch, h, wd, nbr, S2_PART);
}

// w (warped), pr (pred): (batch, h, wd, 64) NHWC; center: (batch / nbr, h,
// wd, 64); wf: the fusion_out 1x1 (64 out, 128 in), float32 in
// ops/cuda_build.py::kernel_weights' layout, bfloat16 as it is (16-byte
// aligned; the walk's TMA loads swizzle it); all of one dtype (is_bf16: 1
// bfloat16, 0 float32). ws: ws_floats of float32 scratch, as
// cdfo_msa_stage1_workspace sizes it for the dtype ([batch][parts][3*64*64
// + 128]); stats: [batch][3][64][64] and gaps: [batch][2][64] float32 out.
// Two launches (partials, reduction). Returns a cudaError_t.
extern "C" int cdfo_msa_stage1(const void* w, const void* pr, const void* center, const void* wf,
                               void* ws, int ws_floats, void* stats, void* gaps, int is_bf16,
                               int batch, int h, int wd, int nbr, void* stream) {
  const int parts = parts_of(ws_floats, batch, S1_PART);
  if (bad_shape(batch, h, wd, nbr) || parts <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch1_walk(w, pr, center, wf, ws, stats, gaps, batch, h * wd, nbr, parts, s)
                 : launch1(w, pr, center, wf, ws, stats, gaps, batch, h * wd, nbr, parts, s);
}

// As stage 1, plus, in float32: wa the [batch] per-image (64 out, 128 in)
// matrices [awt; apt]^T in kernel_weights' layout, one image per tap, wproj
// the 1x1 projection and wf the fusion in that layout; in bfloat16 (all
// 16-byte aligned): wa (batch, 2, 64 n, 64 k) = [awt_b^T, apt_b^T] as it
// is (ops/fused_align.py::pack_stage2_images), wproj (64 n, 64 k) and wf
// (2, 64 n, 64 k) = [W_fA, W_fB], 128-byte swizzled
// (::pack_stage2_weights); fo: (batch, h, wd, 64) out; ws: ws_floats of
// float32 scratch, as cdfo_msa_stage2_workspace sizes it for the dtype;
// gap: [batch][64] float32 out. Two launches (the pass, then the partials'
// reduction). Returns a cudaError_t.
extern "C" int cdfo_msa_stage2(const void* w, const void* pr, const void* center, const void* wa,
                               const void* wproj, const void* wf, void* fo, void* ws,
                               int ws_floats, void* gap, int is_bf16, int batch, int h, int wd,
                               int nbr, void* stream) {
  const int parts = parts_of(ws_floats, batch, S2_PART);
  if (bad_shape(batch, h, wd, nbr) || parts <= 0) return cudaErrorInvalidValue;
  return launch2(w, pr, center, wa, wproj, wf, fo, ws, gap, is_bf16, batch, h * wd, nbr, parts,
                 static_cast<cudaStream_t>(stream));
}
