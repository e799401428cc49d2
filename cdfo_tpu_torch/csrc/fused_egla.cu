// The fused EGLA (expected residual mask) as two calls, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels cdfo_tpu/ops/fused_egla.py::eg1_rows (kernel body
// _eg1_kernel) and ::eg2_local_fuse (_eg2_kernel), which EGLA(fused=True)
// calls once each per compensate_frames call, around the column stage of
// csrc/fused_attention.cu.
//
// eg1, for each frame m and image row g: q_s = x aq[m] + cq[m] and v = x bv
// + cv, both rounded to the working type; the row attention v_r =
// softmax(q_s q_sᵀ) v over the row's W positions (no scale; scores and
// softmax in fp32, the normalised p rounded to the working type); and the H-band q_c[g] =
// sum_{d<9} h9[d] q_s[g + d - 4] + h9[9], rows outside the image zero.
// eg2, for each 8x8 window: q = (x wq + bq) mask_inv[m] and v = x wv + bv
// (rounded), the 64-token attention loc = softmax(q qᵀ) v (rounded), then
// out = long fa + loc fb + bf + x, rounded once.
//
// What bounds them, at (4, 272, 480, 64) bf16: eg1 does ~139 KFLOP per pixel
// (two 64x64 projections and 4 W C of attention), ~73 GFLOP a call, against
// ~200 MB of x in and q_c, v_r out: operations (0.073 ms at 989 TFLOP/s, the
// bytes 0.060 ms). eg2 does ~49 KFLOP per pixel (two projections, the window
// attention, the 128 -> 64 fusion), ~25 GFLOP, against ~200 MB of x, long in
// and out: bytes.
//
// Design of the first kernels, which the float32 twins keep. eg1 is two
// launches under one call: a projection pass writes q_s and v in the
// working type to scratch that the wrapper allocates, and a row pass reads
// them. Its CTA holds 128 queries of one row (16 per warp) and walks the
// row's keys in 64-key tiles with an online softmax: a 480 x 480 fp32
// score row does not fit in shared memory (the TPU kept it in VMEM). The
// same CTA computes the H-band of its 128 positions from the 9 rows of q_s
// in device memory. The scratch rounds q_s and v exactly where the TPU
// kernel's VMEM scratch does and keeps each pass a plain tile loop.
// eg2 is one launch: a CTA holds two windows (an 8 x 16 pixel tile, one
// 16-pixel m-tile per warp) and projects q and v on conv3x3_tile.cuh's tile
// routine; each warp then takes 16 queries of one window against its 64 keys
// (one tile, so the softmax is exact), and the fusion GEMMs run on the tile
// routine again. x, long, q, v and loc never leave shared memory. The
// attention's fragments (`scores`, `attend`): bf16 on mma.sync.m16n8k16
// with fp32 accumulators (now only eg1's row pass past 640 positions), Q
// Kᵀ reading both factors by ldmatrix, P V taking P from the score
// fragments in registers and V by ldmatrix.trans; fp32 on the CUDA cores,
// P passed across the quad by shuffles.
//
// eg1 in bfloat16 (the main path) is two walks on wgmma. The first design
// (above) ran at 13.7x its bound: its projection read the weights per warp
// m-tile from device memory, its row pass re-read a row's q_s and v for
// each of its 4 query tiles in 64-key tiles by synchronous loads behind two
// barriers a tile, its scores ran on mma.sync, the band read 9 rows of q_s
// from device memory per value, and it rounded exp(s - running max) before
// P.V and divided by the sum after it, where the TPU kernel rounds the
// normalised p. Now:
// - Projection and band (`eg1_walk_kernel`): one CTA an SM walks an even
//   share of the units (frame, 64-column strip, row), a strip down two
//   rows a step, one per warpgroup (one code path). x's rows come in by the
//   TMA unit two steps ahead (zero outside the image), aq[m] (per walk,
//   two buffers) and bv stay resident as swizzled tiles, and q_s = x aq[m]
//   + cq, v = x bv + cv run on wgmma (SS), rounded. q_s goes into a ring of
//   the last 10 rows in shared memory (zero outside the image), from which
//   each step computes the band of rows j - 4 and j - 3 (fp32 taps in
//   order, the bias last; each thread both rows of its 16 channels of a
//   pixel, so that each ring value is converted once for both): the band has no column halo, so a strip needs
//   none, and a walk's first 4 steps are its warm-up (the 8 rows above its
//   first; they are not stored). q_s, v and q_c leave by TMA stores.
// - Row attention (`eg1_attend_kernel`): one CTA an SM walks an even share
//   of the units (frame row, 64-query tile). The row's K (= q_s) and V stay
//   resident (2 x NCH x 64 positions each, zero past W), brought in by the
//   TMA unit in 64-position boxes; the next row's K comes into a second
//   buffer during the row (where two fit: W <= 512; else once the row's
//   last query tile has its scores), its V once that tile's P.V is done. The queries are the resident K rows, loaded by ldmatrix as the
//   register A of Q Kᵀ on wgmma (RS, so only K streams from shared memory).
//   A 64 x 480 fp32 score tile is 240 registers a thread, too many for one
//   warpgroup, so the two warpgroups split the keys (NCH 64-key chunks
//   each, NCH = ceil(W / 128), up to 5: W <= 640) rather than take two
//   passes: one pass, one exp per score (the exp rate of the card is as
//   near a limit here as the tensor cores). They exchange each row's max
//   and sum through shared memory, each rounds the normalised p = e / sum
//   to bf16 and runs P.V over its keys (V MN-major), and warpgroup 0 adds
//   warpgroup 1's fp32 half, in that fixed order, rounds v_r once and
//   stores it by the TMA unit.
// - A W past 640 keeps the first design's row pass, chosen by shape, in two
//   passes over the keys (max and sum, then the normalised p, rounded, and
//   P.V), its band left to the walk.
//
// eg2 in bfloat16 is a walk of 8x8 windows on wgmma (`eg2_walk_kernel`).
// The first design ran 4080 short CTAs of two windows, its four 64 x 64
// products reading weight fragments per warp from device memory (~2 KB a
// pixel against the 384 B it must move), x and long loaded synchronously
// behind a barrier, the attention on mma.sync: 6.7x its bound. Now:
// - One CTA an SM walks an even share of the windows (frame, window row,
//   window column), three a step, one per warpgroup of its 384 threads:
//   each warpgroup's chain of five dependent products is latency-bound,
//   and a third chain in flight hides more of it than a deeper ring would.
// - Each warpgroup fills a ring of its own (three stages of its window's x
//   and long, 16 KB) by the TMA unit: an 8 x 8 box of the NHWC tensor lands
//   as the window's 64 tokens in row order, 128-byte swizzled, a K-major
//   tile. No block barrier in the walk: the warpgroups drift, one's
//   softmax beside another's products.
// - wq, wv, fa, fb stay resident, loaded by TMA from the (C in, C out)
//   matrices as they are, which makes them MN-major B tiles (no host pack).
// - The chain through registers: q = x wq, v = x wv (SS); q's bias and mask
//   and v's bias in the epilogue, rounded: q as the scores' register A and
//   into a K-major tile (the keys are the queries' own rows), v into a tile
//   read MN-major; s = q qᵀ (RS); softmax by quad shuffles (a thread holds
//   2 rows x 16 scores), p = e / sum rounded into register A; loc = p v
//   (RS), rounded; out = long fa (SS) + loc fb (RS), + bf + x (x from its
//   tile) in fp32, rounded once into x's tile, then out to device memory
//   as 16-byte rows; the stage is refilled once the warpgroup is past it.
// - Windows are stepped as (frame, row, column) counters: 64-bit divisions
//   in the step cost ~8% of it.

#include <math.h>

#include "gram_tile.cuh"
#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 walks, per step: the
// projection walk's (the wait for x's rows at the step's barrier, q_s and v
// on wgmma, their epilogue to the ring and staging rows, the band with the
// stores' issue) by default, the row attention's (the wait for the row's K,
// Q Kᵀ, the max exchange, exp and the sum exchange, P.V with the wait for
// V, the cross-warpgroup sum and the store's issue) with
// -DCDFO_PHASE_ROWS, the two kernels counting into one set of clocks.
#include "phase_clocks.cuh"
#ifdef CDFO_PHASE_ROWS
#define WALK_PHASE(x)
#define ROWS_PHASE(x) x
#else
#define WALK_PHASE(x) x
#define ROWS_PHASE(x)
#endif

namespace {

using namespace cdfo;

constexpr int QROWS = 16 * WARPS;  // queries per CTA of the row pass: 128
constexpr int KT = 64;             // keys per tile
constexpr int NKT = KT / 8;        // 8-key n-tiles of a score tile
constexpr int NCT = C / 8;         // 8-channel n-tiles of an output
constexpr int WS = 8;              // window side
constexpr int TW = 2 * WS;         // eg2 tile width: two windows
constexpr int NPIX = WS * TW;      // pixels of an eg2 tile, of a projection tile: 128
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

template <int NT>
__device__ __forceinline__ void clear(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// s[nt] += Q Kᵀ over the 64 channels for one warp: the 16 query rows q(i),
// i < 16, against the 64 keys k(j), j < KT, all rows in shared memory
// (Pitch<T> apart within a row of pixels; q and k return a row's channel
// 0). s is the mma C-fragment: lane 4g + t holds queries g, g + 8 and keys
// 8nt + 2t, 8nt + 2t + 1.
template <typename T, typename QRow, typename KRow>
__device__ __forceinline__ void scores(float (&s)[NKT][4], QRow q, KRow k, int lane) {
  if constexpr (std::is_same<T, bf16>::value) {
    // A: lanes 0-7 rows 0-7, 8-15 rows 8-15, channels +8 for lanes 16-31;
    // B (two n-tiles): lanes 0-7 keys 0-7, 8-15 the same keys at channel
    // +8, 16-31 the next 8 keys
    const bf16* qa = q((lane & 7) + ((lane >> 3) & 1) * 8) + (lane >> 4) * 8;
    uint32_t a[C / 16][4];
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) ldsm_x4(a[kc], qa + 16 * kc);
#pragma unroll
    for (int nt = 0; nt < NKT; nt += 2) {
      const bf16* kb = k(8 * nt + (lane & 7) + ((lane >> 4) & 1) * 8) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t b[4];
        ldsm_x4(b, kb + 16 * kc);
        mma16816(s[nt], a[kc][0], a[kc][1], a[kc][2], a[kc][3], b[0], b[1]);
        mma16816(s[nt + 1], a[kc][0], a[kc][1], a[kc][2], a[kc][3], b[2], b[3]);
      }
    }
  } else {
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    const float* q0 = q(g);
    const float* q8 = q(g + 8);
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
      const float* k0 = k(8 * nt + t2);
      const float* k1 = k(8 * nt + t2 + 1);
      float* c = s[nt];
#pragma unroll 4
      for (int ch = 0; ch < C; ch += 4) {
        const float4 x = *reinterpret_cast<const float4*>(q0 + ch);
        const float4 y = *reinterpret_cast<const float4*>(q8 + ch);
        const float4 u = *reinterpret_cast<const float4*>(k0 + ch);
        const float4 v = *reinterpret_cast<const float4*>(k1 + ch);
        c[0] = fmaf(x.x, u.x, fmaf(x.y, u.y, fmaf(x.z, u.z, fmaf(x.w, u.w, c[0]))));
        c[1] = fmaf(x.x, v.x, fmaf(x.y, v.y, fmaf(x.z, v.z, fmaf(x.w, v.w, c[1]))));
        c[2] = fmaf(y.x, u.x, fmaf(y.y, u.y, fmaf(y.z, u.z, fmaf(y.w, u.w, c[2]))));
        c[3] = fmaf(y.x, v.x, fmaf(y.y, v.y, fmaf(y.z, v.z, fmaf(y.w, v.w, c[3]))));
      }
    }
  }
}

// o[nt] += P V for one warp: P the 16 x 64 probabilities in the score
// fragments (rounded to T here), V the rows v(j) of the same 64 keys; o is
// the C-fragment of 16 queries x 64 channels (lane 4g + t: queries g, g + 8,
// channels 8nt + 2t, 8nt + 2t + 1).
template <typename T, typename VRow>
__device__ __forceinline__ void attend(float (&o)[NCT][4], const float (&p)[NKT][4], VRow v,
                                       int lane) {
  if constexpr (std::is_same<T, bf16>::value) {
    // the C-fragments of key n-tiles 2kk, 2kk + 1 are the A-fragment of
    // keys 16kk .. 16kk + 15; V by ldmatrix.trans: lanes 0-7 keys 0-7, 8-15
    // keys 8-15, channels +8 for lanes 16-31
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      const uint32_t a0 = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const bf16* vb = v(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) + ((lane >> 4) & 1) * 8;
#pragma unroll
      for (int nt = 0; nt < NCT; nt += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + 8 * nt);
        mma16816(o[nt], a0, a1, a2, a3, b[0], b[1]);
        mma16816(o[nt + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
  } else {
    const int t2 = (lane & 3) * 2, quad = lane & ~3;
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) {
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        // keys 8kt + 2tt, 8kt + 2tt + 1 of rows g and g + 8, from lane 4g + tt
        const float p0 = __shfl_sync(FULL, p[kt][0], quad | tt);
        const float p1 = __shfl_sync(FULL, p[kt][1], quad | tt);
        const float p2 = __shfl_sync(FULL, p[kt][2], quad | tt);
        const float p3 = __shfl_sync(FULL, p[kt][3], quad | tt);
        const float* v0 = v(8 * kt + 2 * tt);
        const float* v1 = v(8 * kt + 2 * tt + 1);
#pragma unroll
        for (int nt = 0; nt < NCT; ++nt) {
          const float2 a = load2(v0 + 8 * nt + t2), b = load2(v1 + 8 * nt + t2);
          o[nt][0] = fmaf(p0, a.x, fmaf(p1, b.x, o[nt][0]));
          o[nt][1] = fmaf(p0, a.y, fmaf(p1, b.y, o[nt][1]));
          o[nt][2] = fmaf(p2, a.x, fmaf(p3, b.x, o[nt][2]));
          o[nt][3] = fmaf(p2, a.y, fmaf(p3, b.y, o[nt][3]));
        }
      }
    }
  }
}

// ---- eg1, pass 1: q_s = x aq[m] + cq[m], v = x bv + cv ----------------------

template <typename T>
constexpr int project_smem() {
  return NPIX * Pitch<T>::value * static_cast<int>(sizeof(T));
}

// Grid (pixel tiles of 128, frames): the image's pixels as one row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
eg1_project(const T* __restrict__ x, const T* __restrict__ aq, const T* __restrict__ cq,
            const T* __restrict__ bv, const T* __restrict__ cv, T* __restrict__ qs,
            T* __restrict__ vs, int hw) {
  extern __shared__ uint4 cdfo_smem[];
  T* xs = reinterpret_cast<T*>(cdfo_smem);
  const int img = blockIdx.y, p0 = blockIdx.x * NPIX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npix = min(NPIX, hw - p0);
  const long long base = (static_cast<long long>(img) * hw + p0) * C;
  load_window(xs, x + static_cast<long long>(img) * hw * C, 1, hw, 0, p0, 1, NPIX, false);
  __syncthreads();
  const ATile<T> a[1] = {a_tile<1>(xs, NPIX, NPIX, npix, warp, lane)};
  const T* cqm = cq + img * C;
  float acc[1][NCT][4];
  zero(acc);
  conv_tiles<1, 1, 1, NCT>(acc, a, Weights<T>{aq + static_cast<long long>(img) * GRAM, C, C}, 0,
                           0, lane);
  for_each_pair(acc[0], warp, 0, npix, lane, [&](int p, int n, float v0, float v1) {
    const float2 b = load2(cqm + n);
    store2(qs + base + p * C + n, v0 + b.x, v1 + b.y);
  });
  zero(acc);
  conv_tiles<1, 1, 1, NCT>(acc, a, Weights<T>{bv, C, C}, 0, 0, lane);
  for_each_pair(acc[0], warp, 0, npix, lane, [&](int p, int n, float v0, float v1) {
    const float2 b = load2(cv + n);
    store2(vs + base + p * C + n, v0 + b.x, v1 + b.y);
  });
}

// ---- eg1, pass 2: row attention and the H-band --------------------------------

template <typename T>
constexpr int rows_smem() {
  return (QROWS + 2 * KT) * Pitch<T>::value * static_cast<int>(sizeof(T));
}

// Grid (query tiles of 128 along W, H, frames). kWide (bfloat16, W past
// what eg1_attend_kernel keeps resident): no band (the walk computes it)
// and two passes over the keys, so that the normalised p is rounded.
template <typename T, bool kWide>
__device__ __forceinline__ void eg1_rows_body(const T* __restrict__ qs, const T* __restrict__ vs,
                                              const float* __restrict__ h9, T* __restrict__ qc,
                                              T* __restrict__ vr, int h, int w) {
  constexpr int P = Pitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* qt = reinterpret_cast<T*>(cdfo_smem);  // [QROWS][P] this CTA's queries
  T* kt = qt + QROWS * P;                     // [KT][P] one tile of keys (q_s)
  T* vt = kt + KT * P;                        // [KT][P] their v
  const int img = blockIdx.z, g = blockIdx.y, q0 = blockIdx.x * QROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long img_base = static_cast<long long>(img) * h * w * C;
  const long long row = img_base + static_cast<long long>(g) * w * C;

  // q_c of the CTA's positions, 8 channels a thread: the taps in order in
  // fp32, rows outside the image skipped (they are zero), then the bias
  for (int i = threadIdx.x; !kWide && i < QROWS * (C / 8); i += THREADS) {
    const int pos = q0 + i / (C / 8), c = (i % (C / 8)) * 8;
    if (pos >= w) continue;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < 9; ++d) {
      const int y = g + d - 4;
      if (y < 0 || y >= h) continue;
      float u[8];
      load8(qs + img_base + (static_cast<long long>(y) * w + pos) * C + c, u);
      const float tap = __ldg(h9 + d);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += tap * u[e];
    }
    const float bias = __ldg(h9 + 9);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += bias;
    store8(qc + row + static_cast<long long>(pos) * C + c, acc);
  }

  load_window(qt, qs + img_base, h, w, g, q0, 1, QROWS, false);
  auto qrow = [&](int i) { return static_cast<const T*>(qt + (warp * 16 + i) * P); };
  auto krow = [&](int j) { return static_cast<const T*>(kt + j * P); };
  auto vrow = [&](int j) { return static_cast<const T*>(vt + j * P); };
  const int t2 = (lane & 3) * 2;
  // the scores of key tile k0 (and, with_v, its v into vt), keys past w -inf
  auto tile_scores = [&](int k0, float (&s)[NKT][4], bool with_v) {
    __syncthreads();  // the queries are in; the previous tile is read
    load_window(kt, qs + img_base, h, w, g, k0, 1, KT, false);
    if (with_v) load_window(vt, vs + img_base, h, w, g, k0, 1, KT, false);
    __syncthreads();
    clear(s);
    scores<T>(s, qrow, krow, lane);
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * nt + t2 + (e & 1) >= w) s[nt][e] = -INFINITY;
  };
  float o[NCT][4];
  clear(o);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // online max and sum of rows g (e = 0, 1) and g + 8 (e = 2, 3): every
  // tile holds a key of the row, so the tile max is finite and the first
  // tile's rescale exp(-inf) is 0; returns the rescale of each row
  auto online = [&](float (&s)[NKT][4], float (&alpha)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      const float m_new = fmaxf(m_run[r], quad_max(mx));
      alpha[r] = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - m_new);
          sum += s[nt][e];
        }
      l_run[r] = l_run[r] * alpha[r] + quad_sum(sum);
      m_run[r] = m_new;
    }
  };
  if constexpr (kWide) {
#pragma unroll 1
    for (int k0 = 0; k0 < w; k0 += KT) {
      float s[NKT][4], alpha[2];
      tile_scores(k0, s, false);
      online(s, alpha);
    }
#pragma unroll 1
    for (int k0 = 0; k0 < w; k0 += KT) {
      float s[NKT][4];
      tile_scores(k0, s, true);
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - m_run[e >> 1]) / l_run[e >> 1];
      attend<T>(o, s, vrow, lane);
    }
    l_run[0] = l_run[1] = 1.f;
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < w; k0 += KT) {
      float s[NKT][4], alpha[2];
      tile_scores(k0, s, true);
      online(s, alpha);
#pragma unroll
      for (int nt = 0; nt < NCT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
      attend<T>(o, s, vrow, lane);
    }
  }

  const int pos = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int nt = 0; nt < NCT; ++nt) {
    const int n = 8 * nt + t2;
    if (pos < w) {
      store2(vr + row + static_cast<long long>(pos) * C + n, o[nt][0] / l_run[0],
             o[nt][1] / l_run[0]);
    }
    if (pos + 8 < w) {
      store2(vr + row + static_cast<long long>(pos + 8) * C + n, o[nt][2] / l_run[1],
             o[nt][3] / l_run[1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
eg1_rows(const T* __restrict__ qs, const T* __restrict__ vs, const float* __restrict__ h9,
         T* __restrict__ qc, T* __restrict__ vr, int h, int w) {
  eg1_rows_body<T, false>(qs, vs, h9, qc, vr, h, w);
}

__global__ void __launch_bounds__(THREADS, 2)
eg1_rows_wide(const bf16* __restrict__ qs, const bf16* __restrict__ vs,
              const float* __restrict__ h9, bf16* __restrict__ qc, bf16* __restrict__ vr, int h,
              int w) {
  eg1_rows_body<bf16, true>(qs, vs, h9, qc, vr, h, w);
}

// ---- eg1, bfloat16: the projection and band walk ---------------------------

constexpr int ESTRIP = 64;                    // columns of a strip: one m64 tile a row
constexpr int ROW_ELEMS = ESTRIP * C;         // bf16 of a strip row
constexpr int ROW_BYTES = ROW_ELEMS * 2;
constexpr int MAT_BYTES = C * C * 2;          // a 64 x 64 K-major tile
constexpr int RING = 10;                      // q_s rows j - 8 .. j + 1 of a step
constexpr int XSLOTS = 3;                     // x's steps in flight
// aq of two walks | bv | x rows [3 steps][2] | q_s ring | v rows [2] | q_c
// rows [2] | mbarriers: bv's, x's three
constexpr int WALK_SMEM = 1024 + 3 * MAT_BYTES + (2 * XSLOTS + RING + 4) * ROW_BYTES +
                          8 * (1 + XSLOTS);
static_assert(WALK_SMEM <= 232448, "one block's shared memory");

// A step of a walk: the rows [a, e) of one strip of frame b are its
// outputs; step k projects rows j = a - 4 + 2k and j + 1 (one per
// warpgroup) and computes the band of rows j - 4 and j - 3, so a walk is
// ceil((e - a) / 2) + 4 steps, its first 4 the warm-up. par: the walk's
// parity in the CTA (its aq buffer).
struct EgStep {
  long long u;      // the walk's first unit
  int b, c0, a, e;  // frame, the strip's first column, the walk's rows [a, e)
  int k, par;
};

__device__ __forceinline__ EgStep eg_walk_at(long long u, long long g1, int h, int strips,
                                             int par) {
  const long long sb = u / h;
  EgStep s;
  s.u = u;
  s.b = static_cast<int>(sb / strips);
  s.c0 = static_cast<int>(sb % strips) * ESTRIP;
  s.a = static_cast<int>(u % h);
  s.e = static_cast<int>(g1 - u < h - s.a ? s.a + (g1 - u) : h);
  s.k = 0;
  s.par = par;
  return s;
}

__device__ __forceinline__ bool eg_next(const EgStep& s, long long g1, int h, int strips,
                                        EgStep& n) {
  if (s.k + 1 < (s.e - s.a + 1) / 2 + 4) {
    n = s;
    ++n.k;
    return true;
  }
  const long long nu = s.u + (s.e - s.a);
  if (nu >= g1) return false;
  n = eg_walk_at(nu, g1, h, strips, s.par ^ 1);
  return true;
}

// Units (frame, strip, row) numbered (frame * strips + strip) * h + row;
// CTA i walks [i total / G, (i + 1) total / G) of them. aq: (m, 64 n, 64
// k) and bv (64 n, 64 k) by the TMA unit (which swizzles them); cq [m][64], cv [64]; h9 [10].
__global__ void __launch_bounds__(THREADS, 1)
eg1_walk_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tqs,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tqc,
                const __grid_constant__ CUtensorMap taq, const __grid_constant__ CUtensorMap tbv,
                const bf16* __restrict__ cq, const bf16* __restrict__ cv,
                const float* __restrict__ h9, int m, int h, int w) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* aqs = reinterpret_cast<bf16*>(base);   // aq of two walks [2][64 n][64 k]
  bf16* bvs = aqs + 2 * C * C;                  // bv [64 n][64 k]
  bf16* xs = bvs + C * C;                       // x rows [3 steps][2]
  bf16* ring = xs + 2 * XSLOTS * ROW_ELEMS;     // q_s rows, by index in the walk % 10
  bf16* vst = ring + RING * ROW_ELEMS;          // v rows [2]
  bf16* qcs = vst + 2 * ROW_ELEMS;              // q_c rows [2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(qcs + 2 * ROW_ELEMS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int strips = (w + ESTRIP - 1) / ESTRIP;
  const long long total = static_cast<long long>(m) * strips * h;
  const long long g0 = blockIdx.x * total / gridDim.x, g1 = (blockIdx.x + 1) * total / gridDim.x;
  if (g0 >= g1) return;

  // x's rows j, j + 1 of step s (and, at a walk's first step, its frame's
  // aq) into slot t % 3, on mbarrier 1 + t % 3
  auto fetch = [&](const EgStep& s, long long t) {
    uint64_t* bar = bars + 1 + t % XSLOTS;
    const int j = s.a - 4 + 2 * s.k;
    mbar_expect_tx(bar, 2 * ROW_BYTES + (s.k == 0 ? MAT_BYTES : 0));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tma_load_row(xs + (2 * (t % XSLOTS) + r) * ROW_ELEMS, &tx, s.c0, j + r, s.b, bar);
    }
    if (s.k == 0) tma_load_row(aqs + s.par * C * C, &taq, 0, 0, s.b, bar);
  };

  EgStep s = eg_walk_at(g0, g1, h, strips, 0), n1, n2;
  bool has1 = eg_next(s, g1, h, strips, n1);
  bool has2 = has1 && eg_next(n1, g1, h, strips, n2);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + XSLOTS; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, MAT_BYTES);
    tma_load_row(bvs, &tbv, 0, 0, 0, bars);
    fetch(s, 0);
    if (has1) fetch(n1, 1);
  }
  float taps[10];
#pragma unroll
  for (int d = 0; d < 10; ++d) taps[d] = __ldg(h9 + d);
  float2 cvb[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) cvb[jj] = load2(cv + 8 * jj + t2);
  __syncthreads();
  mbar_wait(bars, 0);
  const uint64_t bvd = wgmma_desc(bvs);

  WALK_PHASE(PHASE_START)
#pragma unroll 1
  for (long long t = 0;; ++t) {
    mbar_wait(bars + 1 + t % XSLOTS, static_cast<uint32_t>((t / XSLOTS) & 1));
    bulk_wait_read();   // the last step's rows have left shared memory
    __syncthreads();    // and the last step's band is done with the ring
    WALK_PHASE(PHASE(0))
    if (threadIdx.x == 0 && has2) fetch(n2, t + 2);
    const int j = s.a - 4 + 2 * s.k, r = j + wg;
    // q_s = x aq[m] + cq[m] and v = x bv + cv of row r
    float aqc[8][4], avc[8][4];
    {
      const uint64_t xd = wgmma_desc(xs + (2 * (t % XSLOTS) + wg) * ROW_ELEMS);
      const uint64_t aqd = wgmma_desc(aqs + s.par * C * C);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(aqc, xd + 2 * kk, aqd + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(avc, xd + 2 * kk, bvd + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      keep(aqc);
      keep(avc);
    }
    WALK_PHASE(PHASE(1))
    // rounded: q_s into the ring (zero outside the image: the band's
    // padding), v into its staging row
    const bool in = r >= 0 && r < h;
    bf16* qr = ring + ((2 * s.k + wg) % RING) * ROW_ELEMS;
    bf16* vrow = vst + wg * ROW_ELEMS;
    const bf16* cqm = cq + s.b * C;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 cb = load2(cqm + 8 * jj + t2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = 16 * wl + g + 8 * half;
        store2(swizzled(qr, px, 8 * jj + t2), in ? aqc[jj][2 * half] + cb.x : 0.f,
               in ? aqc[jj][2 * half + 1] + cb.y : 0.f);
        store2(swizzled(vrow, px, 8 * jj + t2), avc[jj][2 * half] + cvb[jj].x,
               avc[jj][2 * half + 1] + cvb[jj].y);
      }
    }
    async_fence();
    __syncthreads();
    WALK_PHASE(PHASE(2))
    // this warpgroup's row r, if the walk's own: q_s and v out
    if ((threadIdx.x & 127) == 0 && r >= s.a && r < s.e) {
      tma_store_row(&tqs, qr, s.c0, r, s.b);
      tma_store_row(&tv, vrow, s.c0, r, s.b);
      bulk_commit();
    }
    // the band of rows y = j - 4 and y + 1 (rows y - 4 .. y + 5 of the
    // ring), four threads a pixel, 16 channels each, both rows at once (a
    // ring row converted once serves both); a walk's first 4 steps have
    // none, a row past e is dropped
    if (s.k >= 4) {
      const int y = j - 4, px = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float a0[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float a1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 10; ++i) {
          float u[8];
          load8(swizzled(ring + ((2 * s.k - 8 + i) % RING) * ROW_ELEMS, px, c0 + 8 * cc), u);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (i < 9) a0[e] += taps[i] * u[e];
            if (i > 0) a1[e] += taps[i - 1] * u[e];
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a0[e] += taps[9];
          a1[e] += taps[9];
        }
        store8(swizzled(qcs, px, c0 + 8 * cc), a0);
        store8(swizzled(qcs + ROW_ELEMS, px, c0 + 8 * cc), a1);
      }
      async_fence();
      __syncthreads();
      if (threadIdx.x == 0) {
        tma_store_row(&tqc, qcs, s.c0, y, s.b);
        if (y + 1 < s.e) tma_store_row(&tqc, qcs + ROW_ELEMS, s.c0, y + 1, s.b);
        bulk_commit();
      }
    }
    WALK_PHASE(PHASE(3))
    if (!has1) break;
    s = n1;
    n1 = n2;
    has1 = has2;
    has2 = has1 && eg_next(n1, g1, h, strips, n2);
    WALK_PHASE(PHASE_STEP)
  }
  bulk_wait_read();
  WALK_PHASE(PHASE_END)
}

// ---- eg1, bfloat16: the row attention with the row resident --------------------

constexpr int RESIDENT_W = 640;   // the widest row kept resident (NCH = 5)
constexpr float LOG2E = 1.4426950408889634f;

#ifndef CDFO_HOST_MMA
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
#endif

// K of a row (two rows, the next one's coming in, where they fit: NCH <= 4)
// and V, 2 NCH 64-position boxes each
__host__ __device__ constexpr int attend_kbufs(int nch) { return nch <= 4 ? 2 : 1; }
// K | V | warpgroup 1's P.V [8][128][4] fp32 | the output tiles of two query
// tiles | the row max and sum of each warpgroup [2][2][64] | mbarriers:
// V's, K's (one a buffer)
__host__ __device__ constexpr int attend_smem(int nch) {
  return 1024 + (attend_kbufs(nch) + 1) * (2 * nch * ROW_BYTES) + 32 * 128 * 4 +
         2 * ROW_BYTES + 4 * 64 * 4 + 24;
}
static_assert(attend_smem(RESIDENT_W / 128) <= 232448, "one block's shared memory");

// Units (frame row, 64-query tile) numbered row * qtiles + tile; CTA i walks
// [i total / G, (i + 1) total / G) of them. Warpgroup wg takes keys
// 64 (wg NCH + c) + .., c < NCH.
template <int NCH>
__global__ void __launch_bounds__(THREADS, 1)
eg1_attend_kernel(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tvr, int m, int h, int w) {
  constexpr int BOXES = 2 * NCH, KBUFS = attend_kbufs(NCH);
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* kring = reinterpret_cast<bf16*>(base);   // K = q_s [KBUFS][64 BOXES positions][64]
  bf16* vsm = kring + KBUFS * BOXES * ROW_ELEMS;  // V, swizzled
  float* obuf = reinterpret_cast<float*>(vsm + BOXES * ROW_ELEMS);   // [8][128 threads][4]
  bf16* osts = reinterpret_cast<bf16*>(obuf + 32 * 128);   // v_r tiles [2], swizzled
  float* mxs = reinterpret_cast<float*>(osts + 2 * ROW_ELEMS);       // [2 wg][64 rows]
  float* sms = mxs + 2 * 64;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sms + 2 * 64);        // V, then K's

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int rt = threadIdx.x & 127;
  const int qtiles = (w + 63) / 64;
  const long long total = static_cast<long long>(m) * h * qtiles;
  const long long g0 = blockIdx.x * total / gridDim.x, g1 = (blockIdx.x + 1) * total / gridDim.x;
  if (g0 >= g1) return;

  // row ri's (frame ri / h, row ri % h) K or V, all BOXES boxes, on bar
  auto fetch = [&](bf16* dst, const CUtensorMap* map, long long ri, uint64_t* bar) {
    mbar_expect_tx(bar, BOXES * ROW_BYTES);
    for (int i = 0; i < BOXES; ++i) {
      tma_load_row(dst + i * ROW_ELEMS, map, 64 * i, static_cast<int>(ri % h),
                   static_cast<int>(ri / h), bar);
    }
  };
  // the CTA's n-th row's K: its buffer and mbarrier
  auto kbuf = [&](int n) { return kring + (n % KBUFS) * BOXES * ROW_ELEMS; };
  auto kbar = [&](int n) { return bars + 1 + n % KBUFS; };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + KBUFS; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    fetch(kbuf(0), &tqs, g0 / qtiles, kbar(0));
    fetch(vsm, &tv, g0 / qtiles, bars);
  }
  __syncthreads();

  int nrow = 0;   // rows this CTA has finished
  ROWS_PHASE(PHASE_START)
#pragma unroll 1
  for (long long u = g0; u < g1; ++u) {
    const long long ri = u / qtiles;
    const int qi = static_cast<int>(u % qtiles);
    const bool first = u == g0 || qi == 0;
    const bool last = u + 1 == g1 || qi == qtiles - 1;
    const bool next_row = (ri + 1) * qtiles < g1;   // the CTA walks a unit of row ri + 1
    if (first) {
      mbar_wait(kbar(nrow), static_cast<uint32_t>((nrow / KBUFS) & 1));
      // two K buffers: the next row's K comes in during this whole row
      if (KBUFS == 2 && threadIdx.x == 0 && next_row) {
        fetch(kbuf(nrow + 1), &tqs, ri + 1, kbar(nrow + 1));
      }
    }
    bf16* ks = kbuf(nrow);
    ROWS_PHASE(PHASE(0))
    // the 64 queries (rows 64 qi .. of K) as register A: warp wl rows 16 wl ..
    uint32_t qa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      ldsm_x4(qa[kc], swizzled(ks, 64 * qi + 16 * wl + (lane & 7) + ((lane >> 3) & 1) * 8,
                               16 * kc + (lane >> 4) * 8));
    }
    float sc[NCH][8][4];
    uint64_t kbase = wgmma_desc(ks + wg * NCH * ROW_ELEMS);
    keep(kbase);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const uint64_t kd = kbase + c * (ROW_BYTES >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64(sc[c], qa[kk], kd + 2 * kk, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(sc);
    keep(qa);
    ROWS_PHASE(PHASE(1))
    // keys past w score -inf; this lane's rows 16 wl + g (e = 0, 1) and + 8
    // (e = 2, 3): their max over the warpgroup's keys, then over both
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int k0 = 64 * (wg * NCH + c);
      if (k0 + 64 > w) {   // a chunk past the row's end (one warpgroup's branch: no wgmma)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * jj + t2 + (e & 1) >= w) sc[c][jj][e] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          mx = fmaxf(mx, fmaxf(sc[c][jj][2 * r], sc[c][jj][2 * r + 1]));
        }
      mx = quad_max(mx);
      if ((lane & 3) == 0) mxs[wg * 64 + 16 * wl + g + 8 * r] = mx;
    }
    __syncthreads();
    // one K buffer: the row's keys have their scores, the next row's K may
    // come in
    if (KBUFS == 1 && threadIdx.x == 0 && last && next_row) {
      fetch(kbuf(nrow + 1), &tqs, ri + 1, kbar(nrow + 1));
    }
    ROWS_PHASE(PHASE(2))
    float ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * wl + g + 8 * r;
      ml[r] = fmaxf(mxs[row], mxs[64 + row]) * LOG2E;   // finite: key 0 is warpgroup 0's
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[c][jj][e] = ex2(fmaf(sc[c][jj][e], LOG2E, -ml[e >> 1]));
          sum[e >> 1] += sc[c][jj][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float q = quad_sum(sum[r]);
      if ((lane & 3) == 0) sms[wg * 64 + 16 * wl + g + 8 * r] = q;
    }
    __syncthreads();
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * wl + g + 8 * r;
      inv[r] = 1.f / (sms[row] + sms[64 + row]);
    }
    // p = e / sum rounded to bf16: the A fragments of P.V, k16 step 4c + kk
    // taking n-tiles 2kk, 2kk + 1 of chunk c
    uint32_t pa[4 * NCH][4];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float* e = sc[c][2 * kk + v];
          pa[4 * c + kk][2 * v] = pack_bf16x2(e[0] * inv[0], e[1] * inv[0]);
          pa[4 * c + kk][2 * v + 1] = pack_bf16x2(e[2] * inv[1], e[3] * inv[1]);
        }
    ROWS_PHASE(PHASE(3))
    if (first) mbar_wait(bars, static_cast<uint32_t>(nrow & 1));
    float o[8][4];
    zero1(o);
    keep(o);
    uint64_t vbase = wgmma_desc(vsm + wg * NCH * ROW_ELEMS, 1024);
    keep(vbase);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // 16 keys a k16 step: 2 KB
        wgmma_64x64_tb(o, pa[4 * c + kk], vbase + c * (ROW_BYTES >> 4) + kk * (2048 >> 4));
      }
    wgmma_commit();
    wgmma_wait<0>();
    keep(o);
    keep(pa);
    ROWS_PHASE(PHASE(4))
    if (wg == 1) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        *reinterpret_cast<float4*>(obuf + (4 * jj * 128 + 4 * rt)) =
            make_float4(o[jj][0], o[jj][1], o[jj][2], o[jj][3]);
      }
    }
    bf16* ost = osts + (u & 1) * ROW_ELEMS;
    if (threadIdx.x == 0) bulk_wait_read<1>();   // the tile before last's v_r has left ost
    __syncthreads();
    // the row's P.V is done: the next row's V may come in
    if (threadIdx.x == 0 && last && next_row) fetch(vsm, &tv, ri + 1, bars);
    if (wg == 0) {
      // v_r = the keys of warpgroup 0, then of warpgroup 1, rounded once
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 p = *reinterpret_cast<const float4*>(obuf + (4 * jj * 128 + 4 * rt));
        store2(swizzled(ost, 16 * wl + g, 8 * jj + t2), o[jj][0] + p.x, o[jj][1] + p.y);
        store2(swizzled(ost, 16 * wl + g + 8, 8 * jj + t2), o[jj][2] + p.z, o[jj][3] + p.w);
      }
      async_fence();
      warpgroup_sync(0);
      if (threadIdx.x == 0) {
        tma_store_row(&tvr, ost, 64 * qi, static_cast<int>(ri % h), static_cast<int>(ri / h));
        bulk_commit();
      }
    }
    if (last) ++nrow;
    ROWS_PHASE(PHASE(5))
    ROWS_PHASE(PHASE_STEP)
  }
  if (threadIdx.x == 0) bulk_wait_read();
  ROWS_PHASE(PHASE_END)
}

// ---- eg2: window attention, fusion, residual -------------------------------------

template <typename T>
constexpr int eg2_smem() {
  return 5 * NPIX * Pitch<T>::value * static_cast<int>(sizeof(T));
}

// Grid (tiles of two windows along W, window rows, frames). A tile's second
// window lies outside the image when W % 16 == 8.
template <typename T>
__global__ void __launch_bounds__(THREADS)
eg2_local_fuse(const T* __restrict__ x, const T* __restrict__ lg, const T* __restrict__ wq,
               const T* __restrict__ bq, const T* __restrict__ wv, const T* __restrict__ bv,
               const T* __restrict__ mi, const T* __restrict__ fa, const T* __restrict__ fb,
               const T* __restrict__ bf, T* __restrict__ out, int h, int w) {
  constexpr int P = Pitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* xs = reinterpret_cast<T*>(cdfo_smem);  // [NPIX][P] x of the tile
  T* ls = xs + NPIX * P;                      // long
  T* qsm = ls + NPIX * P;                     // masked q
  T* vsm = qsm + NPIX * P;                    // v
  T* os = vsm + NPIX * P;                     // loc
  const int img = blockIdx.z, r0 = blockIdx.y * WS, c0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(img) * h * w * C;
  load_window(xs, x + base, h, w, r0, c0, WS, TW, false);
  load_window(ls, lg + base, h, w, r0, c0, WS, TW, false);
  __syncthreads();

  // q, v; warp w: pixel row w of the tile
  const ATile<T> ax[1] = {a_tile<1>(xs, TW, TW, NPIX, warp, lane)};
  const T* mim = mi + img * C;
  float acc[1][NCT][4];
  zero(acc);
  conv_tiles<1, 1, 1, NCT>(acc, ax, Weights<T>{wq, C, C}, 0, 0, lane);
  for_each_pair(acc[0], warp, 0, NPIX, lane, [&](int p, int n, float v0, float v1) {
    const float2 b = load2(bq + n), m = load2(mim + n);
    store2(qsm + p * P + n, (v0 + b.x) * m.x, (v1 + b.y) * m.y);
  });
  zero(acc);
  conv_tiles<1, 1, 1, NCT>(acc, ax, Weights<T>{wv, C, C}, 0, 0, lane);
  for_each_pair(acc[0], warp, 0, NPIX, lane, [&](int p, int n, float v0, float v1) {
    const float2 b = load2(bv + n);
    store2(vsm + p * P + n, v0 + b.x, v1 + b.y);
  });
  __syncthreads();

  // warp w: queries 16 (w % 4) .. + 15 of window w / 4; token t of a window
  // is its pixel (t / 8, t % 8)
  const int win = warp >> 2, q0 = (warp & 3) * 16;
  auto tok = [&](T* buf, int t) { return buf + ((t >> 3) * TW + win * WS + (t & 7)) * P; };
  if (c0 + win * WS < w) {
    float s[NKT][4];
    clear(s);
    scores<T>(s, [&](int i) { return static_cast<const T*>(tok(qsm, q0 + i)); },
              [&](int j) { return static_cast<const T*>(tok(qsm, j)); }, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - mx);
          sum += s[nt][e];
        }
      sum = quad_sum(sum);
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        s[nt][2 * r] /= sum;
        s[nt][2 * r + 1] /= sum;
      }
    }
    float o[NCT][4];
    clear(o);
    attend<T>(o, s, [&](int j) { return static_cast<const T*>(tok(vsm, j)); }, lane);
    const int t = q0 + (lane >> 2), t2 = (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < NCT; ++nt) {
      store2(tok(os, t) + 8 * nt + t2, o[nt][0], o[nt][1]);
      store2(tok(os, t + 8) + 8 * nt + t2, o[nt][2], o[nt][3]);
    }
  }
  __syncthreads();

  // out = long fa + loc fb + bf + x
  const ATile<T> al[1] = {a_tile<1>(ls, TW, TW, NPIX, warp, lane)};
  const ATile<T> ao[1] = {a_tile<1>(os, TW, TW, NPIX, warp, lane)};
  zero(acc);
  conv_tiles<1, 1, 1, NCT>(acc, al, Weights<T>{fa, C, C}, 0, 0, lane);
  conv_tiles<1, 1, 1, NCT>(acc, ao, Weights<T>{fb, C, C}, 0, 0, lane);
  for_each_pair(acc[0], warp, 0, NPIX, lane, [&](int p, int n, float v0, float v1) {
    const int y = r0 + p / TW, xx = c0 + p % TW;
    if (xx < w) {
      const float2 b = load2(bf + n), r = load2(xs + p * P + n);
      store2(out + base + (static_cast<long long>(y) * w + xx) * C + n, v0 + b.x + r.x,
             v1 + b.y + r.y);
    }
  });
}

// ---- eg2, bfloat16: the window walk on wgmma -----------------------------------

constexpr int WIN_BYTES = WS * WS * C * 2;     // a window's 64 tokens: 8 KB
constexpr int E2_WGS = 3;                      // warpgroups, a window each a step
constexpr int E2_THREADS = 128 * E2_WGS;
constexpr int E2_STAGES = 3;                   // a ring per warpgroup
constexpr int E2_STAGE_BYTES = 2 * WIN_BYTES;  // a window's x, then its long
// wq | wv | fa | fb | stages [3 wg][3] | q, v of each warpgroup's window |
// bq, bv, bf in fp32 | mbarriers (weights, [3 wg][3] stages)
constexpr int E2_SMEM = 1024 + 4 * MAT_BYTES + E2_WGS * E2_STAGES * E2_STAGE_BYTES +
                        2 * E2_WGS * WIN_BYTES + 3 * C * 4 + 8 * (1 + E2_WGS * E2_STAGES);
static_assert(E2_SMEM <= 232448, "one block's shared memory");

struct Win {
  int f, wy, wx;   // frame, window row, window column
};
struct WinWalk {
  long long i;   // the window's number
  Win at;        // where it lies (past the CTA's run: its last window)
};

// Windows (frame, window row, window column) numbered in that order; CTA i
// walks [i total / G, (i + 1) total / G) of them, three a step, one per
// warpgroup, each warpgroup through a ring of its own (where the CTA's
// windows run out, a step's last windows repeat its last one, computed and
// dropped). The matrices twq, twv, tfa, tfb: wq, wv, fa, fb as they are,
// (64 k, 64 n) rows, which the TMA loads make MN-major B tiles; bq, bv, bf
// [64]; mi [m][64]; out (m, h, w, 64).
__global__ void __launch_bounds__(E2_THREADS, 1)
eg2_walk_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tlg,
                const __grid_constant__ CUtensorMap twq, const __grid_constant__ CUtensorMap twv,
                const __grid_constant__ CUtensorMap tfa, const __grid_constant__ CUtensorMap tfb,
                const bf16* __restrict__ bq, const bf16* __restrict__ bv,
                const bf16* __restrict__ mi, const bf16* __restrict__ bf, bf16* __restrict__ out,
                int m, int h, int w) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* mats = reinterpret_cast<bf16*>(base);   // wq, wv, fa, fb [64 k][64 n], swizzled
  unsigned char* stages = base + 4 * MAT_BYTES;
  bf16* qsm = reinterpret_cast<bf16*>(stages + E2_WGS * E2_STAGES * E2_STAGE_BYTES);   // [wg][64][64]
  bf16* vsm = qsm + E2_WGS * WS * WS * C;
  float* bsm = reinterpret_cast<float*>(vsm + E2_WGS * WS * WS * C);   // bq | bv | bf
  uint64_t* bars = reinterpret_cast<uint64_t*>(bsm + 3 * C);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int r = threadIdx.x & 127;
  const int wrows = h / WS, wcols = w / WS;
  const long long per = static_cast<long long>(wrows) * wcols, total = m * per;
  const long long g0 = blockIdx.x * total / gridDim.x, g1 = (blockIdx.x + 1) * total / gridDim.x;
  const int steps = static_cast<int>((g1 - g0 + E2_WGS - 1) / E2_WGS);
  if (steps <= 0) return;
  auto window = [&](long long i) {
    const long long rem = i % per;
    return Win{static_cast<int>(i / per), static_cast<int>(rem / wcols),
               static_cast<int>(rem % wcols)};
  };
  // the windows of this warpgroup, g0 + wg, g0 + wg + 3, ..., stepped
  // along without divisions; past the CTA's run, its last window
  const Win final_win = window(g1 - 1);
  auto walk_at = [&](long long i) { return WinWalk{i, window(i < g1 ? i : g1 - 1)}; };
  auto next = [&](WinWalk& x) {
    x.i += E2_WGS;
    x.at.wx += E2_WGS;
    while (x.at.wx >= wcols) {
      x.at.wx -= wcols;
      if (++x.at.wy == wrows) {
        x.at.wy = 0;
        ++x.at.f;
      }
    }
    if (x.i >= g1) x.at = final_win;
  };
  unsigned char* myring = stages + wg * E2_STAGES * E2_STAGE_BYTES;
  uint64_t* ring = bars + 1 + wg * E2_STAGES;
  // step t's window of this warpgroup: its x and long into stage t % 3
  auto fetch = [&](int t, const Win& wi) {
    unsigned char* st = myring + (t % E2_STAGES) * E2_STAGE_BYTES;
    uint64_t* bar = ring + t % E2_STAGES;
    mbar_expect_tx(bar, E2_STAGE_BYTES);
    tma_load_row(st, &tx, WS * wi.wx, WS * wi.wy, wi.f, bar);
    tma_load_row(st + WIN_BYTES, &tlg, WS * wi.wx, WS * wi.wy, wi.f, bar);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + E2_WGS * E2_STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, 4 * MAT_BYTES);
    tma_load_row(mats, &twq, 0, 0, 0, bars);
    tma_load_row(mats + C * C, &twv, 0, 0, 0, bars);
    tma_load_row(mats + 2 * C * C, &tfa, 0, 0, 0, bars);
    tma_load_row(mats + 3 * C * C, &tfb, 0, 0, 0, bars);
  }
  if (threadIdx.x < 3 * C) {
    const bf16* bias = threadIdx.x < C ? bq : threadIdx.x < 2 * C ? bv : bf;
    bsm[threadIdx.x] = to_f(bias[threadIdx.x & (C - 1)]);
  }
  __syncthreads();
  const bool producer = r == 0;   // the thread that fills its warpgroup's ring
  WinWalk ahead = walk_at(g0 + wg);   // the producer's next window, step t + 3's
  if (producer) {
    for (int t = 0; t < E2_STAGES && t < steps; ++t) {
      fetch(t, ahead.at);
      next(ahead);
    }
  }
  mbar_wait(bars, 0);

  // B descriptors of the (k, n) matrices: MN-major, 16 k rows (2 KB) a k16 step
  const uint64_t wqd = wgmma_desc(mats, 1024), wvd = wgmma_desc(mats + C * C, 1024);
  const uint64_t fad = wgmma_desc(mats + 2 * C * C, 1024);
  const uint64_t fbd = wgmma_desc(mats + 3 * C * C, 1024);
  bf16* qs = qsm + wg * WS * WS * C;   // this warpgroup's q, as the scores' K-major B
  bf16* vs = vsm + wg * WS * WS * C;   // its v, as P.V's MN-major B
  WinWalk cur = walk_at(g0 + wg);
  PHASE_START
#pragma unroll 1
  for (int t = 0; t < steps; ++t, next(cur)) {
    unsigned char* st = myring + (t % E2_STAGES) * E2_STAGE_BYTES;
    mbar_wait(ring + t % E2_STAGES, static_cast<uint32_t>((t / E2_STAGES) & 1));
    PHASE(0)
    bf16* xt = reinterpret_cast<bf16*>(st);   // token t of the window at row t
    const bf16* lt = reinterpret_cast<const bf16*>(st + WIN_BYTES);
    const Win wi = cur.at;
    // mask_inv[f] at this lane's channels 8 j + t2, + 1, loaded under the products
    float2 mv[NCT];
    const bf16* mim = mi + static_cast<long long>(wi.f) * C;
#pragma unroll
    for (int j = 0; j < NCT; ++j) mv[j] = load2(mim + 8 * j + t2);
    float qacc[NCT][4], vacc[NCT][4];
    zero1(qacc);
    zero1(vacc);
    keep(qacc);   // defined before the products' fence
    keep(vacc);
    {
      // q = x wq, v = x wv
      const uint64_t xd = wgmma_desc(xt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64_tb(qacc, xd + 2 * kk, wqd + 128 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64_tb(vacc, xd + 2 * kk, wvd + 128 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      keep(qacc);
      keep(vacc);
    }
    PHASE(1)
    // q = (x wq + bq) mask_inv[f] and v = x wv + bv, rounded: q as the
    // scores' register A and, with v, into this warpgroup's tiles
    uint32_t qa[4][4];
#pragma unroll
    for (int j = 0; j < NCT; ++j) {
      const float2 bqj = *reinterpret_cast<const float2*>(bsm + 8 * j + t2);
      const float2 bvj = *reinterpret_cast<const float2*>(bsm + C + 8 * j + t2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tok = 16 * wl + g + 8 * half;
        const uint32_t q2 = pack_bf16x2((qacc[j][2 * half] + bqj.x) * mv[j].x,
                                        (qacc[j][2 * half + 1] + bqj.y) * mv[j].y);
        qa[j >> 1][2 * (j & 1) + half] = q2;
        *reinterpret_cast<uint32_t*>(swizzled(qs, tok, 8 * j + t2)) = q2;
        store2(swizzled(vs, tok, 8 * j + t2), vacc[j][2 * half] + bvj.x,
               vacc[j][2 * half + 1] + bvj.y);
      }
    }
    async_fence();
    warpgroup_sync(wg);
    PHASE(2)
    // the scores s = q qᵀ (the keys are the window's own q rows)
    float sc[NKT][4];
    {
      const uint64_t qd = wgmma_desc(qs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64(sc, qa[kk], qd + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);
      keep(qa);
    }
    PHASE(3)
    // softmax over the 64 keys of rows 16 wl + g (e = 0, 1) and + 8 (e =
    // 2, 3): a quad holds a row; p = e / sum rounded into P.V's register A
    uint32_t pa[4][4];
    {
      float ml[2], inv[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NKT; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * rr], sc[j][2 * rr + 1]));
        ml[rr] = quad_max(mx) * LOG2E;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(fmaf(sc[j][e], LOG2E, -ml[e >> 1]));
          sum[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) inv[rr] = 1.f / quad_sum(sum[rr]);
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= inv[e >> 1];
      round_to_a(sc, pa);
      keep(pa);   // rounded before the products' fence
    }
    PHASE(4)
    // loc = p v, rounded into the fusion's register A
    float acc[NCT][4];
    {
      const uint64_t vd = wgmma_desc(vs, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64_tb(acc, pa[kk], vd + 128 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(pa);
    }
    uint32_t la[4][4];
    round_to_a(acc, la);
    keep(la);
    {
      // out = long fa + loc fb
      const uint64_t ld = wgmma_desc(lt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64_tb(acc, ld + 2 * kk, fad + 128 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64_tb(acc, la[kk], fbd + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(la);
    }
    PHASE(5)
    // + bf + x in fp32, rounded once, in place of x; then the window's 64
    // pixel rows out as 16-byte chunks, 4 a thread
#pragma unroll
    for (int j = 0; j < NCT; ++j) {
      const float2 bfj = *reinterpret_cast<const float2*>(bsm + 2 * C + 8 * j + t2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        bf16* o = swizzled(xt, 16 * wl + g + 8 * half, 8 * j + t2);
        const float2 xv = load2(o);
        store2(o, acc[j][2 * half] + bfj.x + xv.x, acc[j][2 * half + 1] + bfj.y + xv.y);
      }
    }
    warpgroup_sync(wg);
    if (cur.i < g1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = (r >> 3) + 16 * i, ch = 8 * (r & 7);
        const long long pix = (static_cast<long long>(wi.f) * h + WS * wi.wy + (tok >> 3)) * w +
                              WS * wi.wx + (tok & 7);
        *reinterpret_cast<uint4*>(out + pix * C + ch) =
            *reinterpret_cast<const uint4*>(swizzled(xt, tok, ch));
      }
    }
    async_fence();   // the stage's reads and writes before its refill by the TMA unit
    warpgroup_sync(wg);
    if (producer && t + E2_STAGES < steps) {
      fetch(t + E2_STAGES, ahead.at);
      next(ahead);
    }
    PHASE(6)
    PHASE_STEP
  }
  PHASE_END
}

cudaError_t launch_eg2_bf16(const void* x, const void* lg, const void* wq, const void* bq,
                            const void* wv, const void* bv, const void* mi, const void* fa,
                            const void* fb, const void* bf, void* out, int batch, int h, int w,
                            cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  CUtensorMap tx, tlg, twq, twv, tfa, tfb;
  cudaError_t err;
  if ((err = nhwc_tensor_map(&tx, x, batch, h, w, WS, WS)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tlg, lg, batch, h, w, WS, WS)) != cudaSuccess ||
      (err = nhwc_tensor_map(&twq, wq, 1, 1, C, C)) != cudaSuccess ||
      (err = nhwc_tensor_map(&twv, wv, 1, 1, C, C)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tfa, fa, 1, 1, C, C)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tfb, fb, 1, 1, C, C)) != cudaSuccess) {
    return err;
  }
  if ((err = allow_smem(eg2_walk_kernel, E2_SMEM)) != cudaSuccess) return err;
  const long long sets = (static_cast<long long>(batch) * (h / WS) * (w / WS) + E2_WGS - 1) / E2_WGS;
  CDFO_LAUNCH_N(eg2_walk_kernel, dim3(static_cast<unsigned>(sets < sms ? sets : sms)), E2_THREADS,
                E2_SMEM, stream, tx, tlg, twq, twv, tfa, tfb, static_cast<const bf16*>(bq),
                static_cast<const bf16*>(bv), static_cast<const bf16*>(mi),
                static_cast<const bf16*>(bf), static_cast<bf16*>(out), batch, h, w);
  return cudaGetLastError();
}

cudaError_t launch_eg1(const void* x, const void* aq, const void* cq, const void* bv,
                       const void* cv, const void* h9, void* qs, void* vs, void* qc, void* vr,
                       int batch, int h, int w, cudaStream_t stream) {
  using T = float;
  cudaError_t err = allow_smem(eg1_project<T>, project_smem<T>());
  if (err != cudaSuccess) return err;
  err = allow_smem(eg1_rows<T>, rows_smem<T>());
  if (err != cudaSuccess) return err;
  const int hw = h * w;
  CDFO_LAUNCH(eg1_project<T>, dim3((hw + NPIX - 1) / NPIX, batch), project_smem<T>(), stream,
              static_cast<const T*>(x), static_cast<const T*>(aq), static_cast<const T*>(cq),
              static_cast<const T*>(bv), static_cast<const T*>(cv), static_cast<T*>(qs),
              static_cast<T*>(vs), hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(eg1_rows<T>, dim3((w + QROWS - 1) / QROWS, h, batch), rows_smem<T>(), stream,
              static_cast<const T*>(qs), static_cast<const T*>(vs), static_cast<const float*>(h9),
              static_cast<T*>(qc), static_cast<T*>(vr), h, w);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t launch_attend(const CUtensorMap& tqs, const CUtensorMap& tv, const CUtensorMap& tvr,
                          int batch, int h, int w, int sms, cudaStream_t stream) {
  const cudaError_t err = allow_smem(eg1_attend_kernel<NCH>, attend_smem(NCH));
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>(batch) * h * ((w + 63) / 64);
  CDFO_LAUNCH(eg1_attend_kernel<NCH>, dim3(static_cast<unsigned>(units < sms ? units : sms)),
              attend_smem(NCH), stream, tqs, tv, tvr, batch, h, w);
  return cudaGetLastError();
}

// bfloat16: the walk, then the resident row attention (W <= RESIDENT_W) or
// the first design's row pass in two passes
cudaError_t launch_eg1_bf16(const void* x, const void* aq, const void* cq, const void* bv,
                            const void* cv, const void* h9, void* qs, void* vs, void* qc,
                            void* vr, int batch, int h, int w, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  CUtensorMap tx, tqs, tv, tqc, tvr, taq, tbv;
  cudaError_t err;
  if ((err = nhwc_tensor_map(&taq, aq, batch, 1, C, C)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tbv, bv, 1, 1, C, C)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tx, x, batch, h, w, ESTRIP)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tqs, qs, batch, h, w, ESTRIP)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tv, vs, batch, h, w, ESTRIP)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tqc, qc, batch, h, w, ESTRIP)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tvr, vr, batch, h, w, ESTRIP)) != cudaSuccess) {
    return err;
  }
  if ((err = allow_smem(eg1_walk_kernel, WALK_SMEM)) != cudaSuccess) return err;
  const long long units = static_cast<long long>(batch) * ((w + ESTRIP - 1) / ESTRIP) * h;
  CDFO_LAUNCH(eg1_walk_kernel, dim3(static_cast<unsigned>(units < sms ? units : sms)), WALK_SMEM,
              stream, tx, tqs, tv, tqc, taq, tbv, static_cast<const bf16*>(cq),
              static_cast<const bf16*>(cv), static_cast<const float*>(h9), batch, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  switch ((w + 127) / 128) {
    case 1: return launch_attend<1>(tqs, tv, tvr, batch, h, w, sms, stream);
    case 2: return launch_attend<2>(tqs, tv, tvr, batch, h, w, sms, stream);
    case 3: return launch_attend<3>(tqs, tv, tvr, batch, h, w, sms, stream);
    case 4: return launch_attend<4>(tqs, tv, tvr, batch, h, w, sms, stream);
    case 5: return launch_attend<5>(tqs, tv, tvr, batch, h, w, sms, stream);
    default: break;
  }
  if ((err = allow_smem(eg1_rows_wide, rows_smem<bf16>())) != cudaSuccess) return err;
  CDFO_LAUNCH(eg1_rows_wide, dim3((w + QROWS - 1) / QROWS, h, batch), rows_smem<bf16>(), stream,
              static_cast<const bf16*>(qs), static_cast<const bf16*>(vs),
              static_cast<const float*>(h9), static_cast<bf16*>(qc), static_cast<bf16*>(vr), h, w);
  return cudaGetLastError();
}

// float32: the first design
cudaError_t launch_eg2(const void* x, const void* lg, const void* wq, const void* bq,
                       const void* wv, const void* bv, const void* mi, const void* fa,
                       const void* fb, const void* bf, void* out, int batch, int h, int w,
                       cudaStream_t stream) {
  using T = float;
  const cudaError_t err = allow_smem(eg2_local_fuse<T>, eg2_smem<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((w + TW - 1) / TW, h / WS, batch);
  CDFO_LAUNCH(eg2_local_fuse<T>, grid, eg2_smem<T>(), stream, static_cast<const T*>(x),
              static_cast<const T*>(lg), static_cast<const T*>(wq), static_cast<const T*>(bq),
              static_cast<const T*>(wv), static_cast<const T*>(bv), static_cast<const T*>(mi),
              static_cast<const T*>(fa), static_cast<const T*>(fb), static_cast<const T*>(bf),
              static_cast<T*>(out), h, w);
  return cudaGetLastError();
}

}  // namespace

// x, qs, vs, qc, vr: (batch, h, w, 64) NHWC of one dtype (is_bf16: 1
// bfloat16, 0 float32); qs, vs: scratch for the projected q_s and v; cq:
// [batch][64]; cv: [64]; h9: [10] float32 (9 H-band taps, then its bias).
// float32: aq the [batch] per-frame 64 x 64 matrices (out, in) in
// ops/cuda_build.py::kernel_weights' layout, one frame per tap, bv the
// shared matrix in that layout; bfloat16 (all 16-byte aligned): aq (batch,
// 64 n, 64 k) and bv (64 n, 64 k) as B[n][k] = aq[b][k][n], bv[k][n]
// (ops/fused_egla.py::pack_eg1_weights; the walk swizzles them). Two launches
// (projection, rows; in bfloat16 the projection walk with the band, then
// the row attention). Returns a cudaError_t.
extern "C" int cdfo_eg1_rows(const void* x, const void* aq, const void* cq, const void* bv,
                             const void* cv, const void* h9, void* qs, void* vs, void* qc,
                             void* vr, int is_bf16, int batch, int h, int w, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || h > 65535 || w <= 0 ||
      static_cast<long long>(h) * w > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_eg1_bf16(x, aq, cq, bv, cv, h9, qs, vs, qc, vr, batch, h, w, s)
                 : launch_eg1(x, aq, cq, bv, cv, h9, qs, vs, qc, vr, batch, h, w, s);
}

// x, lg (the column stage's output), out: (batch, h, w, 64) NHWC, h and w
// multiples of 8; wq, wv, fa, fb: 64 x 64 matrices, float32 (out, in) in
// kernel_weights' layout, bfloat16 (in, out) as they are (16-byte aligned;
// the walk's TMA loads swizzle them); bq, bv, bf: [64]; mi: [batch][64]
// (1 - mask); all of one dtype. Returns a cudaError_t.
extern "C" int cdfo_eg2_local_fuse(const void* x, const void* lg, const void* wq, const void* bq,
                                   const void* wv, const void* bv, const void* mi, const void* fa,
                                   const void* fb, const void* bf, void* out, int is_bf16,
                                   int batch, int h, int w, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || h % WS != 0 || w % WS != 0 ||
      h / WS > 65535) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_eg2_bf16(x, lg, wq, bq, wv, bv, mi, fa, fb, bf, out, batch, h, w, s)
                 : launch_eg2(x, lg, wq, bq, wv, bv, mi, fa, fb, bf, out, batch, h, w, s);
}
