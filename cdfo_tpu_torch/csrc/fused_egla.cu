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
// softmax in fp32, p rounded to the working type); and the H-band q_c[g] =
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
// Design, simple first. eg1 is two launches under one call: a projection
// pass writes q_s and v in the working type to scratch that the wrapper
// allocates, and a row pass reads them. Its CTA holds 128 queries of one row
// (16 per warp) and walks the row's keys in 64-key tiles with an online
// softmax: a 480 x 480 fp32 score row does not fit in shared memory (the TPU
// kept it in VMEM). The same CTA computes the H-band of its 128 positions
// from the 9 rows of q_s in device memory. The scratch costs ~130 MB of
// traffic (~0.04 ms) but rounds q_s and v exactly where the TPU kernel's VMEM
// scratch does and keeps each pass a plain tile loop; recomputing each key
// tile's projection inside the key loop would cost ~8x the projection FLOPs.
// eg2 is one launch: a CTA holds two windows (an 8 x 16 pixel tile, one
// 16-pixel m-tile per warp) and projects q and v on conv3x3_tile.cuh's tile
// routine; each warp then takes 16 queries of one window against its 64 keys
// (one tile, so the softmax is exact), and the fusion GEMMs run on the tile
// routine again. x, long, q, v and loc never leave shared memory.
// bf16: mma.sync.m16n8k16 with fp32 accumulators. Q Kᵀ reads both factors
// by ldmatrix (K = q: the keys are the queries' own rows); P V takes P from
// the score fragments in registers and V by ldmatrix.trans. fp32: the same
// fragments on the CUDA cores, P passed across the quad by shuffles.

#include <math.h>

#include "gram_tile.cuh"

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

// Grid (query tiles of 128 along W, H, frames).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
eg1_rows(const T* __restrict__ qs, const T* __restrict__ vs, const float* __restrict__ h9,
         T* __restrict__ qc, T* __restrict__ vr, int h, int w) {
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
  for (int i = threadIdx.x; i < QROWS * (C / 8); i += THREADS) {
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
  float o[NCT][4];
  clear(o);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll 1
  for (int k0 = 0; k0 < w; k0 += KT) {
    __syncthreads();  // the queries are in; the previous tile is read
    load_window(kt, qs + img_base, h, w, g, k0, 1, KT, false);
    load_window(vt, vs + img_base, h, w, g, k0, 1, KT, false);
    __syncthreads();
    float s[NKT][4];
    clear(s);
    scores<T>(s, qrow, krow, lane);
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * nt + t2 + (e & 1) >= w) s[nt][e] = -INFINITY;
    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3): every tile
    // holds a key of the row, so the tile max is finite and the first
    // tile's rescale exp(-inf) is 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      const float m_new = fmaxf(m_run[r], quad_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - m_new);
          sum += s[nt][e];
        }
      l_run[r] = l_run[r] * alpha + quad_sum(sum);
      m_run[r] = m_new;
#pragma unroll
      for (int nt = 0; nt < NCT; ++nt) {
        o[nt][2 * r] *= alpha;
        o[nt][2 * r + 1] *= alpha;
      }
    }
    attend<T>(o, s, vrow, lane);
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

template <typename T>
cudaError_t launch_eg1(const void* x, const void* aq, const void* cq, const void* bv,
                       const void* cv, const void* h9, void* qs, void* vs, void* qc, void* vr,
                       int batch, int h, int w, cudaStream_t stream) {
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

template <typename T>
cudaError_t launch_eg2(const void* x, const void* lg, const void* wq, const void* bq,
                       const void* wv, const void* bv, const void* mi, const void* fa,
                       const void* fb, const void* bf, void* out, int batch, int h, int w,
                       cudaStream_t stream) {
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
// bfloat16, 0 float32); qs, vs: scratch for the projected q_s and v; aq:
// [batch] per-frame 64 x 64 matrices (out, in) in ops/cuda_build.py::
// kernel_weights' layout, one frame per tap; bv: the shared matrix in that
// layout; cq: [batch][64]; cv: [64]; h9: [10] float32 (9 H-band taps, then
// its bias). Two launches (projection, rows). Returns a cudaError_t.
extern "C" int cdfo_eg1_rows(const void* x, const void* aq, const void* cq, const void* bv,
                             const void* cv, const void* h9, void* qs, void* vs, void* qc,
                             void* vr, int is_bf16, int batch, int h, int w, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || h > 65535 || w <= 0 ||
      static_cast<long long>(h) * w > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_eg1<bf16>(x, aq, cq, bv, cv, h9, qs, vs, qc, vr, batch, h, w, s)
                 : launch_eg1<float>(x, aq, cq, bv, cv, h9, qs, vs, qc, vr, batch, h, w, s);
}

// x, lg (the column stage's output), out: (batch, h, w, 64) NHWC, h and w
// multiples of 8; wq, wv, fa, fb: 64 x 64 matrices (out, in) in
// kernel_weights' layout; bq, bv, bf: [64]; mi: [batch][64] (1 - mask); all
// of one dtype. Returns a cudaError_t.
extern "C" int cdfo_eg2_local_fuse(const void* x, const void* lg, const void* wq, const void* bq,
                                   const void* wv, const void* bv, const void* mi, const void* fa,
                                   const void* fb, const void* bf, void* out, int is_bf16,
                                   int batch, int h, int w, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || h % WS != 0 || w % WS != 0 ||
      h / WS > 65535) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_eg2<bf16>(x, lg, wq, bq, wv, bv, mi, fa, fb, bf, out, batch, h, w, s)
                 : launch_eg2<float>(x, lg, wq, bq, wv, bv, mi, fa, fb, bf, out, batch, h, w, s);
}
