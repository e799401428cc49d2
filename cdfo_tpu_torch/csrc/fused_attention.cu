// Per-token self-attention for EGLA's long-range stages, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_attention.py::_pallas_forward
// (kernel body _kernel), which token_self_attention and
// column_self_attention launch on a TPU.
//
// out[t] = softmax(q[t] q[t]^T) v[t] for every token t; q and v hold N
// positions of D = 64 channels. There is no 1/sqrt(D) scale. Scores and the
// softmax are fp32; the normalised probabilities p = e / sum(e) are rounded
// to the input type before the P.V product, as the TPU kernel rounds p.
//
// What bounds it: about 2*T*N^2*128 FLOP (Q.K^T and P.V), i.e. ~64 GFLOP
// for the row stage (T = 4*272 tokens, N = 480) and ~36 GFLOP for the column
// stage (T = 4*480, N = 272) of one 4-frame engine step, against ~200 MB of
// q/v/out traffic: at the bf16 tensor-core rate the bytes set the bound
// (~0.06 ms at the column stage). The plain PyTorch version also writes and
// reads back the (T, N, N) fp32 scores; no kernel here writes them.
//
// What held the first kernel back in bf16 (1.98 ms against SDPA's 0.28 at
// the column stage): both products as fp32 FMAs on the CUDA cores, and K
// and V re-read for every 64-query tile. The bf16 routes run on the tensor
// cores with the whole token resident in shared memory: K (= q) and V, N x
// 64 bf16 each, copied in once by cp.async, 16 bytes a chunk, each 128-byte
// position row with its chunks XOR-swizzled by (row & 7) (ldmatrix rows on
// distinct banks, and the 128-byte swizzle a wgmma reads).
//
// bfloat16, N <= 272 (`tc_wgmma_kernel`, the main path's column stage): one
// warpgroup per token, 64-query tiles on wgmma. Q.K^T reads both operands
// from the resident K rows (m64n136k16 twice a k-step); the 64 x 272
// scores stay in registers, so each score takes one exp; p = e / sum(e) is
// rounded to bf16 in registers and P.V runs as m64n64k16 with A = p from
// registers and B = V read MN-major.
//
// bfloat16, N > 272 (`tc_two_pass_kernel`, the row stage, N = 480): one CTA
// of 8 warps per token (per 8 strips past 512 positions, reloading chunks
// of 512), each warp a 16-row query strip at a time on mma.sync.m16n8k16:
// Q as the A operand and, through ldmatrix on the K rows, the B operand of
// Q.K^T with no transpose; V as B of P.V through ldmatrix.trans. Its scores
// do not fit in registers, so it takes two passes over the keys: the row
// max and sum of exp (64 keys at a time), then the scores again, p = exp(s
// - max) / sum rounded to bf16, and P.V.
//
// Both round the normalised p, as the TPU kernel does (the first kernel
// rounded exp(s - running max) and divided at the end). Keys past N score
// -inf and read zero rows; positions past N are never stored.
//
// float32 (`token_attention_kernel`, the unfused EGLA's stages): the
// simple first kernel, kept for the float32 checks. One CTA of 256 threads
// per (token, 64-query tile), looping over 64-key tiles with an online
// softmax; each thread owns a 4x4 block of the 64x64 score tile and the
// same 4 rows x 4 channels of the output, as fp32 FMAs on the CUDA cores.
//
// Token t starts at element (t / n_inner) * s_outer + (t % n_inner) * s_inner
// and its positions are pos_stride elements apart, so the column stage reads
// NHWC (M, H, W, C) in place, with no transpose through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gram_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int D = 64;         // channels per position
constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // key rows per tile
constexpr int LDS = 68;       // padded shared row, in floats (272 B: float4-aligned)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 elements each
constexpr int SMEM_BYTES = static_cast<int>(sizeof(float)) * LDS * (D + D + BK + BK);

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// x rounded to the precision of the pointee type
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
token_attention_kernel(const T* __restrict__ q, const T* __restrict__ v,
                       T* __restrict__ out, long long n_inner, long long s_outer,
                       long long s_inner, int n, long long pos_stride) {
  extern __shared__ uint4 cdfo_smem[];
  float* qt = reinterpret_cast<float*>(cdfo_smem);  // [D][LDS]  qt[c][row]
  float* kt = qt + D * LDS;                     // [D][LDS]  kt[c][key]
  float* vs = kt + D * LDS;                     // [BK][LDS] vs[key][c]
  float* pt = vs + BK * LDS;                    // [BK][LDS] pt[key][row]

  const long long tok = blockIdx.x;
  const long long base = (tok / n_inner) * s_outer + (tok % n_inner) * s_inner;
  const T* qb = q + base;
  const T* vb = v + base;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;  // keys, then channels, 4*tx .. 4*tx+3

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int pos = q0 + r;
    qt[c * LDS + r] = pos < n ? load_f(qb + pos * pos_stride + c) : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // qt is written; the previous tile's kt/vs/pt are read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int pos = k0 + r;
      const bool ok = pos < n;
      const long long off = pos * pos_stride + c;
      kt[c * LDS + r] = ok ? load_f(qb + off) : 0.f;
      vs[r * LDS + c] = ok ? load_f(vb + off) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qt + c * LDS + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(kt + c * LDS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + 4 * tx + j >= n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
      }
    }

    // online softmax: every 64-key tile holds at least one valid key, so
    // the tile max is finite and exp(-inf - m_new) = 0 on the first tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        s[i][j] = round_as(p, q);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * LDS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(pt + kk * LDS + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(vs + kk * LDS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < n) {
      T* o = out + base + row * pos_stride + 4 * tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) store_f(o + j, acc[i][j] / l[i]);
    }
  }
}

// ---- bfloat16: tensor cores, the token resident -----------------------------

// the mma, ldmatrix and cp.async helpers are named unqualified in the
// functions below (a function-scope `using namespace cdfo`), as the host
// emulation of tests/test_torch_kernel_emulation.py supplies its own
using cdfo::allow_smem;
using cdfo::bf16;
using cdfo::pack_bf16x2;

constexpr int CH = 512;          // positions of K and V resident at once
constexpr int TWO_PASS_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int tc_rows(int n) { return n < CH ? round16(n) : CH; }
// K and V of up to tc_rows(n) positions, 128 bytes each
__host__ __device__ constexpr int tc_smem_bytes(int n) { return 2 * tc_rows(n) * D * 2; }

// element offset of (row, channel) in a swizzled [rows][64] bf16 buffer:
// 16-byte chunk c of row r sits at chunk c ^ (r & 7)
__host__ __device__ constexpr int swz(int r, int c) {
  return r * D + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

#ifndef CDFO_HOST_MMA
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
#endif

// This lane's ldmatrix row offsets within a 16-key tile (a tile starts at a
// multiple of 8 rows, so the swizzle depends on the lane alone): K for
// k-step ks of Q.K^T (keys (lane & 7) + 8 (lane >> 4 & 1), channels
// 16 ks + 8 (lane >> 3 & 1)), V for n-tiles 2p, 2p + 1 of P.V (keys
// (lane & 7) + 8 (lane >> 3 & 1), channels 16p + 8 (lane >> 4 & 1)).
struct LaneRows {
  int k[4];
  int v[4];
};
__device__ __forceinline__ LaneRows lane_rows(int lane) {
  LaneRows r;
  const int kr = (lane & 7) + ((lane >> 4) & 1) * 8, vr = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.k[i] = swz(kr, 16 * i + ((lane >> 3) & 1) * 8);
    r.v[i] = swz(vr, 16 * i + ((lane >> 4) & 1) * 8);
  }
  return r;
}

// copies positions p0 .. p0 + rows - 1 of the token's K (= q) and V into
// shared memory; positions past n are zero
__device__ void tc_load(bf16* ks, bf16* vs, const bf16* qb, const bf16* vb, int p0, int rows,
                        int n, long long pos_stride) {
  using namespace cdfo;
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8, pos = p0 + r;
    bf16* kd = ks + swz(r, c);
    bf16* vd = vs + swz(r, c);
    if (pos < n) {
      const long long off = pos * pos_stride + c;
      cp_async16(kd, qb + off);
      cp_async16(vd, vb + off);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
  cp_async_wait();
  __syncthreads();
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// the A fragments of query rows q0 .. q0 + 15 (zero past n)
__device__ __forceinline__ void load_q(uint32_t (&qa)[4][4], const bf16* qb, int q0, int n,
                                       long long pos_stride, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const bf16* r0 = qb + (q0 + g) * pos_stride + t2;
  const bf16* r8 = r0 + 8 * pos_stride;
  const bool ok0 = q0 + g < n, ok8 = q0 + g + 8 < n;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qa[k][0] = ld_pair(r0 + 16 * k, ok0);
    qa[k][1] = ld_pair(r8 + 16 * k, ok8);
    qa[k][2] = ld_pair(r0 + 16 * k + 8, ok0);
    qa[k][3] = ld_pair(r8 + 16 * k + 8, ok8);
  }
}

// the same from the token's rows resident in shared memory (ks = its K,
// which is q): ldmatrix rows q0 + (lane & 7) + 8 (lane >> 3 & 1), channels
// 16k + 8 (lane >> 4)
__device__ __forceinline__ void load_q_smem(uint32_t (&qa)[4][4], const bf16* ks, int q0,
                                            int lane) {
  using namespace cdfo;
  const int r = q0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) ldsm_x4(qa[k], ks + swz(r, 16 * k + (lane >> 4) * 8));
}

// s[0], s[1] = the raw scores of this warp's 16 queries against keys
// 16kk .. 16kk + 7 and + 8 .. + 15 (kt = the tile's K rows); keys at or
// past `valid` score -inf
__device__ __forceinline__ void tc_scores(float (&s)[2][4], const uint32_t (&qa)[4][4],
                                          const bf16* kt, const LaneRows& lr, int kk, int valid,
                                          int lane) {
  using namespace cdfo;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t b[4];
    ldsm_x4(b, kt + lr.k[k]);
    mma16816(s[0], qa[k][0], qa[k][1], qa[k][2], qa[k][3], b[0], b[1]);
    mma16816(s[1], qa[k][0], qa[k][1], qa[k][2], qa[k][3], b[2], b[3]);
  }
  if (16 * kk + 16 > valid) {   // the ragged last tile
    const int k0 = 16 * kk + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + 8 * j + (i & 1) >= valid) s[j][i] = -INFINITY;
      }
  }
}

// o += round(p) V for one 16-key tile: p[j] the normalised probabilities
// of its two n-tiles (rows g: [0], [1]; g + 8: [2], [3]), vt its V rows
__device__ __forceinline__ void tc_pv(float (&o)[8][4], const float (&p)[2][4], const bf16* vt,
                                      const LaneRows& lr) {
  using namespace cdfo;
  const uint32_t a0 = pack_bf16x2(p[0][0], p[0][1]), a1 = pack_bf16x2(p[0][2], p[0][3]);
  const uint32_t a2 = pack_bf16x2(p[1][0], p[1][1]), a3 = pack_bf16x2(p[1][2], p[1][3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t b[4];
    ldsm_x4_trans(b, vt + lr.v[i]);
    mma16816(o[2 * i], a0, a1, a2, a3, b[0], b[1]);
    mma16816(o[2 * i + 1], a0, a1, a2, a3, b[2], b[3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_o(bf16* ob, const float (&o)[8][4], int q0, int n,
                                        long long pos_stride, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + g + 8 * h;
    if (row >= n) continue;
    bf16* dst = ob + row * pos_stride + t2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt) =
          __floats2bfloat162_rn(o[nt][2 * h], o[nt][2 * h + 1]);
    }
  }
}

// N <= WG_KEYS (the column stage, N = 272), on wgmma: one CTA of one
// warpgroup per token, K (= q) and V resident in 128-byte swizzled rows
// from a 1024-byte aligned base, which is the canonical wgmma tile: 64-row
// query tiles (the last one moved back to end at row WG_KEYS, its rows
// before 64i recomputed and not stored). Q.K^T is two m64n136k16 products
// per k-step with A (the query rows) and B (the keys) both read from the K
// rows in shared memory; the 64 x 272 scores stay in registers (136 a
// thread); the row max, e = exp2((s - max) log2 e) and its sum; then P.V
// as 17 m64n64k16 products with A = p = e / sum rounded to bf16, built in
// registers from the score fragments, and B = V MN-major. Keys past N score
// -inf and read zero rows.
constexpr int WG_KEYS = 272;
constexpr int WG_BYTES = 2 * WG_KEYS * D * 2 + 1024;   // K, V and the alignment

__global__ void __launch_bounds__(128, 2)
tc_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                bf16* __restrict__ out, long long n_inner, long long s_outer,
                long long s_inner, int n, long long pos_stride) {
  using namespace cdfo;
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(cdfo_smem);
  smem += (1024u - (shared_address(smem) & 1023u)) & 1023u;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + WG_KEYS * D;
  const long long tok = blockIdx.x;
  const long long base = (tok / n_inner) * s_outer + (tok % n_inner) * s_inner;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  tc_load(ks, vs, q + base, v + base, 0, WG_KEYS, n, pos_stride);
  const uint64_t kdesc0 = wgmma_desc(ks), kdesc1 = wgmma_desc(ks + 136 * D);
#pragma unroll 1
  for (int i = 0; i < (n + 63) / 64; ++i) {
    const int start = min(64 * i, WG_KEYS - 64);
    float sc[2][17][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 17; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[h][nt][e] = 0.f;
    keep(sc);
    const uint64_t qdesc = wgmma_desc(ks + start * D);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_ss_64x136(sc[0], qdesc + 2 * k, kdesc0 + 2 * k);
      wgmma_ss_64x136(sc[1], qdesc + 2 * k, kdesc1 + 2 * k);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(sc);
    // this lane's scores: rows g (elements 0, 1) and g + 8 (2, 3), keys
    // 8 nt + 2t, +1 of n-tile nt = 17 h + j
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 17; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * (17 * h + j) + t2 + e;
            float& x = sc[h][j][2 * r + e];
            if (key >= n) x = -INFINITY;
            mx[j & 3] = fmaxf(mx[j & 3], x);
          }
      // finite: every row has key 0
      ml[r] = quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))) * LOG2E;
    }
    float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 17; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[h][j][e] = ex2(fmaf(sc[h][j][e], LOG2E, -ml[e >> 1]));
          sum[e >> 1][j & 3] += sc[h][j][e];
        }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = 1.f / quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
    }
    // the A fragments of P.V: key step kk takes n-tiles 2kk, 2kk + 1
    uint32_t pa[17][4];
#pragma unroll
    for (int kk = 0; kk < 17; ++kk) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * kk + u;
        const float* e = sc[nt / 17][nt % 17];
        pa[kk][2 * u] = pack_bf16x2(e[0] * inv[0], e[1] * inv[0]);
        pa[kk][2 * u + 1] = pack_bf16x2(e[2] * inv[1], e[3] * inv[1]);
      }
    }
    float o[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    keep(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 17; ++kk) {
      wgmma_64x64_tb(o, pa[kk], wgmma_desc(vs + 16 * kk * D, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(o);
    keep(pa);
    // rows 64i .. (this tile's new rows) of the warp's 16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = start + 16 * warp + g + 8 * r;
      if (row < 64 * i || row >= n) continue;
      bf16* dst = out + base + row * pos_stride + t2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt) =
            __floats2bfloat162_rn(o[nt][2 * r], o[nt][2 * r + 1]);
      }
    }
  }
}

// Any N (the row stage, N = 480, and longer tokens): one CTA of 8 warps per
// token (per 8 strips past CH positions), two passes over the keys.
__global__ void __launch_bounds__(32 * TWO_PASS_WARPS, 2)
tc_two_pass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                   bf16* __restrict__ out, long long n_inner, long long s_outer,
                   long long s_inner, int n, long long pos_stride, int rounds) {
  extern __shared__ uint4 cdfo_smem[];
  const int rows = tc_rows(n);
  bf16* ks = reinterpret_cast<bf16*>(cdfo_smem);
  bf16* vs = ks + rows * D;
  const long long tok = blockIdx.x;
  const long long base = (tok / n_inner) * s_outer + (tok % n_inner) * s_inner;
  const bf16* qb = q + base;
  const bf16* vb = v + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = (n + CH - 1) / CH;
  const int nstrips = (n + 15) / 16;
  const LaneRows lr = lane_rows(lane);
  if (nchunks == 1) tc_load(ks, vs, qb, vb, 0, rows, n, pos_stride);

#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const int strip = (blockIdx.y * rounds + r) * TWO_PASS_WARPS + warp;
    const bool active = strip < nstrips;   // a warp without a strip still loads
    const int q0 = 16 * strip;
    uint32_t qa[4][4];
    if (nchunks == 1) {
      load_q_smem(qa, ks, active ? q0 : 0, lane);
    } else {
      load_q(qa, qb, active ? q0 : n, n, pos_stride, lane);
    }
    // pass 1: row max m (log2 units) and sum l of exp2(s log2 e - m), rows
    // g (0) and g + 8 (1), 64 keys at a time
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll 1
    for (int c = 0; c < nchunks; ++c) {
      const int valid = min(CH, n - c * CH);
      if (nchunks > 1) {
        __syncthreads();
        tc_load(ks, vs, qb, vb, c * CH, rows, n, pos_stride);
      }
      if (!active) continue;
      const int nkk = (valid + 15) / 16;
#pragma unroll 1
      for (int kk0 = 0; kk0 < nkk; kk0 += 4) {
        float s[4][2][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (kk0 + u < nkk) {
            tc_scores(s[u], qa, ks + (kk0 + u) * 16 * D, lr, kk0 + u, valid, lane);
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) s[u][j][i] = -INFINITY;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 2; ++j) mx = fmaxf(mx, fmaxf(s[u][j][2 * h], s[u][j][2 * h + 1]));
          // finite: the 64 keys hold at least one valid one
          mx = fmaxf(m[h], quad_max(mx) * LOG2E);
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              sum += ex2(fmaf(s[u][j][2 * h], LOG2E, -mx)) +
                     ex2(fmaf(s[u][j][2 * h + 1], LOG2E, -mx));
          l[h] = l[h] * ex2(m[h] - mx) + sum;
          m[h] = mx;
        }
      }
    }
    const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
    // pass 2: o = round(p) V with p = exp2(s log2 e - m) / l
    float o[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nchunks; ++c) {
      const int valid = min(CH, n - c * CH);
      if (nchunks > 1) {
        __syncthreads();
        tc_load(ks, vs, qb, vb, c * CH, rows, n, pos_stride);
      }
      if (!active) continue;
      const int nkk = (valid + 15) / 16;
#pragma unroll 2
      for (int kk = 0; kk < nkk; ++kk) {
        float p[2][4];
        tc_scores(p, qa, ks + kk * 16 * D, lr, kk, valid, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[j][i] = ex2(fmaf(p[j][i], LOG2E, -m[i >> 1])) * inv[i >> 1];
          }
        tc_pv(o, p, vs + kk * 16 * D, lr);
      }
    }
    if (active) store_o(out + base, o, q0, n, pos_stride, lane);
  }
}

cudaError_t launch_tc(const void* q, const void* v, void* out, long long n_tokens,
                      long long n_inner, long long s_outer, long long s_inner, int n,
                      long long pos_stride, cudaStream_t stream) {
  const int bytes = tc_smem_bytes(n);
  const auto qp = static_cast<const bf16*>(q);
  const auto vp = static_cast<const bf16*>(v);
  const auto op = static_cast<bf16*>(out);
  if (n <= WG_KEYS) {
    const cudaError_t err = allow_smem(tc_wgmma_kernel, WG_BYTES);
    if (err != cudaSuccess) return err;
    CDFO_LAUNCH_N(tc_wgmma_kernel, dim3(static_cast<unsigned>(n_tokens)), 128, WG_BYTES, stream,
                  qp, vp, op, n_inner, s_outer, s_inner, n, pos_stride);
    return cudaGetLastError();
  }
  const cudaError_t err = allow_smem(tc_two_pass_kernel, bytes);
  if (err != cudaSuccess) return err;
  // the token resident: one CTA walks all its strips; else one CTA per 8
  // strips, each reloading the chunks
  const int strips = (n + 15) / 16;
  const int per_cta = n <= CH ? strips : TWO_PASS_WARPS;
  const int rounds = (per_cta + TWO_PASS_WARPS - 1) / TWO_PASS_WARPS;
  const dim3 grid(static_cast<unsigned>(n_tokens),
                  static_cast<unsigned>((strips + per_cta - 1) / per_cta));
  CDFO_LAUNCH_N(tc_two_pass_kernel, grid, 32 * TWO_PASS_WARPS, bytes, stream, qp, vp, op,
                n_inner, s_outer, s_inner, n, pos_stride, rounds);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* v, void* out, long long n_tokens,
                   long long n_inner, long long s_outer, long long s_inner, int n,
                   long long pos_stride, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      token_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_tokens), static_cast<unsigned>((n + BQ - 1) / BQ));
  CDFO_LAUNCH(token_attention_kernel<T>, grid, SMEM_BYTES, stream, static_cast<const T*>(q),
              static_cast<const T*>(v), static_cast<T*>(out), n_inner, s_outer, s_inner, n,
              pos_stride);
  return cudaGetLastError();
}

}  // namespace

// q, v, out: device pointers to the first element; is_bf16: 1 for bfloat16,
// 0 for float32. Returns a cudaError_t (0 = cudaSuccess).
extern "C" int cdfo_fused_attention(const void* q, const void* v, void* out, int is_bf16,
                                    long long n_tokens, long long n_inner,
                                    long long s_outer, long long s_inner, int n,
                                    long long pos_stride, void* stream) {
  if (n_tokens <= 0 || n_tokens > 0x7fffffffLL || n_inner <= 0 || n <= 0 ||
      (n + BQ - 1) / BQ > 65535) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_tc(q, v, out, n_tokens, n_inner, s_outer, s_inner, n, pos_stride, s)
                 : launch<float>(q, v, out, n_tokens, n_inner, s_outer, s_inner, n,
                                 pos_stride, s);
}
