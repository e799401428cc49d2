// Per-token self-attention for EGLA's long-range stages, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_attention.py::_pallas_forward
// (kernel body _kernel), which token_self_attention and
// column_self_attention launch on a TPU.
//
// out[t] = softmax(q[t] q[t]^T) v[t] for every token t; q and v hold N
// positions of D = 64 channels. There is no 1/sqrt(D) scale. Scores, the
// running max and the running sum are fp32; the probabilities are rounded to
// the input type before the P.V product, as the TPU kernel rounds p.
//
// What bounds it: about 2*T*N^2*128 FLOP (Q.K^T and P.V), i.e. ~64 GFLOP
// for the row stage (T = 4*272 tokens, N = 480) and ~36 GFLOP for the column
// stage (T = 4*480, N = 272) of one 4-frame engine step, against a few
// hundred MB of q/v/out traffic: compute, not memory. The plain PyTorch
// version also writes and reads back the (T, N, N) fp32 scores, ~1.0 GB
// (row) and ~0.57 GB (column) per step; this kernel never writes them.
//
// Design, simple first: one CTA of 256 threads per (token, 64-query tile),
// looping over 64-key tiles with an online softmax (a full score row is
// N*4 bytes, and 64 such rows do not fit in shared memory). Each thread owns
// a 4x4 block of the 64x64 score tile and the same 4 rows x 4 channels of
// the output; the 16 threads that share rows form one half-warp, so the row
// max and sum are shuffles. The products are fp32 FMAs on the CUDA cores:
// the main path calls the kernel with fp32 operands. The ragged edge (N not
// a multiple of 64) is masked.
//
// Token t starts at element (t / n_inner) * s_outer + (t % n_inner) * s_inner
// and its positions are pos_stride elements apart, so the column stage reads
// NHWC (M, H, W, C) in place, with no transpose through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][LDS]  qt[c][row]
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

template <typename T>
cudaError_t launch(const void* q, const void* v, void* out, long long n_tokens,
                   long long n_inner, long long s_outer, long long s_inner, int n,
                   long long pos_stride, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      token_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_tokens), static_cast<unsigned>((n + BQ - 1) / BQ));
  token_attention_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<T*>(out), n_inner,
      s_outer, s_inner, n, pos_stride);
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
  return is_bf16 ? launch<__nv_bfloat16>(q, v, out, n_tokens, n_inner, s_outer, s_inner, n,
                                         pos_stride, s)
                 : launch<float>(q, v, out, n_tokens, n_inner, s_outer, s_inner, n,
                                 pos_stride, s);
}

extern "C" const char* cdfo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
