// Shared tile routines of the port's convolution kernels, hand-written for
// Hopper (sm_90a): the fused_*.cu sources include this header and nothing
// else of each other.
//
// Every activation a kernel reads is NHWC with C = 64 channels. A CTA of 8
// warps copies the pixel windows it needs from device memory into shared
// memory, one pixel every `Pitch<T>` elements (64 channels plus padding, so
// the 8 pixel rows of an mma fragment fall on distinct banks), and computes
// convolutions on them as implicit GEMMs:
//
//   out[p][n] += sum_{ky, kx, c} in[(py*S + ky) * in_w + px*S + kx][c]
//                                 * w[ky*KW + kx][n][c]
//
// M = output pixels (16 per m-tile), N = output channels (8 per n-tile),
// K = taps x 64 input channels, walked 16 channels at a time. One warp owns
// MT m-tiles and NT n-tiles (`conv_tiles`); the m-tiles may come from
// different windows (an `ATile` each) as long as they share the weights.
// Its accumulators are the mma C-fragment: lane (g = lane/4, t = lane%4)
// holds pixels 16*mt + g and 16*mt + g + 8, channels 8*nt + 2t and
// 8*nt + 2t + 1.
//
// bfloat16: `mma.sync.m16n8k16` on the tensor cores, fp32 accumulate. A
// fragments come from shared memory by `ldmatrix`; B fragments (weights)
// straight from device memory through L1/L2, since every CTA reads the
// same few hundred KB (or, `mma_tap_smem`, from one tap staged in shared
// memory): the host packs them in fragment order (`Weights`), so one n-tile
// is one coalesced 8-byte load per lane, used by all MT m-tiles.
// float32: the same tiling with the products on the CUDA cores (each lane
// computes exactly the fragment elements it holds) and the weights in
// plain [tap][N][K] order, so a float32 run differs from a float32
// reference only in summation order.
// int8 (`s8`, fused_block2_q.cu): `mma.sync.m16n8k32` s8 x s8 -> s32 on
// windows of one byte per channel, 80 bytes per pixel; the same ldmatrix
// addressing serves (a 16-byte row is 16 channels), K walks 32 channels at
// a time, and the weights come in the k32 B-fragment order
// (ops/fused_block2_q.py::kernel_weights_s8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cdfo {

constexpr int C = 64;          // channels of every activation a tile holds
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

using bf16 = __nv_bfloat16;
using s8 = int8_t;

template <typename T> struct Pitch;
template <> struct Pitch<float> { static constexpr int value = 68; };  // 272 B
template <> struct Pitch<bf16> { static constexpr int value = 72; };   // 144 B
template <> struct Pitch<s8> { static constexpr int value = 80; };     // 80 B

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 8 consecutive channels (16-byte aligned); a bf16 is the top half of the
// float with the same bits
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(b))) << 16);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : 0.1f * x; }

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

// tests/test_torch_kernel_emulation.py compiles the kernels for the host
// with its own mma16816, ldsm_x4 and cp.async (CDFO_HOST_MMA) and launch
// (CDFO_LAUNCH)
#ifndef CDFO_HOST_MMA
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without a register round trip; completion by
// cp_async_wait
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group 0;\n"); }

// the four 8x8 b16 matrices whose rows lanes 0-7, 8-15, 16-23, 24-31 point at
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// s8 x s8 -> s32, K = 32: lane 4g + t holds A rows g, g + 8 (k 4t .. 4t+3
// and 16+4t .. 16+4t+3, one byte each), B column g (same k) and C rows g,
// g + 8, columns 2t, 2t+1
__device__ __forceinline__ void mma16832(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
#endif

// Weights of one convolution, [tap][N out][K in] in float32; in bfloat16
// the mma B-fragment order [tap][K/16][N/8][lane][4] (lane = 4g + t holds
// n = 8nt + g, k = 16kt + 2t, 2t+1, 2t+8, 2t+9), see
// ops/cuda_build.py::kernel_weights.
template <typename T>
struct Weights {
  const T* p;
  int n;   // N, all output channels
  int k;   // K per tap, all input channels
};

// One lane's view of one m-tile of a convolution's input window: bfloat16
// and int8: the ldmatrix row (pixel 16*mt + lane%8 + 8*(lane/8 % 2), byte
// 16*(lane/16) of its channels); float32: pixel rows g and g + 8. Pixels past n_pix repeat
// the last one and are never stored.
template <typename T>
struct ATile {
  const T* p0;
  const T* p1;
  int in_w;
};

template <int S, typename T>
__device__ __forceinline__ ATile<T> a_tile(const T* in, int in_w, int out_w, int n_pix, int mt,
                                           int lane) {
  constexpr int P = Pitch<T>::value;
  auto at = [&](int row) {
    row = min(row, n_pix - 1);
    return in + ((row / out_w) * S * in_w + (row % out_w) * S) * P;
  };
  if constexpr (!std::is_same<T, float>::value) {
    const T* p = at(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) +
                 (lane >> 4) * (16 / static_cast<int>(sizeof(T)));
    return {p, p, in_w};
  } else {
    return {at(mt * 16 + (lane >> 2)), at(mt * 16 + (lane >> 2) + 8), in_w};
  }
}

// acc[m][nt] += A_m (16 x 16) . B (16 x 8) for MT m-tiles (A_m at a[m] +
// off[m]) and n-tiles nt0 .. nt0+NT-1 of tap `tap`, k-tile kt.
template <int MT, int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT][4], const ATile<bf16> (&a)[MT],
                                        const int (&off)[MT], const Weights<bf16>& w, int tap,
                                        int kt, int nt0, int lane) {
  uint32_t af[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) ldsm_x4(af[m], a[m].p0 + off[m]);
  const uint2* b = reinterpret_cast<const uint2*>(w.p) +
                   ((tap * (w.k >> 4) + kt) * (w.n >> 3) + nt0) * 32 + lane;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint2 bv = __ldg(b + nt * 32);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma16816(acc[m][nt], af[m][0], af[m][1], af[m][2], af[m][3], bv.x, bv.y);
    }
  }
}

// One tap of a convolution with the tap's weights already in shared memory
// (B fragments [K/16 = 4][NT][lane], i.e. Weights order for N = 8*NT,
// K = 64, one tap): acc[m] += A_m . B with A_m at a[m] + off[m].
template <int MT, int NT>
__device__ __forceinline__ void mma_tap_smem(float (&acc)[MT][NT][4], const ATile<bf16> (&a)[MT],
                                             const int (&off)[MT], const bf16* w, int lane) {
  const uint2* b = reinterpret_cast<const uint2*>(w) + lane;
#pragma unroll
  for (int kt = 0; kt < C / 16; ++kt) {
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(af[m], a[m].p0 + off[m] + kt * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 bv = b[(kt * NT + nt) * 32];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma16816(acc[m][nt], af[m][0], af[m][1], af[m][2], af[m][3], bv.x, bv.y);
      }
    }
  }
}

// The int8 forms: acc[m][nt] += A_m (16 x 32) . B (32 x 8) with one tap's
// weights in shared memory (B fragments [K/32 = 2][NT][lane], 8 bytes each) ...
template <int MT, int NT>
__device__ __forceinline__ void mma_tap_smem(int (&acc)[MT][NT][4], const ATile<s8> (&a)[MT],
                                             const int (&off)[MT], const s8* w, int lane) {
  const uint2* b = reinterpret_cast<const uint2*>(w) + lane;
#pragma unroll
  for (int kt = 0; kt < C / 32; ++kt) {
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(af[m], a[m].p0 + off[m] + kt * 32);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 bv = b[(kt * NT + nt) * 32];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma16832(acc[m][nt], af[m][0], af[m][1], af[m][2], af[m][3], bv.x, bv.y);
      }
    }
  }
}

// ... and a warp's share of a KH x KW convolution over 64 int8 input
// channels (k0 .. k0+63 of the weights), weights from device memory.
template <int KH, int KW, int MT, int NT>
__device__ __forceinline__ void conv_tiles(int (&acc)[MT][NT][4], const ATile<s8> (&a)[MT],
                                           const Weights<s8>& w, int n0, int k0, int lane) {
  constexpr int P = Pitch<s8>::value;
#pragma unroll 1
  for (int ky = 0; ky < KH; ++ky) {
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) {
#pragma unroll
      for (int kc = 0; kc < C; kc += 32) {
        uint32_t af[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) ldsm_x4(af[m], a[m].p0 + (ky * a[m].in_w + kx) * P + kc);
        const uint2* b = reinterpret_cast<const uint2*>(w.p) +
                         (((ky * KW + kx) * (w.k >> 5) + ((k0 + kc) >> 5)) * (w.n >> 3) + (n0 >> 3)) * 32 +
                         lane;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 bv = __ldg(b + nt * 32);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma16832(acc[m][nt], af[m][0], af[m][1], af[m][2], af[m][3], bv.x, bv.y);
          }
        }
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT][4], const ATile<float> (&a)[MT],
                                        const int (&off)[MT], const Weights<float>& w, int tap,
                                        int kt, int nt0, int lane) {
  const int t2 = (lane & 3) * 2;
  const float* wr = w.p + (static_cast<long long>(tap) * w.n + nt0 * 8 + t2) * w.k + kt * 16;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int k = 0; k < 16; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(a[m].p0 + off[m] + k);
      const float4 y = *reinterpret_cast<const float4*>(a[m].p1 + off[m] + k);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* w0 = wr + nt * 8 * w.k + k;
        const float4 u = __ldg(reinterpret_cast<const float4*>(w0));
        const float4 v = __ldg(reinterpret_cast<const float4*>(w0 + w.k));
        float* c = acc[m][nt];
        c[0] = fmaf(x.x, u.x, fmaf(x.y, u.y, fmaf(x.z, u.z, fmaf(x.w, u.w, c[0]))));
        c[1] = fmaf(x.x, v.x, fmaf(x.y, v.y, fmaf(x.z, v.z, fmaf(x.w, v.w, c[1]))));
        c[2] = fmaf(y.x, u.x, fmaf(y.y, u.y, fmaf(y.z, u.z, fmaf(y.w, u.w, c[2]))));
        c[3] = fmaf(y.x, v.x, fmaf(y.y, v.y, fmaf(y.z, v.z, fmaf(y.w, v.w, c[3]))));
      }
    }
  }
}

template <typename A, int MT, int NT>
__device__ __forceinline__ void zero(A (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0;
}

// One warp's share of a KH x KW convolution over 64 input channels (input
// channels k0 .. k0+63 of the weights): MT m-tiles (`a`, made by a_tile,
// which holds the stride) x output channels n0 .. n0 + 8*NT - 1.
template <int KH, int KW, int MT, int NT, typename T>
__device__ __forceinline__ void conv_tiles(float (&acc)[MT][NT][4], const ATile<T> (&a)[MT],
                                           const Weights<T>& w, int n0, int k0, int lane) {
  constexpr int P = Pitch<T>::value;
#pragma unroll 1
  for (int ky = 0; ky < KH; ++ky) {
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) {
#pragma unroll
      for (int kc = 0; kc < C; kc += 16) {
        int off[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) off[m] = (ky * a[m].in_w + kx) * P + kc;
        mma_k16<MT, NT>(acc, a, off, w, ky * KW + kx, (k0 + kc) >> 4, n0 >> 3, lane);
      }
    }
  }
}

// Calls f(pixel, channel, v0, v1) for each pair of adjacent channels
// (channel, channel + 1) this lane holds, pixel < n_pix; channels count
// from n0. v0 and v1 are the accumulators themselves (f may take them by
// reference when acc is not const).
template <int NT, typename A, typename F>
__device__ __forceinline__ void for_each_pair(A (&acc)[NT][4], int mt, int n0, int n_pix, int lane,
                                              F&& f) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int p0 = mt * 16 + g, p8 = p0 + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + t2;
    if (p0 < n_pix) f(p0, n, acc[nt][0], acc[nt][1]);
    if (p8 < n_pix) f(p8, n, acc[nt][2], acc[nt][3]);
  }
}

// Copies the rows x cols pixel window whose top-left pixel is (y0, x0) of
// the (h, w) image at `src` into shared memory at `dst`, 16 bytes at a
// time. Pixels outside the image read as 0, or with `clamp` as the nearest
// edge pixel (the bilinear resizes' border rule).
template <typename T>
__device__ void load_window(T* dst, const T* __restrict__ src, int h, int w, int y0, int x0,
                            int rows, int cols, bool clamp) {
  constexpr int V = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int VP = C / V;           // vectors per pixel
  constexpr int P = Pitch<T>::value;
  const int n = rows * cols * VP;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = i % VP, pix = i / VP;
    int y = y0 + pix / cols, x = x0 + pix % cols;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (clamp) {
      y = min(max(y, 0), h - 1);
      x = min(max(x, 0), w - 1);
    }
    if (inside(y, x, h, w)) {
      val = __ldg(reinterpret_cast<const uint4*>(src + (static_cast<long long>(y) * w + x) * C) + v);
    }
    *reinterpret_cast<uint4*>(dst + pix * P + v * V) = val;
  }
}

// Sets every pixel of a rows x cols shared-memory window whose image
// position (y0 + row, x0 + col) lies outside [0, h) x [0, w) to 0: the
// zero padding of the next convolution.
template <typename T>
__device__ void mask_window(T* buf, int h, int w, int y0, int x0, int rows, int cols) {
  constexpr int P = Pitch<T>::value;
  for (int i = threadIdx.x; i < rows * cols * (C / 2); i += blockDim.x) {
    const int pix = i / (C / 2), c = 2 * (i % (C / 2));
    if (!inside(y0 + pix / cols, x0 + pix % cols, h, w)) store2(buf + pix * P + c, 0.f, 0.f);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The SMs of the current device, -1 if it cannot be asked
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return -1;
  }
  return sms;
}

}  // namespace cdfo

#ifndef CDFO_LAUNCH
#define CDFO_LAUNCH(kernel, grid, smem, stream, ...) \
  kernel<<<(grid), cdfo::THREADS, (smem), (stream)>>>(__VA_ARGS__)
#endif
// a launch of another thread count
#ifndef CDFO_LAUNCH_N
#define CDFO_LAUNCH_N(kernel, grid, threads, smem, stream, ...) \
  kernel<<<(grid), (threads), (smem), (stream)>>>(__VA_ARGS__)
#endif
// a launch of a kernel whose CTAs run in clusters of `cluster` (the
// kernel's __cluster_dims__; grid a multiple of it)
#ifndef CDFO_LAUNCH_CLUSTER
#define CDFO_LAUNCH_CLUSTER(kernel, grid, cluster, smem, stream, ...) \
  kernel<<<(grid), cdfo::THREADS, (smem), (stream)>>>(__VA_ARGS__)
#endif
// a launch of `threads` threads a CTA in clusters of `cluster` CTAs given
// at launch (a kernel without __cluster_dims__; grid a multiple of it)
#ifndef CDFO_LAUNCH_CLUSTER_N
namespace cdfo {
template <typename... P, typename... A>
cudaError_t launch_clusters(void (*kernel)(P...), dim3 grid, int cluster, int threads, int smem,
                            cudaStream_t stream, A... args) {
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = static_cast<unsigned>(cluster);
  dims.val.clusterDim.y = 1;
  dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = &dims;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}
}  // namespace cdfo
#define CDFO_LAUNCH_CLUSTER_N(kernel, grid, cluster, threads, smem, stream, ...) \
  cdfo::launch_clusters((kernel), (grid), (cluster), (threads), (smem), (stream), __VA_ARGS__)
#endif

// Each library is one translation unit that includes this header once.
extern "C" const char* cdfo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
