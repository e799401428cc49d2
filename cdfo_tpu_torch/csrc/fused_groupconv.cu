// SCGroup tail, out = skip + conv3x3(x) + b, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_groupconv.py::
// conv3x3_residual_hcw (kernel body _kernel), which fused_vjp.grouptail_fused
// launches 7 times per trunk call.
//
// What bounds it: per 1x pixel 64x64x9 MACs (74 KFLOP) against 3 x 128 B
// (x, skip, out in bf16) of device memory: ~190 FLOP/B, under the card's
// ~295 FLOP/B bf16 balance point, so on paper memory-bound; the eager
// version also writes and re-reads the conv output and its bias add. This
// kernel reads x once (a 10 x 34 pixel window per 8 x 32 output tile, so
// ~1.3x with the halo), reads skip once in the epilogue and writes out once.
//
// Design: one CTA of 8 warps per 8 x 32 output tile; warp w computes output
// pixels [32w, 32w + 32) (two m-tiles sharing each weight fragment) x all
// 64 channels with conv3x3_tile.cuh's implicit GEMM (bf16 tensor cores,
// fp32 CUDA-core twin), adds the bias and skip in fp32 and rounds once, as
// the TPU kernel does.

#include "conv3x3_tile.cuh"

namespace {

using namespace cdfo;

constexpr int TH = 8, TW = 32;

template <typename T>
constexpr int smem_bytes() {
  return (TH + 2) * (TW + 2) * Pitch<T>::value * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grouptail_kernel(const T* __restrict__ x, const T* __restrict__ skip, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int h, int wd) {
  extern __shared__ uint4 cdfo_smem[];
  T* xs = reinterpret_cast<T*>(cdfo_smem);
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const long long img = static_cast<long long>(blockIdx.z) * h * wd * C;
  load_window(xs, x + img, h, wd, r0 - 1, c0 - 1, TH + 2, TW + 2, false);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int NPIX = TH * TW;
  static_assert(NPIX == 2 * 16 * WARPS, "two m-tiles per warp");
  const ATile<T> a[2] = {a_tile<1>(xs, TW + 2, TW, NPIX, 2 * warp, lane),
                         a_tile<1>(xs, TW + 2, TW, NPIX, 2 * warp + 1, lane)};
  float acc[2][8][4];
  zero(acc);
  conv_tiles<3, 3, 2, 8>(acc, a, Weights<T>{w, C, C}, 0, 0, lane);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    for_each_pair(acc[m], 2 * warp + m, 0, NPIX, lane, [&](int p, int n, float v0, float v1) {
      const int y = r0 + p / TW, xx = c0 + p % TW;
      if (y < h && xx < wd) {
        const long long o = img + (static_cast<long long>(y) * wd + xx) * C + n;
        const float2 s = load2(skip + o);
        const float2 b = load2(bias + n);
        store2(out + o, v0 + b.x + s.x, v1 + b.y + s.y);
      }
    });
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* skip, const void* w, const void* bias, void* out,
                   int batch, int h, int wd, cudaStream_t stream) {
  const cudaError_t err = allow_smem(grouptail_kernel<T>, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, batch);
  CDFO_LAUNCH(grouptail_kernel<T>, grid, smem_bytes<T>(), stream, static_cast<const T*>(x),
              static_cast<const T*>(skip), static_cast<const T*>(w),
              static_cast<const T*>(bias), static_cast<T*>(out), h, wd);
  return cudaGetLastError();
}

}  // namespace

// x, skip, out: (batch, h, wd, 64) NHWC; w: [9][64 out][64 in] (tap =
// 3*ky + kx); bias: [64]. All device pointers of one dtype (is_bf16: 1 for
// bfloat16, 0 for float32). Returns a cudaError_t (0 = cudaSuccess).
extern "C" int cdfo_grouptail(const void* x, const void* skip, const void* w, const void* bias,
                              void* out, int is_bf16, int batch, int h, int wd, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, skip, w, bias, out, batch, h, wd, s)
                 : launch<float>(x, skip, w, bias, out, batch, h, wd, s);
}
