// The SCNet Block_ body pair, hand-written for Hopper (sm_90a):
//   out = conv2(lrelu(conv1 x + b1)) + b2 (+ x)
// with conv1 a 3x3 conv 64 -> 256, conv2 a 3x3 conv 256 -> 64, both with
// zero padding 1, lrelu slope 0.1.
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_block.py::block_body_hcw
// (kernel body _body_kernel), which fused_block_body runs for
// tools/microbench_trunk.py; no model path launches it.
//
// What bounds it: operations. 2 * 9 * (64 * 256 + 256 * 64) = 589,824 FLOP
// per pixel against 2 x 128 B of x and out (bf16): 3.08e11 FLOP at
// (4, 272, 480, 64), 0.311 ms at 989 TFLOP/s, against 0.040 ms of bytes.
// The eager pair writes and reads the 256-channel y (4x the bytes of x)
// through device memory; this kernel keeps it on chip.
//
// Design: the 1x branch of fused_block2.cu without the off-scale windows.
// One CTA of 8 warps per 8 x 16 output tile; shared memory holds
//   xs  (8+4) x (16+4)  x, zero outside the image      [r0-2, c0-2]
//   y1  (8+2) x (16+2)  lrelu(conv1 xs + b1), one chunk [r0-1, c0-1]
// The 256 mid channels are walked in 4 chunks of 64: the conv1 phase fills
// y1 with the chunk's channels (zeroed outside the image: conv2's zero
// padding), the conv2 phase adds the chunk's part of conv2 to fp32
// accumulators that each warp keeps in registers across the chunks. In
// the conv1 phase a warp takes 3 of y1's 12 m-tiles x 32 channels, in the
// conv2 phase 2 of the output's 8 m-tiles x 32 channels: both phases
// split evenly over the 8 warps. The weights come from device memory in
// mma-fragment order through L1/L2 (conv3x3_tile.cuh's conv_tiles).
// Rounding is the TPU kernel's: y1 is stored in the working type, b2 and
// the residual are added to conv2's fp32 sum before the one output
// rounding.

#include "conv3x3_tile.cuh"

namespace {

using namespace cdfo;

constexpr int R = 8, S = 16;                  // output tile rows x columns
constexpr int XR = R + 4, XC = S + 4;         // x window
constexpr int YR = R + 2, YC = S + 2;         // y1 window
constexpr int CM = 4 * C;                     // mid channels
constexpr int NY = (YR * YC + 15) / 16;       // y1 m-tiles (12)
constexpr int NO = R * S / 16;                // output m-tiles (8)
constexpr int MT1 = NY / 4, MT2 = NO / 4;     // m-tiles per warp: 3, 2
static_assert(NY % 4 == 0 && NO % 4 == 0, "4 m-groups x 2 channel halves");

template <typename T>
constexpr int smem_bytes() {
  return (XR * XC + YR * YC) * Pitch<T>::value * static_cast<int>(sizeof(T));
}

// bf16 keeps to 128 registers so that two CTAs share an SM; the fp32 twin's
// CUDA-core products need more
template <typename T> struct Occupancy { static constexpr int value = 1; };
template <> struct Occupancy<bf16> { static constexpr int value = 2; };

template <typename T>
__global__ void __launch_bounds__(THREADS, Occupancy<T>::value)
body_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
            const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int h,
            int wd, int residual) {
  constexpr int P = Pitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* xs = reinterpret_cast<T*>(cdfo_smem);
  T* y1 = xs + XR * XC * P;

  const int r0 = blockIdx.y * R, c0 = blockIdx.x * S;
  const long long img = static_cast<long long>(blockIdx.z) * h * wd * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mg = warp & 3, half = (warp >> 2) * 32;   // m-group, channel half

  load_window(xs, x + img, h, wd, r0 - 2, c0 - 2, XR, XC, false);
  const Weights<T> wt1{w1, CM, C}, wt2{w2, C, CM};
  ATile<T> a1[MT1], a2[MT2];
#pragma unroll
  for (int m = 0; m < MT1; ++m) a1[m] = a_tile<1>(xs, XC, YC, YR * YC, mg * MT1 + m, lane);
#pragma unroll
  for (int m = 0; m < MT2; ++m) a2[m] = a_tile<1>(y1, YC, S, R * S, mg * MT2 + m, lane);
  float acc2[MT2][4][4];
  zero(acc2);
  __syncthreads();

#pragma unroll 1
  for (int ch = 0; ch < 4; ++ch) {
    // conv1 phase: y1 = lrelu(conv1 + b1) of this chunk, 0 outside the image
    float acc1[MT1][4][4];
    zero(acc1);
    conv_tiles<3, 3, MT1, 4>(acc1, a1, wt1, ch * C + half, 0, lane);
#pragma unroll
    for (int m = 0; m < MT1; ++m) {
      for_each_pair(acc1[m], mg * MT1 + m, half, YR * YC, lane, [&](int p, int n, float v0, float v1) {
        const bool in = inside(r0 - 1 + p / YC, c0 - 1 + p % YC, h, wd);
        const float2 bb = load2(b1 + ch * C + n);
        store2(y1 + p * P + n, in ? lrelu(v0 + bb.x) : 0.f, in ? lrelu(v1 + bb.y) : 0.f);
      });
    }
    __syncthreads();
    // conv2 phase: the chunk's 64 input channels of conv2
    conv_tiles<3, 3, MT2, 4>(acc2, a2, wt2, half, ch * C, lane);
    __syncthreads();
  }

  // out = conv2 + b2 (+ x), rounded once
#pragma unroll
  for (int m = 0; m < MT2; ++m) {
    for_each_pair(acc2[m], mg * MT2 + m, half, R * S, lane, [&](int p, int n, float v0, float v1) {
      const int py = p / S, px = p % S;
      const int y = r0 + py, xx = c0 + px;
      if (y >= h || xx >= wd) return;
      const float2 bb = load2(b2 + n);
      float o0 = v0 + bb.x, o1 = v1 + bb.y;
      if (residual) {
        const float2 xv = load2(xs + ((py + 2) * XC + px + 2) * P + n);
        o0 += xv.x;
        o1 += xv.y;
      }
      store2(out + img + (static_cast<long long>(y) * wd + xx) * C + n, o0, o1);
    });
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int batch, int h, int wd, int residual,
                   cudaStream_t stream) {
  const cudaError_t err = allow_smem(body_kernel<T>, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + S - 1) / S, (h + R - 1) / R, batch);
  CDFO_LAUNCH(body_kernel<T>, grid, smem_bytes<T>(), stream, static_cast<const T*>(x),
              static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
              static_cast<const T*>(b2), static_cast<T*>(out), h, wd, residual);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, h, wd, 64) NHWC; w1 [9][256][64] and w2 [9][64][256] in
// the Weights layout of conv3x3_tile.cuh, b1 [256], b2 [64]. All device
// pointers of one dtype (is_bf16: 1 for bfloat16, 0 for float32);
// residual: 1 adds x to the output. Returns a cudaError_t.
extern "C" int cdfo_fused_block(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int is_bf16, int batch, int h, int wd,
                                int residual, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, w1, b1, w2, b2, out, batch, h, wd, residual, s)
                 : launch<float>(x, w1, b1, w2, b2, out, batch, h, wd, residual, s);
}
