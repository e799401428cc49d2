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
// the centre is read as center[b / nbr], never broadcast.
//
// Design: one CTA of 8 warps per TH x TW output tile (16 x 16 in bf16, 8 x
// 8 in fp32, by shared memory); in bf16 a warp takes four m-tiles at a
// time, which share each weight fragment. The chain runs on shrinking windows held in
// shared memory, as the TPU kernel holds them in VMEM:
//   xm (TH+8)x(TW+8) gated input -> y1 (TH+6)x(TW+6) -> r1 (TH+4)x(TW+4)
//   -> y2 (TH+2)x(TW+2) -> out TH x TW,
// each stage zeroed outside the image (the next conv's zero padding),
// rounded to the working type as the TPU kernel rounds xm, y1, r1 and y2.

#include "conv3x3_tile.cuh"

namespace {

using namespace cdfo;

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int H = 16, W = 16; };
template <> struct Tile<float> { static constexpr int H = 8, W = 8; };

template <typename T>
constexpr int smem_bytes() {
  constexpr int TH = Tile<T>::H, TW = Tile<T>::W;
  return ((TH + 8) * (TW + 8) + (TH + 6) * (TW + 6) + (TH + 4) * (TW + 4)) * Pitch<T>::value *
         static_cast<int>(sizeof(T));
}

// One conv stage over a rows x cols output window (in_w = cols + 2), MT
// m-tiles per warp (bf16: 4, sharing each weight fragment; the fp32 twin:
// 1); epi(pixel, channel, v0, v1) gets the raw sums.
template <typename T, typename Epi>
__device__ __forceinline__ void stage(const T* in, int rows, int cols, const T* w, int warp,
                                      int lane, Epi&& epi) {
  constexpr int MT = std::is_same<T, bf16>::value ? 4 : 1;
  const int npix = rows * cols, mts = (npix + 15) / 16;
  for (int mt = MT * warp; mt < mts; mt += MT * WARPS) {
    ATile<T> a[MT];
    int ms[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ms[m] = min(mt + m, mts - 1);
      a[m] = a_tile<1>(in, cols + 2, cols, npix, ms[m], lane);
    }
    float acc[MT][8][4];
    zero(acc);
    conv_tiles<3, 3, MT, 8>(acc, a, Weights<T>{w, C, C}, 0, 0, lane);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m == 0 || ms[m] != ms[m - 1]) for_each_pair(acc[m], ms[m], 0, npix, lane, epi);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const T* __restrict__ x, const T* __restrict__ center, const T* __restrict__ gate,
            const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ out, int h,
            int wd, int nbr) {
  constexpr int TH = Tile<T>::H, TW = Tile<T>::W, P = Pitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* xm = reinterpret_cast<T*>(cdfo_smem);       // (TH+8) x (TW+8), origin (r0-4, c0-4)
  T* ys = xm + (TH + 8) * (TW + 8) * P;          // y1, then y2
  T* rs = ys + (TH + 6) * (TW + 6) * P;          // r1, origin (r0-2, c0-2)
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const long long img = static_cast<long long>(b) * h * wd * C;
  const long long cimg = static_cast<long long>(b / nbr) * h * wd * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int WW = C * C;   // elements per 3x3 tap of one conv; a conv is 9 WW

  load_window(xm, x + img, h, wd, r0 - 4, c0 - 4, TH + 8, TW + 8, false);
  __syncthreads();
  for (int i = threadIdx.x; i < (TH + 8) * (TW + 8) * (C / 2); i += blockDim.x) {
    const int pix = i / (C / 2), c = 2 * (i % (C / 2));
    T* p = xm + pix * P + c;
    const float2 v = load2(p), g = load2(gate + b * C + c);
    store2(p, v.x * g.x, v.y * g.y);
  }
  __syncthreads();

  // y1 = relu(conv11(xm) + b11) on (TH+6) x (TW+6), origin (r0-3, c0-3)
  stage(xm, TH + 6, TW + 6, w, warp, lane, [&](int p, int n, float v0, float v1) {
    const int y = r0 - 3 + p / (TW + 6), xx = c0 - 3 + p % (TW + 6);
    const float2 bb = load2(bias + n);
    const bool in = inside(y, xx, h, wd);
    store2(ys + p * P + n, in ? fmaxf(v0 + bb.x, 0.f) : 0.f, in ? fmaxf(v1 + bb.y, 0.f) : 0.f);
  });
  __syncthreads();
  // r1 = xm + conv12(y1) + b12 on (TH+4) x (TW+4), origin (r0-2, c0-2)
  stage(ys, TH + 4, TW + 4, w + 9 * WW, warp, lane, [&](int p, int n, float v0, float v1) {
    const int py = p / (TW + 4), px = p % (TW + 4);
    const float2 bb = load2(bias + C + n);
    const float2 s = load2(xm + ((py + 2) * (TW + 8) + px + 2) * P + n);
    const bool in = inside(r0 - 2 + py, c0 - 2 + px, h, wd);
    store2(rs + p * P + n, in ? v0 + bb.x + s.x : 0.f, in ? v1 + bb.y + s.y : 0.f);
  });
  __syncthreads();
  // y2 = relu(conv21(r1) + b21) on (TH+2) x (TW+2), origin (r0-1, c0-1)
  stage(rs, TH + 2, TW + 2, w + 18 * WW, warp, lane, [&](int p, int n, float v0, float v1) {
    const int y = r0 - 1 + p / (TW + 2), xx = c0 - 1 + p % (TW + 2);
    const float2 bb = load2(bias + 2 * C + n);
    const bool in = inside(y, xx, h, wd);
    store2(ys + p * P + n, in ? fmaxf(v0 + bb.x, 0.f) : 0.f, in ? fmaxf(v1 + bb.y, 0.f) : 0.f);
  });
  __syncthreads();
  // out = r1 + conv22(y2) + b22 + center[b / nbr] on TH x TW
  stage(ys, TH, TW, w + 27 * WW, warp, lane, [&](int p, int n, float v0, float v1) {
    const int py = p / TW, px = p % TW;
    const int y = r0 + py, xx = c0 + px;
    if (y < h && xx < wd) {
      const long long o = (static_cast<long long>(y) * wd + xx) * C + n;
      const float2 bb = load2(bias + 3 * C + n);
      const float2 s = load2(rs + ((py + 2) * (TW + 4) + px + 2) * P + n);
      const float2 cc = load2(center + cimg + o);
      store2(out + img + o, v0 + bb.x + s.x + cc.x, v1 + bb.y + s.y + cc.y);
    }
  });
}

template <typename T>
cudaError_t launch(const void* x, const void* center, const void* gate, const void* w,
                   const void* bias, void* out, int batch, int h, int wd, int nbr,
                   cudaStream_t stream) {
  const cudaError_t err = allow_smem(tail_kernel<T>, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + Tile<T>::W - 1) / Tile<T>::W, (h + Tile<T>::H - 1) / Tile<T>::H, batch);
  CDFO_LAUNCH(tail_kernel<T>, grid, smem_bytes<T>(), stream, static_cast<const T*>(x),
              static_cast<const T*>(center), static_cast<const T*>(gate),
              static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(out), h, wd,
              nbr);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, h, wd, 64) NHWC; center: (batch / nbr, h, wd, 64); gate:
// (batch, 64); w: [4 convs: RB1.conv1, RB1.conv2, RB2.conv1, RB2.conv2][9
// taps][64 out][64 in]; bias: [4][64]. All device pointers of one dtype
// (is_bf16: 1 for bfloat16, 0 for float32). Returns a cudaError_t.
extern "C" int cdfo_fused_tail(const void* x, const void* center, const void* gate,
                               const void* w, const void* bias, void* out, int is_bf16,
                               int batch, int h, int wd, int nbr, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0 || nbr <= 0 || batch % nbr != 0) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, center, gate, w, bias, out, batch, h, wd, nbr, s)
                 : launch<float>(x, center, gate, w, bias, out, batch, h, wd, nbr, s);
}
