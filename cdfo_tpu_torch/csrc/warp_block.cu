// The block-gather ring warp, hand-written for Hopper (sm_90a): bilinear,
// zeros-padding, align_corners = True warp of frames picked from a ring by
// per-image flows, out[b] = warp(ring[frame_idx[b]], flow[b]).
//
// Replaces the TPU kernel cdfo_tpu/ops/warp_block.py::_block_warp_call
// (kernel body _kernel) together with the per-pixel gather around it
// (_pixel_fallback) and the device-side choice between them
// (flow_warp_ring_block).
//
// What bounds it: bytes. Per output pixel 128 B are written (bf16) and,
// where the flow moves whole blocks, about as many are read once; nothing
// is computed but 8 multiply-adds per value.
//
// Design: coding-prior flows are constant over 4x4 blocks, so one warp
// takes one 4x4 output block and decides its path itself, on the device,
// from the block's 16 flows: where they are all equal (and the block is
// not in the bottom 4 rows, which the TPU wrapper always computes per
// pixel because the eval pipeline's row padding mixes them), the warp
// reads the block's (5, 5) source patch once, 16 bytes per lane, blends H
// first and W second with the block's two weights and applies the
// per-pixel keep masks (the "patch path", 25 taps for 16 pixels); any
// other block takes the per-pixel 4-tap form of ops/warp.py (64 taps). Lane
// 8t + v holds column t of the block and channels 8v .. 8v+7, so every
// load and store of a pixel is one 128-byte (bf16) warp-quarter
// transaction. The ring is read as it lies, (L, H, W, C) without border:
// a tap outside the image reads as zero by a bounds test. One launch per
// call and no host decision: the TPU's jax.lax.cond on "all flows blocky"
// has no counterpart.
//
// Every product and sum is written without fused multiply-add, in the order
// of the plain version (ops/warp_block.py), so float32 results repeat.

#include "conv3x3_tile.cuh"

namespace {

using namespace cdfo;

constexpr unsigned FULL = 0xffffffffu;

// floor of a source coordinate as an int, held where every pixel of a far
// block still fails the keep test (and the int conversion is defined)
__device__ __forceinline__ int floor_coord(float s, int dim, float& frac) {
  const float f = floorf(s);
  frac = s - f;
  return static_cast<int>(fminf(fmaxf(f, -8.f), static_cast<float>(dim) + 8.f));
}

template <typename T>
__device__ __forceinline__ void tap(const T* __restrict__ src, int y, int x, int h, int w, int c,
                                    float (&v)[8]) {
  if (inside(y, x, h, w)) {
    load8(src + (static_cast<long long>(y) * w + x) * C + c, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
warp_kernel(const T* __restrict__ ring, const int* __restrict__ frame_idx,
            const T* __restrict__ flow, T* __restrict__ out, unsigned char* __restrict__ paths,
            int h, int w, long long total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (blk >= total) return;   // the whole warp leaves together
  const int nbx = w / 4, nby = h / 4;
  const int bx = static_cast<int>(blk % nbx), by = static_cast<int>((blk / nbx) % nby);
  const int bi = static_cast<int>(blk / (static_cast<long long>(nbx) * nby));
  const long long plane = static_cast<long long>(h) * w;
  const T* fl = flow + bi * plane * 2;
  const T* src = ring + __ldg(frame_idx + bi) * plane * C;
  T* dst = out + bi * plane * C;

  // the block's 16 flows, pixel (lane / 4 % 4, lane % 4) in each half warp
  const float2 mine = load2(fl + (static_cast<long long>(4 * by + ((lane >> 2) & 3)) * w + 4 * bx +
                                  (lane & 3)) * 2);
  const float fx = __shfl_sync(FULL, mine.x, 0), fy = __shfl_sync(FULL, mine.y, 0);
  float differs = (mine.x != fx || mine.y != fy) ? 1.f : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) differs = fmaxf(differs, __shfl_xor_sync(FULL, differs, o));
  const bool patch = differs == 0.f && by != nby - 1;
  if (paths != nullptr && lane == 0) paths[blk] = patch ? 1 : 0;

  const int t = lane >> 3, c = 8 * (lane & 7);   // block column, first channel
  if (patch) {
    float wx, wy;
    const int x0 = floor_coord(__fadd_rn(static_cast<float>(4 * bx), fx), w, wx);
    const int y0 = floor_coord(__fadd_rn(static_cast<float>(4 * by), fy), h, wy);
    const float ux = 1.f - wx, uy = 1.f - wy;
    const bool col_keep = x0 + t >= -1 && x0 + t <= w - 1;
    float prev[2][8], cur[2][8];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      tap(src, y0 + i, x0 + t, h, w, c, cur[0]);
      tap(src, y0 + i, x0 + t + 1, h, w, c, cur[1]);
      if (i > 0) {
        const int r = i - 1;
        const bool keep = col_keep && y0 + r >= -1 && y0 + r <= h - 1;
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float h0 = __fadd_rn(__fmul_rn(prev[0][j], uy), __fmul_rn(cur[0][j], wy));
          const float h1 = __fadd_rn(__fmul_rn(prev[1][j], uy), __fmul_rn(cur[1][j], wy));
          o[j] = __fmul_rn(__fadd_rn(__fmul_rn(h0, ux), __fmul_rn(h1, wx)), keep ? 1.f : 0.f);
        }
        store8(dst + (static_cast<long long>(4 * by + r) * w + 4 * bx + t) * C + c, o);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        prev[0][j] = cur[0][j];
        prev[1][j] = cur[1][j];
      }
    }
    return;
  }
#pragma unroll 1
  for (int r = 0; r < 4; ++r) {
    const int y = 4 * by + r, x = 4 * bx + t;
    const float2 f = load2(fl + (static_cast<long long>(y) * w + x) * 2);
    float wx, wy;
    const int x0 = floor_coord(__fadd_rn(static_cast<float>(x), f.x), w, wx);
    const int y0 = floor_coord(__fadd_rn(static_cast<float>(y), f.y), h, wy);
    const float keep = (y0 >= -1 && y0 <= h - 1 && x0 >= -1 && x0 <= w - 1) ? 1.f : 0.f;
    const float ky0 = __fmul_rn(keep, 1.f - wy), ky1 = __fmul_rn(keep, wy);
    // a tap outside the image reads as zero and its weight is zeroed too
    const float w00 = inside(y0, x0, h, w) ? __fmul_rn(ky0, 1.f - wx) : 0.f;
    const float w01 = inside(y0, x0 + 1, h, w) ? __fmul_rn(ky0, wx) : 0.f;
    const float w10 = inside(y0 + 1, x0, h, w) ? __fmul_rn(ky1, 1.f - wx) : 0.f;
    const float w11 = inside(y0 + 1, x0 + 1, h, w) ? __fmul_rn(ky1, wx) : 0.f;
    float v00[8], v01[8], v10[8], v11[8], o[8];
    tap(src, y0, x0, h, w, c, v00);
    tap(src, y0, x0 + 1, h, w, c, v01);
    tap(src, y0 + 1, x0, h, w, c, v10);
    tap(src, y0 + 1, x0 + 1, h, w, c, v11);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v00[j], w00), __fmul_rn(v01[j], w01)),
                                 __fmul_rn(v10[j], w10)),
                       __fmul_rn(v11[j], w11));
    }
    store8(dst + (static_cast<long long>(y) * w + x) * C + c, o);
  }
}

template <typename T>
cudaError_t launch(const void* ring, const int* frame_idx, const void* flow, void* out,
                   unsigned char* paths, int batch, int h, int w, cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * (h / 4) * (w / 4);
  const dim3 grid(static_cast<unsigned>((total + WARPS - 1) / WARPS));
  CDFO_LAUNCH(warp_kernel<T>, grid, 0, stream, static_cast<const T*>(ring), frame_idx,
              static_cast<const T*>(flow), static_cast<T*>(out), paths, h, w, total);
  return cudaGetLastError();
}

}  // namespace

// ring (slots, h, w, 64) and flow (batch, h, w, 2) (dx, dy) of one type
// (is_bf16: 1 for bfloat16, 0 for float32), frame_idx int32 [batch] ring
// slots in [0, slots), out (batch, h, w, 64); h and w multiples of 4.
// paths: null, or bytes [batch][h / 4][w / 4] that receive 1 where a block
// took the patch path. All device pointers. Returns a cudaError_t.
extern "C" int cdfo_warp_block(const void* ring, const void* frame_idx, const void* flow, void* out,
                               void* paths, int is_bf16, int batch, int h, int w, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || h % 4 != 0 || w % 4 != 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(frame_idx);
  unsigned char* pm = static_cast<unsigned char*>(paths);
  return is_bf16 ? launch<bf16>(ring, idx, flow, out, pm, batch, h, w, s)
                 : launch<float>(ring, idx, flow, out, pm, batch, h, w, s);
}
