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
// is computed but 8 multiply-adds per value. The least traffic reads each
// ring slot once: 134 MB of ring, 12.5 MB of flow and 401 MB of output
// for 24 images of a ring of 8 272x480 frames.
//
// Coding-prior flows are constant over 4x4 blocks, so each 4x4 output
// block decides its path itself, on the device, from its 16 flows: where
// they are all equal (and the block is not in the bottom 4 rows, which the
// TPU wrapper always computes per pixel because the eval pipeline's row
// padding mixes them), the block reads its (5, 5) source patch once,
// blends H first and W second with the block's two weights and applies
// the per-pixel keep masks (the "patch path", 25 taps for 16 pixels); any
// other block takes the per-pixel 4-tap form of ops/warp.py (64 taps).
// One launch per call and no host decision: the TPU's jax.lax.cond on
// "all flows blocky" has no counterpart.
//
// bfloat16 (the main path): the blocks are taken in the order (block row,
// block column, image), the image fastest, a warp taking UNITS blocks that
// follow each other (the same place in UNITS images): the images that read
// one ring slot at one place (about 3 of the 24) run within a few warps of
// each other, and the neighbouring places at the same time, so each slot
// comes from device memory about once and its later readers find it in L2.
// (The first design took the blocks image-major: readers of a slot were
// ~80 MB of output apart, more than L2, and each slot came from device
// memory about 3 times. A persistent walk of the same order, a warp
// walking ~90 blocks with its patches 3 ahead, ran at 0.60 ms on an H100:
// 16 warps an SM each waited on its flows and its patch in turn.) A warp loads its
// blocks' flows at once, decides their paths, and lane 0 asks the TMA unit
// for each patch block's 5 x 5 patch as one box (zero outside the frame, as
// the taps need) into a stage of its own; a per-pixel block reads its taps
// from device memory as they fall. Lane 8t + v holds column t of the block
// and channels 8v .. 8v+7, so every load and store of a pixel is one
// 128-byte (bf16) warp-quarter transaction; the rows leave as 16-byte
// stores from the lanes.
// float32 (the twin for the float32 checks) keeps the first design: one
// warp a block, blocks image-major, the patch read by the lanes.
//
// Every product and sum is written without fused multiply-add, in the order
// of the plain version (ops/warp_block.py), so results repeat bit for bit.

#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 kernel, per block of a
// warp: the blocks' flows, paths and TMA issue (once a warp); the wait for
// the block's patch; the blend and the stores.
#include "phase_clocks.cuh"

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

// The block's flow (fx, fy) from its 16 flows (pixel (lane / 4 % 4, lane
// % 4) in each half warp, `mine`), and whether it takes the patch path:
// all 16 equal and the block not in the bottom 4 rows. Every lane gets
// the same answer.
__device__ __forceinline__ bool patch_path(float2 mine, bool bottom, float& fx, float& fy) {
  fx = __shfl_sync(FULL, mine.x, 0);
  fy = __shfl_sync(FULL, mine.y, 0);
  float differs = (mine.x != fx || mine.y != fy) ? 1.f : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) differs = fmaxf(differs, __shfl_xor_sync(FULL, differs, o));
  return differs == 0.f && !bottom;
}

// flow of pixel (lane / 4 % 4, lane % 4) of block (bx, by) of the image's
// flows fl
template <typename T>
__device__ __forceinline__ float2 block_flow(const T* fl, int bx, int by, int w, int lane) {
  return load2(fl + (static_cast<long long>(4 * by + ((lane >> 2) & 3)) * w + 4 * bx + (lane & 3)) *
                        2);
}

// The patch path of block (bx, by) with flow (fx, fy): `patch(i, j, v)`
// gives the 8 channels of this lane at source pixel (y0 + i, x0 + t + j),
// zero outside the frame; rows blended H first and W second, masked per
// pixel, stored to dst.
template <typename T, typename Patch>
__device__ __forceinline__ void patch_block(T* __restrict__ dst, int h, int w, int bx, int by,
                                            int x0, int y0, float wx, float wy, int lane,
                                            Patch&& patch) {
  const int t = lane >> 3, c = 8 * (lane & 7);   // block column, first channel
  const float ux = 1.f - wx, uy = 1.f - wy;
  const bool col_keep = x0 + t >= -1 && x0 + t <= w - 1;
  float prev[2][8], cur[2][8];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    patch(i, 0, cur[0]);
    patch(i, 1, cur[1]);
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
}

// The per-pixel 4-tap path of block (bx, by): each pixel's own flow from fl,
// taps from the frame src (zero outside it), out to dst.
template <typename T>
__device__ __forceinline__ void pixel_block(const T* __restrict__ src, const T* __restrict__ fl,
                                            T* __restrict__ dst, int h, int w, int bx, int by,
                                            int lane) {
  const int t = lane >> 3, c = 8 * (lane & 7);
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

// ---- float32: one warp a block, blocks image-major -------------------------

__global__ void __launch_bounds__(THREADS)
warp_kernel_f32(const float* __restrict__ ring, const int* __restrict__ frame_idx,
                const float* __restrict__ flow, float* __restrict__ out,
                unsigned char* __restrict__ paths, int h, int w, long long total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (blk >= total) return;   // the whole warp leaves together
  const int nbx = w / 4, nby = h / 4;
  const int bx = static_cast<int>(blk % nbx), by = static_cast<int>((blk / nbx) % nby);
  const int bi = static_cast<int>(blk / (static_cast<long long>(nbx) * nby));
  const long long plane = static_cast<long long>(h) * w;
  const float* fl = flow + bi * plane * 2;
  const float* src = ring + __ldg(frame_idx + bi) * plane * C;
  float* dst = out + bi * plane * C;

  float fx, fy;
  const bool patch = patch_path(block_flow(fl, bx, by, w, lane), by == nby - 1, fx, fy);
  if (paths != nullptr && lane == 0) paths[blk] = patch ? 1 : 0;
  if (!patch) {
    pixel_block(src, fl, dst, h, w, bx, by, lane);
    return;
  }
  float wx, wy;
  const int x0 = floor_coord(__fadd_rn(static_cast<float>(4 * bx), fx), w, wx);
  const int y0 = floor_coord(__fadd_rn(static_cast<float>(4 * by), fy), h, wy);
  const int t = lane >> 3, c = 8 * (lane & 7);
  patch_block(dst, h, w, bx, by, x0, y0, wx, wy, lane, [&](int i, int j, float(&v)[8]) {
    tap(src, y0 + i, x0 + t + j, h, w, c, v);
  });
}

// ---- bfloat16: blocks images-fastest, patches by TMA -----------------------

constexpr int PATCH = 5;                          // a block's source patch: 5 x 5 pixels
constexpr int PATCH_BYTES = PATCH * PATCH * C * 2;
constexpr int UNITS = 2;                          // blocks a warp, a patch stage each
constexpr int TMA_CTAS_PER_SM = 4;                // (64 registers a thread)
// the warps' patch stages (each 128-byte aligned), then their mbarriers
constexpr int SMEM_TMA = 128 + WARPS * UNITS * PATCH_BYTES + WARPS * UNITS * 8;
static_assert(PATCH_BYTES % 128 == 0, "128-byte aligned TMA boxes");
static_assert(TMA_CTAS_PER_SM * (SMEM_TMA + 1024) <= 233472, "four CTAs an SM");

// Warp w of CTA c takes blocks u = UNITS (WARPS c + w) .. + UNITS - 1 of
// the order (block row, block column, image), the image fastest: u = ((by
// nbx + bx) batch + b)
__global__ void __launch_bounds__(THREADS, TMA_CTAS_PER_SM)
warp_tma_kernel(const __grid_constant__ CUtensorMap tring, const bf16* __restrict__ ring,
                const int* __restrict__ frame_idx, const bf16* __restrict__ flow,
                bf16* __restrict__ out, unsigned char* __restrict__ paths, int batch, int h,
                int w, long long total) {
  unsigned char* base = dynamic_smem();
  base += (128u - (shared_address(base) & 127u)) & 127u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long u0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * UNITS;
  if (u0 >= total) return;   // the whole warp leaves together
  bf16* stages = reinterpret_cast<bf16*>(base + warp * UNITS * PATCH_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + WARPS * UNITS * PATCH_BYTES) + warp * UNITS;
  if (lane == 0) {
    for (int i = 0; i < UNITS; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  __syncwarp();
  PHASE_START
  const int nbx = w / 4, nby = h / 4;
  const long long plane = static_cast<long long>(h) * w;
  int ub[UNITS], ux[UNITS], uy[UNITS];
  float2 mine[UNITS];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {   // the blocks' flows, all loads in flight at once
    const long long u = u0 + i < total ? u0 + i : u0, blk = u / batch;
    ub[i] = static_cast<int>(u - blk * batch);
    ux[i] = static_cast<int>(blk % nbx);
    uy[i] = static_cast<int>(blk / nbx);
    mine[i] = block_flow(flow + ub[i] * plane * 2, ux[i], uy[i], w, lane);
  }
  // each block's path; a patch block's 5 x 5 patch by one TMA box into
  // its stage (zero outside the frame)
  bool patch[UNITS];
  int x0[UNITS], y0[UNITS];
  float wx[UNITS], wy[UNITS];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    float fx, fy;
    patch[i] = patch_path(mine[i], uy[i] == nby - 1, fx, fy);
    x0[i] = floor_coord(__fadd_rn(static_cast<float>(4 * ux[i]), fx), w, wx[i]);
    y0[i] = floor_coord(__fadd_rn(static_cast<float>(4 * uy[i]), fy), h, wy[i]);
    if (patch[i] && lane == 0 && u0 + i < total) {
      mbar_expect_tx(bars + i, PATCH_BYTES);
      tma_load_row(stages + i * (PATCH_BYTES / 2), &tring, x0[i], y0[i], __ldg(frame_idx + ub[i]),
                   bars + i);
    }
  }
  PHASE(0)
  const int t = lane >> 3, c = 8 * (lane & 7);
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    if (u0 + i >= total) break;
    bf16* dst = out + ub[i] * plane * C;
    if (patch[i]) {   // the same branch for the whole warp
      mbar_wait(bars + i, 0);
      PHASE(1)
      const bf16* p = stages + i * (PATCH_BYTES / 2);
      patch_block(dst, h, w, ux[i], uy[i], x0[i], y0[i], wx[i], wy[i], lane,
                  [&](int r, int j, float(&v)[8]) { load8(p + (r * PATCH + t + j) * C + c, v); });
    } else {
      PHASE(1)
      pixel_block(ring + __ldg(frame_idx + ub[i]) * plane * C, flow + ub[i] * plane * 2, dst, h,
                  w, ux[i], uy[i], lane);
    }
    if (paths != nullptr && lane == 0) {
      paths[(static_cast<long long>(ub[i]) * nby + uy[i]) * nbx + ux[i]] = patch[i] ? 1 : 0;
    }
    PHASE(2)
    PHASE_STEP
  }
  PHASE_END
}

cudaError_t launch_f32(const void* ring, const int* frame_idx, const void* flow, void* out,
                       unsigned char* paths, int batch, int h, int w, cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * (h / 4) * (w / 4);
  const dim3 grid(static_cast<unsigned>((total + WARPS - 1) / WARPS));
  CDFO_LAUNCH(warp_kernel_f32, grid, 0, stream, static_cast<const float*>(ring), frame_idx,
              static_cast<const float*>(flow), static_cast<float*>(out), paths, h, w, total);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* ring, const int* frame_idx, const void* flow, void* out,
                        unsigned char* paths, int slots, int batch, int h, int w,
                        cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * (h / 4) * (w / 4);
  cudaError_t err = allow_smem(warp_tma_kernel, SMEM_TMA);
  if (err != cudaSuccess) return err;
  CUtensorMap tring;
  if ((err = nhwc_tensor_map(&tring, ring, slots, h, w, PATCH, PATCH, false)) != cudaSuccess) {
    return err;
  }
  const long long per_cta = static_cast<long long>(WARPS) * UNITS;
  const dim3 grid(static_cast<unsigned>((total + per_cta - 1) / per_cta));
  CDFO_LAUNCH(warp_tma_kernel, grid, SMEM_TMA, stream, tring, static_cast<const bf16*>(ring),
              frame_idx, static_cast<const bf16*>(flow), static_cast<bf16*>(out), paths, batch, h,
              w, total);
  return cudaGetLastError();
}

}  // namespace

// ring (slots, h, w, 64) and flow (batch, h, w, 2) (dx, dy) of one type
// (is_bf16: 1 for bfloat16, 0 for float32), frame_idx int32 [batch] ring
// slots in [0, slots), out (batch, h, w, 64); h and w multiples of 4.
// paths: null, or bytes [batch][h / 4][w / 4] that receive 1 where a block
// took the patch path. All device pointers. Returns a cudaError_t.
extern "C" int cdfo_warp_block(const void* ring, const void* frame_idx, const void* flow, void* out,
                               void* paths, int is_bf16, int slots, int batch, int h, int w,
                               void* stream) {
  if (slots <= 0 || batch <= 0 || h <= 0 || w <= 0 || h % 4 != 0 || w % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(frame_idx);
  unsigned char* pm = static_cast<unsigned char*>(paths);
  return is_bf16 ? launch_bf16(ring, idx, flow, out, pm, slots, batch, h, w, s)
                 : launch_f32(ring, idx, flow, out, pm, batch, h, w, s);
}
