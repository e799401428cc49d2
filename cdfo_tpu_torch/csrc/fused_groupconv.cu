// SCGroup tail, out = skip + conv3x3(x) + b, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_groupconv.py::
// conv3x3_residual_hcw (kernel body _kernel), which fused_vjp.grouptail_fused
// launches 7 times per trunk call.
//
// What bounds it: per 1x pixel 64x64x9 MACs (74 KFLOP) against 3 x 128 B
// (x, skip, out in bf16) of device memory: ~190 FLOP/B, under the card's
// ~295 FLOP/B bf16 balance point, so on paper memory-bound (0.060 ms at
// (4, 272, 480, 64)); the eager version also writes and re-reads the conv
// output and its bias add. This kernel reads x and skip once (x with a
// 64 / 62 horizontal halo) and writes out once; the conv + b + skip is
// summed in fp32 and rounded once, as the TPU kernel does.
//
// bfloat16 (the main path), on wgmma (`wgmma_tile.cuh`). The first design
// (one CTA of 8 warps per 8 x 32 tile over a 10 x 34 window, 1.33x reads
// of x, the 3x3 on mma.sync with every weight fragment from device memory
// in every warp, the skip read pixel pair by pixel pair in the epilogue)
// ran at 5x its bound. Now a persistent walk down 62-column strips
// (`StripStep`, one CTA an SM), two output rows a step, one per
// warpgroup:
// - x's window rows (64 pixels, 128-byte swizzled) arrive two steps ahead
//   by the TMA unit (`tma_load_row`, zero outside the image) into a ring of
//   eight (the step's four and the next two steps' four), the skip rows of
//   the step's outputs with them, so that neither the products nor the
//   epilogue wait on device memory; the vertical halo is fetched once per
//   walk (its warm-up step). (Fetched by cp.async, one step ahead, a
//   step's 2048 16-byte copies took ~1.5k cycles to issue, and ptxas's
//   wgmma issue left nothing to hide them under.)
// - The conv is `conv3x3_row`: 9 taps x 4 k16 of m64n64 `wgmma`, pixels as
//   A in window coordinates straight from the ring, the 72 KB of weights
//   as B, resident (one bulk copy a CTA).
// - The epilogue adds b + skip in fp32 and rounds once, in place of the
//   skip row, and one thread a warpgroup stores the row by the TMA unit
//   (`tma_store_row`: 62 pixels, none past the image).
// float32 (the twin for the float32 checks) keeps the first design, one
// CTA of 8 warps per 8 x 32 tile, conv3x3_tile.cuh's implicit GEMM on the
// CUDA cores.

#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 walk, summed over a CTA's
// steps: the wait for the step's rows at its barrier, the conv's products,
// the epilogue and the store's issue.
#include "phase_clocks.cuh"

namespace {

using namespace cdfo;

// ---- float32: one CTA per 8 x 32 tile --------------------------------------

constexpr int TH = 8, TW = 32;

constexpr int smem_bytes_f32() {
  return (TH + 2) * (TW + 2) * Pitch<float>::value * static_cast<int>(sizeof(float));
}

__global__ void __launch_bounds__(THREADS)
grouptail_kernel_f32(const float* __restrict__ x, const float* __restrict__ skip,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     float* __restrict__ out, int h, int wd) {
  using T = float;
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

// ---- bfloat16: the walk on wgmma -------------------------------------------

constexpr int TILE = STRIP_WIN * C;       // bf16 of a 64-pixel window row
constexpr int ROW_BYTES = TILE * 2;
constexpr int RING = 8;                   // x rows: the step's four, the next two steps' four
constexpr int WBYTES = 9 * C * C * 2;     // the 3x3 weights, resident
// weights | x ring (+ 8 pixel rows past it: the taps' overread, alignment) |
// skip rows, then the output rows in their place, [3 steps][2 rows] |
// mbarriers: the weights', one a step of the three in flight
constexpr int SMEM_BF16 = 1024 + WBYTES + (RING * TILE + 8 * C) * 2 + 6 * ROW_BYTES + 32;
static_assert(WBYTES % 1024 == 0 && ROW_BYTES % 1024 == 0, "1024-byte aligned tiles");
static_assert(SMEM_BF16 <= 232448, "one block's shared memory");

__global__ void __launch_bounds__(THREADS, 1)
grouptail_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tskip,
                       const __grid_constant__ CUtensorMap tout, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, int batch, int h, int wd) {
  extern __shared__ uint4 cdfo_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(cdfo_smem);
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* ws = reinterpret_cast<bf16*>(base);   // [9 taps][64 n][64 k], swizzled
  bf16* ring = ws + 9 * C * C;                 // x's window rows, swizzled
  bf16* sk = ring + RING * TILE + 8 * C;       // skip rows, then the output rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(sk + 6 * TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int strips = (wd + STRIP - 1) / STRIP;
  const long long total = static_cast<long long>(batch) * strips * h;
  const long long g0 = blockIdx.x * total / gridDim.x, g1 = (blockIdx.x + 1) * total / gridDim.x;
  if (g0 >= g1) return;

  // step t's rows, by the TMA unit on mbarrier 1 + t % 3: x's window rows
  // j, j + 1 (ring rows 2t, 2t + 1) and the skip rows of output rows
  // j - 1, j (set t % 3; a warm-up's are not used)
  auto fetch = [&](const StripStep& s, int t) {
    uint64_t* bar = bars + 1 + t % 3;
    mbar_expect_tx(bar, 4 * ROW_BYTES);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tma_load_row(ring + ((2 * t + r) % RING) * TILE, &tx, s.c0 - 1, s.j + r, s.b, bar);
      tma_load_row(sk + (2 * (t % 3) + r) * TILE, &tskip, s.c0, s.j - 1 + r, s.b, bar);
    }
  };

  StripStep s = strip_walk_at(g0, g1, h, strips), n1, n2;
  bool more1 = strip_next(s, g1, h, strips, n1);
  bool more2 = more1 && strip_next(n1, g1, h, strips, n2);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, WBYTES);
    bulk_copy(ws, w, WBYTES, bars);
    fetch(s, 0);
    if (more1) fetch(n1, 1);
  }
  float2 bv[8];   // the bias of this lane's channels 8 jj + t2, + 1
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) bv[jj] = load2(bias + 8 * jj + t2);
  __syncthreads();
  mbar_wait(bars, 0);

  int t = 0;   // the CTA's step count
  PHASE_START
#pragma unroll 1
  while (true) {
    mbar_wait(bars + 1 + t % 3, static_cast<uint32_t>((t / 3) & 1));
    bulk_wait_read();   // the last step's output rows have left shared memory
    __syncthreads();
    PHASE(0)
    if (threadIdx.x == 0 && more2) fetch(n2, t + 2);
    if (s.j >= s.a) {   // past the walk's warm-up (the same branch for the whole CTA)
      // this warpgroup's output row y = j - 1 + wg, from window rows y - 1 .. y + 1
      float acc[8][4];
      conv3x3_row(acc, ring + ((2 * t - 2 + wg) % RING) * TILE,
                  ring + ((2 * t - 1 + wg) % RING) * TILE, ring + ((2 * t + wg) % RING) * TILE,
                  ws);
      wgmma_wait<0>();
      keep(acc);
      PHASE(1)
      // out = acc + b + skip, rounded once, in place of the skip row; then
      // one thread of the warpgroup stores the row's 62 pixels by the TMA
      // unit (those past the image are skipped)
      const int y = s.j - 1 + wg;
      bf16* row = sk + (2 * (t % 3) + wg) * TILE;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = 16 * wl + g + 8 * half;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          bf16* p = swizzled(row, q, 8 * jj + t2);
          const float2 sv = load2(p);
          store2(p, acc[jj][2 * half] + bv[jj].x + sv.x, acc[jj][2 * half + 1] + bv[jj].y + sv.y);
        }
      }
      async_fence();
      warpgroup_sync(wg);
      if ((threadIdx.x & 127) == 0 && y < s.e) {
        tma_store_row(&tout, row, s.c0, y, s.b);
        bulk_commit();
      }
      PHASE(2)
    }
    if (!more1) break;
    s = n1;
    n1 = n2;
    more1 = more2;
    more2 = more1 && strip_next(n1, g1, h, strips, n2);
    ++t;
    PHASE_STEP
  }
  bulk_wait_read();
  PHASE_END
}

cudaError_t launch_f32(const void* x, const void* skip, const void* w, const void* bias, void* out,
                       int batch, int h, int wd, cudaStream_t stream) {
  const cudaError_t err = allow_smem(grouptail_kernel_f32, smem_bytes_f32());
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, batch);
  CDFO_LAUNCH(grouptail_kernel_f32, grid, smem_bytes_f32(), stream, static_cast<const float*>(x),
              static_cast<const float*>(skip), static_cast<const float*>(w),
              static_cast<const float*>(bias), static_cast<float*>(out), h, wd);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* skip, const void* w, const void* bias,
                        void* out, int batch, int h, int wd, cudaStream_t stream) {
  cudaError_t err = allow_smem(grouptail_wgmma_kernel, SMEM_BF16);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  CUtensorMap tx, tskip, tout;
  if ((err = nhwc_tensor_map(&tx, x, batch, h, wd, STRIP_WIN)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tskip, skip, batch, h, wd, STRIP_WIN)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tout, out, batch, h, wd, STRIP)) != cudaSuccess) {
    return err;
  }
  const long long units = static_cast<long long>(batch) * ((wd + STRIP - 1) / STRIP) * h;
  const dim3 grid(static_cast<unsigned>(units < sms ? units : sms));
  CDFO_LAUNCH(grouptail_wgmma_kernel, grid, SMEM_BF16, stream, tx, tskip, tout,
              static_cast<const bf16*>(w), static_cast<const bf16*>(bias), batch, h, wd);
  return cudaGetLastError();
}

}  // namespace

// x, skip, out: (batch, h, wd, 64) NHWC (bfloat16: 16-byte aligned); bias: [64]. w: float32 [9][64
// out][64 in] (tap = 3*ky + kx); bfloat16 the 9 taps as
// ops/fused_groupconv.py::pack_grouptail_weights gives them ([9][64 n][64
// k], 128-byte swizzled). All device pointers of one dtype (is_bf16: 1 for
// bfloat16, 0 for float32). Returns a cudaError_t (0 = cudaSuccess).
extern "C" int cdfo_grouptail(const void* x, const void* skip, const void* w, const void* bias,
                              void* out, int is_bf16, int batch, int h, int wd, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(x, skip, w, bias, out, batch, h, wd, s)
                 : launch_f32(x, skip, w, bias, out, batch, h, wd, s);
}
