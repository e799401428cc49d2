// The patch-gather probe of the block warp, hand-written for Hopper
// (sm_90a): how fast many small strided copies into shared memory run with
// several in flight, against one large streaming copy.
//
// Replaces the TPU probe tools/microbench_dma.py::main (kernels
// _gather_kernel and _big_kernel), which sized the TPU's block-gather warp:
//   gather  nblk patches of (ph, pw*c) bf16 of a ring (H+8, (W+8)*c) at
//           per-patch (y, x) starts, 8 copies in flight, out (1, 128) f32 =
//           the sum over patches of lanes 0-127 of the patch's row 0;
//   big     one contiguous copy of `rows` rows from row starts[0]; out =
//           lanes 0-127 of the first row.
//
// What bounds them: bytes, every byte of every patch read once (3.35 TB/s;
// at the tool's defaults the 17.5 MB ring fits the 50 MB L2, so the rate
// it reaches can pass device memory's).
//
// Design. A CTA owns a contiguous range of patches (gather) or of 8 KB
// pieces of the region (big) and copies each one whole into a ring of
// stages in shared memory with cp.async, 16 bytes a thread, `stages` of
// them in flight (8, or fewer where 8 patches do not fit 200 KB); the
// checksum reads the staged copy, as _gather_kernel reads its VMEM stage.
// Gather: each CTA leaves its 128 partial sums, a second launch adds them
// in a fixed order. Big: the CTA holding the region's first piece writes
// out. The TPU's big copy starts at starts[0] as a dynamic slice does:
// clamped so that the rows fit the ring.

#include "conv3x3_tile.cuh"

namespace {

using namespace cdfo;

constexpr int LANES = 128;          // checksummed lanes
constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 200 * 1024;
constexpr int PIECE = 512;          // 16-byte vectors of one big-copy piece (8 KB)

// waits until at most n of this thread's cp.async groups are pending
#ifndef CDFO_HOST_MMA
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#else
template <int N>
inline void wait_pending() {}
#endif

__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: wait_pending<0>(); break;
    case 1: wait_pending<1>(); break;
    case 2: wait_pending<2>(); break;
    case 3: wait_pending<3>(); break;
    case 4: wait_pending<4>(); break;
    case 5: wait_pending<5>(); break;
    case 6: wait_pending<6>(); break;
    default: wait_pending<7>(); break;
  }
}

// Copies `count` units into a ring of `stages` shared-memory stages of
// `vecs` 16-byte vectors, stages - 1 ahead of the one consumed:
// issue(j, stage) issues unit j's copies, use(j, stage) reads it once it
// has landed. One cp.async group is committed per unit (or empty), so
// waiting for all but stages - 1 lands the oldest.
template <typename Issue, typename Use>
__device__ __forceinline__ void ring_copy(int count, int stages, int vecs, bf16* smem, Issue&& issue,
                                          Use&& use) {
  for (int s = 0; s < stages; ++s) {
    if (s < count) issue(s, smem + s * vecs * 8);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    bf16* stage = smem + (j % stages) * vecs * 8;
    wait_pending(stages - 1);
    __syncthreads();
    use(j, stage);
    __syncthreads();
    if (j + stages < count) issue(j + stages, stage);
    cp_async_commit();
  }
  cp_async_wait();
}

// patch j of this CTA at starts[2 * (lo + j)] (row), [.. + 1] (lane),
// clamped into the ring as the TPU's dynamic slices are, the lane taken
// down to a multiple of 8
__global__ void __launch_bounds__(THREADS)
gather_kernel(const bf16* __restrict__ ring, const int* __restrict__ starts, float* __restrict__ part,
              int ring_h, long long ring_w, int nblk, int ph, int pwl, int stages, int ctas) {
  extern __shared__ uint4 cdfo_smem[];
  bf16* smem = reinterpret_cast<bf16*>(cdfo_smem);
  const int lo = static_cast<int>(static_cast<long long>(nblk) * blockIdx.x / ctas);
  const int hi = static_cast<int>(static_cast<long long>(nblk) * (blockIdx.x + 1) / ctas);
  const int vpr = pwl / 8, vecs = ph * vpr;   // vectors per patch row, per patch
  float acc = 0.f;
  ring_copy(
      hi - lo, stages, vecs, smem,
      [&](int j, bf16* stage) {
        const int y = min(max(starts[2 * (lo + j)], 0), ring_h - ph);
        const long long x = min(max(static_cast<long long>(starts[2 * (lo + j) + 1]), 0LL), ring_w - pwl) & ~7LL;
        for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
          const int row = i / vpr, v = i % vpr;
          cp_async16(stage + row * pwl + v * 8, ring + (y + row) * ring_w + x + v * 8);
        }
      },
      [&](int, const bf16* stage) {
        if (threadIdx.x < LANES) acc += __bfloat162float(stage[threadIdx.x]);
      });
  if (threadIdx.x < LANES) part[blockIdx.x * LANES + threadIdx.x] = acc;
}

// out[l] = the sum over CTAs, in order, of part[cta][l]
__global__ void __launch_bounds__(THREADS)
gather_reduce(const float* __restrict__ part, float* __restrict__ out, int ctas) {
  if (threadIdx.x >= LANES) return;
  float s = 0.f;
  for (int b = 0; b < ctas; ++b) s += part[b * LANES + threadIdx.x];
  out[threadIdx.x] = s;
}

// the rows [y0, y0 + rows) of the ring, y0 = starts[0] clamped to fit, as
// `PIECE`-vector pieces split over the CTAs
__global__ void __launch_bounds__(THREADS)
big_kernel(const bf16* __restrict__ ring, const int* __restrict__ starts, float* __restrict__ out,
           long long ring_w, int ring_h, int rows, int ctas) {
  extern __shared__ uint4 cdfo_smem[];
  bf16* smem = reinterpret_cast<bf16*>(cdfo_smem);
  const int y0 = min(max(starts[0], 0), ring_h - rows);
  const bf16* src = ring + y0 * ring_w;
  const long long total = rows * ring_w / 8;   // vectors
  const int pieces = static_cast<int>((total + PIECE - 1) / PIECE);
  const int lo = static_cast<int>(static_cast<long long>(pieces) * blockIdx.x / ctas);
  const int hi = static_cast<int>(static_cast<long long>(pieces) * (blockIdx.x + 1) / ctas);
  ring_copy(
      hi - lo, MAX_STAGES, PIECE, smem,
      [&](int j, bf16* stage) {
        const long long v0 = static_cast<long long>(lo + j) * PIECE;
        for (int i = threadIdx.x; i < PIECE && v0 + i < total; i += blockDim.x) {
          cp_async16(stage + i * 8, src + (v0 + i) * 8);
        }
      },
      [&](int j, const bf16* stage) {
        if (lo + j == 0 && threadIdx.x < LANES) out[threadIdx.x] = __bfloat162float(stage[threadIdx.x]);
      });
}

int stages_of(int patch_bytes) {
  const int s = MAX_SMEM / patch_bytes;
  return s < MAX_STAGES ? s : MAX_STAGES;
}

}  // namespace

// The CTAs of a gather of `nblk` patches of `patch_bytes` bytes: as many
// as the current device's SMs hold at once, at most nblk; the length of
// the workspace is 128 floats per CTA. -1 if the device cannot be asked or
// a patch does not fit.
extern "C" int cdfo_probe_gather_ctas(int nblk, int patch_bytes) {
  const int sms = sm_count();
  if (sms <= 0 || nblk <= 0 || patch_bytes <= 0 || stages_of(patch_bytes) < 1) return -1;
  const int per_sm = 227 * 1024 / (stages_of(patch_bytes) * patch_bytes);
  const long long n = static_cast<long long>(sms) * (per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm));
  return n < nblk ? static_cast<int>(n) : nblk;
}

// ring (ring_h, ring_w) bf16 with ring_w a multiple of 8, starts (nblk, 2)
// int32 (row, lane) on the device; patches (ph, pwl) with pwl a multiple of
// 8; part the workspace of `ctas` x 128 floats
// (cdfo_probe_gather_ctas), out 128 floats. Returns a cudaError_t.
extern "C" int cdfo_probe_gather(const void* ring, const void* starts, void* part, void* out,
                                 int ring_h, int ring_w, int nblk, int ph, int pwl, int ctas,
                                 void* stream) {
  const int patch_bytes = ph * pwl * 2;
  if (ring_h <= 0 || ring_w <= 0 || ring_w % 8 != 0 || nblk <= 0 || ph <= 0 || ph > ring_h ||
      pwl <= 0 || pwl % 8 != 0 || pwl < LANES || pwl > ring_w || ctas <= 0 || ctas > nblk ||
      stages_of(patch_bytes) < 1) {
    return cudaErrorInvalidValue;
  }
  const int stages = stages_of(patch_bytes);
  const int bytes = stages * patch_bytes;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(gather_kernel, bytes);
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(gather_kernel, dim3(ctas), bytes, s, static_cast<const bf16*>(ring),
              static_cast<const int*>(starts), static_cast<float*>(part), ring_h,
              static_cast<long long>(ring_w), nblk, ph, pwl, stages, ctas);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(gather_reduce, dim3(1), 0, s, static_cast<const float*>(part), static_cast<float*>(out),
              ctas);
  return cudaGetLastError();
}

// big: the rows [y0, y0 + rows) of ring (ring_h, ring_w) bf16 through
// shared memory, y0 = starts[0] clamped to [0, ring_h - rows]; out 128
// floats = lanes 0-127 of row y0. Returns a cudaError_t.
extern "C" int cdfo_probe_big(const void* ring, const void* starts, void* out, int ring_h,
                              int ring_w, int rows, void* stream) {
  if (ring_h <= 0 || ring_w < LANES || ring_w % 8 != 0 || rows <= 0 || rows > ring_h) {
    return cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const long long pieces = (static_cast<long long>(rows) * ring_w / 8 + PIECE - 1) / PIECE;
  const int ctas = static_cast<int>(pieces < 2LL * sms ? pieces : 2LL * sms);
  const int bytes = MAX_STAGES * PIECE * 16;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = allow_smem(big_kernel, bytes);
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(big_kernel, dim3(ctas), bytes, s, static_cast<const bf16*>(ring),
              static_cast<const int*>(starts), static_cast<float*>(out),
              static_cast<long long>(ring_w), ring_h, rows, ctas);
  return cudaGetLastError();
}
