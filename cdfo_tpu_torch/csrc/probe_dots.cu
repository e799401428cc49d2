// The dot-shape probes of the trunk, hand-written for Hopper (sm_90a): the
// sustained rate of the trunk's own instruction, mma.sync.m16n8k16 bf16
// fed by ldmatrix from shared memory, at the trunk's product shapes.
//
// Replaces the TPU probes of tools/microbench_dots.py:
//   dots     bench_case (_kernel):  out (m, n) = bf16(sum_{i < reps}
//            lhs (m, k) @ rhs[i mod nplanes] (k, n)), fp32 accumulate;
//   rowpipe  bench_rowpipe (_rowpipe_kernel): per iteration i, r = i mod
//            nrows, y = sum_dx W[:, dx*3c:(dx+1)*3c] @ u[r:r+3] (3c, n+8)
//            [:, dx:dx+n] + b, lrelu, x colmask, stored bf16 as row r of a
//            scratch; out = row 0 (per-row issue: three products on the
//            unshifted rows, the shift taken by the output);
//   kstack   bench_kstack (_kstack_kernel): per iteration, us[r][dx] =
//            u[r][:, dx:dx+n+2] (one row built into 3 shifted copies),
//            y = W (m, 9c) @ us[r:r+3] (9c, n+2)[:, :n] + b, lrelu, x cm,
//            stored as row r; out = row 0 (K-stacked issue: one product
//            of K = 9c on a buffer built for it).
//
// What bounds them: operations, 2 m k n per product at 989 TFLOP/s.
//
// Design. Each product is computed transposed, as the trunk kernels compute
// a convolution: M = pixels (the probes' n), N = output channels (their m),
// K = input channels. The activations (rhs planes, u rows, us rows) are
// staged into shared memory in chunks of 64 channels x the CTA's pixels,
// one pixel every 72 bf16 (conv3x3_tile.cuh's pitch), and read by
// ldmatrix; the weights (lhs, W) come in mma-fragment order from device
// memory through L1/L2 (ops/cuda_build.py::kernel_weights), as the trunk
// reads its weights. A CTA of 8 warps covers all m channels and a block of
// pixels; a warp covers MT m-tiles (16 pixels each) x 4 n-tiles (32
// channels), so m is 64, 128 or 256 (WN = m / 32 warps across channels,
// WM = 8 / WN across pixels, a block of 16 MT WM pixels); k (and c) are
// multiples of 64; a ragged last pixel block is zero-filled on load and
// masked on store.
//   dots (MT = 4): the chunks of all nplanes planes stay resident in
//   shared memory when they fit 200 KB (at 4 planes: k <= 320 for m = 256,
//   k <= 128 for m = 128, k = 64 for m = 64) and the caller does not ask
//   for streaming; else two chunk buffers stream them from L2, the next
//   chunk's cp.async under the current chunk's mma.
//   Where the output has fewer pixel blocks than the card has SMs, the reps
//   are split into groups (grid.y) that leave fp32 partial sums; a second
//   launch adds them in a fixed order and rounds once, so every run gives
//   the same bits.
//   rowpipe (MT of the caller's choice, 4 by default): a chunk is 64
//   channels of one of the three rows over the block's pixels plus 2,
//   streamed from L2 as dots streams, and serves all three dx by shifted
//   ldmatrix rows: the shift is free here.
//   kstack: the stacked rows live on chip, as the TPU's us lives in VMEM:
//   a ring of nrows + 2 slots of 3 shifted copies of the block's pixels
//   in shared memory. Each iteration lands row r of u (streamed from L2
//   under the previous product, as rowpipe streams its rows) in a staging
//   buffer, copies it into slot r at the three shifts, and runs the 9c-deep
//   product on slots r .. r + 2. MT is the largest of 4, 2, 1 whose ring
//   fits 200 KB (2 for the tool's m = 256, c = 64, nrows = 8), so that
//   rowpipe can be run at the same tile for a like-for-like comparison.
//   Both split the reps into groups too, each with its own y scratch; the
//   group whose range holds the last iteration with r = 0 writes out. A
//   kstack group first repeats up to nrows iterations before its range, so
//   that the slots 1 and 2 it reads were built by itself. kstack reads
//   slots that earlier iterations built (slots nrows and nrows + 1 never
//   are: they stay zero), so its output is defined only for reps > nrows,
//   as the TPU kernel's: the wrapper refuses fewer.

#include "conv3x3_tile.cuh"

namespace {

using namespace cdfo;

constexpr int P = Pitch<bf16>::value;   // 72
constexpr int NT = 4;                  // a warp's n-tiles (channels)
constexpr int DOTS_MT = 4;             // the dot probe's m-tiles (pixels) per warp
constexpr int MAX_SMEM = 200 * 1024;
constexpr int PIXEL_BYTES = P * static_cast<int>(sizeof(bf16));   // one pixel of a chunk

// Copies pixels [p0, p0 + np) x channels [c0, c0 + 64) of a [pixel][ld]
// bf16 array (pixels at or past `valid` read as 0) into a chunk buffer.
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* __restrict__ src, long long ld,
                                            int p0, int np, int valid, int c0) {
  for (int i = threadIdx.x; i < np * 8; i += blockDim.x) {
    const int p = i >> 3, v = i & 7;
    bf16* d = dst + p * P + v * 8;
    if (p0 + p < valid) {
      cp_async16(d, src + (p0 + p) * ld + c0 + v * 8);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc += A (the warp's 16 MT pixels of a chunk buffer, from pixel `p0`) .
// W (k-tiles kt0 .. kt0 + 3, the warp's 4 n-tiles from nt0)
template <int MT>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][NT][4], const bf16* buf, int p0,
                                          const Weights<bf16>& w, int kt0, int nt0, int lane) {
  ATile<bf16> a[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    a[m].p0 = buf + (p0 + 16 * m + (lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
    a[m].p1 = a[m].p0;
    a[m].in_w = 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int off[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) off[m] = 16 * j;
    mma_k16<MT, NT>(acc, a, off, w, 0, kt0 + j, nt0, lane);
  }
}

// Streams `count` chunks through two buffers: stage(q, buf) issues chunk
// q's copies, compute(q, buf) consumes it; chunk q + 1 is in flight while q
// computes.
template <typename Stage, typename Compute>
__device__ __forceinline__ void stream_chunks(int count, bf16* bufs, int chunk_elems, Stage&& stage,
                                              Compute&& compute) {
  stage(0, bufs);
  cp_async_commit();
  cp_async_wait();
  __syncthreads();
#pragma unroll 1
  for (int q = 0; q < count; ++q) {
    bf16* cur = bufs + (q & 1) * chunk_elems;
    if (q + 1 < count) {
      stage(q + 1, bufs + ((q + 1) & 1) * chunk_elems);
      cp_async_commit();
    }
    compute(q, cur);
    cp_async_wait();
    __syncthreads();
  }
}

// The range of iterations of rep group g of `groups`
__device__ __forceinline__ void rep_range(int reps, int groups, int g, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(reps) * g / groups);
  hi = static_cast<int>(static_cast<long long>(reps) * (g + 1) / groups);
}

// ---- dots -------------------------------------------------------------------

template <int WN>
__global__ void __launch_bounds__(THREADS, 1)
dots_kernel(const bf16* __restrict__ rhs, const bf16* __restrict__ wl, float* __restrict__ part,
            int m, int k, int n, int nplanes, int reps, int groups, int resident) {
  constexpr int MT = DOTS_MT, WM = WARPS / WN, BN = 16 * MT * WM;
  extern __shared__ uint4 cdfo_smem[];
  bf16* bufs = reinterpret_cast<bf16*>(cdfo_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wp = (warp / WN) * 16 * MT, nt0 = (warp % WN) * NT;
  const int n0 = blockIdx.x * BN, g = blockIdx.y;
  const int kc = k / 64;
  const Weights<bf16> w{wl, m, k};
  int lo, hi;
  rep_range(reps, groups, g, lo, hi);
  float acc[MT][NT][4];
  zero(acc);
  const auto src = [&](int plane) { return rhs + static_cast<long long>(plane) * n * k; };
  if (resident) {
    // every chunk of every plane on chip, loaded once
    for (int q = 0; q < nplanes * kc; ++q) {
      stage_chunk(bufs + q * BN * P, src(q / kc), k, n0, BN, n, (q % kc) * 64);
    }
    cp_async_commit();
    cp_async_wait();
    __syncthreads();
#pragma unroll 1
    for (int i = lo; i < hi; ++i) {
      const bf16* plane = bufs + (i % nplanes) * kc * BN * P;
#pragma unroll 1
      for (int c = 0; c < kc; ++c) chunk_mma(acc, plane + c * BN * P, wp, w, 4 * c, nt0, lane);
    }
  } else {
    stream_chunks(
        (hi - lo) * kc, bufs, BN * P,
        [&](int q, bf16* buf) {
          stage_chunk(buf, src((lo + q / kc) % nplanes), k, n0, BN, n, (q % kc) * 64);
        },
        [&](int q, const bf16* buf) { chunk_mma(acc, buf, wp, w, 4 * (q % kc), nt0, lane); });
  }
  // the group's fp32 partial sums, [g][pixel][channel]
  float* pg = part + static_cast<long long>(g) * n * m;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    for_each_pair(acc[mt], 0, nt0 * 8, 16, lane, [&](int p, int c, float v0, float v1) {
      const int px = n0 + wp + 16 * mt + p;
      if (px < n) *reinterpret_cast<float2*>(pg + static_cast<long long>(px) * m + c) = make_float2(v0, v1);
    });
  }
}

// out (m, n) bf16 = the sum over groups, in order, of part [g][n][m]
__global__ void __launch_bounds__(THREADS)
dots_reduce(const float* __restrict__ part, bf16* __restrict__ out, int m, int n, int groups) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(m) * n) return;
  const int c = static_cast<int>(i % m), px = static_cast<int>(i / m);
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += part[(static_cast<long long>(g) * n + px) * m + c];
  out[static_cast<long long>(c) * n + px] = __float2bfloat16(s);
}

// ---- rowpipe and kstack ----------------------------------------------------

// y = lrelu(acc + b) * cm of the warp's tile, bf16, into the scratch row
// [pixel][channel]; at the output iteration also into out (m, n)
template <int MT>
__device__ __forceinline__ void row_epilogue(const float (&acc)[MT][NT][4], const float* __restrict__ b,
                                             const float* __restrict__ cm, bf16* __restrict__ yrow,
                                             bf16* __restrict__ out, bool last, int m, int n, int pbase,
                                             int nt0, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    for_each_pair(acc[mt], 0, nt0 * 8, 16, lane, [&](int p, int c, float v0, float v1) {
      const int px = pbase + 16 * mt + p;
      if (px >= n) return;
      const float mask = cm[px];
      const float y0 = lrelu(v0 + b[c]) * mask, y1 = lrelu(v1 + b[c + 1]) * mask;
      store2(yrow + static_cast<long long>(px) * m + c, y0, y1);
      if (last) {
        out[static_cast<long long>(c) * n + px] = __float2bfloat16(y0);
        out[static_cast<long long>(c + 1) * n + px] = __float2bfloat16(y1);
      }
    });
  }
}

// u: (nrows + 2, n + 8, c) bf16 (the TPU layout (nrows + 2, c, n + 8)
// transposed); W packed (m, 9c), K index dx*3c + row*c + ch; y scratch
// [groups][nrows][n][m]
template <int WN, int MT>
__global__ void __launch_bounds__(THREADS, 1)
rowpipe_kernel(const bf16* __restrict__ u, const bf16* __restrict__ wp_, const float* __restrict__ b,
               const float* __restrict__ cm, bf16* __restrict__ yscr, bf16* __restrict__ out, int m,
               int c, int n, int nrows, int reps, int groups) {
  constexpr int WM = WARPS / WN, BN = 16 * MT * WM;
  extern __shared__ uint4 cdfo_smem[];
  bf16* bufs = reinterpret_cast<bf16*>(cdfo_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wp = (warp / WN) * 16 * MT, nt0 = (warp % WN) * NT;
  const int n0 = blockIdx.x * BN, g = blockIdx.y;
  const int cc = c / 64, un = n + 8;
  const Weights<bf16> w{wp_, m, 9 * c};
  const int last = ((reps - 1) / nrows) * nrows;
  int lo, hi;
  rep_range(reps, groups, g, lo, hi);
#pragma unroll 1
  for (int i = lo; i < hi; ++i) {
    const int r = i % nrows;
    float acc[MT][NT][4];
    zero(acc);
    stream_chunks(
        3 * cc, bufs, (BN + 2) * P,
        [&](int q, bf16* buf) {
          const int row = q / cc;
          stage_chunk(buf, u + static_cast<long long>(r + row) * un * c, c, n0, BN + 2, un,
                      (q % cc) * 64);
        },
        [&](int q, const bf16* buf) {
          const int row = q / cc, ch = (q % cc) * 64;
#pragma unroll 1
          for (int dx = 0; dx < 3; ++dx) {
            chunk_mma(acc, buf, wp + dx, w, (dx * 3 * c + row * c + ch) / 16, nt0, lane);
          }
        });
    row_epilogue(acc, b, cm, yscr + (static_cast<long long>(g) * nrows + r) * n * m, out, i == last,
                 m, n, n0 + wp, nt0, lane);
  }
}

// Shared memory of kstack: the staging buffer [cc][BN + 2][P] and the ring
// [nrows + 2][3][cc][BN][P]
inline long long kstack_smem(int bn, int c, int nrows) {
  return static_cast<long long>(c / 64) * PIXEL_BYTES * ((bn + 2) + 3LL * (nrows + 2) * bn);
}

// W packed (m, 9c), K index row*3c + dx*c + ch; the stacked rows in shared
// memory (see kstack_smem)
template <int WN, int MT>
__global__ void __launch_bounds__(THREADS, 1)
kstack_kernel(const bf16* __restrict__ u, const bf16* __restrict__ wp_, const float* __restrict__ b,
              const float* __restrict__ cm, bf16* __restrict__ yscr, bf16* __restrict__ out, int m,
              int c, int n, int nrows, int reps, int groups) {
  constexpr int WM = WARPS / WN, BN = 16 * MT * WM;
  extern __shared__ uint4 cdfo_smem[];
  const int cc = c / 64, un = n + 8;
  bf16* stage = reinterpret_cast<bf16*>(cdfo_smem);
  bf16* ring = stage + cc * (BN + 2) * P;
  const int slot = 3 * cc * BN * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wp = (warp / WN) * 16 * MT, nt0 = (warp % WN) * NT;
  const int n0 = blockIdx.x * BN, g = blockIdx.y;
  const Weights<bf16> w{wp_, m, 9 * c};
  const int last = ((reps - 1) / nrows) * nrows;
  int lo, hi;
  rep_range(reps, groups, g, lo, hi);
  const int first = max(0, lo - nrows);
  for (int e = threadIdx.x; e < (nrows + 2) * slot / 8; e += blockDim.x) {
    reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  // row i % nrows of u, the block's pixels plus 2, into the staging buffer
  const auto fetch = [&](int i) {
    const bf16* src = u + static_cast<long long>(i % nrows) * un * c;
    for (int q = 0; q < cc; ++q) stage_chunk(stage + q * (BN + 2) * P, src, c, n0, BN + 2, un, q * 64);
    cp_async_commit();
  };
  if (first < hi) fetch(first);
#pragma unroll 1
  for (int i = first; i < hi; ++i) {
    const int r = i % nrows;
    // the row has landed, and the previous product is done with the ring
    cp_async_wait();
    __syncthreads();
    // build: slot r [dx][q][p] = staged [q][p + dx]
    bf16* dst = ring + r * slot;
    for (int e = threadIdx.x; e < 3 * cc * BN * 8; e += blockDim.x) {
      const int v = e & 7, p = (e >> 3) % BN, dq = (e >> 3) / BN;   // dq = dx * cc + q
      const int dx = dq / cc, q = dq % cc;
      *reinterpret_cast<uint4*>(dst + (dq * BN + p) * P + v * 8) =
          *reinterpret_cast<const uint4*>(stage + (q * (BN + 2) + p + dx) * P + v * 8);
    }
    __syncthreads();
    if (i + 1 < hi) fetch(i + 1);   // under this product
    float acc[MT][NT][4];
    zero(acc);
#pragma unroll 1
    for (int rd = 0; rd < 9; ++rd) {   // rd = row * 3 + dx
      const bf16* rows = ring + (r + rd / 3) * slot + (rd % 3) * cc * BN * P;
#pragma unroll 1
      for (int q = 0; q < cc; ++q) {
        chunk_mma(acc, rows + q * BN * P, wp, w, (rd * c + q * 64) / 16, nt0, lane);
      }
    }
    // (a repeated iteration before the range writes no output)
    row_epilogue(acc, b, cm, yscr + (static_cast<long long>(g) * nrows + r) * n * m, out,
                 i == last && i >= lo, m, n, n0 + wp, nt0, lane);
  }
}

int block_pixels(int m, int mt) { return 16 * mt * (WARPS / (m / 32)); }

bool takes_m(int m) { return m == 64 || m == 128 || m == 256; }

bool takes_mt(int mt) { return mt == 1 || mt == 2 || mt == 4; }

// The largest MT of 4, 2, 1 whose kstack ring fits MAX_SMEM; -1 if none
int kstack_mt(int m, int c, int nrows) {
  for (int mt = 4; mt >= 1; mt /= 2) {
    if (kstack_smem(block_pixels(m, mt), c, nrows) <= MAX_SMEM) return mt;
  }
  return -1;
}

template <int WN>
struct DotsLaunch {
  static cudaError_t run(const void* rhs, const void* wl, float* part, void* out, int m, int k,
                         int n, int nplanes, int reps, int groups, int stream_planes,
                         cudaStream_t stream) {
    constexpr int BN = 16 * DOTS_MT * (WARPS / WN);
    const int chunk = BN * PIXEL_BYTES;
    const int resident = !stream_planes && nplanes * (k / 64) * chunk <= MAX_SMEM;
    const int bytes = resident ? nplanes * (k / 64) * chunk : 2 * chunk;
    cudaError_t err = allow_smem(dots_kernel<WN>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + BN - 1) / BN, groups);
    CDFO_LAUNCH(dots_kernel<WN>, grid, bytes, stream, static_cast<const bf16*>(rhs),
                static_cast<const bf16*>(wl), part, m, k, n, nplanes, reps, groups, resident);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long total = static_cast<long long>(m) * n;
    const dim3 rgrid(static_cast<unsigned>((total + THREADS - 1) / THREADS));
    CDFO_LAUNCH(dots_reduce, rgrid, 0, stream, part, static_cast<bf16*>(out), m, n, groups);
    return cudaGetLastError();
  }
};

template <int WN, int MT>
cudaError_t rows_launch(int kstack, const bf16* u, const bf16* wpk, const float* b, const float* cm,
                        bf16* yscr, bf16* out, int m, int c, int n, int nrows, int reps, int groups,
                        cudaStream_t stream) {
  constexpr int BN = 16 * MT * (WARPS / WN);
  const dim3 grid((n + BN - 1) / BN, groups);
  cudaError_t err;
  if (kstack) {
    const long long bytes = kstack_smem(BN, c, nrows);
    if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
    const auto kernel = kstack_kernel<WN, MT>;
    err = allow_smem(kernel, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    CDFO_LAUNCH(kernel, grid, static_cast<int>(bytes), stream, u, wpk, b, cm, yscr, out, m, c, n,
                nrows, reps, groups);
  } else {
    const int bytes = 2 * (BN + 2) * PIXEL_BYTES;
    const auto kernel = rowpipe_kernel<WN, MT>;
    err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    CDFO_LAUNCH(kernel, grid, bytes, stream, u, wpk, b, cm, yscr, out, m, c, n, nrows, reps, groups);
  }
  return cudaGetLastError();
}

template <int WN, typename... Args>
cudaError_t rows_by_mt(int mt, Args... args) {
  switch (mt) {
    case 1: return rows_launch<WN, 1>(args...);
    case 2: return rows_launch<WN, 2>(args...);
    case 4: return rows_launch<WN, 4>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The number of rep groups (grid.y) of a probe whose output has
// ceil(n / block pixels) pixel blocks at MT m-tiles per warp: as many as
// fill the current device's SMs with one CTA each, at least 1, at most
// reps. -1 if m is not 64, 128 or 256, MT not 1, 2 or 4, or the device
// cannot be asked.
extern "C" int cdfo_probe_groups(int m, int mt, int n, int reps) {
  const int sms = sm_count();
  if (!takes_m(m) || !takes_mt(mt) || n <= 0 || reps <= 0 || sms <= 0) return -1;
  const int bn = block_pixels(m, mt), blocks = (n + bn - 1) / bn;
  const int g = sms / blocks;
  return g < 1 ? 1 : (g > reps ? reps : g);
}

// The m-tiles per warp of kstack at (m, c, nrows): the largest of 4, 2, 1
// whose ring of stacked rows fits shared memory; -1 if none does or m is
// not 64, 128 or 256 or c not a multiple of 64.
extern "C" int cdfo_probe_kstack_mt(int m, int c, int nrows) {
  if (!takes_m(m) || c <= 0 || c % 64 != 0 || nrows < 3) return -1;
  return kstack_mt(m, c, nrows);
}

// dots: rhs (nplanes, n, k) bf16 (the TPU layout (nplanes, k, n)
// transposed), wl the (m, k) lhs in kernel_weights order, part the fp32
// workspace [groups][n][m] (groups from cdfo_probe_groups at MT = 4), out
// (m, n) bf16; stream_planes: stream the planes from L2 even where they
// fit shared memory. Returns a cudaError_t.
extern "C" int cdfo_probe_dots(const void* rhs, const void* wl, void* part, void* out, int m,
                               int k, int n, int nplanes, int reps, int groups, int stream_planes,
                               void* stream) {
  if (!takes_m(m) || k <= 0 || k % 64 != 0 || n <= 0 || nplanes <= 0 || reps <= 0 ||
      groups <= 0 || groups > 65535) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = static_cast<float*>(part);
  switch (m) {
    case 64: return DotsLaunch<2>::run(rhs, wl, f, out, m, k, n, nplanes, reps, groups, stream_planes, s);
    case 128: return DotsLaunch<4>::run(rhs, wl, f, out, m, k, n, nplanes, reps, groups, stream_planes, s);
    default: return DotsLaunch<8>::run(rhs, wl, f, out, m, k, n, nplanes, reps, groups, stream_planes, s);
  }
}

// rowpipe (kstack = 0) or kstack (1) at mt m-tiles per warp (kstack: the
// one cdfo_probe_kstack_mt gives): u (nrows + 2, n + 8, c) bf16, wpk the
// (m, 9c) W in kernel_weights order, b (m,) and cm (n,) float32, yscr
// [groups][nrows][n][m] bf16 (groups from cdfo_probe_groups at the same
// mt), out (m, n) bf16. kstack needs reps > nrows. Returns a cudaError_t.
extern "C" int cdfo_probe_rows(int kstack, int mt, const void* u, const void* wpk, const void* b,
                               const void* cm, void* yscr, void* out, int m, int c, int n,
                               int nrows, int reps, int groups, void* stream) {
  if (!takes_m(m) || !takes_mt(mt) || c <= 0 || c % 64 != 0 || n <= 0 || nrows < 3 || reps <= 0 ||
      (kstack && reps <= nrows) || groups <= 0 || groups > 65535) {
    return cudaErrorInvalidValue;
  }
  const auto ub = static_cast<const bf16*>(u);
  const auto wb = static_cast<const bf16*>(wpk);
  const auto bb = static_cast<const float*>(b);
  const auto cb = static_cast<const float*>(cm);
  const auto yb = static_cast<bf16*>(yscr);
  const auto ob = static_cast<bf16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 64: return rows_by_mt<2>(mt, kstack, ub, wb, bb, cb, yb, ob, m, c, n, nrows, reps, groups, s);
    case 128: return rows_by_mt<4>(mt, kstack, ub, wb, bb, cb, yb, ob, m, c, n, nrows, reps, groups, s);
    default: return rows_by_mt<8>(mt, kstack, ub, wb, bb, cb, yb, ob, m, c, n, nrows, reps, groups, s);
  }
}
