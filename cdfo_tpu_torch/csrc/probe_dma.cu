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
// Design. gather: a CTA is one warp owning a contiguous range of patches;
// its lane 0 copies each patch whole into a ring of stages in shared
// memory (as many as fit 48 KB, at most 16) by TMA tensor copies that
// complete on the stage's mbarrier, several CTAs an SM, so that the
// copies' issue costs no thread more than one instruction a box. The ring
// is seen as a tensor of "pixels" of 64 lanes (128 bytes), or of 8 where
// a patch starts off a 64-lane boundary (clamp_starts keeps starts at
// multiples of 8), (ring_w / lanes, ring_h); a patch is one box of
// (lanes, pwl / lanes, ph) (split into equal boxes along a dimension that
// passes the box's 256, each landing row after row at a 128-byte
// boundary). The 8-lane map alone serves every start, but its boxes (16
// bytes a pixel) took 2.1x the time of the 64-lane ones at the tool's
// patches on an H100. Once a stage lands the
// warp adds lanes 0-127 of its row 0 to its sums, as _gather_kernel reads
// its VMEM stage, then lane 0 refills the stage. Each CTA leaves its 128
// partial sums; a second launch adds them in a fixed order, 32 segments
// side by side. The CTA's starts are read once, clamped, into shared
// memory, so that no copy's issue waits on a load from device memory.
// big: a CTA owns a contiguous range of 8 KB pieces of the region and
// copies each whole into a ring of 8 stages with cp.async, 16 bytes a
// thread; the CTA holding the first piece writes out. The TPU's big copy
// starts at starts[0] as a dynamic slice does: clamped so that the rows
// fit the ring.

#include "wgmma_tile.cuh"

namespace {

using namespace cdfo;

constexpr int LANES = 128;          // checksummed lanes
constexpr int MAX_STAGES = 8;       // the big copy's
constexpr int PIECE = 512;          // 16-byte vectors of one big-copy piece (8 KB)
constexpr int GATHER_STAGES = 16;   // the gather's, at most
constexpr int GATHER_BUDGET = 48 * 1024;
constexpr int START_CAP = 256;     // patches a CTA at most: their starts sit in shared memory
constexpr int SMEM_LIMIT = 232448;
constexpr int SM_SMEM = 233472;     // an SM's shared memory for its CTAs
constexpr int MAX_BOX = 256;        // elements of a TMA box along a dimension
constexpr int REDUCE_SEGMENTS = 32; // of the gather's partials, added side by side

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

// Copies `count` units into a ring of `stages` shared-memory stages of
// `vecs` 16-byte vectors, stages - 1 ahead of the one consumed:
// issue(j, stage) issues unit j's copies, use(j, stage) reads it once it
// has landed. One cp.async group is committed per unit (or empty), so
// waiting for all but stages - 1 lands the oldest.
template <typename Issue, typename Use>
__device__ __forceinline__ void ring_copy(int count, int vecs, bf16* smem, Issue&& issue,
                                          Use&& use) {
  for (int s = 0; s < MAX_STAGES; ++s) {
    if (s < count) issue(s, smem + s * vecs * 8);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    bf16* stage = smem + (j % MAX_STAGES) * vecs * 8;
    wait_pending<MAX_STAGES - 1>();
    __syncthreads();
    use(j, stage);
    __syncthreads();
    if (j + MAX_STAGES < count) issue(j + MAX_STAGES, stage);
    cp_async_commit();
  }
  cp_async_wait();
}

// A patch of ph rows of pwl lanes as boxes x hboxes TMA boxes of (lanes,
// bw, bh): `lanes` lanes a pixel of the map, bw of its pixels and bh rows
// a box, each box in a region of box_elems (its own, rounded up to 128
// bytes, the copies' alignment)
struct PatchBoxes {
  int lanes, boxes, bw, hboxes, bh, box_elems;
};

// the fewest equal parts of `extent` of at most MAX_BOX each
int box_parts(int extent) {
  int parts = 1;
  while (extent % parts != 0 || extent / parts > MAX_BOX) ++parts;
  return parts;
}

PatchBoxes patch_boxes(int ph, int pwl, int lanes) {
  const int nb = box_parts(pwl / lanes), nh = box_parts(ph);
  const int bw = pwl / lanes / nb, bh = ph / nh;
  return {lanes, nb, bw, nh, bh, (bh * bw * lanes + 63) / 64 * 64};
}

// the bytes of a stage: a patch by either map
int stage_bytes(int ph, int pwl) {
  const PatchBoxes n = patch_boxes(ph, pwl, 8);
  int bytes = n.boxes * n.hboxes * n.box_elems * 2;
  if (pwl % 64 == 0) {
    const PatchBoxes w = patch_boxes(ph, pwl, 64);
    const int wide = w.boxes * w.hboxes * w.box_elems * 2;
    if (wide > bytes) bytes = wide;
  }
  return bytes;
}

// The gather's stages: as many as fit GATHER_BUDGET (at least 2 where two
// fit one block, else 1), at most GATHER_STAGES; 0 if none fits
int gather_stages(int stage) {
  int s = GATHER_BUDGET / stage;
  if (s < 2) s = (SMEM_LIMIT - 1024) / stage >= 2 ? 2 : (SMEM_LIMIT - 1024) / stage;
  return s > GATHER_STAGES ? GATHER_STAGES : s;
}

int gather_smem(int stage) {
  return 1024 + gather_stages(stage) * (stage + 8) + START_CAP * 8;
}

// patch j of this CTA at starts[2 * (lo + j)] (row), [.. + 1] (lane),
// clamped into the ring as the TPU's dynamic slices are, the lane taken
// down to a multiple of 8; by the wide map (64 lanes a pixel) where the
// lane is a multiple of 64 and `wide_ok`, else the narrow one (8)
__global__ void __launch_bounds__(32)
gather_kernel(const __grid_constant__ CUtensorMap twide, const __grid_constant__ CUtensorMap tnarrow,
              const int* __restrict__ starts, float* __restrict__ part, int ring_h, int ring_w,
              int nblk, int ph, int pwl, int stage, int stages, int ctas, int wide_ok,
              PatchBoxes wide, PatchBoxes narrow) {
  unsigned char* base = dynamic_smem();
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  const int patch = ph * pwl;   // elements
  stage /= 2;                   // elements
  bf16* ring_s = reinterpret_cast<bf16*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_s + stages * stage);
  int2* yx = reinterpret_cast<int2*>(bars + stages);   // [START_CAP] clamped starts
  const int lane = threadIdx.x;
  const int lo = static_cast<int>(static_cast<long long>(nblk) * blockIdx.x / ctas);
  const int hi = static_cast<int>(static_cast<long long>(nblk) * (blockIdx.x + 1) / ctas);
  const int count = hi - lo;
  for (int j = lane; j < count; j += 32) {
    yx[j] = make_int2(min(max(starts[2 * (lo + j)], 0), ring_h - ph),
                      min(max(starts[2 * (lo + j) + 1], 0), ring_w - pwl) & ~7);
  }
  __syncthreads();   // (the CTA is this warp)
  const auto start_of = [&](int j, int& y, int& x) {
    y = yx[j].x;
    x = yx[j].y;
  };
  // (lane 0) patch j into stage j % stages, box (k, h) (pixels k bw .., rows
  // h bh ..) into region k hboxes + h
  const auto issue = [&](int j) {
    int y, x;
    start_of(j, y, x);
    const bool w = wide_ok && x % 64 == 0;
    const PatchBoxes& pb = w ? wide : narrow;
    uint64_t* bar = bars + j % stages;
    bf16* dst = ring_s + (j % stages) * stage;
    mbar_expect_tx(bar, patch * 2);
    for (int k = 0; k < pb.boxes; ++k) {
      for (int h = 0; h < pb.hboxes; ++h) {
        tma_load_row(dst + (k * pb.hboxes + h) * pb.box_elems, w ? &twide : &tnarrow,
                     x / pb.lanes + k * pb.bw, y + h * pb.bh, 0, bar);
      }
    }
  };
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + s, 1);
    mbar_init_fence();
    for (int j = 0; j < count && j < stages; ++j) issue(j);
  }
  __syncthreads();   // (the CTA is this warp)
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    int y, x;
    start_of(j, y, x);
    const PatchBoxes& pb = wide_ok && x % 64 == 0 ? wide : narrow;
    const int bwl = pb.bw * pb.lanes, col = pb.hboxes * pb.box_elems;
    const bf16* st = ring_s + (j % stages) * stage;
    mbar_wait(bars + j % stages, (j / stages) & 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // lane l of row 0: column l / bwl's first box, its lane l % bwl
      const int l = 4 * lane + e;
      acc[e] += __bfloat162float(st[(l / bwl) * col + l % bwl]);
    }
    __syncthreads();   // the warp has read the stage
    if (lane == 0 && j + stages < count) issue(j + stages);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) part[blockIdx.x * LANES + 4 * lane + e] = acc[e];
}

// out[l] = the sum over CTAs of part[cta][l] in a fixed order, so that
// every run gives the same bits: thread (s, q) adds lanes 4q .. 4q + 3 of
// the CTAs of segment s of REDUCE_SEGMENTS in order, then the segments'
// sums are added in order (one chain of dependent adds a lane over every
// CTA's partials bounded the gather)
__global__ void __launch_bounds__(32 * REDUCE_SEGMENTS)
gather_reduce(const float* __restrict__ part, float* __restrict__ out, int ctas) {
  float* seg = reinterpret_cast<float*>(dynamic_smem());   // [REDUCE_SEGMENTS][LANES]
  const int q = threadIdx.x % 32, sg = threadIdx.x / 32;
  const int lo = ctas * sg / REDUCE_SEGMENTS, hi = ctas * (sg + 1) / REDUCE_SEGMENTS;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int b = lo; b < hi; ++b) {
    const float4 v = *reinterpret_cast<const float4*>(part + b * LANES + 4 * q);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(seg + sg * LANES + 4 * q) = s;
  __syncthreads();
  if (threadIdx.x < LANES) {
    float t = 0.f;
    for (int k = 0; k < REDUCE_SEGMENTS; ++k) t += seg[k * LANES + threadIdx.x];
    out[threadIdx.x] = t;
  }
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
      hi - lo, PIECE, smem,
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

}  // namespace

// The CTAs of a gather of `nblk` patches of (ph, pwl): as many as the
// current device's SMs hold at once (its ring of stages each, at most 16
// an SM), or enough that none takes more than START_CAP patches, at most
// nblk; the length of the workspace is 128 floats per CTA. -1 if the
// device cannot be asked, pwl is not a multiple of 8 or a patch does not
// fit.
extern "C" int cdfo_probe_gather_ctas(int nblk, int ph, int pwl) {
  const int sms = sm_count();
  if (sms <= 0 || nblk <= 0 || ph <= 0 || pwl <= 0 || pwl % 8 != 0 ||
      gather_stages(stage_bytes(ph, pwl)) < 1) {
    return -1;
  }
  const int per_sm = SM_SMEM / (gather_smem(stage_bytes(ph, pwl)) + 1024);
  long long n = static_cast<long long>(sms) * (per_sm < 1 ? 1 : (per_sm > 16 ? 16 : per_sm));
  const long long least = (static_cast<long long>(nblk) + START_CAP - 1) / START_CAP;
  if (n < least) n = least;   // (more CTAs than the card holds at once run after)
  return n < nblk ? static_cast<int>(n) : nblk;
}

// ring (ring_h, ring_w) bf16 with ring_w a multiple of 8, starts (nblk, 2)
// int32 (row, lane) on the device; patches (ph, pwl) with pwl a multiple of
// 8; part the workspace of `ctas` x 128 floats (cdfo_probe_gather_ctas),
// out 128 floats. Returns a cudaError_t.
extern "C" int cdfo_probe_gather(const void* ring, const void* starts, void* part, void* out,
                                 int ring_h, int ring_w, int nblk, int ph, int pwl, int ctas,
                                 void* stream) {
  if (ring_h <= 0 || ring_w <= 0 || ring_w % 8 != 0 || nblk <= 0 || ph <= 0 || ph > ring_h ||
      pwl <= 0 || pwl % 8 != 0 || pwl < LANES || pwl > ring_w || ctas <= 0 || ctas > nblk ||
      (static_cast<long long>(nblk) + ctas - 1) / ctas > START_CAP ||
      gather_stages(stage_bytes(ph, pwl)) < 1) {
    return cudaErrorInvalidValue;
  }
  const int stage = stage_bytes(ph, pwl);
  const int stages = gather_stages(stage);
  const int bytes = gather_smem(stage);
  const int wide_ok = pwl % 64 == 0 && ring_w % 64 == 0;
  const PatchBoxes narrow = patch_boxes(ph, pwl, 8);
  const PatchBoxes wide = wide_ok ? patch_boxes(ph, pwl, 64) : narrow;
  CUtensorMap twide, tnarrow;
  cudaError_t err;
  if ((err = nhwc_tensor_map(&tnarrow, ring, 1, ring_h, ring_w / 8, narrow.bw, narrow.bh, false,
                             8)) != cudaSuccess) {
    return err;
  }
  twide = tnarrow;
  if (wide_ok && (err = nhwc_tensor_map(&twide, ring, 1, ring_h, ring_w / 64, wide.bw, wide.bh,
                                        false, 64)) != cudaSuccess) {
    return err;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if ((err = allow_smem(gather_kernel, bytes)) != cudaSuccess) return err;
  CDFO_LAUNCH_N(gather_kernel, dim3(ctas), 32, bytes, s, twide, tnarrow,
                static_cast<const int*>(starts), static_cast<float*>(part), ring_h, ring_w, nblk,
                ph, pwl, stage, stages, ctas, wide_ok, wide, narrow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH_N(gather_reduce, dim3(1), 32 * REDUCE_SEGMENTS, REDUCE_SEGMENTS * LANES * 4, s,
                static_cast<const float*>(part), static_cast<float*>(out), ctas);
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
