// The dual MSA of the alignment as two passes over the neighbour images,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels cdfo_tpu/ops/fused_align.py::msa_stage1 and
// ::msa_stage2, which DualAttAlignment._fused_msa launches once each per
// align_reconstruct call on the 6k neighbour images.
//
// Stage 1: k = relu(w W_fA^T + p W_fB^T); [sum q^T k, sum q^T q, sum k^T
// k] and the per-channel sums of w and p, with q = center[b / nbr]. Stage
// 2: o = w awt + p apt; po = o W_proj^T; fo = relu(po W_fA^T + q W_fB^T)
// and the per-channel sum of fo.
//
// What bounds them: per neighbour pixel, stage 1 does 128x64 + 3x64x64
// MACs (~41 KFLOP) against 256 B of w and p in bf16 and stage 2 128x64 +
// 64x64 + 128x64 MACs (~41 KFLOP) against 384 B (w, p in, fo out), ~160
// and ~107 FLOP/B, under the card's ~295 FLOP/B bf16 balance point: both
// are memory-bound, at ~0.26 and ~0.39 ms for 24 images of 272 x 480. The
// eager version broadcasts the centre to every neighbour, concatenates,
// gates and sums v in full resolution and runs the grams in float32
// (~6 GB of traffic per step). Here each pass reads w, p once and the
// centre once per group of nbr neighbours; k, o and po never leave shared
// memory, and the centre is read as center[b / nbr], never broadcast.
//
// Design: a block takes one centre and every `parts`-th tile of 128
// consecutive pixels of it, and walks the nbr neighbours of that centre in
// turn (the centre tile comes from device memory for the first and from
// L2 for the others). The 1x1 convolutions are implicit GEMMs on
// conv3x3_tile.cuh's tile routine (bf16 mma.sync, fp32 CUDA-core twin),
// one 16-pixel m-tile per warp; the grams are gram_tile.cuh's. Each sum a
// block holds is written as one partial per (neighbour, block), and a
// second launch adds the partials in a fixed order. Rounding follows the
// TPU kernels: k, o and po to the working type, the sums in fp32, fo's sum
// from the fp32 fo before fo is rounded.

#include "gram_tile.cuh"

namespace {

using namespace cdfo;

constexpr int NP = 128;   // pixels of a tile (8 m-tiles, one per warp)
static_assert(NP == 16 * WARPS, "one m-tile per warp");

// Copies pixels p0 .. p0+NP-1 of the image at src ((npix, 64) NHWC) to dst
// (pitch Pitch<T>), zero past the image.
template <typename T>
__device__ void load_tile(T* dst, const T* __restrict__ src, int p0, int npix) {
  constexpr int V = 16 / sizeof(T), VP = C / V, P = Pitch<T>::value;
  for (int i = threadIdx.x; i < NP * VP; i += blockDim.x) {
    const int pix = i / VP, vi = i % VP;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + pix < npix) {
      val = __ldg(reinterpret_cast<const uint4*>(src + static_cast<long long>(p0 + pix) * C) + vi);
    }
    *reinterpret_cast<uint4*>(dst + pix * P + vi * V) = val;
  }
}

// acc (16 pixels of m-tile `warp` x 64 channels) += a W_A^T + b W_B^T, with
// W = [W_A | W_B] a (64 out, 128 in) conv in kernel_weights' layout (tap
// `tap`).
template <typename T>
__device__ __forceinline__ void fuse_1x1(float (&acc)[1][8][4], const T* a, const T* b,
                                         const T* w, int tap, int warp, int lane) {
  const ATile<T> ta[1] = {a_tile<1>(a, NP, NP, NP, warp, lane)};
  const ATile<T> tb[1] = {a_tile<1>(b, NP, NP, NP, warp, lane)};
  const Weights<T> wt{w + static_cast<long long>(tap) * 2 * GRAM, C, 2 * C};
  conv_tiles<1, 1, 1, 8>(acc, ta, wt, 0, 0, lane);
  conv_tiles<1, 1, 1, 8>(acc, tb, wt, 0, C, lane);
}

template <typename T>
constexpr int s1_smem() {
  return 4 * NP * Pitch<T>::value * static_cast<int>(sizeof(T)) + THREADS * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
msa1_kernel(const T* __restrict__ w, const T* __restrict__ pr, const T* __restrict__ center,
            const T* __restrict__ wf, float* __restrict__ ws, int npix, int nbr, int parts) {
  constexpr int P = Pitch<T>::value, N = 3 * GRAM + 2 * C;
  extern __shared__ uint4 cdfo_smem[];
  T* qs = reinterpret_cast<T*>(cdfo_smem);
  T* wsm = qs + NP * P;
  T* psm = wsm + NP * P;
  T* ks = psm + NP * P;
  float* red = reinterpret_cast<float*>(ks + NP * P);
  const int grp = blockIdx.y, part = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (npix + NP - 1) / NP;
  const T* q_img = center + static_cast<long long>(grp) * npix * C;
  // the per-channel sum thread i keeps: channel i % 64 of w (i % 128 < 64)
  // or p, over tile pixels [64 (i / 128), 64 (i / 128) + 64)
  const int sum_ch = threadIdx.x & (C - 1), sum_half = threadIdx.x >> 7;
  const T* sum_src = (threadIdx.x & C) ? psm : wsm;

  for (int f = 0; f < nbr; ++f) {
    const long long b = static_cast<long long>(grp) * nbr + f;
    float acc[3][4][4];
    zero_grams(acc);
    float csum = 0.f;
    for (int tile = part; tile < tiles; tile += parts) {
      const int p0 = tile * NP;
      __syncthreads();  // the previous tile's grams are done with qs, ks
      load_tile(qs, q_img, p0, npix);
      load_tile(wsm, w + b * npix * C, p0, npix);
      load_tile(psm, pr + b * npix * C, p0, npix);
      __syncthreads();
      for (int i = 0; i < NP / 2; ++i) csum += to_f(sum_src[(sum_half * NP / 2 + i) * P + sum_ch]);
      // k = relu(w W_fA^T + p W_fB^T), zero past the image, rounded to T
      float kacc[1][8][4];
      zero(kacc);
      fuse_1x1(kacc, wsm, psm, wf, 0, warp, lane);
      for_each_pair(kacc[0], warp, 0, NP, lane, [&](int p, int n, float v0, float v1) {
        const bool in = p0 + p < npix;
        store2(ks + p * P + n, in ? fmaxf(v0, 0.f) : 0.f, in ? fmaxf(v1, 0.f) : 0.f);
      });
      __syncthreads();
      gram3(acc, qs, ks, NP, warp, lane);
    }
    float* dst = ws + (b * parts + part) * N;
    store_grams(acc, dst, warp, lane);
    // the two halves of each channel's sum, added in a fixed order
    __syncthreads();  // the previous neighbour's sums are read
    red[threadIdx.x] = csum;
    __syncthreads();
    if (threadIdx.x < 2 * C) dst[3 * GRAM + threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + 2 * C];
  }
}

template <typename T>
constexpr int s2_smem() {
  return 4 * NP * Pitch<T>::value * static_cast<int>(sizeof(T)) + WARPS * 8 * C * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
msa2_kernel(const T* __restrict__ w, const T* __restrict__ pr, const T* __restrict__ center,
            const T* __restrict__ wa, const T* __restrict__ wproj, const T* __restrict__ wf,
            T* __restrict__ fo, float* __restrict__ ws, int npix, int nbr, int parts) {
  constexpr int P = Pitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* qs = reinterpret_cast<T*>(cdfo_smem);
  T* wsm = qs + NP * P;   // w, then po
  T* psm = wsm + NP * P;
  T* os = psm + NP * P;
  float* red = reinterpret_cast<float*>(os + NP * P);  // [warp][g][64]
  const int grp = blockIdx.y, part = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int tiles = (npix + NP - 1) / NP;
  const T* q_img = center + static_cast<long long>(grp) * npix * C;

  for (int f = 0; f < nbr; ++f) {
    const long long b = static_cast<long long>(grp) * nbr + f;
    // this lane's sums of fo's channels 8nt + 2t, +1 over its pixels
    float gsum[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) gsum[nt][0] = gsum[nt][1] = 0.f;
    for (int tile = part; tile < tiles; tile += parts) {
      const int p0 = tile * NP;
      __syncthreads();  // the previous tile is done with every buffer
      load_tile(qs, q_img, p0, npix);
      load_tile(wsm, w + b * npix * C, p0, npix);
      load_tile(psm, pr + b * npix * C, p0, npix);
      __syncthreads();
      // each warp runs its own 16 pixels through the chain (its GEMMs read
      // and write only its m-tile's rows of the buffers)
      float acc[1][8][4];
      zero(acc);
      // o = w awt + p apt, rounded to T
      fuse_1x1(acc, wsm, psm, wa, static_cast<int>(b), warp, lane);
      for_each_pair(acc[0], warp, 0, NP, lane,
                    [&](int p, int n, float v0, float v1) { store2(os + p * P + n, v0, v1); });
      __syncthreads();
      // po = o W_proj^T, rounded to T, over w (no longer read)
      zero(acc);
      {
        const ATile<T> a[1] = {a_tile<1>(os, NP, NP, NP, warp, lane)};
        conv_tiles<1, 1, 1, 8>(acc, a, Weights<T>{wproj, C, C}, 0, 0, lane);
      }
      __syncthreads();
      for_each_pair(acc[0], warp, 0, NP, lane,
                    [&](int p, int n, float v0, float v1) { store2(wsm + p * P + n, v0, v1); });
      __syncthreads();
      // fo = relu(po W_fA^T + q W_fB^T): its sum from the fp32 values,
      // then rounded to T (the C-fragment walk of for_each_pair, with the
      // n-tile index known to the compiler so gsum stays in registers)
      zero(acc);
      fuse_1x1(acc, wsm, qs, wf, 0, warp, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int p = warp * 16 + g + 8 * hi;
          if (p0 + p < npix) {
            const float f0 = fmaxf(acc[0][nt][2 * hi], 0.f);
            const float f1 = fmaxf(acc[0][nt][2 * hi + 1], 0.f);
            gsum[nt][0] += f0;
            gsum[nt][1] += f1;
            store2(fo + (b * npix + p0 + p) * C + 8 * nt + t2, f0, f1);
          }
        }
      }
    }
    // fo's channel sums: [warp][g] partials of every lane, then per channel
    // in a fixed order
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      red[(warp * 8 + g) * C + 8 * nt + t2] = gsum[nt][0];
      red[(warp * 8 + g) * C + 8 * nt + t2 + 1] = gsum[nt][1];
    }
    __syncthreads();
    if (threadIdx.x < C) {
      float s = 0.f;
      for (int i = 0; i < WARPS * 8; ++i) s += red[i * C + threadIdx.x];
      ws[(b * parts + part) * C + threadIdx.x] = s;
    }
  }
}

template <typename T>
cudaError_t launch1(const void* w, const void* pr, const void* center, const void* wf, void* ws,
                    void* stats, void* gaps, int batch, int npix, int nbr, int parts,
                    cudaStream_t stream) {
  const cudaError_t err = allow_smem(msa1_kernel<T>, s1_smem<T>());
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(msa1_kernel<T>, dim3(parts, batch / nbr), s1_smem<T>(), stream,
              static_cast<const T*>(w), static_cast<const T*>(pr), static_cast<const T*>(center),
              static_cast<const T*>(wf), static_cast<float*>(ws), npix, nbr, parts);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return e1;
  return launch_reduce(static_cast<const float*>(ws), parts, 3 * GRAM + 2 * C, 3 * GRAM,
                       static_cast<float*>(stats), static_cast<float*>(gaps), batch, stream);
}

template <typename T>
cudaError_t launch2(const void* w, const void* pr, const void* center, const void* wa,
                    const void* wproj, const void* wf, void* fo, void* ws, void* gap, int batch,
                    int npix, int nbr, int parts, cudaStream_t stream) {
  const cudaError_t err = allow_smem(msa2_kernel<T>, s2_smem<T>());
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH(msa2_kernel<T>, dim3(parts, batch / nbr), s2_smem<T>(), stream,
              static_cast<const T*>(w), static_cast<const T*>(pr), static_cast<const T*>(center),
              static_cast<const T*>(wa), static_cast<const T*>(wproj), static_cast<const T*>(wf),
              static_cast<T*>(fo), static_cast<float*>(ws), npix, nbr, parts);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return e1;
  return launch_reduce(static_cast<const float*>(ws), parts, C, C, static_cast<float*>(gap),
                       nullptr, batch, stream);
}

bool bad_shape(int batch, int h, int wd, int nbr) {
  return batch <= 0 || h <= 0 || wd <= 0 || nbr <= 0 || batch % nbr != 0 ||
         batch / nbr > 65535 || static_cast<long long>(h) * wd > (1LL << 31) / C;
}

// floats of one block's partial sums in stage 1 and stage 2
constexpr int S1_PART = 3 * GRAM + 2 * C, S2_PART = C;

int workspace(int batch, int h, int wd, int nbr, int per_part) {
  if (bad_shape(batch, h, wd, nbr)) return -1;
  return workspace_floats((h * wd + NP - 1) / NP, batch / nbr, batch, per_part);
}

}  // namespace

// The float32 scratch cdfo_msa_stage1 and cdfo_msa_stage2 need for `batch`
// neighbour images of h x wd, nbr per centre, on the current device, in
// floats; -1 if there is none.
extern "C" int cdfo_msa_stage1_workspace(int batch, int h, int wd, int nbr) {
  return workspace(batch, h, wd, nbr, S1_PART);
}

extern "C" int cdfo_msa_stage2_workspace(int batch, int h, int wd, int nbr) {
  return workspace(batch, h, wd, nbr, S2_PART);
}

// w (warped), pr (pred): (batch, h, wd, 64) NHWC; center: (batch / nbr, h,
// wd, 64); wf: the fusion_out 1x1 (64 out, 128 in) in
// ops/cuda_build.py::kernel_weights' layout; all of one dtype (is_bf16: 1
// bfloat16, 0 float32). ws: ws_floats of float32 scratch, as
// cdfo_msa_stage1_workspace sizes it ([batch][parts][3*64*64 + 128]);
// stats: [batch][3][64][64] and gaps: [batch][2][64] float32 out. Two
// launches (partials, reduction). Returns a cudaError_t.
extern "C" int cdfo_msa_stage1(const void* w, const void* pr, const void* center, const void* wf,
                               void* ws, int ws_floats, void* stats, void* gaps, int is_bf16,
                               int batch, int h, int wd, int nbr, void* stream) {
  const int parts = parts_of(ws_floats, batch, S1_PART);
  if (bad_shape(batch, h, wd, nbr) || parts <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch1<bf16>(w, pr, center, wf, ws, stats, gaps, batch, h * wd, nbr, parts, s)
                 : launch1<float>(w, pr, center, wf, ws, stats, gaps, batch, h * wd, nbr, parts,
                                  s);
}

// As stage 1, plus wa: [batch] per-image (64 out, 128 in) matrices [awt;
// apt]^T in kernel_weights' layout, one image per tap; wproj: the 1x1
// projection in that layout; fo: (batch, h, wd, 64) out; ws: ws_floats of
// float32 scratch, as cdfo_msa_stage2_workspace sizes it ([batch][parts]
// [64]); gap: [batch][64] float32 out. Returns a cudaError_t.
extern "C" int cdfo_msa_stage2(const void* w, const void* pr, const void* center, const void* wa,
                               const void* wproj, const void* wf, void* fo, void* ws,
                               int ws_floats, void* gap, int is_bf16, int batch, int h, int wd,
                               int nbr, void* stream) {
  const int parts = parts_of(ws_floats, batch, S2_PART);
  if (bad_shape(batch, h, wd, nbr) || parts <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch2<bf16>(w, pr, center, wa, wproj, wf, fo, ws, gap, batch, h * wd, nbr,
                                 parts, s)
                 : launch2<float>(w, pr, center, wa, wproj, wf, fo, ws, gap, batch, h * wd, nbr,
                                  parts, s);
}
