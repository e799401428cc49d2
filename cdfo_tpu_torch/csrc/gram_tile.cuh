// Channel-attention statistics, shared by fused_mdta.cu and fused_align.cu:
// the three 64 x 64 grams [Q^T K, Q^T Q, K^T K] of a pixel tile held in
// shared memory (pixel-major, `Pitch<float>` per pixel, as conv3x3_tile.cuh
// keeps its windows), summed over the tiles a block walks, and the second
// launch that adds the blocks' partial sums. Only the float32 twins use
// the grams here (on the CUDA cores, in the mma C-fragment layout below);
// the bfloat16 routes run theirs on wgmma (wgmma_tile.cuh). The
// attention kernels take `ldsm_x4_trans` from here for their P.V reads.
//
// Warp w owns m-tile (w & 3) (left-factor channels 16(w & 3) .. +15) and
// n-tiles 4(w >> 2) .. +3 (right-factor channels 32(w >> 2) .. +31) of all
// three grams: acc[gram][nt][4] in the mma C-fragment layout.
//
// Partial sums go to a workspace and a second launch (`reduce_parts`) adds
// them in a fixed order, so a result is the same on every run (no
// atomics). The library sizes the workspace for the device
// (`workspace_floats`) and each launch takes its block count from the
// workspace it is given (`parts_of`).

#pragma once

#include "conv3x3_tile.cuh"

namespace cdfo {

constexpr int GRAM = C * C;   // elements of one gram

#ifndef CDFO_HOST_MMA
// ldmatrix.x4 transposed: lane l gets elements (2(l%4), l/4) and
// (2(l%4) + 1, l/4) of the four 8x8 b16 matrices whose rows lanes 0-7,
// 8-15, 16-23, 24-31 point at
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
#endif

__device__ __forceinline__ void zero_grams(float (&acc)[3][4][4]) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][nt][i] = 0.f;
}

// acc += this warp's share of [Q^T K, Q^T Q, K^T K] over pixels 0 .. npix-1
// of the tiles qs and ks.
__device__ __forceinline__ void gram3(float (&acc)[3][4][4], const float* qs, const float* ks,
                                      int npix, int warp, int lane) {
  constexpr int P = Pitch<float>::value;
  const int c = (warp & 3) * 16 + (lane >> 2), d0 = (warp >> 2) * 32 + (lane & 3) * 2;
#pragma unroll 1
  for (int p = 0; p < npix; ++p) {
    const float* q = qs + p * P;
    const float* k = ks + p * P;
    const float q0 = q[c], q8 = q[c + 8], k0 = k[c], k8 = k[c + 8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 kd = load2(k + d0 + 8 * nt), qd = load2(q + d0 + 8 * nt);
      float* a = acc[0][nt];
      a[0] = fmaf(q0, kd.x, a[0]); a[1] = fmaf(q0, kd.y, a[1]);
      a[2] = fmaf(q8, kd.x, a[2]); a[3] = fmaf(q8, kd.y, a[3]);
      a = acc[1][nt];
      a[0] = fmaf(q0, qd.x, a[0]); a[1] = fmaf(q0, qd.y, a[1]);
      a[2] = fmaf(q8, qd.x, a[2]); a[3] = fmaf(q8, qd.y, a[3]);
      a = acc[2][nt];
      a[0] = fmaf(k0, kd.x, a[0]); a[1] = fmaf(k0, kd.y, a[1]);
      a[2] = fmaf(k8, kd.x, a[2]); a[3] = fmaf(k8, kd.y, a[3]);
    }
  }
}

// Writes this warp's share of the three grams to dst [3][64][64].
__device__ __forceinline__ void store_grams(const float (&acc)[3][4][4], float* dst, int warp,
                                            int lane) {
  const int c = (warp & 3) * 16 + (lane >> 2), d0 = (warp >> 2) * 32 + (lane & 3) * 2;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* o = dst + g * GRAM + c * C + d0 + 8 * nt;
      store2(o, acc[g][nt][0], acc[g][nt][1]);
      store2(o + 8 * C, acc[g][nt][2], acc[g][nt][3]);
    }
}

// out[img][e] = sum over s < parts of ws[img][s][e], s in order, for the
// n floats of each partial: e < n_a go to out_a [img][n_a], the rest to
// out_b [img][n - n_a]. Grid (ceil(n / THREADS), images).
__global__ void __launch_bounds__(THREADS)
reduce_parts(const float* __restrict__ ws, int parts, int n, int n_a, float* __restrict__ out_a,
             float* __restrict__ out_b) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const long long img = blockIdx.y;
  const float* src = ws + img * parts * n + e;
  float s = 0.f;
  for (int i = 0; i < parts; ++i) s += src[static_cast<long long>(i) * n];
  if (e < n_a) {
    out_a[img * n_a + e] = s;
  } else {
    out_b[img * (n - n_a) + e - n_a] = s;
  }
}

inline cudaError_t launch_reduce(const float* ws, int parts, int n, int n_a, float* out_a,
                                 float* out_b, int images, cudaStream_t stream) {
  const dim3 grid((n + THREADS - 1) / THREADS, images);
  CDFO_LAUNCH(reduce_parts, grid, 0, stream, ws, parts, n, n_a, out_a, out_b);
  return cudaGetLastError();
}

// The floats of the workspace in which the blocks of a kernel leave their
// partial sums: `per_part` floats for each of `parts` blocks of each of
// `sums` images, where each of `groups` groups of images (a grid row) gets
// enough blocks for two resident on every SM of the current device, at
// most one per each of its `tiles` tiles. The kernel reads `parts` back
// from the size (parts_of), so the caller never computes it. -1 if the
// device cannot be asked or the size does not fit an int.
inline int workspace_floats(int tiles, int groups, int sums, int per_part) {
  const int sms = sm_count();
  if (tiles <= 0 || groups <= 0 || sms <= 0) return -1;
  const int want = (2 * sms + groups - 1) / groups;
  const long long n = static_cast<long long>(want < tiles ? want : tiles) * sums * per_part;
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// The blocks per image that a workspace of `floats` floats holds (0 if it is
// not a whole number of them, or more than a grid row takes).
inline int parts_of(int floats, int sums, int per_part) {
  const long long one = static_cast<long long>(sums) * per_part;
  if (floats <= 0 || floats % one != 0 || floats / one > 65535) return 0;
  return static_cast<int>(floats / one);
}

}  // namespace cdfo
