"""The convolution-tile CUDA kernels' own code, run on the CPU.

A CUDA kernel has no interpret mode, so this test compiles each
``cdfo_tpu_torch/csrc/*.cu`` built on ``conv3x3_tile.cuh`` (Block_, its
body pair, group tail, head, alignment tail, the two MDTA passes, the two
dual-MSA passes with their reduction launch, EGLA's eg1 with its two
launches and eg2, the int8 Block_, the block warp, EGLA's long-range
attention, and the trunk probes:
the dot probes with their partial-sum launch and the DMA probes) with the
host C++ compiler against a small emulation of the CUDA
subset they use (``_SHIM`` below): blocks run one after another with 256
threads each (or the count a launch names), the CTAs of a cluster at once,
each with shared memory of its own (the cluster barrier a barrier of all
their threads, an asynchronous store into another CTA's shared memory a
copy that completes on its mbarrier), ``__syncthreads`` and the named
barriers are barriers, ``mma.sync`` / ``ldmatrix`` / ``stmatrix`` (plain and transposed)
and the warp shuffles exchange their values through per-warp memory, a
warpgroup's ``wgmma`` (bf16 and s8) through per-warpgroup memory, reading
its shared tiles through their descriptors (128-byte swizzled, or without
swizzle as the s8 routes keep them), a bulk copy or a TMA row copy is a
copy whose bytes count off its mbarrier's expected bytes (the phase
completes at zero) and a ``cp.async`` a plain copy (or zero fill). The
wrappers then take their kernel route
on CPU tensors and are held against their plain versions at small ragged
shapes, in float32 and bfloat16, with the tolerances of
``ops/kernel_cases.py``. It checks the kernels' indexing, borders,
tiling and fragment layouts; speed and the real compiler are the card's
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import concurrent.futures
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cdfo_tpu_torch.ops import cuda_build as cb
from cdfo_tpu_torch.ops import fused_align as fal
from cdfo_tpu_torch.ops import fused_attention as fa
from cdfo_tpu_torch.ops import fused_block as fbody
from cdfo_tpu_torch.ops import fused_block2 as fb
from cdfo_tpu_torch.ops import fused_block2_q as fq
from cdfo_tpu_torch.ops import fused_egla as fe
from cdfo_tpu_torch.ops import fused_groupconv as fg
from cdfo_tpu_torch.ops import fused_head as fh
from cdfo_tpu_torch.ops import fused_mdta as fm
from cdfo_tpu_torch.ops import fused_tail as ft
from cdfo_tpu_torch.ops import kernel_cases as kc
from cdfo_tpu_torch.ops import probe_dma as pm
from cdfo_tpu_torch.ops import probe_dots as pd
from cdfo_tpu_torch.ops import warp_block as wb

# kind: (module, wrapper, plain version, library)
KERNELS = {
    "token": (fa, fa.token_self_attention, fa.token_attention_plain,
              "fused_attention"),
    "token_long": (fa, fa.token_self_attention, fa.token_attention_plain,
                   "fused_attention"),
    "column": (fa, fa.column_self_attention, fa.column_attention_plain,
               "fused_attention"),
    "body": (fbody, fbody.block_body, fbody.block_body_plain, "fused_block"),
    "block": (fb, fb.scale_block, fb.scale_block_plain, "fused_block2"),
    "blockq": (fq, fq.scale_block_q, fq.scale_block_q_plain, "fused_block2_q"),
    "group": (fg, fg.grouptail, fg.grouptail_plain, "fused_groupconv"),
    "head": (fh, fh.fused_head, fh.fused_head_plain, "fused_head"),
    "tail": (ft, ft.resblock_pair, ft.resblock_pair_plain, "fused_tail"),
    "mdta1": (fm, fm.mdta_stage1, fm.mdta_stage1_plain, "fused_mdta"),
    "mdta2": (fm, fm.mdta_stage2, fm.mdta_stage2_plain, "fused_mdta"),
    "msa1": (fal, fal.msa_stage1, fal.msa_stage1_plain, "fused_align"),
    "msa1_groups": (fal, fal.msa_stage1, fal.msa_stage1_plain, "fused_align"),
    "msa2": (fal, fal.msa_stage2, fal.msa_stage2_plain, "fused_align"),
    "eg1": (fe, fe.eg1_rows, fe.eg1_rows_plain, "fused_egla"),
    "eg2": (fe, fe.eg2_local_fuse, fe.eg2_local_fuse_plain, "fused_egla"),
    "eg2_odd": (fe, fe.eg2_local_fuse, fe.eg2_local_fuse_plain, "fused_egla"),
    **{f"warp_{case}": (wb, wb.flow_warp_ring_block,
                        wb.flow_warp_ring_block_plain, "warp_block")
       for case in kc.WARP_CASES},
}
# the trunk probes (bfloat16 only): kind: (module, wrapper, plain, library)
PROBES = {
    "dots": (pd, pd.dot_case, pd.dot_case_plain, "probe_dots"),
    "dots_resident": (pd, pd.dot_case, pd.dot_case_plain, "probe_dots"),
    "dots_streamed": (pd, pd.dot_case, pd.dot_case_plain, "probe_dots"),
    "rowpipe": (pd, pd.rowpipe, pd.rowpipe_plain, "probe_dots"),
    "rowpipe_mt2": (pd, pd.rowpipe, pd.rowpipe_plain, "probe_dots"),
    "kstack": (pd, pd.kstack, pd.kstack_plain, "probe_dots"),
    "gather": (pm, pm.gather, pm.gather_plain, "probe_dma"),
    "big": (pm, pm.big, pm.big_plain, "probe_dma"),
}

_SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__
#define __shared__
#define __grid_constant__
#define __cluster_dims__(...)
#define CDFO_HOST_MMA 1
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
inline thread_local emu_uint3 threadIdx;
inline thread_local emu_uint3 blockIdx;
inline dim3 blockDim(256);
inline dim3 gridDim;
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
// round-to-nearest single operations (never fused on the card)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __int2float_rn(int v) { return static_cast<float>(v); }
inline int __float2int_rn(float v) {   // saturates, as the card's does
  return static_cast<int>(rintf(fminf(fmaxf(v, -2147483520.f), 2147483520.f)));
}
template <class T> T __ldg(const T* p) { return *p; }
inline float rsqrtf(float x) { return 1.f / sqrtf(x); }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
inline int __float_as_int(float f) { int u; memcpy(&u, &f, 4); return u; }
struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u; memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(uint32_t(b.v) << 16); }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
// the card's 227 KB per block: a kernel asking for more fails, as on the card
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? 0 : 1;
}
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// a card of 2 SMs, so that a block sums several tiles and the reduction
// launch several partials
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated launch refused"; }
struct EmuWarp { uint32_t a[32][4]; uint32_t b[32][2]; const void* rows[32]; float f[32]; };
// one emulated CTA: its barriers (the block's, each warp's and each
// warpgroup's, up to 384 threads), its warps' and warpgroups' exchange
// memory and its shared memory; each of its threads points at them
struct EmuCta {
  std::barrier<> block;
  std::unique_ptr<std::barrier<>> warp_bars[12], wg_bars[3];
  std::barrier<>* warp[12];
  std::barrier<>* wg[3];
  EmuWarp warps[12];
  uint32_t wg_a[3][128][4];
  unsigned char* smem;
  std::unique_ptr<std::barrier<>> named_bars[8];
  std::barrier<>* named[8];
  EmuCta(unsigned threads, unsigned char* shared) : block(threads), smem(shared) {
    for (int i = 3; i < 8; ++i) {
      named_bars[i] = std::make_unique<std::barrier<>>(threads);
      named[i] = named_bars[i].get();
    }
    for (int i = 0; i < 12; ++i) {
      warp_bars[i] = std::make_unique<std::barrier<>>(32);
      warp[i] = warp_bars[i].get();
    }
    for (int i = 0; i < 3; ++i) {
      wg_bars[i] = std::make_unique<std::barrier<>>(128);
      wg[i] = wg_bars[i].get();
    }
  }
};
// a cluster's CTAs' shared memory (by rank) and its barrier
struct EmuCluster {
  unsigned char* smem[8];
  std::unique_ptr<std::barrier<>> bar;
};
inline thread_local std::barrier<>* emu_block_bar;
inline thread_local std::barrier<>** emu_warp_bar;
inline thread_local std::barrier<>** emu_wg_bar;
inline thread_local EmuWarp* emu_warp;
inline thread_local uint32_t (*emu_wg_a)[128][4];
inline thread_local unsigned char* emu_smem;   // this CTA's shared memory
inline thread_local std::barrier<>** emu_named;
inline thread_local EmuCluster* emu_cluster;
inline thread_local int emu_rank;
inline void emu_enter(EmuCta& cta, emu_uint3 block, unsigned thread) {
  threadIdx = {thread, 0, 0};
  blockIdx = block;
  emu_block_bar = &cta.block;
  emu_warp_bar = cta.warp;
  emu_wg_bar = cta.wg;
  emu_warp = cta.warps;
  emu_wg_a = cta.wg_a;
  emu_smem = cta.smem;
  emu_named = cta.named;
}
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async_commit() {}
inline void cp_async_wait() {}
inline float emu_half(uint32_t v, int hi) { return __uint_as_float((hi ? v >> 16 : v & 0xffffu) << 16); }
// mma.sync.m16n8k16 row.col bf16 -> f32: lane 4g + t holds A rows g, g + 8
// (k 2t, 2t+1 and 2t+8, 2t+9), B column g (same k) and C rows g, g + 8,
// columns 2t, 2t+1
inline void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                     uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  EmuWarp& X = emu_warp[w];
  X.a[l][0] = a0; X.a[l][1] = a1; X.a[l][2] = a2; X.a[l][3] = a3;
  X.b[l][0] = b0; X.b[l][1] = b1;
  emu_warp_bar[w]->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  auto A = [&](int r, int k) {
    return emu_half(X.a[(r % 8) * 4 + (k % 8) / 2][(r >= 8) + 2 * (k >= 8)], k & 1);
  };
  auto B = [&](int k, int n) { return emu_half(X.b[n * 4 + (k % 8) / 2][k >= 8], k & 1); };
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < 16; ++k) {
    d[0] += A(g, k) * B(k, 2 * t);
    d[1] += A(g, k) * B(k, 2 * t + 1);
    d[2] += A(g + 8, k) * B(k, 2 * t);
    d[3] += A(g + 8, k) * B(k, 2 * t + 1);
  }
  for (int i = 0; i < 4; ++i) c[i] += d[i];
  emu_warp_bar[w]->arrive_and_wait();
}
// mma.sync.m16n8k32 row.col s8 -> s32: lane 4g + t holds A rows g, g + 8
// (k 4t .. 4t+3 and 16+4t .. 16+4t+3, a byte each), B column g (same k)
// and C rows g, g + 8, columns 2t, 2t+1
inline void mma16832(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                     uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  EmuWarp& X = emu_warp[w];
  X.a[l][0] = a0; X.a[l][1] = a1; X.a[l][2] = a2; X.a[l][3] = a3;
  X.b[l][0] = b0; X.b[l][1] = b1;
  emu_warp_bar[w]->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  auto byte = [](uint32_t v, int i) { return int(int8_t((v >> (8 * i)) & 0xffu)); };
  auto A = [&](int r, int k) {
    return byte(X.a[(r % 8) * 4 + (k % 16) / 4][(r >= 8) + 2 * (k >= 16)], k % 4);
  };
  auto B = [&](int k, int n) { return byte(X.b[n * 4 + (k % 16) / 4][k >= 16], k % 4); };
  int d[4] = {0, 0, 0, 0};
  for (int k = 0; k < 32; ++k) {
    d[0] += A(g, k) * B(k, 2 * t);
    d[1] += A(g, k) * B(k, 2 * t + 1);
    d[2] += A(g + 8, k) * B(k, 2 * t);
    d[3] += A(g + 8, k) * B(k, 2 * t + 1);
  }
  for (int i = 0; i < 4; ++i) c[i] += d[i];
  emu_warp_bar[w]->arrive_and_wait();
}
// ldmatrix.x4: lane l gets bytes 4(l%4) .. 4(l%4)+3 of row l/4 of matrix j
// in r[j]; lanes 8j .. 8j+7 give matrix j's row addresses
inline void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_warp[w].rows[l] = row;
  emu_warp_bar[w]->arrive_and_wait();
  for (int j = 0; j < 4; ++j) {
    memcpy(&r[j], static_cast<const char*>(emu_warp[w].rows[j * 8 + l / 4]) + 4 * (l % 4), 4);
  }
  emu_warp_bar[w]->arrive_and_wait();
}
// ldmatrix.x4.trans: lane l gets elements (2(l%4), l/4) and (2(l%4)+1,
// l/4) of matrix j in r[j], the first in the low half
inline void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_warp[w].rows[l] = row;
  emu_warp_bar[w]->arrive_and_wait();
  for (int j = 0; j < 4; ++j) {
    const auto* r0 = static_cast<const __nv_bfloat16*>(emu_warp[w].rows[j * 8 + 2 * (l % 4)]);
    const auto* r1 = static_cast<const __nv_bfloat16*>(emu_warp[w].rows[j * 8 + 2 * (l % 4) + 1]);
    r[j] = uint32_t(r0[l / 4].v) | (uint32_t(r1[l / 4].v) << 16);
  }
  emu_warp_bar[w]->arrive_and_wait();
}
// warp shuffles: every lane of the warp takes part, as in the kernels
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_warp[w].f[l] = v;
  emu_warp_bar[w]->arrive_and_wait();
  const float r = emu_warp[w].f[src & 31];
  emu_warp_bar[w]->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned m, float v, int lane_mask) {
  return __shfl_sync(m, v, int(threadIdx.x % 32) ^ lane_mask);
}
namespace { alignas(1024) uint4 cdfo_smem[232448 / 16]; }
// blocks one after another, all sharing cdfo_smem
template <class F> void emu_launch(dim3 grid, F&& body, unsigned threads = 256) {
  blockDim = dim3(threads);
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        auto cta = std::make_unique<EmuCta>(threads, reinterpret_cast<unsigned char*>(cdfo_smem));
        std::vector<std::thread> threads_;
        for (unsigned i = 0; i < threads; ++i)
          threads_.emplace_back([&, i] { emu_enter(*cta, {x, y, z}, i); body(); });
        for (auto& t : threads_) t.join();
      }
  blockDim = dim3(256);
}
// clusters of `cluster` CTAs along x, one cluster after another; the CTAs
// of a cluster run at once, each with shared memory of its own, which the
// others reach through the cluster helpers below
template <class F> void emu_launch_cluster(dim3 grid, unsigned cluster, F&& body,
                                           unsigned threads = 256) {
  blockDim = dim3(threads);
  gridDim = grid;
  for (unsigned c = 0; c < grid.x / cluster; ++c) {
    EmuCluster cl;
    cl.bar = std::make_unique<std::barrier<>>(cluster * threads);
    std::vector<std::unique_ptr<uint4[]>> shared;
    std::vector<std::unique_ptr<EmuCta>> ctas;
    for (unsigned r = 0; r < cluster; ++r) {
      shared.push_back(std::make_unique<uint4[]>(232448 / 16));
      cl.smem[r] = reinterpret_cast<unsigned char*>(shared.back().get());
      ctas.push_back(std::make_unique<EmuCta>(threads, cl.smem[r]));
    }
    std::vector<std::thread> threads_;
    for (unsigned r = 0; r < cluster; ++r)
      for (unsigned i = 0; i < threads; ++i)
        threads_.emplace_back([&, r, i] {
          emu_enter(*ctas[r], {c * cluster + r, 0, 0}, i);
          emu_cluster = &cl;
          emu_rank = int(r);
          body();
        });
    for (auto& t : threads_) t.join();
  }
  blockDim = dim3(256);
}
#define CDFO_LAUNCH(kernel, grid, smem, stream, ...) emu_launch((grid), [&] { kernel(__VA_ARGS__); })
#define CDFO_LAUNCH_N(kernel, grid, threads, smem, stream, ...) \
  emu_launch((grid), [&] { kernel(__VA_ARGS__); }, (threads))
#define CDFO_LAUNCH_CLUSTER(kernel, grid, cluster, smem, stream, ...) \
  emu_launch_cluster((grid), (cluster), [&] { kernel(__VA_ARGS__); })
#define CDFO_LAUNCH_CLUSTER_N(kernel, grid, cluster, threads, smem, stream, ...) \
  emu_launch_cluster((grid), (cluster), [&] { kernel(__VA_ARGS__); }, (threads))
// the emulated card holds 3 clusters at once (of any size)
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  void* attrs;
  unsigned numAttrs;
};
template <class K> cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t*) {
  *n = 3;
  return 0;
}
// ex2.approx.ftz
inline float ex2(float x) { return exp2f(x); }
// wgmma_tile.cuh: shared addresses count from the CTA's shared memory;
// the products run at once; a bulk copy is a plain copy, after which its
// mbarrier counts one more completed phase, and mbar_wait waits for the
// phase of its parity
inline uint32_t shared_address(const void* p) {
  return uint32_t(static_cast<const unsigned char*>(p) - emu_smem);
}
inline unsigned char* dynamic_smem() { return emu_smem; }
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> void wgmma_wait() {}
template <class T> void keep(T&) {}
// (an mbarrier: its completed phases in the low 32 bits, the bytes it
// still expects in the high 32; a phase completes when they reach 0)
inline void mbar_init(uint64_t* bar, int) { std::atomic_ref<uint64_t>(*bar).store(0); }
inline void mbar_init_fence() {}
inline void emu_complete_tx(uint64_t* bar, uint32_t bytes) {
  std::atomic_ref<uint64_t> phases(*bar);
  const uint64_t tx = uint64_t(bytes) << 32;
  if (((phases.fetch_sub(tx) - tx) >> 32) == 0) {
    phases.fetch_add(1);
    phases.notify_all();
  }
}
// (bytes may land before they are expected: the count then passes below 0
// and the expectation completes the phase)
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::atomic_ref<uint64_t> phases(*bar);
  const uint64_t tx = uint64_t(bytes) << 32;
  if (((phases.fetch_add(tx) + tx) >> 32) == 0) {
    phases.fetch_add(1);
    phases.notify_all();
  }
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {   // sleeps until the copy lands
  std::atomic_ref<uint64_t> phases(*bar);
  for (uint64_t v = phases.load(); (v & 1) == parity; v = phases.load()) phases.wait(v);
}
inline void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  memcpy(dst, src, bytes);
  emu_complete_tx(bar, bytes);
}
// the TMA unit's row copies of a bf16 NHWC tensor (wgmma_tile.cuh): a box
// of box_w pixels of box_h rows, its pixel rows (c elements, 128 bytes but
// for a map of other lanes) one after another in row order, swizzled by
// their shared address (or not, a map made without swizzle), zero (load)
// or skipped (store) outside the tensor; a store completes at once
struct CUtensorMap { const char* base; int batch, h, wd, box_w, box_h; bool swizzle; int c; };
inline int nhwc_tensor_map(CUtensorMap* map, const void* base, int batch, int h, int wd,
                           int box_w, int box_h = 1, bool swizzle = true, int c = 64) {
  *map = {static_cast<const char*>(base), batch, h, wd, box_w, box_h, swizzle, c};
  return 0;
}
template <class F> void emu_tma_rows(const CUtensorMap* m, const void* smem, int x0, int y0, int b,
                                     F&& copy) {
  const int pix = 2 * m->c;
  for (int r = 0; r < m->box_h; ++r)
    for (int p = 0; p < m->box_w; ++p)
      for (int v = 0; v < pix / 16; ++v) {
        uint32_t a = shared_address(smem) + (r * m->box_w + p) * pix + v * 16;
        if (m->swizzle) a ^= ((a >> 7) & 7) << 4;
        const int xx = x0 + p, y = y0 + r;
        const bool in = b >= 0 && b < m->batch && y >= 0 && y < m->h && xx >= 0 && xx < m->wd;
        copy(reinterpret_cast<char*>(emu_smem) + a,
             in ? m->base + ((static_cast<long long>(b) * m->h + y) * m->wd + xx) * pix + v * 16
                : nullptr);
      }
}
inline void tma_load_row(void* dst, const CUtensorMap* m, int x0, int y, int b, uint64_t* bar) {
  emu_tma_rows(m, dst, x0, y, b, [](char* s, const char* g) {
    if (g) memcpy(s, g, 16); else memset(s, 0, 16);
  });
  emu_complete_tx(bar, m->box_w * m->box_h * 2 * m->c);
}
inline void tma_store_row(const CUtensorMap* m, const void* src, int x0, int y, int b) {
  emu_tma_rows(m, src, x0, y, b, [](char* s, const char* g) {
    if (g) memcpy(const_cast<char*>(g), s, 16);
  });
}
inline void bulk_commit() {}
template <int N = 0> void bulk_wait_read() {}
// the cluster helpers (wgmma_tile.cuh): the cluster barrier as a barrier
// of all the cluster's threads, split into its arrival and its wait; an
// asynchronous remote store as a copy into the other CTA's shared memory
// at the same offset, completing its bytes on that CTA's mbarrier
inline thread_local std::optional<std::barrier<>::arrival_token> emu_token;
inline int cluster_rank() { return emu_rank; }
inline void cluster_arrive() { emu_token.emplace(emu_cluster->bar->arrive()); }
inline void cluster_arrive_relaxed() { cluster_arrive(); }
inline void cluster_wait() {
  emu_cluster->bar->wait(std::move(*emu_token));
  emu_token.reset();
}
inline void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
inline void st_async_remote4(const float* local, int rank, float a, float b, float c, float d,
                             const uint64_t* bar) {
  const float v[4] = {a, b, c, d};
  memcpy(emu_cluster->smem[rank] + shared_address(local), v, 16);
  emu_complete_tx(reinterpret_cast<uint64_t*>(emu_cluster->smem[rank] + shared_address(bar)), 16);
}
inline float4 ld_remote4(const float* local, int rank) {
  float4 v;
  memcpy(&v, emu_cluster->smem[rank] + shared_address(local), 16);
  return v;
}
// named barriers 3 .. 7 of all the CTA's threads: the producers arrive, the
// consumers arrive and wait
inline void named_arrive(int id, int) { (void)emu_named[id]->arrive(); }
inline void named_sync(int id, int) { emu_named[id]->arrive_and_wait(); }
// stmatrix.trans: matrix j stored transposed, lane 4g + t's pair to bytes
// 2g .. 2g+1 of rows 2t and 2t + 1 (x2: matrices 0 and 1)
inline void emu_stsm_trans(void* row, const uint32_t* r, int n) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_warp[w].rows[l] = row;
  emu_warp_bar[w]->arrive_and_wait();
  const int g = l / 4, t = l % 4;
  for (int j = 0; j < n; ++j) {
    for (int e = 0; e < 2; ++e) {
      const uint16_t v = uint16_t(e ? r[j] >> 16 : r[j] & 0xffffu);
      memcpy(static_cast<char*>(const_cast<void*>(emu_warp[w].rows[j * 8 + 2 * t + e])) + 2 * g, &v, 2);
    }
  }
  emu_warp_bar[w]->arrive_and_wait();
}
inline void stsm_x4_trans(void* row, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  const uint32_t r[4] = {r0, r1, r2, r3};
  emu_stsm_trans(row, r, 4);
}
inline void stsm_x2_trans(void* row, uint32_t r0, uint32_t r1) {
  const uint32_t r[2] = {r0, r1};
  emu_stsm_trans(row, r, 2);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline float atomicAdd(float* p, float v) {
  static std::mutex m;
  std::lock_guard<std::mutex> lock(m);
  const float old = *p;
  *p = old + v;
  return old;
}
inline void async_fence() {}
inline void warpgroup_sync(int wg) { emu_wg_bar[wg]->arrive_and_wait(); }
inline void cp_async16_or_zero(void* dst, const void* src, bool valid) {
  if (valid) memcpy(dst, src, 16); else memset(dst, 0, 16);
}
template <int N> void cp_async_wait_n() {}
inline void __syncwarp() {}
// wgmma m64nNk16 bf16 -> f32. A from registers (warp w of the warpgroup:
// rows 16w .. 16w+15 in the m16n8k16 A-fragment layout) or, with a_desc,
// a K-major tile like B (or MN-major, trans_a). B a K-major tile read
// through its descriptor (element (k, n) at row n, byte 2k), or MN-major
// (trans_b: row k, byte 2 (n % 64) of the 64-column block n / 64, blocks
// LBO bytes apart). A descriptor tile is 128-byte swizzled (mode 1, 8-row groups 1024
// bytes apart, byte b of row r at start + (r / 8) * 1024 + (r % 8) * 128 +
// b with its bits 4-6 XORed with its bits 7-9) or without swizzle (mode 0,
// 8-row groups 128 bytes apart: core matrices of 8 rows of 16 bytes, byte b
// of row r at start + (r / 8) * 128 + (r % 8) * 16 + (b / 16) * LBO + b %
// 16); any other form reads as NaN (bf16) or -128 (s8), which the
// comparisons catch
inline bool emu_addr(uint64_t desc, int row, int byte, uint32_t& addr) {
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t lbo = uint32_t((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  const int mode = int(desc >> 62);
  if (mode == 1 && sbo == 1024) {
    addr = start + (row / 8) * sbo + (row % 8) * 128 + byte;
    addr ^= ((addr >> 7) & 7) << 4;
    return true;
  }
  if (mode == 0 && sbo == 128 && ((desc >> 49) & 7) == 0) {
    addr = start + (row / 8) * sbo + (row % 8) * 16 + (byte / 16) * lbo + byte % 16;
    return true;
  }
  return false;
}
inline float emu_tile(uint64_t desc, int row, int col) {   // bf16 element `col` of row `row`
  uint32_t addr;
  if (!emu_addr(desc, row, 2 * col, addr)) return NAN;
  uint16_t v;
  memcpy(&v, emu_smem + addr, 2);
  return __uint_as_float(uint32_t(v) << 16);
}
inline int emu_tile_s8(uint64_t desc, int row, int k) {   // s8 element k of row `row`
  uint32_t addr;
  if (!emu_addr(desc, row, k, addr)) return -128;
  return int(reinterpret_cast<const int8_t*>(emu_smem)[addr]);
}
// an MN-major (transposed) tile, 128-byte swizzled: element (k, mn) at
// row k of its 64-column block mn / 64, blocks LBO bytes apart
inline float emu_tile_mn(uint64_t desc, int k, int mn) {
  const uint64_t lbo = ((desc >> 16) & 0x3FFF) << 4;
  return emu_tile(desc + ((mn / 64) * lbo >> 4), k, mn % 64);
}
template <int N>
void emu_wgmma(float (&d)[N / 8][4], const uint32_t* a, uint64_t a_desc, uint64_t desc,
               bool trans_b, bool trans_a = false, int scale_d = 1) {
  const int tid = threadIdx.x, wg = tid / 128, r = tid % 128;
  if (a) memcpy(emu_wg_a[wg][r], a, 16);
  emu_wg_bar[wg]->arrive_and_wait();
  const int l = r % 32, g = l >> 2, t = l & 3, w = r / 32;
  auto A = [&](int row, int k) {   // row of this warp's 16
    if (!a) return trans_a ? emu_tile_mn(a_desc, k, 16 * w + row) : emu_tile(a_desc, 16 * w + row, k);
    const uint32_t* lane_regs = emu_wg_a[wg][w * 32 + (row % 8) * 4 + (k % 8) / 2];
    return emu_half(lane_regs[(row >= 8) + 2 * (k >= 8)], k & 1);
  };
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i >= 2), col = 8 * j + 2 * t + (i & 1);
      float sum = 0.f;
      for (int k = 0; k < 16; ++k) {
        sum += A(row, k) * (trans_b ? emu_tile_mn(desc, k, col) : emu_tile(desc, col, k));
      }
      d[j][i] = scale_d ? d[j][i] + sum : sum;
    }
  emu_wg_bar[wg]->arrive_and_wait();
}
inline void wgmma_64x64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc,
                        int scale_d = 1) {
  emu_wgmma<64>(d, a, 0, desc, false, false, scale_d);
}
inline void wgmma_64x32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t desc) {
  emu_wgmma<32>(d, a, 0, desc, false);
}
inline void wgmma_64x16(float (&d)[2][4], const uint32_t (&a)[4], uint64_t desc,
                        int scale_d = 1) {
  emu_wgmma<16>(d, a, 0, desc, false, false, scale_d);
}
inline void wgmma_64x64_tb(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc,
                           int scale_d = 1) {
  emu_wgmma<64>(d, a, 0, desc, true, false, scale_d);
}
template <int N>
void emu_wgmma_ss(float (&d)[N / 8][4], uint64_t a_desc, uint64_t desc, int scale_d = 1) {
  emu_wgmma<N>(d, nullptr, a_desc, desc, false, false, scale_d);
}
inline void wgmma_ss_64x80(float (&d)[10][4], uint64_t a, uint64_t b) { emu_wgmma_ss<80>(d, a, b); }
inline void wgmma_ss_64x120(float (&d)[15][4], uint64_t a, uint64_t b) { emu_wgmma_ss<120>(d, a, b); }
inline void wgmma_ss_64x136(float (&d)[17][4], uint64_t a, uint64_t b) { emu_wgmma_ss<136>(d, a, b); }
inline void wgmma_ss_64x64(float (&d)[8][4], uint64_t a, uint64_t b, int scale_d = 1) {
  emu_wgmma_ss<64>(d, a, b, scale_d);
}
inline void wgmma_ss_64x96(float (&d)[12][4], uint64_t a, uint64_t b, int scale_d = 1) {
  emu_wgmma_ss<96>(d, a, b, scale_d);
}
inline void wgmma_ss_64x128(float (&d)[16][4], uint64_t a, uint64_t b, int scale_d = 1) {
  emu_wgmma_ss<128>(d, a, b, scale_d);
}
inline void wgmma_ss_64x256(float (&d)[32][4], uint64_t a, uint64_t b, int scale_d = 1) {
  emu_wgmma_ss<256>(d, a, b, scale_d);
}
inline void wgmma_ss_64x128_tt(float (&d)[16][4], uint64_t a, uint64_t b, int scale_d = 1) {
  emu_wgmma<128>(d, nullptr, a, b, true, true, scale_d);
}
inline void wgmma_ss_64x64_tt(float (&d)[8][4], uint64_t a, uint64_t b, int scale_d = 1) {
  emu_wgmma<64>(d, nullptr, a, b, true, true, scale_d);
}
inline void wgmma_ss_64x64_tb(float (&d)[8][4], uint64_t a, uint64_t b, int scale_d = 1) {
  emu_wgmma<64>(d, nullptr, a, b, true, false, scale_d);
}
// wgmma m64nNk32 s8 -> s32: A from registers (warp w: rows 16w .. 16w+15 in
// the m16n8k32 A-fragment layout) or a K-major tile; B a K-major tile
template <int N>
void emu_wgmma_s8(int (&d)[N / 8][4], const uint32_t* a, uint64_t a_desc, uint64_t desc) {
  const int tid = threadIdx.x, wg = tid / 128, r = tid % 128;
  if (a) memcpy(emu_wg_a[wg][r], a, 16);
  emu_wg_bar[wg]->arrive_and_wait();
  const int l = r % 32, g = l >> 2, t = l & 3, w = r / 32;
  auto A = [&](int row, int k) {   // row of this warp's 16
    if (!a) return emu_tile_s8(a_desc, 16 * w + row, k);
    const uint32_t* lane_regs = emu_wg_a[wg][w * 32 + (row % 8) * 4 + (k % 16) / 4];
    return int(int8_t((lane_regs[(row >= 8) + 2 * (k >= 16)] >> (8 * (k % 4))) & 0xffu));
  };
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i >= 2), col = 8 * j + 2 * t + (i & 1);
      int sum = 0;
      for (int k = 0; k < 32; ++k) sum += A(row, k) * emu_tile_s8(desc, col, k);
      d[j][i] += sum;
    }
  emu_wg_bar[wg]->arrive_and_wait();
}
inline void wgmma_ss_s8_64x64(int (&d)[8][4], uint64_t a, uint64_t b) {
  emu_wgmma_s8<64>(d, nullptr, a, b);
}
inline void wgmma_s8_64x32(int (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  emu_wgmma_s8<32>(d, a, 0, b);
}

"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{kind: ctypes library} of the kernels built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "kernels")
    d = tmp_path_factory.mktemp("emulated_kernels")
    (d / "shim.h").write_text(_SHIM)
    (d / "inc").mkdir()
    for header in ("cuda.h", "cuda_bf16.h", "cuda_runtime.h"):
        (d / "inc" / header).write_text("")

    def compile_one(name):
        out = d / f"{name}.so"
        proc = subprocess.run(
            [cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared",
             "-fPIC", "-pthread", "-include", str(d / "shim.h"), "-x", "c++",
             str(cb.CSRC / f"{name}.cu"), "-I", str(cb.CSRC), "-I",
             str(d / "inc"), "-o", str(out)],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return out

    table = {**KERNELS, **PROBES}
    names = sorted({k[3] for k in table.values()})
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(compile_one, names)))
    return {kind: ctypes.CDLL(str(paths[k[3]])) for kind, k in table.items()}


# NHWC shapes that span several tiles of each kernel; the MDTA and MSA
# passes take (images or centres, H, W) with 3 neighbours per centre: MSA
# tiles of 128 pixels ending inside a row. The int8 Block_: two column strips of three serial
# steps each, the second strip ragged, the first step's rows 40x brighter
# than the later ones (``_case``). The tail: 3 neighbours of one image,
# three 24-column strips (the last ragged) of two 8-row steps (the second
# ragged), which the emulated card's 2 SMs split inside a strip. The head
# (3 images) and MDTA stage 1 (one image, ``ALIGN_EMBED_SHAPES``): three
# 62-column strips, the last 5 wide, walked a row a step, which the 2 SMs
# split inside the second strip (the head's after an image boundary). The
# group tail and MDTA stage 2 (one image of 7 rows): three 62-column
# strips, the last 5 wide, walked two rows a step (an odd row count: each
# walk's last step drops its second row), which the 2 SMs split inside the
# second strip (its 4th row). eg1 (bfloat16: the projection and band walk,
# then the row attention): three frames of 5 rows, three 64-column strips
# (the last 12 wide), which the 2 SMs split inside a strip of the second
# frame, the H-band past both image edges; the row's keys split over the
# warpgroups as 128 and 12 (of 128), three query tiles, the last ragged,
# each SM's walk crossing rows (the next row's K coming into the second
# buffer); float32: two query tiles and three key tiles a row, the last
# ragged. eg2 (bfloat16: the window walk, three windows a step, one per
# warpgroup): three frames of two windows, which the 2 SMs split inside the
# second frame, so that a step's windows cross a frame (``eg2``); five
# frames of one window, so that each SM's last step lacks windows (the
# step repeats its last window and drops it; float32: a tile whose second
# window is outside, ``eg2_odd``). Dual-MSA stage 2 (bfloat16: the walk):
# 3 centres of 3 neighbours, 190 pixels (two 128-pixel units, the second
# ragged), which
# the 2 SMs split inside the second centre, so that each walks across a
# centre. Dual-MSA stage 1 (bfloat16: groups of nbr CTAs, as many as the
# SMs hold): 2 centres of 3 neighbours, one group of 3 whose walk crosses
# the centre (``msa1``); 3 centres of 1 neighbour, two groups that split
# the second centre (``msa1_groups``). The body pair (bfloat16: clusters of
# 4 CTAs walking 62-column strips a row a step): one image of 7 rows, two
# strips (the second 38 wide), which the emulated card's 3 clusters split
# inside each strip, so that the second cluster's walk crosses from the
# first strip to the second. The block warp (bfloat16: each warp walks its
# share of the blocks, images fastest): 5 images from a ring of 3 frames of
# 20 x 36, 5 x 9 blocks, the bottom row per pixel, 32 walkers of 7 blocks
SHAPES = {"block": (1, 10, 12, 64), "blockq": (1, 24, 12, 64),
          "body": (1, 7, 100, 64),
          "group": (1, 7, 129, 64),
          "head": (3, 5, 129, 64), "tail": (1, 12, 54, 64)}
WARP_SHAPE = (3, 5, 20, 36)
# the int8 Block_'s bright rows: the top step's own, out of every later
# step's windows (their xm, z and y windows start at row 6 and below)
BRIGHT_ROWS, BRIGHT = 6, 40.0
EGLA_SHAPES = {"eg1": (3, 5, 140, 64), "eg2": (3, 8, 16, 64),
               "eg2_odd": (5, 8, 8, 64)}
ALIGN_EMBED_SHAPES = {"mdta1": (1, 5, 129), "mdta2": (1, 7, 129),
                      "msa2": (3, 10, 19)}
# the kinds whose inputs and tolerances are another kind's, at shapes of
# their own
SAME_AS = {"msa1_groups": "msa1", "eg2_odd": "eg2"}
# (neighbours a centre, (centres, H, W)) of an MSA case with other than 3
ALIGN_NBR = {"msa1_groups": (1, (3, 10, 19))}
# the attention (bfloat16: its three routes): columns of a ragged H read in
# place from NHWC (H <= 272: one warpgroup on wgmma, three 64-query tiles,
# the last moved back); tokens past 272 positions (two passes over the keys
# on mma.sync, 19 strips over 8 warps); one token longer than the 512
# positions kept resident (the chunked walk)
ATTENTION_SHAPES = {"token": (1, 300, 64), "token_long": (1, 520, 64),
                    "column": (1, 150, 2, 64)}


def _case(kind, dtype):
    """The kernel's arguments at small ragged shapes (C = 64, as the
    kernels take)."""
    g = torch.Generator().manual_seed(5)
    if kind == "body":
        return kc.body_args(dtype, g, SHAPES[kind], device="cpu")
    if kind == "blockq":
        x, *params = kc.trunk_args(kind, dtype, g, SHAPES[kind],
                                   device="cpu")
        x[:, :BRIGHT_ROWS] *= BRIGHT
        return (x, *params)
    if kind in SHAPES:
        return kc.trunk_args(kind, dtype, g, SHAPES[kind],
                             nbr=3 if kind == "tail" else 2, device="cpu")
    if kind in ATTENTION_SHAPES:
        return kc.attention_args(dtype, g, ATTENTION_SHAPES[kind],
                                 device="cpu")
    if kind in EGLA_SHAPES:
        return kc.egla_args(SAME_AS.get(kind, kind), dtype, g,
                            EGLA_SHAPES[kind], device="cpu")
    if kind.startswith("warp_"):
        return kc.warp_args(kind[5:], dtype, g, WARP_SHAPE, device="cpu")
    if kind in ALIGN_NBR:
        nbr, shape = ALIGN_NBR[kind]
        return kc.align_embed_args(SAME_AS[kind], dtype, g, shape, nbr,
                                   device="cpu")
    return kc.align_embed_args(kind, dtype, g,
                               ALIGN_EMBED_SHAPES.get(kind, (2, 10, 19)), 3,
                               device="cpu")


def _route_through(monkeypatch, lib):
    """The wrappers' kernel route on CPU tensors, through the emulated
    library."""

    def kernel_function(name, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.cdfo_cuda_error_string.restype = ctypes.c_char_p
        return fn, lib.cdfo_cuda_error_string

    def launch(kernel, what, device, *args):
        fn, err_str = kernel
        err = fn(*args, None)
        assert err == 0, f"{what}: {err_str(err)}"

    monkeypatch.setattr(cb, "kernel_function", kernel_function)
    monkeypatch.setattr(cb, "launch", launch)
    monkeypatch.setattr(cb, "on_card", lambda t, what: True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(KERNELS))
def test_emulated_kernel_matches_plain(emulated, monkeypatch, kind, dtype):
    module, wrapper, plain, _ = KERNELS[kind]
    _route_through(monkeypatch, emulated[kind])
    module._kernel.cache_clear()
    try:
        args = _case(kind, dtype)
        before = wrapper.launches
        with torch.no_grad():
            out = wrapper(*args)
            ref = plain(*args)
    finally:
        module._kernel.cache_clear()
    assert wrapper.launches == before + 1
    kc.assert_outputs_close(out, ref, dtype, SAME_AS.get(kind, kind))
    if kind == "blockq":
        # the third step on its own scale: its lagged y scales come from the
        # bright first step (the running max), not from the dim second one
        kc.assert_outputs_close(out[:, 16:], ref[:, 16:], dtype, kind)


def _unnormalised_rounding(q, v):
    """The attention with exp(s - max) rounded to bfloat16 before P.V and
    the row sum divided out after it: the rounding point of the kernel
    before its redesign, where the TPU kernel rounds the normalised p."""
    qf = q.float()
    s = torch.matmul(qf, qf.transpose(-1, -2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.matmul(e.bfloat16().float(), v.float())
    return (out / e.sum(-1, keepdim=True)).to(v.dtype)


@pytest.mark.parametrize("kind", ["token", "column", "eg1"])
def test_emulated_attention_rounds_the_normalised_p(emulated, monkeypatch,
                                                    kind):
    """The bfloat16 attention rounds p = e / sum(e), as
    ``cdfo_tpu/ops/fused_attention.py`` and ``fused_egla.py`` do, and not
    exp(s - max): on the long-range attention's two routes (two passes on
    mma.sync past 272 positions, wgmma up to it) and on eg1's row attention
    (the keys split over two warpgroups), its output is several times
    nearer the normalised-p reference than the unnormalised one, which
    differs from it by far more than the kernel's own fp32 summation order
    does."""
    module = KERNELS[kind][0]
    _route_through(monkeypatch, emulated[kind])
    module._kernel.cache_clear()
    try:
        args = _case(kind, torch.bfloat16)
        with torch.no_grad():
            out = KERNELS[kind][1](*args)
    finally:
        module._kernel.cache_clear()
    if kind == "eg1":   # tokens are the image rows of the rounded q_s and v
        x, aq, cq, bv, cv, _ = (t.float() for t in args)
        q = (torch.matmul(x, aq[:, None]) + cq[:, None, None]).bfloat16()
        v = (torch.matmul(x, bv) + cv).bfloat16()
        q, v, out = (t.flatten(0, 1) for t in (q, v, out[1]))
    else:
        q, v = args
    if kind == "column":   # tokens are the columns: (B W, H, C)
        q, v, out = (t.permute(0, 2, 1, 3).flatten(0, 1) for t in (q, v, out))
    normalised = fa.token_attention_plain(q, v).float()
    unnormalised = _unnormalised_rounding(q, v).float()
    near = (out.float() - normalised).abs().mean().item()
    far = (out.float() - unnormalised).abs().mean().item()
    apart = (normalised - unnormalised).abs().mean().item()
    assert apart > 4 * near and far > 4 * near, (near, far, apart)


def _probe_case(kind):
    """A probe's arguments and the wrapper's keyword arguments at small
    ragged sizes (the kernels' m are 64, 128 and 256; a last pixel tile of
    4), reps split over the emulated card's 2 SMs: the dot probe at m = 64
    with K split over two CTAs (six 64-channel chunks of lhs and four
    planes fit no CTA), at m = 256 with its planes resident in shared
    memory, and the same streamed; rowpipe at m = 64, c = 192 (its weights
    split by input channels over a cluster of 3, whose rank 0 adds two
    warps' pixel rows) and at m = 128, 2 m-tiles a CTA (its weights held
    whole, two warpgroups taking turns); kstack at m = 64, c = 256 (split
    over a cluster of 4); the DMA probe at 10 patches of 6 x 32-channel pixels, two starts outside the
    ring (clamped into it) and one off a 64-lane boundary (the narrow
    map)."""
    g = torch.Generator().manual_seed(6)
    if kind == "dots":
        return (*kc.dots_args(g, 64, 384, 132, device="cpu"), 5), {}
    if kind in ("dots_resident", "dots_streamed"):
        return ((*kc.dots_args(g, 256, 64, 132, device="cpu"), 6),
                {"streamed": kind == "dots_streamed"})
    if kind in ("rowpipe", "kstack"):
        c = 192 if kind == "rowpipe" else 256
        return (*kc.rows_args(g, 64, c, 68, nrows=4, device="cpu"), 9,
                4), {}
    if kind == "rowpipe_mt2":
        return (*kc.rows_args(g, 128, 64, 68, nrows=4, device="cpu"), 9,
                4), {"mt": 2}
    ring, starts = kc.dma_args(np.random.RandomState(0), 16, 24, 32, 10, 6,
                               device="cpu")
    if kind == "big":
        return (ring, starts, pm.big_rows(16, 24, 10)), {}
    starts[2], starts[5] = 40, 10**6   # outside the ring: clamped into it
    starts[7] = 8 * 13                 # a lane off the 64-lane boundaries
    return (ring, starts, 8, 6 * 32), {}


@pytest.mark.parametrize("kind", list(PROBES))
def test_emulated_probe_matches_plain(emulated, monkeypatch, kind):
    module, wrapper, plain, _ = PROBES[kind]
    _route_through(monkeypatch, emulated[kind])
    module._kernel.cache_clear()
    try:
        args, kw = _probe_case(kind)
        before = wrapper.launches
        out = wrapper(*args, **kw)
        ref = plain(*args)
        if kind == "kstack":
            assert pd.kstack_mt(128, 64, 4) == 1
            assert pd.kstack_mt(64, 256, 4) == 1
    finally:
        module._kernel.cache_clear()
    assert wrapper.launches == before + 1
    kc.assert_outputs_close(out, ref, torch.bfloat16, kind)


def test_block_stage_weights_layout():
    """The bfloat16 Block_'s weight stream: stage (chunk, i) holds conv1's
    tap i (i < 9), the folded conv2's tap i - 9 (i < 25) or conv2's tap
    i - 25, as B[n][k] with its 16-byte chunks swizzled by n % 8."""
    g = torch.Generator().manual_seed(7)
    w1 = torch.randn(256, 64, 3, 3, generator=g)
    w2 = torch.randn(64, 256, 3, 3, generator=g)
    st = fb.stage_weights(w1, w2)
    assert st.shape == (4, 34, 64, 64) and st.dtype == torch.bfloat16
    wf = fb.fold_down_conv2(w2)
    n, k = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    at = st[:, :, n, ((k // 8) ^ (n % 8)) * 8 + k % 8]   # (chunk, stage, n, k)
    for ch in (0, 3):
        for i in (0, 4, 8):
            ref = w1[64 * ch:64 * ch + 64, :, i // 3, i % 3]
            assert torch.equal(at[ch, i], ref.bfloat16())
        for t in (0, 7, 15):
            ref = wf[:, 64 * ch:64 * ch + 64, t // 4, t % 4]
            assert torch.equal(at[ch, 9 + t], ref.bfloat16())
        for i in (0, 5, 8):
            ref = w2[:, 64 * ch:64 * ch + 64, i // 3, i % 3]
            assert torch.equal(at[ch, 25 + i], ref.bfloat16())


def test_int8_half_branch_stage_layout():
    """The int8 Block_'s 0.5x branch streams the exact Block_'s conv1 and
    conv2 stages of its dequantised weights, per chunk in that order, and
    no fold."""
    g = torch.Generator().manual_seed(8)
    w1 = torch.randn(256, 64, 3, 3, generator=g).bfloat16()
    w2 = torch.randn(64, 256, 3, 3, generator=g).bfloat16()
    st = fq.stage_half_weights(w1, w2)
    assert st.shape == (4, 18, 64, 64) and st.dtype == torch.bfloat16
    assert st.is_contiguous()
    exact = fb.stage_weights(w1, w2)
    assert torch.equal(st, torch.cat([exact[:, :9], exact[:, 25:]], dim=1))


def _unswizzle(st):
    """(..., rows, 64) -> the rows before ``fused_block2.swizzle128``."""
    rows = st.shape[-2]
    n, k = torch.meshgrid(torch.arange(rows), torch.arange(64), indexing="ij")
    return st[..., n, ((k // 8) ^ (n % 8)) * 8 + k % 8]


def test_head_stage_weights_layout():
    """The bfloat16 head's resident weights: upconv1's and upconv2's phase
    blocks (row 64p + n of a block set: torch output channel 4n + p), then
    conv_last's 9 taps as rows of the tap matrix, padded to 16 with zeros;
    the biases phase-major."""
    g = torch.Generator().manual_seed(9)
    w1, w2 = (torch.randn(256, 64, 1, 1, generator=g) for _ in range(2))
    b1, b2 = torch.randn(256, generator=g), torch.randn(256, generator=g)
    wl = torch.randn(1, 64, 3, 3, generator=g)
    st, b1p, none2, b2p, nonel = fh.pack_head_weights(w1, b1, w2, b2, wl,
                                                      torch.bfloat16)
    assert none2 is None and nonel is None
    assert st.shape == (528, 64) and st.dtype == torch.bfloat16
    rows = _unswizzle(st)
    for p in range(4):
        for n in (0, 17, 63):
            assert torch.equal(rows[64 * p + n], w1[4 * n + p, :, 0, 0].bfloat16())
            assert torch.equal(rows[256 + 64 * p + n], w2[4 * n + p, :, 0, 0].bfloat16())
            assert b1p[64 * p + n] == b1[4 * n + p].bfloat16()
            assert b2p[64 * p + n] == b2[4 * n + p].bfloat16()
    for tap in range(9):
        assert torch.equal(rows[512 + tap], wl[0, :, tap // 3, tap % 3].bfloat16())
    assert not rows[521:].any()


def test_head_conv_last_as_tap_partials():
    """conv_last (64 -> 1, 3x3, zero padding) at 4x is the bfloat16 head's
    9 tap partials z_tap = f . wl[tap] (the tap matrix of its pack) added
    at their shifts: sum over taps of z_tap(q + d_tap) + bl equals conv2d
    of the 4x feature, in float32, at a 4x feature that is zero outside
    the image as the kernel's is."""
    g = torch.Generator().manual_seed(10)
    f = torch.randn(2, 64, 20, 28, generator=g)
    wl = torch.randn(1, 64, 3, 3, generator=g) * 0.1
    bl = torch.randn(1, generator=g)
    taps = _unswizzle(fh.stage_head_weights(wl.new_zeros(256, 64, 1, 1),
                                            wl.new_zeros(256, 64, 1, 1), wl,
                                            torch.float32))[512:]
    z = torch.einsum("bchw,tc->bthw", f, taps)          # (B, 16, H, W)
    assert not z[:, 9:].any()
    zp = F.pad(z, (1, 1, 1, 1))
    h, w = f.shape[2:]
    out = bl + sum(zp[:, 3 * ky + kx, ky:ky + h, kx:kx + w]
                   for ky in range(3) for kx in range(3))
    ref = F.conv2d(f, wl, bl, padding=1)[:, 0]
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_mdta_stage1_weights_layout():
    """MDTA stage 1's bfloat16 pack: W_qkv as B[n][k] = w_qkv[n, k],
    128-byte swizzled, and the depthwise taps [9][3C] (tap 3 dy + dx)
    float32; float32 keeps kernel_weights and [3C][9]."""
    g = torch.Generator().manual_seed(11)
    w_qkv = torch.randn(192, 64, 1, 1, generator=g)
    w_dw = torch.randn(192, 1, 3, 3, generator=g)
    st, taps = fm.pack_stage1_weights(w_qkv, w_dw, torch.bfloat16)
    assert st.shape == (192, 64) and st.dtype == torch.bfloat16
    assert torch.equal(_unswizzle(st), w_qkv[:, :, 0, 0].bfloat16())
    assert taps.shape == (9, 192) and taps.dtype == torch.float32
    for ch in (0, 70, 191):
        for dy in range(3):
            for dx in range(3):
                assert taps[3 * dy + dx, ch] == w_dw[ch, 0, dy, dx]
    wk, taps32 = fm.pack_stage1_weights(w_qkv, w_dw, torch.float32)
    assert torch.equal(wk, cb.kernel_weights(w_qkv, torch.float32))
    assert torch.equal(taps32, w_dw.reshape(192, 9))


def test_grouptail_weights_layout():
    """The bfloat16 group tail's resident weights: the conv's 9 taps (3 ky
    + kx) as B[n][k] = w[n, k, ky, kx], 128-byte swizzled; float32 keeps
    kernel_weights."""
    g = torch.Generator().manual_seed(12)
    w = torch.randn(64, 64, 3, 3, generator=g)
    st = fg.pack_grouptail_weights(w, torch.bfloat16)
    assert st.shape == (9, 64, 64) and st.dtype == torch.bfloat16
    assert st.is_contiguous()
    rows = _unswizzle(st)
    for tap in range(9):
        assert torch.equal(rows[tap], w[:, :, tap // 3, tap % 3].bfloat16())
    assert torch.equal(fg.pack_grouptail_weights(w, torch.float32),
                       cb.kernel_weights(w, torch.float32))


def test_mdta_stage2_weights_layout():
    """MDTA stage 2's bfloat16 pack: W_proj as B[n][k] = w_proj[n, k] and
    the conv's 9 taps (3 ky + kx) as B[n][k] = w_conv[n, k, ky, kx], both
    128-byte swizzled (the attention matrices are per call, not packed);
    float32 keeps kernel_weights for both."""
    g = torch.Generator().manual_seed(13)
    w_proj = torch.randn(64, 64, 1, 1, generator=g)
    w_conv = torch.randn(64, 64, 3, 3, generator=g)
    pk, ck = fm.pack_stage2_weights(w_proj, w_conv, torch.bfloat16)
    assert pk.shape == (64, 64) and ck.shape == (9, 64, 64)
    assert pk.dtype == ck.dtype == torch.bfloat16
    assert torch.equal(_unswizzle(pk), w_proj[:, :, 0, 0].bfloat16())
    rows = _unswizzle(ck)
    for tap in range(9):
        assert torch.equal(rows[tap], w_conv[:, :, tap // 3, tap % 3].bfloat16())
    pk32, ck32 = fm.pack_stage2_weights(w_proj, w_conv, torch.float32)
    assert torch.equal(pk32, cb.kernel_weights(w_proj, torch.float32))
    assert torch.equal(ck32, cb.kernel_weights(w_conv, torch.float32))


def test_msa_stage2_weights_layout():
    """Dual-MSA stage 2's bfloat16 packs: W_proj as B[n][k] = w_proj[n, k]
    and W_fuse's halves as B[h][n][k] = w_fuse[n, 64 h + k], 128-byte
    swizzled (kept by the model); the per-image matrices, made each call,
    as B[b][0][n][k] = awt[b, k, n] and B[b][1][n][k] = apt[b, k, n],
    unswizzled (the kernel's TMA loads swizzle them); float32 keeps
    kernel_weights and the (C out, 2C in) matrix of [awt; apt]."""
    g = torch.Generator().manual_seed(14)
    w_proj = torch.randn(64, 64, 1, 1, generator=g)
    w_fuse = torch.randn(64, 128, 1, 1, generator=g)
    awt, apt = torch.randn(2, 3, 64, 64, generator=g)
    pk, fk = fal.pack_stage2_weights(w_proj, w_fuse, torch.bfloat16)
    assert pk.shape == (64, 64) and fk.shape == (2, 64, 64)
    assert pk.dtype == fk.dtype == torch.bfloat16 and fk.is_contiguous()
    assert torch.equal(_unswizzle(pk), w_proj[:, :, 0, 0].bfloat16())
    for h in range(2):
        assert torch.equal(_unswizzle(fk[h]),
                           w_fuse[:, 64 * h:64 * h + 64, 0, 0].bfloat16())
    mats = fal.pack_stage2_images(awt, apt, torch.bfloat16)
    assert mats.shape == (3, 2, 64, 64) and mats.is_contiguous()
    assert torch.equal(mats[:, 0], awt.transpose(1, 2).bfloat16())
    assert torch.equal(mats[:, 1], apt.transpose(1, 2).bfloat16())
    pk32, fk32 = fal.pack_stage2_weights(w_proj, w_fuse, torch.float32)
    assert torch.equal(pk32, cb.kernel_weights(w_proj, torch.float32))
    assert torch.equal(fk32, cb.kernel_weights(w_fuse, torch.float32))
    assert torch.equal(
        fal.pack_stage2_images(awt, apt, torch.float32),
        cb.matrix_weights(torch.cat([awt, apt], 1).transpose(1, 2),
                          torch.float32))


def test_eg1_weights_layout():
    """eg1's bfloat16 operands: aq as B[m][n][k] = aq[m, k, n] and bv as
    B[n][k] = bv[k, n], contiguous and unswizzled (the walk's TMA loads
    swizzle them); float32 keeps kernel_weights (aq one frame a tap)."""
    g = torch.Generator().manual_seed(15)
    aq = torch.randn(3, 64, 64, generator=g)
    bv = torch.randn(64, 64, generator=g)
    aqk, bvk = fe.pack_eg1_weights(aq, bv, torch.bfloat16)
    assert aqk.shape == (3, 64, 64) and bvk.shape == (64, 64)
    assert aqk.is_contiguous() and bvk.is_contiguous()
    assert torch.equal(aqk, aq.transpose(1, 2).bfloat16())
    assert torch.equal(bvk, bv.t().bfloat16())
    aq32, bv32 = fe.pack_eg1_weights(aq, bv, torch.float32)
    assert torch.equal(aq32, cb.matrix_weights(aq.transpose(1, 2),
                                               torch.float32))
    assert torch.equal(bv32, cb.kernel_weights(bv.t()[..., None, None],
                                               torch.float32))


def test_body_weights_layout():
    """The bfloat16 body pair's resident slices: CTA q of a cluster keeps
    conv1's 9 taps (3 ky + kx) as B[n][k] = w1[ky, kx, k, 64 q + n] and
    conv2's as B[n][k] = w2[ky, kx, 64 q + k, n], 128-byte swizzled;
    float32 keeps kernel_weights of each."""
    g = torch.Generator().manual_seed(16)
    w1 = torch.randn(3, 3, 64, 256, generator=g)
    w2 = torch.randn(3, 3, 256, 64, generator=g)
    st = fbody.pack_body_weights(w1, w2, torch.bfloat16)
    assert st.shape == (4, 2, 9, 64, 64) and st.dtype == torch.bfloat16
    assert st.is_contiguous()
    rows = _unswizzle(st)
    for q in (0, 3):
        for tap in (0, 4, 8):
            ky, kx = divmod(tap, 3)
            assert torch.equal(rows[q, 0, tap],
                               w1[ky, kx, :, 64 * q:64 * q + 64].t().bfloat16())
            assert torch.equal(rows[q, 1, tap],
                               w2[ky, kx, 64 * q:64 * q + 64, :].t().bfloat16())
    wk1, wk2 = fbody.pack_body_weights(w1, w2, torch.float32)
    assert torch.equal(wk1, cb.kernel_weights(w1.permute(3, 2, 0, 1),
                                              torch.float32))
    assert torch.equal(wk2, cb.kernel_weights(w2.permute(3, 2, 0, 1),
                                              torch.float32))


# A kernel of clusters of 4 CTAs that exercises the shim's cluster helpers
# alone: the cluster barrier, asynchronous stores into every CTA's shared
# memory that complete on its mbarrier before it expects their bytes, and a
# named barrier that one warpgroup passes and the other waits at.
_CLUSTER_PROBE = r"""
#include "wgmma_tile.cuh"

namespace {
using namespace cdfo;
constexpr int CL = 4;

__global__ void __cluster_dims__(CL, 1, 1) cluster_probe(float* out) {
  unsigned char* base = dynamic_smem();
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  float* flag = reinterpret_cast<float*>(base + 512);      // [128]
  float* recv = reinterpret_cast<float*>(base + 1024);     // [CL sources][THREADS][4]
  const int rank = cluster_rank(), t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  cluster_sync();
  for (int r = 0; r < CL; ++r) {
    st_async_remote4(recv + (rank * THREADS + t) * 4, r, float(rank), float(t),
                     float(blockIdx.x), 1.f, bar);
  }
  if (t >= 128) {
    flag[t - 128] = float(blockIdx.x * 1000 + t);
    named_arrive(3, THREADS);
  } else {
    named_sync(3, THREADS);
  }
  cluster_sync();   // every store has landed: the bytes come before their expectation
  if (t == 0) mbar_expect_tx(bar, CL * THREADS * 16);
  mbar_wait(bar, 0);
  float* mine = out + static_cast<long long>(blockIdx.x) * (CL * THREADS * 4 + 128);
  for (int i = t; i < CL * THREADS * 4; i += THREADS) mine[i] = recv[i];
  if (t < 128) mine[CL * THREADS * 4 + t] = flag[t];
  cluster_sync();
}
}  // namespace

// two clusters; out [8 CTAs][CL * THREADS * 4 + 128] float
extern "C" int cdfo_cluster_probe(float* out) {
  CDFO_LAUNCH_CLUSTER(cluster_probe, dim3(2 * CL), CL, 0, nullptr, out);
  return cudaGetLastError();
}
"""


def test_emulated_cluster_shim(tmp_path):
    """The shim's cluster helpers on their own: each CTA holds every CTA's
    asynchronous stores at the offset they were made at, and its mbarrier
    completes though their bytes landed before it expected them; warpgroup
    0 sees what warpgroup 1 stored before the named barrier."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "kernels")
    (tmp_path / "shim.h").write_text(_SHIM)
    (tmp_path / "inc").mkdir()
    for header in ("cuda.h", "cuda_bf16.h", "cuda_runtime.h"):
        (tmp_path / "inc" / header).write_text("")
    src, lib = tmp_path / "probe.cu", tmp_path / "probe.so"
    src.write_text(_CLUSTER_PROBE)
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-include",
         str(tmp_path / "shim.h"), "-x", "c++", str(src), "-I", str(cb.CSRC),
         "-I", str(tmp_path / "inc"), "-o", str(lib)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(lib)).cdfo_cluster_probe
    fn.argtypes = [ctypes.c_void_p]
    threads, cl = 256, 4
    out = torch.zeros(2 * cl, cl * threads * 4 + 128)
    assert fn(out.data_ptr()) == 0
    for cta in range(2 * cl):
        recv = out[cta, :cl * threads * 4].reshape(cl, threads, 4)
        first = cta - cta % cl
        for src in range(cl):
            want = torch.stack([torch.full((threads,), float(src)),
                                torch.arange(threads, dtype=torch.float32),
                                torch.full((threads,), float(first + src)),
                                torch.ones(threads)], dim=1)
            assert torch.equal(recv[src], want), (cta, src)
        flags = out[cta, cl * threads * 4:]
        assert torch.equal(flags, cta * 1000 + 128
                           + torch.arange(128, dtype=torch.float32)), cta
