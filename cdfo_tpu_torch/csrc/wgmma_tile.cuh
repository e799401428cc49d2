// Hopper's warpgroup products and bulk copies, for the bfloat16 routes of
// fused_block2.cu (weights staged through shared memory), fused_attention.cu
// (the token resident), fused_tail.cu (the four convs), fused_block2_q.cu
// (its s8 products and its 0.5x branch's bf16 convs), fused_head.cu (its
// three chained products), fused_mdta.cu (stage 1's qkv and grams, stage
// 2's three products), fused_groupconv.cu (the group tail's conv),
// fused_align.cu (dual-MSA stage 1's key and grams, stage 2's three
// products), fused_egla.cu (eg1's projection and its row attention,
// eg2's window chain), fused_block.cu (the body pair's cluster walk: the
// cluster barrier, asynchronous stores into another CTA's shared memory,
// named barriers), warp_block.cu (its patches by TMA), probe_dots.cu (the
// dot and row probes' products) and probe_dma.cu (its patch gathers by
// TMA). Only those include this header; conv3x3_tile.cuh is unchanged for
// the rest.
//
// The wgmma forms used: m64nNk16, bf16 x bf16 -> fp32, A from registers (or,
// wgmma_ss_*, a K-major tile in shared memory like B) and B from shared
// memory (K-major, or MN-major in wgmma_64x64_tb and wgmma_ss_64x64_tb
// and, with A MN-major too, wgmma_ss_64x128_tt and wgmma_ss_64x64_tt);
// m64nNk32, s8 x s8 -> s32
// (`wgmma_*s8*`), both operands K-major (8-bit types take no transpose),
// either as the swizzle-free tiles of `wgmma_desc_plain` or, for A, in
// registers in the mma.sync.m16n8k32 A-fragment layout.
// - A: each warp of the warpgroup holds 16 of the 64 rows (warp w of the
//   warpgroup rows 16w .. 16w + 15) in the mma.sync.m16n8k16 A-fragment
//   layout, so an `ldmatrix` of any 16 pixels of a window feeds it (a
//   shifted tap window is no canonical shared-memory layout, registers
//   take any rows).
// - B: an N x 64 K-major tile, one 128-byte row per output channel n, its
//   16-byte chunk c stored at chunk c ^ (n & 7) (the 128-byte swizzle),
//   the tile 1024-byte aligned: descriptor `wgmma_desc` (8-row groups 1024
//   bytes apart). K step k16 of the tile is the descriptor advanced by 32
//   bytes (+2 in its 16-byte address units), N rows r0.. by 128 r0 bytes.
// - D: the accumulators in the C-fragment order of conv3x3_tile.cuh: lane
//   4g + t of warp w holds rows 16w + g and 16w + g + 8, channels
//   8j + 2t, 8j + 2t + 1 of n-tile j, as acc[j][0..3].
// With scale_d = 0 (wgmma_64x64, wgmma_64x16, wgmma_ss_64x64, _64x96) a product
// overwrites d instead of adding to it: the first k-step of a sum needs no
// zeroed accumulators.
// The products are asynchronous: `wgmma_fence` before a batch that reads
// registers written since the last one, `wgmma_commit` closes a group and
// `wgmma_wait<n>` waits until at most n groups are in flight. Until then
// the A registers and accumulators of a group must stay as they are:
// `keep` pins them (an empty asm that the compiler must treat as reading
// and writing them), so that it neither reuses nor moves them across the
// wait.
//
// The weights arrive by `cp.async.bulk` (a 1-D bulk copy through the TMA
// unit, one thread issuing it) into a ring of stages, each completing on
// its own mbarrier (`mbar_expect_tx`, then the copy; `mbar_wait` with the
// stage's phase parity). The 62-column strip walks (the group tail, MDTA
// stage 2) move their 64-pixel rows by the TMA unit's tensor copies
// (`tma_load_row`, `tma_store_row` on a `nhwc_tensor_map`), which swizzle
// and zero-fill as wgmma's tiles need; several loads may complete on one
// mbarrier that expects their bytes.
//
// tests/test_torch_kernel_emulation.py runs these through its host
// emulation (CDFO_HOST_MMA): the products synchronously, by the layouts
// above, and the bulk and tensor copies as plain copies that count their
// bytes off their mbarrier.

#pragma once

#include <cuda.h>

#include "conv3x3_tile.cuh"

namespace cdfo {

#ifndef CDFO_HOST_MMA
__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// 16 bytes global -> shared by cp.async, or 16 zero bytes where !valid (src
// then unread); completion by cp_async_wait_n
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_address(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// waits until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's ordinary shared-memory stores before reads by the
// async proxy (wgmma's descriptor operands); then a barrier
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 over the warpgroup) += A (registers) . B (descriptor)
__device__ __forceinline__ void wgmma_64x64(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (64 x 32 over the warpgroup) += A (registers) . B (descriptor)
__device__ __forceinline__ void wgmma_64x32(float (&d)[4][4], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 16 over the warpgroup) += A (registers) . B (descriptor): the
// head's conv_last taps (N = 9 padded to 16)
__device__ __forceinline__ void wgmma_64x16(float (&d)[2][4], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (64 x 96) += A (descriptor) . B (descriptor), both K-major: half of
// the MDTA qkv projection
__device__ __forceinline__ void wgmma_ss_64x96(float (&d)[12][4], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128) += A (descriptor) . B (descriptor), both MN-major: each
// tile's 128-byte rows run along M (or N) and its 8-row groups along K,
// B's two 64-column blocks `lead` bytes apart (wgmma_desc(tile, lead)):
// the MDTA and dual-MSA grams, pixels as K
__device__ __forceinline__ void wgmma_ss_64x128_tt(float (&d)[16][4], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64) += A (descriptor) . B (descriptor), both MN-major: the
// dual-MSA gram k^T k, pixels as K
__device__ __forceinline__ void wgmma_ss_64x64_tt(float (&d)[8][4], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64) += A (descriptor, K-major) . B (descriptor, MN-major): eg2's
// products of a window's tokens with a (C in, C out) matrix as it is
__device__ __forceinline__ void wgmma_ss_64x64_tb(float (&d)[8][4], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N over the warpgroup) += A (descriptor) . B (descriptor), both
// K-major: N = 80, 120, 136
__device__ __forceinline__ void wgmma_ss_64x80(float (&d)[10][4], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_64x120(float (&d)[15][4], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, "
      "%60, %61, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_64x136(float (&d)[17][4], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67}, "
      "%68, %69, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]),
        "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64) += A (registers) . B (descriptor), B MN-major: the tile's
// 128-byte rows run along N (64 columns) and its 8-row groups along K
__device__ __forceinline__ void wgmma_64x64_tb(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (64 x 64) += A (descriptor) . B (descriptor), both K-major: the
// alignment tail's convs, pixels as A and a weight tap as B
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[8][4], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128) += A (descriptor) . B (descriptor), both K-major: the dot
// probe at m = 128, the row probes at 128 output channels a CTA
__device__ __forceinline__ void wgmma_ss_64x128(float (&d)[16][4], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),
        "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),
        "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),
        "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256) += A (descriptor) . B (descriptor), both K-major: the dot
// probe at m = 256 (128 accumulators a thread)
__device__ __forceinline__ void wgmma_ss_64x256(float (&d)[32][4], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),
        "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),
        "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),
        "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]),
        "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]),
        "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]),
        "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]),
        "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), "+f"(d[24][0]),
        "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]),
        "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]),
        "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]),
        "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), "+f"(d[30][0]), "+f"(d[30][1]),
        "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]),
        "+f"(d[31][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The s8 forms (s8 x s8 -> s32, K = 32 bytes a step; both operands
// K-major, the only layout PTX allows for 8-bit types): d (64 x 64) +=
// A (descriptor) . B (descriptor) ...
__device__ __forceinline__ void wgmma_ss_s8_64x64(int (&d)[8][4], uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]),
        "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]),
        "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]),
        "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), "+r"(d[6][0]),
        "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]),
        "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ... and d (64 x 32) += A (registers: warp w of the warpgroup rows 16w ..
// 16w + 15 in the mma.sync.m16n8k32 A-fragment layout) . B (descriptor)
__device__ __forceinline__ void wgmma_s8_64x32(int (&d)[4][4], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]),
        "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]),
        "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]),
        "+r"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(bar)),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the bulk-copy unit
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrives on `bar`, which then also waits for `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}
// returns once the phase of `bar` with this parity has completed; a copy
// that never lands traps (a launch error) rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_address(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}
// bytes (a multiple of 16, both ends 16-byte aligned) global -> shared,
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// The TMA unit's tensor copies of 64-pixel rows of a bf16 NHWC tensor
// (`nhwc_tensor_map`): box pixels x0 .. x0 + box_w - 1 of row y (and of
// the box's further rows) of image b, 64 channels a pixel, one 128-byte
// pixel row each in shared memory,
// 128-byte swizzled (as `fetch_row64` and wgmma's K-major tiles lay them
// out; the tile 1024-byte aligned). A load zero-fills what lies outside the
// tensor and completes its box's bytes on bar; a store skips it, one bulk
// group (`bulk_commit`, `bulk_wait_read` before the rows are written
// again). One thread issues each copy.
__device__ __forceinline__ void tma_load_row(void* dst, const CUtensorMap* map, int x0, int y,
                                             int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(x0), "r"(y), "r"(b),
      "r"(shared_address(bar))
      : "memory");
}
__device__ __forceinline__ void tma_store_row(const CUtensorMap* map, const void* src, int x0,
                                              int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(0), "r"(x0), "r"(y), "r"(b), "r"(shared_address(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's bulk groups have not yet read
// their shared memory
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// a barrier of the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// ---- thread block clusters (the body pair's walk: __cluster_dims__) -----
//
// The dynamic shared memory of this CTA (at the same offset in every CTA
// of a cluster)
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ uint4 cdfo_smem[];
  return reinterpret_cast<unsigned char*>(cdfo_smem);
}
// this CTA's rank in its cluster
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// the cluster barrier, split: every thread of every CTA of the cluster
// arrives (release: its earlier shared-memory writes, remote ones too,
// become visible), then waits (acquire) for the phase to complete;
// arrive and wait alternate in each thread
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// an arrival without release: for a barrier that orders only this
// thread's reads (already consumed) before the others' later writes
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// 16 bytes to the shared memory of CTA `rank` of the cluster, at the
// offset that `local` has in this CTA's (distributed shared memory), as an
// asynchronous store that completes its bytes on the mbarrier at the
// offset that `bar` has in this CTA's: the receiver waits on that barrier
// (which expects the bytes) and nothing else orders the store
__device__ __forceinline__ void st_async_remote4(const float* local, int rank, float a, float b,
                                                 float c, float d, const uint64_t* bar) {
  uint32_t remote, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(shared_address(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar)
               : "r"(shared_address(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::
          "r"(remote),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(remote_bar)
      : "memory");
}
// 16 bytes of the shared memory of CTA `rank` of the cluster (this one
// too), at the offset that `local` has in this CTA's (distributed shared
// memory); a cluster barrier between the writer's stores and this load
// orders them
__device__ __forceinline__ float4 ld_remote4(const float* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(shared_address(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}
// named barrier `id` of `count` threads (a multiple of 32): arrive without
// waiting (the producers), or arrive and wait (the consumers)
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The TMA map of a bf16 NHWC tensor (batch, h, wd, 64) at base, for
// `tma_load_row` and `tma_store_row` with boxes of box_w pixels of box_h
// rows (host code; the driver's encoder is looked up once through the
// runtime). A box of box_h > 1 rows lands as its box_w-pixel rows one
// after another: an 8 x 8 box is an 8x8 window's 64 tokens in row order.
// swizzle: the 128-byte swizzle of wgmma's tiles, or none (pixel rows as
// they lie, for readers that are not wgmma). c: the elements of a pixel,
// 64 but for a tensor seen as lanes of another width (the DMA probe's ring
// as pixels of 8 or 64 lanes; a multiple of 8, and 64 where swizzled).
inline cudaError_t nhwc_tensor_map(CUtensorMap* map, const void* base, int batch, int h, int wd,
                                   int box_w, int box_h = 1, bool swizzle = true, int c = C) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(wd),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(wd) * c * 2,
                                 static_cast<cuuint64_t>(h) * wd * c * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(c), static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// stmatrix: the four 8x8 b16 matrices of r0 .. r3 (lane 4g + t holding
// row g, elements 2t, 2t + 1 of each, as an mma C fragment rounded to
// pairs) to the rows lanes 0-7, 8-15, 16-23, 24-31 point at, each matrix
// stored transposed (lane 4g + t's pair goes to rows 2t and 2t + 1, column
// g); x2: matrices 0 and 1 (rows from lanes 0-15)
__device__ __forceinline__ void stsm_x4_trans(void* row, uint32_t r0, uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   shared_address(row)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stsm_x2_trans(void* row, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(
                   shared_address(row)),
               "r"(r0), "r"(r1)
               : "memory");
}

// pins registers in place (see above)
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }
__device__ __forceinline__ void keep(int& x) { asm volatile("" : "+r"(x)::"memory"); }
// (a descriptor kept opaque here, so that the ones derived from it after
// this point are computed where they are used rather than held in
// registers from before)
__device__ __forceinline__ void keep(uint64_t& x) { asm volatile("" : "+l"(x)::"memory"); }
template <typename A, int N>
__device__ __forceinline__ void keep(A (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(r[i]);
}
#endif

// the descriptor of a 1024-byte aligned, 128-byte swizzled tile at `tile`:
// start address (16-byte units), the leading offset (16 bytes: unused by the
// swizzled K-major form; an MN-major tile has one 128-byte row of 64
// columns per K index, and `lead` is the distance from its first 64-column
// block to its second, unused at 64 columns), 8-row groups 1024 bytes
// apart, swizzle mode 1
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lead_bytes = 16) {
  return static_cast<uint64_t>((shared_address(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// the descriptor of a K-major tile without swizzle (the s8 routes): 8-row
// core matrices of 16-byte rows, 128 contiguous bytes each; `lead` bytes
// from one core matrix to the next along K, `stride` bytes from one 8-row
// group to the next along M or N; swizzle mode 0. A tile of this form can
// start at any 16-byte row, so a window whose pixels keep their 16-byte
// channel chunk c in plane c (`lead` = the plane's bytes, `stride` = 128)
// is a tile from any pixel.
__device__ __forceinline__ uint64_t wgmma_desc_plain(const void* tile, uint32_t lead,
                                                     uint32_t stride) {
  return static_cast<uint64_t>((shared_address(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32);
}

template <int NT>
__device__ __forceinline__ void zero1(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// acc (64 x 64 fp32 fragments) rounded to bf16 as the register A operand of
// the next product, k16 step kk taking n-tiles 2kk, 2kk + 1
__device__ __forceinline__ void round_to_a(const float (&acc)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      a[kk][2 * u] = pack_bf16x2(acc[2 * kk + u][0], acc[2 * kk + u][1]);
      a[kk][2 * u + 1] = pack_bf16x2(acc[2 * kk + u][2], acc[2 * kk + u][3]);
    }
}

// element c of pixel p of a window of 128-byte pixel rows (64 bf16
// channels), 128-byte swizzled: its 16-byte chunk c / 8 at chunk
// (c / 8) ^ (p % 8)
__device__ __forceinline__ bf16* swizzled(bf16* buf, int p, int c) {
  return buf + p * C + ((((c >> 3) ^ p) & 7) << 3) + (c & 7);
}

// The outputs of a conv computed in window coordinates with the weights as
// A (this lane: channels 16 w + g and + 8 of the 64, w the warp of the
// warpgroup) and positions q0 .. q0 + 8 NT - 1 of an input window in_w
// wide as B, as lrelu(acc + bias) rounded to bf16, into the swizzled y
// window (out_w x out_w, image origin (y0, x0) of an hs x ws image, zeroed
// outside it), by transposing stmatrix stores; a position in a column or
// row past out_w goes to `trash`, a 128-byte row.
template <int NT>
__device__ void store_lrelu_window(const float (&acc)[NT][4], int q0, int in_w, int out_w,
                                   bf16* y, int y0, int x0, int hs, int ws, float2 bias,
                                   bf16* trash) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3, t2 = 2 * (lane & 3);
  // q / in_w as a multiply (exact for q < 1024, in_w <= 20)
  const int inv = (65536 + in_w - 1) / in_w;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (j + u >= NT) continue;
      float v[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 8 * (j + u) + t2 + e, oy = (q * inv) >> 16, ox = q - oy * in_w;
        const bool in = ox < out_w && oy < out_w && inside(y0 + oy, x0 + ox, hs, ws);
        v[0][e] = in ? lrelu(acc[j + u][e] + bias.x) : 0.f;
        v[1][e] = in ? lrelu(acc[j + u][2 + e] + bias.y) : 0.f;
      }
      r[2 * u] = pack_bf16x2(v[0][0], v[0][1]);
      r[2 * u + 1] = pack_bf16x2(v[1][0], v[1][1]);
    }
    const int q = q0 + 8 * (j + ((lane >> 4) & 1)) + (lane & 7);
    const int oy = (q * inv) >> 16, ox = q - oy * in_w;
    const int c = 16 * wl + 8 * ((lane >> 3) & 1);
    bf16* row = ox < out_w && oy < out_w ? swizzled(y, oy * out_w + ox, c) : trash + c;
    if (j + 1 < NT) {
      stsm_x4_trans(row, r[0], r[1], r[2], r[3]);
    } else {
      stsm_x2_trans(row, r[0], r[1]);
    }
  }
}

// ---- the 62-column strip walk of the group tail and MDTA stage 2 ---------
//
// A strip is 62 output columns, so that a window row with its one-pixel
// halo is 64 pixels, one m64 tile. The units (image, strip, output row),
// numbered (image * strips + strip) * h + row, are handed out evenly: each
// CTA (one an SM) walks a contiguous run of them, as walks (the output rows
// [a, e) of one strip). A step takes two window rows j, j + 1, one per
// warpgroup. The first step of a walk (j = a - 1) is its warm-up: its rows
// are the vertical halo, and it computes no output. Every later step
// computes output rows j - 1 and j, one per warpgroup; a row at e (a walk
// of an odd length) is computed and dropped, so that both warpgroups stay
// on one code path.
constexpr int STRIP = 62;                // output columns of a strip
constexpr int STRIP_WIN = STRIP + 2;     // window pixels of a row: one m64 tile

struct StripStep {
  long long u;      // the walk's first unit
  int b, c0, a, e;  // image, the strip's first column, the walk's output rows [a, e)
  int j;            // the step's first window row
};

// the warm-up step of the walk that starts at unit u (< g1, the end of the
// CTA's run)
__device__ __forceinline__ StripStep strip_walk_at(long long u, long long g1, int h,
                                                   int strips) {
  const long long sb = u / h;
  StripStep s;
  s.u = u;
  s.b = static_cast<int>(sb / strips);
  s.c0 = static_cast<int>(sb % strips) * STRIP;
  s.a = static_cast<int>(u % h);
  s.e = static_cast<int>(g1 - u < h - s.a ? s.a + (g1 - u) : h);
  s.j = s.a - 1;
  return s;
}

// the step after s: the walk's next two rows, or the warm-up of the next
// walk; false where s is the CTA's last
__device__ __forceinline__ bool strip_next(const StripStep& s, long long g1, int h, int strips,
                                           StripStep& n) {
  if (s.j + 1 < s.e) {
    n = s;
    n.j += 2;
    return true;
  }
  const long long nu = s.u + (s.e - s.a);
  if (nu >= g1) return false;
  n = strip_walk_at(nu, g1, h, strips);
  return true;
}

// The 3x3 conv (64 -> 64 channels) of one output row of a strip on wgmma,
// in window coordinates: output position q (0 .. 63) reads window
// positions q + kx of row ky of (r0, r1, r2), three 64-pixel tiles of
// 128-byte swizzled pixel rows, 1024-byte aligned, each followed by two
// readable pixel rows (positions 62 and 63 read past their row: their
// outputs are dropped). w: the 9 taps (3 ky + kx) as 64 x 64 K-major
// stages B[n][k], 128-byte swizzled, 1024-byte aligned. acc (64 positions
// x 64 channels in the C-fragment order) is overwritten; the 36 products
// are one wgmma group, committed and not waited for.
// Taps [T0, T1) of it, one wgmma group: a conv issued in parts lets the
// warpgroup work between them while the first part's products run (its
// first part overwrites acc).
template <int T0, int T1>
__device__ __forceinline__ void conv3x3_taps(float (&acc)[8][4], const bf16* r0, const bf16* r1,
                                             const bf16* r2, const bf16* w) {
  const bf16* rows[3] = {r0, r1, r2};
  wgmma_fence();
#pragma unroll
  for (int tap = T0; tap < T1; ++tap) {
    const uint64_t a = wgmma_desc(rows[tap / 3] + (tap % 3) * C);
    const uint64_t b = wgmma_desc(w + tap * C * C);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_64x64(acc, a + 2 * kk, b + 2 * kk, tap + kk);
  }
  wgmma_commit();
}
__device__ __forceinline__ void conv3x3_row(float (&acc)[8][4], const bf16* r0, const bf16* r1,
                                            const bf16* r2, const bf16* w) {
  conv3x3_taps<0, 9>(acc, r0, r1, r2, w);
}

}  // namespace cdfo
