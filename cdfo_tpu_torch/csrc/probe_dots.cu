// The dot-shape probes of the trunk, hand-written for Hopper (sm_90a): the
// sustained rate of wgmma (the main-path kernels' instruction) with both
// operands in shared memory, by the product's N, at the trunk's product
// shapes, and what splitting weights that fit no SM costs.
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
// Design. Each product is computed transposed, as the main-path kernels
// compute a convolution: M = 64 pixels (the probes' n) a warpgroup, N =
// output channels (their m), K = input channels, all on wgmma with both
// operands in shared memory as 128-byte swizzled K-major 64-channel chunks
// read by descriptors, put there by the TMA unit (one thread issuing
// tensor copies that complete on mbarriers). The weights
// are read as they lie: lhs (m, k) and W (m, 9c) are K-major N x 64 tiles
// chunk by chunk; rhs and u are taken transposed, a pixel's channels
// contiguous. A ragged last pixel tile is zero-filled by the copies and
// masked on store. Where the output has fewer CTAs than the card has SMs,
// the reps are split into groups (`share`) that run side by side.
//   dots: a CTA of one warpgroup holds its K-chunks of lhs and the pixel
//   tile of every plane at those chunks, loaded once; the loop over reps
//   is then
//   back-to-back wgmma from shared memory with one wait at the end. Where
//   lhs and the four plane tiles do not fit (k = 768 or 1024 at m = 64, k
//   = 576 at m = 256), K is split over CTAs as the reps are split into
//   groups: every (K slice, group) leaves fp32 partial sums, which a
//   second launch adds in a fixed order and rounds once, so every run
//   gives the same bits. streamed: the plane tiles pass through a TMA
//   ring of 4 stages from L2 instead, even where they would fit.
//   rowpipe and kstack: W (m x 9c, 288 KB at the tools' (256, 64) and
//   (64, 256)) fits no SM. It is split two ways, chosen by what the card
//   makes cheap: at c = 64 by output channels (a CTA keeps 64 mt of the m
//   channels resident: mt = 2 for rowpipe at m = 256; no data crosses
//   CTAs), at c = 128 .. 512 by input channels over a cluster of c / 64
//   CTAs (each keeps one 64-channel chunk resident and computes a
//   partial). A CTA thus holds one chunk, and an iteration's 36 products
//   are one unrolled group, as conv3x3_row's. A split CTA runs two
//   warpgroups on the same iterations: warpgroup 0 makes the products and
//   leaves each iteration's fp32 partial in its own shared memory (two
//   buffers, one an iteration); warpgroup 1, under the next iteration's
//   products, loads the partials of the 16-pixel-row blocks its CTA owns
//   from every CTA (distributed shared memory, in rank order), adds them
//   and runs the epilogue; one cluster barrier an iteration orders both.
//   (With one warpgroup doing both, the exchange and the epilogue held
//   the next products back.) The clusters walk (tile, part, group) units,
//   with the groups chosen so that the units spread evenly over the
//   clusters the card holds at once. W streamed through a TMA ring would
//   move 288 KB per iteration into every SM.
//   An unsplit CTA runs two warpgroups, each walking its own contiguous
//   half of the CTA's iterations with its own rows, their products taking
//   turns (two named barriers pass the turn): one warpgroup's 36
//   back-to-back products hold its issue until they are nearly done, so
//   its epilogue (bias, lrelu, mask, the bf16 row to the y scratch), its
//   fetches and builds run under the other's products (with one
//   warpgroup a CTA nothing overlapped the epilogue).
//   rowpipe: each iteration reads rows r .. r + 2 (66 pixels: the tile
//   and its dx reach, one box each) and makes the three dx-shifted
//   products from the same rows at descriptor offsets (a window of
//   swizzled pixel rows is a K-major tile from any row), as conv3x3_row
//   does; its rows are fetched ahead where room allows.
//   kstack: each iteration builds one row into three shifted copies in
//   the swizzled slot layout and runs one product of K = 9c over slots r
//   .. r + 2. The slots hold u's rows, which do not change, so three slots
//   a warpgroup serve where the TPU kept nrows + 2: row q sits in slot q
//   mod 3 while iterations read it; iteration r brings in row r + 2 (and
//   rows r, r + 1 too at the warpgroup's first iteration and after each
//   wrap to r = 0), its fetch issued once the iteration before's products
//   are done and landing as the dx = 0 copy, the threads copying it at dx
//   = 1, 2; rows nrows and nrows + 1 are zero, as the
//   TPU's slots that no iteration writes, so that each cycle of nrows
//   iterations builds the nrows rows once, as the TPU's does. The TPU
//   kernel's output is defined only for reps > nrows, and both versions
//   keep that rule. kstack holds its slots besides W, so it keeps 64
//   channels a CTA (kstack_mt = 1 at m = 256, c = 64); rowpipe(mt=1) runs
//   at its tile.
//   Both write the output from the warpgroup whose range holds the last
//   iteration with r = 0.

#include "wgmma_tile.cuh"

namespace {

using namespace cdfo;

constexpr int WG = 128;                     // a warpgroup
constexpr int TILE = 64;                    // pixels of an m64 tile
constexpr int TILE_ELEMS = TILE * C;        // one tile of 64 channels
constexpr int TILE_BYTES = TILE_ELEMS * 2;  // 8 KB
constexpr int ROWBOX = TILE + 2;            // a row's pixels: the tile and its dx reach
constexpr int RSLOT = 9 * 1024;             // a fetched row chunk's slot (66 rows, 1024-aligned)
constexpr int SMEM_LIMIT = 232448;          // one block's shared memory
constexpr int PAD = 1024;                   // the 1024-byte alignment of the tiles
constexpr int BARS = 16;
constexpr int BAR_BYTES = BARS * 8;
constexpr int DOTS_STAGES = 4;              // the streamed planes' ring
constexpr int MAX_SPLIT = 8;
constexpr int MAX_GROUPS = 16;              // the split row route's rep groups, at most                // CTAs of a cluster sharing K, at most (portable)
constexpr int TURN = 3;                     // named barriers 3, 4: warpgroup 0's, 1's turn
// the partials of a CTA of a K-split cluster: [2 iterations][4 warps][8
// n-tiles][32 lanes] float4s
constexpr int PART_BYTES = 2 * 4 * 8 * 32 * 16;

// d += A (a 64 x 64 K-major tile) . B (an N x 64 K-major tile), 4 k16 steps
__device__ __forceinline__ void mma_ss(float (&d)[8][4], uint64_t a, uint64_t b) {
  wgmma_ss_64x64(d, a, b);
}
__device__ __forceinline__ void mma_ss(float (&d)[16][4], uint64_t a, uint64_t b) {
  wgmma_ss_64x128(d, a, b);
}
__device__ __forceinline__ void mma_ss(float (&d)[32][4], uint64_t a, uint64_t b) {
  wgmma_ss_64x256(d, a, b);
}
template <int NT>
__device__ __forceinline__ void tile_mma(float (&d)[NT][4], const bf16* a, const bf16* b) {
  const uint64_t da = wgmma_desc(a), db = wgmma_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_ss(d, da + 2 * kk, db + 2 * kk);
}

// part i of `parts` of [0, total): [lo, hi)
__host__ __device__ __forceinline__ void share(int total, int parts, int i, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(total) * i / parts);
  hi = static_cast<int>(static_cast<long long>(total) * (i + 1) / parts);
}

// v[u] of lane t of a quad (4 lanes, t = lane & 3) becomes lane u's v[t]:
// the quad's 4 x 4 words transposed, by two exchanges (lanes 2 apart, then
// 1 apart)
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const auto swap = [](uint32_t x, int mask) {
    return static_cast<uint32_t>(
        __float_as_int(__shfl_xor_sync(0xffffffffu, __int_as_float(static_cast<int>(x)), mask)));
  };
  const bool hi2 = t & 2, hi1 = t & 1;
  uint32_t x = swap(hi2 ? v[0] : v[2], 2), y = swap(hi2 ? v[1] : v[3], 2);
  if (hi2) {
    v[0] = x;
    v[1] = y;
  } else {
    v[2] = x;
    v[3] = y;
  }
  x = swap(hi1 ? v[0] : v[1], 1);
  y = swap(hi1 ? v[2] : v[3], 1);
  if (hi1) {
    v[0] = x;
    v[2] = y;
  } else {
    v[1] = x;
    v[3] = y;
  }
}

__device__ __forceinline__ unsigned char* aligned_smem() {
  unsigned char* base = dynamic_smem();
  return base + ((1024u - (shared_address(base) & 1023u)) & 1023u);
}

// ---- dots -------------------------------------------------------------------

// The shared memory of a dots CTA holding nck chunks: lhs's [nck][m][64],
// then the planes' tiles [nplanes][nck] (or the ring's stages), barriers
int dots_bytes(int m, int nck, int nplanes, int streamed) {
  const int planes = streamed ? DOTS_STAGES : nplanes * nck;
  return PAD + nck * m * C * 2 + planes * TILE_BYTES + BAR_BYTES;
}

// The K slices of dots: as few as let a CTA hold its chunks; -1 if even
// one chunk does not fit
int dots_slices(int m, int kc, int nplanes, int streamed) {
  for (int ks = 1; ks <= kc; ++ks) {
    if (dots_bytes(m, (kc + ks - 1) / ks, nplanes, streamed) <= SMEM_LIMIT) return ks;
  }
  return -1;
}

// planes (nplanes, n, k) and lhs (m, k) bf16 as maps of 64-channel chunks
// (tma_load_row: x = chunk, y = pixel or row, b = plane); part [ks *
// groups][n][m] fp32: CTA (tile, slice s, group g) writes partial s *
// groups + g
template <int N>
__global__ void __launch_bounds__(WG, 1)
dots_kernel(const __grid_constant__ CUtensorMap tplanes, const __grid_constant__ CUtensorMap tlhs,
            float* __restrict__ part, int kc, int n, int nplanes, int reps, int ks, int groups,
            int streamed) {
  constexpr int NT = N / 8;
  unsigned char* base = aligned_smem();
  const int p0 = blockIdx.x * TILE, s = blockIdx.y, g = blockIdx.z;
  int c0, c1, lo, hi;
  share(kc, ks, s, c0, c1);
  share(reps, groups, g, lo, hi);
  const int nck = c1 - c0;
  bf16* bs = reinterpret_cast<bf16*>(base);   // lhs: [nck][N][64], swizzled
  bf16* as = bs + nck * N * C;                // planes: [nplanes][nck] tiles, or the ring's stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(as + (streamed ? DOTS_STAGES : nplanes * nck) * TILE_ELEMS);
  const int units = (hi - lo) * nck;          // streamed: (rep, chunk) in order
  // (thread 0) unit j's plane tile into stage j % DOTS_STAGES
  const auto issue = [&](int j) {
    uint64_t* bar = bars + 1 + j % DOTS_STAGES;
    mbar_expect_tx(bar, TILE_BYTES);
    tma_load_row(as + (j % DOTS_STAGES) * TILE_ELEMS, &tplanes, c0 + j % nck, p0,
                 (lo + j / nck) % nplanes, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + DOTS_STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, nck * N * C * 2 + (streamed ? 0 : nplanes * nck * TILE_BYTES));
    for (int q = 0; q < nck; ++q) tma_load_row(bs + q * N * C, &tlhs, c0 + q, 0, 0, bars);
    if (streamed) {
      for (int j = 0; j < units && j < DOTS_STAGES; ++j) issue(j);
    } else {
      for (int p = 0; p < nplanes; ++p) {
        for (int q = 0; q < nck; ++q) {
          tma_load_row(as + (p * nck + q) * TILE_ELEMS, &tplanes, c0 + q, p0, p, bars);
        }
      }
    }
  }
  __syncthreads();
  mbar_wait(bars, 0);
  float acc[NT][4];
  zero1(acc);
  keep(acc);   // zeroed before the first fence (else ptxas injects one: C7519)
  // (rep, chunk) units in order; the accumulators stay in flight across
  // the loop's back edge, pinned (keep) where each unit fences
  if (!streamed) {
    // every rep's products back to back from the resident tiles
    int plane = lo % nplanes, q = 0;
#pragma unroll 1
    for (int j = 0; j < units; ++j) {
      keep(acc);
      wgmma_fence();
      tile_mma(acc, as + (plane * nck + q) * TILE_ELEMS, bs + q * N * C);
      wgmma_commit();
      if (++q == nck) {
        q = 0;
        if (++plane == nplanes) plane = 0;
      }
    }
    wgmma_wait<0>();
  } else {
#pragma unroll 1
    for (int j = 0; j < units; ++j) {
      mbar_wait(bars + 1 + j % DOTS_STAGES, (j / DOTS_STAGES) & 1);
      keep(acc);
      wgmma_fence();
      tile_mma(acc, as + (j % DOTS_STAGES) * TILE_ELEMS, bs + (j % nck) * N * C);
      wgmma_commit();
      wgmma_wait<1>();   // unit j - 1's products are done ...
      keep(acc);
      __syncthreads();   // ... in every warp: its stage may take unit j - 1 + DOTS_STAGES
      if (threadIdx.x == 0 && j >= 1 && j - 1 + DOTS_STAGES < units) issue(j - 1 + DOTS_STAGES);
    }
    wgmma_wait<0>();
  }
  keep(acc);
  // the partial, [pixel][channel]
  float* pg = part + (static_cast<long long>(s) * groups + g) * n * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int px = p0 + 16 * warp + (lane >> 2) + 8 * hf;
    if (px >= n) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<float2*>(pg + static_cast<long long>(px) * N + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
  }
}

// out (m, n) bf16 = the sum over partials, in order, of part [p][n][m]
__global__ void __launch_bounds__(THREADS)
dots_reduce(const float* __restrict__ part, bf16* __restrict__ out, int m, int n, int parts) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(m) * n) return;
  const int c = static_cast<int>(i % m), px = static_cast<int>(i / m);
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(static_cast<long long>(p) * n + px) * m + c];
  out[static_cast<long long>(c) * n + px] = __float2bfloat16(s);
}

// ---- rowpipe and kstack ----------------------------------------------------

// How a row probe holds W: N output channels a CTA (64 mt) and, split,
// its 64-channel chunk of the input channels, rank q of a cluster of
// `split` (= c / 64) CTAs taking chunk q. A CTA holds one chunk, and the
// products of a step are one unrolled group of 36. wgs warpgroups a CTA (2
// unsplit, each walking half the CTA's iterations; 1 split), fsets row
// fetches each warpgroup keeps (rowpipe).
struct RowsPlan {
  int n_w, split, wgs, fsets, bytes;
};

// a warpgroup's rows: rowpipe's fsets sets of 3 fetched rows; kstack's 3
// slots, each the fetched row (66 pixel rows: the dx = 0 copy) and its dx
// = 1, 2 copies
__host__ __device__ __forceinline__ int rows_wg_bytes(bool kstack, int fsets) {
  return kstack ? 3 * (RSLOT + 2 * TILE_BYTES) : fsets * 3 * RSLOT;
}

// W's [9 taps][N][64] | each warpgroup's rows | the partials (split) |
// barriers
int rows_bytes(bool kstack, int n_w, bool split, int wgs, int fsets) {
  return PAD + 9 * n_w * C * 2 + wgs * rows_wg_bytes(kstack, fsets) + (split ? PART_BYTES : 0) +
         BAR_BYTES;
}

// c = 64: the widest tile of at most mt 64-channel m-tiles (and 2: 256
// channels' W never fits) whose W and two warpgroups' rows fit one CTA
// (rowpipe's fetched two ahead where they fit, else one); c = 128 .. 512:
// 64 channels with the input channels split over a cluster of c / 64;
// false otherwise
bool rows_plan(bool kstack, int m, int c, int mt, RowsPlan& p) {
  if (c == 64) {
    int t = mt < m / 64 ? mt : m / 64;
    if (t > 2) t = 2;
    for (; t >= 1; t /= 2) {
      for (int fsets = 2; fsets >= 1; --fsets) {
        const int bytes = rows_bytes(kstack, 64 * t, false, 2, fsets);
        if (bytes <= SMEM_LIMIT) {
          p = {64 * t, 1, 2, fsets, bytes};
          return true;
        }
      }
    }
    return false;
  }
  if (c % 64 != 0 || c < 64 || c > 64 * MAX_SPLIT) return false;
  p = {64, c / 64, 1, 2, rows_bytes(kstack, 64, true, 1, 2)};
  return p.bytes <= SMEM_LIMIT;
}

// The rows of one CTA: units (pixel tile, output channels [part N, part N
// + N), rep group g), tile fastest, unit, unit + stride, .. below units
// (one unsplit), input channels [64 q0, 64 q0 + 64) (q0 = rank where
// split), a unit's iterations shared by its WGS warpgroups in contiguous
// halves. u (nrows + 2, n + 8, c) and W (m, 9c) as maps of 64-channel
// chunks; W's K index is (dx 3 + row) c + ch for rowpipe, (row 3 + dx) c
// + ch for kstack. y scratch [groups][nrows][n][m].
template <int N, bool KSTACK, bool SPLIT_K, int WGS>
__device__ __forceinline__ void rows_body(const CUtensorMap* tu, const CUtensorMap* tw,
                                          const float* __restrict__ b,
                                          const float* __restrict__ cm, bf16* __restrict__ yscr,
                                          bf16* __restrict__ out, int m, int cc, int n, int nrows,
                                          int reps, int groups, int unit, int stride, int units,
                                          int tiles, int rank, int fsets) {
  constexpr int NT = N / 8;
  constexpr int SLOT = RSLOT + 2 * TILE_BYTES;   // kstack: a slot's bytes
  unsigned char* base = aligned_smem();
  const int q0 = SPLIT_K ? rank : 0;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  bf16* ws = reinterpret_cast<bf16*>(base);   // [9 taps][N][64]
  const int wg_bytes = rows_wg_bytes(KSTACK, fsets);
  unsigned char* mine_rows = base + 9 * N * C * 2 + wg * wg_bytes;
  // split: the partials of iteration j in buffer j & 1, each warp's [NT][32
  // lanes] float4s (a warp's 16 pixel rows, its lanes' accumulators)
  float4* parts = reinterpret_cast<float4*>(base + 9 * N * C * 2 + WGS * wg_bytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(parts) + (SPLIT_K ? PART_BYTES : 0));
  // bars: [0] W, [1 + 3 wg + k] this warpgroup's fetch set or slot k
  uint64_t* fbar = bars + 1 + 3 * wg;
  // the unit's pixels from p0, channels from n0c, group g's iterations [lo,
  // hi), this warpgroup's [a, e) (split: both's), trips a warpgroup (two
  // take the same trips: the one with fewer iterations computes one more
  // and drops it, so that neither takes a path holding wgmma alone)
  const int nparts = m / N;
  int p0, n0c, g, lo, hi, a, e, trips;
  const auto start_unit = [&](int u) {
    p0 = (u % tiles) * TILE;
    n0c = ((u / tiles) % nparts) * N;
    g = u / (tiles * nparts);
    share(reps, groups, g, lo, hi);
    share(hi - lo, WGS, SPLIT_K ? 0 : wg, a, e);
    a += lo;
    e += lo;
    trips = (hi - lo + WGS - 1) / WGS;
  };
  start_unit(unit);
  const int last = ((reps - 1) / nrows) * nrows;
  int jg = 0;   // split: the iterations of the units before this one
  // rowpipe: this warpgroup's j-th iteration's rows into set (jg + j) mod
  // fsets
  const auto fetch_rows = [&](int j) {
    uint64_t* bar = fbar + (jg + j) % fsets;
    mbar_expect_tx(bar, 3 * ROWBOX * C * 2);
    const int r = (a + j) % nrows;
    for (int row = 0; row < 3; ++row) {
      tma_load_row(mine_rows + ((jg + j) % fsets * 3 + row) * RSLOT, tu, q0, p0, r + row, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 3 * WGS; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, 9 * N * C * 2);
    for (int t = 0; t < 9; ++t) tma_load_row(ws + t * N * C, tw, t * cc + q0, n0c, 0, bars);
  }
  __syncthreads();
  mbar_wait(bars, 0);
  // kstack: row q (of 0 .. nrows + 1) lives in slot q mod 3 while an
  // iteration reads it; rows from nrows on are zero
  uint32_t sphase = 0u;   // bit k: the parity slot k's fetch waits for
  const auto slot_rows = [&](int q) { return mine_rows + (q % 3) * SLOT; };
  // kstack: the rows the j-th iteration brings in, [q, q + k): r .. r + 2 at
  // the warpgroup's first iteration (j = 0) and after a wrap to r = 0, else
  // r + 2
  const auto new_rows = [&](int j, int& q, int& k) {
    const int r = (a + j) % nrows;
    q = j == 0 || r == 0 ? r : r + 2;
    k = j == 0 || r == 0 ? 3 : 1;
  };
  // (thread 0) their fetches, into slots that the products before have
  // done with; rows from nrows on are zero and fetch nothing
  const auto fetch_new = [&](int j) {
    int q, k;
    new_rows(j, q, k);
    for (int t = q; t < q + k && t < nrows; ++t) {
      mbar_expect_tx(fbar + t % 3, ROWBOX * C * 2);
      tma_load_row(slot_rows(t), tu, q0, p0, t, fbar + t % 3);
    }
  };
  // the j-th iteration's rows are ready: rowpipe's fetched set has landed;
  // kstack's new rows have landed (or are zeroed), each copied at dx = 1,
  // 2 (pixel p = the row's pixel p + dx; 16-byte chunks, each row swizzled
  // by its own index)
  const auto rows_ready = [&](int j) {
    if (!KSTACK) {
      mbar_wait(fbar + (jg + j) % fsets, ((jg + j) / fsets) & 1);
      return;
    }
    int q, k;
    new_rows(j, q, k);
    if (q + k > nrows) {   // the zero rows, written before any thread copies them
      for (int t = q < nrows ? nrows : q; t < q + k; ++t) {
        for (int v = tid; v < ROWBOX * 8; v += WG) {
          reinterpret_cast<uint4*>(slot_rows(t))[v] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      warpgroup_sync(wg);
    }
    for (int t = q; t < q + k; ++t) {
      unsigned char* sr = slot_rows(t);
      if (t < nrows) {
        mbar_wait(fbar + t % 3, (sphase >> (t % 3)) & 1u);
        sphase ^= 1u << (t % 3);
      }
      const bf16* src = reinterpret_cast<const bf16*>(sr);
      bf16* dst = reinterpret_cast<bf16*>(sr + RSLOT);
      for (int v8 = tid; v8 < 2 * TILE * 8; v8 += WG) {
        const int v = v8 & 7, p = (v8 >> 3) & (TILE - 1), dx = 1 + (v8 >> 9);
        const int ps = p + dx;
        *reinterpret_cast<uint4*>(dst + (dx - 1) * TILE_ELEMS + p * C + ((v ^ (p & 7)) << 3)) =
            *reinterpret_cast<const uint4*>(src + ps * C + ((v ^ (ps & 7)) << 3));
      }
    }
    async_fence();
    warpgroup_sync(wg);   // built
  };
  // (thread 0 of the warpgroup) the fetches that wait for the j-th
  // iteration's products to have read their rows
  const auto done_with = [&](int j) {
    if (tid != 0) return;
    if (KSTACK && j + 1 < trips) fetch_new(j + 1);
    if (!KSTACK && j + fsets < trips) fetch_rows(j + fsets);
  };
  // the j-th iteration's products into acc, issued (not waited for)
  const auto products = [&](float (&acc)[NT][4], int j) {
    const int r = (a + j) % nrows;
    // (the rows' descriptors first: slot arithmetic between the products
    // delayed their issue)
    uint64_t dr[3];
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      dr[row] = wgmma_desc(KSTACK ? slot_rows(r + row)
                                  : mine_rows + ((jg + j) % fsets * 3 + row) * RSLOT);
    }
    zero1(acc);
    keep(acc);   // zeroed before the fence (else ptxas injects one: C7519)
    const uint64_t db = wgmma_desc(ws);
    wgmma_fence();
#pragma unroll
    for (int row = 0; row < 3; ++row) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint64_t da =
            dr[row] + ((KSTACK ? (dx == 0 ? 0 : RSLOT + (dx - 1) * TILE_BYTES) : dx * C * 2) >> 4);
        const uint64_t bt = db + (((KSTACK ? row * 3 + dx : dx * 3 + row) * N * C * 2) >> 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_ss(acc, da + 2 * kk, bt + 2 * kk);
      }
    }
    wgmma_commit();
  };
  // y = lrelu(y + b) x cm, rounded, to the scratch row r (and, at the
  // output's iteration i, out), of this warp's pixel rows (warp-uniform:
  // the shuffles take every lane)
  const auto epilogue = [&](float (&y)[NT][4], int i, int r) {
    bf16* yrow = yscr + (static_cast<long long>(g) * nrows + r) * n * m;
    const int t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int px = p0 + 16 * warp + (lane >> 2) + 8 * hf;
      const bool in = px < n;
      const float mask = in ? cm[px] : 0.f;
#pragma unroll
      for (int j4 = 0; j4 < NT; j4 += 4) {
        uint32_t v[4];   // channels 8 (j4 + u) + 2 t, + 1, rounded
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = n0c + 8 * (j4 + u) + 2 * t;
          const float2 bb = load2(b + c);
          const float v0 = lrelu(y[j4 + u][2 * hf] + bb.x) * mask;
          const float v1 = lrelu(y[j4 + u][2 * hf + 1] + bb.y) * mask;
          v[u] = pack_bf16x2(v0, v1);
          if (i == last && in) {
            out[static_cast<long long>(c) * n + px] = __float2bfloat16(v0);
            out[static_cast<long long>(c + 1) * n + px] = __float2bfloat16(v1);
          }
        }
        // the quad's 4 x 4 words transposed: lane t gets n-tile j4 + t's
        // 8 channels, one 16-byte store (4-byte stores, each warp's
        // touching 8 rows, were the epilogue's largest cost)
        quad_transpose(v, t);
        if (in) {
          *reinterpret_cast<uint4*>(yrow + static_cast<long long>(px) * m + n0c + 8 * (j4 + t)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  };
  // (thread 0 of the warpgroup) the unit's first fetches
  const auto fetch_first = [&]() {
    if (KSTACK) {
      fetch_new(0);
    } else {
      for (int j = 0; j < fsets && j < trips; ++j) fetch_rows(j);
    }
  };
  if constexpr (!SPLIT_K) {
    if (tid == 0 && trips > 0) fetch_first();
#pragma unroll 1
    for (int j = 0; j < trips; ++j) {
      const int i = a + j;
      rows_ready(j);
      // the products take turns (two warpgroups): a warpgroup's start once
      // the other's are done, so that each one's epilogue, fetches and
      // builds run under the other's products
      if (WGS == 2 && (wg == 1 || j > 0)) named_sync(TURN + wg, 2 * WG);
      float acc[NT][4];
      products(acc, j);
      wgmma_wait<0>();
      keep(acc);
      if (WGS == 2 && (wg == 0 || j + 1 < trips)) named_arrive(TURN + 1 - wg, 2 * WG);
      warpgroup_sync(wg);    // the warpgroup's products have read its rows
      done_with(j);   // (the fetches under the epilogue)
      if (i < e) epilogue(acc, i, i % nrows);
    }
  } else {
    // The cluster's CTAs walk the same iterations, each with two
    // warpgroups: warpgroup 0 makes each iteration's products and leaves
    // its partial in the CTA's shared memory (two buffers, one an
    // iteration); warpgroup 1 adds up the partials of the pixel-row blocks
    // the CTA owns (warp w's 16 rows are block w, owned by CTA w mod split)
    // from every CTA in rank order, each warp two of the block's n-tiles,
    // and runs their epilogue, under the next iteration's products. One
    // cluster barrier an iteration, phase P(j): warpgroup 0 arrives once
    // iteration j's partial is written, warpgroup 1 once it has added up
    // iteration j - 1's; warpgroup 1 loads iteration j's partials after
    // P(j), and warpgroup 0 writes a buffer again (iteration j + 2) after
    // P(j + 1), which follows every CTA's loads of it.
    static_assert(!SPLIT_K || (N == 64 && WGS == 1), "a split CTA: 64 channels, one walk");
    const int split = cc;
    const int jt = 2 * warp, t = lane & 3;   // this warp's n-tiles jt, jt + 1
    // (read once a unit) their bias pairs, and the mask of this lane's
    // pixels of each owned block (rank, rank + split)
    float2 bias[2];
    float mask[2][2];
    const auto unit_constants = [&]() {
#pragma unroll
      for (int u = 0; u < 2; ++u) bias[u] = load2(b + n0c + 8 * (jt + u) + 2 * t);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int wb = rank + k * split, px = p0 + 16 * wb + (lane >> 2) + 8 * hf;
          mask[k][hf] = wb < 4 && px < n ? cm[px] : 0.f;
        }
      }
    };
    const auto reduce = [&](int j) {
      const int i = a + j;
      bf16* yrow = yscr + (static_cast<long long>(g) * nrows + i % nrows) * n * m;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int wb = rank + k * split;
        if (wb >= 4) break;
        // n-tile jt + u of this lane: (pixel half hf) its pair 2 hf, 2 hf + 1
        const float4* at = parts + (((jg + j) & 1) * 4 + wb) * NT * 32 + jt * 32 + lane;
        float y[2][4];
        zero1(y);
#pragma unroll 1
        for (int q4 = 0; q4 < split; q4 += 4) {   // four CTAs' loads in flight at once
          float4 v[4][2];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            if (q4 + qq < split) {
              v[qq][0] = ld_remote4(reinterpret_cast<const float*>(at), q4 + qq);
              v[qq][1] = ld_remote4(reinterpret_cast<const float*>(at + 32), q4 + qq);
            }
          }
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            if (q4 + qq < split) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                y[u][0] += v[qq][u].x;
                y[u][1] += v[qq][u].y;
                y[u][2] += v[qq][u].z;
                y[u][3] += v[qq][u].w;
              }
            }
          }
        }
        // items (u, hf) as 2 hf + u: lrelu(y + b) x cm, rounded; the quad's
        // 4 x 4 words transposed, lane t stores item t's 8 channels
        uint32_t w4[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int px = p0 + 16 * wb + (lane >> 2) + 8 * hf;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = n0c + 8 * (jt + u) + 2 * t;
            const float v0 = lrelu(y[u][2 * hf] + bias[u].x) * mask[k][hf];
            const float v1 = lrelu(y[u][2 * hf + 1] + bias[u].y) * mask[k][hf];
            w4[2 * hf + u] = pack_bf16x2(v0, v1);
            if (i == last && px < n) {
              out[static_cast<long long>(c) * n + px] = __float2bfloat16(v0);
              out[static_cast<long long>(c + 1) * n + px] = __float2bfloat16(v1);
            }
          }
        }
        quad_transpose(w4, t);
        const int px = p0 + 16 * wb + (lane >> 2) + 8 * (t >> 1);
        if (px < n) {
          *reinterpret_cast<uint4*>(yrow + static_cast<long long>(px) * m + n0c + 8 * (jt + (t & 1))) =
              make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
      }
    };
    uint32_t wphase = 0u;   // the parity of W's barrier
#pragma unroll 1
    while (true) {
      if (wg == 0) {
        if (tid == 0) fetch_first();
#pragma unroll 1
        for (int j = 0; j < trips; ++j) {
          rows_ready(j);
          float acc[NT][4];
          products(acc, j);
          // P(jg + j - 1): every CTA has added up the partials two
          // iterations back, whose buffer this iteration's take
          if (jg + j > 0) cluster_wait();
          wgmma_wait<0>();
          keep(acc);
          float4* mine = parts + (((jg + j) & 1) * 4 + warp) * NT * 32;
#pragma unroll
          for (int jj = 0; jj < NT; ++jj) {
            mine[jj * 32 + lane] = make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
          }
          cluster_arrive();    // P(jg + j): this CTA's partial of it is written
          warpgroup_sync(0);   // every warp's products have read the rows
          done_with(j);
        }
      } else {
        unit_constants();
#pragma unroll 1
        for (int j = 0; j < trips; ++j) {
          cluster_arrive();   // P(jg + j): this CTA has added up the iteration before's
          cluster_wait();     // every CTA's partial of iteration j is written
          reduce(j);
        }
      }
      jg += trips;
      unit += stride;
      if (unit >= units) break;
      const int had = n0c;
      start_unit(unit);
      if (wg == 0 && n0c != had) {   // another part's W, the products done with this one
        if (tid == 0) {
          mbar_expect_tx(bars, 9 * N * C * 2);
          for (int t9 = 0; t9 < 9; ++t9) tma_load_row(ws + t9 * N * C, tw, t9 * cc + q0, n0c, 0, bars);
        }
        wphase ^= 1u;
        mbar_wait(bars, wphase);
      }
    }
    if (wg == 0 && jg > 0) cluster_wait();
    cluster_arrive();   // P(jg): no CTA leaves while another may load its partials
    cluster_wait();
  }
}

// grid (tiles, m / N, groups), two warpgroups a CTA
template <int N, bool KSTACK>
__global__ void __launch_bounds__(2 * WG, 1)
rows_kernel(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tw,
            const float* __restrict__ b, const float* __restrict__ cm, bf16* __restrict__ yscr,
            bf16* __restrict__ out, int m, int cc, int n, int nrows, int reps, int groups,
            int fsets) {
  const int tiles = gridDim.x, units = tiles * gridDim.y * gridDim.z;
  rows_body<N, KSTACK, false, 2>(&tu, &tw, b, cm, yscr, out, m, cc, n, nrows, reps, groups,
                                 blockIdx.x + tiles * (blockIdx.y + gridDim.y * blockIdx.z), units,
                                 units, tiles, 0, fsets);
}

// clusters of cc CTAs along x (given at launch), cluster k walking units
// k, k + clusters, .. of the tiles x (m / 64) x groups; two warpgroups a
// CTA
template <bool KSTACK>
__global__ void __launch_bounds__(2 * WG, 1)
rows_split_kernel(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ b, const float* __restrict__ cm,
                  bf16* __restrict__ yscr, bf16* __restrict__ out, int m, int cc, int n, int nrows,
                  int reps, int groups, int tiles) {
  rows_body<64, KSTACK, true, 1>(&tu, &tw, b, cm, yscr, out, m, cc, n, nrows, reps, groups,
                                 blockIdx.x / cc, gridDim.x / cc, tiles * (m / 64) * groups, tiles,
                                 cluster_rank(), 2);
}

bool takes_m(int m) { return m == 64 || m == 128 || m == 256; }

bool takes_mt(int mt) { return mt == 1 || mt == 2 || mt == 4; }

int tiles_of(int n) { return (n + TILE - 1) / TILE; }

// rep groups: as many as fill the device's SMs with `ctas` CTAs each, at
// least 1, at most reps; -1 if the device cannot be asked
int groups_of(int ctas, int reps) {
  const int sms = sm_count();
  if (sms <= 0) return -1;
  const int g = sms / ctas;
  return g < 1 ? 1 : (g > reps ? reps : g);
}

// The clusters of the split row kernel that the current device holds at
// once (asked once a device and plan: the query costs more host time than
// the launch); -1 if it cannot be asked
int clusters_held(bool kstack, const RowsPlan& p) {
  static int held[2][MAX_SPLIT + 1][64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  int& h = held[kstack][p.split][dev];
  if (h <= 0) {
    const auto kernel = kstack ? rows_split_kernel<true> : rows_split_kernel<false>;
    if (allow_smem(kernel, p.bytes) != cudaSuccess) return -1;
    cudaLaunchAttribute dims;
    dims.id = cudaLaunchAttributeClusterDimension;
    dims.val.clusterDim.x = static_cast<unsigned>(p.split);
    dims.val.clusterDim.y = 1;
    dims.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(p.split));
    config.blockDim = dim3(2 * WG);
    config.dynamicSmemBytes = static_cast<size_t>(p.bytes);
    config.attrs = &dims;
    config.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&h, kernel, &config) != cudaSuccess || h <= 0) {
      h = 0;
      return -1;
    }
  }
  return h;
}

// The split row route's rep groups: `base` units a group (tiles x parts)
// walked by `held` clusters; the fewest (at most MAX_GROUPS and reps) that
// spread the units most evenly over the clusters
int balanced_groups(int base, int held, int reps) {
  int best = 1;
  long long busy = 0, slots = 1;   // the best share of the clusters' turns that are busy
  for (int gg = 1; gg <= MAX_GROUPS && gg <= reps; ++gg) {
    const long long u = static_cast<long long>(base) * gg, turns = (u + held - 1) / held * held;
    if (u * slots > busy * turns) {
      best = gg;
      busy = u;
      slots = turns;
    }
  }
  return best;
}

template <int N>
cudaError_t dots_launch(const CUtensorMap& tp, const CUtensorMap& tl, float* part, void* out,
                        int kc, int n, int nplanes, int reps, int ks, int groups, int streamed,
                        int bytes, cudaStream_t stream) {
  cudaError_t err = allow_smem(dots_kernel<N>, bytes);
  if (err != cudaSuccess) return err;
  CDFO_LAUNCH_N(dots_kernel<N>, dim3(tiles_of(n), ks, groups), WG, bytes, stream, tp, tl, part,
                kc, n, nplanes, reps, ks, groups, streamed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(N) * n;
  const dim3 rgrid(static_cast<unsigned>((total + THREADS - 1) / THREADS));
  CDFO_LAUNCH(dots_reduce, rgrid, 0, stream, part, static_cast<bf16*>(out), N, n, ks * groups);
  return cudaGetLastError();
}

template <int N, bool KSTACK>
cudaError_t rows_launch(const RowsPlan& p, const CUtensorMap& tu, const CUtensorMap& tw,
                        const float* b, const float* cm, bf16* yscr, bf16* out, int m, int cc,
                        int n, int nrows, int reps, int groups, cudaStream_t stream) {
  if (p.split == 1) {
    const auto kernel = rows_kernel<N, KSTACK>;
    cudaError_t err = allow_smem(kernel, p.bytes);
    if (err != cudaSuccess) return err;
    CDFO_LAUNCH_N(kernel, dim3(tiles_of(n), m / N, groups), 2 * WG, p.bytes, stream, tu, tw, b,
                  cm, yscr, out, m, cc, n, nrows, reps, groups, p.fsets);
  } else {
    const auto kernel = rows_split_kernel<KSTACK>;
    const int held = clusters_held(KSTACK, p);
    if (held <= 0) return cudaErrorInvalidValue;
    const int tiles = tiles_of(n), units = tiles * (m / 64) * groups;
    CDFO_LAUNCH_CLUSTER_N(kernel, dim3(p.split * (units < held ? units : held)), p.split, 2 * WG,
                          p.bytes, stream, tu, tw, b, cm, yscr, out, m, cc, n, nrows, reps, groups,
                          tiles);
  }
  return cudaGetLastError();
}

template <bool KSTACK>
cudaError_t rows_by_plan(const RowsPlan& p, const CUtensorMap& tu, const CUtensorMap& tw,
                         const float* b, const float* cm, bf16* yscr, bf16* out, int m, int cc,
                         int n, int nrows, int reps, int groups, cudaStream_t stream) {
  // (kstack's slots leave no room for 128 channels of W: rows_plan never
  // gives it that tile, and it is not built)
  if constexpr (!KSTACK) {
    if (p.n_w == 128) {
      return rows_launch<128, false>(p, tu, tw, b, cm, yscr, out, m, cc, n, nrows, reps, groups,
                                     stream);
    }
  }
  if (p.n_w != 64) return cudaErrorInvalidValue;
  return rows_launch<64, KSTACK>(p, tu, tw, b, cm, yscr, out, m, cc, n, nrows, reps, groups,
                                 stream);
}

}  // namespace

// The partial sums of dots at (m, k, n, nplanes, reps): K slices x rep
// groups, the groups as many as fill the current device's SMs with one
// CTA each (at least 1, at most reps); the workspace holds parts x n x m
// floats. -1 if m is not 64, 128 or 256, k not a multiple of 64, or the
// device cannot be asked.
extern "C" int cdfo_probe_dots_parts(int m, int k, int n, int nplanes, int reps,
                                     int stream_planes) {
  if (!takes_m(m) || k <= 0 || k % 64 != 0 || n <= 0 || nplanes <= 0 || reps <= 0) return -1;
  const int kc = k / 64;
  const int streamed = stream_planes || dots_slices(m, kc, nplanes, 0) < 0;
  const int ks = dots_slices(m, kc, nplanes, streamed);
  if (ks < 0) return -1;
  const int groups = groups_of(tiles_of(n) * ks, reps);
  return groups < 0 ? -1 : ks * groups;
}

// dots: rhs (nplanes, n, k) bf16 (the TPU layout (nplanes, k, n)
// transposed), lhs (m, k) bf16 as it is, part the fp32 workspace of
// `parts` x n x m (cdfo_probe_dots_parts), out (m, n) bf16;
// stream_planes: stream the planes from L2 even where they fit shared
// memory (they are streamed anyway where they do not). Returns a
// cudaError_t.
extern "C" int cdfo_probe_dots(const void* rhs, const void* lhs, void* part, void* out, int m,
                               int k, int n, int nplanes, int reps, int parts, int stream_planes,
                               void* stream) {
  if (!takes_m(m) || k <= 0 || k % 64 != 0 || n <= 0 || nplanes <= 0 || nplanes > 65535 ||
      reps <= 0 || parts <= 0) {
    return cudaErrorInvalidValue;
  }
  const int kc = k / 64;
  const int streamed = stream_planes || dots_slices(m, kc, nplanes, 0) < 0;
  const int ks = dots_slices(m, kc, nplanes, streamed);
  if (ks < 0 || parts % ks != 0 || parts / ks > 65535 || ks > 65535) return cudaErrorInvalidValue;
  const int groups = parts / ks;
  const int bytes = dots_bytes(m, (kc + ks - 1) / ks, nplanes, streamed);
  CUtensorMap tp, tl;
  cudaError_t err;
  if ((err = nhwc_tensor_map(&tp, rhs, nplanes, n, kc, 1, TILE)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tl, lhs, 1, m, kc, 1, m)) != cudaSuccess) {
    return err;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = static_cast<float*>(part);
  switch (m) {
    case 64: return dots_launch<64>(tp, tl, f, out, kc, n, nplanes, reps, ks, groups, streamed, bytes, s);
    case 128: return dots_launch<128>(tp, tl, f, out, kc, n, nplanes, reps, ks, groups, streamed, bytes, s);
    default: return dots_launch<256>(tp, tl, f, out, kc, n, nplanes, reps, ks, groups, streamed, bytes, s);
  }
}

// The rep groups of rowpipe (kstack = 0) or kstack (1) at (m, c, n, reps)
// with at most mt 64-channel m-tiles a CTA: as many as fill the current
// device's SMs (at least 1, at most reps), or, split by input channels,
// the fewest that spread the units over the clusters it holds most evenly
// (balanced_groups); the y scratch holds groups x nrows x n x m. -1 if m is not 64, 128 or 256, mt not 1, 2 or 4, c not
// a multiple of 64 up to 512, no plan fits shared memory or the device
// cannot be asked.
extern "C" int cdfo_probe_rows_groups(int kstack, int mt, int m, int c, int n, int reps) {
  RowsPlan p;
  if (!takes_m(m) || !takes_mt(mt) || c <= 0 || c % 64 != 0 || n <= 0 || reps <= 0 ||
      !rows_plan(kstack != 0, m, c, mt, p)) {
    return -1;
  }
  if (p.split == 1) return groups_of(tiles_of(n) * (m / p.n_w), reps);
  const int held = clusters_held(kstack != 0, p);
  return held <= 0 ? -1 : balanced_groups(tiles_of(n) * (m / 64), held, reps);
}

// The 64-channel m-tiles a CTA of kstack keeps at (m, c, nrows): the most
// (of 2, 1) whose W and slots fit shared memory; 1 where the input
// channels are split over a cluster; -1 if nothing fits, m is not 64, 128
// or 256, c not a multiple of 64 up to 512 or nrows < 3.
extern "C" int cdfo_probe_kstack_mt(int m, int c, int nrows) {
  RowsPlan p;
  if (!takes_m(m) || c <= 0 || c % 64 != 0 || nrows < 3 || !rows_plan(true, m, c, 4, p)) {
    return -1;
  }
  return p.n_w / 64;
}

// rowpipe (kstack = 0) or kstack (1) with at most mt 64-channel m-tiles a
// CTA (kstack: the one cdfo_probe_kstack_mt gives): u (nrows + 2, n + 8,
// c) bf16, w (m, 9c) bf16 as it is, b (m,) and cm (n,) float32, yscr
// [groups][nrows][n][m] bf16 (groups from cdfo_probe_rows_groups at the
// same mt), out (m, n) bf16. kstack needs reps > nrows. Returns a
// cudaError_t.
extern "C" int cdfo_probe_rows(int kstack, int mt, const void* u, const void* w, const void* b,
                               const void* cm, void* yscr, void* out, int m, int c, int n,
                               int nrows, int reps, int groups, void* stream) {
  RowsPlan p;
  if (!takes_m(m) || !takes_mt(mt) || c <= 0 || c % 64 != 0 || n <= 0 || nrows < 3 ||
      nrows + 2 > 65535 || reps <= 0 || (kstack && reps <= nrows) || groups <= 0 ||
      groups > 65535 || !rows_plan(kstack != 0, m, c, mt, p)) {
    return cudaErrorInvalidValue;
  }
  const int cc = c / 64;
  CUtensorMap tu, tw;
  cudaError_t err;
  if ((err = nhwc_tensor_map(&tu, u, nrows + 2, n + 8, cc, 1, ROWBOX)) != cudaSuccess ||
      (err = nhwc_tensor_map(&tw, w, 1, m, 9 * cc, 1, p.n_w)) != cudaSuccess) {
    return err;
  }
  const auto bb = static_cast<const float*>(b);
  const auto cb = static_cast<const float*>(cm);
  const auto yb = static_cast<bf16*>(yscr);
  const auto ob = static_cast<bf16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return kstack ? rows_by_plan<true>(p, tu, tw, bb, cb, yb, ob, m, cc, n, nrows, reps, groups, s)
                : rows_by_plan<false>(p, tu, tw, bb, cb, yb, ob, m, cc, n, nrows, reps, groups, s);
}
