// The SCNet Block_ body pair, hand-written for Hopper (sm_90a):
//   out = conv2(lrelu(conv1 x + b1)) + b2 (+ x)
// with conv1 a 3x3 conv 64 -> 256, conv2 a 3x3 conv 256 -> 64, both with
// zero padding 1, lrelu slope 0.1.
//
// Replaces the TPU kernel cdfo_tpu/ops/fused_block.py::block_body_hcw
// (kernel body _body_kernel), which fused_block_body runs for
// tools/microbench_trunk.py; no model path launches it.
//
// What bounds it: operations. 2 * 9 * (64 * 256 + 256 * 64) = 589,824 FLOP
// per pixel against 2 x 128 B of x and out (bf16): 3.08e11 FLOP at
// (4, 272, 480, 64), 0.311 ms at 989 TFLOP/s, against 0.040 ms of bytes.
// The eager pair writes and reads the 256-channel y (4x the bytes of x)
// through device memory; this kernel keeps it on chip.
// Rounding is the TPU kernel's: y1 is stored in the working type, b2 and
// the residual are added to conv2's fp32 sum before the one output
// rounding.
//
// bfloat16 (the main shape's route): a walk down 62-column strips by
// clusters of 4 CTAs, one CTA an SM, on wgmma (`wgmma_tile.cuh`).
// - The weights stay resident, split over the cluster: CTA q keeps conv1's
//   9 taps for mid channels 64q .. 64q + 63 and conv2's 9 taps from those
//   channels, 2 x 72 KB, loaded once (`pack_body_weights`). The first
//   design (one CTA per 8 x 16 tile, mma.sync) read the whole 590 KB of
//   weights from L2 in every one of its 4080 CTAs, ~2.4 GB a call, and
//   recomputed conv1 over a 10 x 18 window for 8 x 16 outputs.
// - The cluster walks an even share of the units (image, strip, output
//   row) a row a step. Each CTA loads x's window rows (66 pixels: the
//   strip, conv1's and conv2's halos) by TMA into a ring of 4, a step
//   ahead; y1's window rows (64 pixels, one m64 tile) stay in a ring of 4,
//   so that each y1 row is computed once per walk, its vertical halo
//   included (a walk's first 4 steps are its warm-up).
// - Both warpgroups run one code path, `conv3x3_taps` (9 taps x 4 k16 of
//   m64n64 over three swizzled window rows, issued in two parts), on data
//   chosen by selects: warpgroup 0 conv1 of y1 row j from x's rows (its 64
//   channels), warpgroup 1 this CTA's part of conv2 for output row j - 3
//   from y1's rows j - 4 .. j - 2, the same 36 products each.
// - Each warpgroup finishes the last step's epilogue under this step's
//   products: warpgroup 0 stores lrelu(conv1 + b1) rounded (zero outside
//   the image: conv2's padding) over y1's oldest row once warpgroup 1's
//   products that read it are done; warpgroup 1 sends the 16-channel
//   quarters of its fp32 partial to the CTAs that own them, as
//   asynchronous stores into their shared memory that complete on their
//   mbarrier, and adds the four partials of its own quarter in rank order,
//   + b2 (+ x, read from device memory a step earlier) in fp32, rounds
//   once and stores. Named barriers hand y1's slots between the two
//   warpgroups; one cluster barrier a step (relaxed: it orders only the
//   reads of the receive buffer before the next sends) is the only wait
//   on other CTAs besides the partials' own mbarrier.
// - What bounds it on an H100: its m64n64k16 products with both operands
//   from shared memory run at ~42 cycles each (0.525 ms of products alone
//   at (4, 272, 480, 64)), a 4-CTA cluster takes a quarter of the mid
//   channels, so N stays 64, and the card holds 30 such clusters: 120 of
//   its 132 SMs. A first version, with plain remote stores, two cluster
//   barriers a step (one with release) and every epilogue between the
//   products, spent ~6300 cycles a step against ~2300 of products.
// float32 (the twin for the float32 checks) keeps the first design: one
// CTA of 8 warps per 8 x 16 output tile, mid channels walked in 4 chunks of
// 64 through a (10 x 18) y1 window in shared memory, the products on the
// CUDA cores with the weights from device memory in fragment order.

#include "wgmma_tile.cuh"

// Phase marks (`phase_clocks.cuh`) of the bf16 walk, per step in thread 0's
// view (warpgroup 0): the wait for x's rows, the products, the wait for the
// receive buffers and y1's row, the barrier after the sends, and warpgroup
// 1's reduction and stores.
#include "phase_clocks.cuh"

namespace {

using namespace cdfo;

constexpr int R = 8, S = 16;                  // output tile rows x columns
constexpr int XR = R + 4, XC = S + 4;         // x window
constexpr int YR = R + 2, YC = S + 2;         // y1 window
constexpr int CM = 4 * C;                     // mid channels
constexpr int NY = (YR * YC + 15) / 16;       // y1 m-tiles (12)
constexpr int NO = R * S / 16;                // output m-tiles (8)
constexpr int MT1 = NY / 4, MT2 = NO / 4;     // m-tiles per warp: 3, 2
static_assert(NY % 4 == 0 && NO % 4 == 0, "4 m-groups x 2 channel halves");

template <typename T>
constexpr int smem_bytes() {
  return (XR * XC + YR * YC) * Pitch<T>::value * static_cast<int>(sizeof(T));
}

// ---- float32: one CTA per 8 x 16 tile --------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
body_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
            const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int h,
            int wd, int residual) {
  constexpr int P = Pitch<T>::value;
  extern __shared__ uint4 cdfo_smem[];
  T* xs = reinterpret_cast<T*>(cdfo_smem);
  T* y1 = xs + XR * XC * P;

  const int r0 = blockIdx.y * R, c0 = blockIdx.x * S;
  const long long img = static_cast<long long>(blockIdx.z) * h * wd * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mg = warp & 3, half = (warp >> 2) * 32;   // m-group, channel half

  load_window(xs, x + img, h, wd, r0 - 2, c0 - 2, XR, XC, false);
  const Weights<T> wt1{w1, CM, C}, wt2{w2, C, CM};
  ATile<T> a1[MT1], a2[MT2];
#pragma unroll
  for (int m = 0; m < MT1; ++m) a1[m] = a_tile<1>(xs, XC, YC, YR * YC, mg * MT1 + m, lane);
#pragma unroll
  for (int m = 0; m < MT2; ++m) a2[m] = a_tile<1>(y1, YC, S, R * S, mg * MT2 + m, lane);
  float acc2[MT2][4][4];
  zero(acc2);
  __syncthreads();

#pragma unroll 1
  for (int ch = 0; ch < 4; ++ch) {
    // conv1 phase: y1 = lrelu(conv1 + b1) of this chunk, 0 outside the image
    float acc1[MT1][4][4];
    zero(acc1);
    conv_tiles<3, 3, MT1, 4>(acc1, a1, wt1, ch * C + half, 0, lane);
#pragma unroll
    for (int m = 0; m < MT1; ++m) {
      for_each_pair(acc1[m], mg * MT1 + m, half, YR * YC, lane, [&](int p, int n, float v0, float v1) {
        const bool in = inside(r0 - 1 + p / YC, c0 - 1 + p % YC, h, wd);
        const float2 bb = load2(b1 + ch * C + n);
        store2(y1 + p * P + n, in ? lrelu(v0 + bb.x) : 0.f, in ? lrelu(v1 + bb.y) : 0.f);
      });
    }
    __syncthreads();
    // conv2 phase: the chunk's 64 input channels of conv2
    conv_tiles<3, 3, MT2, 4>(acc2, a2, wt2, half, ch * C, lane);
    __syncthreads();
  }

  // out = conv2 + b2 (+ x), rounded once
#pragma unroll
  for (int m = 0; m < MT2; ++m) {
    for_each_pair(acc2[m], mg * MT2 + m, half, R * S, lane, [&](int p, int n, float v0, float v1) {
      const int py = p / S, px = p % S;
      const int y = r0 + py, xx = c0 + px;
      if (y >= h || xx >= wd) return;
      const float2 bb = load2(b2 + n);
      float o0 = v0 + bb.x, o1 = v1 + bb.y;
      if (residual) {
        const float2 xv = load2(xs + ((py + 2) * XC + px + 2) * P + n);
        o0 += xv.x;
        o1 += xv.y;
      }
      store2(out + img + (static_cast<long long>(y) * wd + xx) * C + n, o0, o1);
    });
  }
}

cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int batch, int h, int wd, int residual,
                       cudaStream_t stream) {
  using T = float;
  const cudaError_t err = allow_smem(body_kernel<T>, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + S - 1) / S, (h + R - 1) / R, batch);
  CDFO_LAUNCH(body_kernel<T>, grid, smem_bytes<T>(), stream, static_cast<const T*>(x),
              static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
              static_cast<const T*>(b2), static_cast<T*>(out), h, wd, residual);
  return cudaGetLastError();
}

// ---- bfloat16: the cluster walk on wgmma -----------------------------------

constexpr int CLUSTER = 4;                   // CTAs of a cluster, 64 mid channels each
constexpr int XWIN = STRIP + 4;              // x's window row: columns c0 - 2 .. c0 + 63
constexpr int XSLOT = 9 * 1024;              // its ring slot (>= 66 pixel rows, 1024-aligned)
constexpr int XROW_BYTES = XWIN * C * 2;
constexpr int YSLOT = STRIP_WIN * C * 2;     // y1's window row: columns c0 - 1 .. c0 + 62
constexpr int RING = 4;                      // slots of each ring
constexpr int WCONV = 9 * C * C * 2;         // one conv's 9 taps for this CTA's 64 channels
// the receive buffer: [the 3 other CTAs][2 n-tiles][128 threads][4] fp32
constexpr int RECV = 3 * 2 * 128 * 4 * 4;
// mbarriers: x's slots, the weights, the receive buffer
constexpr int BARS = RING + 2;
// conv1 | conv2 | x ring | y1 ring (+ 2 pixel rows: conv2's overread) |
// receive buffer | mbarriers
constexpr int SMEM_BODY =
    1024 + 2 * WCONV + RING * XSLOT + RING * YSLOT + 2 * C * 2 + RECV + BARS * 8;
static_assert(XROW_BYTES <= XSLOT && WCONV % 1024 == 0 && YSLOT % 1024 == 0,
              "1024-byte aligned tiles");
static_assert(SMEM_BODY <= 232448, "one block's shared memory");
// named barriers, two each by the step's parity: warpgroup 1's products of
// step s are done (y1's slot s % RING may go); y1's row of step s is in
// place
constexpr int Y1_FREE = 3, Y1_READY = 5;

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
body_walk_kernel(const __grid_constant__ CUtensorMap tx, const bf16* __restrict__ x,
                 const bf16* __restrict__ wpack, const bf16* __restrict__ b1,
                 const bf16* __restrict__ b2, bf16* __restrict__ out, int batch, int h, int wd,
                 int residual) {
  unsigned char* base = dynamic_smem();
  base += (1024u - (shared_address(base) & 1023u)) & 1023u;
  bf16* w1s = reinterpret_cast<bf16*>(base);                  // [9][64 n][64 k], swizzled
  bf16* w2s = w1s + WCONV / 2;
  bf16* xring = w2s + WCONV / 2;                              // x's rows, swizzled
  bf16* yring = xring + RING * XSLOT / 2;                     // y1's rows, swizzled
  float* recv = reinterpret_cast<float*>(yring + RING * YSLOT / 2 + 2 * C);
  uint64_t* bars = reinterpret_cast<uint64_t*>(recv + RECV / 4);
  uint64_t* wbar = bars + RING;                               // the weights
  uint64_t* rfull = bars + RING + 1;                          // the receive buffer's partials

  const int rank = cluster_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t2 = 2 * (lane & 3);
  const int strips = (wd + STRIP - 1) / STRIP;
  const long long total = static_cast<long long>(batch) * strips * h;
  const long long clusters = gridDim.x / CLUSTER, cl = blockIdx.x / CLUSTER;
  const long long g0 = cl * total / clusters, g1 = (cl + 1) * total / clusters;
  if (g0 >= g1) return;   // the whole cluster leaves together

  if (threadIdx.x == 0) {
    for (int i = 0; i < BARS; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    mbar_expect_tx(wbar, 2 * WCONV);
    bulk_copy(w1s, wpack + rank * WCONV, WCONV, wbar);
    bulk_copy(w2s, wpack + rank * WCONV + WCONV / 2, WCONV, wbar);
  }
  float2 bv1[8], bv2[2];   // this lane's channels 8 jj + t2, + 1 of b1 (this CTA's) and b2's quarter
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) bv1[jj] = load2(b1 + C * rank + 8 * jj + t2);
#pragma unroll
  for (int u = 0; u < 2; ++u) bv2[u] = load2(b2 + 16 * rank + 8 * u + t2);

  // x's loads, one window row each, in walk order: a walk over output rows
  // [a, e) takes rows a - 2 .. e + 3; load n goes to slot n % RING
  StripStep iw = strip_walk_at(g0, g1, h, strips);
  int irow = iw.a - 2;
  bool idone = false;
  unsigned issued = 0;
  auto issue_below = [&](unsigned end) {   // thread 0: the loads before `end`
    while (!idone && issued < end) {
      mbar_expect_tx(bars + issued % RING, XROW_BYTES);
      tma_load_row(xring + (issued % RING) * (XSLOT / 2), &tx, iw.c0 - 2, irow, iw.b,
                   bars + issued % RING);
      ++issued;
      if (++irow > iw.e + 3) {
        const long long nu = iw.u + (iw.e - iw.a);
        idone = nu >= g1;
        if (!idone) {
          iw = strip_walk_at(nu, g1, h, strips);
          irow = iw.a - 2;
        }
      }
    }
  };
  cluster_sync();   // every CTA's mbarriers are set before a partial reaches them
  if (threadIdx.x == 128) mbar_expect_tx(rfull, RECV);   // (step 0's partials)
  mbar_wait(wbar, 0);

  // this CTA's quarter of an output row (warpgroup 1): the four partials
  // in rank order (its own from `own`, the others' from the receive
  // buffer, phase `ph` of rfull), + b2 (+ x, `xv`), rounded once
  auto reduce = [&](const float(&own)[8][4], const uint32_t(&xv)[2][2], unsigned ph, int b,
                    int c0, int y, bool valid) {
    mbar_wait(rfull, ph & 1u);
    float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int src = 0; src < CLUSTER; ++src) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v[4];
        if (src == rank) {
#pragma unroll
          for (int qq = 0; qq < CLUSTER; ++qq) {
            if (qq == rank) {
#pragma unroll
              for (int i = 0; i < 4; ++i) v[i] = own[2 * qq + u][i];
            }
          }
        } else {
          const float4 f = *reinterpret_cast<const float4*>(
              recv + (((src < rank ? src : src - 1) * 2 + u) * 128 + tid) * 4);
          v[0] = f.x;
          v[1] = f.y;
          v[2] = f.z;
          v[3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[u][i] += v[i];
      }
    }
    warpgroup_sync(1);   // the warpgroup has read the buffer:
    if (tid == 0) mbar_expect_tx(rfull, RECV);   // the next partials' phase
    if (!valid) return;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = 16 * wl + g + 8 * hf;
      if (q >= STRIP || c0 + q >= wd) continue;
      bf16* px = out + ((static_cast<long long>(b) * h + y) * wd + c0 + q) * C + 16 * rank + t2;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float o0 = sum[u][2 * hf] + bv2[u].x, o1 = sum[u][2 * hf + 1] + bv2[u].y;
        if (residual) {   // the pair's first value in the low half
          o0 += __uint_as_float(xv[u][hf] << 16);
          o1 += __uint_as_float(xv[u][hf] & 0xffff0000u);
        }
        store2(px + 8 * u, o0, o1);
      }
    }
  };
  // quarter qq (n-tiles 2 qq, 2 qq + 1) of a partial to CTA qq, into its
  // receive buffer's slot for this rank (warpgroup 1)
  auto send = [&](const float(&part)[8][4]) {
#pragma unroll
    for (int qq = 0; qq < CLUSTER; ++qq) {
      if (qq == rank) continue;
      float* slot = recv + (rank < qq ? rank : rank - 1) * 2 * 128 * 4;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float(&a)[4] = part[2 * qq + u];
        st_async_remote4(slot + (u * 128 + tid) * 4, qq, a[0], a[1], a[2], a[3], rfull);
      }
    }
  };

  // y1 row r of the strip from column c0 - 1 (warpgroup 0): lrelu(conv1 +
  // b1) rounded, zero outside the image, into slot `slot` over the oldest
  // row once warpgroup 1's products that read it are done (Y1_FREE), then
  // announced (Y1_READY)
  auto store_y1 = [&](const float(&v)[8][4], unsigned slot, int r, int c0) {
    named_sync(Y1_FREE + (slot & 1), THREADS);
    bf16* row = yring + slot % RING * (YSLOT / 2);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = 16 * wl + g + 8 * hf;
      const bool in = inside(r, c0 - 1 + p, h, wd);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        store2(swizzled(row, p, 8 * jj + t2), in ? lrelu(v[jj][2 * hf] + bv1[jj].x) : 0.f,
               in ? lrelu(v[jj][2 * hf + 1] + bv1[jj].y) : 0.f);
      }
    }
    async_fence();
    named_arrive(Y1_READY + (slot & 1), THREADS);
  };

  // Step s = st, step k of a walk: warpgroup 0 computes conv1 of y1 row
  // a - 1 + k from x's rows a - 2 + k .. a + k (loads nw + k .. nw + k + 2)
  // and stores it in step s + 1, under that step's products, into y1 slot
  // s % RING; warpgroup 1 computes the partial of output row a - 4 + k from
  // y1's rows a - 5 + k .. a - 3 + k (steps s - 4 .. s - 2, slots s, s + 1,
  // s + 2 % RING), and in step s + 1 sends it and adds up the partials it
  // receives, under that step's products; output rows before a are the
  // warm-up's and are dropped. Both keep the step's accumulators (`prev`)
  // for the next. The cluster barrier's phase P(s) comes after each CTA's
  // sums of step s - 1; the next partials go out after it.
  StripStep cw = strip_walk_at(g0, g1, h, strips);
  unsigned nw = 0, st = 0;
  int k = 0;
  float prev[8][4];                // the last step's accumulators
  uint32_t xprev[2][2] = {{0u, 0u}, {0u, 0u}};   // warpgroup 1: its residual
  int pb = 0, pc0 = 0, pa = 0, pk = 0;           // its walk and step
  PHASE_START
#pragma unroll 1
  while (true) {
    const unsigned need = nw + k + 2;
    const int steps = cw.e - cw.a + 4;   // the walk's
    if (wg == 0) {
      // x's rows up to a step ahead: a load replaces one that no step from
      // this one on reads
      if (threadIdx.x == 0) issue_below(need + 2);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const unsigned n = need - 2 + i;
        mbar_wait(bars + n % RING, (n / RING) & 1u);
      }
    }
    const int y = cw.a - 4 + k;   // warpgroup 1's output row
    uint32_t xres[2][2] = {{0u, 0u}, {0u, 0u}};   // its residual: [n-tile][pixel half]
    if (wg == 1 && residual && k >= 4) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = 16 * wl + g + 8 * hf;
        if (q < STRIP && cw.c0 + q < wd) {
          const bf16* px =
              x + ((static_cast<long long>(cw.b) * h + y) * wd + cw.c0 + q) * C + 16 * rank + t2;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            xres[u][hf] = __ldg(reinterpret_cast<const unsigned*>(px + 8 * u));
          }
        }
      }
    }
    if (wg == 1 && st >= 2) named_sync(Y1_READY + (st & 1), THREADS);   // y1 of step s - 2
    PHASE(0)
    float acc[8][4];
    const bf16* r0 = wg ? yring + st % RING * (YSLOT / 2) : xring + (need - 2) % RING * (XSLOT / 2);
    const bf16* r1 =
        wg ? yring + (st + 1) % RING * (YSLOT / 2) : xring + (need - 1) % RING * (XSLOT / 2);
    const bf16* r2 = wg ? yring + (st + 2) % RING * (YSLOT / 2) : xring + need % RING * (XSLOT / 2);
    const bf16* wc = wg ? w2s : w1s;
    conv3x3_taps<0, 5>(acc, r0, r1, r2, wc);
    if (st > 0) {
      cluster_wait();   // P(s - 1): every CTA has added up its partials of step s - 2
      if (wg == 1) send(prev);
    }
    conv3x3_taps<5, 9>(acc, r0, r1, r2, wc);
    PHASE(1)
    if (st > 0) {   // the last step's epilogue, under this step's products
      if (wg == 1) {
        reduce(prev, xprev, st - 1, pb, pc0, pa - 4 + pk, pk >= 4);
      } else {
        store_y1(prev, st - 1, pa - 1 + pk, pc0);
      }
    }
    PHASE(2)
    wgmma_wait<0>();
    keep(acc);
    if (wg == 1) named_arrive(Y1_FREE + (st & 1), THREADS);   // slot s % RING may go
    PHASE(3)
    cluster_arrive_relaxed();   // P(s): this CTA's reads of its receive buffer are done
    PHASE(4)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) prev[jj][i] = acc[jj][i];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      xprev[u][0] = xres[u][0];
      xprev[u][1] = xres[u][1];
    }
    pb = cw.b;
    pc0 = cw.c0;
    pa = cw.a;
    pk = k;
    ++st;
    PHASE_STEP
    if (++k >= steps) {
      const long long nu = cw.u + (cw.e - cw.a);
      if (nu >= g1) break;
      nw += cw.e - cw.a + 6;
      cw = strip_walk_at(nu, g1, h, strips);
      k = 0;
    }
  }
  cluster_wait();   // P(last)
  if (wg == 1) {
    send(prev);
    reduce(prev, xprev, st - 1, pb, pc0, pa - 4 + pk, pk >= 4);
    // the last two y1 rows' barriers, which no step waited for
    for (unsigned t = st < 2 ? 2 : st; t < st + 2; ++t) named_sync(Y1_READY + (t & 1), THREADS);
  } else {
    store_y1(prev, st - 1, pa - 1 + pk, pc0);
  }
  cluster_sync();   // no CTA leaves while a partial may still reach it
  PHASE_END
}

cudaError_t launch_bf16(const void* x, const void* wpack, const void* b1, const void* b2,
                        void* out, int batch, int h, int wd, int residual, cudaStream_t stream) {
  cudaError_t err = allow_smem(body_walk_kernel, SMEM_BODY);
  if (err != cudaSuccess) return err;
  CUtensorMap tx;
  if ((err = nhwc_tensor_map(&tx, x, batch, h, wd, XWIN)) != cudaSuccess) return err;
  // the clusters the card holds at once (asked once a device: the query
  // costs more host time than the launch)
  static int held[64] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidValue;
  if (held[dev] <= 0) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(CLUSTER);
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes = SMEM_BODY;
    err = cudaOccupancyMaxActiveClusters(&held[dev], body_walk_kernel, &config);
    if (err != cudaSuccess) return err;
    if (held[dev] <= 0) return cudaErrorInvalidValue;
  }
  int clusters = held[dev];
  const long long units = static_cast<long long>(batch) * ((wd + STRIP - 1) / STRIP) * h;
  if (units < clusters) clusters = static_cast<int>(units);
  CDFO_LAUNCH_CLUSTER(body_walk_kernel, dim3(CLUSTER * clusters), CLUSTER, SMEM_BODY, stream, tx,
                      static_cast<const bf16*>(x), static_cast<const bf16*>(wpack),
                      static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
                      static_cast<bf16*>(out), batch, h, wd, residual);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, h, wd, 64) NHWC (bfloat16: 16-byte aligned); b1 [256],
// b2 [64]. float32: w1 [9][256][64] and w2 [9][64][256] in the Weights
// layout of conv3x3_tile.cuh; bfloat16: w1 the resident slices as
// ops/fused_block.py::pack_body_weights gives them ([4 CTAs][conv1, conv2]
// [9 taps][64 n][64 k], 128-byte swizzled) and w2 unused. All device
// pointers of one dtype (is_bf16: 1 for bfloat16, 0 for float32);
// residual: 1 adds x to the output. Returns a cudaError_t.
extern "C" int cdfo_fused_block(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int is_bf16, int batch, int h, int wd,
                                int residual, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(x, w1, b1, b2, out, batch, h, wd, residual, s)
                 : launch_f32(x, w1, b1, w2, b2, out, batch, h, wd, residual, s);
}
