// Phase clocks of a kernel, compiled in only with -DCDFO_PHASE_CLOCKS
// (`chip_smoke.py --phases`); without it the marks are empty.
//
// A kernel puts PHASE_START before its first phase, PHASE(i) at the end of
// phase i (i < 14; a mark inside a loop adds up over its iterations),
// PHASE_STEP at the end of each step of a kernel that walks steps, and
// PHASE_END where every thread of the CTA has passed its last mark. Each
// thread keeps the cycles (clock64) between its marks; thread 0 of every
// CTA (or thread CDFO_PHASE_THREAD, another warpgroup's view) adds its own
// to cdfo_phase_clocks[i], the steps it ran to cdfo_phase_clocks[14] and 1
// to cdfo_phase_clocks[15], the CTA count.
// cdfo_phase_clocks_read copies the 16 counters out and zeroes them.
#pragma once

#ifdef CDFO_PHASE_CLOCKS
#ifndef CDFO_PHASE_THREAD
#define CDFO_PHASE_THREAD 0
#endif
__device__ unsigned long long cdfo_phase_clocks[16];
#define PHASE_START                  \
  long long phase_t = clock64();     \
  long long phase_steps = 0;         \
  long long phase_acc[14] = {};
#define PHASE(i)                           \
  {                                        \
    const long long t_ = clock64();        \
    phase_acc[i] += t_ - phase_t;          \
    phase_t = t_;                          \
  }
#define PHASE_STEP ++phase_steps;
#define PHASE_END                                                                   \
  if (threadIdx.x == CDFO_PHASE_THREAD) {                                          \
    for (int i_ = 0; i_ < 14; ++i_) {                                              \
      atomicAdd(&cdfo_phase_clocks[i_], static_cast<unsigned long long>(phase_acc[i_])); \
    }                                                                              \
    atomicAdd(&cdfo_phase_clocks[14], static_cast<unsigned long long>(phase_steps)); \
    atomicAdd(&cdfo_phase_clocks[15], 1ull);                                       \
  }
extern "C" int cdfo_phase_clocks_read(long long* dst) {
  const long long zeros[16] = {0};
  const cudaError_t err = cudaMemcpyFromSymbol(dst, cdfo_phase_clocks, sizeof(zeros));
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(cdfo_phase_clocks, zeros, sizeof(zeros));
}
#else
#define PHASE_START
#define PHASE(i)
#define PHASE_STEP
#define PHASE_END
#endif
