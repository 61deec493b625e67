// Shared definitions of the port's CUDA kernels.
//
// The library is compiled with -fmad=false (ops/cuda_lib.py): every float
// multiply and add below rounds on its own, exactly like the plain PyTorch
// versions and the JAX reference.  Constants are float32 hex literals, the
// exact float32 values the Python side rounds its decimal constants to.
#pragma once

#include <cuda_runtime.h>

// Shared memory one block can use on Hopper (227 KB), dynamic beyond 48 KB
#define DAFS_SMEM_MAX 232448

// ProbCons LOG_ZERO (-2e20) and LOG_UNDERFLOW (7.5) as float32
#define DAFS_LOG_ZERO (-0x1.5af1d8p+67f)
#define DAFS_LOG_UNDERFLOW (0x1.ep+2f)

// LOOKUP: log(exp(x)+1) for 0 <= x <= 7.5, 4-piece cubic
// (probconsRNA/ScoreType.h:187-198; ops/logspace.py LOOKUP_PIECES).  The
// piece's coefficients are chosen by selects, not branches: the lanes of a
// warp hold different pieces, and a branch would run them one after another.
// The polynomial of the chosen piece is evaluated exactly as before.
__device__ __forceinline__ float dafs_lookup(float x) {
  const bool p1 = x <= 1.0f, p2 = x <= 2.5f, p3 = x <= 4.5f;
  const float a = p1 ? -0x1.32687ap-7f : p2 ? -0x1.dc31f4p-7f : p3 ? -0x1.2dcb9cp-8f : -0x1.e0f10ap-12f;
  const float b = p1 ? 0x1.0b9738p-3f : p2 ? 0x1.1e9a14p-3f : p3 ? 0x1.03cc78p-4f : 0x1.3db77ep-7f;
  const float c = p1 ? 0x1.fec56p-2f : p2 ? 0x1.fb87ep-2f : p3 ? 0x1.645468p-1f : 0x1.dc8942p-1f;
  const float d = p1 ? 0x1.62eb84p-1f : p2 ? 0x1.62604p-1f : p3 ? 0x1.074ebep-1f : 0x1.5823dep-3f;
  return ((a * x + b) * x + c) * x + d;
}

// LOG_ADD (ScoreType.h:259-262) in the operand order of
// dafs_tpu/ops/pairhmm_pallas.py::_log_add_inline; `hi` is selected at the
// end, as ops/logspace.log_add does.  The reference's test `lo == LOG_ZERO`
// needs no instruction of its own: with lo = LOG_ZERO either d >= 7.5, or hi
// is LOG_ZERO too (float32 values are 2^44 apart there), and then
// LOOKUP(0) + LOG_ZERO rounds to LOG_ZERO, which is hi.
__device__ __forceinline__ float dafs_log_add(float x, float y) {
  const float hi = fmaxf(x, y);
  const float lo = fminf(x, y);
  const float d = hi - lo;
  const float approx = dafs_lookup(fminf(d, DAFS_LOG_UNDERFLOW)) + lo;
  return d >= DAFS_LOG_UNDERFLOW ? hi : approx;
}

// ProbCons EXP for x <= 0 (ScoreType.h:37-57; ops/logspace.py EXP_PIECES):
// the quartic of the piece with the largest lower bound below x, 0 at or
// below -16.  Comparisons as ops/logspace.probcons_exp writes them.
__device__ __forceinline__ float dafs_probcons_exp(float x) {
  const bool p0 = x > -0.5f, p1 = x > -1.0f, p2 = x > -2.0f, p3 = x > -4.0f, p4 = x > -8.0f;
  const float a = p0 ? 0x1.0a99e8p-5f : p1 ? 0x1.436754p-6f : p2 ? 0x1.34313ap-7f
                : p3 ? 0x1.1cbf9p-9f : p4 ? 0x1.040566p-13f : 0x1.15c944p-21f;
  const float b = p0 ? 0x1.4d6c5ap-3f : p1 ? 0x1.1b1514p-3f : p2 ? 0x1.81a30cp-4f
                : p3 ? 0x1.1d7a2cp-5f : p4 ? 0x1.c9a53ep-9f : 0x1.c895aep-16f;
  const float c = p0 ? 0x1.ff47ep-2f : p1 ? 0x1.ec19ap-2f : p2 ? 0x1.a20e5ep-2f
                : p3 ? 0x1.c4fb12p-3f : p4 ? 0x1.315ffcp-5f : 0x1.18113cp-11f;
  const float d = p0 ? 0x1.fff9a4p-1f : p1 ? 0x1.fc8dcep-1f : p2 ? 0x1.e0f0aep-1f
                : p3 ? 0x1.574b12p-1f : p4 ? 0x1.7020c2p-3f : 0x1.302764p-8f;
  const float e = p0 ? 0x1.ffffe8p-1f : p1 ? 0x1.ff85c8p-1f : p2 ? 0x1.f7a6e2p-1f
                : p3 ? 0x1.abcfc4p-1f : p4 ? 0x1.54790cp-2f : 0x1.edf5e6p-7f;
  const float poly = (((a * x + b) * x + c) * x + d) * x + e;
  return x > -16.0f ? poly : 0.0f;
}

static inline int dafs_round_up(int n, int m) { return (n + m - 1) / m * m; }
