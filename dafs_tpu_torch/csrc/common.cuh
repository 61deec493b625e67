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
// (probconsRNA/ScoreType.h:187-198; ops/logspace.py LOOKUP_PIECES)
__device__ __forceinline__ float dafs_lookup(float x) {
  float a, b, c, d;
  if (x <= 1.0f) {
    a = -0x1.32687ap-7f; b = 0x1.0b9738p-3f; c = 0x1.fec56p-2f; d = 0x1.62eb84p-1f;
  } else if (x <= 2.5f) {
    a = -0x1.dc31f4p-7f; b = 0x1.1e9a14p-3f; c = 0x1.fb87ep-2f; d = 0x1.62604p-1f;
  } else if (x <= 4.5f) {
    a = -0x1.2dcb9cp-8f; b = 0x1.03cc78p-4f; c = 0x1.645468p-1f; d = 0x1.074ebep-1f;
  } else {
    a = -0x1.e0f10ap-12f; b = 0x1.3db77ep-7f; c = 0x1.dc8942p-1f; d = 0x1.5823dep-3f;
  }
  return ((a * x + b) * x + c) * x + d;
}

// LOG_ADD (ScoreType.h:259-262) in the operand order of
// dafs_tpu/ops/pairhmm_pallas.py::_log_add_inline
__device__ __forceinline__ float dafs_log_add(float x, float y) {
  float hi = fmaxf(x, y);
  float lo = fminf(x, y);
  float d = hi - lo;
  if (lo == DAFS_LOG_ZERO || d >= DAFS_LOG_UNDERFLOW) return hi;
  return dafs_lookup(fminf(d, DAFS_LOG_UNDERFLOW)) + lo;
}

static inline int dafs_round_up(int n, int m) { return (n + m - 1) / m * m; }
