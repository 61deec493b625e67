// Banded MEA Needleman-Wunsch decode with in-kernel traceback (K4).
//
// Replaces the Pallas TPU kernel dafs_tpu/ops/nw_pallas.py::_kernel
// (src/needleman_wunsch.cpp:255-422).  Semantics as ops/nw.py: within the
// row envelope, 'M' wins against 'X' when equal, and 'Y' (the running
// maximum along the row) only when strictly greater.  Only max and add, so
// every value equals the plain version bit for bit; max is exact, so the
// order of the prefix-max scan does not matter.
//
// Design: one thread block per problem (the merges of a DD layer go in one
// launch); one thread per column k in [0, L2].  For each row up to the true
// length l1: form the M and X candidates from the previous row (shared
// memory), take a block-wide inclusive prefix max (warp shuffles, then one
// warp over the warp totals) for the Y term, store the row's codes in
// global memory.  Thread 0 then follows the codes back from (l1, l2), as
// ops/nw.traceback does.
//
// What bounds it on an H100: l1 sequential rows, each with three barriers
// and a two-level scan; about L1 * L2 bytes of codes are written.  One block
// per merge leaves most SMs idle; several problems per block or a
// wavefront over anti-diagonals is later work.

#include "common.cuh"

namespace {

constexpr float kLowest = -0x1.fffffep+127f;  // float32 min
constexpr unsigned kFull = 0xffffffffu;

__device__ float block_inclusive_max(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = fmaxf(v, n);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? warp_tot[lane] : kLowest;
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = fmaxf(w, n);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = fmaxf(v, warp_tot[warp - 1]);
  return v;
}

__global__ void nw_kernel(const float* __restrict__ sm,
                          const int* __restrict__ env_first,
                          const int* __restrict__ env_last,
                          const int* __restrict__ l1s,
                          const int* __restrict__ l2s,
                          unsigned char* __restrict__ tr_all,
                          float* __restrict__ score, int* __restrict__ al_all,
                          int L1, int L2) {
  extern __shared__ float sh[];
  const int W = L2 + 1;
  float* dp_prev = sh;       // [W]
  float* run = sh + W;       // [W]
  float* warp_tot = run + W; // [32]
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int l1 = min(l1s[b], L1), l2 = min(l2s[b], L2);
  const float* S = sm + static_cast<size_t>(b) * L1 * L2;
  const int* ef = env_first + static_cast<size_t>(b) * (L1 + 1);
  const int* el = env_last + static_cast<size_t>(b) * (L1 + 1);
  unsigned char* tr = tr_all + static_cast<size_t>(b) * (L1 + 1) * W;
  int* al = al_all + static_cast<size_t>(b) * L1;

  // row 0: dp = 0, code 'Y' for k > 0
  if (k < W) {
    dp_prev[k] = 0.0f;
    tr[k] = k > 0 ? 3 : 0;
  }
  for (int i = k; i < L1; i += blockDim.x) al[i] = -1;
  __syncthreads();

  for (int i = 1; i <= l1; ++i) {
    const int start = max(ef[i], 1);
    const int last = el[i];
    bool in_band = false;
    float bv = 0.0f, c = kLowest;
    int bcode = 2;
    if (k < W) {
      in_band = k >= start && k <= last;
      if (k == 0) {
        c = start == 1 ? 0.0f : kLowest;
      } else {
        const float m = dp_prev[k - 1] + S[static_cast<size_t>(i - 1) * L2 + k - 1];
        const float x = dp_prev[k];
        if (m >= x) {
          bv = m;
          bcode = 1;
        } else {
          bv = x;
        }
        c = in_band ? bv : kLowest;
      }
    }
    const float r = block_inclusive_max(c, warp_tot);
    if (k < W) run[k] = r;
    __syncthreads();
    float dpv = 0.0f;
    if (k < W) {
      const float left = k > 0 ? run[k - 1] : kLowest;
      int code = left > bv ? 3 : bcode;
      dpv = in_band ? fmaxf(bv, left) : kLowest;
      code = in_band ? code : 0;
      if (k == 0) {
        dpv = 0.0f;
        code = 2;
      }
      tr[static_cast<size_t>(i) * W + k] = static_cast<unsigned char>(code);
    }
    __syncthreads();
    if (k < W) dp_prev[k] = dpv;
    __syncthreads();
  }

  if (k != 0) return;
  score[b] = dp_prev[l2];
  int i = l1, kk = l2;
  while (i > 0 || kk > 0) {
    const int code = tr[static_cast<size_t>(i) * W + kk];
    if (code == 1) {
      al[i - 1] = kk - 1;
      --i;
      --kk;
    } else if (code == 2) {
      al[i - 1] = -1;
      --i;
    } else {
      --kk;
    }
  }
}

}  // namespace

extern "C" int dafs_nw_decode(const float* sm, const int* env_first,
                              const int* env_last, const int* l1,
                              const int* l2, unsigned char* tr, float* score,
                              int* al, int B, int L1, int L2,
                              cudaStream_t stream) {
  const int threads = dafs_round_up(L2 + 1, 32);
  const size_t smem = sizeof(float) * (2 * (L2 + 1) + 32);
  nw_kernel<<<B, threads, smem, stream>>>(sm, env_first, env_last, l1, l2, tr,
                                          score, al, L1, L2);
  return static_cast<int>(cudaGetLastError());
}
