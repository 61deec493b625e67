// MEA Nussinov decode with in-kernel traceback (K3).
//
// Replaces the Pallas TPU kernel dafs_tpu/ops/nussinov_pallas.py::_kernel
// (src/nussinov.cpp:207-298).  Semantics and tables as ops/nussinov.py:
// candidates down, left, pair, then the bifurcations; the first maximum
// wins, and among bifurcations the largest split k (the loop below visits k
// upward and replaces on >=, which picks the same k as the reference's
// downward scan with strictly-greater replacement).  Only max and add, so
// every value equals the plain version bit for bit.
//
// Design: one thread block per problem (the x and y problems of every merge
// of a DD layer go in one launch); one thread per cell of the current
// diagonal, diagonals in order with __syncthreads() between them, and only
// the cells inside the problem's true length are computed.  The dp, pair
// and code tables are diagonal-major in global memory (L * L each, 0.5 MB
// of floats at L = 352: more than a block's 227 KB of shared memory, so
// they stay L2-resident); in that layout the bifurcation loop of
// neighbouring threads reads neighbouring addresses.  Thread 0 then walks
// the traceback with a (2L+4, 2) stack in shared memory, as
// ops/nussinov.traceback does.
//
// What bounds it on an H100: the O(L^3 / 6) bifurcation sums, issued as
// L-1 sequential diagonals of dependent L2 loads, with one block (one SM)
// per problem.  Blocking diagonals, keeping hot rows in shared memory or a
// cluster-wide (DSMEM) table is later work.

#include "common.cuh"

namespace {

constexpr float kNeg = -0x1.c363ccp+127f;  // float32(-3e38)

__global__ void nussinov_kernel(const float* __restrict__ sm,
                                const int* __restrict__ lens,
                                float* dl_all, float* ml_all, int* code_all,
                                float* __restrict__ score,
                                int* __restrict__ ss_all, int L) {
  extern __shared__ int stack[];  // (2L + 4) x 2
  const int b = blockIdx.x;
  const size_t off = static_cast<size_t>(b) * L * L;
  const float* S = sm + off;
  float* DL = dl_all + off;  // DL[span * L + i] = dp(i, i + span)
  float* ML = ml_all + off;  // ML[span * L + i] = m(i, i + span)
  int* CODE = code_all + off;
  int* ss = ss_all + static_cast<size_t>(b) * L;
  const int l = min(lens[b], L);

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    DL[i] = 0.0f;
    ss[i] = -1;
  }
  __syncthreads();

  for (int ld = 1; ld < l; ++ld) {
    const int n = l - ld;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int j = i + ld;
      float t1 = kNeg, t2 = kNeg;
      if (ld >= 2) {
        t1 = DL[(ld - 1) * L + i + 1];  // dp(i+1, j)
        t2 = DL[(ld - 1) * L + i];      // dp(i, j-1)
      }
      const float s = S[static_cast<size_t>(i) * L + j];
      float m = kNeg;
      if (ld >= 3 && s > 0.0f) m = DL[(ld - 2) * L + i + 1] + s;
      float best = kNeg;
      int bo = 0;
      for (int o = 1; o <= ld - 3; ++o) {  // split k = i + o
        const float c = DL[(o - 1) * L + i] + ML[(ld - o) * L + i + o];
        if (c >= best) {
          best = c;
          bo = o;
        }
      }
      float v = t1;
      int code = 1;
      if (t2 > v) { v = t2; code = 2; }
      if (m > v) { v = m; code = 3; }
      if (ld >= 4 && best > v) { v = best; code = 3 + bo; }
      const bool has_any = v > kNeg;
      DL[ld * L + i] = has_any ? v : 0.0f;
      ML[ld * L + i] = m;
      CODE[ld * L + i] = has_any ? code : 0;
    }
    __syncthreads();
  }

  if (threadIdx.x != 0) return;
  score[b] = l >= 1 ? DL[(l - 1) * L] : 0.0f;
  int sp = 1;
  stack[0] = 0;
  stack[1] = l - 1;
  while (sp > 0) {
    --sp;
    const int i = stack[2 * sp], j = stack[2 * sp + 1];
    const int c = j > i ? CODE[(j - i) * L + i] : 0;
    if (c == 1) {
      stack[2 * sp] = i + 1; stack[2 * sp + 1] = j; ++sp;
    } else if (c == 2) {
      stack[2 * sp] = i; stack[2 * sp + 1] = j - 1; ++sp;
    } else if (c == 3) {
      ss[i] = j;
      stack[2 * sp] = i + 1; stack[2 * sp + 1] = j - 1; ++sp;
    } else if (c >= 4) {
      const int k = i + c - 3;
      ss[k] = j;
      stack[2 * sp] = i; stack[2 * sp + 1] = k - 1; ++sp;
      stack[2 * sp] = k + 1; stack[2 * sp + 1] = j - 1; ++sp;
    }
  }
}

}  // namespace

extern "C" int dafs_nussinov_decode(const float* sm, const int* lens,
                                    float* dl, float* ml, int* code,
                                    float* score, int* ss, int B, int L,
                                    cudaStream_t stream) {
  int threads = dafs_round_up(L, 32);
  if (threads > 1024) threads = 1024;
  const size_t smem = sizeof(int) * 2 * (2 * L + 4);
  nussinov_kernel<<<B, threads, smem, stream>>>(sm, lens, dl, ml, code, score,
                                                ss, L);
  return static_cast<int>(cudaGetLastError());
}
