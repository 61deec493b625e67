// ProbCons pair-HMM forward (K1) and backward (K2) passes.
//
// Replaces the Pallas TPU kernels dafs_tpu/ops/pairhmm_pallas.py::_fwd_kernel
// and ::_bwd_kernel.  Same recurrences cell for cell
// (probconsRNA/ProbabilisticModel.h:105-259): the expression order of
// pairhmm_pallas.py:169-188 (forward) and :299-305 (backward), LOG_ADD as
// _log_add_inline, no fused multiply-add (-fmad=false), so the values equal
// the plain PyTorch versions in ops/pairhmm.py bit for bit.
//
// Design: one thread block per sequence pair; the threads run over i along
// the anti-diagonal d = i + j; the M/X/Y values of the last three diagonals
// live in shared memory (9 * (l1max+1) floats, about 12 KB at l1max = 320)
// with __syncthreads() between diagonals.  Emissions come in-kernel from the
// base codes and the 7x7 / 7-entry tables, which are staged in shared
// memory.  The TPU version's diagonal blocking, emission shear and sublane
// rolls were shaped by VMEM and the lane layout and are not carried over.
//
// What bounds it on an H100: the l1max+l2max+1 sequential diagonal steps,
// each a barrier plus ~60 dependent float operations per thread, i.e.
// latency, not bandwidth (the output is one float per cell per pass).  45
// blocks (a 10-sequence family) fill 45 of the 132 SMs; packing several
// pairs per block or splitting a diagonal across a cluster is later work.

#include "common.cuh"

namespace {

constexpr int kTab = 49 + 7 + 9 + 3;  // match, ins, trans, init

struct Tables {
  float match[49];
  float ins[7];
  float trans[9];
  float init[3];
};

__device__ __forceinline__ int code_at(const int* c, int j, int jmax) {
  return (j >= 0 && j <= jmax) ? c[j] : 0;
}

__global__ void pairhmm_forward_kernel(
    const int* __restrict__ codes1, const int* __restrict__ len1,
    const int* __restrict__ codes2, const int* __restrict__ len2,
    const float* __restrict__ tab, float* __restrict__ fm,
    float* __restrict__ fcap, int imax, int l2max) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int W = l2max + 1;
  float* st = smem;                       // [3 diagonals][3 states][imax]
  int* c1 = reinterpret_cast<int*>(st + 9 * imax);
  int* c2 = c1 + imax;
  Tables* T = reinterpret_cast<Tables*>(c2 + W);
  for (int k = threadIdx.x; k < kTab; k += blockDim.x)
    reinterpret_cast<float*>(T)[k] = tab[k];
  for (int k = threadIdx.x; k < imax; k += blockDim.x) c1[k] = codes1[b * imax + k];
  for (int k = threadIdx.x; k < W; k += blockDim.x) c2[k] = codes2[b * W + k];
  for (int k = threadIdx.x; k < 9 * imax; k += blockDim.x) st[k] = DAFS_LOG_ZERO;
  __syncthreads();

  const int n1 = len1[b], n2 = len2[b];
  const float t00 = T->trans[0], t01 = T->trans[1], t02 = T->trans[2];
  const float t10 = T->trans[3], t11 = T->trans[4];
  const float t20 = T->trans[6], t22 = T->trans[8];
  const float LZ = DAFS_LOG_ZERO;
  const int ndiag = imax + l2max;
  float* out = fm + static_cast<size_t>(b) * imax * W;

  for (int d = 0; d < ndiag; ++d) {
    float* cur = st + 3 * imax * (d % 3);
    const float* p1 = st + 3 * imax * ((d + 2) % 3);  // diagonal d-1
    const float* p2 = st + 3 * imax * ((d + 1) % 3);  // diagonal d-2
    for (int i = threadIdx.x; i < imax; i += blockDim.x) {
      const int j = d - i;
      const int cj = code_at(c2, j, l2max);
      const float m_d = T->match[c1[i] * 7 + cj];
      const float e2_d = T->ins[cj];
      const float ins1 = T->ins[c1[i]];
      const bool valid = i <= n1 && j >= 0 && j <= n2;
      const bool not_init = i > 1 || j > 1;

      const float m_in = i > 0 ? p2[i - 1] : LZ;
      const float x_in = i > 0 ? p2[imax + i - 1] : LZ;
      const float y_in = i > 0 ? p2[2 * imax + i - 1] : LZ;
      float acc = m_in + t00;
      acc = dafs_log_add(acc, x_in + t10);
      acc = dafs_log_add(acc, y_in + t20);
      float m_new = acc + m_d;
      m_new = (valid && not_init && i > 0 && j > 0) ? m_new : LZ;

      const float pm = i > 0 ? p1[i - 1] : LZ;
      const float px = i > 0 ? p1[imax + i - 1] : LZ;
      float x_new = ins1 + dafs_log_add(pm + t01, px + t11);
      x_new = (valid && not_init && i > 0) ? x_new : LZ;

      float y_new = e2_d + dafs_log_add(p1[i] + t02, p1[2 * imax + i] + t22);
      y_new = (valid && not_init && j > 0) ? y_new : LZ;

      // init cells (ProbabilisticModel.h:122-131)
      if (i == 1 && j == 1) m_new = T->init[0] + m_d;
      if (i == 1 && j == 0 && 1 <= n1) x_new = T->init[1] + ins1;
      if (i == 0 && j == 1 && 1 <= n2) y_new = T->init[2] + e2_d;
      if (!(valid && i > 0 && j > 0)) m_new = LZ;

      cur[i] = m_new;
      cur[imax + i] = x_new;
      cur[2 * imax + i] = y_new;
      if (j >= 0 && j < W) out[static_cast<size_t>(i) * W + j] = m_new;
      // captures for ComputeTotalProbability
      if (i == n1 && j == n2) {
        fcap[b * 6 + 0] = m_new;
        fcap[b * 6 + 1] = x_new;
        fcap[b * 6 + 2] = y_new;
      }
      if (i == 1 && j == 1) fcap[b * 6 + 3] = m_new;
      if (i == 1 && j == 0) fcap[b * 6 + 4] = x_new;
      if (i == 0 && j == 1) fcap[b * 6 + 5] = y_new;
    }
    __syncthreads();
  }
}

__global__ void pairhmm_backward_kernel(
    const int* __restrict__ codes1, const int* __restrict__ len1,
    const int* __restrict__ codes2, const int* __restrict__ len2,
    const float* __restrict__ tab, float* __restrict__ bm,
    float* __restrict__ bcap, int imax, int l2max) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int W = l2max + 1;
  float* st = smem;  // [3 diagonals][3 states][imax]
  int* c1 = reinterpret_cast<int*>(st + 9 * imax);
  int* c2 = c1 + imax;
  Tables* T = reinterpret_cast<Tables*>(c2 + W);
  for (int k = threadIdx.x; k < kTab; k += blockDim.x)
    reinterpret_cast<float*>(T)[k] = tab[k];
  for (int k = threadIdx.x; k < imax; k += blockDim.x) c1[k] = codes1[b * imax + k];
  for (int k = threadIdx.x; k < W; k += blockDim.x) c2[k] = codes2[b * W + k];
  for (int k = threadIdx.x; k < 9 * imax; k += blockDim.x) st[k] = DAFS_LOG_ZERO;
  __syncthreads();

  const int n1 = len1[b], n2 = len2[b];
  const float LZ = DAFS_LOG_ZERO;
  const float* tr = T->trans;
  const int ndiag = imax + l2max;
  float* out = bm + static_cast<size_t>(b) * imax * W;

  for (int d = ndiag - 1; d >= 0; --d) {
    float* cur = st + 3 * imax * (d % 3);
    const float* n1d = st + 3 * imax * ((d + 1) % 3);  // diagonal d+1
    const float* n2d = st + 3 * imax * ((d + 2) % 3);  // diagonal d+2
    for (int i = threadIdx.x; i < imax; i += blockDim.x) {
      const int j = d - i;
      const bool valid = i <= n1 && j >= 0 && j <= n2;
      // match(c1[i+1], c2[j+1]); 0 past the last lane, like the lane shift
      const float match_n =
          i + 1 < imax ? T->match[c1[i + 1] * 7 + code_at(c2, j + 1, l2max)] : 0.0f;
      const float ins1_n = i + 1 < imax ? T->ins[c1[i + 1]] : 0.0f;
      const float ins2_n = T->ins[code_at(c2, j + 1, l2max)];
      const bool has_m = i < n1 && j < n2 && valid;
      const bool has_x = i < n1 && valid;
      const bool has_y = j < n2 && valid;

      const float bm_11 = i + 1 < imax ? n2d[i + 1] : LZ;
      const float bx_n = i + 1 < imax ? n1d[imax + i + 1] : LZ;
      const float by_n = n1d[2 * imax + i];
      const float prob_xy = bm_11 + match_n;

      // order matches ProbabilisticModel.h:233-249
      float bM = LZ, bX = LZ, bY = LZ;
      if (has_m) {
        bM = dafs_log_add(bM, prob_xy + tr[0]);
        bX = dafs_log_add(bX, prob_xy + tr[3]);
        bY = dafs_log_add(bY, prob_xy + tr[6]);
      }
      if (has_x) {
        bM = dafs_log_add(bM, bx_n + ins1_n + tr[1]);
        bX = dafs_log_add(bX, bx_n + ins1_n + tr[4]);
      }
      if (has_y) {
        bM = dafs_log_add(bM, by_n + ins2_n + tr[2]);
        bY = dafs_log_add(bY, by_n + ins2_n + tr[8]);
      }
      if (i == n1 && j == n2) {
        bM = T->init[0];
        bX = T->init[1];
        bY = T->init[2];
      }
      if (!valid) bM = bX = bY = LZ;

      cur[i] = bM;
      cur[imax + i] = bX;
      cur[2 * imax + i] = bY;
      if (j >= 0 && j < W) out[static_cast<size_t>(i) * W + j] = bM;
      if (i == 1 && j == 1) bcap[b * 3 + 0] = bM;
      if (i == 1 && j == 0) bcap[b * 3 + 1] = bX;
      if (i == 0 && j == 1) bcap[b * 3 + 2] = bY;
    }
    __syncthreads();
  }
}

size_t smem_bytes(int imax, int l2max) {
  return sizeof(float) * (9 * imax + kTab) + sizeof(int) * (imax + l2max + 1);
}

int threads_for(int imax) {
  int t = dafs_round_up(imax, 32);
  return t > 1024 ? 1024 : t;
}

}  // namespace

extern "C" int dafs_pairhmm_forward(const int* codes1, const int* len1,
                                    const int* codes2, const int* len2,
                                    const float* tab, float* fm, float* fcap,
                                    int B, int imax, int l2max,
                                    cudaStream_t stream) {
  pairhmm_forward_kernel<<<B, threads_for(imax), smem_bytes(imax, l2max), stream>>>(
      codes1, len1, codes2, len2, tab, fm, fcap, imax, l2max);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafs_pairhmm_backward(const int* codes1, const int* len1,
                                     const int* codes2, const int* len2,
                                     const float* tab, float* bm, float* bcap,
                                     int B, int imax, int l2max,
                                     cudaStream_t stream) {
  pairhmm_backward_kernel<<<B, threads_for(imax), smem_bytes(imax, l2max), stream>>>(
      codes1, len1, codes2, len2, tab, bm, bcap, imax, l2max);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dafs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
