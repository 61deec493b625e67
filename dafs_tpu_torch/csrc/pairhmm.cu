// ProbCons pair-HMM forward (K1) and backward (K2) passes and the match
// posteriors, designed for Hopper.
//
// Replaces the Pallas TPU kernels dafs_tpu/ops/pairhmm_pallas.py::_fwd_kernel
// and ::_bwd_kernel, and the posterior step that XLA fused behind them
// (pairhmm_pallas.py:484-508).  Same recurrences cell for cell
// (probconsRNA/ProbabilisticModel.h:105-259): the expression order of
// pairhmm_pallas.py:169-188 (forward) and :299-305 (backward), LOG_ADD as
// _log_add_inline, no fused multiply-add (-fmad=false), so the values equal
// the plain PyTorch versions in ops/pairhmm.py bit for bit.
//
// What bounds it on an H100.  Not bytes and not operations (the roofline
// bound is a fiftieth of any time measured) but the chain of
// len1 + len2 + 1 anti-diagonals, each waiting for the one before: per
// diagonal two dependent LOG_ADDs and the hand-over between neighbouring
// rows.  dafs_pairhmm_floor_probe runs that chain alone; chip_smoke.py
// prints its time beside the kernels'.  On an NVIDIA H100 80GB HBM3 at
// 700 W, B = 45: 0.028 ms for the 157 diagonals of L <= 96 and 0.130 ms for
// the 606 of L <= 320; the passes take about twice that (0.05-0.06 and
// 0.25 ms), the first version took 0.13-0.15 and 0.50-0.60 ms.  Beyond the
// chain a pass is bound by instruction issue: a cell is some 250
// instructions, the 321 rows of L <= 320 are 11 warps on the four
// schedulers of one SM.
//
// The design, one thread block per sequence pair and pass:
//
// - A lane owns one row i and walks the anti-diagonals d = i + j.  Its M/X/Y
//   of the last diagonal and the row above's of the last two stay in
//   registers, with the row's own code and insert score.  The emission of a
//   cell is the code c2[j], read one diagonal ahead, and one table read in
//   shared memory that is issued at the top of the step, off the chain.
//   Several rows a lane (so that one warp carries a short pair without any
//   hand-over) were built and measured 1.3 (two rows) and 1.9 to 2.5 times
//   (four) slower at B = 45 for L <= 96 and L <= 320 and at B = 1225: a
//   cell is some 250 instructions, so a pass is bound by instruction issue
//   once the chain is short, and more warps (four schedulers an SM) beat
//   more independent chains a lane.
// - The neighbouring row of another lane (i-1 forward, i+1 backward) comes by
//   __shfl_up_sync / __shfl_down_sync: three values a step forward, two
//   backward.  LOG_ADD and LOOKUP choose by selects (common.cuh), so the
//   lanes of a warp never serialise.
// - Warps walk the diagonals in step, a block barrier between two diagonals.
//   A warp holds 32 rows and needs from outside only the edge row of the
//   warp before it (after it, backward): that warp's edge lane leaves the
//   row's values of diagonal d in one of two 16-byte slots in shared memory,
//   and lane 0 (31) of the next warp picks them up after the barrier.  In
//   the chain alone the barrier is cheap up to four warps (0.028 ms against
//   0.026 ms with one warp and none) and doubles it at eleven (0.130 against
//   0.067 ms); in the kernel, leaving it out saves a third at L <= 320
//   (decoder_variants.py, `no barrier`), because every diagonal then takes
//   as long as its slowest warp.  Skewed warps that wait for each other's
//   slots by polling a tag in shared memory were tried and dropped: the
//   chain alone was slower with them than with the barrier at every warp
//   count, several times slower with volatile or relaxed accesses.
// - Only live work: the loop runs over the len1 + len2 + 1 diagonals of the
//   pair, a warp computes on those that cross its rows within len1 x len2,
//   and warps beyond len1 leave before the loop (the barrier counts the
//   others only).  Cells outside the true lengths are filled with LOG_ZERO
//   by a pass with coalesced rows before the loop, as the plain versions
//   hold them; the posterior kernel reads inside the lengths only.
// - The posterior kernel forms the totals from the captures and writes
//   probcons_exp(min(0, fm + bm - total)), masked to the true lengths,
//   coalesced along j.  ops/pairhmm_cuda.py launches the two passes on two
//   streams, so that they run side by side, and this kernel behind both.
//
// decoder_variants.py times this design against copies with one part left
// out or changed.
//
// Long variant (dafs_pairhmm_{forward,backward}_long, for imax above 1024
// up to the ceiling of 4096 in ops/pairhmm_cuda.py).  A block of 1024
// threads walks the rows in strips of 1024, one strip after another (the
// first strip first forward, the last first backward), each strip as the
// design above: a row a lane, shuffles and slots between warps, a barrier
// per diagonal.  Between strips the edge row goes through global memory:
// the strip's last row forward (first row backward) leaves its values of
// every column in a buffer of W float4, and the next strip's first lane
// (last lane) reads them there.  Slower than one strip, since the strips'
// diagonals do not overlap, and the same operations cell for cell.  The
// posterior kernel has no row limit and serves both.

#include "common.cuh"

namespace {

constexpr int kTab = 49 + 7 + 9 + 3;  // match, ins, trans, init
constexpr unsigned kFull = 0xffffffffu;
constexpr float LZ = DAFS_LOG_ZERO;

struct Tables {
  float match[49];
  float ins[7];
  float trans[9];
  float init[3];
};

// What one pass keeps in shared memory: two hand-over slots per warp (the
// edge row's values of the last two diagonals), the tables, codes2.
struct Shared {
  float4* edge;
  Tables* T;
  int* c2;
};

__host__ __device__ inline size_t shared_bytes(int nwarps, int W) {
  return sizeof(float4) * 2 * nwarps + sizeof(float) * kTab + sizeof(int) * W;
}

__device__ __forceinline__ Shared carve(float4* smem, int nwarps) {
  Shared s;
  s.edge = smem;
  s.T = reinterpret_cast<Tables*>(smem + 2 * nwarps);
  s.c2 = reinterpret_cast<int*>(reinterpret_cast<float*>(s.T) + kTab);
  return s;
}

// The barrier between two diagonals, for the warps with rows within len1.
__device__ __forceinline__ void diagonal_barrier(int nlive) {
  if (nlive > 1) asm volatile("bar.sync 1, %0;\n" :: "r"(32 * nlive) : "memory");
}

__device__ __forceinline__ int code_at(const int* c, int j, int jmax) {
  return (j >= 0 && j <= jmax) ? c[j] : 0;
}

// The four tables as the wrapper hands them over, each a device pointer.
struct TablePtrs {
  const float* match;  // 7 x 7
  const float* ins;    // 7
  const float* trans;  // 3 x 3
  const float* init;   // 3
};

// Stages the tables and codes2; leaves the barrier to the caller.
__device__ __forceinline__ void stage(const Shared& s, const TablePtrs& tab,
                                      const int* codes2, int W) {
  for (int k = threadIdx.x; k < kTab; k += blockDim.x) {
    const float v = k < 49 ? tab.match[k] : k < 56 ? tab.ins[k - 49]
                  : k < 65 ? tab.trans[k - 56] : tab.init[k - 65];
    reinterpret_cast<float*>(s.T)[k] = v;
  }
  for (int k = threadIdx.x; k < W; k += blockDim.x) s.c2[k] = codes2[k];
}

// LOG_ZERO into every cell of the plane outside (0..n1) x (0..n2): a warp a
// row, the lanes along j.
__device__ __forceinline__ void fill_dead(float* out, int n1, int n2, int imax, int W) {
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = w; i < imax; i += nw) {
    float* row = out + i * W;
    for (int j = (i <= n1 ? n2 + 1 : 0) + lane; j < W; j += 32) row[j] = LZ;
  }
}

// The transition and init scores, which a pass keeps in registers.
struct Trans {
  float t00, t01, t02, t10, t11, t20, t22, init0, init1, init2;
};

__device__ __forceinline__ Trans load_trans(const Tables* T) {
  return Trans{T->trans[0], T->trans[1], T->trans[2], T->trans[3], T->trans[4],
               T->trans[6], T->trans[8], T->init[0],  T->init[1],  T->init[2]};
}

// One forward cell (i, j), j = d - i: this row's (M1, X1, Y1) of diagonal
// d - 1 become those of d.  (uM, uX): the row above on d - 1; (nM2, nX2,
// nY2): the row above on d - 2; m_d, e2, ins1: the cell's emissions.  In
// `first_rows` (the warp of rows 0 to 31 in the first strip) rows 0 and 1
// hold the init cells (ProbabilisticModel.h:122-131) and the three captures
// f_M(1,1), f_X(1,0), f_Y(0,1).  Returns whether (i, j) lies within the
// lengths.  Both forward passes run this, so their arithmetic is one.
__device__ __forceinline__ bool forward_cell(
    const Trans& t, bool first_rows, int i, int j, int n1, int n2, float m_d, float e2,
    float ins1, float uM, float uX, float nM2, float nX2, float nY2, float& M1, float& X1,
    float& Y1, float& c11, float& cx10, float& cy01) {
  const bool valid = i <= n1 && static_cast<unsigned>(j) <= static_cast<unsigned>(n2);
  float acc = nM2 + t.t00;
  acc = dafs_log_add(acc, nX2 + t.t10);
  acc = dafs_log_add(acc, nY2 + t.t20);
  float m_new = acc + m_d;
  float x_new = ins1 + dafs_log_add(uM + t.t01, uX + t.t11);
  float y_new = e2 + dafs_log_add(M1 + t.t02, Y1 + t.t22);
  if (first_rows) {
    const bool not_init = i > 1 || j > 1;
    m_new = (valid && not_init && i > 0 && j > 0) ? m_new : LZ;
    x_new = (valid && not_init && i > 0) ? x_new : LZ;
    y_new = (valid && not_init && j > 0) ? y_new : LZ;
    if (i == 1 && j == 1) m_new = t.init0 + m_d;
    if (i == 1 && j == 0 && 1 <= n1) x_new = t.init1 + ins1;
    if (i == 0 && j == 1 && 1 <= n2) y_new = t.init2 + e2;
    if (!(valid && i > 0 && j > 0)) m_new = LZ;
    if (i == 1 && j == 1) c11 = m_new;
    if (i == 1 && j == 0) cx10 = x_new;
    if (i == 0 && j == 1) cy01 = y_new;
  } else {
    // rows from 32 on: M and Y live for 1 <= j <= len2, X for 0 <= j
    const bool inner = i <= n1 && static_cast<unsigned>(j - 1) < static_cast<unsigned>(n2);
    m_new = inner ? m_new : LZ;
    x_new = valid ? x_new : LZ;
    y_new = inner ? y_new : LZ;
  }
  M1 = m_new;
  X1 = x_new;
  Y1 = y_new;
  return valid;
}

// One backward cell (i, j), j = d - i: this row's (M1, X1, Y1) of diagonal
// d + 1 become those of d.  dX: the row below on d + 1; nM2: the row below
// on d + 2; match_n, ins1n, ins2_n: the emissions of (i + 1, j + 1).
// Returns whether (i, j) lies within the lengths.  Both backward passes run
// this.
__device__ __forceinline__ bool backward_cell(
    const Trans& t, int i, int j, int n1, int n2, float match_n, float ins1n, float ins2_n,
    float dX, float nM2, float& M1, float& X1, float& Y1) {
  const bool valid = i <= n1 && static_cast<unsigned>(j) <= static_cast<unsigned>(n2);
  const bool has_y = i <= n1 && static_cast<unsigned>(j) < static_cast<unsigned>(n2);
  const bool has_x = i < n1 && valid;
  const bool has_m = i < n1 && has_y;
  const float prob_xy = nM2 + match_n;

  // order matches ProbabilisticModel.h:233-249.  LOG_ADD of LOG_ZERO
  // and v is the larger of the two, exactly: v >= LOG_ZERO makes
  // LOG_ZERO the smaller operand, which returns v; below LOG_ZERO the
  // two differ by more than LOG_UNDERFLOW (float32 spacing at 2e20),
  // which returns LOG_ZERO.
  float bM = LZ, bX = LZ, bY = LZ;
  if (has_m) {
    bM = fmaxf(LZ, prob_xy + t.t00);
    bX = fmaxf(LZ, prob_xy + t.t10);
    bY = fmaxf(LZ, prob_xy + t.t20);
  }
  const float via_x = dX + ins1n;
  const float mx = dafs_log_add(bM, via_x + t.t01);
  const float xx = dafs_log_add(bX, via_x + t.t11);
  if (has_x) {
    bM = mx;
    bX = xx;
  }
  const float via_y = Y1 + ins2_n;
  const float my = dafs_log_add(bM, via_y + t.t02);
  const float yy = dafs_log_add(bY, via_y + t.t22);
  if (has_y) {
    bM = my;
    bY = yy;
  }
  if (i == n1 && j == n2) {
    bM = t.init0;
    bX = t.init1;
    bY = t.init2;
  }
  // outside the lengths nothing was added: bM, bX and bY are LOG_ZERO
  M1 = bM;
  X1 = bX;
  Y1 = bY;
  return valid;
}

// ------------------------------------------------------------- forward --

__device__ __forceinline__ void forward_pass(
    const int* __restrict__ codes1, const int* __restrict__ codes2,
    const TablePtrs& tab, float* __restrict__ out,
    float* __restrict__ cap, int n1, int n2, int imax, int l2max, float4* smem) {
  const int W = l2max + 1;
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Shared s = carve(smem, nw);
  stage(s, tab, codes2, W);
  fill_dead(out, n1, n2, imax, W);
  __syncthreads();

  const int rb = 32 * w, rl = rb + 31;  // the warp's first and last row
  if (rb > n1) return;
  const int nlive = min(nw, n1 / 32 + 1);  // warps that stay
  const Tables* T = s.T;
  const int* c2 = s.c2;
  const Trans t = load_trans(T);
  const int i = rb + lane;            // this lane's row
  const bool next_live = rl < n1;     // the next warp has rows within len1
  const int de = min(rl, n1) + n2;    // last diagonal crossing these rows

  const int c1 = i < imax ? codes1[i] : 0;
  const int c17 = 7 * c1;
  const float ins1 = T->ins[c1];
  int cj = code_at(c2, rb - i, l2max);    // code of column j = d - i
  float M1 = LZ, X1 = LZ, Y1 = LZ;        // this row, diagonal d-1
  float nM2 = LZ, nX2 = LZ, nY2 = LZ;     // the row above, diagonal d-2
  float c11 = LZ, cx10 = LZ, cy01 = LZ;   // captures f_M(1,1), f_X(1,0), f_Y(0,1)

  for (int d = 0; d <= n1 + n2; ++d) {
    if (d < rb || d > de) {  // no cell of this warp's rows on d
      diagonal_barrier(nlive);
      continue;
    }
    const float m_d = T->match[c17 + cj];
    const float e2 = T->ins[cj];
    const int c_next = code_at(c2, d + 1 - i, l2max);

    // the row above: the lane before, or the warp before through its slot
    float4 edge = make_float4(LZ, LZ, LZ, 0.0f);
    if (lane == 0 && w > 0 && d <= rb + n2)  // row rb - 1 has a cell on d - 1
      edge = s.edge[2 * (w - 1) + ((d - 1) & 1)];
    float uM = __shfl_up_sync(kFull, M1, 1);
    float uX = __shfl_up_sync(kFull, X1, 1);
    float uY = __shfl_up_sync(kFull, Y1, 1);
    if (lane == 0) {
      uM = edge.x;
      uX = edge.y;
      uY = edge.z;
    }

    const int j = d - i;
    if (forward_cell(t, w == 0, i, j, n1, n2, m_d, e2, ins1, uM, uX, nM2, nX2, nY2, M1, X1,
                     Y1, c11, cx10, cy01))
      out[i * W + j] = M1;
    nM2 = uM;
    nX2 = uX;
    nY2 = uY;
    cj = c_next;

    if (lane == 31 && next_live && d >= rl)  // row rl has a cell on d
      s.edge[2 * w + (d & 1)] = make_float4(M1, X1, Y1, 0.0f);
    diagonal_barrier(nlive);
  }

  // captures for ComputeTotalProbability: the loop's last diagonal holds
  // (len1, len2) for the lane that owns row len1
  if (i == n1) {
    cap[0] = M1;
    cap[1] = X1;
    cap[2] = Y1;
  }
  if (w == 0) {
    if (lane == 1) {
      cap[3] = c11;
      cap[4] = cx10;
    }
    if (lane == 0) cap[5] = cy01;
  }
}

// ------------------------------------------------------------ backward --

__device__ __forceinline__ void backward_pass(
    const int* __restrict__ codes1, const int* __restrict__ codes2,
    const TablePtrs& tab, float* __restrict__ out,
    float* __restrict__ cap, int n1, int n2, int imax, int l2max, float4* smem) {
  const int W = l2max + 1;
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Shared s = carve(smem, nw);
  stage(s, tab, codes2, W);
  fill_dead(out, n1, n2, imax, W);
  __syncthreads();

  const int rb = 32 * w, rl = rb + 31;
  if (rb > n1) return;
  const int nlive = min(nw, n1 / 32 + 1);  // warps that stay
  const Tables* T = s.T;
  const int* c2 = s.c2;
  const Trans t = load_trans(T);
  const int i = rb + lane;          // this lane's row
  const bool next_live = rl < n1;   // the warp after this one has live rows
  const int de = min(rl, n1) + n2;

  // of row i+1: whether it exists, 7 * code, insert score
  const bool has_next = i + 1 < imax;
  const int c1n = has_next ? codes1[i + 1] : 0;
  const int c17n = 7 * c1n;
  const float ins1n = has_next ? T->ins[c1n] : 0.0f;
  int cjn = code_at(c2, de - i + 1, l2max);  // code of column j + 1
  float M1 = LZ, X1 = LZ, Y1 = LZ;         // this row, diagonal d+1
  float nM2 = LZ;                          // the row below, diagonal d+2
  float c11 = LZ, cx10 = LZ, cy01 = LZ;    // captures b_M(1,1), b_X(1,0), b_Y(0,1)

  for (int d = n1 + n2; d >= 0; --d) {
    if (d < rb || d > de) {
      diagonal_barrier(nlive);
      continue;
    }
    // match(c1[i+1], c2[j+1]); 0 past the last row, like the lane shift
    const float match_n = has_next ? T->match[c17n + cjn] : 0.0f;
    const float ins2_n = T->ins[cjn];
    const int c_next = code_at(c2, d - i, l2max);

    // the row below: the lane after, or the warp after through its slot;
    // row rl + 1 has a cell on d + 1 from d = rl on (and up to d = de)
    float4 edge = make_float4(LZ, LZ, 0.0f, 0.0f);
    if (lane == 31 && next_live && d >= rl) edge = s.edge[2 * (w + 1) + ((d + 1) & 1)];
    float dM = __shfl_down_sync(kFull, M1, 1);
    float dX = __shfl_down_sync(kFull, X1, 1);
    if (lane == 31) {
      dM = edge.x;
      dX = edge.y;
    }

    const int j = d - i;
    if (backward_cell(t, i, j, n1, n2, match_n, ins1n, ins2_n, dX, nM2, M1, X1, Y1))
      out[i * W + j] = M1;
    if (w == 0) {
      if (i == 1 && j == 1) c11 = M1;
      if (i == 1 && j == 0) cx10 = X1;
      if (i == 0 && j == 1) cy01 = Y1;
    }
    nM2 = dM;
    cjn = c_next;

    if (lane == 0 && w > 0 && d <= rb + n2)  // row rb has a cell on d
      s.edge[2 * w + (d & 1)] = make_float4(M1, X1, 0.0f, 0.0f);
    diagonal_barrier(nlive);
  }

  if (w == 0) {
    if (lane == 1) {
      cap[0] = c11;
      cap[1] = cx10;
    }
    if (lane == 0) cap[2] = cy01;
  }
}

// ------------------------------------------------- long variant passes --

// forward_pass for imax above 1024, in strips of blockDim.x rows.  E: two
// rows of W float4; strip s leaves (M, X, Y) of its last row in E[s & 1].
__device__ __forceinline__ void forward_pass_long(
    const int* __restrict__ codes1, const int* __restrict__ codes2,
    const TablePtrs& tab, float* __restrict__ out, float* __restrict__ cap,
    float4* E, int n1, int n2, int imax, int l2max, float4* smem) {
  const int W = l2max + 1;
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = blockDim.x;
  const Shared s = carve(smem, nw);
  stage(s, tab, codes2, W);
  fill_dead(out, n1, n2, imax, W);
  __syncthreads();

  const Tables* T = s.T;
  const int* c2 = s.c2;
  const Trans t = load_trans(T);
  float c11 = LZ, cx10 = LZ, cy01 = LZ;   // captures f_M(1,1), f_X(1,0), f_Y(0,1)

  for (int row0 = 0; row0 <= n1; row0 += R) {
    const int strip = row0 / R;
    const float4* Ein = E + ((strip + 1) & 1) * W;  // the strip before's last row
    float4* Eout = E + (strip & 1) * W;
    const int rb = row0 + 32 * w, rl = rb + 31;
    const int nlive = min(nw, (n1 - row0) / 32 + 1);
    const int dlast = min(row0 + R - 1, n1) + n2;
    if (rb <= n1) {
      const int i = rb + lane;
      const bool next_live = rl < n1;
      const bool last_warp = w == nw - 1;
      const int de = min(rl, n1) + n2;
      const int c1 = i < imax ? codes1[i] : 0;
      const int c17 = 7 * c1;
      const float ins1 = T->ins[c1];
      int cj = code_at(c2, rb - i, l2max);
      float M1 = LZ, X1 = LZ, Y1 = LZ;
      float nM2 = LZ, nX2 = LZ, nY2 = LZ;
      for (int d = row0; d <= dlast; ++d) {
        if (d < rb || d > de) {
          diagonal_barrier(nlive);
          continue;
        }
        const float m_d = T->match[c17 + cj];
        const float e2 = T->ins[cj];
        const int c_next = code_at(c2, d + 1 - i, l2max);

        // the row above: the lane before, the warp before through its
        // slot, or the strip before through E
        float4 edge = make_float4(LZ, LZ, LZ, 0.0f);
        if (lane == 0 && d <= rb + n2) {
          if (w > 0) {
            edge = s.edge[2 * (w - 1) + ((d - 1) & 1)];
          } else if (row0 > 0) {
            edge = Ein[d - rb];
          }
        }
        float uM = __shfl_up_sync(kFull, M1, 1);
        float uX = __shfl_up_sync(kFull, X1, 1);
        float uY = __shfl_up_sync(kFull, Y1, 1);
        if (lane == 0) {
          uM = edge.x;
          uX = edge.y;
          uY = edge.z;
        }

        const int j = d - i;
        if (forward_cell(t, row0 == 0 && w == 0, i, j, n1, n2, m_d, e2, ins1, uM, uX, nM2,
                         nX2, nY2, M1, X1, Y1, c11, cx10, cy01))
          out[static_cast<size_t>(i) * W + j] = M1;
        nM2 = uM;
        nX2 = uX;
        nY2 = uY;
        cj = c_next;

        if (lane == 31 && next_live && d >= rl) {  // row rl has a cell on d
          const float4 v = make_float4(M1, X1, Y1, 0.0f);
          if (last_warp) {
            Eout[d - rl] = v;
          } else {
            s.edge[2 * w + (d & 1)] = v;
          }
        }
        diagonal_barrier(nlive);
      }
      if (i == n1) {
        cap[0] = M1;
        cap[1] = X1;
        cap[2] = Y1;
      }
    }
    __syncthreads();  // E and the slots are complete before the next strip
  }
  if (w == 0) {
    if (lane == 1) {
      cap[3] = c11;
      cap[4] = cx10;
    }
    if (lane == 0) cap[5] = cy01;
  }
}

// backward_pass for imax above 1024, in strips of blockDim.x rows from the
// last one up.  Strip s leaves (M, X) of its first row in E[s & 1].
__device__ __forceinline__ void backward_pass_long(
    const int* __restrict__ codes1, const int* __restrict__ codes2,
    const TablePtrs& tab, float* __restrict__ out, float* __restrict__ cap,
    float4* E, int n1, int n2, int imax, int l2max, float4* smem) {
  const int W = l2max + 1;
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = blockDim.x;
  const Shared s = carve(smem, nw);
  stage(s, tab, codes2, W);
  fill_dead(out, n1, n2, imax, W);
  __syncthreads();

  const Tables* T = s.T;
  const int* c2 = s.c2;
  const Trans t = load_trans(T);
  float c11 = LZ, cx10 = LZ, cy01 = LZ;   // captures b_M(1,1), b_X(1,0), b_Y(0,1)

  for (int row0 = n1 / R * R; row0 >= 0; row0 -= R) {
    const int strip = row0 / R;
    const float4* Ein = E + ((strip + 1) & 1) * W;  // the strip after's first row
    float4* Eout = E + (strip & 1) * W;
    const int rb = row0 + 32 * w, rl = rb + 31;
    const int nlive = min(nw, (n1 - row0) / 32 + 1);
    const int dtop = min(row0 + R - 1, n1) + n2;
    if (rb <= n1) {
      const int i = rb + lane;
      const bool next_live = rl < n1;
      const bool last_warp = w == nw - 1;
      const int de = min(rl, n1) + n2;
      const bool has_next = i + 1 < imax;
      const int c1n = has_next ? codes1[i + 1] : 0;
      const int c17n = 7 * c1n;
      const float ins1n = has_next ? T->ins[c1n] : 0.0f;
      int cjn = code_at(c2, de - i + 1, l2max);
      float M1 = LZ, X1 = LZ, Y1 = LZ;
      float nM2 = LZ;
      for (int d = dtop; d >= row0; --d) {
        if (d < rb || d > de) {
          diagonal_barrier(nlive);
          continue;
        }
        const float match_n = has_next ? T->match[c17n + cjn] : 0.0f;
        const float ins2_n = T->ins[cjn];
        const int c_next = code_at(c2, d - i, l2max);

        // the row below: the lane after, the warp after through its slot,
        // or the strip after through E
        float4 edge = make_float4(LZ, LZ, 0.0f, 0.0f);
        if (lane == 31 && next_live && d >= rl) {
          edge = last_warp ? Ein[d - rl] : s.edge[2 * (w + 1) + ((d + 1) & 1)];
        }
        float dM = __shfl_down_sync(kFull, M1, 1);
        float dX = __shfl_down_sync(kFull, X1, 1);
        if (lane == 31) {
          dM = edge.x;
          dX = edge.y;
        }

        const int j = d - i;
        if (backward_cell(t, i, j, n1, n2, match_n, ins1n, ins2_n, dX, nM2, M1, X1, Y1))
          out[static_cast<size_t>(i) * W + j] = M1;
        if (row0 == 0 && w == 0) {
          if (i == 1 && j == 1) c11 = M1;
          if (i == 1 && j == 0) cx10 = X1;
          if (i == 0 && j == 1) cy01 = Y1;
        }
        nM2 = dM;
        cjn = c_next;

        if (lane == 0 && d <= rb + n2) {  // row rb has a cell on d
          const float4 v = make_float4(M1, X1, 0.0f, 0.0f);
          if (w > 0) {
            s.edge[2 * w + (d & 1)] = v;
          } else if (row0 > 0) {
            Eout[d - rb] = v;
          }
        }
        diagonal_barrier(nlive);
      }
    }
    __syncthreads();  // E and the slots are complete before the next strip
  }
  if (w == 0) {
    if (lane == 1) {
      cap[0] = c11;
      cap[1] = cx10;
    }
    if (lane == 0) cap[2] = cy01;
  }
}

__global__ void __launch_bounds__(1024)
pairhmm_forward_long_kernel(const int* __restrict__ codes1, const int* __restrict__ len1,
                            const int* __restrict__ codes2, const int* __restrict__ len2,
                            TablePtrs tab, float* __restrict__ fm,
                            float* __restrict__ fcap, float4* __restrict__ edge,
                            int imax, int l2max) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x;
  forward_pass_long(codes1 + static_cast<size_t>(b) * imax,
                    codes2 + static_cast<size_t>(b) * (l2max + 1), tab,
                    fm + static_cast<size_t>(b) * imax * (l2max + 1), fcap + b * 6,
                    edge + static_cast<size_t>(b) * 2 * (l2max + 1),
                    min(len1[b], imax - 1), min(len2[b], l2max), imax, l2max, smem);
}

__global__ void __launch_bounds__(1024)
pairhmm_backward_long_kernel(const int* __restrict__ codes1, const int* __restrict__ len1,
                             const int* __restrict__ codes2, const int* __restrict__ len2,
                             TablePtrs tab, float* __restrict__ bm,
                             float* __restrict__ bcap, float4* __restrict__ edge,
                             int imax, int l2max) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x;
  backward_pass_long(codes1 + static_cast<size_t>(b) * imax,
                     codes2 + static_cast<size_t>(b) * (l2max + 1), tab,
                     bm + static_cast<size_t>(b) * imax * (l2max + 1), bcap + b * 3,
                     edge + static_cast<size_t>(b) * 2 * (l2max + 1),
                     min(len1[b], imax - 1), min(len2[b], l2max), imax, l2max, smem);
}

__global__ void __launch_bounds__(1024)
pairhmm_forward_kernel(const int* __restrict__ codes1, const int* __restrict__ len1,
                       const int* __restrict__ codes2, const int* __restrict__ len2,
                       TablePtrs tab, float* __restrict__ fm,
                       float* __restrict__ fcap, int imax, int l2max) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x;
  forward_pass(codes1 + static_cast<size_t>(b) * imax,
               codes2 + static_cast<size_t>(b) * (l2max + 1), tab,
               fm + static_cast<size_t>(b) * imax * (l2max + 1), fcap + b * 6,
               min(len1[b], imax - 1), min(len2[b], l2max), imax, l2max, smem);
}

__global__ void __launch_bounds__(1024)
pairhmm_backward_kernel(const int* __restrict__ codes1, const int* __restrict__ len1,
                        const int* __restrict__ codes2, const int* __restrict__ len2,
                        TablePtrs tab, float* __restrict__ bm,
                        float* __restrict__ bcap, int imax, int l2max) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x;
  backward_pass(codes1 + static_cast<size_t>(b) * imax,
                codes2 + static_cast<size_t>(b) * (l2max + 1), tab,
                bm + static_cast<size_t>(b) * imax * (l2max + 1), bcap + b * 3,
                min(len1[b], imax - 1), min(len2[b], l2max), imax, l2max, smem);
}

// ----------------------------------------------------------- posterior --

constexpr int kPostThreads = 256;

// Totals (ProbabilisticModel.h:337-365) and match posteriors (:374-403),
// masked to the true lengths, as ops/pairhmm.posterior: blocks (b, y) share
// the rows of pair b, a warp a row, the lanes along j.  Reads fm and bm
// inside the lengths only.
__global__ void __launch_bounds__(kPostThreads)
pairhmm_posterior_kernel(const float* __restrict__ fm, const float* __restrict__ fcap,
                         const float* __restrict__ bm, const float* __restrict__ bcap,
                         const int* __restrict__ len1, const int* __restrict__ len2,
                         const float* __restrict__ init, float* __restrict__ post,
                         int imax, int l2max) {
  const int b = blockIdx.x;
  const int W = l2max + 1;
  const int n1 = min(len1[b], imax - 1), n2 = min(len2[b], l2max);
  const float* fc = fcap + b * 6;
  const float* bc = bcap + b * 3;
  float total_f = fc[0] + init[0];
  total_f = dafs_log_add(total_f, fc[1] + init[1]);
  total_f = dafs_log_add(total_f, fc[2] + init[2]);
  float total_b = fc[3] + bc[0];
  total_b = dafs_log_add(total_b, fc[4] + bc[1]);
  total_b = dafs_log_add(total_b, fc[5] + bc[2]);
  const float total = (total_f + total_b) / 2.0f;

  const float* f = fm + static_cast<size_t>(b) * imax * W;
  const float* g = bm + static_cast<size_t>(b) * imax * W;
  float* p = post + static_cast<size_t>(b) * (imax - 1) * l2max;
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int i = 1 + blockIdx.y * nw + (threadIdx.x >> 5); i < imax; i += gridDim.y * nw) {
    for (int j = 1 + lane; j < W; j += 32) {
      float v = 0.0f;
      if (i <= n1 && j <= n2) {
        const float logp = f[i * W + j] + g[i * W + j] - total;
        v = dafs_probcons_exp(fminf(logp, 0.0f));
      }
      p[(i - 1) * l2max + (j - 1)] = v;
    }
  }
}

// --------------------------------------------------------- floor probe --

// The dependency floor of a pass alone: `steps` diagonals, on each the M
// chain of one cell (two dependent LOG_ADDs and the adds) after the
// hand-over of the design above: a shuffle from the lane before, between
// warps the slot in shared memory, and the block barrier (none with one
// warp).  It computes nothing of use; buf takes one float per thread so that
// the chain is kept.
__global__ void __launch_bounds__(1024)
pairhmm_floor_probe_kernel(float* buf, int steps) {
  extern __shared__ float4 smem[];
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Shared s = carve(smem, nw);
  if (threadIdx.x < 2 * nw) s.edge[threadIdx.x] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const float t0 = -0x1.0p-4f, t1 = -0x1.8p+1f, e = -0x1.4p+0f;
  float m = 0.0f, x = -1.0f - lane, y = -2.0f;
  for (int d = 0; d < steps; ++d) {
    float uM = __shfl_up_sync(kFull, m, 1);
    float uX = __shfl_up_sync(kFull, x, 1);
    float uY = __shfl_up_sync(kFull, y, 1);
    if (lane == 0) {
      uM = w > 0 ? s.edge[2 * (w - 1) + ((d - 1) & 1)].x : 0.0f;
      uX = x;
      uY = y;
    }
    float acc = uM + t0;
    acc = dafs_log_add(acc, uX + t1);
    acc = dafs_log_add(acc, uY + t1);
    m = acc + e;
    if (lane == 31) s.edge[2 * w + (d & 1)] = make_float4(m, x, y, 0.0f);
    diagonal_barrier(nw);
  }
  buf[blockIdx.x * blockDim.x + threadIdx.x] = m;
}

// ------------------------------------------------------------ launchers --

int launch_pass(bool forward, const int* codes1, const int* len1, const int* codes2,
                const int* len2, const TablePtrs& tab, float* out, float* cap, int B,
                int imax, int l2max, cudaStream_t stream) {
  const int nwarps = (imax + 31) / 32;  // a row a lane
  if (nwarps > 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(nwarps, l2max + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (forward) {
    pairhmm_forward_kernel<<<B, 32 * nwarps, smem, stream>>>(
        codes1, len1, codes2, len2, tab, out, cap, imax, l2max);
  } else {
    pairhmm_backward_kernel<<<B, 32 * nwarps, smem, stream>>>(
        codes1, len1, codes2, len2, tab, out, cap, imax, l2max);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_pass_long(bool forward, const int* codes1, const int* len1,
                     const int* codes2, const int* len2, const TablePtrs& tab,
                     float* out, float* cap, float4* edge, int B, int imax,
                     int l2max, cudaStream_t stream) {
  const size_t smem = shared_bytes(32, l2max + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (forward) {
    pairhmm_forward_long_kernel<<<B, 1024, smem, stream>>>(
        codes1, len1, codes2, len2, tab, out, cap, edge, imax, l2max);
  } else {
    pairhmm_backward_long_kernel<<<B, 1024, smem, stream>>>(
        codes1, len1, codes2, len2, tab, out, cap, edge, imax, l2max);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The long variants, for imax above 1024: edge holds B * 2 * (l2max + 1)
// float4 of scratch for the hand-over between strips.
extern "C" int dafs_pairhmm_forward_long(const int* codes1, const int* len1,
                                         const int* codes2, const int* len2,
                                         const float* match, const float* ins,
                                         const float* trans, const float* init,
                                         float* fm, float* fcap, float* edge,
                                         int B, int imax, int l2max,
                                         cudaStream_t stream) {
  const TablePtrs tab = {match, ins, trans, init};
  return launch_pass_long(true, codes1, len1, codes2, len2, tab, fm, fcap,
                          reinterpret_cast<float4*>(edge), B, imax, l2max, stream);
}

extern "C" int dafs_pairhmm_backward_long(const int* codes1, const int* len1,
                                          const int* codes2, const int* len2,
                                          const float* match, const float* ins,
                                          const float* trans, const float* init,
                                          float* bm, float* bcap, float* edge,
                                          int B, int imax, int l2max,
                                          cudaStream_t stream) {
  const TablePtrs tab = {match, ins, trans, init};
  return launch_pass_long(false, codes1, len1, codes2, len2, tab, bm, bcap,
                          reinterpret_cast<float4*>(edge), B, imax, l2max, stream);
}

extern "C" int dafs_pairhmm_forward(const int* codes1, const int* len1,
                                    const int* codes2, const int* len2,
                                    const float* match, const float* ins,
                                    const float* trans, const float* init,
                                    float* fm, float* fcap, int B, int imax,
                                    int l2max, cudaStream_t stream) {
  const TablePtrs tab = {match, ins, trans, init};
  return launch_pass(true, codes1, len1, codes2, len2, tab, fm, fcap, B, imax,
                     l2max, stream);
}

extern "C" int dafs_pairhmm_backward(const int* codes1, const int* len1,
                                     const int* codes2, const int* len2,
                                     const float* match, const float* ins,
                                     const float* trans, const float* init,
                                     float* bm, float* bcap, int B, int imax,
                                     int l2max, cudaStream_t stream) {
  const TablePtrs tab = {match, ins, trans, init};
  return launch_pass(false, codes1, len1, codes2, len2, tab, bm, bcap, B, imax,
                     l2max, stream);
}

// post: (B, imax - 1, l2max).
extern "C" int dafs_pairhmm_posterior(const float* fm, const float* fcap,
                                      const float* bm, const float* bcap,
                                      const int* len1, const int* len2,
                                      const float* init, float* post, int B,
                                      int imax, int l2max, cudaStream_t stream) {
  const int rows_per_block = kPostThreads / 32;
  int gy = (imax - 1 + rows_per_block - 1) / rows_per_block;
  if (gy > 16) gy = 16;
  pairhmm_posterior_kernel<<<dim3(B, gy), kPostThreads, 0, stream>>>(
      fm, fcap, bm, bcap, len1, len2, init, post, imax, l2max);
  return static_cast<int>(cudaGetLastError());
}

// Times nothing itself: the caller brackets it with CUDA events.  buf holds
// B * 32 * nwarps floats.
extern "C" int dafs_pairhmm_floor_probe(float* buf, int steps, int nwarps, int B,
                                        cudaStream_t stream) {
  if (nwarps < 1 || nwarps > 32) return static_cast<int>(cudaErrorInvalidValue);
  pairhmm_floor_probe_kernel<<<B, 32 * nwarps, shared_bytes(nwarps, 0), stream>>>(buf, steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dafs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
