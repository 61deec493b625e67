// CUDA kernels of the RNAalifold consensus partition function: the inside,
// exterior and outside of ops/alifold_kernel.py.
//
// They replace dafs_tpu's device program for the consensus,
// dafs_tpu/ops/alifold_kernel.py::alifold_fast (:437; one XLA program a
// call): the inside scan over diagonals (inside_step :814, scanned at :938),
// the exterior scans (q1_step :946 at :957, qn_step :961 at :973) and the
// outside scan with its multiloop accumulators (outside_step :993, at
// :1214).  Their plain PyTorch version is ops/alifold_kernel.py (`inside`,
// `exterior`, `outside` on a `prepare`d consensus); ops/alifold_cuda.py
// binds these and builds their arguments from the same prepared tensors,
// so every pow, exp and table lookup is rounded once, by the same torch
// ops, and the kernels only multiply, add and divide.
//
// What bounds them on the H100.  The work of a call is small: for each
// pair-allowed cell, each stencil cell (u, v) of the STAIR blocks whose qb
// (inside) or pout/qb (outside) is non-zero, a product over the NS
// sequences of about thirty float operations.  At RF00017's largest call
// (NS 10, n 382) that is some 1e8 operations, a few microseconds of the
// card's float32 rate.  What bounds the kernels is latency along a chain:
// diagonal d of the inside needs every shorter diagonal, and the outside
// every longer one, so a scan is n - 1 dependent steps, and within a step
// each thread walks its stencil cells' sequences in order.  The design:
//
// - One persistent, cooperative launch a scan.  The grid is as many CTAs
//   as fit on the card at once (occupancy x SMs: one CTA an SM, which
//   keeps a cell's loads in registers; at two, capped at 128 registers,
//   the kernels spilled and ran slower), at most the widest diagonal's
//   n - 1 cells; a grid barrier separates the diagonals
//   (dafs_alifold_barrier_probe times the barriers alone).  A card that
//   cannot launch cooperatively, or a grid that does not fit, makes the
//   launcher return the error; there is no per-diagonal fallback.  The loop
//   tables go to shared memory once a CTA a scan.  The outside's
//   accumulator update for diagonal d + 1 runs in diagonal d's step: it
//   writes only entries (i', l) with l <= i' + d, and the cells of
//   diagonal d read only l > i + d.
// - Only pair-allowed cells run the stencil: the CTAs stride over their
//   diagonal's compact list (`pairs`, `pair_off`; ops/alifold_cuda.py
//   builds it on the device once a call).  The inside's qm1 and qm run for
//   every cell of the diagonal; a cell that cannot pair keeps qb, pout, cl
//   and cm at 0.
// - A short chain per stencil cell: a CTA first lists the stencil cells
//   whose factor is non-zero (the others add 0 * SCP[u][v], as the plain
//   version's zero terms do: an exact zero, or NaN where sc ** (u + v + 2)
//   overflows) and deals them out to its threads, one each while they
//   last.  A cell's channels are one record, a float4 a sequence (the
//   four A-group channels), the sequences one after another, so a thread
//   issues the loads of ten sequences at once and one 16-byte load
//   brings a sequence; its codes are bytes beside them, the per-sequence
//   letters bytes and the gap counts shorts.  The B group's table lookups
//   run only where both loop sizes are <= 2: elsewhere every mask
//   (including m.sb's blg1 term) is 0 and the lookups are finite, so the
//   term is an exact +0 and skipping it leaves the sum's bits as they are.
//   A thread's product over the sequences stays sequential, in ascending
//   s, as the plain torch.prod over dim 0 is: a tree product can overflow
//   where the sequential one does not, and the pf-scale ladder would then
//   read the two routes differently.
// - Few steps in a cell's chain: the stencil cells go to shared memory
//   once a scan with the loop tables, and every load of a cell that waits
//   for no other (the stencil factors, the first chunk's staging, the
//   multiloop sums, thread 0's scalars, the qm sum's terms but the cell's
//   own, which thread 0 adds after its qm1) is issued before the cell's
//   first barrier; one block sum gives qb (pout), and thread 0 goes on to
//   qm1 and qm without another.  A diagonal's cells that cannot pair (qm1
//   and qm only) go a warp each to the CTAs after those with a
//   pair-allowed cell, and need no block barrier.
// - State that other CTAs write during a scan (qbl, qm, qm1t, a1t, a2t,
//   cl, cm, and q1, qn, q) is read with ld.global.cg (L2) after the
//   barrier, never through the read-only path; the true inputs are
//   const __restrict__ and read through it.
//
// Determinism: no atomics on values (the grid barrier's counter is the only
// atomic).  A CTA sums its threads' partials (each in a fixed order) by
// warp shuffles and then warp 0 over the warps; the stencil cells are dealt
// out in a fixed order; the accumulators gain one term a diagonal, in the
// plain version's order.  Two runs give the same bits.  The sums are ordered
// otherwise than PyTorch's, so the kernels agree with the plain version to
// float32 rounding (tests and chip_smoke.py hold them at rtol 2e-4, atol
// 1e-6).

#include "common.cuh"

#include <cooperative_groups.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kSW = 31;        // stencil width: loop sizes u, v in [0, 30]
constexpr int kTurn = 3;       // a pair (i, j) needs j - i > kTurn
constexpr int kRP = 64;        // row padding of the diag-major buffers
constexpr int kC0 = kSW + 2;   // column padding of the diag-major buffers
constexpr int kPad = 34;       // column padding of the per-sequence vectors
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCells = 3 * kThreads;   // the STAIR blocks hold 601 cells
constexpr int kCellsPerThread = kMaxCells / kThreads;
constexpr int kChunk = 32;     // sequences staged in shared memory at a time
constexpr int kGroup = 10;     // sequences whose records a thread loads at once
constexpr int kCodes = 6;      // code slots of a cell: tp7, c175o, c35o, rt7, c175i, c35i

}  // namespace

// The arguments of every kernel.  ops/alifold_cuda.py fills the same struct
// (ctypes), in this field order.  Diag-major buffers (nrows x wc) hold
// M[i][i + dd] at row kRP + dd, column kC0 + i, and zeros outside the matrix;
// a record buffer holds a cell's record at the same offset times its size.
struct AlifoldArgs {
  const float4* __restrict__ in_rec;    // (nrows, wc, NS) IN-side A-group channels, a float4 a seq
  const float4* __restrict__ out_rec;   // (nrows, wc, NS) OUT-side A-group channels
  const uint8_t* __restrict__ codes;    // (nrows, wc, 6, NS): tp7, c175o, c35o, rt7, c175i, c35i
  const float* __restrict__ hp;         // hairpin products, diag-major
  const float* __restrict__ mlstem;     // multiloop stem factors, diag-major
  const float* __restrict__ mlclose;    // multiloop closing factors, diag-major
  const float* __restrict__ psc;        // covariance factors, diag-major
  const float* __restrict__ ap;         // allowed pairs (0 or 1), diag-major
  const float* __restrict__ ext;        // (Lp, Lp) exterior stem factors, row-major
  const float* __restrict__ bs_seg;     // (Lp, Lp) blocked-segment factors, row-major
  const float* __restrict__ gate_u;     // (Lp) unpaired gate
  const float* __restrict__ sc_pow;     // (Lp + 1) sc ** k
  const float* __restrict__ scp;        // (31, 31) stencil scale powers, 0 past u + v = 30
  const uint8_t* __restrict__ s5b;      // (NS, wb) per-sequence letters, kPad columns first
  const uint8_t* __restrict__ s3b;
  const int16_t* __restrict__ a2sb;     // (NS, wb) per-sequence non-gap counts
  const float* __restrict__ tabs;       // the flat tables and scalars, at the offsets below
  const int* __restrict__ cells;        // (ncells) stencil cells, u | v << 8
  const int* __restrict__ pairs;        // i of every pair-allowed cell, by diagonal, i ascending
  const int* __restrict__ pair_off;     // (n + 1) diagonal d: pairs[pair_off[d] .. pair_off[d + 1])
  float* qbl;              // qb, diag-major
  float* cl;               // pout / qb, diag-major
  float* cm;               // the accumulators' factor of each outer pair, diag-major
  float* qm;               // (Lp, Lp) row-major
  float* qm1t;             // (Lp, Lp) qm1 transposed: qm1t[j][i] = qm1[i][j]
  float* a1t;              // (Lp, Lp) A1 transposed
  float* a2t;              // (Lp, Lp) A2 transposed
  float* q1;               // (Lp)
  float* qn;               // (Lp)
  float* q;                // (1) the partition function Q
  float* pout;             // (Lp, Lp) row-major
  int ns, lp, n, nrows, wc, wb, bcut, ncells;
  int o_t7, o_ti11, o_ti21a, o_ti21b, o_ti22, o_ti21b_o, o_ti22_o, o_tgen, o_bu, o_f1n,
      o_c23, o_blg1, o_sc, o_bsn;
};

namespace {

__device__ __forceinline__ bool finite_f(float x) { return fabsf(x) <= 0x1.fffffep+127f; }

// Offset of M[p][q] in a diag-major buffer.
__device__ __forceinline__ int64_t ldo(const AlifoldArgs& a, int p, int q) {
  return static_cast<int64_t>(kRP + q - p) * a.wc + kC0 + p;
}

// A chunk of sequences staged for one cell: its own channels and codes,
// and per stencil offset the gap-aware loop size and the neighbour letter
// (size | letter << 8) on the u side and on the v side.
struct Stage {
  float4 row[kChunk];
  int code[3][kChunk];
  int us[kChunk][kSW];
  int vs[kChunk][kSW];
};

struct LoopTabs {
  float tgen[kSW * kSW];
  float bu[kSW];
  float f1n[kSW];
};

// The stencil cells of one cell whose factor is non-zero, in a fixed order,
// with the partner's factor m, the cell's scale power and (outside) the
// partner's covariance factor.
struct Active {
  int cell[kMaxCells];
  float m[kMaxCells];
  float scp[kMaxCells];
  float psc[kMaxCells];
  int warp_count[kWarps];
};

struct Smem {
  Stage st;
  LoopTabs lt;
  Active act;
  int cells[kMaxCells];    // the stencil cells, -1 past ncells
  float red[3][kWarps];
};

// What a scan reads of the tables in every cell: the loop tables and the
// stencil cells, staged once a CTA a scan.
__device__ __forceinline__ void load_scan_tables(const AlifoldArgs& a, Smem& sm) {
  for (int k = threadIdx.x; k < kSW * kSW; k += kThreads)
    sm.lt.tgen[k] = __ldg(a.tabs + a.o_tgen + k);
  if (threadIdx.x < kSW) {
    sm.lt.bu[threadIdx.x] = __ldg(a.tabs + a.o_bu + threadIdx.x);
    sm.lt.f1n[threadIdx.x] = __ldg(a.tabs + a.o_f1n + threadIdx.x);
  }
  for (int k = threadIdx.x; k < kMaxCells; k += kThreads)
    sm.cells[k] = k < a.ncells ? __ldg(a.cells + k) : -1;
}

__device__ __forceinline__ float ind(int x, int k) { return x == k ? 1.0f : 0.0f; }

// The A group of one sequence at one stencil cell: the general, 1xn, 2x3
// and bulge categories, in the plain version's operand order.  `full`: v <
// BCUT (all indicator terms); otherwise only the u-side terms, on u < BCUT.
__device__ __forceinline__ float a_group(float o0, float o1, float o2, float o3, int U1,
                                         int U2, bool full, bool uside, const LoopTabs& t,
                                         float c23) {
  const float tgen = t.tgen[U1 * kSW + U2];
  const float iu0 = ind(U1, 0), iu1 = ind(U1, 1);
  if (full) {
    const float iu2 = ind(U1, 2), iu3 = ind(U1, 3);
    const float iv0 = ind(U2, 0), iv1 = ind(U2, 1), iv2 = ind(U2, 2), iv3 = ind(U2, 3);
    const float t1n = iu1 * t.f1n[U2] + t.f1n[U1] * iv1;
    const float t23 = c23 * (iu2 * iv3 + iu3 * iv2);
    const float tblg = iu0 * t.bu[U2] + t.bu[U1] * iv0;
    return o0 * tgen + o1 * t1n + o2 * t23 + o3 * tblg;
  }
  float k = o0 * tgen;
  if (uside) k = k + (o1 * (iu1 * t.f1n[U2]) + o3 * (iu0 * t.bu[U2]));
  return k;
}

struct Masks {
  float sb, m11, m12, m21, m22;
};

// The B group's loop-size masks (sizes <= 2 on both sides).
__device__ __forceinline__ Masks b_masks(int U1, int U2, float blg1) {
  const float iu0 = ind(U1, 0), iu1 = ind(U1, 1), iu2 = ind(U1, 2);
  const float iv0 = ind(U2, 0), iv1 = ind(U2, 1), iv2 = ind(U2, 2);
  Masks m;
  m.sb = iu0 * iv0 + blg1 * (iu0 * iv1 + iu1 * iv0);
  m.m11 = iu1 * iv1;
  m.m12 = iu1 * iv2;
  m.m21 = iu2 * iv1;
  m.m22 = iu2 * iv2;
  return m;
}

// Sums of the warp's lanes, in lane 0.
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// x, y and z summed over the block in a fixed order; the totals in thread 0.
__device__ __forceinline__ void block_sum3(float& x, float& y, float& z, float (*red)[kWarps]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  x = warp_sum(x);
  y = warp_sum(y);
  z = warp_sum(z);
  __syncthreads();  // an earlier use of red has been read
  if (lane == 0) {
    red[0][w] = x;
    red[1][w] = y;
    red[2][w] = z;
  }
  __syncthreads();
  if (w == 0) {
    x = warp_sum(lane < kWarps ? red[0][lane] : 0.0f);
    y = warp_sum(lane < kWarps ? red[1][lane] : 0.0f);
    z = warp_sum(lane < kWarps ? red[2][lane] : 0.0f);
  }
}

// The stencil partner of cell (i, j) at stencil cell (u, v): the inner pair
// (i + 1 + u, j - 1 - v) inside, the outer pair (i - 1 - u, j + 1 + v)
// outside.
template <bool kInside>
__device__ __forceinline__ int64_t partner(const AlifoldArgs& a, int i, int j, int cell) {
  const int u = cell & 255, v = cell >> 8;
  return kInside ? ldo(a, i + 1 + u, j - 1 - v) : ldo(a, i - 1 - u, j + 1 + v);
}

// A thread's stencil cells (up to kCellsPerThread, -1 where none): the
// partner's factor m (qb of the inner pair inside, pout / qb of the outer
// pair outside), the cell's scale power and (outside) the partner's psc.
struct Slots {
  int cell[kCellsPerThread];
  float m[kCellsPerThread], scp[kCellsPerThread], psc[kCellsPerThread];
};

// Issues the loads of the thread's slots; nothing waits for them here.
template <bool kInside>
__device__ __forceinline__ void load_slots(const AlifoldArgs& a, const Smem& sm, int i, int j,
                                           Slots& sl) {
  const float* m_of = kInside ? a.qbl : a.cl;
#pragma unroll
  for (int c = 0; c < kCellsPerThread; ++c) {
    const int cell = sm.cells[threadIdx.x + c * kThreads];
    sl.cell[c] = cell;
    sl.m[c] = sl.scp[c] = sl.psc[c] = 0.0f;
    if (cell >= 0) {
      const int64_t off = partner<kInside>(a, i, j, cell);
      sl.m[c] = __ldcg(m_of + off);
      sl.scp[c] = __ldg(a.scp + (cell & 255) * kSW + (cell >> 8));
      if (!kInside) sl.psc[c] = __ldg(a.psc + off);
    }
  }
}

// Lists in act the slots whose m is non-zero, in thread order; the others'
// terms 0 * SCP[u][v] go into ina.  Two barriers; returns the count.
__device__ int list_active(Active& act, const Slots& sl, float& ina) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int mine = 0;
#pragma unroll
  for (int c = 0; c < kCellsPerThread; ++c) {
    if (sl.cell[c] < 0) continue;
    if (sl.m[c] != 0.0f)
      ++mine;
    else
      ina += 0.0f * sl.scp[c];
  }
  int incl = mine;  // inclusive scan over the warp's lanes
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) act.warp_count[w] = incl;
  __syncthreads();
  int pos = incl - mine, total = 0;
  for (int k = 0; k < kWarps; ++k) {
    const int t = act.warp_count[k];
    if (k < w) pos += t;
    total += t;
  }
#pragma unroll
  for (int c = 0; c < kCellsPerThread; ++c) {
    if (sl.cell[c] >= 0 && sl.m[c] != 0.0f) {
      act.cell[pos] = sl.cell[c];
      act.m[pos] = sl.m[c];
      act.scp[pos] = sl.scp[c];
      act.psc[pos] = sl.psc[c];
      ++pos;
    }
  }
  __syncthreads();
  return total;
}

// Stages sequences [s0, s0 + sn) of cell (i, j): the cell's own record (OUT
// side inside, IN side outside), its three codes of that side, and the loop
// sizes and neighbour letters of every stencil offset.  A thread issues all
// its loads (a record, a code, up to kStageItems loop-size items) before its
// first store, so the staging costs one round trip.
constexpr int kStageItems = (kChunk * kSW + kThreads - 1) / kThreads;

template <bool kInside>
__device__ void stage_chunk(const AlifoldArgs& a, Stage& st, int i, int j, int64_t cij, int s0,
                            int sn) {
  const int tid = threadIdx.x, ns = a.ns;
  const bool has_row = tid < sn, has_code = tid < 3 * sn;
  float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int code = 0, cc = 0, cs = 0;
  if (has_row) row = __ldg((kInside ? a.out_rec : a.in_rec) + cij * ns + s0 + tid);
  if (has_code) {
    cc = tid / sn;
    cs = tid - cc * sn;
    code = __ldg(a.codes + (cij * kCodes + (kInside ? 0 : 3) + cc) * ns + s0 + cs);
  }
  // item k: sequence k / kSW, offset x = k % kSW; (hi - lo) is the gap-aware
  // loop size, l the neighbour letter: u side S5[i+1+x] (inside) or
  // S3[i-1-x] (outside), v side S3[j-1-x] or S5[j+1+x]
  int uhi[kStageItems], ulo[kStageItems], ul[kStageItems];
  int vhi[kStageItems], vlo[kStageItems], vl[kStageItems];
#pragma unroll
  for (int r = 0; r < kStageItems; ++r) {
    const int k = tid + r * kThreads;
    if (k < sn * kSW) {
      const int s = k / kSW, x = k - s * kSW;
      const int64_t b = static_cast<int64_t>(s0 + s) * a.wb + kPad;
      const int16_t* a2 = a.a2sb + b;
      if (kInside) {
        uhi[r] = __ldg(a2 + i + x);
        ulo[r] = __ldg(a2 + i);
        ul[r] = __ldg(a.s5b + b + i + 1 + x);
        vhi[r] = __ldg(a2 + j - 1);
        vlo[r] = __ldg(a2 + j - 1 - x);
        vl[r] = __ldg(a.s3b + b + j - 1 - x);
      } else {
        uhi[r] = __ldg(a2 + i - 1);
        ulo[r] = __ldg(a2 + i - 1 - x);
        ul[r] = __ldg(a.s3b + b + i - 1 - x);
        vhi[r] = __ldg(a2 + j + x);
        vlo[r] = __ldg(a2 + j);
        vl[r] = __ldg(a.s5b + b + j + 1 + x);
      }
    }
  }
  if (has_row) st.row[tid] = row;
  if (has_code) st.code[cc][cs] = code;
#pragma unroll
  for (int r = 0; r < kStageItems; ++r) {
    const int k = tid + r * kThreads;
    if (k < sn * kSW) {
      const int s = k / kSW, x = k - s * kSW;
      st.us[s][x] = max(0, uhi[r] - ulo[r]) | (ul[r] << 8);
      st.vs[s][x] = max(0, vhi[r] - vlo[r]) | (vl[r] << 8);
    }
  }
}

// kp times the factors of the staged sequences at one stencil cell, in
// ascending s: the A group, and the B group where both loop sizes are <= 2.
// A group of sequences' records and partner codes is loaded at once.
template <bool kInside>
__device__ __forceinline__ float chunk_product(const AlifoldArgs& a, const Stage& st,
                                               const LoopTabs& lt, int cell, int64_t off, int s0,
                                               int sn, float kp) {
  const int u = cell & 255, v = cell >> 8;
  const bool full = v < a.bcut, uside = u < a.bcut;
  const float c23 = __ldg(a.tabs + a.o_c23), blg1 = __ldg(a.tabs + a.o_blg1);
  const float* tb = a.tabs;
  const float4* rec = (kInside ? a.in_rec : a.out_rec) + off * a.ns + s0;
  // the partner's code: the inner type (rt7) inside, the outer (tp7) outside
  const uint8_t* code = a.codes + (off * kCodes + (kInside ? 3 : 0)) * a.ns + s0;
  for (int s1 = 0; s1 < sn; s1 += kGroup) {
    float4 x[kGroup];
    int pcs[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (s1 + g < sn) {
        x[g] = __ldg(rec + s1 + g);
        pcs[g] = full && uside ? __ldg(code + s1 + g) : 0;
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int s = s1 + g;
      if (s >= sn) break;
      const int us = st.us[s][u], vs = st.vs[s][v];
      const int U1 = us & 255, U2 = vs & 255;
      const float4 r = st.row[s];
      float k = a_group(r.x * x[g].x, r.y * x[g].y, r.z * x[g].z, r.w * x[g].w, U1, U2, full,
                        uside, lt, c23);
      if (full && uside && U1 <= 2 && U2 <= 2) {
        const Masks m = b_masks(U1, U2, blg1);
        const int pc = pcs[g];
        float bv;
        if (kInside) {
          const int tp7 = st.code[0][s], c175 = st.code[1][s], c35 = st.code[2][s];
          const int m35 = pc * 5 + (vs >> 8), sp = us >> 8;
          bv = __ldg(tb + a.o_t7 + tp7 * 7 + pc) * m.sb
               + __ldg(tb + a.o_ti11 + c175 * 7 + pc) * m.m11
               + __ldg(tb + a.o_ti21a + c175 * 35 + m35) * m.m12
               + (__ldg(tb + a.o_ti21b + (c35 * 5 + sp) * 35 + m35) * m.m21
                  + __ldg(tb + a.o_ti22 + (c175 * 5 + sp) * 35 + m35) * m.m22);
        } else {
          const int rt7 = st.code[0][s], c175i = st.code[1][s], c35i = st.code[2][s];
          const int si = us >> 8, cout = pc * 25 + si * 5 + (vs >> 8);
          bv = __ldg(tb + a.o_t7 + pc * 7 + rt7) * m.sb
               + (__ldg(tb + a.o_ti11 + cout * 7 + rt7) * m.m11
                  + __ldg(tb + a.o_ti21a + cout * 35 + c35i) * m.m12
                  + __ldg(tb + a.o_ti22_o + cout * 175 + c175i) * m.m22)
               + __ldg(tb + a.o_ti21b_o + (pc * 5 + si) * 175 + c175i) * m.m21;
        }
        k = k + bv;
      }
      kp = kp * k;
    }
  }
  return kp;
}

// A pair-allowed cell's stencil, started by the caller: its slots loaded
// and its first chunk of sequences staged.  Lists the active stencil cells,
// takes their products over the sequences (staging the later chunks) and
// returns the thread's partial of the stencil sum: inside sum m kp SCP,
// outside sum m (kp psc) SCP, after the 0 * SCP terms of the others.
template <bool kInside>
__device__ float stencil_partial(const AlifoldArgs& a, Smem& sm, const Slots& sl, int i, int j,
                                 int64_t cij) {
  const int tid = threadIdx.x, ns = a.ns;
  float part = 0.0f;
  const int nact = list_active(sm.act, sl, part);
  float kp[kCellsPerThread];
#pragma unroll
  for (int r = 0; r < kCellsPerThread; ++r) kp[r] = 1.0f;
  for (int s0 = 0; s0 < ns; s0 += kChunk) {
    const int sn = min(kChunk, ns - s0);
    if (s0 > 0) {
      __syncthreads();  // the previous chunk has been read
      stage_chunk<kInside>(a, sm.st, i, j, cij, s0, sn);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kCellsPerThread; ++r) {
      const int e = tid + r * kThreads;
      if (e < nact) {
        const int cell = sm.act.cell[e];
        kp[r] = chunk_product<kInside>(a, sm.st, sm.lt, cell, partner<kInside>(a, i, j, cell),
                                       s0, sn, kp[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kCellsPerThread; ++r) {
    const int e = tid + r * kThreads;
    if (e < nact) {
      if (kInside)
        part += sm.act.m[e] * kp[r] * sm.act.scp[e];
      else
        part += sm.act.m[e] * (kp[r] * sm.act.psc[e]) * sm.act.scp[e];
    }
  }
  return part;
}

// ---------------------------------------------------------------- inside --
// Thread 0's operands of a cell's qm1 and its first qm term.
struct Qm1Operands {
  float prev, gate, mlstem, bs0, qm0, bsn;
};

__device__ __forceinline__ Qm1Operands load_qm1_operands(const AlifoldArgs& a, int i, int j,
                                                         int64_t cij) {
  const int lp = a.lp;
  Qm1Operands o;
  o.prev = __ldcg(a.qm1t + static_cast<int64_t>(j - 1) * lp + i);
  o.gate = __ldg(a.gate_u + j);
  o.mlstem = __ldg(a.mlstem + cij);
  o.bs0 = __ldg(a.bs_seg + static_cast<int64_t>(i) * lp + i - 1);
  o.qm0 = __ldcg(a.qm + static_cast<int64_t>(i) * lp + i - 1);
  o.bsn = __ldg(a.tabs + a.o_bsn);
  return o;
}

// The cell's qm1 from its qb, and qm from the sum `rest` of its other terms
// (alifold_kernel.inside's diagonal step after qb).
__device__ __forceinline__ void store_qm1_qm(const AlifoldArgs& a, const Qm1Operands& o, int i,
                                             int j, float qb, float rest) {
  const int lp = a.lp;
  const float m1 = o.prev * o.bsn * o.gate + qb * o.mlstem;
  a.qm1t[static_cast<int64_t>(j) * lp + i] = m1;
  a.qm[static_cast<int64_t>(i) * lp + j] = rest + (o.bs0 + o.qm0) * m1;
}

// A term of the qm sum of cell (i, j): (bs_seg[i][k-1] + qm[i][k-1]) qm1[k][j].
__device__ __forceinline__ float qm_term(const AlifoldArgs& a, int i, int j, int k) {
  const int lp = a.lp;
  return (__ldg(a.bs_seg + static_cast<int64_t>(i) * lp + k - 1)
          + __ldcg(a.qm + static_cast<int64_t>(i) * lp + k - 1))
         * __ldcg(a.qm1t + static_cast<int64_t>(j) * lp + k);
}

// qm1 and qm of cell (i, i + d) that cannot pair (its qb stays 0), by one
// warp: the lanes over the qm sum's terms k in (i, j] (the term k = i needs
// the cell's own qm1; lane 0 adds it last), summed by shuffles.
__device__ void inside_rest(const AlifoldArgs& a, int i, int d) {
  const int lane = threadIdx.x & 31, j = i + d;
  Qm1Operands o{};
  if (lane == 0) o = load_qm1_operands(a, i, j, ldo(a, i, j));
  float rest = 0.0f;
#pragma unroll 4
  for (int k = i + lane + (lane == 0 ? 32 : 0); k <= j; k += 32) rest += qm_term(a, i, j, k);
  rest = warp_sum(rest);
  if (lane == 0) store_qm1_qm(a, o, i, j, 0.0f, rest);
}

// qb, qm1 and qm of pair-allowed cell (i, i + d).  Every load that does not
// wait for another is issued before the cell's first barrier: thread 0's
// scalars, the stencil slots, the first terms of the two row sums and the
// first chunk's staging.
__device__ void inside_pair(const AlifoldArgs& a, Smem& sm, int i, int d) {
  const int tid = threadIdx.x, lp = a.lp, j = i + d;
  const int64_t cij = ldo(a, i, j);
  Qm1Operands o{};
  float hp = 0.0f, sc_pow = 0.0f, mlclose = 0.0f, psc = 0.0f, sc = 0.0f;
  if (tid == 0) {
    o = load_qm1_operands(a, i, j, cij);
    hp = __ldg(a.hp + cij);
    sc_pow = __ldg(a.sc_pow + d + 1);
    mlclose = __ldg(a.mlclose + cij);
    psc = __ldg(a.psc + cij);
    sc = __ldg(a.tabs + a.o_sc);
  }
  Slots sl;
  load_slots<true>(a, sm, i, j, sl);
  // multiloop closing: qm[i+1][k-1] qm1[k][j-1], k in [i+2, j-1]; and the
  // qm sum's terms k in (i, j] (thread 0 starts a stride later: k = i is
  // its last term)
  const int k1 = i + 2 + tid, k2 = i + tid + (tid == 0 ? kThreads : 0);
  float ml_q = 0.0f, ml_m = 0.0f, rest = 0.0f;
  if (k1 <= j - 1) {
    ml_q = __ldcg(a.qm + static_cast<int64_t>(i + 1) * lp + k1 - 1);
    ml_m = __ldcg(a.qm1t + static_cast<int64_t>(j - 1) * lp + k1);
  }
  if (k2 <= j) rest = qm_term(a, i, j, k2);
  stage_chunk<true>(a, sm.st, i, j, cij, 0, min(kChunk, a.ns));
  float mlsum = ml_q * ml_m;
  for (int k = k1 + kThreads; k <= j - 1; k += kThreads)
    mlsum += __ldcg(a.qm + static_cast<int64_t>(i + 1) * lp + k - 1)
             * __ldcg(a.qm1t + static_cast<int64_t>(j - 1) * lp + k);
  for (int k = k2 + kThreads; k <= j; k += kThreads) rest += qm_term(a, i, j, k);
  float interior = stencil_partial<true>(a, sm, sl, i, j, cij);
  block_sum3(interior, mlsum, rest, sm.red);
  if (tid == 0) {
    const float qb = (hp * sc_pow + interior + mlsum * mlclose * sc * sc) * psc;
    a.qbl[cij] = qb;
    store_qm1_qm(a, o, i, j, qb, rest);
  }
}

// The inside scan: diagonal d's pair-allowed cells from the compact list, a
// CTA each; then its other cells' qm1 and qm, a warp each, from the warps of
// the CTAs after those with a pair-allowed cell; then the grid barrier.
__global__ void __launch_bounds__(kThreads, 1) inside_kernel(const AlifoldArgs a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  load_scan_tables(a, sm);
  for (int d = 1; d < a.n; ++d) {
    const int beg = __ldg(a.pair_off + d), cnt = __ldg(a.pair_off + d + 1) - beg;
    for (int k = blockIdx.x; k < cnt; k += G) {
      __syncthreads();  // the CTA's last cell is done with shared memory
      inside_pair(a, sm, __ldg(a.pairs + beg + k), d);
    }
    const int warp = ((blockIdx.x + G - cnt % G) % G) * kWarps + (threadIdx.x >> 5);
    for (int i = 1 + warp; i <= a.n - d; i += G * kWarps) {
      if (d > kTurn && __ldg(a.ap + ldo(a, i, i + d)) > 0.0f) continue;  // in the list
      inside_rest(a, i, d);
    }
    grid.sync();
  }
}

// -------------------------------------------------------------- exterior --
// Block 0 walks q1 over j = 1 .. n, block 1 qn over i = n .. 1
// (alifold_kernel.exterior), by pushing each finished value forward: the
// threads own the columns, and when q1[k] is final (broadcast through shared
// memory) every thread adds q1[k] * (qb[k+1][c] * ext[k+1][c]) to the
// accumulator of each of its columns c > k, with the next step's loads
// already in flight; the owner of column k + 1 then finishes q1[k + 1].  A
// step is one broadcast and a multiply-add a thread.  qn is the mirror image:
// qn[m] adds qb[c][m-1] * ext[c][m-1] * qn[m] to every column c < m.  Each
// accumulator gains its terms in a fixed order (ascending k for q1,
// descending m for qn).
constexpr int kExtThreads = 1024;
constexpr int kExtCols = 5;   // columns a thread: Lp <= 5 * 1024

__global__ void __launch_bounds__(kExtThreads) exterior_kernel(const AlifoldArgs a) {
  __shared__ float chain[kExtCols * kExtThreads];
  const int tid = threadIdx.x, T = blockDim.x, n = a.n, lp = a.lp;
  const float sc = a.tabs[a.o_sc];
  const bool forward = blockIdx.x == 0;
  float acc[kExtCols], cur[kExtCols], nxt[kExtCols];
#pragma unroll
  for (int r = 0; r < kExtCols; ++r) acc[r] = cur[r] = nxt[r] = 0.0f;
  for (int c = tid; c < lp; c += T) chain[c] = 0.0f;
  __syncthreads();
  if (forward) {
    // q1[k+1] = q1[k] sc gate_u[k+1] + sum_{k' <= k} q1[k'] (qb ext)[k'+1][k+1]
#pragma unroll
    for (int r = 0; r < kExtCols; ++r) {
      const int c = tid + r * T;
      if (c >= 1 && c <= n) nxt[r] = __ldcg(a.qbl + ldo(a, 1, c)) * __ldg(a.ext + lp + c);
    }
    if (tid == 0) chain[0] = 1.0f;
    __syncthreads();
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int r = 0; r < kExtCols; ++r) {
        cur[r] = nxt[r];
        const int c = tid + r * T;
        if (c >= k + 2 && c <= n)
          nxt[r] = __ldcg(a.qbl + ldo(a, k + 2, c))
                   * __ldg(a.ext + static_cast<int64_t>(k + 2) * lp + c);
      }
      const float qk = chain[k];
#pragma unroll
      for (int r = 0; r < kExtCols; ++r) {
        const int c = tid + r * T;
        if (c > k && c <= n) acc[r] += qk * cur[r];
        if (c == k + 1) chain[c] = qk * sc * __ldg(a.gate_u + c) + acc[r];
      }
      __syncthreads();
    }
    for (int c = tid; c < lp; c += T) a.q1[c] = chain[c];
    if (tid == 0) a.q[0] = chain[n];
  } else {
    // qn[m-1] = qn[m] sc gate_u[m-1] + sum_{m' >= m} (qb ext)[m-1][m'-1] qn[m']
#pragma unroll
    for (int r = 0; r < kExtCols; ++r) {
      const int c = tid + r * T;
      if (c >= 1 && c <= n)
        nxt[r] = __ldcg(a.qbl + ldo(a, c, n)) * __ldg(a.ext + static_cast<int64_t>(c) * lp + n);
    }
    if (tid == 0) chain[n + 1] = 1.0f;
    __syncthreads();
    for (int m = n + 1; m >= 2; --m) {
#pragma unroll
      for (int r = 0; r < kExtCols; ++r) {
        cur[r] = nxt[r];
        const int c = tid + r * T;
        if (c >= 1 && c <= m - 2)
          nxt[r] = __ldcg(a.qbl + ldo(a, c, m - 2))
                   * __ldg(a.ext + static_cast<int64_t>(c) * lp + m - 2);
      }
      const float qm = chain[m];
#pragma unroll
      for (int r = 0; r < kExtCols; ++r) {
        const int c = tid + r * T;
        if (c >= 1 && c <= m - 1) acc[r] += cur[r] * qm;
        if (c == m - 1) chain[c] = qm * sc * __ldg(a.gate_u + c) + acc[r];
      }
      __syncthreads();
    }
    for (int c = tid; c < lp; c += T) a.qn[c] = chain[c];
  }
}

// --------------------------------------------------------------- outside --
// pout of pair-allowed cell (i, i + d) and its factor C of the multiloop
// accumulators (alifold_kernel.outside's diagonal step).  Every load that
// does not wait for another is issued before the first barrier.
__device__ void outside_pair(const AlifoldArgs& a, Smem& sm, int i, int d) {
  const int tid = threadIdx.x, lp = a.lp, n = a.n, j = i + d;
  const int64_t cij = ldo(a, i, j);
  float q1 = 0.0f, qn = 0.0f, ext = 0.0f, q = 1.0f, mlstem = 0.0f, qb = 0.0f, psc = 0.0f,
        mlclose = 0.0f, sc = 0.0f;
  if (tid == 0) {
    q1 = __ldcg(a.q1 + i - 1);
    qn = __ldcg(a.qn + j + 1);
    ext = __ldg(a.ext + static_cast<int64_t>(i) * lp + j);
    q = __ldcg(a.q);
    mlstem = __ldg(a.mlstem + cij);
    qb = __ldcg(a.qbl + cij);
    psc = __ldg(a.psc + cij);
    mlclose = __ldg(a.mlclose + cij);
    sc = __ldg(a.tabs + a.o_sc);
  }
  Slots sl;
  load_slots<false>(a, sm, i, j, sl);
  // multiloop: (A1 + A2)[i][l] qm[j+1][l-1] + A1[i][l] bs_seg[j+1][l-1], l in (j, n]
  const int l1 = j + 1 + tid;
  float a1 = 0.0f, a2 = 0.0f, qv = 0.0f, bv = 0.0f;
  if (l1 <= n) {
    a1 = __ldcg(a.a1t + static_cast<int64_t>(l1) * lp + i);
    a2 = __ldcg(a.a2t + static_cast<int64_t>(l1) * lp + i);
    qv = __ldcg(a.qm + static_cast<int64_t>(j + 1) * lp + l1 - 1);
    bv = __ldg(a.bs_seg + static_cast<int64_t>(j + 1) * lp + l1 - 1);
  }
  stage_chunk<false>(a, sm.st, i, j, cij, 0, min(kChunk, a.ns));
  float mlsum = l1 <= n ? (a1 + a2) * qv + a1 * bv : 0.0f;
  for (int l = l1 + kThreads; l <= n; l += kThreads) {
    const float b1 = __ldcg(a.a1t + static_cast<int64_t>(l) * lp + i);
    const float b2 = __ldcg(a.a2t + static_cast<int64_t>(l) * lp + i);
    mlsum += (b1 + b2) * __ldcg(a.qm + static_cast<int64_t>(j + 1) * lp + l - 1)
             + b1 * __ldg(a.bs_seg + static_cast<int64_t>(j + 1) * lp + l - 1);
  }
  float w_int = stencil_partial<false>(a, sm, sl, i, j, cij), none = 0.0f;
  block_sum3(w_int, mlsum, none, sm.red);
  if (tid == 0) {
    const float w_ext = q1 * qn * ext / q;
    const float w_ml = mlsum * mlstem;
    const float p = qb * (w_ext + w_int + w_ml);
    a.pout[static_cast<int64_t>(i) * lp + j] = p;
    const float cl = p / (qb > 0.0f ? qb : 1.0f);
    a.cl[cij] = cl;
    a.cm[cij] = cl * psc * mlclose * sc * sc;
  }
}

// Diagonal d + 1's accumulator update, spread over the grid's threads from
// the last CTA down (the first CTAs hold the diagonal's cells): for each
// outer pair (k, l = k + d + 1) and k < i' < l, A1[i'][l] += C qm[k+1][i'-1]
// and A2[i'][l] += C bs_seg[k+1][i'-1].  A term with C = 0 and finite
// factors is +0 and leaves the entry's bits as they are, so it is skipped;
// with a factor that is not finite it is added, as the plain loops add it.
__device__ void outside_update(const AlifoldArgs& a, int d) {
  const int lp = a.lp;
  const int64_t items = static_cast<int64_t>(a.n - d - 1) * d;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kThreads + threadIdx.x;
       e < items; e += stride) {
    const int k = 1 + static_cast<int>(e / d), ip = k + 1 + static_cast<int>(e % d);
    const int l = k + d + 1;
    const float c = __ldcg(a.cm + ldo(a, k, l));
    const float qv = __ldcg(a.qm + static_cast<int64_t>(k + 1) * lp + ip - 1);
    const float bv = __ldg(a.bs_seg + static_cast<int64_t>(k + 1) * lp + ip - 1);
    if (c != 0.0f || !finite_f(qv) || !finite_f(bv)) {
      const int64_t o = static_cast<int64_t>(l) * lp + ip;
      a.a1t[o] = __ldcg(a.a1t + o) + c * qv;
      a.a2t[o] = __ldcg(a.a2t + o) + c * bv;
    }
  }
}

// The outside scan: diagonal d's pair-allowed cells from the compact list
// and diagonal d + 1's accumulator update, then the grid barrier.
__global__ void __launch_bounds__(kThreads, 1) outside_kernel(const AlifoldArgs a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  load_scan_tables(a, sm);
  for (int d = a.n - 1; d >= 1; --d) {
    const int beg = __ldg(a.pair_off + d), cnt = __ldg(a.pair_off + d + 1) - beg;
    for (int k = blockIdx.x; k < cnt; k += gridDim.x) {
      __syncthreads();
      outside_pair(a, sm, __ldg(a.pairs + beg + k), d);
    }
    outside_update(a, d);
    grid.sync();
  }
}

// Grid barriers and nothing else: `barrier_probe` times the scans' floor.
__global__ void __launch_bounds__(kThreads) barrier_kernel(int steps) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < steps; ++k) grid.sync();
}

// Does nothing: `floor_probe` launches it to time a chain of dependent
// launches alone (the floor of a launch a diagonal).
__global__ void empty_kernel() {}

// The grid of a scan: as many CTAs of `kernel` as the current card holds at
// once, at most `work` and at least 1.  Refused where the card cannot
// launch cooperatively.
template <typename Kernel>
cudaError_t scan_grid(Kernel kernel, int work, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
  const int fit = per_sm * sms;
  *grid = work < 1 ? 1 : work < fit ? work : fit;
  return e;
}

// One cooperative launch of `kernel` over the scan's grid.
template <typename Kernel>
int launch_scan(Kernel kernel, const AlifoldArgs* args, cudaStream_t stream) {
  AlifoldArgs a = *args;
  if (a.ncells > kMaxCells || a.ns < 1) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 1;
  cudaError_t e = scan_grid(kernel, a.n - 1, &grid);
  if (e == cudaSuccess) {
    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), params, 0, stream);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// Launchers: inside and outside are one cooperative launch each, exterior
// one launch; each returns the launch error (ops/alifold_cuda.py raises).

extern "C" int dafs_alifold_inside(const AlifoldArgs* args, cudaStream_t stream) {
  return launch_scan(inside_kernel, args, stream);
}

extern "C" int dafs_alifold_exterior(const AlifoldArgs* args, cudaStream_t stream) {
  if (args->lp > kExtCols * kExtThreads || args->n + 1 >= args->lp)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = args->lp >= kExtThreads ? kExtThreads : (args->lp + 31) / 32 * 32;
  exterior_kernel<<<2, threads, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafs_alifold_outside(const AlifoldArgs* args, cudaStream_t stream) {
  return launch_scan(outside_kernel, args, stream);
}

// The grid of the inside (outside = 0) or the outside scan for these
// arguments, written to *grid.
extern "C" int dafs_alifold_grid(const AlifoldArgs* args, int outside, int* grid) {
  const int work = args->n - 1;
  return static_cast<int>(outside ? scan_grid(outside_kernel, work, grid)
                                  : scan_grid(inside_kernel, work, grid));
}

// The scans' floor: one cooperative launch of `blocks` CTAs (a scan's grid)
// that passes `steps` grid barriers and computes nothing.
extern "C" int dafs_alifold_barrier_probe(int blocks, int steps, cudaStream_t stream) {
  void* params[] = {&steps};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_kernel), dim3(blocks), dim3(kThreads), params, 0,
      stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The floor of a launch a diagonal: `launches` empty launches one after another
// on the stream (for timing; computes nothing).
extern "C" int dafs_alifold_floor_probe(int launches, cudaStream_t stream) {
  for (int k = 0; k < launches; ++k) {
    empty_kernel<<<1, 32, 0, stream>>>();
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
