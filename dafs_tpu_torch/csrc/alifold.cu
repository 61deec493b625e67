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
// sequences of about thirty float operations and a dozen table reads.  At
// RF00017's largest call (NS 10, n 385) that is some 1e9 operations, about
// 15 microseconds of the card's float32 rate.  What bounds the kernels is
// the chain: diagonal d of the inside needs every shorter diagonal, and
// the outside every longer one, so a call is 2(n - 1) + 1 dependent
// launches, each a few microseconds of launch and drain however little it
// computes.  The design does little about that yet: one launch a diagonal
// (issued in a loop here in C, not from Python), a CTA a cell, the CTA's
// threads over the stencil cells; stencil cells with a zero qb skip their
// product over the sequences and add 0 * SCP[u][v] in its place: the
// product is finite (the tables are, and kT grows with NS), so that is the
// plain version's term, an exact zero, or NaN where sc ** (u + v + 2)
// overflows, and both routes take the same pf-scale ladder; the outside's
// accumulator update for diagonal d + 1
// rides in diagonal d's launch (it writes no entry that launch reads).
//
// Determinism: no atomics.  A CTA sums its threads' partials (each in a
// fixed order over its cells) by warp shuffles and then warp 0 over the
// warps; the accumulators gain one term a launch, in the plain version's
// order.  Two runs give the same bits.  The sums are ordered otherwise than
// PyTorch's, so the kernels agree with the plain version to float32
// rounding (tests and chip_smoke.py hold them at rtol 2e-4, atol 1e-6).

#include "common.cuh"

#include <cstdint>

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

}  // namespace

// The arguments of every kernel.  ops/alifold_cuda.py fills the same struct
// (ctypes), in this field order.  Diag-major buffers (nrows x wc) hold
// M[i][i + dd] at row kRP + dd, column kC0 + i, and zeros outside the matrix.
struct AlifoldArgs {
  const float* in_st;      // (4 NS) IN-side A-group channels, diag-major
  const float* out_st;     // (4 NS) OUT-side A-group channels, diag-major
  const int64_t* tp7;      // (NS) outer pair type - 1, diag-major
  const int64_t* rt7;      // (NS) inner (reversed) pair type - 1
  const int64_t* c175o;    // (NS) outer pair code (type, S3[i], S5[j])
  const int64_t* c35o;     // (NS) outer pair code (type, S3[i])
  const int64_t* c175i;    // (NS) inner pair code
  const int64_t* c35i;     // (NS) inner pair code
  const float* hp;         // hairpin products, diag-major
  const float* mlstem;     // multiloop stem factors, diag-major
  const float* mlclose;    // multiloop closing factors, diag-major
  const float* psc;        // covariance factors, diag-major
  const float* ap;         // allowed pairs (0 or 1), diag-major
  const float* ext;        // (Lp, Lp) exterior stem factors, row-major
  const float* bs_seg;     // (Lp, Lp) blocked-segment factors, row-major
  const float* gate_u;     // (Lp) unpaired gate
  const float* sc_pow;     // (Lp + 1) sc ** k
  const float* scp;        // (31, 31) stencil scale powers, 0 past u + v = 30
  const int64_t* s5b;      // (NS, wb) per-sequence vectors, kPad columns first
  const int64_t* s3b;
  const int64_t* a2sb;
  const float* tabs;       // the flat tables and scalars, at the offsets below
  const int* cells;        // (ncells) stencil cells, u | v << 8
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

// Offset of M[p][q] in a diag-major buffer.
__device__ __forceinline__ int64_t ldo(const AlifoldArgs& a, int p, int q) {
  return static_cast<int64_t>(kRP + q - p) * a.wc + kC0 + p;
}

// A chunk of sequences staged for one cell: its own channels and codes,
// and per stencil offset the gap-aware loop size and the neighbour letter
// (size | letter << 8) on the u side and on the v side.
struct Stage {
  float row[4][kChunk];
  int code[3][kChunk];
  int us[kChunk][kSW];
  int vs[kChunk][kSW];
};

struct LoopTabs {
  float tgen[kSW * kSW];
  float bu[kSW];
  float f1n[kSW];
};

__device__ __forceinline__ void load_loop_tabs(const AlifoldArgs& a, LoopTabs& t) {
  for (int k = threadIdx.x; k < kSW * kSW; k += kThreads) t.tgen[k] = a.tabs[a.o_tgen + k];
  if (threadIdx.x < kSW) {
    t.bu[threadIdx.x] = a.tabs[a.o_bu + threadIdx.x];
    t.f1n[threadIdx.x] = a.tabs[a.o_f1n + threadIdx.x];
  }
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

// x and y summed over the block in a fixed order; the totals in thread 0.
__device__ __forceinline__ void block_sum2(float& x, float& y, float (*red)[kWarps]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  x = warp_sum(x);
  y = warp_sum(y);
  __syncthreads();  // an earlier use of red has been read
  if (lane == 0) {
    red[0][w] = x;
    red[1][w] = y;
  }
  __syncthreads();
  if (w == 0) {
    x = warp_sum(lane < kWarps ? red[0][lane] : 0.0f);
    y = warp_sum(lane < kWarps ? red[1][lane] : 0.0f);
  }
}

// The thread's stencil cells: (u, v), and the cell's offset in the
// diag-major buffers.
struct Cells {
  int u[kCellsPerThread], v[kCellsPerThread];
  int64_t off[kCellsPerThread];
  float m[kCellsPerThread];   // qb (inside) or pout / qb (outside) there
  float kp[kCellsPerThread];  // the product over the sequences
};

// ---------------------------------------------------------------- inside --
// One CTA a cell (i, i + d), i = 1 + blockIdx.x: qb, qm1 and qm of the cell
// (alifold_kernel.inside's diagonal step).
__global__ void __launch_bounds__(kThreads) inside_kernel(const AlifoldArgs a, const int d) {
  __shared__ Stage st;
  __shared__ LoopTabs lt;
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x, lp = a.lp, ns = a.ns;
  const int i = 1 + blockIdx.x, j = i + d;
  const int64_t plane = static_cast<int64_t>(a.nrows) * a.wc;
  const int64_t cij = ldo(a, i, j);
  const bool pair_ok = d > kTurn && a.ap[cij] > 0.0f;
  float interior = 0.0f, mlsum = 0.0f;
  if (pair_ok) {
    load_loop_tabs(a, lt);
    const float c23 = a.tabs[a.o_c23], blg1 = a.tabs[a.o_blg1];
    const float* tb = a.tabs;
    Cells cs;
#pragma unroll
    for (int c = 0; c < kCellsPerThread; ++c) {
      const int idx = tid + c * kThreads;
      cs.u[c] = cs.v[c] = 0;
      cs.off[c] = 0;
      cs.m[c] = 0.0f;
      cs.kp[c] = 1.0f;
      if (idx < a.ncells) {
        const int cell = a.cells[idx];
        cs.u[c] = cell & 255;
        cs.v[c] = cell >> 8;
        cs.off[c] = ldo(a, i + 1 + cs.u[c], j - 1 - cs.v[c]);
        cs.m[c] = a.qbl[cs.off[c]];
      }
    }
    for (int s0 = 0; s0 < ns; s0 += kChunk) {
      const int sn = min(kChunk, ns - s0);
      __syncthreads();  // the previous chunk has been read
      for (int k = tid; k < 4 * sn; k += kThreads) {
        const int c = k / sn, s = k - c * sn;
        st.row[c][s] = a.out_st[static_cast<int64_t>(c * ns + s0 + s) * plane + cij];
      }
      for (int s = tid; s < sn; s += kThreads) {
        const int64_t o = static_cast<int64_t>(s0 + s) * plane + cij;
        st.code[0][s] = static_cast<int>(a.tp7[o]);
        st.code[1][s] = static_cast<int>(a.c175o[o]);
        st.code[2][s] = static_cast<int>(a.c35o[o]);
      }
      for (int k = tid; k < sn * kSW; k += kThreads) {
        const int s = k / kSW, x = k - s * kSW;
        const int64_t b = static_cast<int64_t>(s0 + s) * a.wb + kPad;
        const int64_t* a2 = a.a2sb + b;
        const int u1 = max(0, static_cast<int>(a2[i + x] - a2[i]));
        st.us[s][x] = u1 | (static_cast<int>(a.s5b[b + i + 1 + x]) << 8);   // S5[i+1+u]
        const int u2 = max(0, static_cast<int>(a2[j - 1] - a2[j - 1 - x]));
        st.vs[s][x] = u2 | (static_cast<int>(a.s3b[b + j - 1 - x]) << 8);   // S3[j-1-v]
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kCellsPerThread; ++c) {
        if (cs.m[c] == 0.0f) continue;
        const int u = cs.u[c], v = cs.v[c];
        const bool full = v < a.bcut, uside = u < a.bcut;
        for (int s = 0; s < sn; ++s) {
          const int64_t po = static_cast<int64_t>(s0 + s) * plane + cs.off[c];
          const int64_t cp = static_cast<int64_t>(ns) * plane;
          const int us = st.us[s][u], vs = st.vs[s][v];
          const int U1 = us & 255, U2 = vs & 255;
          float k = a_group(st.row[0][s] * a.in_st[po], st.row[1][s] * a.in_st[po + cp],
                            st.row[2][s] * a.in_st[po + 2 * cp],
                            st.row[3][s] * a.in_st[po + 3 * cp], U1, U2, full, uside, lt, c23);
          if (full && uside) {
            const Masks m = b_masks(U1, U2, blg1);
            const int tp7 = st.code[0][s], c175 = st.code[1][s], c35 = st.code[2][s];
            const int tp2 = static_cast<int>(a.rt7[po]);
            const int m35 = tp2 * 5 + (vs >> 8), sp = us >> 8;
            const float bv = tb[a.o_t7 + tp7 * 7 + tp2] * m.sb
                             + tb[a.o_ti11 + c175 * 7 + tp2] * m.m11
                             + tb[a.o_ti21a + c175 * 35 + m35] * m.m12
                             + (tb[a.o_ti21b + (c35 * 5 + sp) * 35 + m35] * m.m21
                                + tb[a.o_ti22 + (c175 * 5 + sp) * 35 + m35] * m.m22);
            k = k + bv;
          }
          cs.kp[c] = cs.kp[c] * k;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCellsPerThread; ++c) {
      if (tid + c * kThreads >= a.ncells) continue;
      const float scp = a.scp[cs.u[c] * kSW + cs.v[c]];
      interior += cs.m[c] != 0.0f ? cs.m[c] * cs.kp[c] * scp : 0.0f * scp;
    }
    // multiloop closing: qm[i+1][k-1] qm1[k][j-1], k in [i+2, j-1]
    for (int k = i + 2 + tid; k <= j - 1; k += kThreads)
      mlsum += a.qm[static_cast<int64_t>(i + 1) * lp + k - 1]
               * a.qm1t[static_cast<int64_t>(j - 1) * lp + k];
  }
  block_sum2(interior, mlsum, red);
  if (tid == 0) {
    const float sc = a.tabs[a.o_sc], bsn = a.tabs[a.o_bsn];
    float qb = 0.0f;
    if (pair_ok) {
      const float hp = a.hp[cij] * a.sc_pow[d + 1];
      const float ml = mlsum * a.mlclose[cij] * sc * sc;
      qb = (hp + interior + ml) * a.psc[cij];
    }
    a.qbl[cij] = qb;
    a.qm1t[static_cast<int64_t>(j) * lp + i] =
        a.qm1t[static_cast<int64_t>(j - 1) * lp + i] * bsn * a.gate_u[j] + qb * a.mlstem[cij];
  }
  __syncthreads();  // qm1[i][j] is visible to the block
  float acc = 0.0f, none = 0.0f;
  for (int k = i + tid; k <= j; k += kThreads)
    acc += (a.bs_seg[static_cast<int64_t>(i) * lp + k - 1] + a.qm[static_cast<int64_t>(i) * lp + k - 1])
           * a.qm1t[static_cast<int64_t>(j) * lp + k];
  block_sum2(acc, none, red);
  if (tid == 0) a.qm[static_cast<int64_t>(i) * lp + j] = acc;
}

// -------------------------------------------------------------- exterior --
// Block 0 walks q1 over j = 1 .. n, block 1 qn over i = n .. 1, one warp
// each, the stems of a step summed over the warp (alifold_kernel.exterior).
__global__ void exterior_kernel(const AlifoldArgs a) {
  const int lane = threadIdx.x, n = a.n, lp = a.lp;
  const float sc = a.tabs[a.o_sc];
  if (blockIdx.x == 0) {
    if (lane == 0) a.q1[0] = 1.0f;
    __syncwarp();
    for (int j = 1; j <= n; ++j) {
      float acc = 0.0f;
      for (int i = 1 + lane; i <= j; i += 32)
        acc += a.q1[i - 1] * (a.qbl[ldo(a, i, j)] * a.ext[static_cast<int64_t>(i) * lp + j]);
      acc = warp_sum(acc);
      if (lane == 0) a.q1[j] = a.q1[j - 1] * sc * a.gate_u[j] + acc;
      __syncwarp();
    }
    if (lane == 0) a.q[0] = a.q1[n];
  } else {
    if (lane == 0) a.qn[n + 1] = 1.0f;
    __syncwarp();
    for (int i = n; i >= 1; --i) {
      float acc = 0.0f;
      for (int j = i + lane; j <= n; j += 32)
        acc += a.qbl[ldo(a, i, j)] * a.ext[static_cast<int64_t>(i) * lp + j] * a.qn[j + 1];
      acc = warp_sum(acc);
      if (lane == 0) a.qn[i] = a.qn[i + 1] * sc * a.gate_u[i] + acc;
      __syncwarp();
    }
  }
}

// --------------------------------------------------------------- outside --
// Blocks [0, n - d): one CTA a cell (i, i + d), its pout and its factor C of
// the multiloop accumulators (alifold_kernel.outside's diagonal step).
// Blocks [n - d, 2 (n - d) - 1): diagonal d + 1's accumulator update, one CTA
// an outer pair (k, k + d + 1): A1[i'][l] += C qm[k+1][i'-1] and A2[i'][l] +=
// C bs_seg[k+1][i'-1] for k < i' < l.  They write only entries (i', l) with
// l <= i' + d, and the cells of diagonal d read only l > i + d.
__global__ void __launch_bounds__(kThreads) outside_kernel(const AlifoldArgs a, const int d) {
  __shared__ Stage st;
  __shared__ LoopTabs lt;
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x, lp = a.lp, ns = a.ns, n = a.n;
  const int ncell = n - d;
  if (static_cast<int>(blockIdx.x) >= ncell) {
    const int k = 1 + blockIdx.x - ncell, l = k + d + 1;
    const float c = a.cm[ldo(a, k, l)];
    for (int ip = k + 1 + tid; ip < l; ip += kThreads) {
      const int64_t o = static_cast<int64_t>(l) * lp + ip;
      a.a1t[o] = a.a1t[o] + c * a.qm[static_cast<int64_t>(k + 1) * lp + ip - 1];
      a.a2t[o] = a.a2t[o] + c * a.bs_seg[static_cast<int64_t>(k + 1) * lp + ip - 1];
    }
    return;
  }
  const int i = 1 + blockIdx.x, j = i + d;
  const int64_t plane = static_cast<int64_t>(a.nrows) * a.wc;
  const int64_t cij = ldo(a, i, j);
  if (!(d > kTurn && a.ap[cij] > 0.0f)) return;  // pout, pout / qb and C stay 0
  load_loop_tabs(a, lt);
  const float c23 = a.tabs[a.o_c23], blg1 = a.tabs[a.o_blg1];
  const float* tb = a.tabs;
  Cells cs;
#pragma unroll
  for (int c = 0; c < kCellsPerThread; ++c) {
    const int idx = tid + c * kThreads;
    cs.u[c] = cs.v[c] = 0;
    cs.off[c] = 0;
    cs.m[c] = 0.0f;
    cs.kp[c] = 1.0f;
    if (idx < a.ncells) {
      const int cell = a.cells[idx];
      cs.u[c] = cell & 255;
      cs.v[c] = cell >> 8;
      cs.off[c] = ldo(a, i - 1 - cs.u[c], j + 1 + cs.v[c]);
      cs.m[c] = a.cl[cs.off[c]];
    }
  }
  for (int s0 = 0; s0 < ns; s0 += kChunk) {
    const int sn = min(kChunk, ns - s0);
    __syncthreads();
    for (int k = tid; k < 4 * sn; k += kThreads) {
      const int c = k / sn, s = k - c * sn;
      st.row[c][s] = a.in_st[static_cast<int64_t>(c * ns + s0 + s) * plane + cij];
    }
    for (int s = tid; s < sn; s += kThreads) {
      const int64_t o = static_cast<int64_t>(s0 + s) * plane + cij;
      st.code[0][s] = static_cast<int>(a.rt7[o]);
      st.code[1][s] = static_cast<int>(a.c175i[o]);
      st.code[2][s] = static_cast<int>(a.c35i[o]);
    }
    for (int k = tid; k < sn * kSW; k += kThreads) {
      const int s = k / kSW, x = k - s * kSW;
      const int64_t b = static_cast<int64_t>(s0 + s) * a.wb + kPad;
      const int64_t* a2 = a.a2sb + b;
      const int u1 = max(0, static_cast<int>(a2[i - 1] - a2[i - 1 - x]));
      st.us[s][x] = u1 | (static_cast<int>(a.s3b[b + i - 1 - x]) << 8);   // S3[i-1-u]
      const int u2 = max(0, static_cast<int>(a2[j + x] - a2[j]));
      st.vs[s][x] = u2 | (static_cast<int>(a.s5b[b + j + 1 + x]) << 8);   // S5[j+1+v]
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCellsPerThread; ++c) {
      if (cs.m[c] == 0.0f) continue;
      const int u = cs.u[c], v = cs.v[c];
      const bool full = v < a.bcut, uside = u < a.bcut;
      for (int s = 0; s < sn; ++s) {
        const int64_t po = static_cast<int64_t>(s0 + s) * plane + cs.off[c];
        const int64_t cp = static_cast<int64_t>(ns) * plane;
        const int us = st.us[s][u], vs = st.vs[s][v];
        const int U1 = us & 255, U2 = vs & 255;
        float k = a_group(st.row[0][s] * a.out_st[po], st.row[1][s] * a.out_st[po + cp],
                          st.row[2][s] * a.out_st[po + 2 * cp],
                          st.row[3][s] * a.out_st[po + 3 * cp], U1, U2, full, uside, lt, c23);
        if (full && uside) {
          const Masks m = b_masks(U1, U2, blg1);
          const int rt7 = st.code[0][s], c175i = st.code[1][s], c35i = st.code[2][s];
          const int tpo = static_cast<int>(a.tp7[po]);
          const int si = us >> 8, cout = tpo * 25 + si * 5 + (vs >> 8);
          const float bv = tb[a.o_t7 + tpo * 7 + rt7] * m.sb
                           + (tb[a.o_ti11 + cout * 7 + rt7] * m.m11
                              + tb[a.o_ti21a + cout * 35 + c35i] * m.m12
                              + tb[a.o_ti22_o + cout * 175 + c175i] * m.m22)
                           + tb[a.o_ti21b_o + (tpo * 5 + si) * 175 + c175i] * m.m21;
          k = k + bv;
        }
        cs.kp[c] = cs.kp[c] * k;
      }
    }
  }
  float w_int = 0.0f, mlsum = 0.0f;
#pragma unroll
  for (int c = 0; c < kCellsPerThread; ++c) {
    if (tid + c * kThreads >= a.ncells) continue;
    const float scp = a.scp[cs.u[c] * kSW + cs.v[c]];
    w_int += cs.m[c] != 0.0f ? cs.m[c] * (cs.kp[c] * a.psc[cs.off[c]]) * scp : 0.0f * scp;
  }
  // multiloop: (A1 + A2)[i][l] qm[j+1][l-1] + A1[i][l] bs_seg[j+1][l-1], l in (j, n]
  for (int l = j + 1 + tid; l <= n; l += kThreads) {
    const float a1 = a.a1t[static_cast<int64_t>(l) * lp + i];
    const float a2 = a.a2t[static_cast<int64_t>(l) * lp + i];
    mlsum += (a1 + a2) * a.qm[static_cast<int64_t>(j + 1) * lp + l - 1]
             + a1 * a.bs_seg[static_cast<int64_t>(j + 1) * lp + l - 1];
  }
  block_sum2(w_int, mlsum, red);
  if (tid == 0) {
    const float sc = a.tabs[a.o_sc];
    const float w_ext = a.q1[i - 1] * a.qn[j + 1] * a.ext[static_cast<int64_t>(i) * lp + j] / a.q[0];
    const float w_ml = mlsum * a.mlstem[cij];
    const float qb = a.qbl[cij];
    const float p = qb * (w_ext + w_int + w_ml);
    a.pout[static_cast<int64_t>(i) * lp + j] = p;
    const float cl = p / (qb > 0.0f ? qb : 1.0f);
    a.cl[cij] = cl;
    a.cm[cij] = cl * a.psc[cij] * a.mlclose[cij] * sc * sc;
  }
}

// Does nothing: `floor_probe` launches it to time the chain of dependent
// launches alone.
__global__ void empty_kernel() {}

}  // namespace

// Launchers: each loops over its scan's steps here and returns the first
// launch error (ops/alifold_cuda.py counts one launch a step).

extern "C" int dafs_alifold_inside(const AlifoldArgs* args, cudaStream_t stream) {
  const AlifoldArgs a = *args;
  if (a.ncells > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 1; d < a.n; ++d) {
    inside_kernel<<<a.n - d, kThreads, 0, stream>>>(a, d);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafs_alifold_exterior(const AlifoldArgs* args, cudaStream_t stream) {
  exterior_kernel<<<2, 32, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafs_alifold_outside(const AlifoldArgs* args, cudaStream_t stream) {
  const AlifoldArgs a = *args;
  if (a.ncells > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  for (int d = a.n - 1; d >= 1; --d) {
    outside_kernel<<<2 * (a.n - d) - 1, kThreads, 0, stream>>>(a, d);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernels' dependency floor: `launches` empty launches one after another
// on the stream (for timing; computes nothing).
extern "C" int dafs_alifold_floor_probe(int launches, cudaStream_t stream) {
  for (int k = 0; k < launches; ++k) {
    empty_kernel<<<1, 32, 0, stream>>>();
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
