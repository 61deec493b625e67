// CUDA kernels of the McCaskill fold: the inside, exterior and outside of
// ops/mccaskill_kernel.py::mccaskill_fast for one length bucket of
// sequences.
//
// They replace dafs_tpu's device program for the fold,
// dafs_tpu/ops/mccaskill_kernel.py::mccaskill_fast (:51; vmapped and jitted
// by dafs_tpu/ops/mccaskill.py::_batched_fast :577): the inside scan over
// diagonals (inside_step :165, scanned at :308), the exterior chains
// (q1_step :325 at :336, qn_step :340 at :352) and the outside scan with
// its two multiloop accumulators (outside_step :365, at :494).  Their plain
// PyTorch version is ops/mccaskill_kernel.py::mccaskill_fast;
// ops/mccaskill_cuda.py binds these and builds their inputs on the card from
// the same torch helpers (side_factors, exterior_factor, bs_segments), so
// every table lookup and pow is rounded once, by the same ops, and the
// kernels multiply, add and divide.
//
// What bounds them on the H100.  The work is small: at RF00017's bucket (10
// sequences, L 320) each pair-allowed cell sums some 500 interior-loop
// stencil terms and two multiloop rows of up to n terms, every cell a qm row
// of up to n terms: about 1e8 float operations, microseconds of the card's
// rate, and some 60 MB of per-cell factors and state.  What bounds the scans
// is the chain: diagonal d of the inside needs every shorter diagonal, the
// outside every longer one, so a scan is n - 1 dependent steps.  The design:
//
// - One persistent, cooperative launch a scan over all B sequences of the
//   bucket (they share Lp, so one grid barrier between diagonals serves all
//   of them).  The grid is as many CTAs as fit on the card at once, at most
//   as many as diagonal 1's cells need; a card that cannot launch
//   cooperatively, or a grid that does not fit, makes the launcher return
//   the error (ops/mccaskill_cuda.py raises; nothing falls back).
// - A warp a cell, not a CTA.  A McCaskill cell has no product over
//   sequences: its stencil is ~500 terms of two flops, its row sums d terms
//   of two or three.  A warp's lanes take the stencil slots and the row sums'
//   terms, butterfly shuffles sum them, and no block barrier is needed, so
//   8 cells a CTA are in flight (a CTA a cell, the consensus's choice, would
//   leave 31 of 32 lanes of the stencil's short loops idle and put 8 times
//   fewer cells in flight).  Diagonal d's pair-allowed cells come from a
//   compact list (b << 16 | i, built on the card once a bucket); its other
//   cells (qm1 and qm only) go to the warps after them.
// - The stencil slots (u, v), u + v <= 30, are grouped by their loop
//   category (general, 1xn, 2x3, bulge), by u + v within one, so a lane's
//   slots of one category reach the partner's diagonal limit in order and
//   the loop breaks there; each category's sum is multiplied by the cell's
//   factor of it (the plain version's contraction times the outer vector).
//   The seven special slots (stack, the 1-bulges, 1x1, 2x1, 1x2, 2x2) take
//   a lane each, with their table lookups.  The factors qb * F of a finished
//   cell are stored as one float4 (ql; the outside's (pout / qb) * G as clc),
//   so a slot reads one float of its partner.
// - The outside's accumulator update for diagonal d + 1 runs in diagonal
//   d's step, over d + 1's compact list only: it writes entries (i', l) with
//   l <= i' + d, and the cells of diagonal d read l > i + d.  A term with C =
//   0 adds +0 where qm and bs_seg are finite; where they are not, Q has
//   overflowed and the pf-scale ladder reads the attempt as over whatever
//   pout holds, so only outer pairs of the list are walked.
// - The exterior: a CTA a chain (q1 and qn of each sequence).  Each thread
//   owns columns; when q1[k] is final it is broadcast through shared memory
//   and every thread adds q1[k] * qb_ext[k + 1][j] to its own columns'
//   accumulators (the next row's loads issued a step ahead); the owner of
//   column k + 1 then finishes q1[k + 1].  A step is a broadcast and a
//   multiply-add a thread, not a reduction over j terms.  qn is its mirror.
// - State that other warps write during a scan is read with ld.global.cg
//   (L2) after the grid barrier, never through the read-only path.
//
// Determinism: no atomics on values (the grid barrier's counter is the only
// atomic).  A cell's sums run in its warp in a fixed order (each lane in slot
// order, then a butterfly), whatever the grid, the batch or the shard; an
// accumulator entry gains one term a diagonal, in the plain version's order;
// an exterior accumulator gains its terms in ascending k (q1) or descending
// j (qn).  Two runs give the same bits, and a sequence's bits do not depend
// on the batch it runs in.  The sums are ordered otherwise than PyTorch's,
// so the kernels agree with the plain version to float32 rounding
// (chip_smoke.py and the tests hold them at rtol 2e-4; atol 1e-6 on pout).

#include "common.cuh"

#include <cooperative_groups.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kSW = 31;          // stencil width: loop sizes u, v in [0, 30]
constexpr int kTurn = 3;         // a pair (i, j) needs j - i > kTurn
constexpr int kThreads = 256;    // inside and outside
constexpr int kCellThreads = 32;  // the threads of a cell: a warp
constexpr int kCellsPerCta = kThreads / kCellThreads;
constexpr int kMaxSlots = 512;   // the stencil's non-special slots: 489
constexpr int kFactors = 12;     // a cell's factors, in cellf's order below
constexpr int kSPad = 4;         // letters: S[k] at column kSPad + k
constexpr int kExtThreads = 1024;
constexpr int kMaxCols = 5;      // exterior columns a thread: Lp <= 5 * 1024

// cellf's factors of a cell (i, j): F of it as the inner pair (general, 1xn,
// 2x3, bulge/AU), G of it as the outer pair, the hairpin without its scale,
// the multiloop stem and closing factors, the exterior factor.
enum { kFgen, kF1n, kF23, kFtau, kGgen, kG1n, kG23, kGtau, kHp, kStem, kClose, kExt };

}  // namespace

// The arguments of every kernel.  ops/mccaskill_cuda.py fills the same struct
// (ctypes), in this field order.  Row-major (B, Lp, Lp) buffers hold M[i][j] at
// (b Lp + i) Lp + j; diag-major ones at (b Lp + j - i) Lp + i.
struct McArgs {
  const float* __restrict__ cellf;    // (B, Lp, Lp, 12) row-major cell factors
  const uint8_t* __restrict__ code;   // (B, Lp, Lp) row-major: pt | rt << 3 | allowed << 6
  const int* __restrict__ seq;        // (B, Lp + 2 kSPad) letters, zero padded
  const int* __restrict__ blk;        // (B, Lp) positions 1..a that may not be unpaired
  const float* __restrict__ gate_u;   // (B, Lp) 1 where the position may be unpaired
  const int* __restrict__ nlen;       // (B) true lengths
  const int* __restrict__ pairs;      // pair-allowed cells by diagonal: b << 16 | i, ascending
  const int* __restrict__ pair_off;   // (maxn + 1) diagonal d: pairs[pair_off[d] .. pair_off[d + 1])
  const int* __restrict__ slots;      // (nslots) u | v << 8, by category, then u + v, then u
  const float* __restrict__ tabs;     // stack, int11, int21, int22, bulge[1] at the offsets below
  const float* __restrict__ sc;       // (B) per-base scale of this ladder attempt
  const float* __restrict__ bs;       // (B) multiloop base factor times sc
  const float* __restrict__ scs;      // (B, 31) sc ** (s + 2)
  const float* __restrict__ sc_pow;   // (B, Lp + 1) sc ** k
  const float* __restrict__ kslot;    // (B, nslots) the slot's category constant times sc ** (s + 2)
  const float* __restrict__ bs_seg;   // (B, Lp, Lp) row-major
  float* qbl;     // (B, Lp, Lp) diag-major qb
  float4* ql;     // (B, Lp, Lp) diag-major qb F (general, 1xn, 2x3, bulge)
  float* qbx;     // (B, Lp, Lp) row-major qb ext
  float* qbxt;    // (B, Lp, Lp) qbx transposed
  float* qm;      // (B, Lp, Lp) row-major
  float* qm1t;    // (B, Lp, Lp) qm1 transposed: qm1t[j][i] = qm1[i][j]
  float* q1;      // (B, Lp)
  float* qn;      // (B, Lp)
  float* q;       // (B) the partition function Q
  float* cl;      // (B, Lp, Lp) diag-major pout / qb
  float4* clc;    // (B, Lp, Lp) diag-major (pout / qb) G
  float* cm;      // (B, Lp, Lp) diag-major: the accumulators' factor of an outer pair
  float* a1;      // (B, Lp, Lp) row-major A1[i][l]
  float* a2;      // (B, Lp, Lp) row-major A2[i][l]
  float* pout;    // (B, Lp, Lp) row-major
  int nb, lp, maxn, nslots, s_1n, s_23, s_tau;
  int o_stack, o_i11, o_i21, o_i22, o_bulge1;
};

namespace {

struct Smem {
  int slots[kMaxSlots];
};

__device__ __forceinline__ int64_t rm(const McArgs& a, int b, int p, int q) {
  return (static_cast<int64_t>(b) * a.lp + p) * a.lp + q;
}

__device__ __forceinline__ int64_t dm(const McArgs& a, int b, int p, int q) {
  return (static_cast<int64_t>(b) * a.lp + (q - p)) * a.lp + p;
}

// Sum of the warp's lanes, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum over a cell's threads, the same bits in each.
__device__ __forceinline__ float cell_sum(float x) { return warp_sum(x); }

// A thread's index within its cell's threads.
__device__ __forceinline__ int cell_thread() { return threadIdx.x % kCellThreads; }

// One component of a float4 buffer entry, through L2.
__device__ __forceinline__ float comp(const float4* base, int64_t at, int c) {
  return __ldcg(reinterpret_cast<const float*>(base) + at * 4 + c);
}

// seg_ok[a][b] of the plain version (indices clamped into [0, Lp - 1] by the
// caller): the segment a..b is empty or none of it is blocked.
__device__ __forceinline__ bool seg_ok(const int* blk, int p, int q) {
  return q - p + 1 <= 0 || __ldg(blk + q) == __ldg(blk + (p > 0 ? p - 1 : 0));
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : x > hi ? hi : x; }

// The strand gates of a cell as bit masks (bit u of gu, bit v of gv):
// inside g1[u] = seg_ok[i+1][i+u], g2[v] = no blocked position in (j-v, j-1]
// (v <= 1 always open); outside g1[u] = seg_ok[i-u][i-1], g2[v] = none in
// (j, j+v] (v = 0 always open).  Lane x computes bit x.
template <bool kInside>
__device__ __forceinline__ void gates(const McArgs& a, int b, int i, int j, unsigned& gu,
                                      unsigned& gv) {
  const int lane = threadIdx.x & 31, lp = a.lp, x = lane;
  const int* blk = a.blk + static_cast<int64_t>(b) * lp;
  bool g1, g2;
  if (kInside) {
    g1 = x == 0 || seg_ok(blk, clampi(i + 1, 0, lp - 1), clampi(i + x, 0, lp - 1));
    g2 = x <= 1 || __ldg(blk + j - 1) == __ldg(blk + clampi(j - x, 0, lp - 1));
  } else {
    g1 = x == 0 || seg_ok(blk, clampi(i - x, 0, lp - 1), clampi(i - 1, 0, lp - 1));
    g2 = x == 0 || (j + x <= lp - 1 && __ldg(blk + j + x) == __ldg(blk + j));
  }
  gu = __ballot_sync(0xffffffffu, g1);
  gv = __ballot_sync(0xffffffffu, g2);
}

__device__ __forceinline__ float gate(unsigned gu, unsigned gv, int u, int v) {
  return ((gu >> u) & (gv >> v) & 1u) ? 1.0f : 0.0f;
}

__device__ __forceinline__ void load_slots(const McArgs& a, Smem& sm) {
  for (int k = threadIdx.x; k < kMaxSlots; k += blockDim.x)
    sm.slots[k] = k < a.nslots ? __ldg(a.slots + k) : 0;
}

// The special slot k (0..6) as (u, v): stack, the two 1-bulges, 1x1, 1x2,
// 2x1, 2x2.
__device__ __forceinline__ void special_uv(int k, int& u, int& v) {
  const int us[7] = {0, 0, 1, 1, 1, 2, 2}, vs[7] = {0, 1, 0, 1, 2, 1, 2};
  u = us[k];
  v = vs[k];
}

// ---------------------------------------------------------------- inside --
// qm1 and qm of cell (b, i, i + d) from its qb (0 where it cannot pair), its
// factors (lane 0) and the warp's sum `rest` of the qm row's terms k in
// (i, j]; lane 0 stores.
__device__ __forceinline__ void finish_qm(const McArgs& a, int b, int i, int j, float qb,
                                          float stem, float rest) {
  const float prev = __ldcg(a.qm1t + rm(a, b, j - 1, i));
  const float m1 = prev * __ldg(a.bs + b) * __ldg(a.gate_u + static_cast<int64_t>(b) * a.lp + j)
                   + qb * stem;
  a.qm1t[rm(a, b, j, i)] = m1;
  a.qm[rm(a, b, i, j)] =
      rest + (__ldg(a.bs_seg + rm(a, b, i, i - 1)) + __ldcg(a.qm + rm(a, b, i, i - 1))) * m1;
}

// The lane's terms of the qm row of cell (b, i, j): (bs_seg[i][k-1] +
// qm[i][k-1]) qm1[k][j], k in (i, j] (the term k = i waits for the cell's own
// qm1; finish_qm adds it).
__device__ __forceinline__ float qm_row(const McArgs& a, int b, int i, int j) {
  float rest = 0.0f;
#pragma unroll 4
  for (int k = i + 1 + cell_thread(); k <= j; k += kCellThreads)
    rest += (__ldg(a.bs_seg + rm(a, b, i, k - 1)) + __ldcg(a.qm + rm(a, b, i, k - 1)))
            * __ldcg(a.qm1t + rm(a, b, j, k));
  return rest;
}

// A cell of diagonal d that cannot pair: qm1 and qm only.
__device__ void inside_rest(const McArgs& a, int b, int i, int d) {
  const int j = i + d;
  const float rest = cell_sum(qm_row(a, b, i, j));
  if (cell_thread() == 0) finish_qm(a, b, i, j, 0.0f, 0.0f, rest);   // qb stem = 0
}

// A pair-allowed cell: qb (hairpin, interior stencil, multiloop closing),
// then qm1 and qm; stores the factors its partners read.
__device__ void inside_pair(const McArgs& a, Smem& sm, int b, int i, int d) {
  const int lane = threadIdx.x & 31, ct = cell_thread(), lp = a.lp, j = i + d;
  const float f = lane < kFactors ? __ldg(a.cellf + rm(a, b, i, j) * kFactors + lane) : 0.0f;
  unsigned gu, gv;
  gates<true>(a, b, i, j, gu, gv);
  const float* K = a.kslot + static_cast<int64_t>(b) * a.nslots;
  const int smax = d - 2 - (kTurn + 1);   // the partner's diagonal d - 2 - s stays > kTurn
  // the stencil, a category at a time
  const int beg[5] = {0, a.s_1n, a.s_23, a.s_tau, a.nslots};
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float acc = 0.0f;
    for (int t = beg[c] + ct; t < beg[c + 1]; t += kCellThreads) {
      const int sl = sm.slots[t], u = sl & 255, v = sl >> 8;
      if (u + v > smax) break;
      const float x = comp(a.ql, dm(a, b, i + 1 + u, j - 1 - v), c) * gate(gu, gv, u, v);
      acc += __ldg(K + t) * x;
    }
    part += acc * __shfl_sync(0xffffffffu, f, kGgen + c);
  }
  // the special slots, a lane each
  if (ct < 7) {
    int u, v;
    special_uv(ct, u, v);
    if (u + v <= smax) {
      const int p = i + 1 + u, q = j - 1 - v;
      const float qbv = __ldcg(a.qbl + dm(a, b, p, q));
      const int tp = __ldg(a.code + rm(a, b, i, j)) & 7;
      const int tp2 = (__ldg(a.code + rm(a, b, p, q)) >> 3) & 7;
      const int* S = a.seq + static_cast<int64_t>(b) * (lp + 2 * kSPad) + kSPad;
      const int si1 = __ldg(S + i + 1), si2 = __ldg(S + i + 2), sj1 = __ldg(S + j - 1),
                sj2 = __ldg(S + j - 2);
      const float* sc = a.scs + static_cast<int64_t>(b) * kSW;
      const float* tb = a.tabs;
      float term;
      switch (ct) {
        case 0:
          term = qbv * __ldg(tb + a.o_stack + tp * 8 + tp2) * __ldg(sc + 0);
          break;
        case 1:
        case 2:
          term = qbv * __ldg(tb + a.o_bulge1) * __ldg(tb + a.o_stack + tp * 8 + tp2) * __ldg(sc + 1);
          break;
        case 3:
          term = qbv * __ldg(tb + a.o_i11 + ((tp * 8 + tp2) * 5 + si1) * 5 + sj1) * __ldg(sc + 2);
          break;
        case 4:
          term = qbv * __ldg(tb + a.o_i21 + (((tp * 8 + tp2) * 5 + si1) * 5 + sj2) * 5 + sj1)
                 * __ldg(sc + 3);
          break;
        case 5:
          term = qbv * __ldg(tb + a.o_i21 + (((tp2 * 8 + tp) * 5 + sj1) * 5 + si1) * 5 + si2)
                 * __ldg(sc + 3);
          break;
        default:
          term = qbv
                 * __ldg(tb + a.o_i22 + ((((tp * 8 + tp2) * 5 + si1) * 5 + si2) * 5 + sj2) * 5 + sj1)
                 * __ldg(sc + 4);
          break;
      }
      part += term * gate(gu, gv, u, v);
    }
  }
  // multiloop closing: qm[i+1][k-1] qm1[k][j-1], k in [i+2, j-1]
  float ml = 0.0f;
#pragma unroll 4
  for (int k = i + 2 + ct; k <= j - 1; k += kCellThreads)
    ml += __ldcg(a.qm + rm(a, b, i + 1, k - 1)) * __ldcg(a.qm1t + rm(a, b, j - 1, k));
  const float rest = cell_sum(qm_row(a, b, i, j));
  const float interior = cell_sum(part);
  ml = cell_sum(ml);
  const float F0 = __shfl_sync(0xffffffffu, f, kFgen), F1 = __shfl_sync(0xffffffffu, f, kF1n),
              F2 = __shfl_sync(0xffffffffu, f, kF23), F3 = __shfl_sync(0xffffffffu, f, kFtau),
              hp0 = __shfl_sync(0xffffffffu, f, kHp), stem = __shfl_sync(0xffffffffu, f, kStem),
              close = __shfl_sync(0xffffffffu, f, kClose), ext = __shfl_sync(0xffffffffu, f, kExt);
  if (ct == 0) {
    const float scb = __ldg(a.sc + b);
    const float hp = hp0 * __ldg(a.sc_pow + static_cast<int64_t>(b) * (lp + 1) + d + 1);
    const float qb = (hp + interior) + ml * close * scb * scb;
    const int64_t o = dm(a, b, i, j);
    a.qbl[o] = qb;
    a.ql[o] = make_float4(qb * F0, qb * F1, qb * F2, qb * F3);
    const float x = qb * ext;
    a.qbx[rm(a, b, i, j)] = x;
    a.qbxt[rm(a, b, j, i)] = x;
    finish_qm(a, b, i, j, qb, stem, rest);
  }
}

// The inside scan: diagonal d's pair-allowed cells from the compact list, a
// warp each; then its other cells' qm1 and qm, a warp each, from the warps
// after those; then the grid barrier.
__global__ void __launch_bounds__(kThreads) inside_kernel(const McArgs a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  load_slots(a, sm);
  __syncthreads();
  const int W = gridDim.x * kCellsPerCta, gw = blockIdx.x * kCellsPerCta + threadIdx.x / kCellThreads;
  for (int d = 1; d < a.maxn; ++d) {
    const int beg = __ldg(a.pair_off + d), cnt = __ldg(a.pair_off + d + 1) - beg;
    for (int k = gw; k < cnt; k += W) {
      const int e = __ldg(a.pairs + beg + k);
      inside_pair(a, sm, e >> 16, e & 0xffff, d);
    }
    const int span = a.maxn - d, total = a.nb * span;
    for (int e = (gw + W - cnt % W) % W; e < total; e += W) {
      const int b = e / span, i = 1 + e % span, j = i + d;
      if (j > __ldg(a.nlen + b)) continue;
      if (d > kTurn && (__ldg(a.code + rm(a, b, i, j)) >> 6)) continue;   // in the list
      inside_rest(a, b, i, d);
    }
    grid.sync();
  }
}

// -------------------------------------------------------------- exterior --
// Block 2b walks q1 of sequence b, block 2b + 1 its qn (see the header).
__global__ void __launch_bounds__(kExtThreads) exterior_kernel(const McArgs a) {
  __shared__ float chain[kMaxCols * kExtThreads];
  const int b = blockIdx.x >> 1, lp = a.lp, T = blockDim.x, tid = threadIdx.x;
  const int n = __ldg(a.nlen + b);
  const float sc = __ldg(a.sc + b);
  const float* gate_u = a.gate_u + static_cast<int64_t>(b) * lp;
  const int64_t base = static_cast<int64_t>(b) * lp * lp;
  float acc[kMaxCols], cur[kMaxCols], nxt[kMaxCols];
#pragma unroll
  for (int r = 0; r < kMaxCols; ++r) acc[r] = cur[r] = nxt[r] = 0.0f;
  for (int c = tid; c < lp; c += T) chain[c] = 0.0f;
  if ((blockIdx.x & 1) == 0) {
    // q1[k+1] = q1[k] sc gate[k+1] + sum_{k' <= k} q1[k'] qbx[k'+1][k+1]
    const float* row = a.qbx + base;
#pragma unroll
    for (int r = 0; r < kMaxCols; ++r) {
      const int c = tid + r * T;
      if (c < lp && n >= 1) nxt[r] = __ldcg(row + lp + c);
    }
    __syncthreads();
    if (tid == 0) chain[0] = 1.0f;
    __syncthreads();
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int r = 0; r < kMaxCols; ++r) {
        cur[r] = nxt[r];
        const int c = tid + r * T;
        if (c < lp && k + 2 <= n) nxt[r] = __ldcg(row + static_cast<int64_t>(k + 2) * lp + c);
      }
      const float qk = chain[k];
#pragma unroll
      for (int r = 0; r < kMaxCols; ++r) {
        const int c = tid + r * T;
        if (c > k && c <= n) acc[r] += qk * cur[r];
        if (c == k + 1) chain[c] = qk * sc * __ldg(gate_u + c) + acc[r];
      }
      __syncthreads();
    }
    for (int c = tid; c < lp; c += T) a.q1[static_cast<int64_t>(b) * lp + c] = chain[c];
    if (tid == 0) a.q[b] = chain[n];
  } else {
    // qn[m-1] = qn[m] sc gate[m-1] + sum_{m' >= m} qbx[m-1][m'-1] qn[m']
    const float* row = a.qbxt + base;
#pragma unroll
    for (int r = 0; r < kMaxCols; ++r) {
      const int c = tid + r * T;
      if (c < lp && n >= 1) nxt[r] = __ldcg(row + static_cast<int64_t>(n) * lp + c);
    }
    __syncthreads();
    if (tid == 0) chain[n + 1] = 1.0f;
    __syncthreads();
    for (int m = n + 1; m >= 2; --m) {
#pragma unroll
      for (int r = 0; r < kMaxCols; ++r) {
        cur[r] = nxt[r];
        const int c = tid + r * T;
        if (c < lp && m - 2 >= 1) nxt[r] = __ldcg(row + static_cast<int64_t>(m - 2) * lp + c);
      }
      const float qm = chain[m];
#pragma unroll
      for (int r = 0; r < kMaxCols; ++r) {
        const int c = tid + r * T;
        if (c >= 1 && c <= m - 1) acc[r] += cur[r] * qm;
        if (c == m - 1) chain[c] = qm * sc * __ldg(gate_u + c) + acc[r];
      }
      __syncthreads();
    }
    for (int c = tid; c < lp; c += T) a.qn[static_cast<int64_t>(b) * lp + c] = chain[c];
  }
}

// --------------------------------------------------------------- outside --
// pout of pair-allowed cell (b, i, i + d) and what its inner partners and the
// accumulators read of it.
__device__ void outside_pair(const McArgs& a, Smem& sm, int b, int i, int d) {
  const int lane = threadIdx.x & 31, ct = cell_thread(), lp = a.lp, j = i + d,
            n = __ldg(a.nlen + b);
  const float f = lane < kFactors ? __ldg(a.cellf + rm(a, b, i, j) * kFactors + lane) : 0.0f;
  unsigned gu, gv;
  gates<false>(a, b, i, j, gu, gv);
  const float* K = a.kslot + static_cast<int64_t>(b) * a.nslots;
  const int umax = i - 2, vmax = n - j - 1;   // the outer pair (i-1-u, j+1+v) inside 1..n
  const int beg[5] = {0, a.s_1n, a.s_23, a.s_tau, a.nslots};
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float acc = 0.0f;
    for (int t = beg[c] + ct; t < beg[c + 1]; t += kCellThreads) {
      const int sl = sm.slots[t], u = sl & 255, v = sl >> 8;
      if (u + v > umax + vmax) break;
      if (u > umax || v > vmax) continue;
      const float x = comp(a.clc, dm(a, b, i - 1 - u, j + 1 + v), c) * gate(gu, gv, u, v);
      acc += __ldg(K + t) * x;
    }
    part += acc * __shfl_sync(0xffffffffu, f, kFgen + c);
  }
  if (ct < 7) {
    int u, v;
    special_uv(ct, u, v);
    if (u <= umax && v <= vmax) {
      const int p = i - 1 - u, q = j + 1 + v;
      const float clv = __ldcg(a.cl + dm(a, b, p, q));
      const int rt = (__ldg(a.code + rm(a, b, i, j)) >> 3) & 7;
      const int tpo = __ldg(a.code + rm(a, b, p, q)) & 7;
      const int* S = a.seq + static_cast<int64_t>(b) * (lp + 2 * kSPad) + kSPad;
      const int si1 = __ldg(S + i - 1), si2 = __ldg(S + i - 2), sj1 = __ldg(S + j + 1),
                sj2 = __ldg(S + j + 2);
      const float* sc = a.scs + static_cast<int64_t>(b) * kSW;
      const float* tb = a.tabs;
      float term;
      switch (ct) {
        case 0:
          term = clv * __ldg(tb + a.o_stack + tpo * 8 + rt) * __ldg(sc + 0);
          break;
        case 1:
        case 2:
          term = clv * __ldg(tb + a.o_bulge1) * __ldg(tb + a.o_stack + tpo * 8 + rt) * __ldg(sc + 1);
          break;
        case 3:
          term = clv * __ldg(tb + a.o_i11 + ((tpo * 8 + rt) * 5 + si1) * 5 + sj1) * __ldg(sc + 2);
          break;
        case 4:
          term = clv * __ldg(tb + a.o_i21 + (((tpo * 8 + rt) * 5 + si1) * 5 + sj1) * 5 + sj2)
                 * __ldg(sc + 3);
          break;
        case 5:
          term = clv * __ldg(tb + a.o_i21 + (((rt * 8 + tpo) * 5 + sj1) * 5 + si2) * 5 + si1)
                 * __ldg(sc + 3);
          break;
        default:
          term = clv
                 * __ldg(tb + a.o_i22 + ((((tpo * 8 + rt) * 5 + si2) * 5 + si1) * 5 + sj1) * 5 + sj2)
                 * __ldg(sc + 4);
          break;
      }
      part += term * gate(gu, gv, u, v);
    }
  }
  // multiloop: (A1 + A2)[i][l] qm[j+1][l-1] + A1[i][l] bs_seg[j+1][l-1], l in (j, n]
  float ml = 0.0f;
#pragma unroll 4
  for (int l = j + 1 + ct; l <= n; l += kCellThreads) {
    const float a1 = __ldcg(a.a1 + rm(a, b, i, l)), a2 = __ldcg(a.a2 + rm(a, b, i, l));
    ml += (a1 + a2) * __ldcg(a.qm + rm(a, b, j + 1, l - 1))
          + a1 * __ldg(a.bs_seg + rm(a, b, j + 1, l - 1));
  }
  const float w_int = cell_sum(part);
  ml = cell_sum(ml);
  const float G0 = __shfl_sync(0xffffffffu, f, kGgen), G1 = __shfl_sync(0xffffffffu, f, kG1n),
              G2 = __shfl_sync(0xffffffffu, f, kG23), G3 = __shfl_sync(0xffffffffu, f, kGtau),
              stem = __shfl_sync(0xffffffffu, f, kStem), close = __shfl_sync(0xffffffffu, f, kClose),
              ext = __shfl_sync(0xffffffffu, f, kExt);
  if (ct == 0) {
    const int64_t o = dm(a, b, i, j);
    const float q1 = __ldcg(a.q1 + static_cast<int64_t>(b) * lp + i - 1);
    const float qn = __ldcg(a.qn + static_cast<int64_t>(b) * lp + j + 1);
    const float w_ext = q1 * qn * ext / __ldcg(a.q + b);
    const float qb = __ldcg(a.qbl + o);
    const float p = qb * ((w_ext + w_int) + ml * stem);
    a.pout[rm(a, b, i, j)] = p;
    const float cint = p / (qb > 0.0f ? qb : 1.0f);
    const float scb = __ldg(a.sc + b);
    a.cl[o] = cint;
    a.clc[o] = make_float4(cint * G0, cint * G1, cint * G2, cint * G3);
    a.cm[o] = cint * close * scb * scb;
  }
}

// Diagonal d + 1's accumulator update, over its compact list, spread over the
// grid's threads from the last CTA down (the first CTAs hold the diagonal's
// cells): for each outer pair (k, l = k + d + 1) with C != 0 and k < i' < l,
// A1[i'][l] += C qm[k+1][i'-1] and A2[i'][l] += C bs_seg[k+1][i'-1].
__device__ void outside_update(const McArgs& a, int d) {
  const int e0 = __ldg(a.pair_off + d + 1), cnt = __ldg(a.pair_off + d + 2) - e0;
  const int64_t items = static_cast<int64_t>(cnt) * d;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kThreads + threadIdx.x;
       e < items; e += stride) {
    const int code = __ldg(a.pairs + e0 + static_cast<int>(e / d));
    const int b = code >> 16, k = code & 0xffff, ip = k + 1 + static_cast<int>(e % d);
    const int l = k + d + 1;
    const float c = __ldcg(a.cm + dm(a, b, k, l));
    if (c != 0.0f) {
      const int64_t src = rm(a, b, k + 1, ip - 1), dst = rm(a, b, ip, l);
      a.a1[dst] = __ldcg(a.a1 + dst) + c * __ldcg(a.qm + src);
      a.a2[dst] = __ldcg(a.a2 + dst) + c * __ldg(a.bs_seg + src);
    }
  }
}

// The outside scan: diagonal d's pair-allowed cells from the compact list, a
// warp each, and diagonal d + 1's accumulator update; then the grid barrier.
__global__ void __launch_bounds__(kThreads) outside_kernel(const McArgs a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  load_slots(a, sm);
  __syncthreads();
  const int W = gridDim.x * kCellsPerCta, gw = blockIdx.x * kCellsPerCta + threadIdx.x / kCellThreads;
  for (int d = a.maxn - 1; d >= 1; --d) {
    const int beg = __ldg(a.pair_off + d), cnt = __ldg(a.pair_off + d + 1) - beg;
    for (int k = gw; k < cnt; k += W) {
      const int e = __ldg(a.pairs + beg + k);
      outside_pair(a, sm, e >> 16, e & 0xffff, d);
    }
    if (d + 1 < a.maxn) outside_update(a, d);
    grid.sync();
  }
}

// Grid barriers and nothing else: `barrier_probe` times the scans' floor.
__global__ void __launch_bounds__(kThreads) barrier_kernel(int steps) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < steps; ++k) grid.sync();
}

// The grid of a scan: as many CTAs of `kernel` as the current card holds at
// once, at most `work` and at least 1.  Refused where the card cannot launch
// cooperatively.
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

// The CTAs diagonal 1's cells need.
int scan_work(const McArgs& a) {
  const int64_t cells = static_cast<int64_t>(a.nb) * (a.maxn > 1 ? a.maxn - 1 : 1);
  return static_cast<int>((cells + kCellsPerCta - 1) / kCellsPerCta);
}

bool valid(const McArgs& a) {
  return a.nb >= 1 && a.nb < 32768 && a.lp >= 2 && a.lp <= kMaxCols * kExtThreads &&
         a.lp < 65536 && a.maxn >= 1 && a.maxn <= a.lp - 2 && a.nslots <= kMaxSlots;
}

template <typename Kernel>
int launch_scan(Kernel kernel, const McArgs* args, cudaStream_t stream) {
  McArgs a = *args;
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 1;
  cudaError_t e = scan_grid(kernel, scan_work(a), &grid);
  if (e == cudaSuccess) {
    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), params, 0, stream);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// Launchers: inside and outside are one cooperative launch each, exterior one
// launch; each returns the launch error (ops/mccaskill_cuda.py raises).

extern "C" int dafs_mccaskill_inside(const McArgs* args, cudaStream_t stream) {
  return launch_scan(inside_kernel, args, stream);
}

extern "C" int dafs_mccaskill_exterior(const McArgs* args, cudaStream_t stream) {
  const McArgs a = *args;
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = a.lp >= kExtThreads ? kExtThreads : (a.lp + 31) / 32 * 32;
  exterior_kernel<<<2 * a.nb, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafs_mccaskill_outside(const McArgs* args, cudaStream_t stream) {
  return launch_scan(outside_kernel, args, stream);
}

// The grid of the inside (outside = 0) or the outside scan for these
// arguments on the current card, written to *grid.
extern "C" int dafs_mccaskill_grid(const McArgs* args, int outside, int* grid) {
  const int work = scan_work(*args);
  return static_cast<int>(outside ? scan_grid(outside_kernel, work, grid)
                                  : scan_grid(inside_kernel, work, grid));
}

// The scans' floor: one cooperative launch of `blocks` CTAs (a scan's grid)
// that passes `steps` grid barriers and computes nothing.
extern "C" int dafs_mccaskill_barrier_probe(int blocks, int steps, cudaStream_t stream) {
  void* params[] = {&steps};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_kernel), dim3(blocks), dim3(kThreads), params, 0,
      stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
