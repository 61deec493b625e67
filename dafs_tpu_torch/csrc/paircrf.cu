// CONTRAlign 5-state pair-CRF: the forward pass, the backward pass and the
// match posteriors behind them, designed for Hopper.
//
// Replaces no Pallas kernel: dafs_tpu computes the pair-CRF as XLA scans
// (dafs_tpu/ops/paircrf.py::forward_backward_posterior, :58; fwd_step :88,
// bwd_step :209, the posterior :296), and the port ran it as plain PyTorch
// on the card, a Python loop over the anti-diagonals of some 1160 launches
// a diagonal.  The plain version stays in ops/paircrf.py for CPU tensors,
// and these kernels equal it bit for bit on the card: every expression of
// ops/paircrf.py is evaluated as written, brackets included, with the same
// LOG_ADD order per target state and the same where-gates and NEG fills,
// and the library is built with -fmad=false.  Fast_LogPlusEquals and
// Fast_Exp choose their piece's coefficients by compare and select and
// evaluate one cubic, the one the plain version selects after evaluating
// every piece.  Above 0, Fast_Exp takes expf; every term is then at least
// 1 and the clamp of the sum to 1 absorbs its last bit.
//
// What bounds it on an H100.  Not bytes and not operations: a family of 105
// pairs at L <= 96 is a few million cells of some 600 (forward) and 750
// (backward) instructions, well under a millisecond of the card.  The chain
// of len1 + len2 + 1 anti-diagonals bounds it, each waiting for the one
// before: per diagonal the backward M value is four dependent log-adds
// after the hand-over between neighbouring rows (the forward's M chain is
// four log-adds over two diagonals, its X and Y chains two over one).
// dafs_paircrf_floor_probe runs the backward chain alone; chip_smoke.py
// prints its time beside the kernels'.
//
// The design is the pair-HMM's K1/K2 (csrc/pairhmm.cu), one thread block per
// sequence pair and pass:
//
// - A lane owns one row i and walks the anti-diagonals d = i + j.  It keeps
//   its five states (M, IX, IY, I2X, I2Y) of the last diagonal in registers
//   and, forward, the row above's five of the two diagonals before (the
//   X inserts read (i - 1, j) on d - 1, MATCH reads (i - 1, j - 1) on d - 2:
//   five __shfl_up_sync a step, the d - 2 values kept from the step before).
//   Backward it needs row i + 1's IX and I2X on d + 1 and its M on d + 2
//   (three __shfl_down_sync a step, M kept), and its own IY and I2Y on d + 1.
// - Warps walk the diagonals in step, a block barrier between two
//   diagonals; the edge row of a warp reaches the next warp through one of
//   two slots in shared memory.
// - Only live work: the loop runs over the pair's len1 + len2 + 1 diagonals,
//   a warp computes on those that cross its rows, warps beyond len1 leave
//   before the loop.  A cell within the lengths reads only cells within
//   them or cells the plain version holds at NEG (negative indices, rows or
//   columns past the lengths), which the registers hold at NEG too.
// - The forward pass stores all five states of every cell within the
//   lengths, the backward pass only M; the posterior kernel reads
//   F[k](i - 1, j - 1) and B[M](i, j) inside the lengths only, forms Z from
//   the forward's end cell (the five states log-added in the order 0..4)
//   and writes clamp(sum over k of Fast_Exp(...), 0, 1), masked to the true
//   lengths, coalesced along j.  ops/paircrf_cuda.py launches the two passes
//   on two streams, so that they run side by side, and this kernel behind
//   both.
//
// Strips: a block has at most 1024 threads, so from imax 1025 up to the
// ceiling of 4096 in ops/paircrf_cuda.py the block walks the rows in strips
// of 1024, one after another (the first strip first forward, the last first
// backward), each strip as above.  Between strips the edge row goes through
// global memory, as in dafs_pairhmm_forward_long: its values of every column
// in a buffer of W entries of two float4.  Up to 1024 rows the same code
// runs one strip and never touches that buffer.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int M_ = 0, IX = 1, IY = 2, I2X = 3, I2Y = 4;

// NEG_INF (-2e20), the Fast_LogPlusEquals cut NEG_INF / 2 (-1e20) and the
// end of Fast_LogExpPlusOne's range (11.8624794162), as float32
constexpr float NEG = -0x1.5af1d8p+67f;
constexpr float kHalfNeg = -0x1.5af1d8p+66f;
constexpr float kLepoMax = 0x1.7b996ep+3f;

// Fast_LogExpPlusOne: log(exp(x) + 1) for 0 <= x <= 11.8624794162, the
// cubic of the first piece whose upper bound exceeds x (ops/logspace.py
// LEPO_PIECES, contra_fast_logexpplusone).
__device__ __forceinline__ float contra_lepo(float x) {
  const bool p0 = x < 0x1.52b4f2p-1f, p1 = x < 0x1.a1cbcap+0f, p2 = x < 0x1.3ee192p+1f,
             p3 = x < 0x1.b08b44p+1f, p4 = x < 0x1.1b465ap+2f, p5 = x < 0x1.728024p+2f,
             p6 = x < 0x1.f43ddp+2f;
  const float a = p0 ? -0x1.addc7p-8f : p1 ? -0x1.fc6b98p-7f : p2 ? -0x1.a668eap-7f
                : p3 ? -0x1.d8cb46p-8f : p4 ? -0x1.9c4aa8p-9f : p5 ? -0x1.090bbep-10f
                : p6 ? -0x1.9b9ff2p-13f : -0x1.7e801ap-17f;
  const float b = p0 ? 0x1.056a5cp-3f : p1 ? 0x1.284cb6p-3f : p2 ? 0x1.0a735ap-3f
                : p3 ? 0x1.6770d4p-4f : p4 ? 0x1.7ec11ep-5f : p5 ? 0x1.30a652p-6f
                : p6 ? 0x1.2e04cep-8f : 0x1.879d6cp-12f;
  const float c = p0 ? 0x1.ffa5aep-2f : p1 ? 0x1.f40356p-2f : p2 ? 0x1.07b34ep-1f
                : p3 ? 0x1.3de2c8p-1f : p4 ? 0x1.84bcd6p-1f : p5 ? 0x1.c42f42p-1f
                : p6 ? 0x1.ed486ep-1f : 0x1.fde802p-1f;
  const float d = p0 ? 0x1.62e51cp-1f : p1 ? 0x1.64411ep-1f : p2 ? 0x1.5bef1ap-1f
                : p3 ? 0x1.2e934ep-1f : p4 ? 0x1.bd510ap-2f : p5 ? 0x1.026d2ap-2f
                : p6 ? 0x1.92b2a2p-4f : 0x1.eb0b88p-7f;
  return ((a * x + b) * x + c) * x + d;
}

// Fast_LogPlusEquals (ops/logspace.contra_fast_logplus): with hi >= lo, hi
// if lo <= NEG_INF / 2 or hi - lo >= 11.8624794162, else
// Fast_LogExpPlusOne(hi - lo) + lo.  Symmetric in its operands.
__device__ __forceinline__ float contra_lse(float x, float y) {
  const float hi = fmaxf(x, y);
  const float lo = fminf(x, y);
  const float d = hi - lo;
  const float approx = contra_lepo(fminf(d, kLepoMax)) + lo;
  return (lo <= kHalfNeg || d >= kLepoMax) ? hi : approx;
}

// Fast_Exp (ops/logspace.contra_fast_exp): 0 below -9.91152, below 0 the
// cubic of the first piece whose upper bound exceeds x, above 0 expf (1e20
// past 46.052).
__device__ __forceinline__ float contra_fast_exp(float x) {
  const bool p0 = x < -0x1.772fa2p+2f, p1 = x < -0x1.eb7a14p+1f, p2 = x < -0x1.3ee996p+1f,
             p3 = x < -0x1.7b0482p+0f, p4 = x < -0x1.58529ep-1f;
  const float a = p0 ? 0x1.5128bcp-14f : p1 ? 0x1.6c1a48p-10f : p2 ? 0x1.da0f02p-8f
                : p3 ? 0x1.7cc7f8p-6f : p4 ? 0x1.d60af8p-5f : 0x1.eb2eb6p-4f;
  const float b = p0 ? 0x1.1b799cp-9f : p1 ? 0x1.90e0cp-6f : p2 ? 0x1.731944p-4f
                : p3 ? 0x1.ab23eap-3f : p4 ? 0x1.6e9e54p-2f : 0x1.ed1fdap-2f;
  const float c = p0 ? 0x1.3f02bp-6f : p1 ? 0x1.2d52p-3f : p2 ? 0x1.97deep-2f
                : p3 ? 0x1.619b26p-1f : p4 ? 0x1.d30084p-1f : 0x1.fec552p-1f;
  const float d = p0 ? 0x1.e1c152p-5f : p1 ? 0x1.379412p-2f : p2 ? 0x1.3fcb0ap-1f
                : p3 ? 0x1.bc88fp-1f : p4 ? 0x1.f56804p-1f : 0x1.fff984p-1f;
  const float poly = ((a * x + b) * x + c) * x + d;
  const float above = x > 0x1.706a7ep+5f ? 0x1.5af1d8p+66f : expf(x);
  return x < -0x1.3d2b2cp+3f ? 0.0f : x < 0.0f ? poly : above;
}

// The tables as the wrapper hands them over, each a device pointer.
struct TablePtrs {
  const float* match;   // 5 x 5
  const float* ins;     // 5
  const float* single;  // 5
  const float* pair;    // 5 x 5
};

// The tables in shared memory; me is the ScoreMatch emission
// match[a][b] + single[MATCH], as the plain version adds it.
struct Tables {
  float me[25];
  float ins[5];
  float single[5];
  float pair[25];
};
constexpr int kTab = 60;

__device__ __forceinline__ float P(const Tables* T, int src, int dst) {
  return T->pair[5 * src + dst];
}

// What one pass keeps in shared memory: two hand-over slots per warp (the
// edge row's values of the last two diagonals, two float4 each), the
// tables, codes2.
struct Shared {
  float4* edge;
  Tables* T;
  int* c2;
};

__host__ __device__ inline size_t shared_bytes(int nwarps, int W) {
  return sizeof(float4) * 4 * nwarps + sizeof(float) * kTab + sizeof(int) * W;
}

__device__ __forceinline__ Shared carve(float4* smem, int nwarps) {
  Shared s;
  s.edge = smem;
  s.T = reinterpret_cast<Tables*>(smem + 4 * nwarps);
  s.c2 = reinterpret_cast<int*>(reinterpret_cast<float*>(s.T) + kTab);
  return s;
}

// Stages the tables and codes2 (W entries); leaves the barrier to the caller.
__device__ __forceinline__ void stage(Tables* T, int* c2, const TablePtrs& tab,
                                      const int* codes2, int W) {
  for (int k = threadIdx.x; k < 25; k += blockDim.x) {
    T->me[k] = tab.match[k] + tab.single[M_];
    T->pair[k] = tab.pair[k];
  }
  for (int k = threadIdx.x; k < 5; k += blockDim.x) {
    T->ins[k] = tab.ins[k];
    T->single[k] = tab.single[k];
  }
  for (int k = threadIdx.x; k < W; k += blockDim.x) c2[k] = codes2[k];
}

// The barrier between two diagonals, for the warps with rows within len1.
__device__ __forceinline__ void diagonal_barrier(int nlive) {
  if (nlive > 1) asm volatile("bar.sync 1, %0;\n" :: "r"(32 * nlive) : "memory");
}

__device__ __forceinline__ int code_at(const int* c2, int j, int l2max) {
  return c2[min(max(j, 0), l2max)];
}

__device__ __forceinline__ void put5(float4* dst, const float v[5]) {
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void get5(const float4* src, float v[5]) {
  const float4 a = src[0], b = src[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
}

__device__ __forceinline__ void fill5(float v[5], float x) {
#pragma unroll
  for (int k = 0; k < 5; ++k) v[k] = x;
}

// ------------------------------------------------------------- forward --

// A forward lane's constants: the X-insert terms of its row, which the
// plain version adds as ins[x_i] + (single[state] + pair[src][dst]) (em).
struct FwdRow {
  float eXM, eXX, eXY;  // into INS_X from M, IX, IY
  float e2M, e22, e2Y;  // into INS2_X from M, I2X, I2Y
  float ex1, ex2;       // ins[x_i] + single[INS_X], + single[INS2_X]
};

__device__ __forceinline__ FwdRow forward_row(const Tables* T, int c1) {
  const float EX = T->ins[c1];
  const float sX = T->single[IX], s2X = T->single[I2X];
  FwdRow r;
  r.eXM = EX + (sX + P(T, M_, IX));
  r.eXX = EX + (sX + P(T, IX, IX));
  r.eXY = EX + (sX + P(T, IY, IX));
  r.e2M = EX + (s2X + P(T, M_, I2X));
  r.e22 = EX + (s2X + P(T, I2X, I2X));
  r.e2Y = EX + (s2X + P(T, I2Y, I2X));
  r.ex1 = EX + sX;
  r.ex2 = EX + s2X;
  return r;
}

// One forward cell (i, j), j = d - i, as ops/paircrf.py's forward loop: p,
// the row above on d - 2, cell (i - 1, j - 1); q, the row above on d - 1,
// cell (i - 1, j); s, this row on d - 1, cell (i, j - 1), becomes (i, j).
// me_d: the ScoreMatch emission of (i, j); ey_d: ins[y_j].  Returns whether
// (i, j) lies within the lengths.  Both forward passes run this.
__device__ __forceinline__ bool forward_cell(const Tables* T, const FwdRow& r, int i, int j,
                                             int n1, int n2, float me_d, float ey_d,
                                             const float p[5], const float q[5], float s[5]) {
  const bool valid = i <= n1 && j >= 0 && j <= n2;
  const bool not_first = i > 1 || j > 1;

  // MATCH from (i - 1, j - 1), sources M, IX, IY, I2X, I2Y; pair dropped at (1, 1)
  const float pr = (i == 1 && j == 1) ? 0.0f : 1.0f;
  float m = p[M_] + (me_d + pr * P(T, M_, M_));
  if (not_first) {
    m = contra_lse(m, p[IX] + (me_d + P(T, IX, M_)));
    m = contra_lse(m, p[IY] + (me_d + P(T, IY, M_)));
    m = contra_lse(m, p[I2X] + (me_d + P(T, I2X, M_)));
    m = contra_lse(m, p[I2Y] + (me_d + P(T, I2Y, M_)));
  }
  if (!(valid && i > 0 && j > 0)) m = NEG;

  // INS_X / INS2_X from (i - 1, j); the column j == 0 chains IX / I2X
  // only; pair dropped at (1, 0)
  const float prx = (i == 1 && j == 0) ? 0.0f : 1.0f;
  float x, x2;
  if (j > 0) {
    x = contra_lse(contra_lse(q[M_] + r.eXM, q[IX] + r.eXX), q[IY] + r.eXY);
    x2 = contra_lse(contra_lse(q[M_] + r.e2M, q[I2X] + r.e22), q[I2Y] + r.e2Y);
  } else {
    x = q[IX] + (r.ex1 + prx * P(T, IX, IX));
    x2 = q[I2X] + (r.ex2 + prx * P(T, I2X, I2X));
  }
  if (!(valid && i > 0)) {
    x = NEG;
    x2 = NEG;
  }

  // INS_Y / INS2_Y from (i, j - 1); the row i == 0 chains IY / I2Y only;
  // pair dropped at (0, 1)
  const float pry = (i == 0 && j == 1) ? 0.0f : 1.0f;
  const float ey1 = ey_d + T->single[IY];
  const float ey2 = ey_d + T->single[I2Y];
  float y, y2;
  if (i > 0) {
    y = contra_lse(contra_lse(s[M_] + (ey1 + P(T, M_, IY)), s[IX] + (ey1 + P(T, IX, IY))),
                   s[IY] + (ey1 + P(T, IY, IY)));
    y2 = contra_lse(contra_lse(s[M_] + (ey2 + P(T, M_, I2Y)), s[I2X] + (ey2 + P(T, I2X, I2Y))),
                    s[I2Y] + (ey2 + P(T, I2Y, I2Y)));
  } else {
    y = s[IY] + (ey1 + pry * P(T, IY, IY));
    y2 = s[I2Y] + (ey2 + pry * P(T, I2Y, I2Y));
  }
  if (!(valid && j > 0)) {
    y = NEG;
    y2 = NEG;
  }

  s[M_] = m;
  s[IX] = x;
  s[IY] = y;
  s[I2X] = x2;
  s[I2Y] = y2;
  if (i == 0 && j == 0) fill5(s, 0.0f);  // the origin: all states 0
  if (!valid) fill5(s, NEG);
  return valid;
}

__device__ __forceinline__ void store5(float* F, size_t plane, size_t at, const float s[5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) F[k * plane + at] = s[k];
}

// The forward pass in strips of blockDim.x rows, one after another: one
// strip up to 1024 rows, more above.  E: two rows of W entries of two
// float4 (unused with one strip); strip s leaves its last row's five states
// in E[s & 1] for the next strip's first lane.
__device__ __forceinline__ void forward_pass(const int* __restrict__ codes1,
                                             const int* __restrict__ codes2, const TablePtrs& tab,
                                             float* __restrict__ F, float4* E, int n1, int n2,
                                             int imax, int l2max, float4* smem) {
  const int W = l2max + 1;
  const size_t plane = static_cast<size_t>(imax) * W;
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = blockDim.x;
  const Shared sh = carve(smem, nw);
  stage(sh.T, sh.c2, tab, codes2, W);
  __syncthreads();
  const Tables* T = sh.T;

  for (int row0 = 0; row0 <= n1; row0 += R) {
    const int strip = row0 / R;
    const float4* Ein = E + 2 * ((strip + 1) & 1) * W;  // the strip before's last row
    float4* Eout = E + 2 * (strip & 1) * W;
    const int rb = row0 + 32 * w, rl = rb + 31;
    const int nlive = min(nw, (n1 - row0) / 32 + 1);
    const int dlast = min(row0 + R - 1, n1) + n2;
    if (rb <= n1) {
      const int i = rb + lane;
      const bool next_live = rl < n1;
      const bool last_warp = w == nw - 1;
      const int de = min(rl, n1) + n2;
      const int c1 = i < imax ? codes1[i] : 4;
      const float* me_row = T->me + 5 * c1;
      const FwdRow r = forward_row(T, c1);
      float s[5], p[5];
      fill5(s, NEG);
      fill5(p, NEG);
      for (int d = row0; d <= dlast; ++d) {
        if (d < rb || d > de) {
          diagonal_barrier(nlive);
          continue;
        }
        const int j = d - i;
        const int cj = code_at(sh.c2, j, l2max);
        const float me_d = me_row[cj];
        const float ey_d = T->ins[cj];

        // the row above on d - 1: the lane before, the warp before's slot,
        // or the strip before through E
        float q[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) q[k] = __shfl_up_sync(kFull, s[k], 1);
        if (lane == 0) {
          if (d <= rb + n2 && w > 0) {
            get5(sh.edge + 2 * (2 * (w - 1) + ((d - 1) & 1)), q);
          } else if (d <= rb + n2 && row0 > 0) {
            get5(Ein + 2 * (d - rb), q);
          } else {
            fill5(q, NEG);
          }
        }

        if (forward_cell(T, r, i, j, n1, n2, me_d, ey_d, p, q, s))
          store5(F, plane, static_cast<size_t>(i) * W + j, s);
#pragma unroll
        for (int k = 0; k < 5; ++k) p[k] = q[k];

        if (lane == 31 && next_live && d >= rl) {  // row rl has a cell on d
          if (last_warp) {
            put5(Eout + 2 * (d - rl), s);
          } else {
            put5(sh.edge + 2 * (2 * w + (d & 1)), s);
          }
        }
        diagonal_barrier(nlive);
      }
    }
    __syncthreads();  // E and the slots are complete before the next strip
  }
}

// ------------------------------------------------------------ backward --

// A backward lane's constants: the terms of row i + 1's X inserts, which
// the plain version adds as ins[x_{i+1}] + (single[state] + pair[src][dst])
// (em of EX_next), and ins[x_{i+1}] + single[INS_X | INS2_X].
struct BwdRow {
  float eXM, eXY;  // from INS_X (i + 1, j) into M, IY
  float e2M, e2Y;  // from INS2_X (i + 1, j) into M, I2Y
  float ex1n, ex2n;
};

__device__ __forceinline__ BwdRow backward_row(const Tables* T, int c1n) {
  const float EXn = T->ins[c1n];
  const float sX = T->single[IX], s2X = T->single[I2X];
  BwdRow r;
  r.eXM = EXn + (sX + P(T, M_, IX));
  r.eXY = EXn + (sX + P(T, IY, IX));
  r.e2M = EXn + (s2X + P(T, M_, I2X));
  r.e2Y = EXn + (s2X + P(T, I2Y, I2X));
  r.ex1n = EXn + sX;
  r.ex2n = EXn + s2X;
  return r;
}

// One backward cell (i, j), j = d - i, as ops/paircrf.py's backward loop:
// s, this row on d + 1, cell (i, j + 1), becomes (i, j); dX, dX2, row
// i + 1's IX and I2X on d + 1, cell (i + 1, j); nM2, row i + 1's M on
// d + 2, cell (i + 1, j + 1).  me_n: the ScoreMatch emission of
// (i + 1, j + 1); ey_n: ins[y_{j+1}].  LOG_ADD order per target as the
// plain version: M: match, insX, ins2X, insY, ins2Y; IX, IY: match, insX,
// insY; I2X, I2Y: match, ins2X, ins2Y.  Returns whether (i, j) lies within
// the lengths.  Both backward passes run this.
__device__ __forceinline__ bool backward_cell(const Tables* T, const BwdRow& r, int i, int j,
                                              int n1, int n2, float me_n, float ey_n, float dX,
                                              float dX2, float nM2, float s[5]) {
  const bool valid = i <= n1 && j >= 0 && j <= n2;
  // the successors are the gated first cells exactly when (i, j) == (0, 0)
  const float g00 = (i == 0 && j == 0) ? 0.0f : 1.0f;
  const bool has_m = i < n1 && j < n2;
  const bool has_m_nf = has_m && (i + 1 > 1 || j + 1 > 1);
  const bool has_x = i < n1;
  const bool has_y = j < n2;
  const bool x_in = has_x && j != 0;
  const bool y_in = has_y && i != 0;
  const float ey1n = ey_n + T->single[IY];
  const float ey2n = ey_n + T->single[I2Y];
  const float sIY = s[IY], sI2Y = s[I2Y];

  // from match (i + 1, j + 1).  The plain version log-adds into NEG here:
  // Fast_LogPlusEquals of NEG and v is max(NEG, v) exactly (the smaller
  // operand is at most NEG <= NEG_INF / 2, which returns the larger).
  const float mterm = nM2 + me_n;
  float bM = has_m ? fmaxf(NEG, mterm + g00 * P(T, M_, M_)) : NEG;
  float bX = has_m_nf ? fmaxf(NEG, mterm + P(T, IX, M_)) : NEG;
  float bY = has_m_nf ? fmaxf(NEG, mterm + P(T, IY, M_)) : NEG;
  float bX2 = has_m_nf ? fmaxf(NEG, mterm + P(T, I2X, M_)) : NEG;
  float bY2 = has_m_nf ? fmaxf(NEG, mterm + P(T, I2Y, M_)) : NEG;
  // from insX (i + 1, j)
  if (x_in) bM = contra_lse(bM, dX + r.eXM);
  if (has_x) bX = contra_lse(bX, dX + (r.ex1n + g00 * P(T, IX, IX)));
  if (x_in) bY = contra_lse(bY, dX + r.eXY);
  // from ins2X (i + 1, j)
  if (x_in) bM = contra_lse(bM, dX2 + r.e2M);
  if (has_x) bX2 = contra_lse(bX2, dX2 + (r.ex2n + g00 * P(T, I2X, I2X)));
  if (x_in) bY2 = contra_lse(bY2, dX2 + r.e2Y);
  // from insY (i, j + 1)
  if (y_in) bM = contra_lse(bM, sIY + (ey1n + P(T, M_, IY)));
  if (y_in) bX = contra_lse(bX, sIY + (ey1n + P(T, IX, IY)));
  if (has_y) bY = contra_lse(bY, sIY + (ey1n + g00 * P(T, IY, IY)));
  // from ins2Y (i, j + 1)
  if (y_in) bM = contra_lse(bM, sI2Y + (ey2n + P(T, M_, I2Y)));
  if (y_in) bX2 = contra_lse(bX2, sI2Y + (ey2n + P(T, I2X, I2Y)));
  if (has_y) bY2 = contra_lse(bY2, sI2Y + (ey2n + g00 * P(T, I2Y, I2Y)));

  s[M_] = bM;
  s[IX] = bX;
  s[IY] = bY;
  s[I2X] = bX2;
  s[I2Y] = bY2;
  if (i == n1 && j == n2) fill5(s, 0.0f);  // the end cell: all states 0
  if (!valid) fill5(s, NEG);
  return valid;
}

// The backward pass in strips of blockDim.x rows from the last one up.
// Strip s leaves its first row's M, IX and I2X in E[s & 1] for the strip
// above's last lane (unused with one strip).
__device__ __forceinline__ void backward_pass(const int* __restrict__ codes1,
                                              const int* __restrict__ codes2,
                                              const TablePtrs& tab, float* __restrict__ Bm,
                                              float4* E, int n1, int n2, int imax, int l2max,
                                              float4* smem) {
  const int W = l2max + 1;
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = blockDim.x;
  const Shared sh = carve(smem, nw);
  stage(sh.T, sh.c2, tab, codes2, W);
  __syncthreads();
  const Tables* T = sh.T;

  for (int row0 = n1 / R * R; row0 >= 0; row0 -= R) {
    const int strip = row0 / R;
    const float4* Ein = E + 2 * ((strip + 1) & 1) * W;  // the strip after's first row
    float4* Eout = E + 2 * (strip & 1) * W;
    const int rb = row0 + 32 * w, rl = rb + 31;
    const int nlive = min(nw, (n1 - row0) / 32 + 1);
    const int dtop = min(row0 + R - 1, n1) + n2;
    if (rb <= n1) {
      const int i = rb + lane;
      const bool next_live = rl < n1;
      const bool last_warp = w == nw - 1;
      const int de = min(rl, n1) + n2;
      const int c1n = i + 1 < imax ? codes1[i + 1] : 4;
      const float* me_row = T->me + 5 * c1n;
      const BwdRow r = backward_row(T, c1n);
      float s[5];
      float nM2 = NEG;
      fill5(s, NEG);
      for (int d = dtop; d >= row0; --d) {
        if (d < rb || d > de) {
          diagonal_barrier(nlive);
          continue;
        }
        const int j = d - i;
        const int cjn = code_at(sh.c2, j + 1, l2max);
        const float me_n = me_row[cjn];
        const float ey_n = T->ins[cjn];

        // the row below on d + 1: the lane after, the warp after's slot, or
        // the strip after through E
        float dM = __shfl_down_sync(kFull, s[M_], 1);
        float dX = __shfl_down_sync(kFull, s[IX], 1);
        float dX2 = __shfl_down_sync(kFull, s[I2X], 1);
        if (lane == 31) {
          if (next_live && d >= rl && d <= rl + n2) {
            const float4 e = last_warp ? Ein[2 * (d - rl)]
                                       : sh.edge[2 * (2 * (w + 1) + ((d + 1) & 1))];
            dM = e.x;
            dX = e.y;
            dX2 = e.z;
          } else {
            dM = dX = dX2 = NEG;
          }
        }

        if (backward_cell(T, r, i, j, n1, n2, me_n, ey_n, dX, dX2, nM2, s))
          Bm[static_cast<size_t>(i) * W + j] = s[M_];
        nM2 = dM;

        if (lane == 0 && d <= rb + n2) {  // row rb has a cell on d
          const float4 v = make_float4(s[M_], s[IX], s[I2X], 0.0f);
          if (w > 0) {
            sh.edge[2 * (2 * w + (d & 1))] = v;
          } else if (row0 > 0) {
            Eout[2 * (d - rb)] = v;
          }
        }
        diagonal_barrier(nlive);
      }
    }
    __syncthreads();  // E and the slots are complete before the next strip
  }
}

// ------------------------------------------------------------- kernels --

// edge: B * 2 * (l2max + 1) entries of two float4 for the hand-over between
// strips, or null when imax <= 1024 (one strip).
__global__ void __launch_bounds__(1024)
paircrf_forward_kernel(const int* __restrict__ codes1, const int* __restrict__ len1,
                       const int* __restrict__ codes2, const int* __restrict__ len2,
                       TablePtrs tab, float* __restrict__ F, float4* __restrict__ edge, int imax,
                       int l2max) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x;
  const size_t W = l2max + 1;
  forward_pass(codes1 + static_cast<size_t>(b) * imax, codes2 + b * W, tab,
               F + static_cast<size_t>(b) * 5 * imax * W, edge ? edge + b * 4 * W : nullptr,
               min(len1[b], imax - 1), min(len2[b], l2max), imax, l2max, smem);
}

__global__ void __launch_bounds__(1024)
paircrf_backward_kernel(const int* __restrict__ codes1, const int* __restrict__ len1,
                        const int* __restrict__ codes2, const int* __restrict__ len2,
                        TablePtrs tab, float* __restrict__ Bm, float4* __restrict__ edge,
                        int imax, int l2max) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x;
  const size_t W = l2max + 1;
  backward_pass(codes1 + static_cast<size_t>(b) * imax, codes2 + b * W, tab,
                Bm + static_cast<size_t>(b) * imax * W, edge ? edge + b * 4 * W : nullptr,
                min(len1[b], imax - 1), min(len2[b], l2max), imax, l2max, smem);
}

// ----------------------------------------------------------- posterior --

constexpr int kPostThreads = 256;

// Z and the match posteriors (InferenceEngine.ipp:1252-1257, 1280-1307) as
// ops/paircrf.py: blocks (b, y) share the rows of pair b, a warp a row, the
// lanes along j.  Reads F and Bm inside the lengths only.
__global__ void __launch_bounds__(kPostThreads)
paircrf_posterior_kernel(const float* __restrict__ F, const float* __restrict__ Bm,
                         const int* __restrict__ codes1, const int* __restrict__ len1,
                         const int* __restrict__ codes2, const int* __restrict__ len2,
                         TablePtrs tab, float* __restrict__ post, int imax, int l2max) {
  __shared__ Tables T;
  const int b = blockIdx.x;
  const int W = l2max + 1;
  const size_t plane = static_cast<size_t>(imax) * W;
  const int n1 = min(len1[b], imax - 1), n2 = min(len2[b], l2max);
  stage(&T, nullptr, tab, codes2, 0);
  __syncthreads();

  const float* f = F + static_cast<size_t>(b) * 5 * plane;
  const float* g = Bm + static_cast<size_t>(b) * plane;
  const int* c1 = codes1 + static_cast<size_t>(b) * imax;
  const int* c2 = codes2 + static_cast<size_t>(b) * W;
  // Z: the five states at (len1, len2), log-added in the order 0..4
  const size_t end = static_cast<size_t>(n1) * W + n2;
  float Z = f[end];
#pragma unroll
  for (int k = 1; k < 5; ++k) Z = contra_lse(Z, f[k * plane + end]);

  float* out = post + static_cast<size_t>(b) * (imax - 1) * l2max;
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int i = 1 + blockIdx.y * nw + (threadIdx.x >> 5); i < imax; i += gridDim.y * nw) {
    const float* me_row = T.me + 5 * c1[i];
    for (int j = 1 + lane; j < W; j += 32) {
      float v = 0.0f;
      if (i <= n1 && j <= n2) {
        const float me = me_row[c2[j]];
        const float prm = (i == 1 && j == 1) ? 0.0f : 1.0f;
        const bool not_first = i > 1 || j > 1;
        const size_t at = static_cast<size_t>(i - 1) * W + (j - 1);
        const float bm = g[static_cast<size_t>(i) * W + j];
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const float sc = me + prm * T.pair[5 * k + M_];
          float term = contra_fast_exp(f[k * plane + at] + sc + bm - Z);
          if (k != M_ && !not_first) term = 0.0f;
          sum = sum + term;
        }
        v = fminf(fmaxf(sum, 0.0f), 1.0f);
      }
      out[static_cast<size_t>(i - 1) * l2max + (j - 1)] = v;
    }
  }
}

// --------------------------------------------------------- floor probe --

// The dependency floor of a pass alone: `steps` diagonals, on each the
// backward M chain of one cell (four dependent Fast_LogPlusEquals, the
// longer of the two passes' chains) after the design's hand-over: three
// values by shuffle from the lane after, between warps through a slot in
// shared memory, and the block barrier (none with one warp).  It computes
// nothing of use; buf takes one float per thread so that the chain is kept.
__global__ void __launch_bounds__(1024)
paircrf_floor_probe_kernel(float* buf, int steps) {
  extern __shared__ float4 smem[];
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 4 * nw) smem[threadIdx.x] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const float e = -0x1.4p+0f, t = -0x1.8p+1f;
  float m = 0.0f, x = -1.0f - lane, x2 = -2.0f, y = -3.0f, y2 = -4.0f, nM2 = -5.0f;
  for (int d = 0; d < steps; ++d) {
    float dM = __shfl_down_sync(kFull, m, 1);
    float dX = __shfl_down_sync(kFull, x, 1);
    float dX2 = __shfl_down_sync(kFull, x2, 1);
    if (lane == 31 && w + 1 < nw) {
      const float4 v = smem[2 * (2 * (w + 1) + ((d + 1) & 1))];
      dM = v.x;
      dX = v.y;
      dX2 = v.z;
    }
    float bM = fmaxf(NEG, nM2 + e);
    bM = contra_lse(bM, dX + t);
    bM = contra_lse(bM, dX2 + t);
    bM = contra_lse(bM, y + e);
    bM = contra_lse(bM, y2 + e);
    x = contra_lse(dX + t, y + t);
    nM2 = dM;
    m = bM;
    if (lane == 0 && w > 0) smem[2 * (2 * w + (d & 1))] = make_float4(m, x, x2, 0.0f);
    diagonal_barrier(nw);
  }
  buf[blockIdx.x * blockDim.x + threadIdx.x] = m + x;
}

// ------------------------------------------------------------ launchers --

// A block of a row a lane, at most 1024 threads: one strip up to imax 1024,
// strips of 1024 rows above, with edge for the hand-over between them.
int launch_pass(bool forward, const int* codes1, const int* len1, const int* codes2,
                const int* len2, const TablePtrs& tab, float* out, float* edge, int B, int imax,
                int l2max, cudaStream_t stream) {
  const int nwarps = imax > 1024 ? 32 : (imax + 31) / 32;
  if (imax > 32 * nwarps && edge == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(nwarps, l2max + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  float4* e = reinterpret_cast<float4*>(edge);
  if (forward) {
    paircrf_forward_kernel<<<B, 32 * nwarps, smem, stream>>>(codes1, len1, codes2, len2, tab,
                                                             out, e, imax, l2max);
  } else {
    paircrf_backward_kernel<<<B, 32 * nwarps, smem, stream>>>(codes1, len1, codes2, len2, tab,
                                                              out, e, imax, l2max);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F: (B, 5, imax, l2max + 1), every state of every cell within the lengths.
// edge: B * 2 * (l2max + 1) entries of two float4 of scratch for the
// hand-over between strips, null when imax <= 1024.
extern "C" int dafs_paircrf_forward(const int* codes1, const int* len1, const int* codes2,
                                    const int* len2, const float* match, const float* ins,
                                    const float* single, const float* pair, float* F,
                                    float* edge, int B, int imax, int l2max,
                                    cudaStream_t stream) {
  const TablePtrs tab = {match, ins, single, pair};
  return launch_pass(true, codes1, len1, codes2, len2, tab, F, edge, B, imax, l2max, stream);
}

// Bm: (B, imax, l2max + 1), the M state of every cell within the lengths;
// edge as the forward pass's.
extern "C" int dafs_paircrf_backward(const int* codes1, const int* len1, const int* codes2,
                                     const int* len2, const float* match, const float* ins,
                                     const float* single, const float* pair, float* Bm,
                                     float* edge, int B, int imax, int l2max,
                                     cudaStream_t stream) {
  const TablePtrs tab = {match, ins, single, pair};
  return launch_pass(false, codes1, len1, codes2, len2, tab, Bm, edge, B, imax, l2max, stream);
}

// post: (B, imax - 1, l2max).
extern "C" int dafs_paircrf_posterior(const float* F, const float* Bm, const int* codes1,
                                      const int* len1, const int* codes2, const int* len2,
                                      const float* match, const float* ins,
                                      const float* single, const float* pair, float* post,
                                      int B, int imax, int l2max, cudaStream_t stream) {
  const TablePtrs tab = {match, ins, single, pair};
  const int rows_per_block = kPostThreads / 32;
  int gy = (imax - 1 + rows_per_block - 1) / rows_per_block;
  if (gy > 16) gy = 16;
  paircrf_posterior_kernel<<<dim3(B, gy), kPostThreads, 0, stream>>>(
      F, Bm, codes1, len1, codes2, len2, tab, post, imax, l2max);
  return static_cast<int>(cudaGetLastError());
}

// Times nothing itself: the caller brackets it with CUDA events.  buf holds
// B * 32 * nwarps floats.
extern "C" int dafs_paircrf_floor_probe(float* buf, int steps, int nwarps, int B,
                                        cudaStream_t stream) {
  if (nwarps < 1 || nwarps > 32) return static_cast<int>(cudaErrorInvalidValue);
  paircrf_floor_probe_kernel<<<B, 32 * nwarps, shared_bytes(nwarps, 0), stream>>>(buf, steps);
  return static_cast<int>(cudaGetLastError());
}
