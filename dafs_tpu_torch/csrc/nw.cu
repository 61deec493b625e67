// Banded MEA Needleman-Wunsch decode with in-kernel traceback (K4),
// designed for Hopper.
//
// Replaces the Pallas TPU kernel dafs_tpu/ops/nw_pallas.py::_kernel
// (src/needleman_wunsch.cpp:255-422).  Semantics as ops/nw.py: within the
// row envelope, 'M' wins against 'X' when equal, and 'Y' (the running
// maximum along the row) only when strictly greater; column 0 is dp 0,
// code 'X'.  Only max and add, so every value equals the plain version bit
// for bit; max is exact, so the order of the prefix-max scan does not
// matter.  Max-plus has no tensor-core form (wgmma computes sums of
// products).
//
// What bounds it on an H100.  The roofline bound is the scores read once,
// about 0.4 us at B=4, 320x320.  What bounds it in fact is the chain of l1
// dependent rows, then the serial traceback of up to l1 + l2 steps.  So the
// design shortens each row and each step:
//
// - One warp per problem (one block of 32 threads; the B <= 5 merges of a
//   DD layer land on B SMs).  Lane t owns the CH consecutive columns
//   [t*CH, t*CH + CH) in registers, CH = ceil((L2+1)/32) rounded up to a
//   multiple of 4 and fixed at compile time (template dispatch), so the
//   register arrays are only indexed by unrolled constants.
// - No block barrier, and no scan per row: the lanes work as a wavefront.
//   At step t lane l computes its columns of row t - l, in one lane-serial
//   pass.  What a lane needs from the columns to its left, the 'Y' running
//   maximum of its row, dp[i-1][l*CH - 1] and the score of that column,
//   lane l-1 produced one step earlier and hands over with one
//   __shfl_up_sync each.  The wavefront takes l1 + 31 steps; one step is
//   about 20 instructions a column, so a single warp's issue rate bounds
//   it.
// - Each lane copies the scores of its own columns (16-byte cp.async, CH
//   a multiple of 4 for that) and its row's envelope kDepth steps ahead
//   into a ring in shared memory.
// - Traceback codes (0-3) are kept 2 bits a cell in shared memory, one
//   32-bit word per lane and 16 columns per row; lane 0 walks them there,
//   one dependent shared-memory read a step.  The ring and the table must
//   fit one block's 227 KB: the wrapper raises above that
//   (ops/nw_cuda.smem_bytes; L1 <= 771 at 1023 columns, 1703 at 320, far
//   beyond the main path's merged alignments of under 600 columns).
//
// Long variant (nw_long_kernel, for shapes past the limits above, up to
// the ceiling of 4096 x 4096 in ops/nw_cuda.py).  One block of 1024
// threads per problem walks the rows one after another; thread t owns a
// chunk of ceil((L2+1)/1024) consecutive columns.  Per row: each thread
// forms 'M' against 'X' for its columns and the running maximum of its
// chunk; a block scan (shuffles, then the warps' totals) gives each chunk
// the maximum left of it; each thread then finishes its columns in order.
// The previous and current dp rows are in shared memory (two rows of
// L2+1 floats), the codes one byte a cell in global memory, and thread 0
// walks them there.  Two block barriers a row: slower than the wavefront
// and simple; it exists so that no length up to the ceiling is refused.
//
// Tried on the card and dropped, each slower: one row at a time with a
// 5-step shuffle scan per row (one warp then waits on every step of the
// scan); 8-byte copies with column 0 kept out of the lanes; a ring of whole
// rows copied coalesced, which each lane reads its columns from; a
// traceback that loads the next code word a step ahead.
// The costs of the copies, the code stores and the walk were timed when K4
// was redesigned for Hopper; CHANGES.md records the times.

#include "common.cuh"

namespace {

constexpr float kLowest = -0x1.fffffep+127f;  // float32 min
constexpr unsigned kFull = 0xffffffffu;

constexpr int kDepth = 8;  // steps of scores in flight ahead of the step computed

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  // bytes = 0 fills the destination with zeros and reads nothing
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// Starts copying what lane `lane` needs at step t, row i = t - lane, into
// ring slot t % kDepth: the scores of (i-1, c) for its columns
// c = lane*CH + j as CH contiguous floats (16-byte copies when `vec`: rows
// and chunks then start 16-byte aligned), and the row's envelope.  Each
// lane reads back only what it copied itself.  One commit group per step,
// empty or not.
template <int CH>
__device__ __forceinline__ void issue_step(float* ring, int2* ring_env,
                                           const float* S, const int* ef,
                                           const int* el, int t, int l1,
                                           int lane, int L2, bool vec) {
  const int slot = t % kDepth;
  const int i = t - lane;
  const bool row = i >= 1 && i <= l1;
  float* dst = ring + (slot * 32 + lane) * CH;
  const float* src = S + static_cast<size_t>(i - 1) * L2 + lane * CH;
  if (vec) {
#pragma unroll
    for (int q = 0; q < CH / 4; ++q) {
      const bool ok = row && lane * CH + 4 * q < L2;
      cp_async16(dst + 4 * q, ok ? src + 4 * q : S, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const bool ok = row && lane * CH + j < L2;
      cp_async4(dst + j, ok ? src + j : S, ok ? 4 : 0);
    }
  }
  int* env = reinterpret_cast<int*>(ring_env + slot * 32 + lane);
  cp_async4(env, row ? ef + i : ef, row ? 4 : 0);
  cp_async4(env + 1, row ? el + i : el, row ? 4 : 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Words of codes a lane owns per row: 16 codes of 2 bits per 32-bit word.
template <int CH>
__host__ __device__ constexpr int code_words() { return (CH + 15) / 16; }

template <int CH>
__device__ __forceinline__ void store_codes(unsigned* row, const int (&code)[CH],
                                            int lane) {
#pragma unroll
  for (int w = 0; w < code_words<CH>(); ++w) {
    unsigned word = 0;
#pragma unroll
    for (int j = 16 * w; j < CH && j < 16 * w + 16; ++j) {
      word |= static_cast<unsigned>(code[j]) << (2 * (j - 16 * w));
    }
    row[lane * code_words<CH>() + w] = word;
  }
}

template <int CH>
__global__ void __launch_bounds__(32)
nw_kernel(const float* __restrict__ sm, const int* __restrict__ env_first,
          const int* __restrict__ env_last, const int* __restrict__ l1s,
          const int* __restrict__ l2s, float* __restrict__ score,
          int* __restrict__ al_all, int L1, int L2, bool vec) {
  // ring of kDepth steps of scores and envelopes, then the codes: row i
  // holds RW words, lane l's code words at l*NWD, column l*CH + j at bits
  // 2*(j%16) of word j/16
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int2* ring_env = reinterpret_cast<int2*>(ring + kDepth * CH * 32);
  unsigned* tr = reinterpret_cast<unsigned*>(ring_env + kDepth * 32);
  constexpr int NWD = code_words<CH>();
  constexpr int RW = 32 * NWD;
  const int W = L2 + 1;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int l1 = min(l1s[b], L1), l2 = min(l2s[b], L2);
  const float* S = sm + static_cast<size_t>(b) * L1 * L2;
  const int* ef = env_first + static_cast<size_t>(b) * (L1 + 1);
  const int* el = env_last + static_cast<size_t>(b) * (L1 + 1);
  int* al = al_all + static_cast<size_t>(b) * L1;

  for (int t = 1; t <= kDepth; ++t) issue_step<CH>(ring, ring_env, S, ef, el, t, l1, lane, L2, vec);
  for (int i = lane; i < L1; i += 32) al[i] = -1;

  // row 0: dp = 0, code 'Y' for k > 0
  float dp[CH];
  int code[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    dp[j] = 0.0f;
    code[j] = lane * CH + j > 0 ? 3 : 0;
  }
  store_codes<CH>(tr, code, lane);

  // Wavefront over the lanes: at step t lane `lane` computes its columns
  // of row i = t - lane.  From the lane before it takes, by shuffles, what
  // that lane produced at step t-1: the running max of row i's chain
  // values left of this lane's columns, dp[i-1][lane*CH - 1] (that lane's
  // last column one row earlier) and the score of (i-1, lane*CH - 1).
  float run_out = kLowest;  // this lane's running max, row of the last step
  float last_out = 0.0f;    // this lane's last dp column, row before that
  float score_out = 0.0f;   // this lane's last score, row of the last step
  float sv = 0.0f;          // dp[l1][l2], kept by the lane owning column l2
  for (int t = 1; t <= l1 + 31; ++t) {
    float left = __shfl_up_sync(kFull, run_out, 1);
    const float before = __shfl_up_sync(kFull, last_out, 1);
    const float s_first = __shfl_up_sync(kFull, score_out, 1);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kDepth - 1) : "memory");
    const int slot = t % kDepth;
    float raw[CH];  // raw[j]: score of (i-1, lane*CH + j)
#pragma unroll
    for (int q = 0; q < CH / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(ring + (slot * 32 + lane) * CH)[q];
      raw[4 * q] = v.x;
      raw[4 * q + 1] = v.y;
      raw[4 * q + 2] = v.z;
      raw[4 * q + 3] = v.w;
    }
    const int2 env = ring_env[slot * 32 + lane];
    issue_step<CH>(ring, ring_env, S, ef, el, t + kDepth, l1, lane, L2, vec);
    const int i = t - lane;
    if (i < 1 || i > l1) continue;
    // columns lane*CH + j inside the band [max(first, 1), last], and < W
    const int jlo = max(env.x, 1) - lane * CH;
    const int jhi = min(env.y, W - 1) - lane * CH;
    const bool start1 = env.x <= 1;  // dp[i][0] = 0 starts the 'Y' chain
    if (lane == 0) left = kLowest;
    last_out = dp[CH - 1];
    score_out = raw[CH - 1];

    // 'M' wins against 'X' on ties; 'Y' (left) only when strictly greater
    float diag = before;  // dp[i-1][k-1]
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float m = diag + (j == 0 ? s_first : raw[j - 1]);
      const float x = dp[j];
      diag = x;
      const bool ge = m >= x;
      const float bv = ge ? m : x;
      const bool in_band = j >= jlo && j <= jhi;
      float c = in_band ? bv : kLowest;
      int cd = left > bv ? 3 : (ge ? 1 : 2);
      float d = in_band ? fmaxf(bv, left) : kLowest;
      cd = in_band ? cd : 0;
      if (j == 0 && lane == 0) {  // column 0
        c = start1 ? 0.0f : kLowest;
        d = 0.0f;
        cd = 2;
      }
      left = fmaxf(left, c);
      dp[j] = d;
      code[j] = cd;
    }
    if (i == l1) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (lane * CH + j == l2) sv = dp[j];
      }
    }
    run_out = left;
    store_codes<CH>(tr + i * RW, code, lane);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // dp[l1][l2] from the lane that owns column l2 (0 when l1 = 0)
  sv = __shfl_sync(kFull, sv, l2 / CH);
  __syncwarp();
  if (lane != 0) return;
  score[b] = sv;
  // column k = owner*CH + j, followed as k falls; in row 0 only 'Y' and in
  // column 0 only 'X' remain, which leave al at -1
  int i = l1, k = l2, owner = l2 / CH, j = l2 - owner * CH;
  const unsigned* row = tr + i * RW;
  while (i > 0 && k > 0) {
    const int c = (row[owner * NWD + (j >> 4)] >> (2 * (j & 15))) & 3;
    if (c == 1) al[i - 1] = k - 1;  // 'X' leaves al[i-1] at -1
    const bool up = c == 1 || c == 2;
    const bool back = c != 2;
    i -= up;
    row -= up ? RW : 0;
    k -= back;
    j -= back;
    if (j < 0) {
      j = CH - 1;
      --owner;
    }
  }
}

template <int CH>
int launch(const float* sm, const int* env_first, const int* env_last,
           const int* l1, const int* l2, float* score, int* al, int B, int L1,
           int L2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kDepth * CH * 32 + sizeof(int2) * kDepth * 32 +
                      sizeof(unsigned) * static_cast<size_t>(L1 + 1) * 32 * code_words<CH>();
  if (smem > DAFS_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nw_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 16-byte copies need 16-byte aligned rows
  const bool vec = L2 % 4 == 0 && reinterpret_cast<size_t>(sm) % 16 == 0;
  nw_kernel<CH><<<B, 32, smem, stream>>>(sm, env_first, env_last, l1, l2,
                                         score, al, L1, L2, vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- long variant --

constexpr int kLongThreads = 1024;
constexpr int kLongChunk = 8;  // columns a thread: (4096 + 1) / 1024 rounded up, with room

// Shared memory of the long variant: two dp rows and the warps' totals.
__host__ __device__ inline size_t long_smem_bytes(int L2) {
  return sizeof(float) * (2 * static_cast<size_t>(L2 + 1) + 32);
}

__global__ void __launch_bounds__(kLongThreads)
nw_long_kernel(const float* __restrict__ sm, const int* __restrict__ env_first,
               const int* __restrict__ env_last, const int* __restrict__ l1s,
               const int* __restrict__ l2s, float* __restrict__ score,
               int* __restrict__ al_all, unsigned char* __restrict__ code_all,
               int L1, int L2) {
  extern __shared__ float rows[];
  const int W = L2 + 1;
  float* prev = rows;
  float* cur = rows + W;
  float* wmax = rows + 2 * W;  // 32 warps' running maxima
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l1 = min(l1s[b], L1), l2 = min(l2s[b], L2);
  const float* S = sm + static_cast<size_t>(b) * L1 * L2;
  const int* ef = env_first + static_cast<size_t>(b) * (L1 + 1);
  const int* el = env_last + static_cast<size_t>(b) * (L1 + 1);
  int* al = al_all + static_cast<size_t>(b) * L1;
  unsigned char* codes = code_all + static_cast<size_t>(b) * (L1 + 1) * W;
  const int per = (W + kLongThreads - 1) / kLongThreads;  // <= kLongChunk
  const int k0 = tid * per;

  // row 0: dp = 0, code 'Y' for k > 0
  for (int k = tid; k < W; k += kLongThreads) {
    prev[k] = 0.0f;
    codes[k] = k > 0 ? 3 : 0;
  }
  for (int i = tid; i < L1; i += kLongThreads) al[i] = -1;
  if (tid == 0 && l1 == 0) score[b] = 0.0f;
  __syncthreads();

  for (int i = 1; i <= l1; ++i) {
    const int first = max(ef[i], 1), last = el[i];
    const bool start1 = ef[i] <= 1;  // dp[i][0] = 0 starts the 'Y' chain
    const float* srow = S + static_cast<size_t>(i - 1) * L2;
    float bv[kLongChunk];
    int bc[kLongChunk];
    float run = kLowest;  // running max of this chunk's chain values
#pragma unroll
    for (int q = 0; q < kLongChunk; ++q) {
      const int k = k0 + q;
      bv[q] = kLowest;
      bc[q] = 0;
      if (q < per && k < W) {
        float c;
        if (k == 0) {
          c = start1 ? 0.0f : kLowest;
        } else {
          // 'M' wins against 'X' on ties
          const float m = prev[k - 1] + srow[k - 1];
          const float x = prev[k];
          const bool ge = m >= x;
          bv[q] = ge ? m : x;
          bc[q] = ge ? 1 : 2;
          c = (k >= first && k <= last) ? bv[q] : kLowest;
        }
        run = fmaxf(run, c);
      }
    }
    // exclusive block scan of the chunks' maxima
    float incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = fmaxf(incl, v);
    }
    if (lane == 31) wmax[warp] = incl;
    __syncthreads();
    float left = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) left = kLowest;
    for (int v = 0; v < warp; ++v) left = fmaxf(left, wmax[v]);
    // 'Y' (left) only when strictly greater
#pragma unroll
    for (int q = 0; q < kLongChunk; ++q) {
      const int k = k0 + q;
      if (q < per && k < W) {
        float d;
        int cd;
        if (k == 0) {
          d = 0.0f;
          cd = 2;
          left = start1 ? 0.0f : kLowest;
        } else {
          const bool in_band = k >= first && k <= last;
          d = in_band ? fmaxf(bv[q], left) : kLowest;
          cd = in_band ? (left > bv[q] ? 3 : bc[q]) : 0;
          left = fmaxf(left, in_band ? bv[q] : kLowest);
        }
        cur[k] = d;
        codes[static_cast<size_t>(i) * W + k] = static_cast<unsigned char>(cd);
        if (i == l1 && k == l2) score[b] = d;
      }
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  if (tid != 0) return;
  // in row 0 only 'Y' and in column 0 only 'X' remain, which leave al at -1
  int i = l1, k = l2;
  while (k > 0 && i > 0) {
    const int c = codes[static_cast<size_t>(i) * W + k];
    if (c == 1) al[i - 1] = k - 1;  // 'X' leaves al[i-1] at -1
    i -= (c == 1 || c == 2);
    k -= (c != 2);
  }
}

}  // namespace

// The long variant: any L1 and L2 + 1 <= 1024 * 8 columns; code: B *
// (L1 + 1) * (L2 + 1) bytes of global memory.
extern "C" int dafs_nw_decode_long(const float* sm, const int* env_first,
                                   const int* env_last, const int* l1,
                                   const int* l2, float* score, int* al,
                                   unsigned char* code, int B, int L1, int L2,
                                   cudaStream_t stream) {
  if (L2 + 1 > kLongThreads * kLongChunk) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = long_smem_bytes(L2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nw_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nw_long_kernel<<<B, kLongThreads, smem, stream>>>(sm, env_first, env_last, l1,
                                                    l2, score, al, code, L1, L2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafs_nw_decode(const float* sm, const int* env_first,
                              const int* env_last, const int* l1,
                              const int* l2, float* score, int* al, int B,
                              int L1, int L2, cudaStream_t stream) {
  const int ch = dafs_round_up((L2 + 1 + 31) / 32, 4);
  switch (ch) {
    case 4: return launch<4>(sm, env_first, env_last, l1, l2, score, al, B, L1, L2, stream);
    case 8: return launch<8>(sm, env_first, env_last, l1, l2, score, al, B, L1, L2, stream);
    case 12: return launch<12>(sm, env_first, env_last, l1, l2, score, al, B, L1, L2, stream);
    case 16: return launch<16>(sm, env_first, env_last, l1, l2, score, al, B, L1, L2, stream);
    case 20: return launch<20>(sm, env_first, env_last, l1, l2, score, al, B, L1, L2, stream);
    case 24: return launch<24>(sm, env_first, env_last, l1, l2, score, al, B, L1, L2, stream);
    case 28: return launch<28>(sm, env_first, env_last, l1, l2, score, al, B, L1, L2, stream);
    case 32: return launch<32>(sm, env_first, env_last, l1, l2, score, al, B, L1, L2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
