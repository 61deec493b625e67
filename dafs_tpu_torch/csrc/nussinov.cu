// MEA Nussinov decode with in-kernel traceback (K3), designed for Hopper.
//
// Replaces the Pallas TPU kernel dafs_tpu/ops/nussinov_pallas.py::_kernel
// (src/nussinov.cpp:207-298).  Semantics and tie-breaks as ops/nussinov.py:
// candidates down, left, pair, then the bifurcations; the first maximum
// wins (strictly greater replaces), and among bifurcations the largest
// split k wins.  Only max and add, so every value equals the plain version
// bit for bit whatever the order of evaluation, as long as the tie-breaks
// are kept.  Max-plus has no tensor-core form: wgmma computes sums of
// products, so nothing here can go through the tensor cores.
//
// What bounds it on an H100.  The roofline bound is tiny: about
// sum_ld (l-ld)(ld-3) bifurcation terms of one add and one compare each
// (about 1.5 us at B=8, L=352 against 67 TFLOP/s float32) and the upper
// triangle of the scores (about 0.5 us at 3.35 TB/s).  What bounds it in
// fact is the dependency chain: l-1 diagonals, each of which reads the
// earlier ones, then a serial traceback.  So the design shortens the time
// per diagonal:
//
// 1. Each cell's bifurcation maximum is split across a group of G lanes
//    (G = 32, or fewer while the diagonal has few splits or too many cells
//    for the cluster's lanes; lanes_per_cell).  The lanes stride over the
//    splits o = 1..ld-3, each keeping the serial rule (visit o upward,
//    replace on >=), and the group reduces by shuffles with the
//    lexicographic rule: greater value wins, on equal values the larger o.
//    The value carried is the chosen split's own, never fmaxf of two
//    values, so the bits of dp (and of -0.0 against +0.0) are the serial
//    loop's.
// 2. Coalesced operands, as the Pallas kernel laid out its VMEM scratch:
//    dp start-major (row i holds dp(i, c), contiguous in c) and the pair
//    values end-major (column j holds m(k, j), contiguous in k), so a
//    group's lanes read consecutive words of each.
// 3. More than one SM per problem: a thread-block cluster of C CTAs (1024
//    threads each) shares each diagonal's cells, cell (i, j) going to CTA
//    i % C; between diagonals the cluster meets at a cluster barrier
//    (release/acquire), a block barrier when C = 1.  The wrapper picks C
//    from B and L (ops/nussinov_cuda.cluster_size).
// 4. Tables on chip where they fit (table_bytes; L <= 669 at C = 8): CTA r
//    holds the dp rows i = r (mod C) and the pair columns j = r (mod C) in
//    its shared memory, packed.  A cell's own dp row is then local, and the
//    pair column and dp row i+1 are read from the owning CTA through
//    distributed shared memory (DSMEM).  Above that the tables are in
//    global memory, L2-resident (2 L*L floats a problem), read with
//    ld.global.cg since other SMs wrote them.  At the main path's widths
//    the on-chip tables are the faster layout (decoder_variants.py times
//    both).
// 5. Traceback codes are int16 (3 + o <= 1026 at L = 1024), packed as the
//    upper triangle (code_index).  Where they fit beside the tables (L <= 389 at
//    C = 8), every CTA writes its codes straight into the shared memory of
//    the cluster's rank 0 (DSMEM), and rank 0 walks them locally; otherwise
//    the codes go to global memory.  The walk is one thread: about 2l
//    dependent reads, the current segment in registers and the stack in
//    shared memory only for the second half of a bifurcation.
//
// Long variant (dafs_nussinov_decode_long, padded L above 1024 up to the
// ceiling of 4096 in ops/nussinov_cuda.py): the same kernel with its tables
// and its codes in global memory and the codes int32, so that no code
// width or shared-memory size bounds the split offset.  The walk's stack,
// 8 (L + 2) bytes (32 KB at 4096), still fits shared memory.  The tables
// (2 L*L floats, 128 MB a problem at 4096) no longer stay in L2, so each
// split reads from memory: slower, and the same values bit for bit.
//
// The floor this leaves: l-1 cluster barriers, each carrying a release at
// cluster scope so that the next diagonal sees the tables' writes
// (chip_smoke.py times 351 of them with one dependent L2 round trip each),
// plus per diagonal the cells' dependent reads, the split loop and the
// reduction, then the walk.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -0x1.c363ccp+127f;  // float32(-3e38)
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// codes of the cells (i, j), 0 <= i < j < L, row by row
__device__ __forceinline__ int code_index(int i, int j, int L) {
  return i * L - i * (i + 1) / 2 + (j - i - 1);
}

// Lanes given to each cell of a diagonal of n cells with s splits, when the
// cluster has T lanes: a power of two, at most 32, no more than the splits
// need, and few enough that every cell gets its group in one pass.
__device__ __forceinline__ int lanes_per_cell(int n, int s, int T) {
  int G = 32;
  while (G > 1 && (G / 2 >= s || n * G > T)) G >>= 1;
  return G;
}

__host__ __device__ size_t stack_bytes(int L) { return sizeof(int) * 2 * (L + 2); }
__host__ __device__ size_t codes_smem_bytes(int L) {
  return (sizeof(short) * static_cast<size_t>(L) * (L - 1) / 2 + 15) / 16 * 16;
}

// On-chip tables: CTA r of the cluster holds the dp rows i = r, r+C, ...
// (row i, entries c = i..L-1, at offset dp_row_offset) and the pair-value
// columns j = r, r+C, ... (column j, entries k = 0..j, at offset
// m_col_offset).  The m region starts after the largest dp region, CTA 0's.
__host__ __device__ int rows_owned(int L, int C, int r) { return r < L ? (L - r + C - 1) / C : 0; }
__host__ __device__ size_t dp_row_offset(int L, int C, int r, int q) {
  return static_cast<size_t>(q) * (L - r) - static_cast<size_t>(C) * q * (q - 1) / 2;
}
__host__ __device__ size_t m_col_offset(int C, int r, int q) {
  return static_cast<size_t>(C) * q * (q - 1) / 2 + static_cast<size_t>(q) * (r + 1);
}
size_t table_bytes(int L, int C) {
  size_t m = 0;
  for (int r = 0; r < C; ++r) {
    const size_t t = m_col_offset(C, r, rows_owned(L, C, r));
    m = t > m ? t : m;
  }
  return sizeof(float) * (dp_row_offset(L, C, 0, rows_owned(L, C, 0)) + m);
}

template <bool kSmemTables>
__device__ __forceinline__ float load_table(const float* p) {
  // global tables are read from L2: other SMs wrote them
  return kSmemTables ? *p : __ldcg(p);
}

// kSmemTables: dp and pair tables in the cluster's shared memory (read
// locally or through DSMEM); otherwise in global memory, L2-resident.
// codes_in_smem: the traceback codes in rank 0's shared memory.  Code: the
// type of a traceback code, short up to L = 1024, int above.
template <bool kSmemTables, typename Code = short>
__global__ void __launch_bounds__(kThreads)
nussinov_kernel(const float* __restrict__ sm, const int* __restrict__ lens,
                float* dp_all, float* mt_all, Code* code_all,
                float* __restrict__ score, int* __restrict__ ss_all, int L,
                int codes_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int lgC = __ffs(C) - 1;  // C is a power of two
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x >> lgC;
  const size_t off = static_cast<size_t>(b) * L * L;
  const float* S = sm + off;
  float* DP = dp_all + off;  // global tables: DP[i * L + c] = dp(i, c)
  float* MT = mt_all + off;  //                MT[j * L + k] = m(k, j)
  int* stack = reinterpret_cast<int*>(smem);
  Code* codes_local = reinterpret_cast<Code*>(smem + stack_bytes(L));
  Code* codes = codes_in_smem
      ? cluster.map_shared_rank(codes_local, 0)
      : code_all + static_cast<size_t>(b) * L * (L - 1) / 2;
  float* dp_local = reinterpret_cast<float*>(
      smem + stack_bytes(L) + (codes_in_smem ? codes_smem_bytes(L) : 0));
  float* m_local = dp_local + dp_row_offset(L, C, 0, rows_owned(L, C, 0));
  const int l = min(lens[b], L);

  // p[c] = dp(i, c) for c >= i
  auto dp_row = [&](int i) -> float* {
    if (!kSmemTables) return DP + i * L;
    const int r = i & (C - 1);
    float* p = dp_local + dp_row_offset(L, C, r, i >> lgC);
    return (r == rank ? p : cluster.map_shared_rank(p, r)) - i;
  };
  // p[k] = m(k, j) for k <= j
  auto m_col = [&](int j) -> float* {
    if (!kSmemTables) return MT + j * L;
    const int r = j & (C - 1);
    float* p = m_local + m_col_offset(C, r, j >> lgC);
    return r == rank ? p : cluster.map_shared_rank(p, r);
  };

  // Cells (i, j) go to the CTA owning row i, dp(i, .) is then local: this
  // CTA's cells of diagonal ld are i = rank + C*c, c < cells(ld).
  auto cells = [&](int ld) { return l - ld > rank ? (l - ld - rank + C - 1) >> lgC : 0; };
  for (int i = rank + C * static_cast<int>(threadIdx.x); i < l; i += C * kThreads) {
    dp_row(i)[i] = 0.0f;
  }
  // also makes sure every CTA has started before any DSMEM access
  cluster.sync();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  for (int ld = 1; ld < l; ++ld) {
    const int mine = cells(ld);
    const int s = ld - 3;  // splits o = 1..s
    const int G = lanes_per_cell(mine, s, kThreads);
    const int cpw = 32 / G;  // cells per warp
    const int sub = lane / G, lg = lane & (G - 1);
    for (int base = warp * cpw; base < mine; base += kWarps * cpw) {
      const int i = rank + C * (base + sub);
      const int j = i + ld;
      const bool act = base + sub < mine;
      const bool lead = act && lg == 0;
      float t1 = kNeg, t2 = kNeg, din = 0.0f, sv = 0.0f;
      const float* row_i = act ? dp_row(i) : nullptr;
      if (lead) {
        sv = __ldg(S + static_cast<size_t>(i) * L + j);
        const float* row_i1 = dp_row(i + 1);
        if (ld >= 2) {
          t1 = load_table<kSmemTables>(row_i1 + j);     // dp(i+1, j)
          t2 = load_table<kSmemTables>(row_i + j - 1);  // dp(i, j-1)
        }
        if (ld >= 3) din = load_table<kSmemTables>(row_i1 + j - 1);  // dp(i+1, j-1)
      }
      float best = kNeg;
      int bo = 0;
      if (act) {
        const float* dr = row_i + i - 1;  // dr[o] = dp(i, i+o-1)
        const float* mc = m_col(j) + i;   // mc[o] = m(i+o, j)
#pragma unroll 4
        for (int o = 1 + lg; o <= s; o += G) {
          const float c = load_table<kSmemTables>(dr + o) + load_table<kSmemTables>(mc + o);
          if (c >= best) {
            best = c;
            bo = o;
          }
        }
      }
      for (int w = G >> 1; w >= 1; w >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, w);
        const int oo = __shfl_xor_sync(kFull, bo, w);
        if (ov > best || (ov == best && oo > bo)) {
          best = ov;
          bo = oo;
        }
      }
      if (lead) {
        const float m = (ld >= 3 && sv > 0.0f) ? din + sv : kNeg;
        float v = t1;
        int code = 1;
        if (t2 > v) { v = t2; code = 2; }
        if (m > v) { v = m; code = 3; }
        if (ld >= 4 && best > v) { v = best; code = 3 + bo; }
        const bool has_any = v > kNeg;
        dp_row(i)[j] = has_any ? v : 0.0f;
        m_col(j)[i] = m;
        codes[code_index(i, j, L)] = static_cast<Code>(has_any ? code : 0);
      }
    }
    // one CTA needs only a block barrier, far cheaper than the cluster's
    if (C == 1) {
      __syncthreads();
    } else {
      cluster.sync();
    }
  }

  if (rank != 0) return;
  int* ss = ss_all + static_cast<size_t>(b) * L;
  for (int i = threadIdx.x; i < L; i += kThreads) ss[i] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;
  score[b] = l >= 1 ? load_table<kSmemTables>(dp_row(0) + l - 1) : 0.0f;  // dp(0, l-1)
  const Code* walk = codes_in_smem ? codes_local : codes;
  // segments are disjoint, so the order they are walked in does not matter
  int sp = 0, i = 0, j = l - 1;
  while (true) {
    const int c = j > i ? walk[code_index(i, j, L)] : 0;
    if (c == 1) {
      ++i;
    } else if (c == 2) {
      --j;
    } else if (c == 3) {
      ss[i] = j;
      ++i;
      --j;
    } else if (c >= 4) {
      const int k = i + c - 3;
      ss[k] = j;
      stack[2 * sp] = i;
      stack[2 * sp + 1] = k - 1;
      ++sp;
      i = k + 1;
      --j;
    } else {
      if (sp == 0) break;
      --sp;
      i = stack[2 * sp];
      j = stack[2 * sp + 1];
    }
  }
}

// The design's floor alone: `steps` rounds of one dependent L2 read and
// write by each CTA's thread 0, each round closed by a cluster barrier, as
// the diagonal loop above does with no cells.  One cluster of C CTAs.
__global__ void __launch_bounds__(kThreads)
floor_probe_kernel(float* buf, int steps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  float v = 0.0f;
  for (int t = 1; t <= steps; ++t) {
    if (threadIdx.x == 0) {
      v = __ldcg(buf + (t - 1) % 64 * 32 + (rank + 1) % cluster.num_blocks());
      buf[t % 64 * 32 + rank] = v + 1.0f;
    }
    cluster.sync();
  }
}

cudaError_t launch_cluster(const void* kernel, int grid, int C, size_t smem,
                           cudaStream_t stream, void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

bool valid_cluster(int C) { return C == 1 || C == 2 || C == 4 || C == 8; }

}  // namespace

// C: CTAs per problem (1, 2, 4 or 8), chosen by the wrapper.
extern "C" int dafs_nussinov_decode(const float* sm, const int* lens,
                                    float* dp, float* mt, short* code,
                                    float* score, int* ss, int B, int L,
                                    int C, cudaStream_t stream) {
  if (!valid_cluster(C)) return static_cast<int>(cudaErrorInvalidValue);
  // shared memory: the stack, then the codes and the tables where they fit
  const size_t tables = table_bytes(L, C);
  const bool smem_tables = stack_bytes(L) + tables <= DAFS_SMEM_MAX;
  size_t smem = stack_bytes(L) + (smem_tables ? tables : 0);
  int in_smem = smem + codes_smem_bytes(L) <= DAFS_SMEM_MAX ? 1 : 0;
  if (in_smem) smem += codes_smem_bytes(L);
  const void* kernel = smem_tables
      ? reinterpret_cast<const void*>(nussinov_kernel<true>)
      : reinterpret_cast<const void*>(nussinov_kernel<false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* args[] = {&sm, &lens, &dp, &mt, &code, &score, &ss, &L, &in_smem};
  const cudaError_t e = launch_cluster(kernel, B * C, C, smem, stream, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The long variant: padded L above 1024.  Tables and int32 codes in global
// memory (dp, mt: B*L*L floats; code: B*L*(L-1)/2 ints), the stack in
// shared memory.
extern "C" int dafs_nussinov_decode_long(const float* sm, const int* lens,
                                         float* dp, float* mt, int* code,
                                         float* score, int* ss, int B, int L,
                                         int C, cudaStream_t stream) {
  if (!valid_cluster(C)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stack_bytes(L);
  if (smem > DAFS_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(nussinov_kernel<false, int>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int in_smem = 0;
  void* args[] = {&sm, &lens, &dp, &mt, &code, &score, &ss, &L, &in_smem};
  const cudaError_t e = launch_cluster(kernel, B * C, C, smem, stream, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Times nothing itself: the caller brackets it with CUDA events.  buf holds
// 64 * 32 floats.
extern "C" int dafs_nussinov_floor_probe(float* buf, int steps, int C,
                                         cudaStream_t stream) {
  if (!valid_cluster(C)) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&buf, &steps};
  const cudaError_t e = launch_cluster(
      reinterpret_cast<const void*>(floor_probe_kernel), C, C, 0, stream, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
