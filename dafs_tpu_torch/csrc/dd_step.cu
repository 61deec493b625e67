// The multiplier step of the batched DD loop: the body of dd._dd_core after
// its two decodes, designed for Hopper.
//
// Replaces no Pallas kernel: on the TPU, XLA fused this part of the body
// inside dafs_tpu/dd.py::_dd_core's while_loop.  The plain version is
// dafs_tpu_torch/dd.py::_step_plain, about 270 ATen launches a body: the
// count planes scattered through index_put_ (a sort, an assert and
// reductions each), dense one-hot planes, masked updates and some twenty
// selects that freeze finished merges, each its own kernel.
//
// What bounds it on an H100.  A body reads and writes each multiplier cell
// a few times, B * (P1^2 + P2^2 + P1*P2) cells and U candidates a merge: a
// few MB at tRNA sizes (B <= 25, P <= 128), about 1 us at 3.35 TB/s.  What
// bounded the plain version is launches, ~20 us of host time each.  So the
// design is the fewest launches that keep the plain version's bits, three
// kernels and one ATen reduction a body:
//
// 1. candidates_kernel, a thread a (merge, candidate): the candidate's
//    s_w = ((q_x[i,j] + q_y[k,l]) - q_z[i,k]) - q_z[j,l], written where it
//    is active (valid and s_w > 0; else 0) into a contiguous (B, U) buffer,
//    and 1 added with atomicAdd to the int32 count planes t_x[i,j],
//    t_y[k,l], t_z[i,k] and t_z[j,l] where active.  Integer counts do not
//    depend on the order of the adds.
// 2. torch.sum of that buffer along U, by the caller: the body's one float
//    reduction, the same ATen call on the same values as the plain version
//    (the card's order differs from the CPU's, so it is not redone here).
// 3. update_kernel<RULE>, grid (chunks, plane x/y/z, merge): every cell of
//    a running merge's planes, read and written by one thread.  The one-hot
//    of this body's decoded structure or alignment is one compare in
//    registers; then the update masks, the rule's step and optimiser state,
//    the clamp of q_z, the next body's score matrix from the new q (in
//    nussinov.score_matrix's order w*(p-th) - q, and (p_z - th_a) + q_z),
//    the count zeroed for the next body, and the block's violations added
//    to its merge's counter.  The rule is a template argument: the three
//    differ only in the step.
// 4. scalars_kernel<RULE>, a block a merge: s = ((s_x + s_y) + s_z) + sum,
//    the convergence test, the step width (subgradient), the freeze, the
//    copy of x, y and z; the violation counter reset.
//
// Every float operation is one IEEE float32 operation in the plain
// version's order (-fmad=false, ops/cuda_lib.py; division and sqrt
// rounded, as ATen's), so the step is bit-equal to the plain one.  A merge
// that finished in an earlier body is skipped by all three, which leaves it
// as the plain version's torch.where(run, new, old) does; its count planes
// stay zero.  A body on the card is then K3, K4 and these four launches.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 1024;  // blocks a (plane, merge); grid-stride beyond
constexpr int kScalarThreads = 128;
enum Rule { kSubgradient = 0, kAdagrad = 1, kAdam = 2 };

}  // namespace

// The problem (dd.prep_batch, read only), the loop's state (dd._State,
// updated in place), the step's scratch, then the scalars.  Planes are
// (B, P1, P1) for x, (B, P2, P2) for y, (B, P1, P2) for z; sm_xy is
// (2B, P, P), P = max(P1, P2), the x problems first.  a_* hold adagrad's g2
// or adam's m, v_* adam's v; unused pointers are null.
struct DDStepArgs {
  const float* p_x;
  const float* p_y;
  const float* p_z;
  const uint8_t* in_cx;
  const uint8_t* in_cy;
  const uint8_t* in_cz;
  const int64_t* cbp;
  const uint8_t* cbp_valid;
  const float* w_x;
  const float* w_y;
  const float* n_cbp4;
  const float* bc1;
  const float* bc2;
  float* q_x;
  float* q_y;
  float* q_z;
  float* a_x;
  float* a_y;
  float* a_z;
  float* v_x;
  float* v_y;
  float* v_z;
  float* eta;
  float* c;
  float* s_prev;
  int64_t* violated;
  int64_t* t;
  int* x;
  int* y;
  int* z;
  uint8_t* done;
  float* sm_xy;
  float* sm_z;
  int* t_x;
  int* t_y;
  int* t_z;
  float* sw;
  int* viol;
  float th_s0, th_a, eta0, eps, b1, b2;
  int B, P1, P2, P, U, rule;
};

namespace {

__global__ void __launch_bounds__(kThreads) candidates_kernel(const DDStepArgs a) {
  const int b = blockIdx.y;
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= a.U) return;
  const int64_t bu = int64_t(b) * a.U + u;
  float out = 0.0f;
  if (!a.done[b] && a.cbp_valid[bu]) {
    const int64_t* cb = a.cbp + bu * 4;
    const int i = int(cb[0]), j = int(cb[1]), k = int(cb[2]), l = int(cb[3]);
    const int64_t xo = int64_t(b) * a.P1 * a.P1;
    const int64_t yo = int64_t(b) * a.P2 * a.P2;
    const int64_t zo = int64_t(b) * a.P1 * a.P2;
    const int64_t xij = xo + int64_t(i) * a.P1 + j, ykl = yo + int64_t(k) * a.P2 + l;
    const int64_t zik = zo + int64_t(i) * a.P2 + k, zjl = zo + int64_t(j) * a.P2 + l;
    const float s_w = ((a.q_x[xij] + a.q_y[ykl]) - a.q_z[zik]) - a.q_z[zjl];
    if (s_w > 0.0f) {
      out = s_w;
      atomicAdd(a.t_x + xij, 1);
      atomicAdd(a.t_y + ykl, 1);
      atomicAdd(a.t_z + zik, 1);
      atomicAdd(a.t_z + zjl, 1);
    }
  }
  a.sw[bu] = out;
}

// The step of one updated cell with difference d (src/dafs.cpp:984-1004, in
// dafs_tpu's order); moves the cell's optimiser state in ga / gv.
template <int RULE>
__device__ __forceinline__ float cell_step(const DDStepArgs& a, float d, float eta, float bc1,
                                           float bc2, float* ga, float* gv) {
  if (RULE == kSubgradient) return eta * d;
  if (RULE == kAdagrad) {
    const float g2 = *ga + d * d;
    *ga = g2;
    return (a.eta0 * d) / sqrtf(g2 + a.eps);
  }
  const float m = a.b1 * *ga + (1.0f - a.b1) * d;
  const float v = a.b2 * *gv + ((1.0f - a.b2) * d) * d;
  *ga = m;
  *gv = v;
  return (a.eta0 * (m / bc1)) / (sqrtf(v / bc2) + a.eps);
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
update_kernel(const DDStepArgs a, const int* __restrict__ xy, const int* __restrict__ z_new) {
  const int b = blockIdx.z;
  if (a.done[b]) return;
  const int plane = blockIdx.y;  // 0 x, 1 y, 2 z
  const int rows = plane == 1 ? a.P2 : a.P1;
  const int cols = plane == 0 ? a.P1 : a.P2;
  const int n = rows * cols;  // at most 4096^2 (K3's ceiling)
  const int64_t off = int64_t(b) * n;
  float* const q = (plane == 0 ? a.q_x : plane == 1 ? a.q_y : a.q_z) + off;
  int* const cnt = (plane == 0 ? a.t_x : plane == 1 ? a.t_y : a.t_z) + off;
  const float* const p = (plane == 0 ? a.p_x : plane == 1 ? a.p_y : a.p_z) + off;
  const uint8_t* const inc = (plane == 0 ? a.in_cx : plane == 1 ? a.in_cy : a.in_cz) + off;
  float* const ga = RULE == kSubgradient ? nullptr
                    : (plane == 0 ? a.a_x : plane == 1 ? a.a_y : a.a_z) + off;
  float* const gv = RULE != kAdam ? nullptr
                    : (plane == 0 ? a.v_x : plane == 1 ? a.v_y : a.v_z) + off;
  // this body's decode of each row: x_new = xy[b], y_new = xy[B + b], z_new[b]
  const int* const dec = plane == 0 ? xy + int64_t(b) * a.P
                       : plane == 1 ? xy + int64_t(a.B + b) * a.P
                                    : z_new + int64_t(b) * a.P1;
  float* const sm = plane == 2 ? a.sm_z + off
                               : a.sm_xy + int64_t(plane == 0 ? b : a.B + b) * a.P * a.P;
  const int sm_ld = plane == 2 ? cols : a.P;
  const float w = plane == 0 ? a.w_x[b] : a.w_y[b];
  const float eta = RULE == kSubgradient ? a.eta[b] : 0.0f;
  float bc1 = 0.0f, bc2 = 0.0f;
  if (RULE == kAdam) {
    const int64_t t = a.t[b];
    bc1 = a.bc1[t];
    bc2 = a.bc2[t];
  }

  int viol = 0;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
    const int r = e / cols;
    const int col = e - r * cols;
    const bool hot = dec[r] == col;
    const int tc = cnt[e];
    const bool cand = inc[e] != 0;
    const float qv = q[e];
    float qn = qv;
    if (plane != 2) {
      const float d = float(tc - int(hot));
      const bool upd = (hot || cand) && d != 0.0f;
      if (upd) qn = qv - cell_step<RULE>(a, d, eta, bc1, bc2, ga + e, gv + e);
      viol += int(upd);
      sm[int64_t(r) * sm_ld + col] = w * (p[e] - a.th_s0) - qn;
    } else {
      const float d = float(int(hot) - tc);
      const bool mz = hot || cand;
      const bool upd = mz && d != 0.0f;
      const float st = upd ? cell_step<RULE>(a, d, eta, bc1, bc2, ga + e, gv + e) : 0.0f;
      if (mz) {
        const float v = qv - st;
        qn = isnan(v) ? v : fmaxf(v, 0.0f);  // ATen's clamp(min=0)
      }
      viol += int((hot && tc > 1) || (!hot && cand && tc > 0));
      sm[int64_t(r) * sm_ld + col] = (p[e] - a.th_a) + qn;
    }
    q[e] = qn;
    cnt[e] = 0;
  }

  // the block's violations, then one add to its merge's counter
  for (int o = 16; o > 0; o >>= 1) viol += __shfl_down_sync(0xffffffffu, viol, o);
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = viol;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += warp_sums[k];
    if (total) atomicAdd(a.viol + b, total);
  }
}

template <int RULE>
__global__ void __launch_bounds__(kScalarThreads)
scalars_kernel(const DDStepArgs a, const float* __restrict__ s_xy, const int* __restrict__ xy,
               const float* __restrict__ s_z, const float* __restrict__ s_sum,
               const int* __restrict__ z_new) {
  const int b = blockIdx.x;
  const bool run = !a.done[b];
  __syncthreads();  // every thread has read done[b] before thread 0 writes it
  if (run) {
    const int* xb = xy + int64_t(b) * a.P;
    const int* yb = xy + int64_t(a.B + b) * a.P;
    const int* zb = z_new + int64_t(b) * a.P1;
    for (int i = threadIdx.x; i < a.P1; i += kScalarThreads) {
      a.x[int64_t(b) * a.P1 + i] = xb[i];
      a.z[int64_t(b) * a.P1 + i] = zb[i];
    }
    for (int k = threadIdx.x; k < a.P2; k += kScalarThreads) a.y[int64_t(b) * a.P2 + k] = yb[k];
  }
  if (threadIdx.x != 0) return;
  const int viol = a.viol[b];
  a.viol[b] = 0;
  if (!run) return;
  const float s = ((s_xy[b] + s_xy[a.B + b]) + s_z[b]) + s_sum[b];
  const bool done_new = viol == 0;
  const float s_prev = a.s_prev[b];
  const int64_t t = a.t[b];
  if (RULE == kSubgradient) {
    // step width (src/dafs.cpp:1283-1288); on break the reference skips it
    // and keeps the previous s_prev
    if ((s > s_prev || t == 0) && !done_new) {
      const float n4 = a.n_cbp4[b];
      const float v = n4 - float(viol);
      const float c_new = a.c[b] + (isnan(v) ? v : fmaxf(v, 0.0f)) / n4;
      a.c[b] = c_new;
      a.eta[b] = a.eta0 / (1.0f + c_new);
    }
  }
  a.s_prev[b] = done_new ? s_prev : s;
  a.violated[b] = viol;
  a.t[b] = t + 1;
  a.done[b] = done_new;
}

bool bad_shape(const DDStepArgs* a) {
  return a->B < 1 || a->B > 65535 || a->P1 < 1 || a->P2 < 1 || a->U < 1 ||
         a->P != (a->P1 > a->P2 ? a->P1 : a->P2);
}

}  // namespace

extern "C" int dafs_dd_candidates(const DDStepArgs* a, cudaStream_t stream) {
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a->U + kThreads - 1) / kThreads, a->B);
  candidates_kernel<<<grid, kThreads, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafs_dd_update(const DDStepArgs* a, const int* xy, const int* z_new,
                              cudaStream_t stream) {
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cells = int64_t(a->P) * a->P;
  const int64_t chunks = (cells + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(chunks < kMaxChunks ? chunks : kMaxChunks), 3, a->B);
  switch (a->rule) {
    case kSubgradient:
      update_kernel<kSubgradient><<<grid, kThreads, 0, stream>>>(*a, xy, z_new);
      break;
    case kAdagrad:
      update_kernel<kAdagrad><<<grid, kThreads, 0, stream>>>(*a, xy, z_new);
      break;
    case kAdam:
      update_kernel<kAdam><<<grid, kThreads, 0, stream>>>(*a, xy, z_new);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafs_dd_scalars(const DDStepArgs* a, const float* s_xy, const int* xy,
                               const float* s_z, const float* s_sum, const int* z_new,
                               cudaStream_t stream) {
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->rule) {
    case kSubgradient:
      scalars_kernel<kSubgradient><<<a->B, kScalarThreads, 0, stream>>>(*a, s_xy, xy, s_z, s_sum,
                                                                        z_new);
      break;
    case kAdagrad:
    case kAdam:
      // the two differ from subgradient only in the cells' step
      scalars_kernel<kAdagrad><<<a->B, kScalarThreads, 0, stream>>>(*a, s_xy, xy, s_z, s_sum,
                                                                    z_new);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
