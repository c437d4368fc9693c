// K13 sgns_pair_grads: the pair-based SGNS step's pair lists and gradients.
//
// Replaces node2vec_tpu/models/skipgram.py:130 make_pairs and the gradient
// half of :168 sgns_train_step_impl (:198-235).  The step works on a flat
// list of P = B * 2w * L1 (center, context) lanes in the JAX order (walk,
// offset, position); each lane gathers its own rows, and every output is
// per lane.  The row-wise Adagrad that follows is K3 + K4 (adagrad.cu) over
// three lists: d_ci at the center rows, d_co at the context rows, d_no at
// the shared negatives.
//
// Two launches:
//  1. pair lists, one thread a lane: centers[p] and contexts[p] are the
//     lane's vertex ids, or -1 where the lane is invalid (either id < 0,
//     |d| > the position's shrunk window b, or either id out of the
//     vocabulary) -- make_pairs' rule.  make_pairs on the card returns this
//     launch's output in the JAX form (id 0 and valid=False).
//  2. gradients, a block a walk (grid-stride), as K2 (sgns.cu): the walk's
//     [L1, D] rows of emb_in and emb_out and the S negative rows sit in
//     shared memory.  A lane's center is a walk position, and g_neg depends
//     only on the center and the lane's validity, so each center's S
//     negative logits are computed once and shared by its <= 2w valid
//     lanes, and gn = g_neg . no is formed once a position:
//       d_ci[p] = g_pos[p] * co[p] + gn[center]      (0 where invalid)
//       d_co[p] = g_pos[p] * ci[p]                   (0 where invalid)
//       d_no    = sum over valid lanes of g_neg^T ci (block partial in
//                 shared memory, one fp32 atomic per entry per block)
//     This is the JAX function, with its sums taken in another order.
//
// Staging: a walk whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); the wrapper picks the mode from the shape.
//
// Bound on an H100: memory.  The per-lane gradients the JAX function defines
// are the largest output: 2 * P * D * 4 bytes written (550 MB at B = 2,560,
// L1 = 21, w = 5, D = 128), which K3/K4 then read back per occurrence.  The
// block writes a walk's 2w * L1 lanes as one contiguous [2w * L1, D] run of
// each output, so the stores coalesce; the flops (6 S D a live center, ~5 D
// a valid lane) are far below the fp32 rate.

#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// log(sigmoid(x)) = -softplus(-x), in the overflow-safe form
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// offset index o in [0, 2w) -> window offset d in -w..-1, 1..w
__device__ __forceinline__ int offset_of(int o, int window) {
  return o < window ? o - window : o - window + 1;
}

__global__ void __launch_bounds__(kThreads)
pair_lists_kernel(const int32_t* __restrict__ walks, const int32_t* __restrict__ b_sh,
                  const uint8_t* __restrict__ vocab_mask, int n_walks, int length,
                  int window, int32_t* __restrict__ centers,
                  int32_t* __restrict__ contexts) {
  const int W2 = 2 * window;
  const int64_t n = static_cast<int64_t>(n_walks) * W2 * length;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  const int i = static_cast<int>(p % length);
  const int64_t t = p / length;
  const int o = static_cast<int>(t % W2);
  const int64_t base = (t / W2) * length;
  const int d = offset_of(o, window), j = i + d;
  const int c = walks[base + i];
  const int x = (j >= 0 && j < length) ? walks[base + j] : -1;  // -1 padded
  bool valid = c >= 0 && x >= 0 && abs(d) <= b_sh[base + i];
  valid = valid && vocab_mask[c] && vocab_mask[x];
  centers[p] = valid ? c : -1;
  contexts[p] = valid ? x : -1;
}

// One block's work, every array of a walk carved from sm: the dynamic shared
// memory, or the block's slice of a global workspace (staging.cuh).
__device__ __forceinline__ void
pair_grads_block(float* sm, const float* __restrict__ emb_in, const float* __restrict__ emb_out,
                 int dim, const int32_t* __restrict__ walks,
                 const int32_t* __restrict__ centers, const int32_t* __restrict__ neg_ids,
                 int n_walks, int length, int window, int n_neg, float neg_scale,
                 float* __restrict__ d_ci, float* __restrict__ d_co, float* __restrict__ d_no,
                 float* __restrict__ loss_parts) {
  const int L = length, D = dim, S = n_neg, W2 = 2 * window;
  float* xin = sm;              // [L, D] emb_in at the walk's positions
  float* xout = xin + L * D;    // [L, D] emb_out at the walk's positions
  float* gn = xout + L * D;     // [L, D] g_neg . no of each center
  float* no = gn + L * D;       // [S, D]
  float* dno = no + S * D;      // [S, D] block partial of d_no
  float* gneg = dno + S * D;    // [L, S] sigmoid(nl) * K/S, 0 for a dead center
  float* gpos = gneg + L * S;   // [2w, L] sigmoid(pos) - 1, 0 where invalid
  float* mult = gpos + W2 * L;  // [L] valid lanes of each center
  float* red = mult + L;        // [3 * kWarps]
  int* rows = reinterpret_cast<int*>(red + 3 * kWarps);  // [L]
  int* live = rows + L;                                  // [2w, L] lane valid

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < S * D; i += kThreads) {
    no[i] = emb_out[static_cast<int64_t>(neg_ids[i / D]) * D + i % D];
    dno[i] = 0.f;
  }
  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;

  for (int b = blockIdx.x; b < n_walks; b += gridDim.x) {
    const int64_t base = static_cast<int64_t>(b) * L;
    const int64_t lane0 = static_cast<int64_t>(b) * W2 * L;  // the walk's first lane
    for (int i = tid; i < L; i += kThreads) {
      const int v = walks[base + i];
      rows[i] = v >= 0 ? v : 0;
    }
    for (int q = tid; q < W2 * L; q += kThreads) live[q] = centers[lane0 + q] >= 0;
    __syncthreads();
    for (int i = tid; i < L * D; i += kThreads) {
      const int64_t r = static_cast<int64_t>(rows[i / D]) * D + i % D;
      xin[i] = emb_in[r];
      xout[i] = emb_out[r];
    }
    for (int i = tid; i < L; i += kThreads) {
      float m = 0.f;
      for (int o = 0; o < W2; ++o) m += live[o * L + i] ? 1.f : 0.f;
      mult[i] = m;
      mult_acc += m;
    }
    __syncthreads();

    // positive logits: one warp dot per valid lane
    for (int q = warp; q < W2 * L; q += kWarps) {
      const int o = q / L, i = q % L;
      float g = 0.f;
      if (live[q]) {
        const int j = i + offset_of(o, window);
        float acc = 0.f;
        for (int k = lane; k < D; k += 32) acc += xin[i * D + k] * xout[j * D + k];
        const float logit = warp_sum(acc);
        g = sigmoid(logit) - 1.f;
        if (lane == 0) pos_acc += log_sigmoid(logit);
      }
      if (lane == 0) gpos[q] = g;
    }
    // negative logits: one warp dot per (center with a valid lane, negative)
    for (int q = warp; q < L * S; q += kWarps) {
      const int i = q / S, s = q % S;
      float g = 0.f;
      if (mult[i] > 0.f) {
        float acc = 0.f;
        for (int k = lane; k < D; k += 32) acc += xin[i * D + k] * no[s * D + k];
        const float nl = warp_sum(acc);
        g = sigmoid(nl) * neg_scale;
        if (lane == 0) neg_acc += log_sigmoid(-nl) * mult[i];
      }
      if (lane == 0) gneg[q] = g;
    }
    __syncthreads();

    for (int e = tid; e < L * D; e += kThreads) {
      const int i = e / D, k = e % D;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += gneg[i * S + s] * no[s * D + k];
      gn[e] = acc;
    }
    for (int e = tid; e < S * D; e += kThreads) {
      const int s = e / D, k = e % D;
      float acc = 0.f;
      for (int i = 0; i < L; ++i) acc += mult[i] * gneg[i * S + s] * xin[i * D + k];
      dno[e] += acc;
    }
    __syncthreads();

    // per-lane gradients: the walk's lanes are one contiguous run
    float* ci_out = d_ci + lane0 * D;
    float* co_out = d_co + lane0 * D;
    for (int e = tid; e < W2 * L * D; e += kThreads) {
      const int q = e / D, k = e % D;
      const int o = q / L, i = q % L;
      float a = 0.f, c = 0.f;
      if (live[q]) {
        const int j = i + offset_of(o, window);
        a = gpos[q] * xout[j * D + k] + gn[i * D + k];
        c = gpos[q] * xin[i * D + k];
      }
      ci_out[e] = a;
      co_out[e] = c;
    }
    __syncthreads();  // the next walk overwrites the shared rows
  }

  for (int i = tid; i < S * D; i += kThreads) atomicAdd(d_no + i, dno[i]);
  pos_acc = warp_sum(pos_acc);
  neg_acc = warp_sum(neg_acc);
  mult_acc = warp_sum(mult_acc);
  if (lane == 0) {
    red[warp] = pos_acc;
    red[kWarps + warp] = neg_acc;
    red[2 * kWarps + warp] = mult_acc;
  }
  __syncthreads();
  if (tid < 3) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[tid * kWarps + w];
    loss_parts[3 * blockIdx.x + tid] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
pair_grads_kernel(const float* __restrict__ emb_in, const float* __restrict__ emb_out, int dim,
                  const int32_t* __restrict__ walks, const int32_t* __restrict__ centers,
                  const int32_t* __restrict__ neg_ids, int n_walks, int length, int window,
                  int n_neg, float neg_scale, float* __restrict__ d_ci,
                  float* __restrict__ d_co, float* __restrict__ d_no,
                  float* __restrict__ loss_parts) {
  extern __shared__ float sm[];
  pair_grads_block(sm, emb_in, emb_out, dim, walks, centers, neg_ids, n_walks, length, window,
                   n_neg, neg_scale, d_ci, d_co, d_no, loss_parts);
}

__global__ void __launch_bounds__(kThreads)
pair_grads_kernel_staged(const float* __restrict__ emb_in, const float* __restrict__ emb_out,
                         int dim, const int32_t* __restrict__ walks,
                         const int32_t* __restrict__ centers,
                         const int32_t* __restrict__ neg_ids, int n_walks, int length,
                         int window, int n_neg, float neg_scale, float* __restrict__ d_ci,
                         float* __restrict__ d_co, float* __restrict__ d_no,
                         float* __restrict__ loss_parts, float* __restrict__ ws,
                         int64_t ws_stride) {
  pair_grads_block(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, emb_in, emb_out, dim,
                   walks, centers, neg_ids, n_walks, length, window, n_neg, neg_scale, d_ci,
                   d_co, d_no, loss_parts);
}

size_t smem_bytes(int length, int dim, int n_neg, int window) {
  const size_t floats = 3 * static_cast<size_t>(length) * dim +
                        2 * static_cast<size_t>(n_neg) * dim +
                        static_cast<size_t>(length) * n_neg +
                        static_cast<size_t>(length) * 2 * window + length +
                        3 * kWarps;
  return floats * sizeof(float) +
         sizeof(int) * (static_cast<size_t>(length) + 2 * window * length);
}

}  // namespace

extern "C" size_t n2v_sgns_pair_grads_smem(int length, int dim, int n_neg, int window) {
  return smem_bytes(length, dim, n_neg, window);
}

// Launch 1: centers and contexts [n_walks * 2w * length], -1 where invalid.
extern "C" int n2v_pair_lists(const int32_t* walks, const int32_t* b_sh,
                              const uint8_t* vocab_mask, int n_walks, int length,
                              int window, int32_t* centers, int32_t* contexts,
                              void* stream) {
  const int64_t n = static_cast<int64_t>(n_walks) * 2 * window * length;
  if (n == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  pair_lists_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      walks, b_sh, vocab_mask, n_walks, length, window, centers, contexts);
  return static_cast<int>(cudaGetLastError());
}

// Launch 2, on launch 1's centers.  loss_parts must hold 3 * n_walks zeros;
// d_no must be zeroed [n_neg, dim].  ws null: the walk stages in shared
// memory; else in ws (staging.cuh).
extern "C" int n2v_sgns_pair_grads(const float* emb_in, const float* emb_out, int dim,
                                   const int32_t* walks, const int32_t* centers,
                                   const int32_t* neg_ids, int n_walks, int length,
                                   int window, int n_neg, float neg_scale, float* d_ci,
                                   float* d_co, float* d_no, float* loss_parts, float* ws,
                                   int ws_blocks, void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      pair_grads_kernel, pair_grads_kernel_staged, kThreads,
      smem_bytes(length, dim, n_neg, window), n_walks, ws, ws_blocks,
      static_cast<cudaStream_t>(stream), emb_in, emb_out, dim, walks, centers, neg_ids, n_walks,
      length, window, n_neg, neg_scale, d_ci, d_co, d_no, loss_parts);
}
