// K8 hs_grads: the gradient half of one walk-structured hierarchical-softmax
// skip-gram step.
//
// Replaces node2vec_tpu/models/hsoftmax.py:209 hs_walk_step_impl up to the
// optimizer (:255-380, and the head closure :388-395): for every valid
// (center i, context j = i + d) pair, valid_pos[i] & valid_pos[j] &
// |d| <= b_sh[i], and every entry c < len(j) of the context's Huffman path,
//   logit = x_in[i] . theta[point_c(j)],  sgn = 1 - 2 * code_c(j),
//   loss -= log sigmoid(sgn * logit),  g = sigmoid(logit) - (1 + sgn) / 2,
//   g_in[i] += g * theta[point_c(j)],
// and the path entry's gradient g * x_in[i], summed over the centers that
// pair with context j, goes to
//   - g_tail[(j, c - H)] for tail levels c >= H (one row per occurrence, the
//     (-d)-shifted sum of :348-352), with its theta row in tail_rows, or -1
//     where the position is dead or c >= len(j);
//   - d_head[point_c(j)] for head levels c < H, pre-aggregated over the
//     batch (:393-395).
// Head entries are scored as dot products with theta[point], the number the
// JAX package picks from its [B*L1, D] @ [D, K] matmul by one-hot selects.
// The row-wise Adagrad that follows is K3 + K4 (adagrad.cu).
//
// Design: a block walks over whole walks (grid-stride, one walk at a time),
// holding the walk's [L1, D] emb_in rows, its g_in and its paths in shared
// memory.  It goes down the tree one level at a time: it loads every
// context's level-c theta row ([L1, D]), computes the g of each (center,
// offset) pair as a warp dot product, then per (position, column) adds the
// pairs' terms to g_in and forms the position's gradient as a context.
// Every root-to-leaf path passes the root, so d_head's first rows would
// serialise on global atomics from every pair: the first kSharedHeadRows
// rows (levels 0-5 with their 63 nodes) are summed in shared memory over
// all the block's walks and added with one fp32 atomic per element per
// block at the end; deeper head rows (each on at most ~1/64 of the paths)
// take global atomics, one per (position, column) of the walk.  Loss parts
// go to loss_parts[block] (the log-sigmoid sum and the pair count).
//
// Routed mode (the row-sharded step, node2vec_tpu/parallel/rowsharded_hs.py
// :156-298): the body is the same; only where a row comes from changes.
// emb_in is then the [N * cap_in, D] buffer of centers the owners sent back
// and theta the [N * cap_th, D] buffer of tail path rows: the center of walk
// position p is emb_in[slot_in[p]], and the level-c (c >= H) theta row of
// context position p is theta[slot_th[p * CLT + c - H]] (K18's request
// slots, -1 where dropped on overflow).  Head levels (c < H) read the
// all-gathered head table head [K, D] at their inner-node id.  A position
// is valid only where its center slot is live (plan_in.ok), and a tail path
// entry is masked where its slot is -1 (plan_th.ok): no loss, no gradient,
// and tail_rows -1.  The same shared and global staging, the same outputs.
//
// Staging: a walk whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); the wrapper picks the mode from the shape.
//
// Bound on an H100: the per-occurrence tail gradients written (B * L1 * CLT
// * D * 4 bytes) against 6 * D flops per live (pair, path entry) on the fp32
// CUDA cores.

#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSharedHeadRows = 64;

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

__host__ __device__ __forceinline__ int shared_head_rows(int k_rows) {
  return k_rows < kSharedHeadRows ? k_rows : kSharedHeadRows;
}

// Routed mode's request slots and head table (null in the direct mode)
struct Routes {
  const int32_t *in, *th;
  const float* head;
};

// One block's work, every array of a walk carved from sm: the dynamic shared
// memory, or the block's slice of a global workspace (staging.cuh).
template <bool kRouted>
__device__ __forceinline__ void
hs_grads_block(float* sm, const float* __restrict__ emb_in, const float* __restrict__ theta,
               int dim, const int32_t* __restrict__ walks,
               const uint8_t* __restrict__ vocab_mask, const int32_t* __restrict__ b_sh,
               const int32_t* __restrict__ points, const int8_t* __restrict__ codes,
               const int32_t* __restrict__ lengths, int cl, int n_walks, int length, int window,
               int n_head, int k_rows, float* __restrict__ g_in, float* __restrict__ g_tail,
               int32_t* __restrict__ tail_rows, float* __restrict__ d_head,
               float* __restrict__ loss_parts, Routes rt) {
  const int L = length, D = dim, W2 = 2 * window, CLT = cl - n_head;
  const int KS = shared_head_rows(k_rows);
  float* xin = sm;              // [L, D] emb_in rows of the walk
  float* gin = xin + L * D;     // [L, D] g_in of the walk
  float* thc = gin + L * D;     // [L, D] each context's level-c theta row
  float* dhs = thc + L * D;     // [KS, D] block partial of d_head's first rows
  float* gm = dhs + KS * D;     // [L, 2w] g of each (center, offset) at level c
  float* red = gm + L * W2;     // [2 * kWarps]
  int* walk = reinterpret_cast<int*>(red + 2 * kWarps);  // [L] raw ids (-1 dead)
  int* vpos = walk + L;                                  // [L]
  int* plen = vpos + L;                                  // [L]
  int* bsh = plen + L;                                   // [L]
  int* pts = bsh + L;                                    // [L, CL]
  int* cds = pts + L * cl;                               // [L, CL]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < KS * D; i += kThreads) dhs[i] = 0.f;
  float loss_acc = 0.f, pair_acc = 0.f;

  for (int b = blockIdx.x; b < n_walks; b += gridDim.x) {
    const int64_t base = static_cast<int64_t>(b) * L;
    for (int i = tid; i < L; i += kThreads) {
      const int v = walks[base + i];
      const int safe = v >= 0 ? v : 0;
      walk[i] = v;
      vpos[i] = v >= 0 && vocab_mask[safe] && (!kRouted || rt.in[base + i] >= 0);
      plen[i] = lengths[safe];
      bsh[i] = b_sh[base + i];
    }
    __syncthreads();
    for (int e = tid; e < L * cl; e += kThreads) {
      const int i = e / cl, c = e % cl;
      const int64_t src = static_cast<int64_t>(walk[i] >= 0 ? walk[i] : 0) * cl + c;
      pts[e] = points[src];
      cds[e] = codes[src];
    }
    for (int e = tid; e < L * D; e += kThreads) {
      const int i = e / D;
      if (kRouted) {
        const int si = rt.in[base + i];
        xin[e] = si >= 0 ? emb_in[static_cast<int64_t>(si) * D + e % D] : 0.f;
      } else {
        xin[e] = emb_in[static_cast<int64_t>(walk[i] >= 0 ? walk[i] : 0) * D + e % D];
      }
      gin[e] = 0.f;
    }
    for (int i = tid; i < L; i += kThreads) {  // valid pairs with center i
      float m = 0.f;
      for (int o = 0; o < W2; ++o) {
        const int d = offset_of(o, window), j = i + d;
        m += (vpos[i] && j >= 0 && j < L && vpos[j] && abs(d) <= bsh[i]) ? 1.f : 0.f;
      }
      pair_acc += m;
    }
    __syncthreads();
    for (int e = tid; e < L * CLT; e += kThreads) {  // tail rows of the walk
      const int i = e / CLT, c = n_head + e % CLT;
      tail_rows[base * CLT + e] =
          (walk[i] >= 0 && c < plen[i] && (!kRouted || rt.th[base * CLT + e] >= 0))
              ? pts[i * cl + c]
              : -1;
    }

    for (int c = 0; c < cl; ++c) {
      for (int e = tid; e < L * D; e += kThreads) {
        const int j = e / D;
        float t = 0.f;
        if (vpos[j] && c < plen[j]) {
          if (!kRouted) {
            t = theta[static_cast<int64_t>(pts[j * cl + c]) * D + e % D];
          } else if (c < n_head) {
            t = rt.head[static_cast<int64_t>(pts[j * cl + c]) * D + e % D];
          } else {
            const int st = rt.th[(base + j) * CLT + (c - n_head)];
            t = st >= 0 ? theta[static_cast<int64_t>(st) * D + e % D] : 0.f;
          }
        }
        thc[e] = t;
      }
      __syncthreads();

      // g of each (center, offset): one warp dot product per live pair
      for (int p = warp; p < L * W2; p += kWarps) {
        const int i = p / W2, o = p % W2;
        const int d = offset_of(o, window), j = i + d;
        const bool live = vpos[i] && j >= 0 && j < L && vpos[j] && abs(d) <= bsh[i] &&
                          c < plen[j] &&
                          (!kRouted || c < n_head || rt.th[(base + j) * CLT + (c - n_head)] >= 0);
        float g = 0.f;
        if (live) {
          float acc = 0.f;
          for (int k = lane; k < D; k += 32) acc += xin[i * D + k] * thc[j * D + k];
          const float logit = warp_sum(acc);
          const float sgn = 1.f - 2.f * static_cast<float>(cds[j * cl + c]);
          g = sigmoid(logit) - (1.f + sgn) * 0.5f;
          if (lane == 0) loss_acc += log_sigmoid(sgn * logit);
        }
        if (lane == 0) gm[p] = g;
      }
      __syncthreads();

      // per (position, column): g_in of the position as a center, and the
      // gradient of its level-c path entry as a context
      for (int e = tid; e < L * D; e += kThreads) {
        const int i = e / D, k = e % D;
        float gi = 0.f, gc = 0.f;
        for (int o = 0; o < W2; ++o) {
          const int d = offset_of(o, window);
          const int j = i + d;  // context of center i
          if (j >= 0 && j < L) gi += gm[i * W2 + o] * thc[j * D + k];
          const int ctr = i - d;  // center whose offset-d context is i
          if (ctr >= 0 && ctr < L) gc += gm[ctr * W2 + o] * xin[ctr * D + k];
        }
        gin[e] += gi;
        if (c >= n_head) {
          g_tail[((base + i) * CLT + (c - n_head)) * D + k] = gc;
        } else if (vpos[i] && c < plen[i]) {
          const int row = pts[i * cl + c];
          if (row < KS) {
            atomicAdd(dhs + row * D + k, gc);
          } else {
            atomicAdd(d_head + static_cast<int64_t>(row) * D + k, gc);
          }
        }
      }
      __syncthreads();  // the next level overwrites thc and gm
    }
    for (int e = tid; e < L * D; e += kThreads) g_in[base * D + e] = gin[e];
    __syncthreads();  // the next walk overwrites the shared rows and paths
  }

  for (int i = tid; i < KS * D; i += kThreads) atomicAdd(d_head + i, dhs[i]);
  loss_acc = warp_sum(loss_acc);
  pair_acc = warp_sum(pair_acc);
  if (lane == 0) {
    red[warp] = loss_acc;
    red[kWarps + warp] = pair_acc;
  }
  __syncthreads();
  if (tid < 2) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[tid * kWarps + w];
    loss_parts[2 * blockIdx.x + tid] = t;
  }
}

template <bool kRouted>
__global__ void __launch_bounds__(kThreads)
hs_grads_kernel(const float* __restrict__ emb_in, const float* __restrict__ theta, int dim,
                const int32_t* __restrict__ walks, const uint8_t* __restrict__ vocab_mask,
                const int32_t* __restrict__ b_sh, const int32_t* __restrict__ points,
                const int8_t* __restrict__ codes, const int32_t* __restrict__ lengths, int cl,
                int n_walks, int length, int window, int n_head, int k_rows,
                float* __restrict__ g_in, float* __restrict__ g_tail,
                int32_t* __restrict__ tail_rows, float* __restrict__ d_head,
                float* __restrict__ loss_parts, Routes rt) {
  extern __shared__ float sm[];
  hs_grads_block<kRouted>(sm, emb_in, theta, dim, walks, vocab_mask, b_sh, points, codes,
                          lengths, cl, n_walks, length, window, n_head, k_rows, g_in, g_tail,
                          tail_rows, d_head, loss_parts, rt);
}

template <bool kRouted>
__global__ void __launch_bounds__(kThreads)
hs_grads_kernel_staged(const float* __restrict__ emb_in, const float* __restrict__ theta,
                       int dim, const int32_t* __restrict__ walks,
                       const uint8_t* __restrict__ vocab_mask, const int32_t* __restrict__ b_sh,
                       const int32_t* __restrict__ points, const int8_t* __restrict__ codes,
                       const int32_t* __restrict__ lengths, int cl, int n_walks, int length,
                       int window, int n_head, int k_rows, float* __restrict__ g_in,
                       float* __restrict__ g_tail, int32_t* __restrict__ tail_rows,
                       float* __restrict__ d_head, float* __restrict__ loss_parts, Routes rt,
                       float* __restrict__ ws, int64_t ws_stride) {
  hs_grads_block<kRouted>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, emb_in, theta,
                          dim, walks, vocab_mask, b_sh, points, codes, lengths, cl, n_walks,
                          length, window, n_head, k_rows, g_in, g_tail, tail_rows, d_head,
                          loss_parts, rt);
}

size_t smem_bytes(int length, int dim, int cl, int window, int k_rows) {
  const size_t floats = 3 * static_cast<size_t>(length) * dim +
                        static_cast<size_t>(shared_head_rows(k_rows)) * dim +
                        static_cast<size_t>(length) * 2 * window + 2 * kWarps;
  const size_t ints = 4 * static_cast<size_t>(length) + 2 * static_cast<size_t>(length) * cl;
  return floats * sizeof(float) + ints * sizeof(int);
}

}  // namespace

extern "C" size_t n2v_hs_grads_smem(int length, int dim, int cl, int window, int k_rows) {
  return smem_bytes(length, dim, cl, window, k_rows);
}

// loss_parts must hold 2 * n_walks zeros; d_head must be zeroed [k_rows, dim].
// g_in [n_walks * length, dim], g_tail [n_walks * length * (cl - n_head), dim]
// and tail_rows [n_walks * length * (cl - n_head)] are written whole.  ws
// null: the walk stages in shared memory; else in ws (staging.cuh).
extern "C" int n2v_hs_grads(const float* emb_in, const float* theta, int dim,
                            const int32_t* walks, const uint8_t* vocab_mask,
                            const int32_t* b_sh, const int32_t* points,
                            const int8_t* codes, const int32_t* lengths, int cl,
                            int n_walks, int length, int window, int n_head,
                            int k_rows, float* g_in, float* g_tail, int32_t* tail_rows,
                            float* d_head, float* loss_parts, float* ws, int ws_blocks,
                            void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      hs_grads_kernel<false>, hs_grads_kernel_staged<false>, kThreads,
      smem_bytes(length, dim, cl, window, k_rows), n_walks, ws, ws_blocks,
      static_cast<cudaStream_t>(stream), emb_in, theta, dim, walks, vocab_mask, b_sh, points,
      codes, lengths, cl, n_walks, length, window, n_head, k_rows, g_in, g_tail, tail_rows,
      d_head, loss_parts, Routes{nullptr, nullptr, nullptr});
}

// Routed mode: x_in [N * cap_in, dim] and th [N * cap_th, dim] the buffers
// the owners sent back, slot_in [n_walks * length] and slot_th [n_walks *
// length * (cl - n_head)] the requests' rows in them (-1: dropped), head
// [k_rows, dim] the all-gathered head rows.  The shared memory is the direct
// mode's (n2v_hs_grads_smem); the outputs are n2v_hs_grads's.
extern "C" int n2v_hs_grads_routed(const float* x_in, const float* th, const float* head,
                                   int dim, const int32_t* walks, const uint8_t* vocab_mask,
                                   const int32_t* b_sh, const int32_t* points,
                                   const int8_t* codes, const int32_t* lengths,
                                   const int32_t* slot_in, const int32_t* slot_th, int cl,
                                   int n_walks, int length, int window, int n_head, int k_rows,
                                   float* g_in, float* g_tail, int32_t* tail_rows,
                                   float* d_head, float* loss_parts, float* ws, int ws_blocks,
                                   void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      hs_grads_kernel<true>, hs_grads_kernel_staged<true>, kThreads,
      smem_bytes(length, dim, cl, window, k_rows), n_walks, ws, ws_blocks,
      static_cast<cudaStream_t>(stream), x_in, th, dim, walks, vocab_mask, b_sh, points,
      codes, lengths, cl, n_walks, length, window, n_head, k_rows, g_in, g_tail, tail_rows,
      d_head, loss_parts, Routes{slot_in, slot_th, head});
}
