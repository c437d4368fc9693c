// K2 sgns_grads: the gradient half of one walk-structured SGNS step.
//
// Replaces node2vec_tpu/models/skipgram.py:344-398 (inside
// sgns_walk_step_impl, :261): the positional positive pairs over window
// offsets +-1..+-w with the shrunk-window mask, the positive grads g_in /
// g_out (the latter through the -d shift), the per-center multiplicity, the
// shared-negative logits nl = x_in . no^T, g_neg = sigmoid(nl) * mult * K/S,
// g_in += g_neg . no, d_no = g_neg^T . x_in, and both loss sums.  The
// row-wise Adagrad that follows is K3 + K4 (adagrad.cu).
//
// Design: a block walks over whole walks (grid-stride, one walk at a time),
// holding that walk's [L1, D] rows of emb_in and emb_out in shared memory
// together with the S shared negative rows, which it loads once.  Each
// (position, offset) positive logit and each (position, negative) logit is a
// warp dot product; the grads are then formed per (position, column) in the
// JAX order of offsets.  d_no is summed over the block's walks in shared
// memory and added to the global [S, D] with one fp32 atomic per element per
// block at the end, so the atomics are grid * S * D, not B * S * D.  Loss
// partials go to loss_parts[block] (pos, neg without the K/S factor, sum of
// mult) and are summed by the wrapper.
//
// Staging: a walk whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); the wrapper picks the mode from the shape.
//
// Bound on an H100: 3 * 2 * B * L1 * S * D flops (nl, g_neg . no and
// g_neg^T . x_in) on the fp32 CUDA cores, against 2 * B * L1 * D * 4 bytes of
// row reads and the same again of grads written.
//
// Routed mode (the row-sharded step, node2vec_tpu/parallel/rowsharded_sgns.py
// :270-344): the body is the same; only where a row comes from changes.
// emb_in and emb_out are then the [N * cap, D] buffers the owners sent back
// (K19's gather between two all_to_alls), the row of walk position p is
// emb_in[slot_in[p]] and emb_out[slot_out[p]], negative s is
// emb_out[slot_neg[s]] (K18's request slots: owner * cap + rank, -1 where
// the row was dropped on overflow, which reads as zeros), a position is valid
// only where both its slots are live (ok_in & ok_out), and when any negative
// was dropped every negative term of the step is masked (the JAX step's
// ok_neg.all(), :337), which each block checks from slot_neg itself.  The
// same shared and global staging, the same outputs.
//
// ld is the tables' row stride in floats: D for the [V, D] tables of every
// trainer, D + 1 for the fused [V, D+1] tables of sgns_walk_step_fused
// (skipgram.py:541-596 compute the same gradients from the first D columns;
// the accumulator in column D is read by K14, fused_adagrad.cu).  A row of
// D + 1 floats starts 4-byte aligned only, so its gather cannot use wider
// loads; the kernel reads one float a thread either way.

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

// One block's work, every array of a walk carved from sm: the dynamic shared
// memory, or the block's slice of a global workspace (staging.cuh).
// Routed mode's request slots (null in the direct mode)
struct Slots {
  const int32_t *in, *out, *neg;
};

template <bool kRouted>
__device__ __forceinline__ void
sgns_grads_block(float* sm, const float* __restrict__ emb_in, const float* __restrict__ emb_out,
                 int dim, int ld, const int32_t* __restrict__ walks,
                 const uint8_t* __restrict__ vocab_mask, const int32_t* __restrict__ b_sh,
                 const int32_t* __restrict__ neg_ids, int n_walks, int length, int window,
                 int n_neg, float neg_scale, float* __restrict__ g_in,
                 float* __restrict__ g_out, float* __restrict__ d_no,
                 float* __restrict__ loss_parts, Slots sl) {
  const int L = length, D = dim, S = n_neg, W2 = 2 * window;
  float* xin = sm;              // [L, D]
  float* xout = xin + L * D;    // [L, D]
  float* no = xout + L * D;     // [S, D]
  float* dno = no + S * D;      // [S, D] block partial of d_no
  float* gneg = dno + S * D;    // [L, S]
  float* gpos = gneg + L * S;   // [L, 2w]
  float* mult = gpos + L * W2;  // [L]
  float* red = mult + L;        // [3 * kWarps]
  int* rows = reinterpret_cast<int*>(red + 3 * kWarps);  // [L]
  int* vpos = rows + L;                                  // [L]
  int* bsh = vpos + L;                                   // [L]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float neg_live = 1.f;  // routed: 0 when any negative was dropped
  for (int i = tid; i < S * D; i += kThreads) {
    if (kRouted) {
      const int sn = sl.neg[i / D];
      no[i] = sn >= 0 ? emb_out[static_cast<int64_t>(sn) * ld + i % D] : 0.f;
    } else {
      no[i] = emb_out[static_cast<int64_t>(neg_ids[i / D]) * ld + i % D];
    }
    dno[i] = 0.f;
  }
  if (kRouted) {
    for (int s = 0; s < S; ++s)
      if (sl.neg[s] < 0) neg_live = 0.f;
  }
  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;

  for (int b = blockIdx.x; b < n_walks; b += gridDim.x) {
    const int64_t base = static_cast<int64_t>(b) * L;
    for (int i = tid; i < L; i += kThreads) {
      const int v = walks[base + i];
      const int safe = v >= 0 ? v : 0;
      rows[i] = safe;
      vpos[i] = v >= 0 && vocab_mask[safe] &&
                (!kRouted || (sl.in[base + i] >= 0 && sl.out[base + i] >= 0));
      bsh[i] = b_sh[base + i];
    }
    __syncthreads();
    for (int i = tid; i < L * D; i += kThreads) {
      if (kRouted) {
        const int si = sl.in[base + i / D], so = sl.out[base + i / D];
        xin[i] = si >= 0 ? emb_in[static_cast<int64_t>(si) * ld + i % D] : 0.f;
        xout[i] = so >= 0 ? emb_out[static_cast<int64_t>(so) * ld + i % D] : 0.f;
      } else {
        const int64_t r = static_cast<int64_t>(rows[i / D]) * ld + i % D;
        xin[i] = emb_in[r];
        xout[i] = emb_out[r];
      }
    }
    for (int i = tid; i < L; i += kThreads) {  // valid pairs per center
      float m = 0.f;
      for (int o = 0; o < W2; ++o) {
        const int d = offset_of(o, window), j = i + d;
        const bool pv = vpos[i] && j >= 0 && j < L && vpos[j] && abs(d) <= bsh[i];
        m += pv ? 1.f : 0.f;
      }
      mult[i] = m;
      mult_acc += m;
    }
    __syncthreads();

    // positive logits: one warp dot per (position, offset)
    for (int p = warp; p < L * W2; p += kWarps) {
      const int i = p / W2, o = p % W2;
      const int d = offset_of(o, window), j = i + d;
      float logit = 0.f;  // out of range: the zero-padded shift gives 0
      if (j >= 0 && j < L) {
        float acc = 0.f;
        for (int k = lane; k < D; k += 32) acc += xin[i * D + k] * xout[j * D + k];
        logit = warp_sum(acc);
      }
      const bool pv = vpos[i] && j >= 0 && j < L && vpos[j] && abs(d) <= bsh[i];
      if (lane == 0) {
        gpos[p] = pv ? sigmoid(logit) - 1.f : 0.f;
        if (pv) pos_acc += log_sigmoid(logit);
      }
    }
    // negative logits: one warp dot per (position, negative)
    for (int p = warp; p < L * S; p += kWarps) {
      const int i = p / S, s = p % S;
      float acc = 0.f;
      for (int k = lane; k < D; k += 32) acc += xin[i * D + k] * no[s * D + k];
      const float nl = warp_sum(acc);
      if (lane == 0) {
        const float m = mult[i] * neg_live;
        gneg[p] = sigmoid(nl) * m * neg_scale;
        neg_acc += log_sigmoid(-nl) * m;
      }
    }
    __syncthreads();

    // grads per (position, column), offsets in the JAX order
    for (int e = tid; e < L * D; e += kThreads) {
      const int i = e / D, k = e % D;
      float gi = 0.f, go = 0.f;
      for (int o = 0; o < W2; ++o) {
        const int d = offset_of(o, window);
        const int j = i + d;  // context of center i
        if (j >= 0 && j < L) gi += gpos[i * W2 + o] * xout[j * D + k];
        const int c = i - d;  // center whose offset-d context is i
        if (c >= 0 && c < L) go += gpos[c * W2 + o] * xin[c * D + k];
      }
      float gn = 0.f;
      for (int s = 0; s < S; ++s) gn += gneg[i * S + s] * no[s * D + k];
      g_in[base * D + e] = gi + gn;
      g_out[base * D + e] = go;
    }
    for (int e = tid; e < S * D; e += kThreads) {
      const int s = e / D, k = e % D;
      float acc = 0.f;
      for (int i = 0; i < L; ++i) acc += gneg[i * S + s] * xin[i * D + k];
      dno[e] += acc;
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

template <bool kRouted>
__global__ void __launch_bounds__(kThreads)
sgns_grads_kernel(const float* __restrict__ emb_in, const float* __restrict__ emb_out, int dim,
                  int ld, const int32_t* __restrict__ walks,
                  const uint8_t* __restrict__ vocab_mask, const int32_t* __restrict__ b_sh,
                  const int32_t* __restrict__ neg_ids, int n_walks, int length, int window,
                  int n_neg, float neg_scale, float* __restrict__ g_in,
                  float* __restrict__ g_out, float* __restrict__ d_no,
                  float* __restrict__ loss_parts, Slots sl) {
  extern __shared__ float sm[];
  sgns_grads_block<kRouted>(sm, emb_in, emb_out, dim, ld, walks, vocab_mask, b_sh, neg_ids,
                            n_walks, length, window, n_neg, neg_scale, g_in, g_out, d_no,
                            loss_parts, sl);
}

template <bool kRouted>
__global__ void __launch_bounds__(kThreads)
sgns_grads_kernel_staged(const float* __restrict__ emb_in, const float* __restrict__ emb_out,
                         int dim, int ld, const int32_t* __restrict__ walks,
                         const uint8_t* __restrict__ vocab_mask,
                         const int32_t* __restrict__ b_sh, const int32_t* __restrict__ neg_ids,
                         int n_walks, int length, int window, int n_neg, float neg_scale,
                         float* __restrict__ g_in, float* __restrict__ g_out,
                         float* __restrict__ d_no, float* __restrict__ loss_parts, Slots sl,
                         float* __restrict__ ws, int64_t ws_stride) {
  sgns_grads_block<kRouted>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, emb_in,
                            emb_out, dim, ld, walks, vocab_mask, b_sh, neg_ids, n_walks,
                            length, window, n_neg, neg_scale, g_in, g_out, d_no, loss_parts,
                            sl);
}

size_t smem_bytes(int length, int dim, int n_neg, int window) {
  const size_t floats = 2 * static_cast<size_t>(length) * dim +
                        2 * static_cast<size_t>(n_neg) * dim +
                        static_cast<size_t>(length) * n_neg +
                        static_cast<size_t>(length) * 2 * window + length +
                        3 * kWarps;
  return floats * sizeof(float) + 3 * sizeof(int) * length;
}

}  // namespace

extern "C" size_t n2v_sgns_grads_smem(int length, int dim, int n_neg, int window) {
  return smem_bytes(length, dim, n_neg, window);
}

// loss_parts must hold 3 * n_walks zeros; d_no must be zeroed [n_neg, dim];
// the tables are [V, ld] with ld >= dim, their first dim columns read.  ws
// null: the walk stages in shared memory; else in ws, ws_blocks blocks of
// n2v::staging_stride(n2v_sgns_grads_smem(...)) floats (staging.cuh).
extern "C" int n2v_sgns_grads(const float* emb_in, const float* emb_out, int dim,
                              int ld, const int32_t* walks, const uint8_t* vocab_mask,
                              const int32_t* b_sh, const int32_t* neg_ids,
                              int n_walks, int length, int window, int n_neg,
                              float neg_scale, float* g_in, float* g_out,
                              float* d_no, float* loss_parts, float* ws, int ws_blocks,
                              void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      sgns_grads_kernel<false>, sgns_grads_kernel_staged<false>, kThreads,
      smem_bytes(length, dim, n_neg, window), n_walks, ws, ws_blocks,
      static_cast<cudaStream_t>(stream), emb_in, emb_out, dim, ld, walks, vocab_mask, b_sh,
      neg_ids, n_walks, length, window, n_neg, neg_scale, g_in, g_out, d_no, loss_parts,
      Slots{nullptr, nullptr, nullptr});
}

// Routed mode: x_in and x_out are the [N * cap, dim] buffers the owners sent
// back (row stride dim); slot_in, slot_out [n_walks * length] and slot_neg
// [n_neg] the requests' rows in them (-1: dropped).  The shared memory is the
// direct mode's (n2v_sgns_grads_smem); the other arguments are n2v_sgns_grads's.
extern "C" int n2v_sgns_grads_routed(const float* x_in, const float* x_out, int dim,
                                     const int32_t* walks, const uint8_t* vocab_mask,
                                     const int32_t* b_sh, const int32_t* slot_in,
                                     const int32_t* slot_out, const int32_t* slot_neg,
                                     int n_walks, int length, int window, int n_neg,
                                     float neg_scale, float* g_in, float* g_out, float* d_no,
                                     float* loss_parts, float* ws, int ws_blocks,
                                     void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      sgns_grads_kernel<true>, sgns_grads_kernel_staged<true>, kThreads,
      smem_bytes(length, dim, n_neg, window), n_walks, ws, ws_blocks,
      static_cast<cudaStream_t>(stream), x_in, x_out, dim, dim, walks, vocab_mask, b_sh,
      static_cast<const int32_t*>(nullptr), n_walks, length, window, n_neg, neg_scale, g_in,
      g_out, d_no, loss_parts, Slots{slot_in, slot_out, slot_neg});
}
