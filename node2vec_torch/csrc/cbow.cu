// K9 cbow_grads: the gradient half of one walk-structured CBOW
// negative-sampling step.
//
// Replaces node2vec_tpu/models/cbow.py:112 cbow_walk_step_impl up to the
// optimizer (:148-196, with _context_mean :60 and _scatter_context_grads
// :94).  For every position i, its contexts are the positions j = i + d with
// valid_pos[i] & valid_pos[j] & |d| <= b_sh[i], cnt[i] of them, and
//   h[i]        = sum of the contexts' emb_in rows (/ max(cnt, 1) under cbow_mean),
//   w_c[i]      = valid_pos[i] & cnt[i] > 0 (a trainable center),
//   g_pos[i]    = (sigmoid(h[i] . emb_out[i]) - 1) * w_c[i],
//   g_neg[i, s] = sigmoid(h[i] . no[s]) * w_c[i] * K/S over the S shared negatives,
//   g_h[i]      = g_pos[i] emb_out[i] + sum_s g_neg[i, s] no[s] (/ max(cnt, 1) under
//                 cbow_mean),
//   g_in[j]     = sum of g_h over the centers whose context j is,
//   d_out[i]    = g_pos[i] h[i],  d_no = g_neg^T h,
// with the loss parts (sum of w_c log sigmoid(pos), of w_c log sigmoid(-nl)
// without the K/S factor, and of w_c).  The row-wise Adagrad that follows is
// K3 + K4 (adagrad.cu) over (g_in, walks), (d_out, walks), (d_no, negatives).
//
// Design (K2's, sgns.cu): a block walks over whole walks (grid-stride, one
// walk at a time), holding the walk's [L1, D] rows of emb_in and emb_out and
// h in shared memory, with the S shared negative rows loaded once.  h is a
// per-(position, column) sum over the window; the positive logit of each
// trainable center and each (center, negative) logit is a warp dot product
// (dead and context-less centers are skipped); g_h then replaces the emb_in
// rows, and g_in is gathered from it per (position, column).  d_no is summed
// over the block's walks in shared memory and added with one fp32 atomic per
// element per block at the end.  Loss parts go to loss_parts[block].
//
// Staging: a walk whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); the wrapper picks the mode from the shape.
//
// Bound on an H100: about (6 S + 8 w + 5) flops per (position, column) on
// the fp32 CUDA cores (the [B*L1, S] logits, g_neg . no and g_neg^T . h
// dominate), against the distinct rows read and the live rows' grads written.

#include "cbow_common.cuh"

namespace {

using namespace cbow;

// One block's work, every array of a walk carved from sm: the dynamic shared
// memory, or the block's slice of a global workspace (staging.cuh).
__device__ __forceinline__ void
cbow_grads_block(float* sm, const float* __restrict__ emb_in, const float* __restrict__ emb_out,
                 int dim, const int32_t* __restrict__ walks,
                 const uint8_t* __restrict__ vocab_mask, const int32_t* __restrict__ b_sh,
                 const int32_t* __restrict__ neg_ids, int n_walks, int length, int window,
                 int n_neg, float neg_scale, int cbow_mean, float* __restrict__ g_in,
                 float* __restrict__ d_out, float* __restrict__ d_no,
                 float* __restrict__ loss_parts) {
  const int L = length, D = dim, S = n_neg;
  float* xin = sm;             // [L, D] emb_in rows of the walk, then g_h
  float* xout = xin + L * D;   // [L, D] emb_out rows of the walk (each center's own)
  float* h = xout + L * D;     // [L, D] hidden vectors
  float* no = h + L * D;       // [S, D] shared negative rows
  float* dno = no + S * D;     // [S, D] block partial of d_no
  float* gneg = dno + S * D;   // [L, S]
  float* gpos = gneg + L * S;  // [L]
  float* cnt = gpos + L;       // [L] context counts
  float* red = cnt + L;        // [3 * kWarps]
  int* rows = reinterpret_cast<int*>(red + 3 * kWarps);  // [L] ids (0 where dead)
  int* vpos = rows + L;                                  // [L]
  int* bsh = vpos + L;                                   // [L]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < S * D; i += kThreads) {
    no[i] = emb_out[static_cast<int64_t>(neg_ids[i / D]) * D + i % D];
    dno[i] = 0.f;
  }
  float pos_acc = 0.f, neg_acc = 0.f, ctr_acc = 0.f;

  for (int b = blockIdx.x; b < n_walks; b += gridDim.x) {
    const int64_t base = static_cast<int64_t>(b) * L;
    for (int i = tid; i < L; i += kThreads) {
      const int v = walks[base + i];
      const int safe = v >= 0 ? v : 0;
      rows[i] = safe;
      vpos[i] = v >= 0 && vocab_mask[safe];
      bsh[i] = b_sh[base + i];
    }
    __syncthreads();
    for (int e = tid; e < L * D; e += kThreads) {
      const int64_t r = static_cast<int64_t>(rows[e / D]) * D + e % D;
      xin[e] = emb_in[r];
      xout[e] = emb_out[r];
    }
    context_counts(vpos, bsh, L, window, cnt);
    __syncthreads();
    context_mean(xin, vpos, bsh, cnt, L, D, window, cbow_mean != 0, h);
    __syncthreads();

    // positive logits: one warp dot per trainable center
    for (int i = warp; i < L; i += kWarps) {
      const bool wc = vpos[i] && cnt[i] > 0.f;
      float g = 0.f;
      if (wc) {
        float acc = 0.f;
        for (int k = lane; k < D; k += 32) acc += h[i * D + k] * xout[i * D + k];
        const float logit = warp_sum(acc);
        g = sigmoid(logit) - 1.f;
        if (lane == 0) {
          pos_acc += log_sigmoid(logit);
          ctr_acc += 1.f;
        }
      }
      if (lane == 0) gpos[i] = g;
    }
    // negative logits: one warp dot per (trainable center, negative)
    for (int p = warp; p < L * S; p += kWarps) {
      const int i = p / S, s = p % S;
      float g = 0.f;
      if (vpos[i] && cnt[i] > 0.f) {
        float acc = 0.f;
        for (int k = lane; k < D; k += 32) acc += h[i * D + k] * no[s * D + k];
        const float nl = warp_sum(acc);
        g = sigmoid(nl) * neg_scale;
        if (lane == 0) neg_acc += log_sigmoid(-nl);
      }
      if (lane == 0) gneg[p] = g;
    }
    __syncthreads();

    // g_h (into xin, read no more) and d_out per (position, column); the
    // block's part of d_no per (negative, column)
    for (int e = tid; e < L * D; e += kThreads) {
      const int i = e / D, k = e % D;
      float g = gpos[i] * xout[e];
      for (int s = 0; s < S; ++s) g += gneg[i * S + s] * no[s * D + k];
      xin[e] = cbow_mean ? g / fmaxf(cnt[i], 1.f) : g;
      d_out[base * D + e] = gpos[i] * h[e];
    }
    for (int e = tid; e < S * D; e += kThreads) {
      const int s = e / D, k = e % D;
      float acc = 0.f;
      for (int i = 0; i < L; ++i) acc += gneg[i * S + s] * h[i * D + k];
      dno[e] += acc;
    }
    __syncthreads();
    scatter_context(xin, vpos, bsh, L, D, window, g_in + base * D);
    __syncthreads();  // the next walk overwrites the shared rows
  }

  for (int i = tid; i < S * D; i += kThreads) atomicAdd(d_no + i, dno[i]);
  pos_acc = warp_sum(pos_acc);
  neg_acc = warp_sum(neg_acc);
  ctr_acc = warp_sum(ctr_acc);
  if (lane == 0) {
    red[warp] = pos_acc;
    red[kWarps + warp] = neg_acc;
    red[2 * kWarps + warp] = ctr_acc;
  }
  __syncthreads();
  if (tid < 3) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[tid * kWarps + w];
    loss_parts[3 * blockIdx.x + tid] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
cbow_grads_kernel(const float* __restrict__ emb_in, const float* __restrict__ emb_out, int dim,
                  const int32_t* __restrict__ walks, const uint8_t* __restrict__ vocab_mask,
                  const int32_t* __restrict__ b_sh, const int32_t* __restrict__ neg_ids,
                  int n_walks, int length, int window, int n_neg, float neg_scale,
                  int cbow_mean, float* __restrict__ g_in, float* __restrict__ d_out,
                  float* __restrict__ d_no, float* __restrict__ loss_parts) {
  extern __shared__ float sm[];
  cbow_grads_block(sm, emb_in, emb_out, dim, walks, vocab_mask, b_sh, neg_ids, n_walks, length,
                   window, n_neg, neg_scale, cbow_mean, g_in, d_out, d_no, loss_parts);
}

__global__ void __launch_bounds__(kThreads)
cbow_grads_kernel_staged(const float* __restrict__ emb_in, const float* __restrict__ emb_out,
                         int dim, const int32_t* __restrict__ walks,
                         const uint8_t* __restrict__ vocab_mask,
                         const int32_t* __restrict__ b_sh, const int32_t* __restrict__ neg_ids,
                         int n_walks, int length, int window, int n_neg, float neg_scale,
                         int cbow_mean, float* __restrict__ g_in, float* __restrict__ d_out,
                         float* __restrict__ d_no, float* __restrict__ loss_parts,
                         float* __restrict__ ws, int64_t ws_stride) {
  cbow_grads_block(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, emb_in, emb_out, dim,
                   walks, vocab_mask, b_sh, neg_ids, n_walks, length, window, n_neg, neg_scale,
                   cbow_mean, g_in, d_out, d_no, loss_parts);
}

size_t smem_bytes(int length, int dim, int n_neg) {
  const size_t floats = 3 * static_cast<size_t>(length) * dim +
                        2 * static_cast<size_t>(n_neg) * dim +
                        static_cast<size_t>(length) * n_neg + 2 * static_cast<size_t>(length) +
                        3 * kWarps;
  return floats * sizeof(float) + 3 * sizeof(int) * static_cast<size_t>(length);
}

}  // namespace

extern "C" size_t n2v_cbow_grads_smem(int length, int dim, int n_neg) {
  return smem_bytes(length, dim, n_neg);
}

// loss_parts must hold 3 * n_walks zeros; d_no must be zeroed [n_neg, dim].
// g_in and d_out [n_walks * length, dim] are written whole.  ws null: the
// walk stages in shared memory; else in ws (staging.cuh).
extern "C" int n2v_cbow_grads(const float* emb_in, const float* emb_out, int dim,
                              const int32_t* walks, const uint8_t* vocab_mask,
                              const int32_t* b_sh, const int32_t* neg_ids, int n_walks,
                              int length, int window, int n_neg, float neg_scale,
                              int cbow_mean, float* g_in, float* d_out, float* d_no,
                              float* loss_parts, float* ws, int ws_blocks, void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      cbow_grads_kernel, cbow_grads_kernel_staged, kThreads,
      smem_bytes(length, dim, n_neg), n_walks, ws, ws_blocks,
      static_cast<cudaStream_t>(stream), emb_in, emb_out, dim, walks, vocab_mask, b_sh, neg_ids,
      n_walks, length, window, n_neg, neg_scale, cbow_mean, g_in, d_out, d_no, loss_parts);
}
