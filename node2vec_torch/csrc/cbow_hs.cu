// K10 cbow_hs_grads: the gradient half of one walk-structured CBOW
// hierarchical-softmax step.
//
// Replaces node2vec_tpu/models/cbow.py:230 cbow_hs_step_impl up to the
// optimizer (:264-304, with _context_mean :60 and _scatter_context_grads
// :94).  h[i] and w_c[i] are K9's (cbow.cu); each trainable center is scored
// along its OWN Huffman path (no per-offset shift, no dense head): for
// every entry c < len(center),
//   logit = h[i] . theta[point_c(i)],  sgn = 1 - 2 * code_c(i),
//   loss -= log sigmoid(sgn * logit),  g = sigmoid(logit) - (1 + sgn) / 2,
//   g_h[i] += g * theta[point_c(i)]    (then / max(cnt, 1) under cbow_mean),
//   g_theta[(i, c)] = g * h[i], theta_rows[(i, c)] = point_c(i),
// where an entry of a dead or context-less position, or beyond the code,
// writes a zero row and theta_rows -1.  g_in[j] is the sum of g_h over the
// centers whose context j is.  Loss parts: the log-sigmoid sum and the
// number of trainable centers.  The row-wise Adagrad that follows is K3 + K4
// (adagrad.cu) over (g_in, walks) and (g_theta, theta_rows).
//
// Design: a block walks over whole walks (grid-stride, one walk at a time)
// with the walk's [L1, D] emb_in rows and h in shared memory.  One warp owns
// one position: it descends the position's path, each entry a warp dot
// product of h with the theta row read from global memory, and adds g times
// that row to the position's g_h row in shared memory (which takes the place
// of its emb_in row: no other warp writes it, and the entries are summed in
// path order).  g_in is then gathered from g_h per (position, column).
//
// Staging: a walk whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); the wrapper picks the mode from the shape.
//
// Bound on an H100: bytes — the per-occurrence path gradients written
// (B * L1 * CL * D * 4) and the theta rows on the paths read, against
// 5 * D flops per live path entry on the fp32 CUDA cores.

#include "cbow_common.cuh"

namespace {

using namespace cbow;

// One block's work, every array of a walk carved from sm: the dynamic shared
// memory, or the block's slice of a global workspace (staging.cuh).
__device__ __forceinline__ void
cbow_hs_grads_block(float* sm, const float* __restrict__ emb_in,
                    const float* __restrict__ theta, int dim, const int32_t* __restrict__ walks,
                    const uint8_t* __restrict__ vocab_mask, const int32_t* __restrict__ b_sh,
                    const int32_t* __restrict__ points, const int8_t* __restrict__ codes,
                    const int32_t* __restrict__ lengths, int cl, int n_walks, int length,
                    int window, int cbow_mean, float* __restrict__ g_in,
                    float* __restrict__ g_theta, int32_t* __restrict__ theta_rows,
                    float* __restrict__ loss_parts) {
  const int L = length, D = dim;
  float* xin = sm;           // [L, D] emb_in rows of the walk, then g_h
  float* h = xin + L * D;    // [L, D] hidden vectors
  float* cnt = h + L * D;    // [L] context counts
  float* red = cnt + L;      // [2 * kWarps]
  int* rows = reinterpret_cast<int*>(red + 2 * kWarps);  // [L] ids (0 where dead)
  int* vpos = rows + L;                                  // [L]
  int* bsh = vpos + L;                                   // [L]
  int* plen = bsh + L;                                   // [L] code lengths

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float loss_acc = 0.f, ctr_acc = 0.f;

  for (int b = blockIdx.x; b < n_walks; b += gridDim.x) {
    const int64_t base = static_cast<int64_t>(b) * L;
    for (int i = tid; i < L; i += kThreads) {
      const int v = walks[base + i];
      const int safe = v >= 0 ? v : 0;
      rows[i] = safe;
      vpos[i] = v >= 0 && vocab_mask[safe];
      bsh[i] = b_sh[base + i];
      plen[i] = lengths[safe];
    }
    __syncthreads();
    for (int e = tid; e < L * D; e += kThreads)
      xin[e] = emb_in[static_cast<int64_t>(rows[e / D]) * D + e % D];
    context_counts(vpos, bsh, L, window, cnt);
    __syncthreads();
    context_mean(xin, vpos, bsh, cnt, L, D, window, cbow_mean != 0, h);
    __syncthreads();

    // one warp a position: its path entries in order, g_h in place of its emb_in row
    for (int i = warp; i < L; i += kWarps) {
      const bool wc = vpos[i] && cnt[i] > 0.f;
      float* gh = xin + i * D;
      const float* hi = h + i * D;
      for (int k = lane; k < D; k += 32) gh[k] = 0.f;
      const int64_t path = static_cast<int64_t>(rows[i]) * cl;
      for (int c = 0; c < cl; ++c) {
        const bool live = wc && c < plen[i];
        const int row = points[path + c];
        float g = 0.f;
        if (live) {
          const float* th = theta + static_cast<int64_t>(row) * D;
          float acc = 0.f;
          for (int k = lane; k < D; k += 32) acc += hi[k] * th[k];
          const float logit = warp_sum(acc);
          const float sgn = 1.f - 2.f * static_cast<float>(codes[path + c]);
          g = sigmoid(logit) - (1.f + sgn) * 0.5f;
          if (lane == 0) loss_acc += log_sigmoid(sgn * logit);
          for (int k = lane; k < D; k += 32) gh[k] += g * th[k];
        }
        const int64_t entry = (base + i) * cl + c;
        float* gt = g_theta + entry * D;
        for (int k = lane; k < D; k += 32) gt[k] = g * hi[k];
        if (lane == 0) theta_rows[entry] = live ? row : -1;
      }
      if (cbow_mean) {
        const float inv = fmaxf(cnt[i], 1.f);
        for (int k = lane; k < D; k += 32) gh[k] = gh[k] / inv;
      }
      if (lane == 0 && wc) ctr_acc += 1.f;
    }
    __syncthreads();
    scatter_context(xin, vpos, bsh, L, D, window, g_in + base * D);
    __syncthreads();  // the next walk overwrites the shared rows
  }

  loss_acc = warp_sum(loss_acc);
  ctr_acc = warp_sum(ctr_acc);
  if (lane == 0) {
    red[warp] = loss_acc;
    red[kWarps + warp] = ctr_acc;
  }
  __syncthreads();
  if (tid < 2) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[tid * kWarps + w];
    loss_parts[2 * blockIdx.x + tid] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
cbow_hs_grads_kernel(const float* __restrict__ emb_in, const float* __restrict__ theta, int dim,
                     const int32_t* __restrict__ walks, const uint8_t* __restrict__ vocab_mask,
                     const int32_t* __restrict__ b_sh, const int32_t* __restrict__ points,
                     const int8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                     int cl, int n_walks, int length, int window, int cbow_mean,
                     float* __restrict__ g_in, float* __restrict__ g_theta,
                     int32_t* __restrict__ theta_rows, float* __restrict__ loss_parts) {
  extern __shared__ float sm[];
  cbow_hs_grads_block(sm, emb_in, theta, dim, walks, vocab_mask, b_sh, points, codes, lengths,
                      cl, n_walks, length, window, cbow_mean, g_in, g_theta, theta_rows,
                      loss_parts);
}

__global__ void __launch_bounds__(kThreads)
cbow_hs_grads_kernel_staged(const float* __restrict__ emb_in, const float* __restrict__ theta,
                            int dim, const int32_t* __restrict__ walks,
                            const uint8_t* __restrict__ vocab_mask,
                            const int32_t* __restrict__ b_sh,
                            const int32_t* __restrict__ points,
                            const int8_t* __restrict__ codes,
                            const int32_t* __restrict__ lengths, int cl, int n_walks,
                            int length, int window, int cbow_mean, float* __restrict__ g_in,
                            float* __restrict__ g_theta, int32_t* __restrict__ theta_rows,
                            float* __restrict__ loss_parts, float* __restrict__ ws,
                            int64_t ws_stride) {
  cbow_hs_grads_block(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, emb_in, theta, dim,
                      walks, vocab_mask, b_sh, points, codes, lengths, cl, n_walks, length,
                      window, cbow_mean, g_in, g_theta, theta_rows, loss_parts);
}

size_t smem_bytes(int length, int dim) {
  const size_t floats = 2 * static_cast<size_t>(length) * dim + length + 2 * kWarps;
  return floats * sizeof(float) + 4 * sizeof(int) * static_cast<size_t>(length);
}

}  // namespace

extern "C" size_t n2v_cbow_hs_grads_smem(int length, int dim) {
  return smem_bytes(length, dim);
}

// loss_parts must hold 2 * n_walks zeros.  g_in [n_walks * length, dim],
// g_theta [n_walks * length * cl, dim] and theta_rows [n_walks * length * cl]
// are written whole.  ws null: the walk stages in shared memory; else in ws
// (staging.cuh).
extern "C" int n2v_cbow_hs_grads(const float* emb_in, const float* theta, int dim,
                                 const int32_t* walks, const uint8_t* vocab_mask,
                                 const int32_t* b_sh, const int32_t* points,
                                 const int8_t* codes, const int32_t* lengths, int cl,
                                 int n_walks, int length, int window, int cbow_mean,
                                 float* g_in, float* g_theta, int32_t* theta_rows,
                                 float* loss_parts, float* ws, int ws_blocks, void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      cbow_hs_grads_kernel, cbow_hs_grads_kernel_staged, kThreads,
      smem_bytes(length, dim), n_walks, ws, ws_blocks, static_cast<cudaStream_t>(stream),
      emb_in, theta, dim, walks, vocab_mask, b_sh, points, codes, lengths, cl, n_walks, length,
      window, cbow_mean, g_in, g_theta, theta_rows, loss_parts);
}
