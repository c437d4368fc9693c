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
// Bound on an H100: 6 * B * L1 * D * (S + 2w) flops at the fp32 rate
// (3.05 GFLOP at B = 2,560, L1 = 21, D = 128, S = 64, w = 5: 0.0456 ms),
// against 110.6 MB of row reads and grad writes (0.033 ms).  The products
// are matrix products, so the design puts them on the tensor cores:
//
// * Walk groups.  A persistent grid (one block of 16 warps an SM) walks
//   over groups of G = 64 / L1 walks (one walk when L1 > 64): the group's
//   G * L1 positions make the rows of one M-tile of Mt = G * L1 rounded up
//   to 16 (L1 = 21: 3 walks, 63 of 64 rows).  Its negative half is three
//   products,
//     NL = X_in . NO^T [Mt, S],  g_in += Gneg . NO,  d_no += Gneg^T . X_in,
//   and its positive half three banded ones on the group's [Mt, Mt] logits
//   PL = X_in . X_out^T, computed only in the 16 x 8 tiles that meet the
//   band |i - j| <= w: Band = (sigmoid(PL) - 1) where (i, j) is a valid
//   pair of one walk, g_in += Band . X_out, g_out += Band^T . X_in.  No dot
//   product is tied to one warp; a warp owns 16 x 16 output tiles in pass
//   1 and 16 x 32 ones in pass 2.
// * fp32 accuracy on TF32 tensor cores (3xTF32).  Every operand is split as
//   a = hi + lo, hi rounded to TF32, and each product accumulates
//   a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in fp32 with mma.sync m16n8k8 (lo
//   is handed over unrounded: the tensor cores read its top 19 bits), about
//   22 bits of each product kept, against TF32's 11 alone.
// * Columns in chunks.  D is cut into chunks of KC = 64 (or 32, where 64
//   does not fit) columns, gathered as [Mt, KC] slices of X_in and X_out.  A
//   group streams its chunks twice: pass 1 accumulates NL and PL over them;
//   then the elementwise phase turns NL into Gneg and PL into Band; pass 2
//   makes each chunk's columns of g_in, g_out and d_no.  Shared memory
//   grows with Mt * KC, S * D and Mt^2, not with L1 * D.
// * Asynchronous gathers.  The chunks come through a ring of two stages,
//   the next chunk (of this group or the next) gathered while the current
//   one computes: a row a bulk copy (cp.async.bulk, completing on the
//   stage's mbarrier) where rows are 16-byte aligned, cp.async 4 B at a time
//   at row stride D + 1.  The row indices come from a table per group, read
//   a group ahead.  Rows of dead positions, dropped routed slots and a
//   ragged last group's missing walks are zero-filled, not read
//   (out-of-vocabulary rows are read, and masked): their grads are 0 either
//   way.
// * NO [S, D] is loaded once a block and stays in shared memory; the
//   block's d_no partial stays there across its groups and is added to the
//   global [S, D] with one 16-byte atomic per 4 elements at the end, so the
//   atomics are grid * S * D, not B * S * D.  Loss partials go to
//   loss_parts[block] (pos, neg without the K/S factor, sum of mult).
//
// Strides: a chunk's and NO's rows are 4 mod 32 floats apart and Gneg's
// and Band's 8 mod 32, with the k index of pass 2's fragments permuted
// (slots t and t + 4 hold k = 2t and 2t + 1), so that most fragment loads
// meet no bank conflict.
//
// Staging: a shape whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); there the gathers are plain copies.
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
// ok_neg.all(), :337), which each block checks from slot_neg itself.
//
// ld is the tables' row stride in floats: D for the [V, D] tables of every
// trainer, D + 1 for the fused [V, D+1] tables of sgns_walk_step_fused
// (skipgram.py:541-596 compute the same gradients from the first D columns;
// the accumulator in column D is read by K14, fused_adagrad.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;       // the ring of gathered chunks
constexpr int kGroupRows = 64;   // rows of the M-tile a group of walks fills
constexpr size_t kSmemOptin = 232448;  // an H100's shared memory per block
constexpr unsigned kFull = 0xFFFFFFFFu;

// sigmoid(x) and log(1 + exp(-|x|)) from one exp: log(sigmoid(x)) =
// min(x, 0) - that, the overflow-safe form.  The exp, log and division are
// the fast intrinsics (a few ulp, or 2^-21 absolute for the log on (1, 2];
// e is in (0, 1], so none meets its argument limits).
__device__ __forceinline__ float sigmoid_log1pe(float x, float& log1pe) {
  const float e = __expf(-fabsf(x));
  log1pe = __logf(1.f + e);
  const float inv = __fdividef(1.f, 1.f + e);
  return x >= 0.f ? inv : e * inv;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// the least stride >= n that is 8 mod 32 floats
__host__ __device__ inline int stride8(int n) { return n + ((40 - n % 32) % 32); }

// A launch's geometry, computed alike on the host and in the kernel.
struct Geo {
  int L, D, S, W;  // walk length, dim, shared negatives, window
  int G;           // walks a group
  int Mt;          // a group's rows: G * L rounded up to 16
  int Sp;          // S rounded up to 16
  int KC, Dp, nc;  // columns a chunk, D rounded up to KC, chunks a pass
  int ldn;         // row stride of NO and the d_no partial (Dp + 4)
  int ldx;         // row stride of a gathered chunk (KC + 4)
  int ldg, ldb;    // row strides of NL / Gneg and PL / Band (8 mod 32)
};

Geo make_geo(int length, int dim, int n_neg, int window, int kc) {
  Geo g;
  g.L = length;
  g.D = dim;
  g.S = n_neg;
  g.W = window;
  g.G = length >= kGroupRows ? 1 : kGroupRows / length;
  g.Mt = round_up(g.G * length, 16);
  g.Sp = round_up(n_neg, 16);
  g.KC = kc;
  g.Dp = round_up(dim, kc);
  g.nc = g.Dp / kc;
  g.ldn = g.Dp + 4;
  g.ldx = kc + 4;
  g.ldg = stride8(g.Sp);
  g.ldb = stride8(g.Mt);
  return g;
}

size_t smem_bytes(const Geo& g) {
  const size_t floats = 2 * static_cast<size_t>(g.Sp) * g.ldn +        // NO, d_no partial
                        static_cast<size_t>(kStages) * 2 * g.Mt * g.ldx +  // the ring
                        static_cast<size_t>(g.Mt) * (g.ldg + g.ldb) +    // NL / Gneg, PL / Band
                        11 * static_cast<size_t>(g.Mt) +  // two groups' tables; mult
                        3 * kWarps +                                     // loss reduction
                        4;  // the ring's two mbarriers
  return floats * sizeof(float);
}

// chunks of 64 columns where they fit the card's shared memory, else 32
Geo pick_geo(int length, int dim, int n_neg, int window) {
  if (dim > 32) {
    const Geo g = make_geo(length, dim, n_neg, window, 64);
    if (smem_bytes(g) <= kSmemOptin) return g;
  }
  return make_geo(length, dim, n_neg, window, 32);
}

// Routed mode's request slots (null in the direct mode)
struct Slots {
  const int32_t *in, *out, *neg;
};

struct K2Args {
  const float* emb_in;
  const float* emb_out;
  int ld;  // the tables' row stride (routed: D)
  const int32_t* walks;
  const uint8_t* vocab_mask;
  const int32_t* b_sh;
  const int32_t* neg_ids;
  int n_walks;
  float neg_scale;
  float* g_in;
  float* g_out;
  float* d_no;
  float* loss_parts;
  Slots sl;
};

// ---- TF32 tensor-core products at fp32 accuracy ---------------------------

// x = hi + lo: hi rounded to TF32; lo = x - hi exactly, handed over as it
// is (the tensor cores read a TF32 operand's top 19 bits, so lo is
// truncated there: |error| < 2^-21 |x|, about what rounding it would keep)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (the 16 x 8 tiles at rows m0.., columns n0 + 8j.., j < NT, those
// below n_end) += A[m0:m0+16, k0:k1] . B[k0:k1, n0 + 8j:...], k0 and k1
// multiples of 8.  A(m, k) is A[k * lda + m] when kAK (stored k-major), else
// A[m * lda + k]; B(k, n) is B[k * ldb + n] when kBK, else B[n * ldb + k].
// kPerm: fragment slots t and t + 4 hold k = 2t and 2t + 1 (then a
// row-major A's pair is one 8-byte load).
template <int NT, bool kAK, bool kBK, bool kPerm>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4], const float* A, int lda,
                                         const float* B, int ldb, int m0, int n0, int n_end,
                                         int k0, int k1) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ka = kPerm ? 2 * tq : tq, kb = kPerm ? 2 * tq + 1 : tq + 4;
  float small[NT][4] = {};  // the lo terms: chains of their own, added at the end
  for (int k = k0; k < k1; k += 8) {
    float av[4];
    if (kAK) {
      av[0] = A[(k + ka) * lda + m0 + gq];
      av[1] = A[(k + ka) * lda + m0 + gq + 8];
      av[2] = A[(k + kb) * lda + m0 + gq];
      av[3] = A[(k + kb) * lda + m0 + gq + 8];
    } else if (kPerm) {
      const float2 x = *reinterpret_cast<const float2*>(A + (m0 + gq) * lda + k + ka);
      const float2 y = *reinterpret_cast<const float2*>(A + (m0 + gq + 8) * lda + k + ka);
      av[0] = x.x;
      av[2] = x.y;
      av[1] = y.x;
      av[3] = y.y;
    } else {
      av[0] = A[(m0 + gq) * lda + k + ka];
      av[1] = A[(m0 + gq + 8) * lda + k + ka];
      av[2] = A[(m0 + gq) * lda + k + kb];
      av[3] = A[(m0 + gq + 8) * lda + k + kb];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j;
      if (n >= n_end) break;
      float b0, b1;
      if (kBK) {
        b0 = B[(k + ka) * ldb + n + gq];
        b1 = B[(k + kb) * ldb + n + gq];
      } else {
        b0 = B[(n + gq) * ldb + k + ka];
        b1 = B[(n + gq) * ldb + k + kb];
      }
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      mma_tf32(small[j], al, bh0, bh1);
      mma_tf32(acc[j], ah, bh0, bh1);
      mma_tf32(small[j], ah, bl0, bl1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += small[j][i];
}

// the accumulator fragments of a 16 x 8NT tile from / to a row-major array
template <int NT>
__device__ __forceinline__ void load_acc(float (&acc)[NT][4], const float* C, int ldc, int m0,
                                         int n0, int n_end) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (n0 + 8 * j >= n_end) break;
    const int col = n0 + 8 * j + 2 * tq;
    const float2 x = *reinterpret_cast<const float2*>(C + (m0 + gq) * ldc + col);
    const float2 y = *reinterpret_cast<const float2*>(C + (m0 + gq + 8) * ldc + col);
    acc[j][0] = x.x;
    acc[j][1] = x.y;
    acc[j][2] = y.x;
    acc[j][3] = y.y;
  }
}

template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], float* C, int ldc, int m0,
                                          int n0, int n_end) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (n0 + 8 * j >= n_end) break;
    const int col = n0 + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(C + (m0 + gq) * ldc + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(C + (m0 + gq + 8) * ldc + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// a 16 x 8NT tile of g_in or g_out: the group's rows below `rows`, columns
// col0.. below D, rows of D floats from out + row0 * D
template <int NT>
__device__ __forceinline__ void store_grads(const float (&acc)[NT][4], float* __restrict__ out,
                                            int64_t row0, int dim, int rows, int m0, int col0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + gq + 8 * h;
    if (r >= rows) continue;
    float* dst = out + (row0 + r) * dim;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + 8 * j + 2 * tq;
      if (dim % 2 == 0 && col + 1 < dim) {  // an 8-byte aligned pair
        *reinterpret_cast<float2*>(dst + col) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        continue;
      }
      if (col < dim) dst[col] = acc[j][2 * h];
      if (col + 1 < dim) dst[col + 1] = acc[j][2 * h + 1];
    }
  }
}

// ---- the gathers ----------------------------------------------------------

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Which group, pass and chunk the block's item t is.
struct Item {
  int q, pass, chunk;  // q: the block's group index
  int rows;            // the group's positions (G * L1, less in a ragged last group)
  int64_t row0;        // the group's first position
};

__device__ __forceinline__ Item group_of(const Geo& g, int n_walks, int q) {
  Item it;
  it.q = q;
  it.pass = it.chunk = 0;
  const int w0 = (blockIdx.x + q * gridDim.x) * g.G;
  it.rows = min(g.G, n_walks - w0) * g.L;
  it.row0 = static_cast<int64_t>(w0) * g.L;
  return it;
}

__device__ __forceinline__ Item item_of(const Geo& g, int n_walks, int t) {
  Item it = group_of(g, n_walks, t / (2 * g.nc));
  it.pass = (t / g.nc) % 2;
  it.chunk = t % g.nc;
  return it;
}

// A group's row table (in shared memory, one a group parity):
//   tab [2][Mt]  the rows of X_in and X_out in the tables, -1 where the
//                position is dead, a routed slot was dropped or the row is
//                past a ragged last group (its rows zero-filled);
//   wid [Mt]     the walk's vertex id, for the vocabulary lookup;
//   bsh [Mt]     the shrunk window;
//   valid [Mt]   whether the position carries pairs: tab >= 0 and the vertex
//                in the vocabulary, written at the end of the group's first
//                item (out-of-vocabulary rows are gathered, and masked).
struct Table {
  int *tab, *wid, *bsh, *valid;
};

__device__ __forceinline__ Table table_of(int* tabs, int mt, int par) {
  int* base = tabs + par * 5 * mt;
  return Table{base, base + 2 * mt, base + 3 * mt, base + 4 * mt};
}

// one row's entries of a table, read from global memory
struct RowIds {
  int in, out, wid, bsh;
};

template <bool kRouted>
__device__ __forceinline__ RowIds load_row(const K2Args& a, const Item& it, int r) {
  RowIds x{-1, -1, -1, 0};
  if (r < it.rows) {
    const int64_t p = it.row0 + r;
    x.wid = a.walks[p];
    x.bsh = a.b_sh[p];
    if (kRouted) {
      const int si = a.sl.in[p], so = a.sl.out[p];
      const bool ok = x.wid >= 0 && si >= 0 && so >= 0;
      x.in = ok ? si : -1;
      x.out = ok ? so : -1;
    } else {
      x.in = x.out = x.wid >= 0 ? x.wid : -1;
    }
  }
  return x;
}

__device__ __forceinline__ void store_row(const Table& t, int mt, int r, const RowIds& x) {
  t.tab[r] = x.in;
  t.tab[mt + r] = x.out;
  t.wid[r] = x.wid;
  t.bsh[r] = x.bsh;
}

// Copy `n` floats of the row at src (null: zeros) from column c0 into dst,
// `piece` the caller's 16 B (vec) or 4 B piece of it: cp.async into shared
// memory, plain copies into a global workspace.
template <bool kShared>
__device__ __forceinline__ void copy_piece(float* dst, const float* src, int c0, int dim,
                                           int piece, bool vec) {
  if (vec) {
    const int col = c0 + 4 * piece;
    float* d = dst + 4 * piece;
    if (src != nullptr && col < dim) {
      if (kShared) {
        const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(d));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + col));
      } else {
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src + col);
      }
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const int col = c0 + piece;
    float* d = dst + piece;
    if (src != nullptr && col < dim) {
      if (kShared) {
        const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(d));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src + col));
      } else {
        *d = src[col];
      }
    } else {
      *d = 0.f;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait until the mbarrier at `mbar` has completed the phase of the given
// parity.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  }
}

// Gather item t's [Mt, KC] chunks of X_in and X_out into `stage`; tab is the
// item's group's row table.  Rows 16-byte aligned in shared memory (`bulk`):
// one bulk copy a row (cp.async.bulk, the copy engine's 1-D form: the
// issuing thread does not wait), completing on the stage's mbarrier, whose
// phase counts one arrival a row; otherwise cp.async (4 B at row stride
// D + 1) or plain copies into a global workspace.
template <bool kShared>
__device__ __forceinline__ void gather(float* stage, const Geo& g, const K2Args& a, int t,
                                       const int* tab, int ld, bool vec, uint32_t mbar) {
  const int c0 = (t % g.nc) * g.KC;
  if (kShared && vec) {
    // a copy's issue waits for the copy engine to take it, so every warp
    // issues a few rows rather than four warps all of them
    const int n = 4 * min(g.KC, g.D - c0);  // bytes a live row brings
    const int per_warp = (2 * g.Mt + kWarps - 1) / kWarps;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int i = lane; i < per_warp; i += 32) {
      const int rr = warp * per_warp + i;
      if (rr >= 2 * g.Mt) break;
      const int row = tab[rr];
      const int bytes = row < 0 ? 0 : n;
      float* dst = stage + rr * g.ldx;
      for (int c = bytes / 4; c < g.KC; c += 4)  // dead rows; columns past D
        *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
                   "r"(bytes)
                   : "memory");
      if (bytes > 0) {
        const float* table = rr < g.Mt ? a.emb_in : a.emb_out;
        const float* src = table + static_cast<int64_t>(row) * ld + c0;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(dst)),
            "l"(src), "r"(bytes), "r"(mbar)
            : "memory");
      }
    }
    return;
  }
  const int per_row = vec ? g.KC / 4 : g.KC;  // copies a row
  const int piece = threadIdx.x % per_row;
  for (int rr = threadIdx.x / per_row; rr < 2 * g.Mt; rr += kThreads / per_row) {
    const int row = tab[rr];
    const float* table = rr < g.Mt ? a.emb_in : a.emb_out;
    copy_piece<kShared>(stage + rr * g.ldx,
                        row < 0 ? nullptr : table + static_cast<int64_t>(row) * ld, c0, g.D,
                        piece, vec);
  }
}

// ---- one block's work -----------------------------------------------------

// Every array carved from sm: the dynamic shared memory, or the block's
// slice of a global workspace (staging.cuh).
template <bool kRouted, bool kShared>
__device__ __forceinline__ void sgns_grads_block(float* sm, const Geo& g, const K2Args& a) {
  float* no = sm;                                    // [Sp, ldn] the shared negatives' rows
  float* dno = no + g.Sp * g.ldn;                    // [Sp, ldn] the block's d_no partial
  float* ring = dno + g.Sp * g.ldn;                  // [kStages][2][Mt, ldx]
  float* nlg = ring + kStages * 2 * g.Mt * g.ldx;    // [Mt, ldg] NL, then Gneg
  float* plb = nlg + g.Mt * g.ldg;                   // [Mt, ldb] PL, then Band
  int* tabs = reinterpret_cast<int*>(plb + g.Mt * g.ldb);  // [2 parities][5][Mt] (Table)
  float* mult = reinterpret_cast<float*>(tabs + 10 * g.Mt);  // [Mt]
  float* red = mult + g.Mt;                                  // [3 * kWarps]
  uint64_t* mbars = reinterpret_cast<uint64_t*>(red + 3 * kWarps);  // [2] the ring's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = g.L, D = g.D, S = g.S, W = g.W, Mt = g.Mt, Sp = g.Sp, KC = g.KC;
  const int n_groups = (a.n_walks + g.G - 1) / g.G;
  const int my_groups =
      n_groups > static_cast<int>(blockIdx.x) ? (n_groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_items = my_groups * 2 * g.nc;
  const int ld = kRouted ? D : a.ld;
  const bool vec = ld % 4 == 0 && D % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.emb_in) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.emb_out) % 16 == 0);

  // prologue: group 0's table, then NO and item 0's chunks in flight
  const bool bulk = kShared && vec;  // the ring fills by bulk copies
  if (n_items > 0) {
    const Item g0 = group_of(g, a.n_walks, 0);
    const Table t0 = table_of(tabs, Mt, 0);
    for (int r = tid; r < Mt; r += kThreads) store_row(t0, Mt, r, load_row<kRouted>(a, g0, r));
  }
  if (bulk && tid == 0) {
    for (int st = 0; st < kStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(mbars + st)),
                   "r"(2 * Mt)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  {
    const int per_row = vec ? g.Dp / 4 : g.Dp;
    for (int i = tid; i < Sp * per_row; i += kThreads) {
      const int s = i / per_row;
      int row = -1;
      if (s < S) row = kRouted ? a.sl.neg[s] : a.neg_ids[s];
      copy_piece<kShared>(no + s * g.ldn,
                          row < 0 ? nullptr : a.emb_out + static_cast<int64_t>(row) * ld, 0, D,
                          i % per_row, vec);
    }
    for (int i = tid; i < Sp * g.ldn; i += kThreads) dno[i] = 0.f;
  }
  if (n_items > 0) gather<kShared>(ring, g, a, 0, tabs, ld, vec, smem_addr(mbars));
  cp_commit();
  float neg_live = 1.f;  // routed: 0 when any negative was dropped
  if (kRouted) {
    for (int s = 0; s < S; ++s)
      if (a.sl.neg[s] < 0) neg_live = 0.f;
  }
  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;

  const int mt16 = Mt / 16, sp16 = Sp / 16;
  const int n_nl = mt16 * sp16;
  const int pl_slots = 2 + 2 * ((W + 7) / 8);  // 8-column tiles a row tile's band meets, at most
  // pass 2's warp tiles: 16 x 32 (4 mma tiles) in shared memory; 16 x 16 in
  // a global workspace, where the wider tile's registers cost more than its
  // reuse gains
  constexpr int kP2Tiles = kShared ? 4 : 2;
  const int kc2 = KC / (8 * kP2Tiles);  // pass 2's warp tiles across a chunk
  const int n_gi = mt16 * kc2, n_dno = sp16 * kc2;

  for (int t = 0; t < n_items; ++t) {
    if (bulk) mbar_wait(smem_addr(mbars + t % kStages), (t / kStages) & 1);
    cp_wait_all();
    __syncthreads();  // item t landed; item t - 1's stage is free
    if (t + 1 < n_items)
      gather<kShared>(ring + ((t + 1) % kStages) * 2 * Mt * g.ldx, g, a, t + 1,
                      table_of(tabs, Mt, ((t + 1) / (2 * g.nc)) & 1).tab, ld, vec,
                      smem_addr(mbars + (t + 1) % kStages));
    cp_commit();

    const Item it = item_of(g, a.n_walks, t);
    const float* xin = ring + (t % kStages) * 2 * Mt * g.ldx;
    const float* xout = xin + Mt * g.ldx;
    const int c0 = it.chunk * KC;
    const int par = it.q & 1;
    const Table tb = table_of(tabs, Mt, par);

    if (it.pass == 0) {
      // At a group's first item: its vocabulary flags and the next group's
      // table, loaded first and stored after the products, which hide the
      // loads' latency.  Read from the next item on, after a barrier (the
      // next group's first gather is issued at the top of this group's last
      // item, the second at the earliest).
      const bool first = it.chunk == 0, ahead = first && it.q + 1 < my_groups;
      int ok = 0;
      RowIds nx{-1, -1, -1, 0};
      if (first && tid < Mt) ok = tb.tab[tid] >= 0 && a.vocab_mask[tb.wid[tid]];
      if (ahead && tid < Mt) nx = load_row<kRouted>(a, group_of(g, a.n_walks, it.q + 1), tid);

      // pass 1: NL += X_in . NO^T in 16 x 16 tiles and, in the band's 16 x 8
      // tiles, PL += X_in . X_out^T (a warp takes one of each, most often)
      for (int w = warp; w < n_nl + mt16 * pl_slots; w += kWarps) {
        int m0, n0, n_end, ldc, ldbb;
        float* C;
        const float* B;
        if (w < n_nl) {
          m0 = (w / sp16) * 16;
          n0 = (w % sp16) * 16;
          n_end = n0 + 16;
          C = nlg;
          ldc = g.ldg;
          B = no + c0;
          ldbb = g.ldn;
        } else {
          const int j = w - n_nl;
          m0 = (j / pl_slots) * 16;
          const int j0 = max(0, m0 - W) / 8, j1 = min(Mt - 1, m0 + 15 + W) / 8;
          n0 = (j0 + j % pl_slots) * 8;
          if (n0 > 8 * j1) continue;
          n_end = n0 + 8;
          C = plb;
          ldc = g.ldb;
          B = xout;
          ldbb = g.ldx;
        }
        float acc[2][4] = {};
        if (it.chunk > 0) load_acc(acc, C, ldc, m0, n0, n_end);
        mma_tile<2, false, false, false>(acc, xin, g.ldx, B, ldbb, m0, n0, n_end, 0, KC);
        store_acc(acc, C, ldc, m0, n0, n_end);
      }

      if (first) {
        for (int r = tid; r < Mt; r += kThreads)  // rows past the threads (L1 > kThreads)
          if (r >= kThreads) tb.valid[r] = tb.tab[r] >= 0 && a.vocab_mask[tb.wid[r]];
        if (tid < Mt) tb.valid[tid] = ok;
      }
      if (ahead) {
        const Item nq = group_of(g, a.n_walks, it.q + 1);
        const Table tn = table_of(tabs, Mt, par ^ 1);
        for (int r = tid; r < Mt; r += kThreads)
          store_row(tn, Mt, r, r < kThreads ? nx : load_row<kRouted>(a, nq, r));
      }
      continue;
    }

    if (it.chunk == 0) {
      // the elementwise phase: multiplicities, then Gneg and Band in place
      const int* valid = tb.valid;
      const int* bsh = tb.bsh;
      for (int r = tid; r < Mt; r += kThreads) {
        float m = 0.f;
        if (valid[r]) {
          const int i = r % L;
          for (int d = 1; d <= W && d <= bsh[r]; ++d) {
            if (i - d >= 0 && valid[r - d]) m += 1.f;
            if (i + d < L && valid[r + d]) m += 1.f;
          }
        }
        mult[r] = m;
        mult_acc += m;
      }
      __syncthreads();
      for (int r = warp; r < Mt; r += kWarps) {  // a warp a row
        const float m = mult[r] * neg_live;
        float* nrow = nlg + r * g.ldg;
        for (int s = lane; s < Sp; s += 32) {
          float out = 0.f;
          if (m > 0.f && s < S) {
            const float nl = nrow[s];
            float l1pe;
            out = sigmoid_log1pe(nl, l1pe) * m * a.neg_scale;
            neg_acc += (fminf(-nl, 0.f) - l1pe) * m;  // log sigmoid(-nl)
          }
          nrow[s] = out;
        }
        const int vr = valid[r], br = min(bsh[r], W), ir = r % L;
        float* prow = plb + r * g.ldb;
        for (int c = lane; c < Mt; c += 32) {
          const int ad = abs(c - r), ic = ir + c - r;  // c's position, if in r's walk
          float out = 0.f;
          if (vr && ad >= 1 && ad <= br && ic >= 0 && ic < L && valid[c]) {
            const float pl = prow[c];
            float l1pe;
            out = sigmoid_log1pe(pl, l1pe) - 1.f;
            pos_acc += fminf(pl, 0.f) - l1pe;  // log sigmoid(pl)
          }
          prow[c] = out;
        }
      }
      __syncthreads();
    }

    // pass 2: this chunk's columns of g_in, d_no and g_out in 16 x 32 warp
    // tiles.  Slots: g_in's tiles first, then d_no's, then g_out's placed
    // so that each lands on the warp of the d_no tile of its index (a g_in
    // tile takes about as long as a d_no and a g_out tile together).
    const int k_live = min(Mt, round_up(it.rows, 8));
    const int go0 = n_gi + round_up(n_dno, kWarps);
    for (int w = warp; w < go0 + n_gi; w += kWarps) {
      float acc[kP2Tiles][4] = {};
      if (w < n_gi) {  // g_in = Gneg . NO + Band . X_out
        const int m0 = (w / kc2) * 16, n0 = (w % kc2) * 8 * kP2Tiles;
        if (m0 >= it.rows) continue;
        mma_tile<kP2Tiles, false, true, true>(acc, nlg, g.ldg, no + c0, g.ldn, m0, n0, KC, 0,
                                              Sp);
        const int kb0 = max(0, m0 - W) / 8 * 8, kb1 = min(Mt, round_up(m0 + 16 + W, 8));
        mma_tile<kP2Tiles, false, true, true>(acc, plb, g.ldb, xout, g.ldx, m0, n0, KC, kb0,
                                              kb1);
        store_grads(acc, a.g_in, it.row0, D, it.rows, m0, c0 + n0);
      } else if (w < n_gi + n_dno) {  // the d_no partial += Gneg^T . X_in
        const int j = w - n_gi, s0 = (j / kc2) * 16, n0 = (j % kc2) * 8 * kP2Tiles;
        if (s0 >= S) continue;
        float* C = dno + c0;
        load_acc(acc, C, g.ldn, s0, n0, KC);
        mma_tile<kP2Tiles, true, true, true>(acc, nlg, g.ldg, xin, g.ldx, s0, n0, KC, 0, k_live);
        store_acc(acc, C, g.ldn, s0, n0, KC);
      } else if (w >= go0) {  // g_out = Band^T . X_in
        const int j = w - go0, m0 = (j / kc2) * 16, n0 = (j % kc2) * 8 * kP2Tiles;
        if (m0 >= it.rows) continue;
        const int kb0 = max(0, m0 - W) / 8 * 8, kb1 = min(Mt, round_up(m0 + 16 + W, 8));
        mma_tile<kP2Tiles, true, true, true>(acc, plb, g.ldb, xin, g.ldx, m0, n0, KC, kb0, kb1);
        store_grads(acc, a.g_out, it.row0, D, it.rows, m0, c0 + n0);
      }
    }
  }
  cp_wait_all();
  __syncthreads();

  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(a.d_no) % 16 == 0) {  // 16-byte atomics
    for (int i = 4 * tid; i < S * D; i += 4 * kThreads) {
      const float* p = dno + (i / D) * g.ldn + i % D;
      atomicAdd(reinterpret_cast<float4*>(a.d_no + i), make_float4(p[0], p[1], p[2], p[3]));
    }
  } else {
    for (int i = tid; i < S * D; i += kThreads)
      atomicAdd(a.d_no + i, dno[(i / D) * g.ldn + i % D]);
  }
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
    a.loss_parts[3 * blockIdx.x + tid] = t;
  }
}

template <bool kRouted>
__global__ void __launch_bounds__(kThreads, 1) sgns_grads_kernel(Geo g, K2Args a) {
  extern __shared__ __align__(16) float sm[];
  sgns_grads_block<kRouted, true>(sm, g, a);
}

template <bool kRouted>
__global__ void __launch_bounds__(kThreads, 1)
sgns_grads_kernel_staged(Geo g, K2Args a, float* ws, int64_t ws_stride) {
  sgns_grads_block<kRouted, false>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, g, a);
}

template <bool kRouted>
int launch(int length, int dim, int n_neg, int window, const K2Args& a, float* ws,
           int ws_blocks, void* stream) {
  if (a.n_walks == 0 || length <= 0) return 0;
  const Geo g = pick_geo(length, dim, n_neg, window);
  const int n_groups = (a.n_walks + g.G - 1) / g.G;
  return n2v::launch_staged(sgns_grads_kernel<kRouted>, sgns_grads_kernel_staged<kRouted>,
                            kThreads, smem_bytes(g), n_groups, ws, ws_blocks,
                            static_cast<cudaStream_t>(stream), g, a);
}

}  // namespace

// Bytes of shared memory a block takes (or of workspace it stages in).
extern "C" size_t n2v_sgns_grads_smem(int length, int dim, int n_neg, int window) {
  return smem_bytes(pick_geo(length, dim, n_neg, window));
}

// loss_parts must hold 3 * n_walks zeros; d_no must be zeroed [n_neg, dim];
// the tables are [V, ld] with ld >= dim, their first dim columns read.  ws
// null: the blocks stage in shared memory; else in ws, ws_blocks blocks of
// n2v::staging_stride(n2v_sgns_grads_smem(...)) floats (staging.cuh).
extern "C" int n2v_sgns_grads(const float* emb_in, const float* emb_out, int dim,
                              int ld, const int32_t* walks, const uint8_t* vocab_mask,
                              const int32_t* b_sh, const int32_t* neg_ids,
                              int n_walks, int length, int window, int n_neg,
                              float neg_scale, float* g_in, float* g_out,
                              float* d_no, float* loss_parts, float* ws, int ws_blocks,
                              void* stream) {
  const K2Args a{emb_in, emb_out, ld, walks, vocab_mask, b_sh, neg_ids, n_walks, neg_scale,
                 g_in, g_out, d_no, loss_parts, Slots{nullptr, nullptr, nullptr}};
  return launch<false>(length, dim, n_neg, window, a, ws, ws_blocks, stream);
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
  const K2Args a{x_in, x_out, dim, walks, vocab_mask, b_sh, nullptr, n_walks, neg_scale,
                 g_in, g_out, d_no, loss_parts, Slots{slot_in, slot_out, slot_neg}};
  return launch<true>(length, dim, n_neg, window, a, ws, ws_blocks, stream);
}
