// Fused delta-rank reprice for Hopper (sm_90a): one fleet tick in two
// launches, plus the k-head selection.  A plain C interface, loaded with
// ctypes by repro_torch/kernels/rank_delta.py; every entry point returns
// cudaGetLastError() after its launch and never synchronizes.
//
// Replaces the Pallas kernel repro/kernels/rank_delta.py::_make_kernel
// (fused_reprice, and fused_reprice_heads with heads=k).  The TPU grid ran
// phase 0 (masked row minima) before phase 1 (member folds) on one core;
// here the two phases are two launches on one stream, which orders them.
//
// What bounds it: memory.  Per tick it must read hours and mask (5 bytes
// a cell) and read and write the S x C score accumulators; the member
// folds are 4 flops per (member, row, column), far below the fp32 peak.
// At 64 jobs x 10,000 configs x 16 members that is about 4.5 MB, a floor
// near 1.3 us at 3.35 TB/s, so launch latency dominates.  The design
// keeps no cost or norm matrix in device memory: both are recomputed
// from hours, mask and the price vectors in every pass.
//
// Exactness is the contract.  Build without fast math.  __fmul_rn and
// __fdiv_rn are never contracted into FMAs, so an unchanged column
// recomputes bit-identical cost and norm cells and norm_new - norm_old is
// an exact 0.0: an identity tick leaves scores and row minima bit-for-bit
// unchanged.  The row minima are order-free and so bitwise equal to any
// other exact evaluation; only the order of the member sums differs from
// the reference, which its float32 tolerance envelope covers.
//
// The k-head (select) replaces jax.lax.top_k in the reference fleet's
// top_k (repro/selector/rank.py:1218) and the Pallas kernel's in-kernel
// top-k tail (repro/kernels/rank_delta.py:157).  For each row it returns
// the k lowest (masked score, column) pairs in lexicographic order, k
// distinct columns, unprofiled (non-finite) columns as +inf in catalog
// order.  What bounds it: memory, 5 bytes a cell read once (1 x 10,000:
// 0.015 us; 16 x 100,000: 2.4 us), so launch latency, the number of SMs
// at work and the length of each warp's dependent chain of shuffles
// decide its time.  The design, for k <= kSelectCap (64):
//   - Each candidate is one 64-bit key: the score's order-preserving bits
//     (-0.0 first made +0.0, which lex_less ties with it; non-finite
//     +inf) over the column.  Lexicographic order is one integer compare,
//     and keys are distinct because columns are.
//   - Stage 1: a grid of (chunks of 2,048 columns) x rows.  Each warp
//     reads 256 columns once (float4 scores and uchar4 flags where C is
//     a multiple of 4) and sorts their keys with a bitonic network, 8 a
//     lane: fixed work, no data-dependent chain.  Its best 32 or 64 keys
//     merge with the other warps' in a tree (the minimum of one list and
//     the other reversed is bitonic; a bitonic merge sorts it), and the
//     chunk's k best go to scratch.
//   - Stage 2, a second launch: one block per row merges its chunks'
//     lists the same way and unpacks the k-head, reading each value back
//     from the row.
// At 1 x 10,000 that is 5 + 1 blocks; at 16 x 100,000, 784 + 16.  k above
// the cap keeps the k-round kernel (select_kernel), chosen by k alone.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRowminThreads = 256;
constexpr int kFoldThreads = 128;   // one thread per column
constexpr int kFoldRows = 64;       // job rows staged in shared memory
constexpr int kFoldMembers = 16;    // member accumulators in registers
constexpr int kSelectThreads = 512;
constexpr int kWarp = 32;
constexpr int kNoIndex = 0x7fffffff;  // sorts after every column

// Phase 0: one block per job row.  row_best_out[j] is the masked minimum
// of hours[j, :] * new_p; moved counts the rows whose minimum changed.
// row_best_in is only read: the fold still needs the old minima.
__global__ void rowmin_kernel(const float* __restrict__ hours,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ new_p,
                              const float* __restrict__ row_best_in,
                              float* __restrict__ row_best_out,
                              int* __restrict__ moved, int C) {
  const int j = blockIdx.x;
  const size_t base = (size_t)j * C;
  float best = CUDART_INF_F;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    if (mask[base + c])
      best = fminf(best, __fmul_rn(hours[base + c], new_p[c]));
  }
  for (int off = kWarp / 2; off > 0; off >>= 1)
    best = fminf(best, __shfl_down_sync(0xffffffffu, best, off));
  __shared__ float warp_best[kRowminThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x / kWarp); ++w)
      best = fminf(best, warp_best[w]);
    row_best_out[j] = best;
    // a fully masked row stays inf == inf and never counts as a handoff
    if (best != row_best_in[j]) atomicAdd(moved, 1);
  }
}

// Phase 1: one thread per column.  For each chunk of members, stream the
// job rows, recompute both norms of the cell, and accumulate
//   P = sum_j rm[s, j] * norm_new[j, c]
//   D = sum_j rm[s, j] * (norm_new[j, c] - norm_old[j, c]);
// then write changed ? P : scores_in + D.  scores_out may alias
// scores_in: each element is read and then written by one thread only.
__global__ void fold_kernel(const float* __restrict__ hours,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ old_p,
                            const float* __restrict__ new_p,
                            const float* __restrict__ changed,
                            const float* __restrict__ rb_old,
                            const float* __restrict__ rb_new,
                            const float* __restrict__ row_masks,
                            const float* scores_in, float* scores_out,
                            int J, int C, int S) {
  __shared__ float s_rb_old[kFoldRows];
  __shared__ float s_rb_new[kFoldRows];
  __shared__ float s_rm[kFoldMembers][kFoldRows];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < C;
  const float po = live ? old_p[c] : 0.0f;
  const float pn = live ? new_p[c] : 0.0f;
  for (int s0 = 0; s0 < S; s0 += kFoldMembers) {
    const int ns = min(kFoldMembers, S - s0);
    float p_acc[kFoldMembers], d_acc[kFoldMembers];
#pragma unroll
    for (int s = 0; s < kFoldMembers; ++s) p_acc[s] = d_acc[s] = 0.0f;
    for (int j0 = 0; j0 < J; j0 += kFoldRows) {
      const int nj = min(kFoldRows, J - j0);
      __syncthreads();  // the previous chunk's readers are done
      for (int t = threadIdx.x; t < kFoldRows; t += blockDim.x) {
        s_rb_old[t] = t < nj ? rb_old[j0 + t] : 1.0f;
        s_rb_new[t] = t < nj ? rb_new[j0 + t] : 1.0f;
      }
      for (int t = threadIdx.x; t < kFoldMembers * kFoldRows;
           t += blockDim.x) {
        const int s = t / kFoldRows, jj = t % kFoldRows;
        s_rm[s][jj] = (s < ns && jj < nj)
                          ? row_masks[(size_t)(s0 + s) * J + j0 + jj]
                          : 0.0f;
      }
      __syncthreads();
      if (!live) continue;
      for (int jj = 0; jj < nj; ++jj) {
        const size_t cell = (size_t)(j0 + jj) * C + c;
        if (!mask[cell]) continue;  // masked cells normalize to 0 in both
        const float h = hours[cell];
        // select before dividing: a masked cell never divides, so a
        // fully masked row (inf / inf) never yields NaN
        const float n_old = __fdiv_rn(__fmul_rn(h, po), s_rb_old[jj]);
        const float n_new = __fdiv_rn(__fmul_rn(h, pn), s_rb_new[jj]);
        const float dn = __fsub_rn(n_new, n_old);
#pragma unroll
        for (int s = 0; s < kFoldMembers; ++s) {
          p_acc[s] += s_rm[s][jj] * n_new;
          d_acc[s] += s_rm[s][jj] * dn;
        }
      }
    }
    if (live) {
      const bool chg = changed[c] > 0.0f;
#pragma unroll  // constant indices keep the accumulators in registers
      for (int s = 0; s < kFoldMembers; ++s) {
        if (s < ns) {
          const size_t at = (size_t)(s0 + s) * C + c;
          scores_out[at] = chg ? p_acc[s] : scores_in[at] + d_acc[s];
        }
      }
    }
  }
}

// (value, index) in lexicographic order: the lower value, then the lower
// index.  An unprofiled config has value inf and so ranks after every
// profiled one, in catalog order among its kind.
__device__ __forceinline__ bool lex_less(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// The k-round k-head, for k above kSelectCap: one block per member row,
// k rounds of a block-wide lexicographic argmin over (masked score,
// column).  Taken columns are kept in a shared-memory bitmap, so a head
// is always k distinct configs even when a member has fewer than k
// profiled ones.
__global__ void select_kernel(const float* __restrict__ scores,
                              const uint8_t* __restrict__ finite,
                              float* __restrict__ top_v,
                              int* __restrict__ top_i, int C, int k) {
  extern __shared__ uint32_t taken[];
  __shared__ float red_v[kSelectThreads / kWarp];
  __shared__ int red_i[kSelectThreads / kWarp];
  const int s = blockIdx.x;
  const size_t row = (size_t)s * C;
  const int words = (C + 31) / 32;
  for (int w = threadIdx.x; w < words; w += blockDim.x) taken[w] = 0u;
  __syncthreads();
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  for (int t = 0; t < k; ++t) {
    float bv = CUDART_INF_F;
    int bi = kNoIndex;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      if (taken[c >> 5] & (1u << (c & 31))) continue;
      const float v = finite[row + c] ? scores[row + c] : CUDART_INF_F;
      if (lex_less(v, c, bv, bi)) { bv = v; bi = c; }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (lex_less(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < (int)(blockDim.x / kWarp); ++w)
        if (lex_less(red_v[w], red_i[w], bv, bi)) {
          bv = red_v[w];
          bi = red_i[w];
        }
      top_v[(size_t)s * k + t] = bv;
      top_i[(size_t)s * k + t] = bi;
      if (bi != kNoIndex) taken[bi >> 5] |= 1u << (bi & 31);
    }
    __syncthreads();  // the bitmap and red_* are settled for next round
  }
}

// --- the two-stage k-head ------------------------------------------------

constexpr int kSelectCap = 64;          // the largest k the two stages serve
constexpr int kChunkThreads = 256;      // 8 warps a block, both stages
constexpr int kLaneKeys = 8;            // keys a lane sorts in stage 1
constexpr int kSelectChunk = kChunkThreads * kLaneKeys;   // 2,048 columns
constexpr uint64_t kNoKey = ~0ull;      // sorts after every real key
constexpr unsigned kFull = 0xffffffffu;

// (masked score, column) as one key whose unsigned order is lex_less's.
__device__ __forceinline__ uint64_t pack_key(float v, bool fin, int c) {
  uint32_t u;
  if (!fin) u = 0x7f800000u;                       // +inf
  else if (v != v) u = 0x7fc00000u;                // NaN after +inf
  else u = __float_as_uint(v == 0.0f ? 0.0f : v);  // -0.0 ties +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (uint32_t)c;
}

// Warp-wide bitonic networks over 64-bit keys held M to a lane: the key
// in e[r] of lane l has index r * 32 + l.  min/max of one compare-swap
// go to the lower/upper index of an ascending pair.
template <int M>
__device__ __forceinline__ void cswap(uint64_t (&e)[M], int d, int size,
                                      int lane) {
  if (d >= 32) {                       // both keys in this lane
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const int p = r ^ (d / 32);
      if (p > r) {
        const bool up = ((r * 32 + lane) & size) == 0;
        const uint64_t lo = e[r] < e[p] ? e[r] : e[p];
        const uint64_t hi = e[r] < e[p] ? e[p] : e[r];
        e[r] = up ? lo : hi;
        e[p] = up ? hi : lo;
      }
    }
  } else {                             // the partner is lane ^ d
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const uint64_t o = __shfl_xor_sync(kFull, e[r], d);
      const bool up = ((r * 32 + lane) & size) == 0;
      const bool lower = (lane & d) == 0;
      e[r] = (lower == up) ? (e[r] < o ? e[r] : o) : (e[r] < o ? o : e[r]);
    }
  }
}

// Sort the warp's 32 M keys ascending.
template <int M>
__device__ __forceinline__ void warp_sort(uint64_t (&e)[M], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * M; size *= 2)
#pragma unroll
    for (int d = size / 2; d > 0; d /= 2) cswap<M>(e, d, size, lane);
}

// e and f ascending lists of 32 R keys: e becomes the 32 R smallest of
// both, ascending (the minimum of e and f reversed is bitonic; a bitonic
// merge sorts it).
template <int R>
__device__ __forceinline__ void warp_merge(uint64_t (&e)[R],
                                           const uint64_t (&f)[R], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint64_t fr = __shfl_sync(kFull, f[R - 1 - r], 31 - lane);
    e[r] = e[r] < fr ? e[r] : fr;
  }
#pragma unroll
  for (int d = 16 * R; d > 0; d /= 2) cswap<R>(e, d, 64 * R, lane);
}

// The block's 8 warp lists (32 R keys each, ascending) merged in a tree
// through shared memory; warp 0's e ends with the block's best.
template <int R>
__device__ __forceinline__ void block_merge(uint64_t (&e)[R],
                                            uint64_t (*lists)[32 * R],
                                            int warp, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) lists[warp][r * 32 + lane] = e[r];
  __syncthreads();
#pragma unroll
  for (int half = kChunkThreads / kWarp / 2; half > 0; half /= 2) {
    if (warp < half) {
      uint64_t f[R];
#pragma unroll
      for (int r = 0; r < R; ++r) f[r] = lists[warp + half][r * 32 + lane];
      warp_merge<R>(e, f, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) lists[warp][r * 32 + lane] = e[r];
    }
    __syncthreads();
  }
}

// Stage 1: block (chunk, row) writes the k best keys of its kSelectChunk
// columns to part[row][chunk][:k].  Each warp sorts 256 of them, 8 a
// lane, read once (float4 scores and uchar4 flags where ``vec``: C a
// multiple of 4, aligned bases), and keeps its 32 R best.
template <int R>
__global__ void __launch_bounds__(kChunkThreads)
select_chunk_kernel(const float* __restrict__ scores,
                    const uint8_t* __restrict__ finite,
                    uint64_t* __restrict__ part, int C, int k, int vec) {
  __shared__ uint64_t lists[kChunkThreads / kWarp][32 * R];
  const int s = blockIdx.y, chunk = blockIdx.x;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int c0 = chunk * kSelectChunk + warp * 32 * kLaneKeys;
  const size_t row = (size_t)s * C;
  uint64_t e[kLaneKeys];
  if (vec) {
    const float4* sv = reinterpret_cast<const float4*>(scores + row);
    const uchar4* fv = reinterpret_cast<const uchar4*>(finite + row);
#pragma unroll
    for (int j = 0; j < kLaneKeys / 4; ++j) {
      const int c = c0 + 128 * j + 4 * lane;
      if (c < C) {
        const float4 v = sv[c / 4];
        const uchar4 f = fv[c / 4];
        e[4 * j] = pack_key(v.x, f.x, c);
        e[4 * j + 1] = pack_key(v.y, f.y, c + 1);
        e[4 * j + 2] = pack_key(v.z, f.z, c + 2);
        e[4 * j + 3] = pack_key(v.w, f.w, c + 3);
      } else {
        e[4 * j] = e[4 * j + 1] = e[4 * j + 2] = e[4 * j + 3] = kNoKey;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) {
      const int c = c0 + 32 * j + lane;
      e[j] = c < C ? pack_key(scores[row + c], finite[row + c], c) : kNoKey;
    }
  }
  warp_sort<kLaneKeys>(e, lane);
  uint64_t best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) best[r] = e[r];
  block_merge<R>(best, lists, warp, lane);
  if (warp != 0) return;
  uint64_t* out = part + ((size_t)s * gridDim.x + chunk) * k;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r * 32 + lane < k) out[r * 32 + lane] = best[r];
}

// Stage 2: one block per row; warp w merges the lists of chunks w, w + 8,
// ..., the block merges the warps', and warp 0 unpacks the k-head.
template <int R>
__global__ void __launch_bounds__(kChunkThreads)
select_merge_kernel(const float* __restrict__ scores,
                    const uint8_t* __restrict__ finite,
                    const uint64_t* __restrict__ part,
                    float* __restrict__ top_v, int* __restrict__ top_i, int C,
                    int k, int nchunks) {
  __shared__ uint64_t lists[kChunkThreads / kWarp][32 * R];
  const int s = blockIdx.x;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  uint64_t e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) e[r] = kNoKey;
  for (int c = warp; c < nchunks; c += kChunkThreads / kWarp) {
    const uint64_t* p = part + ((size_t)s * nchunks + c) * k;
    uint64_t f[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      f[r] = r * 32 + lane < k ? p[r * 32 + lane] : kNoKey;
    warp_merge<R>(e, f, lane);
  }
  block_merge<R>(e, lists, warp, lane);
  if (warp != 0) return;
  const size_t row = (size_t)s * C;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = r * 32 + lane;
    if (idx < k) {
      const int c = (int)(uint32_t)e[r];   // a row holds k columns
      top_i[(size_t)s * k + idx] = c;
      top_v[(size_t)s * k + idx] = finite[row + c] ? scores[row + c]
                                                   : CUDART_INF_F;
    }
  }
}

template <int R>
int select_two_stage(const float* scores, const uint8_t* finite,
                     float* top_v, int* top_i, uint64_t* part, int S, int C,
                     int k, int vec, cudaStream_t stream) {
  const int nchunks = (C + kSelectChunk - 1) / kSelectChunk;
  select_chunk_kernel<R><<<dim3(nchunks, S), kChunkThreads, 0, stream>>>(
      scores, finite, part, C, k, vec);
  select_merge_kernel<R><<<S, kChunkThreads, 0, stream>>>(
      scores, finite, part, top_v, top_i, C, k, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rank_delta_rowmin(const float* hours, const uint8_t* mask,
                      const float* new_p, const float* row_best_in,
                      float* row_best_out, int* moved, int J, int C,
                      void* stream) {
  if (J > 0)
    rowmin_kernel<<<J, kRowminThreads, 0, (cudaStream_t)stream>>>(
        hours, mask, new_p, row_best_in, row_best_out, moved, C);
  return (int)cudaGetLastError();
}

int rank_delta_fold(const float* hours, const uint8_t* mask,
                    const float* old_p, const float* new_p,
                    const float* changed, const float* rb_old,
                    const float* rb_new, const float* row_masks,
                    const float* scores_in, float* scores_out, int J, int C,
                    int S, void* stream) {
  const int blocks = (C + kFoldThreads - 1) / kFoldThreads;
  if (blocks > 0 && S > 0)
    fold_kernel<<<blocks, kFoldThreads, 0, (cudaStream_t)stream>>>(
        hours, mask, old_p, new_p, changed, rb_old, rb_new, row_masks,
        scores_in, scores_out, J, C, S);
  return (int)cudaGetLastError();
}

// The k-round kernel (any k in [1, C]).
int rank_delta_select_rounds(const float* scores, const uint8_t* finite,
                             float* top_v, int* top_i, int S, int C, int k,
                             void* stream) {
  const size_t smem = sizeof(uint32_t) * (size_t)((C + 31) / 32);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (S > 0 && k > 0)
    select_kernel<<<S, kSelectThreads, smem, (cudaStream_t)stream>>>(
        scores, finite, top_v, top_i, C, k);
  return (int)cudaGetLastError();
}

// The two-stage kernels, k in [1, min(C, 64)]: part is scratch for S x
// ceil(C / cols) x k keys, and cols must be the kernels' chunk (2,048);
// vec != 0 only where C % 4 == 0 and scores and finite start 16- and
// 4-byte aligned.
int rank_delta_select(const float* scores, const uint8_t* finite,
                      float* top_v, int* top_i, uint64_t* part, int S, int C,
                      int k, int cols, int vec, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kSelectCap || k > C || cols != kSelectChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return select_two_stage<1>(scores, finite, top_v, top_i, part, S, C, k,
                               vec, st);
  return select_two_stage<2>(scores, finite, top_v, top_i, part, S, C, k,
                             vec, st);
}

}  // extern "C"
