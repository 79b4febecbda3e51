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

// The k-head: one block per member row, k rounds of a block-wide
// lexicographic argmin over (masked score, column).  Taken columns are
// kept in a shared-memory bitmap, so a head is always k distinct configs
// even when a member has fewer than k profiled ones.
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

int rank_delta_select(const float* scores, const uint8_t* finite,
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

}  // extern "C"
