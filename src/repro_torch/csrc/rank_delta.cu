// Fused delta-rank reprice for Hopper (sm_90a): one fleet tick in two
// launches after the tick's price scatter, plus the k-head selection.  A
// plain C interface, loaded with ctypes by
// repro_torch/kernels/rank_delta.py; every entry point returns
// cudaGetLastError() after its launch and never synchronizes (but for
// what CUDA may do to stage rank_delta_scatter_pageable's upload, and
// the page-locked allocation entries).
//
// Replaces the Pallas kernel repro/kernels/rank_delta.py::_make_kernel
// (fused_reprice, and fused_reprice_heads with heads=k).  The TPU grid ran
// phase 0 (masked row minima) before phase 1 (member folds) on one core;
// here the two phases are two launches on one stream, which orders them.
//
// What bounds the tick: per tick it must read hours and mask (5 bytes a
// cell) and read and write the S x C score accumulators; the member folds
// are 4 flops per (member, row, column), far below the fp32 peak.  At 64
// jobs x 10,000 configs x 16 members that is about 4.5 MB, a floor near
// 1.3 us at 3.35 TB/s.  The design keeps no cost or norm matrix in device
// memory: both are recomputed from hours, mask and the price vectors in
// every pass.
//
// The row minima (rowmin_split_kernel).  Phase 0 reads hours and mask once
// (5 bytes a cell) and new_p once: at 64 x 10,000 that is 0.97 us at 3.35
// TB/s.  One 256-thread block a job row (rowmin_row_kernel, kept as the
// yardstick) gives 64 blocks on 132 SMs, and each thread walks C / 256
// columns in a chain where the mask load decides whether the hours load
// happens: two dependent round trips a step, so latency sets its time.
// The split kernel's grid is (J, column chunks of kRowminCols = 4,096,
// the fastest or tied of 1,024 to 8,192 in a sweep recorded in PERF.md):
// 192 blocks at 64 x 10,000, 1,600 at 64 x 100,000.  A thread issues
// all its loads (hours, mask, new_p: float4 and uchar4 where C is a
// multiple of 4 and the bases are aligned, else scalars) before it uses
// any, and applies the mask as a select.  The
// blocks of a row combine in the same launch, exactly: each writes its
// partial minimum to scratch, fences, and bumps the row's arrival counter;
// the row's last block reduces the partials with fminf and writes
// row_best_out[j], then bumps a grid counter; the grid's last block counts
// moved from the J minima and writes it.  The counters wrap to 0 on their
// last arrival (atomicInc), so the scratch needs no memset between
// launches and the wrapper launches no fill kernel: moved is written, not
// accumulated.  atomicMin on float bits was the alternative: it needs an
// output preset to +inf before every launch and still a last block to
// count moved, so it saves nothing.  Launches that share a scratch must be
// ordered: the wrapper keeps one scratch a (device, stream).
//
// The tick's prices (rank_delta_scatter_mapped, kernel scatter).  The
// reference densifies each tick on the host
// (repro/selector/pallas_rank.py::_dense_tick: a (1, C) price vector and
// a (1, C) changed vector, both uploaded).  Here the host writes the
// tick's n (int32 column, float32 price) pairs into a staging slot of
// page-locked host memory mapped into the card's address space
// (cudaHostAllocMapped | cudaHostAllocPortable, rank_delta_host_alloc):
// word 0 holds n, words 1 to cap the columns, the cap words after them
// the prices, so a slot is 8 cap + 4 bytes and never grows (the columns
// are distinct, so n <= C = cap for a fleet).  Two launches, counted as
// one: scatter_prepare_kernel copies old_p into new_p and clears changed
// on a grid over C, while one of its threads reads n from the slot into
// a word on the card; scatter_staged_kernel then reads n there and walks
// the pairs in a grid-stride loop on a grid the wrapper fixes from C
// alone, writing each pair's price and a 1.0 flag (the columns are
// distinct, so the writes never race).  Nothing in either launch depends
// on n, and the slot is read when the kernels run, not when they are
// queued: a CUDA graph captures the two once and every replay reads the
// pairs the host wrote before it.  The reads are zero-copy (__ldcv, never
// a cached line) rather than a memcpy node, whose size a graph fixes at
// capture (a copy of all C pairs a tick, or a graph a size).  Why one
// thread reads n: with every block reading it (the first design), the
// uncached reads of that one word went over PCIe one after another, about
// 1.2 us a block on the H100 (8 blocks 0.0164 ms, 132 blocks 0.1649 ms a
// call from a graph at C = 10,000, n = 100), while the pairs' reads, each
// word read once, overlap.  The copy and the clear go in the first launch
// and not in the second: a pair's write must land after the copy of its
// column, an order across blocks that two launches give and one would
// need a grid-wide barrier for.  The host must not rewrite a slot while
// a queued launch may still read it; the wrapper alternates slots and
// waits on the event recorded after a slot's last launch.  What bounds
// it: 12 C + 8 n bytes on the card (0.04 us at 10,000 columns), plus one
// PCIe round trip for n and one for the pairs, about a microsecond each.
// rank_delta_scatter_pageable, the entry it replaced and the yardstick,
// sends the pairs from pageable memory in a copy whose size only the host
// knows, so it refuses a graph capture.
//
// The fold (fold_rows_kernel).  With one thread a column walking all J
// rows (fold_col_kernel, kept as the yardstick), 10,000 columns are 2.4
// warps an SM, each thread a chain of J dependent mask and hours loads:
// latency, not bytes, set its time.  The row-split fold gives each block
// 32 columns (one a lane, so a row's hours are one 128-byte line a warp)
// and 8 warps, warp w taking rows w, w + 8, ...: a thread's chain is J / 8
// rows and the card holds about 19 warps an SM at C = 10,000.  Each warp
// keeps its rows' member partials in registers (8 or 16 members, a
// template argument, so a fleet of at most 8 carries no dead
// accumulators); the block adds the 8 partials through shared memory in
// fixed warp order and one thread writes each output.  No float atomics
// and no scratch in device memory: one launch, and two launches on the
// same inputs give bit-identical scores.
//
// Exactness is the contract.  Build without fast math.  __fmul_rn and
// __fdiv_rn are never contracted into FMAs, so an unchanged column
// recomputes bit-identical cost and norm cells and norm_new - norm_old is
// an exact 0.0: every partial of an identity tick is +0.0 and the tick
// leaves scores and row minima bit-for-bit unchanged.  The row minima are
// order-free and so bitwise equal to any other exact evaluation; only the
// order of the member sums differs from the reference, which its float32
// tolerance envelope covers.
//
// The k-head replaces jax.lax.top_k in the reference fleet's top_k
// (repro/selector/rank.py:1218) and the Pallas kernel's in-kernel top-k
// tail (repro/kernels/rank_delta.py:157).  For each row it returns the k
// lowest (masked score, column) pairs in lexicographic order, k distinct
// columns, unprofiled (non-finite) columns as +inf in catalog order.  What
// bounds it: memory, 5 bytes a cell read once (1 x 10,000: 0.015 us;
// 16 x 100,000: 2.4 us), so launch latency, the number of SMs at work and
// the length of each block's dependent chain decide its time.
//   - Each candidate is one 64-bit key: the score's order-preserving bits
//     (-0.0 first made +0.0, which lex_less ties with it; non-finite
//     +inf) over the column.  Lexicographic order is one integer compare,
//     and keys are distinct because columns are.
//   - k <= kSelectCap (256), select: a grid of (chunks of 2,048 columns)
//     x rows.  Each warp reads 256 columns once (float4 scores and uchar4
//     flags where C is a multiple of 4) and sorts their keys with a
//     bitonic network, 8 a lane: fixed work, no data-dependent chain.
//     Its best 32 R keys (R = 1, 2, 4 or 8 registers a lane) merge with
//     the other warps' in a tree (the minimum of one list and the other
//     reversed is bitonic; a bitonic merge sorts it), and the chunk's k
//     best go to scratch.  A second launch, one block a row, merges its
//     chunks' lists the same way and unpacks the k-head, reading each
//     value back from the row.  At 1 x 10,000 that is 5 + 1 blocks; at
//     16 x 100,000, 784 + 16.
//   - k > kSelectCap, select_sort: the same chunks, each sorted whole in
//     shared memory (the warps' bitonic sorts, then three in-block
//     merge-path rounds), its first min(k, 2,048) keys to scratch; then
//     ceil(log2(chunks)) launches each merge pairs of sorted lists, cut
//     to their first k keys.  A block owns 2,048 output positions of one
//     pair, finds where they start and end on both inputs with a search
//     along the merge path's diagonals (256 candidates a step), stages
//     both input runs in shared memory and merges them, 8 outputs a
//     thread.  The last launch unpacks the head.  One code path serves
//     every k up to C; keys are distinct, so the merge is exact and ties
//     fall in catalog order by construction.
// select_kernel, the k-round k-head that served k above 64 before
// select_sort, stays as a yardstick only; no wrapper path reaches it.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

constexpr int kRowminThreads = 256;
constexpr int kRowminGroups = 4;    // rowmin: float4 groups a thread
constexpr int kRowminCols = kRowminThreads * 4 * kRowminGroups;  // a block
constexpr int kFoldThreads = 128;   // fold_col: one thread per column
constexpr int kFoldRows = 64;       // job rows staged in shared memory
constexpr int kFoldMembers = 16;    // member accumulators in registers
constexpr int kFoldCols = 32;       // fold_rows: columns a block, one a lane
constexpr int kFoldWarps = 8;       // fold_rows: row groups a block
constexpr int kSelectThreads = 512;
constexpr int kScatterThreads = 256;  // scatter: threads a block
constexpr int kScatterPrepBlocks = 1024;  // scatter: copy and clear
constexpr int kWarp = 32;
constexpr int kNoIndex = 0x7fffffff;  // sorts after every column

// Phase 0, the yardstick: one block per job row.  row_best_out[j] is the
// masked minimum of hours[j, :] * new_p; moved (zeroed by the caller)
// counts the rows whose minimum changed.  row_best_in is only read: the
// fold still needs the old minima.
__global__ void rowmin_row_kernel(const float* __restrict__ hours,
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

// The minimum of v over the block, valid in thread 0.  red holds a float
// a warp; a second call must follow a barrier after thread 0's reads.
__device__ __forceinline__ float block_min(float v, float* red) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kRowminThreads / kWarp; ++w) v = fminf(v, red[w]);
  return v;
}

// Phase 0, split: block (j, chunk) takes columns [chunk * kRowminCols,
// + kRowminCols) of row j, 16 a thread, all loaded before any is used.
// counters[0] counts the rows finished in this launch, counters[1 + j]
// row j's finished chunks (both 0 between launches); partials holds J x
// chunks minima.  row_best_out[j] and moved are written once, by the row's and
// the grid's last block.
template <bool kVec>
__global__ void __launch_bounds__(kRowminThreads)
rowmin_split_kernel(const float* __restrict__ hours,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ new_p,
                    const float* __restrict__ row_best_in,
                    float* row_best_out, int* __restrict__ moved,
                    unsigned* counters, float* partials, int J, int C) {
  constexpr int Q = kRowminGroups;
  constexpr int kItems = 4 * Q;                    // columns a thread
  __shared__ float red[kRowminThreads / kWarp];
  __shared__ int last;
  const int j = blockIdx.x, chunk = blockIdx.y, chunks = gridDim.y;
  const size_t row = (size_t)j * C;
  const int c0 = chunk * kRowminCols;
  float v[kItems];
  if (kVec) {
    // thread t's group q is columns c0 + 4 (256 q + t) .. + 3, so a warp
    // reads 512 contiguous bytes of hours; C % 4 == 0, so a group is
    // whole or past the row's end
    const float4* h4 = reinterpret_cast<const float4*>(hours + row);
    const uchar4* m4 = reinterpret_cast<const uchar4*>(mask + row);
    const float4* p4 = reinterpret_cast<const float4*>(new_p);
    float4 h[Q], p[Q];
    uchar4 m[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int g = (c0 >> 2) + q * kRowminThreads + threadIdx.x;
      const bool live = 4 * g < C;
      h[q] = live ? h4[g] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      m[q] = live ? m4[g] : make_uchar4(0, 0, 0, 0);
      p[q] = live ? p4[g] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      v[4 * q] = m[q].x ? __fmul_rn(h[q].x, p[q].x) : CUDART_INF_F;
      v[4 * q + 1] = m[q].y ? __fmul_rn(h[q].y, p[q].y) : CUDART_INF_F;
      v[4 * q + 2] = m[q].z ? __fmul_rn(h[q].z, p[q].z) : CUDART_INF_F;
      v[4 * q + 3] = m[q].w ? __fmul_rn(h[q].w, p[q].w) : CUDART_INF_F;
    }
  } else {
    float h[kItems], p[kItems];
    uint8_t m[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int c = c0 + i * kRowminThreads + threadIdx.x;
      const bool live = c < C;
      h[i] = live ? hours[row + c] : 0.0f;
      m[i] = live ? mask[row + c] : 0;
      p[i] = live ? new_p[c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      v[i] = m[i] ? __fmul_rn(h[i], p[i]) : CUDART_INF_F;
  }
  float best = v[0];
#pragma unroll
  for (int i = 1; i < kItems; ++i) best = fminf(best, v[i]);
  best = block_min(best, red);
  if (threadIdx.x == 0) {
    partials[(size_t)j * chunks + chunk] = best;
    __threadfence();                  // the partial lands before the count
    last = atomicInc(&counters[1 + j], chunks - 1) == (unsigned)(chunks - 1);
  }
  __syncthreads();
  if (!last) return;                  // block-uniform
  // the row's last block: every partial of row j has landed (read past L1)
  __threadfence();
  best = CUDART_INF_F;
  for (int t = threadIdx.x; t < chunks; t += kRowminThreads)
    best = fminf(best, __ldcg(partials + (size_t)j * chunks + t));
  best = block_min(best, red);
  if (threadIdx.x == 0) {
    row_best_out[j] = best;
    __threadfence();
    last = atomicInc(&counters[0], J - 1) == (unsigned)(J - 1);
  }
  __syncthreads();
  if (!last) return;
  // the grid's last block: every row's minimum has landed
  __threadfence();
  int n = 0;
  for (int r0 = 0; r0 < J; r0 += kRowminThreads) {
    const int r = r0 + threadIdx.x;
    // a fully masked row stays inf == inf and never counts as a handoff
    n += __syncthreads_count(r < J &&
                             __ldcg(row_best_out + r) != row_best_in[r]);
  }
  if (threadIdx.x == 0) *moved = n;
}

// The pageable yardstick's pairs: thread i writes pair i (the wrapper
// has checked that the columns are distinct and in [0, C)).
__global__ void scatter_kernel(const int* __restrict__ cols,
                               const float* __restrict__ prices, int n,
                               float* __restrict__ new_p,
                               float* __restrict__ changed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cols[i];
  new_p[c] = prices[i];
  changed[c] = 1.0f;
}

// Scatter, launch 1 of 2 (see the note above): new_p = old_p and
// changed = 0 over the grid, and the slot's n, clamped to the slot, into
// *count by one thread.
__global__ void scatter_prepare_kernel(const int* staged, int cap, int C,
                                       const float* __restrict__ old_p,
                                       float* __restrict__ new_p,
                                       float* __restrict__ changed,
                                       int* __restrict__ count) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *count = min(max(__ldcv(staged), 0), cap);
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x) {
    new_p[c] = old_p[c];
    changed[c] = 0.0f;
  }
}

// Scatter, launch 2 of 2: the grid walks the staged pairs.  A column
// outside [0, C) is skipped, so a corrupt slot cannot write outside the
// vectors; the wrapper has checked the columns.
__global__ void scatter_staged_kernel(const int* staged, int cap, int C,
                                      const int* __restrict__ count,
                                      float* __restrict__ new_p,
                                      float* __restrict__ changed) {
  const int n = *count;
  const int* cols = staged + 1;
  const float* prices = reinterpret_cast<const float*>(staged + 1 + cap);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int c = __ldcv(cols + i);
    const float p = __ldcv(prices + i);
    if ((unsigned)c < (unsigned)C) {
      new_p[c] = p;
      changed[c] = 1.0f;
    }
  }
}

// Both norms of cell (j, c) from its hours h, and their difference:
// n_new = h * pn / rb_new, dn = n_new - h * po / rb_old.  Only called for
// a profiled cell: a masked one never divides, so a fully masked row
// (inf / inf) never yields NaN.
__device__ __forceinline__ void cell_norms(float h, float po, float pn,
                                           float rb_old, float rb_new,
                                           float& n_new, float& dn) {
  const float n_old = __fdiv_rn(__fmul_rn(h, po), rb_old);
  n_new = __fdiv_rn(__fmul_rn(h, pn), rb_new);
  dn = __fsub_rn(n_new, n_old);
}

// Phase 1, the yardstick: one thread per column.  For each chunk of
// members, stream the job rows, recompute both norms of the cell, and
// accumulate
//   P = sum_j rm[s, j] * norm_new[j, c]
//   D = sum_j rm[s, j] * (norm_new[j, c] - norm_old[j, c]);
// then write changed ? P : scores_in + D.  scores_out may alias
// scores_in: each element is read and then written by one thread only.
__global__ void fold_col_kernel(const float* __restrict__ hours,
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
        float n_new, dn;
        cell_norms(hours[cell], po, pn, s_rb_old[jj], s_rb_new[jj], n_new,
                   dn);
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

// Phase 1, row-split: block b covers columns [32 b, 32 b + 32), one a
// lane; warp w folds rows w, w + 8, ... of each staged chunk of 64 rows
// into M member partials of P and D in registers, its rows' loads issued
// together before their use.  The block then adds the 8 warps' partials in
// warp order 0..7 through shared memory, and thread t writes
// (member, column) outputs t, t + 256, ..., whose scores_in it reads
// before the rows so that their latency hides behind them.
// scores_out may alias scores_in: each output is read and written by one
// thread.
template <int M>
__global__ void __launch_bounds__(kFoldCols * kFoldWarps)
fold_rows_kernel(const float* __restrict__ hours,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ old_p,
                 const float* __restrict__ new_p,
                 const float* __restrict__ changed,
                 const float* __restrict__ rb_old,
                 const float* __restrict__ rb_new,
                 const float* __restrict__ row_masks,
                 const float* scores_in, float* scores_out, int J, int C,
                 int S) {
  constexpr int kThreads = kFoldCols * kFoldWarps;
  constexpr int kOuts = (M * kFoldCols + kThreads - 1) / kThreads;
  constexpr int kBatch = kFoldRows / kFoldWarps;  // a warp's staged rows
  static_assert(M % 4 == 0, "row masks are read 4 members at a time");
  __shared__ float s_rb_old[kFoldRows];
  __shared__ float s_rb_new[kFoldRows];
  __shared__ __align__(16) float s_rm[kFoldRows][M];
  __shared__ float part_p[kFoldWarps][M][kFoldCols];
  __shared__ float part_d[kFoldWarps][M][kFoldCols];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int c0 = blockIdx.x * kFoldCols;
  const int c = c0 + lane;
  const bool live = c < C;
  const float po = live ? old_p[c] : 0.0f;
  const float pn = live ? new_p[c] : 0.0f;
  for (int s0 = 0; s0 < S; s0 += M) {
    const int ns = min(M, S - s0);
    float sc_in[kOuts];
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      const int t = threadIdx.x + o * kThreads;
      const int sm = t / kFoldCols, col = c0 + t % kFoldCols;
      sc_in[o] = t < M * kFoldCols && sm < ns && col < C
                     ? scores_in[(size_t)(s0 + sm) * C + col] : 0.0f;
    }
    float p_acc[M], d_acc[M];
#pragma unroll
    for (int s = 0; s < M; ++s) p_acc[s] = d_acc[s] = 0.0f;
    for (int j0 = 0; j0 < J; j0 += kFoldRows) {
      const int nj = min(kFoldRows, J - j0);
      __syncthreads();  // the previous chunk's readers are done
      for (int t = threadIdx.x; t < kFoldRows; t += kThreads) {
        s_rb_old[t] = t < nj ? rb_old[j0 + t] : 1.0f;
        s_rb_new[t] = t < nj ? rb_new[j0 + t] : 1.0f;
      }
      for (int t = threadIdx.x; t < M * kFoldRows; t += kThreads) {
        const int jj = t / M, s = t % M;
        s_rm[jj][s] = (s < ns && jj < nj)
                          ? row_masks[(size_t)(s0 + s) * J + j0 + jj]
                          : 0.0f;
      }
      __syncthreads();
      if (!live) continue;
      for (int jb = warp; jb < nj; jb += kFoldWarps * kBatch) {
        bool on[kBatch];
        float h[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int jj = jb + u * kFoldWarps;
          const size_t cell = (size_t)(j0 + jj) * C + c;
          on[u] = jj < nj && mask[cell] != 0;
          h[u] = jj < nj ? hours[cell] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (!on[u]) continue;  // masked cells normalize to 0 in both
          const int jj = jb + u * kFoldWarps;
          float n_new, dn;
          cell_norms(h[u], po, pn, s_rb_old[jj], s_rb_new[jj], n_new, dn);
          const float4* rm4 = reinterpret_cast<const float4*>(s_rm[jj]);
#pragma unroll
          for (int q = 0; q < M / 4; ++q) {
            const float4 r = rm4[q];
            p_acc[4 * q] += r.x * n_new;
            d_acc[4 * q] += r.x * dn;
            p_acc[4 * q + 1] += r.y * n_new;
            d_acc[4 * q + 1] += r.y * dn;
            p_acc[4 * q + 2] += r.z * n_new;
            d_acc[4 * q + 2] += r.z * dn;
            p_acc[4 * q + 3] += r.w * n_new;
            d_acc[4 * q + 3] += r.w * dn;
          }
        }
      }
    }
#pragma unroll  // constant indices keep the accumulators in registers
    for (int s = 0; s < M; ++s) {
      part_p[warp][s][lane] = p_acc[s];
      part_d[warp][s][lane] = d_acc[s];
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      const int t = threadIdx.x + o * kThreads;
      const int sm = t / kFoldCols, col = t % kFoldCols;
      if (t >= M * kFoldCols || sm >= ns || c0 + col >= C) continue;
      float P = part_p[0][sm][col], D = part_d[0][sm][col];
#pragma unroll
      for (int w = 1; w < kFoldWarps; ++w) {  // fixed order: repeatable
        P += part_p[w][sm][col];
        D += part_d[w][sm][col];
      }
      scores_out[(size_t)(s0 + sm) * C + c0 + col] =
          changed[c0 + col] > 0.0f ? P : sc_in[o] + D;
    }
    __syncthreads();  // the partials are read before the next chunk's
  }
}

// (value, index) in lexicographic order: the lower value, then the lower
// index.  An unprofiled config has value inf and so ranks after every
// profiled one, in catalog order among its kind.
__device__ __forceinline__ bool lex_less(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// The k-round k-head, the yardstick: one block per member row, k rounds
// of a block-wide lexicographic argmin over (masked score, column).
// Taken columns are kept in a shared-memory bitmap, so a head is always k
// distinct configs even when a member has fewer than k profiled ones.
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

// --- the k-head: keys, warp sorts ------------------------------------------

constexpr int kSelectCap = 256;         // the largest k select serves
constexpr int kChunkThreads = 256;      // 8 warps a block, every stage
constexpr int kLaneKeys = 8;            // keys a lane sorts in stage 1
static_assert(kSelectCap == 32 * kLaneKeys,
              "select keeps at most a warp's sorted keys");
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

// The head entry of key ``key`` of row ``row``: its column, and the value
// read back from the row (+inf where unprofiled).
__device__ __forceinline__ void unpack_key(uint64_t key,
                                           const float* __restrict__ scores,
                                           const uint8_t* __restrict__ finite,
                                           size_t row, float* v, int* i) {
  const int c = (int)(uint32_t)key;   // a head holds only real columns
  *i = c;
  *v = finite[row + c] ? scores[row + c] : CUDART_INF_F;
}

// The keys of the 256 columns from c0 a warp reads in stage 1, 8 a lane
// (float4 scores and uchar4 flags where ``vec``: C a multiple of 4,
// aligned bases); kNoKey past the row's end.
__device__ __forceinline__ void load_keys(const float* __restrict__ scores,
                                          const uint8_t* __restrict__ finite,
                                          size_t row, int c0, int C,
                                          int vec, int lane,
                                          uint64_t (&e)[kLaneKeys]) {
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

// --- select: the two-stage k-head, k <= kSelectCap --------------------------

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
// lane, read once, and keeps its 32 R best.
template <int R>
__global__ void __launch_bounds__(kChunkThreads)
select_chunk_kernel(const float* __restrict__ scores,
                    const uint8_t* __restrict__ finite,
                    uint64_t* __restrict__ part, int C, int k, int vec) {
  static_assert(R <= kLaneKeys, "a warp sorts 32 x kLaneKeys keys");
  __shared__ uint64_t lists[kChunkThreads / kWarp][32 * R];
  const int s = blockIdx.y, chunk = blockIdx.x;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  uint64_t e[kLaneKeys];
  load_keys(scores, finite, (size_t)s * C,
            chunk * kSelectChunk + warp * 32 * kLaneKeys, C, vec, lane, e);
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
    if (idx < k)
      unpack_key(e[r], scores, finite, row, &top_v[(size_t)s * k + idx],
                 &top_i[(size_t)s * k + idx]);
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

// --- select_sort: chunk sorts and a merge tree, any k ----------------------

// Merge path over ascending a[0, na) and b[0, nb), a's key first on ties
// (only kNoKey repeats): a's share of the merge's first d outputs.
__device__ __forceinline__ int merge_split(const uint64_t* a, int na,
                                           const uint64_t* b, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (a[m] <= b[d - 1 - m]) lo = m + 1; else hi = m;
  }
  return lo;
}

// out[0, n) = outputs d .. d + n - 1 of that merge (n <= na + nb - d).
__device__ __forceinline__ void merge_run(const uint64_t* a, int na,
                                          const uint64_t* b, int nb, int d,
                                          int n, uint64_t* out) {
  int i = merge_split(a, na, b, nb, d), j = d - i;
  for (int t = 0; t < n; ++t) {
    const bool take_a = j >= nb || (i < na && a[i] <= b[j]);
    out[t] = take_a ? a[i++] : b[j++];
  }
}

// merge_split for the whole block over device memory: each step tests up
// to blockDim.x evenly spaced diagonal points at once and keeps the span
// between the last that passes and the first that fails, so a split over
// k positions takes ceil(log256(k)) dependent loads instead of log2(k).
// Every thread must call it; lo and hi stay block-uniform.
__device__ int block_split(const uint64_t* __restrict__ a, int na,
                           const uint64_t* __restrict__ b, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int step = (hi - lo + blockDim.x - 1) / blockDim.x;
    const int m = lo + (int)threadIdx.x * step;
    const int pass = __syncthreads_count(m < hi && a[m] <= b[d - 1 - m]);
    const int next_lo = pass ? lo + (pass - 1) * step + 1 : lo;
    hi = min(hi, lo + pass * step);
    lo = next_lo;
  }
  return lo;
}

// Stage 1: block (chunk, row) sorts the chunk's keys whole: each warp
// sorts 256 in registers, then three rounds merge pairs of sorted runs in
// shared memory (256 -> 512 -> 1,024 -> 2,048), 8 outputs a thread.  The
// first L keys go to part[row][chunk][:L]; with one chunk a row (C <=
// 2,048) the block unpacks the k-head itself.
__global__ void __launch_bounds__(kChunkThreads)
select_sort_chunk_kernel(const float* __restrict__ scores,
                         const uint8_t* __restrict__ finite,
                         uint64_t* __restrict__ part,
                         float* __restrict__ top_v, int* __restrict__ top_i,
                         int C, int k, int L, int vec) {
  __shared__ uint64_t buf[2][kSelectChunk];
  const int s = blockIdx.y, chunk = blockIdx.x;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const size_t row = (size_t)s * C;
  uint64_t e[kLaneKeys];
  load_keys(scores, finite, row, chunk * kSelectChunk + warp * 32 * kLaneKeys,
            C, vec, lane, e);
  warp_sort<kLaneKeys>(e, lane);
#pragma unroll
  for (int r = 0; r < kLaneKeys; ++r)
    buf[0][warp * 32 * kLaneKeys + r * 32 + lane] = e[r];
  __syncthreads();
  int src = 0;
  for (int run = 32 * kLaneKeys; run < kSelectChunk; run *= 2) {
    const int g = threadIdx.x * kLaneKeys;   // this thread's 8 outputs
    const int base = g / (2 * run) * (2 * run);
    const uint64_t* a = buf[src] + base;
    merge_run(a, run, a + run, run, g - base, kLaneKeys, buf[src ^ 1] + g);
    src ^= 1;
    __syncthreads();
  }
  if (gridDim.x == 1) {      // k <= C <= 2,048: the head is here
    for (int t = threadIdx.x; t < k; t += blockDim.x)
      unpack_key(buf[src][t], scores, finite, row, &top_v[(size_t)s * k + t],
                 &top_i[(size_t)s * k + t]);
    return;
  }
  uint64_t* out = part + ((size_t)s * gridDim.x + chunk) * L;
  for (int t = threadIdx.x; t < L; t += blockDim.x) out[t] = buf[src][t];
}

// One round of the merge tree.  Row s's lists in ``in`` each cover w
// chunks (the last fewer) and sit at stride L_in; list p's length is
// min(k, 2,048 x chunks covered).  Block (x, s) takes pair x / spans
// (lists 2p and 2p + 1; an unpaired last list is copied) and output
// positions [2,048 (x % spans), + 2,048) of the pair's merge cut to k,
// written to list p of ``out`` at stride L_out, or, in the last round,
// unpacked into the head.  Row stride in both buffers: ``stride`` keys.
__global__ void __launch_bounds__(kChunkThreads)
select_sort_merge_kernel(const float* __restrict__ scores,
                         const uint8_t* __restrict__ finite,
                         const uint64_t* __restrict__ in,
                         uint64_t* __restrict__ out,
                         float* __restrict__ top_v, int* __restrict__ top_i,
                         int C, int k, int nchunks, int w, int L_in,
                         int L_out, size_t stride, int spans, int last) {
  __shared__ uint64_t runs[kSelectChunk];     // a's run, then b's
  __shared__ uint64_t merged[kSelectChunk];
  const int s = blockIdx.y;
  const int pair = blockIdx.x / spans, span = blockIdx.x % spans;
  const int cov_a = min(w, nchunks - 2 * pair * w);
  const int cov_b = max(0, min(w, nchunks - (2 * pair + 1) * w));
  const int na = min(k, kSelectChunk * cov_a);
  const int nb = cov_b > 0 ? min(k, kSelectChunk * cov_b) : 0;
  const int n_out = min(k, na + nb);
  const int o0 = span * kSelectChunk;
  if (o0 >= n_out) return;                    // block-uniform
  const int o1 = min(o0 + kSelectChunk, n_out);
  const uint64_t* a = in + s * stride + (size_t)(2 * pair) * L_in;
  const uint64_t* b = a + L_in;
  const int i0 = block_split(a, na, b, nb, o0);
  const int i1 = block_split(a, na, b, nb, o1);
  const int ma = i1 - i0, mb = (o1 - i1) - (o0 - i0);
  for (int t = threadIdx.x; t < ma; t += blockDim.x) runs[t] = a[i0 + t];
  for (int t = threadIdx.x; t < mb; t += blockDim.x)
    runs[ma + t] = b[o0 - i0 + t];
  __syncthreads();
  const int m = o1 - o0;
  const int g = threadIdx.x * kLaneKeys;
  if (g < m)
    merge_run(runs, ma, runs + ma, mb, g, min(kLaneKeys, m - g), merged + g);
  __syncthreads();
  if (last) {
    const size_t row = (size_t)s * C;
    for (int t = threadIdx.x; t < m; t += blockDim.x)
      unpack_key(merged[t], scores, finite, row,
                 &top_v[(size_t)s * k + o0 + t],
                 &top_i[(size_t)s * k + o0 + t]);
  } else {
    uint64_t* o = out + s * stride + (size_t)pair * L_out + o0;
    for (int t = threadIdx.x; t < m; t += blockDim.x) o[t] = merged[t];
  }
}

}  // namespace

extern "C" {

// The split row minima: counters hold J + 1 words, 0 on entry and on
// return, and no other launch uses them meanwhile; partials J x ceil(C /
// kRowminCols) floats; vec != 0 only where C % 4 == 0, hours and new_p
// start 16-byte and mask 4-byte aligned.  moved is written, never
// accumulated: the caller need not zero it.
int rank_delta_rowmin(const float* hours, const uint8_t* mask,
                      const float* new_p, const float* row_best_in,
                      float* row_best_out, int* moved, unsigned* counters,
                      float* partials, int J, int C, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (J <= 0) return (int)cudaMemsetAsync(moved, 0, sizeof(int), st);
  const int chunks = (C + kRowminCols - 1) / kRowminCols;
  if (C < 0 || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(J, chunks > 0 ? chunks : 1);   // C = 0: rows of +inf
  if (vec)
    rowmin_split_kernel<true><<<grid, kRowminThreads, 0, st>>>(
        hours, mask, new_p, row_best_in, row_best_out, moved, counters,
        partials, J, C);
  else
    rowmin_split_kernel<false><<<grid, kRowminThreads, 0, st>>>(
        hours, mask, new_p, row_best_in, row_best_out, moved, counters,
        partials, J, C);
  return (int)cudaGetLastError();
}

// The tick's new prices and changed flags from the pairs in a staging
// slot (see the note above): staged is the slot's address on the card,
// 1 + 2 cap int32 words, and count one int on the card for its n; new_p =
// old_p with the pairs' prices, changed = 1.0 at their columns and 0
// elsewhere.  blocks (at least 1) is the pair launch's fixed grid.  A
// graph may capture it.
int rank_delta_scatter_mapped(const int* staged, int cap, int* count,
                              const float* old_p, float* new_p,
                              float* changed, int C, int blocks,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 0 || cap < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaGetLastError();
  const int prep = min((C + kScatterThreads - 1) / kScatterThreads,
                       kScatterPrepBlocks);
  scatter_prepare_kernel<<<prep, kScatterThreads, 0, st>>>(
      staged, cap, C, old_p, new_p, changed, count);
  scatter_staged_kernel<<<blocks, kScatterThreads, 0, st>>>(
      staged, cap, C, count, new_p, changed);
  return (int)cudaGetLastError();
}

// bytes of zeroed page-locked host memory mapped into the card's address
// space: *host is its host address, *dev its address on the card.  For
// the staging slots and the tick's handoff count, which rowmin's last
// block writes there directly.
int rank_delta_host_alloc(size_t bytes, void** host, void** dev) {
  cudaError_t err = cudaHostAlloc(host, bytes, cudaHostAllocMapped |
                                                   cudaHostAllocPortable);
  if (err != cudaSuccess) return (int)err;
  memset(*host, 0, bytes);
  err = cudaHostGetDevicePointer(dev, *host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(*host);
    *host = nullptr;
  }
  return (int)err;
}

int rank_delta_host_free(void* host) { return (int)cudaFreeHost(host); }

// The entry scatter replaced, kept as the yardstick: cols holds n int32
// columns (distinct, in [0, C)) and prices n float32 prices, both in
// host memory; dev_pairs is 8 n bytes on the card.  The pairs are packed
// into one pageable buffer and sent in one copy; cudaMemcpyAsync returns
// once CUDA has read it (it stages pageable memory), so nothing on the
// host is held past the call.  A stream being captured into a graph is
// refused with cudaErrorStreamCaptureUnsupported.
int rank_delta_scatter_pageable(const int* cols, const float* prices,
                                void* dev_pairs, const float* old_p,
                                float* new_p, float* changed, int n, int C,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  cudaStreamCaptureStatus capture;
  cudaError_t err = cudaStreamIsCapturing(st, &capture);
  if (err != cudaSuccess) return (int)err;
  if (capture != cudaStreamCaptureStatusNone)
    return (int)cudaErrorStreamCaptureUnsupported;
  // the upload first: if CUDA waits on the stream to stage it, it
  // waits for the caller's work only
  if (n > 0) {
    std::vector<int> packed(2 * (size_t)n);
    memcpy(packed.data(), cols, sizeof(int) * (size_t)n);
    memcpy(packed.data() + n, prices, sizeof(float) * (size_t)n);
    err = cudaMemcpyAsync(dev_pairs, packed.data(), 8 * (size_t)n,
                          cudaMemcpyHostToDevice, st);
  }
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(new_p, old_p, sizeof(float) * (size_t)C,
                          cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(changed, 0, sizeof(float) * (size_t)C, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int* d_cols = static_cast<const int*>(dev_pairs);
    const float* d_prices = reinterpret_cast<const float*>(d_cols + n);
    scatter_kernel<<<(n + 255) / 256, 256, 0, st>>>(d_cols, d_prices, n,
                                                     new_p, changed);
  }
  return (int)cudaGetLastError();
}

// The one-block-a-row kernel the split one replaced (the yardstick);
// moved must be zeroed first.
int rank_delta_rowmin_row(const float* hours, const uint8_t* mask,
                          const float* new_p, const float* row_best_in,
                          float* row_best_out, int* moved, int J, int C,
                          void* stream) {
  if (J > 0)
    rowmin_row_kernel<<<J, kRowminThreads, 0, (cudaStream_t)stream>>>(
        hours, mask, new_p, row_best_in, row_best_out, moved, C);
  return (int)cudaGetLastError();
}

// The row-split fold: 8 member accumulators a thread where S <= 8, else
// 16 (more members loop over chunks of 16).
int rank_delta_fold(const float* hours, const uint8_t* mask,
                    const float* old_p, const float* new_p,
                    const float* changed, const float* rb_old,
                    const float* rb_new, const float* row_masks,
                    const float* scores_in, float* scores_out, int J, int C,
                    int S, void* stream) {
  const int blocks = (C + kFoldCols - 1) / kFoldCols;
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks > 0 && S > 0) {
    if (S <= 8)
      fold_rows_kernel<8>
          <<<blocks, kFoldCols * kFoldWarps, 0, st>>>(
          hours, mask, old_p, new_p, changed, rb_old, rb_new, row_masks,
          scores_in, scores_out, J, C, S);
    else
      fold_rows_kernel<16>
          <<<blocks, kFoldCols * kFoldWarps, 0, st>>>(
          hours, mask, old_p, new_p, changed, rb_old, rb_new, row_masks,
          scores_in, scores_out, J, C, S);
  }
  return (int)cudaGetLastError();
}

// The column-per-thread fold the row-split one replaced (the yardstick).
int rank_delta_fold_col(const float* hours, const uint8_t* mask,
                        const float* old_p, const float* new_p,
                        const float* changed, const float* rb_old,
                        const float* rb_new, const float* row_masks,
                        const float* scores_in, float* scores_out, int J,
                        int C, int S, void* stream) {
  const int blocks = (C + kFoldThreads - 1) / kFoldThreads;
  if (blocks > 0 && S > 0)
    fold_col_kernel<<<blocks, kFoldThreads, 0, (cudaStream_t)stream>>>(
        hours, mask, old_p, new_p, changed, rb_old, rb_new, row_masks,
        scores_in, scores_out, J, C, S);
  return (int)cudaGetLastError();
}

// The k-round kernel (any k in [1, C]), the yardstick.
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

// The two-stage kernels, k in [1, min(C, 32 R)] with R in {1, 2, 4, 8}
// (R <= 8 means k <= kSelectCap): part is scratch for S x ceil(C / cols)
// x k keys, and cols must be the kernels' chunk (2,048); vec != 0 only
// where C % 4 == 0 and scores and finite start 16- and 4-byte aligned.
int rank_delta_select(const float* scores, const uint8_t* finite,
                      float* top_v, int* top_i, uint64_t* part, int S, int C,
                      int k, int cols, int R, int vec, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > C || k > 32 * R || k > kSelectCap ||
      cols != kSelectChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 1: return select_two_stage<1>(scores, finite, top_v, top_i, part,
                                       S, C, k, vec, st);
    case 2: return select_two_stage<2>(scores, finite, top_v, top_i, part,
                                       S, C, k, vec, st);
    case 4: return select_two_stage<4>(scores, finite, top_v, top_i, part,
                                       S, C, k, vec, st);
    case 8: return select_two_stage<8>(scores, finite, top_v, top_i, part,
                                       S, C, k, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The sort-and-merge k-head, k in [1, C]: 1 + ceil(log2(chunks))
// launches, chunks = ceil(C / cols).  scratch holds two buffers of S x
// chunks x min(k, cols) keys; cols must be the kernels' chunk (2,048);
// vec as for rank_delta_select.
int rank_delta_select_sort(const float* scores, const uint8_t* finite,
                           float* top_v, int* top_i, uint64_t* scratch,
                           int S, int C, int k, int cols, int vec,
                           void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > C || cols != kSelectChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nchunks = (C + kSelectChunk - 1) / kSelectChunk;
  const int L0 = min(k, kSelectChunk);
  const size_t stride = (size_t)nchunks * L0;
  uint64_t* src = scratch;
  uint64_t* dst = scratch + (size_t)S * stride;
  select_sort_chunk_kernel<<<dim3(nchunks, S), kChunkThreads, 0, st>>>(
      scores, finite, src, top_v, top_i, C, k, L0, vec);
  int L_in = L0;
  for (int w = 1; w < nchunks; w *= 2) {
    const int L_out = min(k, 2 * L_in);
    const int pairs = ((nchunks + w - 1) / w + 1) / 2;
    const int spans = (L_out + kSelectChunk - 1) / kSelectChunk;
    const int last = 2 * w >= nchunks;
    select_sort_merge_kernel<<<dim3(pairs * spans, S), kChunkThreads, 0,
                               st>>>(scores, finite, src, dst, top_v, top_i,
                                     C, k, nchunks, w, L_in, L_out, stride,
                                     spans, last);
    uint64_t* t = src;
    src = dst;
    dst = t;
    L_in = L_out;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
