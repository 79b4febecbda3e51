// The RWKV-6 ("Finch") WKV recurrence for Hopper (sm_90a).  A plain C
// interface, loaded with ctypes by repro_torch/kernels/rwkv6_scan.py; each
// entry point returns cudaGetLastError() after its launch and never
// synchronizes.
//
// Replaces the Pallas kernel repro/kernels/rwkv6_scan.py::_kernel (:25),
// called by wkv6_pallas (:67).  Per (b, h) stream, with an (N, N) fp32
// state s (rows i index k, columns j index v), step by step in t:
//
//     y_t[j] = sum_i r_t[i] s[i][j] + c_t v_t[j]
//     c_t = sum_i r_t[i] u[i] k_t[i]
//     s[i][j] <- w_t[i] s[i][j] + k_t[i] v_t[j]
//
// (the reference's y_t = r_t^T (s + (u * k_t) outer v_t) with its bonus
// term factored into one scalar per step and stream).  The recurrence is
// the reference's own: no cumulative decay products, no chunked form.
// RWKV-6's decay w = exp(-exp(x)) comes arbitrarily close to 0, and a form
// that divides by products of decays overflows there.
//
// Types: r, k and v in float32 or bfloat16 (the model's compute dtype),
// w, u and s0 in float32; y and s_T are float32, as the reference's oracle
// wkv6_scan_ref returns them.  N is 16, 32 or 64; any T >= 1 (T = 1 is a
// decode step and takes the same kernel).
//
// What bounds it.  rwkv6-3b's prefill (B = 4, T = 1024, H = 40, N = 64,
// bf16 r/k/v) moves 152 MB -- r, k, v in bf16, w in and y out in fp32, the
// state in and out -- 0.0454 ms at 3.35 TB/s, and needs 5 N^2 flops a step
// and stream, 0.0501 ms at 67 TFLOP/s of fp32 off the tensor cores: the
// operations bound it, the bytes close behind.  The FFMA pipe itself needs
// three instructions per state cell and step (k v, w s + kv, r s + y):
// about 0.065 ms at the card's clock.  A decode step (T = 1) is one state
// read, one step and one state write: 1.6 us of bytes.
//
// wkv6_split, the kernel the model runs, is built around that:
//
// 1. Columns across blocks.  Column j of s depends only on v_t[j] and the
//    row vectors r_t, k_t and w_t, so the grid is (B * H, N / CJ) with CJ
//    state columns a block: at the prefill shape and CJ = 32, 320 blocks
//    of four warps, where one block a stream gave 160 of two.  The N / CJ
//    blocks of a stream each read its r, k and w rows; the repeat reads
//    come from L2 (50 MB), not device memory.
// 2. Rows across threads.  Each thread keeps a TR x 4 tile of the state in
//    registers (rows TR g.., columns 4 q..; TR = 4).  A step reads its
//    rows' r, k and w and its columns' v as wide shared-memory broadcasts
//    and runs 3 TR 4 FFMA-pipe operations on independent cells, so no
//    thread waits on a long dependent chain; the next step's operands
//    load before this step's are used.  Its partial y for each step goes
//    to shared memory (y_part[t][g][j]); after the chunk's barrier the
//    block sums the row groups, adds c_t v_t[j] and stores y coalesced.
//    No barrier runs inside the step loop.
// 3. An asynchronous copy ring.  r, k, v (the block's CJ columns) and w
//    stream through kRing chunk buffers of C steps in shared memory,
//    filled by cp.async (16 bytes a copy, commit/wait groups): chunk c + 1
//    is in flight while chunk c is computed.  c_t is reduced once a step
//    per block in the chunk's epilogue: the CG threads that finish a step
//    each take N / CG rows and add their parts with shuffles.
// 4. The state comes in and goes out coalesced: lanes run along j, so a
//    row's loads and stores of s0 and s_T are contiguous.
//
// The tiles -- CJ = 32 state columns a block (16 at N = 16), C = 16 steps
// a chunk, TR = 4 state rows a thread -- were chosen by measurement on the
// card against (16, 16, 4), (32, 8, 4) and (32, 16, 8) (PERF.md has the
// figures).  At N = 64 in bf16 a block is 128 threads, 52,352 bytes of
// shared memory (a two-chunk ring of 9,280 bytes a stage, 33,792 of
// y_part), and ptxas gives it 152 registers with no spills: three blocks
// an SM, held by the register file.  What holds the kernel above its
// bound: its step loop issues about 60 instructions a thread for 48
// FFMA-pipe operations, with two or three warps a scheduler, and the
// chunk's epilogue and barriers run in step on every block of an SM rather
// than under other blocks' steps.
//
// wkv6_seq, the kernel this one replaced, stays as the yardstick: one
// block of N threads a stream, thread j walks its whole column for every
// step (a chain of N dependent FMAs), staged synchronously 32 steps at a
// time.  The wrapper launches it only when asked for by name.
//
// The backward (entry wkv6_bwd; kernels wkv6_bwd_cluster and
// wkv6_du_sum).  It replaces no Pallas kernel: the reference trains
// through XLA's autodiff of its chunk-rematerialised scan
// (repro/models/recurrent.py:206, wkv6_scan_chunked, each chunk under
// jax.checkpoint).  With dS the gradient of the state after step t,
// walking back from dS = dsT:
//
//     a_t = v_t . dy_t,   c_t = sum_i r_t[i] u[i] k_t[i]
//     dr_t[i] = sum_j s_{t-1}[i][j] dy_t[j] + u[i] k_t[i] a_t
//     dk_t[i] = sum_j dS[i][j] v_t[j] + u[i] r_t[i] a_t
//     dv_t[j] = sum_i dS[i][j] k_t[i] + c_t dy_t[j]
//     dw_t[i] = sum_j s_{t-1}[i][j] dS[i][j]
//     du[i] = sum over b and t of r_t[i] k_t[i] a_t
//     dS[i][j] <- w_t[i] dS[i][j] + r_t[i] dy_t[j]     (then ds0 = dS)
//
// The states.  dw_t needs s_{t-1} beside dS at every step, walking back.
// Stepping s back by (s_t - k v^T) / w_t would divide by a decay that
// reaches 0 in fp32, so the forward saves the state before every C = 16th
// step (the split kernel's own chunk: it writes its registers at each
// chunk's start, no extra pass), and the backward recomputes each chunk's
// states from that checkpoint with the forward's own arithmetic.  C = 16
// keeps the checkpoints at 168 MB for rwkv6-3b's training shape (B = 4,
// T = 1,024, H = 40, N = 64).
//
// What bounds it.  14 N^2 flops a step and stream (the recompute 3; dr,
// dk, dv and dw 2 each; dS 3): at rwkv6-3b's training shape 9.40e9, 0.140
// ms at 67 TFLOP/s of fp32.  The bytes -- r, k, v in and dr, dk, dv out
// (bf16), w and dy in and dw out (fp32), the checkpoints in -- are 419.5
// MB, 0.125 ms at 3.35 TB/s: the operations bound it.
//
// What held the first design back (wkv6_bwd_block, below; 1.25 ms at
// that shape on an H100 SXM at 700 W, 8.9 times the bound): (1) one
// block of 256 threads owned a stream, 237 registers a thread and 158,080
// bytes of shared memory, one block an SM: 160 blocks ran in two waves
// on 132 SMs, the second of 28 blocks on an idle card; (2) eight warps an
// SM and four block barriers a half-chunk, with the
// one-thread-a-dot-product passes and the epilogue's sums exposed; (3)
// each chunk's operands loaded element by element after a barrier; (4)
// every step every thread stored four float4 partial sums to shared
// memory, read back 16 at a time.
//
// wkv6_bwd_cluster, what the train step runs:
//
// 1. Columns across a thread-block cluster.  Column j of s and of dS
//    needs only v_t[j], dy_t[j] and the row vectors, so the grid is (B *
//    H, N / CJ), CJ = 32 state columns a block, and the N / CJ blocks of
//    a stream are one cluster (cudaLaunchKernelEx with a cluster
//    dimension; a cluster of one at N <= 32).  Sums over i (dv) stay in
//    the block.  Sums over j cross it: rank q ends rows [q CJ, (q + 1)
//    CJ), and every rank sends it its parts of those rows, which it adds
//    in rank order.  a_t and c_t every block computes from whole rows, in
//    one fixed order.  No atomics, no global scratch but du_part: the
//    same bits on every call.
// 2. One wave.  At N = 64 in bf16 a block is 128 threads (four warps),
//    each with a 2 x 8 tile of s and dS and HC = 4 steps of state history
//    in registers (64 of them); __launch_bounds__(128, 3) and 66,456
//    bytes of shared memory give three blocks an SM, so every cluster of
//    rwkv6-3b's training shape (160 of 2 blocks) is resident at once
//    (the registers, blocks an SM and clusters resident that ptxas and the
//    occupancy calls give are in PERF.md).  The history: a chunk is
//    walked in four histories of four steps; the walk forward from the
//    checkpoint leaves the states before histories 1 and 2 in the
//    thread's own shared-memory slots, and each history recomputes three
//    steps: 1.5 recomputed steps a step.  The checkpoints a chunk needs
//    later (history 0's state, the next chunk's start) are copied into
//    slots as they free, by cp.async, so no global load waits in the walk.
//    CJ = 16 (four blocks of two warps a stream) measured slower: its
//    shared memory leaves too few clusters resident for one wave (the
//    reading is in PERF.md).
// 3. Partials by shuffles.  A warp spans the four column groups of eight
//    row pairs: a thread's parts of dr, dk and dw, a [dr, dk, dw, 0] for
//    each of its two rows, are added across its column groups by a
//    halving butterfly of __shfl_xor_sync (each lane keeps two), and its
//    eight of dv across the warp's eight row groups (each lane keeps one).
//    A lane then sends one float2 and stores one float a step, where the
//    first design stored sixteen floats; the warps' dv parts are added in
//    the epilogue.
// 4. An asynchronous ring.  Chunk c - 1's r, k, v, w and dy come in by
//    cp.async (the forward's helpers) while chunk c is walked back.
// 5. The exchange.  A lane sends its float2 to the rank that ends its rows
//    by st.async, which counts the bytes on that rank's mbarrier; the rank
//    expects them as the walk starts and waits on the mbarrier one
//    history later, after the next history's walk.  Three exchange
//    buffers, and a relaxed cluster barrier a history (arrive once a
//    buffer is read, wait one history later), keep a rank from writing
//    parts another has not read.  A release barrier (what makes plain
//    remote stores, or remote loads, safe to read) costs a MEMBAR.GPU a
//    history, which waits on every store in flight; it measured slower.
//    So did an "empty" mbarrier a buffer in every sender, which each
//    warp of the owner arrives on with mbarrier.arrive.release.cluster
//    once it has read the buffer, and the sender waits on with acquire
//    before it fills the buffer again (about a fifth slower at rwkv6-3b's
//    training shape on an H100 SXM at 700 W).
//    The assumption this rests on: the relaxed arrive gives the owner's
//    reads of a buffer no order by the PTX memory model.  They are done
//    before it on the hardware: the arrive comes after put(), whose global
//    stores take the values those reads gave (the "memory" clobbers keep
//    the compiler from moving either across it), and a warp issues in
//    order, so no read is outstanding when the arrive issues; a remote
//    rank writes the buffer again only after its own wait on that
//    arrive, a whole history walk later.  compute-sanitizer's racecheck
//    reports the H100 as not supported; the five-call bitwise tests at
//    the training shape (every cluster resident) are the check kept.
//
// du: each rank adds r_t[i] k_t[i] a_t over t for its rows, in a fixed
// order (by step within a history, then the four in order); a second
// kernel (wkv6_du_sum) adds the B parts of each (h, i) in order of b.
//
// What holds it above its bound: it is latency-bound a block (one stream
// alone on the card takes more than half of the full grid's time; the
// reading is in PERF.md), its step issues about 230 instructions a
// thread for 96 of the walk's FFMA-pipe operations and 48 of the
// recompute's, and 320 equal blocks on 132 SMs leave the SMs that hold
// three blocks to set the time.
//
// wkv6_bwd_block, the kernel this one replaced, stays as the yardstick:
// one block of (N/4)^2 threads a stream owns its whole state, a 4 x 4
// tile a thread with HC = 8 steps of history in registers, partial sums
// through shared memory.  The wrapper launches it only when asked for by
// name (entry wkv6_bwd_yardstick).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// wkv6_seq: the sequential kernel (one block of N threads a stream)

constexpr int kSeqChunk = 32;   // steps staged in shared memory at a time

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_seq(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ s0,
         float* __restrict__ y, float* __restrict__ sT, int T_len, int H) {
  __shared__ float r_s[kSeqChunk][N], k_s[kSeqChunk][N], v_s[kSeqChunk][N],
      w_s[kSeqChunk][N];
  __shared__ float u_s[N];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;

  float s[N];   // column j of the state: s[i] = state[i][j]
  const float* s_in = s0 + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s_in[i * N + j];
  u_s[j] = u[h * N + j];

  for (int t0 = 0; t0 < T_len; t0 += kSeqChunk) {
    const int n = min(kSeqChunk, T_len - t0);
    __syncthreads();   // the last chunk's reads are done (u_s written)
    for (int c = 0; c < n; ++c) {
      const size_t off = (((size_t)b * T_len + t0 + c) * H + h) * N + j;
      r_s[c][j] = to_f32(r[off]);
      k_s[c][j] = to_f32(k[off]);
      v_s[c][j] = to_f32(v[off]);
      w_s[c][j] = w[off];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = v_s[c][j];
      float yj = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float kv = k_s[c][i] * vj;
        yj = fmaf(r_s[c][i], fmaf(u_s[i], kv, s[i]), yj);
        s[i] = fmaf(w_s[c][i], s[i], kv);
      }
      y[(((size_t)b * T_len + t0 + c) * H + h) * N + j] = yj;
    }
  }

  float* s_out = sT + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) s_out[i * N + j] = s[i];
}

// ---------------------------------------------------------------------------
// wkv6_split: columns across blocks, rows across threads, a cp.async ring

constexpr int kRing = 2;    // chunk buffers in the ring
constexpr int kCols = 4;    // state columns a thread (one float4 of y)
constexpr int kChunk = 16;  // steps a chunk (C)
constexpr int kRows = 4;    // state rows a thread (TR)

// 4 consecutive values from shared memory, widened to float
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}
// K (4 or 8) consecutive values, in as few wide loads as the type allows
template <int K>
__device__ __forceinline__ void ldk(const float* p, float (&o)[K]) {
#pragma unroll
  for (int m = 0; m < K; m += 4) {
    const float4 x = ld4(p + m);
    o[m] = x.x; o[m + 1] = x.y; o[m + 2] = x.z; o[m + 3] = x.w;
  }
}
template <int K>
__device__ __forceinline__ void ldk(const __nv_bfloat16* p, float (&o)[K]) {
  if constexpr (K == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      o[2 * m] = __uint_as_float(w[m] << 16);
      o[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
    }
  } else {
    const float4 x = ld4(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// The split kernel's layout at head size N: CJ = min(N, 32) state columns
// a block, chunks of C steps, TR state rows a thread.
template <typename T, int N>
struct Split {
  static constexpr int kN = N, kCJ = N < 32 ? N : 32;
  static constexpr int CJ = kCJ, C = kChunk, TR = kRows;
  static constexpr int RG = N / TR;        // row groups
  static constexpr int CG = CJ / kCols;    // column groups
  static constexpr int NT = RG * CG;       // threads a block
  static constexpr int ES = (int)sizeof(T);
  // one ring stage: r[C][N], k[C][N] (T), w[C][N] (float), v[C + 1][CJ]
  // (T).  v's spare row keeps the step loop's read one row past a full
  // chunk (its operands for a step that does not run) inside the stage:
  // r's and w's such rows fall in k's and v's regions, v's would fall in
  // the next stage, which the ring is filling at that moment.
  static constexpr int R_BYTES = C * N * ES;
  static constexpr int W_BYTES = C * N * 4;
  static constexpr int V_BYTES = (C + 1) * CJ * ES;
  static constexpr int STAGE = 2 * R_BYTES + W_BYTES + V_BYTES;
  // y_part[t][g][j], a step's rows padded by 16 floats so that the
  // epilogue's float4 reads of 8 steps at once spread over all banks
  static constexpr int Y_STEP = RG * CJ + 16;
  static constexpr int SMEM = kRing * STAGE + C * Y_STEP * 4;
  static constexpr int RPL = N / CG;       // rows of c_t an epilogue thread
  static_assert(N % TR == 0 && TR % 4 == 0 && CJ % kCols == 0 &&
                N % CJ == 0, "tiles");
  static_assert(CJ * ES % 16 == 0 && N * ES % 16 == 0, "16-byte copies");
  static_assert(STAGE % 16 == 0 && RPL % 4 == 0 && NT % CG == 0 &&
                CG <= 32, "layout");
};

// Issue the copies of one chunk (n <= C steps from the row offset row0)
// into ring stage st.  Every thread takes a share of the 16-byte pieces.
template <typename S, typename T>
__device__ __forceinline__ void issue_chunk(
    unsigned char* st, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w, size_t row0,
    size_t stride, int n, int j0, int tid) {
  T* rs = reinterpret_cast<T*>(st);
  T* ks = reinterpret_cast<T*>(st + S::R_BYTES);
  float* ws = reinterpret_cast<float*>(st + 2 * S::R_BYTES);
  T* vs = reinterpret_cast<T*>(st + 2 * S::R_BYTES + S::W_BYTES);
  constexpr int N = S::kN, CJ = S::kCJ;
  constexpr int EP = 16 / S::ES;            // elements a piece (r, k, v)
  constexpr int PR = N / EP, PW = N / 4, PV = CJ / EP;
  for (int p = tid; p < n * PR; p += S::NT) {
    const int c = p / PR, q = (p % PR) * EP;
    const size_t g = row0 + c * stride + q;
    cp16(rs + c * N + q, r + g);
    cp16(ks + c * N + q, k + g);
  }
  for (int p = tid; p < n * PW; p += S::NT) {
    const int c = p / PW, q = (p % PW) * 4;
    cp16(ws + c * N + q, w + row0 + c * stride + q);
  }
  for (int p = tid; p < n * PV; p += S::NT) {
    const int c = p / PV, q = (p % PV) * EP;
    cp16(vs + c * CJ + q, v + row0 + c * stride + j0 + q);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(Split<T, N>::NT)
wkv6_split(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ sT,
           float* __restrict__ ckpt, int T_len, int H) {
  using S = Split<T, N>;
  constexpr int CJ = S::CJ, C = S::C, TR = S::TR;
  extern __shared__ __align__(16) unsigned char smem[];
  float* y_part = reinterpret_cast<float*>(smem + kRing * S::STAGE);

  const int tid = threadIdx.x;
  const int g = tid / S::CG, q = tid % S::CG;   // row group, column group
  const int i0 = g * TR, jl = q * kCols;        // tile origin (jl: local)
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * CJ;
  const size_t stride = (size_t)H * N;          // one step, in elements
  const size_t row0 = ((size_t)b * T_len * H + h) * N;
  const int chunks = (T_len + C - 1) / C;
  auto stage = [&](int c) { return smem + (c % kRing) * S::STAGE; };

  // the ring's first kRing - 1 chunks, in flight while the state loads
#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < chunks)
      issue_chunk<S>(stage(c), r, k, v, w, row0 + c * C * stride, stride,
                     min(C, T_len - c * C), j0, tid);
    cp_commit();
  }

  float s[TR][kCols];
  const float* s_in = s0 + (size_t)bh * N * N + (size_t)i0 * N + j0 + jl;
#pragma unroll
  for (int a = 0; a < TR; ++a) ldk<kCols>(s_in + a * N, s[a]);
  // the epilogue's share of c_t: rows [q RPL, (q + 1) RPL); the CG lanes
  // of one step (consecutive, aligned) reduce together
  const unsigned group = (0xffffffffu >> (32 - S::CG))
                         << ((tid % 32) & ~(S::CG - 1));
  float u_l[S::RPL];
#pragma unroll
  for (int e = 0; e < S::RPL; ++e) u_l[e] = u[h * N + q * S::RPL + e];

  for (int ch = 0; ch < chunks; ++ch) {
    const int n = min(C, T_len - ch * C);
    cp_wait<kRing - 2>();   // this thread's copies of chunk ch landed
    __syncthreads();        // (A) everyone's have; chunk ch - 1 is done
    {
      const int nx = ch + kRing - 1;   // refill the stage ch - 1 left
      if (nx < chunks)
        issue_chunk<S>(stage(nx), r, k, v, w, row0 + (size_t)nx * C * stride,
                       stride, min(C, T_len - nx * C), j0, tid);
      cp_commit();
    }
    if (ckpt != nullptr) {   // the state before the chunk's first step
      float* cp = ckpt + ((size_t)bh * chunks + ch) * N * N +
                  (size_t)i0 * N + j0 + jl;
#pragma unroll
      for (int a = 0; a < TR; ++a)
        *reinterpret_cast<float4*>(cp + a * N) =
            make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    }
    const unsigned char* st = stage(ch);
    const T* rs = reinterpret_cast<const T*>(st);
    const T* ks = reinterpret_cast<const T*>(st + S::R_BYTES);
    const float* ws = reinterpret_cast<const float*>(st + 2 * S::R_BYTES);
    const T* vs =
        reinterpret_cast<const T*>(st + 2 * S::R_BYTES + S::W_BYTES);

    // the steps: this thread's TR x 4 cells, no barrier.  The next step's
    // operands load before this step's partials are stored, so the
    // shared-memory loads never wait behind a store.  (Step n's loads read
    // the row past the chunk's, inside this stage, and go unused.)
    float ra[TR], ka[TR], wa[TR], va[kCols];
    ldk<TR>(rs + i0, ra);
    ldk<TR>(ks + i0, ka);
    ldk<TR>(ws + i0, wa);
    ldk<kCols>(vs + jl, va);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float rn[TR], kn[TR], wn[TR], vn[kCols];
      ldk<TR>(rs + (t + 1) * N + i0, rn);
      ldk<TR>(ks + (t + 1) * N + i0, kn);
      ldk<TR>(ws + (t + 1) * N + i0, wn);
      ldk<kCols>(vs + (t + 1) * CJ + jl, vn);
      float yp[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int bb = 0; bb < kCols; ++bb) {
          yp[bb] = fmaf(ra[a], s[a][bb], yp[bb]);
          s[a][bb] = fmaf(wa[a], s[a][bb], ka[a] * va[bb]);
        }
      *reinterpret_cast<float4*>(y_part + t * S::Y_STEP + g * CJ + jl) =
          make_float4(yp[0], yp[1], yp[2], yp[3]);
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        ra[a] = rn[a]; ka[a] = kn[a]; wa[a] = wn[a];
      }
#pragma unroll
      for (int bb = 0; bb < kCols; ++bb) va[bb] = vn[bb];
    }
    __syncthreads();   // (B) every row group's partials are in y_part

    // y_t[j0 + j] = sum over row groups + c_t v_t[j], 4 columns a thread.
    // The CG threads of a step each take N / CG rows of c_t = sum_i r_t[i]
    // u[i] k_t[i] and add their parts with shuffles.
    for (int p = tid; p < n * S::CG; p += S::NT) {
      const int t = p / S::CG, jq = (p % S::CG) * kCols;
      const T* rt = rs + t * N + q * S::RPL;
      const T* kt = ks + t * N + q * S::RPL;
      float ct = 0.f;
#pragma unroll
      for (int e = 0; e < S::RPL; e += 4) {
        const float4 rr = ld4(rt + e), kk = ld4(kt + e);
        ct = fmaf(rr.x * u_l[e], kk.x, ct);
        ct = fmaf(rr.y * u_l[e + 1], kk.y, ct);
        ct = fmaf(rr.z * u_l[e + 2], kk.z, ct);
        ct = fmaf(rr.w * u_l[e + 3], kk.w, ct);
      }
#pragma unroll
      for (int o = S::CG / 2; o > 0; o >>= 1)
        ct += __shfl_xor_sync(group, ct, o, S::CG);
      const float4 vv = ld4(vs + t * CJ + jq);
      float4 acc = make_float4(ct * vv.x, ct * vv.y, ct * vv.z, ct * vv.w);
      const float* yp = y_part + t * S::Y_STEP + jq;
#pragma unroll
      for (int gg = 0; gg < S::RG; ++gg) {
        const float4 x = ld4(yp + gg * CJ);
        acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
      }
      *reinterpret_cast<float4*>(
          y + row0 + (size_t)(ch * C + t) * stride + j0 + jq) = acc;
    }
  }
  cp_wait<0>();

  float* s_out = sT + (size_t)bh * N * N + (size_t)i0 * N + j0 + jl;
#pragma unroll
  for (int a = 0; a < TR; ++a)
    *reinterpret_cast<float4*>(s_out + a * N) =
        make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
}

// ---------------------------------------------------------------------------
// wkv6_bwd_block: the backward's first design, one block a stream (the
// yardstick)

__device__ __forceinline__ void from_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

constexpr int kHist = 8;   // steps of state history a thread keeps (HC)
static_assert(kChunk % kHist == 0, "a checkpoint chunk is whole histories");

// The backward's layout at head size N: the block holds the whole N x N
// state of one stream, a TR x TC tile a thread (rows 4 g.., columns 4 q..),
// so every sum over i or j stays inside the block.  Shared memory, in
// floats: the chunk's operands as float (r, k, w, v, dy: C x N each), a_t
// and c_t (C each), u (N), then one history's partial sums: over the
// thread's columns for dr, dk and dw (rowp[HC][3][CG][N + 4]; the pad
// spreads the float4 stores of the CG column groups over all banks) and
// over its rows for dv (colp[HC][RG][N]).
template <int N>
struct Bwd {
  static constexpr int TR = 4, TC = 4, C = kChunk, HC = kHist;
  static constexpr int RG = N / TR, CG = N / TC, NT = RG * CG;
  static constexpr int PR = N + 4;
  static constexpr int OPS = 5 * C * N, AC = 2 * C;
  static constexpr int ROWP = HC * 3 * CG * PR, COLP = HC * RG * N;
  static constexpr int SMEM = (OPS + AC + N + ROWP + COLP) * 4;
  static_assert((OPS + AC + N) % 4 == 0 && PR % 4 == 0 && ROWP % 4 == 0,
                "16-byte aligned partials");
};

template <typename T, int N>
__global__ void __launch_bounds__(Bwd<N>::NT)
wkv6_bwd_block(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dy,
                const float* __restrict__ dsT,
                const float* __restrict__ ckpt, T* __restrict__ dr,
                T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, int T_len, int H) {
  using S = Bwd<N>;
  constexpr int TR = S::TR, TC = S::TC, C = S::C, HC = S::HC;
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm;
  float* k_s = r_s + C * N;
  float* w_s = k_s + C * N;
  float* v_s = w_s + C * N;
  float* dy_s = v_s + C * N;
  float* a_s = dy_s + C * N;    // a_t = v_t . dy_t
  float* c_s = a_s + C;         // c_t = sum_i r_t[i] u[i] k_t[i]
  float* u_s = c_s + C;
  float* rowp = u_s + N;
  float* colp = rowp + S::ROWP;

  const int tid = threadIdx.x;
  const int g = tid / S::CG, q = tid % S::CG;   // row group, column group
  const int i0 = g * TR, j0 = q * TC;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t stride = (size_t)H * N;
  const size_t row0 = ((size_t)b * T_len * H + h) * N;
  const int chunks = (T_len + C - 1) / C;
  for (int i = tid; i < N; i += S::NT) u_s[i] = u[h * N + i];

  // dS = dL/ds_t, walking back from t = T
  float dS[TR][TC];
  if (dsT != nullptr) {
    const float* src = dsT + (size_t)bh * N * N + (size_t)i0 * N + j0;
#pragma unroll
    for (int a = 0; a < TR; ++a) ldk<TC>(src + a * N, dS[a]);
  } else {
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int bb = 0; bb < TC; ++bb) dS[a][bb] = 0.f;
  }
  float du_acc = 0.f;

  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int n = min(C, T_len - ch * C);
    const size_t base = row0 + (size_t)ch * C * stride;
    __syncthreads();   // the last chunk's epilogue is done with the operands
    for (int p = tid; p < n * N; p += S::NT) {
      const int t = p / N, i = p % N;
      const size_t off = base + t * stride + i;
      r_s[p] = to_f32(r[off]);
      k_s[p] = to_f32(k[off]);
      w_s[p] = w[off];
      v_s[p] = to_f32(v[off]);
      dy_s[p] = dy[off];
    }
    __syncthreads();
    // a_t and c_t, one dot product a thread in a fixed order (read in the
    // epilogue, after the walk's barrier)
    for (int p = tid; p < 2 * n; p += S::NT) {
      const int t = p >> 1;
      float acc = 0.f;
      if (p & 1) {
        for (int i = 0; i < N; ++i)
          acc = fmaf(r_s[t * N + i] * u_s[i], k_s[t * N + i], acc);
        c_s[t] = acc;
      } else {
        for (int j = 0; j < N; ++j)
          acc = fmaf(v_s[t * N + j], dy_s[t * N + j], acc);
        a_s[t] = acc;
      }
    }
    const float* cp = ckpt + ((size_t)bh * chunks + ch) * N * N +
                      (size_t)i0 * N + j0;

    // the chunk's histories from the last to the first
    for (int sub = (n - 1) / HC; sub >= 0; --sub) {
      const int t_lo = sub * HC;
      float s[TR][TC];
#pragma unroll
      for (int a = 0; a < TR; ++a) ldk<TC>(cp + a * N, s[a]);
      // recompute from the checkpoint up to the history's first step
      for (int t = 0; t < t_lo; ++t) {
        float kk[TR], ww[TR], vv[TC];
        ldk<TR>(k_s + t * N + i0, kk);
        ldk<TR>(w_s + t * N + i0, ww);
        ldk<TC>(v_s + t * N + j0, vv);
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int bb = 0; bb < TC; ++bb)
            s[a][bb] = fmaf(ww[a], s[a][bb], kk[a] * vv[bb]);
      }
      // hist[tt] = s_{t-1} of step t_lo + tt, in registers
      float hist[HC][TR][TC];
#pragma unroll
      for (int tt = 0; tt < HC; ++tt) {
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int bb = 0; bb < TC; ++bb) hist[tt][a][bb] = s[a][bb];
        const int t = t_lo + tt;
        if (tt + 1 < HC && t < n) {
          float kk[TR], ww[TR], vv[TC];
          ldk<TR>(k_s + t * N + i0, kk);
          ldk<TR>(w_s + t * N + i0, ww);
          ldk<TC>(v_s + t * N + j0, vv);
#pragma unroll
          for (int a = 0; a < TR; ++a)
#pragma unroll
            for (int bb = 0; bb < TC; ++bb)
              s[a][bb] = fmaf(ww[a], s[a][bb], kk[a] * vv[bb]);
        }
      }
      // walk the history back: this thread's partial sums of dr, dk, dw
      // (over its columns) and dv (over its rows), then dS_{t-1}
#pragma unroll
      for (int tt = HC - 1; tt >= 0; --tt) {
        const int t = t_lo + tt;
        if (t < n) {
          float rr[TR], kk[TR], ww[TR], vv[TC], gy[TC];
          ldk<TR>(r_s + t * N + i0, rr);
          ldk<TR>(k_s + t * N + i0, kk);
          ldk<TR>(w_s + t * N + i0, ww);
          ldk<TC>(v_s + t * N + j0, vv);
          ldk<TC>(dy_s + t * N + j0, gy);
          float pr[TR], pk[TR], pw[TR], pv[TC];
#pragma unroll
          for (int a = 0; a < TR; ++a) pr[a] = pk[a] = pw[a] = 0.f;
#pragma unroll
          for (int bb = 0; bb < TC; ++bb) pv[bb] = 0.f;
#pragma unroll
          for (int a = 0; a < TR; ++a)
#pragma unroll
            for (int bb = 0; bb < TC; ++bb) {
              const float sp = hist[tt][a][bb], d = dS[a][bb];
              pr[a] = fmaf(sp, gy[bb], pr[a]);
              pw[a] = fmaf(sp, d, pw[a]);
              pk[a] = fmaf(d, vv[bb], pk[a]);
              pv[bb] = fmaf(d, kk[a], pv[bb]);
              dS[a][bb] = fmaf(ww[a], d, rr[a] * gy[bb]);
            }
          float* rp = rowp + (tt * 3 * S::CG + q) * S::PR + i0;
          *reinterpret_cast<float4*>(rp) =
              make_float4(pr[0], pr[1], pr[2], pr[3]);
          *reinterpret_cast<float4*>(rp + S::CG * S::PR) =
              make_float4(pk[0], pk[1], pk[2], pk[3]);
          *reinterpret_cast<float4*>(rp + 2 * S::CG * S::PR) =
              make_float4(pw[0], pw[1], pw[2], pw[3]);
          *reinterpret_cast<float4*>(colp + (tt * S::RG + g) * N + j0) =
              make_float4(pv[0], pv[1], pv[2], pv[3]);
        }
      }
      __syncthreads();   // every tile's partial sums are in place

      // the history's gradients: the partial sums added in a fixed order,
      // the bonus terms, rounded once to the output's type
      const int m = min(HC, n - t_lo);
      for (int p = tid; p < m * 4 * N; p += S::NT) {
        const int tt = p / (4 * N), qty = (p / N) % 4, i = p % N;
        const int t = t_lo + tt;
        const size_t off = base + t * stride + i;
        float acc = 0.f;
        if (qty < 3) {
          const float* pp = rowp + (tt * 3 + qty) * S::CG * S::PR + i;
#pragma unroll
          for (int c = 0; c < S::CG; ++c) acc += pp[c * S::PR];
        } else {
          const float* pp = colp + tt * S::RG * N + i;
#pragma unroll
          for (int c = 0; c < S::RG; ++c) acc += pp[c * N];
        }
        if (qty == 0) {
          acc = fmaf(u_s[i] * k_s[t * N + i], a_s[t], acc);
          from_f32(acc, dr + off);
        } else if (qty == 1) {
          acc = fmaf(u_s[i] * r_s[t * N + i], a_s[t], acc);
          from_f32(acc, dk + off);
        } else if (qty == 2) {
          dw[off] = acc;
        } else {
          acc = fmaf(c_s[t], dy_s[t * N + i], acc);
          from_f32(acc, dv + off);
        }
      }
      // du[i] += r_t[i] k_t[i] a_t, from the last step to the first
      if (tid < N)
        for (int tt = m - 1; tt >= 0; --tt) {
          const int t = t_lo + tt;
          du_acc = fmaf(r_s[t * N + tid] * k_s[t * N + tid], a_s[t], du_acc);
        }
      __syncthreads();   // the partial sums are read before the next walk
    }
  }

  if (ds0 != nullptr) {
    float* dst = ds0 + (size_t)bh * N * N + (size_t)i0 * N + j0;
#pragma unroll
    for (int a = 0; a < TR; ++a)
      *reinterpret_cast<float4*>(dst + a * N) =
          make_float4(dS[a][0], dS[a][1], dS[a][2], dS[a][3]);
  }
  if (tid < N) du_part[(size_t)bh * N + tid] = du_acc;
}

// du = the B streams' parts of each (h, i), added in order of b
__global__ void wkv6_du_sum(const float* __restrict__ part,
                            float* __restrict__ du, int B, int HN) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HN) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[(size_t)b * HN + x];
  du[x] = acc;
}

// ---------------------------------------------------------------------------
// wkv6_bwd_cluster: the backward, a stream's columns across a cluster

// K (2, 4 or 8) consecutive values, in as few loads as the type allows
template <int K>
__device__ __forceinline__ void ldn(const float* p, float (&o)[K]) {
  if constexpr (K == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
    ldk<K>(p, o);
  }
}
template <int K>
__device__ __forceinline__ void ldn(const __nv_bfloat16* p, float (&o)[K]) {
  if constexpr (K == 2) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    o[0] = __uint_as_float(raw << 16);
    o[1] = __uint_as_float(raw & 0xffff0000u);
  } else {
    ldk<K>(p, o);
  }
}

// A sum of x[0, LEN) over the lanes that differ in the lane bits O, 2 O,
// ..., END / 2.  While the live values split evenly a level halves them
// (the lane with the level's bit set keeps the upper half, its partner the
// lower, each adding what the other sends: one shuffle a value kept);
// after that a level adds all of them.  Leaves kept<LEN, O, END>() sums in
// x[0, ..), the first of them x's index lane_base<LEN, O, END>(lane);
// lanes that differ only in plain_bits<LEN, O, END>() hold the same sums.
// A fixed tree: the same bits on every call.
template <int LEN, int O, int END>
constexpr int kept() {
  if constexpr (O >= END) return LEN;
  else if constexpr (LEN % 2 == 0) return kept<LEN / 2, 2 * O, END>();
  else return LEN;
}
template <int LEN, int O, int END>
constexpr int plain_bits() {
  if constexpr (O >= END) return 0;
  else if constexpr (LEN % 2 == 0) return plain_bits<LEN / 2, 2 * O, END>();
  else return O | plain_bits<LEN, 2 * O, END>();
}
template <int LEN, int O, int END>
__device__ __forceinline__ int lane_base(int lane) {
  if constexpr (O >= END) {
    return 0;
  } else if constexpr (LEN % 2 == 0) {
    return ((lane & O) ? LEN / 2 : 0) + lane_base<LEN / 2, 2 * O, END>(lane);
  } else {
    return lane_base<LEN, 2 * O, END>(lane);
  }
}
template <int LEN, int O, int END, int V>
__device__ __forceinline__ void lane_sum(float (&x)[V], unsigned mask,
                                         int lane) {
  if constexpr (O < END) {
    if constexpr (LEN % 2 == 0) {
      constexpr int H = LEN / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int m = 0; m < H; ++m) {
        const float send = up ? x[m] : x[m + H];
        const float keep = up ? x[m + H] : x[m];
        x[m] = keep + __shfl_xor_sync(mask, send, O);
      }
      lane_sum<H, 2 * O, END>(x, mask, lane);
    } else {
#pragma unroll
      for (int m = 0; m < LEN; ++m) x[m] += __shfl_xor_sync(mask, x[m], O);
      lane_sum<LEN, 2 * O, END>(x, mask, lane);
    }
  }
}

// p's place in the shared memory of the cluster's block ``rank`` (a 32-bit
// shared::cluster address)
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(a), "r"(rank));
  return out;
}
// K (2 or 4) floats stored at a cluster address, their bytes counted as
// a transaction on the mbarrier at mbar (in the same block) when they land
template <int K>
__device__ __forceinline__ void st_async(uint32_t addr, const float* x,
                                         uint32_t mbar) {
  if constexpr (K == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32"
        " [%0], {%1, %2}, [%3];\n" ::"r"(addr),
        "r"(__float_as_uint(x[0])), "r"(__float_as_uint(x[1])), "r"(mbar));
  } else {
    static_assert(K == 4, "2 or 4 floats");
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
        " [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
        "r"(__float_as_uint(x[0])), "r"(__float_as_uint(x[1])),
        "r"(__float_as_uint(x[2])), "r"(__float_as_uint(x[3])), "r"(mbar));
  }
}
// the mbarriers of the exchange: set up, expect bytes (one arrival), wait
// for a phase to complete
__device__ __forceinline__ void mbar_init(uint64_t* m, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(m)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* m, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"((uint32_t)__cvta_generic_to_shared(m)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* m, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"((uint32_t)__cvta_generic_to_shared(m)),
      "r"(parity)
      : "memory");
}
// the cluster barrier without memory order (what it orders is said where
// it is used)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The cluster kernel's layout at head size N: CJ state columns a block and
// NB = N / CJ blocks a stream (the cluster); a TR x TC tile a thread (rows
// TR g.., columns TC q..; lanes run along q, then g), so a warp spans the
// CG column groups of WL / CG row groups.  Shared memory: a two-stage ring
// of the chunk's operands (r, k, v [C][N] in T, w, dy [C][N] float), then
// in floats: each thread's state slots (the states before a chunk's
// histories 1 and 2, float4 by thread, which also take checkpoints copied
// ahead of their use), the exchange (every rank's parts of dr, dk, dw of
// the rows this block ends, a float4 [dr, dk, dw, 0] a row,
// xin[NBUF][HC][NB][CJ][4], written by the cluster), each warp's dv parts (dvp[NBUF][NW][HC][CJ]), c_t, a_t, u,
// du's parts by history step, the chunk's v columns as float (bf16 only),
// then the exchange's NBUF mbarriers.
template <typename T, int N>
struct Clu {
  static constexpr int kN = N;
  static constexpr int CJ = N < 32 ? N : 32;
  static constexpr int kCJ = CJ, NB = N / CJ;
  static constexpr int TR = 2, TC = 8, C = kChunk, HC = 4, NQ = C / HC;
  static constexpr int RG = N / TR, CG = CJ / TC, NT = RG * CG;
  static constexpr int WL = NT < 32 ? NT : 32, NW = NT / WL;
  static constexpr int MINB = NT >= 64 ? 384 / NT : 1;
  static constexpr int ES = (int)sizeof(T);
  static constexpr int R_BYTES = C * N * ES, F_BYTES = C * N * 4;
  // r, k, v in T; w, dy in float
  static constexpr int STAGE = 3 * R_BYTES + 2 * F_BYTES;
  static constexpr int CELLS = TR * TC;
  static constexpr int SLOTS = 2 * CELLS * NT;
  static constexpr int NBUF = 3;   // exchange buffers (see the loop)
  static constexpr int XCH = NBUF * HC * N * 4;
  static constexpr int DVP = NBUF * NW * HC * CJ, ITEMS = HC * CJ;
  static constexpr int IPT = (ITEMS + NT - 1) / NT;   // items a thread
  static constexpr int VF = ES == 4 ? 0 : C * CJ;
  static constexpr int FLOATS =
      SLOTS + XCH + DVP + 2 * C + N + ITEMS + VF;
  static constexpr int SMEM = 2 * STAGE + 4 * FLOATS + 8 * NBUF;
  // a step's partial sums, reduced after its products: dr, dk, dw of the
  // thread's rows, a [dr, dk, dw, 0] each (4 TR), over the CG column lanes
  // (each lane keeps RM of them, one store), dv (TC) over the warp's
  // row-group lanes
  static constexpr int PR = 4 * TR, PV = TC;
  static constexpr int RM = kept<PR, 1, CG>();
  static constexpr int VM = kept<PV, CG, WL>();
  // the bytes of parts a block receives for a history step: every rank's
  // float4 of each of its CJ rows
  static constexpr int STEP_BYTES = NB * CJ * 16;
  // the a_t and c_t pass: four threads a step, N / 4 terms each
  static constexpr int CR = N / 4;
  static_assert(N % CJ == 0 && CJ % TC == 0 && N % TR == 0 && TC == 8 &&
                TR == 2 && CELLS == 16 && NQ == 4, "tiles");
  static_assert((RM == 2 || RM == 4) && plain_bits<PR, 1, CG>() == 0 &&
                NT % WL == 0 && (WL & (WL - 1)) == 0 &&
                (CG & (CG - 1)) == 0 && CR % 4 == 0 &&
                ((4 * C) % NT == 0 || (NT > 4 * C && (4 * C) % 32 == 0)),
                "layout");
  static_assert(STAGE % 16 == 0 && CJ * ES % 16 == 0 && N * ES % 16 == 0 &&
                FLOATS % 2 == 0, "16-byte copies, 8-byte mbarriers");
};

// The copies of one chunk (n <= C steps from the row offset row0) into a
// ring stage: every row of r, k, v, w and dy.
template <typename S, typename T>
__device__ __forceinline__ void issue_bwd_chunk(
    unsigned char* st, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ dy, size_t row0, size_t stride, int n,
    int tid) {
  constexpr int N = S::kN;
  T* rs = reinterpret_cast<T*>(st);
  T* ks = reinterpret_cast<T*>(st + S::R_BYTES);
  T* vs = reinterpret_cast<T*>(st + 2 * S::R_BYTES);
  float* ws = reinterpret_cast<float*>(st + 3 * S::R_BYTES);
  float* ds = reinterpret_cast<float*>(st + 3 * S::R_BYTES + S::F_BYTES);
  constexpr int EP = 16 / S::ES;            // elements a piece (r, k, v)
  constexpr int PR = N / EP, PF = N / 4;
  for (int p = tid; p < n * PR; p += S::NT) {
    const int c = p / PR, q = (p % PR) * EP;
    const size_t g = row0 + c * stride + q;
    cp16(rs + c * N + q, r + g);
    cp16(ks + c * N + q, k + g);
    cp16(vs + c * N + q, v + g);
  }
  for (int p = tid; p < n * PF; p += S::NT) {
    const int c = p / PF, q = (p % PF) * 4;
    const size_t g = row0 + c * stride + q;
    cp16(ws + c * N + q, w + g);
    cp16(ds + c * N + q, dy + g);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(Clu<T, N>::NT, Clu<T, N>::MINB)
wkv6_bwd_cluster(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ dy,
                 const float* __restrict__ dsT,
                 const float* __restrict__ ckpt, T* __restrict__ dr,
                 T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ dw, float* __restrict__ du_part,
                 float* __restrict__ ds0, int T_len, int H) {
  using S = Clu<T, N>;
  constexpr int TR = S::TR, TC = S::TC, C = S::C, HC = S::HC, CJ = S::CJ;
  constexpr int NB = S::NB, NT = S::NT, NW = S::NW, NBUF = S::NBUF;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* slots = reinterpret_cast<float4*>(smem + 2 * S::STAGE);
  float* xin = reinterpret_cast<float*>(slots) + S::SLOTS;
  float* dvp = xin + S::XCH;
  float* c_s = dvp + S::DVP;
  float* a_s = c_s + C;
  float* u_s = a_s + C;
  float* dus = u_s + N;
  float* vf = dus + S::ITEMS;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + 2 * S::STAGE + 4 * S::FLOATS);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / S::CG, q = tid % S::CG;   // row group, column group
  const int i0 = g * TR, jl = q * TC;           // tile origin (jl: local)
  const int j0 = rank * CJ;   // the block's columns, and the rows it ends
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t stride = (size_t)H * N;
  const size_t row0 = ((size_t)b * T_len * H + h) * N;
  const int chunks = (T_len + C - 1) / C;
  const unsigned mask = NT >= 32 ? 0xffffffffu : (1u << (NT & 31)) - 1u;
  auto stage = [&](int c) { return smem + (c & 1) * S::STAGE; };
  // this thread's tile of the checkpoint before chunk c
  const float* ck = ckpt + (size_t)bh * chunks * N * N + (size_t)i0 * N +
                    j0 + jl;
  auto load_ckpt = [&](float (&x)[TR][TC], int c) {
#pragma unroll
    for (int a = 0; a < TR; ++a) ldk<TC>(ck + (size_t)c * N * N + a * N, x[a]);
  };
  // where this thread's sums of dr, dk, dw go: the exchange of the rank
  // that ends its rows (a 32-bit cluster address in buffer 0, step 0),
  // with that rank's mbarriers
  uint32_t xdst, xbar;
  {
    const int rb = lane_base<S::PR, 1, S::CG>(lane), owner = i0 / CJ;
    // row i0 + rb / 4, quantities rb % 4 ..
    xdst = cluster_addr(xin, owner) +
           4u * ((rank * CJ + i0 % CJ + rb / 4) * 4 + rb % 4);
    xbar = cluster_addr(full, owner);
  }
  // and those of dv: its warp's row of dvp
  float* vdst = dvp + warp * HC * CJ + jl +
                lane_base<S::PV, S::CG, S::WL>(lane);

  for (int i = tid; i < N; i += NT) u_s[i] = u[h * N + i];
  if (tid == 0) {
#pragma unroll
    for (int x = 0; x < NBUF; ++x) mbar_init(full + x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float dS[TR][TC];   // dL/ds_t, walking back from t = T
  if (dsT != nullptr) {
    const float* src = dsT + (size_t)bh * N * N + (size_t)i0 * N + j0 + jl;
#pragma unroll
    for (int a = 0; a < TR; ++a) ldk<TC>(src + a * N, dS[a]);
  } else {
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int bb = 0; bb < TC; ++bb) dS[a][bb] = 0.f;
  }
  {
    const int c = chunks - 1;
    issue_bwd_chunk<S>(stage(c), r, k, v, w, dy, row0 + (size_t)c * C * stride,
                       stride, T_len - c * C, tid);
    cp_commit();
  }
  float du_acc[S::IPT];
#pragma unroll
  for (int e = 0; e < S::IPT; ++e) du_acc[e] = 0.f;
  cluster.sync();   // every block of the cluster runs, its mbarriers set
  float hist[HC][TR][TC];   // hist[tt] = s_{t-1} of the history's step tt
  int hk = 0;               // histories walked: buffer hk % NBUF
  bool arrived = false;     // a cluster arrive is waiting for its wait
  // this thread's state slots 1 and 2 (its own: no barrier guards them);
  // its checkpoint tile of chunk c copied into slot sq by cp.async
  auto slot = [&](int sq, int e) -> float4& {
    return slots[((sq - 1) * 4 + e) * NT + tid];
  };
  auto read_slot = [&](float (&x)[TR][TC], int sq) {
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const float4 lo = slot(sq, 2 * a), hi = slot(sq, 2 * a + 1);
      x[a][0] = lo.x; x[a][1] = lo.y; x[a][2] = lo.z; x[a][3] = lo.w;
      x[a][4] = hi.x; x[a][5] = hi.y; x[a][6] = hi.z; x[a][7] = hi.w;
    }
  };
  auto fetch_ckpt = [&](int sq, int c) {
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        cp16(&slot(sq, 2 * a + e), ck + (size_t)c * N * N + a * N + 4 * e);
    cp_commit();
  };
  // s: the state before the chunk's first step, from its checkpoint; a
  // full chunk fetches the next one's into slot 1 ahead of time
  float s[TR][TC];
  load_ckpt(s, chunks - 1);
  bool fetched = false;

  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int n = min(C, T_len - ch * C);
    const size_t base = row0 + (size_t)ch * C * stride;
    const bool full_chunk = n == C;
    cp_wait<0>();      // this thread's copies of chunk ch landed
    if (fetched) read_slot(s, 1);
    __syncthreads();   // everyone's have; chunk ch + 1's stage is free
    if (ch > 0) {
      issue_bwd_chunk<S>(stage(ch - 1), r, k, v, w, dy, base - C * stride,
                         stride, C, tid);
      cp_commit();
    }
    const unsigned char* st = stage(ch);
    const T* rs = reinterpret_cast<const T*>(st);
    const T* ks = reinterpret_cast<const T*>(st + S::R_BYTES);
    const T* vr = reinterpret_cast<const T*>(st + 2 * S::R_BYTES);
    const float* ws = reinterpret_cast<const float*>(st + 3 * S::R_BYTES);
    const float* yr = reinterpret_cast<const float*>(
        st + 3 * S::R_BYTES + S::F_BYTES);
    const float* ys = yr + j0;   // dy of the block's columns, stride N
    // v of the block's columns as float, stride CJ: bf16 widened once a
    // chunk here, not at every use
    const float* vs;
    int vstride;
    if constexpr (S::VF > 0) {
      for (int p = tid; p < n * CJ; p += NT)
        vf[p] = to_f32(vr[(p / CJ) * N + j0 + p % CJ]);
      vs = vf;
      vstride = CJ;
    } else {
      vs = reinterpret_cast<const float*>(vr) + j0;
      vstride = N;
    }
    // c_t and a_t, four threads a step each taking a quarter of the terms
    // in a fixed order, added by two shuffles (every rank the same bits);
    // a thread starts its quarter at its step's offset, so that the
    // threads' reads spread over the banks
    for (int p = tid; p < 4 * C; p += NT) {
      const int t = p >> 2, qq = p & 3;
      float c_acc = 0.f, a_acc = 0.f;
      if (t < n) {
#pragma unroll 4
        for (int e = 0; e < S::CR; ++e) {
          const int i = qq * S::CR + ((e + 2 * t) & (S::CR - 1));
          c_acc = fmaf(to_f32(rs[t * N + i]) * u_s[i], to_f32(ks[t * N + i]),
                       c_acc);
          a_acc = fmaf(to_f32(vr[t * N + i]), yr[t * N + i], a_acc);
        }
      }
      c_acc += __shfl_xor_sync(mask, c_acc, 1);
      a_acc += __shfl_xor_sync(mask, a_acc, 1);
      c_acc += __shfl_xor_sync(mask, c_acc, 2);
      a_acc += __shfl_xor_sync(mask, a_acc, 2);
      if (qq == 0 && t < n) {
        c_s[t] = c_acc;
        a_s[t] = a_acc;
      }
    }
    __syncthreads();   // vf, c_t and a_t are in

    // s <- s after step t (the forward's arithmetic)
    auto advance = [&](float (&x)[TR][TC], int t) {
      float kk[TR], ww[TR], vv[TC];
      ldn<TR>(ks + t * N + i0, kk);
      ldn<TR>(ws + t * N + i0, ww);
      ldn<TC>(vs + t * vstride + jl, vv);
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int bb = 0; bb < TC; ++bb)
          x[a][bb] = fmaf(ww[a], x[a][bb], kk[a] * vv[bb]);
    };
    // the history from step t_lo: hist[tt] = s_{t_lo + tt - 1}, from x
    auto build = [&](float (&x)[TR][TC], int t_lo) {
      if (t_lo + HC <= n) {
#pragma unroll
        for (int tt = 0; tt < HC; ++tt) {
#pragma unroll
          for (int a = 0; a < TR; ++a)
#pragma unroll
            for (int bb = 0; bb < TC; ++bb) hist[tt][a][bb] = x[a][bb];
          if (tt + 1 < HC) advance(x, t_lo + tt);
        }
      } else {   // the chunk's ragged end
#pragma unroll
        for (int tt = 0; tt < HC; ++tt) {
#pragma unroll
          for (int a = 0; a < TR; ++a)
#pragma unroll
            for (int bb = 0; bb < TC; ++bb) hist[tt][a][bb] = x[a][bb];
          if (tt + 1 < HC && t_lo + tt + 1 < n) advance(x, t_lo + tt);
        }
      }
    };

    // forward from the checkpoint: the states before histories 1 and 2 to
    // this thread's slots, the last history's into registers
    const int nq = (n + HC - 1) / HC;
    for (int sq = 0; sq + 1 < nq; ++sq) {
      if (sq > 0) {
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          slot(sq, 2 * a) = make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
          slot(sq, 2 * a + 1) =
              make_float4(s[a][4], s[a][5], s[a][6], s[a][7]);
        }
      }
#pragma unroll
      for (int tt = 0; tt < HC; ++tt) advance(s, sq * HC + tt);
    }
    build(s, (nq - 1) * HC);

    // one walk back over a history: this thread's parts of dr, dk, dw
    // (over its columns) and dv (over its rows) at each step, summed over
    // the lanes and sent for the epilogue (dr, dk, dw to the rank that ends
    // the rows), then dS_{t-1}.  A full history's steps are one straight
    // line, so the compiler overlaps a step's shuffles with the next
    // step's products
    auto walk = [&](int t_lo, bool ragged) {
      const int xb = hk % NBUF;
      const uint32_t xo = 4u * xb * HC * N * 4;
      const uint32_t mb = xbar + 8u * xb;
      float* vp = vdst + xb * NW * HC * CJ;
#pragma unroll
      for (int tt = HC - 1; tt >= 0; --tt) {
        const int t = t_lo + tt;
        if (!ragged || t < n) {
          float rr[TR], kk[TR], ww[TR], vv[TC], gy[TC];
          ldn<TR>(rs + t * N + i0, rr);
          ldn<TR>(ks + t * N + i0, kk);
          ldn<TR>(ws + t * N + i0, ww);
          ldn<TC>(vs + t * vstride + jl, vv);
          ldn<TC>(ys + t * N + jl, gy);
          float pr[S::PR], pv[S::PV];   // pr[a][dr, dk, dw, 0], pv[bb]
#pragma unroll
          for (int m = 0; m < S::PR; ++m) pr[m] = 0.f;
#pragma unroll
          for (int m = 0; m < S::PV; ++m) pv[m] = 0.f;
#pragma unroll
          for (int a = 0; a < TR; ++a)
#pragma unroll
            for (int bb = 0; bb < TC; ++bb) {
              const float sp = hist[tt][a][bb], d = dS[a][bb];
              pr[4 * a] = fmaf(sp, gy[bb], pr[4 * a]);
              pr[4 * a + 1] = fmaf(d, vv[bb], pr[4 * a + 1]);
              pr[4 * a + 2] = fmaf(sp, d, pr[4 * a + 2]);
              pv[bb] = fmaf(d, kk[a], pv[bb]);
              dS[a][bb] = fmaf(ww[a], d, rr[a] * gy[bb]);
            }
          // (lanes that hold the same dv sums store the same bits to the
          // same place in one instruction: no branch in the step)
          lane_sum<S::PR, 1, S::CG>(pr, mask, lane);
          st_async<S::RM>(xdst + xo + 16u * tt * N, pr, mb);
          lane_sum<S::PV, S::CG, S::WL>(pv, mask, lane);
#pragma unroll
          for (int m = 0; m < S::VM; ++m) vp[tt * CJ + m] = pv[m];
        }
      }
    };

    // the history's gradients of this rank's rows [j0, j0 + CJ) from
    // exchange buffer xb: the ranks' parts added in rank order, the bonus
    // terms, rounded once; dv of the block's columns: the warps' parts in
    // order, c_t dy_t.  Summed here, stored by put() before the next
    // cluster arrive
    float g_r[S::IPT], g_k[S::IPT], g_w[S::IPT], g_v[S::IPT];
    size_t g_off[S::IPT];
    bool g_ok[S::IPT];
    auto epilogue = [&](int t_lo, int xb) {
      const int m = min(HC, n - t_lo);
      const float4* xq = reinterpret_cast<const float4*>(xin) + xb * HC * N;
#pragma unroll
      for (int e = 0; e < S::IPT; ++e) {
        const int p = tid + e * NT, tt = p / CJ, il = p % CJ, i = j0 + il;
        const int t = t_lo + tt;
        g_ok[e] = p < S::ITEMS && tt < m;
        if (g_ok[e]) {
          const float a = a_s[t];
          float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int x = 0; x < NB; ++x) {   // rank x's parts
            const float4 part = xq[(tt * NB + x) * CJ + il];
            acc[0] += part.x;
            acc[1] += part.y;
            acc[2] += part.z;
          }
          g_off[e] = (size_t)t * stride;
          const float rt = to_f32(rs[t * N + i]), kt = to_f32(ks[t * N + i]);
          g_r[e] = fmaf(u_s[i] * kt, a, acc[0]);
          g_k[e] = fmaf(u_s[i] * rt, a, acc[1]);
          g_w[e] = acc[2];
          du_acc[e] = fmaf(rt * kt, a, du_acc[e]);
          // dv's item p: step tt, column il of the block's
          float vsum = 0.f;
#pragma unroll
          for (int x = 0; x < NW; ++x)
            vsum += dvp[((xb * NW + x) * HC + tt) * CJ + il];
          g_v[e] = fmaf(c_s[t], ys[t * N + il], vsum);
        }
      }
    };
    auto put = [&]() {
#pragma unroll
      for (int e = 0; e < S::IPT; ++e) {
        if (g_ok[e]) {
          const size_t off = base + g_off[e] + j0 + (tid + e * NT) % CJ;
          from_f32(g_r[e], dr + off);
          from_f32(g_k[e], dk + off);
          dw[off] = g_w[e];
          from_f32(g_v[e], dv + off);
        }
      }
    };
    // history hk's parts: its buffer's mbarrier phase, then the block's
    // barrier for the warps' dv parts
    auto gather = [&](int t_lo, int k_hist) {
      mbar_wait(full + k_hist % NBUF, (k_hist / NBUF) & 1);
      __syncthreads();
      epilogue(t_lo, k_hist % NBUF);
    };

    // the histories, last first.  Each history's parts of dr, dk, dw reach
    // their owner by st.async, which counts their bytes on its mbarrier
    // (the owner expects them as the walk starts); the owner gathers them
    // after the next history's walk.  The cluster barrier (relaxed) orders
    // reuse: a rank arrives once it has read a buffer, and waits one
    // history later, before the walk that fills that buffer again: with
    // three buffers, the walk of history hk fills the buffer read in
    // gather(hk - 3), which every rank arrived after before the wait
    // this rank passed two histories back.  The relaxed arrive does not
    // order the owner's reads of the buffer by the PTX memory model; that
    // they are done rests on the hardware (see the note at the top)
    int owed = -1;   // the history whose epilogue is owed, and its count
    for (int sq = nq - 1; sq >= 0; --sq) {
      const int t_lo = sq * HC;
      if (tid == 0)
        mbar_expect(full + hk % NBUF, S::STEP_BYTES * min(HC, n - t_lo));
      if (t_lo + HC <= n)
        walk(t_lo, false);
      else
        walk(t_lo, true);
      if (owed >= 0) {
        gather(owed * HC, hk - 1);
        put();   // stores what the buffer's loads gave, before the arrive
      }
      if (arrived) cluster_wait();
      cluster_arrive();   // buffer (hk - 1) % NBUF is read
      arrived = true;
      if (sq > 0) {       // the next history's states
        // a full chunk's slot 2, once read, takes the chunk's checkpoint
        // (history 0's state), and slot 1 the next chunk's
        if (sq > 1) {
          read_slot(s, sq - 1);
        } else if (full_chunk) {
          cp_wait<0>();
          read_slot(s, 2);
        } else {
          load_ckpt(s, ch);
        }
        build(s, (sq - 1) * HC);
        if (full_chunk && sq == 3) fetch_ckpt(2, ch);
        if (full_chunk && sq == 2 && ch > 0) fetch_ckpt(1, ch - 1);
      }
      owed = sq;
      ++hk;
    }
    gather(0, hk - 1);   // the chunk's last history, before its stage goes
    put();
    fetched = full_chunk && ch > 0;
    if (!fetched && ch > 0) load_ckpt(s, ch - 1);
  }

  // du's parts of this rank's rows: by history step, then in step order
#pragma unroll
  for (int e = 0; e < S::IPT; ++e) {
    const int p = tid + e * NT;
    if (p < S::ITEMS) dus[p] = du_acc[e];
  }
  if (arrived) cluster_wait();
  cluster.sync();   // the dus parts are in; no rank's sends are in flight
  if (tid < CJ) {
    float acc = 0.f;
#pragma unroll
    for (int tt = 0; tt < HC; ++tt) acc += dus[tt * CJ + tid];
    du_part[(size_t)bh * N + j0 + tid] = acc;
  }
  if (ds0 != nullptr) {
    float* dst = ds0 + (size_t)bh * N * N + (size_t)i0 * N + j0 + jl;
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      *reinterpret_cast<float4*>(dst + a * N) =
          make_float4(dS[a][0], dS[a][1], dS[a][2], dS[a][3]);
      *reinterpret_cast<float4*>(dst + a * N + 4) =
          make_float4(dS[a][4], dS[a][5], dS[a][6], dS[a][7]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches

struct Args {
  const void *r, *k, *v;
  const float *w, *u, *s0;
  float *y, *sT, *ckpt;
  int B, T_len, H;
  cudaStream_t stream;
};

template <typename T, int N>
int launch_seq(const Args& a) {
  wkv6_seq<T, N><<<a.B * a.H, N, 0, a.stream>>>(
      (const T*)a.r, (const T*)a.k, (const T*)a.v, a.w, a.u, a.s0, a.y,
      a.sT, a.T_len, a.H);
  return (int)cudaGetLastError();
}

// Let kern take more than 48 KB of dynamic shared memory on the current
// device, once a device (done: the kernel's own flags, one a device): the
// call costs microseconds of host time, which a decode step's launch would
// otherwise pay every time.
constexpr int kDevices = 64;
template <typename K>
cudaError_t allow_smem(K kern, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < kDevices)
    done[dev].store(true, std::memory_order_release);
  return e;
}

template <typename T, int N>
int launch_split(const Args& a) {
  using S = Split<T, N>;
  auto kern = wkv6_split<T, N>;
  if (S::SMEM > 48 * 1024) {
    static std::atomic<bool> done[kDevices];
    const cudaError_t e = allow_smem(kern, S::SMEM, done);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.B * a.H, N / S::CJ), S::NT, S::SMEM, a.stream>>>(
      (const T*)a.r, (const T*)a.k, (const T*)a.v, a.w, a.u, a.s0, a.y,
      a.sT, a.ckpt, a.T_len, a.H);
  return (int)cudaGetLastError();
}

struct BwdArgs {
  const void *r, *k, *v;
  const float *w, *u, *dy, *dsT, *ckpt;
  void *dr, *dk, *dv;
  float *dw, *du_part, *du, *ds0;
  int B, T_len, H;
  cudaStream_t stream;
};

// du = the B streams' parts of each (h, i), added in order of b
template <int N>
int launch_du_sum(const BwdArgs& a) {
  const int HN = a.H * N;
  wkv6_du_sum<<<(HN + 255) / 256, 256, 0, a.stream>>>(a.du_part, a.du, a.B,
                                                      HN);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_bwd_block(const BwdArgs& a) {
  using S = Bwd<N>;
  auto kern = wkv6_bwd_block<T, N>;
  if (S::SMEM > 48 * 1024) {
    static std::atomic<bool> done[kDevices];
    const cudaError_t e = allow_smem(kern, S::SMEM, done);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<a.B * a.H, S::NT, S::SMEM, a.stream>>>(
      (const T*)a.r, (const T*)a.k, (const T*)a.v, a.w, a.u, a.dy, a.dsT,
      a.ckpt, (T*)a.dr, (T*)a.dk, (T*)a.dv, a.dw, a.du_part, a.ds0, a.T_len,
      a.H);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_du_sum<N>(a);
}

// The cluster kernel's launch: grid (B * H, NB), the NB blocks of a
// stream one cluster
template <typename T, int N>
cudaLaunchConfig_t cluster_config(int streams, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  using S = Clu<T, N>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(streams, S::NB, 1);
  cfg.blockDim = dim3(S::NT, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = S::NB;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int N>
cudaError_t allow_cluster_smem() {
  using S = Clu<T, N>;
  if (S::SMEM <= 48 * 1024) return cudaSuccess;
  static std::atomic<bool> done[kDevices];
  return allow_smem(wkv6_bwd_cluster<T, N>, S::SMEM, done);
}

template <typename T, int N>
int launch_bwd_cluster(const BwdArgs& a) {
  cudaError_t e = allow_cluster_smem<T, N>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<T, N>(a.B * a.H, a.stream, &attr);
  e = cudaLaunchKernelEx(&cfg, wkv6_bwd_cluster<T, N>, (const T*)a.r,
                         (const T*)a.k, (const T*)a.v, a.w, a.u, a.dy, a.dsT,
                         a.ckpt, (T*)a.dr, (T*)a.dk, (T*)a.dv, a.dw,
                         a.du_part, a.ds0, a.T_len, a.H);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_du_sum<N>(a);
}

// What the card gives a kernel: out[0] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] clusters
// resident at once (cudaOccupancyMaxActiveClusters; 0 for the block
// kernel), out[2] threads a block, out[3] dynamic shared memory a block,
// out[4] registers a thread, out[5] local memory a thread (spills), out[6]
// blocks a stream
template <typename K>
cudaError_t func_stats(K kern, int threads, int smem, int* out) {
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, threads, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return e;
  out[2] = threads;
  out[3] = smem;
  out[4] = fa.numRegs;
  out[5] = (int)fa.localSizeBytes;
  return cudaSuccess;
}

template <typename T, int N>
int occupancy(int variant, int* out) {
  if (variant == 1) {
    using S = Bwd<N>;
    auto kern = wkv6_bwd_block<T, N>;
    if (S::SMEM > 48 * 1024) {
      static std::atomic<bool> done[kDevices];
      const cudaError_t e = allow_smem(kern, S::SMEM, done);
      if (e != cudaSuccess) return (int)e;
    }
    out[1] = 0;
    out[6] = 1;
    return (int)func_stats(kern, S::NT, S::SMEM, out);
  }
  using S = Clu<T, N>;
  cudaError_t e = allow_cluster_smem<T, N>();
  if (e != cudaSuccess) return (int)e;
  e = func_stats(wkv6_bwd_cluster<T, N>, S::NT, S::SMEM, out);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<T, N>(1, 0, &attr);
  e = cudaOccupancyMaxActiveClusters(&out[1], wkv6_bwd_cluster<T, N>, &cfg);
  out[6] = S::NB;
  return (int)e;
}

template <typename T>
int dispatch_bwd(int variant, int N, const BwdArgs& a) {
  switch (N) {
    case 16: return variant ? launch_bwd_block<T, 16>(a)
                            : launch_bwd_cluster<T, 16>(a);
    case 32: return variant ? launch_bwd_block<T, 32>(a)
                            : launch_bwd_cluster<T, 32>(a);
    case 64: return variant ? launch_bwd_block<T, 64>(a)
                            : launch_bwd_cluster<T, 64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_occupancy(int variant, int N, int* out) {
  switch (N) {
    case 16: return occupancy<T, 16>(variant, out);
    case 32: return occupancy<T, 32>(variant, out);
    case 64: return occupancy<T, 64>(variant, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run_bwd(const void* r, const void* k, const void* v, const float* w,
            const float* u, const float* dy, const float* dsT,
            const float* ckpt, void* dr, void* dk, void* dv, float* dw,
            float* du_part, float* du, float* ds0, int B, int T_len, int H,
            int N, int dtype, int variant, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (T_len <= 0) return (int)cudaErrorInvalidValue;
  const BwdArgs a{r, k, v, w, u, dy, dsT, ckpt, dr, dk, dv, dw, du_part,
                  du, ds0, B, T_len, H, (cudaStream_t)stream};
  if (dtype == 0) return dispatch_bwd<float>(variant, N, a);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(variant, N, a);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_n(int variant, int N, const Args& a) {
  switch (N) {
    case 16: return variant ? launch_seq<T, 16>(a) : launch_split<T, 16>(a);
    case 32: return variant ? launch_seq<T, 32>(a) : launch_split<T, 32>(a);
    case 64: return variant ? launch_seq<T, 64>(a) : launch_split<T, 64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v: (B, T, H, N) of one dtype (0: float32, 1: bfloat16); w:
// (B, T, H, N) float32; u: (H, N) float32; s0: (B, H, N, N) float32;
// y: (B, T, H, N) float32; sT: (B, H, N, N) float32; ckpt: null, or
// (B, H, ceil(T / 16), N, N) float32 for the state before every 16th
// step (wkv6_split only).  All contiguous and 16-byte aligned.  variant 0
// is wkv6_split, 1 wkv6_seq.  Returns a cudaError_t.
int wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* sT,
             float* ckpt, int B, int T_len, int H, int N, int dtype,
             int variant, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (T_len <= 0 || variant < 0 || variant > 1 ||
      (variant == 1 && ckpt != nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, w, u, s0, y, sT, ckpt, B, T_len, H,
               (cudaStream_t)stream};
  if (dtype == 0) return dispatch_n<float>(variant, N, a);
  if (dtype == 1) return dispatch_n<__nv_bfloat16>(variant, N, a);
  return (int)cudaErrorInvalidValue;
}

// The backward.  r, k, v, w, u and ckpt as wkv6_fwd takes and writes
// them; dy: (B, T, H, N) float32; dsT: null (zero) or (B, H, N, N)
// float32.  Writes dr, dk, dv: (B, T, H, N) in r's dtype; dw: (B, T, H, N)
// float32; du_part: (B, H, N) float32 scratch; du: (H, N) float32; ds0:
// null (not wanted) or (B, H, N, N) float32.  Two launches: the walk
// (wkv6_bwd_cluster), and du's sum over b.  Returns a cudaError_t.
int wkv6_bwd(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* dy, const float* dsT,
             const float* ckpt, void* dr, void* dk, void* dv, float* dw,
             float* du_part, float* du, float* ds0, int B, int T_len, int H,
             int N, int dtype, void* stream) {
  return run_bwd(r, k, v, w, u, dy, dsT, ckpt, dr, dk, dv, dw, du_part, du,
                 ds0, B, T_len, H, N, dtype, 0, stream);
}

// The same with the first design's walk, wkv6_bwd_block (the yardstick).
int wkv6_bwd_yardstick(const void* r, const void* k, const void* v,
                       const float* w, const float* u, const float* dy,
                       const float* dsT, const float* ckpt, void* dr,
                       void* dk, void* dv, float* dw, float* du_part,
                       float* du, float* ds0, int B, int T_len, int H, int N,
                       int dtype, void* stream) {
  return run_bwd(r, k, v, w, u, dy, dsT, ckpt, dr, dk, dv, dw, du_part, du,
                 ds0, B, T_len, H, N, dtype, 1, stream);
}

// What the card gives the backward's walk at head size N and dtype
// (0: float32, 1: bfloat16): variant 0 wkv6_bwd_cluster, 1
// wkv6_bwd_block; out: 7 ints (see occupancy above) on the current
// device.  Returns a cudaError_t.
int wkv6_bwd_occupancy(int N, int dtype, int variant, int* out) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_occupancy<float>(variant, N, out);
  if (dtype == 1) return dispatch_occupancy<__nv_bfloat16>(variant, N, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
