// Forward flash attention for Hopper (sm_90a): causal, sliding window or
// bidirectional, with grouped-query heads.  A plain C interface, loaded
// with ctypes by repro_torch/kernels/flash_attention.py; each entry point
// returns cudaGetLastError() after its launch and never synchronizes.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::_kernel
// (:28), called by flash_attention_pallas (:85).  Two kernels; the
// wrapper picks one, and its operand pieces, from the dtype and the head
// size alone:
//
// flash_fwd_sm90<D, NP> (D in {16, 32, 64, 80, 128, 160, 256}): the
//   tensor-core kernel, on bf16 (NP = 1) or on fp32 split into three bf16
//   pieces (NP = 3, below).
//   What bounds it: operations.  A causal call does 4 B H D Tq (Tq + 1) / 2
//   flops on B Tq H D + 2 B Tk G D inputs, far above the card's ridge; at
//   989 TFLOP/s bf16 the qwen3-1.7b prefill (B = 4, T = 1024, H = 16,
//   D = 128) has a 0.0174 ms floor a layer.  With as many KV heads as
//   query heads the bytes come close: the stablelm-3b prefill (H = G = 32,
//   D = 80) moves 83.9 MB, a 0.0250 ms floor at 3.35 TB/s against 0.0217
//   for its flops.  Only wgmma reaches the flop rate, so the design feeds
//   it:
//   - Persistent: one block an SM.  A work item is one (b, query head,
//     128-row q tile); causal masking gives the last q tiles up to 16
//     times the work of the first, so the items are ordered heaviest
//     first and dealt to the blocks in snake order, which keeps the
//     blocks' sums of key tiles close.  A block has a producer warpgroup
//     (one thread issues TMA; the group gives its registers back with
//     setmaxnreg) and two consumer warpgroups of 64 rows each, the M of
//     wgmma.  The producer runs ahead into the block's next item, so an
//     item's first Q and K/V loads hide under the last one's products.
//   - TMA loads each item's Q (a full and an empty mbarrier) and 128-key
//     K and V tiles through a ring of two stages with full and empty
//     mbarriers, from 4-d tensor maps over the tensors' own (B, T, heads,
//     D) layouts: GQA is a coordinate (KV head h / R), no copy is made,
//     and the out-of-bounds fill gives the zero keys and queries past Tk
//     and Tq.  A tile's rows are cut into 64-column blocks (128-byte
//     rows, 128-byte swizzle) and a tail of the 16 or 32 columns left
//     (32- or 64-byte rows and swizzle), one TMA box and one tensor map
//     each, all completing on one mbarrier; the wgmma descriptors match
//     each block's swizzle.  D = 128 is two full blocks, D = 16 and 32 a
//     tail alone, and D = 80 (160-byte rows, which no one swizzle width
//     divides) one full block and a 16-column tail.
//   - S = Q K^T is wgmma m64n128k16 from shared memory (both operands
//     K-major).  O += P V is wgmma with P in registers, rounded to bf16,
//     taken straight from S's accumulator layout, and V the MN-major
//     (transposed) B operand, so neither P nor a transposed V is staged.
//     A descriptor has one swizzle, so at D = 80 P V is two wgmma a k16
//     step, n64 on the full block and n16 on the tail, into disjoint
//     ranges of one accumulator (Q K^T takes 4 + 1 k16 steps).  One n80
//     wgmma instead needs every block at one swizzle: five 16-column
//     blocks of 32 bytes, five TMA boxes a tile; that layout measured 7%
//     slower on an H100.
//   - The softmax stays in registers: a thread holds two rows of S, and
//     row statistics reduce over the four threads of a quad.  Tiles that
//     need no mask fold the scale into one FFMA a score, and a warp
//     whose row maxima did not move skips the accumulator's rescale.
//   - The two consumer groups take turns (ping-pong) to issue their
//     Q K^T (named barriers), so that one group's softmax runs while the
//     other's products do; without the turns both groups wait on the
//     same tile and the tensor cores idle through both softmaxes.
//     Registers cap the rest: the compiler holds each thread to the 168
//     of a 384-thread block (setmaxnreg's 240 does not raise its
//     allocation here), too few to keep one tile's S while the last
//     tile's P V is in flight.
//   - D = 256 (recurrentgemma-9b's local attention) has a block shape of
//     its own (Shape<D>): its O accumulator alone is 128 fp32 a consumer
//     thread, so one consumer warpgroup of 64 query rows beside the
//     producer in a 256-thread block (255 registers a thread), 64-key
//     tiles (S is m64n64k16, 16 k16 steps a tile), four 64-column blocks
//     a row and no tail, and P V as two m64n128k16 halves a k16 step into
//     the two halves of one accumulator.  Q and two stages of K and V
//     take 5 x 32 KB of shared memory.  With one group there is no
//     ping-pong: the softmax and the products of a tile take turns.
//   - D = 160 (pixtral-12b: 5,120 over 32 heads) takes the same wide
//     block.  In the two-consumer block its 80 fp32 O accumulators, 64
//     of S and 32 of packed P a thread come to 176 registers, over that
//     block's 168.  A row is two 64-column blocks and a 32-column tail
//     (64-byte rows and swizzle), 20,480 bytes a 64-row tile, 103,488
//     bytes of shared memory in all; Q K^T takes 8 + 2 k16 steps, and
//     P V a k16 step is one m64n128k16 over both full blocks (the
//     leading offset steps from block to block, as D = 256's halves) and
//     one m64n32k16 on the tail, into disjoint ranges of one
//     accumulator.
//   fp32 (NP = 3, the wrapper's "split" variant): wgmma has no fp32
//   operands, and tf32 keeps 10 of fp32's 23 bits, so split_pieces
//   (sm90.cuh) first writes q's, k's and v's three bf16 pieces to scratch
//   as (3 B, T, heads, D) tensors, which the same tensor maps read as
//   ordinary bf16 tiles (piece p of batch b is batch p B + b), and each
//   product is six wgmma products on the piece pairs (2, 0), (1, 1),
//   (0, 2), (1, 0), (0, 1), (0, 0), smallest first, into one fp32
//   accumulator; P is split in registers.  What bounds it: operations,
//   six bf16 products a product at 989 TFLOP/s: 0.1043 ms for the
//   qwen3-1.7b prefill in fp32, against 0.2567 for scalar FFMAs at 67
//   TFLOP/s; the split pass adds 10 bytes an element.  Every tile takes
//   three times a bf16 tile's shared memory, so the K/V tiles shrink: 64
//   keys up to D = 80, 32 from D = 128 on, in two stages but one at D =
//   256 (Q's pieces 96 KB and a stage's K and V pieces 96 KB): 36 to 193
//   KB in all.  A stage's K is freed after Q K^T and its V after P V, so
//   the next K loads under the softmax and P V.  The tensor cores' fp32
//   accumulation is coarser than a chain of fp32 FMAs, so a P V sum
//   carried across many key tiles drifts from the plain version: 2.7e-5
//   relative L2 at Tk = 4,096 (one decode token, D = 64) against the
//   scalar kernel's 1.2e-6 on an H100; within the fp32 tolerance (atol
//   2e-5).
//
// flash_fwd_kernel (fp32 and bf16 at every D): the scalar kernel, reached
//   only by name (the wrapper's yardstick for the tensor-core kernel on
//   both dtypes).
//   One block owns one (b, query head, 64-row q tile); Q, K and V are
//   staged in shared memory as fp32 and both products run as scalar FMAs
//   (4 x 4 scores and 4 x D/16 outputs per thread), no tensor cores.
//   Shared-memory rows of Q and K are padded to D + 1 floats so that the
//   16 threads of a row group read 16 different banks.
//
// Arithmetic, both kernels, as the reference: scores in fp32 scaled by
// 1/sqrt(D) (the tensor-core kernel folds log2(e) in and uses exp2),
// masked scores are -1e30 exactly, the running max m, sum l and
// accumulator stay in fp32, and the output is acc / max(l, 1e-30) in q's
// dtype.  Each q tile walks the key tiles it can see in the reference's
// order, from the window's lower tile (max(0, q0 - window) / tile) up to
// the causal upper tile.  A row whose first visited tile is wholly masked
// takes p = 1 on the masked keys until the first real score rescales them
// by exp(-1e30 - m) = 0, so a row that sees a key gets the full softmax of
// the reference oracle.  Keys past Tk (the tile's padding) score -inf, so
// p = 0 on them whatever the row's max: a row with no key in reach (a
// bidirectional window, Tq >= Tk + window) keeps m = -1e30 and p = 1 on
// each of the Tk keys, the oracle's uniform softmax, the mean of v; a q
// tile that holds such a row walks the key tiles from the first
// (no_key_rows).  Rows past Tq are never written.

#include "sm90.cuh"

namespace {

using namespace sm90;

// --- the scalar kernel -----------------------------------------------------

constexpr int kBQ = 64;          // query rows per block
constexpr int kBKV = 64;         // keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty owns rows, tx owns columns
constexpr int kPS = kBKV + 1;    // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

// Whether rows [q0, q0 + rows) hold one with no key in reach: a
// bidirectional window over Tk keys leaves none to rows from Tk + window -
// 1 on.  Such a row's softmax is uniform over the Tk keys (every score is
// -1e30), so a tile that holds one walks the key tiles from the first.
__device__ __forceinline__ bool no_key_rows(int q0, int rows, int Tq, int Tk,
                                            int causal, int window) {
  const int end = q0 + rows < Tq ? q0 + rows : Tq;
  return !causal && window > 0 && end >= Tk + window;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + (size_t)kBKV * (D + 1) + (size_t)kBKV * D +
          (size_t)kBQ * kPS);
}

// Thread (ty, tx) owns query rows ty + 16 i (i < 4) of the tile, score
// columns tx + 16 j (j < 4) of each key tile and output columns
// tx + 16 c (c < D / 16).  The 16 threads of a row group share one half
// of a warp, so row statistics reduce with xor shuffles over 16 lanes.
// Two blocks an SM up to D = 128; at D = 160 the 140,032 bytes of shared
// memory and at D = 256 the 213,760 allow one, and a hint of two would
// cap each thread's registers below its 4 x 16 accumulators at D = 256
// (spills).
template <int D>
constexpr int scalar_min_blocks() { return D > 128 ? 1 : 2; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, scalar_min_blocks<D>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
                 int H, int G, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // kBQ x DP, scaled
  float* k_s = q_s + kBQ * DP;       // kBKV x DP
  float* v_s = k_s + kBKV * DP;      // kBKV x D
  float* p_s = v_s + kBKV * D;       // kBQ x kPS
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    float x = 0.f;
    if (t < Tq) x = to_f32(q[(((size_t)b * Tq + t) * H + h) * D + d]) * scale;
    q_s[r * DP + d] = x;
  }

  float acc[4][CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int nkv = (Tk + kBKV - 1) / kBKV;
  const int hi = causal ? min((q0 + kBQ + kBKV - 1) / kBKV, nkv) : nkv;
  const int lo = window > 0 && !no_key_rows(q0, kBQ, Tq, Tk, causal, window)
                     ? max(0, q0 - window) / kBKV
                     : 0;

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kBKV;
    __syncthreads();   // the last tile's K, V and P reads are done
    for (int i = threadIdx.x; i < kBKV * D; i += kThreads) {
      const int r = i / D, d = i % D, t = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * G + g) * D + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[r * DP + d] = kk;
      v_s[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = true;
        if (causal) ok = qp >= kp;
        if (window > 0) ok = ok && (qp - kp) < window;
        if (!ok) s[i][j] = kNegInf;
        if (kp >= Tk) s[i][j] = neg_inf();   // no part, even in a keyless row
        mb = fmaxf(mb, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float mn = fmaxf(m[i], mb);
      const float corr = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        p_s[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();   // P is whole

#pragma unroll 4
    for (int kv = 0; kv < kBKV; ++kv) {
      float vb[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vb[c] = v_s[kv * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kPS + kv];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vb[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + (((size_t)b * Tq + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      out[tx + 16 * c] = from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int G, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static std::atomic<bool> done[kDevices];   // per instantiation and device
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, (int)bytes, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Tq, Tk, H, G, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Tq, int Tk, int H, int G, int D, int causal, int window,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 160: return launch<T, 160>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// --- the tensor-core kernel ------------------------------------------------

namespace tc {

constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The block's shape at head size D and NP operand pieces (sm90.cuh: 1 for
// bf16, 3 for fp32).  Up to D = 128: a producer warpgroup and two consumer
// warpgroups of 64 query rows each (384 threads), a work item 128 query
// rows, and the two groups in ping-pong.  D = 160 and 256 ("wide"): the O
// accumulator is D / 2 fp32 a consumer thread (80 or 128), which with S
// and P overflows the 168 registers a thread of a 384-thread block may
// hold, so one consumer warpgroup beside the producer (256 threads: up to
// 255 registers a thread, no setmaxnreg, no ping-pong) and items of 64
// query rows.  K/V tiles: for bf16 as many keys as the item has rows (128
// or 64), through a ring of two stages, which keeps Q and the ring to 5 x
// 20 KB (D = 160) or 5 x 32 KB (D = 256) of shared memory.  fp32 holds
// three pieces of every tile, so its K/V tiles are smaller: 64 keys up to
// D = 80, 32 from D = 128 on, two stages but at D = 256 one (Q's pieces
// 96 KB and a stage's K and V pieces 96 KB): 36 KB (D = 16) to 192 KB (D =
// 128 and 256) in all.
template <int D, int NP>
struct Shape {
  static constexpr bool kWide = D > 128;
  static constexpr int kConsumers = kWide ? 1 : 2;
  static constexpr int kBM = 64 * kConsumers;     // query rows an item
  static constexpr int kBN = NP == 1 ? (kWide ? 64 : 128)    // keys a tile
                                     : (D >= 128 ? 32 : 64);
  static constexpr int kStages = NP == 3 && D == 256 ? 1 : 2;  // K/V ring
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static_assert(NP == 3 || kBM == kBN, "bf16 Q and K/V tiles share one "
                "geometry");
};

// Shared-memory geometry at head size D: a TileGeo (sm90.cuh) for a piece
// of the Q tile (Shape::kBM rows) and one for a piece of a K or V tile
// (Shape::kBN rows); Q's NP pieces, the K and V rings' (NP pieces a
// stage), the mbarriers (full and empty for Q, full K and full V a stage,
// and a stage's empty: one for K and V, or for NP = 3 one each), and slack
// to align to 1024 bytes.  bf16: 164,928 bytes at D = 128 and at D = 256,
// 103,488 at D = 80 and at D = 160.
template <int D, int NP>
struct Geo {
  using Q = TileGeo<D, Shape<D, NP>::kBM>;
  using KV = TileGeo<D, Shape<D, NP>::kBN>;
  static constexpr int kStages = Shape<D, NP>::kStages;
  static constexpr int kBars = 2 + (NP == 1 ? 3 : 4) * kStages;
  static constexpr size_t kSmemBytes =
      (size_t)NP * (Q::kTileBytes + 2 * kStages * KV::kTileBytes) +
      8 * kBars + 1024;
};

// Named barriers 1 and 2 over the two consumer groups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// A block's work: q tiles ordered heaviest first (item j is q tile
// nmt - 1 - j / BH of head-batch j % BH), dealt to the G blocks in snake
// order (round r: block i takes r G + i when r is even, r G + G - 1 - i
// when it is odd), so that the blocks' sums of key tiles stay close.
struct Work {
  int b, h, g, q0, lo, ntiles;
};

template <typename Sh>
struct Items {
  static constexpr int kBM = Sh::kBM, kBN = Sh::kBN;
  int total, nmt, BH, H, G, Tq, Tk, causal, window;

  __device__ __forceinline__ int at(int r) const {   // round r's item, or -1
    const int j = r * (int)gridDim.x +
                  ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                           : (int)blockIdx.x);
    return j < total ? j : -1;
  }

  __device__ __forceinline__ Work work(int j) const {
    Work w;
    const int bh = j % BH;
    w.h = bh % H;
    w.b = bh / H;
    w.g = w.h / (H / G);
    w.q0 = (nmt - 1 - j / BH) * kBM;
    const int nkv = (Tk + kBN - 1) / kBN;
    const int hi = causal ? min((w.q0 + kBM + kBN - 1) / kBN, nkv) : nkv;
    w.lo = window > 0 && !no_key_rows(w.q0, kBM, Tq, Tk, causal, window)
               ? max(0, w.q0 - window) / kBN
               : 0;
    w.ntiles = max(hi - w.lo, 0);
    return w;
  }
};

// The tensor maps of one call: for each of Q, K and V one over the full
// 64-column blocks and one over the tail (left zeroed where D has none).
// For NP = 3 they map the pieces' (3 B, T, heads, D) tensors: piece p of
// batch b is batch p B + b.
struct Maps {
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

// Accumulator layout of wgmma m64nNk16 (fp32), per consumer thread: with
// warp w of the group, lane l, r = 16 w + l / 4 and q = l % 4, element
// 4 j + e sits at row r + 8 (e / 2), column 8 j + 2 q + e % 2.  A thread
// holds two rows; the four threads of a quad share them.
template <int D, int NP>
__global__ void __launch_bounds__(Shape<D, NP>::kThreads, 1)
flash_fwd_sm90(const __grid_constant__ Maps maps, Elem<NP>* __restrict__ o,
               int B, int Tq, int Tk, int H, int G, int causal, int window,
               float scale) {
  using Sh = Shape<D, NP>;
  using Gq = typename Geo<D, NP>::Q;
  using Gk = typename Geo<D, NP>::KV;
  constexpr int kBM = Sh::kBM, kBN = Sh::kBN, kStages = Sh::kStages;
  constexpr int kConsumerWarps = 4 * Sh::kConsumers;
  constexpr int kQBytes = NP * Gq::kTileBytes;     // Q's pieces
  constexpr int kKVBytes = NP * Gk::kTileBytes;    // a stage's K (or V)
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle and the wgmma descriptors assume 1024-byte aligned tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kQBytes;                         // [kStages]
  const uint32_t v_s = k_s + kStages * kKVBytes;              // [kStages]
  const uint32_t bars = v_s + kStages * kKVBytes;
  const uint32_t full_q = bars;
  const uint32_t q_empty = bars + 8;
  const uint32_t full_k = bars + 16;                          // [kStages]
  const uint32_t full_v = full_k + 8 * kStages;               // [kStages]
  const uint32_t empty = full_v + 8 * kStages;                // [kStages]
  // fp32 frees a stage's K after Q K^T (`empty`) and its V after P V
  // (`empty_v`), so the next K loads under this tile's softmax and P V;
  // bf16 frees both at once
  const uint32_t empty_v = NP == 1 ? empty : empty + 8 * kStages;

  const int nmt = (Tq + kBM - 1) / kBM;
  const Items<Sh> items{nmt * B * H, nmt, B * H, H, G, Tq, Tk, causal,
                        window};

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(q_empty, kConsumerWarps);   // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
      if constexpr (NP == 3) mbar_init(empty_v + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load, running
    // ahead into the block's next item while the consumers finish one
    if constexpr (!Sh::kWide)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int tiles = 0;                  // K/V tiles loaded: the ring's clock
      for (int r = 0, j; (j = items.at(r)) >= 0; ++r) {
        const Work w = items.work(j);
        mbar_wait(q_empty, (r & 1) ^ 1);     // the last item's Q is read
        mbar_expect_tx(full_q, kQBytes);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          load_tile<Gq>(q_s + p * Gq::kTileBytes, &maps.q, &maps.q_tail,
                        full_q, w.h, w.q0, p * B + w.b);
        for (int n = 0; n < w.ntiles; ++n, ++tiles) {
          const int st = tiles % kStages;
          const uint32_t free_ph = ((tiles / kStages) & 1) ^ 1;
          mbar_wait(empty + 8 * st, free_ph);
          const int k0 = (w.lo + n) * kBN;
          mbar_expect_tx(full_k + 8 * st, kKVBytes);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            load_tile<Gk>(k_s + st * kKVBytes + p * Gk::kTileBytes, &maps.k,
                          &maps.k_tail, full_k + 8 * st, w.g, k0,
                          p * B + w.b);
          if constexpr (NP == 3) mbar_wait(empty_v + 8 * st, free_ph);
          mbar_expect_tx(full_v + 8 * st, kKVBytes);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            load_tile<Gk>(v_s + st * kKVBytes + p * Gk::kTileBytes, &maps.v,
                          &maps.v_tail, full_v + 8 * st, w.g, k0,
                          p * B + w.b);
        }
      }
    }
  } else {
    // ---- the consumer warpgroups, 64 query rows each ----
    if constexpr (!Sh::kWide)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const float scale2 = scale * kLog2e;
    // ping-pong (two consumer groups): group 0 issues the block's k-th
    // Q K^T only after group 1 issued its (k - 1)-th (named barrier 1), and
    // group 1 its k-th only after group 0's k-th (barrier 2), so one
    // group's softmax runs while the other's products do.  Both groups
    // issue the same count.
    constexpr bool kPingPong = Sh::kConsumers == 2;
    int total_s = 0;
    if constexpr (kPingPong)
      for (int r = 0, j; (j = items.at(r)) >= 0; ++r)
        total_s += items.work(j).ntiles;
    int tiles = 0;                    // K/V tiles consumed: the ring's clock

    for (int r = 0, j; (j = items.at(r)) >= 0; ++r) {
      const Work w = items.work(j);
      const int r_lo = w.q0 + 64 * wg;               // this group's rows
      const int row0 = r_lo + 16 * warp + lane / 4;  // and row0 + 8
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      mbar_wait(full_q, r & 1);
      if (w.ntiles == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      }

      for (int n = 0; n < w.ntiles; ++n, ++tiles) {
        const int st = tiles % kStages;
        const uint32_t ph = (tiles / kStages) & 1;
        const int k0 = (w.lo + n) * kBN;
        const uint32_t kb = k_s + st * kKVBytes;
        const uint32_t vb = v_s + st * kKVBytes;

        // S = Q K^T: for fp32 the six piece products (sm90.cuh) into one
        // accumulator
        float s[kBN / 2];
        mbar_wait(full_k + 8 * st, ph);
        if constexpr (kPingPong)
          if (wg == 1 || tiles > 0) named_sync(1 + wg);
        wgmma_fence();
#pragma unroll
        for (int pr = 0; pr < products<NP>(); ++pr)
#pragma unroll
          for (int ks = 0; ks < Gq::kKSteps; ++ks)   // A: this group's rows
            SS<kBN>::mma(
                s, Gq::k_desc(q_s + piece_a<NP>(pr) * Gq::kTileBytes,
                              64 * wg, ks),
                Gk::k_desc(kb + piece_b<NP>(pr) * Gk::kTileBytes, 0, ks),
                pr > 0 || ks > 0);
        wgmma_commit();
        if constexpr (kPingPong)
          if (wg == 0 || tiles + 1 < total_s) named_arrive(2 - wg);
        wgmma_wait_all();
        fence_regs(s);
        if (n + 1 == w.ntiles) {        // this item's Q is read
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty);
        }
        if constexpr (NP == 3) {        // and this tile's K
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * st);
        }

        // scale into log2 units and mask, only where this tile can mask
        const bool need_mask =
            k0 + kBN > Tk || (causal && k0 + kBN - 1 > r_lo) ||
            (window > 0 && r_lo + 63 - k0 >= window);
        // Unmasked tiles keep the raw scores and fold the scale into one
        // FFMA a score (the max commutes with a positive scale); masked
        // tiles scale first, so that a masked score is -1e30 exactly.
        float mx[2] = {kNegInf, kNegInf};
        if (need_mask) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            float x = s[i] * scale2;
            const int r = row0 + 8 * ((i / 2) % 2);
            const int c = k0 + 8 * (i / 4) + col0 + (i % 2);
            bool ok = true;
            if (causal) ok = r >= c;
            if (window > 0) ok = ok && (r - c) < window;
            if (!ok) x = kNegInf;
            // keys past Tk take no part, not even in a row with no key in
            // reach: p = 2^-inf = 0 whatever the row's max
            if (c >= Tk) x = neg_inf();
            s[i] = x;
            mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i)
            mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
          mx[0] *= scale2;
          mx[1] *= scale2;
        }
        float corr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
          mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
          const float mn = fmaxf(m[e], mx[e]);
          corr[e] = ex2(m[e] - mn);
          m[e] = mn;
          l[e] *= corr[e];          // a thread's partial sum; quads add up last
        }
        const float sc = need_mask ? 1.f : scale2;
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const float p = ex2(fmaf(s[i], sc, -m[(i / 2) % 2]));
          s[i] = p;
          l[(i / 2) % 2] += p;
        }
        // a warp whose row maxima all stayed put skips the rescale
        if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];
        }

        // O += P V: P straight from S's accumulator layout as the A operand
        // (for fp32 its three pieces, six products).  wgmma reads its
        // register operands asynchronously, so every fragment stays live
        // until the wait.
        uint32_t pa[NP][kBN / 16][4];
        to_piece_frags<kBN, NP>(s, pa);
        mbar_wait(full_v + 8 * st, ph);
        fence_regs(acc);
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_frags(pa[p]);
        wgmma_fence();
#pragma unroll
        for (int pr = 0; pr < products<NP>(); ++pr)
#pragma unroll
          for (int ks = 0; ks < kBN / 16; ++ks)
            mma_rows<Gk>(acc, pa[piece_a<NP>(pr)][ks],
                         vb + piece_b<NP>(pr) * Gk::kTileBytes, ks);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_frags(pa[p]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_v + 8 * st);   // V (and K) is read
      }

#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
        l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
        l[e] = 1.f / fmaxf(l[e], 1e-30f);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * e;
        if (row >= Tq) continue;
        Elem<NP>* out = o + (((size_t)w.b * Tq + row) * H + w.h) * D;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          store2(out + 8 * jj + col0, acc[4 * jj + 2 * e] * l[e],
                 acc[4 * jj + 2 * e + 1] * l[e]);
      }
    }
  }
}

// Launch flash_fwd_sm90<D, NP> on tensors q, k, v (bf16; for NP = 3 the
// pieces' (3 B, T, heads, D) tensors) into o.
template <int D, int NP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int G, int causal, int window, float scale,
           cudaStream_t stream) {
  using Sh = Shape<D, NP>;
  constexpr size_t bytes = Geo<D, NP>::kSmemBytes;
  static std::atomic<bool> done[kDevices];   // per instantiation and device
  cudaError_t err = allow_smem(flash_fwd_sm90<D, NP>, (int)bytes, done);
  if (err != cudaSuccess) return (int)err;
  Maps maps = {};
  if (!bind_context() ||
      !make_maps<D>(&maps.q, &maps.q_tail, q, NP * B, Tq, H, Sh::kBM) ||
      !make_maps<D>(&maps.k, &maps.k_tail, k, NP * B, Tk, G, Sh::kBN) ||
      !make_maps<D>(&maps.v, &maps.v_tail, v, NP * B, Tk, G, Sh::kBN))
    return (int)cudaErrorInvalidValue;
  // persistent: one block an SM of the current device, each walking its
  // share of the q tiles
  int sms = 0;
  err = (cudaError_t)sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int items = B * H * ((Tq + Sh::kBM - 1) / Sh::kBM);
  flash_fwd_sm90<D, NP><<<min(items, sms), Sh::kThreads, bytes, stream>>>(
      maps, (Elem<NP>*)o, B, Tq, Tk, H, G, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int NP>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Tq, int Tk, int H, int G, int D, int causal, int window,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, NP>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 32: return launch<32, NP>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 64: return launch<64, NP>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 80: return launch<80, NP>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 128: return launch<128, NP>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 160: return launch<160, NP>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    case 256: return launch<256, NP>(q, k, v, o, B, Tq, Tk, H, G, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// q: (B, Tq, H, D); k, v: (B, Tk, G, D); o: (B, Tq, H, D), all
// contiguous and of one dtype (0: float32, 1: bfloat16).  window <= 0
// means no window.  The scalar kernel.  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int Tq, int Tk, int H, int G, int D,
                        int causal, int window, float scale, int dtype,
                        void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return (int)cudaSuccess;
  if (G <= 0 || H % G != 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Tq, Tk, H, G, D, causal, window,
                             scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, H, G, D, causal,
                                     window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The same call for bf16 tensors at D in {16, 32, 64, 80, 128, 160, 256}
// on the tensor cores.  Base pointers must be 16-byte aligned (the tensor maps' rule;
// the wrapper checks).  Returns a cudaError_t.
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                             void* o, int B, int Tq, int Tk, int H, int G,
                             int D, int causal, int window, float scale,
                             void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return (int)cudaSuccess;
  if (G <= 0 || H % G != 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  return tc::dispatch<1>(q, k, v, o, B, Tq, Tk, H, G, D, causal, window,
                         scale, (cudaStream_t)stream);
}

// The same call for fp32 tensors at the same head sizes on the tensor
// cores: split_pieces writes q's, k's and v's three bf16 pieces (sm90.cuh)
// to `pieces`, bf16 scratch of 3 (q's + k's + v's elements), in that
// order; then flash_fwd_sm90<D, 3> reads them.  Base pointers 16-byte
// aligned.  Launches both kernels on `stream`.  Returns a cudaError_t.
int flash_attention_fwd_split(const void* q, const void* k, const void* v,
                              void* o, void* pieces, int B, int Tq, int Tk,
                              int H, int G, int D, int causal, int window,
                              float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return (int)cudaSuccess;
  if (G <= 0 || H % G != 0 || Tk <= 0 || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nq = (long long)B * Tq * H * D;
  const long long nk = (long long)B * Tk * G * D;
  __nv_bfloat16* pq = (__nv_bfloat16*)pieces;
  __nv_bfloat16* pk = pq + 3 * nq;
  __nv_bfloat16* pv = pk + 3 * nk;
  const sm90::SplitJobs jobs = {
      {(const float*)q, (const float*)k, (const float*)v, nullptr},
      {pq, pk, pv, nullptr},
      {nq, nk, nk, 0}};
  const int err = sm90::launch_split(jobs, 3, s);
  if (err != 0) return err;
  return tc::dispatch<3>(pq, pk, pv, o, B, Tq, Tk, H, G, D, causal, window,
                         scale, s);
}

}  // extern "C"
