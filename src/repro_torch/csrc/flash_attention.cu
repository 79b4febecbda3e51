// Forward flash attention for Hopper (sm_90a): causal, sliding window or
// bidirectional, with grouped-query heads.  A plain C interface, loaded
// with ctypes by repro_torch/kernels/flash_attention.py; each entry point
// returns cudaGetLastError() after its launch and never synchronizes.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::_kernel
// (:28), called by flash_attention_pallas (:85).  Two kernels, chosen by
// the wrapper from the dtype and the head size alone:
//
// flash_fwd_sm90 (bf16, D in {16, 32, 64, 80, 128, 160, 256}): the
//   tensor-core kernel.
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
//   fp32 takes the scalar kernel: wgmma has no fp32 operands, and TF32
//   would break the fp32 tolerance.
//
// flash_fwd_kernel (fp32 at every D): the scalar kernel.  It takes bf16
//   too, reached only by name (the wrapper's yardstick for the
//   tensor-core kernel).
//   One block owns one (b, query head, 64-row q tile); Q, K and V are
//   staged in shared memory as fp32 and both products run as scalar FMAs
//   (4 x 4 scores and 4 x D/16 outputs per thread), no tensor cores.
//   Shared-memory rows of Q and K are padded to D + 1 floats so that the
//   16 threads of a row group read 16 different banks.
//
// Arithmetic, both kernels, as the reference: scores in fp32 scaled by
// 1/sqrt(D) (the tensor-core kernel folds log2(e) in and uses exp2),
// masked scores are -1e30 exactly (never -inf), the running max m, sum l
// and accumulator stay in fp32, and the output is acc / max(l, 1e-30) in
// q's dtype.  Each q tile walks the key tiles it can see in the
// reference's order, from the window's lower tile (max(0, q0 - window) /
// tile) up to the causal upper tile.  A row whose first visited tile is
// wholly masked takes p = 1 on the masked keys until the first real score
// rescales them by exp(-1e30 - m) = 0; every row sees its own diagonal key
// in a later tile of the same walk, so the result equals the full softmax
// of the reference oracle.  Ragged edges are masked here (any Tq and Tk):
// keys past Tk score -1e30, and rows past Tq are never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// --- the scalar kernel -----------------------------------------------------

constexpr int kBQ = 64;          // query rows per block
constexpr int kBKV = 64;         // keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty owns rows, tx owns columns
constexpr int kPS = kBKV + 1;    // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

// Let kern take `bytes` of dynamic shared memory on the current device,
// once a device (`done`: the kernel's own flags, one a device).  The
// attribute belongs to the device's context, so a flag for the whole
// process would leave every card but the first unset.
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
  const int lo = window > 0 ? max(0, q0 - window) / kBKV : 0;

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
        bool ok = kp < Tk;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && (qp - kp) < window;
        if (!ok) s[i][j] = kNegInf;
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

constexpr int kStages = 2;       // K/V ring depth
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The block's shape at head size D.  Up to D = 128: a producer warpgroup
// and two consumer warpgroups of 64 query rows each (384 threads), a
// work item 128 query rows, K/V tiles of 128 keys, and the two groups in
// ping-pong.  D = 160 and 256 ("wide"): the O accumulator is D / 2 fp32 a
// consumer thread (80 or 128), which with S and P overflows the 168
// registers a thread of a 384-thread block may hold, so one consumer
// warpgroup beside the producer (256 threads: up to 255 registers a
// thread, no setmaxnreg, no ping-pong), items of 64 query rows and K/V
// tiles of 64 keys, which keeps Q and two stages of K and V to 5 x 20 KB
// (D = 160) or 5 x 32 KB (D = 256) of shared memory.
template <int D>
struct Shape {
  static constexpr bool kWide = D > 128;
  static constexpr int kConsumers = kWide ? 1 : 2;
  static constexpr int kBM = 64 * kConsumers;     // query rows an item
  static constexpr int kBN = kWide ? 64 : 128;    // keys a tile
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static_assert(kBM == kBN, "Q and K/V tiles share one geometry");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  A
// ring that never completes traps (an error the launch's stream reports)
// after some 2^26 polls, seconds at least, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One 4-d TMA tile load (coordinates innermost first: column, head, row,
// batch) into shared memory, completing on ``bar``'s transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
         ((uint64_t)layout << 62);
}

// Shared-memory geometry of a kRows-row tile of Q, K or V at head size D
// (kRows = Shape<D>::kBM, 128 or 64): kFull blocks of 64 columns
// (128-byte rows, 128-byte swizzle) and, where 64 does not divide D, one
// tail block of the kTail columns left (16 or 32: rows and swizzle of 32
// or 64 bytes).  Each block holds all kRows rows of its columns, so one
// TMA box fills it and one descriptor layout reads it.
template <int D>
struct Geo {
  static constexpr int kRows = Shape<D>::kBM;
  static constexpr int kFull = D / 64;
  static constexpr int kTail = D % 64;
  static constexpr int kFullBytes = kRows * 128;
  static constexpr int kTailSw = 2 * kTail;           // its row bytes
  static constexpr int kTailOffset = kFull * kFullBytes;
  static constexpr int kTileBytes = kTailOffset + kRows * kTailSw;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr int kTailLayout = kTailSw == 64 ? 2 : 3;
  static constexpr int kKSteps = D / 16;              // k16 steps of Q K^T
  // Q, the K and V rings, the mbarriers (full and empty for Q, full K,
  // full V and empty for each stage), and slack to align to 1024 bytes:
  // 164,928 bytes at D = 128 and at D = 256, 103,488 at D = 80 and at
  // D = 160
  static constexpr size_t kSmemBytes =
      (size_t)(1 + 2 * kStages) * kTileBytes + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kTail == 0 || kTail == 16 || kTail == 32, "head size");

  // The K-major descriptor of k16 step ks (16 columns, 32 bytes) of rows
  // [row, row + 64) of a tile: steps 4 c to 4 c + 3 lie in full block c,
  // the rest in the tail.
  static __device__ __forceinline__ uint64_t k_desc(uint32_t tile, int row,
                                                    int ks) {
    if (ks < 4 * kFull)
      return make_desc(tile + (ks / 4) * kFullBytes + row * 128 +
                           (ks % 4) * 32, 16, 8 * 128, 1);
    return make_desc(tile + kTailOffset + row * kTailSw +
                         (ks - 4 * kFull) * 32, 16, 8 * kTailSw, kTailLayout);
  }
  // The MN-major descriptors of keys [16 ks, 16 ks + 16) of a V tile: one
  // spans the full blocks from ``block`` on (the leading offset steps
  // along N from block to block), the other the tail.
  static __device__ __forceinline__ uint64_t v_full_desc(uint32_t tile,
                                                         int ks,
                                                         int block = 0) {
    return make_desc(tile + block * kFullBytes + ks * 16 * 128, kFullBytes,
                     8 * 128, 1);
  }
  static __device__ __forceinline__ uint64_t v_tail_desc(uint32_t tile,
                                                         int ks) {
    return make_desc(tile + kTailOffset + ks * 16 * kTailSw,
                     kRows * kTailSw, 8 * kTailSw, kTailLayout);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Named barriers 1 and 2 over the two consumer groups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128 keys) += A (64 x 16, shared memory) * B (16 x 128, shared
// memory), both K-major; ``accumulate`` 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S += Q K^T over one k16 step at N = the key tile's width.
template <int N> struct SS;
template <> struct SS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    wgmma_ss_n64(d, a, b, accumulate);
  }
};
template <> struct SS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    wgmma_ss_n128(d, a, b, accumulate);
  }
};

// O (64 x N) += P (64 x 16, registers, bf16) * V (16 x N, shared memory,
// MN-major: the transposed B operand).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V at N = D, by the instruction of that width.
template <int N> struct PV;
template <> struct PV<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n16(d, a, b);
  }
};
template <> struct PV<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n32(d, a, b);
  }
};
template <> struct PV<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <> struct PV<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};

// A block's work: q tiles ordered heaviest first (item j is q tile
// nmt - 1 - j / BH of head-batch j % BH), dealt to the G blocks in snake
// order (round r: block i takes r G + i when r is even, r G + G - 1 - i
// when it is odd), so that the blocks' sums of key tiles stay close.
struct Work {
  int b, h, g, q0, lo, ntiles;
};

template <int D>
struct Items {
  static constexpr int kBM = Shape<D>::kBM, kBN = Shape<D>::kBN;
  int total, nmt, BH, H, G, Tk, causal, window;

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
    w.lo = window > 0 ? max(0, w.q0 - window) / kBN : 0;
    w.ntiles = max(hi - w.lo, 0);
    return w;
  }
};

// The tensor maps of one call: for each of Q, K and V one over the full
// 64-column blocks and one over the tail (left zeroed where D has none).
struct Maps {
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

// One tile, kRows rows of one head from ``row``, into shared memory at
// ``dst``: a box for each full block and one for the tail, all completing
// on ``bar``.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const CUtensorMap* full,
                                          const CUtensorMap* tail,
                                          uint32_t bar, int head, int row,
                                          int b) {
  using Gm = Geo<D>;
#pragma unroll
  for (int c = 0; c < Gm::kFull; ++c)
    tma_load_4d(dst + c * Gm::kFullBytes, full, bar, 64 * c, head, row, b);
  if (Gm::kTail > 0)
    tma_load_4d(dst + Gm::kTailOffset, tail, bar, 64 * Gm::kFull, head, row,
                b);
}

// The accumulator registers of output columns [2 At, 2 At + 2 N): wgmma
// m64nNk16 keeps N / 2 a thread in column order, so the n64 product of a
// full block and the n16 one of the tail write disjoint ranges of one
// array laid out as a single m64nDk16 accumulator.
template <int At, int N, int M>
__device__ __forceinline__ float (&acc_part(float (&a)[M]))[N] {
  static_assert(At + N <= M, "accumulator range");
  return *reinterpret_cast<float(*)[N]>(a + At);
}

// Accumulator layout of wgmma m64nNk16 (fp32), per consumer thread: with
// warp w of the group, lane l, r = 16 w + l / 4 and q = l % 4, element
// 4 j + e sits at row r + 8 (e / 2), column 8 j + 2 q + e % 2.  A thread
// holds two rows; the four threads of a quad share them.
template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads, 1)
flash_fwd_sm90(const __grid_constant__ Maps maps,
               __nv_bfloat16* __restrict__ o, int B, int Tq, int Tk, int H,
               int G, int causal, int window, float scale) {
  using Gm = Geo<D>;
  using Sh = Shape<D>;
  constexpr int kBM = Sh::kBM, kBN = Sh::kBN;
  constexpr int kConsumerWarps = 4 * Sh::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle and the wgmma descriptors assume 1024-byte aligned tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + Gm::kTileBytes;                  // [kStages]
  const uint32_t v_s = k_s + kStages * Gm::kTileBytes;        // [kStages]
  const uint32_t bars = v_s + kStages * Gm::kTileBytes;
  const uint32_t full_q = bars;
  const uint32_t q_empty = bars + 8;
  const uint32_t full_k = bars + 16;                          // [kStages]
  const uint32_t full_v = full_k + 8 * kStages;               // [kStages]
  const uint32_t empty = full_v + 8 * kStages;                // [kStages]

  const int nmt = (Tq + kBM - 1) / kBM;
  const Items<D> items{nmt * B * H, nmt, B * H, H, G, Tk, causal, window};

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(q_empty, kConsumerWarps);   // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
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
        mbar_expect_tx(full_q, Gm::kTileBytes);
        load_tile<D>(q_s, &maps.q, &maps.q_tail, full_q, w.h, w.q0, w.b);
        for (int n = 0; n < w.ntiles; ++n, ++tiles) {
          const int st = tiles % kStages;
          mbar_wait(empty + 8 * st, ((tiles / kStages) & 1) ^ 1);
          const int k0 = (w.lo + n) * kBN;
          mbar_expect_tx(full_k + 8 * st, Gm::kTileBytes);
          load_tile<D>(k_s + st * Gm::kTileBytes, &maps.k, &maps.k_tail,
                       full_k + 8 * st, w.g, k0, w.b);
          mbar_expect_tx(full_v + 8 * st, Gm::kTileBytes);
          load_tile<D>(v_s + st * Gm::kTileBytes, &maps.v, &maps.v_tail,
                       full_v + 8 * st, w.g, k0, w.b);
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
        const uint32_t kb = k_s + st * Gm::kTileBytes;
        const uint32_t vb = v_s + st * Gm::kTileBytes;

        float s[kBN / 2];
        mbar_wait(full_k + 8 * st, ph);
        if constexpr (kPingPong)
          if (wg == 1 || tiles > 0) named_sync(1 + wg);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < Gm::kKSteps; ++ks)   // A: this group's rows
          SS<kBN>::mma(s, Gm::k_desc(q_s, 64 * wg, ks),
                       Gm::k_desc(kb, 0, ks), ks > 0);
        wgmma_commit();
        if constexpr (kPingPong)
          if (wg == 0 || tiles + 1 < total_s) named_arrive(2 - wg);
        wgmma_wait_all();
        fence_regs(s);
        if (n + 1 == w.ntiles) {        // this item's Q is read
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty);
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
            bool ok = c < Tk;
            if (causal) ok = ok && r >= c;
            if (window > 0) ok = ok && (r - c) < window;
            if (!ok) x = kNegInf;
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

        // O += P V: P straight from S's accumulator layout as the A operand.
        // wgmma reads its register operands asynchronously, so every
        // fragment stays live until the wait.
        uint32_t pa[kBN / 16][4];
#pragma unroll
        for (int ks = 0; ks < kBN / 16; ++ks) {
          pa[ks][0] = pack_bf16(s[8 * ks + 0], s[8 * ks + 1]);
          pa[ks][1] = pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
          pa[ks][2] = pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
          pa[ks][3] = pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
        }
        mbar_wait(full_v + 8 * st, ph);
        fence_regs(acc);
        fence_frags(pa);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBN / 16; ++ks) {
          if constexpr (Gm::kFull == 4) {       // D = 256: two n128 halves
            PV<128>::mma(acc_part<0, 64>(acc), pa[ks],
                         Gm::v_full_desc(vb, ks, 0));
            PV<128>::mma(acc_part<64, 64>(acc), pa[ks],
                         Gm::v_full_desc(vb, ks, 2));
          } else if constexpr (Gm::kFull > 0) {
            PV<64 * Gm::kFull>::mma(acc_part<0, 32 * Gm::kFull>(acc), pa[ks],
                                    Gm::v_full_desc(vb, ks));
          }
          if constexpr (Gm::kTail > 0)
            PV<Gm::kTail>::mma(acc_part<32 * Gm::kFull, Gm::kTail / 2>(acc),
                               pa[ks], Gm::v_tail_desc(vb, ks));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_frags(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);   // K and V are read
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
        __nv_bfloat16* out = o + (((size_t)w.b * Tq + row) * H + w.h) * D;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(out + 8 * jj + col0) = pack_bf16(
              acc[4 * jj + 2 * e] * l[e], acc[4 * jj + 2 * e + 1] * l[e]);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-d map over a contiguous bf16 (B, T, heads, D) tensor whose box is
// ``cols`` columns (one block, ``cols`` x 2 bytes wide and swizzled by
// that width) of ``rows`` rows of one head.
bool make_map(CUtensorMap* map, const void* ptr, int B, int T, int heads,
              int D, int cols, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)T * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int G, int causal, int window, float scale,
           cudaStream_t stream) {
  using Gm = Geo<D>;
  using Sh = Shape<D>;
  constexpr size_t bytes = Gm::kSmemBytes;
  constexpr int rows = Gm::kRows;
  static std::atomic<bool> done[kDevices];   // per instantiation and device
  cudaError_t err = allow_smem(flash_fwd_sm90<D>, (int)bytes, done);
  if (err != cudaSuccess) return (int)err;
  Maps maps = {};
  bool ok = true;
  if (Gm::kFull > 0)
    ok = make_map(&maps.q, q, B, Tq, H, D, 64, rows) &&
         make_map(&maps.k, k, B, Tk, G, D, 64, rows) &&
         make_map(&maps.v, v, B, Tk, G, D, 64, rows);
  if (ok && Gm::kTail > 0)
    ok = make_map(&maps.q_tail, q, B, Tq, H, D, Gm::kTail, rows) &&
         make_map(&maps.k_tail, k, B, Tk, G, D, Gm::kTail, rows) &&
         make_map(&maps.v_tail, v, B, Tk, G, D, Gm::kTail, rows);
  if (!ok) return (int)cudaErrorInvalidValue;
  // persistent: one block an SM of the current device, each walking its
  // share of the q tiles
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int items = B * H * ((Tq + Sh::kBM - 1) / Sh::kBM);
  flash_fwd_sm90<D><<<min(items, sms), Sh::kThreads, bytes, stream>>>(
      maps, (__nv_bfloat16*)o, B, Tq, Tk, H, G, causal,
      window, scale);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return tc::launch<16>(q, k, v, o, B, Tq, Tk, H, G, causal, window,
                            scale, s);
    case 32:
      return tc::launch<32>(q, k, v, o, B, Tq, Tk, H, G, causal, window,
                            scale, s);
    case 64:
      return tc::launch<64>(q, k, v, o, B, Tq, Tk, H, G, causal, window,
                            scale, s);
    case 80:
      return tc::launch<80>(q, k, v, o, B, Tq, Tk, H, G, causal, window,
                            scale, s);
    case 128:
      return tc::launch<128>(q, k, v, o, B, Tq, Tk, H, G, causal, window,
                             scale, s);
    case 160:
      return tc::launch<160>(q, k, v, o, B, Tq, Tk, H, G, causal, window,
                             scale, s);
    case 256:
      return tc::launch<256>(q, k, v, o, B, Tq, Tk, H, G, causal, window,
                             scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
