// Hopper (sm_90a) building blocks shared by the attention kernels
// (flash_attention.cu's forward, flash_attention_bwd.cu's backward): the
// mbarrier and TMA instructions, wgmma descriptors and instructions, the
// shared-memory geometry of a bf16 tile cut into swizzled column blocks,
// and the tensor-map encoder.  Header-only; each source that includes it
// builds into a library of its own.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace sm90 {

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

// One 3-d or 4-d TMA tile load (coordinates innermost first) into shared
// memory, completing on ``bar``'s transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

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

// --- fp32 on the tensor cores: three bf16 pieces ----------------------------
//
// wgmma takes no fp32 operands, and tf32 keeps 10 bits of fp32's 23.  An
// fp32 value x splits into three bf16 pieces, p0 = bf16_rn(x), p1 =
// bf16_rn(x - p0), p2 = bf16_rn(x - p0 - p1): each difference is exact in
// fp32, and the pieces sum to x exactly wherever a bf16 can hold x's last
// bit (|x| >= 2^-110).  Where bf16_rn(x) overflows (|x| within half a bf16
// step of the largest float) p0 rounds toward zero instead.  A product of
// two such operands is the sum of the six piece products (i, j) with i + j
// <= 2, issued smallest first into one fp32 accumulator; the three left
// out, (1, 2), (2, 1) and (2, 2), are below 2^-24 of the product.  A piece
// product is exact in the tensor core (8 x 8 significant bits), so the sum
// keeps about fp32's accuracy at six bf16 products' rate: 164.8 TFLOP/s of
// fp32 work at 989, 2.46 times the 67 TFLOP/s of scalar FFMAs.  Kernels
// take the number of pieces NP as a template argument: 1 is bf16 (the one
// product (0, 0)), 3 is fp32.

// The element type of an NP-piece kernel's inputs and outputs: bf16, or
// fp32 for NP = 3.
template <int NP>
using Elem = typename std::conditional<NP == 1, __nv_bfloat16, float>::type;

// The products a k16 step of an NP-piece operand pair takes, and the
// pieces of A and B product t multiplies.
template <int NP>
__host__ __device__ constexpr int products() { return NP == 1 ? 1 : 6; }
template <int NP>
__host__ __device__ constexpr int piece_a(int t) {
  return NP == 1 ? 0 : t == 0 ? 2 : (t == 1 || t == 3) ? 1 : 0;
}
template <int NP>
__host__ __device__ constexpr int piece_b(int t) {
  return NP == 1 ? 0 : t == 2 ? 2 : (t == 1 || t == 4) ? 1 : 0;
}

// x's three pieces (above).
__device__ __forceinline__ void split3(float x, __nv_bfloat16& p0,
                                       __nv_bfloat16& p1, __nv_bfloat16& p2) {
  p0 = __float2bfloat16_rn(x);
  if (isinf(__bfloat162float(p0)) && !isinf(x)) p0 = __float2bfloat16_rz(x);
  const float r = x - __bfloat162float(p0);
  p1 = __float2bfloat16_rn(r);
  p2 = __float2bfloat16_rn(r - __bfloat162float(p1));
}

// The pass that splits fp32 tensors into their pieces: job j reads n[j]
// floats (a multiple of 4) at src[j] and writes piece p of element i to
// dst[j][p n[j] + i], so a contiguous (B, T, heads, D) tensor's pieces are
// one contiguous (3 B, T, heads, D) bf16 tensor whose 4-d tensor maps read
// piece p of batch b as batch p B + b.  16-byte loads, 8-byte stores.
struct SplitJobs {
  const float* src[4];
  __nv_bfloat16* dst[4];
  long long n[4];
};

static __global__ void __launch_bounds__(256)
split_pieces(const SplitJobs jobs) {
  const int j = blockIdx.y;
  const long long n = jobs.n[j], n4 = n / 4;
  const float4* src = reinterpret_cast<const float4*>(jobs.src[j]);
  __nv_bfloat16* dst = jobs.dst[j];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 x = src[i];
    const float xs[4] = {x.x, x.y, x.z, x.w};
    __align__(8) __nv_bfloat16 p[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(xs[e], p[0][e], p[1][e], p[2][e]);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<uint2*>(dst + q * n + 4 * i) =
          *reinterpret_cast<const uint2*>(p[q]);
  }
}

// Launch split_pieces over the first `count` jobs on `stream`.
inline int launch_split(const SplitJobs& jobs, int count, cudaStream_t stream) {
  long long most = 0;
  for (int j = 0; j < count; ++j) most = jobs.n[j] > most ? jobs.n[j] : most;
  const long long blocks = (most / 4 + 255) / 256;
  const int grid = (int)(blocks < 1056 ? (blocks > 0 ? blocks : 1) : 1056);
  split_pieces<<<dim3(grid, count), 256, 0, stream>>>(jobs);
  return (int)cudaGetLastError();
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

// Shared-memory geometry of a Rows-row bf16 tile of head size D (a tile of
// Q, K, V or dO, or of one of their pieces; Rows a multiple of 32: 64 for
// an A operand, 32 or more for a B operand): kFull blocks of 64 columns
// (128-byte rows, 128-byte swizzle) and, where 64 does not divide D, one
// tail block of the kTail columns left (16 or 32: rows and swizzle of 32
// or 64 bytes).  Each block holds all Rows rows of its columns, so one TMA
// box fills it and one descriptor layout reads it.
template <int D, int Rows>
struct TileGeo {
  static constexpr int kRows = Rows;
  static constexpr int kFull = D / 64;
  static constexpr int kTail = D % 64;
  static constexpr int kFullBytes = kRows * 128;
  static constexpr int kTailSw = 2 * kTail;           // its row bytes
  static constexpr int kTailOffset = kFull * kFullBytes;
  static constexpr int kTileBytes = kTailOffset + kRows * kTailSw;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr int kTailLayout = kTailSw == 64 ? 2 : 3;
  static constexpr int kKSteps = D / 16;              // k16 steps over D
  static_assert(kTail == 0 || kTail == 16 || kTail == 32, "head size");
  static_assert(Rows % 32 == 0, "tile rows");

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
  // The MN-major descriptors of rows [16 ks, 16 ks + 16) of a tile taken as
  // the B operand (K x N with the tile's rows as K and D as N): one spans
  // the full blocks from ``block`` on (the leading offset steps along N
  // from block to block), the other the tail.
  static __device__ __forceinline__ uint64_t mn_full_desc(uint32_t tile,
                                                          int ks,
                                                          int block = 0) {
    return make_desc(tile + block * kFullBytes + ks * 16 * 128, kFullBytes,
                     8 * 128, 1);
  }
  static __device__ __forceinline__ uint64_t mn_tail_desc(uint32_t tile,
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -inf: the score of a key past Tk, whose p = exp(-inf - m) is 0 even
// in a row whose every real score is the mask's -1e30
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two output values at out[0], out[1] in the output's type (Elem).
__device__ __forceinline__ void store2(__nv_bfloat16* out, float x0,
                                      float x1) {
  *reinterpret_cast<uint32_t*>(out) = pack_bf16(x0, x1);
}
__device__ __forceinline__ void store2(float* out, float x0, float x1) {
  *reinterpret_cast<float2*>(out) = make_float2(x0, x1);
}

// An m64nNk16 fp32 accumulator (N / 2 floats a thread) as the A operand
// fragments of the next product, k16 step by k16 step, rounded to bf16:
// the accumulator's columns become the product's K.
template <int N>
__device__ __forceinline__ void to_frags(const float (&s)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    a[ks][0] = pack_bf16(s[8 * ks + 0], s[8 * ks + 1]);
    a[ks][1] = pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
    a[ks][2] = pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
    a[ks][3] = pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
  }
}

// The same fragments of an NP-piece operand: NP = 1 rounds to bf16 as
// to_frags; NP = 3 gives piece p of each value in a[p] (split3's pieces;
// the values here, P and dS, are far from fp32's largest).
template <int N, int NP>
__device__ __forceinline__ void to_piece_frags(const float (&s)[N / 2],
                                               uint32_t (&a)[NP][N / 16][4]) {
  if constexpr (NP == 1) {
    to_frags<N>(s, a[0]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float x0 = s[2 * i], x1 = s[2 * i + 1];
      const uint32_t h0 = pack_bf16(x0, x1);
      const __nv_bfloat162 b0 = *reinterpret_cast<const __nv_bfloat162*>(&h0);
      const float r0 = x0 - __low2float(b0), r1 = x1 - __high2float(b0);
      const uint32_t h1 = pack_bf16(r0, r1);
      const __nv_bfloat162 b1 = *reinterpret_cast<const __nv_bfloat162*>(&h1);
      a[0][i / 4][i % 4] = h0;
      a[1][i / 4][i % 4] = h1;
      a[2][i / 4][i % 4] =
          pack_bf16(r0 - __low2float(b1), r1 - __high2float(b1));
    }
  }
}

// D (64 x 128) += A (64 x 16, shared memory) * B (16 x 128, shared
// memory), both K-major; ``accumulate`` 0 overwrites D.
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

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B over one k16 step at N = the B tile's rows (32, 64 or 128),
// both operands K-major in shared memory.
template <int N> struct SS;
template <> struct SS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    wgmma_ss_n32(d, a, b, accumulate);
  }
};
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

// D (64 x N) += A (64 x 16, registers, bf16) * B (16 x N, shared memory,
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

// D += A B at N = the instruction's width, A in registers.
template <int N> struct RS;
template <> struct RS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n16(d, a, b);
  }
};
template <> struct RS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n32(d, a, b);
  }
};
template <> struct RS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <> struct RS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};

// The accumulator registers of output columns [2 At, 2 At + 2 N): wgmma
// m64nNk16 keeps N / 2 a thread in column order, so the n64 product of a
// full block and the n16 one of the tail write disjoint ranges of one
// array laid out as a single m64nDk16 accumulator.
template <int At, int N, int M>
__device__ __forceinline__ float (&acc_part(float (&a)[M]))[N] {
  static_assert(At + N <= M, "accumulator range");
  return *reinterpret_cast<float(*)[N]>(a + At);
}

// acc (64 x D) += A (64 x 16, registers) * rows [16 ks, 16 ks + 16) of a
// Geo tile taken as the MN-major B operand (the tile's D columns as N): a
// product of the full blocks' width and one of the tail's, into disjoint
// ranges of one accumulator; at D = 256 the full blocks as two n128
// halves.
template <typename Geo, int M>
__device__ __forceinline__ void mma_rows(float (&acc)[M],
                                         const uint32_t (&a)[4],
                                         uint32_t tile, int ks) {
  if constexpr (Geo::kFull == 4) {
    RS<128>::mma(acc_part<0, 64>(acc), a, Geo::mn_full_desc(tile, ks, 0));
    RS<128>::mma(acc_part<64, 64>(acc), a, Geo::mn_full_desc(tile, ks, 2));
  } else if constexpr (Geo::kFull > 0) {
    RS<64 * Geo::kFull>::mma(acc_part<0, 32 * Geo::kFull>(acc), a,
                             Geo::mn_full_desc(tile, ks));
  }
  if constexpr (Geo::kTail > 0)
    RS<Geo::kTail>::mma(acc_part<32 * Geo::kFull, Geo::kTail / 2>(acc), a,
                        Geo::mn_tail_desc(tile, ks));
}

// One tile, Geo::kRows rows of one head from ``row``, into shared memory
// at ``dst``: a box for each full block and one for the tail, all
// completing on ``bar``.  The tile's columns start at ``col0`` of the
// tensor's rows (a column slice of a wider head: its Geo is the slice's
// width, its maps' boxes that width's blocks).
template <typename Geo>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const CUtensorMap* full,
                                          const CUtensorMap* tail,
                                          uint32_t bar, int head, int row,
                                          int b, int col0 = 0) {
#pragma unroll
  for (int c = 0; c < Geo::kFull; ++c)
    tma_load_4d(dst + c * Geo::kFullBytes, full, bar, col0 + 64 * c, head,
                row, b);
  if (Geo::kTail > 0)
    tma_load_4d(dst + Geo::kTailOffset, tail, bar, col0 + 64 * Geo::kFull,
                head, row, b);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
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
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int T,
                     int heads, int D, int cols, int rows) {
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

// Make the current device's primary context current on the calling
// thread.  The tensor-map encoder (cuTensorMapEncodeTiled) needs one; a host
// thread whose first CUDA work this is (autograd's backward thread, when
// the kernels' attributes were set on another) has none until a runtime
// call binds it, which cudaSetDevice does since CUDA 12.  A launch calls it
// once, before its first make_maps.
inline bool bind_context() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess &&
         cudaSetDevice(dev) == cudaSuccess;
}

// The maps of one tensor: over its full 64-column blocks and over its
// tail (left zeroed where D has none), boxes of ``rows`` rows.  ``width``
// is the tensor's row (D unless the tiles are D-column slices of wider
// rows, which load_tile's ``col0`` places).
template <int D>
bool make_maps(CUtensorMap* full, CUtensorMap* tail, const void* ptr, int B,
               int T, int heads, int rows, int width = D) {
  if (D / 64 > 0 && !make_map(full, ptr, B, T, heads, width, 64, rows))
    return false;
  if (D % 64 > 0 && !make_map(tail, ptr, B, T, heads, width, D % 64, rows))
    return false;
  return true;
}

inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace sm90
