// Forward flash attention for Hopper (sm_90a): causal, sliding window or
// bidirectional, with grouped-query heads.  A plain C interface, loaded
// with ctypes by repro_torch/kernels/flash_attention.py; the entry point
// returns cudaGetLastError() after its launch and never synchronizes.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::_kernel
// (:28), called by flash_attention_pallas (:85).  The TPU grid (B, H,
// Tq/bq) ran in order on one core and looped over the visible KV blocks
// with a fori_loop; here one block owns one (b, query head, 64-row q
// tile), the blocks run in parallel, and a loop inside the block walks
// the 64-key tiles the q tile can see in the reference's order: from the
// window's lower tile (max(0, q0 - window) / 64) up to the causal upper
// tile.  Query head h reads KV head h / R (R = H / G).
//
// Arithmetic, as the reference: q is scaled by 1/sqrt(D) in fp32, the
// scores, the running max m, the running sum l and the accumulator stay
// in fp32, masked scores are -1e30 exactly (never -inf), and the output
// is acc / max(l, 1e-30) rounded to q's dtype (bf16 or fp32).  A row
// whose first visited tile is wholly masked takes p = 1 on the masked
// keys until the first real score rescales them by exp(-1e30 - m) = 0;
// every row sees its own diagonal key in a later tile of the same walk,
// so the result equals the full softmax of the reference oracle.  Ragged
// edges are masked here (any Tq and Tk): keys past Tk load as zeros and
// score -1e30, and rows past Tq are never written.
//
// What bounds it: operations.  A causal call does 4 * B * H * D * Tq *
// (Tq + 1) / 2 flops on (B Tq H D + 2 B Tk G D) inputs, far above the
// card's ridge; at 989 TFLOP/s bf16 a 4 x 1024-token prefill of
// qwen3-1.7b (H = 16, D = 128) is a 0.017 ms floor per layer.  This
// first kernel is simple rather than fast: the Q, K and V tiles are
// staged in shared memory as fp32 and both products run as scalar FMAs
// from shared memory (4 x 4 scores and 4 x D/16 outputs per thread), no
// tensor cores.  Shared memory rows of Q and K are padded to D + 1 floats
// so that the 16 threads of a row group read 16 different banks.
// wgmma/TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBKV = 64;         // keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty owns rows, tx owns columns
constexpr int kPS = kBKV + 1;    // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
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
  static bool configured = false;   // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
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
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, Tq, H, D); k, v: (B, Tk, G, D); o: (B, Tq, H, D), all
// contiguous and of one dtype (0: float32, 1: bfloat16).  window <= 0
// means no window.  Returns a cudaError_t.
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

}  // extern "C"
