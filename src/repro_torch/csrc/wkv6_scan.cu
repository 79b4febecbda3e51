// The RWKV-6 ("Finch") WKV recurrence for Hopper (sm_90a).  A plain C
// interface, loaded with ctypes by repro_torch/kernels/rwkv6_scan.py; the
// entry point returns cudaGetLastError() after its launch and never
// synchronizes.
//
// Replaces the Pallas kernel repro/kernels/rwkv6_scan.py::_kernel (:25),
// called by wkv6_pallas (:67).  Per (b, h) stream, with an (N, N) fp32
// state s (rows i index k, columns j index v):
//
//     y_t[j] = sum_i r_t[i] (s[i][j] + u[i] k_t[i] v_t[j])
//     s[i][j] <- w_t[i] s[i][j] + k_t[i] v_t[j]
//
// The TPU grid ran one program per (b, h) and walked T in chunks with
// the state resident in VMEM.  Here one block of N threads owns one
// (b, h) stream and thread j keeps column j of the state in registers for
// the whole sequence, so the state never leaves the SM between steps.
// Each chunk of up to 32 steps of r, k, v and w is staged in shared
// memory with coalesced loads (thread j reads element j of each row);
// every thread then reads r_t[i], k_t[i], w_t[i] and u[i] as shared-memory
// broadcasts.  Any T >= 1 (T = 1 is a decode step) and no divisibility by
// the chunk.  s0 comes in and s_T goes out in fp32.
//
// Types: r, k and v in float32 or bfloat16 (the model's compute dtype),
// w, u and s0 in float32; y is float32, as the reference's oracle
// wkv6_scan_ref returns it and as the time mix casts it right after.  (The
// Pallas kernel writes y in r's dtype instead.)  N is 16, 32 or 64.
//
// What bounds it: neither side by much.  A step needs at least 5 N^2
// flops (y = r^T s + (r . u k) v: 2 N^2; the state update: 3 N^2) on
// 14 N bytes in bf16 (r, k, v in bf16, w in and y out in fp32), 23 flops
// a byte at N = 64 against the fp32 ridge of 20 (67 TFLOP/s without
// tensor cores over 3.35 TB/s): the fp32 rate bounds a bf16 call and the
// bytes an fp32 one, each with the other close behind.  This kernel runs
// the steps of a stream in order on one block: B * H blocks (160 for
// rwkv6-3b at batch 4) leave most of each SM idle, and its time is the
// step latency times T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;   // steps staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int T_len,
            int H) {
  __shared__ float r_s[kChunk][N], k_s[kChunk][N], v_s[kChunk][N],
      w_s[kChunk][N];
  __shared__ float u_s[N];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;

  float s[N];   // column j of the state: s[i] = state[i][j]
  const float* s_in = s0 + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s_in[i * N + j];
  u_s[j] = u[h * N + j];

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = min(kChunk, T_len - t0);
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

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B,
           int T_len, int H, cudaStream_t stream) {
  wkv6_kernel<T, N><<<B * H, N, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, y, sT, T_len, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const void* r, const void* k, const void* v, const float* w,
               const float* u, const float* s0, float* y, float* sT, int B,
               int T_len, int H, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, sT, B, T_len, H, s);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, sT, B, T_len, H, s);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, sT, B, T_len, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v: (B, T, H, N) of one dtype (0: float32, 1: bfloat16); w:
// (B, T, H, N) float32; u: (H, N) float32; s0: (B, H, N, N) float32;
// y: (B, T, H, N) float32; sT: (B, H, N, N) float32.  All contiguous.
// Returns a cudaError_t.
int wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* sT, int B,
             int T_len, int H, int N, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (T_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_n<float>(r, k, v, w, u, s0, y, sT, B, T_len, H, N, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, T_len, H,
                                     N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
