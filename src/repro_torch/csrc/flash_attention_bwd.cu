// Backward flash attention for Hopper (sm_90a): the gradients (dq, dk, dv)
// of o = softmax(q k^T / sqrt(D) + mask) v for the forward kernels of
// flash_attention.cu (causal, sliding window or bidirectional with any Tq
// and Tk; grouped-query heads, query head h reading KV head h / R).  A
// plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py; the entry point returns
// cudaGetLastError() after its launches and never synchronizes.
//
// Replaces what XLA's autodiff derives from the reference's chunked jnp
// attention (repro/models/layers.py::sdpa, :132) inside the train step's
// jax.value_and_grad (repro/train/train_loop.py:53): the reference's
// training reaches no Pallas kernel, and this is the gradient of the port's
// forward kernel (the counterpart of repro/kernels/flash_attention.py:28).
//
// Three kernels, launched in stream order by one call:
//
// bwd_stats: one block a (b, query head, tile of query rows).  It walks
//   the keys once and keeps each row's running max m and sum l of
//   exp(s - m), as the forward does, and writes m, 1 / max(l, 1e-30) and
//   delta = rowsum(dO * O) to fp32 scratch (B, H, Tq).  Keeping m and 1/l
//   apart, not m + log l, keeps a fully masked row exact: its scores are
//   all -1e30, so its softmax is uniform, 1 / Tk, which m + log l cannot
//   hold beside -1e30 in fp32.
// bwd_dq: one block a (b, query head, tile of query rows), looping over
//   key tiles: S = Q K^T / sqrt(D), P = exp(S - m) / l, dP = dO V^T,
//   dS = P * (dP - delta) (0 where masked), dQ += dS K / sqrt(D).
// bwd_dkdv: one block a (b, KV head, tile of keys).  It loops over the R
//   query heads of its group and over the query tiles that can see its
//   keys: dV += P^T dO, dK += dS^T Q / sqrt(D).  Each block owns its
//   output rows, so there are no atomics, and the sums run in a fixed
//   order: the result is deterministic.
//
// All three stage fp32 tiles in shared memory (rows padded to D + 1
// floats, so the 16 threads of a row group read 16 banks) and run scalar
// fp32 FMAs, as the forward's scalar kernel does: thread (ty, tx) of 256
// owns rows ty + 16 i of its tile and columns tx + 16 j of the loop tile,
// and output columns tx + 16 c.  Tiles are 64 x 64 up to D = 160 and
// 32 x 32 at D = 256 (shared memory: 4 fp32 tiles of D + 1 columns).
//
// What bounds it on the card: operations.  At qwen3-1.7b's training shape
// (B = 4, T = 1,024, H = 16, G = 8, D = 128, causal) the backward does five
// products of 2 B H Tq Tk D, halved for causal: 4.3e10 flops, 0.0434 ms
// at 989 TFLOP/s bf16 on the tensor cores, against 1.0e8 bytes moved
// (q, k, v, o, dO read once, dq, dk, dv written once: 0.030 ms at 3.35
// TB/s).  Scalar fp32 FMAs reach at most 67 TFLOP/s, and this kernel
// recomputes S and dP in two kernels, so it runs far above that bound:
// it is the simple, right first version, and wgmma with TMA is later
// work.
//
// Arithmetic, as the plain version (attention_bwd_ref): scores in fp32
// from q scaled by 1/sqrt(D); masked scores are -1e30 exactly and get
// dS = 0; keys past Tk and rows past Tq take no part; the gradients are
// accumulated in fp32 and written in the inputs' dtype.  Tiles wholly
// above the causal diagonal are skipped, and so are tiles wholly below a
// causal window (no causal row is fully masked: it sees its diagonal).  A
// bidirectional call with a window can leave a row fully masked (Tq > Tk),
// so there the stats and dK/dV walk every tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

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

// The tile edge: rows of a block's own tile and of its loop tile.
template <int D>
constexpr int kTile = D > 160 ? 32 : 64;

struct Shape {
  int Tq, Tk, H, G, causal, window;
  float scale;
};

__device__ __forceinline__ bool allowed(const Shape& s, int qp, int kp) {
  bool ok = true;
  if (s.causal) ok = qp >= kp;
  if (s.window > 0) ok = ok && (qp - kp) < s.window;
  return ok;
}

// rows [t0, t0 + N) of a (B, T, heads, D) tensor at (b, head) into an fp32
// tile of row stride D + 1, times mul; rows past T are zero
template <typename T, int D, int N>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int T_, int heads, int head,
                                      int t0, float mul) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < N * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    float x = 0.f;
    if (t < T_)
      x = to_f32(src[(((size_t)b * T_ + t) * heads + head) * D + d]) * mul;
    dst[r * DP + d] = x;
  }
}

// acc[i][j] = sum_d a[(ty + 16 i)][d] * b[(tx + 16 j)][d] over tiles of row
// stride D + 1
template <int D, int RM, int RN>
__device__ __forceinline__ void dot_tile(float (&acc)[RM][RN], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// --- bwd_stats ------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_stats(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ m_out, float* __restrict__ il_out,
          float* __restrict__ delta_out, Shape s) {
  constexpr int BT = kTile<D>, DP = D + 1, R4 = BT / 16, CPT = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;              // BT x DP, scaled
  float* k_s = q_s + BT * DP;     // BT x DP
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (s.H / s.G);
  stage<T, D, BT>(q_s, q, b, s.Tq, s.H, h, q0, s.scale);

  // delta = rowsum(dO * O): the 16 threads of a row group split D
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int t = q0 + ty + 16 * i;
    float acc = 0.f;
    if (t < s.Tq) {
      const size_t base = (((size_t)b * s.Tq + t) * s.H + h) * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc = fmaf(to_f32(dout[base + tx + 16 * c]),
                   to_f32(o[base + tx + 16 * c]), acc);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (tx == 0 && t < s.Tq)
      delta_out[((size_t)b * s.H + h) * s.Tq + t] = acc;
  }

  float m[R4], l[R4];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int nk = (s.Tk + BT - 1) / BT;
  const int hi = s.causal ? min((q0 + BT + BT - 1) / BT, nk) : nk;
  const int lo = (s.causal && s.window > 0) ? max(0, q0 - s.window) / BT : 0;
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * BT;
    __syncthreads();
    stage<T, D, BT>(k_s, k, b, s.Tk, s.G, g, k0, 1.f);
    __syncthreads();
    float sc[R4][R4];
    dot_tile<D, R4, R4>(sc, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < R4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= s.Tk || !allowed(s, qp, kp)) sc[i][j] = kNegInf;
        mb = fmaxf(mb, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float mn = fmaxf(m[i], mb);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < R4; ++j)
        if (k0 + tx + 16 * j < s.Tk) ps += expf(sc[i][j] - mn);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * expf(m[i] - mn) + ps;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (tx == 0 && t < s.Tq) {
      const size_t at = ((size_t)b * s.H + h) * s.Tq + t;
      m_out[at] = m[i];
      il_out[at] = 1.f / fmaxf(l[i], 1e-30f);
    }
  }
}

// P and dS of one (row, column) pair: p_out, ds_out; rows past Tq and keys
// past Tk give 0
__device__ __forceinline__ void p_ds(const Shape& s, int qp, int kp,
                                     float score, float dp, float m,
                                     float il, float delta, float& p_out,
                                     float& ds_out) {
  if (qp >= s.Tq || kp >= s.Tk) {
    p_out = 0.f;
    ds_out = 0.f;
    return;
  }
  const bool ok = allowed(s, qp, kp);
  const float p = expf((ok ? score : kNegInf) - m) * il;
  p_out = p;
  ds_out = ok ? p * (dp - delta) : 0.f;
}

// --- bwd_dq ----------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ m_in, const float* __restrict__ il_in,
       const float* __restrict__ delta_in, T* __restrict__ dq, Shape s) {
  constexpr int BT = kTile<D>, DP = D + 1, R4 = BT / 16, CPT = D / 16;
  constexpr int SP = BT + 1;
  extern __shared__ float smem[];
  float* q_s = smem;              // BT x DP, scaled
  float* do_s = q_s + BT * DP;    // BT x DP
  float* k_s = do_s + BT * DP;    // BT x DP
  float* v_s = k_s + BT * DP;     // BT x DP
  float* ds_s = v_s + BT * DP;    // BT x SP
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (s.H / s.G);
  stage<T, D, BT>(q_s, q, b, s.Tq, s.H, h, q0, s.scale);
  stage<T, D, BT>(do_s, dout, b, s.Tq, s.H, h, q0, 1.f);

  float m[R4], il[R4], dl[R4];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int t = q0 + ty + 16 * i;
    const size_t at = ((size_t)b * s.H + h) * s.Tq + t;
    m[i] = t < s.Tq ? m_in[at] : 0.f;
    il[i] = t < s.Tq ? il_in[at] : 0.f;
    dl[i] = t < s.Tq ? delta_in[at] : 0.f;
  }
  float acc[R4][CPT];
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // dS is 0 on masked scores, so every tile wholly masked for the tile's
  // rows is skipped, bidirectional windows included
  const int nk = (s.Tk + BT - 1) / BT;
  const int hi = s.causal ? min((q0 + BT + BT - 1) / BT, nk) : nk;
  const int lo = s.window > 0 ? max(0, q0 - s.window) / BT : 0;
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * BT;
    __syncthreads();   // the last tile's K and dS reads are done
    stage<T, D, BT>(k_s, k, b, s.Tk, s.G, g, k0, 1.f);
    stage<T, D, BT>(v_s, v, b, s.Tk, s.G, g, k0, 1.f);
    __syncthreads();
    float sc[R4][R4], dp[R4][R4];
    dot_tile<D, R4, R4>(sc, q_s, k_s, ty, tx);
    dot_tile<D, R4, R4>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < R4; ++i)
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        float p, ds;
        p_ds(s, q0 + ty + 16 * i, k0 + tx + 16 * j, sc[i][j], dp[i][j],
             m[i], il[i], dl[i], p, ds);
        ds_s[(ty + 16 * i) * SP + tx + 16 * j] = ds;
      }
    __syncthreads();   // dS is whole
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float kb[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kb[c] = k_s[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        const float ds = ds_s[(ty + 16 * i) * SP + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(ds, kb[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= s.Tq) continue;
    T* out = dq + (((size_t)b * s.Tq + t) * s.H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      out[tx + 16 * c] = from_f32<T>(acc[i][c] * s.scale);
  }
}

// --- bwd_dkdv --------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ m_in, const float* __restrict__ il_in,
         const float* __restrict__ delta_in, T* __restrict__ dk,
         T* __restrict__ dv, Shape s) {
  constexpr int BT = kTile<D>, DP = D + 1, R4 = BT / 16, CPT = D / 16;
  constexpr int SP = BT + 1;
  extern __shared__ float smem[];
  float* k_s = smem;              // BT x DP: this block's keys
  float* v_s = k_s + BT * DP;     // BT x DP
  float* q_s = v_s + BT * DP;     // BT x DP, scaled: the loop's query rows
  float* do_s = q_s + BT * DP;    // BT x DP
  float* pt_s = do_s + BT * DP;   // BT x SP: P^T (key row, query column)
  float* dst_s = pt_s + BT * SP;  // BT x SP: dS^T
  float* st_s = dst_s + BT * SP;  // 3 x BT: m, 1/l, delta of the loop rows
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BT, g = blockIdx.y, b = blockIdx.z;
  const int R = s.H / s.G;
  stage<T, D, BT>(k_s, k, b, s.Tk, s.G, g, k0, 1.f);
  stage<T, D, BT>(v_s, v, b, s.Tk, s.G, g, k0, 1.f);

  float ak[R4][CPT], av[R4][CPT];
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      ak[i][c] = 0.f;
      av[i][c] = 0.f;
    }

  // the query tiles that can see these keys: from the diagonal down
  // (causal), up to the window's reach (causal window); a bidirectional
  // window walks every tile, since its fully masked rows spread P = 1/Tk
  // over every key
  const int nq = (s.Tq + BT - 1) / BT;
  const int qlo = s.causal ? k0 / BT : 0;
  const int qhi = (s.causal && s.window > 0)
                      ? min(nq, (k0 + BT - 1 + s.window + BT - 1) / BT)
                      : nq;
  for (int r = 0; r < R; ++r) {
    const int h = g * R + r;
    for (int it = qlo; it < qhi; ++it) {
      const int q0 = it * BT;
      __syncthreads();   // the last tile's Q, dO, P^T and dS^T reads are done
      stage<T, D, BT>(q_s, q, b, s.Tq, s.H, h, q0, s.scale);
      stage<T, D, BT>(do_s, dout, b, s.Tq, s.H, h, q0, 1.f);
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        const int t = q0 + i;
        const size_t at = ((size_t)b * s.H + h) * s.Tq + t;
        st_s[i] = t < s.Tq ? m_in[at] : 0.f;
        st_s[BT + i] = t < s.Tq ? il_in[at] : 0.f;
        st_s[2 * BT + i] = t < s.Tq ? delta_in[at] : 0.f;
      }
      __syncthreads();
      float sc[R4][R4], dp[R4][R4];
      dot_tile<D, R4, R4>(sc, k_s, q_s, ty, tx);    // S^T
      dot_tile<D, R4, R4>(dp, v_s, do_s, ty, tx);   // dP^T
#pragma unroll
      for (int i = 0; i < R4; ++i)
#pragma unroll
        for (int j = 0; j < R4; ++j) {
          const int qc = tx + 16 * j;
          float p, ds;
          p_ds(s, q0 + qc, k0 + ty + 16 * i, sc[i][j], dp[i][j], st_s[qc],
               st_s[BT + qc], st_s[2 * BT + qc], p, ds);
          pt_s[(ty + 16 * i) * SP + qc] = p;
          dst_s[(ty + 16 * i) * SP + qc] = ds;
        }
      __syncthreads();   // P^T and dS^T are whole
#pragma unroll 4
      for (int qq = 0; qq < BT; ++qq) {
        float ob[CPT], qb[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          ob[c] = do_s[qq * DP + tx + 16 * c];
          qb[c] = q_s[qq * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < R4; ++i) {
          const float p = pt_s[(ty + 16 * i) * SP + qq];
          const float ds = dst_s[(ty + 16 * i) * SP + qq];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            av[i][c] = fmaf(p, ob[c], av[i][c]);
            ak[i][c] = fmaf(ds, qb[c], ak[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= s.Tk) continue;
    const size_t base = (((size_t)b * s.Tk + t) * s.G + g) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[base + tx + 16 * c] = from_f32<T>(ak[i][c]);
      dv[base + tx + 16 * c] = from_f32<T>(av[i][c]);
    }
  }
}

template <int D>
constexpr size_t stats_bytes() {
  return sizeof(float) * 2 * kTile<D> * (D + 1);
}
template <int D>
constexpr size_t dq_bytes() {
  return sizeof(float) * (4 * kTile<D> * (D + 1) +
                          kTile<D> * (kTile<D> + 1));
}
template <int D>
constexpr size_t dkdv_bytes() {
  return sizeof(float) * (4 * kTile<D> * (D + 1) +
                          2 * kTile<D> * (kTile<D> + 1) + 3 * kTile<D>);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* m,
           float* il, float* delta, int B, const Shape& s,
           cudaStream_t stream) {
  constexpr int BT = kTile<D>;
  static std::atomic<bool> done_st[kDevices], done_dq[kDevices],
      done_kv[kDevices];
  cudaError_t err = allow_smem(bwd_stats<T, D>, (int)stats_bytes<D>(),
                               done_st);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dq<T, D>, (int)dq_bytes<D>(), done_dq);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dkdv<T, D>, (int)dkdv_bytes<D>(), done_kv);
  if (err != cudaSuccess) return (int)err;
  const dim3 qgrid((s.Tq + BT - 1) / BT, s.H, B);
  const dim3 kgrid((s.Tk + BT - 1) / BT, s.G, B);
  bwd_stats<T, D><<<qgrid, kThreads, stats_bytes<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)o, (const T*)dout, m, il, delta, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq<T, D><<<qgrid, kThreads, dq_bytes<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, il, delta,
      (T*)dq, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv<T, D><<<kgrid, kThreads, dkdv_bytes<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, il, delta,
      (T*)dk, (T*)dv, s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* m,
               float* il, float* delta, int B, int D, const Shape& s,
               cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, m, il, delta, B, s, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, m, il, delta, B, s, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, m, il, delta, B, s, st);
    case 80: return launch<T, 80>(q, k, v, o, dout, dq, dk, dv, m, il, delta, B, s, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, m, il, delta, B, s, st);
    case 160: return launch<T, 160>(q, k, v, o, dout, dq, dk, dv, m, il, delta, B, s, st);
    case 256: return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, m, il, delta, B, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq: (B, Tq, H, D); k, v, dk, dv: (B, Tk, G, D), all
// contiguous and of one dtype (0: float32, 1: bfloat16); m, il, delta:
// fp32 scratch of B * H * Tq floats each.  window <= 0 means no window.
// Launches the three kernels on `stream`.  Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, float* m, float* il, float* delta, int B,
                        int Tq, int Tk, int H, int G, int D, int causal,
                        int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  const Shape s{Tq, Tk, H, G, causal, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, dout, dq, dk, dv, m, il, delta, B,
                             D, s, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, m, il,
                                     delta, B, D, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
