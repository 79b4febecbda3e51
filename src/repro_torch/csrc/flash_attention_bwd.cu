// Backward flash attention for Hopper (sm_90a): the gradients (dq, dk, dv)
// of o = softmax(q k^T / sqrt(D) + mask) v for the forward kernels of
// flash_attention.cu (causal, sliding window or bidirectional with any Tq
// and Tk; grouped-query heads, query head h reading KV head h / R).  A
// plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py; each entry point returns
// cudaGetLastError() after its launches and never synchronizes.
//
// Replaces what XLA's autodiff derives from the reference's chunked jnp
// attention (repro/models/layers.py::sdpa, :132) inside the train step's
// jax.value_and_grad (repro/train/train_loop.py:53): the reference's
// training reaches no Pallas kernel, and this is the gradient of the port's
// forward kernel (the counterpart of repro/kernels/flash_attention.py:28).
//
// What bounds it on the card: operations.  At qwen3-1.7b's training shape
// (B = 4, T = 1,024, H = 16, G = 8, D = 128, causal) the backward's five
// products of 2 B H Tq Tk D, halved for causal, are 4.3e10 flops: 0.0434
// ms at 989 TFLOP/s bf16, against 1.0e8 bytes moved (q, k, v, o, dO read
// once, dq, dk, dv written once: 0.030 ms at 3.35 TB/s).  Only wgmma
// reaches that rate.  Two variants, chosen by the wrapper from the dtype
// and the head size alone (bwd_variant):
//
// flash_attention_bwd_sm90 (bf16, D in {16, 32, 64, 80, 128}): three
//   passes on the tensor cores, each a grid of one-warpgroup blocks (128
//   threads, two or more a block an SM) on 64-row tiles, fed by TMA from
//   4-d tensor maps over the tensors' own (B, T, heads, D) layouts (GQA
//   is a coordinate, the out-of-bounds fill gives the rows past Tq and
//   Tk), the tiles cut into swizzled column blocks as the forward's
//   (sm90.cuh's TileGeo).  A block's thread 0 issues the loads of a
//   two-stage ring, refilling a stage once every warp's products have
//   read it.
//   - bwd_stats_tc: the row statistics, a block a (b, query head, query
//     tile): S = Q K^T on wgmma, the running max m and sum l of
//     2^(S log2(e) / sqrt(D) - m), and delta = rowsum(dO * O), written
//     as m, 1 / max(l, 1e-30) and delta to fp32 scratch (3, B H, Tq
//     rounded up to 64).  m and 1/l stay apart, not m + log l: a fully
//     masked row's scores are all -1e30, its softmax uniform, 1 / Tk,
//     which m + log l cannot hold beside -1e30 in fp32.
//   - bwd_dq_tc: a block a (b, query head, query tile), Q and dO resident,
//     K and V through the ring: S = Q K^T and dP = dO V^T from shared
//     memory, P and dS = P (dP - delta) in the accumulators' registers,
//     and dQ += dS K with dS the register A operand (rounded to bf16, as
//     the forward's P V takes P) and K the MN-major B operand.  The causal
//     work is dealt heaviest first (the last query tiles first).
//   - bwd_dkdv_tc: a block a (b, KV head, 64-key tile), K and V resident,
//     looping over the group's R query heads and the query tiles that can
//     see its keys, Q, dO and their statistics through the ring: S^T = K
//     Q^T and dP^T = V dO^T put P^T and dS^T in the accumulators' layout,
//     rows the keys, and dV += P^T dO, dK += dS^T Q take them as the A
//     operand with dO and Q the MN-major B operand: nothing is transposed
//     in memory.
//   Each block owns its output rows, so there are no atomics and every
//   sum runs in a fixed order: two calls give the same bits.  The two
//   passes recompute S and dP (8 products in all, 1.6 times the bound's
//   5); the bound counts the work, not this design's.  A block waits on
//   its products before the elementwise work that reads them; two or
//   more blocks an SM (232 registers a thread for dK/dV at D = 128: 64 +
//   64 fp32 accumulators, 32 + 32 of S^T and dP^T, the bf16 fragments of
//   P^T and dS^T; 157 for dQ, 58 for the statistics; no spills, and
//   ptxas reports no C7512 "wgmma serialized" warning) keep the tensor
//   cores fed while one of them is in its elementwise phase.  Two trials
//   ran slower and were not kept: S and dP split into two groups, to take
//   P while dP runs (it spills a few registers); and blocks of two
//   warpgroups owning 128 rows, which halves the loop tiles' traffic but
//   makes the groups wait on the same tiles in lockstep.  D = 160
//   and 256 are not taken: their dK and dV alone are 160 and 256 fp32 a
//   thread.
//
// flash_attention_bwd (fp32 at every D, bf16 at D = 160 and 256; bf16 at
//   the other sizes only by name, the yardstick): three scalar kernels.
//   bwd_stats, bwd_dq and bwd_dkdv have the same work split as the
//   tensor-core passes but stage fp32 tiles in shared memory (rows padded
//   to D + 1 floats, so the 16 threads of a row group read 16 banks) and
//   run scalar fp32 FMAs: thread (ty, tx) of 256 owns rows ty + 16 i of
//   its tile and columns tx + 16 j of the loop tile, and output columns
//   tx + 16 c.  Tiles are 64 x 64 up to D = 160 and 32 x 32 at D = 256.
//   Scalar FMAs reach at most 67 TFLOP/s.
//
// Arithmetic, as the plain version (attention_bwd_ref): scores in fp32
// from q scaled by 1/sqrt(D); masked scores are -1e30 exactly and get
// dS = 0; keys past Tk and rows past Tq take no part; the gradients are
// accumulated in fp32 and written in the inputs' dtype.  Tiles wholly
// above the causal diagonal are skipped, and so are tiles wholly below a
// window (dS is 0 there); a fully masked row (a bidirectional window, Tq
// > Tk) has dS = 0 and P = 1 / Tk on every key, so its statistics walk
// every key tile, and dK/dV walks every query tile of a bidirectional
// call.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

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

// --- the tensor-core kernels -------------------------------------------------

namespace tcb {

constexpr int kRows = 64;        // every tile: 64 queries or 64 keys (wgmma M)
constexpr int kThreads = 128;    // one warpgroup a block
constexpr int kStages = 2;       // depth of the ring a loop tile comes through
constexpr int kStatBytes = 3 * kRows * 4;   // m, 1/l, delta of a query tile
constexpr int kStatStride = 1024;           // their room a stage
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
using Geo = TileGeo<D, kRows>;

// The tensor maps of one call: Q, K, V and dO over their full 64-column
// blocks and their tails (left zeroed where D has none), boxes of 64 rows;
// and the row statistics, fp32 (3, B H, Tqp), boxes of 64 rows of all
// three.
struct Maps {
  CUtensorMap q, k, v, dout, q_tail, k_tail, v_tail, do_tail, stats;
};

struct Args {
  int B, Tq, Tk, H, G, causal, window, Tqp;
  float scale;
};

__device__ __forceinline__ bool allowed(const Args& a, int qp, int kp) {
  bool ok = true;
  if (a.causal) ok = qp >= kp;
  if (a.window > 0) ok = ok && (qp - kp) < a.window;
  return ok;
}

// Whether a tile pair (64 queries from q0, 64 keys from k0) has a score
// that is masked or lies past Tq or Tk.
__device__ __forceinline__ bool needs_mask(const Args& a, int q0, int k0) {
  return k0 + kRows > a.Tk || q0 + kRows > a.Tq ||
         (a.causal && k0 + kRows - 1 > q0) ||
         (a.window > 0 && q0 + kRows - 1 - k0 >= a.window);
}

// A query tile's work item: heaviest first under a causal mask (the last
// query tiles see the most keys), so the grid's tail is light.
struct QItem {
  int b, h, g, bh, q0, lo, n;
};

__device__ __forceinline__ QItem q_item(const Args& a, bool stats) {
  QItem w;
  const int BH = a.B * a.H, nqt = (a.Tq + kRows - 1) / kRows;
  const int j = blockIdx.x;
  w.bh = j % BH;
  w.h = w.bh % a.H;
  w.b = w.bh / a.H;
  w.g = w.h / (a.H / a.G);
  const int qt = nqt - 1 - j / BH;
  w.q0 = qt * kRows;
  const int nk = (a.Tk + kRows - 1) / kRows;
  const int hi = a.causal ? min(qt + 1, nk) : nk;
  // dS is 0 on every masked score, so dQ skips the tiles below the window;
  // the statistics of a row with no key in reach count every key
  const bool from_first = stats && !a.causal && a.window > 0 &&
                          min(w.q0 + kRows, a.Tq) >= a.Tk + a.window;
  w.lo = a.window > 0 && !from_first ? max(0, w.q0 - a.window) / kRows : 0;
  w.n = max(hi - w.lo, 0);
  return w;
}

// Per thread of the warpgroup: element 4 j + e of an m64nNk16 accumulator
// sits at row 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) +
// e % 2.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

// --- pass 1: the row statistics ---------------------------------------------
//
// One block a (b, query head, 64-row query tile): S = Q K^T on wgmma over
// the key tiles a row can see (K through a two-stage TMA ring), the
// running max m and sum l of 2^(S log2(e) / sqrt(D) - m) as the forward
// keeps them, keys past Tk left out of l; and delta = rowsum(dO * O) from
// plain 16-byte loads while the first tiles arrive.  Writes m (log2 units),
// 1 / max(l, 1e-30) and delta for all 64 rows (0 past Tq).
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_stats_tc(const __grid_constant__ Maps maps,
             const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ stats, Args a) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + Gm::kTileBytes;                 // [kStages]
  const uint32_t full_q = k_s + kStages * Gm::kTileBytes;
  const uint32_t full_k = full_q + 8;                        // [kStages]
  const QItem w = q_item(a, true);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full_k + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(full_q, Gm::kTileBytes);
    load_tile<Gm>(q_s, &maps.q, &maps.q_tail, full_q, w.h, w.q0, w.b);
    for (int i = 0; i < min(w.n, kStages); ++i) {
      mbar_expect_tx(full_k + 8 * i, Gm::kTileBytes);
      load_tile<Gm>(k_s + i * Gm::kTileBytes, &maps.k, &maps.k_tail,
                    full_k + 8 * i, w.g, (w.lo + i) * kRows, w.b);
    }
  }
  __syncthreads();

  {  // delta: two threads a row, D / 2 columns each, 8 bf16 a load
    const int r = threadIdx.x / 2, t = w.q0 + r;
    float acc = 0.f;
    if (t < a.Tq) {
      const size_t at = (((size_t)w.b * a.Tq + t) * a.H + w.h) * D +
                        (threadIdx.x % 2) * (D / 2);
      const uint4* po = reinterpret_cast<const uint4*>(o + at);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 x = po[c], y = pd[c];
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fx = __bfloat1622float2(x2[e]);
          const float2 fy = __bfloat1622float2(y2[e]);
          acc = fmaf(fx.x, fy.x, acc);
          acc = fmaf(fx.y, fy.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (threadIdx.x % 2 == 0)
      stats[((size_t)2 * a.B * a.H + w.bh) * a.Tqp + t] = acc;
  }

  const float scale2 = a.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(full_q, 0);
  for (int i = 0; i < w.n; ++i) {
    const int st = i % kStages, k0 = (w.lo + i) * kRows;
    const uint32_t kb = k_s + st * Gm::kTileBytes;
    mbar_wait(full_k + 8 * st, (i / kStages) & 1);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<64>::mma(s, Gm::k_desc(q_s, 0, ks), Gm::k_desc(kb, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    __syncthreads();   // every warp's product has read the stage
    if (threadIdx.x == 0 && i + kStages < w.n) {
      mbar_expect_tx(full_k + 8 * st, Gm::kTileBytes);
      load_tile<Gm>(kb, &maps.k, &maps.k_tail, full_k + 8 * st, w.g,
                    k0 + kStages * kRows, w.b);
    }
    const bool mask = needs_mask(a, w.q0, k0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = s[j] * scale2;
      if (mask) {
        const int qp = w.q0 + acc_row(j), kp = k0 + acc_col(j);
        if (!allowed(a, qp, kp)) x = kNegInf;
        if (kp >= a.Tk) x = neg_inf();   // no part, even in a keyless row
      }
      s[j] = x;
      mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], x);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float mn = fmaxf(m[e], mx[e]);
      l[e] *= ex2(m[e] - mn);
      m[e] = mn;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) l[(j / 2) % 2] += ex2(s[j] - m[(j / 2) % 2]);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const int r = acc_row(2 * e), t = w.q0 + r;
    if (threadIdx.x % 4 == 0) {
      const bool in = t < a.Tq;
      stats[(size_t)w.bh * a.Tqp + t] = in ? m[e] : 0.f;
      stats[((size_t)a.B * a.H + w.bh) * a.Tqp + t] =
          in ? 1.f / fmaxf(l[e], 1e-30f) : 0.f;
    }
  }
}

// P and dS of one score of a tile pair: p = 2^(x - m) / l with x the
// scaled score (-1e30 where masked), dS = p (dP - delta) and 0 where
// masked; 0 and 0 for a row past Tq or a key past Tk.
__device__ __forceinline__ void p_ds(const Args& a, bool mask, int qp, int kp,
                                     float score, float dp, float m, float il,
                                     float delta, float& p, float& ds) {
  const float scale2 = a.scale * kLog2e;
  if (!mask) {
    p = ex2(fmaf(score, scale2, -m)) * il;
    ds = p * (dp - delta);
    return;
  }
  if (qp >= a.Tq || kp >= a.Tk) {
    p = 0.f;
    ds = 0.f;
    return;
  }
  const bool ok = allowed(a, qp, kp);
  p = ex2((ok ? score * scale2 : kNegInf) - m) * il;
  ds = ok ? p * (dp - delta) : 0.f;
}

// --- pass 2: dQ ----------------------------------------------------------------
//
// One block a (b, query head, 64-row query tile), Q and dO resident, K and
// V through a two-stage TMA ring over the key tiles that hold an unmasked
// score: S = Q K^T and dP = dO V^T on wgmma from shared memory, P and dS
// in the accumulators' registers, and dQ += dS K with dS as the register A
// operand (bf16) and K the MN-major B operand.  The block owns its rows:
// no atomics, a fixed order.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_tc(const __grid_constant__ Maps maps,
          const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
          Args a) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + Gm::kTileBytes;
  const uint32_t k_s = do_s + Gm::kTileBytes;                // [kStages]
  const uint32_t v_s = k_s + kStages * Gm::kTileBytes;       // [kStages]
  const uint32_t full_q = v_s + kStages * Gm::kTileBytes;
  const uint32_t full_kv = full_q + 8;                       // [kStages]
  const QItem w = q_item(a, false);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(full_q, 2 * Gm::kTileBytes);
    load_tile<Gm>(q_s, &maps.q, &maps.q_tail, full_q, w.h, w.q0, w.b);
    load_tile<Gm>(do_s, &maps.dout, &maps.do_tail, full_q, w.h, w.q0, w.b);
    for (int i = 0; i < min(w.n, kStages); ++i) {
      const int k0 = (w.lo + i) * kRows;
      mbar_expect_tx(full_kv + 8 * i, 2 * Gm::kTileBytes);
      load_tile<Gm>(k_s + i * Gm::kTileBytes, &maps.k, &maps.k_tail,
                    full_kv + 8 * i, w.g, k0, w.b);
      load_tile<Gm>(v_s + i * Gm::kTileBytes, &maps.v, &maps.v_tail,
                    full_kv + 8 * i, w.g, k0, w.b);
    }
  }
  __syncthreads();

  float m[2], il[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const size_t at = (size_t)w.bh * a.Tqp + w.q0 + acc_row(2 * e);
    const size_t plane = (size_t)a.B * a.H * a.Tqp;
    m[e] = stats[at];
    il[e] = stats[plane + at];
    dl[e] = stats[2 * plane + at];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(full_q, 0);
  for (int i = 0; i < w.n; ++i) {
    const int st = i % kStages, k0 = (w.lo + i) * kRows;
    const uint32_t kb = k_s + st * Gm::kTileBytes;
    const uint32_t vb = v_s + st * Gm::kTileBytes;
    mbar_wait(full_kv + 8 * st, (i / kStages) & 1);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<64>::mma(s, Gm::k_desc(q_s, 0, ks), Gm::k_desc(kb, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<64>::mma(dp, Gm::k_desc(do_s, 0, ks), Gm::k_desc(vb, 0, ks),
                  ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool mask = needs_mask(a, w.q0, k0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int e = (j / 2) % 2;
      float p;
      p_ds(a, mask, w.q0 + acc_row(j), k0 + acc_col(j), s[j], dp[j], m[e],
           il[e], dl[e], p, dp[j]);
    }
    uint32_t da[4][4];
    to_frags<64>(dp, da);
    fence_regs(acc);
    fence_frags(da);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rows<Gm>(acc, da[ks], kb, ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(da);
    __syncthreads();   // every warp's products have read the stage
    if (threadIdx.x == 0 && i + kStages < w.n) {
      const int kn = k0 + kStages * kRows;
      mbar_expect_tx(full_kv + 8 * st, 2 * Gm::kTileBytes);
      load_tile<Gm>(kb, &maps.k, &maps.k_tail, full_kv + 8 * st, w.g, kn,
                    w.b);
      load_tile<Gm>(vb, &maps.v, &maps.v_tail, full_kv + 8 * st, w.g, kn,
                    w.b);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = w.q0 + acc_row(2 * e);
    if (t >= a.Tq) continue;
    __nv_bfloat16* out = dq + (((size_t)w.b * a.Tq + t) * a.H + w.h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(out + acc_col(4 * jj)) =
          pack_bf16(acc[4 * jj + 2 * e] * a.scale,
                    acc[4 * jj + 2 * e + 1] * a.scale);
  }
}

// --- pass 3: dK and dV -----------------------------------------------------------
//
// One block a (b, KV head, 64-key tile), K and V resident, looping over
// the group's R query heads and the query tiles that can see its keys
// (the causal and window bounds of bwd_dkdv); Q, dO and the tile's row
// statistics come through a two-stage TMA ring.  S^T = K Q^T and dP^T =
// V dO^T on wgmma from shared memory put P^T and dS^T = P^T (dP^T -
// delta) in the accumulators' layout, rows the keys; dV += P^T dO and dK
// += dS^T Q take them as the register A operand (bf16) with dO and Q the
// MN-major B operand, so nothing is transposed in memory.  The block owns
// its key rows: no atomics, a fixed order.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_tc(const __grid_constant__ Maps maps,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            Args a) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + Gm::kTileBytes;
  const uint32_t q_s = v_s + Gm::kTileBytes;                 // [kStages]
  const uint32_t do_s = q_s + kStages * Gm::kTileBytes;      // [kStages]
  const uint32_t st_s = do_s + kStages * Gm::kTileBytes;     // [kStages]
  const uint32_t full_kv = st_s + kStages * kStatStride;
  const uint32_t full = full_kv + 8;                         // [kStages]
  const float* st_g = reinterpret_cast<const float*>(smem_raw + (st_s - raw));

  const int BG = a.B * a.G, R = a.H / a.G;
  const int bg = blockIdx.x % BG, kt = blockIdx.x / BG;   // heaviest first
  const int g = bg % a.G, b = bg / a.G, k0 = kt * kRows;
  const int nq = (a.Tq + kRows - 1) / kRows;
  const int qlo = a.causal ? kt : 0;
  const int qhi = (a.causal && a.window > 0)
                      ? min(nq, (k0 + kRows - 1 + a.window + kRows - 1) / kRows)
                      : nq;
  const int per = max(qhi - qlo, 0), n = R * per;
  // iteration i: query head g R + i / per, query tile qlo + i % per
  auto load = [&](int i, int st) {
    const int h = g * R + i / per, q0 = (qlo + i % per) * kRows;
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, 2 * Gm::kTileBytes + kStatBytes);
    load_tile<Gm>(q_s + st * Gm::kTileBytes, &maps.q, &maps.q_tail, bar, h,
                  q0, b);
    load_tile<Gm>(do_s + st * Gm::kTileBytes, &maps.dout, &maps.do_tail, bar,
                  h, q0, b);
    tma_load_3d(st_s + st * kStatStride, &maps.stats, bar, q0, b * a.H + h,
                0);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(full_kv, 2 * Gm::kTileBytes);
    load_tile<Gm>(k_s, &maps.k, &maps.k_tail, full_kv, g, k0, b);
    load_tile<Gm>(v_s, &maps.v, &maps.v_tail, full_kv, g, k0, b);
    for (int i = 0; i < min(n, kStages); ++i) load(i, i);
  }
  __syncthreads();

  float ak[D / 2], av[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    ak[i] = 0.f;
    av[i] = 0.f;
  }
  mbar_wait(full_kv, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages, q0 = (qlo + i % per) * kRows;
    const uint32_t qb = q_s + st * Gm::kTileBytes;
    const uint32_t dob = do_s + st * Gm::kTileBytes;
    const float* sm = st_g + st * (kStatStride / 4);   // m, 1/l, delta
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<64>::mma(s, Gm::k_desc(k_s, 0, ks), Gm::k_desc(qb, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<64>::mma(dp, Gm::k_desc(v_s, 0, ks), Gm::k_desc(dob, 0, ks),
                  ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool mask = needs_mask(a, q0, k0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {   // rows the keys, columns the queries
      const int c = acc_col(j);
      p_ds(a, mask, q0 + c, k0 + acc_row(j), s[j], dp[j], sm[c],
           sm[kRows + c], sm[2 * kRows + c], s[j], dp[j]);
    }
    uint32_t pa[4][4], da[4][4];
    to_frags<64>(s, pa);
    to_frags<64>(dp, da);
    fence_regs(av);
    fence_regs(ak);
    fence_frags(pa);
    fence_frags(da);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rows<Gm>(av, pa[ks], dob, ks);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rows<Gm>(ak, da[ks], qb, ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(av);
    fence_regs(ak);
    fence_frags(pa);
    fence_frags(da);
    __syncthreads();   // every warp's products have read the stage
    if (threadIdx.x == 0 && i + kStages < n) load(i + kStages, st);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = k0 + acc_row(2 * e);
    if (t >= a.Tk) continue;
    const size_t row = (((size_t)b * a.Tk + t) * a.G + g) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = acc_col(4 * jj);
      *reinterpret_cast<uint32_t*>(dk + row + c) =
          pack_bf16(ak[4 * jj + 2 * e] * a.scale,
                    ak[4 * jj + 2 * e + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dv + row + c) =
          pack_bf16(av[4 * jj + 2 * e], av[4 * jj + 2 * e + 1]);
    }
  }
}

// Shared memory of each pass, with slack to align the tiles to 1024 bytes.
template <int D>
constexpr int stats_smem() {
  return 1024 + (1 + kStages) * Geo<D>::kTileBytes + 8 * (1 + kStages);
}
template <int D>
constexpr int dq_smem() {
  return 1024 + (2 + 2 * kStages) * Geo<D>::kTileBytes + 8 * (1 + kStages);
}
template <int D>
constexpr int dkdv_smem() {
  return 1024 + (2 + 2 * kStages) * Geo<D>::kTileBytes +
         kStages * kStatStride + 8 * (1 + kStages);
}

// The statistics' map: fp32 (3, B H, Tqp), a box of 64 rows of each.
bool make_stats_map(CUtensorMap* map, float* stats, int BH, int Tqp) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Tqp, (cuuint64_t)BH, 3};
  const cuuint64_t strides[2] = {(cuuint64_t)Tqp * 4,
                                 (cuuint64_t)BH * Tqp * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kRows, 1, 3};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, stats, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* stats,
           const Args& a, cudaStream_t stream) {
  static std::atomic<bool> done_st[kDevices], done_dq[kDevices],
      done_kv[kDevices];
  cudaError_t err = allow_smem(bwd_stats_tc<D>, stats_smem<D>(), done_st);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dq_tc<D>, dq_smem<D>(), done_dq);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dkdv_tc<D>, dkdv_smem<D>(), done_kv);
  if (err != cudaSuccess) return (int)err;
  Maps maps = {};
  if (!make_maps<D>(&maps.q, &maps.q_tail, q, a.B, a.Tq, a.H, kRows) ||
      !make_maps<D>(&maps.k, &maps.k_tail, k, a.B, a.Tk, a.G, kRows) ||
      !make_maps<D>(&maps.v, &maps.v_tail, v, a.B, a.Tk, a.G, kRows) ||
      !make_maps<D>(&maps.dout, &maps.do_tail, dout, a.B, a.Tq, a.H,
                    kRows) ||
      !make_stats_map(&maps.stats, stats, a.B * a.H, a.Tqp))
    return (int)cudaErrorInvalidValue;
  const int nqt = (a.Tq + kRows - 1) / kRows, nkt = (a.Tk + kRows - 1) / kRows;
  bwd_stats_tc<D><<<a.B * a.H * nqt, kThreads, stats_smem<D>(), stream>>>(
      maps, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, stats, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_tc<D><<<a.B * a.H * nqt, kThreads, dq_smem<D>(), stream>>>(
      maps, stats, (__nv_bfloat16*)dq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_tc<D><<<a.B * a.G * nkt, kThreads, dkdv_smem<D>(), stream>>>(
      maps, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a);
  return (int)cudaGetLastError();
}

}  // namespace tcb

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

// The same call for bf16 tensors at D in {16, 32, 64, 80, 128} on the
// tensor cores.  stats: fp32 scratch (3, B H, Tqp) with Tqp = Tq rounded
// up to 64.  Base pointers must be 16-byte aligned (the tensor maps'
// rule; the wrapper checks).  Launches the three passes on `stream`.
// Returns a cudaError_t.
int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, float* stats, int B, int Tq,
                             int Tk, int H, int G, int D, int causal,
                             int window, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  const tcb::Args a{B, Tq, Tk, H, G, causal, window,
                    (Tq + tcb::kRows - 1) / tcb::kRows * tcb::kRows, scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return tcb::launch<16>(q, k, v, o, dout, dq, dk, dv, stats, a, st);
    case 32: return tcb::launch<32>(q, k, v, o, dout, dq, dk, dv, stats, a, st);
    case 64: return tcb::launch<64>(q, k, v, o, dout, dq, dk, dv, stats, a, st);
    case 80: return tcb::launch<80>(q, k, v, o, dout, dq, dk, dv, stats, a, st);
    case 128: return tcb::launch<128>(q, k, v, o, dout, dq, dk, dv, stats, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
