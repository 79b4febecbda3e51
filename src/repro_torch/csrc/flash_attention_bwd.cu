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
// reaches that rate.  In fp32 the same work is six bf16 piece products a
// product (sm90.cuh): 0.2606 ms at 989 TFLOP/s, against 0.6410 for scalar
// FFMAs at 67.  Three variants, chosen by the wrapper from the dtype and
// the head size alone (bwd_variant):
//
// flash_attention_bwd_sm90 (bf16, every D in {16, 32, 64, 80, 128, 160,
//   256}): three passes on the tensor cores, each a grid of
//   one-warpgroup blocks (128 threads, two or more a block an SM; dQ and
//   dK/dV at D = 160 and 256 on two warpgroups, below) on 64-row tiles,
//   fed by TMA from
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
//   makes the groups wait on the same tiles in lockstep.  At D = 160 and
//   256 dK and dV alone are 160 and 256 fp32 a thread of one warpgroup:
//   there bwd_dq_tc2 and bwd_dkdv_tc2 split the output columns over two
//   warpgroups, and bwd_dkdv_tc2 a key tile's query heads over a
//   thread-block cluster (the section "D = 160 and 256" below).
//
// flash_attention_bwd_split (fp32, every D): the one-warpgroup passes
//   above at NP = 3.  split_pieces (sm90.cuh) writes
//   q's, k's, v's and dO's three bf16 pieces to scratch as (3 B, T,
//   heads, D) tensors that the same tensor maps read (piece p of batch b
//   is batch p B + b); each product is six wgmma products on the piece
//   pairs, smallest first; P, P^T, dS and dS^T are split in registers.
//   The pieces take three times a bf16 tile's shared memory: at D = 128
//   dQ's and dK/dV's rings have one stage (148,504, 197,648 and 198,672
//   bytes, one block an SM).  The tensor cores' fp32 accumulation is
//   coarser than a chain of fp32 FMAs, so a gradient carried inside wgmma
//   across the loop drifts with its length (dK and dV 1.3e-5 from the
//   plain version at qwen3-1.7b's shape, over the 1e-5 limit, in a first
//   build); dQ, dK and dV therefore take each tile's products into a
//   zeroed partial added to the total in fp32 (add_tile), and dK/dV runs
//   two warpgroups, dV's (P^T dO) and dK's (dP^T and dS^T Q), both taking
//   S^T, since one thread cannot hold both totals, a partial and the
//   pieces.  At D = 160 and 256 a tile's pieces (61,440 and 98,304 bytes)
//   leave no room for the resident pair and a ring stage, so dQ and dK/dV
//   run as column pairs: two blocks of a cluster, each the same pass at D
//   / 2 columns (80 or 128), S and dP summed from their two partials
//   through distributed shared memory (the section "a column pair"
//   below); dK/dV's key tiles split their query heads over the cluster
//   too where the KV heads are few.  The statistics take all D columns
//   (one ring stage at D = 256).
//
// flash_attention_bwd (scalar fp32 and bf16, every D; only by name, the
//   yardstick): three scalar kernels.
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

#include <utility>

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
constexpr int kWide = 256;       // two warpgroups a block
constexpr int kStages = 2;       // depth of the ring a loop tile comes through
constexpr int kMaxSplit = 4;     // blocks a key tile's query heads split over
constexpr int kStatBytes = 3 * kRows * 4;   // m, 1/l, delta of a query tile
constexpr int kStatStride = 1024;           // their room a stage
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
using Geo = TileGeo<D, kRows>;

// The ring's depth in dQ and dK/dV at tile width D (the head size, or a
// column pair's half of it: 80 at D = 160, 128 at D = 256) and NP operand
// pieces (sm90.cuh: 1 bf16, 3 fp32): two stages, but one for fp32 at 128
// columns, where the resident tiles' pieces (96 KB) and a stage's (96 KB)
// fill the 227 KB.
template <int D, int NP>
__host__ __device__ constexpr int ring_stages() {
  return NP == 3 && D > 80 ? 1 : 2;
}

// The statistics pass's ring (K only, Q resident, all D columns): two
// stages, but one for fp32 at D = 256, where Q's pieces and two stages'
// would be 295,936 bytes.
template <int D, int NP>
__host__ __device__ constexpr int stats_stages() {
  return NP == 3 && D > 160 ? 1 : 2;
}

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
  int split;   // blocks a key tile's query heads split over (a cluster, or
               // with a column pair C x split a cluster) in dK/dV; else 1
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
// query tiles see the most keys), so the grid's tail is light.  With a
// column pair (C = 2) item j is the cluster of blocks 2 j and 2 j + 1.
struct QItem {
  int b, h, g, bh, q0, lo, n;
};

__device__ __forceinline__ QItem q_item(const Args& a, bool stats,
                                        int C = 1) {
  QItem w;
  const int BH = a.B * a.H, nqt = (a.Tq + kRows - 1) / kRows;
  const int j = blockIdx.x / C;
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

// A key tile's work item: its batch, KV head and key tile (heaviest
// first) and the query heads and tiles it walks.  The key tile is that of
// cluster c = block / (C split); the block's cluster rank is col + C rank,
// col its half of a column pair (0 at C = 1) and rank of `split` takes
// query heads [g R + rank R / split, g R + (rank + 1) R / split).
// bwd_dkdv_tc runs it at split 1 (every head) up to D = 128 and at C = 2
// and Args::split at D = 160 and 256 (fp32); bwd_dkdv_tc2 at Args::split.
struct KItem {
  int b, g, k0, rank, col, h0, qlo, per, n;
};

__device__ __forceinline__ KItem k_item(const Args& a, int split,
                                        int C = 1) {
  KItem w;
  const int BG = a.B * a.G, R = a.H / a.G;
  const int c = blockIdx.x / (C * split);
  w.col = blockIdx.x % C;
  w.rank = (blockIdx.x % (C * split)) / C;
  const int bg = c % BG, kt = c / BG;
  w.g = bg % a.G;
  w.b = bg / a.G;
  w.k0 = kt * kRows;
  const int nq = (a.Tq + kRows - 1) / kRows;
  w.qlo = a.causal ? kt : 0;
  const int qhi = (a.causal && a.window > 0)
                      ? min(nq, (w.k0 + kRows - 1 + a.window + kRows - 1) /
                                    kRows)
                      : nq;
  w.per = max(qhi - w.qlo, 0);
  w.h0 = w.g * R + w.rank * R / split;
  w.n = (w.g * R + (w.rank + 1) * R / split - w.h0) * w.per;
  return w;
}

// Per thread of a warpgroup: element 4 j + e of an m64nNk16 accumulator
// sits at row 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) +
// e % 2, with warp the thread's warp within its warpgroup.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4 +
         8 * ((i / 2) % 2);
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
// 1 / max(l, 1e-30) and delta for all 64 rows (0 past Tq).  For fp32 (NP =
// 3) the tiles are Q's and K's pieces, S six piece products, and delta
// comes from the fp32 O and dO; at D = 256 the ring has one stage
// (stats_stages).  It takes all D columns at every head size: at D = 160
// and 256 in fp32 the other passes split the columns over a pair.
template <int D, int NP>
__global__ void __launch_bounds__(kThreads)
bwd_stats_tc(const __grid_constant__ Maps maps,
             const Elem<NP>* __restrict__ o,
             const Elem<NP>* __restrict__ dout,
             float* __restrict__ stats, Args a) {
  using Gm = Geo<D>;
  constexpr int kT = NP * Gm::kTileBytes;                    // a tile's pieces
  constexpr int kStages = stats_stages<D, NP>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kT;                             // [kStages]
  const uint32_t full_q = k_s + kStages * kT;
  const uint32_t full_k = full_q + 8;                        // [kStages]
  const QItem w = q_item(a, true);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full_k + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(full_q, kT);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      load_tile<Gm>(q_s + p * Gm::kTileBytes, &maps.q, &maps.q_tail, full_q,
                    w.h, w.q0, p * a.B + w.b);
    for (int i = 0; i < min(w.n, kStages); ++i) {
      mbar_expect_tx(full_k + 8 * i, kT);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        load_tile<Gm>(k_s + i * kT + p * Gm::kTileBytes, &maps.k,
                      &maps.k_tail, full_k + 8 * i, w.g, (w.lo + i) * kRows,
                      p * a.B + w.b);
    }
  }
  __syncthreads();

  {  // delta: two threads a row, D / 2 columns each, 16 bytes a load
    const int r = threadIdx.x / 2, t = w.q0 + r;
    float acc = 0.f;
    if (t < a.Tq) {
      const size_t at = (((size_t)w.b * a.Tq + t) * a.H + w.h) * D +
                        (threadIdx.x % 2) * (D / 2);
      if constexpr (NP == 1) {
        const uint4* po = reinterpret_cast<const uint4*>(o + at);
        const uint4* pd = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const uint4 x = po[c], y = pd[c];
          const __nv_bfloat162* x2 =
              reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* y2 =
              reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fx = __bfloat1622float2(x2[e]);
            const float2 fy = __bfloat1622float2(y2[e]);
            acc = fmaf(fx.x, fy.x, acc);
            acc = fmaf(fx.y, fy.y, acc);
          }
        }
      } else {
        const float4* po = reinterpret_cast<const float4*>(o + at);
        const float4* pd = reinterpret_cast<const float4*>(dout + at);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const float4 x = po[c], y = pd[c];
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          acc = fmaf(x.w, y.w, acc);
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
    const uint32_t kb = k_s + st * kT;
    mbar_wait(full_k + 8 * st, (i / kStages) & 1);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < products<NP>(); ++pr)
#pragma unroll
      for (int ks = 0; ks < Gm::kKSteps; ++ks)
        SS<64>::mma(s, Gm::k_desc(q_s + piece_a<NP>(pr) * Gm::kTileBytes, 0,
                                  ks),
                    Gm::k_desc(kb + piece_b<NP>(pr) * Gm::kTileBytes, 0, ks),
                    pr > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    __syncthreads();   // every warp's product has read the stage
    if (threadIdx.x == 0 && i + kStages < w.n) {
      mbar_expect_tx(full_k + 8 * st, kT);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        load_tile<Gm>(kb + p * Gm::kTileBytes, &maps.k, &maps.k_tail,
                      full_k + 8 * st, w.g, k0 + kStages * kRows,
                      p * a.B + w.b);
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

// fp32 (NP = 3): tot += x (64 x 64 in an accumulator's layout, split into
// its three pieces as the register A operand) times rows [0, 64) of the
// three-piece tile at `tile` (the MN-major B operand, D columns), the six
// piece products waited on.  The products go to a zeroed partial that is
// then added to tot in fp32: the tensor cores' fp32 accumulation is
// coarser than a chain of fp32 FMAs, so a sum carried inside wgmma across
// a whole loop drifts with its length (dK and dV 1.3e-5 from the plain
// version at qwen3-1.7b's 2 x 16 query tiles, 2.1e-5 at 48 heads x 2
// tiles, on an H100), where one tile's chain is 24 products.
template <typename Gm, int M>
__device__ __forceinline__ void add_tile(float (&tot)[M],
                                         const float (&x)[32],
                                         uint32_t tile) {
  constexpr int NP = 3;
  uint32_t pf[NP][4][4];
  to_piece_frags<64, NP>(x, pf);
  float part[M];
#pragma unroll
  for (int i = 0; i < M; ++i) part[i] = 0.f;
  fence_regs(part);
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_frags(pf[p]);
  wgmma_fence();
#pragma unroll
  for (int pr = 0; pr < products<NP>(); ++pr)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma_rows<Gm>(part, pf[piece_a<NP>(pr)][ks],
                   tile + piece_b<NP>(pr) * Gm::kTileBytes, ks);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(part);
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_frags(pf[p]);
#pragma unroll
  for (int i = 0; i < M; ++i) tot[i] += part[i];
}

// --- fp32 at D = 160 and 256: a column pair ---------------------------------
//
// One 64-row tile's three pieces are 61,440 bytes at D = 160 and 98,304 at
// D = 256, so dQ's and dK/dV's two resident tiles and a ring stage of two
// (at least 245,760 and 393,216 bytes) do not fit a block's 232,448.  So
// at C = 2 two blocks of a thread-block cluster each own half of the
// head's columns (80 + 80, 128 + 128): each loads its columns alone (the
// tiles' Geo is the half's width, loaded from column col0 = col D / 2, a
// multiple of 16 bytes, so no operand starts inside a swizzle block) and
// runs the one-warpgroup passes' work at that width, whose shared memory
// and registers are those of D = 80 and 128.  S = Q K^T and dP = dO V^T
// (or S^T and dP^T) contract over all D columns: each block takes its
// six-product partial over its columns, sends it into the peer's exchange
// by st.async (16-byte stores whose bytes complete on the peer's
// mbarrier), waits on its own mbarrier for the peer's, and adds it to its
// own.  IEEE addition commutes, so rank 0's partial plus rank 1's is the
// same bits on both blocks: both hold the same S and dP, and so the same
// P and dS, and each writes its own columns of dQ, dK and dV with no
// further exchange and no atomics.  A relaxed cluster barrier an
// iteration (arrive once the exchange is read, wait before the next
// sends) keeps a block from writing partials its peer has not read: its
// arrive follows the adds that consume those reads (fence_regs), so no
// read is outstanding when it issues.  Every block of a cluster takes the
// same number of iterations (dkdv_split keeps the head split to divisors
// of R), as the cluster barrier counts all of them.

constexpr int kPartBytes = 64 * 64 * 4;    // a 64 x 64 fp32 partial
constexpr int kXBytes = 2 * kPartBytes;    // S's (or S^T's) and dP's

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// a shared memory address of this block as the cluster's block `rank`'s
__device__ __forceinline__ uint32_t peer_addr(uint32_t at, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(at), "r"(rank));
  return out;
}

// A column pair's exchange in one block: its buffer (kXBytes: the peer's
// partials of S and dP, [2][8][128] float4), its mbarrier, and the
// peer's two as shared::cluster addresses.
struct Xchg {
  const float4* mine;
  uint32_t bar, peer_buf, peer_bar;
};

__device__ __forceinline__ Xchg make_xchg(const uint8_t* smem_raw,
                                          uint32_t raw, uint32_t buf,
                                          uint32_t bar, int peer) {
  return {reinterpret_cast<const float4*>(smem_raw + (buf - raw)), bar,
          peer_addr(buf, peer), peer_addr(bar, peer)};
}

// This warpgroup's 64 x 64 fp32 partial (32 floats a thread, an
// accumulator's layout) into part `part` (0: S, 1: dP) of the peer's
// exchange: eight 16-byte st.async a thread, counted on its mbarrier.
__device__ __forceinline__ void send_part(const Xchg& x, int part,
                                          const float (&v)[32]) {
  const uint32_t at = x.peer_buf + part * kPartBytes + 16 * (threadIdx.x % 128);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
        " [%0], {%1, %2, %3, %4}, [%5];\n"
        :: "r"(at + j * 128 * 16), "r"(__float_as_uint(v[4 * j])),
           "r"(__float_as_uint(v[4 * j + 1])),
           "r"(__float_as_uint(v[4 * j + 2])),
           "r"(__float_as_uint(v[4 * j + 3])), "r"(x.peer_bar)
        : "memory");
}

// v += the peer's partial in part `part` of this block's exchange.
__device__ __forceinline__ void add_part(const Xchg& x, int part,
                                         float (&v)[32]) {
  const float4* p = x.mine + part * (kPartBytes / 16) + threadIdx.x % 128;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 t = p[j * 128];
    v[4 * j] += t.x;
    v[4 * j + 1] += t.y;
    v[4 * j + 2] += t.z;
    v[4 * j + 3] += t.w;
  }
}

// Iteration i of n's exchange of the partials s (sent by warpgroup
// sends_s) and dp (by sends_dp; nullptr: none), the peer's added into
// both where wants_dp, into s alone otherwise.  Thread 0 expects the next
// iteration's bytes as soon as this one's are in: the peer sends them
// only after this block's arrive.
__device__ __forceinline__ void exchange(const Xchg& x, int i, int n,
                                         float (&s)[32], float (&dp)[32],
                                         bool sends_s, bool sends_dp,
                                         bool wants_dp) {
  if (i > 0) cluster_wait();   // the peer has read the last partials
  if (sends_s) send_part(x, 0, s);
  if (sends_dp) send_part(x, 1, dp);
  mbar_wait(x.bar, i & 1);     // the peer's partials are in
  if (threadIdx.x == 0 && i + 1 < n) mbar_expect_tx(x.bar, kXBytes);
  add_part(x, 0, s);
  if (wants_dp) add_part(x, 1, dp);
  fence_regs(s);
  fence_regs(dp);
  cluster_arrive_relaxed();    // this block's exchange is read
}

// --- pass 2: dQ ----------------------------------------------------------------
//
// One block a (b, query head, 64-row query tile), Q and dO resident, K and
// V through a two-stage TMA ring over the key tiles that hold an unmasked
// score: S = Q K^T and dP = dO V^T on wgmma from shared memory, P and dS
// in the accumulators' registers, and dQ += dS K with dS as the register A
// operand (bf16) and K the MN-major B operand.  The block owns its rows:
// no atomics, a fixed order.  For fp32 (NP = 3) every tile is its three
// pieces, each product six piece products, dS split into its pieces as the
// A operand, and at 128 columns the ring has one stage (ring_stages).  At C
// = 2 (fp32 at D = 160 and 256) a cluster of two blocks a query tile, each
// its D / 2 columns, S and dP summed over the pair (the column pair's
// section above).
template <int D, int NP, int C>
__global__ void __launch_bounds__(kThreads)
bwd_dq_tc(const __grid_constant__ Maps maps,
          const float* __restrict__ stats, Elem<NP>* __restrict__ dq,
          Args a) {
  constexpr int W = D / C;                                   // the columns
  using Gm = Geo<W>;
  constexpr int kT = NP * Gm::kTileBytes;                    // a tile's pieces
  constexpr int kS = ring_stages<W, NP>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + kT;
  const uint32_t k_s = do_s + kT;                            // [kS]
  const uint32_t v_s = k_s + kS * kT;                        // [kS]
  const uint32_t x_s = v_s + kS * kT;                        // C = 2
  const uint32_t full_q = x_s + (C > 1 ? kXBytes : 0);
  const uint32_t full_kv = full_q + 8;                       // [kS]
  const uint32_t full_x = full_kv + 8 * kS;                  // C = 2
  const QItem w = q_item(a, false, C);
  const int col = C > 1 ? (int)(blockIdx.x % C) : 0;
  const int c0 = col * W;
  // the K and V tiles of key tile k0 into ring stage st
  auto load_kv = [&](int st, int k0) {
    mbar_expect_tx(full_kv + 8 * st, 2 * kT);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      load_tile<Gm>(k_s + st * kT + p * Gm::kTileBytes, &maps.k,
                    &maps.k_tail, full_kv + 8 * st, w.g, k0, p * a.B + w.b,
                    c0);
      load_tile<Gm>(v_s + st * kT + p * Gm::kTileBytes, &maps.v,
                    &maps.v_tail, full_kv + 8 * st, w.g, k0, p * a.B + w.b,
                    c0);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kS; ++s) mbar_init(full_kv + 8 * s, 1);
    if (C > 1) {
      mbar_init(full_x, 1);
      if (w.n > 0) mbar_expect_tx(full_x, kXBytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(full_q, 2 * kT);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      load_tile<Gm>(q_s + p * Gm::kTileBytes, &maps.q, &maps.q_tail, full_q,
                    w.h, w.q0, p * a.B + w.b, c0);
      load_tile<Gm>(do_s + p * Gm::kTileBytes, &maps.dout, &maps.do_tail,
                    full_q, w.h, w.q0, p * a.B + w.b, c0);
    }
    for (int i = 0; i < min(w.n, kS); ++i) load_kv(i, (w.lo + i) * kRows);
  }
  Xchg x = {};
  if constexpr (C > 1) {
    cluster_sync();   // both blocks' mbarriers are set
    x = make_xchg(smem_raw, raw, x_s, full_x, col ^ 1);
  } else {
    __syncthreads();
  }

  float m[2], il[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const size_t at = (size_t)w.bh * a.Tqp + w.q0 + acc_row(2 * e);
    const size_t plane = (size_t)a.B * a.H * a.Tqp;
    m[e] = stats[at];
    il[e] = stats[plane + at];
    dl[e] = stats[2 * plane + at];
  }
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;

  mbar_wait(full_q, 0);
  for (int i = 0; i < w.n; ++i) {
    const int st = i % kS, k0 = (w.lo + i) * kRows;
    const uint32_t kb = k_s + st * kT;
    const uint32_t vb = v_s + st * kT;
    mbar_wait(full_kv + 8 * st, (i / kS) & 1);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < products<NP>(); ++pr)
#pragma unroll
      for (int ks = 0; ks < Gm::kKSteps; ++ks)
        SS<64>::mma(s, Gm::k_desc(q_s + piece_a<NP>(pr) * Gm::kTileBytes, 0,
                                  ks),
                    Gm::k_desc(kb + piece_b<NP>(pr) * Gm::kTileBytes, 0, ks),
                    pr > 0 || ks > 0);
#pragma unroll
    for (int pr = 0; pr < products<NP>(); ++pr)
#pragma unroll
      for (int ks = 0; ks < Gm::kKSteps; ++ks)
        SS<64>::mma(dp,
                    Gm::k_desc(do_s + piece_a<NP>(pr) * Gm::kTileBytes, 0,
                               ks),
                    Gm::k_desc(vb + piece_b<NP>(pr) * Gm::kTileBytes, 0, ks),
                    pr > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    if constexpr (C > 1) exchange(x, i, w.n, s, dp, true, true, true);
    const bool mask = needs_mask(a, w.q0, k0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int e = (j / 2) % 2;
      float p;
      p_ds(a, mask, w.q0 + acc_row(j), k0 + acc_col(j), s[j], dp[j], m[e],
           il[e], dl[e], p, dp[j]);
    }
    if constexpr (NP == 1) {
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
    } else {
      add_tile<Gm>(acc, dp, kb);   // dS's pieces times K's
    }
    __syncthreads();   // every warp's products have read the stage
    if (threadIdx.x == 0 && i + kS < w.n) load_kv(st, k0 + kS * kRows);
  }
  if constexpr (C > 1) {
    if (w.n > 0) cluster_wait();   // the peer has read this block's sends
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = w.q0 + acc_row(2 * e);
    if (t >= a.Tq) continue;
    Elem<NP>* out = dq + (((size_t)w.b * a.Tq + t) * a.H + w.h) * D + c0;
#pragma unroll
    for (int jj = 0; jj < W / 8; ++jj)
      store2(out + acc_col(4 * jj), acc[4 * jj + 2 * e] * a.scale,
             acc[4 * jj + 2 * e + 1] * a.scale);
  }
}

// S^T = K Q^T and, `with_dp`, dP^T = V dO^T of a key tile and a query
// tile from q0 on wgmma (for NP = 3 each six piece products), waited on,
// then `sum(s, dp)` (a column pair's exchange; nothing at C = 1), then
// P^T and dS^T in their place, rows the keys and columns the queries
// (p_ds with the query tile's m, 1/l, delta at sm; dS^T 0 without dP^T).
template <typename Gm, int NP, typename Sum>
__device__ __forceinline__ void scores_t(float (&s)[32], float (&dp)[32],
                                         bool with_dp, uint32_t k_s,
                                         uint32_t v_s, uint32_t qb,
                                         uint32_t dob, const Args& a, int q0,
                                         int k0, const float* sm,
                                         const Sum& sum) {
  if (!with_dp) {
#pragma unroll
    for (int j = 0; j < 32; ++j) dp[j] = 0.f;
  }
  wgmma_fence();
#pragma unroll
  for (int pr = 0; pr < products<NP>(); ++pr)
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<64>::mma(s, Gm::k_desc(k_s + piece_a<NP>(pr) * Gm::kTileBytes, 0, ks),
                  Gm::k_desc(qb + piece_b<NP>(pr) * Gm::kTileBytes, 0, ks),
                  pr > 0 || ks > 0);
  if (with_dp) {
#pragma unroll
    for (int pr = 0; pr < products<NP>(); ++pr)
#pragma unroll
      for (int ks = 0; ks < Gm::kKSteps; ++ks)
        SS<64>::mma(dp,
                    Gm::k_desc(v_s + piece_a<NP>(pr) * Gm::kTileBytes, 0, ks),
                    Gm::k_desc(dob + piece_b<NP>(pr) * Gm::kTileBytes, 0, ks),
                    pr > 0 || ks > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
  sum(s, dp);
  const bool mask = needs_mask(a, q0, k0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = acc_col(j);
    p_ds(a, mask, q0 + c, k0 + acc_row(j), s[j], dp[j], sm[c],
         sm[kRows + c], sm[2 * kRows + c], s[j], dp[j]);
  }
}

// The head split's sum of dK and dV over a cluster (bwd_dkdv_tc2, and
// bwd_dkdv_tc at C = 2): the pairs of accumulator floats (q: floats 4 (q /
// 2) + 2 (q % 2) and the next, at row acc_row(2 (q % 2)), column acc_col(4
// (q / 2))) of one of dK or dV that a thread sends to their owners: pair
// p0 + q belongs to head rank (p0 + q) % split, the cluster's block col +
// C rank (the same column half), and lands in its ring at slot (sender,
// (p0 + q) / split) of [split - 1][per_rank][256] float2.
template <int N>
__device__ __forceinline__ void send_pairs(const float (&acc)[N], int p0,
                                           int S, int rank, int per_rank,
                                           uint32_t ring, int col = 0,
                                           int C = 1) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const int p = p0 + q, o = p % S;
    if (o == rank) continue;
    const int slot = rank < o ? rank : rank - 1;
    const uint32_t at = ring + 8 * ((slot * per_rank + p / S) * kWide +
                                    threadIdx.x);
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
                 :: "r"(peer_addr(at, col + C * o)),
                    "f"(acc[4 * (q / 2) + 2 * (q % 2)]),
                    "f"(acc[4 * (q / 2) + 2 * (q % 2) + 1]) : "memory");
  }
}

// The owned pairs of one of dK or dV: the split partials added in rank
// order (the thread's own from registers), times mul, written in out's
// type at the row's column col(accumulator column) of D.
template <int D, int N, typename T, typename Col>
__device__ __forceinline__ void own_pairs(const float (&acc)[N], int p0,
                                          int S, int rank, int per_rank,
                                          const float2* ring,
                                          T* __restrict__ out, const Args& a,
                                          const KItem& w, float mul,
                                          const Col& col) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const int p = p0 + q, e = q % 2, j = 4 * (q / 2) + 2 * e;
    if (p % S != rank) continue;
    float2 v = make_float2(acc[j], acc[j + 1]);
    if (S > 1) {
      for (int r = 0; r < S; ++r) {
        const float2 part = r == rank
            ? make_float2(acc[j], acc[j + 1])
            : ring[((r < rank ? r : r - 1) * per_rank + p / S) * kWide +
                   threadIdx.x];
        if (r == 0) {
          v = part;
        } else {
          v.x += part.x;
          v.y += part.y;
        }
      }
    }
    const int t = w.k0 + acc_row(2 * e);
    if (t >= a.Tk) continue;
    store2(out + (((size_t)w.b * a.Tk + t) * a.G + w.g) * D +
               col(acc_col(4 * (q / 2))),
           v.x * mul, v.y * mul);
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
// its key rows: no atomics, a fixed order.  For fp32 (NP = 3) every tile
// is its three pieces and each product six piece products, and the block
// has two warpgroups: each product's tile goes to a zeroed partial added
// to its total in fp32 (add_tile), and dK's and dV's totals, partials and
// the pieces of P^T or dS^T (64 + 64 + 64 + 64 + 48 registers a thread at
// D = 128) do not fit one.  Both take S^T; warpgroup 0 adds P^T dO into
// dV, warpgroup 1 takes dP^T too and adds dS^T Q into dK (a quarter more
// tensor work than one warpgroup's four products).  At C = 2 (fp32 at D =
// 160 and 256) a key tile is a cluster of C x Args::split blocks: a
// column pair (warpgroup 0 sends its S^T partial, warpgroup 1 its dP^T's)
// times the head split of bwd_dkdv_tc2 (below), whose sum of dK and dV
// over the head ranks takes the ring after the loop.
template <int D, int NP, int C>
__global__ void __launch_bounds__(NP == 1 ? kThreads : kWide)
bwd_dkdv_tc(const __grid_constant__ Maps maps,
            Elem<NP>* __restrict__ dk, Elem<NP>* __restrict__ dv,
            Args a) {
  constexpr int Wd = D / C;                                  // the columns
  using Gm = Geo<Wd>;
  constexpr int kT = NP * Gm::kTileBytes;                    // a tile's pieces
  constexpr int kS = ring_stages<Wd, NP>();
  static_assert(C == 1 || NP == 3, "a column pair is fp32's");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + kT;
  const uint32_t q_s = v_s + kT;                             // [kS]
  const uint32_t do_s = q_s + kS * kT;                       // [kS]
  const uint32_t st_s = do_s + kS * kT;                      // [kS]
  const uint32_t x_s = st_s + kS * kStatStride;              // C = 2
  const uint32_t full_kv = x_s + (C > 1 ? kXBytes : 0);
  const uint32_t full = full_kv + 8;                         // [kS]
  const uint32_t full_x = full + 8 * kS;                     // C = 2
  const float* st_g = reinterpret_cast<const float*>(smem_raw + (st_s - raw));

  const int split = C > 1 ? a.split : 1;
  const KItem w = k_item(a, split, C);
  const int b = w.b, g = w.g, k0 = w.k0, qlo = w.qlo, per = w.per, n = w.n;
  const int c0 = w.col * Wd;
  // iteration i: query head g R + i / per, query tile qlo + i % per
  auto load = [&](int i, int st) {
    const int h = w.h0 + i / per, q0 = (qlo + i % per) * kRows;
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, 2 * kT + kStatBytes);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      load_tile<Gm>(q_s + st * kT + p * Gm::kTileBytes, &maps.q, &maps.q_tail,
                    bar, h, q0, p * a.B + b, c0);
      load_tile<Gm>(do_s + st * kT + p * Gm::kTileBytes, &maps.dout,
                    &maps.do_tail, bar, h, q0, p * a.B + b, c0);
    }
    tma_load_3d(st_s + st * kStatStride, &maps.stats, bar, q0, b * a.H + h,
                0);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kS; ++s) mbar_init(full + 8 * s, 1);
    if (C > 1) {
      mbar_init(full_x, 1);
      if (n > 0) mbar_expect_tx(full_x, kXBytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(full_kv, 2 * kT);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      load_tile<Gm>(k_s + p * Gm::kTileBytes, &maps.k, &maps.k_tail, full_kv,
                    g, k0, p * a.B + b, c0);
      load_tile<Gm>(v_s + p * Gm::kTileBytes, &maps.v, &maps.v_tail, full_kv,
                    g, k0, p * a.B + b, c0);
    }
    for (int i = 0; i < min(n, kS); ++i) load(i, i);
  }
  Xchg x = {};
  if constexpr (C > 1) {
    cluster_sync();   // every block's mbarriers are set
    x = make_xchg(smem_raw, raw, x_s, full_x, (w.col ^ 1) + C * w.rank);
  } else {
    __syncthreads();
  }

  if constexpr (NP == 1) {
    float ak[D / 2], av[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      ak[i] = 0.f;
      av[i] = 0.f;
    }
    mbar_wait(full_kv, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % kS, q0 = (qlo + i % per) * kRows;
      const uint32_t qb = q_s + st * kT;
      const uint32_t dob = do_s + st * kT;
      const float* sm = st_g + st * (kStatStride / 4);   // m, 1/l, delta
      mbar_wait(full + 8 * st, (i / kS) & 1);
      float s[32], dp[32];
      scores_t<Gm, NP>(s, dp, true, k_s, v_s, qb, dob, a, q0, k0, sm,
                       [](float (&)[32], float (&)[32]) {});
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
      if (threadIdx.x == 0 && i + kS < n) load(i + kS, st);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = k0 + acc_row(2 * e);
      if (t >= a.Tk) continue;
      const size_t row = (((size_t)b * a.Tk + t) * a.G + g) * D;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int c = acc_col(4 * jj);
        store2(dk + row + c, ak[4 * jj + 2 * e] * a.scale,
               ak[4 * jj + 2 * e + 1] * a.scale);
        store2(dv + row + c, av[4 * jj + 2 * e], av[4 * jj + 2 * e + 1]);
      }
    }
  } else {
    // fp32: warpgroup W's total, dV (W = 0) or dK (W = 1)
    const int W = threadIdx.x / 128;
    float tot[Wd / 2];
#pragma unroll
    for (int i = 0; i < Wd / 2; ++i) tot[i] = 0.f;
    mbar_wait(full_kv, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % kS, q0 = (qlo + i % per) * kRows;
      const uint32_t qb = q_s + st * kT;
      const uint32_t dob = do_s + st * kT;
      const float* sm = st_g + st * (kStatStride / 4);   // m, 1/l, delta
      mbar_wait(full + 8 * st, (i / kS) & 1);
      float s[32], dp[32];
      scores_t<Gm, NP>(s, dp, W == 1, k_s, v_s, qb, dob, a, q0, k0, sm,
                       [&](float (&s2)[32], float (&dp2)[32]) {
                         if constexpr (C > 1)
                           exchange(x, i, n, s2, dp2, W == 0, W == 1,
                                    W == 1);
                       });
      if (W == 0)
        add_tile<Gm>(tot, s, dob);   // P^T's pieces times dO's
      else
        add_tile<Gm>(tot, dp, qb);   // dS^T's pieces times Q's
      __syncthreads();   // both groups' products have read the stage
      if (threadIdx.x == 0 && i + kS < n) load(i + kS, st);
    }
    Elem<NP>* out = W == 0 ? dv : dk;
    const float mul = W == 0 ? 1.f : a.scale;
    if constexpr (C > 1) {
      // the head split's sum over the ranks of this column half, through
      // the ring (Q's and dO's stages, one span) once every loop is done
      constexpr int kPairs = Wd / 4;
      static_assert((kMaxSplit - 1) * ((kPairs + kMaxSplit - 1) / kMaxSplit) *
                            kWide * 8 <= 2 * kS * kT,
                    "the cluster's sum fits the ring");
      const int per_rank = (kPairs + split - 1) / split;
      if (n > 0) cluster_wait();   // the peer has read this block's sends
      if (split > 1) {
        cluster_sync();   // every rank's loop is done: the rings are free
        send_pairs(tot, 0, split, w.rank, per_rank, q_s, w.col, C);
        cluster_sync();   // every pair is in its owner's shared memory
      }
      const float2* ring =
          reinterpret_cast<const float2*>(smem_raw + (q_s - raw));
      own_pairs<D>(tot, 0, split, w.rank, per_rank, ring, out, a, w, mul,
                   [c0](int c) { return c0 + c; });
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = k0 + acc_row(2 * e);
        if (t >= a.Tk) continue;
        const size_t row = (((size_t)b * a.Tk + t) * a.G + g) * D;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          store2(out + row + acc_col(4 * jj), tot[4 * jj + 2 * e] * mul,
                 tot[4 * jj + 2 * e + 1] * mul);
      }
    }
  }
}

// --- D = 160 and 256: two warpgroups a block -----------------------------------
//
// dK and dV of a 64-key tile are 64 x D fp32 each: D / 2 + D / 2 floats a
// thread of one warpgroup, 256 at D = 256 before S^T and dP^T, which no
// thread's 255 registers hold.  So bwd_dq_tc2 and bwd_dkdv_tc2 run two
// warpgroups a block (256 threads) that split the output columns (Half):
// 128 and 128 at D = 256, and at D = 160 full block 0 with the 32-column
// tail (96) and full block 1 (64), since a warpgroup's product columns
// must start on a swizzle block (80 and 80 would cut block 1 through its
// 128-byte swizzle); the 96-column group does 22% more of the tile's
// work.  The first products are split by the other side: warpgroup W
// takes loop rows [32 W, 32 W + 32) (wgmma N = 32), so S and dP (or S^T
// and dP^T) are still computed once a tile pair.  Each group turns its
// half into bf16 A fragments of its two k16 steps, writes them to shared
// memory (8 KiB for dS in dQ, 16 KiB for P^T and dS^T in dK/dV), and
// after a named barrier over the 256 threads reads the other group's two,
// so both run their column products over all 64 loop rows with A in
// registers (thread t of one group holds exactly the fragment slots
// thread t of the other needs).  dS = P (dP - delta) stays fp32 until
// the fragments, as p_ds computes it.  Shared memory at D = 256: Q, dO
// (or K, V) resident, two ring stages of K, V (or Q, dO), the statistics
// and the exchange: 205,848 bytes for dQ, 216,088 for dK/dV, one block
// an SM; at D = 160 132,120 and 142,360.  Registers (ptxas, CUDA 12.9):
// dK/dV 222 at D = 256 and 190 at 160, dQ 136 and 120, no spills, no
// C7512 warning.  One trial ran slower in each pass and was not kept:
// the next tile's first products started behind this tile's column
// products (a wgmma group in flight across the stage barrier).
//
// The dK/dV grid under few KV heads.  A block walks a key tile's R query
// heads; at recurrentgemma-9b's G = 1 (B = 4, T = 1,024) that is 64
// blocks of 256 iterations for 132 SMs.  So a key tile's heads are split
// over a thread-block cluster of `split` blocks (1, 2 or 4: the least
// power of two that gives at least one block an SM, at most R), each
// summing its heads' partial dK and dV in fp32 registers.  After a
// cluster barrier (every rank's ring is free) each rank sends the pairs
// it does not own (pair p belongs to rank p % split) into the owner's
// ring space through distributed shared memory; after a second barrier
// each owner adds the split partials in rank order and writes its pairs.
// No atomics, a fixed order: two calls give the same bits.

// The columns of dQ, dK and dV that warpgroup W owns at head size D
// (kN of them, kN / 2 accumulator floats a thread), the global column of
// its accumulator column c, and acc += A (64 x 16, registers) x rows
// [16 ks, 16 ks + 16) of a tile over those columns (the MN-major B).
template <int D, int W> struct Half;
template <int W> struct Half<256, W> {   // full blocks 2 W, 2 W + 1
  static constexpr int kN = 128;
  static __device__ __forceinline__ int col(int c) { return 128 * W + c; }
  template <typename Gm>
  static __device__ __forceinline__ void mma(float (&acc)[kN / 2],
                                             const uint32_t (&a)[4],
                                             uint32_t tile, int ks) {
    RS<128>::mma(acc, a, Gm::mn_full_desc(tile, ks, 2 * W));
  }
};
template <> struct Half<160, 0> {        // full block 0 and the tail
  static constexpr int kN = 96;
  static __device__ __forceinline__ int col(int c) {
    return c < 64 ? c : c + 64;
  }
  template <typename Gm>
  static __device__ __forceinline__ void mma(float (&acc)[kN / 2],
                                             const uint32_t (&a)[4],
                                             uint32_t tile, int ks) {
    RS<64>::mma(acc_part<0, 32>(acc), a, Gm::mn_full_desc(tile, ks, 0));
    RS<32>::mma(acc_part<32, 16>(acc), a, Gm::mn_tail_desc(tile, ks));
  }
};
template <> struct Half<160, 1> {        // full block 1
  static constexpr int kN = 64;
  static __device__ __forceinline__ int col(int c) { return c + 64; }
  template <typename Gm>
  static __device__ __forceinline__ void mma(float (&acc)[kN / 2],
                                             const uint32_t (&a)[4],
                                             uint32_t tile, int ks) {
    RS<64>::mma(acc, a, Gm::mn_full_desc(tile, ks, 1));
  }
};
// pairs of accumulator floats a thread in dK and dV together, at most
template <int D>
constexpr int kMaxPairs = Half<D, 0>::kN / 2;

// the 256 threads of a wide block (barrier 1: the two groups run apart
// code, so not __syncthreads)
__device__ __forceinline__ void sync_wide() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One group's two k16 steps of A fragments (the loop rows it computed)
// into slots [2 W, 2 W + 2) of the exchange x ([kinds][4][4][128] words),
// then, after the barrier, the other group's two from it.
template <int W, int K>
__device__ __forceinline__ void swap_frags(uint32_t* x,
                                           const uint32_t (&mine)[K][2][4],
                                           uint32_t (&all)[K][4][4]) {
  const int lt = threadIdx.x % 128;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        x[((k * 4 + 2 * W + t) * 4 + r) * 128 + lt] = mine[k][t][r];
        all[k][2 * W + t][r] = mine[k][t][r];
      }
  sync_wide();
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        all[k][2 * (1 - W) + t][r] =
            x[((k * 4 + 2 * (1 - W) + t) * 4 + r) * 128 + lt];
}

// The shared memory of bwd_dq_tc2 from its 1024-aligned base: Q and dO
// resident, the K and V ring, the exchange of dS fragments, the barriers.
template <int D>
struct DqWide {
  static constexpr int kTile = Geo<D>::kTileBytes;
  static constexpr int kX = 8192;
  static constexpr int kBytes =
      1024 + (2 + 2 * kStages) * kTile + kX + 8 * (1 + kStages);
  uint32_t q, dout, k, v, x, full_q, full_kv;
  __device__ __forceinline__ explicit DqWide(uint32_t base)
      : q(base), dout(base + kTile), k(base + 2 * kTile),
        v(base + (2 + kStages) * kTile),
        x(base + (2 + 2 * kStages) * kTile), full_q(x + kX),
        full_kv(full_q + 8) {}
};

// bwd_dq_tc's work on two warpgroups: warpgroup W's loop over the block's
// key tiles (S and dP over keys [32 W, 32 W + 32) of each, dQ over its
// columns) and its part of dQ.
template <int D, int W>
__device__ __forceinline__ void dq_wide(const Maps& maps,
                                        const float* __restrict__ stats,
                                        __nv_bfloat16* __restrict__ dq,
                                        const Args& a, const QItem& w,
                                        const DqWide<D>& L, uint32_t* x) {
  using Gm = Geo<D>;
  using Hf = Half<D, W>;
  float m[2], il[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const size_t at = (size_t)w.bh * a.Tqp + w.q0 + acc_row(2 * e);
    const size_t plane = (size_t)a.B * a.H * a.Tqp;
    m[e] = stats[at];
    il[e] = stats[plane + at];
    dl[e] = stats[2 * plane + at];
  }
  float acc[Hf::kN / 2];
#pragma unroll
  for (int i = 0; i < Hf::kN / 2; ++i) acc[i] = 0.f;

  mbar_wait(L.full_q, 0);
  for (int i = 0; i < w.n; ++i) {
    const int st = i % kStages, k0 = (w.lo + i) * kRows;
    const uint32_t kb = L.k + st * Gm::kTileBytes;
    const uint32_t vb = L.v + st * Gm::kTileBytes;
    mbar_wait(L.full_kv + 8 * st, (i / kStages) & 1);
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<32>::mma(s, Gm::k_desc(L.q, 0, ks), Gm::k_desc(kb, 32 * W, ks),
                  ks > 0);
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<32>::mma(dp, Gm::k_desc(L.dout, 0, ks), Gm::k_desc(vb, 32 * W, ks),
                  ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool mask = needs_mask(a, w.q0, k0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = (j / 2) % 2;
      float p;
      p_ds(a, mask, w.q0 + acc_row(j), k0 + 32 * W + acc_col(j), s[j], dp[j],
           m[e], il[e], dl[e], p, dp[j]);
    }
    uint32_t mine[1][2][4], da[1][4][4];
    to_frags<32>(dp, mine[0]);
    swap_frags<W>(x, mine, da);
    fence_regs(acc);
    fence_frags(da[0]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Hf::template mma<Gm>(acc, da[0][ks], kb, ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(da[0]);
    sync_wide();   // both groups' products have read the stage and x
    if (threadIdx.x == 0 && i + kStages < w.n) {
      const int kn = k0 + kStages * kRows;
      mbar_expect_tx(L.full_kv + 8 * st, 2 * Gm::kTileBytes);
      load_tile<Gm>(kb, &maps.k, &maps.k_tail, L.full_kv + 8 * st, w.g, kn,
                    w.b);
      load_tile<Gm>(vb, &maps.v, &maps.v_tail, L.full_kv + 8 * st, w.g, kn,
                    w.b);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = w.q0 + acc_row(2 * e);
    if (t >= a.Tq) continue;
    __nv_bfloat16* out = dq + (((size_t)w.b * a.Tq + t) * a.H + w.h) * D;
#pragma unroll
    for (int jj = 0; jj < Hf::kN / 8; ++jj)
      *reinterpret_cast<uint32_t*>(out + Hf::col(acc_col(4 * jj))) =
          pack_bf16(acc[4 * jj + 2 * e] * a.scale,
                    acc[4 * jj + 2 * e + 1] * a.scale);
  }
}

// Pass 2 at D = 160 and 256: bwd_dq_tc's block (b, query head, 64-row
// query tile) on two warpgroups.
template <int D>
__global__ void __launch_bounds__(kWide, 1)
bwd_dq_tc2(const __grid_constant__ Maps maps,
           const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
           Args a) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const DqWide<D> L((raw + 1023u) & ~1023u);
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw + (L.x - raw));
  const QItem w = q_item(a, false);

  if (threadIdx.x == 0) {
    mbar_init(L.full_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(L.full_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(L.full_q, 2 * Gm::kTileBytes);
    load_tile<Gm>(L.q, &maps.q, &maps.q_tail, L.full_q, w.h, w.q0, w.b);
    load_tile<Gm>(L.dout, &maps.dout, &maps.do_tail, L.full_q, w.h, w.q0,
                  w.b);
    for (int i = 0; i < min(w.n, kStages); ++i) {
      const int k0 = (w.lo + i) * kRows;
      mbar_expect_tx(L.full_kv + 8 * i, 2 * Gm::kTileBytes);
      load_tile<Gm>(L.k + i * Gm::kTileBytes, &maps.k, &maps.k_tail,
                    L.full_kv + 8 * i, w.g, k0, w.b);
      load_tile<Gm>(L.v + i * Gm::kTileBytes, &maps.v, &maps.v_tail,
                    L.full_kv + 8 * i, w.g, k0, w.b);
    }
  }
  __syncthreads();
  if (threadIdx.x < 128)
    dq_wide<D, 0>(maps, stats, dq, a, w, L, x);
  else
    dq_wide<D, 1>(maps, stats, dq, a, w, L, x);
}

// The shared memory of bwd_dkdv_tc2 from its 1024-aligned base: K and V
// resident, the ring of Q, dO and their statistics (Q's and dO's stages
// one span, which the cluster's sum takes over after the loop), the
// exchange of P^T and dS^T fragments, the barriers.
template <int D>
struct DkdvWide {
  static constexpr int kTile = Geo<D>::kTileBytes;
  static constexpr int kX = 16384;
  static constexpr int kBytes = 1024 + (2 + 2 * kStages) * kTile +
                                kStages * kStatStride + kX +
                                8 * (1 + kStages);
  uint32_t k, v, q, dout, stat, x, full_kv, full;
  __device__ __forceinline__ explicit DkdvWide(uint32_t base)
      : k(base), v(base + kTile), q(base + 2 * kTile),
        dout(base + (2 + kStages) * kTile),
        stat(base + (2 + 2 * kStages) * kTile),
        x(stat + kStages * kStatStride), full_kv(x + kX),
        full(full_kv + 8) {}
  // ring stage st of iteration i: Q, dO and the statistics of query head
  // w.h0 + i / w.per, query tile w.qlo + i % w.per
  __device__ __forceinline__ void load(const Maps& maps, const Args& a,
                                       const KItem& w, int i, int st) const {
    using Gm = Geo<D>;
    const int h = w.h0 + i / w.per, q0 = (w.qlo + i % w.per) * kRows;
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, 2 * kTile + kStatBytes);
    load_tile<Gm>(q + st * kTile, &maps.q, &maps.q_tail, bar, h, q0, w.b);
    load_tile<Gm>(dout + st * kTile, &maps.dout, &maps.do_tail, bar, h, q0,
                  w.b);
    tma_load_3d(stat + st * kStatStride, &maps.stats, bar, q0,
                w.b * a.H + h, 0);
  }
};

// bwd_dkdv_tc's work on two warpgroups: warpgroup W's loop (S^T and dP^T
// over queries [32 W, 32 W + 32) of each query tile, dK and dV over its
// columns), the cluster's sum and its part of dK and dV.
template <int D, int W>
__device__ __forceinline__ void dkdv_wide(const Maps& maps,
                                          __nv_bfloat16* __restrict__ dk,
                                          __nv_bfloat16* __restrict__ dv,
                                          const Args& a, const KItem& w,
                                          const DkdvWide<D>& L,
                                          uint8_t* smem_raw, uint32_t raw) {
  using Gm = Geo<D>;
  using Hf = Half<D, W>;
  const float* st_g = reinterpret_cast<const float*>(smem_raw + (L.stat - raw));
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw + (L.x - raw));
  float ak[Hf::kN / 2], av[Hf::kN / 2];
#pragma unroll
  for (int i = 0; i < Hf::kN / 2; ++i) {
    ak[i] = 0.f;
    av[i] = 0.f;
  }
  mbar_wait(L.full_kv, 0);
  for (int i = 0; i < w.n; ++i) {
    const int st = i % kStages, q0 = (w.qlo + i % w.per) * kRows;
    const uint32_t qb = L.q + st * Gm::kTileBytes;
    const uint32_t dob = L.dout + st * Gm::kTileBytes;
    const float* sm = st_g + st * (kStatStride / 4);   // m, 1/l, delta
    mbar_wait(L.full + 8 * st, (i / kStages) & 1);
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<32>::mma(s, Gm::k_desc(L.k, 0, ks), Gm::k_desc(qb, 32 * W, ks),
                  ks > 0);
#pragma unroll
    for (int ks = 0; ks < Gm::kKSteps; ++ks)
      SS<32>::mma(dp, Gm::k_desc(L.v, 0, ks), Gm::k_desc(dob, 32 * W, ks),
                  ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool mask = needs_mask(a, q0, w.k0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {   // rows the keys, columns the queries
      const int c = 32 * W + acc_col(j);
      p_ds(a, mask, q0 + c, w.k0 + acc_row(j), s[j], dp[j], sm[c],
           sm[kRows + c], sm[2 * kRows + c], s[j], dp[j]);
    }
    uint32_t mine[2][2][4], pd[2][4][4];   // [P^T, dS^T]
    to_frags<32>(s, mine[0]);
    to_frags<32>(dp, mine[1]);
    swap_frags<W>(x, mine, pd);
    fence_regs(av);
    fence_regs(ak);
    fence_frags(pd[0]);
    fence_frags(pd[1]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Hf::template mma<Gm>(av, pd[0][ks], dob, ks);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Hf::template mma<Gm>(ak, pd[1][ks], qb, ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(av);
    fence_regs(ak);
    fence_frags(pd[0]);
    fence_frags(pd[1]);
    sync_wide();   // both groups' products have read the stage and x
    if (threadIdx.x == 0 && i + kStages < w.n) L.load(maps, a, w, i + kStages,
                                                      st);
  }
  // pairs 0 .. kN / 4 - 1 are dK's, the next kN / 4 dV's
  constexpr int kQ = Hf::kN / 4;
  const int S = a.split, per_rank = kMaxPairs<D> / S;
  if (S > 1) {
    cluster_sync();   // every rank's loop is done: the rings are free
    send_pairs(ak, 0, S, w.rank, per_rank, L.q);
    send_pairs(av, kQ, S, w.rank, per_rank, L.q);
    cluster_sync();   // every pair is in its owner's shared memory
  }
  const float2* ring = reinterpret_cast<const float2*>(smem_raw + (L.q - raw));
  const auto col = [](int c) { return Hf::col(c); };
  own_pairs<D>(ak, 0, S, w.rank, per_rank, ring, dk, a, w, a.scale, col);
  own_pairs<D>(av, kQ, S, w.rank, per_rank, ring, dv, a, w, 1.f, col);
}

// Pass 3 at D = 160 and 256: bwd_dkdv_tc's block on two warpgroups, the
// R query heads of a key tile split over a cluster of a.split blocks.
template <int D>
__global__ void __launch_bounds__(kWide, 1)
bwd_dkdv_tc2(const __grid_constant__ Maps maps,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             Args a) {
  using Gm = Geo<D>;
  static_assert((kMaxSplit - 1) * (kMaxPairs<D> / kMaxSplit) * kWide * 8 <=
                    2 * kStages * Gm::kTileBytes,
                "the cluster's sum fits the ring");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const DkdvWide<D> L((raw + 1023u) & ~1023u);
  const KItem w = k_item(a, a.split);

  if (threadIdx.x == 0) {
    mbar_init(L.full_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(L.full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(L.full_kv, 2 * Gm::kTileBytes);
    load_tile<Gm>(L.k, &maps.k, &maps.k_tail, L.full_kv, w.g, w.k0, w.b);
    load_tile<Gm>(L.v, &maps.v, &maps.v_tail, L.full_kv, w.g, w.k0, w.b);
    for (int i = 0; i < min(w.n, kStages); ++i) L.load(maps, a, w, i, i);
  }
  __syncthreads();
  if (threadIdx.x < 128)
    dkdv_wide<D, 0>(maps, dk, dv, a, w, L, smem_raw, raw);
  else
    dkdv_wide<D, 1>(maps, dk, dv, a, w, L, smem_raw, raw);
}

// Shared memory of each pass, with slack to align the tiles to 1024 bytes:
// for fp32 (NP = 3) 148,504 bytes (statistics), 197,648 (dQ) and 198,672
// (dK/dV) at D = 128, one block an SM; at D = 160 185,368, 218,144 and
// 220,192, at D = 256 197,648, 230,424 and 231,448 (a column pair's
// halves, each with its exchange).
constexpr int kSmemLimit = 232448;   // a block's most on the H100
template <int D, int NP>
constexpr int stats_smem() {
  constexpr int kSt = stats_stages<D, NP>();
  return 1024 + (1 + kSt) * NP * Geo<D>::kTileBytes + 8 * (1 + kSt);
}
template <int D, int NP, int C>
constexpr int dq_smem() {
  constexpr int kS = ring_stages<D / C, NP>();
  return 1024 + (2 + 2 * kS) * NP * Geo<D / C>::kTileBytes +
         (C > 1 ? kXBytes + 8 : 0) + 8 * (1 + kS);
}
template <int D, int NP, int C>
constexpr int dkdv_smem() {
  constexpr int kS = ring_stages<D / C, NP>();
  return 1024 + (2 + 2 * kS) * NP * Geo<D / C>::kTileBytes +
         kS * kStatStride + (C > 1 ? kXBytes + 8 : 0) + 8 * (1 + kS);
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

// The blocks a key tile's query heads split over in dK/dV: the least
// power of two (at most kMaxSplit and R) that gives each of the card's sms
// SMs a block, counting the `cols` blocks of a column pair; with a pair
// (whose cluster barrier counts every block's iterations) only divisors
// of R, so that every rank takes as many heads.
int dkdv_split(const Args& a, int nkt, int sms, int cols = 1) {
  const int R = a.H / a.G;
  int split = 1;
  while (2 * split <= kMaxSplit && 2 * split <= R &&
         (cols == 1 || R % (2 * split) == 0) &&
         a.B * a.G * nkt * cols * split < sms)
    split *= 2;
  return split;
}

// kern on `blocks` blocks of `threads` in clusters of `cluster`.
template <typename... Params, typename... Actual>
cudaError_t launch_clusters(void (*kern)(Params...), int blocks, int threads,
                            int smem, int cluster, cudaStream_t stream,
                            Actual&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, std::forward<Actual>(args)...);
}

// The three passes at head size D on NP-piece operands: q, k, v and dout
// are what the tensor maps read (bf16, or for NP = 3 the pieces' (3 B, T,
// heads, D) tensors), o and dout_raw the inputs of delta = rowsum(dO * O)
// in q's dtype.  bf16 at D = 160 and 256 takes the two-warpgroup passes,
// fp32 there the column pair (C = 2: dQ a cluster of 2 blocks a query
// tile, dK/dV of 2 x split a key tile, the statistics at all D columns).
template <int D, int NP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* dout_raw, void* dq, void* dk,
           void* dv, float* stats, const Args& a, cudaStream_t stream) {
  constexpr bool kWideD = NP == 1 && D > 128;
  constexpr int C = NP == 3 && D > 128 ? 2 : 1;
  static_assert(stats_smem<D, NP>() <= kSmemLimit &&
                    dq_smem<D, NP, C>() <= kSmemLimit &&
                    dkdv_smem<D, NP, C>() <= kSmemLimit,
                "a pass's shared memory fits a block");
  static std::atomic<bool> done_st[kDevices], done_dq[kDevices],
      done_kv[kDevices];
  cudaError_t err =
      allow_smem(bwd_stats_tc<D, NP>, stats_smem<D, NP>(), done_st);
  if constexpr (kWideD) {
    if (err == cudaSuccess)
      err = allow_smem(bwd_dq_tc2<D>, DqWide<D>::kBytes, done_dq);
    if (err == cudaSuccess)
      err = allow_smem(bwd_dkdv_tc2<D>, DkdvWide<D>::kBytes, done_kv);
  } else {
    if (err == cudaSuccess)
      err = allow_smem(bwd_dq_tc<D, NP, C>, dq_smem<D, NP, C>(), done_dq);
    if (err == cudaSuccess)
      err = allow_smem(bwd_dkdv_tc<D, NP, C>, dkdv_smem<D, NP, C>(),
                       done_kv);
  }
  if (err != cudaSuccess) return (int)err;
  // the maps over all D columns (the statistics, and every pass at C =
  // 1) and, at C = 2, over D / 2-column slices of the same rows
  Maps maps = {}, half = {};
  const int NB = NP * a.B;   // the maps' batches: NP pieces of each
  if (!bind_context() ||
      !make_maps<D>(&maps.q, &maps.q_tail, q, NB, a.Tq, a.H, kRows) ||
      !make_maps<D>(&maps.k, &maps.k_tail, k, NB, a.Tk, a.G, kRows) ||
      !make_maps<D>(&maps.v, &maps.v_tail, v, NB, a.Tk, a.G, kRows) ||
      !make_maps<D>(&maps.dout, &maps.do_tail, dout, NB, a.Tq, a.H,
                    kRows) ||
      !make_stats_map(&maps.stats, stats, a.B * a.H, a.Tqp))
    return (int)cudaErrorInvalidValue;
  if constexpr (C > 1) {
    constexpr int W = D / C;
    half.stats = maps.stats;
    if (!make_maps<W>(&half.q, &half.q_tail, q, NB, a.Tq, a.H, kRows, D) ||
        !make_maps<W>(&half.k, &half.k_tail, k, NB, a.Tk, a.G, kRows, D) ||
        !make_maps<W>(&half.v, &half.v_tail, v, NB, a.Tk, a.G, kRows, D) ||
        !make_maps<W>(&half.dout, &half.do_tail, dout, NB, a.Tq, a.H, kRows,
                      D))
      return (int)cudaErrorInvalidValue;
  }
  const int nqt = (a.Tq + kRows - 1) / kRows, nkt = (a.Tk + kRows - 1) / kRows;
  bwd_stats_tc<D, NP>
      <<<a.B * a.H * nqt, kThreads, stats_smem<D, NP>(), stream>>>(
          maps, (const Elem<NP>*)o, (const Elem<NP>*)dout_raw, stats, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kWideD || C > 1) {
    if constexpr (kWideD) {
      bwd_dq_tc2<D><<<a.B * a.H * nqt, kWide, DqWide<D>::kBytes, stream>>>(
          maps, stats, (__nv_bfloat16*)dq, a);
      err = cudaGetLastError();
    } else {
      err = launch_clusters(bwd_dq_tc<D, NP, C>, a.B * a.H * nqt * C,
                            kThreads, dq_smem<D, NP, C>(), C, stream, half,
                            stats, (Elem<NP>*)dq, a);
    }
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    err = (cudaError_t)sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    Args ak = a;
    ak.split = dkdv_split(a, nkt, sms, C);
    if constexpr (kWideD)
      err = launch_clusters(bwd_dkdv_tc2<D>, a.B * a.G * nkt * ak.split,
                            kWide, DkdvWide<D>::kBytes, ak.split, stream,
                            maps, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
                            ak);
    else
      err = launch_clusters(bwd_dkdv_tc<D, NP, C>,
                            a.B * a.G * nkt * C * ak.split, kWide,
                            dkdv_smem<D, NP, C>(), C * ak.split, stream,
                            half, (Elem<NP>*)dk, (Elem<NP>*)dv, ak);
    if (err != cudaSuccess) return (int)err;
  } else {
    bwd_dq_tc<D, NP, C><<<a.B * a.H * nqt, kThreads, dq_smem<D, NP, C>(),
                          stream>>>(maps, stats, (Elem<NP>*)dq, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bwd_dkdv_tc<D, NP, C><<<a.B * a.G * nkt, NP == 1 ? kThreads : kWide,
                            dkdv_smem<D, NP, C>(), stream>>>(
        maps, (Elem<NP>*)dk, (Elem<NP>*)dv, a);
  }
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

// The same call for bf16 tensors at D in {16, 32, 64, 80, 128, 160, 256}
// on the tensor cores (D = 160 and 256 on two-warpgroup blocks, dK/dV as
// a cluster launch).  stats: fp32 scratch (3, B H, Tqp) with Tqp = Tq rounded
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
                    (Tq + tcb::kRows - 1) / tcb::kRows * tcb::kRows, scale,
                    1};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return tcb::launch<16, 1>(q, k, v, o, dout, dout, dq, dk, dv, stats, a, st);
    case 32: return tcb::launch<32, 1>(q, k, v, o, dout, dout, dq, dk, dv, stats, a, st);
    case 64: return tcb::launch<64, 1>(q, k, v, o, dout, dout, dq, dk, dv, stats, a, st);
    case 80: return tcb::launch<80, 1>(q, k, v, o, dout, dout, dq, dk, dv, stats, a, st);
    case 128: return tcb::launch<128, 1>(q, k, v, o, dout, dout, dq, dk, dv, stats, a, st);
    case 160: return tcb::launch<160, 1>(q, k, v, o, dout, dout, dq, dk, dv, stats, a, st);
    case 256: return tcb::launch<256, 1>(q, k, v, o, dout, dout, dq, dk, dv, stats, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same call for fp32 tensors at D in {16, 32, 64, 80, 128, 160, 256}
// on the tensor cores: split_pieces writes q's, k's, v's and dout's three
// bf16 pieces (sm90.cuh) to `pieces`, bf16 scratch of 3 (2 q's + 2 k's
// elements), in that order; then the three passes read them (NP = 3; at
// D = 160 and 256 dQ and dK/dV as column pairs, cluster launches).  Base
// pointers 16-byte aligned.  Returns a cudaError_t.
int flash_attention_bwd_split(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, void* dq,
                              void* dk, void* dv, float* stats, void* pieces,
                              int B, int Tq, int Tk, int H, int G, int D,
                              int causal, int window, float scale,
                              void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      (D != 16 && D != 32 && D != 64 && D != 80 && D != 128 && D != 160 &&
       D != 256))
    return (int)cudaErrorInvalidValue;
  const tcb::Args a{B, Tq, Tk, H, G, causal, window,
                    (Tq + tcb::kRows - 1) / tcb::kRows * tcb::kRows, scale,
                    1};
  cudaStream_t st = (cudaStream_t)stream;
  const long long nq = (long long)B * Tq * H * D;
  const long long nk = (long long)B * Tk * G * D;
  __nv_bfloat16* pq = (__nv_bfloat16*)pieces;
  __nv_bfloat16* pk = pq + 3 * nq;
  __nv_bfloat16* pv = pk + 3 * nk;
  __nv_bfloat16* pd = pv + 3 * nk;
  const sm90::SplitJobs jobs = {
      {(const float*)q, (const float*)k, (const float*)v, (const float*)dout},
      {pq, pk, pv, pd},
      {nq, nk, nk, nq}};
  const int err = sm90::launch_split(jobs, 4, st);
  if (err != 0) return err;
  switch (D) {
    case 16: return tcb::launch<16, 3>(pq, pk, pv, o, pd, dout, dq, dk, dv, stats, a, st);
    case 32: return tcb::launch<32, 3>(pq, pk, pv, o, pd, dout, dq, dk, dv, stats, a, st);
    case 64: return tcb::launch<64, 3>(pq, pk, pv, o, pd, dout, dq, dk, dv, stats, a, st);
    case 80: return tcb::launch<80, 3>(pq, pk, pv, o, pd, dout, dq, dk, dv, stats, a, st);
    case 128: return tcb::launch<128, 3>(pq, pk, pv, o, pd, dout, dq, dk, dv, stats, a, st);
    case 160: return tcb::launch<160, 3>(pq, pk, pv, o, pd, dout, dq, dk, dv, stats, a, st);
    default: return tcb::launch<256, 3>(pq, pk, pv, o, pd, dout, dq, dk, dv, stats, a, st);
  }
}

}  // extern "C"
