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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
           float* __restrict__ y, float* __restrict__ sT, int T_len, int H) {
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
// launches

struct Args {
  const void *r, *k, *v;
  const float *w, *u, *s0;
  float *y, *sT;
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
      a.sT, a.T_len, a.H);
  return (int)cudaGetLastError();
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
// y: (B, T, H, N) float32; sT: (B, H, N, N) float32.  All contiguous and
// 16-byte aligned.  variant 0 is wkv6_split, 1 wkv6_seq.  Returns a
// cudaError_t.
int wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* sT, int B,
             int T_len, int H, int N, int dtype, int variant, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (T_len <= 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, w, u, s0, y, sT, B, T_len, H, (cudaStream_t)stream};
  if (dtype == 0) return dispatch_n<float>(variant, N, a);
  if (dtype == 1) return dispatch_n<__nv_bfloat16>(variant, N, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
