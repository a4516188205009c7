// K5b: FlashAttention backward -- the gradient of the LM's training attention.
//
// Not a TPU kernel: the counterpart of the reference's jnp custom-VJP backward
// src/repro/models/attention.py::_flash_bwd (the chunked flash attention the
// training forward differentiates through).  Given q (B, T, H, D), k, v
// (B, S, KV, D), the forward's output o and its gradient dO (B, T, H, D), and
// K5's per-row logsumexp lse (B, H, T) float32, it writes dq, dk and dv in the
// inputs' type.  With s = scale q.k (masked to -1e30 where causal and
// row < col, K5's convention) and p = exp(s - lse):
//   delta = rowsum(dO * o),   dv = p^T dO,   dp = dO v^T,
//   ds = p * (dp - delta),    dq = scale ds k,   dk = scale ds^T q.
// GQA: kv head h / (H / KV) serves q head h, so dk and dv sum over the G q
// heads of a kv head.  float32 or bfloat16 inputs; every product and sum in
// float32; no float atomics, so the result is the same on every run.
//
// What bounds it on an H100: operations.  At granite-moe-3b-a800m's training
// shape (B 4, T = S 2048, H 24, KV 8, D 64, causal) the five products do
// 5 * 2 * B H T^2 D / 2 = 1.29e11 flops against 40 MB of bytes; at the bf16
// tensor cores' 989 TFLOP/s that is 0.130 ms.  This first kernel is simple
// and right, not fast: all its products run on the CUDA cores in float32, so
// its own ceiling is the 67 TFLOP/s f32 rate, and it recomputes the scores
// and dp in the dq pass (seven products where the bound counts five).  The
// tensor-core redesign (mma.sync on bf16 tiles, as K5's bf16 path) is queued.
//
// Three launches a call, one block of 256 threads (16 x 16) per tile:
// 1. bwd_delta: one warp per (b, t, h) row, delta (B, H, T) float32 into a
//    scratch tensor the wrapper allocates.
// 2. bwd_dkdv: one block per (64 key rows, kv head, batch).  K and V of its
//    key rows sit in shared memory for the whole block; it loops over the G q
//    heads and over the 64-row query tiles that can see its keys (causal:
//    from the diagonal tile on), staging Q, dO, lse and delta per tile.  Each
//    thread owns 4 query rows x 4 key columns of the score and dp tiles (two
//    passes over D, float4 reads from rows padded to D + 4 floats), writes p
//    and ds to shared memory, then accumulates 4 key rows x D/16 columns of
//    dk and of dv in registers over the tile's query rows.  dk and dv are
//    written once, so no two blocks touch one output.
// 3. bwd_dq: one block per (64 query rows, q head, batch), Q, dO, lse and
//    delta staged once; it loops over the key tiles the rows can see,
//    recomputes s and dp, writes ds to shared memory and accumulates 4 query
//    rows x D/16 columns of dq in registers.
// Rows at or beyond T and keys at or beyond S load as zeros and are masked
// (p = 0), so T and S are any lengths; D is 32, 64 or 128 (a template
// argument).  Shared memory at D = 128: 170 KB (dkdv), 153 KB (dq): one block
// an SM.  Times, the bound and the compiler's register counts are in PERF.md
// (chip_smoke.py measures them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns (tx + 16 j)
constexpr int PS = BK + 4;    // padded row of the p and ds tiles (float4 reads)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of a (batch, row, head) tensor whose last axis is contiguous.
struct Strides {
  long long b, t, h;
};

// Loads rows [r0, r0 + 64) of one head of a (batch, row, head, D) tensor into
// a 64 x (D + 4) float tile; rows at or beyond n load as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long st,
                                          int r0, int n) {
  constexpr int DP = D + 4;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D, t = r0 + r;
    dst[r * DP + d] = t < n ? to_f32(base[t * st + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty*4 + i][d] * B[tx + 16 j][d] over two 64 x (D + 4) tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* Bm, int ty, int tx) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty * 4 + i) * DP + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * DP + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                     a[i].w * b[j].w;
  }
}

// delta[b, h, t] = sum_d dO * o, one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, int T_len, int D, Strides os, Strides ds) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * (THREADS / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (t >= T_len) return;
  const T* ob = o + b * os.b + t * os.t + h * os.h;
  const T* db = dout + b * ds.b + t * ds.t + h * ds.h;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += to_f32(ob[d]) * to_f32(db[d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[((long long)b * gridDim.y + h) * T_len + t] = sum;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return (4 * 64 * (D + 4) + 2 * 64 * PS + 2 * BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
         int T_len, int S, int H, int G, Strides qs, Strides ks, Strides vs,
         Strides dos, Strides dks, Strides dvs, float scale, int causal) {
  constexpr int DP = D + 4;
  constexpr int DPT = D / 16;  // output columns per thread: tx + 16 j
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;             // BK x DP
  float* sV = sK + BK * DP;     // BK x DP
  float* sQ = sV + BK * DP;     // BQ x DP
  float* sO = sQ + BQ * DP;     // BQ x DP: dO
  float* sP = sO + BQ * DP;     // BQ x PS: p[query][key]
  float* sS = sP + BQ * PS;     // BQ x PS: ds[query][key]
  float* sL = sS + BQ * PS;     // BQ: lse
  float* sD = sL + BQ;          // BQ: delta

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  load_tile<T, D>(sK, k + b * ks.b + kvh * ks.h, ks.t, k0, S);
  load_tile<T, D>(sV, v + b * vs.b + kvh * vs.h, vs.t, k0, S);

  float adk[4][DPT], adv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  // Causal: a query row t sees key s iff t >= s, so tiles below k0 see none.
  const int qstart = causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const float* lb = lse + ((long long)b * H + h) * T_len;
    const float* deb = delta + ((long long)b * H + h) * T_len;
    for (int q0 = qstart; q0 < T_len; q0 += BQ) {
      __syncthreads();  // the last tile's reads are done
      load_tile<T, D>(sQ, qb, qs.t, q0, T_len);
      load_tile<T, D>(sO, db, dos.t, q0, T_len);
      for (int r = tid; r < BQ; r += THREADS) {
        const int t = q0 + r;
        sL[r] = t < T_len ? lb[t] : 0.f;
        sD[r] = t < T_len ? deb[t] : 0.f;
      }
      __syncthreads();

      // p and ds of query rows ty*4 + i against key columns tx + 16 j.
      float sc[4][4], dp[4][4];
      tile_dot<D>(sc, sQ, sK, ty, tx);
      tile_dot<D>(dp, sO, sV, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, col = k0 + c;
          const bool vis = row < T_len && col < S && (!causal || row >= col);
          const float p = vis ? expf(sc[i][j] * scale - sL[r]) : 0.f;
          sP[r * PS + c] = p;
          sS[r * PS + c] = p * (dp[i][j] - sD[r]);
        }
      }
      __syncthreads();

      // dv += p^T dO and dk += ds^T q for key rows ty*4 + i, columns tx + 16 j.
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sP[r * PS + ty * 4]);
        const float4 s4 = *reinterpret_cast<const float4*>(&sS[r * PS + ty * 4]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float o = sO[r * DP + tx + 16 * j];
          const float qq = sQ[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] += pv[i] * o;
            adk[i][j] += sv[i] * qq;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty * 4 + i;
    if (s >= S) continue;
    T* kb = dk + b * dks.b + s * dks.t + kvh * dks.h;
    T* vb = dv + b * dvs.b + s * dvs.t + kvh * dvs.h;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      kb[tx + 16 * j] = from_f32<T>(adk[i][j] * scale);
      vb[tx + 16 * j] = from_f32<T>(adv[i][j]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (4 * 64 * (D + 4) + 64 * PS + 2 * BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, int T_len, int S,
       int G, Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
       float scale, int causal) {
  constexpr int DP = D + 4;
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // BQ x DP
  float* sO = sQ + BQ * DP;     // BQ x DP: dO
  float* sK = sO + BQ * DP;     // BK x DP
  float* sV = sK + BK * DP;     // BK x DP
  float* sS = sV + BK * DP;     // BQ x PS: ds[query][key]
  float* sL = sS + BQ * PS;     // BQ: lse
  float* sD = sL + BQ;          // BQ: delta

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  load_tile<T, D>(sQ, q + b * qs.b + h * qs.h, qs.t, q0, T_len);
  load_tile<T, D>(sO, dout + b * dos.b + h * dos.h, dos.t, q0, T_len);
  const long long row0 = ((long long)b * gridDim.y + h) * T_len;
  for (int r = tid; r < BQ; r += THREADS) {
    const int t = q0 + r;
    sL[r] = t < T_len ? lse[row0 + t] : 0.f;
    sD[r] = t < T_len ? delta[row0 + t] : 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // Causal: rows below q0 + BQ see no column at or beyond q0 + BQ.
  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the last tile's reads are done; Q, dO, lse, delta staged
    load_tile<T, D>(sK, kb, ks.t, k0, S);
    load_tile<T, D>(sV, vb, vs.t, k0, S);
    __syncthreads();

    float sc[4][4], dp[4][4];
    tile_dot<D>(sc, sQ, sK, ty, tx);
    tile_dot<D>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        const bool vis = row < T_len && col < S && (!causal || row >= col);
        const float p = vis ? expf(sc[i][j] * scale - sL[r]) : 0.f;
        sS[r * PS + c] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();

    // dq += ds k for query rows ty*4 + i, columns tx + 16 j.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kk = sK[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += dsv[i] * kk;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= T_len) continue;
    T* ob = dq + b * dqs.b + t * dqs.t + h * dqs.h;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* dout, const float* lse,
             const float* delta, T* dq, T* dk, T* dv, int B, int T_len, int S,
             int H, int KV, const Strides* st, float scale, int causal,
             cudaStream_t s) {
  const int G = H / KV;
  const size_t smem_kv = dkdv_smem_bytes<D>(), smem_q = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  // st: q, k, v, o, dO, dq, dk, dv
  bwd_dkdv<T, D><<<dim3((S + BK - 1) / BK, KV, B), THREADS, smem_kv, s>>>(
      q, k, v, dout, lse, delta, dk, dv, T_len, S, H, G, st[0], st[1], st[2],
      st[4], st[6], st[7], scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq<T, D><<<dim3((T_len + BQ - 1) / BQ, H, B), THREADS, smem_q, s>>>(
      q, k, v, dout, lse, delta, dq, T_len, S, G, st[0], st[1], st[2], st[4],
      st[5], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int T_len, int S, int H, int KV, int D,
           const long long* st24, float scale, int causal, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{st24[3 * i], st24[3 * i + 1], st24[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  float* fdelta = static_cast<float*>(delta);
  bwd_delta<T><<<dim3((T_len + THREADS / 32 - 1) / (THREADS / 32), H, B), THREADS, 0, s>>>(
      static_cast<const T*>(o), tdo, fdelta, T_len, D, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* flse = static_cast<const float*>(lse);
#define K5B_CASE(DIM)                                                          \
  case DIM:                                                                    \
    return launch_d<T, DIM>(tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq), \
                            static_cast<T*>(dk), static_cast<T*>(dv), B, T_len, \
                            S, H, KV, st, scale, causal, s);
  switch (D) {
    K5B_CASE(32)
    K5B_CASE(64)
    K5B_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K5B_CASE
}

}  // namespace

extern "C" {

// strides: 24 element strides, (batch, row, head) of q, k, v, o, dO, dq, dk
// and dv in turn.  lse: K5's (B, H, T) float32 logsumexp, contiguous; delta:
// (B, H, T) float32 scratch, contiguous.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int T, int S, int H, int KV, int D,
                            const long long* strides, float scale, int causal,
                            void* stream) {
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, S, H, KV,
                       D, strides, scale, causal, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int T, int S, int H, int KV, int D,
                             const long long* strides, float scale, int causal,
                             void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T,
                               S, H, KV, D, strides, scale, causal, stream);
}

}  // extern "C"
