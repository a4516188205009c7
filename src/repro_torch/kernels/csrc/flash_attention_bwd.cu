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
// heads of a kv head.  A query offset q_off >= 0 (context parallelism: a
// rank's T chunk of queries against the whole gathered K/V) makes local row
// t global row q_off + t of the causal mask; key tiles that no local row
// sees (past q_off + T) get no query tile and write zeros, which the K/V
// gather's reduce-scatter then sums with the other ranks' gradients.  The
// bf16 dk/dv pass is built twice (template flag OFF): q_off = 0 launches the
// build whose offset is the constant 0, the code without an offset (the
// build with the offset as an argument was 1.9% slower at q_off = 0 on an
// H100, three times the spread of one build's runs; the dq pass's 0.1-0.7%
// was within or at the edge of it, scripts/attention_graph_ms.py); the
// other kernels take it as an argument.
// No float atomics: every output element is written once by the block that
// owns it, so the result is the same on every run.
//
// What bounds it on an H100: operations.  At granite-moe-3b-a800m's training
// shape (B 4, T = S 2048, H 24, KV 8, D 64, causal) the five products do
// 5 * 2 * B H T^2 D / 2 = 1.29e11 flops against 135 MB of bytes: 0.130 ms at
// the bf16 tensor cores' 989 TFLOP/s (bytes: 0.040 ms); at Mistral-Nemo-12B's
// (B 2, H 32, KV 8, D 128) 0.174 ms.  The dq pass recomputes s and dp (seven
// products where the bound counts five): dropping that without atomics
// would write and re-read a (T x S) ds, which costs more than the two
// products it saves.
//
// Three launches a call:
// 1. bwd_delta: one warp per (b, t, h) row, delta (B, H, T) float32 into a
//    scratch tensor the wrapper allocates.
// 2. the dk/dv pass, one block per (64 key rows, kv head, batch): it loops
//    over the G q heads and the query tiles that can see its keys (causal:
//    from the diagonal tile on) and writes dk and dv once.
// 3. the dq pass, one block per (64 query rows, q head, batch): it loops over
//    the key tiles its rows can see and writes dq once.
// Rows at or beyond T and keys at or beyond S load as zeros and are masked
// (p = 0, the same as exp(-1e30 - lse)), so T and S are any lengths; D is
// 32, 64 or 128 (a template argument), and 192 in bfloat16 (nemotron-4-340b's
// heads).  The dtype picks one of two designs:
//
// * bfloat16 (the trained models' type): bwd_dkdv_bf16 and bwd_dq_bf16, all
//   products on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), K5's bf16 layout: four warps a block, one per 16 rows;
//   64-row tiles in shared memory with rows padded to D + 8 elements (the
//   eight 16-byte rows of an ldmatrix fall in distinct banks), filled by
//   16-byte cp.async (src-size 0 past the ragged end writes zeros).
//   - dk/dv: K and V of the block's 64 keys are staged once; Q, dO and the
//     tile's lse and delta (4-byte cp.async: a (B, H, T) row need not be
//     16-byte aligned) are double-buffered, tile n + 1 in flight while tile
//     n is used.  The products are taken transposed, so that nothing but
//     the tiles goes through shared memory: S^T = K Q^T and dP^T = V dO^T
//     (K and V as A fragments by ldmatrix, Q and dO as B fragments), then
//     P^T = exp(scale S^T - lse[col]) and dS^T = P^T (dP^T - delta[col]) in
//     f32 registers, each rounded to bf16 and used directly as the A
//     fragment of dV += P^T dO and dK += dS^T Q (the m16n8 C layout is the
//     m16n8k16 A layout); dO and Q are read with ldmatrix.trans for those.
//   - dq: Q and dO are read once into registers as A fragments; K and V
//     tiles are double-buffered.  S = Q K^T and dP = dO V^T, dS rounded to
//     bf16 as the A fragment of dQ += dS K, K read with ldmatrix.trans.
//   - Register budget: each warp holds a 16 x D accumulator (two in the
//     dk/dv pass: D f32 registers a thread at D = 128) beside its 16-row
//     score and dp tiles.  At D = 128 both passes take the tile's 64
//     columns 32 at a time (CW below), which halves the score and dp tiles
//     (16 registers each instead of 32) rather than splitting D between
//     warps or shrinking the block to 32 rows, which would halve the rows
//     that share each staged tile.  K and V fragments of the dk/dv pass are
//     re-read from shared memory for each product instead of held.  ptxas
//     (sm_90a, CUDA 12.8): bwd_dkdv_bf16 249 / 209 / 149 registers at
//     D = 128 / 64 / 32, bwd_dq_bf16 241 / 190 / 146, no spill (chip_smoke.py's
//     ptxas line; a spill fails it), so two blocks of 128 threads fit the
//     SM's 65,536 registers.
//   - Causal: query (dk/dv) or key (dq) tiles wholly on the far side of the
//     diagonal are never loaded; only a warp's diagonal tile and the ragged
//     ends are masked.  The heaviest tiles start first: the dq pass reverses
//     blockIdx.x (the last query tiles see the most keys), the dk/dv pass
//     keeps it (the first key tiles see the most queries).
//   - Two blocks fit on an SM (six 64 x (D + 8) tiles: 104 KB at D = 128).
//   - D = 192: a 16 x 192 f32 accumulator is 96 registers a thread, and the
//     dk/dv pass holds two.  So that pass splits the output columns: two
//     blocks take each key tile (blockIdx.x = 2 tile + half), each computes
//     the whole S^T and dP^T (their k-steps run over all of D) but keeps
//     and writes only its 96 columns of dk and dv; S^T and dP^T are
//     computed twice, 1.5x the pass's products.  The dq pass keeps its one
//     accumulator and re-reads Q's and dO's fragments from their tiles at
//     each k-step instead of holding them.  151 KB of shared memory a block:
//     one block an SM (ptxas: dk/dv 231 registers, dq 238, no spill).
//   q, k, v and dO need 16-byte-aligned rows: the wrapper raises on a base
//   pointer or a row stride that is not (it never falls back).
// * float32 (only the smoke configs' type): bwd_dkdv and bwd_dq on the CUDA
//   cores, every product in f32 (TF32 keeps 10 mantissa bits and cannot meet
//   the f32 limit, as for K5's f32 path).  One block of 256 threads (16 x 16)
//   per tile: K and V (dk/dv) or Q and dO (dq) sit in shared memory for the
//   whole block, the other two are staged per tile; each thread owns 4 x 4
//   of the score and dp tiles (float4 reads from rows padded to D + 4), p
//   and ds go through shared memory, and 4 rows x D/16 columns of each
//   accumulator stay in registers.  Shared memory at D = 128: 170 KB
//   (dk/dv), 153 KB (dq): one block an SM.
//
// Times, the bound and the compiler's register counts are in PERF.md
// (chip_smoke.py measures them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns (tx + 16 j)
constexpr int PS = BK + 4;    // padded row of the p and ds tiles (float4 reads)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
         Strides dos, Strides dks, Strides dvs, float scale, int causal, int q_off) {
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

  // Causal: a query row t sees key s iff q_off + t >= s, so the tiles below
  // the one holding row k0 - q_off see none.
  const int qstart = causal ? max(0, k0 - q_off) / BQ * BQ : 0;
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
          const bool vis = row < T_len && col < S && (!causal || q_off + row >= col);
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
       float scale, int causal, int q_off) {
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

  // Causal: rows below q0 + BQ see no column at or beyond q_off + q0 + BQ.
  const int kend = causal ? min(S, q_off + q0 + BQ) : S;
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
        const bool vis = row < T_len && col < S && (!causal || q_off + row >= col);
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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ---------------------------------------------------------------------------
// The copy, ldmatrix and mma helpers repeat flash_attention.cu's: each
// library is built from its one source and keyed by that file's hash
// (kernels/build.py), so K5's binary stays as it was.

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;  // four warps, one per 16 rows of the block's 64
constexpr float LOG2E = 1.4426950408889634f;

// Columns of the score and dp tiles a warp holds at once (see the note).
template <int D>
constexpr int CHUNK_COLS = D >= 128 ? 32 : 64;

// Output columns of dk and dv a dk/dv block holds (see the note).
template <int D>
constexpr int DKDV_COLS = D > 128 ? D / 2 : D;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src-size 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes; src-size 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for a 16 x 16 bf16 A fragment and a 16 x 8 B fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t holds
// C/D elements (g, 2t..2t+1) in c[0..1] and (g + 8, 2t..2t+1) in c[2..3];
// A elements (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..) in
// a[0..3]; B elements (k = 2t.., n = g) in b0 and (k = 2t + 8.., n = g) in b1.
// So the C fragments of two neighbouring 8-column tiles j = 2 kk, 2 kk + 1,
// rounded to bf16, are the A fragment of k-step kk.

// Rows [r0, r0 + 64) of one head (D bf16 each, row stride st) into a
// 64 x (D + 8) tile; rows at or beyond n are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long st,
                                          int r0, int n) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += TC_THREADS) {
    const int r = c / CH, ch = c % CH, t = r0 + r;
    const bool ok = t < n;
    cp_async16(smem_u32(dst + r * (D + 8) + ch * 8), ok ? base + t * st + ch * 8 : base, ok);
  }
}

// The A fragment of rows [row0, row0 + 16) and k-step kk of a row-major tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, smem_u32(tile + (row0 + (lane & 15)) * (D + 8) + kk * 16 + (lane >> 4) * 8));
}

// acc[2 nn .. 2 nn + 1] += a x (rows [r0 + 16 nn, + 16) of tile)^T for the
// k-step kk: the B fragments of a tile stored [n][k].
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&a)[4],
                                        const bf16* tile, int r0, int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nn = 0; nn < NT / 2; ++nn) {
    uint32_t b[4];
    const int r = r0 + nn * 16 + (lane & 7) + ((lane >> 4) << 3);
    ldmatrix_x4(b, smem_u32(tile + r * (D + 8) + kk * 16 + ((lane >> 3) & 1) * 8));
    mma_bf16(acc[2 * nn], a, b[0], b[1]);
    mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
  }
}

// acc (16 x DO) += a (16 x 16 of k-step kk) x rows [r0 + 16 kk, + 16),
// columns [c0, c0 + DO) of a tile stored [k][n]: B fragments by
// ldmatrix.trans.
template <int D, int DO = D>
__device__ __forceinline__ void mma_ab(float (&acc)[DO / 8][4], const uint32_t (&a)[4],
                                       const bf16* tile, int r0, int c0 = 0) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int dn = 0; dn < DO / 16; ++dn) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, smem_u32(tile + r * (D + 8) + c0 + dn * 16 + (lane >> 4) * 8));
    mma_bf16(acc[2 * dn], a, b[0], b[1]);
    mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
  }
}

// Writes a warp's 16 x DO accumulator times mul as bf16 rows [row0, row0 +
// 16), columns [c0, c0 + DO) of out (rows at or beyond n skipped), staged
// through the warp's own 16 rows of a shared tile for 16-byte stores.
template <int D, int DO = D>
__device__ __forceinline__ void store_rows(bf16* stage, const float (&acc)[DO / 8][4], float mul,
                                           bf16* out, long long st, int row0, int n, int c0 = 0) {
  constexpr int CH = DO / 8, LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int col = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + col) =
        __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH, t = row0 + r;
    if (t < n)
      *reinterpret_cast<uint4*>(out + t * st + c0 + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + ch * 8);
  }
}

template <int D>
constexpr size_t dkdv_tc_smem_bytes() {  // K, V, two Q and two dO tiles; two lse and delta rows
  return 6 * 64 * (D + 8) * sizeof(bf16) + 4 * BQ * sizeof(float);
}

template <int D, bool OFF>
__global__ void __launch_bounds__(TC_THREADS, 2)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len, int S, int H,
              int G, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
              Strides dvs, float scale, int causal, int q_off_arg) {
  const int q_off = OFF ? q_off_arg : 0;
  constexpr int LD = D + 8, KS = D / 16, CW = CHUNK_COLS<D>, NT = CW / 8;
  constexpr int DO = DKDV_COLS<D>, SPLIT = D / DO;  // output columns a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);    // BK x LD, later dk
  bf16* sV = sK + BK * LD;                         // BK x LD, later dv
  bf16* sQ = sV + BK * LD;                         // 2 x BQ x LD
  bf16* sO = sQ + 2 * BQ * LD;                     // 2 x BQ x LD: dO
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * LD);  // 2 x BQ: lse
  float* sD = sL + 2 * BQ;                                 // 2 x BQ: delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x / SPLIT * BK;  // the first key tiles see the most queries
  const int c0 = blockIdx.x % SPLIT * DO;   // the block's first output column
  const int kvh = blockIdx.y, b = blockIdx.z;
  load_rows<D>(sK, k + b * ks.b + kvh * ks.h, ks.t, k0, S);
  load_rows<D>(sV, v + b * vs.b + kvh * vs.h, vs.t, k0, S);

  // Causal: a query row t sees key s iff q_off + t >= s, so the tiles below
  // the one holding row k0 - q_off see none; past the last row, none does
  // (nq = 0: dk and dv of these keys are written as zeros).
  const int qstart = !causal ? 0 : OFF ? max(0, k0 - q_off) / BQ * BQ : k0;
  const int nq = qstart < T_len ? (T_len - qstart + BQ - 1) / BQ : 0;
  const int total = G * nq;  // (q head, query tile) pairs, head-major
  auto load_q = [&](int it, int buf) {
    const int h = kvh * G + it / nq, q0 = qstart + (it % nq) * BQ;
    load_rows<D>(sQ + buf * BQ * LD, q + b * qs.b + h * qs.h, qs.t, q0, T_len);
    load_rows<D>(sO + buf * BQ * LD, dout + b * dos.b + h * dos.h, dos.t, q0, T_len);
    const int r = tid & (BQ - 1), t = q0 + r;
    const float* src = (tid < BQ ? lse : delta) + ((long long)b * H + h) * T_len;
    cp_async4(smem_u32((tid < BQ ? sL : sD) + buf * BQ + r), t < T_len ? src + t : src, t < T_len);
  };
  if (total > 0) load_q(0, 0);
  cp_async_commit();

  float adk[DO / 8][4], adv[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;
  const int krow = warp * 16;  // the warp's first key row in the tile
  const int key_a = k0 + krow + g, key_b = key_a + 8;
  const float sl2 = scale * LOG2E;

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1, q0 = qstart + (it % nq) * BQ;
    if (it + 1 < total) {
      load_q(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tq = sQ + buf * BQ * LD;
    const bf16* to = sO + buf * BQ * LD;
    const float* tl = sL + buf * BQ;
    const float* td = sD + buf * BQ;
    // The diagonal tile and the ragged ends.
    const bool masked = q0 + BQ > T_len || k0 + BK > S || (causal && q_off + q0 < k0 + krow + 16);

#pragma unroll
    for (int qc = 0; qc < BQ; qc += CW) {
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x CW queries.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        load_a<D>(a, sK, krow, kk);
        mma_abt<D, NT>(s, a, tq, qc, kk);
        load_a<D>(a, sV, krow, kk);
        mma_abt<D, NT>(dp, a, to, qc, kk);
      }
      // P^T and dS^T (column = query), rounded to bf16 as A fragments.
      uint32_t pf[CW / 16][4], dsf[CW / 16][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = qc + j * 8 + 2 * t4;
        const float l0 = tl[c] * LOG2E, l1 = tl[c + 1] * LOG2E;
        const float d0 = td[c], d1 = td[c + 1];
        float p[4] = {exp2f(s[j][0] * sl2 - l0), exp2f(s[j][1] * sl2 - l1),
                      exp2f(s[j][2] * sl2 - l0), exp2f(s[j][3] * sl2 - l1)};
        if (masked) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = q0 + c + (e & 1), key = e < 2 ? key_a : key_b;
            if (t >= T_len || key >= S || (causal && q_off + t < key)) p[e] = 0.f;
          }
        }
        pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsf[j >> 1][(j & 1) * 2] = pack_bf16(p[0] * (dp[j][0] - d0), p[1] * (dp[j][1] - d1));
        dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2] * (dp[j][2] - d0), p[3] * (dp[j][3] - d1));
      }
      // dV += P^T dO and dK += dS^T Q over the chunk's query rows.
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk) {
        mma_ab<D, DO>(adv, pf[kk], to, qc + kk * 16, c0);
        mma_ab<D, DO>(adk, dsf[kk], tq, qc + kk * 16, c0);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }
  cp_async_wait<0>();  // no query tile: K and V may still be landing
  __syncthreads();

  // The warp read only its own 16 rows of sK and sV: they stage its output.
  store_rows<D, DO>(sK + krow * LD, adk, scale, dk + b * dks.b + kvh * dks.h, dks.t, k0 + krow, S, c0);
  store_rows<D, DO>(sV + krow * LD, adv, 1.f, dv + b * dvs.b + kvh * dvs.h, dvs.t, k0 + krow, S, c0);
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {  // Q, dO, two K and two V tiles
  return 6 * 64 * (D + 8) * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, int T_len, int S, int G, Strides qs, Strides ks,
            Strides vs, Strides dos, Strides dqs, float scale, int causal, int q_off) {
  constexpr int LD = D + 8, KS = D / 16, CW = CHUNK_COLS<D>, NT = CW / 8;
  constexpr bool HOLD = D <= 128;  // Q's and dO's fragments in registers (see the note)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD, later dq
  bf16* sO = sQ + BQ * LD;                       // BQ x LD: dO
  bf16* sK = sO + BQ * LD;                       // 2 x BK x LD
  bf16* sV = sK + 2 * BK * LD;                   // 2 x BK x LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  load_rows<D>(sQ, q + b * qs.b + h * qs.h, qs.t, q0, T_len);
  load_rows<D>(sO, dout + b * dos.b + h * dos.h, dos.t, q0, T_len);
  auto load_kv = [&](int k0, int buf) {
    load_rows<D>(sK + buf * BK * LD, kb, ks.t, k0, S);
    load_rows<D>(sV + buf * BK * LD, vb, vs.t, k0, S);
  };

  // Causal: rows below q0 + BQ see no column at or beyond q_off + q0 + BQ.
  const int kend = causal ? min(S, q_off + q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  load_kv(0, 0);
  cp_async_commit();

  const int wrow = q0 + warp * 16;  // the warp's first query row
  const int row_a = wrow + g, row_b = row_a + 8;
  const long long lrow = ((long long)b * gridDim.y + h) * T_len;
  const float l_a = row_a < T_len ? lse[lrow + row_a] * LOG2E : 0.f;
  const float l_b = row_b < T_len ? lse[lrow + row_b] * LOG2E : 0.f;
  const float d_a = row_a < T_len ? delta[lrow + row_a] : 0.f;
  const float d_b = row_b < T_len ? delta[lrow + row_b] : 0.f;
  const float sl2 = scale * LOG2E;
  uint32_t qf[HOLD ? KS : 1][4], of[HOLD ? KS : 1][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK, buf = it & 1;
    if (it + 1 < ntiles) {
      load_kv(k0 + BK, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (HOLD && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        load_a<D>(qf[HOLD ? kk : 0], sQ, warp * 16, kk);
        load_a<D>(of[HOLD ? kk : 0], sO, warp * 16, kk);
      }
    }
    const bf16* tk = sK + buf * BK * LD;
    const bf16* tv = sV + buf * BK * LD;
    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > q_off + wrow);

#pragma unroll
    for (int kc = 0; kc < BK; kc += CW) {
      // S = Q K^T and dP = dO V^T: the warp's 16 rows x CW keys.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if constexpr (HOLD) {
          mma_abt<D, NT>(s, qf[kk], tk, kc, kk);
          mma_abt<D, NT>(dp, of[kk], tv, kc, kk);
        } else {
          uint32_t a[4];
          load_a<D>(a, sQ, warp * 16, kk);
          mma_abt<D, NT>(s, a, tk, kc, kk);
          load_a<D>(a, sO, warp * 16, kk);
          mma_abt<D, NT>(dp, a, tv, kc, kk);
        }
      }
      uint32_t dsf[CW / 16][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[4] = {exp2f(s[j][0] * sl2 - l_a), exp2f(s[j][1] * sl2 - l_a),
                      exp2f(s[j][2] * sl2 - l_b), exp2f(s[j][3] * sl2 - l_b)};
        if (masked) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + kc + j * 8 + 2 * t4 + (e & 1);
            if (col >= S || (causal && col > q_off + (e < 2 ? row_a : row_b))) p[e] = 0.f;
          }
        }
        dsf[j >> 1][(j & 1) * 2] = pack_bf16(p[0] * (dp[j][0] - d_a), p[1] * (dp[j][1] - d_a));
        dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2] * (dp[j][2] - d_b), p[3] * (dp[j][3] - d_b));
      }
      // dQ += dS K over the chunk's keys.
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk) mma_ab<D>(acc, dsf[kk], tk, kc + kk * 16);
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  // The warp read only its own 16 rows of sQ: they stage its output.
  store_rows<D>(sQ + warp * 16 * LD, acc, scale, dq + b * dqs.b + h * dqs.h, dqs.t, wrow, T_len);
}

template <int D>
int launch_bf16_d(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                  const float* lse, const float* delta, bf16* dq, bf16* dk, bf16* dv,
                  int B, int T_len, int S, int H, int KV, const Strides* st, float scale,
                  int causal, int q_off, cudaStream_t s) {
  const int G = H / KV;
  const size_t smem_kv = dkdv_tc_smem_bytes<D>(), smem_q = dq_tc_smem_bytes<D>();
  auto* dkdv = q_off ? &bwd_dkdv_bf16<D, true> : &bwd_dkdv_bf16<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  // st: q, k, v, o, dO, dq, dk, dv
  dkdv<<<dim3((S + BK - 1) / BK * (D / DKDV_COLS<D>), KV, B), TC_THREADS, smem_kv, s>>>(
      q, k, v, dout, lse, delta, dk, dv, T_len, S, H, G, st[0], st[1], st[2], st[4],
      st[6], st[7], scale, causal, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_bf16<D><<<dim3((T_len + BQ - 1) / BQ, H, B), TC_THREADS, smem_q, s>>>(
      q, k, v, dout, lse, delta, dq, T_len, S, G, st[0], st[1], st[2], st[4], st[5],
      scale, causal, q_off);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* dout, const float* lse,
             const float* delta, T* dq, T* dk, T* dv, int B, int T_len, int S,
             int H, int KV, const Strides* st, float scale, int causal, int q_off,
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
      st[4], st[6], st[7], scale, causal, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq<T, D><<<dim3((T_len + BQ - 1) / BQ, H, B), THREADS, smem_q, s>>>(
      q, k, v, dout, lse, delta, dq, T_len, S, G, st[0], st[1], st[2], st[4],
      st[5], scale, causal, q_off);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int T_len, int S, int H, int KV, int D,
           const long long* st24, float scale, int causal, int q_off, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || q_off < 0) return (int)cudaErrorInvalidValue;
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
    if constexpr (sizeof(T) == 2)                                              \
      return launch_bf16_d<DIM>(tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq), \
                                static_cast<T*>(dk), static_cast<T*>(dv), B, T_len, \
                                S, H, KV, st, scale, causal, q_off, s);        \
    else                                                                       \
      return launch_d<T, DIM>(tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq), \
                              static_cast<T*>(dk), static_cast<T*>(dv), B, T_len, \
                              S, H, KV, st, scale, causal, q_off, s);
  switch (D) {
    K5B_CASE(32)
    K5B_CASE(64)
    K5B_CASE(128)
    case 192:  // bfloat16 only
      if constexpr (sizeof(T) == 2)
        return launch_bf16_d<192>(tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq),
                                  static_cast<T*>(dk), static_cast<T*>(dv), B, T_len, S, H, KV, st,
                                  scale, causal, q_off, s);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K5B_CASE
}

}  // namespace

extern "C" {

// strides: 24 element strides, (batch, row, head) of q, k, v, o, dO, dq, dk
// and dv in turn.  lse: K5's (B, H, T) float32 logsumexp, contiguous; delta:
// (B, H, T) float32 scratch, contiguous.  q_offset: the global row of q's
// first row under the causal mask (0 for a whole sequence).
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int T, int S, int H, int KV, int D,
                            const long long* strides, float scale, int causal,
                            int q_offset, void* stream) {
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, S, H, KV,
                       D, strides, scale, causal, q_offset, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int T, int S, int H, int KV, int D,
                             const long long* strides, float scale, int causal,
                             int q_offset, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T,
                               S, H, KV, D, strides, scale, causal, q_offset, stream);
}

}  // extern "C"
