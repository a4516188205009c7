// K5: FlashAttention forward -- the LM's prefill attention on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _fa_kernel): softmax(q k^T * scale) v for q
// (B, T, H, D) against k, v (B, S, KV, D), causal (row >= col) or not, with
// GQA: q head h reads kv head h / (H / KV), and K/V are never repeated.  The
// softmax is online over key tiles with f32 running max m, sum l and
// accumulator; the mask value is the finite -1e30, so a masked score
// underflows to exactly 0 and never gives NaN; a row whose l is 0 writes 0.
// Inputs are float32 or bfloat16, accumulation is float32, the output has
// the input's type.  D is 32, 64 or 128 (a template argument), and 192 in
// bfloat16 (nemotron-4-340b's heads); T and S are
// any lengths: the ragged tails are bounds-checked here, where the TPU
// wrapper demanded T % block_q == 0.  On request (a non-null lse pointer, the
// training forward) each row's natural-log logsumexp of its scaled, masked
// scores goes to a (B, H, T) float32 tensor for the backward (K5b,
// flash_attention_bwd.cu); without it nothing more is written or read.
// Context parallelism passes a query offset q_off >= 0: local row i is
// global row q_off + i of the causal mask, which keeps key j iff
// q_off + i >= j (a rank's T chunk against the gathered K/V).  It is an
// argument of both kernels: at q_off = 0 a second build whose offset is the
// constant 0 was no faster on an H100 than this one, within the spread of
// one build's runs (scripts/attention_graph_ms.py).
//
// What bounds it on an H100: operations.  A causal prefill at T = 1963,
// D = 128, 32 q heads does 4 * T(T+1)/2 * D * 32 = 31.6 GFLOP while it reads
// q, k, v and writes o once (40 MB in bf16 with 8 kv heads): about 800
// flops per byte, so at the tensor cores' 989 TFLOP/s dense bf16 rate the
// bound is 32 us against 12 us for the bytes.  The dtype picks one of two
// hand-written kernels:
//
// * bfloat16 (the served models' type): flash_fwd_bf16, both products on
//   the tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate), the
//   FlashAttention-2 layout.  One block of 4 warps per (64 query rows, q
//   head, batch), one warp per 16 rows: 64 rows keep the Q tile, the output
//   accumulator (D/2 f32 per thread at D = 128) and a 16 x 64 score tile in
//   registers with no spill (ptxas: 212 registers at D = 128, 160 at 64, 128
//   at 32), and two blocks fit on an SM (87 KB of shared memory each at
//   D = 128).  128 rows a block (two 16-row tiles a warp, each K and V
//   fragment used twice) runs out of registers and spills at D = 128, and
//   measured slower at D = 64 as well, so the block is 64 rows.  Q is staged once through shared memory and
//   read into registers as A fragments with ldmatrix.  K and V come in
//   64-row tiles, double-buffered in shared memory: cp.async of 16 bytes a
//   thread, tile n+1 in flight while tile n is used; rows are padded to
//   D + 8 elements so the eight 16-byte rows of an ldmatrix fall in distinct
//   banks.  Rows at or beyond S (and query rows at or beyond T) load as zeros
//   (cp.async with src-size 0), never stale shared memory, and their scores
//   are masked before the max.  S = Q K^T accumulates in f32 registers; the
//   scale is applied to S in f32 after the product (q is never rounded to
//   bf16 pre-scaled).  The online softmax stays in registers: the row max is
//   reduced over the quad of threads that holds a row (__shfl_xor_sync 1
//   and 2).  P is rounded to bf16 in registers and used directly as the A
//   fragment of P V: the m16n8 C-fragment layout is the m16n8k16
//   A-fragment layout, so P never goes to shared memory; V is read with
//   ldmatrix.trans.  The running sum l adds the rounded P, so the weights
//   that multiply V sum to l exactly.  The output is divided by l once,
//   cast, staged through the warp's own rows of the Q tile and stored with
//   16-byte stores.  Causal key tiles wholly above the diagonal are never
//   loaded and only tiles that reach the diagonal or the ragged end are
//   masked; blockIdx.x is reversed so the heaviest query tiles start first.
//   At D = 192 the accumulator alone is 96 registers a thread, so the Q
//   fragments are not held: each k-step re-reads its fragment from the Q
//   tile by ldmatrix (the tile stays in shared memory until the output
//   replaces it), and the 125 KB of shared memory fit one block an SM
//   (ptxas: 232 registers, no spill).
//   cp.async needs 16-byte-aligned rows: the wrapper raises on a base
//   pointer or a row stride that is not (it never falls back).
// * float32 (only the smoke configs' type; no full-width path runs it):
//   flash_fwd<float, D>, a kernel on the CUDA cores.  TF32
//   tensor cores keep 10 mantissa bits and cannot meet the float32 limit of
//   2e-5 + 1e-3 |want|, so both products stay in f32 on the CUDA cores.
//   One block of 256 threads per (64 query rows, head, batch) stages its
//   pre-scaled Q tile in shared memory once, then streams 64-row K and V
//   tiles through shared memory; each thread owns a 4 x 4 block of the
//   score tile and a 4 x D/16 block of the output accumulator in registers.
//
// Times, bounds and the compiler's register and spill counts are in PERF.md
// (chip_smoke.py measures them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 query rows; tx 4 key columns
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Element strides of a (batch, row, head, D) tensor whose last axis is
// contiguous.
struct Strides {
  long long b, t, h;
};

template <int D>
constexpr size_t smem_bytes() {
  return (2 * BQ * (D + 4) + BK * D + BQ * (BK + 1) + 3 * BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int T_len, int S, int G, Strides qs, Strides ks, Strides vs,
          Strides os, float scale, int causal, int q_off) {
  constexpr int DP = D + 4;     // padded row of the Q and K tiles
  constexpr int DPT = D / 16;   // output columns per thread: tx + 16 j
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                 // BQ x DP, pre-scaled
  float* sK = sQ + BQ * DP;         // BK x DP
  float* sV = sK + BK * DP;         // BK x D
  float* sP = sV + BK * D;          // BQ x (BK + 1): scores, then probabilities
  float* sM = sP + BQ * (BK + 1);   // running row max
  float* sL = sM + BQ;              // running row sum
  float* sA = sL + BQ;              // this tile's rescale factor exp(m_old - m_new)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, t = q0 + r;
    sQ[r * DP + d] = t < T_len ? to_f32(qb[t * qs.t + d]) * scale : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    sM[r] = NEG;
    sL[r] = 0.f;
  }
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // Causal: rows below q0 + BQ see no column at or beyond q_off + q0 + BQ.
  const int kend = causal ? min(S, q_off + q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the last tile's reads are done; Q and m/l are staged
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D, s = k0 + c;
      const bool ok = s < S;
      sK[c * DP + d] = ok ? to_f32(kb[s * ks.t + d]) : 0.f;
      sV[c * D + d] = ok ? to_f32(vb[s * vs.t + d]) : 0.f;
    }
    __syncthreads();

    // Scores of rows ty*4 + i against columns tx + 16 j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                      qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        const bool vis = col < S && (!causal || row + q_off >= col);
        sP[r * (BK + 1) + c] = vis ? sc[i][j] : NEG;
      }
    }
    __syncthreads();

    // Online softmax: warp w updates rows 8w .. 8w + 7.
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = sP + r * (BK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }

  // sL was last written before the final barrier of the loop.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, t = q0 + r;
    if (t >= T_len) continue;
    const float l = sL[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* ob = o + b * os.b + t * os.t + h * os.h;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * T_len + t] = sM[r] + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;             // one warp per 16 query rows
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr size_t tc_smem_bytes() {
  return 5 * BQ * (D + 8) * sizeof(bf16);  // Q, two K and two V tiles
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src-size 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t holds
// C/D elements (g, 2t..2t+1) in c[0..1] and (g + 8, 2t..2t+1) in c[2..3];
// A elements (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..) in
// a[0..3]; B elements (k = 2t.., n = g) in b0 and (k = 2t + 8.., n = g) in b1.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int T_len, int S, int G, Strides qs,
               Strides ks, Strides vs, Strides os, float scale, int causal,
               int q_off) {
  constexpr int LD = D + 8;     // padded shared row, elements
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int KS = D / 16;    // k-steps of Q K^T
  constexpr int NT = BK / 8;    // 8-key n-tiles of a score tile
  constexpr bool HOLD_Q = D <= 128;  // Q's fragments in registers (see the note)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD, later the output
  bf16* sK = sQ + BQ * LD;                       // 2 x BK x LD
  bf16* sV = sK + 2 * BK * LD;                   // 2 x BK x LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  for (int c = tid; c < BQ * CH; c += TC_THREADS) {
    const int r = c / CH, ch = c % CH, t = q0 + r;
    const bool ok = t < T_len;
    cp_async16(smem_u32(sQ + r * LD + ch * 8), ok ? qb + t * qs.t + ch * 8 : qb, ok);
  }
  auto load_kv = [&](int k0, int buf) {
    bf16* dk = sK + buf * BK * LD;
    bf16* dv = sV + buf * BK * LD;
    for (int c = tid; c < BK * CH; c += TC_THREADS) {
      const int r = c / CH, ch = c % CH, s = k0 + r;
      const bool ok = s < S;
      cp_async16(smem_u32(dk + r * LD + ch * 8), ok ? kb + s * ks.t + ch * 8 : kb, ok);
      cp_async16(smem_u32(dv + r * LD + ch * 8), ok ? vb + s * vs.t + ch * 8 : vb, ok);
    }
  };

  // Causal: rows below q0 + BQ see no column at or beyond q_off + q0 + BQ.
  const int kend = causal ? min(S, q_off + q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  load_kv(0, 0);
  cp_async_commit();

  const int wrow = q0 + warp * 16;        // first query row of this warp
  const int row_a = wrow + g, row_b = row_a + 8;
  const float sl2 = scale * LOG2E;        // scores in the log2 domain
  uint32_t qf[HOLD_Q ? KS : 1][4];
  float acc[CH][4];
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

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
    auto q_frag = [&](uint32_t (&a)[4], int kk) {
      ldmatrix_x4(a, smem_u32(sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
    };
    if (HOLD_Q && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) q_frag(qf[HOLD_Q ? kk : 0], kk);
    }
    const bf16* tk = sK + buf * BK * LD;
    const bf16* tv = sV + buf * BK * LD;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qr[4];
      if constexpr (!HOLD_Q) q_frag(qr, kk);
      const uint32_t(&qa)[4] = HOLD_Q ? qf[HOLD_Q ? kk : 0] : qr;
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bfr[4];
        const int key = nn * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bfr, smem_u32(tk + key * LD + kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * nn], qa, bfr[0], bfr[1]);
        mma_bf16(s[2 * nn + 1], qa, bfr[2], bfr[3]);
      }
    }

    // Scale in f32, mask the diagonal tile and the ragged end, row max.
    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > q_off + wrow);
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= S || (causal && col > q_off + row)) x = NEG;
        }
        s[j][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }

    // P in bf16, straight into the A fragments of P V.
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat162 pa = __floats2bfloat162_rn(exp2f(s[j][0] - mn_a), exp2f(s[j][1] - mn_a));
      const __nv_bfloat162 pb = __floats2bfloat162_rn(exp2f(s[j][2] - mn_b), exp2f(s[j][3] - mn_b));
      l_a += __low2float(pa) + __high2float(pa);
      l_b += __low2float(pb) + __high2float(pb);
      pf[j >> 1][(j & 1) * 2] = as_u32(pa);
      pf[j >> 1][(j & 1) * 2 + 1] = as_u32(pb);
    }

    // acc += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < CH / 2; ++dn) {
        uint32_t bfr[4];
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldmatrix_x4_trans(bfr, smem_u32(tv + key * LD + dn * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dn], pf[kk], bfr[0], bfr[1]);
        mma_bf16(acc[2 * dn + 1], pf[kk], bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  if (lse != nullptr && t4 == 0) {
    // m is in the log2 domain: lse = (m + log2 l) ln 2.
    float* lb = lse + ((long long)b * gridDim.y + h) * T_len;
    if (row_a < T_len) lb[row_a] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * LN2;
    if (row_b < T_len) lb[row_b] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * LN2;
  }
  // The warp's own 16 rows of the Q tile (read only by this warp) stage the
  // output for 16-byte stores.
  bf16* so = sQ + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int col = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(so + g * LD + col) =
        __floats2bfloat162_rn(acc[j][0] * inv_a, acc[j][1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(so + (g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
  __syncwarp();
  bf16* ob = o + b * os.b + h * os.h;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH, t = wrow + r;
    if (t < T_len)
      *reinterpret_cast<uint4*>(ob + t * os.t + ch * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + ch * 8);
  }
}

template <int D>
int launch_bf16_d(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int T_len, int S, int H, int G, Strides qs, Strides ks,
                  Strides vs, Strides os, float scale, int causal, int q_off,
                  cudaStream_t st) {
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_bf16<D><<<grid, TC_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, T_len, S, G,
      qs, ks, vs, os, scale, causal, q_off);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int T_len, int S, int H, int G, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal, int q_off,
             cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, T_len, S, G, qs, ks,
      vs, os, scale, causal, q_off);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int T_len, int S, int H, int KV, int D, const long long* st6,
           float scale, int causal, int q_off, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || q_off < 0) return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const Strides qs{st6[0], st6[1], st6[2]}, ks{st6[3], st6[4], st6[5]},
      vs{st6[6], st6[7], st6[8]}, os{st6[9], st6[10], st6[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  const int G = H / KV;
#define K5_CASE(DIM)                                                          \
  case DIM:                                                                   \
    if constexpr (sizeof(T) == 2)                                             \
      return launch_bf16_d<DIM>(q, k, v, o, lf, B, T_len, S, H, G, qs, ks, vs, \
                                os, scale, causal, q_off, s);                 \
    else                                                                      \
      return launch_d<T, DIM>(q, k, v, o, lf, B, T_len, S, H, G, qs, ks, vs,  \
                              os, scale, causal, q_off, s);
  switch (D) {
    K5_CASE(32)
    K5_CASE(64)
    K5_CASE(128)
    case 192:  // bfloat16 only
      if constexpr (sizeof(T) == 2)
        return launch_bf16_d<192>(q, k, v, o, lf, B, T_len, S, H, G, qs, ks, vs, os, scale, causal,
                                  q_off, s);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K5_CASE
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, row, head) of q, k, v and o in turn.
// lse: null, or a contiguous (B, H, T) float32 tensor that receives each
// row's natural-log logsumexp of its scaled, masked scores (the backward's
// input, K5b); serve passes null and writes nothing more.  q_offset: the
// global row of q's first row under the causal mask (0 for a whole sequence).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int T, int S, int H, int KV, int D,
                        const long long* strides, float scale, int causal,
                        int q_offset, void* stream) {
  return launch<float>(q, k, v, o, lse, B, T, S, H, KV, D, strides, scale,
                       causal, q_offset, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int T, int S, int H, int KV, int D,
                         const long long* strides, float scale, int causal,
                         int q_offset, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, T, S, H, KV, D, strides,
                               scale, causal, q_offset, stream);
}

}  // extern "C"
