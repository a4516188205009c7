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
// the input's type.  D is 32, 64 or 128 (a template argument); T and S are
// any lengths: the ragged tails are bounds-checked here, where the TPU
// wrapper demanded T % block_q == 0.
//
// What bounds it on an H100: operations.  A causal prefill at T = 2048,
// D = 128 does 4 * T^2/2 * D = 1.07 GFLOP per head (34 GFLOP for 32 heads)
// while it reads q, k, v and writes o once (42 MB per layer in bf16 with 8
// kv heads): about 800 flops per byte, at the tensor cores' 989 TFLOP/s
// dense bf16 rate 35 us per layer against 13 us for the bytes.  This first
// kernel does its Q K^T and P V on the CUDA cores in f32 (no tensor cores,
// no library call), so it sits far above that bound; its times are in
// PERF.md.  Its design keeps everything but the output out of device
// memory: one block of 256 threads per (64 query rows, q head, batch)
// stages its pre-scaled Q tile in shared memory once, then streams 64-row K
// and V tiles through shared memory; each thread owns a 4 x 4 block of the
// score tile (float4 reads along D from rows padded to D + 4 floats, so
// eight rows cover all 32 banks) and a 4 x D/16 block of the output
// accumulator in registers.  The row max and sum of each tile are taken by
// one warp per eight rows with shuffles.  Key tiles wholly above the
// diagonal are never loaded, as _fa_kernel skips them.  Next steps:
// 16-byte tile loads staged in registers (each thread now loads one element
// per loop iteration), then mma.sync / wgmma on bf16 tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 query rows; tx 4 key columns
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
          const T* __restrict__ v, T* __restrict__ o, int T_len, int S, int G,
          Strides qs, Strides ks, Strides vs, Strides os, float scale,
          int causal) {
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

  // Causal: rows below q0 + BQ see no column at or beyond q0 + BQ.
  const int kend = causal ? min(S, q0 + BQ) : S;
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
        const bool vis = col < S && (!causal || row >= col);
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
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int T_len, int S, int H, int G, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal,
             cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), T_len, S, G, qs, ks, vs,
      os, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int T_len, int S, int H, int KV, int D, const long long* st6,
           float scale, int causal, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const Strides qs{st6[0], st6[1], st6[2]}, ks{st6[3], st6[4], st6[5]},
      vs{st6[6], st6[7], st6[8]}, os{st6[9], st6[10], st6[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, B, T_len, S, H, G, qs, ks, vs, os, scale, causal, s);
    case 64:
      return launch_d<T, 64>(q, k, v, o, B, T_len, S, H, G, qs, ks, vs, os, scale, causal, s);
    case 128:
      return launch_d<T, 128>(q, k, v, o, B, T_len, S, H, G, qs, ks, vs, os, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, row, head) of q, k, v and o in turn.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int T, int S, int H, int KV, int D,
                        const long long* strides, float scale, int causal,
                        void* stream) {
  return launch<float>(q, k, v, o, B, T, S, H, KV, D, strides, scale, causal,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int T, int S, int H, int KV, int D,
                         const long long* strides, float scale, int causal,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, T, S, H, KV, D, strides, scale,
                               causal, stream);
}

}  // extern "C"
