// K6: decode attention -- one new query token per head against the KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _kernel): for q (B, H, D) and caches (B, S, KV, D),
// softmax over the first lengths[b] cache positions of q . k * scale, times
// v; the G = H / KV query heads of a kv head share its cache rows.  Cache
// blocks are merged by their log-sum-exp, as _kernel merges its block_s
// blocks: each block keeps a running max m, sum l and f32 accumulator, the
// mask value is the finite -1e30, and a row whose l is 0 writes 0.  Inputs
// are float32 or bfloat16; D is 32, 64 or 128.
//
// The cache is read in place, in the model's (B, S, KV, D) layout, through
// the strides it is given (a layer's slice of the stacked cache is a pointer
// offset): the TPU wrapper's transpose to (B*KV, S, D) would copy the whole
// cache every step.
//
// What bounds it on an H100: bytes.  A step reads each visible cache row of
// k and v once (4 slots x 2080 positions x 8 kv heads x 128 x 2 B x 2 =
// 34 MB per layer in bf16, about 10 us at 3.35 TB/s) for 4 flops per cached
// element pair and query head.  The TPU ran the cache blocks of one kv head
// in order on one core; here one block per (b, kv head) would give only
// B * KV = 32 blocks for 132 SMs, so the sequence is split as well: pass 1
// runs one 128-thread block per (block_s positions, kv head, b) -- blocks
// past lengths[b] return at once -- streaming 32-position K/V tiles through
// shared memory and writing its partial (m, l, acc); pass 2 merges the
// partials of each (b, head) by their LSE weights exp(m - max m).  The
// lengths stay on the card: the grid is sized by S, so no step waits on the
// host.  The next step is 16-byte loads staged in registers: each thread
// now loads one element per loop iteration, and those loads wait on memory
// one after another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // four warps
constexpr int TILE = 32;      // cache positions per shared-memory tile
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

struct Args {
  long long q_b, q_h;           // q (B, H, D)
  long long k_b, k_s, k_h;      // kcache (B, S, KV, D)
  long long v_b, v_s, v_h;      // vcache (B, S, KV, D)
  long long o_b, o_h;           // out (B, H, D)
};

template <int D>
size_t smem_bytes(int G) {
  return (size_t)(G * D + TILE * (D + 1) + TILE * D + G * TILE + 3 * G +
                  G * D) * sizeof(float);
}

// Pass 1: the partial softmax of one block_s slice of one (b, kv head).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
               const T* __restrict__ vc, const int* __restrict__ lengths,
               float* __restrict__ part_acc, float* __restrict__ part_ml,
               int S, int KV, int G, int block_s, Args a, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // G x D, pre-scaled
  float* sK = sQ + G * D;              // TILE x (D + 1)
  float* sV = sK + TILE * (D + 1);     // TILE x D
  float* sS = sV + TILE * D;           // G x TILE: scores, then probabilities
  float* sM = sS + G * TILE;           // running max per query head
  float* sL = sM + G;                  // running sum
  float* sA = sL + G;                  // this tile's rescale factor
  float* sAcc = sA + G;                // G x D accumulator

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const long long part = ((long long)b * KV + kvh) * nsplit + split;
  const int len = min(max(lengths[b], 0), S);
  const int s_begin = split * block_s;
  const int s_end = min(len, s_begin + block_s);

  if (s_begin >= s_end) {  // nothing visible here: an empty partial
    for (int e = tid; e < G * D; e += THREADS) part_acc[part * G * D + e] = 0.f;
    for (int g = tid; g < G; g += THREADS) {
      part_ml[(part * G + g) * 2] = NEG;
      part_ml[(part * G + g) * 2 + 1] = 0.f;
    }
    return;
  }

  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    sQ[e] = to_f32(q[b * a.q_b + (long long)(kvh * G + g) * a.q_h + d]) * scale;
    sAcc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = NEG;
    sL[g] = 0.f;
  }
  const T* kb = kc + b * a.k_b + kvh * a.k_h;
  const T* vb = vc + b * a.v_b + kvh * a.v_h;

  for (int s0 = s_begin; s0 < s_end; s0 += TILE) {
    __syncthreads();  // the last tile's reads are done; q and m/l are staged
    for (int e = tid; e < TILE * D; e += THREADS) {
      const int c = e / D, d = e % D, s = s0 + c;
      const bool ok = s < s_end;
      sK[c * (D + 1) + d] = ok ? to_f32(kb[s * a.k_s + d]) : 0.f;
      sV[c * D + d] = ok ? to_f32(vb[s * a.v_s + d]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < G * TILE; e += THREADS) {
      const int g = e / TILE, c = e % TILE;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += sQ[g * D + d] * sK[c * (D + 1) + d];
      sS[e] = s0 + c < s_end ? dot : NEG;
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {  // one warp per query head
      const float s = sS[g * TILE + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      sS[g * TILE + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[g] = alpha;
        sL[g] = alpha * sL[g] + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += THREADS) {
      const int g = e / D, d = e % D;
      float acc = sAcc[e] * sA[g];
#pragma unroll 8
      for (int c = 0; c < TILE; ++c) acc += sS[g * TILE + c] * sV[c * D + d];
      sAcc[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += THREADS) part_acc[part * G * D + e] = sAcc[e];
  for (int g = tid; g < G; g += THREADS) {
    part_ml[(part * G + g) * 2] = sM[g];
    part_ml[(part * G + g) * 2 + 1] = sL[g];
  }
}

// Pass 2: merge the nsplit partials of one (b, head) by their LSE weights.
template <typename T>
__global__ void decode_merge(const float* __restrict__ part_acc,
                             const float* __restrict__ part_ml,
                             T* __restrict__ out, int KV, int G, int nsplit,
                             int D, Args a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = h / G, g = h % G;
  const long long base = ((long long)b * KV + kvh) * nsplit;
  float m = NEG;
  for (int sp = 0; sp < nsplit; ++sp)
    m = fmaxf(m, part_ml[((base + sp) * G + g) * 2]);
  float l = 0.f, acc = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const long long pg = (base + sp) * G + g;
    const float w = expf(part_ml[pg * 2] - m);
    l += part_ml[pg * 2 + 1] * w;
    acc += part_acc[pg * D + d] * w;
  }
  out[b * a.o_b + h * a.o_h + d] = from_f32<T>(acc / (l == 0.f ? 1.f : l));
}

template <typename T, int D>
int launch_d(const void* q, const void* kc, const void* vc, const int* lengths,
             void* out, float* part_acc, float* part_ml, int B, int S, int H,
             int KV, int block_s, const Args& a, float scale, cudaStream_t st) {
  const int G = H / KV;
  const int nsplit = (S + block_s - 1) / block_s;
  const size_t smem = smem_bytes<D>(G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_partial<T, D><<<dim3(nsplit, KV, B), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, part_acc, part_ml, S, KV, G, block_s,
      a, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  decode_merge<T><<<dim3(H, B), D, 0, st>>>(part_acc, part_ml,
                                            static_cast<T*>(out), KV, G,
                                            nsplit, D, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* lengths,
           void* out, void* part_acc, void* part_ml, int B, int S, int H,
           int KV, int D, int block_s, const long long* st10, float scale,
           void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || block_s <= 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{st10[0], st10[1], st10[2], st10[3], st10[4],
               st10[5], st10[6], st10[7], st10[8], st10[9]};
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, kc, vc, len, out, pa, pm, B, S, H, KV, block_s, a, scale, s);
    case 64:
      return launch_d<T, 64>(q, kc, vc, len, out, pa, pm, B, S, H, KV, block_s, a, scale, s);
    case 128:
      return launch_d<T, 128>(q, kc, vc, len, out, pa, pm, B, S, H, KV, block_s, a, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 10 element strides -- q (b, h), kcache (b, s, h), vcache (b, s, h),
// out (b, h).  part_acc holds B*KV*nsplit*G*D floats and part_ml
// B*KV*nsplit*G*2, nsplit = ceil(S / block_s).
int decode_attention_f32(const void* q, const void* kc, const void* vc,
                         const void* lengths, void* out, void* part_acc,
                         void* part_ml, int B, int S, int H, int KV, int D,
                         int block_s, const long long* strides, float scale,
                         void* stream) {
  return launch<float>(q, kc, vc, lengths, out, part_acc, part_ml, B, S, H, KV,
                       D, block_s, strides, scale, stream);
}

int decode_attention_bf16(const void* q, const void* kc, const void* vc,
                          const void* lengths, void* out, void* part_acc,
                          void* part_ml, int B, int S, int H, int KV, int D,
                          int block_s, const long long* strides, float scale,
                          void* stream) {
  return launch<__nv_bfloat16>(q, kc, vc, lengths, out, part_acc, part_ml, B,
                               S, H, KV, D, block_s, strides, scale, stream);
}

}  // extern "C"
