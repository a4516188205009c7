// K6: decode attention -- one new query token per head against the KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _kernel): for q (B, H, D) and caches (B, S, KV, D),
// softmax over the first lengths[b] cache positions of q . k * scale, times
// v; the G = H / KV query heads of a kv head share its cache rows.  Cache
// blocks are merged by their log-sum-exp, as _kernel merges its block_s
// blocks: running max m, sum l and f32 accumulator, the mask value the finite
// -1e30.  A slot whose length is 0 sees every position masked to -1e30, so
// its softmax is uniform and it writes the mean of v over the cache, as the
// reference and the plain version do.  Inputs are float32 or bfloat16; D is
// 32, 64 or 128, and 192 in bfloat16 (nemotron-4-340b's heads: 24 16-byte
// chunks a row, so a whole warp takes one row and lanes 24-31 load nothing);
// any G.
//
// Where the caller asks for it (a non-null lse), the merge pass also writes
// each (slot, head)'s natural-log logsumexp of its scaled, masked scores,
// f32 (B, H): its running max plus the log of its denominator, in the same
// launch.  The sequence-sharded decode merges the chunks of several ranks by
// these weights.  A slot of length 0 writes -1e30 + log(S), which is -1e30
// in f32: beside any chunk with a visible position its weight exp(lse - max)
// is exactly 0, as the reference's -1e30 masking gives it.
//
// The cache is read in place, in the model's (B, S, KV, D) layout, through
// the strides it is given (a layer's slice of the stacked cache is a pointer
// offset): the TPU wrapper's transpose to (B*KV, S, D) would copy the whole
// cache every step.  Rows (every (b, s, kv head) and (b, head)) must start on
// a 16-byte boundary; the wrapper checks it.
//
// What bounds it on an H100: bytes.  A step reads each visible cache row of
// k and v once (Mistral-Nemo-12B's largest smoke step: 5,720 positions x 8 kv
// heads x 128 x 2 B x 2 = 23.4 MB, 7 us at 3.35 TB/s) for 4 flops per cached
// element pair and query head.  So the design is about keeping enough loads
// in flight on every SM:
//
// * pass 1 runs one 4-warp block per (block_s positions, kv head, slot);
//   blocks past the slot's length return at once and write nothing.  A warp
//   streams rows of the block: each lane loads 16 bytes of a K row and of a V
//   row (8 bf16 or 4 f32; D = 128 bf16 is 16 lanes a row, 2 rows a warp
//   load), UNROLL = 4 rows each before the first use, straight into
//   registers -- nothing passes through shared memory.
// * Each lane keeps its slice of the pre-scaled query vectors of up to
//   GQ = 4 heads in f32 registers, forms partial dots, and reduces them over
//   the row's lanes with __shfl_xor_sync.  More heads run in further passes
//   over the block's rows, which the first pass left in L2.
// * The online softmax and the V sums stay in f32 registers, one stream per
//   row group of a warp; row groups merge by shuffle, the block's warps
//   through 8 KB of shared memory, into one partial (m, l, acc) per block
//   and head.
// * pass 2 is one block per (slot, head): its warps split the visible
//   partials, read each acc with 16-byte loads and merge by the LSE weights
//   exp(m - max m); the warps' sums meet in shared memory.
//
// The lengths stay on the card: the grid is sized by S, so no step waits on
// the host.  No dynamic shared memory, so no per-call attribute call.
// Measured by chip_smoke.py (PERF.md has the numbers and the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;  // K and V rows in flight per lane
constexpr int GQ = 4;      // query heads per pass
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes as f32: 4 floats or 8 bfloat16s.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

struct Args {
  long long q_b, q_h;           // q (B, H, D)
  long long k_b, k_s, k_h;      // kcache (B, S, KV, D)
  long long v_b, v_s, v_h;      // vcache (B, S, KV, D)
  long long o_b, o_h;           // out (B, H, D)
};

template <typename T, int D>
struct Shape {
  static constexpr int E = 16 / (int)sizeof(T);  // elements per lane load
  static constexpr int CH = D / E;               // 16-byte chunks a row
  static constexpr int LPR = 32 % CH == 0 ? CH : 32;  // lanes per row (lanes >= CH idle)
  static constexpr int RPW = 32 / LPR;           // rows per warp load
  static constexpr int RPI = RPW * UNROLL * WARPS;  // rows per block iteration
  static_assert(CH <= 32, "a row is at most one 16-byte load a lane");
};

// Heads g0 .. g0 + NQ - 1 of one block's rows [s_begin, s_end): the partial
// (m, l, acc) of each, written to the block's slot of part_ml / part_acc.
template <typename T, int D, int NQ>
__device__ __forceinline__ void heads(
    const T* qb, const T* kb, const T* vb, const Args& a, int s_begin,
    int s_end, bool empty, float scale, int g0, int G, long long part,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    float (*s_acc)[GQ][D], float (*s_ml)[GQ][2]) {
  using Sh = Shape<T, D>;
  constexpr int E = Sh::E, LPR = Sh::LPR, RPW = Sh::RPW, RPI = Sh::RPI;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / LPR, c = lane % LPR;
  const bool live = c < Sh::CH;  // a lane past the row's chunks loads zeros

  float qf[NQ][E], acc[NQ][E], m[NQ], l[NQ];
#pragma unroll
  for (int g = 0; g < NQ; ++g) {
    unpack(live ? load16(qb + (long long)(g0 + g) * a.q_h) : make_uint4(0, 0, 0, 0), qf[g]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[g][e] *= scale;
      acc[g][e] = 0.f;
    }
    m[g] = NEG;
    l[g] = 0.f;
  }

  for (int it = s_begin; it < s_end; it += RPI) {
    uint4 kr[UNROLL], vr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = it + (warp * UNROLL + u) * RPW + rg;
      ok[u] = row < s_end;
      kr[u] = ok[u] && live ? load16(kb + row * a.k_s) : make_uint4(0, 0, 0, 0);
      vr[u] = ok[u] && live ? load16(vb + row * a.v_s) : make_uint4(0, 0, 0, 0);
    }
    float p[UNROLL][NQ];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[E];
      unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < NQ; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = LPR / 2; off; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
        p[u][g] = empty ? NEG : d;
      }
    }
#pragma unroll
    for (int g = 0; g < NQ; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mx = ok[u] ? fmaxf(mx, p[u][g]) : mx;
      const float alpha = expf(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u][g] = ok[u] ? expf(p[u][g] - mx) : 0.f;
        sum += p[u][g];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[E];
      unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < NQ; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p[u][g], vf[e], acc[g][e]);
    }
  }

  // The warp's row groups, by shuffle (a group that saw no visible row has
  // m = -1e30 and l = 0, and weighs nothing beside one that did).
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < NQ; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lo = __shfl_xor_sync(FULL, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float wa = expf(m[g] - mn), wb = expf(mo - mn);
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * wa + __shfl_xor_sync(FULL, acc[g][e], off) * wb;
      m[g] = mn;
    }
  }
  // The block's warps, through shared memory.
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < NQ; ++g) {
      if (live) {
#pragma unroll
        for (int e = 0; e < E; ++e) s_acc[warp][g][c * E + e] = acc[g][e];
      }
      if (c == 0) {
        s_ml[warp][g][0] = m[g];
        s_ml[warp][g][1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < NQ * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, s_ml[w][g][0]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(s_ml[w][g][0] - mm);
      ll += s_ml[w][g][1] * wt;
      aa += s_acc[w][g][d] * wt;
    }
    const long long pg = part * G + g0 + g;
    part_acc[pg * D + d] = aa;
    if (d == 0) {
      part_ml[pg * 2] = mm;
      part_ml[pg * 2 + 1] = ll;
    }
  }
  __syncthreads();  // s_acc is read before the next pass writes it
}

// Visible positions of slot b: lengths[b] clamped to S, or all S (every one
// masked) when the length is 0 or less.
__device__ __forceinline__ int visible(const int* lengths, int b, int S) {
  const int n = lengths[b];
  return n <= 0 ? S : min(n, S);
}

// Pass 1: the partials of one block_s slice of one (b, kv head).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
               const T* __restrict__ vc, const int* __restrict__ lengths,
               float* __restrict__ part_acc, float* __restrict__ part_ml,
               int S, int KV, int G, int block_s, Args a, float scale) {
  __shared__ float s_acc[WARPS][GQ][D];
  __shared__ float s_ml[WARPS][GQ][2];
  constexpr int E = Shape<T, D>::E, LPR = Shape<T, D>::LPR;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const bool empty = lengths[b] <= 0;
  const int len = visible(lengths, b, S);
  const int s_begin = split * block_s;
  if (s_begin >= len) return;  // the merge reads only visible partials
  const int s_end = min(len, s_begin + block_s);
  const long long part = ((long long)b * KV + kvh) * gridDim.x + split;
  const int c = (threadIdx.x % 32) % LPR;
  const T* qb = q + b * a.q_b + (long long)kvh * G * a.q_h + c * E;
  const T* kb = kc + b * a.k_b + kvh * a.k_h + c * E;
  const T* vb = vc + b * a.v_b + kvh * a.v_h + c * E;
  for (int g0 = 0; g0 < G; g0 += GQ) {
    switch (min(GQ, G - g0)) {
      case 1:
        heads<T, D, 1>(qb, kb, vb, a, s_begin, s_end, empty, scale, g0, G, part,
                       part_acc, part_ml, s_acc, s_ml);
        break;
      case 2:
        heads<T, D, 2>(qb, kb, vb, a, s_begin, s_end, empty, scale, g0, G, part,
                       part_acc, part_ml, s_acc, s_ml);
        break;
      case 3:
        heads<T, D, 3>(qb, kb, vb, a, s_begin, s_end, empty, scale, g0, G, part,
                       part_acc, part_ml, s_acc, s_ml);
        break;
      default:
        heads<T, D, 4>(qb, kb, vb, a, s_begin, s_end, empty, scale, g0, G, part,
                       part_acc, part_ml, s_acc, s_ml);
        break;
    }
  }
}

// Pass 2: one block per (b, head) merges the visible partials by their LSE
// weights; warp w takes partials w, w + WARPS, ..., lane i holds D / 32
// consecutive elements of the accumulator; the warps meet in shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_merge(const float* __restrict__ part_acc,
             const float* __restrict__ part_ml, const int* __restrict__ lengths,
             T* __restrict__ out, float* __restrict__ lse, int S, int KV, int G,
             int nsplit, int block_s, Args a) {
  constexpr int PER = D / 32;
  __shared__ float s_m[WARPS], s_l[WARPS], s_acc[WARPS][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / G, g = h % G;
  const int nvis = (visible(lengths, b, S) + block_s - 1) / block_s;
  const long long base = ((long long)b * KV + kvh) * nsplit;
  float m = NEG;
  for (int sp = threadIdx.x; sp < nvis; sp += THREADS)
    m = fmaxf(m, part_ml[((base + sp) * G + g) * 2]);
#pragma unroll
  for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  if (lane == 0) s_m[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m = fmaxf(m, s_m[w]);
  float l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int sp = warp; sp < nvis; sp += WARPS) {
    const long long pg = (base + sp) * G + g;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + pg * 2);
    const float w = expf(ml.x - m);
    l += ml.y * w;
    const float* src = part_acc + pg * D + lane * PER;
    float x[PER];
    if constexpr (PER == 4) {
      const float4 t = *reinterpret_cast<const float4*>(src);
      x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
    } else if constexpr (PER == 2) {
      const float2 t = *reinterpret_cast<const float2*>(src);
      x[0] = t.x, x[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) x[i] = src[i];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = fmaf(w, x[i], acc[i]);
  }
  if (lane == 0) s_l[warp] = l;
#pragma unroll
  for (int i = 0; i < PER; ++i) s_acc[warp][lane * PER + i] = acc[i];
  __syncthreads();
  if (warp) return;
  l = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) l += s_l[w];
  const float den = l == 0.f ? 1.f : l;
  if (lse != nullptr && lane == 0)
    lse[(long long)b * gridDim.x + h] = m + logf(l);
  T* o = out + b * a.o_b + h * a.o_h + lane * PER;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += s_acc[w][lane * PER + i];
    o[i] = from_f32<T>(sum / den);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* kc, const void* vc, const int* lengths,
             void* out, float* lse, float* part_acc, float* part_ml, int B,
             int S, int H, int KV, int block_s, const Args& a, float scale,
             cudaStream_t st) {
  const int G = H / KV;
  const int nsplit = (S + block_s - 1) / block_s;
  decode_partial<T, D><<<dim3(nsplit, KV, B), THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, part_acc, part_ml, S, KV, G, block_s,
      a, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge<T, D><<<dim3(H, B), THREADS, 0, st>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), lse, S, KV, G, nsplit,
      block_s, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* lengths,
           void* out, void* lse, void* part_acc, void* part_ml, int B, int S,
           int H, int KV, int D, int block_s, const long long* st10,
           float scale, void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV || block_s <= 0 || B > 65535 || KV > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{st10[0], st10[1], st10[2], st10[3], st10[4],
               st10[5], st10[6], st10[7], st10[8], st10[9]};
  const int* len = static_cast<const int*>(lengths);
  float* ls = static_cast<float*>(lse);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, kc, vc, len, out, ls, pa, pm, B, S, H, KV, block_s, a, scale, s);
    case 64:
      return launch_d<T, 64>(q, kc, vc, len, out, ls, pa, pm, B, S, H, KV, block_s, a, scale, s);
    case 128:
      return launch_d<T, 128>(q, kc, vc, len, out, ls, pa, pm, B, S, H, KV, block_s, a, scale, s);
    case 192:  // bfloat16 only
      if constexpr (sizeof(T) == 2)
        return launch_d<T, 192>(q, kc, vc, len, out, ls, pa, pm, B, S, H, KV, block_s, a, scale, s);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 10 element strides -- q (b, h), kcache (b, s, h), vcache (b, s, h),
// out (b, h).  lse is null or (B, H) contiguous f32.  part_acc holds
// B*KV*nsplit*G*D floats and part_ml B*KV*nsplit*G*2, nsplit =
// ceil(S / block_s); only the visible blocks' entries are written and read.
int decode_attention_f32(const void* q, const void* kc, const void* vc,
                         const void* lengths, void* out, void* lse,
                         void* part_acc, void* part_ml, int B, int S, int H,
                         int KV, int D, int block_s, const long long* strides,
                         float scale, void* stream) {
  return launch<float>(q, kc, vc, lengths, out, lse, part_acc, part_ml, B, S, H,
                       KV, D, block_s, strides, scale, stream);
}

int decode_attention_bf16(const void* q, const void* kc, const void* vc,
                          const void* lengths, void* out, void* lse,
                          void* part_acc, void* part_ml, int B, int S, int H,
                          int KV, int D, int block_s, const long long* strides,
                          float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kc, vc, lengths, out, lse, part_acc, part_ml,
                               B, S, H, KV, D, block_s, strides, scale, stream);
}

}  // extern "C"
