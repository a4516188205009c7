// K3: key-value row sort -- the MoE dispatch's argsort on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitonic.py::sort_tiles_kv
// (_sort_kv_kernel): every row of a contiguous (rows, n) matrix of int32 or
// int64 keys is sorted ascending, and the int32 value beside each key
// follows it.  n is a power of two.  The network is the one of
// bitonic.py::bitonic_argsort_array, stage for stage: in stage (k, j) the
// pair (i, i + j) swaps when asc ? key[i] > key[i+j] : key[i] < key[i+j],
// with asc = (i & k) == 0 for the position i inside the row.  It is not
// stable, but it is deterministic, so keys *and* values equal the plain
// torch version (bitonic.py::sort_rows_kv_plain) exactly, ties included.
// The pairs of one stage are disjoint, so any schedule that runs the same
// stages in the same order gives the same bits; this kernel only chooses
// where each stage runs.
//
// What bounds it on an H100: neither bytes nor operations.  At the MoE
// prefill's row (1 x 16,384 int32 pairs) the pairs are 128 KB, read and
// written once in 0.08 us at 3.35 TB/s, and the 105 stages of 8,192
// compare-exchanges (4 INT32 operations each) take 0.2 us on the card's INT32
// ALUs.  What costs is latency: a stage depends on the one before it.  The
// design keeps each stage as close to the registers as its pair distance j
// allows and spreads one row over many SMs:
//
// * chunk launch: one block of 256 threads owns a chunk of CHUNK = 2,048
//   consecutive pairs, 8 per thread in registers.  Stages with j < 8 run
//   inside a thread's registers; 8 <= j < 256 by __shfl_xor_sync with the
//   lane that holds the partner (all 16 shuffles of a stage issued before
//   the first is used, so they do not wait on each other); j >= 256
//   (up to 1,024) after a transpose through shared memory into a layout
//   where a thread holds the 8 elements t + m * 256, again inside its
//   registers.  Two barriers per transpose.  A compare-exchange is a min,
//   a max and selects; a thread that keeps the other's key takes its
//   value, so equal keys stay where they are.
// * strided launch, for 2,048 <= j < 2,048 * GROUP: a thread holds the
//   k / 2,048 elements i + m * 2,048 (m < GROUP = 16) that those stages
//   connect, runs them in registers and writes them back.
// * device-memory pass, one launch per stage, for j >= 2,048 * GROUP: rows
//   far wider than the MoE's (2^16 pairs and more).
//
// A row of n <= 2,048 pairs is one chunk launch (the decode step's 1 x 32 is
// one warp; many small rows share a block).  A wider row runs one chunk
// launch for k <= 2,048, then per k: the device-memory passes, one strided
// launch, one chunk launch for j = 1,024 .. 1: plan() below, the same loop
// as row_sort_kv_plan in bitonic.py, which reads ITEMS, THREADS and GROUP
// from this file.  At 1 x 16,384: 7 launches over 8 blocks each.  Why
// 2,048: a chunk of 1,024 (128 threads) or 512 pairs (128 threads of 4) took
// as long on an H100, with two or five more launches; 4,096 pairs would need
// more than the 48 KB of static shared memory at int64 keys, and 16 pairs a
// thread over 128 threads ran slower.  Index math inside a chunk or group is
// 32-bit; the row position's high bits are taken once per block in 64-bit.
// Measured by chip_smoke.py (PERF.md has the numbers and the card).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITEMS = 8;                 // pairs a thread holds
constexpr int THREADS = 256;             // threads of a chunk block
constexpr int CHUNK = ITEMS * THREADS;   // 2,048 pairs per chunk
constexpr int WARP_SPAN = ITEMS * 32;    // 256 pairs per warp
constexpr int GROUP = 16;                // most elements per strided thread
constexpr unsigned FULL = 0xffffffffu;
constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }
constexpr int LOG_CHUNK = ilog2(CHUNK);
// Every j < THREADS lies inside a warp (shuffles); j >= THREADS in layout B.
static_assert(THREADS <= WARP_SPAN && ITEMS <= 16 && GROUP <= 16, "layouts");

__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

__device__ __forceinline__ int32_t shfl_x(int32_t x, int m) {
  return __shfl_xor_sync(FULL, x, m);
}
__device__ __forceinline__ int64_t shfl_x(int64_t x, int m) {
  return (int64_t)__shfl_xor_sync(FULL, (long long)x, m);
}

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) { return b < a ? b : a; }
template <typename K>
__device__ __forceinline__ K kmax(K a, K b) { return a < b ? b : a; }

// The pair (a, b) in order: ascending unless asc is false; the values
// follow, and equal keys keep their places.
template <typename K>
__device__ __forceinline__ void cex(K& a, int& va, K& b, int& vb, bool asc) {
  const K lo = kmin(a, b), hi = kmax(a, b);
  const K na = asc ? lo : hi;
  const bool swap = na != a;
  const int xa = va;
  va = swap ? vb : va;
  vb = swap ? xa : vb;
  b = asc ? hi : lo;
  a = na;
}

// One stage inside a thread's N registers: register r holds the element at
// position e0 + r * stride; pairs (r, r | J).  The pair ascends unless its
// block lies in a descending run (desc) or its lower position has bit lo.
template <typename K, int N, int J>
__device__ __forceinline__ void reg_stage(K (&k)[N], int (&v)[N], unsigned e0,
                                          unsigned stride, unsigned lo,
                                          bool desc) {
  if constexpr (J < N) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (!(r & J)) {
        const bool asc = !desc && !((e0 + r * stride) & lo);
        cex(k[r], v[r], k[r | J], v[r | J], asc);
      }
    }
  }
}

template <typename K, int N>
__device__ __forceinline__ void reg_stage_j(K (&k)[N], int (&v)[N], int J,
                                            unsigned e0, unsigned stride,
                                            unsigned lo, bool desc) {
  switch (J) {
    case 1: reg_stage<K, N, 1>(k, v, e0, stride, lo, desc); break;
    case 2: reg_stage<K, N, 2>(k, v, e0, stride, lo, desc); break;
    case 4: reg_stage<K, N, 4>(k, v, e0, stride, lo, desc); break;
    case 8: reg_stage<K, N, 8>(k, v, e0, stride, lo, desc); break;
    default: break;
  }
}

// One stage with ITEMS <= j < THREADS in layout A (thread t holds
// ITEMS * t + r): the partner of every register is the same register of
// lane ^ (j / ITEMS).  All shuffles are issued before the first is used; a
// thread keeps the smaller or the larger key, and its value only when the
// key it keeps is the other's.
template <typename K>
__device__ __forceinline__ void shfl_stage(K (&k)[ITEMS], int (&v)[ITEMS],
                                           int j, unsigned e0, unsigned lo,
                                           bool desc) {
  const bool lower = !(e0 & j);
  const bool asc = !desc && !(e0 & lo);  // lo >= 2j > ITEMS: the same for all r
  const bool keep_min = asc == lower;
  K o[ITEMS];
  int ov[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    o[r] = shfl_x(k[r], j / ITEMS);
    ov[r] = __shfl_xor_sync(FULL, v[r], j / ITEMS);
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const K nk = keep_min ? kmin(o[r], k[r]) : kmax(o[r], k[r]);
    v[r] = nk != k[r] ? ov[r] : v[r];
    k[r] = nk;
  }
}

// Layout A (thread t holds 8t + r) <-> layout B (thread t holds r * T + t)
// through shared memory, padded one word in 32 so neither side conflicts.
template <typename K>
__device__ __forceinline__ void transpose(K (&k)[ITEMS], int (&v)[ITEMS],
                                          K* sk, int* sv, int t, int T,
                                          bool to_a) {
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int e = to_a ? r * T + t : ITEMS * t + r;
    sk[pad(e)] = k[r];
    sv[pad(e)] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int e = to_a ? ITEMS * t + r : r * T + t;
    k[r] = sk[pad(e)];
    v[r] = sv[pad(e)];
  }
  __syncthreads();
}

// A chunk launch: block b owns pairs [b * 8T, (b + 1) * 8T) of the row-major
// matrix (8T divides n, or n divides 8T).  Runs k = k_first .. k_last
// (doubling), j from j_first for the first k and from k / 2 after it, down
// to 1.  Reads (kin, vin), writes (kout, vout); they may alias.
template <typename K>
__global__ void __launch_bounds__(THREADS)
chunk_stages(const K* kin, const int* vin, K* kout, int* vout, long long total,
             long long n, long long k_first, long long k_last, int j_first) {
  __shared__ K sk[CHUNK + CHUNK / 32];
  __shared__ int sv[CHUNK + CHUNK / 32];
  const int T = blockDim.x, t = threadIdx.x, tile = ITEMS * T;
  const long long base = (long long)blockIdx.x * tile;
  const long long rem = total - base;
  const int valid = rem < tile ? (int)rem : tile;
  kin += base;
  vin += base;
  K k[ITEMS];
  int v[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {  // layout B: coalesced
    const int e = r * T + t;
    k[r] = e < valid ? kin[e] : K(0);
    v[r] = e < valid ? vin[e] : 0;
  }
  // Positions past `valid` form whole rows of their own (n divides the
  // tile), so they never meet a real pair.
  bool in_b = true;
  for (long long kk = k_first; kk <= k_last; kk <<= 1) {
    const long long km = kk & (n - 1);  // 0 when kk == n: the last merge ascends
    const bool desc = (base & km) != 0;  // km >= tile: the whole block's run
    const unsigned lo = km < tile ? (unsigned)km : 0u;
    for (int j = kk == k_first ? j_first : (int)(kk >> 1); j >= 1; j >>= 1) {
      if (j >= THREADS) {  // n > THREADS, so T == THREADS
        if (!in_b) transpose(k, v, sk, sv, t, T, false);
        in_b = true;
        reg_stage_j<K, ITEMS>(k, v, j / T, t, T, lo, desc);
      } else {
        if (in_b) transpose(k, v, sk, sv, t, T, true);
        in_b = false;
        if (j >= ITEMS)
          shfl_stage(k, v, j, ITEMS * t, lo, desc);
        else
          reg_stage_j<K, ITEMS>(k, v, j, ITEMS * t, 1, lo, desc);
      }
    }
  }
  if (!in_b) transpose(k, v, sk, sv, t, T, false);
  kout += base;
  vout += base;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int e = r * T + t;
    if (e < valid) {
      kout[e] = k[r];
      vout[e] = v[r];
    }
  }
}

// A strided launch (in place): thread g holds the M elements
// base + m * CHUNK, base = (g / CHUNK) * M * CHUNK + g % CHUNK, and runs the
// stages (kk, j) for j = j_first .. CHUNK in its registers.  kk >= M * CHUNK,
// so the direction is the same for all of them.
template <typename K, int M>
__global__ void __launch_bounds__(THREADS)
strided_stages(K* keys, int* vals, long long groups, long long n, long long kk,
               int j_first) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long base =
      (g >> LOG_CHUNK) * ((long long)M * CHUNK) + (g & (CHUNK - 1));
  const bool desc = (base & kk & (n - 1)) != 0;
  keys += base;
  vals += base;
  K k[M];
  int v[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    k[m] = keys[m * CHUNK];
    v[m] = vals[m * CHUNK];
  }
  for (int j = j_first; j >= CHUNK; j >>= 1)
    reg_stage_j<K, M>(k, v, j / CHUNK, 0, 0, 0, desc);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    keys[m * CHUNK] = k[m];
    vals[m * CHUNK] = v[m];
  }
}

// One stage (kk, j) over all rows in device memory (j >= CHUNK * GROUP).
template <typename K>
__global__ void __launch_bounds__(THREADS)
global_stage(K* __restrict__ keys, int* __restrict__ vals, long long pairs,
             long long n, long long kk, long long j) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // 2j divides n
  const long long p = i + j;
  K a = keys[i], b = keys[p];
  int va = vals[i], vb = vals[p];
  cex(a, va, b, vb, (i & kk & (n - 1)) == 0);
  keys[i] = a;
  keys[p] = b;
  vals[i] = va;
  vals[p] = vb;
}

enum Kind { kChunk, kStrided, kGlobal };

// The launches of one call on rows of n pairs, in order (bitonic.py::
// row_sort_kv_plan): op(kind, k_first, k_last, j_first) for each; stops at
// the first error.
template <typename Op>
int plan(long long n, Op&& op) {
  if (n < 2) return 0;
  const long long c = n < CHUNK ? n : CHUNK;
  int err = op(kChunk, 2LL, c, 1LL);
  for (long long k = 2 * c; k <= n && !err; k <<= 1) {
    long long j = k >> 1;
    for (; j >= (long long)CHUNK * GROUP && !err; j >>= 1)
      err = op(kGlobal, k, k, j);
    if (!err) err = op(kStrided, k, k, j);
    if (!err) err = op(kChunk, k, k, (long long)CHUNK / 2);
  }
  return err;
}

template <typename K>
int launch(const void* kin, const void* vin, void* kout, void* vout,
           long long rows, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 0 || n < 2 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long total = rows * n;
  // Short rows that fill less than a chunk: one warp per WARP_SPAN pairs.
  int threads = THREADS;
  if (n <= THREADS && total < CHUNK)
    threads = (int)((total + WARP_SPAN - 1) / WARP_SPAN) * 32;
  const long long tile = (long long)ITEMS * threads;
  const unsigned chunks = (unsigned)((total + tile - 1) / tile);
  K* ko = (K*)kout;
  int* vo = (int*)vout;
  bool first = true;
  return plan(n, [&](Kind kind, long long k0, long long k1, long long j) {
    switch (kind) {
      case kChunk:
        chunk_stages<K><<<chunks, threads, 0, st>>>(
            first ? (const K*)kin : ko, first ? (const int*)vin : vo, ko, vo,
            total, n, k0, k1, (int)j);
        break;
      case kStrided: {
        const int m = (int)(2 * j / CHUNK);
        const long long groups = total / m;
        const unsigned blocks = (unsigned)(groups / THREADS);
        switch (m) {
          case 2: strided_stages<K, 2><<<blocks, THREADS, 0, st>>>(ko, vo, groups, n, k0, (int)j); break;
          case 4: strided_stages<K, 4><<<blocks, THREADS, 0, st>>>(ko, vo, groups, n, k0, (int)j); break;
          case 8: strided_stages<K, 8><<<blocks, THREADS, 0, st>>>(ko, vo, groups, n, k0, (int)j); break;
          case 16: strided_stages<K, 16><<<blocks, THREADS, 0, st>>>(ko, vo, groups, n, k0, (int)j); break;
          default: return (int)cudaErrorInvalidValue;
        }
        break;
      }
      case kGlobal: {
        const long long pairs = total / 2;
        global_stage<K><<<(unsigned)((pairs + THREADS - 1) / THREADS), THREADS,
                          0, st>>>(ko, vo, pairs, n, k0, j);
        break;
      }
    }
    first = false;
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

int row_sort_kv_i32(const void* kin, const void* vin, void* kout, void* vout,
                    long long rows, long long n, void* stream) {
  return launch<int32_t>(kin, vin, kout, vout, rows, n, stream);
}

int row_sort_kv_i64(const void* kin, const void* vin, void* kout, void* vout,
                    long long rows, long long n, void* stream) {
  return launch<int64_t>(kin, vin, kout, vout, rows, n, stream);
}

}  // extern "C"
