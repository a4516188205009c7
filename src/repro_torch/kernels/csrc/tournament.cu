// K2: tournament -- the run arena's merge of P padded sorted rows on Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitonic.py::tournament_tiles (_tournament_kernel): a
// (P, B) matrix of sorted rows, padded with the dtype maximum, both powers of
// two, becomes one sorted row of P*B keys.  Round r merges adjacent row pairs
// of width w = B * 2^r into rows of width 2w.  The TPU kernel ran the bitonic
// merge network with the whole matrix in VMEM (capped at 2^22 keys); here any
// P*B that fits in device memory is taken.  The result is keys only, so every
// correct merge gives the same bytes as the network did.
//
// What bounds it on an H100: bytes.  A merge of n keys over log2(P) rounds
// needs one comparison per output key per round (n log2 P), and reading and
// writing the n keys once; at the main path's largest bucket (131,072 x 64
// int64, 2^23 keys) that is 0.040 ms for the 128 MiB at 3.35 TB/s against
// 0.034 ms for the 1.4e8 comparisons on the INT32 ALUs.  A bitonic merge
// network, which makes a pass over device memory for every stage wider than
// a shared-memory tile, needs 78 such passes there; this design is a
// merge-path merge with one pass per round beyond the first tile:
//   * tile_merge: the first rounds, while the row pairs fit in one TILE of
//     16,384 keys (139 KB of dynamic shared memory at int64, above the
//     default 48 KB, so the launch raises the block's limit first), run in
//     one launch: 1,024 threads, each producing PER = 16 consecutive keys of
//     a round by a binary search for its start on the cross diagonal of its
//     pair (the co-rank) and a sequential merge into registers (the heads
//     a[i] and b[j] carried in registers: one shared-memory read per key);
//     then the tile is written back in place and the next round starts.
//   * merge_round: each wider round is one launch.  A block of 256 threads
//     owns SPAN = 4,096 consecutive output keys; warps 0 and 1 find where
//     the span starts and ends in its pair (a, b) by a 32-way search along
//     the cross diagonal (each of ~5 steps one coalesced probe by the warp),
//     the block stages the two input ranges in shared memory with coalesced
//     loads, each thread merges its 16 keys as above, and the span goes back
//     through shared memory with coalesced stores.
// Rounds ping-pong between the output and one scratch buffer of P*B keys
// that the wrapper allocates; the first round writes the buffer that makes
// the last round land in the output, and the input is never written.  That
// is 1 + log2(P*B / TILE) launches when B < TILE (one tile launch, then one
// per round), log2(P) when B >= TILE (tournament_launches reports it).
//
// The tie rule is the one every part shares: a's key comes first when
// a[i] <= b[j].  The co-rank of diagonal d is the least i with
// a[i] > b[d-1-i] (searched over max(0, d-|b|) <= i <= min(d, |a|)), so the
// partitions of neighbouring threads and blocks neither overlap nor leave
// gaps, whatever the duplicates (every row ends in a run of pads).
// Shared-memory positions are padded by one key per 16 (p + p/16), so the 16
// consecutive keys a thread writes start in distinct banks.  Indices into
// device memory are 64-bit throughout.  Measured by chip_smoke.py (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16384;         // keys per shared-memory tile
constexpr int TILE_THREADS = 1024;  // threads of a tile block
constexpr int PER = 16;             // keys one thread merges per round
constexpr int SPAN = 4096;          // output keys per block of a wider round
constexpr int SPAN_THREADS = SPAN / PER;

__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }
static_assert(TILE / TILE_THREADS <= PER, "a tile thread merges at most PER keys");

// Keys of a tile padded as pad(): tile + tile / 16.
template <typename T>
constexpr size_t tile_smem_bytes(int tile) {
  return (size_t)(tile + tile / 16) * sizeof(T);
}

// The co-rank of diagonal d in the stable merge of a (na keys) and b (nb
// keys): how many of the first d outputs come from a.
template <typename I, typename FA, typename FB>
__device__ __forceinline__ I co_rank(I d, FA a, I na, FB b, I nb) {
  I lo = d > nb ? d - nb : 0;
  I hi = d < na ? d : na;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (a(mid) <= b(d - 1 - mid))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The same search in device memory by one warp: each step the 32 lanes probe
// 32 evenly spaced candidates and the range shrinks to one gap between them.
template <typename T>
__device__ long long warp_co_rank(long long d, const T* __restrict__ a,
                                  const T* __restrict__ b, long long w,
                                  int lane) {
  long long lo = d > w ? d - w : 0;
  long long hi = d < w ? d : w;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool taken = p < hi && a[p] <= b[d - 1 - p];
    const int c = __popc(__ballot_sync(0xffffffffu, taken));  // a prefix
    if (c == 0) {
      hi = lo;
    } else {
      const long long next = lo + (long long)c * step;
      lo += (long long)(c - 1) * step + 1;
      hi = next < hi ? next : hi;
    }
  }
  return lo;
}

// Rounds w = w0, 2*w0, ..., tile/2 of one tile of `tile` keys, in shared
// memory.  Reads `in`, writes `out` (distinct buffers).
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
tile_merge(const T* __restrict__ in, T* __restrict__ out, int tile, int w0) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[pad(i)] = in[base + i];
  __syncthreads();
  const int per = tile / blockDim.x;  // 1 .. PER, a power of two
  const int first = threadIdx.x * per;
  T r[PER];
  for (int w = w0; w < tile; w <<= 1) {
    const int seg = per < 2 * w ? per : 2 * w;  // keys of one pair per run
    int i = 0, j = 0, pa = 0;
    T av = T(), bv = T();  // a[i] and b[j], carried in registers
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (k < per) {
        if ((k & (seg - 1)) == 0) {  // a new pair (or the thread's start)
          const int start = first + k;
          pa = start & ~(2 * w - 1);
          const int pb = pa + w;
          i = co_rank<int>(start - pa, [&](int x) { return s[pad(pa + x)]; }, w,
                           [&](int x) { return s[pad(pb + x)]; }, w);
          j = start - pa - i;
          av = s[pad(pa + min(i, w - 1))];
          bv = s[pad(pa + w + min(j, w - 1))];
        }
        const bool take_a = j >= w || (i < w && av <= bv);
        r[k] = take_a ? av : bv;
        i += take_a;
        j += !take_a;
        const T x = s[pad(take_a ? pa + min(i, w - 1) : pa + w + min(j, w - 1))];
        av = take_a ? x : av;
        bv = take_a ? bv : x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (k < per) s[pad(first + k)] = r[k];
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) out[base + i] = s[pad(i)];
}

// One round of width w (2w >= 2 * TILE > SPAN) over all n keys: block
// blockIdx.x writes out[blockIdx.x * SPAN, + SPAN).
template <typename T>
__global__ void __launch_bounds__(SPAN_THREADS)
merge_round(const T* __restrict__ in, T* __restrict__ out, long long w) {
  __shared__ T s[SPAN + SPAN / 16];
  __shared__ long long cut[2];
  const long long o0 = (long long)blockIdx.x * SPAN;
  const long long pair0 = o0 & ~(2 * w - 1);
  const T* a = in + pair0;
  const T* b = a + w;
  const long long d0 = o0 - pair0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const long long c = warp_co_rank(d0 + warp * SPAN, a, b, w, lane);
    if (lane == 0) cut[warp] = c;
  }
  __syncthreads();
  const long long i0 = cut[0], j0 = d0 - i0;
  const int na = (int)(cut[1] - i0), nb = SPAN - na;
  for (int e = threadIdx.x; e < SPAN; e += SPAN_THREADS)
    s[pad(e)] = e < na ? a[i0 + e] : b[j0 + (e - na)];
  __syncthreads();
  const int first = threadIdx.x * PER;
  int i = co_rank<int>(first, [&](int x) { return s[pad(x)]; }, na,
                       [&](int x) { return s[pad(na + x)]; }, nb);
  int j = first - i;
  // a[i] and b[j] carried in registers; an exhausted side is never read
  T av = na ? s[pad(min(i, na - 1))] : T();
  T bv = nb ? s[pad(na + min(j, nb - 1))] : T();
  T r[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const bool take_a = j >= nb || (i < na && av <= bv);
    r[k] = take_a ? av : bv;
    i += take_a;
    j += !take_a;
    const T x = s[pad(take_a ? min(i, na - 1) : na + min(j, nb - 1))];
    av = take_a ? x : av;
    bv = take_a ? bv : x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) s[pad(first + k)] = r[k];
  __syncthreads();
  for (int e = threadIdx.x; e < SPAN; e += SPAN_THREADS) out[o0 + e] = s[pad(e)];
}

bool valid(long long P, long long B) {
  return P >= 1 && B >= 1 && !(P & (P - 1)) && !(B & (B - 1));
}

// Kernel launches of one call: the tile launch (when 2B fits a tile), then
// one per wider round.
int launches(long long P, long long B) {
  if (!valid(P, B) || P == 1) return 0;
  const long long n = P * B;
  const long long tile = n < TILE ? n : TILE;
  int count = 0;
  long long w = B;
  if (2 * w <= tile) {
    count = 1;
    w = tile;
  }
  for (; w < n; w *= 2) ++count;
  return count;
}

template <typename T>
int launch(const void* in, void* out, void* scratch, long long P, long long B,
           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!valid(P, B)) return (int)cudaErrorInvalidValue;
  if (P == 1) return 0;  // the wrapper copies a single row itself
  const long long n = P * B;
  const int count = launches(P, B);
  if (count > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // The round after which `count - r` launches remain writes out when that
  // is odd: the last launch always writes out.
  T* bufs[2] = {(T*)out, (T*)scratch};
  int dst = (count % 2) ? 0 : 1;
  const T* src = (const T*)in;
  const int tile = n < TILE ? (int)n : TILE;
  long long w = B;
  int err;
  if (2 * w <= tile) {
    const int threads = tile < TILE_THREADS ? tile : TILE_THREADS;
    const size_t smem = tile_smem_bytes<T>(tile);
    if ((err = (int)cudaFuncSetAttribute(tile_merge<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem)))
      return err;
    tile_merge<T><<<(unsigned int)(n / tile), threads, smem, st>>>(src, bufs[dst], tile, (int)w);
    if ((err = (int)cudaGetLastError())) return err;
    src = bufs[dst];
    dst ^= 1;
    w = tile;
  }
  for (; w < n; w *= 2) {
    merge_round<T><<<(unsigned int)(n / SPAN), SPAN_THREADS, 0, st>>>(src, bufs[dst], w);
    if ((err = (int)cudaGetLastError())) return err;
    src = bufs[dst];
    dst ^= 1;
  }
  return 0;
}

}  // namespace

extern "C" {

// in: (P, B) sorted rows; out: P*B keys; scratch: P*B keys, or null when
// tournament_launches(P, B) <= 1.
int tournament_i32(const void* in, void* out, void* scratch, long long P,
                   long long B, void* stream) {
  return launch<int32_t>(in, out, scratch, P, B, stream);
}

int tournament_i64(const void* in, void* out, void* scratch, long long P,
                   long long B, void* stream) {
  return launch<int64_t>(in, out, scratch, P, B, stream);
}

int tournament_launches(long long P, long long B) { return launches(P, B); }

}  // extern "C"
