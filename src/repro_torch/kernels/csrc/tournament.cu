// K2: tournament -- the run arena's merge of P padded sorted rows on Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitonic.py::tournament_tiles (_tournament_kernel): a
// (P, B) matrix of sorted rows, padded with the dtype maximum, both powers of
// two, becomes one sorted row of P*B keys.  Round r merges adjacent row pairs
// of width w = B * 2^r into rows of width 2w with the bitonic merge network.
// The TPU kernel kept the whole matrix in VMEM (capped at 2^22 keys); here
// any P*B that fits in device memory is taken.
//
// What bounds it on an H100: integer operations.  A round over n keys runs
// log2(2w) compare-exchange stages of n/2 pairs; on int64 keys each costs six
// 32-bit integer operations (a 64-bit compare is two, and min and max each
// select two halves).  At the main path's largest bucket (131,072 x 64
// int64: 255 stages, 1.07e9 compare-exchanges) that is 0.38 ms on the INT32
// ALUs (132 SMs x 64 lanes x 1.98 GHz), against 0.04 ms for reading and
// writing the 64 MiB once.  What the kernel actually pays for is neither: a
// stage whose pairs span more than one shared-memory tile must read and write
// all n keys in device memory.  The design therefore keeps every stage it can
// inside shared memory:
//   * rounds with 2w <= TILE run together in one launch per tile
//     (tile_rounds): the first log2(TILE/B) rounds never leave the SM;
//   * a wider round runs each stage whose pairs lie more than a tile apart
//     (2j > TILE, and its flip stage) as one global launch (global_flip,
//     global_cleaner), then all its stages with 2j <= TILE in one
//     shared-memory launch (tile_cleaners).
// The flip of concat(a, flip(b)) is never copied: the first stage of a round
// compares position i with 2w-1-i inside each 2w-wide pair of rows (the
// "flip" comparator), after which both halves are bitonic and the remaining
// half-cleaner stages (i against i+j, ascending) finish the sort.  The work
// is in place on the output buffer, which the host fills with a copy of the
// input first.  Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W: 4.8-5.0 ms for the main path's largest bucket (78 passes over the
// matrix) against its 0.38 ms operation bound, and slower than torch.sort on
// the same keys.  Merge-path partitioning, which would cut the
// device-memory passes to one per round, is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;    // keys per shared-memory tile
constexpr int THREADS = 512;  // threads per block
constexpr int GLOBAL_THREADS = 256;

template <typename T>
__device__ __forceinline__ void cmp_swap(T& a, T& b) {
  if (a > b) {
    const T t = a;
    a = b;
    b = t;
  }
}

// Rounds w = w0, 2*w0, ..., tile/2, each the flip stage plus its
// half-cleaners, inside one tile of `tile` keys.
template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_rounds(T* __restrict__ x, int tile, int w0) {
  __shared__ T s[TILE];
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += THREADS) s[i] = x[base + i];
  __syncthreads();
  const int half = tile / 2;
  for (int w = w0; w < tile; w <<= 1) {
    // flip: pair t -> i inside its 2w-block, partner 2w-1-i
    for (int t = threadIdx.x; t < half; t += THREADS) {
      const int blk = t / w;
      const int i = t % w;
      const int p = blk * 2 * w + i;
      const int q = blk * 2 * w + 2 * w - 1 - i;
      T a = s[p], b = s[q];
      cmp_swap(a, b);
      s[p] = a;
      s[q] = b;
    }
    __syncthreads();
    for (int j = w >> 1; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += THREADS) {
        const int p = (t / j) * 2 * j + (t % j);
        const int q = p + j;
        T a = s[p], b = s[q];
        cmp_swap(a, b);
        s[p] = a;
        s[q] = b;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += THREADS) x[base + i] = s[i];
}

// Half-cleaner stages j = j0, j0/2, ..., 1 inside each tile (2*j0 <= tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_cleaners(T* __restrict__ x, int tile, int j0) {
  __shared__ T s[TILE];
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += THREADS) s[i] = x[base + i];
  __syncthreads();
  const int half = tile / 2;
  for (int j = j0; j >= 1; j >>= 1) {
    for (int t = threadIdx.x; t < half; t += THREADS) {
      const int p = (t / j) * 2 * j + (t % j);
      const int q = p + j;
      T a = s[p], b = s[q];
      cmp_swap(a, b);
      s[p] = a;
      s[q] = b;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile; i += THREADS) x[base + i] = s[i];
}

// The flip stage of a round of width w over all n keys in device memory.
template <typename T>
__global__ void global_flip(T* __restrict__ x, long long pairs, long long w) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long blk = t / w;
  const long long i = t - blk * w;
  const long long p = blk * 2 * w + i;
  const long long q = blk * 2 * w + 2 * w - 1 - i;
  T a = x[p], b = x[q];
  cmp_swap(a, b);
  x[p] = a;
  x[q] = b;
}

// One half-cleaner stage of distance j over all n keys in device memory.
template <typename T>
__global__ void global_cleaner(T* __restrict__ x, long long pairs,
                               long long j) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long blk = t / j;
  const long long p = blk * 2 * j + (t - blk * j);
  const long long q = p + j;
  T a = x[p], b = x[q];
  cmp_swap(a, b);
  x[p] = a;
  x[q] = b;
}

template <typename T>
int launch(const void* in, void* out, long long P, long long B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P < 1 || B < 1 || (P & (P - 1)) || (B & (B - 1)))
    return (int)cudaErrorInvalidValue;
  const long long n = P * B;
  T* x = (T*)out;
  cudaMemcpyAsync(out, in, n * sizeof(T), cudaMemcpyDeviceToDevice, st);
  int err = (int)cudaGetLastError();
  if (err || P == 1) return err;
  const int tile = n < TILE ? (int)n : TILE;
  const unsigned int tiles = (unsigned int)(n / tile);
  const long long pairs = n / 2;
  const unsigned int gblocks =
      (unsigned int)((pairs + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  long long w = B;
  if (2 * w <= tile) {
    tile_rounds<T><<<tiles, THREADS, 0, st>>>(x, tile, (int)w);
    if ((err = (int)cudaGetLastError())) return err;
    w = tile;
  }
  for (; w < n; w *= 2) {
    global_flip<T><<<gblocks, GLOBAL_THREADS, 0, st>>>(x, pairs, w);
    if ((err = (int)cudaGetLastError())) return err;
    long long j = w / 2;
    for (; 2 * j > tile; j /= 2) {
      global_cleaner<T><<<gblocks, GLOBAL_THREADS, 0, st>>>(x, pairs, j);
      if ((err = (int)cudaGetLastError())) return err;
    }
    tile_cleaners<T><<<tiles, THREADS, 0, st>>>(x, tile, (int)j);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

int tournament_i32(const void* in, void* out, long long P, long long B,
                   void* stream) {
  return launch<int32_t>(in, out, P, B, stream);
}

int tournament_i64(const void* in, void* out, long long P, long long B,
                   void* stream) {
  return launch<int64_t>(in, out, P, B, stream);
}

}  // extern "C"
