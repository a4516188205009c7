// K4: row merge -- two row-wise sorted matrices into one, on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitonic.py::merge_tiles
// (_merge_kernel): a and b are contiguous (rows, B) matrices whose rows are
// sorted ascending, B a power of two; row r of the (rows, 2B) output is the
// sorted merge of a[r] and b[r].  Types: int32, int64, float32 (NaN-free).
// The network is bitonic.py::bitonic_merge_rows: the row of concat(a[r],
// flip(b[r])) is bitonic, and the log2(2B) half-cleaner stages j = B, B/2,
// .., 1 with k = 2B (every pair ascending: min to i, max to i + j) sort it.
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once; the network does log2(2B) compare-exchanges per pair.  At the shape
// of one K2 round on the sort path's largest bucket (two 65,536 x 64 int64
// halves into 65,536 x 128) the 134 MB take 0.040 ms at 3.35 TB/s and the
// 29.4M compare-exchanges 0.011 ms on the INT32 ALUs (6 operations each on
// int64).  The design moves each element through device memory once: one
// block loads a tile of TILE elements (TILE / 2B whole output rows, each
// written as concat(a, flip(b)) while it is loaded, so the flip is never
// stored), runs all the stages in shared memory with __syncthreads() between
// them, and stores the tile.  An output row wider than TILE runs the first
// stage straight from a and b into the output and every stage whose pairs
// lie a tile or more apart (j >= TILE) as device-memory passes, one launch
// each, then the rest in shared memory.  Measured by chip_smoke.py (PERF.md
// has the numbers and the card).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;    // elements per shared-memory tile
constexpr int THREADS = 512;  // threads per tile block
constexpr int GLOBAL_THREADS = 256;

template <typename T>
__device__ __forceinline__ void cmp_swap(T& lo, T& hi) {
  if (lo > hi) {
    const T t = lo;
    lo = hi;
    hi = t;
  }
}

__device__ __forceinline__ long long lower_of(long long t, long long j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// Element g of the (rows, n) matrix concat(a, flip(b)), n = 2B.
template <typename T>
__device__ __forceinline__ T load_ab(const T* a, const T* b, long long g,
                                     long long n) {
  const long long q = g & (n - 1);
  const long long half = (g - q) >> 1;  // row * B
  const long long B = n >> 1;
  return q < B ? a[half + q] : b[half + (n - 1 - q)];
}

// The stages j = j_first .. 1 over one tile of the (rows, n) output; the
// tile (a power of two) holds whole rows when n <= TILE and is a slice of
// one row otherwise.  Loads from a and b when from_ab, else from out.
template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_tile(const T* __restrict__ a, const T* __restrict__ b, T* out,
           long long total, long long n, int tile, int j_first, int from_ab) {
  __shared__ T s[TILE];
  const long long base = (long long)blockIdx.x * tile;
  const long long rem = total - base;
  const int valid = rem < tile ? (int)rem : tile;  // a multiple of n, or tile
  for (int i = threadIdx.x; i < valid; i += THREADS)
    s[i] = from_ab ? load_ab(a, b, base + i, n) : out[base + i];
  __syncthreads();
  for (int j = j_first; j >= 1; j >>= 1) {
    for (int t = threadIdx.x; t < tile / 2; t += THREADS) {
      const int i = (int)lower_of(t, j);
      if (i < valid) cmp_swap(s[i], s[i + j]);  // pairs never cross rows
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < valid; i += THREADS) out[base + i] = s[i];
}

// Stage j = B of every row, straight from a and b into out.
template <typename T>
__global__ void global_first(const T* __restrict__ a, const T* __restrict__ b,
                             T* __restrict__ out, long long pairs,
                             long long B) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long q = t & (B - 1);
  const long long r = t - q;  // row * B
  T lo = a[t];
  T hi = b[r + (B - 1 - q)];
  cmp_swap(lo, hi);
  out[2 * r + q] = lo;
  out[2 * r + q + B] = hi;
}

// One half-cleaner stage of distance j over the whole output.
template <typename T>
__global__ void global_cleaner(T* __restrict__ x, long long pairs,
                               long long j) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long p = lower_of(t, j);
  T lo = x[p];
  T hi = x[p + j];
  cmp_swap(lo, hi);
  x[p] = lo;
  x[p + j] = hi;
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long rows,
           long long B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 0 || B < 1 || (B & (B - 1))) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long n = 2 * B;
  const long long total = rows * n;
  const T* pa = (const T*)a;
  const T* pb = (const T*)b;
  T* po = (T*)out;
  int err;
  if (n <= TILE) {
    // whole rows per tile; a tile no wider than the matrix needs
    long long tile = n;
    while (tile < TILE && tile < total) tile <<= 1;
    const unsigned int blocks = (unsigned int)((total + tile - 1) / tile);
    merge_tile<T><<<blocks, THREADS, 0, st>>>(pa, pb, po, total, n, (int)tile,
                                              (int)B, 1);
    return (int)cudaGetLastError();
  }
  const long long pairs = total / 2;
  const unsigned int gblocks =
      (unsigned int)((pairs + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  global_first<T><<<gblocks, GLOBAL_THREADS, 0, st>>>(pa, pb, po, pairs, B);
  if ((err = (int)cudaGetLastError())) return err;
  long long j = B / 2;
  for (; j >= TILE; j /= 2) {
    global_cleaner<T><<<gblocks, GLOBAL_THREADS, 0, st>>>(po, pairs, j);
    if ((err = (int)cudaGetLastError())) return err;
  }
  merge_tile<T><<<(unsigned int)(total / TILE), THREADS, 0, st>>>(
      pa, pb, po, total, n, TILE, (int)j, 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int merge_rows_i32(const void* a, const void* b, void* out, long long rows,
                   long long B, void* stream) {
  return launch<int32_t>(a, b, out, rows, B, stream);
}

int merge_rows_i64(const void* a, const void* b, void* out, long long rows,
                   long long B, void* stream) {
  return launch<int64_t>(a, b, out, rows, B, stream);
}

int merge_rows_f32(const void* a, const void* b, void* out, long long rows,
                   long long B, void* stream) {
  return launch<float>(a, b, out, rows, B, stream);
}

}  // extern "C"
