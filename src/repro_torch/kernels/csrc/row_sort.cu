// K1: row sort -- the fused hop's block-matrix sort on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitonic.py::sort_tiles
// (_sort_kernel): an ascending sort of every row of a contiguous (rows, B)
// integer matrix, B a power of two (1..4096), int32 or int64 keys.
//
// What bounds it on an H100: bytes, by less than a factor of two.  Every key
// is read once and written once, while the bitonic network does
// log2(B)(log2(B)+1)/4 compare-exchanges per key (10.5 at the hop's B = 64),
// two 32-bit integer operations each (min, max) on int32 keys.  At the root
// hop (1,562,509 x 64 int32) the bytes take 0.24 ms at 3.35 TB/s and the
// operations 0.13 ms on the INT32 ALUs (132 SMs x 64 lanes x 1.98 GHz).  Both
// are far below what device-memory passes per stage would cost, so the design
// keeps the whole network out of device memory: one thread block
// loads a tile of TILE keys (TILE/B whole rows, one contiguous coalesced
// span), runs every (k, j) stage of the network in shared memory with
// __syncthreads() between stages, and stores the tile once.  The network is
// the schedule of bitonic.py::_stages; the direction of a pair is taken from
// its position inside its own row, so rows packed side by side in one tile
// never interact.  Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W: 1.63 ms for the 100M-key root hop (1,562,509 x 64 int32) against a
// 0.24 ms byte bound -- the barrier-separated shared-memory stages, not the
// bytes, set the pace.  Warp shuffles for the j < 32 stages are the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;     // keys per block: 16 KB (int32) / 32 KB (int64)
constexpr int THREADS = 512;   // each thread owns TILE / 2 / THREADS pairs

template <typename T>
__device__ __forceinline__ T max_of();
template <>
__device__ __forceinline__ int32_t max_of<int32_t>() { return INT32_MAX; }
template <>
__device__ __forceinline__ int64_t max_of<int64_t>() { return INT64_MAX; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
row_sort_kernel(const T* __restrict__ in, T* __restrict__ out,
                long long total, int B) {
  __shared__ T s[TILE];
  const long long base = (long long)blockIdx.x * TILE;
  long long rem = total - base;
  const int valid = rem < TILE ? (int)rem : TILE;
  // Whole rows only: valid is a multiple of B because total is rows * B and
  // B divides TILE.  The tail of a short last tile holds no row; filling it
  // with the maximum keeps every compare well defined.
  for (int i = threadIdx.x; i < TILE; i += THREADS)
    s[i] = i < valid ? in[base + i] : max_of<T>();
  __syncthreads();
  const int mask = B - 1;
  for (int k = 2; k <= B; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < TILE / 2; t += THREADS) {
        const int i = ((t / j) * 2 * j) + (t % j);  // lower element of pair
        const int p = i + j;
        const bool asc = ((i & mask) & k) == 0;
        const T a = s[i];
        const T b = s[p];
        const bool swap = asc ? (a > b) : (a < b);
        if (swap) {
          s[i] = b;
          s[p] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < valid; i += THREADS) out[base + i] = s[i];
}

template <typename T>
int launch(const void* in, void* out, long long rows, int B, void* stream) {
  if (rows <= 0) return 0;
  if (B < 1 || B > TILE || (B & (B - 1))) return (int)cudaErrorInvalidValue;
  const long long total = rows * (long long)B;
  const long long blocks = (total + TILE - 1) / TILE;
  if (B == 1) {
    cudaMemcpyAsync(out, in, total * sizeof(T), cudaMemcpyDeviceToDevice,
                    (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  row_sort_kernel<T><<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, total, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int row_sort_i32(const void* in, void* out, long long rows, int B,
                 void* stream) {
  return launch<int32_t>(in, out, rows, B, stream);
}

int row_sort_i64(const void* in, void* out, long long rows, int B,
                 void* stream) {
  return launch<int64_t>(in, out, rows, B, stream);
}

}  // extern "C"
