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
//
// What bounds it on an H100: neither bytes nor operations.  At the MoE
// prefill's row (1 x 16,384 int32 pairs) the pairs are 128 KB, read and
// written once in 0.08 us at 3.35 TB/s, and the 105 stages of 8,192
// compare-exchanges (4 INT32 operations each: min and max of the keys, two
// selects of the values) take 0.2 us on the card's INT32 ALUs.  A single row
// is one block's work, so the kernel runs on one SM: its time is the 105
// barrier-separated shared-memory stages of one block, and the rest of the
// card idles.  The design keeps the whole row out of device memory: one
// block per tile of TILE pairs, keys and values in dynamic shared memory
// (TILE * 12 bytes = 192 KB at int64, above the default 48 KB, so the launch
// raises the block's limit with cudaFuncSetAttribute first), every stage
// with 2j <= TILE run there with __syncthreads() between stages.  A row wider
// than TILE (2^15 int32 pairs would need 256 KB) runs the stages whose pairs
// lie a tile or more apart (j >= TILE) as device-memory passes, one launch per
// stage, then the rest of that k in shared memory, as tournament.cu does.
// Measured by chip_smoke.py (PERF.md has the numbers and the card).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16384;   // pairs per shared-memory tile
constexpr int THREADS = 1024; // threads of a full tile's block
constexpr int GLOBAL_THREADS = 256;

template <typename K>
__device__ __forceinline__ void cex(K* sk, int* sv, int i, int p, bool asc) {
  const K a = sk[i];
  const K b = sk[p];
  if (asc ? a > b : a < b) {
    sk[i] = b;
    sk[p] = a;
    const int t = sv[i];
    sv[i] = sv[p];
    sv[p] = t;
  }
}

// Lower element of pair t in a stage of distance j (j a power of two).
__device__ __forceinline__ long long lower_of(long long t, long long j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// One tile of `tile` pairs (block b holds elements [b*tile, (b+1)*tile) of
// the row-major matrix; tile divides n).  Runs the stages k = k_first ..
// k_last (doubling), j from j_first for the first k and from k/2 after it,
// down to 1.  Reads (kin, vin) and writes (kout, vout), which may alias.
template <typename K>
__global__ void __launch_bounds__(THREADS)
tile_stages(const K* kin, const int* vin, K* kout, int* vout, long long n,
            int tile, long long k_first, long long k_last, int j_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  int* sv = reinterpret_cast<int*>(sk + tile);
  const long long base = (long long)blockIdx.x * tile;
  const long long in_row = base & (n - 1);  // tile's offset inside its row
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    sk[i] = kin[base + i];
    sv[i] = vin[base + i];
  }
  __syncthreads();
  const int half = tile / 2;
  for (long long k = k_first; k <= k_last; k <<= 1) {
    for (int j = k == k_first ? j_first : (int)(k >> 1); j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = (int)lower_of(t, j);
        cex(sk, sv, i, i + j, ((in_row + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    kout[base + i] = sk[i];
    vout[base + i] = sv[i];
  }
}

// One stage (k, j) over all rows in device memory (j >= TILE).
template <typename K>
__global__ void global_stage(K* __restrict__ keys, int* __restrict__ vals,
                             long long pairs, long long n, long long k,
                             long long j) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long i = lower_of(t, j);  // 2j divides n: pairs never cross rows
  const long long p = i + j;
  const K a = keys[i];
  const K b = keys[p];
  const bool asc = ((i & (n - 1)) & k) == 0;
  if (asc ? a > b : a < b) {
    keys[i] = b;
    keys[p] = a;
    const int t2 = vals[i];
    vals[i] = vals[p];
    vals[p] = t2;
  }
}

template <typename K>
int launch(const void* kin, const void* vin, void* kout, void* vout,
           long long rows, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 0 || n < 2 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int tile = n < TILE ? (int)n : TILE;
  const int smem = tile * (int)(sizeof(K) + sizeof(int));
  static int smem_allowed = 48 * 1024;  // per instantiation of launch<K>
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_stages<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  const unsigned int tiles = (unsigned int)(rows * (n / tile));
  const int threads = tile / 2 < THREADS ? (tile / 2 < 32 ? 32 : tile / 2)
                                         : THREADS;
  tile_stages<K><<<tiles, threads, smem, st>>>((const K*)kin, (const int*)vin,
                                               (K*)kout, (int*)vout, n, tile,
                                               2, tile, 1);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long pairs = rows * n / 2;
  const unsigned int gblocks =
      (unsigned int)((pairs + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  for (long long k = 2LL * tile; k <= n; k <<= 1) {
    for (long long j = k / 2; j >= tile; j >>= 1) {
      global_stage<K><<<gblocks, GLOBAL_THREADS, 0, st>>>(
          (K*)kout, (int*)vout, pairs, n, k, j);
      if ((err = (int)cudaGetLastError())) return err;
    }
    tile_stages<K><<<tiles, threads, smem, st>>>(
        (const K*)kout, (const int*)vout, (K*)kout, (int*)vout, n, tile, k, k,
        tile / 2);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
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
