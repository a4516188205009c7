// K1: row sort -- the fused hop's block-matrix sort on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitonic.py::sort_tiles
// (_sort_kernel): an ascending sort of every row of a contiguous (rows, B)
// integer matrix, B a power of two (1..4096), int32 or int64 keys.  The rows
// hold keys only, so every correct sort gives the same bits; this kernel
// runs the stages of bitonic.py::_stages in order, and equals the plain
// torch version (sort_rows_plain) exactly.
//
// What bounds it on an H100: bytes.  Every key is read once and written
// once, while the network does log2(B)(log2(B)+1)/4 compare-exchanges per
// key (10.5 at the hop's B = 64), two 32-bit integer operations each (min,
// max) on int32 keys.  At the root hop (1,562,509 x 64 int32) the bytes take
// 0.239 ms at 3.35 TB/s and the operations 0.126 ms on the INT32 ALUs (132
// SMs x 64 lanes x 1.98 GHz).  So the network must stay out of device
// memory and cost less than the bytes: a row lives in registers.
//
// Layout: a block of THREADS threads owns a tile of N * THREADS consecutive
// keys (whole rows), thread t the N = ITEMS consecutive keys N t .. N t + N-1
// (layout A), loaded and stored as 16-byte vectors.  At B = 64 a row is 8
// lanes and a warp holds 4 rows; at B <= ITEMS a thread holds whole rows.
// At B = 4096 a thread holds N = 16 keys so that a block still holds a row.
// B is a template parameter (a switch over the 12 widths), so every stage
// unrolls, with its pair distance j and merge size k as constants; a pair
// (p, p + j) ascends unless the row position p has bit k set (k = B: the last
// merge, all ascending), read from the thread's offset with a mask.  Each
// stage runs in the tier its j allows:
//
// * j < N: inside a thread's registers;
// * N <= j < THREADS: by __shfl_xor_sync with lane ^ (j / N), which holds
//   the partner of every register (THREADS <= 32 ITEMS keeps it in the
//   warp); all N shuffles of a stage are issued before the first is used,
//   and the thread keeps the min or the max as its position says;
// * j >= THREADS (B > 256 only): after a transpose through shared memory
//   into layout B, where register r holds position r THREADS + t, the pair
//   lies in one thread's registers again; two barriers per transpose,
//   padded one word in 32 so neither side conflicts.
//
// A compare-exchange is a min, a max and two selects, with no branch.  The
// last block may hold fewer keys than a tile: positions past the matrix read
// the dtype's maximum and form whole rows of their own (B divides the
// tile), and only real positions are stored.  A base pointer that is not
// 16-byte aligned (a contiguous view at an odd offset) takes key-by-key
// loads and stores in the same kernel.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.272-0.275
// ms a call at the root hop (device time, a CUDA graph of 24 calls), 87% of
// the byte bound, against 1.571 ms for the shared-memory network with a
// barrier after every stage that this design replaced.  ptxas: 28 registers
// at int32 B = 64, at most 111 (int64 B = 4096), no spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITEMS = 8;      // consecutive keys a thread holds (16 at 4096)
constexpr int THREADS = 256;  // threads of a block
constexpr int MAX_ROW = 4096;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS <= 32 * ITEMS, "every j < THREADS lies inside a warp");
static_assert(MAX_ROW <= 16 * THREADS, "at most 16 keys a thread");

// Keys a thread holds at width B: ITEMS, or B / THREADS where a tile of
// ITEMS * THREADS keys would be shorter than a row.
template <int B>
__host__ __device__ constexpr int items() {
  return B > ITEMS * THREADS ? B / THREADS : ITEMS;
}

template <typename T>
__device__ __forceinline__ T max_of();
template <>
__device__ __forceinline__ int32_t max_of<int32_t>() { return INT32_MAX; }
template <>
__device__ __forceinline__ int64_t max_of<int64_t>() { return INT64_MAX; }

template <typename T>
__device__ __forceinline__ T kmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T kmax(T a, T b) { return a < b ? b : a; }

__device__ __forceinline__ int32_t shfl_x(int32_t x, int m) {
  return __shfl_xor_sync(FULL, x, m);
}
__device__ __forceinline__ int64_t shfl_x(int64_t x, int m) {
  return (int64_t)__shfl_xor_sync(FULL, (long long)x, m);
}

template <typename T>
__device__ __forceinline__ void cex(T& a, T& b, bool asc) {
  const T lo = kmin(a, b), hi = kmax(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// A thread's N keys as 16-byte vectors: 4 int32 or 2 int64 each.
template <int N>
__device__ __forceinline__ void vload(const int32_t* p, int32_t (&x)[N]) {
#pragma unroll
  for (int v = 0; v < N; v += 4) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p + v));
    x[v] = w.x; x[v + 1] = w.y; x[v + 2] = w.z; x[v + 3] = w.w;
  }
}
template <int N>
__device__ __forceinline__ void vload(const int64_t* p, int64_t (&x)[N]) {
#pragma unroll
  for (int v = 0; v < N; v += 2) {
    const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(p + v));
    x[v] = w.x; x[v + 1] = w.y;
  }
}
template <int N>
__device__ __forceinline__ void vstore(int32_t* p, const int32_t (&x)[N]) {
#pragma unroll
  for (int v = 0; v < N; v += 4)
    *reinterpret_cast<int4*>(p + v) = make_int4(x[v], x[v + 1], x[v + 2], x[v + 3]);
}
template <int N>
__device__ __forceinline__ void vstore(int64_t* p, const int64_t (&x)[N]) {
#pragma unroll
  for (int v = 0; v < N; v += 2)
    *reinterpret_cast<longlong2*>(p + v) = make_longlong2(x[v], x[v + 1]);
}

// Stage (K, J), J < N, in layout A: register r holds position e0 + r.
template <typename T, int N, int B, int K, int J>
__device__ __forceinline__ void reg_stage(T (&x)[N], unsigned e0) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r & J) continue;
    const bool asc = K == B || (K < N ? !(r & K) : !(e0 & K));
    cex(x[r], x[r + J], asc);
  }
}

// Stage (K, J), N <= J < THREADS, in layout A: the partner of every register
// is the same register of lane ^ (J / N); K > J >= N, so the direction is
// the thread's.
template <typename T, int N, int B, int K, int J>
__device__ __forceinline__ void shfl_stage(T (&x)[N], unsigned e0) {
  const bool asc = K == B || !(e0 & K);
  const bool keep_min = asc == !(e0 & J);
  T o[N];
#pragma unroll
  for (int r = 0; r < N; ++r) o[r] = shfl_x(x[r], J / N);
#pragma unroll
  for (int r = 0; r < N; ++r)
    x[r] = keep_min ? kmin(x[r], o[r]) : kmax(x[r], o[r]);
}

// Stage (K, J), J >= THREADS, in layout B: register r holds position
// r THREADS + t, so bits K and J of a position are bits of r.
template <typename T, int N, int B, int K, int J>
__device__ __forceinline__ void wide_stage(T (&x)[N]) {
  constexpr int M = J / THREADS;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r & M) continue;
    cex(x[r], x[r + M], K == B || !((r * THREADS) & K));
  }
}

__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

// Layout A <-> layout B through shared memory.
template <typename T, int N, bool TO_B>
__device__ __forceinline__ void transpose(T (&x)[N], T* s, int t) {
#pragma unroll
  for (int r = 0; r < N; ++r) s[pad(TO_B ? N * t + r : r * THREADS + t)] = x[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < N; ++r) x[r] = s[pad(TO_B ? r * THREADS + t : N * t + r)];
  __syncthreads();
}

// Stage (K, J) and every stage after it, in order; IN_B: the layout the
// registers are in.
template <typename T, int N, int B, int K, int J, bool IN_B>
__device__ __forceinline__ void network(T (&x)[N], T* s, int t) {
  constexpr bool wide = J >= THREADS;
  if constexpr (wide != IN_B) transpose<T, N, wide>(x, s, t);
  if constexpr (wide)
    wide_stage<T, N, B, K, J>(x);
  else if constexpr (J < N)
    reg_stage<T, N, B, K, J>(x, N * t);
  else
    shfl_stage<T, N, B, K, J>(x, N * t);
  if constexpr (J > 1)
    network<T, N, B, K, J / 2, wide>(x, s, t);
  else if constexpr (K < B)
    network<T, N, B, 2 * K, K, wide>(x, s, t);
}

template <typename T, int B>
__global__ void __launch_bounds__(THREADS)
row_sort_kernel(const T* __restrict__ in, T* __restrict__ out,
                long long total, int vec) {
  constexpr int N = items<B>();
  constexpr int TILE = N * THREADS;
  __shared__ T s[B > THREADS ? TILE + TILE / 32 : 1];
  const long long base = (long long)blockIdx.x * TILE;
  const long long rem = total - base;
  const int valid = rem < TILE ? (int)rem : TILE;
  const int t = threadIdx.x;
  const int e0 = N * t;
  in += base + e0;
  out += base + e0;
  const bool whole = vec && e0 + N <= valid;
  T x[N];
  if (whole) {
    vload(in, x);
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r) x[r] = e0 + r < valid ? in[r] : max_of<T>();
  }
  network<T, N, B, 2, 1, false>(x, s, t);
  if (whole) {
    vstore(out, x);
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (e0 + r < valid) out[r] = x[r];
  }
}

template <typename T, int B>
int launch_width(const void* in, void* out, long long total, int vec,
                 cudaStream_t st) {
  constexpr long long TILE = (long long)items<B>() * THREADS;
  const long long blocks = (total + TILE - 1) / TILE;
  row_sort_kernel<T, B><<<(unsigned)blocks, THREADS, 0, st>>>(
      (const T*)in, (T*)out, total, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, long long rows, int B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 0 || B < 1 || B > MAX_ROW || (B & (B - 1)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long total = rows * (long long)B;
  if (B == 1) {
    cudaMemcpyAsync(out, in, total * sizeof(T), cudaMemcpyDeviceToDevice, st);
    return (int)cudaGetLastError();
  }
  const int vec = ((uintptr_t)in | (uintptr_t)out) % 16 == 0;
  switch (B) {
    case 2: return launch_width<T, 2>(in, out, total, vec, st);
    case 4: return launch_width<T, 4>(in, out, total, vec, st);
    case 8: return launch_width<T, 8>(in, out, total, vec, st);
    case 16: return launch_width<T, 16>(in, out, total, vec, st);
    case 32: return launch_width<T, 32>(in, out, total, vec, st);
    case 64: return launch_width<T, 64>(in, out, total, vec, st);
    case 128: return launch_width<T, 128>(in, out, total, vec, st);
    case 256: return launch_width<T, 256>(in, out, total, vec, st);
    case 512: return launch_width<T, 512>(in, out, total, vec, st);
    case 1024: return launch_width<T, 1024>(in, out, total, vec, st);
    case 2048: return launch_width<T, 2048>(in, out, total, vec, st);
    default: return launch_width<T, 4096>(in, out, total, vec, st);
  }
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
