// K7: the WKV recurrence of RWKV6's time mix, forward.
//
// Not a TPU kernel: the counterpart of the `step` inside the `lax.scan` of
// src/repro/models/rwkv6.py::rwkv_time_mix, which the reference leaves in
// plain jnp.  For each (batch b, head h) it carries a 64 x 64 float32 state
// S (key index i, value index j) through T steps:
//   y_t[j] = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j] <- w_t[i] S[i,j] + k_t[i] v_t[j]
// r, k, v, w: (B, T, H, 64) float32 with the last axis contiguous (any other
// strides); u: (H, 64) contiguous; the initial state s0 and the final state
// (B, H, 64, 64) with the inner (64, 64) contiguous (any batch and head
// strides: a layer's slice of the serving cache).  y is written (B, T, H, 64).
//
// Design.  The bonus is factored out of the state:
//   y_t[j] = sum_i r_t[i] S[i,j] + v_t[j] rho_t,  rho_t = sum_i r_t[i] u[i] k_t[i],
// so a state element costs three float32 operations a step (k_i v_j, the
// read's FMA, the update's FMA), and rho_t is one 64-long dot a step.
// - Columns over blocks.  y_t[j] and column j of S depend on column j alone,
//   so a (b, h)'s 64 columns split over 64 / CB blocks (the column block is
//   the fastest block index, so a head's blocks run together and share its
//   r, k, w rows in L2).  The wrapper picks CB from B H (kernels/wkv.py
//   launch_plan): 32 columns where that gives 256 blocks (B H 128, the
//   training shape), else 8 (a B 1 prefill of 32 heads: 256 blocks).
// - Register tiles.  Each of a block's 128 threads holds an R x C tile of
//   its columns (4 x 4 at CB 32, 2 x 2 at 8) for the whole sequence.  A step
//   reads R values each of r, k, w and C of v as vector shared loads; a
//   tile's partial y over its R rows (C independent accumulators, R-long
//   chains) is summed over the 64 / R threads of its columns (all in one
//   warp) by __shfl_xor_sync in a fixed order, halving the values at each
//   level so that each thread ends with one column.  A chunk's CH steps are
//   unrolled and each column's sums stay in registers until the chunk ends,
//   so one step's sums overlap the next step's work.
// - Staging.  The CH steps of a chunk are loaded into registers (16 bytes a
//   load; 4 where a row is not 16-byte aligned) while the chunk before
//   computes, then stored to the other of two shared buffers; rho is summed
//   from those registers (16 lanes a step, by shuffles) on the way.  One
//   barrier a chunk.  y goes through shared memory and leaves as 16-byte
//   stores of whole rows, a chunk behind.  (Copies by cp.async, even three
//   chunks ahead, and by the bulk-copy engine were slower on an H100: their
//   loads did not overlap the steps, which load from shared memory too.)
// - A chunk shorter than CH (the last) writes y straight from the threads
//   that hold it, with no barrier after it.
// - T = 1 (a decode step) runs a kernel of its own with the wide tiles, no
//   shared memory and no barrier: through the chunked kernel, whose staging,
//   barriers and 33 KB of shared memory a single step cannot hide, a decode
//   step was slower than the one-block-a-head kernel this design replaced.
//
// In place: the final state may be written over s0 (the decode step passes
// its layer's slice of the cache as both).  Each thread reads its tile of
// s0 before the first step and writes the same tile after the last; no other
// thread, in this block or another, touches those elements.  So every
// element is read before it is written, whatever order the blocks run in.
//
// What bounds it on an H100: bytes.  At the training shape (B 4, T 2,048,
// H 32) it reads r, k, v, w (268 MB) and writes y (67 MB): 0.100 ms at
// 3.35 TB/s, against 5.4e9 flops, 0.080 ms at 67 TFLOP/s of float32.  The
// design does not reach either: a thread's step is 48 FMAs among some 30
// shared loads, shuffles, selects and adds, two or four warps a scheduler
// hide little of their latency, and every block loads its head's r, k, w
// rows (2x at CB 32, 8x at CB 8).  Times are in PERF.md (chip_smoke.py
// measures them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;        // head size: state rows and columns
constexpr int CH = 16;        // steps a chunk
constexpr int THREADS = 128;  // threads a block, in every configuration
// The two chunked configurations: columns a block (CB) and a thread's tile
// (R x C).  A single step (T = 1) takes the wide one's blocks and tiles.
constexpr int WIDE_COLS = 32;
constexpr int WIDE_TILE_R = 4;
constexpr int WIDE_TILE_C = 4;
constexpr int NARROW_COLS = 8;
constexpr int NARROW_TILE_R = 2;
constexpr int NARROW_TILE_C = 2;
constexpr int QUADS = HS / 4;  // 4-float pieces of an r, k or w row
constexpr unsigned FULL = 0xffffffffu;

// Element strides of a (B, T, H, HS) tensor whose last axis is contiguous.
struct Seq {
  long long b, t, h;
};

// Element strides of a (B, H, HS, HS) state whose inner (HS, HS) is contiguous.
struct State {
  long long b, h;
};

// N consecutive floats (N x 4 bytes aligned) into registers, and back.
template <int N>
__device__ __forceinline__ void load_vec(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
    static_assert(N == 2, "tiles are 2 or 4 wide");
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x, x[1] = q.y;
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    static_assert(N == 2, "tiles are 2 or 4 wide");
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// N floats of device memory: a vector access where the rows are 16-byte
// aligned (vec), else one float at a time.
template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const float* p, bool vec) {
  if (vec) {
    load_vec(x, p);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = p[e];
  }
}
template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&x)[N], bool vec) {
  if (vec) {
    store_vec(p, x);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = x[e];
  }
}

// Sums v[0..N) over the L = 2 M lanes that differ in lane bits M, M / 2,
// .., 1 (xor masks, largest first).  While values remain, each level halves
// them: the lane whose mask bit is set keeps the upper half and sends the
// lower.  The lane ends with the full sum of value (lane % L) / (L / N),
// which L / N lanes hold alike.  Every lane gets its sums in the same order
// each run.
template <int N, int M>
__device__ __forceinline__ float fold(float* v, int lane) {
  if constexpr (M == 0) {
    static_assert(N == 1, "more values than lanes");
    return v[0];
  } else if constexpr (N > 1) {
    const bool hi = lane & M;
#pragma unroll
    for (int a = 0; a < N / 2; ++a) {
      const float send = hi ? v[a] : v[a + N / 2];
      const float keep = hi ? v[a + N / 2] : v[a];
      v[a] = keep + __shfl_xor_sync(FULL, send, M);
    }
    return fold<N / 2, M / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(FULL, v[0], M);
    return fold<1, M / 2>(v, lane);
  }
}

template <int R, int C, int CB>
__global__ void __launch_bounds__(THREADS) wkv_forward(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ y,
    float* s_out, int T, int H, Seq rs, Seq ks, Seq vs, Seq ws, Seq ys,
    State s0s, State sos, bool vec, bool svec) {
  constexpr int G = HS / R;                  // threads that share a column
  constexpr int NCB = HS / CB;               // blocks a (b, h)
  constexpr int OWN = G / C;                 // threads that end with one column's sum
  constexpr int TRIP = CH * QUADS / THREADS;  // (r, k, w) pieces a thread stages a chunk
  constexpr int VU = CH * CB / 4;            // 4-float pieces of v a chunk
  static_assert(G * (CB / C) == THREADS, "a block's tiles cover its columns");
  static_assert(G <= 32 && 32 % G == 0, "a column's threads lie in one warp");
  static_assert(CH * QUADS % THREADS == 0 && VU <= THREADS, "a chunk's staging");
  __shared__ __align__(16) float s_r[2][CH][HS];
  __shared__ __align__(16) float s_k[2][CH][HS];
  __shared__ __align__(16) float s_w[2][CH][HS];
  __shared__ __align__(16) float s_v[2][CH][CB];
  __shared__ __align__(16) float s_y[2][CH][CB];
  __shared__ float s_rho[2][CH];

  const int tid = threadIdx.x, lane = tid % 32, rg = tid % G, cg = tid / G;
  const int bh = blockIdx.x / NCB, jb = (blockIdx.x % NCB) * CB;
  const int b = bh / H, h = bh % H;
  const int i0 = rg * R, jc = cg * C;  // the tile's first row, first column in the block
  const int jown = jc + rg / OWN;      // the column whose sum this thread ends with
  const int nch = (T + CH - 1) / CH;

  const float* rb = r + b * rs.b + h * rs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* wb = w + b * ws.b + h * ws.h;
  const float* vb = v + b * vs.b + h * vs.h + jb;
  float* yb = y + b * ys.b + h * ys.h + jb;

  float S[R][C];
  const float* sp = s0 + b * s0s.b + h * s0s.h + jb + jc;
#pragma unroll
  for (int a = 0; a < R; ++a) load_row(S[a], sp + (i0 + a) * HS, svec);
  float* so = s_out + b * sos.b + h * sos.h + jb + jc;

  const int quad = tid % QUADS;  // the 4 rows this thread stages (rho's rows too)
  float ur[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ur[e] = u[h * HS + 4 * quad + e];
  float4 pr[TRIP] = {}, pk[TRIP] = {}, pw[TRIP] = {}, pv = {};

  auto ld4 = [&](const float* p) {
    if (vec) return *reinterpret_cast<const float4*>(p);
    return make_float4(p[0], p[1], p[2], p[3]);
  };
  // Chunk ci's inputs into registers: piece s of a step is rows 4 quad .. + 3.
  auto load = [&](int ci) {
    const int t0 = ci * CH, n = min(CH, T - t0);
#pragma unroll
    for (int s = 0; s < TRIP; ++s) {
      const int c = (tid + s * THREADS) / QUADS;
      if (c < n) {
        const long long t = t0 + c;
        pr[s] = ld4(rb + t * rs.t + 4 * quad);
        pk[s] = ld4(kb + t * ks.t + 4 * quad);
        pw[s] = ld4(wb + t * ws.t + 4 * quad);
      }
    }
    const int c = tid / (CB / 4), j = (tid % (CB / 4)) * 4;
    if (tid < VU && c < n) pv = ld4(vb + (t0 + c) * vs.t + j);
  };
  // ... then into buffer ci & 1, with each step's rho.
  auto commit = [&](int ci) {
    const int n = min(CH, T - ci * CH), p = ci & 1;
#pragma unroll
    for (int s = 0; s < TRIP; ++s) {
      const int c = (tid + s * THREADS) / QUADS;
      float q = pr[s].x * ur[0] * pk[s].x;
      q = fmaf(pr[s].y * ur[1], pk[s].y, q);
      q = fmaf(pr[s].z * ur[2], pk[s].z, q);
      q = fmaf(pr[s].w * ur[3], pk[s].w, q);
#pragma unroll
      for (int m = QUADS / 2; m; m /= 2) q += __shfl_xor_sync(FULL, q, m);
      if (c < n) {
        *reinterpret_cast<float4*>(&s_r[p][c][4 * quad]) = pr[s];
        *reinterpret_cast<float4*>(&s_k[p][c][4 * quad]) = pk[s];
        *reinterpret_cast<float4*>(&s_w[p][c][4 * quad]) = pw[s];
        if (quad == 0) s_rho[p][c] = q;
      }
    }
    const int c = tid / (CB / 4), j = (tid % (CB / 4)) * 4;
    if (tid < VU && c < n) *reinterpret_cast<float4*>(&s_v[p][c][j]) = pv;
  };
  // One step from buffer p: this thread's column sum of r S, then the update.
  auto step = [&](int p, int c) {
    float rr[R], kk[R], ww[R], vv[C], part[C];
    load_vec(rr, s_r[p][c] + i0);
    load_vec(kk, s_k[p][c] + i0);
    load_vec(ww, s_w[p][c] + i0);
    load_vec(vv, s_v[p][c] + jc);
#pragma unroll
    for (int x = 0; x < C; ++x) part[x] = rr[0] * S[0][x];
#pragma unroll
    for (int a = 1; a < R; ++a)
#pragma unroll
      for (int x = 0; x < C; ++x) part[x] = fmaf(rr[a], S[a][x], part[x]);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int x = 0; x < C; ++x) S[a][x] = fmaf(ww[a], S[a][x], kk[a] * vv[x]);
    return fold<C, G / 2>(part, lane);
  };
  // A whole chunk's y goes to s_y[ci & 1]; a shorter one's to device memory.
  auto compute = [&](int ci) {
    const int t0 = ci * CH, n = min(CH, T - t0), p = ci & 1;
    if (n == CH) {
      float sums[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) sums[c] = step(p, c);
      if (rg % OWN == 0) {
#pragma unroll
        for (int c = 0; c < CH; ++c) s_y[p][c][jown] = fmaf(s_v[p][c][jown], s_rho[p][c], sums[c]);
      }
    } else {
      for (int c = 0; c < n; ++c) {
        const float sum = step(p, c);
        if (rg % OWN == 0) yb[(t0 + c) * ys.t + jown] = fmaf(s_v[p][c][jown], s_rho[p][c], sum);
      }
    }
  };
  // y of whole chunk ci, from s_y[ci & 1], as whole rows of the block's columns.
  auto write_y = [&](int ci) {
    constexpr int U = CB / 4;
    const int t0 = ci * CH, p = ci & 1;
    for (int q = tid; q < CH * U; q += THREADS) {
      const int c = q / U, j = (q % U) * 4;
      float x[4];
      load_vec(x, s_y[p][c] + j);
      store_row(yb + (t0 + c) * ys.t + j, x, vec);
    }
  };

  load(0);
  commit(0);
  if (nch > 1) load(1);
  __syncthreads();
  // Iteration ci: chunk ci computes from buffer ci & 1 while chunk ci + 1 is
  // in registers; chunk ci - 1's y leaves; chunk ci + 1 goes to the other
  // buffer (chunk ci - 1's, whose reads ended at the last barrier) and chunk
  // ci + 2's loads start.
  for (int ci = 0; ci < nch; ++ci) {
    compute(ci);
    if (ci > 0) write_y(ci - 1);
    if (ci + 1 < nch) {
      commit(ci + 1);
      if (ci + 2 < nch) load(ci + 2);
      __syncthreads();
    }
  }
  if (T % CH == 0) {
    __syncthreads();
    write_y(nch - 1);
  }

#pragma unroll
  for (int a = 0; a < R; ++a) store_row(so + (i0 + a) * HS, S[a], svec);
}

// A single step (the decode step): each thread reads its own rows of r, k,
// w, u and columns of v straight into registers and folds its rows' share
// of rho into its partial y; no shared memory, no barrier.  The state is
// stored before y's sum, so the two overlap.
__global__ void __launch_bounds__(THREADS) wkv_forward(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ y,
    float* s_out, int H, Seq rs, Seq ks, Seq vs, Seq ws, Seq ys, State s0s,
    State sos, bool vec, bool svec) {
  constexpr int R = WIDE_TILE_R, C = WIDE_TILE_C, CB = WIDE_COLS;
  constexpr int G = HS / R, NCB = HS / CB, OWN = G / C;
  static_assert(G * (CB / C) == THREADS, "a block's tiles cover its columns");
  const int tid = threadIdx.x, lane = tid % 32, rg = tid % G, cg = tid / G;
  const int bh = blockIdx.x / NCB, b = bh / H, h = bh % H;
  const int i0 = rg * R, j0 = (blockIdx.x % NCB) * CB + cg * C;

  float S[R][C], rr[R], kk[R], ww[R], uu[R], vv[C], part[C];
  const float* sp = s0 + b * s0s.b + h * s0s.h + j0;
#pragma unroll
  for (int a = 0; a < R; ++a) load_row(S[a], sp + (i0 + a) * HS, svec);
  load_row(rr, r + b * rs.b + h * rs.h + i0, vec);
  load_row(kk, k + b * ks.b + h * ks.h + i0, vec);
  load_row(ww, w + b * ws.b + h * ws.h + i0, vec);
  load_row(vv, v + b * vs.b + h * vs.h + j0, vec);
#pragma unroll
  for (int a = 0; a < R; ++a) uu[a] = u[h * HS + i0 + a];

  float bonus = rr[0] * uu[0] * kk[0];
#pragma unroll
  for (int a = 1; a < R; ++a) bonus = fmaf(rr[a] * uu[a], kk[a], bonus);
#pragma unroll
  for (int x = 0; x < C; ++x) part[x] = vv[x] * bonus;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int x = 0; x < C; ++x) part[x] = fmaf(rr[a], S[a][x], part[x]);
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int x = 0; x < C; ++x) S[a][x] = fmaf(ww[a], S[a][x], kk[a] * vv[x]);
  float* so = s_out + b * sos.b + h * sos.h + j0;
#pragma unroll
  for (int a = 0; a < R; ++a) store_row(so + (i0 + a) * HS, S[a], svec);
  const float sum = fold<C, G / 2>(part, lane);
  if (rg % OWN == 0) y[b * ys.b + h * ys.h + j0 + rg / OWN] = sum;
}

template <int R, int C, int CB>
cudaError_t launch(int B, int T, int H, const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y, float* s_out,
                   const Seq (&seq)[5], const State (&st)[2], bool vec, bool svec,
                   cudaStream_t stream) {
  wkv_forward<R, C, CB><<<B * H * (HS / CB), THREADS, 0, stream>>>(
      r, k, v, w, u, s0, y, s_out, T, H, seq[0], seq[1], seq[2], seq[3], seq[4], st[0], st[1],
      vec, svec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// strides: 19 element strides -- r, k, v, w, y (b, t, h) each, then s0 and
// s_out (b, h).  s_out may be s0 (in place).  groups: blocks a (b, h), 2 or
// 8 (kernels/wkv.py launch_plan), which sets the configuration; T = 1 runs
// the single step, on 2.
int wkv_forward_f32(const void* r, const void* k, const void* v, const void* w,
                    const void* u, const void* s0, void* y, void* s_out, int B,
                    int T, int H, int groups, const long long* st, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (H <= 0 || (long long)B * H * groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Seq seq[5] = {{st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
                      {st[9], st[10], st[11]}, {st[12], st[13], st[14]}};
  const State sta[2] = {{st[15], st[16]}, {st[17], st[18]}};
  bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) && aligned16(y);
  for (int i = 0; i < 15; ++i) vec = vec && st[i] % 4 == 0;
  bool svec = aligned16(s0) && aligned16(s_out);
  for (int i = 15; i < 19; ++i) svec = svec && st[i] % 4 == 0;
  const float *rf = static_cast<const float*>(r), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u), *sf = static_cast<const float*>(s0);
  float *yf = static_cast<float*>(y), *of = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 1) {
    if (groups != HS / WIDE_COLS) return (int)cudaErrorInvalidValue;
    wkv_forward<<<B * H * groups, THREADS, 0, s>>>(rf, kf, vf, wf, uf, sf, yf, of, H, seq[0], seq[1], seq[2],
                                                  seq[3], seq[4], sta[0], sta[1], vec, svec);
    return (int)cudaGetLastError();
  }
  switch (groups) {
    case HS / WIDE_COLS:
      return (int)launch<WIDE_TILE_R, WIDE_TILE_C, WIDE_COLS>(B, T, H, rf, kf, vf, wf, uf, sf, yf, of,
                                                               seq, sta, vec, svec, s);
    case HS / NARROW_COLS:
      return (int)launch<NARROW_TILE_R, NARROW_TILE_C, NARROW_COLS>(B, T, H, rf, kf, vf, wf, uf, sf,
                                                                     yf, of, seq, sta, vec, svec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
