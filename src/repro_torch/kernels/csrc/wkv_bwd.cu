// K7b: the WKV recurrence of RWKV6's time mix, backward.
//
// Not a TPU kernel: the counterpart of the VJP of the `lax.scan` in
// src/repro/models/rwkv6.py::rwkv_time_mix (K7's recurrence, wkv.cu), the
// gradient the training forward takes through K7.  With S_t the state after
// step t (S_{-1} = s0), G_t the gradient of the loss with respect to S_t
// (G_{T-1} = 0: the final state gets no gradient) and dy the gradient of y:
//   G_{t-1}[i,j] = w_t[i] G_t[i,j] + r_t[i] dy_t[j]
//   dr_t[i] = sum_j S_{t-1}[i,j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i,j] v_t[j]      + u[i] r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i,j] k_t[i]      + dy_t[j] rho_t,  rho_t = sum_i r_t[i] u[i] k_t[i]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
// Shapes and strides as K7's; dy (B, T, H, 64) with its last axis
// contiguous; dr, dk, dv, dw are written (B, T, H, 64), and du per (b, h):
// du_part (B, H, 64), which the wrapper sums over b with a torch reduction.
// No float atomics: every output element is written once by the thread that
// owns it, and every sum runs in a fixed order (shuffles by xor mask, then
// the warps in turn), so a call gives the same bytes on every run.
//
// dw needs S_{t-1} and G_t at the same step, which run in opposite
// directions.  The state is never recovered by dividing by w_t (unstable as
// w -> 0: exp(-exp(3)) is 2e-9): it is recomputed from checkpoints at two
// levels.  Two launches a call, each thread holding a 4 x 4 tile:
// 1. wkv_grad_r, forward in time: two blocks of 128 threads a (b, h), each
//    32 rows of S (dr sums over a row: its 16 threads lie in one half-warp
//    and sum by shuffles).  It writes dr, du_part and, every CK = 32 steps,
//    the state before that step into the checkpoint scratch (B H, ceil(T /
//    CK) - 1, 64, 64) float32 that the wrapper allocates (the first segment
//    starts from s0 itself).  Its inputs are staged as K7's: 16 steps a
//    chunk through registers into two shared buffers, v . dy summed on the
//    way, a chunk's sums kept in registers until its steps are done, and dr
//    leaves as K7's y does, a chunk behind, in 16-byte pieces of rows.
// 2. wkv_grad_kvw, backward in time: one block of 256 threads a (b, h), its
//    whole state, G in registers.  For each segment of CK steps, last first
//    (its inputs staged whole by cp.async, the next one's in flight): each
//    thread runs its own tile of S forward from the segment's checkpoint and
//    keeps the state before every SK = 4th step in shared memory (level 2,
//    each thread its own slots); then, sub-chunk by sub-chunk backward,
//    recomputes that sub-chunk's four states into registers and walks them
//    back, summing dk and dw (over a row: 16 threads of a half-warp) and dv
//    (over a column: a shuffle across the warp's two tile rows, then the
//    eight warps' sums through shared memory after the sub-chunk's barrier).
//    A sub-chunk's sums stay in registers until its four steps are done, and
//    dk and dw leave through shared memory in 16-byte pieces of rows.  G's
//    recurrence runs once.  Steps past T in the last segment are padded
//    with w = 1 and r, k, v, dy = 0, which leave S and G as they are.
// No block writes what another reads, so the two launches need nothing but
// their order on the stream.  The scratch at the training shape (B 4, T
// 2,048, H 32) is 128 x 63 checkpoints of 16 KiB: 126 MiB, written once and
// read once (the re-read of a segment's checkpoint finds it in L2), 264 MB
// of traffic, 0.079 ms at 3.35 TB/s.
//
// What bounds it on an H100: operations.  At the training shape it reads r,
// k, v, w, dy and writes dr, dk, dv, dw (604 MB: 0.180 ms at 3.35 TB/s) and
// does 14 flops per state element and step (the recomputed state's 3, G's
// 3, four reads of 2): 1.5e10 flops, 0.224 ms at 67 TFLOP/s of float32.
// The design does more: the state runs three times (pass 1, then twice
// from the two levels of checkpoints), and the sums' shuffles and selects
// and the shared-memory loads of every step are latency the eight warps of
// pass 2's one block an SM (its 213 KiB of shared memory) only partly hide.
// Times are in PERF.md (chip_smoke.py measures them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;            // head size: state rows and columns
constexpr int TILE = 4;           // a thread's tile: TILE x TILE state elements
constexpr int CH = 16;            // pass 1: steps a chunk
constexpr int FWD_THREADS = 128;  // pass 1: threads a block
constexpr int FWD_ROWS = 32;      // pass 1: state rows a block
constexpr int CK = 32;            // steps between checkpoints in device memory
constexpr int SK = 4;             // steps between checkpoints in shared memory
constexpr int BWD_THREADS = 256;  // pass 2: threads a block, one (b, h)
constexpr unsigned FULL = 0xffffffffu;

struct Seq {
  long long b, t, h;
};

struct State {
  long long b, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four floats from global to shared memory: one 16-byte copy where both are
// 16-byte aligned (vec), else four 4-byte copies.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst + e)), "l"(src + e)
                   : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Four consecutive, 16-byte aligned floats into registers.
__device__ __forceinline__ void load4(float (&x)[TILE], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
}

// A tile's row of s0: a vector load where s0 is 16-byte aligned (vec).
__device__ __forceinline__ void load_row(float (&x)[TILE], const float* p, bool vec) {
  if (vec) {
    load4(x, p);
  } else {
#pragma unroll
    for (int e = 0; e < TILE; ++e) x[e] = p[e];
  }
}

// S <- w S + k v over a tile, the step's rows and columns in registers.
__device__ __forceinline__ void advance(float (&S)[TILE][TILE], const float (&kk)[TILE],
                                        const float (&ww)[TILE], const float (&vv)[TILE]) {
#pragma unroll
  for (int a = 0; a < TILE; ++a)
#pragma unroll
    for (int x = 0; x < TILE; ++x) S[a][x] = fmaf(ww[a], S[a][x], kk[a] * vv[x]);
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

// Pass 1: dr, du_part and the checkpoints.  Block (b h, row half); thread
// tid holds the tile at rows 4 (tid / 16) of the half, columns 4 (tid % 16).
__global__ void __launch_bounds__(FWD_THREADS) wkv_grad_r(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    const float* __restrict__ dy, float* __restrict__ dr,
    float* __restrict__ du_part, float* __restrict__ ckpt, int T, int H,
    Seq rs, Seq ks, Seq vs, Seq ws, Seq dys, Seq drs, State s0s, bool vec,
    bool svec) {
  constexpr int NRB = HS / FWD_ROWS;  // blocks a (b, h)
  constexpr int L = HS / TILE;        // threads that share a row
  constexpr int RQ = FWD_ROWS / 4;    // 4-row pieces of the block's rows
  constexpr int CQ = HS / 4;          // 4-column pieces of a row of v or dy
  constexpr int PAIRS = CH * CQ / FWD_THREADS;  // (v, dy) pieces a thread stages a chunk
  static_assert(L * (FWD_ROWS / TILE) == FWD_THREADS, "a block's tiles cover its rows");
  static_assert(CH * RQ == FWD_THREADS && CH * CQ % FWD_THREADS == 0, "a chunk's staging");
  static_assert(CK % CH == 0, "checkpoints fall at chunk starts");
  __shared__ __align__(16) float s_r[2][CH][FWD_ROWS];
  __shared__ __align__(16) float s_k[2][CH][FWD_ROWS];
  __shared__ __align__(16) float s_w[2][CH][FWD_ROWS];
  __shared__ __align__(16) float s_v[2][CH][HS];
  __shared__ __align__(16) float s_dy[2][CH][HS];
  __shared__ __align__(16) float s_dr[2][CH][FWD_ROWS];
  __shared__ float s_vdy[2][CH];

  const int tid = threadIdx.x, lane = tid % 32, cg = tid % L, rg = tid / L;
  const int bh = blockIdx.x / NRB, ib = (blockIdx.x % NRB) * FWD_ROWS;
  const int b = bh / H, h = bh % H;
  const int li0 = rg * TILE, j0 = cg * TILE;  // the tile's first row in the block, first column
  const int own = li0 + cg / (L / TILE);      // the row (in the block) whose dr this thread sums
  const bool writer = cg % (L / TILE) == 0;
  const int nch = (T + CH - 1) / CH, nseg = (T + CK - 1) / CK;

  const float* rb = r + b * rs.b + h * rs.h + ib;
  const float* kb = k + b * ks.b + h * ks.h + ib;
  const float* wb = w + b * ws.b + h * ws.h + ib;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* dyb = dy + b * dys.b + h * dys.h;
  float* drb = dr + b * drs.b + h * drs.h + ib;
  float* ck = ckpt + (long long)bh * (nseg - 1) * HS * HS + (ib + li0) * HS + j0;
  const float u_own = u[h * HS + ib + own];
  float du = 0.f;

  float S[TILE][TILE];
  {
    const float* sp = s0 + b * s0s.b + h * s0s.h + (ib + li0) * HS + j0;
#pragma unroll
    for (int a = 0; a < TILE; ++a) load_row(S[a], sp + a * HS, svec);
  }

  auto ld4 = [&](const float* p) {
    if (vec) return *reinterpret_cast<const float4*>(p);
    return make_float4(p[0], p[1], p[2], p[3]);
  };
  // Chunk ci's inputs into registers: rows 4 (tid % RQ) .. + 3 of step
  // tid / RQ, and columns 4 (tid % CQ) .. + 3 of v and dy at PAIRS steps.
  float4 pr = {}, pk = {}, pw = {}, pv[PAIRS] = {}, pd[PAIRS] = {};
  auto load = [&](int ci) {
    const int t0 = ci * CH, n = min(CH, T - t0);
    {
      const int c = tid / RQ, i = (tid % RQ) * 4;
      if (c < n) {
        const long long t = t0 + c;
        pr = ld4(rb + t * rs.t + i), pk = ld4(kb + t * ks.t + i), pw = ld4(wb + t * ws.t + i);
      }
    }
#pragma unroll
    for (int s = 0; s < PAIRS; ++s) {
      const int c = (tid + s * FWD_THREADS) / CQ, j = (tid % CQ) * 4;
      if (c < n) {
        const long long t = t0 + c;
        pv[s] = ld4(vb + t * vs.t + j), pd[s] = ld4(dyb + t * dys.t + j);
      }
    }
  };
  // ... then into buffer ci & 1, with each step's v . dy (16 lanes a step).
  auto commit = [&](int ci) {
    const int n = min(CH, T - ci * CH), p = ci & 1;
    {
      const int c = tid / RQ, i = (tid % RQ) * 4;
      if (c < n) {
        *reinterpret_cast<float4*>(&s_r[p][c][i]) = pr;
        *reinterpret_cast<float4*>(&s_k[p][c][i]) = pk;
        *reinterpret_cast<float4*>(&s_w[p][c][i]) = pw;
      }
    }
#pragma unroll
    for (int s = 0; s < PAIRS; ++s) {
      const int c = (tid + s * FWD_THREADS) / CQ, j = (tid % CQ) * 4;
      float q = pv[s].x * pd[s].x;
      q = fmaf(pv[s].y, pd[s].y, q);
      q = fmaf(pv[s].z, pd[s].z, q);
      q = fmaf(pv[s].w, pd[s].w, q);
#pragma unroll
      for (int m = CQ / 2; m; m /= 2) q += __shfl_xor_sync(FULL, q, m);
      if (c < n) {
        *reinterpret_cast<float4*>(&s_v[p][c][j]) = pv[s];
        *reinterpret_cast<float4*>(&s_dy[p][c][j]) = pd[s];
        if (j == 0) s_vdy[p][c] = q;
      }
    }
  };
  // One step from buffer p: this thread's row sum of S dy, then the update.
  auto step = [&](int p, int c) {
    float kk[TILE], ww[TILE], vv[TILE], dd[TILE], part[TILE];
    load4(kk, s_k[p][c] + li0);
    load4(ww, s_w[p][c] + li0);
    load4(vv, s_v[p][c] + j0);
    load4(dd, s_dy[p][c] + j0);
#pragma unroll
    for (int a = 0; a < TILE; ++a) {
      part[a] = S[a][0] * dd[0];
#pragma unroll
      for (int x = 1; x < TILE; ++x) part[a] = fmaf(S[a][x], dd[x], part[a]);
    }
    advance(S, kk, ww, vv);
    return fold<TILE, L / 2>(part, lane);
  };
  // dr_t of the row (into s_dr, or straight to device memory for a chunk
  // shorter than CH) and the row's du.
  auto finish = [&](int p, int c, long long t, float sum, bool whole) {
    const float kv = s_k[p][c][own] * s_vdy[p][c];
    const float d = fmaf(u_own, kv, sum);
    if (writer && whole) s_dr[p][c][own] = d;
    if (writer && !whole) drb[t * drs.t + own] = d;
    du = fmaf(s_r[p][c][own], kv, du);
  };
  // dr of whole chunk ci, from s_dr[ci & 1], as 16-byte pieces of rows.
  auto write_dr = [&](int ci) {
    constexpr int U = FWD_ROWS / 4;
    const int t0 = ci * CH, p = ci & 1;
    for (int q = tid; q < CH * U; q += FWD_THREADS) {
      const int c = q / U, i = (q % U) * 4;
      float x[TILE];
      load4(x, s_dr[p][c] + i);
      float* dst = drb + (t0 + c) * drs.t + i;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < TILE; ++e) dst[e] = x[e];
      }
    }
  };
  auto compute = [&](int ci) {
    const int t0 = ci * CH, n = min(CH, T - t0), p = ci & 1;
    if (t0 % CK == 0 && t0 > 0) {  // the state before step t0
      float* dst = ck + (long long)(t0 / CK - 1) * HS * HS;
#pragma unroll
      for (int a = 0; a < TILE; ++a)
        *reinterpret_cast<float4*>(dst + a * HS) = make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
    }
    if (n == CH) {
      float sums[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) sums[c] = step(p, c);
#pragma unroll
      for (int c = 0; c < CH; ++c) finish(p, c, t0 + c, sums[c], true);
    } else {
      for (int c = 0; c < n; ++c) finish(p, c, t0 + c, step(p, c), false);
    }
  };

  load(0);
  commit(0);
  if (nch > 1) load(1);
  __syncthreads();
  for (int ci = 0; ci < nch; ++ci) {  // K7's two buffers, and dr as K7's y
    compute(ci);
    if (ci > 0) write_dr(ci - 1);
    if (ci + 1 < nch) {
      commit(ci + 1);
      if (ci + 2 < nch) load(ci + 2);
      __syncthreads();
    }
  }
  if (T % CH == 0) {
    __syncthreads();
    write_dr(nch - 1);
  }
  if (writer) du_part[(long long)bh * HS + ib + own] = du;
}

// Pass 2's shared memory, in floats: a segment's inputs twice (being used,
// in flight), the level-2 checkpoints (each thread its own float4 slots),
// the warps' dv sums for two sub-chunks, rho and v . dy of two segments, u,
// and dk and dw of two sub-chunks.
enum { IN_R, IN_K, IN_W, IN_V, IN_DY, IN_STREAMS };
constexpr int NSUB = CK / SK;  // level-2 checkpoints a segment (the first is level 1's)
constexpr int WARPS = BWD_THREADS / 32;
constexpr int OFF_SLOT = 2 * IN_STREAMS * CK * HS;
constexpr int OFF_DVP = OFF_SLOT + (NSUB - 1) * TILE * BWD_THREADS * 4;
constexpr int OFF_SCAL = OFF_DVP + 2 * SK * WARPS * HS;
constexpr int OFF_U = OFF_SCAL + 2 * 2 * CK;
constexpr int OFF_DKW = OFF_U + HS;
constexpr int BWD_SMEM = (OFF_DKW + 2 * SK * 2 * HS) * (int)sizeof(float);

// Pass 2: dk, dv, dw.  Block b h; thread tid holds the tile at rows
// 4 (tid / 16), columns 4 (tid % 16): warp w the tile rows 2 w, 2 w + 1.
__global__ void __launch_bounds__(BWD_THREADS, 1) wkv_grad_kvw(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    const float* __restrict__ dy, const float* __restrict__ ckpt,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
    int T, int H, Seq rs, Seq ks, Seq vs, Seq ws, Seq dys, Seq dks, Seq dvs,
    Seq dws, State s0s, bool svec, bool vec) {
  constexpr int L = HS / TILE;  // threads that share a row: a half-warp
  static_assert(L * L == BWD_THREADS, "one tile a thread covers the state");
  static_assert(SK * HS == BWD_THREADS, "a sub-chunk's dv: one thread a step and column");
  static_assert(2 * CK * 4 == BWD_THREADS, "rho and v . dy: four threads a step each");
  static_assert(CK % SK == 0, "segments hold whole sub-chunks");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  auto in = reinterpret_cast<float(*)[IN_STREAMS][CK][HS]>(smem);               // [2][stream][step][64]
  auto slot = reinterpret_cast<float4(*)[TILE][BWD_THREADS]>(smem + OFF_SLOT);  // [NSUB - 1][row][thread]
  auto dvp = reinterpret_cast<float(*)[SK][WARPS][HS]>(smem + OFF_DVP);         // [2][step][warp][64]
  auto scal = reinterpret_cast<float(*)[2][CK]>(smem + OFF_SCAL);               // [2][rho, v . dy][step]
  float* su = smem + OFF_U;
  auto dkw = reinterpret_cast<float(*)[SK][2][HS]>(smem + OFF_DKW);             // [2][step][dk, dw][64]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, cg = tid % L, rg = tid / L;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i0 = rg * TILE, j0 = cg * TILE;
  const int nseg = (T + CK - 1) / CK;
  // dk and dw sum over a row: this thread ends with value cg / 2 of
  // {dk rows 0-3, dw rows 0-3} of its tile; the even lanes keep it.
  const int qty = cg / (L / 2), i_own = i0 + (cg / 2) % TILE;
  const bool writer = cg % 2 == 0;
  const float u_out = qty == 0 ? u[h * HS + i_own] : 0.f;  // dw has no bonus
  float* const dkb = dk + b * dks.b + h * dks.h;
  float* const dwb = dw + b * dws.b + h * dws.h;

  const float* rb = r + b * rs.b + h * rs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* wb = w + b * ws.b + h * ws.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* dyb = dy + b * dys.b + h * dys.h;
  float* dvb = dv + b * dvs.b + h * dvs.h;
  const float* s0p = s0 + b * s0s.b + h * s0s.h + i0 * HS + j0;
  const float* ckb = ckpt + (long long)bh * (nseg - 1) * HS * HS + i0 * HS + j0;
  if (tid < HS) su[tid] = u[h * HS + tid];

  // Segment s's steps into in[s & 1]; the last segment padded to whole sub-chunks.
  auto stage = [&](int s) {
    constexpr int RU = HS / 4, U = IN_STREAMS * RU;
    const int t0 = s * CK, n = min(CK, T - t0), buf = s & 1;
    for (int q = tid; q < n * U; q += BWD_THREADS) {
      const int c = q / U, e = q % U, a = e / RU, i = (e % RU) * 4;
      const long long t = t0 + c;
      const float* src = a == IN_R ? rb + t * rs.t : a == IN_K ? kb + t * ks.t
                       : a == IN_W ? wb + t * ws.t : a == IN_V ? vb + t * vs.t : dyb + t * dys.t;
      copy4(&in[buf][a][c][i], src + i, vec);
    }
    cp_async_commit();
    const int padded = (n + SK - 1) / SK * SK;
    for (int q = tid; q < (padded - n) * IN_STREAMS * HS; q += BWD_THREADS) {
      const int c = n + q / (IN_STREAMS * HS), a = q / HS % IN_STREAMS;
      in[buf][a][c][q % HS] = a == IN_W ? 1.f : 0.f;
    }
  };
  // rho and v . dy of segment s's steps into scal[s & 1]: four neighbouring
  // lanes a dot, warps 0-3 rho, 4-7 v . dy.
  auto sum_scalars = [&](int s) {
    const int buf = s & 1, d = tid / 4, qty_ = d / CK, c = d % CK, e0 = (tid % 4) * (HS / 4);
    const float* x = in[buf][qty_ == 0 ? IN_R : IN_V][c] + e0;
    const float* z = in[buf][qty_ == 0 ? IN_K : IN_DY][c] + e0;
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < HS / 4; ++e) p = fmaf(qty_ == 0 ? x[e] * su[e0 + e] : x[e], z[e], p);
    p += __shfl_xor_sync(FULL, p, 1);
    p += __shfl_xor_sync(FULL, p, 2);
    if (tid % 4 == 0) scal[buf][qty_][c] = p;
  };
  // The tile of the state before segment s: s0, or its checkpoint.
  auto load_level1 = [&](float (&S)[TILE][TILE], int s) {
#pragma unroll
    for (int a = 0; a < TILE; ++a) {
      if (s == 0) load_row(S[a], s0p + a * HS, svec);
      else load4(S[a], ckb + (long long)(s - 1) * HS * HS + a * HS);
    }
  };
  auto step_forward = [&](float (&S)[TILE][TILE], int buf, int c) {
    float kk[TILE], ww[TILE], vv[TILE];
    load4(kk, in[buf][IN_K][c] + i0);
    load4(ww, in[buf][IN_W][c] + i0);
    load4(vv, in[buf][IN_V][c] + j0);
    advance(S, kk, ww, vv);
  };

  float G[TILE][TILE];
#pragma unroll
  for (int a = 0; a < TILE; ++a)
#pragma unroll
    for (int x = 0; x < TILE; ++x) G[a][x] = 0.f;
  int par = 0;  // which half of dvp the sub-chunk fills

  stage(nseg - 1);
  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * CK, nsub = (min(CK, T - t0) + SK - 1) / SK, buf = s & 1;
    cp_async_wait_all();
    __syncthreads();  // segment s landed; every read of in[(s + 1) & 1] is done
    sum_scalars(s);
    __syncthreads();
    if (s > 0) stage(s - 1);

    {  // level 2: the state before each sub-chunk, each thread its own slots
      float S[TILE][TILE];
      load_level1(S, s);
      for (int m = 1; m < nsub; ++m) {
#pragma unroll
        for (int q = 0; q < SK; ++q) step_forward(S, buf, (m - 1) * SK + q);
#pragma unroll
        for (int a = 0; a < TILE; ++a) slot[m - 1][a][tid] = make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
      }
    }

    for (int m = nsub - 1; m >= 0; --m) {
      float St[SK][TILE][TILE];  // St[q]: the state before step m SK + q
      if (m == 0) {
        load_level1(St[0], s);
      } else {
#pragma unroll
        for (int a = 0; a < TILE; ++a) {
          const float4 q4 = slot[m - 1][a][tid];
          St[0][a][0] = q4.x, St[0][a][1] = q4.y, St[0][a][2] = q4.z, St[0][a][3] = q4.w;
        }
      }
#pragma unroll
      for (int q = 1; q < SK; ++q) {
#pragma unroll
        for (int a = 0; a < TILE; ++a)
#pragma unroll
          for (int x = 0; x < TILE; ++x) St[q][a][x] = St[q - 1][a][x];
        step_forward(St[q], buf, m * SK + q - 1);
      }
      // The sub-chunk's steps, last first; each step's sums stay in
      // registers until the four are done, so the steps overlap.
      float outs[SK], colsums[SK][TILE / 2];
      const bool hi = lane & 16;  // the warp's second row of tiles
#pragma unroll
      for (int q = SK - 1; q >= 0; --q) {
        const int c = m * SK + q;
        float rr[TILE], kk[TILE], ww[TILE], vv[TILE], dd[TILE], rows[2 * TILE], cols[TILE];
        load4(rr, in[buf][IN_R][c] + i0);
        load4(kk, in[buf][IN_K][c] + i0);
        load4(ww, in[buf][IN_W][c] + i0);
        load4(vv, in[buf][IN_V][c] + j0);
        load4(dd, in[buf][IN_DY][c] + j0);
#pragma unroll
        for (int a = 0; a < TILE; ++a) {
          rows[a] = G[a][0] * vv[0];               // dk
          rows[TILE + a] = G[a][0] * St[q][a][0];  // dw
#pragma unroll
          for (int x = 1; x < TILE; ++x) {
            rows[a] = fmaf(G[a][x], vv[x], rows[a]);
            rows[TILE + a] = fmaf(G[a][x], St[q][a][x], rows[TILE + a]);
          }
        }
#pragma unroll
        for (int x = 0; x < TILE; ++x) {
          cols[x] = G[0][x] * kk[0];  // dv
#pragma unroll
          for (int a = 1; a < TILE; ++a) cols[x] = fmaf(G[a][x], kk[a], cols[x]);
        }
#pragma unroll
        for (int a = 0; a < TILE; ++a)
#pragma unroll
          for (int x = 0; x < TILE; ++x) G[a][x] = fmaf(ww[a], G[a][x], rr[a] * dd[x]);

        outs[q] = fold<2 * TILE, L / 2>(rows, lane);
        // dv: the warp's two tile rows (lanes 16 apart), then the warps below.
#pragma unroll
        for (int x = 0; x < TILE / 2; ++x) {
          const float send = hi ? cols[x] : cols[x + TILE / 2];
          const float keep = hi ? cols[x + TILE / 2] : cols[x];
          colsums[q][x] = keep + __shfl_xor_sync(FULL, send, 16);
        }
      }
#pragma unroll
      for (int q = 0; q < SK; ++q) {
        const int c = m * SK + q;
        const long long t = t0 + c;
        if (writer) dkw[par][q][qty][i_own] = fmaf(u_out * in[buf][IN_R][c][i_own], scal[buf][1][c], outs[q]);
        *reinterpret_cast<float2*>(&dvp[par][q][warp][j0 + (hi ? TILE / 2 : 0)]) =
            make_float2(colsums[q][0], colsums[q][1]);
      }
      __syncthreads();  // dvp[par] holds every warp's sums; the other half is free
      {
        const int q = tid / HS, j = tid % HS, c = m * SK + q;
        float acc = dvp[par][q][0][j];
#pragma unroll
        for (int x = 1; x < WARPS; ++x) acc += dvp[par][q][x][j];
        if (t0 + c < T) dvb[(t0 + c) * dvs.t + j] = fmaf(in[buf][IN_DY][c][j], scal[buf][0][c], acc);
      }
      if (tid < SK * 2 * HS / 4) {  // dk and dw of the sub-chunk, 16 bytes a thread
        const int q = tid / (2 * HS / 4), o = tid / (HS / 4) % 2, i = tid % (HS / 4) * 4;
        const long long t = t0 + m * SK + q;
        float x[TILE];
        load4(x, &dkw[par][q][o][i]);
        float* dst = (o == 0 ? dkb + t * dks.t : dwb + t * dws.t) + i;
        if (t < T && vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
        } else if (t < T) {
#pragma unroll
          for (int e = 0; e < TILE; ++e) dst[e] = x[e];
        }
      }
      par ^= 1;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// strides: 29 element strides -- r, k, v, w, dy, dr, dk, dv, dw (b, t, h)
// each, then s0 (b, h).  du_part is (B, H, 64) contiguous; ckpt holds
// B H (ceil(T / CK) - 1) 64 x 64 floats, 16-byte aligned.
int wkv_backward_f32(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0,
                     const void* dy, void* dr, void* dk, void* dv, void* dw,
                     void* du_part, void* ckpt, int B, int T, int H,
                     const long long* st, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (H <= 0 || (long long)B * H * (HS / FWD_ROWS) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Seq rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      dys{st[12], st[13], st[14]}, drs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]},
      dws{st[24], st[25], st[26]};
  const State s0s{st[27], st[28]};
  // 16-byte accesses where every row of the inputs and the outputs allows
  // them (the wrapper's outputs always do), else one float at a time.
  bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) && aligned16(dy) &&
             aligned16(dr) && aligned16(dk) && aligned16(dv) && aligned16(dw);
  for (int i = 0; i < 27; ++i) vec = vec && st[i] % 4 == 0;
  const bool svec = aligned16(s0) && st[27] % 4 == 0 && st[28] % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *rf = static_cast<const float*>(r), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u), *s0f = static_cast<const float*>(s0),
              *dyf = static_cast<const float*>(dy);
  float* ck = static_cast<float*>(ckpt);

  wkv_grad_r<<<B * H * (HS / FWD_ROWS), FWD_THREADS, 0, s>>>(
      rf, kf, vf, wf, uf, s0f, dyf, static_cast<float*>(dr), static_cast<float*>(du_part), ck, T, H,
      rs, ks, vs, ws, dys, drs, s0s, vec, svec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(wkv_grad_kvw, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  wkv_grad_kvw<<<B * H, BWD_THREADS, BWD_SMEM, s>>>(
      rf, kf, vf, wf, uf, s0f, dyf, ck, static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dw), T, H, rs, ks, vs, ws, dys, dks, dvs, dws, s0s, svec, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
