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
//   dv_t[j] = sum_i G_t[i,j] k_t[i]      + dy_t[j] sum_i r_t[i] u[i] k_t[i]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
// Shapes and strides as K7's; dy (B, T, H, 64) with its last axis
// contiguous; dr, dk, dv, dw are written (B, T, H, 64), and du per (b, h):
// du_part (B, H, 64), which the wrapper sums over b with a torch reduction.
// No float atomics: every output element is written once by the thread that
// owns it, so a call gives the same bytes on every run.
//
// dw needs S_{t-1} and G_t at the same step, which run in opposite
// directions.  The state is never recovered by dividing by w_t (unstable as
// w -> 0: exp(-exp(3)) is 2e-9): it is recomputed.  Three launches a call:
// 1. wkv_grad_r, forward in time: thread i holds row i of S, writes dr and
//    du_part and, every CK steps, the state before that step into a
//    checkpoint scratch (B H, ceil(T / CK), 64, 64) float32 the wrapper
//    allocates (transposed, [j][i], so that a warp writes 128 contiguous
//    bytes).  At the training shape (B 4, T 2,048, H 32) that is 512 MiB.
// 2. wkv_grad_kw, backward in time: thread i holds row i of G.  For each
//    chunk of CK steps, last first, it recomputes the chunk's CK states
//    from its checkpoint into shared memory (CK x 64 x 64 floats, 128 KB,
//    laid out [c][j][i]: each thread reads and writes only its own row, at
//    consecutive addresses across the warp), then walks the chunk backwards
//    writing dk and dw.
// 3. wkv_grad_v, backward in time: thread j holds column j of G (dv sums
//    over the key index i, the other axis) and writes dv.
// Rows (passes 1, 2) and columns (pass 3) of the state are independent, so
// each pass carries its part in registers with no exchange between threads;
// inputs are staged as in K7, a chunk at a time, each row a coalesced load.
//
// What bounds it on an H100: operations.  At the training shape it reads r,
// k, v, w, dy and writes dr, dk, dv, dw (604 MB: 0.180 ms at 3.35 TB/s) and
// does 14 flops per state element and step (the recomputed state's 3, G's
// 3, four reads of 2): 1.5e10 flops, 0.224 ms at 67 TFLOP/s of float32.  The
// three passes run the recurrence three times, pass 2 at one block an SM
// (its 128 KB of shared memory), and the checkpoints add 1 GB of traffic.
// Times are in PERF.md (chip_smoke.py measures them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;  // head size: threads a block, state rows and columns
constexpr int CH = 16;  // steps staged in shared memory at a time (passes 1, 3)
constexpr int CK = 8;   // steps between checkpoints, and pass 2's chunk

struct Seq {
  long long b, t, h;
};

struct State {
  long long b, h;
};

// Pass 1: dr, du_part and the checkpoints.  Thread i holds row i of S.
__global__ void __launch_bounds__(HS) wkv_grad_r(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    const float* __restrict__ dy, float* __restrict__ dr,
    float* __restrict__ du_part, float* __restrict__ ckpt, int T, int H,
    Seq rs, Seq ks, Seq vs, Seq ws, Seq dys, Seq drs, State s0s) {
  __shared__ float2 vdy[CH][HS];  // (v, dy) of step c, value index j
  __shared__ float4 own[CH][HS];  // (r, k, w, -) of step c, thread i's own
  __shared__ float dot[CH];       // v_t . dy_t
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  const int nck = (T + CK - 1) / CK;

  float S[HS];
  const float* sp = s0 + b * s0s.b + h * s0s.h + i * HS;
#pragma unroll
  for (int j = 0; j < HS; ++j) S[j] = sp[j];
  const float ui = u[h * HS + i];
  float du = 0.f;
  float* ck = ckpt + (long long)bh * nck * HS * HS + i;

  const float* rb = r + b * rs.b + h * rs.h + i;
  const float* kb = k + b * ks.b + h * ks.h + i;
  const float* vb = v + b * vs.b + h * vs.h + i;
  const float* wb = w + b * ws.b + h * ws.h + i;
  const float* dyb = dy + b * dys.b + h * dys.h + i;
  float* drb = dr + b * drs.b + h * drs.h + i;

  for (int t0 = 0; t0 < T; t0 += CH) {
    const int n = min(CH, T - t0);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c < n) {
        const long long t = t0 + c;
        vdy[c][i] = make_float2(vb[t * vs.t], dyb[t * dys.t]);
        own[c][i] = make_float4(rb[t * rs.t], kb[t * ks.t], wb[t * ws.t], 0.f);
      }
    }
    __syncthreads();
    if (i < n) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < HS; ++j) d = fmaf(vdy[i][j].x, vdy[i][j].y, d);
      dot[i] = d;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const int t = t0 + c;
      if (t % CK == 0) {
        float* dst = ck + (long long)(t / CK) * HS * HS;
#pragma unroll
        for (int j = 0; j < HS; ++j) dst[j * HS] = S[j];
      }
      const float4 q = own[c][i];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < HS; ++j) {
        const float2 p = vdy[c][j];
        acc = fmaf(S[j], p.y, acc);
        S[j] = fmaf(q.z, S[j], q.y * p.x);
      }
      const float kd = q.y * dot[c];
      drb[(long long)t * drs.t] = fmaf(ui, kd, acc);
      du = fmaf(q.x, kd, du);
    }
  }
  du_part[(long long)bh * HS + i] = du;
}

// Pass 2: dk and dw.  Thread i holds row i of G; the chunk's states are
// recomputed from its checkpoint into shared memory.
__global__ void __launch_bounds__(HS) wkv_grad_kw(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ dy,
    const float* __restrict__ ckpt, float* __restrict__ dk,
    float* __restrict__ dw, int T, int H, Seq rs, Seq ks, Seq vs, Seq ws,
    Seq dys, Seq dks, Seq dws) {
  extern __shared__ float states[];  // [CK][HS j][HS i]: S_{t-1} of step c
  __shared__ float2 vdy[CK][HS];
  __shared__ float4 own[CK][HS];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  const int nck = (T + CK - 1) / CK;
  const float ui = u[h * HS + i];
  const float* ck = ckpt + (long long)bh * nck * HS * HS + i;

  const float* rb = r + b * rs.b + h * rs.h + i;
  const float* kb = k + b * ks.b + h * ks.h + i;
  const float* vb = v + b * vs.b + h * vs.h + i;
  const float* wb = w + b * ws.b + h * ws.h + i;
  const float* dyb = dy + b * dys.b + h * dys.h + i;
  float* dkb = dk + b * dks.b + h * dks.h + i;
  float* dwb = dw + b * dws.b + h * dws.h + i;

  float G[HS];
#pragma unroll
  for (int j = 0; j < HS; ++j) G[j] = 0.f;

  for (int cix = nck - 1; cix >= 0; --cix) {
    const int t0 = cix * CK, n = min(CK, T - t0);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      if (c < n) {
        const long long t = t0 + c;
        vdy[c][i] = make_float2(vb[t * vs.t], dyb[t * dys.t]);
        own[c][i] = make_float4(rb[t * rs.t], kb[t * ks.t], wb[t * ws.t], 0.f);
      }
    }
    __syncthreads();
    {
      float S[HS];
      const float* src = ck + (long long)cix * HS * HS;
#pragma unroll
      for (int j = 0; j < HS; ++j) S[j] = src[j * HS];
      for (int c = 0; c < n; ++c) {
        const float4 q = own[c][i];
        float* dst = states + c * HS * HS + i;
#pragma unroll
        for (int j = 0; j < HS; ++j) {
          dst[j * HS] = S[j];
          S[j] = fmaf(q.z, S[j], q.y * vdy[c][j].x);
        }
      }
    }
    for (int c = n - 1; c >= 0; --c) {
      const float4 q = own[c][i];
      const float* st = states + c * HS * HS + i;
      float gk = 0.f, gw = 0.f, d = 0.f;
#pragma unroll
      for (int j = 0; j < HS; ++j) {
        const float2 p = vdy[c][j];
        const float g = G[j];
        gk = fmaf(g, p.x, gk);
        gw = fmaf(g, st[j * HS], gw);
        d = fmaf(p.x, p.y, d);
        G[j] = fmaf(q.z, g, q.x * p.y);
      }
      const long long t = t0 + c;
      dkb[t * dks.t] = fmaf(ui * q.x, d, gk);
      dwb[t * dws.t] = gw;
    }
  }
}

// Pass 3: dv.  Thread j holds column j of G.
__global__ void __launch_bounds__(HS) wkv_grad_v(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ dy, float* __restrict__ dv, int T, int H,
    Seq rs, Seq ks, Seq ws, Seq dys, Seq dvs) {
  __shared__ float4 rkwu[CH][HS];  // (r, k, w, u) of step c, key index i
  __shared__ float sdy[CH][HS];    // dy of step c (thread j reads its own)
  const int b = blockIdx.x / H, h = blockIdx.x % H, j = threadIdx.x;
  const float uj = u[h * HS + j];

  const float* rb = r + b * rs.b + h * rs.h + j;
  const float* kb = k + b * ks.b + h * ks.h + j;
  const float* wb = w + b * ws.b + h * ws.h + j;
  const float* dyb = dy + b * dys.b + h * dys.h + j;
  float* dvb = dv + b * dvs.b + h * dvs.h + j;

  float G[HS];
#pragma unroll
  for (int i = 0; i < HS; ++i) G[i] = 0.f;

  const int nch = (T + CH - 1) / CH;
  for (int cix = nch - 1; cix >= 0; --cix) {
    const int t0 = cix * CH, n = min(CH, T - t0);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c < n) {
        const long long t = t0 + c;
        rkwu[c][j] = make_float4(rb[t * rs.t], kb[t * ks.t], wb[t * ws.t], uj);
        sdy[c][j] = dyb[t * dys.t];
      }
    }
    __syncthreads();
    for (int c = n - 1; c >= 0; --c) {
      const float dyj = sdy[c][j];
      float gv = 0.f, ruk = 0.f;
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const float4 q = rkwu[c][i];
        const float g = G[i];
        gv = fmaf(g, q.y, gv);
        ruk = fmaf(q.x * q.w, q.y, ruk);
        G[i] = fmaf(q.z, g, q.x * dyj);
      }
      dvb[(long long)(t0 + c) * dvs.t] = fmaf(dyj, ruk, gv);
    }
  }
}

}  // namespace

extern "C" {

// strides: 29 element strides -- r, k, v, w, dy, dr, dk, dv, dw (b, t, h)
// each, then s0 (b, h).  du_part is (B, H, 64)
// contiguous; ckpt holds B * H * ceil(T / CK) * 64 * 64 floats.
int wkv_backward_f32(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0,
                     const void* dy, void* dr, void* dk, void* dv, void* dw,
                     void* du_part, void* ckpt, int B, int T, int H,
                     const long long* st, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (H <= 0 || (long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Seq rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      dys{st[12], st[13], st[14]}, drs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]},
      dws{st[24], st[25], st[26]};
  const State s0s{st[27], st[28]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *rf = static_cast<const float*>(r), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u), *dyf = static_cast<const float*>(dy);
  float* ck = static_cast<float*>(ckpt);

  wkv_grad_r<<<B * H, HS, 0, s>>>(rf, kf, vf, wf, uf, static_cast<const float*>(s0), dyf,
                                  static_cast<float*>(dr), static_cast<float*>(du_part), ck,
                                  T, H, rs, ks, vs, ws, dys, drs, s0s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = CK * HS * HS * (int)sizeof(float);
  err = cudaFuncSetAttribute(wkv_grad_kw, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wkv_grad_kw<<<B * H, HS, smem, s>>>(rf, kf, vf, wf, uf, dyf, ck, static_cast<float*>(dk),
                                      static_cast<float*>(dw), T, H, rs, ks, vs, ws, dys, dks,
                                      dws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  wkv_grad_v<<<B * H, HS, 0, s>>>(rf, kf, wf, uf, dyf, static_cast<float*>(dv), T, H, rs, ks,
                                  ws, dys, dvs);
  return (int)cudaGetLastError();
}

}  // extern "C"
