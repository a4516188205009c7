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
// Design: one block of 64 threads per (b, h); thread j holds column j of S
// in 64 registers for the whole sequence, so the state never goes through
// memory between steps.  The steps are staged CH at a time in shared memory
// (r, k, w and u packed as one float4 per key index, read as a broadcast;
// each row a coalesced 256-byte load), one pair of barriers a chunk; a step
// is then 64 x (one 16-byte shared read, two multiplies, three FMAs) per
// thread with no barrier.  y_t[j] is a coalesced 256-byte row per step.
//
// In place: the final state may be written over s0 (the decode step passes
// its layer's slice of the cache as both).  Each thread reads its whole
// column of s0 before the first step and writes the same column after the
// last, and no other block touches this (b, h), so the block reads its whole
// state before writing any of it.
//
// What bounds it on an H100: bytes.  At the training shape (B 4, T 2,048,
// H 32) it reads r, k, v, w (268 MB) and writes y (67 MB): 0.100 ms at
// 3.35 TB/s, against 5 flops per state element and step (the read's FMA,
// the update's multiply and FMA): 5.4e9 flops, 0.080 ms at 67 TFLOP/s of
// float32.  The design does not reach that: one block per (b, h) gives 128
// blocks of two warps at the training shape and 32 at a serving prefill
// (B 1), and each step is a chain of dependent shared reads and FMAs.
// Splitting T (a chunked, parallel form) is the speed work for later.
// Times are in PERF.md (chip_smoke.py measures them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;  // head size: threads a block, state rows and columns
constexpr int CH = 16;  // steps staged in shared memory at a time

// Element strides of a (B, T, H, HS) tensor whose last axis is contiguous.
struct Seq {
  long long b, t, h;
};

// Element strides of a (B, H, HS, HS) state whose inner (HS, HS) is contiguous.
struct State {
  long long b, h;
};

__global__ void __launch_bounds__(HS) wkv_forward(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ y,
    float* s_out, int T, int H, Seq rs, Seq ks, Seq vs, Seq ws, Seq ys,
    State s0s, State sos) {
  __shared__ float4 rkwu[CH][HS];  // (r, k, w, u) of step c, key index i
  __shared__ float sv[CH][HS];     // v of step c (thread j reads its own)
  const int b = blockIdx.x / H, h = blockIdx.x % H, j = threadIdx.x;

  float S[HS];
  const float* sp = s0 + b * s0s.b + h * s0s.h;
#pragma unroll
  for (int i = 0; i < HS; ++i) S[i] = sp[i * HS + j];
  const float uj = u[h * HS + j];

  const float* rb = r + b * rs.b + h * rs.h + j;
  const float* kb = k + b * ks.b + h * ks.h + j;
  const float* vb = v + b * vs.b + h * vs.h + j;
  const float* wb = w + b * ws.b + h * ws.h + j;
  float* yb = y + b * ys.b + h * ys.h + j;

  for (int t0 = 0; t0 < T; t0 += CH) {
    const int n = min(CH, T - t0);
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c < n) {
        const long long t = t0 + c;
        rkwu[c][j] = make_float4(rb[t * rs.t], kb[t * ks.t], wb[t * ws.t], uj);
        sv[c][j] = vb[t * vs.t];
      }
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const float4 q = rkwu[c][i];
        const float kv = q.y * vj;
        acc = fmaf(q.x, fmaf(q.w, kv, S[i]), acc);
        S[i] = fmaf(q.z, S[i], kv);
      }
      yb[(long long)(t0 + c) * ys.t] = acc;
    }
  }

  float* so = s_out + b * sos.b + h * sos.h;
#pragma unroll
  for (int i = 0; i < HS; ++i) so[i * HS + j] = S[i];
}

}  // namespace

extern "C" {

// strides: 19 element strides -- r, k, v, w, y (b, t, h) each, then s0 and
// s_out (b, h).  s_out may be s0 (in place).
int wkv_forward_f32(const void* r, const void* k, const void* v, const void* w,
                    const void* u, const void* s0, void* y, void* s_out, int B,
                    int T, int H, const long long* st, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (H <= 0 || (long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Seq rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  const State s0s{st[15], st[16]}, sos{st[17], st[18]};
  wkv_forward<<<B * H, HS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), T, H, rs, ks, vs,
      ws, ys, s0s, sos);
  return (int)cudaGetLastError();
}

}  // extern "C"
