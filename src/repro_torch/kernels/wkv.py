"""K7 and K7b: RWKV6's WKV recurrence on the card, forward and backward, and
their plain torch versions.

Not TPU kernels: the reference leaves the recurrence in plain ``jnp``, the
``step`` of the ``lax.scan`` in :func:`repro.models.rwkv6.rwkv_time_mix`
(K7) and that scan's VJP (K7b).  For r, k, v, w ``(B, T, H, N)`` float32, the
bonus ``u`` ``(H, N)`` and an initial state ``s0`` ``(B, H, N, N)``, each
(b, h) carries its state ``S`` (key index i, value index j) through T steps::

    y_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
    S[i, j] <- w_t[i] S[i, j] + k_t[i] v_t[j]

:func:`wkv` returns ``(y (B, T, H, N), the final state (B, H, N, N))``; with
``in_place=True`` the final state is written over ``s0`` (the decode step
passes its layer's slice of the cache), which the kernel allows: each block
reads its whole state before writing any of it.  :func:`wkv_bwd` returns
``(dr, dk, dv, dw, du)`` from the same inputs and ``dy``; the final state
gets no gradient, nor does ``s0``.

The kernels are ``csrc/wkv.cu`` (K7, one launch) and ``csrc/wkv_bwd.cu`` (K7b,
:data:`KERNELS_PER_CALL` launches: dr and the state checkpoints forward in
time, dk and dw backward from the checkpoints, dv backward; ``du`` summed over
the batch from per-(b, h) partials by a torch reduction, no float atomics).
The head size is 64 (:data:`HEAD_SIZES`); r, k, v, w and dy need their last
axis contiguous and the states their inner (N, N) contiguous, any other
strides: the wrappers raise on anything else and never copy.
:func:`wkv_plain` is the reference's step in a loop over T;
:func:`wkv_bwd_plain` is the closed-form backward in two loops (every state
kept).  The wrappers take the plain versions only for tensors on the CPU; for
CUDA tensors they launch the kernel or raise, and add one to
``LAUNCHES["wkv"]`` / ``LAUNCHES["wkv_bwd"]`` per call.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .build import LAUNCHES

#: Head sizes the kernels are written for (rwkv6-1.6b and its smoke config).
HEAD_SIZES = (64,)

#: Kernels one K7b call launches: the dr, dk/dw and dv passes.
KERNELS_PER_CALL = 3

#: Steps between K7b's state checkpoints (``csrc/wkv_bwd.cu``).
(CHECKPOINT_STEPS,) = build.source_constants("wkv_bwd.cu", "CK")

# (r, k, v, w, u, s0, y, s_out, B, T, H, strides[19], stream)
build.register("wkv", "wkv.cu", {"wkv_forward_f32": [build.PTR] * 8 + [build.INT] * 3 + [build.PTR] * 2})
# (r, k, v, w, u, s0, dy, dr, dk, dv, dw, du_part, ckpt, B, T, H, strides[29], stream)
build.register("wkv_bwd", "wkv_bwd.cu",
               {"wkv_backward_f32": [build.PTR] * 13 + [build.INT] * 3 + [build.PTR] * 2})


def _check(r, k, v, w, u, s0, dy=None) -> None:
    seqs = (r, k, v, w) if dy is None else (r, k, v, w, dy)
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, N), got {tuple(r.shape)}")
    B, T, H, N = r.shape
    if any(t.shape != r.shape for t in seqs):
        raise ValueError(f"r, k, v, w{', dy' if dy is not None else ''} must share one shape, got "
                         f"{[tuple(t.shape) for t in seqs]}")
    if u.shape != (H, N) or s0.shape != (B, H, N, N):
        raise ValueError(f"u must be {(H, N)} and s0 {(B, H, N, N)}, got {tuple(u.shape)}, {tuple(s0.shape)}")
    if any(t.dtype != torch.float32 for t in (*seqs, u, s0)):
        raise TypeError("the WKV recurrence takes float32 tensors")
    if any(t.device != r.device for t in (*seqs, u, s0)):
        raise ValueError("every input must lie on one device")
    if any(t.stride(-1) != 1 for t in seqs if t.numel()):
        raise ValueError("r, k, v, w and dy must have their last axis contiguous (the wrapper never copies)")
    if not u.is_contiguous() or (s0.numel() and (s0.stride(-1) != 1 or s0.stride(-2) != N)):
        raise ValueError("u must be contiguous and the state's inner (N, N) contiguous (the wrapper never copies)")


def _check_head_size(r) -> None:
    N = r.shape[-1]
    if N not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head sizes {HEAD_SIZES}, got {N}")


def wkv_plain(r, k, v, w, u, s0, *, in_place: bool = False):
    """K7's plain version: the reference's step, one time step at a time."""
    T = r.shape[1]
    s = s0.float()
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if T else torch.zeros_like(r)
    if in_place:
        s0.copy_(s)
        return y, s0
    return y, s if T else s.clone()


def wkv_bwd_plain(r, k, v, w, u, s0, dy):
    """K7b's plain version: the closed-form backward, the states of a loop
    forward in time kept for a loop backward in time (not autograd)."""
    T = r.shape[1]
    vdy = (v * dy).sum(-1, keepdim=True)  # (B, T, H, 1)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    states = []
    s = s0.float()
    for t in range(T):
        states.append(s)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", s, dy[:, t]) + u * k[:, t] * vdy[:, t]
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    g = torch.zeros_like(s0, dtype=torch.float32)
    for t in reversed(range(T)):
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, v[:, t]) + u * r[:, t] * vdy[:, t]
        dv[:, t] = torch.einsum("bhij,bhi->bhj", g, k[:, t]) + dy[:, t] * (r[:, t] * u * k[:, t]).sum(-1, keepdim=True)
        dw[:, t] = (g * states[t]).sum(-1)
        g = w[:, t, :, :, None] * g + r[:, t, :, :, None] * dy[:, t, :, None, :]
    du = (r * k * vdy).sum((0, 1))
    return dr, dk, dv, dw, du


def _seq_strides(*ts) -> list[int]:
    return [s for t in ts for s in t.stride()[:3]]


def wkv(r, k, v, w, u, s0, *, in_place: bool = False):
    """K7: ``(y, final state)``; with ``in_place`` the final state is ``s0``,
    overwritten."""
    _check(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, s0, in_place=in_place)
    _check_head_size(r)
    B, T, H, N = r.shape
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    s_out = s0 if in_place else torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if B == 0 or T == 0:
        if not in_place:
            s_out.copy_(s0)
        return y, s_out
    strides = (ctypes.c_longlong * 19)(*_seq_strides(r, k, v, w, y), *s0.stride()[:2], *s_out.stride()[:2])
    fn = build.function("wkv", "wkv_forward_f32")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                 y.data_ptr(), s_out.data_ptr(), B, T, H, strides, stream)
    build.check_launch(err, "wkv")
    LAUNCHES["wkv"] += 1
    return y, s_out


def wkv_bwd(r, k, v, w, u, s0, dy):
    """K7b: ``(dr, dk, dv, dw, du)``, each contiguous float32."""
    _check(r, k, v, w, u, s0, dy)
    if r.device.type == "cpu":
        return wkv_bwd_plain(r, k, v, w, u, s0, dy)
    _check_head_size(r)
    B, T, H, N = r.shape
    dr, dk, dv, dw = (torch.empty((B, T, H, N), dtype=torch.float32, device=r.device) for _ in range(4))
    if B == 0 or T == 0:
        return dr, dk, dv, dw, torch.zeros((H, N), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    nck = -(-T // CHECKPOINT_STEPS)
    ckpt = torch.empty((B * H, nck, N, N), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 29)(*_seq_strides(r, k, v, w, dy, dr, dk, dv, dw), *s0.stride()[:2])
    fn = build.function("wkv_bwd", "wkv_backward_f32")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                 dy.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
                 ckpt.data_ptr(), B, T, H, strides, stream)
    build.check_launch(err, "wkv_bwd")
    LAUNCHES["wkv_bwd"] += 1
    return dr, dk, dv, dw, du_part.sum(0)
