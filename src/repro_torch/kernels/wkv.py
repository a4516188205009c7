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
passes its layer's slice of the cache).  :func:`wkv_bwd` returns ``(dr, dk,
dv, dw, du)`` from the same inputs and ``dy``; the final state gets no
gradient, nor does ``s0``.

The kernels (``csrc/wkv.cu``, ``csrc/wkv_bwd.cu``) run the recurrence on the
float32 CUDA cores, each thread carrying a small register tile of a state
through the whole sequence; :func:`launch_plan` gives every launch's shape.

* K7, one launch: a (b, h)'s 64 columns split over 2 or 8 blocks (column j
  of the state and y_t[j] depend on column j alone), chosen from B H so that
  the grid holds :data:`MIN_FORWARD_BLOCKS` blocks where it can: 256 at the
  training shape and at a B 1 prefill of 32 heads; a single step (T = 1,
  the decode step) runs a kernel of its own on 2 blocks a (b, h).  Each
  block reads and writes only its own columns of ``s0`` and the final
  state, and each thread its own tile, read before any of it is written: so
  the state may be written in place, over a slot's or a layer's slice of a
  cache.
* K7b, :data:`KERNELS_PER_CALL` launches: dr, ``du``'s per-(b, h) partials and
  the checkpoints forward in time (two blocks a (b, h), its rows split), then
  dk, dv and dw backward in time (one block a (b, h)), the states recomputed
  from checkpoints every :data:`CHECKPOINT_STEPS` steps in device memory and
  every :data:`SUBCHECKPOINT_STEPS` in shared memory, never by dividing by a
  decay.  No float atomics: each output element is written once by its
  owner, every sum runs in a fixed order, and ``du`` is summed over the
  batch by a torch reduction, so a call gives the same bytes every run.

The head size is 64 (:data:`HEAD_SIZES`); r, k, v, w and dy need their last
axis contiguous and the states their inner (N, N) contiguous, any other
strides: the wrappers raise on anything else and never copy.
:func:`wkv_plain` is the reference's step in a loop over T;
:func:`wkv_bwd_plain` is the closed-form backward in two loops (every state
kept).  The wrappers take the plain versions only for tensors on the CPU; for
CUDA tensors they launch the kernel or raise, and add one to
``LAUNCHES["wkv"]`` / ``LAUNCHES["wkv_bwd"]`` per call; on the meta device
(the dry run) they return empty outputs, their work :func:`wkv_work` and
:func:`wkv_bwd_work`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..obs import costs
from . import build
from .build import LAUNCHES

#: Head sizes the kernels are written for (rwkv6-1.6b and its smoke config).
HEAD_SIZES = (64,)

#: Kernels one K7b call launches: ``wkv_grad_r`` and ``wkv_grad_kvw``.
KERNELS_PER_CALL = 2

#: K7's threads a block, and its two chunked configurations: (columns a
#: block, a thread's tile rows x columns), wide first.  A single step takes
#: the wide one's.
(FORWARD_THREADS,) = build.source_constants("wkv.cu", "THREADS")
FORWARD_CONFIGS = tuple((cols, (rows, tcols)) for cols, rows, tcols in (
    build.source_constants("wkv.cu", f"{size}_COLS", f"{size}_TILE_R", f"{size}_TILE_C")
    for size in ("WIDE", "NARROW")))

#: K7b: steps between the state checkpoints in device memory and in shared
#: memory, its tile, and each pass's threads a block (and pass 1's rows).
(CHECKPOINT_STEPS, SUBCHECKPOINT_STEPS, _TILE, _GRAD_R_THREADS, _GRAD_R_ROWS, _GRAD_KVW_THREADS) = \
    build.source_constants("wkv_bwd.cu", "CK", "SK", "TILE", "FWD_THREADS", "FWD_ROWS", "BWD_THREADS")

#: K7's grid aims at this many blocks (about two on each of an H100's 132
#: SMs): the widest configuration that reaches it, else the narrowest.
MIN_FORWARD_BLOCKS = 256

# (r, k, v, w, u, s0, y, s_out, B, T, H, groups, strides[19], stream)
build.register("wkv", "wkv.cu", {"wkv_forward_f32": [build.PTR] * 8 + [build.INT] * 4 + [build.PTR] * 2})
# (r, k, v, w, u, s0, dy, dr, dk, dv, dw, du_part, ckpt, B, T, H, strides[29], stream)
build.register("wkv_bwd", "wkv_bwd.cu",
               {"wkv_backward_f32": [build.PTR] * 13 + [build.INT] * 3 + [build.PTR] * 2})


@dataclass(frozen=True)
class Launch:
    """One kernel launch: its entry, blocks, threads a block, a thread's tile
    of the state (rows, columns), and how many blocks split one (b, h)'s
    rows and columns."""

    kernel: str
    grid: int
    threads: int
    tile: tuple[int, int]
    row_groups: int
    column_groups: int


@dataclass(frozen=True)
class Plan:
    """K7's launch, K7b's two, and K7b's checkpoints: the steps between them
    in device memory and in shared memory, the device-memory states and the
    scratch they take."""

    forward: Launch
    backward: tuple[Launch, Launch]
    checkpoint_steps: tuple[int, int]
    checkpoints: int
    scratch_bytes: int


def launch_plan(B: int, T: int, H: int, N: int = 64) -> Plan:
    """The launches of a K7 and a K7b call on ``(B, T, H, N)`` inputs, as the
    wrappers make them (the C entry points run the same shapes)."""
    bh = B * H
    cols, tile = FORWARD_CONFIGS[0] if T == 1 else next(
        ((c, t) for c, t in FORWARD_CONFIGS if bh * (N // c) >= MIN_FORWARD_BLOCKS), FORWARD_CONFIGS[-1])
    forward = Launch("wkv_forward", bh * (N // cols), FORWARD_THREADS, tile, 1, N // cols)
    rows = N // _GRAD_R_ROWS
    backward = (Launch("wkv_grad_r", bh * rows, _GRAD_R_THREADS, (_TILE, _TILE), rows, 1),
                Launch("wkv_grad_kvw", bh, _GRAD_KVW_THREADS, (_TILE, _TILE), 1, 1))
    checkpoints = bh * max(0, -(-T // CHECKPOINT_STEPS) - 1)
    return Plan(forward, backward, (CHECKPOINT_STEPS, SUBCHECKPOINT_STEPS), checkpoints, checkpoints * N * N * 4)


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


def wkv_work(r, k, v, w, u, s0, *, in_place: bool = False) -> dict:
    """One K7 call's work: 5 flops a state element and step (the read's FMA,
    the update's multiply and FMA); r, k, v, w, u and s0 read once, y and the
    state written once."""
    B, T, H, N = r.shape
    seq, state = 4.0 * B * T * H * N, 4.0 * B * H * N * N
    return {"flops": 5.0 * B * T * H * N * N, "bytes": 5 * seq + 2 * state + 4.0 * H * N}


def wkv_bwd_work(r, k, v, w, u, s0, dy) -> dict:
    """One K7b call's work: 14 flops a state element and step (the state
    recomputed, 3; G's update, 3; the reads of dr, dk, dv and dw, an FMA
    each); r, k, v, w, dy, u and s0 read once, dr, dk, dv, dw and du written
    once (its checkpoints are the design's own traffic, not counted)."""
    B, T, H, N = r.shape
    seq, state = 4.0 * B * T * H * N, 4.0 * B * H * N * N
    return {"flops": 14.0 * B * T * H * N * N, "bytes": 9 * seq + state + 2 * 4.0 * H * N}


@costs.kernel("wkv", wkv_work)
def wkv(r, k, v, w, u, s0, *, in_place: bool = False):
    """K7: ``(y, final state)``; with ``in_place`` the final state is ``s0``,
    overwritten.  On the meta device (the dry run) empty outputs, the state
    ``s0`` itself with ``in_place``, nothing written."""
    _check(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, s0, in_place=in_place)
    _check_head_size(r)  # the card's limit, which the dry run (meta) is held to as well
    if r.device.type == "meta":
        B, T, H, N = r.shape
        y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
        return y, s0 if in_place else torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    B, T, H, N = r.shape
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    s_out = s0 if in_place else torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if B == 0 or T == 0:
        if not in_place:
            s_out.copy_(s0)
        return y, s_out
    groups = launch_plan(B, T, H, N).forward.column_groups
    strides = (ctypes.c_longlong * 19)(*_seq_strides(r, k, v, w, y), *s0.stride()[:2], *s_out.stride()[:2])
    fn = build.function("wkv", "wkv_forward_f32")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                 y.data_ptr(), s_out.data_ptr(), B, T, H, groups, strides, stream)
    build.check_launch(err, "wkv")
    LAUNCHES["wkv"] += 1
    return y, s_out


@costs.kernel("wkv_bwd", wkv_bwd_work)
def wkv_bwd(r, k, v, w, u, s0, dy):
    """K7b: ``(dr, dk, dv, dw, du)``, each contiguous float32 (on the meta
    device, the dry run's, empty)."""
    _check(r, k, v, w, u, s0, dy)
    if r.device.type == "cpu":
        return wkv_bwd_plain(r, k, v, w, u, s0, dy)
    _check_head_size(r)  # the card's limit, which the dry run (meta) is held to as well
    if r.device.type == "meta":
        B, T, H, N = r.shape
        seqs = tuple(torch.empty((B, T, H, N), dtype=torch.float32, device=r.device) for _ in range(4))
        return (*seqs, torch.empty((H, N), dtype=torch.float32, device=r.device))
    B, T, H, N = r.shape
    dr, dk, dv, dw = (torch.empty((B, T, H, N), dtype=torch.float32, device=r.device) for _ in range(4))
    if B == 0 or T == 0:
        return dr, dk, dv, dw, torch.zeros((H, N), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    ckpt = torch.empty((launch_plan(B, T, H, N).checkpoints, N, N), dtype=torch.float32, device=r.device)
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
