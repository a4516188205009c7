"""K5b: FlashAttention backward on the card, and its plain torch version.

Not a TPU kernel: the counterpart of the reference's jnp custom-VJP backward
(:func:`repro.models.attention._flash_bwd`), the gradient the training
attention takes through K5.  Given q ``(B, T, H, d)``, k, v ``(B, S, KV, d)``,
the forward's output ``o`` and its gradient ``dout`` ``(B, T, H, d)``, and
K5's per-row logsumexp ``lse`` (float32 ``(B, H, T)``,
``flash_attention(..., return_lse=True)``), it returns ``(dq, dk, dv)`` in
the inputs' type; GQA's dk and dv sum over the q heads of a kv head.  K5's
causal convention (``row >= col``), query offset (``q_offset``: q's row ``i``
is global row ``q_offset + i``; the dk and dv of keys no row sees are zeros)
and mask value.

The kernel is ``csrc/flash_attention_bwd.cu`` (CUDA C++ for ``sm_90a``: a
delta pass, a dk/dv pass over key tiles and a dq pass over query tiles, no
float atomics, :data:`KERNELS_PER_CALL` launches a call).  The dtype picks
the design: bfloat16 runs every product on the tensor cores
(``mma.sync.m16n8k16``, bf16 in and f32 accumulate, K5's bf16 layout; p and
ds are rounded to bf16 before the products that take them) and copies its
q, k, v and dout tiles with 16-byte ``cp.async``, so those four must start
on 16-byte boundaries with row strides that are multiples of 8 elements
(the wrapper raises otherwise, as K5's bf16 path does; a transposed
``(B, H, T, d)`` view is aligned and read in place); float32 runs the
CUDA-core kernels in f32, which take any strides whose last axis is
contiguous.  :func:`flash_attention_bwd_plain` is the port of
``_flash_bwd``, chunked over S in torch ops, with any S (the reference
reshapes S into chunks of 1024 and needs S to divide).
:func:`flash_attention_bwd` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises, and adds one to
``LAUNCHES["flash_attention_bwd"]`` per call; on the meta device (the dry
run) it returns empty gradients, its work :func:`flash_attention_bwd_work`.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import costs
from . import build
from .build import LAUNCHES
from .flash_attention import NEG_INF, _check, _check_aligned, check_head_dim, check_offset, visible_pairs

#: Keys per chunk of the plain version (the reference's ``_FLASH_CHUNK``).
CHUNK = 1024

#: Kernels one call launches: the delta, dk/dv and dq passes.
KERNELS_PER_CALL = 3

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# (q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, S, H, KV, D, strides[24],
#  scale, causal, q_offset, stream)
build.register("flash_attention_bwd", "flash_attention_bwd.cu", {
    f"flash_attention_bwd_{sfx}": [build.PTR] * 10 + [build.INT] * 6
    + [build.PTR, build.F32, build.INT, build.INT, build.PTR]
    for sfx in _SUFFIX.values()
})


def flash_attention_bwd_plain(q, k, v, o, dout, lse, *, causal: bool = True, scale: float | None = None,
                              q_offset: int = 0):
    """K5b's plain version, the reference's ``_flash_bwd`` in torch: keys in
    chunks of :data:`CHUNK` (the last one ragged), f32 throughout."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = d**-0.5 if scale is None else scale

    def heads(x):  # (B, T, H, d) -> (B, KV, G, T, d) f32
        return x.reshape(B, T, KV, G, d).permute(0, 2, 3, 1, 4).float()

    qg = heads(q) * scale
    do = heads(dout)
    delta = (do * heads(o)).sum(-1)  # (B, KV, G, T)
    lse = lse.reshape(B, KV, G, T)
    kf = k.permute(0, 2, 1, 3).float()  # (B, KV, S, d)
    vf = v.permute(0, 2, 1, 3).float()
    dq = torch.zeros_like(qg)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    rows = q_offset + torch.arange(T, device=q.device)[:, None]
    for s0 in range(0, S, CHUNK):
        kc, vc = kf[:, :, s0:s0 + CHUNK], vf[:, :, s0:s0 + CHUNK]
        s = torch.einsum("bkgtd,bksd->bkgts", qg, kc)
        if causal:
            cols = s0 + torch.arange(kc.shape[2], device=q.device)[None, :]
            s = s.masked_fill(rows < cols, NEG_INF)
        p = torch.exp(s - lse[..., None])
        dv[:, :, s0:s0 + CHUNK] = torch.einsum("bkgts,bkgtd->bksd", p, do)
        dp = torch.einsum("bkgtd,bksd->bkgts", do, vc)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bkgts,bksd->bkgtd", ds, kc)
        dk[:, :, s0:s0 + CHUNK] = torch.einsum("bkgts,bkgtd->bksd", ds, qg)
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, T, H, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_bwd_work(q, k, v, o, dout, lse, *, causal: bool = True, scale: float | None = None,
                             q_offset: int = 0) -> dict:
    """One K5b call's work: five products (s, dp, dv, dq, dk) of 2 flops a
    multiply-add over the visible pairs; q, o, dout, the lse and dq of T
    rows, k, v, dk and dv of S rows, each read or written once."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    pairs = visible_pairs(T, S, causal, q_offset if causal else 0)
    nbytes = (4 * B * T * H * d + 4 * B * S * KV * d) * q.element_size() + 4 * B * H * T
    return {"flops": 10.0 * B * H * d * pairs, "bytes": float(nbytes)}


@costs.kernel("flash_attention_bwd", flash_attention_bwd_work)
def flash_attention_bwd(q, k, v, o, dout, lse, *, causal: bool = True, scale: float | None = None,
                        q_offset: int = 0):
    """K5b: returns ``(dq, dk, dv)``, each contiguous, in the inputs' type
    (on the meta device, the dry run's, empty)."""
    _check(q, k, v)
    q_offset = check_offset(q_offset) if causal else 0
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} must match q {tuple(q.shape)}")
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    if lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, H, T)}, got {lse.dtype} {tuple(lse.shape)}")
    if not (o.dtype == dout.dtype == q.dtype):
        raise TypeError(f"o and dout must have q's type {q.dtype}, got {o.dtype}, {dout.dtype}")
    if not (o.device == dout.device == lse.device == q.device):
        raise ValueError("every input must lie on one device")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, dout, lse, causal=causal, scale=scale, q_offset=q_offset)
    # The card's limits, which the dry run (meta) is held to as well.
    check_head_dim(d, q.dtype)
    if S == 0:
        raise ValueError("flash_attention_bwd needs at least one key")
    if any(t.stride(-1) != 1 for t in (q, k, v, o, dout)):
        raise ValueError("flash_attention_bwd takes tensors whose last axis is contiguous")
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd takes a contiguous lse")
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v, dout, op="flash_attention_bwd (bfloat16)")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.device.type == "meta":
        return dq, dk, dv
    scale = d**-0.5 if scale is None else scale
    if B == 0 or T == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, dout, dq, dk, dv) for s in t.stride()[:3]))
    fn = build.function("flash_attention_bwd", f"flash_attention_bwd_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, T, S, H, KV, d, strides, float(scale), int(causal), q_offset, stream)
    build.check_launch(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
