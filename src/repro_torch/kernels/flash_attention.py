"""K5: FlashAttention forward on the card, and its plain torch version.

Counterpart of :mod:`repro.kernels.flash_attention`, the LM's prefill
attention: ``softmax(q k^T * scale) v`` for q ``(B, T, H, d)`` against k, v
``(B, S, KV, d)``, causal (``row >= col``) or not, each q head ``h`` reading
kv head ``h // (H // KV)`` (GQA, K/V never repeated), f32 softmax with the
finite mask value -1e30.  The kernel is ``csrc/flash_attention.cu`` (CUDA C++
for ``sm_90a``); :func:`flash_attention_plain` computes the same function in
plain torch.  :func:`flash_attention` takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises, and
adds one to ``LAUNCHES["flash_attention"]``; on the meta device (the dry
run, :mod:`repro_torch.launch.dryrun`) it returns empty outputs of the
kernel's shapes, and :func:`flash_attention_work` is what a call counts
(:mod:`repro_torch.obs.costs`); it is held to the card's limits first
(:func:`check_card`), so the dry run refuses what the card refuses.  With
``return_lse=True`` (the
training forward) it also returns each row's logsumexp of its scaled, masked
scores, float32 ``(B, H, T)``, which the backward (K5b,
:mod:`.flash_attention_bwd`) reads; without it the kernel writes nothing more.
``q_offset`` (context parallelism) makes row ``i`` of q global row
``q_offset + i`` of the causal mask: key ``j`` is visible iff ``q_offset + i
>= j``; the lse is that of the given rows.  Without ``causal`` it is ignored.

Unlike the TPU wrapper, T and S may be any lengths (the kernel checks its
ragged tails), and no block sizes are taken.  The dtype picks the kernel:
bfloat16 runs both products on the tensor cores and copies its K/V tiles with
16-byte ``cp.async``, so its q, k and v must start on 16-byte boundaries with
row strides that are multiples of 8 elements (:func:`flash_attention` raises
otherwise; the model's projections always are); float32 runs the CUDA-core
kernel, which takes any stride.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from ..obs import costs
from . import build
from .build import LAUNCHES

#: Finite mask value: a masked score's exp() is exactly 0, never NaN.
NEG_INF = -1e30

#: Head dims the kernels (K5, K5b, K6) are compiled for, by dtype: bfloat16
#: also takes nemotron-4-340b's 192.
HEAD_DIMS = {torch.float32: (32, 64, 128), torch.bfloat16: (32, 64, 128, 192)}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# (q, k, v, o, lse or null, B, T, S, H, KV, D, strides[12], scale, causal,
#  q_offset, stream)
build.register("flash_attention", "flash_attention.cu", {
    f"flash_attention_{sfx}": [build.PTR] * 5 + [build.INT] * 6
    + [build.PTR, build.F32, build.INT, build.INT, build.PTR]
    for sfx in _SUFFIX.values()
})


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None,
                          return_lse: bool = False, q_offset: int = 0):
    """K5's plain version: the whole score matrix at once, in f32; with
    ``return_lse`` also each row's logsumexp, float32 ``(B, H, T)``."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = d**-0.5 if scale is None else scale
    qg = q.reshape(B, T, KV, G, d).float() * scale
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float())
    if causal:
        rows = q_offset + torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    out = out.reshape(B, T, H, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, T)
    return out


def check_offset(q_offset) -> int:
    """``q_offset`` as a Python int; a negative one raises."""
    q_offset = operator.index(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be non-negative, got {q_offset}")
    return q_offset


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention takes q (B,T,H,d) and k, v (B,S,KV,d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, _, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SUFFIX:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def check_head_dim(d: int, dtype) -> None:
    if d not in HEAD_DIMS[dtype]:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS[dtype]} in {dtype}, got {d}")


def check_card(q, k, v) -> None:
    """What the card's kernel refuses beyond :func:`_check`: a head dim it
    is not compiled for, no key, a last axis that is not contiguous, and in
    bfloat16 rows not aligned to 16 bytes."""
    check_head_dim(q.shape[3], q.dtype)
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention takes tensors whose last axis is contiguous")
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v)


def _check_aligned(*tensors, op: str = "flash_attention (bfloat16)") -> None:
    """16-byte copies of whole rows (K5's bf16 kernel, K6): every row (each
    index of the axes before the last) starts on a 16-byte boundary.  A
    stride of an axis of length 1 is never used, so it is not checked."""
    for t in tensors:
        step, lead = 16 // t.element_size(), t.dim() - 1
        if t.data_ptr() % 16 or any(st % step for n, st in zip(t.shape[:lead], t.stride()[:lead]) if n > 1):
            raise ValueError(
                f"{op} takes rows aligned to 16 bytes: base pointer {t.data_ptr() % 16} bytes off, "
                f"strides {t.stride()[:lead]} (need multiples of {step})")


def visible_pairs(t: int, s: int, causal: bool, q_offset: int = 0) -> int:
    """The (row, key) pairs a call of ``t`` query rows against ``s`` keys
    computes: ``t s``, or under the causal mask row ``i`` against keys ``j <=
    q_offset + i``."""
    if not causal:
        return t * s
    first = q_offset + 1  # keys row 0 sees
    short = min(max(s - first, 0), t)  # rows that see fewer than s keys
    return short * first + short * (short - 1) // 2 + (t - short) * s


def flash_attention_work(q, k, v, *, causal: bool = True, scale: float | None = None,
                         return_lse: bool = False, q_offset: int = 0) -> dict:
    """One K5 call's work: 2 flops a multiply-add of q.k and of p.v over the
    visible pairs; q, k and v read once, the output (and the lse) written
    once."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    pairs = visible_pairs(T, S, causal, q_offset if causal else 0)
    nbytes = (2 * B * T * H * d + 2 * B * S * KV * d) * q.element_size() + (4 * B * H * T if return_lse else 0)
    return {"flops": 4.0 * B * H * d * pairs, "bytes": float(nbytes)}


@costs.kernel("flash_attention", flash_attention_work)
def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    return_lse: bool = False, q_offset: int = 0):
    """K5: q (B, T, H, d); k, v (B, S, KV, d); returns (B, T, H, d) in q's
    type, and with ``return_lse`` also the rows' logsumexp (B, H, T) f32.
    ``q_offset``: q's first row is global row ``q_offset`` of the causal mask.
    On the meta device (the dry run) empty outputs of those shapes."""
    _check(q, k, v)
    q_offset = check_offset(q_offset) if causal else 0
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, return_lse=return_lse,
                                     q_offset=q_offset)
    check_card(q, k, v)
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if return_lse else None
    if q.device.type == "meta":
        return (out, lse) if return_lse else out
    scale = d**-0.5 if scale is None else scale
    if B == 0 or T == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = build.function("flash_attention", f"flash_attention_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, T, S, H, KV, d, strides, float(scale), int(causal), q_offset, stream)
    build.check_launch(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out
