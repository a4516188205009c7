"""K6: decode attention on the card, and its plain torch version.

Counterpart of :mod:`repro.kernels.decode_attention`: one query token per
head, q ``(B, H, d)``, against a KV cache ``(B, S, KV, d)`` of which the
first ``lengths[b]`` positions are visible; the ``G = H // KV`` query heads
of a kv head share its rows.  The kernel is ``csrc/decode_attention.cu``
(CUDA C++ for ``sm_90a``): it splits the sequence into ``BLOCK_S`` slices,
streams each slice's rows through registers with 16-byte loads, and merges
the partial softmaxes by log-sum-exp, as the TPU kernel merges its cache
blocks.  It reads the cache in place through its strides, so a layer's slice
of the model's stacked cache is passed as it is -- no copy; every row must
start on a 16-byte boundary (the wrapper raises otherwise).  A slot of
length 0 sees every position masked to ``NEG_INF``: a uniform softmax, the
mean of v over the cache, as in the reference.
:func:`decode_attention_plain` computes the same function in plain torch.
:func:`decode_attention` takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises, and adds one to
``LAUNCHES["decode_attention"]``; on the meta device (the dry run) it
returns empty outputs, its work :func:`decode_attention_work`.

With ``return_lse=True`` K6 also returns each (slot, head)'s natural-log
logsumexp of its scaled, masked scores, float32 ``(B, H)``, written by the
kernel's merge pass in the same launch; without it the kernel writes nothing
more.  The sequence-sharded decode runs K6 on each rank's chunk of the cache
and merges the chunks' ``(out, lse)`` with :func:`merge_partials`.  A slot of
length 0 has the lse ``-1e30 + log(S)``, which is ``-1e30`` in float32 (the
reference's masking gives the same), so beside a chunk with a visible
position its weight ``exp(lse - max)`` is exactly 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import costs
from . import build
from .build import LAUNCHES
from .flash_attention import NEG_INF, _check_aligned, check_head_dim

#: Cache positions per block of the kernel's first pass.  Mistral-Nemo-12B's
#: largest smoke step (5,720 visible positions x 8 kv heads) gives 368
#: blocks of 4 warps, each warp 32 rows at bf16 D = 128: one wave, since 162
#: registers a thread let three blocks share an SM.  64 (twice the blocks,
#: twice the partials to merge) and 256 (too few blocks) ran slower on an
#: H100 (PERF.md has the three times and the card).
BLOCK_S = 128

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# (q, kc, vc, lengths, out, lse or null, part_acc, part_ml, B, S, H, KV, D,
#  block_s, strides[10], scale, stream)
build.register("decode_attention", "decode_attention.cu", {
    f"decode_attention_{sfx}": [build.PTR] * 8 + [build.INT] * 6
    + [build.PTR, build.F32, build.PTR]
    for sfx in _SUFFIX.values()
})


def decode_attention_plain(q, kcache, vcache, lengths, *, scale: float | None = None,
                           return_lse: bool = False):
    """K6's plain version: a masked softmax over the whole cache, in f32;
    with ``return_lse`` also the logsumexp of the masked scores, (B, H) f32."""
    B, H, d = q.shape
    S, KV = kcache.shape[1], kcache.shape[2]
    G = H // KV
    scale = d**-0.5 if scale is None else scale
    qg = q.reshape(B, KV, G, d).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qg, kcache.float())
    visible = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = s.masked_fill(~visible[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vcache.float()).reshape(B, H, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H)
    return out


def merge_partials(outs, lses) -> torch.Tensor:
    """Merge K6's results over chunks of one cache: ``outs`` (C, B, H, d),
    each chunk's normalised output, and ``lses`` (C, B, H), its logsumexp.
    Returns the attention over the whole cache, (B, H, d) float32: the
    chunks weighted by ``exp(lse - max lse)``, which is the reference's
    ``_decode_body`` merge (its pmax, then the psums of ``o * w`` and
    ``l * w``) written with normalised partials.  A chunk with no visible
    position (lse -1e30) weighs exactly 0 beside one with a visible
    position."""
    lses = lses.float()
    w = torch.exp(lses - lses.amax(dim=0, keepdim=True))
    num = (w[..., None] * outs.float()).sum(0)
    return num / w.sum(0)[..., None]


def _check(q, kcache, vcache, lengths) -> None:
    if q.dim() != 3 or kcache.dim() != 4 or kcache.shape != vcache.shape:
        raise ValueError(
            f"decode_attention takes q (B,H,d) and caches (B,S,KV,d), got "
            f"{tuple(q.shape)}, {tuple(kcache.shape)}, {tuple(vcache.shape)}"
        )
    B, H, d = q.shape
    if kcache.shape[0] != B or kcache.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(kcache.shape)} disagree on batch or head dim")
    if kcache.shape[2] == 0 or H % kcache.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {kcache.shape[2]}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    if not (q.dtype == kcache.dtype == vcache.dtype) or q.dtype not in _SUFFIX:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q and caches of one type, "
                        f"got {q.dtype}, {kcache.dtype}, {vcache.dtype}")
    if not (q.device == kcache.device == vcache.device == lengths.device):
        raise ValueError("q, the caches and lengths must lie on one device")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")


def decode_attention_work(q, kcache, vcache, lengths, *, scale: float | None = None,
                          return_lse: bool = False) -> dict:
    """One K6 call's work at every cache position visible (the lengths are
    data; the dry run counts a full cache): 2 flops a multiply-add of q.k and
    of p.v; the cache's k and v read once, q and the lengths read, the output
    (and the lse) written."""
    B, H, d = q.shape
    S, KV = kcache.shape[1], kcache.shape[2]
    nbytes = (2 * B * S * KV * d + 2 * B * H * d) * q.element_size() + 4 * B + (4 * B * H if return_lse else 0)
    return {"flops": 4.0 * B * H * d * S, "bytes": float(nbytes)}


@costs.kernel("decode_attention", decode_attention_work)
def decode_attention(q, kcache, vcache, lengths, *, scale: float | None = None,
                     return_lse: bool = False):
    """K6: q (B, H, d); caches (B, S, KV, d); lengths (B,) int32 visible
    counts.  Returns (B, H, d) in q's type, and with ``return_lse`` also the
    logsumexp (B, H) float32 (on the meta device, the dry run's, empty)."""
    _check(q, kcache, vcache, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, kcache, vcache, lengths, scale=scale, return_lse=return_lse)
    B, H, d = q.shape
    S, KV = kcache.shape[1], kcache.shape[2]
    # The card's limits, which the dry run (meta) is held to as well.
    check_head_dim(d, q.dtype)
    if S == 0:
        raise ValueError("decode_attention needs a cache of at least one position")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError("decode_attention takes contiguous int32 lengths")
    if any(t.stride(-1) != 1 for t in (q, kcache, vcache)):
        raise ValueError("decode_attention takes tensors whose last axis is contiguous")
    _check_aligned(q, kcache, vcache, op="decode_attention")
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    if q.device.type == "meta":
        return (out, lse) if return_lse else out
    scale = d**-0.5 if scale is None else scale
    if B == 0:
        return (out, lse) if return_lse else out
    G = H // KV
    nsplit = -(-S // BLOCK_S)
    part_acc = torch.empty((B, KV, nsplit, G, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, KV, nsplit, G, 2), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1),
        kcache.stride(0), kcache.stride(1), kcache.stride(2),
        vcache.stride(0), vcache.stride(1), vcache.stride(2),
        out.stride(0), out.stride(1),
    )
    fn = build.function("decode_attention", f"decode_attention_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), None if lse is None else lse.data_ptr(),
                 part_acc.data_ptr(), part_ml.data_ptr(),
                 B, S, H, KV, d, BLOCK_S, strides, float(scale), stream)
    build.check_launch(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return (out, lse) if return_lse else out
