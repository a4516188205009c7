"""Batched serving engine: slot-based continuous batching.

Counterpart of :mod:`repro.serve.engine`, with the same slot semantics: a
fixed number of decode slots share one batched ``decode_step``; a request is
admitted into a free slot by prefilling ``prompt[:-1]`` in one forward at
batch 1 into that slot's region of the cache, and its ``prompt[-1]`` is the
slot's next decode input.  A slot frees as soon as its request reaches EOS
or ``max_tokens``, and the queue backfills it; every step decodes all slots,
as the reference's does.

The reference prefills a standalone batch-1 cache and grafts it into the
slot.  Here the prefill writes straight into the slot's views of the batched
cache (``cache["k"][:, s:s+1]`` and so on), after the slot is zeroed: the
same state, without allocating and copying a second cache.

The reference compiles its decode step once (``jax.jit(model.decode_step)``).
On the card the engine captures ``model.decode_step`` once, when it is
built, into a CUDA graph over static buffers -- a ``(slots,)`` token buffer,
the cache tensors (allocated once by ``init_cache``, written in place by the
step, by prefill and by the slot reset) and the logits -- and every step
copies the next tokens in, replays the graph and samples the logits outside
it.  A failed capture raises; nothing falls back to the eager step.  On the
CPU the step runs eagerly.  Prefill stays eager: a graph per prompt length
would be one capture per request.  The engine serves decoder-only token
models: the encoder-decoder and an embeddings model raise, as the
reference's engine prefills ``{"tokens": ...}`` alone.

A model on a mesh (``LM(cfg, ctx)``) is served the same way on every rank:
each holds every slot, its chunk of the sequence-sharded cache and its
shard of the weights; the decode step's collectives (NCCL on the card) are
captured inside the graph, which reads nothing back to the host.  The
greedy sampler gives every rank the same token; a sampled token is rank
0's, broadcast to the others.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..kernels import build
from .sampler import SampleConfig, sample


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_tokens: int = 16
    eos: int | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Serve ``model`` (a :class:`repro_torch.models.lm.LM` on ``device``,
    default ``"cuda"``; raises without a card unless asked for ``"cpu"``).
    On the card the decode step is captured when the engine is built
    (:attr:`decode_graph`); ``_eager`` keeps it eager there, for the checks
    that hold the graph to the eager step."""

    def __init__(
        self,
        model,
        *,
        slots: int = 4,
        max_len: int = 256,
        sample_cfg: SampleConfig = SampleConfig(temperature=0.0),
        seed: int = 0,
        device="cuda",
        _eager: bool = False,
    ):
        self.device = resolve_device(device)
        if model.cfg.is_encdec or model.cfg.input_kind != "tokens":
            raise ValueError(f"{model.cfg.name}: the Engine prefills token prompts of a decoder-only model, as the "
                             "reference's does (its prefill batch carries tokens alone)")
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the engine runs on {self.device}")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.sample_cfg = sample_cfg
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self.cache = model.init_cache(slots, max_len)
        self.active: list[Request | None] = [None] * slots
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._next_token = np.zeros((slots,), np.int32)
        #: Decode steps run (graph replays on the card).
        self.decode_steps = 0
        self.decode_graph = None
        if self.device.type == "cuda" and not _eager:
            self._capture_decode()

    # ------------------------------------------------------------- plumbing
    def add(self, req: Request) -> None:
        self.queue.append(req)

    def _slot_cache(self, s: int) -> dict:
        """Views of slot ``s``'s region of every cache leaf: batch axis 0 of
        ``pos``, axis 1 of the stacked ``(L, B, ...)`` caches (``k``/``v``,
        and ``k_dense``/``v_dense`` of the leading dense layers)."""
        return {
            name: leaf[s : s + 1] if name == "pos" else leaf[:, s : s + 1]
            for name, leaf in self.cache.items()
        }

    def _reset_cache(self) -> None:
        """Zero every cache leaf in place (the tensors are never rebound)."""
        for leaf in self.cache.values():
            leaf.zero_()

    def _capture_decode(self) -> None:
        """Capture one batched ``decode_step`` into :attr:`decode_graph`.

        The capture recipe (:func:`~repro_torch.kernels.build.capture`) runs
        the step once before capturing it.  That warm-up is a real step --
        ``pos`` advances and a k/v row is written in every slot -- so it runs
        before any request is admitted and the cache is zeroed after it."""
        self._tokens = torch.zeros(self.slots, dtype=torch.int64, device=self.device)
        self.decode_graph, (self._logits, _) = build.capture(
            lambda: self.model.decode_step(self.cache, self._tokens), self.device
        )
        self._reset_cache()

    def _decode(self) -> torch.Tensor:
        """One batched decode step over every slot from ``_next_token``:
        the graph's replay on the card, the eager step on the CPU.  Returns
        the logits ``(slots, V)``."""
        self.decode_steps += 1
        tokens = torch.from_numpy(self._next_token)
        if self.decode_graph is None:
            logits, self.cache = self.model.decode_step(self.cache, tokens.to(self.model.device))
            return logits
        self._tokens.copy_(tokens)
        self.decode_graph.replay()
        return self._logits

    def _reset_slot(self, s: int) -> None:
        """Zero one slot's cache region (pos and every stack's k/v)."""
        for leaf in self._slot_cache(s).values():
            leaf.zero_()

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self._reset_slot(s)
                if len(req.prompt) > 1:
                    tokens = torch.tensor([req.prompt[:-1]], dtype=torch.int64, device=self.model.device)
                    self.model.prefill(tokens, self._slot_cache(s))
                self._next_token[s] = req.prompt[-1]
                self.active[s] = req

    # ----------------------------------------------------------------- step
    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        toks = sample(self._decode(), self.generator, self.sample_cfg)
        ctx = getattr(self.model, "ctx", None)
        if ctx is not None and self.sample_cfg.temperature > 0 and dist.get_world_size() > 1:
            dist.broadcast(toks, src=0)
        toks = toks.tolist()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(toks[s])
            req.out.append(tok)
            self._next_token[s] = tok
            if (req.eos is not None and tok == req.eos) or len(req.out) >= req.max_tokens:
                req.done = True
                self.finished.append(req)
                self.active[s] = None
        return sum(r is not None for r in self.active)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
