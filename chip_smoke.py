#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--n KEYS] [--seed S] [--profile]

The main paths: the sort dataplane (``run_pipeline``), the dense LM serve
path (``Engine`` over Mistral-Nemo-12B), the MoE serve paths (``Engine``
over granite-moe-3b-a800m and deepseek-moe-16b), training (AdamW steps of
granite-moe-3b-a800m, of Mistral-Nemo-12B cut to 8 layers and of
deepseek-moe-16b cut to 10), the sharded fabric at one rank
(``sort_sharded``, the pool's ``shard_map`` backend, ``moe_layer_a2a``), the
LM on a (data, model) mesh at one rank (training and the serve CLI),
attention at any tp, the hybrid Mamba2 + shared-attention LM
(zamba2-1.2b, served and trained), the RWKV6 LM (rwkv6-1.6b, served and
trained), the encoder-decoder LM (whisper-small, served and trained), the
LM on precomputed embeddings (llava-next-34b, served at full width and
depth, trained at 4 of 60 layers) and the example twins.  Phases, one JSON line each:

1. ``device``   -- the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the seconds the nine hand-written kernels took to build
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel);
2. ``k1``, ``k2`` -- kernels K1 (row sort) and K2 (tournament merge) against
   their plain torch versions, for exact equality, int32 and int64; K1 at
   every width 2..4096, row counts that leave a warp or a block part-filled,
   ragged pads, all-equal rows, the dtype's extreme keys and a view that is
   not 16-byte aligned; K2 up to 2^23 keys, all-pad rows, all-equal keys,
   one pair of 2^22-wide rows, rows wider than its tile, with its kernel
   launches per call (1 + log2(P*B / tile));
3. ``pipeline`` -- ``repro_torch.net.pipeline.run_pipeline`` on the card: first
   byte-identical to the same call on the CPU (plain versions) at small n,
   then once at the full size (default 100M keys, the paper's §6 trace size)
   with the ``end_to_end`` configuration of ``benchmarks/net_bench.py``
   (7-hop binary tree, 16 segments of length 64, 256-key packets, 8 flows,
   oracle ranges, 4 arena servers, a 2-column int64 payload).  The launch
   counters are zeroed just before that run and read just after it;
4. ``pipeline_device`` -- ``run_pipeline(engine="device")``: the whole
   epoch as one program, captured into a CUDA graph on the card.  At small
   n, on the single, leaf-spine and tree graphs, with and without a
   payload, byte-identical to ``engine="fused"`` on the card and to
   ``engine="device"`` on the CPU; then the ``end_to_end`` configuration at
   the full size: the first call (warm-up and capture included) and at
   least three replays timed apart, keys/s from the replays' median, the
   output equal to the ``pipeline`` phase's and to ``torch.sort``'s with
   the payload following, one device-to-host read and no host-to-device
   copy per epoch, and K1 counted as the kernel nodes of the captured
   graph (one per hop).  The program cache is emptied after it; then the
   rest of the dataplane, each line with its own launch counts:
   ``pipeline_observed`` (the telemetry modes), ``pipeline_sampled`` (the
   adaptive control plane), ``pipeline_network`` (the link timing model),
   ``pipeline_faults`` (the reference's fault ladder: every plan on the
   three fabrics at small n against the fault-free run, ``torch.sort``, the
   CPU and the device engine's fused fallback; then the ladder at 1M on
   numpy-ladder servers and at the full size on the E2E fabric's arena
   servers, every output equal to the fault-free one, K1 once per sorting
   hop), ``pipeline_tenants`` (``run_jobs`` at J = 1, 2, 4 and J = 4 at 10M
   keys a tenant, every tenant equal to its solo run and to the
   ``pack=False`` twin; J = 4 on the device engine with its captures) and
   ``hop_engines`` (one hop, fused against the segment engine, K1 once per
   non-empty segment, the wires equal; ``faithful=True`` equal to fused);
5. ``k3``, ``k4`` -- kernels K3 (key-value row sort, the MoE dispatch) and K4
   (row merge) against their plain versions, for exact equality (K3's
   values too, duplicate keys included): the MoE path's shapes, the
   reference tests' shapes, and rows wide enough for every kind of launch
   (K3 up to 2^20 pairs, with its launches per call at each width, counted
   as the kernel nodes of a CUDA graph of one call, held to
   ``row_sort_kv_plan``; K4 at 2^14 and 2^17 elements);
6. ``k5``, ``k6`` -- the attention kernels K5 (flash attention) and K6
   (decode attention) against their plain torch versions: head dims 32, 64,
   128, GQA groups 1, 3, 4 and 7, causal or not, ragged T, S != T, strided
   q/k/v views, Mistral's 1963-token prefill, lengths 1..S (K6 also G 7
   and 12, and slots of length 0), float32 and bfloat16, on inputs whose
   softmax is peaked (limits: ``attn_limit``);
   the bf16 K5 wrapper must raise on rows that are not 16-byte aligned;
7. ``serve``, ``serve_moe`` -- for Mistral-Nemo-12B and for
   granite-moe-3b-a800m: first the smoke config(s) in float32 on the card
   against the same weights on the CPU (greedy tokens identical, logits
   within 1e-4; for the MoE path both MoE models' smoke configs), then the
   full model (every layer at full width, bf16, weights drawn on the card
   from ``--seed``) behind an ``Engine`` of 4 slots and ``max_len`` 4096: 8
   requests, prompt lengths from ``numpy.random.default_rng(seed)`` in
   512..2048, 32 greedy tokens each.  The engine replays its decode step as
   one CUDA graph (and the smoke configs' engines too: their tokens must
   equal an eager engine's on the card and the CPU's); the same requests
   then run on an eager engine, whose tokens must equal the graph's.  The
   launch counters are zeroed just before the graph run and read just after
   it; the decode step's launches are the captured graph's kernel nodes
   times its replays: K5 must launch once per layer per prefill, K6 once
   per layer per decode step, K3 once per MoE layer per prefill and per
   decode step, in the graph run and in the eager one.  Prefill and decode
   tokens/s and ms per decode step of both runs, peak device memory, the
   dropped assignments; the full model's
   logits on a short prompt through the kernels against the plain versions
   (Mistral: K5 and K6 plain, every argmax equal; granite: K3 plain, every
   dispatch and every logit identical).  After the MoE run,
   ``serve_moe_attention`` holds K5 and K6 to their plain versions at the
   shapes that run gave them (head_dim 64, 3 query heads per kv head);
8. ``kernels``  -- every ported kernel on fresh random inputs at the largest
   shape and dtype its main path gave it (K4, on no path, at the shape of
   one K2 round on the sort path's largest bucket): launches, agreement with
   the plain version, and kernel, plain and library (``torch.sort``, or
   ``scaled_dot_product_attention`` with ``enable_gqa``) times of one eager
   call (CUDA events, median of 10 after a warm-up) beside the bound; then
   the kernel's and the library call's device time per call of 24 calls
   replayed as one CUDA graph (``graph_ms``, ``library_graph_ms``), which
   leaves the host's cost of each call out.  K3's row adds the decode step's
   1 x 32 and its measured launches per call;
9. ``k5b``, ``train``, ``train_dense``, ``train_resume`` (before the
   ``kernels`` line) -- the attention backward K5b and K5's lse against
   their plain versions (head dims 32, 64, 128 x G 1, 3, 4, 7, causal or not,
   T and S of 1, 63, 130 and mixed, f32 and bf16; the training shapes,
   a transposed dO, a non-causal T != S; limits ``grad_limit`` and
   ``lse_limit``); then ``head_dim_192``: K5, K5b and K6 at
   nemotron-4-340b's head dim 192, which only the bf16 kernels take,
   against their plain versions (G 1, 3, 4, 7, ragged T and S, causal or
   not, slots of length 0, strided views; f32 at 192 must raise), and each
   one's eager and graph ms, plain and library ms and bound at a
   nemotron-4-340b rank's shapes (tp 16: 6 q heads, 1 kv head, T 4,096,
   decode 8 slots x 4,096); granite-moe-3b-a800m at full width and depth and
   Mistral-Nemo-12B at 8 of 40 layers (``TRAIN``, ``TRAIN_DENSE``) trained
   on ``TokenPipeline`` batches: tokens/s, ms per step (the first apart),
   peak memory, loss, gradient norm and lr per step, dropped assignments,
   K5 / K5b / K3 launches held exactly per step, one step cut into forward,
   backward and AdamW (with ``--profile`` also profiled), and granite's
   first step again with every kernel plain (loss and gradient norm within
   a stated bf16 limit); the training CLI at granite's smoke config in f32
   on the card, run, interrupted and resumed from its step-3 checkpoint
   (steps 4-6 within 1e-5).  The ``kernels`` line then gains K5b's row
   (granite's shape; Mistral's under ``dense``): eager and graph ms, its
   plain twin's, the backward of SDPA timed on its own, the bound, its
   design and the kernel nodes of one call captured in a CUDA graph (held
   to the wrapper's ``KERNELS_PER_CALL``);
10. ``sharded`` (after ``train_resume``, before the ``kernels`` line) -- the
   sharded fabric (M19) on a one-rank NCCL process group (a ``file://``
   rendezvous in a temporary directory, destroyed after the phase; no CPU
   stand-in): ``sort_sharded`` on the pipeline phase's 100M int64 keys with
   the presort block 256 and capacity factor 2.0, equal to ``torch.sort``,
   nothing dropped, every key valid, K1 launched once (the presort), the
   median of three timed calls, keys/s and peak memory; ``run_pipeline``
   with ``pool_backend="shard_map"`` on the ``end_to_end`` configuration at
   200k keys and at the full size, byte-identical in output and passes to
   ``pool_backend="numpy"`` (``pool_mesh(4)`` is None at one rank: the pool
   concatenates), K1 once per hop and K2 counted; ``moe_layer_a2a`` at tp = 1
   on granite-moe-3b-a800m's MoE layer at full width (bf16, 1 x 2,048
   tokens) against ``moe_layer`` on the same weights: dropped equal, aux
   within 1e-5, the output and every gradient of ``sum(y^2) + aux`` within
   ``MOE_A2A_LIMIT``, K3 twice a call; ``gpipe`` at one stage against
   ``sequential_reference`` and ``fsdp_gather`` at one rank against the
   identity, forward and backward.  The ``kernels`` line's K1, K2 and K3 rows
   gain ``sharded``: their launches there, and K1 and K3 at the sharded
   path's shapes against their plain versions, timed, with their bounds;
11. ``lm_mesh`` (after ``sharded``, before the ``kernels`` line) -- the LM
   on a (data, model) mesh at one rank (a one-rank NCCL process group
   through a ``file://`` rendezvous, destroyed after the runs; no CPU
   stand-in): granite-moe-3b-a800m's train step at full width and depth on
   the (1, 1) mesh against the step without a mesh, 3 AdamW steps each on
   the same batches (loss and gradient norm within ``LM_MESH_TRAIN_LIMIT``,
   step ms and peak memory of both, K5 / K5b / K3 held to their launches
   per step); Mistral-Nemo-12B at full width and depth through
   ``python -m repro_torch.launch.serve --mesh 1x1`` against the CLI without
   a mesh, each capturing its decode graph (greedy tokens equal, ms per
   decode step, K5 and K6 counted); K6 with its lse at Mistral's decode
   shape against its plain version, and the sequence-sharded decode's math
   at tp = 4 on one card (the cache in four chunks with chunk-local
   lengths, some 0, K6 with lse on each, ``merge_partials``) against
   whole-cache K6, with K6's graph ms without and with the lse and at the
   chunk shape; the vocab-parallel cross entropy at 131,072 columns over
   four shards against one shard's and the library's; whisper-small and
   llava-next-34b (4 of 60 layers) trained 3 steps at their train phases'
   shapes on the (1, 1) mesh against no mesh, the same bytes
   (``families``).  The ``kernels`` line's K6 row gains ``lse``, K5's,
   K5b's and K3's their launches there;
12. ``cp`` (after ``lm_mesh``, before the ``kernels`` line) -- context
   parallelism on one card: K5 (with its lse) and K5b at query offsets 0,
   64, 100 and 230 (T 70 rows of S 300) against their plain versions in
   bf16 (head dims 128, 64) and f32 (64, 32), causal, dk and dv of the keys
   past offset + T exactly zero, an offset of 0 the same bytes as none;
   starcoder2-15b's attention at tp 8 rank by rank (``CP``: 48 q heads, 4
   kv heads, T 4,096, 512 rows a rank at offset 512 r): the eight K5 calls
   concatenated against the whole-T call, the eight K5b calls (dq
   concatenated, dk and dv summed) against the whole-T K5b, graph ms per
   rank and whole beside their bounds; then its attention layer at full
   width in both layouts through the port's rank bodies (context-parallel:
   each rank's rows projected, K/V concatenated as the all-gather, K5/K5b
   at the offset, the whole ``wo``; column-split: each rank's heads through
   its rows of ``wo``, summed) against the one-device layer, output and
   every gradient (``CP_LAYER_LIMIT``); then
   starcoder2-15b served whole at full width and depth through
   ``launch.serve`` (its smoke config first, card against CPU): tokens,
   ms per decode step, peak memory, K5 and K6 counted.  The ``kernels``
   line's K5 and K5b rows gain ``q_offset``;
13. ``serve_deepseek``, ``train_deepseek`` (after ``cp``, before the
   ``kernels`` line) -- deepseek-moe-16b at full width and depth (28
   layers, the first dense with its own ``k_dense``/``v_dense`` cache, 64
   routed experts top-6 and 2 shared; 32.7 GB of bf16 weights from
   ``--seed``) served as ``serve_moe`` is (the full-width check with K3
   plain, then the graph run and the eager run of the same 8 requests:
   tokens/s, mean and median ms per decode step, peak memory, each cache
   leaf's bytes, K3 / K5 / K6 launches held exactly); then trained at full
   width with its dense layer and 9 MoE layers (``TRAIN_DEEPSEEK``: B 2 x
   2,048, 3 AdamW steps, launches held per step);
14. ``serve_hybrid``, ``serve_hybrid_attention``, ``train_hybrid`` --
   zamba2-1.2b: its smoke config in float32 on the card against the CPU
   (logits within 1e-4, greedy tokens equal, the graph's equal the eager
   step's), then the full model (38 Mamba2 layers, the shared attention +
   MLP block 6 times, bf16 from ``--seed``, nothing cut) behind the serve
   traffic: K5 6 launches a prefill and K6 6 a decode step, held exactly,
   each request's prefill seconds and SSD chunk length Q (1 for a prime
   prompt: the inter-chunk loop then runs a host step per token and
   layer); K5 and K6 held to their plain versions at that run's shapes
   (head dim 64, 32 heads, MHA); then ``TRAIN_HYBRID`` (B 4 x 2,048, 4
   AdamW steps, nothing cut: K5 12 / K5b 6 launches a step), its step cut
   into the Mamba2 blocks, the shared block and AdamW (``train_stages``),
   and its first step again with the kernels plain.  The ``kernels`` line's
   K5, K6 and K5b rows gain ``zamba2`` (the shape, launches, times and
   bound) and K3's, K5's and K6's ``deepseek_serve_launches``;
15. ``k7``, ``serve_rwkv``, ``train_rwkv`` -- RWKV6's WKV recurrence: K7
   (forward) and K7b (backward) against their plain versions at T 1, 7 and
   64 with B x H 1 and 6, at the ragged shapes ``K7_RAGGED`` (T off the
   chunk and both checkpoint intervals, both of K7's chunked configurations)
   and at the training shape (B 4, T 2,048, H 32), decays exp(-exp(w)) for
   w in [-8, 3], nonzero u and s0 (limit ``wkv_limit``); two K7b calls at
   the training shape equal byte for byte; K7 at T 1 in place on a layer's
   and on a slot's slice of a stacked (L, B, H, 64, 64) cache; an r whose
   last axis is not contiguous refused; K7b's two passes counted as the
   kernel nodes of one captured call; eager, graph (24 calls replayed) and
   plain ms at the training shape beside the float32 bound, with each
   call's ``wkv.launch_plan``.  Then rwkv6-1.6b: its smoke
   config in float32 on the card against the CPU (logits within 1e-4,
   greedy tokens equal, the graph's equal the eager step's), the full model
   (24 layers, d_model 2,048, 32 heads of 64, vocab 65,536, bf16 from
   ``--seed``, nothing cut) through the ``Engine`` at the serve traffic: K7
   24 launches a prefill and 24 kernel nodes a decode replay, held exactly,
   each request's prefill seconds, each cache leaf's bytes; a prefill and 4
   steps with K7 plain against the kernel (``full_width_parity``).  Then
   ``TRAIN_RWKV`` (B 4 x 2,048, 4 AdamW steps, nothing cut: K7 48 / K7b 24
   launches a step, held exactly), its step cut into the RWKV6 blocks, AdamW
   and the rest, and the first step at the cut shape B 1 x 256 with the
   kernels and with K7 and K7b plain.  The ``kernels`` line gains K7's
   (with its serve shapes, prefill and decode) and K7b's rows (``library_ms``
   null: no single PyTorch call computes the recurrence);
16. ``serve_encdec``, ``train_encdec``, ``serve_embeds``, ``train_embeds``
   (after ``train_rwkv``) -- whisper-small at full width and depth (12 + 12
   layers, bf16 from ``--seed``): its smoke config on the card against the
   CPU (logits within 1e-4, tokens equal, the captured decode step's equal
   the eager step's), the full model through K5 and K6 against their plain
   versions on a float32 copy of its weights (1e-3 of the logits' scale,
   the bf16 model's difference recorded), then ``SERVE_ENCDEC`` (one
   prefill of 4 x 1,500 frames and the 4-token start-of-transcript prompt,
   64 greedy steps) through the captured decode step and through the eager
   step, tokens equal: K5 36 launches a prefill (encoder, decoder self and
   cross) and K6 24 kernel nodes a replay (self and cross), held exactly;
   prefill seconds, median ms a decode step, peak memory, the cache's bytes
   and the shapes K5 and K6 ran at; then ``TRAIN_ENCDEC`` (B 8 x (1,500
   frames + 448 tokens), 4 AdamW steps: K5 72 / K5b 36 a step, held) and
   its first step at 2 + 2 layers in float32 with the kernels and with
   them plain.  llava-next-34b at full width and depth from embeddings
   (60 layers, 68.8 GB of bf16 from ``--seed``): its smoke config (heads
   widened to K5's 32, G 7) on the card against the CPU, the full model's
   K5 and K6 against their plain versions (``full_width_parity``, bf16),
   then ``SERVE_EMBEDS`` (a prefill of 576-2,880 embedding rows into each
   of 4 slots, 32 greedy token steps of all 4 through the captured decode
   step and the eager one, tokens equal: K5 60 a prefill, K6 60 nodes a
   replay, held), then ``TRAIN_EMBEDS`` (4 of 60 layers, B 1 x 2,048, 3
   steps).  Each serve phase runs its graph run again on the (1, 1) mesh
   (``mesh_1x1``: the model's twin there, built on the meta device and
   given the model's own tensors), tokens and prefill logits the same bytes
   as without the mesh, launches held as there.  The ``kernels`` line's K5,
   K6 and K5b rows gain ``whisper`` (K5: the encoder's and the training
   cross-attention's shapes; K6: the self and the cross cache; K5b: the
   encoder's and the cross shape) and ``llava`` (G 7: the largest prefill,
   the decode step, the training shape), each with launches, eager and
   graph ms, the plain and SDPA times and a bound of T x S pairs without
   the causal mask, and ``lm_mesh_launches``: the (1, 1) runs' launches by
   shape (``AttnRecorder``; K6's as the captured step's calls by shape
   times its replays); and ``whisper_tp4`` / ``llava_tp4`` (K6:
   ``*_tp4_chunk``), the same at a tp-4 rank's shapes (whisper's 3 of 12
   heads, llava's 14 over 2 kv heads; K6 with its lse on a chunk of every
   head: 112 and 375 positions, 1,024), with no launch count (no run here
   is tp 4);
17. ``examples`` -- each example twin (``examples/torch_*.py``) once on the
   card at its reference example's default size, one after the other, its
   lines (times, the serve twin's sampled tokens and the training twin's
   losses masked) equal to the same twin's on the CPU, run in background
   processes started before the serve phases;
18. ``dryrun`` (after ``examples``) -- the multi-pod dry run
   (``repro_torch.launch.dryrun``, a fake process group on the meta device,
   no card) in two parts.  (a) Calibration against the runs above at a
   one-rank fake world: granite-moe-3b-a800m's ``train`` cell (B 4 x 2,048,
   f32 moments, AdamW's row chunk as there; no kernel launched, the stand-ins
   on the meta device) -- its ``argument_bytes`` must
   equal the bytes of the parameters, moments and batch that phase held, and
   the predicted peak (arguments + ``temp_bytes``) stands beside that
   phase's ``torch.cuda.max_memory_allocated()`` with their ratio, its
   ``flops_per_device`` beside ``train_flops``; one Mistral-Nemo-12B decode
   step at ``SERVE``'s 4 slots x 4,096 -- its cache and parameter bytes must
   equal the ``serve`` phase's live cache and weights.  (b) The sweep: every
   arch x shape on the single-pod (data 16, model 16) mesh, run by the CLI
   in a background process started just before ``examples``, each cell's
   seconds; any cell in ``error``, or a skip the reference would not make,
   fails the run (both meshes: ``--both-meshes`` on the CLI);
19. ``ptxas`` -- every kernel entry's registers, static shared memory and
   spills, as the compiler reported them when it built the kernels; a
   spill in any entry fails the run.

Then the card's name and power limit, then ``{"ok": true, "device": ...}``.
Any failed check exits non-zero before that line.  Without a CUDA device, or
without the port beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks the bound is computed against.  Bytes: HBM3 at 3.35 TB/s
#: (NVIDIA's data sheet).  Attention flops: the dense bf16 tensor-core rate,
#: 989e12 flop/s (the same sheet), the peak for the main path's type.
#: Operations of the sort networks: a compare-exchange runs on the integer
#: ALUs, not on the float32 pipes: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
#: (the Hopper architecture whitepaper) is 16.7e12 32-bit integer operations
#: per second.  A compare-exchange costs 2 of them on int32 keys (min and
#: max) and 6 on int64 keys (a 64-bit compare is two 32-bit compares, and
#: min and max each select two 32-bit halves); K3's key-value one costs 2
#: more, the two selects of the int32 values.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
#: The WKV recurrence (K7, K7b) is float32 on the CUDA cores: 67e12 flop/s
#: of float32 outside the tensor cores (the same data sheet), an FMA two.
F32_FLOP_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_COMPARE_EXCHANGE = {4: 2, 8: 6}
OPS_PER_KV_COMPARE_EXCHANGE = {4: 4, 8: 8}
OPS_PER_MERGE_STEP = {4: 2, 8: 4}

E2E = dict(
    topology="tree", branching=2, height=3, num_segments=16,
    segment_length=64, payload_size=256, num_flows=8, k=10,
    range_mode="oracle", num_servers=4, merge_backend="arena",
)
E2E_HOPS = 7

#: The serve runs: Mistral-Nemo-12B (dense) and granite-moe-3b-a800m (MoE,
#: 40 experts top-8) at full width, as their users serve them.
SERVE_ARCH = "mistral-nemo-12b"
MOE_ARCH = "granite-moe-3b-a800m"
SERVE = dict(slots=4, max_len=4096, requests=8, prompt_min=512, prompt_max=2048, new_tokens=32)
#: Seconds the dry run's sweep may take past its start (it runs beside the
#: card's phases).
DRYRUN_SWEEP_TIMEOUT = 900

#: The training runs, bf16 from ``--seed``, AdamW at lr 3e-4 with
#: ``AdamWConfig``'s other defaults (f32 moments), one microbatch:
#: granite-moe-3b-a800m at full width and depth, and Mistral-Nemo-12B at full
#: width with 8 of its 40 layers (its 12.25B parameters with AdamW's f32
#: moments, 12 bytes each, need about 147 GB).  ``TRAIN_RESUME`` drives the
#: training CLI at granite's smoke config.
TRAIN = dict(arch=MOE_ARCH, batch=4, seq=2048, steps=6, lr=3e-4)
TRAIN_DENSE = dict(arch=SERVE_ARCH, layers=8, batch=2, seq=2048, steps=4, lr=3e-4)
TRAIN_RESUME = dict(arch=MOE_ARCH)
#: K5b's training shapes: (B, T, S, H, KV, d, causal).
TRAIN_K5B = {"granite": (4, 2048, 2048, 24, 8, 64, True), "mistral": (2, 2048, 2048, 32, 8, 128, True)}

#: The hybrid and deepseek paths, at ``SERVE``'s traffic: zamba2-1.2b (38
#: Mamba2 layers and one shared attention + MLP block run after every 6 of
#: them, 6 times; MHA with 32 heads of 64) served and trained at full width
#: and depth, nothing cut; deepseek-moe-16b (28 layers, the first dense, 64
#: routed experts top-6 and 2 shared) served at full width and depth, and
#: trained at full width with its dense first layer and 9 of its 27 MoE
#: layers (its 16.4B parameters with AdamW's f32 moments, 12 bytes each,
#: need about 197 GB; 10 layers peak near 72 GB).
HYBRID_ARCH = "zamba2-1.2b"
DEEPSEEK_ARCH = "deepseek-moe-16b"
TRAIN_HYBRID = dict(arch=HYBRID_ARCH, batch=4, seq=2048, steps=4, lr=3e-4)
TRAIN_DEEPSEEK = dict(arch=DEEPSEEK_ARCH, layers=10, batch=2, seq=2048, steps=3, lr=3e-4)

#: RWKV6 (rwkv6-1.6b: 24 layers, d_model 2,048, 32 heads of 64, vocab 65,536)
#: served at ``SERVE``'s traffic and trained at full width and depth, nothing
#: cut.  Its plain-kernel check runs the first step at the cut shape
#: ``plain_batch`` x ``plain_seq`` (B 1 x 256), with the kernels and then with
#: K7 and K7b plain: the plain WKV is a host loop of T steps a layer (its
#: backward keeps every step's state), which at B 4 x 2,048 would take
#: minutes.
#: That check runs on a float32 model (``plain_dtype``) of 4 layers
#: (``plain_layers``).  At the initial weights (every decay near 0.9975) the
#: gradient grows some 25,000x from the last layer's WKV to the first's, so
#: the backward is ill-conditioned: on an H100 K7 and K7b agreed with their
#: plain versions to 1e-6 relative on every one of the 24 layers' own inputs,
#: yet the two steps' gradient norms came out 1,177 and 1,697 in float32
#: (5,898 and 12,366 in bf16), each deterministic; at 4 layers they agree to
#: rounding.
RWKV_ARCH = "rwkv6-1.6b"
TRAIN_RWKV = dict(arch=RWKV_ARCH, batch=4, seq=2048, steps=4, lr=3e-4, plain_batch=1, plain_seq=256,
                  plain_dtype="float32", plain_layers=4)
#: K7's and K7b's checks (the ``k7`` phase): (B, T, H) with T 1, 7 and 64 and
#: B x H 1 and 6; shapes the kernels' tiling makes ragged (T off K7's
#: 16-step chunk and K7b's 32- and 4-step checkpoint intervals, B x H 15,
#: 32 and 75, on K7's narrow configuration); the training shape (the wide).
K7_SMALL = tuple((b, t, h) for t in (1, 7, 64) for b, h in ((1, 1), (2, 3)))
K7_RAGGED = ((3, 37, 5), (1, 1963, 32), (2, 100, 3), (3, 65, 25))
K7_TRAIN = (4, 2048, 32)

#: The encoder-decoder (whisper-small: 12 encoder and 12 decoder layers, d
#: 768, 12 heads of 64 MHA, d_ff 3,072, vocab 51,865; bf16 from ``--seed``)
#: at full width and depth, nothing cut.  ``frames`` 1,500 and ``max_len``
#: 448 are the public openai/whisper-small config's max_source_positions and
#: max_target_positions (a 30 s window after the conv frontend's stride 2).
#: Served: 4 sequences of 1,500 frames, the 4-token start-of-transcript
#: prompt (<|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>), 64
#: greedy steps through the captured decode step.  Trained: B 8 x (1,500
#: frames + 448 tokens), 4 AdamW steps; the plain-kernel check at 2 + 2
#: layers in float32, B 2, at the same lengths.
ENCDEC_ARCH = "whisper-small"
SERVE_ENCDEC = dict(batch=4, frames=1500, max_len=448, new_tokens=64, prompt=(50258, 50259, 50359, 50363))
TRAIN_ENCDEC = dict(arch=ENCDEC_ARCH, batch=8, frames=1500, seq=448, steps=4, lr=3e-4, plain_batch=2,
                    plain_seq=448, plain_dtype="float32", plain_layers=2)
#: The embeddings inputs (llava-next-34b's backbone: 60 layers, d 7,168, 56
#: heads over 8 kv heads of 128, G 7, gated d_ff 20,480, vocab 64,000; 68.8 GB
#: of bf16 from ``--seed``), served at full width and depth: one request a
#: slot, each a prompt of 1-5 of LLaVA-NeXT's 576-row anyres tiles (576-2,880
#: embedding rows, the count from ``default_rng(seed)``), then 32 greedy token
#: steps of the 4 slots through the captured decode step.  Trained at full
#: width with 4 of its 60 layers (all 60 with AdamW's f32 moments need some
#: 413 GB), B 1 x 2,048 embedding rows, 3 AdamW steps.
EMBEDS_ARCH = "llava-next-34b"
SERVE_EMBEDS = dict(slots=4, max_len=4096, tile=576, tiles=(1, 5), new_tokens=32)
TRAIN_EMBEDS = dict(arch=EMBEDS_ARCH, layers=4, batch=1, seq=2048, steps=3, lr=3e-4)
#: Embeddings are drawn as ``data.synthetic.make_batch`` draws them: N(0, 1)
#: x 0.02, the scale of the token table's rows.
EMBED_SCALE = 0.02

#: The example twins (``examples/torch_*.py``), each at its reference
#: example's default size, on the card in this process and on the CPU in a
#: background process started before the first phase; ``{dir}`` is a
#: directory of the run's own.  The distributed sort runs one rank (one
#: card), in processes of its own (``torch.multiprocessing.spawn``).
EXAMPLES = (("torch_quickstart.py", ()), ("torch_net_pipeline.py", ()), ("torch_serve_lm.py", ()),
            ("torch_train_moe.py", ("--ckpt-dir", "{dir}/moe_ckpt")), ("torch_distributed_sort.py", ("--ranks", "1")))
#: Intra-op threads of a twin's CPU run: one each, three for the training
#: twin's 120 steps (about 170 s on one thread), so that every CPU run ends
#: while the card-bound phases before ``examples`` run.
EXAMPLE_CPU_THREADS = {"torch_train_moe.py": 3}
#: What two runs of a twin cannot repeat, masked before their lines are
#: compared: times and the rates and percentages made from them; the serve
#: twin's sampled tokens and the training twin's bf16 losses (the card and
#: the CPU draw and round differently); the checkpoint directory.
EXAMPLE_MASKS = (
    (r"-?\d+\.\d+% faster", "<pct> faster"), (r"\d+\.\d+s\b", "<s>"),
    (r"[\d,.]+ (keys|records|jobs)/sec", r"<rate> \1/sec"), (r"[\d.]+ tok/s", "<rate> tok/s"),
    (r"-> \[[\d, ]*\]", "-> <tokens>"), (r"(loss|aux) -?[\d.]+", r"\1 <x>"), (r"-> -?\d+\.\d+", "-> <x>"),
    (r"checkpoints at \S+:", "checkpoints at <dir>:"),
)

#: The sharded phase (M19) on one card, a one-rank NCCL process group: the
#: range sort at the pipeline phase's input with the reference example's
#: presort block (``examples/distributed_sort.py``) and capacity factor; the
#: pool's ``shard_map`` backend on the E2E configuration at ``small_n`` and at
#: ``--n``; the all_to_all MoE layer at granite-moe-3b-a800m's full width on
#: one 2,048-token sequence; ``gpipe`` and ``fsdp_gather`` at one rank.
SHARDED = dict(presort_block=256, capacity_factor=2.0, small_n=200_000)
SHARDED_MOE = dict(arch=MOE_ARCH, batch=1, seq=2048)
SHARDED_PP = dict(M=6, mb=8, d=1024)
#: The all_to_all MoE layer against ``moe_layer`` on the same bf16 weights:
#: the same dispatch and the same expert products, but a token's k = 8
#: returned rows (forward) and its k gradient rows (backward, in bf16) are
#: added in another order.  Each output and gradient leaf within k bf16
#: roundings (8 x 2^-8) of its largest magnitude; the CPU gives 0 for every
#: leaf but x's gradient (7.5e-3) at this shape.
MOE_A2A_LIMIT = 8 * 2**-8

#: The LM on a (data, model) mesh at one rank (the driver's machine has one
#: card, so a one-rank NCCL group): granite-moe-3b-a800m's train step at full
#: width and depth on the (1, 1) mesh against the step without a mesh;
#: Mistral-Nemo-12B at full width and depth through ``launch.serve --mesh
#: 1x1`` (its default prompts of 2-11 tokens); K6 with its lse at Mistral's
#: decode shape (``attention_rows``'s largest step) and the sequence-sharded
#: decode's math at tp = 4 on that cache; the vocab-parallel cross entropy at
#: Mistral's 131,072 vocabulary over four shards.  Since the recurrent kinds
#: run on a mesh, zamba2-1.2b and rwkv6-1.6b at full width and depth as well
#: (``recurrent``): their train steps at B 2 x 2,048 on the (1, 1) mesh
#: against no mesh, and each through ``launch.serve --mesh 1x1`` against the
#: CLI without a mesh.
LM_MESH = dict(
    train=dict(arch=MOE_ARCH, batch=4, seq=2048, steps=3, lr=3e-4),
    serve_arch=SERVE_ARCH, serve=dict(requests=8, slots=4, max_len=256, max_tokens=16),
    recurrent=dict(archs=(HYBRID_ARCH, RWKV_ARCH), batch=2, seq=2048, steps=3, lr=3e-4),
    k6=dict(q=(4, 32, 128), cache=(4, 4096, 8, 128), lengths=[1850, 1995, 1015, 860], chunks=4),
    ce=dict(vocab=131_072, batch=2, seq=2048, shards=4),
)
#: The kernels of the recurrent models at a rank's shapes at tp 4 (four
#: cards of a host; one card holds the shapes): K7 and K7b at rwkv6-1.6b's
#: training shape with 32 / 4 heads and K7 at its decode step (4 slots); the
#: WKV rank by rank (four calls on 8 heads each against the whole 32-head
#: call); K5 and K5b at zamba2-1.2b's shared block with 8 of its 32 heads;
#: K6 with its lse on one tp-4 chunk (the first, full, of S / 4 positions)
#: of zamba2's sequence-sharded cache at ``LM_MESH["k6"]``'s lengths.
TP4 = dict(tp=4, wkv=(4, 2048, 32), wkv_slots=4, attn=(4, 2048, 32, 64),
           k6=dict(q=(4, 32, 64), cache=(4, 4096, 32, 64), lengths=[1850, 1995, 1015, 860]))
#: The (1, 1) mesh runs the same operations as no mesh (no collective at one
#: rank).  The card's atomic adds (the MoE gathers' and the embedding's
#: backward) are not reproducible from run to run (they moved a first step's
#: gradient norm by 1.7e-5 relative), so both runs use torch's deterministic
#: algorithms (those adds sorted), where the two give the same bytes: every
#: arch of the phase has (granite, zamba2, rwkv6, whisper, llava).
LM_MESH_TRAIN_LIMIT = 0.0
#: The merged shards' mean cross entropy against one shard's and the
#: library's: f32 sums over 2^17 columns in other orders.
LM_MESH_CE_LIMIT = 1e-5
#: Context parallelism (the ``cp`` phase).  ``offsets``: K5 and K5b at a
#: query offset against their plain versions, B 2, S 300, T 70 rows a rank
#: (ragged against the 64-row tiles) at offsets 0, 64 (a tile), 100 (not a
#: tile) and 230 (the last rows: offset + T = S), 8 q heads over 2 kv heads.
#: ``starcoder2``: starcoder2-15b's attention at full width (48 q heads, 4 kv
#: heads, head dim 128, bf16) over T = 4,096 at tp 8, rank by rank on one
#: card (512 query rows a rank at offset 512 r against the whole K/V) against
#: the whole-T call, and its attention layer the same way; then the model
#: served whole through ``launch.serve`` (its 8 default requests).
CP = dict(offsets=dict(b=2, s=300, t=70, h=8, kv=2, offs=(0, 64, 100, 230)),
          arch="starcoder2-15b", tp=8, seq=4096)
#: The layer's output and every gradient, rank by rank against whole: the
#: ranks' dk/dv partials (context-parallel) or q/k/v cotangents (column
#: split) are rounded to bf16 and summed (as the collectives' backward sums
#: them), and autograd sums the eight ranks' bf16 weight gradients, so the
#: two differ by bf16 roundings (2^-9 relative each) of the partials: held
#: to a relative L2 error of 1e-2.
CP_LAYER_LIMIT = 1e-2

#: Inputs of the attention kernels' checks: q and k at 1.5 x a unit normal,
#: so the scores have a standard deviation of 2.25 at any head dim and the
#: softmax is peaked (about a dozen cache rows carry most of a 2000-row
#: row's weight); v a unit normal.  A cache block dropped from the merge or
#: a missing online-softmax rescale then moves the outputs by far more than
#: ``attn_limit``.
QK_SCALE = 1.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: The run's start on the host clock: every phase line carries ``t_s``, the
#: seconds since then when it was printed.
T0 = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, calls: int = 24, reps: int = 10) -> float:
    """Median device milliseconds per call of ``fn()``: ``calls`` calls
    captured in one CUDA graph, replayed ``reps`` times after a warm-up,
    CUDA events around each replay.  The host's Python and launch calls are
    out of the window, the launches' gaps on the card are in it: the time
    of a function of a few microseconds, which ``cuda_ms`` cannot see under
    its host cost."""
    import torch

    from repro_torch.kernels import build

    graph, _ = build.capture(lambda: [fn() for _ in range(calls)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    times.sort()
    return times[len(times) // 2]


def timings(kern, plain, lib) -> dict:
    """A kernels-line row's times: one eager call of the kernel, its plain
    version and the library call, and the kernel's and the library call's
    time per call of a CUDA graph."""
    return {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(lib),
            "graph_ms": graph_ms(kern), "library_graph_ms": graph_ms(lib)}


def exact(a, b) -> int:
    """Max absolute difference of two integer tensors (0 when equal)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype mismatch {tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/{b.dtype}")
    if torch.equal(a, b):
        return 0
    return int((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def log2(n: int) -> int:
    return n.bit_length() - 1


def k1_work(rows: int, b: int, itemsize: int) -> tuple[float, float]:
    """(bytes, compare-exchanges) of sorting ``rows`` rows of width ``b``."""
    s = log2(b)
    return 2.0 * rows * b * itemsize, rows * (b // 2) * s * (s + 1) / 2


def k2_work(p: int, b: int, itemsize: int) -> tuple[float, float]:
    """(bytes, merge steps) of the tournament over a (p, b) matrix: the n
    keys read once and written once; log2(p) rounds of one comparison per
    output key, n log2(p) in all -- the least a merge of p sorted rows
    needs, whatever the kernel's design."""
    n = p * b
    return 2.0 * n * itemsize, float(n * log2(p))


def k3_work(rows: int, n: int, itemsize: int) -> tuple[float, float]:
    """(bytes, compare-exchanges) of K3 over ``rows`` rows of ``n`` pairs:
    keys and int32 values read and written once; the full network."""
    s = log2(n)
    return 2.0 * rows * n * (itemsize + 4), rows * (n // 2) * s * (s + 1) / 2


def k4_work(rows: int, b: int, itemsize: int) -> tuple[float, float]:
    """(bytes, compare-exchanges) of K4 merging two (rows, b) halves: both
    read once, the (rows, 2b) output written once; log2(2b) stages of b
    pairs per row."""
    return 4.0 * rows * b * itemsize, float(rows * b * log2(2 * b))


def bound(bytes_: float, ce: float, itemsize: int, ops_per=OPS_PER_COMPARE_EXCHANGE) -> tuple[float, str]:
    """Least milliseconds on the card, and which of bytes and operations
    sets it."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_per[itemsize] * ce / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class StageClock:
    """Duck-typed null tracer that times the pipeline's top-level stages.

    It records nothing into the run (``enabled`` is False, as for the null
    tracer); spans of the ``pipeline``, ``hop`` and ``control`` categories
    synchronise the card on entry and exit so that their wall seconds are
    device time.  Two stages have no span of their own (the reference has
    none): ``pre_epoch``, from the start of the pipeline to its first epoch
    (flows, interleave, payload rows, the range table), and ``egress``, from
    the end of its last epoch to its end (the server pool).
    """

    enabled = False

    def __init__(self) -> None:
        import torch

        from repro_torch.obs.trace import NULL_TRACER

        self._null = NULL_TRACER
        self._torch = torch
        self.seconds: dict[str, float] = {}
        self._marks: dict[str, float] = {}

    def _now(self) -> float:
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        return time.perf_counter()

    def span(self, name: str, cat: str = "", tid: int = 0, **args):
        if cat not in ("pipeline", "hop", "control"):
            return self._null.span(name, cat, tid, **args)
        clock = self

        class _Span:
            def __enter__(self):
                self.t0 = clock._now()
                if name == "pipeline":
                    clock._marks = {"start": self.t0}
                elif name.startswith("epoch:") and "pre_epoch" not in clock.seconds:
                    clock.seconds["pre_epoch"] = self.t0 - clock._marks.get("start", self.t0)
                return self

            def __exit__(self, *exc):
                t1 = clock._now()
                clock.seconds[name] = t1 - self.t0
                if name.startswith("epoch:"):
                    clock._marks["epoch_end"] = t1
                elif name == "pipeline":
                    clock.seconds["egress"] = t1 - clock._marks.get("epoch_end", t1)
                return False

            def set(self, **kw):
                pass

        return _Span()

    def timed(self, name: str, cat: str = "", tid: int = 0, **args):
        return self._null.timed(name, cat, tid, **args)

    def instant(self, name: str, cat: str = "", tid: int = 0, **args) -> None:
        pass


class LargestShape:
    """Records the shape and dtype of the largest input a kernel wrapper was
    called with on the main path (what the kernel phase times); it copies no
    data, and launches are counted by the wrapper itself, unchanged."""

    def __init__(self, module, attr: str) -> None:
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.shape: tuple[int, ...] = ()
        self.dtype = None
        self.numel = -1

    def __call__(self, x, *rest, **kw):
        if x.numel() > self.numel:
            self.shape, self.dtype, self.numel = tuple(x.shape), x.dtype, x.numel()
        return self.orig(x, *rest, **kw)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)
        return False


def main_path_input(torch, gen, shape, dtype, *, sorted_rows: bool):
    """Fresh random rows at a main-path kernel shape: keys in the range the
    100M-key run gives the kernel (15-bit trace keys for K1; packed
    ``(key << 27) | row`` records, below 2^42, for K2), each row's ragged
    tail padded with the dtype max, rows sorted for K2.  K1's network is
    data-oblivious; K2's merge moves the same bytes whatever the keys, and
    only its searches depend on them."""
    rows, b = shape
    hi = (1 << 42) if dtype == torch.int64 and sorted_rows else 1 << 15
    x = torch.randint(0, hi, shape, dtype=dtype, device="cuda", generator=gen)
    # a bucket of width b holds runs longer than b/2 (K2); K1 rows end anywhere
    lo = b // 2 + 1 if sorted_rows else 1
    cut = torch.randint(lo, b + 1, (rows, 1), device="cuda", generator=gen)
    x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, torch.iinfo(dtype).max)
    if sorted_rows:
        x = torch.sort(x, dim=1).values
    return x.contiguous()


def k1_rows(torch, gen, rows: int, b: int, dtype, kind: str):
    """A K1 input: ``ragged`` keys with many ties and a random tail of each
    row padded with the dtype max, ``all_equal`` rows, or ``extremes``
    (a quarter each of the dtype's min and max among the ties)."""
    info = torch.iinfo(dtype)
    if kind == "all_equal":
        return torch.full((rows, b), -7, dtype=dtype, device="cuda")
    x = torch.randint(-3, 4, (rows, b), dtype=dtype, device="cuda", generator=gen)
    if kind == "extremes":
        pick = torch.randint(0, 4, (rows, b), device="cuda", generator=gen)
        return torch.where(pick == 0, info.min, torch.where(pick == 1, info.max, x))
    cut = torch.randint(0, b + 1, (rows, 1), device="cuda", generator=gen)
    return torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, info.max)


def phase_k1(bt, torch, gen) -> None:
    """K1 at every width 2..4096, int32 and int64: row counts that leave a
    warp or a block part-filled (1, 3, 5, 1000, and one that ends inside the
    third block where a block holds more than a row), the three key kinds of
    ``k1_rows``, and a contiguous view one key past a 16-byte boundary (the
    kernel's key-by-key path); each against the plain network and
    ``torch.sort``."""
    checked = 0
    worst = 0
    for dtype in (torch.int32, torch.int64):
        for b in (1 << e for e in range(1, 13)):
            tile = bt.row_sort_items(b) * bt.ROW_SORT_THREADS
            cases = [(rows, kind, False) for rows in (1, 3, 5, 1000, (2 * tile + tile // 2) // b + 1)
                     for kind in ("ragged", "all_equal", "extremes")]
            for rows, kind, shifted in cases + [(37, "ragged", True)]:
                x = k1_rows(torch, gen, rows, b, dtype, kind).contiguous()
                if shifted:
                    x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(rows, b)
                    if x.data_ptr() % 16 == 0 or not x.is_contiguous():
                        fail("K1's shifted view is 16-byte aligned")
                got = bt.sort_rows(x)
                want = bt.sort_rows_plain(x)
                worst = max(worst, exact(got, want))
                if not torch.equal(got, torch.sort(x, dim=1).values):
                    fail(f"K1 disagrees with torch.sort at {dtype} {rows}x{b} {kind} shifted={shifted}")
                checked += 1
    torch.cuda.synchronize()
    if worst:
        fail(f"K1 differs from sort_rows_plain by {worst}")
    emit({"phase": "k1", "cases": checked, "max_abs_err": worst})


def phase_k2(bt, torch, gen) -> None:
    """Random sorted rows with ragged pads (duplicate keys and pad runs in
    every row), all-pad rows and all-equal keys; one pair of 2^22-wide rows;
    rows at least a tile wide (the first round starts in device memory); the
    sort path's largest bucket.  Exact against ``tournament_plain`` and
    ``torch.sort``; each shape's kernel launches per call (1 + log2(P*B /
    tile) for B under the 16,384-key tile, log2(P) from it), the kernel's
    own count held to the Python plan."""
    from repro_torch.kernels import build

    checked = 0
    worst = 0
    plan = {}
    count_fn = build.function("tournament", "tournament_launches")
    cases = [(p, b, "random") for p, b in ((2, 2), (2, 4096), (1024, 64), (64, 1024), (4096, 2),
                                           (1 << 17, 64), (1 << 16, 128), (2, 1 << 22),
                                           (8, 1 << 15), (4, 1 << 16))]
    cases += [(64, 256, "all_pad"), (64, 256, "all_equal"), (1 << 15, 64, "all_equal"), (4, 1 << 16, "all_pad")]
    for dtype in (torch.int32, torch.int64):
        hi = torch.iinfo(dtype).max
        for p, b, kind in cases:
            if kind == "all_pad":
                x = torch.full((p, b), hi, dtype=dtype, device="cuda")
            elif kind == "all_equal":
                x = torch.full((p, b), 5, dtype=dtype, device="cuda")
            else:
                x = torch.randint(0, 1 << 30, (p, b), dtype=dtype, device="cuda", generator=gen)
                cut = torch.randint(1, b + 1, (p, 1), device="cuda", generator=gen)
                x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, hi)
                x = torch.sort(x, dim=1).values.contiguous()
            got = bt.merge_tournament(x)
            want = bt.tournament_plain(x)
            worst = max(worst, exact(got, want))
            if not torch.equal(got, torch.sort(x.reshape(-1)).values):
                fail(f"K2 disagrees with torch.sort at {dtype} {p}x{b} ({kind})")
            launches = count_fn(p, b)
            if launches != bt.tournament_launches(p, b):
                fail(f"K2 plans {launches} launches at {p}x{b}, the Python plan {bt.tournament_launches(p, b)}")
            plan[f"{p}x{b}"] = launches
            checked += 1
            del x, got, want
    torch.cuda.synchronize()
    if worst:
        fail(f"K2 differs from tournament_plain by {worst}")
    emit({"phase": "k2", "cases": checked, "max_abs_err": worst,
          "largest_keys": max(p * b for p, b, _ in cases), "tile": bt.TOURNAMENT_TILE,
          "launches_per_call": plan})


def dispatch_keys(torch, gen, rows: int, n: int, real: int, dtype, experts: int = 40):
    """K3's input as the MoE dispatch builds it: the composite keys
    ``expert * real + index`` of ``real`` assignments, padded to ``n`` with
    the dtype max; values ``arange(n)``."""
    eid = torch.randint(0, experts, (rows, real), device="cuda", generator=gen, dtype=dtype)
    keys = torch.full((rows, n), torch.iinfo(dtype).max, dtype=dtype, device="cuda")
    keys[:, :real] = eid * real + torch.arange(real, device="cuda", dtype=dtype)
    vals = torch.arange(n, dtype=torch.int32, device="cuda").repeat(rows, 1)
    return keys, vals.contiguous()


def check_k3(bt, torch, keys, vals) -> int:
    """K3 against its plain version, keys and values: exact, or fail."""
    gk, gv = bt.sort_rows_kv(keys, vals)
    wk, wv = bt.sort_rows_kv_plain(keys, vals)
    err = max(exact(gk, wk), exact(gv, wv))
    if err or not torch.equal(gk, torch.sort(keys, dim=1).values):
        fail(f"K3 differs from its plain version at {keys.dtype} {tuple(keys.shape)}")
    return err


def k3_launches(bt, keys, vals) -> int:
    """K3's kernel launches in one call on ``keys``/``vals``: the kernel nodes
    of a CUDA graph of that call; fails unless they are the Python plan's."""
    from repro_torch.kernels import build

    n = keys.shape[1]
    launches = build.graph_kernel_launches(lambda: bt.sort_rows_kv(keys, vals))
    if launches != len(bt.row_sort_kv_plan(n)):
        fail(f"K3 launched {launches} kernels at n={n}, the Python plan {len(bt.row_sort_kv_plan(n))}")
    return launches


def phase_k3(bt, torch, gen) -> None:
    """The MoE path's shapes (the 1,963-token prefill's 15,704 assignments
    padded to 16,384; the decode step's 32), the reference tests' shapes
    (unique keys; duplicate keys in four rows), int64 keys, and duplicate
    keys at every kind of launch: one chunk (64 .. 2,048 pairs), strided
    launches (4,096 .. 2^15), device-memory passes (2^16 .. 2^20).  Each
    width's launches per call, measured on its first case and held to
    ``row_sort_kv_plan``."""
    cases = []
    for dtype in (torch.int32, torch.int64):
        cases += [dispatch_keys(torch, gen, 1, 16_384, 15_704, dtype),
                  dispatch_keys(torch, gen, 1, 32, 32, dtype),
                  dispatch_keys(torch, gen, 2, 1 << 16, 60_000, dtype)]
        for n in (8, 128, 512):
            perm = torch.randperm(n, device="cuda", generator=gen).to(dtype)[None, :]
            cases.append((perm, (perm * 7 + 1).to(torch.int32)))
        for rows, n in ((4, 16), (4, 256), (4, 1 << 16), (3, 64), (2, 2048), (4, 4096), (1, 1 << 15),
                        (2, 1 << 17), (1, 1 << 20)):
            keys = torch.randint(0, 7 if n < 4096 else 1000, (rows, n), dtype=dtype, device="cuda",
                                 generator=gen)
            cases.append((keys, torch.arange(rows * n, dtype=torch.int32, device="cuda").reshape(rows, n)))
    worst = max(check_k3(bt, torch, k, v) for k, v in cases)
    torch.cuda.synchronize()
    by_width = {}
    for k, v in cases:
        by_width.setdefault(k.shape[1], (k, v))
    emit({"phase": "k3", "cases": len(cases), "max_abs_err": worst, "widest": max(by_width),
          "chunk": bt.ROW_SORT_KV_CHUNK,
          "launches_per_call": {str(n): k3_launches(bt, *by_width[n]) for n in sorted(by_width)}})


def sorted_halves(torch, gen, rows: int, b: int, dtype):
    """Two (rows, b) matrices of sorted rows: packed int64 records below 2^42
    (the K2 bucket's keys), int32 keys, or float32 normals."""
    def one():
        if dtype == torch.float32:
            x = torch.randn((rows, b), device="cuda", generator=gen)
        else:
            hi = (1 << 42) if dtype == torch.int64 else (1 << 30)
            x = torch.randint(0, hi, (rows, b), dtype=dtype, device="cuda", generator=gen)
        return torch.sort(x, dim=1).values.contiguous()
    return one(), one()


def check_k4(bt, torch, a, b) -> float:
    """K4 against its plain version: exact, or fail."""
    got = bt.merge_rows(a, b)
    want = bt.merge_rows_plain(a, b)
    err = 0 if torch.equal(got, want) else (got.double() - want.double()).abs().max().item()
    if err or not torch.equal(got, torch.sort(torch.cat([a, b], dim=1), dim=1).values):
        fail(f"K4 differs from its plain version at {a.dtype} {tuple(a.shape)}")
    return err


def phase_k4(bt, torch, gen) -> None:
    """The reference tests' (8, n) shapes, n in 8, 128, 1024; the timed shape
    (two 65,536 x 64 halves); rows of 2^14 and 2^17 elements, whose stages
    with j >= 4096 run in device memory."""
    cases = 0
    worst = 0
    for dtype in (torch.int32, torch.int64, torch.float32):
        for rows, b in ((8, 8), (8, 128), (8, 1024), (3, 16), (65_536, 64), (4, 1 << 13), (2, 1 << 16)):
            worst = max(worst, check_k4(bt, torch, *sorted_halves(torch, gen, rows, b, dtype)))
            cases += 1
    torch.cuda.synchronize()
    emit({"phase": "k4", "cases": cases, "max_abs_err": worst})


def bitonic_rows(torch, bt, gen, k3_shape, k3_dtype, k3_real: int, launches) -> list[dict]:
    """The kernels-line rows of K3 (at the MoE path's largest row) and K4 (on
    no path: at the shape of one K2 round on the sort path's largest bucket,
    two 65,536 x 64 int64 halves)."""
    rows = []
    keys, vals = dispatch_keys(torch, gen, k3_shape[0], k3_shape[1], k3_real, k3_dtype)
    err = check_k3(bt, torch, keys, vals)
    b_bytes, ce = k3_work(keys.shape[0], keys.shape[1], keys.element_size())
    b_ms, b_by = bound(b_bytes, ce, keys.element_size(), OPS_PER_KV_COMPARE_EXCHANGE)
    # the decode step's row (1 x 32): 2,048 of the run's 2,304 launches
    dk, dv = dispatch_keys(torch, gen, 1, 32, 32, k3_dtype)
    err = max(err, check_k3(bt, torch, dk, dv))
    d_bytes, d_ce = k3_work(1, 32, dk.element_size())
    d_ms, d_by = bound(d_bytes, d_ce, dk.element_size(), OPS_PER_KV_COMPARE_EXCHANGE)
    def timed(k, v) -> dict:
        return timings(lambda: bt.sort_rows_kv(k, v), lambda: bt.sort_rows_kv_plain(k, v),
                       lambda: torch.sort(k, dim=1, stable=True))

    rows.append({
        "name": "row_sort_kv", "route": "cuda", "source": "src/repro_torch/kernels/csrc/row_sort_kv.cu",
        "replaces": "src/repro/kernels/bitonic.py:201", "launches": launches["row_sort_kv"],
        "max_abs_err": err, "shape": list(keys.shape), "dtype": str(keys.dtype).replace("torch.", ""),
        "launches_per_call": k3_launches(bt, keys, vals),
        **timed(keys, vals), "bound_ms": b_ms, "bound_by": b_by,
        "decode": {"shape": list(dk.shape), "launches_per_call": k3_launches(bt, dk, dv),
                   **timed(dk, dv), "bound_ms": d_ms, "bound_by": d_by},
    })
    a, b = sorted_halves(torch, gen, 65_536, 64, torch.int64)
    err = check_k4(bt, torch, a, b)
    b_bytes, ce = k4_work(a.shape[0], a.shape[1], a.element_size())
    b_ms, b_by = bound(b_bytes, ce, a.element_size())
    rows.append({
        "name": "merge_rows", "route": "cuda", "source": "src/repro_torch/kernels/csrc/merge_rows.cu",
        "replaces": "src/repro/kernels/bitonic.py:230", "launches": launches["merge_rows"],
        "max_abs_err": err, "shape": [list(a.shape), list(b.shape)], "dtype": "int64",
        **timings(lambda: bt.merge_rows(a, b), lambda: bt.merge_rows_plain(a, b),
                  lambda: torch.sort(torch.cat([a, b], dim=-1), dim=-1)),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    del keys, vals, dk, dv, a, b
    torch.cuda.empty_cache()
    return rows


def parity_small(torch, np, run_pipeline, random_trace) -> list[int]:
    """The card's run against the plain versions on the CPU, column by column."""
    sizes = [20_000, 300_000]
    for n in sizes:
        vals = random_trace(n, seed=1)
        payload = np.stack([vals * 7 + 3, np.arange(n)], axis=1).astype(np.int64)
        cols = []
        for dev in ("cuda", "cpu"):
            r = run_pipeline(vals, payload=payload, seed=1, device=dev, **E2E)
            d = r.to_numpy()
            cols.append(d)
        a, b = cols
        for key in ("output", "payload_row_order", "sorted_payload"):
            if not np.array_equal(a[key], b[key]):
                fail(f"card and CPU disagree on {key} at n={n}")
        if a["passes"] != b["passes"]:
            fail(f"card and CPU disagree on passes at n={n}")
        for c in ("values", "flow_id", "seq", "segment_id", "row_index"):
            if not np.array_equal(a["delivered"][c], b["delivered"][c]):
                fail(f"card and CPU disagree on delivered {c} at n={n}")
        for sa, sb in zip(a["hop_stats"], b["hop_stats"]):
            for f, v in sa.items():
                same = np.array_equal(v, sb[f]) if isinstance(v, np.ndarray) else v == sb[f]
                if not same:
                    fail(f"card and CPU disagree on hop stat {f} at n={n}")
        if not np.array_equal(a["output"], np.sort(vals)):
            fail(f"output is not the sorted input at n={n}")
    return sizes


GRAPHS = {"single": {}, "leaf_spine": {"num_leaves": 4}, "tree": {"branching": 2, "height": 3}}


def same_run(np, a: dict, b: dict) -> str | None:
    """The first field in which two ``PipelineResult.to_numpy()`` differ:
    output, passes, payload, the delivered wire and every hop stat's
    scalars and segment loads (the device engine, like the reference's,
    leaves the per-run arrays of ``HopStats`` out)."""
    for key in ("output", "payload_row_order", "sorted_payload"):
        if (a[key] is None) != (b[key] is None) or (a[key] is not None and not np.array_equal(a[key], b[key])):
            return key
    if a["passes"] != b["passes"] or a["server_keys"] != b["server_keys"]:
        return "passes"
    for c in ("values", "flow_id", "seq", "segment_id", "row_index"):
        x, y = a["delivered"][c], b["delivered"][c]
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            return f"delivered {c}"
    if len(a["hop_stats"]) != len(b["hop_stats"]):
        return "hop count"
    for sa, sb in zip(a["hop_stats"], b["hop_stats"]):
        for f in ("name", "arrivals", "load_imbalance", "emitted_runs", "mean_run_len", "recirculations"):
            if sa[f] != sb[f]:
                return f"hop stat {f}"
        if not np.array_equal(sa["segment_loads"], sb["segment_loads"]):
            return "hop stat segment_loads"
    return None


def parity_device_small(torch, np, run_pipeline, random_trace) -> list[dict]:
    """``engine="device"`` on the card against ``engine="fused"`` on the card
    and ``engine="device"`` on the CPU, on every graph kind, with and
    without a payload."""
    n = 20_000
    vals = random_trace(n, seed=2)
    payload = np.stack([vals * 7 + 3, np.arange(n)], axis=1).astype(np.int64)
    cells = []
    for graph, kw in GRAPHS.items():
        for with_payload in (False, True):
            cfg = dict(E2E, topology=graph, **kw)
            if graph != "tree":
                cfg.pop("branching"), cfg.pop("height")
            runs = {}
            for engine, dev in (("device", "cuda"), ("fused", "cuda"), ("device", "cpu")):
                r = run_pipeline(vals, payload=payload if with_payload else None, seed=2,
                                 engine=engine, device=dev, **cfg)
                runs[(engine, dev)] = r.to_numpy()
            card = runs[("device", "cuda")]
            for other in (("fused", "cuda"), ("device", "cpu")):
                diff = same_run(np, card, runs[other])
                if diff:
                    fail(f"device engine on the card and {other} disagree on {diff} ({graph}, payload {with_payload})")
            if not np.array_equal(card["output"], np.sort(vals)):
                fail(f"device engine output is not the sorted input ({graph})")
            cells.append({"graph": graph, "payload": with_payload, "n": n, "hops": len(card["hop_stats"])})
    return cells


def phase_pipeline_device(torch, np, args, run_pipeline, random_trace, values_d, payload_d,
                          fused_out, fused_payload) -> dict:
    """The device epoch at the full size: first call, then replays."""
    from repro_torch.data.traces import trace_max_value
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import build
    from repro_torch.net import device_epoch as de

    parity = parity_device_small(torch, np, run_pipeline, random_trace)
    de.clear_program_cache()
    torch.cuda.empty_cache()
    n = int(values_d.numel())
    want = torch.sort(values_d, stable=True)

    def run():
        clock = StageClock()
        de.reset_transfer_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_pipeline(values_d, payload=payload_d, max_value=trace_max_value("random"),
                           seed=args.seed, tracer=clock, engine="device", device="cuda", **E2E)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not torch.equal(res.output, want.values) or not torch.equal(res.output, fused_out):
            fail("device engine output differs from torch.sort / the fused run")
        if not torch.equal(res.payload_row_order, want.indices) or not torch.equal(res.sorted_payload, fused_payload):
            fail("device engine payload does not follow its keys")
        transfers = dict(de.TRANSFER_COUNTS)
        if transfers != {"to_device": 0, "to_host": 1}:
            fail(f"device epoch transfers {transfers}, want no copy in and one read back")
        stages = dict(clock.seconds, server_makespan=res.server_seconds, per_server=res.per_server_seconds,
                      pool_merge=res.pool_merge_seconds)
        return sec, stages, res

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with LargestShape(bt, "sort_rows") as k1_in:
        first_s, first_stages, res = run()
    first_launches = dict(build.LAUNCHES)
    reserved = torch.cuda.memory_reserved()
    peak_first = torch.cuda.max_memory_allocated()
    passes = res.passes
    del res
    (prog,) = de._PROGRAM_CACHE.values()
    nodes = build.graph_kernel_nodes(prog.graph, ["row_sort_kernel", "tile_merge", "merge_round"])
    if nodes["row_sort_kernel"] != E2E_HOPS:
        fail(f"the captured epoch holds {nodes['row_sort_kernel']} K1 nodes, want one per hop ({E2E_HOPS})")
    if nodes["tile_merge"] or nodes["merge_round"]:
        fail("the captured epoch holds K2 nodes")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    replays = []
    for _ in range(3):
        sec, stages, res = run()
        replays.append({"s": sec, "stages": stages})
        del res
    replay_launches = dict(build.LAUNCHES)
    if replay_launches["row_sort"]:
        fail("a replay launched K1 outside the graph")
    if replay_launches["tournament"] < 1:
        fail("K2 never launched at the device run's egress")
    peak = torch.cuda.max_memory_allocated()
    med = sorted(r["s"] for r in replays)[len(replays) // 2]
    if args.profile:
        emit({"phase": "pipeline_device_profile", **profiled(torch, lambda: run()[2])[0]})
    emit({"phase": "pipeline_device", "n": n, "config": E2E, "parity_small": parity,
          "first_call_s": first_s, "first_call_stage_s": first_stages,
          "replay_s": [r["s"] for r in replays], "replay_stage_s": [r["stages"] for r in replays],
          "keys_per_s": n / med, "passes": passes,
          "peak_device_bytes_first_call": peak_first, "peak_device_bytes_replays": peak,
          "memory_reserved_after_capture": reserved,
          "transfers_per_epoch": {"to_device": 0, "to_host": 1},
          "k1_graph_nodes_per_epoch": nodes["row_sort_kernel"], "graph_kernel_nodes": nodes["all"],
          "k1_input": {"shape": list(k1_in.shape), "dtype": str(k1_in.dtype).replace("torch.", "")},
          "launches_first_call": {k: first_launches[k] for k in ("row_sort", "tournament")},
          "launches_replays": {k: replay_launches[k] for k in ("row_sort", "tournament")},
          "epochs_replayed": len(replays)})
    del want, prog
    de.clear_program_cache()
    torch.cuda.empty_cache()
    return {"k1_shape": k1_in.shape, "k1_dtype": k1_in.dtype, "k1_nodes": nodes["row_sort_kernel"],
            "epochs": 1 + len(replays)}


#: The reference's ``--scenarios`` rows (``net_bench.py`` ``BENCH_SCENARIOS``)
#: on the ``E2E`` fabric with sampled ranges, as ``(scenario, keys, flows)``:
#: ``drifting`` at the paper's trace size, ``adversarial_skew`` at the
#: reference's end-to-end size (a cut for the control plane's per-packet
#: host loop).  Eight flows are eight contiguous shards of the trace, so the
#: wire carries every drift phase at once; one more row feeds ``drifting``
#: through a single flow, whose wire does drift, at the end-to-end size.
#: Then ``drifting`` on the device engine at that size, whose sampled epochs
#: each build and capture a program of their own.
SCENARIO_ROWS = (("drifting", 100_000_000, 8), ("adversarial_skew", 10_000_000, 8),
                 ("drifting", 10_000_000, 1))
SCENARIO_DEVICE_N = 10_000_000

#: The reference's network sweep (``net_bench.py`` ``NETWORK_BENCH``,
#: ``NETWORK_RATES`` x ``NETWORK_BUFFERS``): one switch, 16 x 64, 256-key
#: packets, 8 flows, oracle ranges, 2% wire loss under the drop policy, at
#: its ``--network-n`` default of 1M keys (a cut: the timing model is a
#: per-packet host event loop).  Rate (0, 1) is unthrottled, buffer 0
#: unbounded.  One more cell runs the backpressure policy on a lossless,
#: slow, one-slot link.
NETWORK_N = 1_000_000
NETWORK = dict(topology="single", num_segments=16, segment_length=64, payload_size=256,
               num_flows=8, k=10, range_mode="oracle")
NETWORK_RATES = ((0, 1), (8, 1), (2, 1), (1, 1), (1, 4), (1, 16), (1, 64))
NETWORK_BUFFERS = (0, 4, 1)
NETWORK_LOSS = 0.02


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _reset_peak(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _peak(torch):
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None


def _reserved(torch):
    return torch.cuda.memory_reserved() if torch.cuda.is_available() else None


def timed_run(torch, run_pipeline, values, **kw):
    """One ``run_pipeline`` call between two synchronisations: the result
    and its wall seconds."""
    _sync(torch)
    t0 = time.perf_counter()
    res = run_pipeline(values, **kw)
    _sync(torch)
    return res, time.perf_counter() - t0


def phase_pipeline_sampled(torch, np, run_pipeline, dev: str, rows_in, device_n: int,
                           seed: int) -> None:
    """The adaptive control plane on the card: each scenario row with
    sampled, static and oracle ranges on the same keys (fused engine), then
    ``drifting`` with sampled ranges on the device engine against the fused
    run at that size."""
    from repro_torch.data.scenarios import SCENARIOS, scenario_max_value
    from repro_torch.kernels import build
    from repro_torch.net import device_epoch as de

    cfg = {k: v for k, v in E2E.items() if k != "range_mode"}
    rows = []
    for name, n, flows in rows_in:
        values = torch.from_numpy(SCENARIOS[name](n, seed=seed)).to(dev)
        maxv = scenario_max_value(name)
        want = torch.sort(values).values
        row = {"scenario": name, "n": n, "num_flows": flows}
        for mode in ("sampled", "static", "oracle"):
            clock = StageClock()
            build.reset_launches()
            _reset_peak(torch)
            res, sec = timed_run(torch, run_pipeline, values, max_value=maxv, seed=seed,
                                 tracer=clock, range_mode=mode, device=dev,
                                 **dict(cfg, num_flows=flows))
            launches = dict(build.LAUNCHES)
            if not torch.equal(res.output, want):
                fail(f"{name} with {mode} ranges: output differs from torch.sort")
            # K1 once per hop of every epoch that received keys (through one
            # flow, the leaves of the other three ingress groups get none).
            fed = sum(1 for st in res.hop_stats if st.arrivals)
            if dev == "cuda" and (launches["row_sort"] != fed or launches["tournament"] < 1):
                fail(f"{name} with {mode} ranges: launches {launches}, want K1 once per "
                     f"hop with keys ({fed} over {res.num_epochs} epochs) and K2 at least once")
            entry = {"run_pipeline_s": sec, "keys_per_s": n / sec, "num_epochs": res.num_epochs,
                     "peak_device_bytes": _peak(torch), "server_imbalance": res.server_imbalance,
                     "server_keys": res.server_keys, "server_makespan_s": res.server_seconds,
                     "passes_total": sum(res.passes), "stage_s": dict(clock.seconds),
                     "hops_with_keys": fed,
                     "launches": {k: launches[k] for k in ("row_sort", "tournament")}}
            if mode == "sampled":
                entry["split_epochs_s"] = clock.seconds["control:split_epochs"]
                entry["ranges_history"] = [r.cpu().tolist() for r in res.ranges_history]
                if name == "drifting" and res.num_epochs < (2 if flows > 1 else 3):
                    fail(f"drifting keys through {flows} flow(s) gave {res.num_epochs} epochs")
            row[mode] = entry
            del res
        rows.append(row)
        del values, want

    # drifting on the device engine, through 8 flows and through one: each
    # epoch's range table is a new program key, so each epoch warms up and
    # captures a program of its own.
    values = torch.from_numpy(SCENARIOS["drifting"](device_n, seed=seed)).to(dev)
    maxv = scenario_max_value("drifting")
    device_rows = []
    for flows in (8, 1):
        kw = dict(cfg, num_flows=flows, range_mode="sampled", max_value=maxv, seed=seed, device=dev)
        fused, fused_s = timed_run(torch, run_pipeline, values, engine="fused", **kw)
        fused_np = fused.to_numpy()
        del fused
        de.clear_program_cache()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        reserved = []
        orig = de.run_graph_device

        def per_epoch(*a, **k):
            out = orig(*a, **k)
            reserved.append(_reserved(torch))
            return out

        de.run_graph_device = per_epoch
        try:
            first, first_s = timed_run(torch, run_pipeline, values, engine="device", **kw)
            first_np = first.to_numpy()
            del first
            again, again_s = timed_run(torch, run_pipeline, values, engine="device", **kw)
            again_np = again.to_numpy()
            del again
        finally:
            de.run_graph_device = orig
        programs = len(de._PROGRAM_CACHE)
        for what, got in (("first call", first_np), ("replay", again_np)):
            diff = same_run(np, got, fused_np)
            if diff:
                fail(f"sampled device engine ({what}, {flows} flows) and fused engine disagree on {diff}")
            if got["num_epochs"] != fused_np["num_epochs"] or any(
                    not np.array_equal(a, b) for a, b in zip(got["ranges_history"], fused_np["ranges_history"])):
                fail(f"sampled device engine ({what}, {flows} flows) epochs differ from the fused run's")
        epochs = first_np["num_epochs"]
        device_rows.append({"scenario": "drifting", "n": device_n, "num_flows": flows,
                            "num_epochs": epochs, "epoch_keys": [int(c) for c in np.bincount(
                                first_np["delivered"]["segment_id"] // cfg["num_segments"])],
                            "programs_cached": programs, "fused_s": fused_s,
                            "first_call_s": first_s, "replay_s": again_s,
                            "memory_reserved_after_each_epoch": reserved[:epochs],
                            "memory_reserved_after_replays": reserved[epochs:]})
        del first_np, again_np, fused_np
        de.clear_program_cache()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    del values
    emit({"phase": "pipeline_sampled", "config": cfg, "scenarios": rows, "device_engine": device_rows})


def phase_pipeline_observed(torch, np, run_pipeline, dev: str, values_d, payload_d, fused_out,
                            fused_payload, seed: int, rounds: int = 2) -> None:
    """The reference's telemetry modes (off, a recording Tracer with a
    MetricsRegistry, and INT stamps on top) on the E2E cell, interleaved:
    every mode's output, passes, hop stat scalars and delivered wire must
    equal the unobserved run's.  Then the device engine traced."""
    import os
    import tempfile

    from repro_torch.data.traces import trace_max_value
    from repro_torch.kernels import build
    from repro_torch.net import device_epoch as de
    from repro_torch.obs import MetricsRegistry, Tracer

    n = int(values_d.numel())
    kw = dict(payload=payload_d, max_value=trace_max_value("random"), seed=seed, device=dev, **E2E)
    cols = ("values", "flow_id", "seq", "segment_id", "row_index")
    base = None
    times: dict[str, list[float]] = {"off": [], "traced": [], "int": []}
    info: dict[str, dict] = {}
    for _ in range(rounds):
        for mode in times:
            tracer = None if mode == "off" else Tracer()
            metrics = None if mode == "off" else MetricsRegistry()
            build.reset_launches()
            _reset_peak(torch)
            res, sec = timed_run(torch, run_pipeline, values_d, tracer=tracer, metrics=metrics,
                                 int_telemetry=mode == "int", **kw)
            launches = dict(build.LAUNCHES)
            times[mode].append(sec)
            if dev == "cuda" and (launches["row_sort"] != E2E_HOPS or launches["tournament"] < 1):
                fail(f"observed mode {mode}: launches {launches}")
            if not torch.equal(res.output, fused_out) or not torch.equal(res.sorted_payload, fused_payload):
                fail(f"observed mode {mode}: output differs from the pipeline phase's")
            stats = [(st.name, st.arrivals, st.load_imbalance, st.emitted_runs, st.mean_run_len,
                      st.recirculations) for st in res.hop_stats]
            if base is None:
                base = {"passes": res.passes, "stats": stats,
                        "delivered": {c: getattr(res.delivered, c) for c in cols}}
            else:
                if res.passes != base["passes"] or stats != base["stats"]:
                    fail(f"observed mode {mode}: passes or hop stats differ from the unobserved run")
                for c in cols:
                    if not torch.equal(getattr(res.delivered, c), base["delivered"][c]):
                        fail(f"observed mode {mode}: delivered {c} differs from the unobserved run")
            if mode != "off" and mode not in info:
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "trace.json")
                    t0 = time.perf_counter()
                    tracer.dump(path)
                    dump_s = time.perf_counter() - t0
                    size = os.path.getsize(path)
                entry = {"spans": len(tracer.spans), "instants": len(tracer.instants),
                         "chrome_trace_bytes": size, "chrome_trace_dump_s": dump_s,
                         "metrics": sum(len(v) for kind in res.telemetry.values()
                                        if isinstance(kind, dict) for v in kind.values())}
                if mode == "int":
                    meta = res.delivered.int_meta
                    if meta is None or meta.depth != 3:
                        fail("INT run: the delivered wire lacks its 3-deep INT stack")
                    entry["int_depth"] = meta.depth
                    entry["int_summary_rows"] = len(res.telemetry["int"])
                    entry["peak_device_bytes"] = _peak(torch)
                    entry["int_stack_bytes"] = 3 * n * meta.depth * 8
                info[mode] = entry
            del res, tracer, metrics
    del base
    best = {m: min(v) for m, v in times.items()}

    # The device engine, traced: the program with taps (its own key).
    de.clear_program_cache()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    tracer = Tracer()
    de.reset_transfer_counts()
    _reset_peak(torch)
    res, dev_s = timed_run(torch, run_pipeline, values_d, tracer=tracer, engine="device", **kw)
    transfers = dict(de.TRANSFER_COUNTS)
    if not torch.equal(res.output, fused_out) or not torch.equal(res.sorted_payload, fused_payload):
        fail("traced device engine: output differs from the unobserved runs")
    if len(tracer.find(cat="hop")) != E2E_HOPS or any(st.ship_emission is None for st in res.hop_stats):
        fail("traced device engine: the taps did not replay every hop")
    device = {"s": dev_s, "transfers": transfers, "spans": len(tracer.spans),
              "peak_device_bytes": _peak(torch), "memory_reserved": _reserved(torch),
              "metrics": sum(len(v) for kind in res.telemetry.values() for v in kind.values())}
    del res, tracer
    de.clear_program_cache()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    emit({"phase": "pipeline_observed", "n": n, "config": E2E, "payload_cols": 2, "rounds": rounds,
          "seconds": times, "best_s": best,
          "traced_over_off": best["traced"] / best["off"], "int_over_off": best["int"] / best["off"],
          "traced": info["traced"], "int": info["int"], "device_traced": device})


def phase_pipeline_network(torch, np, run_pipeline, dev: str, n: int, seed: int) -> None:
    """The reference's network sweep: every (rate, buffer) cell under 2%
    wire loss (drop policy) and one backpressure cell, each byte-identical
    to the timeless lossless run; the timing model's host seconds beside
    the pipeline's."""
    from repro_torch.data.traces import random_trace, trace_max_value
    from repro_torch.net import timing
    from repro_torch.net.timing import LinkSpec, NetworkConfig

    values = torch.from_numpy(random_trace(n, seed=seed)).to(dev)
    kw = dict(NETWORK, max_value=trace_max_value("random"), seed=seed, device=dev)
    ref, ref_s = timed_run(torch, run_pipeline, values, **kw)
    if not torch.equal(ref.output, torch.sort(values).values):
        fail("network phase: the timeless run is not sorted")
    model_s = [0.0]
    orig = timing.simulate_link

    def clocked(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        model_s[0] += time.perf_counter() - t0
        return out

    cells = [(numer, denom, buf, "drop", NETWORK_LOSS) for numer, denom in NETWORK_RATES
             for buf in NETWORK_BUFFERS] + [(1, 4, 1, "backpressure", 0.0)]
    rows = []
    timing.simulate_link = clocked
    try:
        for numer, denom, buf, policy, loss in cells:
            net = NetworkConfig(
                link=LinkSpec(latency=2, rate_numer=numer or None, rate_denom=denom,
                              buffer_packets=buf or None, policy=policy, loss_rate=loss),
                switch_latency=1, seed=seed)
            model_s[0] = 0.0
            res, sec = timed_run(torch, run_pipeline, values, network=net, **kw)
            rep = res.network
            if not torch.equal(res.output, ref.output) or res.passes != ref.passes:
                fail(f"network cell rate {numer}/{denom} buffer {buf} {policy}: output differs "
                     "from the lossless run")
            if policy == "drop" and rep.drops != rep.retransmits:
                fail(f"network cell rate {numer}/{denom} buffer {buf}: drops {rep.drops} != "
                     f"retransmits {rep.retransmits}")
            if policy == "backpressure" and (rep.drops or not rep.stall_ticks):
                fail(f"backpressure cell: {rep.drops} drops, {rep.stall_ticks} stall ticks")
            rows.append({
                "rate_numer": numer, "rate_denom": denom, "buffer_packets": buf, "policy": policy,
                "loss_rate": loss, "makespan_ticks": rep.makespan_ticks,
                "network_seconds": rep.seconds, "server_seconds": res.server_seconds,
                "bottleneck": "network" if rep.seconds >= res.server_seconds else "compute",
                "drops": rep.drops, "retransmits": rep.retransmits, "duplicates": rep.duplicates,
                "stall_ticks": rep.stall_ticks,
                "coalesced": sum(s.coalesced for s in rep.links),
                "forced": sum(s.forced for s in rep.links),
                "buffer_high_water": max(s.buffer_high_water for s in rep.links),
                "server_dup_packets": res.dup_packets_dropped, "spilled_packets": res.spilled_packets,
                "spilled_keys": res.spilled_keys, "pipeline_s": sec, "timing_model_s": model_s[0],
                "lossless_identical": True})
            del res
    finally:
        timing.simulate_link = orig
    emit({"phase": "pipeline_network", "n": n, "config": dict(NETWORK, loss_rate=NETWORK_LOSS),
          "timeless_s": ref_s, "cells": rows, "all_lossless_identical": True})


#: The reference's fault ladder (``net_bench.py`` ``FAULT_PLANS``) and its
#: configuration (``FAULT_BENCH`` = ``SCALING_BENCH`` + 4 servers: the 7-hop
#: tree, 16 x 64, 256-key packets, 8 flows, k = 10, oracle ranges,
#: ``random_trace``, numpy-ladder servers) at 250k keys, cut from its
#: ``--fault-n`` default of 1M: there its ``all_degraded`` plan (the plain-sort
#: baseline through the numpy-ladder servers) took 76 s of the run; then the
#: same ladder on the E2E fabric with its 4 arena servers (no payload, as the
#: reference's ladder) at the paper's trace size.
FAULT_PLANS = (
    ("fault_free", ""),
    ("one_hop_degraded", "degrade:l1n0@0"),
    ("half_degraded", "degrade:l1n0@0;degrade:l0n0@0;degrade:l0n1@0"),
    ("all_degraded", "degrade:all@0"),
    ("dead_interior", "crash:l1n0@0"),
    ("dead_leaf", "crash:l0n3@0"),
    ("shard_failover", "server_crash:1@0.5"),
    ("kitchen_sink", "crash:l1n0@0;degrade:l0n0@0;server_crash:2@0.3;corrupt_ranges@0"),
)
FAULT_BENCH = dict(topology="tree", branching=2, height=3, num_segments=16, segment_length=64,
                   payload_size=256, num_flows=8, k=10, range_mode="oracle", num_servers=4)
FAULT_N = 250_000
FAULT_E2E_N = 100_000_000

#: The reference's multi-tenant sweep (``net_bench.py`` ``MT_*``): J jobs,
#: scenario-cycled with their range modes, one switch, 16 x 64, 64-key
#: packets, the fused engine, 4 in flight, numpy-ladder servers, at its
#: ``--mt-n`` of 200k keys per tenant; then J = 4 at 10M keys per tenant (a
#: cut from 25M for the sampled tenants' host loop) on the arena servers.
MT_JOBS = (1, 2, 4)
MT_SCENARIOS = ("adversarial_skew", "drifting", "sorted50", "duplicate_heavy")
MT_MODES = ("sampled", "sampled", "oracle", "static")
MT_FABRIC = dict(topology="single", num_segments=16, segment_length=64, payload_size=64,
                 engine="fused", max_inflight=4)
MT_N = 200_000
MT_BIG_N = 10_000_000

#: The reference's hop-throughput bench (``net_bench.py`` ``HOP_BENCH``): one
#: hop, 64 x 64, 64-key packets, 8 flows round-robin, ``random_trace`` at its
#: ``--hop-n`` of 1M; and its faithful check on 4,000 keys.
HOP_BENCH = dict(segments=64, length=64, payload=64, flows=8)
HOP_N = 1_000_000
FAITHFUL_N = 4000


def _sorting_hops(plan: str, hop_stats) -> int:
    """Hops of a run that sorted keys: neither dead nor degraded, with
    arrivals (each launches K1 once)."""
    from repro_torch.net.faults import parse_fault_plan

    ef = parse_fault_plan(plan).at_epoch(0)
    return sum(1 for st in hop_stats if st.arrivals and ef.hop_state(st.name) == "healthy")


def _fault_row(torch, run_pipeline, values, want, name: str, spec: str, base_s, **kw) -> dict:
    from repro_torch.kernels import build

    build.reset_launches()
    _reset_peak(torch)
    res, sec = timed_run(torch, run_pipeline, values, fault_plan=spec or None, **kw)
    launches = dict(build.LAUNCHES)
    if not torch.equal(res.output, want):
        fail(f"fault plan {name}: output differs from the fault-free run and torch.sort")
    hops = _sorting_hops(spec, res.hop_stats)
    if values.is_cuda and launches["row_sort"] != hops:
        fail(f"fault plan {name}: K1 launched {launches['row_sort']} times, want {hops} (one per sorting hop)")
    if values.is_cuda and kw.get("merge_backend") == "arena" and launches["tournament"] < 1:
        fail(f"fault plan {name}: K2 never launched in the arena servers")
    base_s = sec if base_s is None else base_s
    return {"plan": name, "spec": spec, "seconds": sec, "keys_per_s": values.numel() / sec,
            "throughput_ratio": base_s / sec, "identical": True,
            "hops_dead": res.fault_hops_dead, "hops_degraded": res.fault_hops_degraded,
            "servers_failed_over": res.servers_failed_over, "range_fallbacks": res.range_fallbacks,
            "passes_total": sum(res.passes), "server_keys": res.server_keys,
            "server_makespan_s": res.server_seconds, "peak_device_bytes": _peak(torch),
            "launches": {k: launches[k] for k in ("row_sort", "tournament")}}


def phase_pipeline_faults(torch, np, run_pipeline, dev: str, seed: int, small_n: int,
                          big_n: int) -> None:
    """The fault plane on the card: every plan of the ladder on the three
    fabrics at small n (card against the fault-free run, torch.sort and the
    CPU; ``engine="device"`` and its fused fallback), then the ladder at the
    reference's configuration and on the E2E fabric at the paper's size."""
    from repro_torch.data.traces import random_trace, trace_max_value
    from repro_torch.net import device_epoch as de
    from repro_torch.net.faults import parse_fault_plan
    from repro_torch.obs import MetricsRegistry

    maxv = trace_max_value("random")
    n = 20_000
    vals = random_trace(n, seed=3)
    cells = 0
    for graph, gkw in GRAPHS.items():
        cfg = {k: v for k, v in FAULT_BENCH.items() if k not in ("branching", "height")}
        cfg.update(topology=graph, max_value=maxv, seed=seed, **gkw)
        free = None
        for name, spec in FAULT_PLANS:
            runs = {}
            for engine, where in (("fused", dev), ("fused", "cpu"), ("device", dev)):
                metrics = MetricsRegistry()
                r = run_pipeline(vals, fault_plan=spec or None, engine=engine, device=where,
                                 metrics=metrics, **cfg)
                runs[(engine, where)] = (r.to_numpy(), metrics.snapshot()["counters"])
            card, _ = runs[("fused", dev)]
            diff = same_run(np, card, runs[("fused", "cpu")][0])
            if diff:
                fail(f"faults {name} on {graph}: the card and the CPU disagree on {diff}")
            devrun, counters = runs[("device", dev)]
            if not np.array_equal(devrun["output"], card["output"]) or devrun["passes"] != card["passes"]:
                fail(f"faults {name} on {graph}: the device engine and the fused engine disagree")
            fell_back = bool(counters.get("fault_device_fallbacks"))
            if fell_back != (spec != "" and parse_fault_plan(spec).at_epoch(0).any_dataplane):
                fail(f"faults {name} on {graph}: device fallback {fell_back}")
            if not np.array_equal(card["output"], np.sort(vals)):
                fail(f"faults {name} on {graph}: output is not the sorted input")
            if free is None:
                free = card
            elif not np.array_equal(card["output"], free["output"]):
                fail(f"faults {name} on {graph}: output differs from the fault-free run")
            cells += 1
    de.clear_program_cache()
    torch.cuda.empty_cache()

    ladders = []
    for size, servers, extra in ((small_n, "numpy", {}), (big_n, "arena", {"merge_backend": "arena"})):
        values = torch.from_numpy(random_trace(size, seed=seed)).to(dev)
        want = torch.sort(values).values
        kw = dict(FAULT_BENCH, max_value=maxv, seed=seed, device=dev, **extra)
        # An untimed fault-free run first: the allocator's growth and the
        # first calls' costs belong to no plan.
        run_pipeline(values, **kw)
        _sync(torch)
        rows = []
        for name, spec in FAULT_PLANS:
            rows.append(_fault_row(torch, run_pipeline, values, want, name, spec,
                                   rows[0]["seconds"] if rows else None, **kw))
        by = {r["plan"]: r for r in rows}
        ladders.append({"n": size, "servers": servers, "rows": rows,
                        "fault_free_s": by["fault_free"]["seconds"],
                        "one_hop_degraded_ratio": by["one_hop_degraded"]["throughput_ratio"],
                        "all_degraded_ratio": by["all_degraded"]["throughput_ratio"],
                        "all_degraded_over_fault_free_s": by["all_degraded"]["seconds"]
                        / by["fault_free"]["seconds"]})
        del values, want
        torch.cuda.empty_cache()
    emit({"phase": "pipeline_faults", "config": FAULT_BENCH, "parity_small": {"n": n, "cells": cells},
          "ladders": ladders, "all_identical": True})


def _mt_jobs(np, Job, J: int, n: int, seed: int):
    from repro_torch.data.scenarios import SCENARIOS, scenario_max_value

    jobs = []
    for t in range(J):
        name = MT_SCENARIOS[t % len(MT_SCENARIOS)]
        jobs.append(Job(t, SCENARIOS[name](n, seed=seed + t), seed=seed + t,
                        range_mode=MT_MODES[t % len(MT_MODES)], max_value=scenario_max_value(name)))
    return jobs


def _mt_row(torch, np, J: int, n: int, seed: int, dev: str, **over) -> dict:
    from repro_torch.kernels import build
    from repro_torch.net.scheduler import Job, run_job_solo, run_jobs

    fabric = dict(MT_FABRIC, **over)
    build.reset_launches()
    _reset_peak(torch)
    res = run_jobs(_mt_jobs(np, Job, J, n, seed), device=dev, **fabric)
    launches = dict(build.LAUNCHES)
    if dev == "cuda" and launches["row_sort"] != res.fabric_calls:
        fail(f"tenants J={J}: K1 launched {launches['row_sort']} times for {res.fabric_calls} fabric calls")
    if dev == "cuda" and fabric.get("merge_backend") == "arena" and launches["tournament"] < 1:
        fail(f"tenants J={J}: K2 never launched in the arena servers")
    peak = _peak(torch)
    twin = run_jobs(_mt_jobs(np, Job, J, n, seed), device=dev, pack=False, **fabric)
    for job in _mt_jobs(np, Job, J, n, seed):
        jr = res.by_tenant(job.tenant_id)
        if not torch.equal(jr.output, torch.sort(job.values.to(dev)).values):
            fail(f"tenants J={J}: tenant {job.tenant_id}'s output is not its sorted keys")
        solo = run_job_solo(job, device=dev, **fabric)
        if not torch.equal(jr.output, solo.output) or jr.passes != solo.passes:
            fail(f"tenants J={J}: tenant {job.tenant_id} differs from its solo run")
        tw = twin.by_tenant(job.tenant_id)
        if not torch.equal(jr.output, tw.output) or jr.passes != tw.passes:
            fail(f"tenants J={J}: tenant {job.tenant_id} differs from the pack=False twin")
        del solo
    if J > 1 and fabric["engine"] in ("fused", "device") and res.packed_calls < 1:
        fail(f"tenants J={J}: no round was packed")
    return {"num_jobs": J, "n_per_tenant": n, "elapsed_seconds": res.elapsed_seconds,
            "jobs_per_sec": res.jobs_per_sec, "p50_latency_s": res.p50_latency_s,
            "p99_latency_s": res.p99_latency_s, "fairness": res.fairness, "rounds": res.rounds,
            "fabric_calls": res.fabric_calls, "packed_calls": res.packed_calls,
            "epochs": [jr.num_epochs for jr in res.jobs], "isolation_ok": True,
            "pack_false_equal": True, "pack_false_elapsed_s": twin.elapsed_seconds,
            "peak_device_bytes": peak, "launches": {k: launches[k] for k in ("row_sort", "tournament")}}


def phase_pipeline_tenants(torch, np, dev: str, seed: int, small_n: int, big_n: int) -> None:
    """The multi-tenant scheduler on the card: the reference's sweep, J = 4
    at a larger size, and J = 4 packed on the device engine."""
    from repro_torch.net import device_epoch as de
    from repro_torch.net.scheduler import Job, run_jobs

    rows = [_mt_row(torch, np, J, small_n, seed, dev) for J in MT_JOBS]
    rows.append(_mt_row(torch, np, 4, big_n, seed, dev, merge_backend="arena"))
    # J = 4 packed on the device engine: each packed round's range table is
    # a new program key (a warm-up and a capture each).
    de.clear_program_cache()
    torch.cuda.empty_cache()
    fused = run_jobs(_mt_jobs(np, Job, 4, small_n, seed), device=dev, **MT_FABRIC)
    reserved = []
    orig = de.run_graph_device

    def per_round(*a, **k):
        out = orig(*a, **k)
        reserved.append(_reserved(torch))
        return out

    de.run_graph_device = per_round
    try:
        _sync(torch)
        t0 = time.perf_counter()
        devres = run_jobs(_mt_jobs(np, Job, 4, small_n, seed), device=dev,
                          **dict(MT_FABRIC, engine="device"))
        dev_s = time.perf_counter() - t0
    finally:
        de.run_graph_device = orig
    captures = len(de._PROGRAM_CACHE)
    for jr in fused.jobs:
        d = devres.by_tenant(jr.tenant_id)
        if not torch.equal(d.output, jr.output) or d.passes != jr.passes:
            fail(f"tenants on the device engine: tenant {jr.tenant_id} differs from the fused engine")
    device = {"num_jobs": 4, "n_per_tenant": small_n, "elapsed_seconds": dev_s,
              "fused_elapsed_seconds": fused.elapsed_seconds, "rounds": devres.rounds,
              "packed_calls": devres.packed_calls, "fabric_calls": devres.fabric_calls,
              "captures": captures, "memory_reserved_after_each_call": reserved,
              "jobs_per_sec": devres.jobs_per_sec, "p99_latency_s": devres.p99_latency_s}
    de.clear_program_cache()
    torch.cuda.empty_cache()
    emit({"phase": "pipeline_tenants", "config": MT_FABRIC, "scenarios": MT_SCENARIOS, "modes": MT_MODES,
          "rows": rows, "device_engine": device, "all_isolated": True})


def phase_hop_engines(torch, np, run_pipeline, dev: str, seed: int, n: int) -> None:
    """The reference's hop bench on the card (fused against the segment
    engine, K1 once per non-empty segment, the wires byte-identical), then
    ``faithful=True`` through ``run_pipeline`` against the fused engine."""
    from repro_torch.core.partition import set_ranges
    from repro_torch.data.traces import random_trace, trace_max_value
    from repro_torch.kernels import build
    from repro_torch.net.engine import HopSpec, run_hop
    from repro_torch.net.flow import interleave_batch, split_flows

    trace = random_trace(n, seed=seed)
    maxv = trace_max_value("random")
    values = torch.from_numpy(trace).to(dev)
    batch = interleave_batch(split_flows(values, HOP_BENCH["flows"], HOP_BENCH["payload"]), "round_robin")
    spec = HopSpec(HOP_BENCH["segments"], HOP_BENCH["length"], maxv,
                   set_ranges(maxv, HOP_BENCH["segments"], device=dev), payload_size=HOP_BENCH["payload"])
    rows, outs = {}, {}
    for engine, reps in (("fused", 5), ("segment", 3)):
        times = []
        for _ in range(reps):
            build.reset_launches()
            _sync(torch)
            t0 = time.perf_counter()
            out, st = run_hop(batch, spec, "hop", engine)
            _sync(torch)
            times.append(time.perf_counter() - t0)
            launches = dict(build.LAUNCHES)
        nonempty = int((st.segment_loads > 0).sum())
        want = 1 if engine == "fused" else nonempty
        if dev == "cuda" and launches["row_sort"] != want:
            fail(f"hop engine {engine}: K1 launched {launches['row_sort']} times, want {want}")
        outs[engine] = (out, st)
        rows[engine] = {"engine": engine, "seconds": min(times), "keys_per_s": n / min(times),
                        "k1_launches": launches["row_sort"], "nonempty_segments": nonempty}
    (fo, fs), (so, ss) = outs["fused"], outs["segment"]
    for col in ("values", "flow_id", "seq", "segment_id"):
        if not torch.equal(getattr(fo, col), getattr(so, col)):
            fail(f"hop engines: the segment engine's {col} differs from the fused engine's")
    if not torch.equal(fs.ship_emission, ss.ship_emission) or fs != ss:
        fail("hop engines: the segment engine's stats differ from the fused engine's")
    if not torch.equal(torch.sort(fo.values).values, torch.sort(values).values):
        fail("hop engines: the hop lost or invented keys")
    del outs, fo, so, batch
    small = trace[:FAITHFUL_N]
    kw = dict(topology="single", num_segments=16, segment_length=64, max_value=maxv,
              payload_size=256, device=dev, verify=True)
    faithful, faithful_s = timed_run(torch, run_pipeline, small, faithful=True, **kw)
    fused = run_pipeline(small, **kw)
    diff = same_run(np, faithful.to_numpy(), fused.to_numpy())
    if diff:
        fail(f"faithful and fused pipelines disagree on {diff}")
    emit({"phase": "hop_engines", "config": dict(HOP_BENCH, n=n), "rows": list(rows.values()),
          "speedup_fused_vs_segment": rows["segment"]["seconds"] / rows["fused"]["seconds"],
          "identical": True, "faithful": {"n": FAITHFUL_N, "seconds": faithful_s,
                                          "passes_max": max(faithful.passes), "equal_to_fused": True}})


class CallClock:
    """Times every call of ``module.attr`` during a run: the wall
    milliseconds between a synchronisation before the call and one after it
    (``sync``), or the device milliseconds between CUDA events recorded
    around it (read by :meth:`ms` after the run)."""

    def __init__(self, torch, module, attr: str, sync: bool) -> None:
        self.torch, self.module, self.attr, self.sync = torch, module, attr, sync
        self.orig = getattr(module, attr)
        self.wall_ms = 0.0
        self.events = []

    def __call__(self, *args, **kwargs):
        cuda = self.torch.cuda
        if self.sync:
            cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            cuda.synchronize()
            self.wall_ms += (time.perf_counter() - t0) * 1e3
            return out
        a, b = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
        a.record()
        out = self.orig(*args, **kwargs)
        b.record()
        self.events.append((a, b))
        return out

    def ms(self) -> float:
        return self.wall_ms if self.sync else sum(a.elapsed_time(b) for a, b in self.events)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)
        return False


def profiled(torch, fn) -> tuple[dict, dict]:
    """One call of ``fn`` under ``torch.profiler``: the wall time, the device
    busy share (kernel and copy time over wall time) and the top 15 kernels
    by device time, as line fields; and the device time and calls by
    kernel name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return ({"wall_s": wall, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / 1e3 / wall,
             "top_device_ms": [{"name": k[:90], "ms": v[0], "calls": v[1]} for k, v in top]}, by_name)


def phase_profile(torch, run_pipeline, values_d, payload_d, seed: int) -> None:
    """Two more main-path runs.  The first times the hop's row sort:
    ``row_sort_device`` between two synchronisations, and inside it K1's
    call between CUDA events; the difference is the glue around K1 (the two
    host reads of the key range, the mask, narrowing, widening).  The
    second runs under ``torch.profiler``: device busy share (kernel and copy
    time over wall time), the device time by kernel, and K1's."""
    from repro_torch.data.traces import trace_max_value
    from repro_torch.kernels import ops
    from repro_torch.net import engine

    with CallClock(torch, engine, "row_sort_device", sync=True) as hop_sort, \
            CallClock(torch, ops, "sort_rows_padded", sync=False) as k1:
        run_pipeline(values_d, payload=payload_d, max_value=trace_max_value("random"),
                     seed=seed, device="cuda", **E2E)
        torch.cuda.synchronize()
    row_sort = {"calls": len(k1.events), "row_sort_device_ms": hop_sort.ms(), "k1_ms": k1.ms(),
                "glue_ms": hop_sort.ms() - k1.ms()}
    fields, by_name = profiled(torch, lambda: run_pipeline(
        values_d, payload=payload_d, max_value=trace_max_value("random"), seed=seed, device="cuda", **E2E))
    k1_prof = [v for k, v in by_name.items() if "row_sort_kernel" in k]
    emit({"phase": "profile", **fields, "k1_device_ms": sum(v[0] for v in k1_prof),
          "k1_launches": sum(v[1] for v in k1_prof), "row_sort": row_sort})


def attn_bound(flops: float, bytes_: float) -> tuple[float, str]:
    """Least milliseconds of an attention call: its flops at the bf16
    tensor-core peak or its bytes at the HBM rate, whichever is larger."""
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_work(b: int, t: int, h: int, kv: int, d: int, itemsize: int, causal: bool,
            s: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of one K5 call of T query rows against S keys (``s``,
    default T): 2 flops per multiply-add of q.k and of p.v over the visible
    (row, col) pairs, T (T + 1) / 2 under the causal mask (T = S) and T x S
    without it; q and o of T rows, k and v of S rows, each read or written
    once."""
    s = t if s is None else s
    pairs = t * (t + 1) / 2 if causal else t * s
    return 4.0 * b * h * d * pairs, (2.0 * b * t * h * d + 2.0 * b * s * kv * d) * itemsize


def k6_work(lengths: list[int], h: int, kv: int, d: int, itemsize: int) -> tuple[float, float]:
    """(flops, bytes) of one K6 call: the visible cache rows of k and v read
    once, q read, the output written, the lengths read."""
    vis = float(sum(lengths))
    return 4.0 * h * d * vis, (2.0 * vis * kv * d + 2.0 * len(lengths) * h * d) * itemsize + 4 * len(lengths)


def attn_limit(want):
    """Elementwise limit on |kernel - plain| for an attention output.

    Both sides sum in float32, in other orders, and round the output once.
    float32: 2e-5 + 1e-3 |want|.  bfloat16: the two may round one value to
    neighbouring bf16 numbers, one ulp apart, at most 2^-7 of it: 1e-2
    |want|, plus 4e-3 of the largest |want| (half to one ulp at the top of
    the output's range) for the values near zero.
    """
    import torch

    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return 4e-3 * w.max() + 1e-2 * w
    return 2e-5 + 1e-3 * w


def allclose_err(got, want, what: str) -> float:
    """Max absolute difference; fails beyond ``attn_limit(want)``."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype mismatch {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: an output is not finite")
    diff = (g - w).abs()
    if (diff > attn_limit(want)).any():
        fail(f"{what} differs from its plain version by {diff.max().item()} "
             f"({want.dtype}, shape {tuple(want.shape)}, largest output {w.abs().max().item()})")
    return diff.max().item()


def randn(torch, gen, shape, dt, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)


def check_k5(fa, torch, gen, q_shape, kv_shape, dt, causal: bool):
    """K5 against its plain version on fresh inputs: (max error, (q, k, v))."""
    q = randn(torch, gen, q_shape, dt, QK_SCALE)
    k = randn(torch, gen, kv_shape, dt, QK_SCALE)
    v = randn(torch, gen, kv_shape, dt)
    err = allclose_err(fa.flash_attention(q, k, v, causal=causal),
                       fa.flash_attention_plain(q, k, v, causal=causal), "K5")
    return err, (q, k, v)


def check_k6(da, torch, gen, q_shape, cache_shape, dt, lengths, layers: int = 2):
    """K6 against its plain version on fresh inputs, reading the last layer's
    slice of stacked ``(layers, *cache_shape)`` caches in place, as the model
    does: (max error, (q, kc, vc))."""
    q = randn(torch, gen, q_shape, dt, QK_SCALE)
    kc = randn(torch, gen, (layers, *cache_shape), dt, QK_SCALE)
    vc = randn(torch, gen, (layers, *cache_shape), dt)
    err = allclose_err(da.decode_attention(q, kc[-1], vc[-1], lengths),
                       da.decode_attention_plain(q, kc[-1], vc[-1], lengths), "K6")
    return err, (q, kc, vc)


def phase_k5(fa, torch, gen) -> None:
    """Head dims 32, 64, 128 x G 1, 3, 4, 7 (llava-next-34b's 56 / 8) x T 1,
    7, 64, 130, 1000, causal or not; then Mistral-Nemo-12B's largest prefill (q 1 x 1963 x 32 x 128),
    S != T non-causal, q/k/v as strided views of one fused projection, and
    the bf16 wrapper raising on a row stride its 16-byte copies cannot
    take.  float32 and bfloat16, limits ``attn_limit``."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    for name in worst:
        dt = getattr(torch, name)
        for d in (32, 64, 128):
            for g in (1, 3, 4, 7):
                for t in (1, 7, 64, 130, 1000):
                    for causal in (True, False):
                        kv = 2
                        err, _ = check_k5(fa, torch, gen, (2, t, kv * g, d), (2, t, kv, d), dt, causal)
                        worst[name] = max(worst[name], err)
                        cases += 1
        for b, t, s, h, kv, d, causal in ((1, 1963, 1963, 32, 8, 128, True), (1, 1, 300, 4, 1, 32, False),
                                          (2, 7, 130, 6, 2, 64, False), (1, 130, 1000, 8, 2, 128, False),
                                          (1, 130, 7, 8, 2, 32, False), (3, 23, 23, 12, 4, 64, True)):
            err, _ = check_k5(fa, torch, gen, (b, t, h, d), (b, s, kv, d), dt, causal)
            worst[name] = max(worst[name], err)
            cases += 1
        for d in (32, 64, 128):
            qkv = randn(torch, gen, (2, 150, 12, d), dt, QK_SCALE)  # 8 q heads, 2 + 2 kv heads
            q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
            for causal in (True, False):
                worst[name] = max(worst[name], allclose_err(
                    fa.flash_attention(q, k, v, causal=causal),
                    fa.flash_attention_plain(q, k, v, causal=causal), "K5 on strided views"))
                cases += 1
    bad = randn(torch, gen, (1, 64, 4, 33), torch.bfloat16)[..., :32]
    try:
        fa.flash_attention(bad, bad, bad)
        fail("K5 (bfloat16) took rows that are not 16-byte aligned")
    except ValueError:
        pass
    torch.cuda.synchronize()
    emit({"phase": "k5", "cases": cases, "max_abs_err": worst, "misaligned_bf16_raises": True})


def phase_k6(da, torch, gen) -> None:
    """Head dims 32, 64, 128 x G 1, 3, 4, 7, 12 x caches of 1, 300 and 4096
    positions: lengths 1, S and random between; then slots of length 0
    (every position masked: the mean of v over the cache) beside a length
    past S.  float32 and bfloat16, limits ``attn_limit``; the last layer's
    slice of stacked caches, read in place."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    for name in worst:
        dt = getattr(torch, name)
        for d in (32, 64, 128):
            for g in (1, 3, 4, 7, 12):
                for b, s in ((1, 1), (3, 300), (4, 4096)):
                    kv = 8 if s == 4096 else 2
                    lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
                    lengths[0] = 1
                    lengths[-1] = s
                    err, _ = check_k6(da, torch, gen, (b, kv * g, d), (b, s, kv, d), dt, lengths)
                    worst[name] = max(worst[name], err)
                    cases += 1
                lengths = torch.tensor([0, 7, 1000, 0], dtype=torch.int32, device="cuda")
                err, _ = check_k6(da, torch, gen, (4, 2 * g, d), (4, 777, 2, d), dt, lengths)
                worst[name] = max(worst[name], err)
                cases += 1
    torch.cuda.synchronize()
    emit({"phase": "k6", "cases": cases, "max_abs_err": worst, "block_s": da.BLOCK_S,
          "length_zero_slots": True})


class AttnRecorder:
    """Pass-through for an attention wrapper as the model calls it: counts
    the calls by (q shape, k shape, causal) and keeps each such shape's
    latest lengths tensor (K6: the model makes a fresh one per call and
    never writes it again); copies no data: no device work and no host sync
    inside the timed run."""

    def __init__(self, module, attr: str) -> None:
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.dtype = None
        self.calls: dict = {}
        self.shape_lengths: dict = {}

    def __call__(self, q, k, v, *args, **kwargs):
        key = (tuple(q.shape), tuple(k.shape), bool(kwargs.get("causal", True)))
        self.dtype = q.dtype
        self.calls[key] = self.calls.get(key, 0) + 1
        if args:  # re-inserted, so the last entry is the latest call's
            self.shape_lengths.pop(key, None)
            self.shape_lengths[key] = args[0]
        return self.orig(q, k, v, *args, **kwargs)

    @property
    def largest(self) -> tuple:
        """The (q shape, k shape, causal) of the first call with the most
        q elements."""
        return max(self.calls, key=lambda key: math.prod(key[0]))

    @property
    def q_shape(self) -> tuple:
        return self.largest[0]

    @property
    def kv_shape(self) -> tuple:
        return self.largest[1]

    @property
    def causal(self) -> bool:
        return self.largest[2]

    @property
    def lengths(self):
        """The lengths tensor of the latest call that took one, or None."""
        return next(reversed(self.shape_lengths.values()), None)

    def shapes(self) -> dict:
        """(B, T, S, H, KV, d, causal) -> calls, of a (B, T, H, d) q."""
        return {(q[0], q[1], k[1], q[2], k[2], q[3], c): n for (q, k, c), n in self.calls.items()}

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)
        return False


def shape_launches(rec: AttnRecorder, launches: dict, per: int = 1) -> list:
    """``rec``'s calls by shape as ``[[q shape, k shape, causal], calls /
    per]`` pairs (JSON), their sum held to the wrapper's launch count in
    ``launches`` (``per``: calls a launch, 2 for a graph capture's warm-up
    and captured step)."""
    name = {"flash_attention": "flash_attention", "flash_attention_bwd": "flash_attention_bwd",
            "decode_attention_kernel": "decode_attention"}[rec.attr]
    pairs = [[[list(q), list(k), c], n // per] for (q, k, c), n in rec.calls.items()]
    if sum(n for _, n in pairs) * per != sum(rec.calls.values()):
        fail(f"{name}: {rec.calls} calls are not {per} a launch")
    if sum(n for _, n in pairs) != launches[name]:
        fail(f"{name}: {sum(n for _, n in pairs)} calls by shape, {launches[name]} launches counted")
    return pairs


class SyncTimer:
    """Wraps a model method: synchronises the card on entry and exit and adds
    the wall seconds to ``seconds`` (each call's in ``times``); ``after`` sees
    each call's result."""

    def __init__(self, torch, fn, after=None) -> None:
        self.torch, self.fn, self.after = torch, fn, after
        self.seconds = 0.0
        self.calls = 0
        self.times: list[float] = []

    def __call__(self, *args, **kwargs):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        self.seconds += self.times[-1]
        self.calls += 1
        if self.after is not None:
            self.after(out)
        return out


def serve_parity_small(torch, np, arch: str) -> dict:
    """The smoke config of ``arch`` in float32: the card against the CPU,
    same weights."""
    import dataclasses

    from repro_torch import configs, models
    from repro_torch.serve.engine import Engine, Request

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    host = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = models.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 9)))
    errs = []
    hc, cc = host.init_cache(2, 32), card.init_cache(2, 32)
    want, hc = host.prefill(toks, hc)
    got, cc = card.prefill(toks.cuda(), cc)
    errs.append((got.cpu() - want).abs().max().item())
    tok = want.argmax(-1)
    for _ in range(6):
        want, hc = host.decode_step(hc, tok)
        got, cc = card.decode_step(cc, tok.cuda())
        errs.append((got.cpu() - want).abs().max().item())
        tok = want.argmax(-1)
    if max(errs) > 1e-4:
        fail(f"{arch} smoke LM on the card differs from the CPU by {max(errs)}")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (3, 5, 2, 7, 4)]
    outs = []
    for model, dev, eager in ((host, "cpu", False), (card, "cuda", False), (card, "cuda", True)):
        eng = Engine(model, slots=2, max_len=64, device=dev, _eager=eager)
        if (eng.decode_graph is None) != (dev == "cpu" or eager):
            fail(f"{arch} smoke Engine on {dev} (eager {eager}) has the wrong decode path")
        for i, p in enumerate(prompts):
            eng.add(Request(rid=i, prompt=p, max_tokens=6))
        outs.append(sorted((r.rid, r.out) for r in eng.run()))
    if outs[1] != outs[2]:
        fail(f"{arch} smoke Engine's decode graph gives other greedy tokens than its eager step")
    if outs[0] != outs[1]:
        fail(f"{arch} smoke Engine on the card gives other greedy tokens than on the CPU")
    return {"arch": arch, "logits_max_abs_err": max(errs), "requests": len(outs[0]),
            "tokens": sum(len(o[1]) for o in outs[0]), "graph_tokens_equal_eager": True}


class MoERecorder:
    """Pass-through for ``moe.moe_layer`` and ``moe.dispatch`` as the model
    calls them: keeps each call's dropped count (a 0-d device tensor, summed
    only after the run, so no host sync and no device launch of its own)
    and, when ``keep`` is set, each call's dispatch."""

    def __init__(self, moe_mod, keep: bool = False) -> None:
        self.moe_mod, self.keep = moe_mod, keep
        self.orig = moe_mod.moe_layer, moe_mod.dispatch
        self.dropped: list = []
        self.dispatches: list = []

    def _layer(self, *args):
        y, aux, dropped = self.orig[0](*args)
        self.dropped.append(dropped)
        return y, aux, dropped

    def _dispatch(self, *args):
        d = self.orig[1](*args)
        if self.keep:
            self.dispatches.append(d)
        return d

    def __enter__(self):
        self.moe_mod.moe_layer, self.moe_mod.dispatch = self._layer, self._dispatch
        return self

    def __exit__(self, *exc):
        self.moe_mod.moe_layer, self.moe_mod.dispatch = self.orig
        return False


def same_dispatch(torch, a, b) -> bool:
    return (len(a) == len(b) and all(torch.equal(x.order, y.order) and torch.equal(x.slot, y.slot)
                                     and torch.equal(x.dropped, y.dropped) for x, y in zip(a, b)))


def full_width_parity(torch, model, gen) -> dict:
    """The full-width model on a short prompt (1 x 64 tokens, or embedding
    rows; the encoder-decoder's decoder prompt after ``SERVE_ENCDEC``'s
    frames) and 4 decode steps through the kernels and through their plain
    versions.

    Dense: K5 and K6 plain; the logits within 5% of their scale, every
    argmax equal.  RWKV6 (K7 plain) and the encoder-decoder (K5 and K6
    plain): on a float32 copy of the model (the same weights), the logits
    within 1e-3 of their scale, every argmax equal; the bf16 model's own
    difference is recorded beside it, not held (RWKV6's bf16 roundings of
    the WKV's output, one place apart on the two sides, grow over 24 layers
    to some 9% of the logits' scale at the initial weights).  MoE: K3 plain; every dispatch (order, slots, dropped)
    and every logit identical.  K5 and K6 stay on their kernels there: the
    router's strict top-k flips near-ties on a bf16 rounding one place
    apart, so a plain attention path routes some tokens elsewhere (PERF.md
    §7).  They are held to their plain versions at the MoE run's own shapes
    instead (:func:`check_attention_at`)."""
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.wkv import wkv_plain
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv6 as rwkv_mod

    is_moe = model.cfg.moe is not None
    is_rwkv = model.cfg.rwkv is not None
    is_encdec = model.cfg.is_encdec
    toks = torch.randint(0, model.cfg.vocab_size, (1, 64), generator=gen, device="cuda")
    prompt, frames = toks, SERVE_ENCDEC["frames"]  # the models cast embeddings to their type
    if is_encdec:
        prompt = {"enc_embeds": torch.randn(1, frames, model.cfg.d_model, generator=gen, device="cuda") * EMBED_SCALE,
                  "tokens": toks}
    elif model.cfg.input_kind == "embeds":  # 64 embedding rows, then tokens
        prompt = torch.randn(1, 64, model.cfg.d_model, generator=gen, device="cuda") * EMBED_SCALE

    def run(plain: bool, net=model):
        saved = (attn_mod.flash_attention, attn_mod.decode_attention_kernel, bt.sort_rows_kv, rwkv_mod.wkv)
        if plain and is_moe:
            bt.sort_rows_kv = bt.sort_rows_kv_plain
        elif plain and is_rwkv:
            rwkv_mod.wkv = wkv_plain
        elif plain:
            attn_mod.flash_attention = fa_mod.flash_attention_plain
            attn_mod.decode_attention_kernel = decode_attention_plain
        try:
            with MoERecorder(moe_mod, keep=True) as rec:
                cache = net.init_cache(1, 128, frames) if is_encdec else net.init_cache(1, 128)
                logits, cache = net.prefill(prompt, cache)
                seq = [logits.float()]
                tok = toks[:, -1]
                for _ in range(4):
                    logits, cache = net.decode_step(cache, tok)
                    seq.append(logits.float())
                    tok = logits.argmax(-1)
        finally:
            attn_mod.flash_attention, attn_mod.decode_attention_kernel, bt.sort_rows_kv, rwkv_mod.wkv = saved
        out = torch.stack(seq)
        if not torch.isfinite(out).all():
            fail("full-width logits are not finite")
        return out, rec

    if is_rwkv or is_encdec:
        import dataclasses

        from repro_torch import models as models_mod

        bf16_err = (run(False)[0] - run(True)[0]).abs().max().item()
        f32 = models_mod.build(dataclasses.replace(model.cfg, dtype="float32"), device="cuda")
        f32.load_state_dict(model.state_dict())
        kern, _ = run(False, f32)
        plain, _ = run(True, f32)
        del f32
        torch.cuda.empty_cache()
        err, scale = (kern - plain).abs().max().item(), plain.abs().max().item()
        if err > 1e-3 * scale or not torch.equal(kern.argmax(-1), plain.argmax(-1)):
            fail(f"full-width float32 logits through the kernels differ from the plain path by {err} "
                 f"(scale {scale}) or in an argmax")
        return {"plain": "k7" if is_rwkv else "k5+k6", "dtype": "float32 copy of the bf16 weights",
                "logits_max_abs_err": err,
                "logits_max_abs": scale, "limit": "1e-3 of the logits' largest magnitude", "argmax_equal": True,
                "bf16_logits_max_abs_err": bf16_err}
    kern, krec = run(False)
    plain, prec = run(True)
    err = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    if is_moe:
        if not same_dispatch(torch, krec.dispatches, prec.dispatches):
            fail("with K3 plain, the dispatch differs from the kernel run")
        if err:
            fail(f"with K3 plain, the logits differ from the kernel run by {err}")
        return {"plain": "k3", "dispatch_calls": len(krec.dispatches), "dispatch_identical": True,
                "dropped": int(sum(d.dropped for d in krec.dispatches)),
                "assignments": int(sum(d.order.numel() for d in krec.dispatches)),
                "logits_max_abs_err": err, "logits_max_abs": scale, "argmax_equal": True}
    # bf16 attention outputs round at one more place on one side; the layers
    # carry that: hold the kernels' logits within 5% of the logits' scale
    if err > 0.05 * scale:
        fail(f"full-width logits through the kernels differ from the plain path by {err} (scale {scale})")
    if not torch.equal(kern.argmax(-1), plain.argmax(-1)):
        fail("full-width greedy tokens through the kernels differ from the plain path")
    return {"plain": "k5+k6", "logits_max_abs_err": err, "logits_max_abs": scale, "argmax_equal": True}


def attention_layers(cfg) -> int:
    """The attention layers a token passes through: every layer, the
    hybrid's shared-block invocations (one after each full segment of
    ``shared_attn_every`` Mamba2 layers), none (Mamba2, RWKV6), or the
    encoder-decoder's encoder layers and its decoder's self- and
    cross-attentions (36 for whisper-small)."""
    if cfg.is_encdec:
        return cfg.encoder_layers + 2 * cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return 0 if cfg.ssm is not None or cfg.rwkv is not None else cfg.num_layers


def rwkv_layers(cfg) -> int:
    """The RWKV6 blocks a token passes through (each runs K7 once)."""
    return cfg.num_layers if cfg.rwkv is not None else 0


def phase_serve(torch, np, args, arch: str, phase: str, smoke_archs) -> dict:
    """One LM serve path at full width; returns what the kernels phase needs.
    A Mamba2 model's line adds each request's prefill: its tokens, the SSD
    chunk length Q (the configured chunk shrunk to the largest divisor of
    the prompt: 1 for a prime one, whose inter-chunk loop then takes a host
    step per token and layer) and its seconds."""
    from repro_torch import configs, models
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.serve.engine import Engine, Request

    parity = [serve_parity_small(torch, np, a) for a in smoke_archs]

    cfg = configs.get_config(arch)
    moe_layers = cfg.num_layers - cfg.moe.first_dense_layers if cfg.moe else 0
    attn_layers = attention_layers(cfg)
    wkv_layers = rwkv_layers(cfg)
    t0 = time.perf_counter()
    model = models.build(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    width = full_width_parity(torch, model, gen)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(args.seed)
    prompts = []
    for rid in range(SERVE["requests"]):
        plen = int(rng.integers(SERVE["prompt_min"], SERVE["prompt_max"] + 1))
        prompts.append(rng.integers(0, cfg.vocab_size, size=plen).tolist())
    want = {"flash_attention": attn_layers, "decode_attention": attn_layers,
            "row_sort_kv": moe_layers, "wkv": wkv_layers, "row_sort": 0, "tournament": 0, "merge_rows": 0}

    def engine_run(eager: bool, after_step=None):
        """One Engine over the 8 requests; the counters zeroed just before
        ``run`` and read just after; ``after_step`` runs after each decode
        step.  Returns the engine, its timers, the finished requests, the
        run's seconds, launches and peak memory."""
        eng = Engine(model, slots=SERVE["slots"], max_len=SERVE["max_len"], device="cuda", _eager=eager)
        for rid, p in enumerate(prompts):
            eng.add(Request(rid=rid, prompt=p, max_tokens=SERVE["new_tokens"]))
        finite = []
        prefill = SyncTimer(torch, model.prefill, lambda out: finite.append(torch.isfinite(out[0]).all()))
        decode = SyncTimer(torch, eng._decode, lambda out: (
            finite.append(torch.isfinite(out).all()), after_step and after_step()))
        model.prefill, eng._decode = prefill, decode
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t_run = time.perf_counter()
            finished = eng.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            launches = dict(build.LAUNCHES)
        finally:
            del model.prefill, eng._decode
        if not torch.stack(finite).all():
            fail(f"the {arch} serve run produced non-finite logits")
        if len(finished) != SERVE["requests"]:
            fail(f"{len(finished)} of {SERVE['requests']} requests finished")
        for r in finished:
            if len(r.out) != SERVE["new_tokens"] or not all(0 <= t < cfg.vocab_size for t in r.out):
                fail(f"request {r.rid} came back with {len(r.out)} tokens or a token out of the vocabulary")
        return eng, prefill, decode, finished, run_s, launches, torch.cuda.max_memory_allocated()

    def rates(prefill, decode, finished, run_s) -> dict:
        new_tokens = sum(len(r.out) for r in finished)
        return {"run_s": run_s, "prefills": prefill.calls, "prefill_s": prefill.seconds,
                "prefill_tokens_per_s": sum(len(p) - 1 for p in prompts) / prefill.seconds,
                "decode_steps": decode.calls, "decode_tokens": new_tokens, "decode_s": decode.seconds,
                "decode_tokens_per_s": new_tokens / decode.seconds,
                "ms_per_decode_step": decode.seconds / decode.calls * 1e3,
                "ms_per_decode_step_median": float(np.median(decode.times)) * 1e3,
                "host_s_outside_model": run_s - prefill.seconds - decode.seconds}

    def hold(launches: dict, prefills: int, steps: int, what: str) -> None:
        for name, per in want.items():
            n = per * (prefills + steps) if name in ("row_sort_kv", "wkv") else (
                per * prefills if name == "flash_attention" else per * steps)
            if launches[name] != n:
                fail(f"{arch} {what}: {name} launched {launches[name]} times, want {n} "
                     f"({prefills} prefills, {steps} decode steps)")

    # -- the main path: the decode step replayed as one CUDA graph -------------
    eng, prefill, decode, finished, run_s, g_launches, peak = engine_run(False)
    entries = ["flash_fwd", "flash_fwd_bf16", "decode_partial", "decode_merge", "chunk_stages",
               "strided_stages", "global_stage", "row_sort_kernel", "tile_merge", "merge_round",
               "merge_tile", "global_first", "global_cleaner", "wkv_forward"]
    nodes = build.graph_kernel_nodes(eng.decode_graph, entries)
    per_replay = {"flash_attention": nodes["flash_fwd"] + nodes["flash_fwd_bf16"],
                  "decode_attention": nodes["decode_partial"],
                  "row_sort_kv": nodes["chunk_stages"] + nodes["strided_stages"] + nodes["global_stage"],
                  "row_sort": nodes["row_sort_kernel"], "tournament": nodes["tile_merge"] + nodes["merge_round"],
                  "merge_rows": nodes["merge_tile"] + nodes["global_first"] + nodes["global_cleaner"],
                  "wkv": nodes["wkv_forward"]}
    if eng.decode_steps != decode.calls:
        fail(f"{arch}: the engine counted {eng.decode_steps} replays, the timer {decode.calls}")
    if g_launches["decode_attention"] or any(g_launches[k] != want[k] * prefill.calls for k in ("row_sort_kv", "wkv")):
        fail(f"{arch}: a decode-step kernel launched outside the graph")
    if per_replay["wkv"] != wkv_layers:
        fail(f"{arch}: a decode-graph replay holds {per_replay['wkv']} K7 nodes, want {wkv_layers}")
    launches = {k: g_launches[k] + per_replay[k] * decode.calls for k in want}
    hold(launches, prefill.calls, decode.calls, "graph run")
    names = [k for k in ("flash_attention", "decode_attention", "row_sort_kv", "wkv") if want[k]]
    if any(launches[k] < 1 for k in names):
        fail(f"a kernel of the {arch} serve path never launched")
    graph_line = rates(prefill, decode, finished, run_s)
    if cfg.ssm is not None:  # admitted in request order: one prefill each
        from repro_torch.models.mamba2 import chunk_len

        graph_line["prefill_requests"] = [
            {"rid": rid, "prefill_tokens": len(p) - 1, "Q": chunk_len(cfg, len(p) - 1),
             "chunks": (len(p) - 1) // chunk_len(cfg, len(p) - 1), "prefill_s": t}
            for rid, (p, t) in enumerate(zip(prompts, prefill.times))]
    elif cfg.rwkv is not None:
        graph_line["prefill_requests"] = [{"rid": rid, "prefill_tokens": len(p) - 1, "prefill_s": t}
                                          for rid, (p, t) in enumerate(zip(prompts, prefill.times))]
    cache_bytes = {k: v.numel() * v.element_size() for k, v in eng.cache.items()}
    graph_tokens = sorted((r.rid, r.out) for r in finished)
    first_tokens = [r.out[:4] for r in sorted(finished, key=lambda r: r.rid)]
    if args.profile:
        phase_serve_profile(torch, eng, rng, cfg)
    del eng, finished
    torch.cuda.empty_cache()

    # -- the same requests on the eager step: tokens, times, kernel shapes -----
    step_lengths = []
    with AttnRecorder(attn_mod, "flash_attention") as k5_in, \
            AttnRecorder(attn_mod, "decode_attention_kernel") as k6_in, \
            LargestShape(bt, "sort_rows_kv") as k3_in, MoERecorder(moe_mod) as moe_rec, \
            LargestShape(rwkv_mod, "wkv") as k7_in:
        eng, eprefill, edecode, efinished, erun_s, e_launches, epeak = engine_run(
            True, lambda: step_lengths.append(k6_in.lengths))
    if sorted((r.rid, r.out) for r in efinished) != graph_tokens:
        fail(f"{arch}: the decode graph's tokens differ from the eager step's")
    hold(e_launches, eprefill.calls, edecode.calls, "eager run")
    k6_lengths = None
    if attn_layers:
        lens = torch.stack(step_lengths).sum(dim=1)
        k6_lengths = step_lengths[int(lens.argmax())].tolist()
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "config": SERVE, "parity_smoke_f32_vs_cpu": parity,
            "parity_full_width_kernels_vs_plain": width, "init_s": init_s,
            "weight_bytes": weight_bytes, "cache_bytes": cache_bytes, "attention_layers": attn_layers,
            "prompt_lengths": [len(p) for p in prompts],
            "decode": "cuda_graph", **graph_line, "prefill_tokens": sum(len(p) - 1 for p in prompts),
            "peak_device_bytes": peak, "launches": {k: launches[k] for k in names},
            "decode_graph": {"kernel_nodes": nodes["all"], "per_replay": {k: per_replay[k] for k in names},
                             "decode_merge_nodes": nodes["decode_merge"], "replays": decode.calls},
            "eager": {**rates(eprefill, edecode, efinished, erun_s), "peak_device_bytes": epeak,
                      "launches": {k: e_launches[k] for k in names}},
            "graph_tokens_equal_eager": True, "first_tokens": first_tokens}
    if moe_layers:
        line["dropped_assignments_eager_run"] = int(torch.stack(moe_rec.dropped).sum())
    emit(line)
    del eng, efinished, model
    torch.cuda.empty_cache()
    return {"launches": launches, "k5": k5_in, "k6": k6_in, "k6_lengths": k6_lengths,
            "k3_shape": k3_in.shape, "k3_dtype": k3_in.dtype,
            "k3_real": (max(len(p) for p in prompts) - 1) * (cfg.moe.top_k if cfg.moe else 0),
            "k7_prefill_shape": k7_in.shape, "slots": SERVE["slots"], "wkv_layers": wkv_layers,
            "per_replay": per_replay, "replays": decode.calls, "weight_bytes": weight_bytes,
            "cache_bytes": cache_bytes}


def phase_serve_profile(torch, eng, rng, cfg) -> None:
    """One prefill of up to 1024 tokens and eight decode steps of the serve
    path under ``torch.profiler``: device busy share and time by kernel."""
    from repro_torch.serve.engine import Request

    plen = min(1024, eng.max_len - 8)
    eng.add(Request(rid=99, prompt=rng.integers(0, cfg.vocab_size, size=plen).tolist(), max_tokens=8))
    emit({"phase": "serve_profile", "arch": cfg.name, "prompt": plen, "decode_steps": 8,
          **profiled(torch, eng.run)[0]})


def check_attention_at(torch, serve: dict, gen, phase: str) -> None:
    """K5 and K6 against their plain versions (fresh peaked inputs,
    ``attn_limit``) at the largest inputs a serve run gave them: the
    prefill's q and k/v shapes, the decode step with the most cache rows."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    k5, k6 = serve["k5"], serve["k6"]
    lengths = torch.tensor(serve["k6_lengths"], dtype=torch.int32, device="cuda")
    e5, _ = check_k5(fa, torch, gen, k5.q_shape, k5.kv_shape, k5.dtype, k5.causal)
    e6, _ = check_k6(da, torch, gen, k6.q_shape, k6.kv_shape, k6.dtype, lengths)
    torch.cuda.synchronize()
    emit({"phase": phase, "dtype": str(k5.dtype).replace("torch.", ""),
          "flash_attention": {"q": list(k5.q_shape), "kv": list(k5.kv_shape), "causal": k5.causal,
                              "max_abs_err": e5},
          "decode_attention": {"q": list(k6.q_shape), "cache": list(k6.kv_shape),
                               "lengths": serve["k6_lengths"], "max_abs_err": e6}})
    torch.cuda.empty_cache()


def k5_row_at(torch, gen, q_shape, kv_shape, dt, causal: bool, launches=None) -> dict:
    """A K5 kernels-line row at one shape: K5 against its plain version on
    fresh peaked inputs, eager and graph ms of K5, its plain version and
    ``scaled_dot_product_attention`` (``enable_gqa``), the bound of T x S
    (or T (T + 1) / 2 causal) pairs; ``launches`` where a path's run
    counted them."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, t, h, d = q_shape
    s, kv = kv_shape[1], kv_shape[2]
    err, (q, k, v) = check_k5(fa, torch, gen, q_shape, kv_shape, dt, causal)
    flops, bytes_ = k5_work(b, t, h, kv, d, q.element_size(), causal, s)
    b_ms, b_by = attn_bound(flops, bytes_)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    row = {**({} if launches is None else {"launches": launches}), "max_abs_err": err,
           "shape": {"q": list(q_shape), "kv": list(kv_shape), "causal": causal},
           "dtype": str(dt).replace("torch.", ""),
           **timings(lambda: fa.flash_attention(q, k, v, causal=causal),
                     lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                     lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)),
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": bytes_}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def k6_row_at(torch, gen, q_shape, cache_shape, dt, lengths: list[int], launches) -> dict:
    """A K6 kernels-line row at one shape: K6 against its plain version,
    eager and graph ms of K6, its plain version and SDPA with the lengths'
    mask, cycling over 8 layers' caches so that no launch finds its cache in
    L2; the bound of the visible rows."""
    import itertools

    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    b, h, d = q_shape
    s, kv = cache_shape[1], cache_shape[2]
    layers = 8
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    err, (q, kc, vc) = check_k6(da, torch, gen, q_shape, cache_shape, dt, lens, layers)
    flops, bytes_ = k6_work(lengths, h, kv, d, q.element_size())
    b_ms, b_by = attn_bound(flops, bytes_)
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qs = q[:, :, None, :]

    def cycling(fn):
        it = itertools.cycle(range(layers))

        def run():
            i = next(it)
            return fn(kc[i], vc[i])
        return run

    row = {"launches": launches, "max_abs_err": err,
           "shape": {"q": list(q_shape), "cache": list(cache_shape), "lengths": lengths},
           "dtype": str(dt).replace("torch.", ""), "block_s": da.BLOCK_S,
           **timings(cycling(lambda kk, vv: da.decode_attention(q, kk, vv, lens)),
                     cycling(lambda kk, vv: da.decode_attention_plain(q, kk, vv, lens)),
                     cycling(lambda kk, vv: F.scaled_dot_product_attention(
                         qs, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask, enable_gqa=True))),
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": bytes_}
    del q, kc, vc
    torch.cuda.empty_cache()
    return row


def attention_rows(torch, serve: dict, gen) -> list[dict]:
    """The kernels-line rows of K5 and K6 at the serve run's largest inputs."""
    k5, k6 = serve["k5"], serve["k6"]
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:85",
             **k5_row_at(torch, gen, k5.q_shape, k5.kv_shape, k5.dtype, k5.causal,
                         serve["launches"]["flash_attention"])},
            {"name": "decode_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/decode_attention.py:74",
             **k6_row_at(torch, gen, k6.q_shape, k6.kv_shape, k6.dtype, serve["k6_lengths"],
                         serve["launches"]["decode_attention"])}]


# -- the training paths -----------------------------------------------------------


def grad_limit(want):
    """Elementwise limit on |K5b - plain| for a gradient.

    Both sides multiply the same inputs in float32 and sum in other orders
    (dk and dv over every query row of G heads), then round once to the
    input's type.  float32: 2e-5 of the tensor's largest |want| plus 1e-3
    |want|; bfloat16: one or two ulps, 4e-3 of the largest plus 1e-2 |want|.
    Both add 1e-5: a gradient that is exactly 0 (one visible key: the
    softmax is constant) is f32 rounding noise of order 1e-7 on each side."""
    import torch

    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return 1e-5 + 4e-3 * w.max() + 1e-2 * w
    return 1e-5 + 2e-5 * w.max() + 1e-3 * w


def lse_limit(dt) -> float:
    """Limit on |K5's lse - the plain logsumexp|: float32 online sums in
    other orders, 2e-5; the bf16 kernel sums its probabilities as rounded to
    bf16 (2^-9 relative each), so log l moves by up to 2^-9: 2^-8."""
    import torch

    return 2.0**-8 if dt == torch.bfloat16 else 2e-5


def check_k5b(fa, fb, torch, gen, q_shape, kv_shape, dt, causal: bool, strided_do: bool = False):
    """K5 with its lse and K5b against their plain versions on fresh peaked
    inputs: (max error of dq, dk, dv, lse error, the inputs).  K5's output
    must be the same bytes with and without the lse."""
    q = randn(torch, gen, q_shape, dt, QK_SCALE)
    k = randn(torch, gen, kv_shape, dt, QK_SCALE)
    v = randn(torch, gen, kv_shape, dt)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    if not torch.equal(o, fa.flash_attention(q, k, v, causal=causal)):
        fail("K5's output changes when it also writes the lse")
    _, plse = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    e_lse = (lse - plse).abs().max().item()
    if not e_lse <= lse_limit(dt):
        fail(f"K5's lse differs from the plain logsumexp by {e_lse} ({dt}, q {q_shape})")
    b, t, h, d = q_shape
    do = randn(torch, gen, (b, h, t, d), dt).transpose(1, 2) if strided_do else randn(torch, gen, q_shape, dt)
    got = fb.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = fb.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    errs = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.isfinite(g).all():
            fail(f"K5b {name}: shape, type or a non-finite value ({dt}, q {q_shape}, kv {kv_shape})")
        diff = (g.float() - w.float()).abs()
        if (diff > grad_limit(w)).any():
            fail(f"K5b {name} differs from its plain version by {diff.max().item()} ({dt}, q {q_shape}, "
                 f"kv {kv_shape}, causal {causal}, largest {w.float().abs().max().item()})")
        errs.append(diff.max().item())
    return errs, e_lse, (q, k, v, o, do, lse)


def phase_k5b(fa, fb, torch, gen) -> None:
    """K5b (and K5's lse) against their plain versions: head dims 32, 64,
    128 x G 1, 3, 4, 7 x (T, S) in (1, 1), (63, 63), (130, 130), (7, 130),
    (130, 7), causal or not, B 2, float32 and bfloat16; then the training
    shapes in bf16, causal (granite-moe-3b-a800m: B 4, T = S 2048, H 24,
    KV 8, d 64; Mistral-Nemo-12B: B 2, T = S 2048, H 32, KV 8, d 128), the
    granite shape in float32 and with a dO that is a transposed view, and a
    non-causal T != S with ragged tails.  Limits: ``grad_limit``,
    ``lse_limit``."""
    worst = {"float32": [0.0, 0.0, 0.0, 0.0], "bfloat16": [0.0, 0.0, 0.0, 0.0]}
    cases = 0

    def note(name, errs, e_lse):
        nonlocal cases
        worst[name] = [max(a, b) for a, b in zip(worst[name], errs + [e_lse])]
        cases += 1

    for name in worst:
        dt = getattr(torch, name)
        for d in (32, 64, 128):
            for g in (1, 3, 4, 7):
                for t, s in ((1, 1), (63, 63), (130, 130), (7, 130), (130, 7)):
                    for causal in (True, False):
                        errs, e_lse, _ = check_k5b(fa, fb, torch, gen, (2, t, 2 * g, d), (2, s, 2, d), dt, causal)
                        note(name, errs, e_lse)
    big = {}
    for label, (b, t, s, h, kv, d, causal), dt, strided in (
            ("granite_bf16", TRAIN_K5B["granite"], torch.bfloat16, False),
            ("mistral_bf16", TRAIN_K5B["mistral"], torch.bfloat16, False),
            ("granite_f32", TRAIN_K5B["granite"], torch.float32, False),
            ("granite_bf16_strided_dout", TRAIN_K5B["granite"], torch.bfloat16, True),
            ("noncausal_ragged_bf16", (2, 1000, 2100, 8, 2, 64, False), torch.bfloat16, False),
            ("noncausal_ragged_f32", (2, 1000, 2100, 8, 2, 64, False), torch.float32, False)):
        errs, e_lse, _ = check_k5b(fa, fb, torch, gen, (b, t, h, d), (b, s, kv, d), dt, causal, strided)
        note(str(dt).replace("torch.", ""), errs, e_lse)
        big[label] = {"q": [b, t, h, d], "kv": [b, s, kv, d], "causal": causal,
                      "max_abs_err": dict(zip(("dq", "dk", "dv", "lse"), errs + [e_lse]))}
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit({"phase": "k5b", "cases": cases,
          "max_abs_err": {k: dict(zip(("dq", "dk", "dv", "lse"), v)) for k, v in worst.items()},
          "limits": {"grad": "1e-5 + 2e-5 max|w| + 1e-3 |w| (f32), 1e-5 + 4e-3 max|w| + 1e-2 |w| (bf16)",
                     "lse": {"float32": lse_limit(torch.float32), "bfloat16": lse_limit(torch.bfloat16)}},
          "training_shapes": big, "k5_output_unchanged_by_lse": True})


#: nemotron-4-340b's head dim, which only the bfloat16 kernels take, and a
#: rank's attention at tp 16 (96 / 16 = 6 q heads against 1 kv head): the
#: training and prefill shape at T 4,096 and a decode step of 8 slots.
D192_TRAIN = (1, 4096, 4096, 6, 1, 192, True)
D192_DECODE = ((8, 6, 192), (8, 4096, 1, 192))


def phase_head_dim_192(fa, fb, da, torch, gen) -> None:
    """K5, K5b (with K5's lse) and K6 at head dim 192 in bfloat16 against
    their plain versions: G 1, 3, 4, 7 x (T, S) in (1, 1), (7, 130), (64,
    64), (130, 130), (130, 7), (1000, 1000), causal or not, and K6 over
    caches of 1, 300 and 4096 positions (lengths 1, S and random between)
    and slots of length 0; q, k, v as strided views of one fused projection;
    float32 at 192 raises.  Then eager and graph ms of each beside its plain
    version, the library's and its bound at a nemotron-4-340b rank's shapes
    (``D192_TRAIN``, ``D192_DECODE``)."""
    dt, d = torch.bfloat16, 192
    worst = {"k5": 0.0, "k5b": [0.0, 0.0, 0.0, 0.0], "k6": 0.0}
    cases = 0
    for g in (1, 3, 4, 7):
        for t, s in ((1, 1), (7, 130), (64, 64), (130, 130), (130, 7), (1000, 1000)):
            for causal in (True, False):
                err, _ = check_k5(fa, torch, gen, (2, t, 2 * g, d), (2, s, 2, d), dt, causal)
                worst["k5"] = max(worst["k5"], err)
                errs, e_lse, _ = check_k5b(fa, fb, torch, gen, (2, t, 2 * g, d), (2, s, 2, d), dt, causal)
                worst["k5b"] = [max(a, b) for a, b in zip(worst["k5b"], errs + [e_lse])]
                cases += 2
        for b, s in ((1, 1), (3, 300), (4, 4096)):
            lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
            lengths[0] = 1
            lengths[-1] = s
            err, _ = check_k6(da, torch, gen, (b, 2 * g, d), (b, s, 2, d), dt, lengths)
            worst["k6"] = max(worst["k6"], err)
            cases += 1
        lengths = torch.tensor([0, 7, 1000, 0], dtype=torch.int32, device="cuda")
        err, _ = check_k6(da, torch, gen, (4, 2 * g, d), (4, 777, 2, d), dt, lengths)
        worst["k6"] = max(worst["k6"], err)
        cases += 1
    qkv = randn(torch, gen, (2, 150, 12, d), dt, QK_SCALE)  # 8 q heads, 2 + 2 kv heads
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    for causal in (True, False):
        worst["k5"] = max(worst["k5"], allclose_err(
            fa.flash_attention(q, k, v, causal=causal),
            fa.flash_attention_plain(q, k, v, causal=causal), "K5 on strided views (d 192)"))
        cases += 1
    x = randn(torch, gen, (1, 8, 2, d), torch.float32)
    for what, call in (("K5", lambda: fa.flash_attention(x, x, x)),
                       ("K6", lambda: da.decode_attention(x[:, 0], x, x, torch.ones(1, dtype=torch.int32,
                                                                                     device="cuda")))):
        try:
            call()
            fail(f"{what} took head dim 192 in float32, which no kernel is built for")
        except ValueError:
            pass
    (b, t, s, h, kv, _, causal), (q6, c6) = D192_TRAIN, D192_DECODE
    rows = {"flash_attention": k5_row_at(torch, gen, (b, t, h, d), (b, s, kv, d), dt, causal),
            "flash_attention_bwd": k5b_row(fa, fb, torch, gen, D192_TRAIN),
            "decode_attention": k6_row_at(torch, gen, q6, c6, dt, [c6[1]] * c6[0], None)}
    torch.cuda.synchronize()
    emit({"phase": "head_dim_192", "cases": cases,
          "max_abs_err": {"k5": worst["k5"], "k5b": dict(zip(("dq", "dk", "dv", "lse"), worst["k5b"])),
                          "k6": worst["k6"]},
          "float32_raises": True, "rows": rows})


def k5b_work(b: int, t: int, h: int, kv: int, d: int, itemsize: int, causal: bool,
             s: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of one K5b call of T query rows against S keys (``s``,
    default T): five products (s, dp, dv, dq, dk) of 2 flops per
    multiply-add over the visible (row, col) pairs (as :func:`k5_work`
    counts them); q, o, dO, the lse and dq of T rows, k, v, dk and dv of S
    rows, each read or written once."""
    s = t if s is None else s
    pairs = t * (t + 1) / 2 if causal else t * s
    return (10.0 * b * h * d * pairs,
            (4.0 * b * t * h * d + 4.0 * b * s * kv * d) * itemsize + 4.0 * b * h * t)


def k5b_row(fa, fb, torch, gen, shape, launches: int | None = None, per_step: int | None = None) -> dict:
    """A K5b kernels-line row at a training shape: eager ms, graph ms, the
    plain twin's ms, and the backward of ``scaled_dot_product_attention``
    (``enable_gqa``) timed on its own (its forward is outside the window);
    ``launches`` and ``launches_per_train_step`` where a path's run counted
    them."""
    import torch.nn.functional as F

    from repro_torch.kernels import build

    b, t, s, h, kv, d, causal = shape
    errs, _, (q, k, v, o, do, lse) = check_k5b(fa, fb, torch, gen, (b, t, h, d), (b, s, kv, d),
                                               torch.bfloat16, causal)
    flops, bytes_ = k5b_work(b, t, h, kv, d, q.element_size(), causal, s)
    b_ms, b_by = attn_bound(flops, bytes_)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2)
    kern = lambda: fb.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)  # noqa: E731
    nodes = build.graph_kernel_launches(kern)
    if nodes != fb.KERNELS_PER_CALL:
        fail(f"a K5b call put {nodes} kernels on the card, want {fb.KERNELS_PER_CALL}")
    row = {"shape": {"q": [b, t, h, d], "kv": [b, s, kv, d], "causal": causal}, "dtype": "bfloat16",
           "design": "mma.sync bf16", "kernels_per_call": nodes,
           **({} if launches is None else {"launches": launches, "launches_per_train_step": per_step}),
           "max_abs_err": max(errs),
           "ms": cuda_ms(kern), "graph_ms": graph_ms(kern),
           "plain_ms": cuda_ms(lambda: fb.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal), 3),
           "library_ms": cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)),
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": bytes_}
    del q, k, v, o, do, lse, qt, kt, vt, ot
    torch.cuda.empty_cache()
    return row


def wkv_limit(want):
    """Elementwise limit on |K7 or K7b - plain|: both run the recurrence in
    float32 with the same products, summed in other orders (and K7b's dw and
    dk against a state recomputed from checkpoints), carried over up to
    2,048 steps: 1e-5 + 1e-5 of the tensor's largest |want| + 1e-4 |want|.
    A dropped term (u, a decay, a step of the state) moves them by far more."""
    w = want.abs()
    return 1e-5 + 1e-5 * w.max() + 1e-4 * w


def wkv_inputs(torch, gen, b: int, t: int, h: int, n: int = 64):
    """Fresh K7/K7b inputs: r, k, v and dy unit normals, decays exp(-exp(w))
    for w uniform on [-8, 3] (0.9997 down to 2e-9), u a unit normal and s0
    half of one: none of the terms is zero."""
    r, k, v, dy = (torch.randn(b, t, h, n, generator=gen, device="cuda") for _ in range(4))
    w = torch.exp(-torch.exp(torch.rand(b, t, h, n, generator=gen, device="cuda") * 11 - 8))
    u = torch.randn(h, n, generator=gen, device="cuda")
    s0 = torch.randn(b, h, n, n, generator=gen, device="cuda") * 0.5
    return r, k, v, w, u, s0, dy


def held(name: str, got, want, what: str) -> float:
    """The largest |got - want|; fails beyond ``wkv_limit``."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name} ({what}): shape {tuple(got.shape)} against {tuple(want.shape)}, or a non-finite value")
    diff = (got - want).abs()
    if (diff > wkv_limit(want)).any():
        fail(f"{name} ({what}) differs from its plain version by {diff.max().item()} "
             f"(largest {want.abs().max().item()})")
    return diff.max().item()


def check_k7(wk, torch, gen, b: int, t: int, h: int, same_bytes: bool = False) -> tuple[dict, tuple]:
    """K7 and K7b against their plain versions on fresh inputs: the largest
    error of each output, and the inputs.  With ``same_bytes`` a second K7b
    call must give the first one's bytes."""
    ins = wkv_inputs(torch, gen, b, t, h)
    r, k, v, w, u, s0, dy = ins
    what = f"B {b}, T {t}, H {h}"
    errs = {}
    for name, got, want in zip(("y", "state"), wk.wkv(r, k, v, w, u, s0), wk.wkv_plain(r, k, v, w, u, s0)):
        errs[name] = held(f"K7 {name}", got, want, what)
    got = wk.wkv_bwd(r, k, v, w, u, s0, dy)
    if same_bytes and not all(torch.equal(a, c) for a, c in zip(got, wk.wkv_bwd(r, k, v, w, u, s0, dy))):
        fail(f"two K7b calls ({what}) gave different bytes")
    want = wk.wkv_bwd_plain(r, k, v, w, u, s0, dy)
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        errs[name] = held(f"K7b {name}", g, w_, what)
    del got, want
    return errs, ins


def k7_in_place(wk, torch, gen) -> dict:
    """K7 at T 1 in place on two slices of a stacked (L, B, H, 64, 64) cache:
    a layer's (every slot) and one slot of a layer (the engine's view: batch
    stride L's, 1 row), against the plain version on copies; the other
    slices keep their bytes."""
    cache = torch.randn(5, 4, 32, 64, 64, generator=gen, device="cuda")
    out = {}
    for label, index, b in (("layer", (2,), 4), ("slot", (3, slice(1, 2)), 1)):
        r, k, v, w, u, _, _ = wkv_inputs(torch, gen, b, 1, 32)
        before = cache.clone()
        state = cache[index]
        want_y, want_s = wk.wkv_plain(r, k, v, w, u, state.clone())
        y, s = wk.wkv(r, k, v, w, u, state, in_place=True)
        torch.cuda.synchronize()
        if s.data_ptr() != state.data_ptr():
            fail("K7 in place returned another tensor than the given state")
        out[label] = {"y": held("K7 y", y, want_y, f"in place, {label}"),
                      "state": held("K7 state", cache[index], want_s, f"in place, {label}")}
        before[index] = cache[index]
        if not torch.equal(before, cache):
            fail(f"K7 in place ({label}) wrote outside its slice of the cache")
    return out


def k7_work(b: int, t: int, h: int, n: int = 64, backward: bool = False) -> tuple[float, float]:
    """(flops, bytes) of one K7 or K7b call.  K7: 5 flops per state element
    and step (the read's FMA, the update's multiply and FMA); r, k, v, w, u,
    s0 read once, y and the state written once.  K7b: 14 (the state
    recomputed, 3; G's update, 3; the reads of dr, dk, dv and dw, an FMA
    each); r, k, v, w, dy, u, s0 read once, dr, dk, dv, dw and du written
    once (the checkpoints are the design's own traffic, not counted)."""
    seq = 4.0 * b * t * h * n
    state = 4.0 * b * h * n * n
    if backward:
        return 14.0 * b * t * h * n * n, 9 * seq + state + 2 * 4.0 * h * n
    return 5.0 * b * t * h * n * n, 5 * seq + 2 * state + 4.0 * h * n


def f32_bound(flops: float, bytes_: float) -> tuple[float, str]:
    """The least time on an H100 at float32 CUDA-core rate: ms and the
    larger of the two terms."""
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_k7(wk, torch, gen) -> dict:
    """K7 and K7b against their plain versions (``K7_SMALL``, ``K7_RAGGED``,
    the training shape ``K7_TRAIN``; limits ``wkv_limit``; K7b's bytes equal
    over two calls at the training shape), K7 in place on cache slices, the
    stride check that raises, and K7b's kernel nodes a call; then the times
    at the training shape for the kernels line."""
    import dataclasses

    from repro_torch.kernels import build

    worst: dict[str, float] = {}
    for b, t, h in K7_SMALL + K7_RAGGED:
        errs, _ = check_k7(wk, torch, gen, b, t, h)
        worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
    in_place = k7_in_place(wk, torch, gen)
    r, k, v, w, u, s0, dy = wkv_inputs(torch, gen, 2, 5, 3)
    try:
        wk.wkv(r.transpose(1, 3).contiguous().transpose(1, 3), k, v, w, u, s0)
    except ValueError:
        pass
    else:
        fail("K7 took an r whose last axis is not contiguous")
    train_errs, (r, k, v, w, u, s0, dy) = check_k7(wk, torch, gen, *K7_TRAIN, same_bytes=True)
    bwd = lambda: wk.wkv_bwd(r, k, v, w, u, s0, dy)  # noqa: E731
    b, t, h = K7_TRAIN
    plan = wk.launch_plan(b, t, h)
    passes = [p.kernel for p in plan.backward]
    graph, _ = build.capture(bwd)
    nodes = build.graph_kernel_nodes(graph, passes)
    graph.reset()
    ours = sum(nodes[e] for e in passes)
    if ours != wk.KERNELS_PER_CALL or any(nodes[e] != 1 for e in passes):
        fail(f"a K7b call put {nodes} kernels on the card, want each pass once ({wk.KERNELS_PER_CALL})")
    rows = {}
    for name, kern, plain, backward in (
            ("wkv", lambda: wk.wkv(r, k, v, w, u, s0), lambda: wk.wkv_plain(r, k, v, w, u, s0), False),
            ("wkv_bwd", bwd, lambda: wk.wkv_bwd_plain(r, k, v, w, u, s0, dy), True)):
        flops, bytes_ = k7_work(b, t, h, backward=backward)
        b_ms, b_by = f32_bound(flops, bytes_)
        ms = cuda_ms(kern)
        rows[name] = {"shape": {"r": [b, t, h, 64], "state": [b, h, 64, 64]}, "dtype": "float32",
                      "ms": ms, "graph_ms": graph_ms(kern), "plain_ms": cuda_ms(plain, 3),
                      "library_ms": None,
                      "library_note": "no single PyTorch call computes the WKV recurrence (or its gradient)",
                      "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "flops": flops,
                      "bytes": bytes_}
        torch.cuda.empty_cache()
    rows["wkv"]["max_abs_err"] = max(train_errs[k] for k in ("y", "state"))
    rows["wkv_bwd"]["max_abs_err"] = max(train_errs[k] for k in ("dr", "dk", "dv", "dw", "du"))
    rows["wkv"]["plan"] = dataclasses.asdict(plan.forward)
    rows["wkv_bwd"].update(kernels_per_call=ours, graph_kernel_nodes_per_call=nodes["all"],
                           plan=[dataclasses.asdict(p) for p in plan.backward],
                           checkpoint_steps=list(plan.checkpoint_steps), checkpoint_bytes=plan.scratch_bytes)
    del r, k, v, w, u, s0, dy
    torch.cuda.empty_cache()
    emit({"phase": "k7", "small_shapes": [list(x) for x in K7_SMALL], "ragged_shapes": [list(x) for x in K7_RAGGED],
          "max_abs_err_small_and_ragged": worst, "in_place_t1": in_place, "training_shape": list(K7_TRAIN),
          "max_abs_err_training": train_errs, "k7b_same_bytes_twice": True, "k7b_kernel_nodes": nodes,
          "stride_check_raises": True, "limit": "1e-5 + 1e-5 max|plain| + 1e-4 |plain|, elementwise"})
    return rows


def k7_serve_times(wk, torch, gen, serve: dict) -> dict:
    """K7 at the serve run's shapes: its largest prefill (B 1) and the decode
    step (B = slots, T 1, in place on a layer of a stacked cache), each
    against its plain version, eager and graph ms beside the bound."""
    import dataclasses

    out = {}
    b, t, h, n = serve["k7_prefill_shape"]
    cache = torch.zeros(4, serve["slots"], h, n, n, device="cuda")
    for label, (bb, tt) in (("prefill", (b, t)), ("decode", (serve["slots"], 1))):
        errs, (r, k, v, w, u, s0, _) = check_k7(wk, torch, gen, bb, tt, h)
        state = cache[1] if label == "decode" else s0
        kern = lambda: wk.wkv(r, k, v, w, u, state, in_place=label == "decode")  # noqa: E731
        flops, bytes_ = k7_work(bb, tt, h)
        b_ms, b_by = f32_bound(flops, bytes_)
        out[label] = {"shape": [bb, tt, h, n], "max_abs_err": max(errs["y"], errs["state"]), "ms": cuda_ms(kern),
                      "graph_ms": graph_ms(kern), "plain_ms": cuda_ms(lambda: wk.wkv_plain(r, k, v, w, u, s0), 3),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "plan": dataclasses.asdict(wk.launch_plan(bb, tt, h).forward)}
    torch.cuda.empty_cache()
    return out


class PlainKernels:
    """Swaps every kernel of the training path for its plain version (K5 and
    K5b in ``models.attention``, K3 in ``kernels.bitonic``, K7 and K7b in
    ``models.rwkv6``): a check-only route for one step, never a fallback."""

    def __init__(self) -> None:
        from repro_torch.kernels import bitonic as bt
        from repro_torch.kernels import flash_attention as fa_mod
        from repro_torch.kernels import flash_attention_bwd as fb_mod
        from repro_torch.kernels import wkv as wkv_mod
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import rwkv6 as rwkv_mod

        self.swaps = [(attn_mod, "flash_attention", fa_mod.flash_attention_plain),
                      (attn_mod, "flash_attention_bwd", fb_mod.flash_attention_bwd_plain),
                      (bt, "sort_rows_kv", bt.sort_rows_kv_plain),
                      (rwkv_mod, "wkv", wkv_mod.wkv_plain), (rwkv_mod, "wkv_bwd", wkv_mod.wkv_bwd_plain)]
        self.saved = [getattr(m, a) for m, a, _ in self.swaps]

    def __enter__(self):
        for m, a, plain in self.swaps:
            setattr(m, a, plain)
        return self

    def __exit__(self, *exc):
        for (m, a, _), orig in zip(self.swaps, self.saved):
            setattr(m, a, orig)
        return False


def train_stages(torch, model, opt_state, opt_cfg, batch) -> dict:
    """One more step cut into its stages, each between two synchronisations:
    the forward (loss), the backward (the per-block recompute, K5b and every
    gradient) and AdamW."""
    from repro_torch.train.optimizer import apply_updates

    params = dict(model.named_parameters())
    _sync(torch)
    t0 = time.perf_counter()
    loss, _ = model.loss(batch)
    _sync(torch)
    t1 = time.perf_counter()
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True))}
    _sync(torch)
    t2 = time.perf_counter()
    apply_updates(params, grads, opt_state, opt_cfg)
    _sync(torch)
    t3 = time.perf_counter()
    return {"forward_s": t1 - t0, "backward_s": t2 - t1, "optimizer_s": t3 - t2}


def step_profile(torch, step, opt_state, batch) -> dict:
    """One train step under ``torch.profiler``: busy share, the top kernels,
    and the device time of the step's parts by kernel name: K5b, K5, K3, the
    GEMMs (cuBLAS's ``nvjet`` kernels), the gathers and scatters, torch's
    elementwise passes and copies (AdamW's f32 passes, casts, norms,
    activations) and the rest."""
    fields, by_name = profiled(torch, lambda: step(opt_state, batch))
    groups = {"k5b": ("bwd_dkdv", "bwd_dq", "bwd_delta"), "k5": ("flash_fwd",),
              "k3": ("chunk_stages", "strided_stages", "global_stage"),
              "gemm": ("nvjet", "gemm", "sm90_xmma", "cutlass"),
              "gather_scatter": ("index", "scatter", "gather", "Indexing"),
              "elementwise_copy": ("elementwise", "Memcpy", "copy")}
    parts = {g: 0.0 for g in groups}
    parts["other"] = 0.0
    for name, (ms, _) in by_name.items():
        for g, keys in groups.items():
            if any(key in name for key in keys):
                parts[g] += ms
                break
        else:
            parts["other"] += ms
    return {**fields, "device_ms_by_part": parts}


def train_flops(cfg, batch: int, seq: int, frames: int = 0) -> float:
    """Model flops of one train step (recompute not counted): 6 per weight of
    every matrix a token passes through (the MoE's router and its top_k
    experts, not every slab; the head; no embedding lookup) per token,
    attention's q.k and p.v at 12 per visible causal (row, col) pair per
    head dim (4 forward, 8 backward), a Mamba2 layer's SSD products, and an
    RWKV6 layer's WKV at 12 per state element a token and head (its read
    and its update, an FMA each, 3 x forward).  The encoder-decoder: the
    encoder's matrices per frame, the decoder's (with the cross-attention's
    q and o) per token and its cross k and v per frame and decoder layer;
    T x S pairs where there is no causal mask."""
    L, D = cfg.num_layers, cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    attn = 2 * D * H * hd + 2 * D * KV * hd
    ffn = lambda f: D * f * (3 if cfg.mlp_gated else 2)  # noqa: E731
    if cfg.is_encdec:
        enc, dec, Le = batch * frames, batch * seq, cfg.encoder_layers
        mats = Le * (attn + ffn(cfg.d_ff)) * enc + L * (attn + 2 * D * H * hd + ffn(cfg.d_ff)) * dec \
            + L * 2 * D * KV * hd * enc + D * cfg.vocab_size * dec
        pairs = Le * frames * frames + L * (seq * (seq + 1) / 2 + seq * frames)
        return 6.0 * mats + 12.0 * batch * H * hd * pairs
    n_attn = attention_layers(cfg)
    ssd = 0.0
    if cfg.ssm is not None:
        # a Mamba2 layer's projections (z, x, B, C, dt in; out), the shared
        # block's attention and MLP once an invocation, and the chunked SSD's
        # products per token and head (C.B over a chunk of Q, its weights
        # times x.dt, the chunk's end state, the state read by C), 3 x forward
        from repro_torch.models.mamba2 import chunk_len, dims

        s, d_inner, nh = dims(cfg)
        Q, N, P = chunk_len(cfg, seq), s.state_dim, s.head_dim
        mats = L * (D * (2 * d_inner + 2 * s.num_groups * N + nh) + d_inner * D) + n_attn * (attn + ffn(cfg.d_ff))
        ssd = 3.0 * L * nh * (2 * Q * N + 2 * Q * P + 4 * N * P) * batch * seq
    elif cfg.rwkv is not None:
        # the time mix's five D x D projections and low-rank mixers (decay
        # and the five token-shift mixes, in and out), the channel mix
        r = cfg.rwkv
        hs, H = r.head_size, D // r.head_size
        mats = L * (5 * D * D + 2 * D * r.decay_lora + 10 * D * r.mix_lora + 2 * D * cfg.d_ff + D * D)
        ssd = 12.0 * L * H * hs * hs * batch * seq
    elif cfg.moe:
        m = cfg.moe
        moe = D * m.num_experts + m.top_k * ffn(m.d_expert) + (ffn(m.num_shared * m.d_expert) if m.num_shared else 0)
        mats = m.first_dense_layers * (attn + ffn(m.d_ff_dense or cfg.d_ff)) + (L - m.first_dense_layers) * (attn + moe)
    else:
        mats = L * (attn + ffn(cfg.d_ff))
    mats += D * cfg.vocab_size
    return 6.0 * mats * batch * seq + ssd + 12.0 * n_attn * batch * H * hd * seq * (seq + 1) / 2


def recurrent_stages(torch, model, batch, adamw_s: float, step_s: float) -> dict:
    """A Mamba2 or RWKV6 model's step by its parts: one block's forward and
    backward as training runs it (checkpointed: the backward recomputes the
    forward; an RWKV6 block runs K7 twice and K7b once) and one
    shared-block invocation's, each on a fresh (B, T, D) input in the
    model's dtype between two synchronisations (median of three), times the
    blocks and invocations of a step; AdamW's stage; and the rest of the
    step (embedding, final norm, head, loss, the clip)."""
    from torch.utils.checkpoint import checkpoint

    B, T = batch["tokens"].shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    positions = torch.arange(T, device="cuda")[None, :]

    def timed(fn, block) -> float:
        leaves = [p for p in block.parameters()]
        times = []
        for _ in range(3):
            x = torch.randn(B, T, model.cfg.d_model, generator=gen, device="cuda").to(model.dtype).requires_grad_(True)
            _sync(torch)
            t0 = time.perf_counter()
            y = fn(x)
            torch.autograd.grad(y, [x] + leaves, torch.ones_like(y))
            _sync(torch)
            times.append(time.perf_counter() - t0)
        return float(sorted(times)[1])

    kind, layer_fn = ("rwkv", model._rwkv_layer) if model.kind == "rwkv" else ("mamba", model._mamba_layer)
    block = timed(lambda x: checkpoint(layer_fn, model.layers[0], x, positions, False, use_reentrant=False)[0],
                  model.layers[0])
    n_blocks, n_shared = model.cfg.num_layers, attention_layers(model.cfg)
    out = {f"{kind}_block_s": block, f"{kind}_blocks": n_blocks, f"{kind}_blocks_s": n_blocks * block}
    shared_s = 0.0
    if n_shared:
        shared = timed(lambda x: checkpoint(model._block, model.shared, x, positions, False, use_reentrant=False)[0],
                       model.shared)
        shared_s = n_shared * shared
        out.update({"shared_invocation_s": shared, "shared_invocations": n_shared, "shared_blocks_s": shared_s})
    out.update({"adamw_s": adamw_s, "step_s_median": step_s,
                "rest_s": step_s - n_blocks * block - shared_s - adamw_s})
    return out


def batch_source(torch, cfg, batch: int, seq: int, seed: int, dev: str, frames: int = 0):
    """A function giving the next training batch on ``dev``: a token model's
    from ``TokenPipeline(seed)``; the encoder-decoder's ``enc_embeds`` (B,
    ``frames``, D), ``tokens`` and ``labels`` (B, ``seq``), an embeddings
    model's ``embeds`` (B, ``seq``, D) and ``labels``, drawn from ``seed``
    on the device as ``data.synthetic.make_batch`` draws them (embeddings N(0,
    1) x ``EMBED_SCALE`` in the model's type, ids uniform in the
    vocabulary)."""
    from repro_torch.data.tokens import TokenPipeline

    if not cfg.is_encdec and cfg.input_kind == "tokens":
        pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=seed)
        return lambda: {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)

    def rows(n):
        return (torch.randn(batch, n, cfg.d_model, generator=gen, device=dev) * EMBED_SCALE).to(dt)

    def ids():
        return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev, dtype=torch.int32)

    def draw() -> dict:
        out = {"enc_embeds": rows(frames), "tokens": ids()} if cfg.is_encdec else {"embeds": rows(seq)}
        out["labels"] = ids()
        return out

    return draw


def phase_train(torch, np, args, run: dict, phase: str, plain_check: bool, dev: str = "cuda") -> dict:
    """One training path at full width: ``run["steps"]`` AdamW steps of the
    model from ``--seed`` on ``TokenPipeline`` batches (an embeddings
    model's from :func:`batch_source`, ``run["frames"]`` encoder frames a
    row for the encoder-decoder), the first timed apart.  Each step's launches are counted (zeroed just before the step,
    read just after) and held exactly to K5 2 x attention layers (the
    forward and the block's recompute; the hybrid's shared-block
    invocations), K5b 1 x attention layers, K3 2 x MoE layers, K7 2 x and
    K7b 1 x RWKV6 layers.  Then one step cut into stages (a Mamba2 or RWKV6
    model's also into its blocks: :func:`recurrent_stages`; with
    ``--profile`` one profiled), and with ``plain_check`` the first step
    again from the same seed with every kernel swapped for its plain
    version: its loss within 1e-2 relative and its gradient norm within
    5e-2 of the kernels' (bf16: K5 rounds its probabilities to bf16 where
    the plain one keeps f32, and the router's top-k flips near-ties on such
    a difference).  A run with ``plain_batch`` makes that check at the cut
    shape ``plain_batch`` x ``plain_seq`` instead: the first step of that
    shape with the kernels, then with them plain, each from the same seed,
    on a fresh model of ``plain_dtype`` and ``plain_layers`` (the trained
    model freed first), within 1e-3 (loss) and 1e-2 (gradient norm)
    relative in float32."""
    import dataclasses

    from repro_torch import configs, models
    from repro_torch.kernels import build
    from repro_torch.obs.costs import part_bytes
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step

    cfg = configs.get_config(run["arch"])
    reduced = {}
    if run.get("layers"):
        reduced = {"num_layers": f"{cfg.num_layers} -> {run['layers']} (AdamW's f32 moments of every layer do "
                                 "not fit one card)"}
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    frames = run.get("frames", 0)
    moe_layers = cfg.num_layers - cfg.moe.first_dense_layers if cfg.moe else 0
    if dev == "cuda":
        torch.cuda.empty_cache()
    _reset_peak(torch)
    t0 = time.perf_counter()
    model = models.build(cfg, device=dev).requires_grad_(True)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt_cfg = AdamWConfig(lr=run["lr"])
    opt_state = init_opt_state(dict(model.named_parameters()), opt_cfg)
    step = build_train_step(model, opt_cfg)
    _sync(torch)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    next_batch = batch_source(torch, cfg, run["batch"], run["seq"], args.seed, dev, frames)
    attn_layers = attention_layers(cfg)
    wkv_layers = rwkv_layers(cfg)
    want = {"flash_attention": 2 * attn_layers, "flash_attention_bwd": attn_layers,
            "row_sort_kv": 2 * moe_layers, "wkv": 2 * wkv_layers, "wkv_bwd": wkv_layers,
            "row_sort": 0, "tournament": 0, "merge_rows": 0, "decode_attention": 0}
    steps, first_batch = [], None
    with AttnRecorder(attn_mod, "flash_attention_bwd") as k5b_in, MoERecorder(moe_mod) as moe_rec:
        for i in range(run["steps"]):
            batch = next_batch()
            first_batch = first_batch or batch
            n_moe = len(moe_rec.dropped)
            _sync(torch)
            build.reset_launches()
            t_step = time.perf_counter()
            opt_state, met = step(opt_state, batch)
            _sync(torch)
            dt = time.perf_counter() - t_step
            launches = dict(build.LAUNCHES)
            for name, n in want.items():
                if launches[name] != n:
                    fail(f"{phase} step {i}: {name} launched {launches[name]} times, want {n}")
            rec = {"step": i, "s": dt, "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                   "lr": float(met["lr"])}
            if moe_layers:  # the forward's calls; the recompute repeats them
                rec["dropped_assignments"] = int(torch.stack(moe_rec.dropped[n_moe:n_moe + moe_layers]).sum())
            if not all(np.isfinite([rec["loss"], rec["grad_norm"]])):
                fail(f"{phase} step {i}: loss {rec['loss']} or grad norm {rec['grad_norm']} is not finite")
            steps.append(rec)
    peak, reserved = _peak(torch), _reserved(torch)
    # what the dry run's calibration holds its arguments and peak to
    held = part_bytes(params={**dict(model.named_parameters()), **dict(model.named_buffers())},
                      opt_state=opt_state, batch=first_batch)
    rest = [r["s"] for r in steps[1:]]
    tokens = run["batch"] * run["seq"]
    flops = train_flops(cfg, run["batch"], run["seq"], frames)
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "reduced": reduced, "params": n_params, "config": run,
            "optimizer": dataclasses.asdict(opt_cfg), "init_s": init_s, "first_step_s": steps[0]["s"],
            "step_s_median": float(np.median(rest)), "step_s_min": min(rest), "step_s_max": max(rest),
            "tokens_per_step": tokens, "tokens_per_s": tokens / float(np.median(rest)),
            "model_flops_per_step": flops,
            "model_flops_utilization": flops / float(np.median(rest)) / BF16_FLOP_PER_S,
            "peak_allocated_bytes": peak, "reserved_bytes": reserved, "launches_per_step": want,
            "steps": steps, "stages": train_stages(torch, model, opt_state, opt_cfg, first_batch)}
    if frames:
        line.update(frames_per_step=run["batch"] * frames,
                    frames_per_s=run["batch"] * frames / float(np.median(rest)))
    if cfg.ssm is not None or cfg.rwkv is not None:
        line["train_stages"] = recurrent_stages(torch, model, first_batch, line["stages"]["optimizer_s"],
                                                line["step_s_median"])
    if args.profile:
        line["profile"] = step_profile(torch, step, opt_state, first_batch)
    if plain_check:
        limits = {"loss": 1e-2, "grad_norm": 5e-2}
        if run.get("plain_dtype"):
            del model, opt_state, step
            if dev == "cuda":
                torch.cuda.empty_cache()
            cut_cfg = dataclasses.replace(cfg, dtype=run["plain_dtype"],
                                          num_layers=run.get("plain_layers", cfg.num_layers))
            if cfg.is_encdec:
                cut_cfg = dataclasses.replace(cut_cfg, encoder_layers=run.get("plain_layers", cfg.encoder_layers))
            model = models.build(cut_cfg, device=dev).requires_grad_(True)
            opt_state = init_opt_state(dict(model.named_parameters()), opt_cfg)
            step = build_train_step(model, opt_cfg)
            limits = {"loss": 1e-3, "grad_norm": 1e-2}

        def first_step(batch, plain: bool):
            with torch.no_grad():
                model.init(torch.Generator(device=dev).manual_seed(args.seed))
                for part in ("m", "v"):
                    for t in opt_state[part].values():
                        t.zero_()
                opt_state["step"].zero_()
            build.reset_launches()
            if not plain:
                _, met = step(opt_state, batch)
                _sync(torch)
                return met
            with PlainKernels():
                _, met = step(opt_state, batch)
                _sync(torch)
            if any(build.LAUNCHES[k] for k in ("flash_attention", "flash_attention_bwd", "row_sort_kv", "wkv",
                                                "wkv_bwd")):
                fail(f"{phase}: the plain-kernel step launched a kernel")
            return met

        want_loss, want_gnorm, cut = steps[0]["loss"], steps[0]["grad_norm"], None
        if run.get("plain_batch"):
            cut = {"batch": run["plain_batch"], "seq": run["plain_seq"],
                   "layers": run.get("plain_layers", cfg.num_layers), "dtype": run.get("plain_dtype", cfg.dtype)}
            first_batch = batch_source(torch, model.cfg, cut["batch"], cut["seq"], args.seed, dev, frames)()
            met = first_step(first_batch, plain=False)
            want_loss, want_gnorm = float(met["loss"]), float(met["grad_norm"])
        met = first_step(first_batch, plain=True)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        d_loss = abs(loss - want_loss) / abs(want_loss)
        d_gnorm = abs(gnorm - want_gnorm) / want_gnorm
        if not (d_loss <= limits["loss"] and d_gnorm <= limits["grad_norm"]):
            fail(f"{phase}: the plain-kernel step gives loss {loss} / grad norm {gnorm}, the kernels "
                 f"{want_loss} / {want_gnorm}")
        line["plain_kernels_first_step"] = {"loss": loss, "grad_norm": gnorm, "loss_rel_diff": d_loss,
                                            "grad_norm_rel_diff": d_gnorm, "limits": limits}
        if cut:
            line["plain_kernels_first_step"].update(cut_shape=cut, kernels_loss=want_loss,
                                                    kernels_grad_norm=want_gnorm)
    emit(line)
    del model, opt_state, step, first_batch, moe_rec
    if dev == "cuda":
        torch.cuda.empty_cache()
    out = {"k5_per_step": want["flash_attention"], "k5b_per_step": want["flash_attention_bwd"],
           "k5b_launches": want["flash_attention_bwd"] * run["steps"], "argument_bytes": held,
           "peak_allocated_bytes": peak,
           "k7_per_step": want["wkv"], "k7b_per_step": want["wkv_bwd"], "k7b_launches": want["wkv_bwd"] * run["steps"]}
    if attn_layers:
        shapes = k5b_in.shapes()
        out["k5b_shape"] = max(shapes, key=lambda sh: sh[0] * sh[1] * sh[3] * sh[5])
        out["k5b_shapes"] = {sh: n // run["steps"] for sh, n in shapes.items()}
    return out


def phase_train_resume(torch, args, dev: str = "cuda") -> None:
    """``python -m repro_torch.launch.train`` (in process, its stdout kept) at
    granite-moe-3b-a800m's smoke config in float32 on the card: 6 steps with
    a checkpoint every 3, then the step-6 checkpoint is deleted and the same
    command resumes from step 3.  Steps 3-5 of the resumed run must equal the
    uninterrupted run's loss and gradient norm within 1e-5 relative (the
    card's atomic adds are not bit-reproducible from run to run)."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from repro_torch.launch import train as train_cli

    ckpt = ROOT / "build" / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", TRAIN_RESUME["arch"], "--smoke", "--device", dev, "--dtype", "float32",
            "--steps", "6", "--batch", "4", "--seq", "64", "--ckpt-dir", str(ckpt), "--ckpt-every", "3",
            "--log-every", "1", "--seed", str(args.seed)]
    logs = []
    runs = []
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            runs.append(train_cli.main(argv))
        logs.append(out.getvalue())
        shutil.rmtree(ckpt / "step_0000000006", ignore_errors=True)
    first, second = runs
    if "resumed from step 3" not in logs[1] or [r["step"] for r in second] != [3, 4, 5]:
        fail(f"train_resume: the second run did not resume from step 3: {[r['step'] for r in second]}")
    worst = 0.0
    for a, b in zip(first[3:], second):
        for key in ("loss", "grad_norm", "lr"):
            rel = abs(a[key] - b[key]) / max(abs(a[key]), 1e-30)
            worst = max(worst, rel)
            if rel > 1e-5:
                fail(f"train_resume step {a['step']}: {key} {b[key]} resumed, {a[key]} uninterrupted")
    if not all(np.isfinite(r["loss"]) for r in first):
        fail("train_resume: a loss is not finite")
    shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "train_resume", "argv": argv, "steps": first, "resumed": second,
          "max_rel_diff": worst, "limit": 1e-5, "log_lines": sum(len(s.splitlines()) for s in logs)})


def k1_device_epoch(torch, bt, gen, dev: dict) -> dict:
    """K1 at the device epoch's largest input (the root hop's packed int64
    record cells), for the K1 row of the kernels line: its kernel nodes per
    captured epoch, and an eager and a graph call's time at that shape."""
    x = main_path_input(torch, gen, dev["k1_shape"], dev["k1_dtype"], sorted_rows=False)
    err = exact(bt.sort_rows(x), bt.sort_rows_plain(x))
    if err:
        fail("K1 differs from its plain version at the device epoch's shape")
    b_bytes, ce = k1_work(x.shape[0], x.shape[1], x.element_size())
    b_ms, b_by = bound(b_bytes, ce, x.element_size())
    out = {"shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
           "graph_nodes_per_epoch": dev["k1_nodes"], "epochs": dev["epochs"], "max_abs_err": err,
           **timings(lambda: bt.sort_rows(x), lambda: bt.sort_rows_plain(x),
                     lambda: torch.sort(x, dim=1).values),
           "bound_ms": b_ms, "bound_by": b_by}
    del x
    torch.cuda.empty_cache()
    return out


def sort_rows_of(torch, bt, gen, launches, k1_in, k2_in) -> list[dict]:
    """The kernels-line rows of K1 and K2 at the pipeline's largest inputs."""
    rows = []
    x1 = main_path_input(torch, gen, k1_in.shape, k1_in.dtype, sorted_rows=False)
    x2 = main_path_input(torch, gen, k2_in.shape, k2_in.dtype, sorted_rows=True)
    for name, x, kern, plain, lib, work, ops_per, src, replaces in (
        ("row_sort", x1, bt.sort_rows, bt.sort_rows_plain,
         lambda x: torch.sort(x, dim=1).values, k1_work, OPS_PER_COMPARE_EXCHANGE,
         "src/repro_torch/kernels/csrc/row_sort.cu", "src/repro/kernels/bitonic.py:174"),
        ("tournament", x2, bt.merge_tournament, bt.tournament_plain,
         lambda x: torch.sort(x.reshape(-1)).values, k2_work, OPS_PER_MERGE_STEP,
         "src/repro_torch/kernels/csrc/tournament.cu", "src/repro/kernels/bitonic.py:261"),
    ):
        err = exact(kern(x), plain(x))
        if err:
            fail(f"{name} differs from its plain version at the main-path shape")
        b_bytes, ce = work(x.shape[0], x.shape[1], x.element_size())
        b_ms, b_by = bound(b_bytes, ce, x.element_size(), ops_per)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
            **timings(lambda: kern(x), lambda: plain(x), lambda: lib(x)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    del x1, x2
    torch.cuda.empty_cache()
    return rows


def eager_timings(kern, plain, lib, reps: int = 3) -> dict:
    """One eager call each of the kernel, its plain version and the library
    call, at a shape too large for ``timings``' graph of 24 calls."""
    return {"ms": cuda_ms(kern, reps), "plain_ms": cuda_ms(plain, reps), "library_ms": cuda_ms(lib, reps)}


def sharded_sort(torch, args, bt, build, cd, mesh, random_trace) -> tuple[dict, dict]:
    """``sort_sharded`` at one rank on the pipeline phase's input: equal to
    ``torch.sort``, nothing dropped, every key valid, K1 once (the presort);
    then the median of three timed calls.  Returns the line's entry and K1's
    kernels-line entry at the presort's shape."""
    n = args.n
    x = torch.from_numpy(random_trace(n, seed=args.seed)).cuda()
    splitters = cd.make_splitters(x[:: max(1, n // 4096)].cpu().numpy(), 1)
    kw = dict(capacity_factor=SHARDED["capacity_factor"], presort_block=SHARDED["presort_block"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with LargestShape(bt, "sort_rows") as k1_in:
        build.reset_launches()
        t0 = time.perf_counter()
        padded, valid, overflow = cd.sort_sharded(x, mesh, "segment", splitters, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    if launches["row_sort"] != 1:
        fail(f"sort_sharded launched K1 {launches['row_sort']} times, want once (the presort)")
    if any(v for k, v in launches.items() if k != "row_sort"):
        fail(f"sort_sharded launched another kernel: {launches}")
    if int(overflow) or int(valid) != n:
        fail(f"sort_sharded: overflow {int(overflow)}, valid {int(valid)} of {n}")
    if not torch.equal(padded[:n], torch.sort(x).values):
        fail("sort_sharded differs from torch.sort")
    if not bool((padded[n:] == torch.iinfo(torch.int64).max).all()):
        fail("sort_sharded's padding is not the int64 max")
    capacity = padded.numel()
    del padded
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = cd.sort_sharded(x, mesh, "segment", splitters, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del res
    peak = torch.cuda.max_memory_allocated()
    median = sorted(times)[1]
    entry = {"n": n, "dtype": "int64", **kw, "capacity": capacity, "first_s": first_s,
             "seconds": times, "median_s": median, "keys_per_s": n / median,
             "peak_device_bytes": peak, "launches": {"row_sort": launches["row_sort"]}}
    del x
    torch.cuda.empty_cache()
    # K1 at the presort's shape, fresh rows against its plain version
    k1 = main_path_input(torch, torch.Generator(device="cuda").manual_seed(args.seed), k1_in.shape,
                         k1_in.dtype, sorted_rows=False)
    err = exact(bt.sort_rows(k1), bt.sort_rows_plain(k1))
    if err:
        fail("K1 differs from its plain version at the presort's shape")
    b_bytes, ce = k1_work(k1.shape[0], k1.shape[1], k1.element_size())
    b_ms, b_by = bound(b_bytes, ce, k1.element_size())
    k1_row = {"site": "core/distributed.py blockwise_sort (sort_sharded's presort)",
              "shape": list(k1.shape), "dtype": str(k1.dtype).replace("torch.", ""),
              "launches": launches["row_sort"], "max_abs_err": err,
              **eager_timings(lambda: bt.sort_rows(k1), lambda: bt.sort_rows_plain(k1),
                              lambda: torch.sort(k1, dim=1).values),
              "bound_ms": b_ms, "bound_by": b_by}
    del k1
    torch.cuda.empty_cache()
    return entry, k1_row


def sharded_pool(torch, args, build, sharding, run_pipeline, random_trace, trace_max_value) -> dict:
    """``run_pipeline(pool_backend="shard_map")`` on the E2E configuration
    at ``small_n`` and at ``--n`` against ``pool_backend="numpy"``: output and
    passes byte-identical, K1 once per hop and K2 in the shard_map run."""
    out = {"pool_mesh_4": sharding.pool_mesh(E2E["num_servers"]),
           "merge": "concatenation: pool_mesh(4) is None at one rank (fewer ranks than servers)"}
    if out["pool_mesh_4"] is not None:
        fail("pool_mesh(4) is not None at one rank")
    for n in sorted({min(SHARDED["small_n"], args.n), args.n}):
        values = torch.from_numpy(random_trace(n, seed=args.seed)).cuda()
        runs = {}
        for backend in ("numpy", "shard_map"):
            build.reset_launches()
            t0 = time.perf_counter()
            res = run_pipeline(values, max_value=trace_max_value("random"), seed=args.seed,
                               device="cuda", pool_backend=backend, **E2E)
            torch.cuda.synchronize()
            runs[backend] = (res, time.perf_counter() - t0, dict(build.LAUNCHES))
        (a, a_s, _), (b, b_s, launches) = runs["numpy"], runs["shard_map"]
        if not torch.equal(a.output, b.output) or a.passes != b.passes:
            fail(f"the shard_map pool differs from the numpy pool at n={n}")
        if launches["row_sort"] != E2E_HOPS or launches["tournament"] < 1:
            fail(f"the shard_map pipeline's launches at n={n}: {launches}")
        out[str(n)] = {"numpy_s": a_s, "shard_map_s": b_s, "pool_merge_s": b.pool_merge_seconds,
                       "launches": {k: launches[k] for k in ("row_sort", "tournament")}}
        del a, b, runs, values
        torch.cuda.empty_cache()
    return out


def sharded_moe(torch, bt, build, moe, sharding, configs, gen) -> tuple[dict, dict]:
    """``moe_layer_a2a`` at tp = 1 on granite-moe-3b-a800m's MoE layer at full
    width (bf16, 1 x 2,048 tokens) against ``moe_layer`` on the same weights:
    the output, aux, dropped and every gradient of ``sum(y^2) + aux``; K3
    twice a call (the two grouping sorts).  Returns the line's entry and
    K3's kernels-line entry at the a2a's largest sort."""
    import dataclasses

    from repro_torch.models.lm import init_params

    cfg = configs.get_config(SHARDED_MOE["arch"])
    p = init_params(moe.MoE(cfg, torch.bfloat16, "cuda"), gen)
    p.requires_grad_(True)
    ctx = dataclasses.replace(sharding.local_ctx("cuda"), sp=True)
    x = torch.randn((SHARDED_MOE["batch"], SHARDED_MOE["seq"], cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def step(fn):
        p.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        y, aux, dropped = fn(xi)
        (y.float().square().sum() + aux).backward()
        torch.cuda.synchronize()
        return y.detach(), aux.detach(), int(dropped), {"x": xi.grad, **{k: v.grad for k, v in p.named_parameters()}}

    a2a = lambda xi: moe.moe_layer_a2a(p, cfg, ctx, xi)  # noqa: E731
    with LargestShape(bt, "sort_rows_kv") as k3_in:
        build.reset_launches()
        ya, auxa, da, ga = step(a2a)
        launches = dict(build.LAUNCHES)
    if launches["row_sort_kv"] != 2:
        fail(f"moe_layer_a2a launched K3 {launches['row_sort_kv']} times, want 2 (its two sorts)")
    yb, auxb, db, gb = step(lambda xi: moe.moe_layer(p, cfg, xi))
    if da != db:
        fail(f"moe_layer_a2a dropped {da}, moe_layer {db}")
    if abs(float(auxa) - float(auxb)) > 1e-5 * abs(float(auxb)):
        fail(f"moe_layer_a2a's aux {float(auxa)} against moe_layer's {float(auxb)}")

    def rel(u, v) -> float:
        return float((u.float() - v.float()).abs().max() / v.float().abs().max())

    errs = {"y": rel(ya, yb), **{f"grad_{k}": rel(ga[k], gb[k]) for k in gb}}
    bad = {k: e for k, e in errs.items() if not e <= MOE_A2A_LIMIT}
    if bad:
        fail(f"moe_layer_a2a against moe_layer beyond {MOE_A2A_LIMIT}: {bad}")
    times = {}
    for name, fn in (("a2a", a2a), ("moe_layer", lambda xi: moe.moe_layer(p, cfg, xi))):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(fn)
            ts.append(time.perf_counter() - t0)
        times[f"{name}_fwd_bwd_ms"] = sorted(ts)[1] * 1e3
    entry = {"arch": cfg.name, "shape": [SHARDED_MOE["batch"], SHARDED_MOE["seq"], cfg.d_model],
             "dtype": "bfloat16", "tp": 1, "dropped": da, "aux": float(auxa), "limit": MOE_A2A_LIMIT,
             "rel_err": errs, **times, "launches": {"row_sort_kv": launches["row_sort_kv"]}}
    del ya, yb, ga, gb, p, x
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(1)
    real = k3_in.shape[1]
    keys, vals = dispatch_keys(torch, g, 1, real, real, k3_in.dtype, experts=moe.padded_experts(cfg.moe.num_experts) + 1)
    err = check_k3(bt, torch, keys, vals)
    b_bytes, ce = k3_work(1, real, keys.element_size())
    b_ms, b_by = bound(b_bytes, ce, keys.element_size(), OPS_PER_KV_COMPARE_EXCHANGE)
    k3_row = {"site": "models/moe.py moe_layer_a2a (its two stable_argsort calls)",
              "shape": list(keys.shape), "dtype": str(keys.dtype).replace("torch.", ""),
              "launches": launches["row_sort_kv"], "max_abs_err": err,
              "launches_per_call": k3_launches(bt, keys, vals),
              **timings(lambda: bt.sort_rows_kv(keys, vals), lambda: bt.sort_rows_kv_plain(keys, vals),
                        lambda: torch.sort(keys, dim=1, stable=True)),
              "bound_ms": b_ms, "bound_by": b_by}
    return entry, k3_row


def sharded_pp_fsdp(torch, pp, sharding, make_mesh, gen) -> dict:
    """``gpipe`` at one stage against ``sequential_reference`` (outputs and
    gradients), ``fsdp_gather`` at one rank against the identity (the
    gather and its reduce-scatter backward)."""
    M, mb, d = SHARDED_PP["M"], SHARDED_PP["mb"], SHARDED_PP["d"]
    mesh = make_mesh((1,), ("pipe",))
    w = torch.randn((1, d, d), generator=gen, device="cuda") * d**-0.5
    b = torch.randn((1, d), generator=gen, device="cuda") * 0.1
    xs = torch.randn((M, mb, d), generator=gen, device="cuda")

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    res = []
    for fn in (lambda p: pp.gpipe(stage, p, xs, mesh, "pipe"), lambda p: pp.sequential_reference(stage, p, xs)):
        p = {"w": w.clone().requires_grad_(True), "b": b.clone().requires_grad_(True)}
        out = fn(p)
        out.square().sum().backward()
        res.append((out.detach(), p["w"].grad, p["b"].grad))
    errs = [float((u - v).abs().max()) for u, v in zip(*res)]
    if max(errs) > 1e-5:
        fail(f"gpipe at one stage against sequential_reference: {errs}")
    ctx = sharding.ShardCtx(mesh=make_mesh((1,), ("data",)), tp=None, fsdp="data")
    leaf = torch.randn((d, d // 2), generator=gen, device="cuda").requires_grad_(True)
    coef = torch.randn((d, d // 2), generator=gen, device="cuda")
    g = sharding.fsdp_gather(ctx, {"w": leaf}, {"w": 0})["w"]
    (g * coef).sum().backward()
    if not (torch.equal(g, leaf) and torch.equal(leaf.grad, coef)):
        fail("fsdp_gather at one rank is not the identity")
    return {"gpipe": {"S": 1, "M": M, "mb": mb, "d": d, "max_abs_err": {"out": errs[0], "grad_w": errs[1],
                                                                         "grad_b": errs[2]}},
            "fsdp_gather": {"shape": [d, d // 2], "identity": True}}


def phase_sharded(torch, args, bt, gen, run_pipeline, random_trace, trace_max_value) -> dict:
    """The sharded fabric (M19) at one rank: a one-rank NCCL process group
    through a ``file://`` rendezvous, destroyed at the end (a failure to
    start it fails the run: no gloo or CPU stand-in).  Emits the ``sharded``
    line; returns K1's and K3's entries for the kernels line and the pool
    run's K2 launches."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import distributed as cd
    from repro_torch.distributed import pp, sharding
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.kernels import build
    from repro_torch.models import moe

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
        try:
            line = {"phase": "sharded", "backend": dist.get_backend(), "world_size": dist.get_world_size()}
            line["sort"], k1 = sharded_sort(torch, args, bt, build, cd, make_mesh((1,), ("segment",)),
                                            random_trace)
            line["pool"] = sharded_pool(torch, args, build, sharding, run_pipeline, random_trace,
                                        trace_max_value)
            line["moe_a2a"], k3 = sharded_moe(torch, bt, build, moe, sharding, configs, gen)
            line.update(sharded_pp_fsdp(torch, pp, sharding, make_mesh, gen))
        finally:
            dist.destroy_process_group()
    line["phase_s"] = time.perf_counter() - t0
    emit(line)
    pool_k2 = line["pool"][str(args.n)]["launches"]
    return {"k1": {**k1, "pipeline_shard_map_launches": pool_k2["row_sort"]}, "k3": k3,
            "k2_pipeline_shard_map_launches": pool_k2["tournament"]}


def lm_mesh_per_step(cfg) -> dict:
    """The kernel launches of one train step of ``cfg`` (each block's
    recompute runs its forward kernels a second time): K5 twice and K5b once
    an attention layer or shared invocation, K3 twice an MoE layer, K7 twice
    and K7b once an RWKV6 block, K6 never."""
    attn = attention_layers(cfg)
    moe_layers = cfg.num_layers - cfg.moe.first_dense_layers if cfg.moe is not None else 0
    return {"flash_attention": 2 * attn, "flash_attention_bwd": attn, "row_sort_kv": 2 * moe_layers,
            "wkv": 2 * rwkv_layers(cfg), "wkv_bwd": rwkv_layers(cfg), "decode_attention": 0}


def lm_mesh_train(torch, np, args, ctx, run: dict) -> dict:
    """``run["arch"]``'s train step on the (1, 1) mesh against the step
    without a mesh: ``run["steps"]`` steps of each from ``--seed`` on the
    same batches (``batch_source``: ``TokenPipeline``'s, or the
    encoder-decoder's frames and tokens, an embeddings model's rows; at
    ``run["layers"]`` layers where it is given), both in torch's
deterministic mode; loss and gradient norm within
    ``LM_MESH_TRAIN_LIMIT`` relative at every step; every kernel of the path
    held to its launches per step on both (``lm_mesh_per_step``; counters
    zeroed just before each run, read just after); K5's and K5b's calls by
    shape (``AttnRecorder``, their sums held to the counts)."""
    import dataclasses

    from repro_torch import configs, models
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn_mod
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, shard_batch

    cfg = configs.get_config(run["arch"])
    if run.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    per_step = lm_mesh_per_step(cfg)

    def train(c):
        torch.cuda.empty_cache()
        _reset_peak(torch)
        model = models.build(cfg, ctx=c, device="cuda").requires_grad_(True)
        model.init(torch.Generator(device="cuda").manual_seed(args.seed))
        opt_cfg = AdamWConfig(lr=run["lr"])
        opt_state = init_opt_state(dict(model.named_parameters()), opt_cfg)
        step = build_train_step(model, opt_cfg)
        next_batch = batch_source(torch, cfg, run["batch"], run["seq"], args.seed, "cuda", run.get("frames", 0))
        recs = []
        torch.cuda.synchronize()
        build.reset_launches()
        with AttnRecorder(attn_mod, "flash_attention") as k5_in, \
                AttnRecorder(attn_mod, "flash_attention_bwd") as k5b_in:
            for i in range(run["steps"]):
                batch = shard_batch(next_batch(), c)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt_state, met = step(opt_state, batch)
                torch.cuda.synchronize()
                recs.append({"step": i, "ms": (time.perf_counter() - t0) * 1e3, "loss": float(met["loss"]),
                             "grad_norm": float(met["grad_norm"])})
        launches = dict(build.LAUNCHES)
        shapes = {"flash_attention": shape_launches(k5_in, launches), "flash_attention_bwd": shape_launches(k5b_in, launches)}
        peak = torch.cuda.max_memory_allocated()
        del model, opt_state, step
        torch.cuda.empty_cache()
        for name, n in per_step.items():
            if launches[name] != n * run["steps"]:
                fail(f"lm_mesh train {cfg.name} ({'mesh' if c else 'no mesh'}): {name} launched "
                     f"{launches[name]} times, want {n * run['steps']}")
        if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in recs):
            fail("lm_mesh train: a loss or gradient norm is not finite")
        return {"steps": recs, "step_ms_median_after_first": float(np.median([r["ms"] for r in recs[1:]])),
                "peak_allocated_bytes": peak, "launches": {k: launches[k] for k in per_step},
                "shape_launches": shapes}

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = train(None)
        mesh = train(ctx)
    finally:
        torch.use_deterministic_algorithms(False)
    worst = 0.0
    for a, b in zip(plain["steps"], mesh["steps"]):
        for key in ("loss", "grad_norm"):
            rel = abs(a[key] - b[key]) / abs(a[key])
            worst = max(worst, rel)
            if rel > LM_MESH_TRAIN_LIMIT:
                fail(f"lm_mesh train {cfg.name} step {a['step']}: {key} {b[key]} on the (1, 1) mesh, "
                     f"{a[key]} without")
    return {"arch": cfg.name, "layers": cfg.num_layers, "config": run, "tokens_per_step": run["batch"] * run["seq"],
            "deterministic_algorithms": True, "no_mesh": plain, "mesh_1x1": mesh, "max_rel_diff": worst,
            "bit_equal": worst == 0.0, "limit": LM_MESH_TRAIN_LIMIT}


def lm_mesh_serve(torch, args, arch: str = LM_MESH["serve_arch"]) -> dict:
    """``python -m repro_torch.launch.serve`` in process at ``arch``'s full
    width and depth (Mistral-Nemo-12B; zamba2-1.2b and rwkv6-1.6b), without
    a mesh and with ``--mesh 1x1`` (the phase's one-rank NCCL group): greedy
    tokens equal; ms per decode step (the graph's replay between two
    synchronisations, median); K5 and K7 launches counted (zeroed before
    each run, read after), K6 and K7 in the decode step as the captured
    graph's kernel nodes times its replays; each kernel of the arch's path
    launched at least once."""
    import contextlib
    import io

    from repro_torch.kernels import build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import engine as engine_mod

    sv = LM_MESH["serve"]
    from repro_torch import configs

    cfg = configs.get_config(arch)
    argv = ["--arch", arch, "--device", "cuda", "--seed", str(args.seed),
            "--requests", str(sv["requests"]), "--slots", str(sv["slots"]), "--max-len", str(sv["max_len"]),
            "--max-tokens", str(sv["max_tokens"])]
    orig = engine_mod.Engine._decode
    out = {}
    for name, extra in (("no_mesh", []), ("mesh_1x1", ["--mesh", "1x1"])):
        times, engines = [], []

        def timed(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = orig(self)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not engines:
                engines.append(self)
            return logits

        engine_mod.Engine._decode = timed
        try:
            torch.cuda.empty_cache()
            _reset_peak(torch)
            build.reset_launches()
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                finished = serve_cli.main(argv + extra)
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
        finally:
            engine_mod.Engine._decode = orig
        eng = engines[0]
        if eng.decode_graph is None:
            fail(f"lm_mesh serve ({name}): the engine did not capture its decode step")
        nodes = build.graph_kernel_nodes(eng.decode_graph, ["decode_partial", "wkv_forward"])
        counted = {"flash_attention": launches["flash_attention"],
                   "decode_attention": launches["decode_attention"] + nodes["decode_partial"] * eng.decode_steps,
                   "wkv": launches["wkv"] + nodes["wkv_forward"] * eng.decode_steps}
        path = ("wkv",) if cfg.rwkv is not None else ("flash_attention", "decode_attention")
        if any(counted[k] < 1 for k in path) or any(counted[k] for k in counted if k not in path):
            fail(f"lm_mesh serve {arch} ({name}): launches {counted}, want each of {path} and no other")
        out[name] = {"tokens": sorted((r.rid, r.out) for r in finished), "decode_steps": eng.decode_steps,
                     "ms_per_decode_step_median": float(sorted(times)[len(times) // 2]) * 1e3,
                     "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "launches": {k: counted[k] for k in path}, "printed": log.getvalue().splitlines()[0]}
        del engines, eng, finished
        torch.cuda.empty_cache()
    if out["no_mesh"]["tokens"] != out["mesh_1x1"]["tokens"]:
        fail(f"lm_mesh serve {arch}: the (1, 1) mesh's greedy tokens differ from the engine's without a mesh")
    first = [toks[:4] for _, toks in out["no_mesh"]["tokens"]]
    for v in out.values():
        del v["tokens"]
    return {"arch": arch, "argv": argv, "tokens_equal": True, "first_tokens": first, **out}


def lm_mesh_k6(torch, da, gen) -> tuple[dict, dict]:
    """K6 with its lse at Mistral-Nemo-12B's decode shape against its plain
    version (output within ``attn_limit``, lse within ``lse_limit`` of f32, the
    output the same bytes as without the lse); then the sequence-sharded
    decode's math at tp = 4 on one card: the cache cut into four chunks of
    ``S / 4`` positions, K6 with lse on each with its chunk-local lengths
    (some 0), merged by ``merge_partials``, against whole-cache K6
    (``attn_limit``).  Graph ms of K6 without and with the lse at the whole
    shape and with the lse at the chunk shape, and of the four chunks and
    the merge together.  Returns the line's entry and the K6 row's ``lse``."""
    k = LM_MESH["k6"]
    q = randn(torch, gen, k["q"], torch.bfloat16, QK_SCALE)
    kc = randn(torch, gen, (2, *k["cache"]), torch.bfloat16, QK_SCALE)[-1]
    vc = randn(torch, gen, (2, *k["cache"]), torch.bfloat16)[-1]
    lengths = torch.tensor(k["lengths"], dtype=torch.int32, device="cuda")
    o, lse = da.decode_attention(q, kc, vc, lengths, return_lse=True)
    po, plse = da.decode_attention_plain(q, kc, vc, lengths, return_lse=True)
    err = allclose_err(o, po, "K6 with lse")
    lse_err = float((lse - plse).abs().max())
    if not lse_err <= lse_limit(torch.float32):  # K6's math is f32 at any input type
        fail(f"K6's lse differs from the plain logsumexp by {lse_err}")
    if not torch.equal(o, da.decode_attention(q, kc, vc, lengths)):
        fail("K6's output differs with and without its lse")
    S, C = k["cache"][1], k["chunks"]
    chunk = S // C
    starts = [c * chunk for c in range(C)]
    local = [(lengths - s).clamp(0, chunk).to(torch.int32) for s in starts]
    if not any((lc == 0).any() for lc in local):
        fail("lm_mesh k6: no chunk is empty")

    def chunks():
        parts = [da.decode_attention(q, kc[:, s:s + chunk], vc[:, s:s + chunk], lc, return_lse=True)
                 for s, lc in zip(starts, local)]
        return da.merge_partials(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))

    merged = chunks().to(torch.bfloat16)
    merge_err = allclose_err(merged, o, "the four chunks merged against whole-cache K6")
    plain_err = allclose_err(merged, po, "the four chunks merged against the plain version")
    c1 = 1
    entry = {"q": list(k["q"]), "cache": list(k["cache"]), "lengths": k["lengths"], "dtype": "bfloat16",
             "max_abs_err": err, "lse_max_abs_err": lse_err, "lse_limit": lse_limit(torch.float32),
             "chunks": C, "chunk_lengths": [lc.tolist() for lc in local],
             "merged_vs_whole_max_abs_err": merge_err, "merged_vs_plain_max_abs_err": plain_err}
    row = {"shape": {"q": list(k["q"]), "cache": list(k["cache"]), "lengths": k["lengths"]},
           "graph_ms_without_lse": graph_ms(lambda: da.decode_attention(q, kc, vc, lengths)),
           "graph_ms": graph_ms(lambda: da.decode_attention(q, kc, vc, lengths, return_lse=True)),
           "chunk": {"cache": [k["cache"][0], chunk, *k["cache"][2:]], "lengths": local[c1].tolist(),
                     "graph_ms": graph_ms(lambda: da.decode_attention(
                         q, kc[:, chunk:2 * chunk], vc[:, chunk:2 * chunk], local[c1], return_lse=True))},
           "four_chunks_and_merge_graph_ms": graph_ms(chunks), "max_abs_err": err, "lse_max_abs_err": lse_err}
    torch.cuda.synchronize()
    return entry, row


def tp4_wkv_rows(wk, torch, gen) -> dict:
    """K7 and K7b at a tp-4 rank's share of rwkv6-1.6b's heads
    (``TP4["wkv"]``, 8 heads) and K7 at its decode step, each against its
    plain version (``wkv_limit``) with eager and graph ms beside the bound;
    then the WKV rank by rank: four K7 calls on heads ``[8 r, 8 r + 8)`` of
    the 32-head inputs, concatenated over heads, against the whole 32-head
    call (``wkv_limit``).  No launch count: nothing here runs a tp-4 path
    (``scripts/sharded_cards.py`` counts a rank's launches on four cards)."""
    import dataclasses

    tp, (b, t, h) = TP4["tp"], TP4["wkv"]
    hl = h // tp
    errs, (r, k, v, w, u, s0, dy) = check_k7(wk, torch, gen, b, t, hl)
    plan = wk.launch_plan(b, t, hl)
    out = {}
    for name, kern, plain, backward in (
            ("wkv", lambda: wk.wkv(r, k, v, w, u, s0), lambda: wk.wkv_plain(r, k, v, w, u, s0), False),
            ("wkv_bwd", lambda: wk.wkv_bwd(r, k, v, w, u, s0, dy),
             lambda: wk.wkv_bwd_plain(r, k, v, w, u, s0, dy), True)):
        flops, bytes_ = k7_work(b, t, hl, backward=backward)
        b_ms, b_by = f32_bound(flops, bytes_)
        ms = cuda_ms(kern)
        out[name] = {"tp": tp, "shape": {"r": [b, t, hl, 64], "state": [b, hl, 64, 64]}, "dtype": "float32",
                     "max_abs_err": max(errs[e] for e in (("dr", "dk", "dv", "dw", "du") if backward
                                                          else ("y", "state"))),
                     "ms": ms, "graph_ms": graph_ms(kern), "plain_ms": cuda_ms(plain, 3), "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "flops": flops, "bytes": bytes_,
                     "plan": ([dataclasses.asdict(p) for p in plan.backward] if backward
                              else dataclasses.asdict(plan.forward))}
    del r, k, v, w, u, s0, dy
    # the decode step at a rank's heads, in place on a layer of a stacked cache
    slots = TP4["wkv_slots"]
    errs, (r, k, v, w, u, s0, _) = check_k7(wk, torch, gen, slots, 1, hl)
    cache = torch.zeros(4, slots, hl, 64, 64, device="cuda")
    kern = lambda: wk.wkv(r, k, v, w, u, cache[1], in_place=True)  # noqa: E731
    flops, bytes_ = k7_work(slots, 1, hl)
    b_ms, b_by = f32_bound(flops, bytes_)
    out["wkv"]["decode"] = {"shape": [slots, 1, hl, 64], "max_abs_err": max(errs["y"], errs["state"]),
                            "ms": cuda_ms(kern), "graph_ms": graph_ms(kern),
                            "plain_ms": cuda_ms(lambda: wk.wkv_plain(r, k, v, w, u, s0), 3),
                            "bound_ms": b_ms, "bound_by": b_by,
                            "plan": dataclasses.asdict(wk.launch_plan(slots, 1, hl).forward)}
    # rank by rank against the whole call
    r, k, v, w, u, s0, _ = wkv_inputs(torch, gen, b, t, h)
    y, state = wk.wkv(r, k, v, w, u, s0)

    def ranks():
        parts = [wk.wkv(*(x[:, :, i * hl:(i + 1) * hl].contiguous() for x in (r, k, v, w)),
                        u[i * hl:(i + 1) * hl].contiguous(), s0[:, i * hl:(i + 1) * hl].contiguous())
                 for i in range(tp)]
        return torch.cat([p[0] for p in parts], dim=2), torch.cat([p[1] for p in parts], dim=1)

    ry, rs = ranks()
    out["wkv"]["rank_by_rank"] = {
        "ranks": tp, "heads_per_rank": hl, "whole_shape": [b, t, h, 64],
        "max_abs_err_y": held("K7 rank by rank y", ry, y, "tp 4 against the whole call"),
        "max_abs_err_state": held("K7 rank by rank state", rs, state, "tp 4 against the whole call"),
        "limit": "wkv_limit of the whole call", "whole_graph_ms": graph_ms(lambda: wk.wkv(r, k, v, w, u, s0)),
        "four_ranks_graph_ms": graph_ms(ranks, calls=4)}
    del r, k, v, w, u, s0, y, state, ry, rs, cache
    torch.cuda.empty_cache()
    return out


def tp4_attention_rows(fa, fb, torch, gen) -> dict:
    """K5 and K5b at a tp-4 rank's share of zamba2-1.2b's shared block
    (``TP4["attn"]``: 8 of 32 heads, causal, bf16) through ``k5_row_at`` and
    ``k5b_row``; K6 with its lse on the first tp-4 chunk of zamba2's
    sequence-sharded decode cache (``TP4["k6"]``: S / 4 positions, every kv
    head, chunk-local lengths) through ``k6_lse_row_at``.  No launch count:
    nothing here runs a tp-4 path (``scripts/sharded_cards.py`` counts a
    rank's launches on four cards)."""
    tp, (b, t, h, d) = TP4["tp"], TP4["attn"]
    hl = h // tp
    bf16 = torch.bfloat16
    out = {"flash_attention": {**k5_row_at(torch, gen, (b, t, hl, d), (b, t, hl, d), bf16, True), "tp": tp},
           "flash_attention_bwd": {**k5b_row(fa, fb, torch, gen, (b, t, t, hl, hl, d, True)), "tp": tp}}
    k6 = TP4["k6"]
    chunk = k6["cache"][1] // tp
    cache = (k6["cache"][0], chunk, *k6["cache"][2:])
    out["decode_attention"] = {**k6_lse_row_at(torch, gen, k6["q"], cache, [min(n, chunk) for n in k6["lengths"]]),
                               "tp": tp}
    return out


def k6_lse_row_at(torch, gen, q_shape, cache_shape, lengths: list[int], launches=None) -> dict:
    """K6 with its lse on one rank's chunk of a sequence-sharded cache
    (chunk-local ``lengths``) against its plain version (output within
    ``attn_limit``, lse within ``lse_limit`` of f32), eager and graph ms
    beside the bound and SDPA's with the lengths' mask; ``launches`` where
    a path's run counted them."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    bf16 = torch.bfloat16
    d, chunk = q_shape[2], cache_shape[1]
    q = randn(torch, gen, q_shape, bf16, QK_SCALE)
    kc = randn(torch, gen, (2, *cache_shape), bf16, QK_SCALE)[-1]
    vc = randn(torch, gen, (2, *cache_shape), bf16)[-1]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o, lse = da.decode_attention(q, kc, vc, lens, return_lse=True)
    po, plse = da.decode_attention_plain(q, kc, vc, lens, return_lse=True)
    err = allclose_err(o, po, f"K6 with lse on a chunk of {chunk}")
    lse_err = float((lse - plse).abs().max())
    if not lse_err <= lse_limit(torch.float32):
        fail(f"K6's lse on a chunk of {chunk} differs from the plain logsumexp by {lse_err}")
    flops, bytes_ = k6_work(lengths, q_shape[1], cache_shape[2], d, 2)
    b_ms, b_by = attn_bound(flops, bytes_)
    mask = (torch.arange(chunk, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    kern = lambda: da.decode_attention(q, kc, vc, lens, return_lse=True)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2),  # noqa: E731
                                                 attn_mask=mask, enable_gqa=True)
    row = {**({} if launches is None else {"launches": launches}),
           "shape": {"q": list(q_shape), "cache": list(cache_shape), "lengths": lengths}, "dtype": "bfloat16",
           "lse": True, "block_s": da.BLOCK_S, "max_abs_err": err, "lse_max_abs_err": lse_err,
           **timings(kern, lambda: da.decode_attention_plain(q, kc, vc, lens, return_lse=True), lib),
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": bytes_}
    del q, kc, vc, o, lse, po, plse
    torch.cuda.empty_cache()
    return row


def tp4_family_rows(fa, fb, torch, gen, embeds: dict, embeds_train: dict) -> dict:
    """K5, K5b and K6 at a tp-4 rank's shapes of whisper-small (3 of 12
    heads; ``TRAIN_ENCDEC``'s batch for training, ``SERVE_ENCDEC``'s for
    serving) and llava-next-34b (14 of 56 q heads over 2 of 8 kv heads, G
    7), each against its plain version with eager and graph ms, the bound
    and SDPA's time: K5 at the encoder's, the decoder self-attention's and
    the cross-attention's shapes, llava's largest prefill; K5b at whisper's
    three training shapes; K6 with its lse on a tp-4 chunk of every head:
    whisper's self cache (448 / 4 = 112 positions, the serve run's lengths
    on rank 0), its cross cache (1,500 / 4 = 375, every length 375: not a
    multiple of ``BLOCK_S``), llava's cache (4,096 / 4 = 1,024, rank 1's
    lengths at the serve run's last step).  No launch count: nothing here
    runs a tp-4 path (``scripts/sharded_cards.py`` counts a rank's launches
    on four cards)."""
    from repro_torch import configs

    tp = TP4["tp"]
    bf16 = torch.bfloat16
    enc_serve, run = SERVE_ENCDEC, TRAIN_ENCDEC
    wcfg = configs.get_config(ENCDEC_ARCH)
    H, d = wcfg.num_heads, wcfg.resolved_head_dim
    h = H // tp
    whisper_k5 = {
        "serve_encoder": ((enc_serve["batch"], enc_serve["frames"], h, d), (enc_serve["batch"], enc_serve["frames"], h, d),
                          False),
        "train_encoder": ((run["batch"], run["frames"], h, d), (run["batch"], run["frames"], h, d), False),
        "train_decoder_self": ((run["batch"], run["seq"], h, d), (run["batch"], run["seq"], h, d), True),
        "train_cross": ((run["batch"], run["seq"], h, d), (run["batch"], run["frames"], h, d), False)}
    out = {"whisper": {"tp": tp, "k5": {}, "k5b": {}, "k6": {}}, "llava": {"tp": tp}}
    for name, (qs, ks, causal) in whisper_k5.items():
        out["whisper"]["k5"][name] = k5_row_at(torch, gen, qs, ks, bf16, causal)
    for name in ("train_encoder", "train_decoder_self", "train_cross"):
        (b, t, _, _), (_, s, kv, _), causal = whisper_k5[name]
        out["whisper"]["k5b"][name] = k5b_row(fa, fb, torch, gen, (b, t, s, h, kv, d, causal))
    B = enc_serve["batch"]
    self_chunk, cross_chunk = enc_serve["max_len"] // tp, enc_serve["frames"] // tp
    pos = len(enc_serve["prompt"]) + enc_serve["new_tokens"]
    out["whisper"]["k6"]["self"] = k6_lse_row_at(torch, gen, (B, H, d), (B, self_chunk, H, d),
                                                 [min(pos, self_chunk)] * B)
    out["whisper"]["k6"]["cross"] = k6_lse_row_at(torch, gen, (B, H, d), (B, cross_chunk, H, d), [cross_chunk] * B)
    # llava: 56 q heads over 8 kv heads of 128, a rank's 14 over 2 at prefill
    b, t, s, hq, kvq, dq, causal = embeds["k5_shape"]
    out["llava"]["k5_prefill"] = k5_row_at(torch, gen, (b, t, hq // tp, dq), (b, s, kvq // tp, dq), bf16, causal)
    q, c, lengths = embeds["k6"]
    chunk = c[1] // tp
    local = [max(0, min(chunk, n - chunk)) for n in lengths]  # rank 1's positions [chunk, 2 chunk)
    out["llava"]["k6_rank1_chunk"] = k6_lse_row_at(torch, gen, q, (c[0], chunk, *c[2:]), local)
    b, t, s, hq, kvq, *rest = embeds_train["k5b_shape"]
    out["llava"]["k5b_train"] = k5b_row(fa, fb, torch, gen, (b, t, s, hq // tp, kvq // tp, *rest))
    return out


def lm_mesh_ce(torch, gen) -> dict:
    """The vocab-parallel cross entropy at Mistral-Nemo-12B's vocabulary:
    f32 logits of 2 x 2,048 tokens cut into four vocab shards, each shard's
    ``vocab_stats`` merged by ``merge_vocab_stats``, against the one-shard
    ``cross_entropy`` and ``torch.nn.functional.cross_entropy``, within
    ``LM_MESH_CE_LIMIT`` relative."""
    import torch.nn.functional as F

    from repro_torch.models.layers import cross_entropy, merge_vocab_stats, vocab_stats

    c = LM_MESH["ce"]
    logits = torch.randn((c["batch"], c["seq"], c["vocab"]), generator=gen, device="cuda") * 3.0
    labels = torch.randint(0, c["vocab"], (c["batch"], c["seq"]), generator=gen, device="cuda")
    v = c["vocab"] // c["shards"]
    stats = torch.stack([vocab_stats(logits[..., s * v:(s + 1) * v], labels, s * v) for s in range(c["shards"])])
    lse, gold = merge_vocab_stats(stats)
    sharded = float((lse - gold).mean())
    one = float(cross_entropy(logits, labels))
    lib = float(F.cross_entropy(logits.reshape(-1, c["vocab"]), labels.reshape(-1)))
    errs = {"vs_one_shard": abs(sharded - one) / abs(one), "vs_library": abs(sharded - lib) / abs(lib)}
    if not all(e <= LM_MESH_CE_LIMIT for e in errs.values()):
        fail(f"the vocab-parallel cross entropy {sharded} against {one} / {lib}")
    del logits, labels, stats
    torch.cuda.empty_cache()
    return {**c, "loss": sharded, "one_shard": one, "library": lib, "rel_err": errs, "limit": LM_MESH_CE_LIMIT}


def phase_lm_mesh(torch, np, args, da, gen) -> dict:
    """The LM on a (data, model) mesh at one rank (a one-rank NCCL process
    group through a ``file://`` rendezvous, destroyed after; no CPU
    stand-in): granite's train step on the (1, 1) mesh against the step
    without one, Mistral served through ``launch.serve --mesh 1x1`` against
    the CLI without a mesh, and the same two checks for zamba2-1.2b and
    rwkv6-1.6b (``LM_MESH["recurrent"]``); whisper-small and llava-next-34b
    (4 of 60 layers) trained 3 steps at ``TRAIN_ENCDEC``'s and
    ``TRAIN_EMBEDS``' shapes on the (1, 1) mesh against no mesh, the same
    bytes (``families``; their serving on the mesh is in ``serve_encdec``
    and ``serve_embeds``); then K6 with its lse and the four-chunk merge,
    and the vocab-parallel cross entropy.  Emits the ``lm_mesh`` line;
    returns K6's ``lse`` row and the launches for the kernels line."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    line = {"phase": "lm_mesh"}
    with one_rank_group(torch) as ctx:
        line.update(backend=dist.get_backend(), world_size=dist.get_world_size())
        line["train"] = lm_mesh_train(torch, np, args, ctx, LM_MESH["train"])
        line["serve"] = lm_mesh_serve(torch, args)
        rec = LM_MESH["recurrent"]
        line["recurrent"] = {arch: {"train": lm_mesh_train(torch, np, args, ctx, {**rec, "arch": arch}),
                                    "serve": lm_mesh_serve(torch, args, arch)} for arch in rec["archs"]}
        # the encoder-decoder and the embeddings model (served on the mesh in
        # their own serve phases), trained at their train phases' shapes
        line["families"] = {run["arch"]: {"train": lm_mesh_train(torch, np, args, ctx, {**run, "steps": 3})}
                            for run in (TRAIN_ENCDEC, TRAIN_EMBEDS)}
    line["k6_lse"], k6_row = lm_mesh_k6(torch, da, gen)
    line["vocab_parallel_ce"] = lm_mesh_ce(torch, gen)
    line["phase_s"] = time.perf_counter() - t0
    emit(line)
    return {"k6_lse": k6_row, "train_launches": line["train"]["mesh_1x1"]["launches"],
            "serve_launches": line["serve"]["mesh_1x1"]["launches"],
            "recurrent": {arch: {"train": v["train"]["mesh_1x1"]["launches"],
                                 "serve": v["serve"]["mesh_1x1"]["launches"]}
                          for arch, v in line["recurrent"].items()},
            "families": {arch: v["train"]["mesh_1x1"]["shape_launches"] for arch, v in line["families"].items()}}


class one_rank_group:
    """A one-rank NCCL process group (a ``file://`` rendezvous in a
    temporary directory) and the (1, 1) mesh's ``ShardCtx`` on it, destroyed
    on exit; no CPU stand-in."""

    def __init__(self, torch) -> None:
        self.torch = torch

    def __enter__(self):
        import tempfile

        import torch.distributed as dist

        from repro_torch.distributed.compat import make_mesh
        from repro_torch.distributed.sharding import ShardCtx

        self.torch.cuda.set_device(0)
        self.tmp = tempfile.TemporaryDirectory()
        dist.init_process_group("nccl", init_method=f"file://{self.tmp.name}/rendezvous", rank=0, world_size=1)
        return ShardCtx(mesh=make_mesh((1, 1), ("data", "model")), tp="model", fsdp=None, dp=("data",))

    def __exit__(self, *exc):
        import torch.distributed as dist

        try:
            dist.destroy_process_group()
        finally:
            self.tmp.cleanup()
        return False


def mesh_twin(torch, model, ctx):
    """``model``'s twin on the mesh ``ctx``: built by ``models.build(cfg,
    ctx)`` on the meta device and given ``model``'s own tensors
    (``load_state_dict(assign=True)``: shared, nothing copied), so that a
    68.8 GB model fits once."""
    from repro_torch import models

    twin = models.build(model.cfg, ctx=ctx, device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin


def k5_offset_work(b: int, t: int, s: int, off: int, h: int, kv: int, d: int, itemsize: int,
                   backward: bool = False) -> tuple[float, float]:
    """(flops, bytes) of a causal K5 (or with ``backward`` K5b) call on ``t``
    query rows at offset ``off`` against ``s`` keys: the visible pairs,
    ``sum_i min(s, off + i + 1)``, and the keys the rows see,
    ``min(s, off + t)``, read once (K5: q, the seen k and v, o written; K5b:
    q, o, dO, the lse and the seen k and v read, dq written and dk/dv for
    every key, the unseen ones as zeros)."""
    pairs = float(sum(min(s, off + i + 1) for i in range(t)))
    seen = min(s, off + t)
    if not backward:
        return 4.0 * b * h * d * pairs, (2.0 * b * t * h * d + 2.0 * b * seen * kv * d) * itemsize
    return (10.0 * b * h * d * pairs,
            (4.0 * b * t * h * d + 2.0 * b * seen * kv * d + 2.0 * b * s * kv * d) * itemsize + 4.0 * b * h * t)


def cp_offset_cases(fa, fb, torch, gen) -> list[dict]:
    """K5 (with its lse) and K5b at query offsets against their plain
    versions, bf16 and f32, causal; dk and dv of the keys past offset + T
    exactly zero; and an offset of 0 the same bytes as no offset."""
    c = CP["offsets"]
    b, s, t, h, kv = c["b"], c["s"], c["t"], c["h"], c["kv"]
    rows = []
    for dt, d in ((torch.bfloat16, 128), (torch.bfloat16, 64), (torch.float32, 64), (torch.float32, 32)):
        k = randn(torch, gen, (b, s, kv, d), dt, QK_SCALE)
        v = randn(torch, gen, (b, s, kv, d), dt)
        for off in c["offs"]:
            q = randn(torch, gen, (b, t, h, d), dt, QK_SCALE)
            do = randn(torch, gen, (b, t, h, d), dt)
            o, lse = fa.flash_attention(q, k, v, return_lse=True, q_offset=off)
            po, plse = fa.flash_attention_plain(q, k, v, return_lse=True, q_offset=off)
            err = allclose_err(o, po, f"K5 at q_offset {off}")
            e_lse = (lse - plse).abs().max().item()
            if not e_lse <= lse_limit(dt):
                fail(f"K5's lse at q_offset {off} differs from the plain logsumexp by {e_lse} ({dt})")
            got = fb.flash_attention_bwd(q, k, v, o, do, lse, q_offset=off)
            want = fb.flash_attention_bwd_plain(q, k, v, o, do, lse, q_offset=off)
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                diff = (g.float() - w.float()).abs()
                if not torch.isfinite(g).all() or (diff > grad_limit(w)).any():
                    fail(f"K5b {name} at q_offset {off} differs from its plain version by {diff.max().item()} "
                         f"({dt}, d {d})")
                errs.append(diff.max().item())
            unseen = got[1][:, off + t:], got[2][:, off + t:]
            if any(x.numel() and x.any() for x in unseen):
                fail(f"K5b at q_offset {off}: dk/dv of keys no row sees are not zero")
            if off == 0:
                o0, lse0 = fa.flash_attention(q, k, v, return_lse=True)
                if not (torch.equal(o0, o) and torch.equal(lse0, lse)) or not all(
                        torch.equal(x, y) for x, y in zip(fb.flash_attention_bwd(q, k, v, o, do, lse), got)):
                    fail("K5/K5b at q_offset 0 are not the same bytes as without an offset")
            rows.append({"dtype": str(dt).replace("torch.", ""), "d": d, "q_offset": off, "t": t, "s": s,
                         "k5_err": err, "lse_err": e_lse, "k5b_errs": errs,
                         "zero_keys": max(0, s - off - t)})
    return rows


def cp_starcoder2_kernels(fa, fb, torch, gen) -> tuple[dict, dict]:
    """starcoder2-15b's attention shapes at tp 8 on one card: the eight
    ranks' K5 calls (512 query rows at offset 512 r against the whole K/V)
    concatenated against the whole-T call (output and lse: ``attn_limit``,
    ``lse_limit``, and whether the bytes are the same), the eight K5b calls'
    dq concatenated and dk/dv summed against the whole-T K5b (``grad_limit``
    plus an ulp of each partial), the keys past each rank's rows zero in its
    dk/dv; graph ms per rank and whole, launches, bounds.  Returns (K5's,
    K5b's)."""
    from repro_torch import configs
    from repro_torch.kernels import build

    cfg = configs.get_config(CP["arch"])
    tp, T = CP["tp"], CP["seq"]
    H, KV, d, tl = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, T // tp
    dt = torch.bfloat16
    q = randn(torch, gen, (1, T, H, d), dt, QK_SCALE)
    k = randn(torch, gen, (1, T, KV, d), dt, QK_SCALE)
    v = randn(torch, gen, (1, T, KV, d), dt)
    do = randn(torch, gen, (1, T, H, d), dt)
    rows = [slice(r * tl, (r + 1) * tl) for r in range(tp)]
    build.reset_launches()
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    parts = [fa.flash_attention(q[:, sl], k, v, return_lse=True, q_offset=sl.start) for sl in rows]
    oc, lc = torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], -1)
    k5_launches = build.LAUNCHES["flash_attention"]
    err = allclose_err(oc, o, "K5 rank by rank against whole T")
    e_lse = (lc - lse).abs().max().item()
    if not e_lse <= lse_limit(dt):
        fail(f"K5's lse rank by rank differs from the whole-T call's by {e_lse}")
    want = fb.flash_attention_bwd(q, k, v, o, do, lse)
    got = [fb.flash_attention_bwd(q[:, sl], k, v, p[0], do[:, sl], p[1], q_offset=sl.start)
           for sl, p in zip(rows, parts)]
    k5b_launches = build.LAUNCHES["flash_attention_bwd"]
    for r, (sl, g) in enumerate(zip(rows, got)):
        if g[1][:, sl.stop:].any() or g[2][:, sl.stop:].any():
            fail(f"K5b rank {r}: dk/dv of keys past its rows are not zero")
    errs = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        w = want[i]
        if name == "dq":
            gsum, slack = torch.cat([g[0] for g in got], 1).float(), 0.0
        else:
            gsum = sum(g[i].float() for g in got)
            slack = sum(g[i].float().abs() for g in got) * 2.0**-8
        diff = (gsum - w.float()).abs()
        if not torch.isfinite(gsum).all() or (diff > grad_limit(w) + slack).any():
            fail(f"K5b {name} rank by rank differs from the whole-T call by {diff.max().item()}")
        errs[name] = diff.max().item()
    shape = {"q_whole": [1, T, H, d], "kv": [1, T, KV, d], "tp": tp, "rows_per_rank": tl}
    k5_ms = [graph_ms(lambda sl=sl: fa.flash_attention(q[:, sl], k, v, return_lse=True, q_offset=sl.start))
             for sl in rows]
    whole_ms = graph_ms(lambda: fa.flash_attention(q, k, v, return_lse=True))
    k5b_ms = [graph_ms(lambda sl=sl, p=p: fb.flash_attention_bwd(q[:, sl], k, v, p[0], do[:, sl], p[1],
                                                                  q_offset=sl.start))
              for sl, p in zip(rows, parts)]
    whole_b_ms = graph_ms(lambda: fb.flash_attention_bwd(q, k, v, o, do, lse))
    k5_bounds = [attn_bound(*k5_offset_work(1, tl, T, sl.start, H, KV, d, 2))[0] for sl in rows]
    k5b_bounds = [attn_bound(*k5_offset_work(1, tl, T, sl.start, H, KV, d, 2, backward=True))[0] for sl in rows]
    k5 = {"shape": shape, "launches": k5_launches, "max_abs_err": err, "lse_err": e_lse,
          "bytes_equal_whole": bool(torch.equal(oc, o) and torch.equal(lc, lse)),
          "graph_ms_per_rank": k5_ms, "graph_ms_ranks_sum": sum(k5_ms), "graph_ms_whole": whole_ms,
          "bound_ms_per_rank": k5_bounds, "bound_ms_whole": attn_bound(*k5_work(1, T, H, KV, d, 2, True))[0]}
    k5b = {"shape": shape, "launches": k5b_launches, "errs": errs,
           "dq_bytes_equal_whole": bool(torch.equal(torch.cat([g[0] for g in got], 1), want[0])),
           "graph_ms_per_rank": k5b_ms, "graph_ms_ranks_sum": sum(k5b_ms), "graph_ms_whole": whole_b_ms,
           "bound_ms_per_rank": k5b_bounds, "bound_ms_whole": attn_bound(*k5b_work(1, T, H, KV, d, 2, True))[0]}
    del q, k, v, do, o, lse, parts, got, want
    torch.cuda.empty_cache()
    return k5, k5b


def cp_starcoder2_layer(torch, gen) -> dict:
    """starcoder2-15b's attention layer at full width (bf16, weights drawn
    from the generator) over T = 4,096 at tp 8 on one card, in the two
    layouts the port runs there, each rank by rank through the port's own
    rank bodies, against the one-device ``attention`` on the whole
    sequence: the output and the gradients of x and of every weight
    (``CP_LAYER_LIMIT``), K5 and K5b launches.  ``context`` (under SP): each
    rank's rows projected at their global positions (``context_project``),
    K and V of all ranks concatenated (the all-gather), ``context_rank`` at
    the rank's query offset through the whole ``wo``.  ``columns`` (no SP):
    q/k/v projected whole (the gathered columns), ``column_rank`` on the
    heads holding the rank's columns through its rows of ``wo``, the ranks'
    partial outputs summed in f32 (the all-reduce) and rounded once."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import init_params

    cfg = configs.get_config(CP["arch"])
    tp, T = CP["tp"], CP["seq"]
    tl = T // tp
    p = init_params(attn_mod.Attention(cfg, torch.bfloat16, "cuda"), torch.Generator(device="cuda").manual_seed(1))
    p.requires_grad_(True)
    x = randn(torch, gen, (1, T, cfg.d_model), torch.bfloat16).requires_grad_(True)
    dy = randn(torch, gen, (1, T, cfg.d_model), torch.bfloat16)
    pos = torch.arange(T, device="cuda")[None, :]
    params = dict(p.named_parameters())
    n = p.wo.shape[0] // tp

    def grads(y):
        g = torch.autograd.grad(y, [x, *params.values()], dy)
        return dict(zip(["x", *params], g))

    def context():
        qkv = [attn_mod.context_project(p, cfg, x[:, r * tl:(r + 1) * tl], pos, r) for r in range(tp)]
        k, v = torch.cat([t[1] for t in qkv], 1), torch.cat([t[2] for t in qkv], 1)
        return torch.cat([attn_mod.context_rank(cfg, q, k, v, p.wo, r) for r, (q, _, _) in enumerate(qkv)], 1) + p.bo

    def columns():
        q, k, v = attn_mod.project_qkv(p, cfg, x, pos)
        parts = [attn_mod.column_rank(cfg, q, k, v, p.wo[r * n:(r + 1) * n], r, tp).float() for r in range(tp)]
        return sum(parts).to(x.dtype) + p.bo

    def run(fn):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        y = fn()
        g = grads(y)
        torch.cuda.synchronize()
        launches = {k: build.LAUNCHES[k] for k in ("flash_attention", "flash_attention_bwd")}
        return y.detach(), g, time.perf_counter() - t0, launches

    grads(attn_mod.attention(p, cfg, x, pos))  # warm-up: cuBLAS and the allocator set up
    y_w, g_w, whole_s, _ = run(lambda: attn_mod.attention(p, cfg, x, pos))
    out = {"arch": cfg.name, "tp": tp, "seq": T, "limit": CP_LAYER_LIMIT, "whole_fwd_bwd_s": whole_s}
    for layout, fn in (("context", context), ("columns", columns)):
        y, g, secs, launches = run(fn)
        if launches != {"flash_attention": tp, "flash_attention_bwd": tp}:
            fail(f"cp layer ({layout}): launches {launches}, want {tp} of K5 and of K5b")
        err_y = allclose_err(y, y_w.detach(), f"the {layout} layer rank by rank against whole T")
        rel = {}
        for name, w in g_w.items():
            if not torch.isfinite(g[name]).all():
                fail(f"cp layer ({layout}): the gradient of {name} is not finite")
            rel[name] = ((g[name].float() - w.float()).norm() / w.float().norm().clamp(min=1e-30)).item()
            if rel[name] > CP_LAYER_LIMIT:
                fail(f"cp layer ({layout}): the gradient of {name} rank by rank differs from whole T by "
                     f"{rel[name]} (relative L2)")
        out[layout] = {"launches": launches, "y_max_abs_err": err_y, "grad_rel_l2": rel, "ranks_fwd_bwd_s": secs}
        del y, g
    del p, x, dy, y_w, g_w
    torch.cuda.empty_cache()
    return out


def cp_serve(torch, np, args) -> dict:
    """starcoder2-15b at full width and depth (bf16, weights drawn on the
    card from ``--seed``) through ``python -m repro_torch.launch.serve`` in
    process, its 8 default requests (prompts of 2-11 tokens, 16 greedy
    tokens each): tokens in the vocabulary, every request complete; seconds,
    ms per decode step (median), peak memory; K5 once a layer a prefill,
    K6 as the captured graph's kernel nodes times its replays.  Its smoke
    config first, in f32: the card against the CPU (``serve_parity_small``)."""
    import contextlib
    import io

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import engine as engine_mod

    small = serve_parity_small(torch, np, CP["arch"])
    cfg = configs.get_config(CP["arch"])
    argv = ["--arch", CP["arch"], "--device", "cuda", "--seed", str(args.seed)]
    orig = engine_mod.Engine._decode
    times, engines = [], []

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = orig(self)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not engines:
            engines.append(self)
        return logits

    engine_mod.Engine._decode = timed
    try:
        torch.cuda.empty_cache()
        _reset_peak(torch)
        build.reset_launches()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            finished = serve_cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        engine_mod.Engine._decode = orig
    eng = engines[0]
    if eng.decode_graph is None:
        fail("cp serve: the engine did not capture its decode step")
    k6 = launches["decode_attention"] + build.graph_kernel_nodes(eng.decode_graph, ["decode_partial"])[
        "decode_partial"] * eng.decode_steps
    if len(finished) != 8 or any(len(r.out) != 16 or not all(0 <= t < cfg.vocab_size for t in r.out)
                                 for r in finished):
        fail("cp serve: a request is incomplete or holds a token outside the vocabulary")
    if launches["flash_attention"] != cfg.num_layers * len(finished) or k6 < cfg.num_layers:
        fail(f"cp serve: K5 launched {launches['flash_attention']} times (want {cfg.num_layers} a prefill), K6 {k6}")
    out = {"arch": cfg.name, "argv": argv, "smoke_parity": small, "requests": len(finished),
           "tokens": sum(len(r.out) for r in finished), "run_s": run_s, "decode_steps": eng.decode_steps,
           "ms_per_decode_step_median": float(sorted(times)[len(times) // 2]) * 1e3,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": {"flash_attention": launches["flash_attention"], "decode_attention": k6},
           "first_tokens": [r.out[:4] for r in sorted(finished, key=lambda r: r.rid)],
           "printed": log.getvalue().splitlines()[0]}
    del engines, eng, finished
    torch.cuda.empty_cache()
    return out


def phase_cp(torch, np, args, fa, fb, gen) -> dict:
    """Context parallelism on one card: K5 and K5b at query offsets against
    their plain versions, starcoder2-15b's attention at tp 8 rank by rank
    (the kernels, then the layer) against the whole sequence, and
    starcoder2-15b served whole.  Emits the ``cp`` line; returns the K5 and
    K5b rows' ``q_offset`` entries for the kernels line."""
    t0 = time.perf_counter()
    line = {"phase": "cp", "offsets": cp_offset_cases(fa, fb, torch, gen)}
    line["starcoder2_k5"], line["starcoder2_k5b"] = cp_starcoder2_kernels(fa, fb, torch, gen)
    line["starcoder2_layer"] = cp_starcoder2_layer(torch, gen)
    line["starcoder2_serve"] = cp_serve(torch, np, args)
    line["phase_s"] = time.perf_counter() - t0
    emit(line)
    worst = {k: max(r[k] if not isinstance(r[k], list) else max(r[k]) for r in line["offsets"])
             for k in ("k5_err", "lse_err", "k5b_errs")}
    return {"k5": {"cases": len(line["offsets"]), "worst": worst, "starcoder2_tp8": line["starcoder2_k5"]},
            "k5b": {"cases": len(line["offsets"]), "starcoder2_tp8": line["starcoder2_k5b"]}}


# -- the encoder-decoder (whisper-small) and the embeddings inputs (llava) ----------


def capture_decode(torch, model, cache: dict, batch: int, dev: str = "cuda"):
    """``model.decode_step`` over ``cache`` and a (batch,) token buffer
    captured into one CUDA graph, as the serve ``Engine`` captures it: the
    capture's warm-up step is a real one, so every cache leaf is zeroed
    after it.  Returns (graph, token buffer, logits buffer); None on the
    CPU (``dev``), which has no graph."""
    from repro_torch.kernels import build

    if dev != "cuda":
        return None
    tokens = torch.zeros(batch, dtype=torch.int64, device="cuda")
    graph, (logits, _) = build.capture(lambda: model.decode_step(cache, tokens), "cuda")
    for leaf in cache.values():
        leaf.zero_()
    return graph, tokens, logits


def decode_loop(torch, model, cache: dict, logits, steps: int, graph=None):
    """``steps`` greedy decode steps from ``logits`` (B, V): the eager step,
    or the captured ``graph`` (``capture_decode``'s triple) replayed; each
    step between two synchronisations of the card (none on the CPU).
    Returns (the tokens (B, steps + 1) on the host, each step's seconds,
    whether every logit was finite)."""
    sync = torch.cuda.synchronize if logits.is_cuda else (lambda: None)
    out, times, finite = [], [], []
    for _ in range(steps):
        tok = logits.argmax(-1)
        out.append(tok)
        sync()
        t0 = time.perf_counter()
        if graph is None:
            logits, _ = model.decode_step(cache, tok)
        else:
            graph[1].copy_(tok)
            graph[0].replay()
            logits = graph[2]
        sync()
        times.append(time.perf_counter() - t0)
        finite.append(torch.isfinite(logits).all())
    out.append(logits.argmax(-1))
    return torch.stack(out, 1).cpu(), times, bool(torch.stack(finite).all())


def embeddings_parity_small(torch, np, arch: str) -> dict:
    """The smoke config of an embeddings model (``arch``: the
    encoder-decoder, 2 rows of 37 frames and a 4-token prompt; the
    embeddings LM, 2 x 9 embedding rows, its heads of 16 widened to 14 of 32
    over 2 kv heads, K5's head dim and llava's G 7) in float32, the card against the
    CPU on the same weights: prefill and 6 greedy steps, logits within 1e-4
    and tokens equal; on the card the captured decode step's tokens equal to
    the eager step's."""
    import dataclasses

    from repro_torch import configs, models

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    if cfg.resolved_head_dim not in (32, 64, 128):  # llava's smoke heads of 16: K5 takes 32, 64, 128
        cfg = dataclasses.replace(cfg, num_heads=14, num_kv_heads=2, head_dim=32)  # and llava's G 7
    host = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = models.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(0)
    B, frames, steps = 2, 37, 6
    if cfg.is_encdec:
        prompt = {"enc_embeds": torch.from_numpy(rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32)),
                  "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, 4)))}
    else:
        prompt = torch.from_numpy(rng.standard_normal((B, 9, cfg.d_model)).astype(np.float32))

    def run(model, dev: str, graph: bool):
        cache = model.init_cache(B, 16, frames) if cfg.is_encdec else model.init_cache(B, 16)
        g = capture_decode(torch, model, cache, B) if graph else None
        x = {k: v.to(dev) for k, v in prompt.items()} if cfg.is_encdec else prompt.to(dev)
        logits, _ = model.prefill(x, cache)
        seq = [logits.to("cpu", torch.float32, copy=True)]
        for _ in range(steps):
            tok = logits.argmax(-1)
            if g is None:
                logits, _ = model.decode_step(cache, tok)
            else:
                g[1].copy_(tok)
                g[0].replay()
                logits = g[2]
            seq.append(logits.to("cpu", torch.float32, copy=True))
        return torch.stack(seq)

    want, eager, graph = run(host, "cpu", False), run(card, "cuda", False), run(card, "cuda", True)
    err = (eager - want).abs().max().item()
    if err > 1e-4 or not torch.equal(eager.argmax(-1), want.argmax(-1)):
        fail(f"{arch} smoke model on the card differs from the CPU by {err} or in a greedy token")
    if not torch.equal(graph.argmax(-1), eager.argmax(-1)):
        fail(f"{arch} smoke model's decode graph gives other greedy tokens than its eager step")
    return {"arch": arch, "logits_max_abs_err": err, "graph_vs_eager_max_abs_err": (graph - eager).abs().max().item(),
            "decode_steps": steps, "tokens_equal": True, "graph_tokens_equal_eager": True}


def serve_launches(build, graph, launches: dict, steps: int) -> dict:
    """A serve run's K5 and K6 launches (the counters ``launches``), K6's
    as the launches outside the captured step (``graph``, or None) plus its
    kernel nodes times the ``steps`` replays; and a replay's K5, K6 and K6
    merge nodes and all its kernel nodes."""
    got = {"flash_attention": launches["flash_attention"], "decode_attention": launches["decode_attention"]}
    per_replay = None
    if graph is not None:
        nodes = build.graph_kernel_nodes(graph[0], ["flash_fwd", "flash_fwd_bf16", "decode_partial", "decode_merge"])
        per_replay = {"flash_attention": nodes["flash_fwd"] + nodes["flash_fwd_bf16"],
                      "decode_attention": nodes["decode_partial"], "decode_merge": nodes["decode_merge"],
                      "kernel_nodes": nodes["all"]}
        got["decode_attention"] += per_replay["decode_attention"] * steps
    return {"launches": got, "decode_graph_per_replay": per_replay}


def serve_counts(build, graph, launches: dict, steps: int, k5: int, k6: int, what: str) -> dict:
    """Hold a serve run's launches (:func:`serve_launches`): K5 ``k5`` (its
    prefills), K6 ``k6`` a decode step, as kernel nodes of the captured
    step times its replays (``graph``) or as launches of the eager steps;
    no other kernel."""
    held = serve_launches(build, graph, launches, steps)
    got, per_replay = held["launches"], held["decode_graph_per_replay"]
    if per_replay is not None and (per_replay["flash_attention"] or per_replay["decode_attention"] != k6
                                   or launches["decode_attention"]):
        fail(f"{what}: a replay holds {per_replay} kernel nodes and {launches['decode_attention']} K6 "
             f"launches ran outside the graph; want {k6} K6 nodes")
    if got != {"flash_attention": k5, "decode_attention": k6 * steps}:
        fail(f"{what}: K5 / K6 launched {got}, want {k5} / {k6 * steps}")
    others = {k: n for k, n in launches.items() if k not in ("flash_attention", "decode_attention") and n}
    if others:
        fail(f"{what}: another kernel launched: {others}")
    return held


def phase_serve_encdec(torch, np, args) -> dict:
    """whisper-small served at full width and depth: its smoke config on the
    card against the CPU, the full model's kernels against their plain
    versions on a float32 copy (:func:`full_width_parity`), then
    ``SERVE_ENCDEC``'s batch (one prefill: the encoder over 4 x 1,500
    frames, the cross K/V of every decoder layer, the 4-token prompt) and 64
    greedy steps through the captured decode step, and the same through the
    eager step (tokens equal).  K5 36 launches a prefill (encoder, decoder
    self and cross), K6 24 kernel nodes a replay (self and cross), held
    exactly.  Prefill ms, median ms a decode step, peak memory; the shapes
    K5 and K6 ran at, for the kernels line."""
    from repro_torch import configs, models
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn_mod

    parity = embeddings_parity_small(torch, np, ENCDEC_ARCH)
    cfg = configs.get_config(ENCDEC_ARCH)
    run = SERVE_ENCDEC
    B, S, steps = run["batch"], run["frames"], run["new_tokens"]
    t0 = time.perf_counter()
    model = models.build(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    width = full_width_parity(torch, model, gen)
    batch = {"enc_embeds": (torch.randn(B, S, cfg.d_model, generator=gen, device="cuda") * EMBED_SCALE).to(model.dtype),
             "tokens": torch.tensor([run["prompt"]] * B, device="cuda")}
    cache = model.init_cache(B, run["max_len"], S)
    graph = capture_decode(torch, model, cache, B)
    k5, k6 = attention_layers(cfg), 2 * cfg.num_layers

    def serve(eager: bool, m=model, g=graph, what: str = "") -> tuple[dict, object]:
        for leaf in cache.values():
            leaf.zero_()
        _sync(torch)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t = time.perf_counter()
        logits, _ = m.prefill(batch, cache)
        _sync(torch)
        prefill_s = time.perf_counter() - t
        first = logits.clone()
        toks, times, finite = decode_loop(torch, m, cache, logits, steps, None if eager else g)
        launches = dict(build.LAUNCHES)
        if not finite or not bool(torch.isfinite(logits).all()):
            fail("the whisper-small serve run produced non-finite logits")
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail("the whisper-small serve run gave a token out of the vocabulary")
        held = serve_counts(build, None if eager else g, launches, steps, k5, k6,
                            f"whisper-small {what}{'eager' if eager else 'graph'} run")
        return {"prefill_s": prefill_s, "prefill_frames_per_s": B * S / prefill_s,
                "decode_steps": steps, "ms_per_decode_step_median": float(np.median(times)) * 1e3,
                "ms_per_decode_step_mean": float(np.mean(times)) * 1e3,
                "decode_tokens_per_s": B * steps / sum(times), "peak_device_bytes": torch.cuda.max_memory_allocated(),
                **held}, (toks, first)

    graph_line, (graph_toks, graph_first) = serve(False)
    with AttnRecorder(attn_mod, "flash_attention") as k5_in, AttnRecorder(attn_mod, "decode_attention_kernel") as k6_in:
        eager_line, (eager_toks, _) = serve(True)
    if not torch.equal(graph_toks, eager_toks):
        fail("whisper-small: the decode graph's tokens differ from the eager step's")
    mesh_line = serve_on_mesh(torch, model, cache, B, graph_toks, graph_first,
                              lambda m, g: serve(False, m, g, "(1, 1) mesh "), "whisper-small")
    k6_shapes = {("cross" if k[1][1] == S else "self"): (k[0], k[1], k6_in.shape_lengths[k].tolist())
                 for k in k6_in.calls}
    emit({"phase": "serve_encdec", "arch": cfg.name, "encoder_layers": cfg.encoder_layers,
          "layers": cfg.num_layers, "d_model": cfg.d_model, "dtype": cfg.dtype, "config": run,
          "parity_smoke_f32_vs_cpu": parity, "parity_full_width_kernels_vs_plain": width, "init_s": init_s,
          "weight_bytes": weight_bytes, "cache_bytes": {k: v.numel() * v.element_size() for k, v in cache.items()},
          "attention_layers": k5, "decode": "cuda_graph", **graph_line, "eager": eager_line, "mesh_1x1": mesh_line,
          "k5_shapes": {str(list(sh)): n for sh, n in k5_in.shapes().items()},
          "k6_shapes": {k: {"q": list(q), "cache": list(c), "lengths": ln} for k, (q, c, ln) in k6_shapes.items()},
          "graph_tokens_equal_eager": True, "first_tokens": graph_toks[:, :8].tolist()})
    del model, cache, graph, batch
    torch.cuda.empty_cache()
    return {"launches": graph_line["launches"], "per_replay": graph_line["decode_graph_per_replay"],
            "mesh_launches": mesh_line["shape_launches"], "k5_shapes": k5_in.shapes(), "k6_shapes": k6_shapes,
            "dtype": torch.bfloat16}


def serve_on_mesh(torch, model, cache: dict, batch: int, want_toks, want_first, serve, arch: str) -> dict:
    """The serve run again on the (1, 1) mesh: ``model``'s twin there
    (:func:`mesh_twin`, its tensors shared) with its own captured decode
    step over the same cache, through ``serve(twin, graph)`` (which holds its
    launches as the run without a mesh); its greedy tokens and its prefill's
    logits the same bytes as that run's (``want_toks``, ``want_first``).
    ``shape_launches``: K5's launches by shape (the prefill's calls) and
    K6's (the captured step's calls by shape times the replays), their sums
    held to the run's counts.  The graph is freed before the group."""
    from repro_torch.models import attention as attn_mod

    with one_rank_group(torch) as ctx:
        twin = mesh_twin(torch, model, ctx)
        with AttnRecorder(attn_mod, "decode_attention_kernel") as k6_in:
            graph = capture_decode(torch, twin, cache, batch)
        with AttnRecorder(attn_mod, "flash_attention") as k5_in:
            line, (toks, first) = serve(twin, graph)
        graph[0].reset()
        del graph, twin
    if not torch.equal(toks, want_toks) or not torch.equal(first, want_first):
        fail(f"{arch}: the (1, 1) mesh's tokens or prefill logits differ from the run without a mesh")
    per_replay = shape_launches(k6_in, line["decode_graph_per_replay"], per=2)
    shapes = {"flash_attention": shape_launches(k5_in, line["launches"]),
              "decode_attention": [[sh, n * line["decode_steps"]] for sh, n in per_replay]}
    return {**line, "shape_launches": shapes, "tokens_equal_no_mesh": True, "prefill_logits_equal_no_mesh": True}


def phase_serve_embeds(torch, np, args) -> dict:
    """llava-next-34b served at full width and depth from embeddings: its
    smoke config (G 4) on the card against the CPU, the full model's K5 and
    K6 against their plain versions (``full_width_parity``, a 64-row
    embeddings prompt), then one request a slot (``SERVE_EMBEDS``: 1-5 tiles
    of 576 embedding rows each), each prefilled at B 1 into its slot of the
    4-slot cache, and 32 greedy token steps of every slot through the
    captured decode step, then the same through the eager step (tokens
    equal).  K5 60 launches a prefill, K6 60 kernel nodes a replay (G 7),
    held exactly.  Each prefill's seconds, median ms a decode step, peak
    memory, the cache's bytes; the shapes for the kernels line."""
    from repro_torch import configs, models
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn_mod

    parity = embeddings_parity_small(torch, np, EMBEDS_ARCH)
    cfg = configs.get_config(EMBEDS_ARCH)
    run = SERVE_EMBEDS
    slots, steps = run["slots"], run["new_tokens"]
    t0 = time.perf_counter()
    model = models.build(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    width = full_width_parity(torch, model, gen)
    torch.cuda.empty_cache()
    tiles = np.random.default_rng(args.seed).integers(run["tiles"][0], run["tiles"][1] + 1, size=slots)
    prompts = [(torch.randn(1, int(n) * run["tile"], cfg.d_model, generator=gen, device="cuda") * EMBED_SCALE)
               .to(model.dtype) for n in tiles]
    cache = model.init_cache(slots, run["max_len"])
    graph = capture_decode(torch, model, cache, slots)
    L = cfg.num_layers

    def serve(eager: bool, m=model, g=graph, what: str = "") -> tuple[dict, object]:
        for leaf in cache.values():
            leaf.zero_()
        _sync(torch)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        firsts, prefill_s = [], []
        for s, p in enumerate(prompts):
            view = {name: leaf[s:s + 1] if name == "pos" else leaf[:, s:s + 1] for name, leaf in cache.items()}
            t = time.perf_counter()
            logits, _ = m.prefill(p, view)
            _sync(torch)
            prefill_s.append(time.perf_counter() - t)
            firsts.append(logits)
        logits = torch.cat(firsts)
        first = logits.clone()
        toks, times, finite = decode_loop(torch, m, cache, logits, steps, None if eager else g)
        launches = dict(build.LAUNCHES)
        if not finite or not bool(torch.isfinite(logits).all()):
            fail("the llava-next-34b serve run produced non-finite logits")
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail("the llava-next-34b serve run gave a token out of the vocabulary")
        held = serve_counts(build, None if eager else g, launches, steps, L * slots, L,
                            f"llava-next-34b {what}{'eager' if eager else 'graph'} run")
        rows = sum(p.shape[1] for p in prompts)
        return {"prefill_requests": [{"slot": s, "rows": p.shape[1], "prefill_s": t}
                                     for s, (p, t) in enumerate(zip(prompts, prefill_s))],
                "prefill_s": sum(prefill_s), "prefill_rows_per_s": rows / sum(prefill_s),
                "decode_steps": steps, "ms_per_decode_step_median": float(np.median(times)) * 1e3,
                "ms_per_decode_step_mean": float(np.mean(times)) * 1e3,
                "decode_tokens_per_s": slots * steps / sum(times),
                "peak_device_bytes": torch.cuda.max_memory_allocated(), **held}, (toks, first)

    graph_line, (graph_toks, graph_first) = serve(False)
    with AttnRecorder(attn_mod, "flash_attention") as k5_in, AttnRecorder(attn_mod, "decode_attention_kernel") as k6_in:
        eager_line, (eager_toks, _) = serve(True)
    if not torch.equal(graph_toks, eager_toks):
        fail("llava-next-34b: the decode graph's tokens differ from the eager step's")
    graph[0].reset()  # one decode graph at a time beside the 68.8 GB of weights
    mesh_line = serve_on_mesh(torch, model, cache, slots, graph_toks, graph_first,
                              lambda m, g: serve(False, m, g, "(1, 1) mesh "), "llava-next-34b")
    (k6_key,) = k6_in.calls
    k5_shape = max(k5_in.shapes(), key=lambda sh: sh[1])
    emit({"phase": "serve_embeds", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "dtype": cfg.dtype, "config": run,
          "parity_smoke_f32_vs_cpu": parity, "parity_full_width_kernels_vs_plain": width, "init_s": init_s,
          "weight_bytes": weight_bytes, "cache_bytes": {k: v.numel() * v.element_size() for k, v in cache.items()},
          "tiles": tiles.tolist(), "decode": "cuda_graph", **graph_line, "eager": eager_line, "mesh_1x1": mesh_line,
          "graph_tokens_equal_eager": True, "first_tokens": graph_toks[:, :8].tolist()})
    del model, cache, graph, prompts
    torch.cuda.empty_cache()
    return {"launches": graph_line["launches"], "per_replay": graph_line["decode_graph_per_replay"],
            "mesh_launches": mesh_line["shape_launches"], "k5_shape": k5_shape,
            "k6": (k6_key[0], k6_key[1], k6_in.shape_lengths[k6_key].tolist())}


def example_argv(extra, run_dir: Path) -> list[str]:
    return [a.format(dir=run_dir) for a in extra]


def start_examples_on_cpu(run_dir: Path) -> list:
    """Each example twin at its default size with ``--device cpu``, in a
    background process of its own (niced, ``EXAMPLE_CPU_THREADS`` intra-op
    threads, no card visible), its standard output to a file under
    ``run_dir`` (its errors to another); started before the serve phases so
    that they are done when :func:`phase_examples` reads them.  Returns
    (script, process, output path, start time) each."""
    procs = []
    for script, extra in EXAMPLES:
        env = dict(os.environ, OMP_NUM_THREADS=str(EXAMPLE_CPU_THREADS.get(script, 1)), CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=str(ROOT / "src"))
        out_dir = run_dir / "cpu"
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{script}.out"
        with open(path, "w") as f, open(out_dir / f"{script}.err", "w") as err:
            proc = subprocess.Popen([sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
                                     *example_argv(extra, out_dir)], stdout=f, stderr=err,
                                    env=env, cwd=ROOT, preexec_fn=lambda: os.nice(19))
        procs.append((script, proc, path, time.perf_counter()))
    return procs


def start_dryrun_sweep(run_dir: Path) -> tuple:
    """The dry run of every arch x shape on the single-pod mesh
    (``python -m repro_torch.launch.dryrun --out``), in a background process
    (niced, one thread, no card visible): (name, process, output path,
    start time), as :func:`start_examples_on_cpu` gives them."""
    run_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT / "src"))
    path = run_dir / "dryrun_sweep.json"
    with open(run_dir / "dryrun_sweep.out", "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all", "--shape", "all",
                                 "--out", str(path)], stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                                preexec_fn=lambda: os.nice(19))
    return "dryrun", proc, path, time.perf_counter()


#: The dry run's calibration cells: granite's ``TRAIN`` cell and one decode
#: step of ``SERVE``'s slots at its ``max_len``, on a one-rank fake world.
DRYRUN_TRAIN = dict(seq=TRAIN["seq"], batch=TRAIN["batch"], kind="train")
DRYRUN_DECODE = dict(seq=SERVE["max_len"], batch=SERVE["slots"], kind="decode")


def phase_dryrun(torch, train: dict, serve: dict, sweep: tuple) -> None:
    """The ``dryrun`` phase (see the module's docstring): the calibration
    cells traced here against what ``train`` and ``serve`` held, then the
    background sweep's result."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import AdamWConfig

    if dist.is_initialized():
        fail("dryrun: a process group is still initialized; the dry run starts its own fake one")
    t0 = time.perf_counter()
    build.reset_launches()
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        tr = dryrun.lower_cell(MOE_ARCH, "calibration_train", mesh, verbose=False, spec=DRYRUN_TRAIN,
                               chunk_bytes=AdamWConfig().chunk_threshold_bytes)
        dec = dryrun.lower_cell(SERVE_ARCH, "calibration_decode", mesh, verbose=False, spec=DRYRUN_DECODE)
    calib_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if any(launches.values()):
        fail(f"dryrun: the meta-device trace launched kernels: {launches}")
    if tr["memory"]["arguments"] != train["argument_bytes"]:
        fail(f"dryrun: granite's train arguments {tr['memory']['arguments']} differ from the live tensors' "
             f"{train['argument_bytes']}")
    live_cache = sum(serve["cache_bytes"].values())
    got = dec["memory"]["arguments"]
    if got["cache"] != live_cache or got["params"] != serve["weight_bytes"]:
        fail(f"dryrun: Mistral's decode cache / parameters {got['cache']} / {got['params']} differ from the "
             f"live {live_cache} / {serve['weight_bytes']}")
    predicted = tr["memory"]["argument_bytes"] + tr["memory"]["temp_bytes"]
    model_flops = train_flops(configs.get_config(MOE_ARCH), TRAIN["batch"], TRAIN["seq"])
    calibration = {
        "train": {"arch": MOE_ARCH, "cell": DRYRUN_TRAIN, "argument_bytes": tr["memory"]["argument_bytes"],
                  "arguments": tr["memory"]["arguments"], "arguments_equal_live": True,
                  "temp_bytes": tr["memory"]["temp_bytes"], "predicted_peak_bytes": predicted,
                  "max_memory_allocated": train["peak_allocated_bytes"],
                  "predicted_over_measured_peak": predicted / train["peak_allocated_bytes"],
                  "flops_per_device": tr["flops_per_device"], "train_flops_formula": model_flops,
                  "flops_over_formula": tr["flops_per_device"] / model_flops, "kernels": tr["kernels"],
                  "trace_s": tr["trace_s"]},
        "decode": {"arch": SERVE_ARCH, "cell": DRYRUN_DECODE, "cache_bytes": got["cache"],
                   "live_cache_bytes": live_cache, "params_bytes": got["params"],
                   "live_weight_bytes": serve["weight_bytes"], "equal_live": True,
                   "temp_bytes": dec["memory"]["temp_bytes"], "flops_per_device": dec["flops_per_device"],
                   "trace_s": dec["trace_s"]},
        "seconds": calib_s, "launches": launches,
    }
    name, proc, path, started = sweep
    try:
        proc.wait(timeout=DRYRUN_SWEEP_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"dryrun: the sweep did not end within {DRYRUN_SWEEP_TIMEOUT} s")
    sweep_s = time.perf_counter() - started
    if proc.returncode or not path.is_file():
        fail(f"dryrun: the sweep exited {proc.returncode}: "
             f"{path.with_name('dryrun_sweep.out').read_text()[-3000:]}")
    cells = json.loads(path.read_text())
    want_skips = {(a, "long_500k") for a in configs.list_archs() if a not in dryrun.LONG_OK}
    skips = {(c["arch"], c["shape"]) for c in cells if c["status"] == "skipped"}
    bad = [c for c in cells if c["status"] not in ("ok", "skipped")]
    if bad or skips != want_skips or len(cells) != len(configs.list_archs()) * len(dryrun.SHAPES):
        fail(f"dryrun: the sweep has {len(bad)} cells in error ({[(c['arch'], c['shape']) for c in bad]}), "
             f"skips {sorted(skips)}")
    rows = [{k: c.get(k) for k in ("arch", "shape", "status", "trace_s", "microbatches", "flops_per_device",
                                   "bytes_per_device", "collective_bytes_per_device")}
            | ({"argument_bytes": c["memory"]["argument_bytes"], "temp_bytes": c["memory"]["temp_bytes"]}
               if c["status"] == "ok" else {}) for c in cells]
    emit({"phase": "dryrun", "calibration": calibration,
          "sweep": {"mesh": {"data": 16, "model": 16}, "wall_s": sweep_s,
                    "ok": sum(c["status"] == "ok" for c in cells), "skipped": len(skips), "errors": 0,
                    "trace_s_sum": sum(c.get("trace_s", 0.0) for c in cells), "cells": rows}})


def stop_processes(procs) -> None:
    for _, proc, _, _ in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def masked_lines(text: str) -> list[str]:
    """``text``'s lines with :data:`EXAMPLE_MASKS` applied, the arena
    backend's note left out."""
    import re

    out = []
    for line in text.splitlines():
        if line.startswith("note: the arena backend"):
            continue
        for pat, rep in EXAMPLE_MASKS:
            line = re.sub(pat, rep, line)
        out.append(line)
    return out


def phase_examples(torch, cpu_procs, run_dir: Path) -> dict:
    """Each example twin once on the card at its reference example's
    default size, one after the other (their host syncs would wait on each
    other's kernels on one card): in this process (``main(argv)``, its
    standard output kept; the launch counters zeroed before and read after),
    the distributed sort in a subprocess (its ranks are spawned processes;
    their launches are not seen here).  Each run's lines, masked, must equal
    its CPU twin's (:func:`start_examples_on_cpu`)."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.kernels import build

    card_dir = run_dir / "cuda"
    card_dir.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(ROOT / "examples"))
    rows = []
    for (script, extra), (_, cpu_proc, cpu_path, _) in zip(EXAMPLES, cpu_procs):
        argv = ["--device", "cuda", *example_argv(extra, card_dir)]
        build.reset_launches()
        t0 = time.perf_counter()
        if script == "torch_distributed_sort.py":
            r = subprocess.run([sys.executable, str(ROOT / "examples" / script), *argv], capture_output=True,
                               text=True, timeout=600, cwd=ROOT)
            if r.returncode:
                fail(f"{script} on the card exited {r.returncode}: {r.stderr[-2000:]}")
            text, launches = r.stdout, None
        else:
            spec = importlib.util.spec_from_file_location(f"_twin_{script[:-3]}", ROOT / "examples" / script)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
            torch.cuda.synchronize()
            text = buf.getvalue()
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
        card_s = time.perf_counter() - t0
        try:
            cpu_proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            fail(f"{script} on the CPU did not end")
        cpu_text = cpu_path.read_text()
        if cpu_proc.returncode:
            fail(f"{script} on the CPU exited {cpu_proc.returncode}: "
                 f"{cpu_path.with_suffix('.err').read_text()[-2000:]}")
        got, want = masked_lines(text), masked_lines(cpu_text)
        if got != want:
            fail(f"{script}: the card's lines differ from the CPU's: {got} against {want}")
        rows.append({"script": f"examples/{script}", "argv": argv, "card_s": card_s, "lines": len(got),
                     "lines_equal_cpu": True, "launches": launches, "first_lines": text.splitlines()[:3]})
        torch.cuda.empty_cache()
    line = {"phase": "examples", "twins": rows}
    emit(line)
    return line


def ptxas_line(build) -> dict:
    """Registers, static shared memory, stack and spills of every kernel entry
    built in this process, from the compiler's ``-Xptxas -v`` output
    (``build.BUILD_LOGS``); names demangled with ``c++filt`` where present.
    Dynamic shared memory is set at launch and is not in these numbers."""
    import re
    import shutil

    rows = []
    for lib, log in sorted(build.BUILD_LOGS.items()):
        cur = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"library": lib, "kernel": m.group(1)}
                rows.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                cur.update(registers=int(m.group(1)), smem_static_bytes=int(smem.group(1)) if smem else 0)
    spilled = [r for r in rows if r.get("spill_stores") or r.get("spill_loads")]
    if spilled:
        fail(f"ptxas reports spills in {[(r['library'], r['kernel']) for r in spilled]}")
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and rows:
        names = subprocess.run([cxxfilt], input="\n".join(r["kernel"] for r in rows), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, name in zip(rows, names):
                r["kernel"] = name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
    return {"ptxas": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000_000, help="keys in the sort run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also time the hop's row sort and the glue around K1 in a "
                         "second sort run, profile a third and a short serve run "
                         "(device busy share, time by kernel)")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: the port (src/repro_torch) is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = smi_line()
    t0 = time.perf_counter()
    build_s = build.build_kernels()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "kernels_built": sorted(build.BUILD_LOGS), "kernel_build_s": build_s,
          "build_wall_s": time.perf_counter() - t0})

    import shutil

    run_dir = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(run_dir, ignore_errors=True)
    cpu_examples: list = []  # started by run_phases, stopped here whatever happens
    try:
        return run_phases(args, np, torch, smi, cpu_examples, run_dir)
    finally:
        stop_processes(cpu_examples)


def run_phases(args, np, torch, smi: str, cpu_examples, run_dir: Path) -> int:
    """Every phase after the build, in order; the last lines of the run."""
    from repro_torch.core import mergesort
    from repro_torch.data.traces import random_trace, trace_max_value
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import wkv as wk
    from repro_torch.net.pipeline import run_pipeline

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_k1(bt, torch, gen)
    phase_k2(bt, torch, gen)

    # -- the sort path ---------------------------------------------------------
    parity = parity_small(torch, np, run_pipeline, random_trace)
    n = args.n
    t_prep = time.perf_counter()
    trace = random_trace(n, seed=args.seed)
    payload = np.empty((n, 2), dtype=np.int64)
    payload[:, 0] = trace * 7 + 3
    payload[:, 1] = np.arange(n)
    values_d = torch.from_numpy(trace).cuda()
    payload_d = torch.from_numpy(payload).cuda()
    del payload, trace
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t_prep
    clock = StageClock()
    torch.cuda.reset_peak_memory_stats()
    with LargestShape(bt, "sort_rows") as k1_in, LargestShape(bt, "merge_tournament") as k2_in:
        build.reset_launches()
        mergesort.reset_branches()
        t_run = time.perf_counter()
        res = run_pipeline(
            values_d, payload=payload_d, max_value=trace_max_value("random"),
            seed=args.seed, tracer=clock, device="cuda", **E2E,
        )
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = dict(build.LAUNCHES)
        branches = dict(mergesort.MERGE_BRANCHES)
    peak = torch.cuda.max_memory_allocated()
    want = torch.sort(values_d, stable=True)
    if not torch.equal(res.output, want.values):
        fail("pipeline output differs from torch.sort of the input")
    if not torch.equal(res.payload_row_order, want.indices):
        fail("payload_row_order differs from the stable argsort")
    if not torch.equal(res.sorted_payload, payload_d[want.indices]):
        fail("sorted_payload differs from payload[order]")
    if launches["row_sort"] != E2E_HOPS:
        fail(f"K1 launched {launches['row_sort']} times, want one per hop ({E2E_HOPS})")
    if launches["tournament"] < 1:
        fail("K2 never launched on the main path")
    if any(launches[k] for k in ("flash_attention", "decode_attention", "row_sort_kv", "merge_rows")):
        fail("the sort path launched a kernel of another path")
    if branches["ladder"] != 0:
        fail(f"merge_runs_flat took the host ladder {branches['ladder']} times")
    fused_out, fused_payload = res.output, res.sorted_payload
    del want
    emit({"phase": "pipeline", "n": n, "config": E2E, "parity_with_cpu_at": parity,
          "prep_s": prep_s, "run_s": run_s, "keys_per_s": n / run_s,
          "stage_s": dict(clock.seconds), "server_makespan_s": res.server_seconds,
          "per_server_s": res.per_server_seconds, "pool_merge_s": res.pool_merge_seconds,
          "server_keys": res.server_keys, "passes": res.passes,
          "peak_device_bytes": peak, "launches": {k: launches[k] for k in ("row_sort", "tournament")},
          "merge_branches": branches})
    del res
    if args.profile:
        phase_profile(torch, run_pipeline, values_d, payload_d, args.seed)
    dev_epoch = phase_pipeline_device(torch, np, args, run_pipeline, random_trace, values_d, payload_d,
                                      fused_out, fused_payload)
    phase_pipeline_observed(torch, np, run_pipeline, "cuda", values_d, payload_d, fused_out,
                            fused_payload, args.seed)
    del values_d, payload_d, fused_out, fused_payload
    torch.cuda.empty_cache()
    phase_pipeline_sampled(torch, np, run_pipeline, "cuda",
                           [(name, min(n, args.n), flows) for name, n, flows in SCENARIO_ROWS],
                           min(SCENARIO_DEVICE_N, args.n), args.seed)
    phase_pipeline_network(torch, np, run_pipeline, "cuda", min(NETWORK_N, args.n), args.seed)
    phase_pipeline_faults(torch, np, run_pipeline, "cuda", args.seed, min(FAULT_N, args.n),
                          min(FAULT_E2E_N, args.n))
    phase_pipeline_tenants(torch, np, "cuda", args.seed, min(MT_N, args.n), min(MT_BIG_N, args.n))
    phase_hop_engines(torch, np, run_pipeline, "cuda", args.seed, min(HOP_N, args.n))
    rows = sort_rows_of(torch, bt, gen, launches, k1_in, k2_in)
    rows[0]["device_epoch"] = k1_device_epoch(torch, bt, gen, dev_epoch)

    # -- the serve paths -------------------------------------------------------
    # the example twins' CPU runs overlap the card-bound phases from here on,
    # not the host-bound dataplane phases above
    cpu_examples += start_examples_on_cpu(run_dir)
    phase_k3(bt, torch, gen)
    phase_k4(bt, torch, gen)
    phase_k5(fa, torch, gen)
    phase_k6(da, torch, gen)
    serve = phase_serve(torch, np, args, SERVE_ARCH, "serve", [SERVE_ARCH])
    attn = attention_rows(torch, serve, gen)
    moe = phase_serve(torch, np, args, MOE_ARCH, "serve_moe", [MOE_ARCH, "deepseek-moe-16b"])
    check_attention_at(torch, moe, gen, "serve_moe_attention")
    rows += bitonic_rows(torch, bt, gen, moe["k3_shape"], moe["k3_dtype"], moe["k3_real"], moe["launches"])
    rows += attn

    # -- the training paths ----------------------------------------------------
    phase_k5b(fa, fb, torch, gen)
    phase_head_dim_192(fa, fb, da, torch, gen)
    train = phase_train(torch, np, args, TRAIN, "train", plain_check=True)
    dense = phase_train(torch, np, args, TRAIN_DENSE, "train_dense", plain_check=False)
    phase_train_resume(torch, args)
    sharded = phase_sharded(torch, args, bt, gen, run_pipeline, random_trace, trace_max_value)
    lm_mesh = phase_lm_mesh(torch, np, args, da, gen)
    cp = phase_cp(torch, np, args, fa, fb, gen)

    # -- deepseek-moe-16b at full width, and the hybrid (zamba2-1.2b) ----------
    deepseek = phase_serve(torch, np, args, DEEPSEEK_ARCH, "serve_deepseek", [])
    deepseek_train = phase_train(torch, np, args, TRAIN_DEEPSEEK, "train_deepseek", plain_check=False)
    hybrid = phase_serve(torch, np, args, HYBRID_ARCH, "serve_hybrid", [HYBRID_ARCH])
    check_attention_at(torch, hybrid, gen, "serve_hybrid_attention")
    hybrid_train = phase_train(torch, np, args, TRAIN_HYBRID, "train_hybrid", plain_check=True)

    # -- RWKV6 (rwkv6-1.6b), its WKV on K7 and K7b -------------------------------
    k7_rows = phase_k7(wk, torch, gen)
    rwkv = phase_serve(torch, np, args, RWKV_ARCH, "serve_rwkv", [RWKV_ARCH])
    rwkv_train = phase_train(torch, np, args, TRAIN_RWKV, "train_rwkv", plain_check=True)

    # -- the encoder-decoder (whisper-small), the embeddings inputs (llava-next-34b)
    encdec = phase_serve_encdec(torch, np, args)
    encdec_train = phase_train(torch, np, args, TRAIN_ENCDEC, "train_encdec", plain_check=True)
    embeds = phase_serve_embeds(torch, np, args)
    embeds_train = phase_train(torch, np, args, TRAIN_EMBEDS, "train_embeds", plain_check=False)
    # the sweep beside the twins' card runs (checks, not timings), after the
    # host-timed phases, whose clocks it would share the cores with;
    # appended after the twins: phase_examples pairs EXAMPLES with the list's head
    sweep = start_dryrun_sweep(run_dir)
    cpu_examples.append(sweep)
    phase_examples(torch, cpu_examples, run_dir)
    phase_dryrun(torch, train, serve, sweep)
    rows[0]["sharded"] = sharded["k1"]
    rows[1]["sharded"] = {"site": "core/mergesort.py merge_runs_flat (pipeline, pool_backend=shard_map)",
                          "launches": sharded["k2_pipeline_shard_map_launches"]}
    next(r for r in rows if r["name"] == "row_sort_kv")["sharded"] = sharded["k3"]
    k5_row = next(r for r in rows if r["name"] == "flash_attention")
    k5_row["train_launches_per_step"] = {"granite": train["k5_per_step"], "mistral_8_layers": dense["k5_per_step"]}
    k5b = k5b_row(fa, fb, torch, gen, train["k5b_shape"], train["k5b_launches"], train["k5b_per_step"])
    k5b["dense"] = k5b_row(fa, fb, torch, gen, dense["k5b_shape"], dense["k5b_launches"], dense["k5b_per_step"])
    k6_row = next(r for r in rows if r["name"] == "decode_attention")
    k6_row["lse"] = {**lm_mesh["k6_lse"], "lm_mesh_serve_launches": lm_mesh["serve_launches"]["decode_attention"]}
    k5_row["lm_mesh_launches"] = {"train": lm_mesh["train_launches"]["flash_attention"],
                                  "serve": lm_mesh["serve_launches"]["flash_attention"]}
    k5_row["q_offset"] = cp["k5"]
    next(r for r in rows if r["name"] == "row_sort_kv")["lm_mesh_train_launches"] = \
        lm_mesh["train_launches"]["row_sort_kv"]
    k5b["zamba2"] = k5b_row(fa, fb, torch, gen, hybrid_train["k5b_shape"], hybrid_train["k5b_launches"],
                            hybrid_train["k5b_per_step"])
    rows.append({"name": "flash_attention_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 "replaces": "src/repro/models/attention.py:181", "tpu_kernel": False, **k5b,
                 "lm_mesh_train_launches": lm_mesh["train_launches"]["flash_attention_bwd"],
                 "q_offset": cp["k5b"]})
    keep = ("launches", "max_abs_err", "shape", "dtype", "ms", "plain_ms", "library_ms", "graph_ms",
            "library_graph_ms", "bound_ms", "bound_by", "flops", "bytes")
    for row, at in zip((k5_row, k6_row), attention_rows(torch, hybrid, gen)):
        row["zamba2"] = {k: at[k] for k in keep if k in at}
        row["zamba2"]["decode_graph_per_replay"] = hybrid["per_replay"][row["name"]]
    k5_row["zamba2"]["train_launches_per_step"] = hybrid_train["k5_per_step"]
    for row in rows:
        if row["name"] in ("flash_attention", "decode_attention", "row_sort_kv"):
            row["deepseek_serve_launches"] = deepseek["launches"][row["name"]]
    k5_row["deepseek_train_launches_per_step"] = deepseek_train["k5_per_step"]
    rows.append({"name": "wkv", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv.cu",
                 "replaces": "src/repro/models/rwkv6.py:138", "tpu_kernel": False,
                 "launches": rwkv["launches"]["wkv"], **k7_rows["wkv"],
                 "serve": {"launches": rwkv["launches"]["wkv"], "per_prefill": rwkv["wkv_layers"],
                           "decode_graph_per_replay": rwkv["per_replay"]["wkv"], "replays": rwkv["replays"],
                           **k7_serve_times(wk, torch, gen, rwkv)},
                 "train_launches_per_step": rwkv_train["k7_per_step"]})
    rows.append({"name": "wkv_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv_bwd.cu",
                 "replaces": "src/repro/models/rwkv6.py:148", "tpu_kernel": False,
                 "launches": rwkv_train["k7b_launches"], **k7_rows["wkv_bwd"],
                 "train_launches_per_step": rwkv_train["k7b_per_step"]})

    bf16 = torch.bfloat16
    k5b_row_ = next(r for r in rows if r["name"] == "flash_attention_bwd")

    def k5_at(sh, launches):
        b, t, s, h, kv, d, causal = sh
        return k5_row_at(torch, gen, (b, t, h, d), (b, s, kv, d), bf16, causal, launches)

    def attn_kind(sh) -> str:
        return "cross" if sh[1] != sh[2] else "decoder_self" if sh[6] else "encoder"

    # every bf16 shape whisper's K5 and K5b ran at, with its launches: a
    # prefill's (serve), a train step's (K5 twice a K5b call: the forward and
    # the recompute) and the whole training run's (K5b)
    k5_row["whisper"] = {"serve": {attn_kind(sh): k5_at(sh, n) for sh, n in encdec["k5_shapes"].items()},
                         "train": {attn_kind(sh): k5_at(sh, 2 * n) for sh, n in encdec_train["k5b_shapes"].items()},
                         "serve_launches_per_prefill": encdec["launches"]["flash_attention"],
                         "train_launches_per_step": encdec_train["k5_per_step"]}
    k6_row["whisper"] = {name: k6_row_at(torch, gen, q, c, bf16, lengths, encdec["launches"]["decode_attention"])
                         for name, (q, c, lengths) in sorted(encdec["k6_shapes"].items())}
    k6_row["whisper"]["decode_graph_per_replay"] = encdec["per_replay"]["decode_attention"]
    k5b_row_["whisper"] = {attn_kind(sh): k5b_row(fa, fb, torch, gen, sh, n * TRAIN_ENCDEC["steps"], n)
                           for sh, n in encdec_train["k5b_shapes"].items()}
    # the recurrent models on a mesh: their (1, 1) runs' launches, and their
    # kernels at a tp-4 rank's shapes
    wkv_row, wkv_bwd_row = (next(r for r in rows if r["name"] == n) for n in ("wkv", "wkv_bwd"))
    rec = lm_mesh["recurrent"]
    wkv_row["lm_mesh_launches"] = {"train": rec[RWKV_ARCH]["train"]["wkv"], "serve": rec[RWKV_ARCH]["serve"]["wkv"]}
    wkv_bwd_row["lm_mesh_train_launches"] = rec[RWKV_ARCH]["train"]["wkv_bwd"]
    k5_row["zamba2"]["lm_mesh_launches"] = {"train": rec[HYBRID_ARCH]["train"]["flash_attention"],
                                            "serve": rec[HYBRID_ARCH]["serve"]["flash_attention"]}
    k6_row["zamba2"]["lm_mesh_serve_launches"] = rec[HYBRID_ARCH]["serve"]["decode_attention"]
    tp4_wkv = tp4_wkv_rows(wk, torch, gen)
    wkv_row["tp4"], wkv_bwd_row["tp4"] = tp4_wkv["wkv"], tp4_wkv["wkv_bwd"]
    tp4_attn = tp4_attention_rows(fa, fb, torch, gen)
    k5_row["zamba2_tp4"] = tp4_attn["flash_attention"]
    k5b_row_["zamba2_tp4"] = tp4_attn["flash_attention_bwd"]
    k6_row["zamba2_tp4_chunk"] = tp4_attn["decode_attention"]
    k5_row["llava"] = {**k5_at(embeds["k5_shape"], embeds["launches"]["flash_attention"]),
                       "train_launches_per_step": embeds_train["k5_per_step"]}
    q, c, lengths = embeds["k6"]
    k6_row["llava"] = {**k6_row_at(torch, gen, q, c, bf16, lengths, embeds["launches"]["decode_attention"]),
                       "decode_graph_per_replay": embeds["per_replay"]["decode_attention"]}
    k5b_row_["llava"] = k5b_row(fa, fb, torch, gen, embeds_train["k5b_shape"], embeds_train["k5b_launches"],
                                embeds_train["k5b_per_step"])
    # the encoder-decoder and the embeddings model on a mesh: their (1, 1)
    # runs' launches by shape (the same shapes as without a mesh), and their
    # kernels at a tp-4 rank's shapes
    def by_kind(pairs) -> dict:
        out = {}
        for (q, k, causal), n in pairs:
            kind = attn_kind((q[0], q[1], k[1], q[2], k[2], q[3], causal))
            out[kind] = out.get(kind, 0) + n
        return out

    fam_train = lm_mesh["families"]
    k5_row["whisper"]["lm_mesh_launches"] = {"serve": by_kind(encdec["mesh_launches"]["flash_attention"]),
                                             "train": by_kind(fam_train[ENCDEC_ARCH]["flash_attention"])}
    k5b_row_["whisper"]["lm_mesh_launches"] = by_kind(fam_train[ENCDEC_ARCH]["flash_attention_bwd"])
    k6_row["whisper"]["lm_mesh_launches"] = {("cross" if k[1] == SERVE_ENCDEC["frames"] else "self"): n
                                             for (_, k, _), n in encdec["mesh_launches"]["decode_attention"]}
    k5_row["llava"]["lm_mesh_launches"] = {"serve": embeds["mesh_launches"]["flash_attention"],
                                           "train": fam_train[EMBEDS_ARCH]["flash_attention"]}
    k5b_row_["llava"]["lm_mesh_launches"] = fam_train[EMBEDS_ARCH]["flash_attention_bwd"]
    k6_row["llava"]["lm_mesh_launches"] = embeds["mesh_launches"]["decode_attention"]
    fam = tp4_family_rows(fa, fb, torch, gen, embeds, embeds_train)
    k5_row["whisper_tp4"] = {**fam["whisper"]["k5"], "tp": fam["whisper"]["tp"]}
    k5b_row_["whisper_tp4"] = {**fam["whisper"]["k5b"], "tp": fam["whisper"]["tp"]}
    k6_row["whisper_tp4_chunk"] = {**fam["whisper"]["k6"], "tp": fam["whisper"]["tp"]}
    k5_row["llava_tp4"] = {**fam["llava"]["k5_prefill"], "tp": fam["llava"]["tp"]}
    k5b_row_["llava_tp4"] = {**fam["llava"]["k5b_train"], "tp": fam["llava"]["tp"]}
    k6_row["llava_tp4_chunk"] = {**fam["llava"]["k6_rank1_chunk"], "tp": fam["llava"]["tp"]}

    emit({"kernels": rows})
    emit(ptxas_line(build))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
