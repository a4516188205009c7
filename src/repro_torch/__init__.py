"""PyTorch/CUDA port of the switch-sort dataplane (:mod:`repro` is the JAX
reference it is held against).

The subpackages mirror the reference's layout: ``core`` (partitioning,
MergeMarathon, runs, merge sort), ``net`` (wire, flows, hop engine,
topologies, control plane, streaming servers, egress pool, pipeline),
``kernels`` (the hand-written Hopper kernels and their plain versions),
``obs``, ``data``, and the LM stack: ``configs``, ``models``, ``serve``,
``train``, ``distributed`` (its one-device part) and ``launch``.  Entry points take ``device=`` and default to
``"cuda"``; with no card present they raise unless the caller asks for
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raise rather than fall back.

    ``"cuda"`` without a card is an error, never a silent CPU run.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
