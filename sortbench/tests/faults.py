"""Faults planted in the program underneath a run, to see ``correct`` come
out false (``run.main(..., patch="sortbench.tests.faults:<name>")``)."""

from __future__ import annotations

import types

import torch


def _wrap_pipeline(after):
    from repro_torch.net import pipeline

    real = pipeline.run_pipeline

    def patched(values, **kw):
        return after(real, values, kw)

    pipeline.run_pipeline = patched


def pipeline_unchanged():
    """A job that returns its input as it came: keys unsorted."""

    def after(real, values, kw):
        n = values.numel()
        return types.SimpleNamespace(output=values.clone(), payload_row_order=torch.arange(n, device=values.device),
                                     sorted_payload=kw["payload"].clone(), server_seconds=0.0,
                                     hop_stats=[types.SimpleNamespace(emitted_runs=1)])

    _wrap_pipeline(after)


def pipeline_half():
    """Half of the job left out: the sort of the first half alone."""

    def after(real, values, kw):
        half = values.numel() // 2
        kw = dict(kw, payload=kw["payload"][:half])
        return real(values[:half], **kw)

    _wrap_pipeline(after)


def pipeline_altered():
    """One answer altered where it is produced: a key of the output."""

    def after(real, values, kw):
        res = real(values, **kw)
        res.output[res.output.numel() // 3] += 1
        return res

    _wrap_pipeline(after)


def _wrap_sharded(after):
    from repro_torch.core import distributed as cd

    real = cd.sort_sharded

    def patched(x, mesh, axis, splitters, **kw):
        return after(real, x, mesh, axis, splitters, kw)

    cd.sort_sharded = patched


def sharded_unchanged():
    """Every rank returns its keys as they came."""
    _wrap_sharded(lambda real, x, mesh, axis, sp, kw: (x.clone(), torch.tensor([x.numel()]), torch.tensor([0])))


def sharded_half():
    """Half of each rank's keys left out."""
    _wrap_sharded(lambda real, x, mesh, axis, sp, kw: real(x[: x.numel() // 2], mesh, axis, sp, **kw))


def sharded_altered():
    """One key of a rank's output altered where it is produced."""

    def after(real, x, mesh, axis, sp, kw):
        padded, valid, overflow = real(x, mesh, axis, sp, **kw)
        padded[int(valid[0]) // 2] += 1
        return padded, valid, overflow

    _wrap_sharded(after)


def sharded_no_exchange():
    """The exchange between cards left out: each rank keeps what it sends."""
    import torch.distributed as dist

    def local(out, inp, *a, **kw):
        out.copy_(inp)

    dist.all_to_all_single = local
