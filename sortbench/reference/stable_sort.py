"""The plain reference of a sort job: a stable sort of the records.

Plain PyTorch; it imports nothing of the program.  It takes the job's keys
and payload as the benchmark made them and works out the sorted keys, the
stable sort permutation and the payload rows in key order.  The
configuration states int64 keys and int64 payload columns, a stable and
complete sort: every number compared is a count of positions that break
that, and its limit is 0.

The control is the same reference with the records narrowed to int32, the
precision below the stated one: keys of a narrow domain still sort right,
the full-width payload does not come back.
"""

from __future__ import annotations

import torch

LIMITS = {"key_mismatches": 0, "row_mismatches": 0, "payload_mismatches": 0}


def sort_records(keys: torch.Tensor, payload, dtype=torch.int64) -> dict:
    """Keys, stable permutation and payload rows in key order, computed in
    ``dtype`` and returned as int64."""
    order = torch.sort(keys.to(dtype), stable=True)
    rows = None if payload is None else payload.to(dtype)[order.indices].to(torch.int64)
    return {"output": order.values.to(torch.int64), "row_order": order.indices, "payload": rows}


def control(keys: torch.Tensor, payload) -> dict:
    return sort_records(keys, payload, torch.int32)


def count_mismatches(got, length: int, want) -> int:
    """Rows of ``want`` that ``got`` (the first rows of an output of
    ``length`` rows) does not reproduce, and rows it has too many."""
    if want is None:
        return length
    if got is None:
        return int(want.shape[0])
    m = min(got.shape[0], want.shape[0])
    diff = got[:m].to(want.device).reshape(m, -1) != want[:m].reshape(m, -1)
    return abs(length - int(want.shape[0])) + int(torch.count_nonzero(diff.any(dim=1)))


def judge(got: dict, keys: torch.Tensor, payload) -> dict:
    """``got``: output name -> (rows, length), as the program produced it."""
    want = sort_records(keys, payload)
    return {"key_mismatches": count_mismatches(*got["output"], want["output"]),
            "row_mismatches": count_mismatches(*got["row_order"], want["row_order"]),
            "payload_mismatches": count_mismatches(*got["payload"], want["payload"])}
