"""The plain reference of a range sort over ranks: the guarantee, not a rule
for the splitters.

Plain PyTorch; it imports nothing of the program.  The configuration states
that the ranks' outputs, joined in rank order, are every key of the job in
ascending order, each key once, with none dropped for capacity.  So the
reference sorts all of the job's keys (every rank's, as the benchmark made
them) and cuts from that sorted sequence the slice that rank ``r``'s output
has to be: it starts after the keys the lower ranks hold, and is as long as
rank ``r``'s valid count.  How the program chose its splitters does not
enter: any split that keeps the guarantee reads 0.  Each number compared is
a count that breaks the guarantee, and its limit is 0.

The control is the same reference with the keys narrowed to int32, the
precision below the stated one, its sorted keys cut into equal shares.
"""

from __future__ import annotations

import torch

LIMITS = {"key_mismatches": 0, "count_mismatches": 0, "overflow": 0}


def sorted_keys(all_keys: list) -> torch.Tensor:
    """Every key of the job, every rank's, in ascending order."""
    return torch.sort(torch.cat(all_keys)).values


def control(rank: int, world: int, all_keys: list):
    """``(padded, valid, overflow)`` as the program returns them, from the
    reference computed in int32."""
    keys = sorted_keys([k.to(torch.int32) for k in all_keys]).to(torch.int64)
    lo, hi = keys.numel() * rank // world, keys.numel() * (rank + 1) // world
    mine = keys[lo:hi]
    return mine, torch.tensor([mine.numel()]), torch.tensor([0])


def judge(rank: int, got: torch.Tensor, valids: list, overflow: int, all_keys: list) -> dict:
    """``got``: rank ``rank``'s first ``valids[rank]`` output keys as the
    program produced them; ``valids``: every rank's valid count.  Summed over
    the ranks, the numbers are the job's (the count is rank 0's to give)."""
    want = sorted_keys(all_keys)
    start = sum(int(v) for v in valids[:rank])
    valid = int(valids[rank])
    part = want[start:start + valid]
    m = min(got.numel(), part.numel())
    differ = int(torch.count_nonzero(got[:m].to(want.device) != part[:m]))
    missing = abs(sum(int(v) for v in valids) - want.numel()) if rank == 0 else 0
    return {"key_mismatches": differ + valid - m, "count_mismatches": missing, "overflow": int(overflow)}
