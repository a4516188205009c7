"""The paper's own workload as a first-class config: big-data sort jobs
(the port's own copy of ``repro.configs.paper_sort``).

Not an LM architecture — this is the configuration surface for the
MergeMarathon pipeline itself (switch geometry × trace × server order),
used by the benchmark harness and the examples.  The paper's evaluated
grid is the default.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SortJobConfig:
    trace: str = "random"             # random | network | memory
    n: int = 1_000_000                # paper: 100M / 77M
    segments: int = 16                # x ∈ {1,4,8,16,32,64,128}
    segment_length: int = 32          # y ∈ {4,8,16,32,64,128}
    merge_order: int = 10             # paper: k = 10
    balanced_ranges: bool = False     # beyond-paper: quantile splitters
    presort_block: int | None = None  # pod-scale on-path pre-sort tile


# the paper's §6.2 sweep
PAPER_SEGMENTS = (1, 4, 8, 16, 32, 64, 128)
PAPER_LENGTHS = (4, 8, 16, 32, 64, 128)


def paper_grid(trace: str, n: int = 1_000_000):
    for s in PAPER_SEGMENTS:
        for y in PAPER_LENGTHS:
            yield SortJobConfig(trace=trace, n=n, segments=s,
                                segment_length=y)
