"""Paper algorithms on tensors: range partitioning, MergeMarathon, runs and
the run arena, the server merges, and the faithful switch simulator
(counterpart of ``repro.core``).

* :mod:`.switchsim` -- the faithful PISA/RMT switch (Alg. 2 and 3), host code.
* :mod:`.marathon` -- the vectorized equivalent (the blockwise-sort theorem).
* :mod:`.partition` -- SetRanges and balanced quantile ranges.
* :mod:`.runs` -- run detection and statistics (Def. 3.1.1, §6.3).
* :mod:`.mergesort` -- the server: k-way natural merge sort, the arena's K2 merge.
"""

from .marathon import (
    MarathonEmission,
    blockwise_sort,
    marathon_emission,
    marathon_flat,
    marathon_streams,
)
from .mergesort import (
    merge_runs,
    merge_runs_batched,
    merge_runs_flat,
    merge_sort,
    merge_sort_reference,
    merge_two,
    server_sort,
)
from .partition import load_imbalance, quantile_ranges, segment_of, set_ranges
from .runs import RunArena, RunStats, merge_passes, run_lengths, run_starts
from .switchsim import Segment, Switch

__all__ = [
    "MarathonEmission",
    "blockwise_sort",
    "marathon_emission",
    "marathon_flat",
    "marathon_streams",
    "merge_runs",
    "merge_runs_batched",
    "merge_runs_flat",
    "merge_sort",
    "merge_sort_reference",
    "merge_two",
    "server_sort",
    "RunArena",
    "load_imbalance",
    "quantile_ranges",
    "segment_of",
    "set_ranges",
    "RunStats",
    "merge_passes",
    "run_lengths",
    "run_starts",
    "Segment",
    "Switch",
]
