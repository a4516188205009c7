"""K2 (``csrc/tournament.cu``): the least time of the servers' merge of the
runs they receive (``sortbench/work.py``: every record read and written
once, log2 of the runs a segment merge steps a record) over the device
trace's time of K2's kernels, in %."""

PATTERNS = ("tile_merge", "merge_round")


def read(r):
    if not r.traces or not r.work or "k2_least_s" not in r.work:
        return None
    t = sum(tr.seconds_of(PATTERNS) for tr in r.traces)
    if t <= 0:
        return None
    return 100.0 * r.work["k2_least_s"] / t
