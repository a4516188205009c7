"""NCCL's kernels' device time over the traced window, on the busiest rank,
in %."""

PATTERNS = ("nccl",)


def read(r):
    if not r.traces:
        return None
    shares = [tr.seconds_of(PATTERNS) / tr.window_s for tr in r.traces if tr.window_s > 0]
    if not shares or max(shares) <= 0:
        return None
    return 100.0 * max(shares)
