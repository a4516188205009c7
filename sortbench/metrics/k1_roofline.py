"""K1 (``csrc/row_sort.cu``): the least time of the jobs' block sorts
(``sortbench/work.py``, counted from the cell's sizes) over the device
trace's time of K1's kernels, in %; every card of the run summed."""

PATTERNS = ("row_sort_kernel",)


def read(r):
    if not r.traces or not r.work or "k1_least_s" not in r.work:
        return None
    t = sum(tr.seconds_of(PATTERNS) for tr in r.traces)
    if t <= 0:
        return None
    return 100.0 * r.work["k1_least_s"] / t
