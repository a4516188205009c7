"""1 minus the union of the device's kernel, copy and memset intervals over
the traced window, in %; averaged over the cards of the run."""


def read(r):
    if not r.traces:
        return None
    idle = [1.0 - tr.busy_s() / tr.window_s for tr in r.traces if tr.window_s > 0]
    if not idle:
        return None
    return 100.0 * sum(idle) / len(idle)
