"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at its
start, in GiB; on several cards the fullest card's."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
