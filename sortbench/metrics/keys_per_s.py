"""Keys of all jobs completed in the window, over the window's seconds (the
host clock: the window runs from the first job's start to the last job's
completion, a synchronise; the client's making of each job's input is in it)."""


def read(r):
    return r.keys / r.window_s
