"""Seconds from the process's start to the window's: imports, the kernels'
build (only the first run in a checkout compiles) and load, the warm-up jobs
(the device engine's graph capture), the host buffers of the judged job."""


def read(r):
    return r.setup_s
