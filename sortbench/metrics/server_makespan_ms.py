"""The server pool's own makespan, ``PipelineResult.server_seconds`` (the
slowest server plus the pool's merge, each timed between synchronisations
in ``net/egress.py``), a job.  Far below ``egress_ms``, the servers run one
after another."""


def read(r):
    vals = [s for s in (r.server_s or []) if s is not None]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
