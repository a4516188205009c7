"""The server pool: the stage clock's time from the end of the last epoch to
the end of the pipeline, a job."""


def read(r):
    if not r.stages or not r.stages.get("jobs") or "egress" not in r.stages:
        return None
    return 1e3 * r.stages["egress"] / r.stages["jobs"]
