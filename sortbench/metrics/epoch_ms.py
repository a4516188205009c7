"""The fabric: the stage clock's ``epoch:<e>`` spans (every hop of the
topology), a job."""


def read(r):
    if not r.stages or not r.stages.get("jobs") or "epoch" not in r.stages:
        return None
    return 1e3 * r.stages["epoch"] / r.stages["jobs"]
