"""Flows and ranges: the stage clock's time from a pipeline's start to its
first epoch (split, interleave, payload rows, the range table), a job."""


def read(r):
    if not r.stages or not r.stages.get("jobs") or "pre_epoch" not in r.stages:
        return None
    return 1e3 * r.stages["pre_epoch"] / r.stages["jobs"]
