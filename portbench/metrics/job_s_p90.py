"""90th percentile of the wall seconds of every job in the window (host
clock)."""

from portbench import stats


def read(run):
    return stats.percentile([j.seconds for j in run.jobs], 90) if run.jobs else None
