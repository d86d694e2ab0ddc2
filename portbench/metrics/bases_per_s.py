"""Bases of every job in the window over the window's seconds, from the
first job's start to the last job's end (host clock)."""

from portbench import stats


def read(run):
    return stats.rate(run.bases, run.window_s) if run.jobs else None
