"""Seconds from the process's start to the first timed job: input
generation, kernel load (and build, in a checkout's first run) and the
warm-up jobs (host clock)."""


def read(run):
    return run.setup_s
