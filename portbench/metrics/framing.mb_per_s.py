"""Framing's rate: the ``meter=`` stage ``frame``'s transport bytes over
its seconds, summed over the window's jobs, in MB/s (``io/`` and
``csrc/framer.cpp``; the stage runs on a feeder thread and overlaps the
rest; traced run)."""


def read(run):
    s = run.meter_stage("frame", "s")
    return run.meter_stage("frame", "bytes") / s / 1e6 if s > 0 else None
