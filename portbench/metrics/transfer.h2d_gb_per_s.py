"""The host-to-device copy's rate: the ``meter=`` stage ``h2d``'s bytes
over its seconds (synchronised on both sides), summed over the window's
jobs, in GB/s (``pipeline._uploader``; traced run)."""


def read(run):
    s = run.meter_stage("h2d", "s")
    return run.meter_stage("h2d", "bytes") / s / 1e9 if s > 0 else None
