"""Share of the driver's wall time spent waiting for the next placed
batch: the ``meter=`` stages ``wait`` over ``wall``, summed over the
window's jobs (``device/pipeline.py``; traced run)."""


def read(run):
    wall = run.meter_stage("wall", "s")
    return run.meter_stage("wait", "s") / wall if wall > 0 else None
