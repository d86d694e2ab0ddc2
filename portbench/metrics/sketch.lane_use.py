"""Useful lanes over lanes sketched: the valid sketch positions of the
window's jobs, counted from the generated input, over the ``meter=``
stage ``sketch``'s items (the positions the sketch computed, batch
padding included), summed over the window's jobs (traced run).  A
program without the stage gives no reading."""

from portbench.reference import minimizers


def read(run):
    lanes = run.meter_stage("sketch", "items")
    return minimizers.run_positions(run) / lanes if lanes > 0 else None
