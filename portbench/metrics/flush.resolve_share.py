"""Share of the window spent resolving flushes on the device: the
``meter=`` stage ``flush.resolve`` (``count.finalize_sparse``:
concatenate, pad, sort, run count and the route's compaction, up to the
host's read that settles the route), summed over the window's jobs, over
the window (traced run)."""

from portbench import meter_stages


def read(run):
    return meter_stages.share(run, "flush.resolve")
