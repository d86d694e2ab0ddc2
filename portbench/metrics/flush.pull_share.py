"""Share of the window spent pulling each flush's spectrum to the host:
the ``meter=`` stage ``flush.pull`` (``count.finalize_sparse``: the copy
of the compacted entries, or the host filter's pull and filter), summed
over the window's jobs, over the window (traced run)."""

from portbench import meter_stages


def read(run):
    return meter_stages.share(run, "flush.pull")
