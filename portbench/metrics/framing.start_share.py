"""Share of the window in which a framing pool was starting: the
``meter=`` stage ``framing.start`` (``io/framing.parallel_read_batches``,
from the split of the file into ranges through the workers' spawn to the
first batch off the pool's queue; it runs on a feeder thread, so only the
meter sees it), summed over the window's jobs, over the window (traced
run)."""

from portbench import meter_stages


def read(run):
    return meter_stages.share(run, "framing.start")
