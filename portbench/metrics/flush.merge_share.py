"""Share of the window spent merging each flush into the job's spectrum
on the host: the ``meter=`` stage ``flush.merge``
(``count.merge_sorted_spectra``), summed over the window's jobs, over the
window (traced run)."""

from portbench import meter_stages


def read(run):
    return meter_stages.share(run, "flush.merge")
