"""Useful lanes over lanes sorted: the valid windows of the window's jobs,
counted from the generated input as the rooflines count them, over the
``meter=`` stage ``flush.resolve``'s items (``count.finalize_sparse``:
the lanes of every flush, batch padding and the pad to 2^20 lanes
included), summed over the window's jobs (traced run)."""


def read(run):
    lanes = run.meter_stage("flush.resolve", "items")
    return run.windows() / lanes if lanes > 0 else None
