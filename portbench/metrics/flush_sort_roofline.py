"""The flush sort's share of its roofline, in %: 8 bytes read and 8
written a valid window over HBM's peak, against the summed device time
of the operations that ``kernels.json`` names ``flush_sort`` (the sort of
the packed keys in ``device/count.py``'s ``unique_counts``).  Windows are
counted from the generated input, so a padded flush reads as waste
(traced run)."""

from portbench import peaks


def read(run):
    if run.trace is None:
        return None
    spent, n = run.trace.seconds_matching(run.patterns["flush_sort"])
    if not n or spent <= 0:
        return None
    least, _ = peaks.bound_s(16 * run.windows())
    return 100.0 * least / spent
