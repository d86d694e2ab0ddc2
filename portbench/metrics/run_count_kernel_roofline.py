"""The run-count kernel's share of its roofline, in %: the least time the
flush's run count needs, 8 bytes read (the sorted packed key) and 4
written (its count) a valid window, over HBM's peak, against the summed
device time of ``csrc/run_counts.cu``'s kernel.  Windows are counted from
the generated input, so a padded flush reads as waste (traced run); a
program without the kernel gives no reading."""

from portbench import peaks

# the kernel's name in the device trace
PATTERNS = ["run_counts_kernel"]


def read(run):
    if run.trace is None:
        return None
    spent, n = run.trace.seconds_matching(PATTERNS)
    if not n or spent <= 0:
        return None
    least, _ = peaks.bound_s(12 * run.windows())
    return 100.0 * least / spent
