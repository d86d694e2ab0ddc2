"""The sketch kernel's share of its roofline, in %: the least time the
window's inputs need, 8 bytes read a valid k-window (the key planes'
``hi`` and ``lo``) and 8 written a valid sketch position, over HBM's
peak, against the summed device time of ``csrc/minimizer_sketch.cu``'s
kernel.  Windows and positions are counted from the generated input, not
from padded lanes (traced run); a program without the kernel gives no
reading."""

from portbench import peaks
from portbench.reference import minimizers

# the kernel's name in the device trace
PATTERNS = ["minimizer_sketch_kernel"]


def read(run):
    if run.trace is None:
        return None
    spent, n = run.trace.seconds_matching(PATTERNS)
    if not n or spent <= 0:
        return None
    least, _ = peaks.bound_s(8 * run.windows() + 8 * minimizers.run_positions(run))
    return 100.0 * least / spent
