"""The key-plane kernel's share of its roofline, in %: the least time the
window's inputs need, 2 bits read a base and 8 bytes written a valid
window (``hi`` and ``lo`` planes) over HBM's peak, against the summed
device time of the operations that ``kernels.json`` names
``window_kernel`` (``csrc/hash_keys.cu``, planes mode).  Windows and
bases are counted from the generated input, not from padded lanes
(traced run)."""

import math

from portbench import peaks


def read(run):
    if run.trace is None:
        return None
    spent, n = run.trace.seconds_matching(run.patterns["window_kernel"])
    if not n or spent <= 0:
        return None
    least, _ = peaks.bound_s(math.ceil(run.bases / 4) + 8 * run.windows())
    return 100.0 * least / spent
