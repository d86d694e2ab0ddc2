"""Share of the window in which no kernel, copy or memset ran on the
card: 1 - (union of the device intervals on the ``torch.profiler``
timeline) / window, behind the discarded warm-up step (traced run)."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s() / t.window_s
