"""Share of the window spent in the flush (``device/count.py``'s
``SparseSpectrumAccumulator._flush``: sort, run count, compaction or host
filter, host merge), timed by the benchmark's span, synchronised at entry
and exit, summed over the window (traced run; a cell that reports
``job_s_p90``, which it moves)."""

from portbench.spans import flush_share as read  # noqa: F401
