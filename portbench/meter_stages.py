"""Shares of the window from the stages of the port's ``meter=``.

The port times its layers into the driver's ``ThroughputMeter``
(``utils/profiling.span``), on ``time.perf_counter`` like the window's
jobs, and the harness keeps each job's meter in a traced run of a cell
whose configuration names one.  A program without a stage (an older
port) gives ``None`` here, never an error.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["share"]


def share(run, stage: str) -> Optional[float]:
    """Seconds of the meter's stage ``stage``, summed over the window's
    jobs, over the window; None where no job's meter holds the stage."""
    if run.window_s <= 0 or not any(stage in (j.meter or {}) for j in run.jobs):
        return None
    return run.meter_stage(stage, "s") / run.window_s
