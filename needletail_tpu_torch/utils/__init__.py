"""Small helpers shared by the port's drivers: throughput metering and the
``torch.profiler`` trace hook."""

from .profiling import ThroughputMeter, trace

__all__ = ["ThroughputMeter", "trace"]
