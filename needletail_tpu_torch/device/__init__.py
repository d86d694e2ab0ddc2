"""Device side of the port: transport ops, CUDA kernels, file drivers.

The submodules load on first use (``device.count`` or ``from .device
import count``), so importing the package imports no ``torch``.
"""

import importlib

__all__ = ["ops", "kmers", "count", "pipeline", "minimizers", "quality", "tiling"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
