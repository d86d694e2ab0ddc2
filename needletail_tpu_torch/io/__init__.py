"""Host-side I/O: compression sniffing/decoding and batched ingestion.

The port's copy of the JAX package's ``io/__init__.py``.
"""

from .compression import (
    BZ_MAGIC,
    GZ_MAGIC,
    XZ_MAGIC,
    ZST_MAGIC,
    ChainedReader,
    open_uncompressed,
    sniff_compression,
    wrap_decompressor,
)

from .bgzf import BGZFReader, is_bgzf, write_bgzf
from .feed import device_feed
from .spill import decompress_to_spill, spilled_input


def __getattr__(name):
    # lazy: bucketed -> fast_batch -> parser -> io.compression would be a
    # circular import at package-init time
    if name in ("bucketed_read_batches", "DEFAULT_BUCKETS"):
        from . import bucketed

        return getattr(bucketed, name)
    raise AttributeError(name)


__all__ = [
    "bucketed_read_batches",
    "DEFAULT_BUCKETS",
    "BGZFReader",
    "is_bgzf",
    "write_bgzf",
    "device_feed",
    "decompress_to_spill",
    "spilled_input",
    "GZ_MAGIC",
    "BZ_MAGIC",
    "XZ_MAGIC",
    "ZST_MAGIC",
    "ChainedReader",
    "open_uncompressed",
    "sniff_compression",
    "wrap_decompressor",
]
