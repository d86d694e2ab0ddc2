"""Phred quality decoding (ref needletail src/quality.rs).

Decodes Phred quality strings by subtracting the encoding offset
(Phred+33 -> ``!``, Phred+64 -> ``@``); raises ``PhredOffsetError`` when a
character is below the offset (ref src/quality.rs:15-28).

The port's copy of the JAX package's ``quality.py``.
"""

from __future__ import annotations

import enum
from typing import Union

import numpy as np

from .errors import PhredOffsetError

__all__ = ["PhredEncoding", "decode_phred"]


class PhredEncoding(enum.Enum):
    PHRED33 = 33
    PHRED64 = 64

    # Aliases matching the reference naming
    Phred33 = 33  # noqa: PIE796 - intentional alias
    Phred64 = 64  # noqa: PIE796 - intentional alias


def _as_bytes(data: Union[bytes, bytearray, memoryview, str]) -> bytes:
    if isinstance(data, str):
        return data.encode("utf-8")
    return bytes(data)


def decode_phred(
    qual: Union[bytes, bytearray, memoryview, str],
    encoding: PhredEncoding = PhredEncoding.PHRED33,
) -> bytes:
    """Decode Phred quality data to quality scores.

    Returns the scores as ``bytes`` (one score per input char).  Raises
    ``PhredOffsetError`` if any character's ASCII value is below the offset,
    reporting the *first* offending character (ref src/quality.rs:21-26).
    """
    raw = _as_bytes(qual)
    offset = encoding.value
    if not raw:
        return b""
    arr = np.frombuffer(raw, dtype=np.uint8)
    bad = arr < offset
    if bad.any():
        first = int(arr[int(np.argmax(bad))])
        raise PhredOffsetError(q=first, offset=offset)
    return (arr - np.uint8(offset)).tobytes()
