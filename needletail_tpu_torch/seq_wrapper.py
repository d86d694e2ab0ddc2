"""``Sequence``: a byte-string wrapper mirroring the reference's Sequence
trait surface (ref src/sequence.rs:156-253) for users who want method-style
access on plain bytes rather than the free functions.

The port's copy of the JAX package's ``seq_wrapper.py``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple, Union

from . import bitkmer as _bitkmer
from . import kmer as _kmer
from . import sequence as _sequence

__all__ = ["Sequence"]


class Sequence(bytes):
    """``bytes`` subclass with the reference trait methods.

    >>> Sequence(b"AACC").reverse_complement()
    b'GGTT'
    >>> bytes(Sequence(b"ADGH").normalize(False))
    b'ANGN'
    """

    def sequence(self) -> bytes:
        return bytes(self)

    def strip_returns(self) -> "Sequence":
        """Remove all \\r and \\n (ref sequence.rs:165-191)."""
        return Sequence(_sequence.strip_returns(self))

    def reverse_complement(self) -> "Sequence":
        """Reverse complement (ref sequence.rs:202-208)."""
        return Sequence(_sequence.reverse_complement(self))

    def normalize(self, iupac: bool = False) -> "Sequence":
        """Normalized form; returns self when already normal
        (ref sequence.rs:226-232)."""
        out = _sequence.normalize(self, iupac)
        return self if out is None else Sequence(out)

    def canonical(self) -> "Sequence":
        """Lexicographically smaller of self / reverse complement
        (ref sequence.rs:110-134)."""
        return Sequence(_sequence.canonical(self))

    def minimizer(self, length: int) -> "Sequence":
        """Smallest length-``length`` substring of self or its rc
        (ref sequence.rs:139-152)."""
        return Sequence(_sequence.minimizer(self, length))

    def kmers(self, k: int) -> Iterator[bytes]:
        """Plain sliding-window k-mers (ref kmer.rs:13-41)."""
        return _kmer.kmers(self, k)

    def canonical_kmers(
        self, k: int, reverse_complement: bytes
    ) -> Iterator[Tuple[int, bytes, bool]]:
        """(pos, canonical kmer, was_rc) over valid windows (ref kmer.rs:48-129)."""
        return _kmer.canonical_kmers(self, reverse_complement, k)

    def bit_kmers(
        self, k: int, canonical: bool = False
    ) -> Iterator[Tuple[int, Tuple[int, int], bool]]:
        """(pos, (value, k), was_rc) 2-bit packed k-mers (ref bitkmer.rs:72-109)."""
        return _bitkmer.bit_kmers(self, k, canonical)

    def quality_mask(self, qual: bytes, score: int) -> "Sequence":
        """Mask bases below ``score`` to N (ref sequence.rs:280-296)."""
        return Sequence(_sequence.quality_mask(self, qual, score))
