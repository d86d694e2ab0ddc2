"""FASTA/FASTQ record framers of the port.

The port's copy of the parts of ``needletail_tpu/parser`` that the batch
framers use: the pure-Python FASTA and FASTQ readers (the fallback of the
native framer, and its tail parser) and their record type.
"""

from __future__ import annotations

from .fasta import FastaReader
from .fastq import FastqReader
from .record import SequenceRecord
from .utils import FastxReader, Format, LineEnding, Position

__all__ = [
    "FastaReader",
    "FastqReader",
    "FastxReader",
    "SequenceRecord",
    "Format",
    "LineEnding",
    "Position",
]
