"""needletail_tpu_torch — the PyTorch/CUDA port of ``needletail_tpu``.

The JAX package ``needletail_tpu`` stays the reference; this package runs
its device paths with PyTorch on an NVIDIA Hopper GPU, through kernels
written by hand in CUDA C++ (``csrc/``), and is held bit for bit against
the JAX functions on the same inputs.  It imports no JAX and nothing of
``needletail_tpu``: the host side (parsers, framers, batch planes, codecs)
is the port's own copy, and its native framer builds from
``csrc/framer.cpp``.

Layout mirrors the JAX package:
  * this module — the needletail-compatible surface, the same ``__all__``
    as the JAX package's root: ``parse_fastx_file``/``parse_fastx_string``/
    ``parse_fastx_reader``/``parse_fastx_stdin``, ``Record``,
    ``FastxReader``, ``normalize_seq``, ``reverse_complement``,
    ``decode_phred``, ``Sequence``, the error types and the host sequence
    modules ``sequence``, ``kmer``, ``bitkmer`` and ``quality``.  It is
    numpy only: importing it imports no ``torch``.
  * ``batch``, ``encoding``, ``errors``, ``parser``, ``io`` — the host side:
    batch planes and the one-buffer wire, the framers (``io.fast_batch``,
    ``io.native``), codecs, and the multi-worker front ``io.framing``.
  * ``device.ops``       — wire transport: ``unwire``, ``unpack_codes``,
    ``expand_vrows``, ``resolve_vbits``, ``encode_2bit``.
  * ``device.kmers``     — packed and canonical k-mer windows.
  * ``device.kernels``   — the hand-written kernels and their plain
    PyTorch versions.
  * ``device.count``     — dense spectra, sorted run counts, the
    slot-compaction cascade, the streaming sparse accumulator.
  * ``device.pipeline``  — ``hash_count_file`` and ``count_file``.
  * ``checkpoint``       — stream checkpoints, file-compatible with JAX's.
  * ``parallel``         — the sharded drivers on ``torch.distributed``
    (one process a device; NCCL on the card, gloo on the CPU).
  * ``dryrun``           — the sharded paths on tiny shapes, on the
    current process group.
  * ``cli``              — ``python -m needletail_tpu_torch.cli``: the
    device commands ``count``, ``hash-count``, ``spectrum``,
    ``minimizers`` and ``filter``, and the host commands ``stats``,
    ``bgzip`` and ``convert``.
"""

from . import bitkmer, errors, kmer, quality, sequence
from .api import (
    FastxReader,
    NeedletailError,
    Record,
    decode_phred,
    normalize_seq,
    parse_fastx_file,
    parse_fastx_string,
    reverse_complement,
)
from .errors import ParseError, ParseErrorKind, PhredOffsetError
from .seq_wrapper import Sequence
from .parser import parse_fastx_reader, parse_fastx_stdin

__version__ = "0.1.0"

__all__ = [
    "parse_fastx_file",
    "parse_fastx_string",
    "parse_fastx_reader",
    "parse_fastx_stdin",
    "Record",
    "FastxReader",
    "NeedletailError",
    "normalize_seq",
    "reverse_complement",
    "decode_phred",
    "ParseError",
    "ParseErrorKind",
    "PhredOffsetError",
    "Sequence",
    "errors",
    "sequence",
    "kmer",
    "bitkmer",
    "quality",
]
