"""The port's kernels, written by hand in CUDA for Hopper, each beside its
plain PyTorch version.

Counterpart of ``needletail_tpu/device/pallas_kernels.py``:

  * :func:`canonical_hash_keys` / :func:`canonical_hash_keys_packed` run
    ``csrc/hash_keys.cu`` (replaces the Pallas ``_keys_kernel`` through
    ``_run_tally``, pallas_kernels.py:183/:251);
  * :func:`canonical_key_planes` / :func:`canonical_key_planes_packed` run
    the planes mode of ``csrc/hash_keys.cu`` (replaces ``_planes_kernel``,
    :193, through ``canonical_key_planes(_packed)``, :324/:348);
  * :func:`mxu_histogram16` runs ``csrc/histogram16.cu`` (replaces the
    Pallas ``_packed_hist_kernel`` / ``_hist_kernel``, :408/:469);
  * :func:`mxu_compact_slots` runs ``csrc/compact_slots.cu`` (replaces
    ``_compact_kernel`` through ``mxu_compact_slots``, :585/:672);
  * :func:`canonical_hash_tally` runs the tally mode of
    ``csrc/hash_keys.cu`` (replaces ``_kernel``, :175, through
    ``canonical_hash_tally``, :275);
  * :func:`bitonic_block_sort` runs ``csrc/block_sort.cu`` (replaces
    ``_bitonic_kernel`` through ``bitonic_block_sort`` of the experiment
    ``benchmarks/exp_mosaic_sort.py``, :39/:84).

Key planes are int32 tensors holding uint32 bit patterns, with the
sentinel 0xFFFFFFFF (-1) on invalid lanes, as the Pallas planes kernel
writes them before its bitcast to uint32.

Each source says what bounds its kernel on the card and what its design
does about that.  A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches its kernel or raises.  The plain
versions (``*_plain``) take tensors on any device, so a GPU run can hold
each kernel against them.  They compute in int64: PyTorch implements no
``uint32`` shifts on the CPU, and an int64 product that wraps keeps the
low 32 bits a ``uint32`` product would give.

:data:`LAUNCHES` counts kernel launches by kernel name, one per launch
(one per sort for the block sort, whatever its number of kernels and
passes).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .kmers import u32_bits
from .ops import _INVALID, encode_2bit, unpack_codes

__all__ = [
    "canonical_hash_keys",
    "canonical_hash_keys_packed",
    "canonical_hash_keys_plain",
    "canonical_hash_keys_packed_plain",
    "canonical_key_planes",
    "canonical_key_planes_packed",
    "canonical_key_planes_plain",
    "canonical_key_planes_packed_plain",
    "mxu_histogram16",
    "histogram16_plain",
    "mxu_compact_slots",
    "compact_slots_plain",
    "canonical_hash_tally",
    "canonical_hash_tally_plain",
    "bitonic_block_sort",
    "block_sort_plain",
    "LAUNCHES",
    "reset_launches",
]

HASH_C1 = 0x9E3779B1
HASH_C2 = 0x85EBCA77
BINS = 1 << 16

LAUNCHES: Dict[str, int] = {
    "hash_keys": 0, "histogram16": 0, "key_planes": 0, "compact_slots": 0,
    "hash_tally": 0, "block_sort": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_k(k: int, table_bits: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    if not 0 <= table_bits <= 32:
        raise ValueError(f"table_bits must be in [0, 32], got {table_bits}")


def _on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA inputs, False for CPU ones; raises on anything else
    or on a mix of devices."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs must share one device, got {devices}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def _check_plane(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(
            f"{name} must be a {ndim}-D {dtype} tensor, got {t.dim()}-D "
            f"{t.dtype}"
        )


def _check_contiguous(**tensors: Optional[torch.Tensor]) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"the CUDA kernel needs a contiguous {name}")


# ---------------------------------------------------------------------------
# canonical k-mer hash keys
# ---------------------------------------------------------------------------


def _canonical_from_codes(
    codes: torch.Tensor, lengths: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(canonical, valid, use_rc)`` over ``[B, L]`` per-base codes (255
    invalid): the int64 canonical window starting at each lane."""
    b, l = codes.shape
    c = torch.nn.functional.pad(
        codes.to(torch.int64), (0, k - 1), value=_INVALID
    )
    fwd = torch.zeros((b, l), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    valid = torch.ones((b, l), dtype=torch.bool, device=c.device)
    for j in range(k):
        cj = c[:, j : j + l]
        valid &= cj < 4
        base = cj & 3
        fwd = (fwd << 2) | base
        rc |= (3 - base) << (2 * j)
    pos = torch.arange(l, device=c.device)[None, :]
    valid &= pos + k <= lengths.to(torch.int64)[:, None]
    use_rc = fwd > rc
    return torch.where(use_rc, rc, fwd), valid, use_rc


def _hash(canon: torch.Tensor, table_bits: int) -> torch.Tensor:
    """The table index of int64 canonical windows (in int64)."""
    hi = canon >> 32
    lo = canon & 0xFFFFFFFF
    # the int64 products may wrap; their low 32 bits are the uint32 ones
    return ((lo * HASH_C1) ^ (hi * HASH_C2)) & ((1 << table_bits) - 1)


def _hash_keys_from_codes(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, table_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version over per-base codes ``[B, L]`` (255 invalid)."""
    canon, valid, use_rc = _canonical_from_codes(codes, lengths, k)
    keys = torch.where(valid, _hash(canon, table_bits), -1).to(torch.int32)
    total = valid.sum()
    fwd_n = (valid & ~use_rc).sum()
    return keys, total, fwd_n


def canonical_hash_keys_plain(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    table_bits: int = 20,
    normalized: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`canonical_hash_keys`."""
    _check_k(k, table_bits)
    return _hash_keys_from_codes(
        encode_2bit(seqs, normalized), lengths, k, table_bits
    )


def canonical_hash_keys_packed_plain(
    codes: torch.Tensor,
    vbits: Optional[torch.Tensor],
    lengths: torch.Tensor,
    k: int,
    table_bits: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`canonical_hash_keys_packed`."""
    _check_k(k, table_bits)
    return _hash_keys_from_codes(
        unpack_codes(codes, vbits), lengths, k, table_bits
    )


def _key_planes_from_codes(
    codes: torch.Tensor, lengths: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain key planes over per-base codes ``[B, L]`` (255 invalid)."""
    canon, valid, use_rc = _canonical_from_codes(codes, lengths, k)
    sentinel = torch.tensor(-1, dtype=torch.int32, device=canon.device)
    hi = torch.where(valid, u32_bits(canon >> 32), sentinel)
    lo = torch.where(valid, u32_bits(canon), sentinel)
    return hi, lo, valid.sum(), (valid & ~use_rc).sum()


def canonical_key_planes_plain(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    normalized: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`canonical_key_planes`."""
    _check_k(k, 0)
    return _key_planes_from_codes(encode_2bit(seqs, normalized), lengths, k)


def canonical_key_planes_packed_plain(
    codes: torch.Tensor,
    vbits: Optional[torch.Tensor],
    lengths: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`canonical_key_planes_packed`."""
    _check_k(k, 0)
    return _key_planes_from_codes(unpack_codes(codes, vbits), lengths, k)


def _hash_keys_lib() -> ctypes.CDLL:
    lib = _build.load("hash_keys")
    fn = lib.nt_hash_keys
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [
            p, p, p, p, p, ll, ll, ll, ll, i, ctypes.c_uint, i, i, p,
        ]
        fn.restype = i
        planes = lib.nt_key_planes
        planes.argtypes = [p, p, p, p, p, p, ll, ll, ll, ll, i, i, i, p]
        planes.restype = i
        tally = lib.nt_hash_tally
        tally.argtypes = [
            p, p, p, p, p, p, ll, ll, ll, ll, i, ctypes.c_uint, i, i, p,
        ]
        tally.restype = i
    return lib


def _launch_hash_keys(
    data: torch.Tensor,
    vbits: Optional[torch.Tensor],
    lengths: torch.Tensor,
    lanes: int,
    k: int,
    table_bits: int,
    packed: bool,
    normalized: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_contiguous(data=data, vbits=vbits, lengths=lengths)
    b = data.shape[0]
    keys = torch.empty((b, lanes), dtype=torch.int32, device=data.device)
    tallies = torch.zeros(2, dtype=torch.int64, device=data.device)
    if b == 0 or lanes == 0:
        return keys, tallies[0], tallies[1]
    fn = _hash_keys_lib().nt_hash_keys
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(
            data.data_ptr(),
            None if vbits is None else vbits.data_ptr(),
            lengths.data_ptr(),
            keys.data_ptr(),
            tallies.data_ptr(),
            b,
            lanes,
            data.shape[1],
            0 if vbits is None else vbits.shape[1],
            k,
            (1 << table_bits) - 1,
            int(packed),
            int(normalized),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_keys kernel launch failed: CUDA error {err}")
    LAUNCHES["hash_keys"] += 1
    return keys, tallies[0], tallies[1]


def _launch_two_planes(
    name: str,
    data: torch.Tensor,
    vbits: Optional[torch.Tensor],
    lengths: torch.Tensor,
    lanes: int,
    k: int,
    packed: bool,
    normalized: bool,
    table_bits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-plane modes of ``hash_keys.cu``: ``key_planes`` (hi, lo)
    and ``hash_tally`` (idx, weight, hashed into ``table_bits``)."""
    _check_contiguous(data=data, vbits=vbits, lengths=lengths)
    b = data.shape[0]
    first = torch.empty((b, lanes), dtype=torch.int32, device=data.device)
    second = torch.empty_like(first)
    tallies = torch.zeros(2, dtype=torch.int64, device=data.device)
    if b == 0 or lanes == 0:
        return first, second, tallies[0], tallies[1]
    lib = _hash_keys_lib()
    fn = lib.nt_hash_tally if name == "hash_tally" else lib.nt_key_planes
    mask = () if table_bits is None else ((1 << table_bits) - 1,)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(
            data.data_ptr(),
            None if vbits is None else vbits.data_ptr(),
            lengths.data_ptr(),
            first.data_ptr(),
            second.data_ptr(),
            tallies.data_ptr(),
            b,
            lanes,
            data.shape[1],
            0 if vbits is None else vbits.shape[1],
            k,
            *mask,
            int(packed),
            int(normalized),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return first, second, tallies[0], tallies[1]


def _check_packed(
    codes: torch.Tensor, vbits: Optional[torch.Tensor], lengths: torch.Tensor
) -> None:
    _check_plane("codes", codes, torch.uint8, 2)
    _check_plane("lengths", lengths, torch.int32, 1)
    b, lq = codes.shape
    if lengths.shape[0] != b:
        raise ValueError("lengths must have one entry per row of codes")
    if vbits is not None:
        _check_plane("vbits", vbits, torch.uint8, 2)
        if vbits.shape[0] != b or vbits.shape[1] * 8 != lq * 4:
            raise ValueError(
                f"vbits {tuple(vbits.shape)} does not match codes {(b, lq)}"
            )


def _check_ascii(seqs: torch.Tensor, lengths: torch.Tensor) -> None:
    _check_plane("seqs", seqs, torch.uint8, 2)
    _check_plane("lengths", lengths, torch.int32, 1)
    if lengths.shape[0] != seqs.shape[0]:
        raise ValueError("lengths must have one entry per row of seqs")


def canonical_key_planes(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    normalized: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical k-mer key planes of an ASCII read plane: the exact path's
    extractor.

    ``seqs`` uint8 ``[B, L]``, ``lengths`` int32 ``[B]``.  Returns
    ``(hi, lo, total, fwd)``: int32 ``[B, L]`` planes of the canonical
    window starting at lane p (uint32 bit patterns, ``hi = canonical >>
    32``; -1 in both where the window is invalid), and the int64 tallies
    of :func:`canonical_hash_keys`.  Equals JAX's ``canonical_key_planes``
    bit for bit.
    """
    _check_k(k, 0)
    _check_ascii(seqs, lengths)
    if not _on_cuda(seqs, lengths):
        return canonical_key_planes_plain(seqs, lengths, k, normalized)
    return _launch_two_planes(
        "key_planes", seqs, None, lengths, seqs.shape[1], k, False, normalized
    )


def canonical_key_planes_packed(
    codes: torch.Tensor,
    vbits: Optional[torch.Tensor],
    lengths: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`canonical_key_planes` over the packed transport (``codes``
    uint8 ``[B, L/4]``, ``vbits`` uint8 ``[B, L/8]`` or None)."""
    _check_k(k, 0)
    _check_packed(codes, vbits, lengths)
    if not _on_cuda(codes, vbits, lengths):
        return canonical_key_planes_packed_plain(codes, vbits, lengths, k)
    return _launch_two_planes(
        "key_planes", codes, vbits, lengths, codes.shape[1] * 4, k, True, True
    )


def canonical_hash_keys(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    table_bits: int = 20,
    normalized: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical k-mer hash keys of an ASCII read plane.

    ``seqs`` uint8 ``[B, L]``, ``lengths`` int32 ``[B]``.  Returns
    ``(keys, total, fwd)``: int32 ``[B, L]`` keys (the window starting at
    lane p; -1 where it is invalid), and int64 scalars counting valid
    windows and those taken from the forward strand.  Equals JAX's
    ``canonical_hash_keys`` for every L (no VMEM limit, no row blocking).
    """
    _check_k(k, table_bits)
    _check_ascii(seqs, lengths)
    if not _on_cuda(seqs, lengths):
        return canonical_hash_keys_plain(seqs, lengths, k, table_bits, normalized)
    return _launch_hash_keys(
        seqs, None, lengths, seqs.shape[1], k, table_bits, False, normalized
    )


def canonical_hash_keys_packed(
    codes: torch.Tensor,
    vbits: Optional[torch.Tensor],
    lengths: torch.Tensor,
    k: int,
    table_bits: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`canonical_hash_keys` over the packed transport: ``codes``
    uint8 ``[B, L/4]`` and ``vbits`` uint8 ``[B, L/8]`` or None (every
    base valid).  The normalization was applied when the batch was
    packed."""
    _check_k(k, table_bits)
    _check_packed(codes, vbits, lengths)
    if not _on_cuda(codes, vbits, lengths):
        return canonical_hash_keys_packed_plain(
            codes, vbits, lengths, k, table_bits
        )
    return _launch_hash_keys(
        codes, vbits, lengths, codes.shape[1] * 4, k, table_bits, True, True
    )


# ---------------------------------------------------------------------------
# 2^16-bin histogram
# ---------------------------------------------------------------------------


def _histogram_keys(
    idx: torch.Tensor, weight: Optional[torch.Tensor]
) -> torch.Tensor:
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.numel() >= (1 << 31):
        raise ValueError(
            f"mxu_histogram16 takes < 2^31 keys per call (got {idx.numel()});"
            " split the batch to keep the int32 bins exact"
        )
    if weight is None:
        return idx.reshape(-1)
    if weight.shape != idx.shape:
        raise ValueError("weight must have the shape of idx")
    return torch.where(weight > 0, idx, -1).reshape(-1)


def histogram16_plain(
    idx: torch.Tensor, weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`mxu_histogram16`."""
    keys = _histogram_keys(idx, weight).to(torch.int64)
    keys = keys[keys >= 0] & (BINS - 1)
    return torch.bincount(keys, minlength=BINS).to(torch.int32)


def _histogram_lib() -> ctypes.CDLL:
    lib = _build.load("histogram16")
    fn = lib.nt_histogram16
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, p]
        fn.restype = ctypes.c_int
    return lib


def mxu_histogram16(
    idx: torch.Tensor, weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Exact int32 ``[65536]`` histogram of the int32 keys ``idx``.

    Keys < 0 are dropped; a key counts in bin ``key & 0xFFFF``.  With
    ``weight`` (same shape), only entries whose weight is > 0 count.  A
    call takes fewer than 2^31 keys, so no bin can wrap.  The name is the
    JAX function's; on the GPU the count runs on integer atomics.
    """
    keys = _histogram_keys(idx, weight)
    if not _on_cuda(keys):
        return histogram16_plain(keys)
    _check_contiguous(idx=keys)
    counts = torch.zeros(BINS, dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:
        return counts
    fn = _histogram_lib().nt_histogram16
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = fn(keys.data_ptr(), keys.numel(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"histogram16 kernel launch failed: CUDA error {err}")
    LAUNCHES["histogram16"] += 1
    return counts


# ---------------------------------------------------------------------------
# per-chunk slot compaction
# ---------------------------------------------------------------------------

_GROUP = 8  # chunks per padding unit, as the Pallas grid steps


def _compact_inputs(hi, lo, counts, chunk: int, slots: int):
    if chunk <= 0 or chunk % 32 or slots <= 0:
        raise ValueError(
            f"chunk must be a positive multiple of 32 and slots positive, "
            f"got chunk={chunk} slots={slots}"
        )
    for name, t in (("hi", hi), ("lo", lo), ("counts", counts)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if counts.numel() != lo.numel() or (hi is not None and hi.numel() != lo.numel()):
        raise ValueError("hi, lo and counts must hold the same number of lanes")
    rows = -(-lo.numel() // (_GROUP * chunk)) * _GROUP
    hi, lo, counts = (
        None if t is None else t.reshape(-1) for t in (hi, lo, counts)
    )
    return hi, lo, counts, rows


def compact_slots_plain(
    hi: Optional[torch.Tensor],
    lo: torch.Tensor,
    counts: torch.Tensor,
    chunk: int = 1024,
    slots: int = 128,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`mxu_compact_slots`."""
    hi, lo, counts, rows = _compact_inputs(hi, lo, counts, chunk, slots)
    n = lo.numel()
    dev = lo.device
    c = torch.zeros(rows * chunk, dtype=torch.int32, device=dev)
    c[:n] = counts
    flag = (c > 0).view(rows, chunk)
    rank = flag.to(torch.int64).cumsum(1) - 1
    ok = flag.sum(1).max() <= slots if rows else torch.tensor(True, device=dev)
    take = flag & (rank < slots)
    row = torch.arange(rows, device=dev)[:, None].expand(rows, chunk)
    dest = (row * slots + rank)[take]
    src = take.reshape(-1)[:n]

    def place(values: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(rows * slots, dtype=torch.int32, device=dev)
        out[dest] = values[src]
        return out

    return (
        None if hi is None else place(hi), place(lo), place(counts), ok,
    )


def _compact_lib() -> ctypes.CDLL:
    lib = _build.load("compact_slots")
    fn = lib.nt_compact_slots
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, p, p, p, p, p]
        fn.restype = i
    return lib


def mxu_compact_slots(
    hi: Optional[torch.Tensor],
    lo: torch.Tensor,
    counts: torch.Tensor,
    chunk: int = 1024,
    slots: int = 128,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move each chunk's flagged (``counts > 0``) entries to its first slots.

    ``hi`` (or None: narrow k <= 15 keys), ``lo`` and ``counts`` are int32
    streams of one length N, as ``count.unique_counts`` returns them.  The
    stream is cut into ``chunk``-lane chunks, padded with zeros to a
    multiple of 8 chunks.  Returns ``(hi_c, lo_c, counts_c, ok)`` of length
    ``ceil(N / (8 * chunk)) * 8 * slots``: each chunk's flagged entries, in
    input order, in its first slots, the rest 0; ``ok`` (a bool scalar on
    the input's device) is False iff some chunk had more than ``slots``
    flags, and then each slot j still holds the chunk's j-th flagged
    entry.  The name is the JAX function's; on the GPU the compaction is a
    ballot-and-prefix-count scatter.
    """
    hi, lo, counts, rows = _compact_inputs(hi, lo, counts, chunk, slots)
    if not _on_cuda(hi, lo, counts):
        return compact_slots_plain(hi, lo, counts, chunk, slots)
    _check_contiguous(hi=hi, lo=lo, counts=counts)
    dev = lo.device
    out = [
        torch.empty(rows * slots, dtype=torch.int32, device=dev)
        for _ in range(2 if hi is None else 3)
    ]
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    if rows:
        fn = _compact_lib().nt_compact_slots
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(
                None if hi is None else hi.data_ptr(),
                lo.data_ptr(),
                counts.data_ptr(),
                lo.numel(),
                chunk,
                slots,
                None if hi is None else out[-3].data_ptr(),
                out[-2].data_ptr(),
                out[-1].data_ptr(),
                overflow.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(
                f"compact_slots kernel launch failed: CUDA error {err}"
            )
        LAUNCHES["compact_slots"] += 1
    hi_c = None if hi is None else out[0]
    return hi_c, out[-2], out[-1], overflow[0] == 0


# ---------------------------------------------------------------------------
# hash-tally planes
# ---------------------------------------------------------------------------


def _check_block_rows(block_rows: Optional[int], rows: int) -> None:
    """JAX's only use of an explicit ``block_rows`` that the port keeps:
    it must divide the batch rows (the CUDA kernel has no row blocks)."""
    if block_rows is not None and (block_rows <= 0 or rows % block_rows):
        raise ValueError(f"batch rows {rows} not a multiple of {block_rows}")


def canonical_hash_tally_plain(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    table_bits: int = 20,
    normalized: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`canonical_hash_tally`."""
    _check_k(k, table_bits)
    canon, valid, use_rc = _canonical_from_codes(
        encode_2bit(seqs, normalized), lengths, k
    )
    idx = torch.where(valid, _hash(canon, table_bits), 0).to(torch.int32)
    return idx, valid.to(torch.int32), valid.sum(), (valid & ~use_rc).sum()


def canonical_hash_tally(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    table_bits: int = 20,
    normalized: bool = True,
    block_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical k-mer hash indices and weights of an ASCII read plane.

    ``seqs`` uint8 ``[B, L]``, ``lengths`` int32 ``[B]``.  Returns ``(idx,
    weight, total, fwd)``: int32 ``[B, L]`` planes, ``idx`` the hash of
    the window starting at lane p where it is valid and 0 where not,
    ``weight`` 1 where it is valid and 0 where not, and the int64 tallies
    of :func:`canonical_hash_keys`.  ``mxu_histogram16(idx, weight)``
    counts them.  ``block_rows``, JAX's VMEM tiling, only has to divide
    the rows when given.  Equals JAX's ``canonical_hash_tally``.
    """
    _check_k(k, table_bits)
    _check_ascii(seqs, lengths)
    _check_block_rows(block_rows, seqs.shape[0])
    if not _on_cuda(seqs, lengths):
        return canonical_hash_tally_plain(
            seqs, lengths, k, table_bits, normalized
        )
    return _launch_two_planes(
        "hash_tally", seqs, None, lengths, seqs.shape[1], k, False,
        normalized, table_bits,
    )


# ---------------------------------------------------------------------------
# bitonic block sort
# ---------------------------------------------------------------------------

_INT32_SIGN = -(1 << 31)


def _check_block_sort(x: torch.Tensor, block_lanes: int) -> None:
    _check_plane("x", x, torch.int32, 1)
    if block_lanes < 128 or block_lanes & (block_lanes - 1):
        raise ValueError(
            f"block_lanes must be a power of two >= 128, got {block_lanes}"
        )
    if x.numel() % block_lanes:
        raise ValueError(
            f"{x.numel()} lanes are not a multiple of block_lanes "
            f"{block_lanes}"
        )


def block_sort_plain(x: torch.Tensor, block_lanes: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`bitonic_block_sort`: the sign bit
    flipped (unsigned order as signed), a row sort, the bit flipped back."""
    _check_block_sort(x, block_lanes)
    rows = (x ^ _INT32_SIGN).view(-1, block_lanes)
    return (torch.sort(rows, dim=1).values ^ _INT32_SIGN).reshape(-1)


def _block_sort_lib() -> ctypes.CDLL:
    lib = _build.load("block_sort")
    fn = lib.nt_block_sort
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.nt_block_sort_scratch.argtypes = [ll, ll]
        lib.nt_block_sort_scratch.restype = ll
    return lib


def bitonic_block_sort(x: torch.Tensor, block_lanes: int) -> torch.Tensor:
    """Sort each consecutive ``block_lanes`` span of ``x`` ascending, as
    unsigned 32-bit keys, into a new tensor.

    ``x`` is an int32 ``[N]`` tensor of uint32 bit patterns; ``block_lanes``
    a power of two >= 128 that divides N (JAX's experiment fails only at
    its reshape, or sorts wrongly, otherwise; here they raise
    ``ValueError``).  Equals JAX's ``bitonic_block_sort`` bit for bit.
    """
    _check_block_sort(x, block_lanes)
    if not _on_cuda(x):
        return block_sort_plain(x, block_lanes)
    _check_contiguous(x=x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _block_sort_lib()
    # spans past one CTA's tile merge through a ping-pong buffer
    lanes = lib.nt_block_sort_scratch(x.numel(), block_lanes)
    if lanes < 0:
        raise ValueError(f"block_sort takes at most 2^31 lanes, got {x.numel()}")
    scratch = torch.empty(lanes, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nt_block_sort(
            x.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if lanes else None,
            x.numel(), block_lanes, stream,
        )
    if err != 0:
        raise RuntimeError(f"block_sort kernel launch failed: CUDA error {err}")
    LAUNCHES["block_sort"] += 1
    return out
