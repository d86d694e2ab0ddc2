"""The hash-count path's kernels, written by hand in CUDA for Hopper, each
beside its plain PyTorch version.

Counterpart of ``needletail_tpu/device/pallas_kernels.py``:

  * :func:`canonical_hash_keys` / :func:`canonical_hash_keys_packed` run
    ``csrc/hash_keys.cu`` (replaces the Pallas ``_keys_kernel`` through
    ``_run_tally``, pallas_kernels.py:183/:251);
  * :func:`mxu_histogram16` runs ``csrc/histogram16.cu`` (replaces the
    Pallas ``_packed_hist_kernel`` / ``_hist_kernel``, :408/:469).

Each source says what bounds its kernel on the card and what its design
does about that.  A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches its kernel or raises.  The plain
versions (``*_plain``) take tensors on any device, so a GPU run can hold
each kernel against them.  They compute in int64: PyTorch implements no
``uint32`` shifts on the CPU, and an int64 product that wraps keeps the
low 32 bits a ``uint32`` product would give.

:data:`LAUNCHES` counts kernel launches by kernel name, one per launch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .ops import _INVALID, encode_2bit, unpack_codes

__all__ = [
    "canonical_hash_keys",
    "canonical_hash_keys_packed",
    "canonical_hash_keys_plain",
    "canonical_hash_keys_packed_plain",
    "mxu_histogram16",
    "histogram16_plain",
    "LAUNCHES",
    "reset_launches",
]

HASH_C1 = 0x9E3779B1
HASH_C2 = 0x85EBCA77
BINS = 1 << 16

LAUNCHES: Dict[str, int] = {"hash_keys": 0, "histogram16": 0}


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


def _hash_keys_from_codes(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, table_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version over per-base codes ``[B, L]`` (255 invalid)."""
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
    canon = torch.where(use_rc, rc, fwd)
    hi = canon >> 32
    lo = canon & 0xFFFFFFFF
    # the int64 products may wrap; their low 32 bits are the uint32 ones
    h = ((lo * HASH_C1) ^ (hi * HASH_C2)) & ((1 << table_bits) - 1)
    keys = torch.where(valid, h, -1).to(torch.int32)
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


def _hash_keys_lib() -> ctypes.CDLL:
    lib = _build.load("hash_keys")
    fn = lib.nt_hash_keys
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [
            p, p, p, p, p, ll, ll, ll, ll, i, ctypes.c_uint, i, i, p,
        ]
        fn.restype = i
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
    _check_plane("seqs", seqs, torch.uint8, 2)
    _check_plane("lengths", lengths, torch.int32, 1)
    if lengths.shape[0] != seqs.shape[0]:
        raise ValueError("lengths must have one entry per row of seqs")
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
    if not _on_cuda(codes, vbits, lengths):
        return canonical_hash_keys_packed_plain(
            codes, vbits, lengths, k, table_bits
        )
    return _launch_hash_keys(
        codes, vbits, lengths, lq * 4, k, table_bits, True, True
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
