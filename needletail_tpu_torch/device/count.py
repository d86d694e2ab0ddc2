"""K-mer counting on the device: dense spectra, targeted counts, sorted
exact spectra.

Counterpart of ``needletail_tpu/device/count.py``; every function returns
what its JAX twin returns on the same input, with (hi, lo) key planes as
int32 tensors of uint32 bit patterns and the invalid-window sentinel
0xFFFFFFFF as -1.

  * :func:`dense_spectrum`: a ``4^k`` table, for k <= 12.  On CUDA, k <= 9
    runs the 2^16-bin histogram kernel (4^9 as four masked passes).
  * :func:`match_count`: occurrences of one k-mer without a table.
  * :func:`unique_counts` / :func:`sorted_spectrum`: exact counts for any
    k <= 31 by one sort and run lengths.  JAX sorts (hi, lo) as unsigned
    pairs with ``lax.sort``; here they pack into one int64 whose sign bit
    is flipped, so a signed ``torch.sort`` gives the unsigned order and
    the sentinel (all ones) becomes ``INT64_MAX`` and sorts last.  Narrow
    keys (k <= 15, ``hi`` None) sort as their unsigned 32-bit values.
  * :func:`compact_runs_cascade`: two passes of the slot-compaction
    kernel shrink a flush up to 64x before the stable partition of
    :func:`compact_runs_device` runs on the remainder.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .kmers import KmerWindows, u32_bits

__all__ = [
    "dense_spectrum",
    "match_count",
    "valid_count",
    "forward_count",
    "sorted_spectrum",
    "unique_counts",
    "mask_keys",
    "compact_spectrum",
    "compact_runs_device",
    "compact_runs_cascade",
    "finalize_sparse",
    "finalize_sparse_device",
    "merge_sorted_spectra",
    "SparseSpectrumAccumulator",
    "SPARSE_FLUSH_LANES",
    "spectrum_arrays_to_dict",
    "spectrum_to_dict",
    "merge_spectra",
    "MAX_DENSE_K",
    "MXU_DENSE_K",
    "FLUSH_ROUTES",
    "reset_flush_routes",
]

MAX_DENSE_K = 12

# largest k whose [4^k] table rides the 2^16-bin histogram kernel (4^9 as
# four masked passes); beyond it, dense output accumulates through the
# sorted sparse path and densifies at the end
MXU_DENSE_K = 9

_SENTINEL = -1  # 0xFFFFFFFF as an int32 bit pattern
_SIGN = -(1 << 63)  # flips the sign bit of an int64


# finalize_sparse calls by how their runs were compacted: "cascade" (the
# slot-compaction cascade's first pass held), "host_filter" (it overflowed
# on a mostly-distinct stream: the sorted runs were pulled whole),
# "stable_partition" (full-length compaction on the device) or "host" (no
# device compaction)
FLUSH_ROUTES: Dict[str, int] = {
    "cascade": 0,
    "host_filter": 0,
    "stable_partition": 0,
    "host": 0,
}


def reset_flush_routes() -> None:
    for route in FLUSH_ROUTES:
        FLUSH_ROUTES[route] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def dense_spectrum(
    windows: KmerWindows, k: int, use_kernel: Optional[bool] = None
) -> torch.Tensor:
    """Exact counts of all 4^k k-mers: int32 ``[4^k]``.

    ``use_kernel`` (default: on for CUDA tensors, for k <= 9) runs the
    2^16-bin histogram kernel, where the packed k-mer is the bin; a table
    of 4^9 bins runs as four masked passes.  Otherwise one ``bincount``.
    """
    if k > MAX_DENSE_K:
        raise ValueError(f"dense spectrum needs k <= {MAX_DENSE_K}, got {k}")
    n_bins = 4**k
    if use_kernel is None:
        use_kernel = k <= MXU_DENSE_K and _on_cuda(windows.lo)
    if use_kernel:
        from .kernels import mxu_histogram16

        keys = torch.where(windows.valid, windows.lo, _SENTINEL)
        if n_bins <= 65536:
            return mxu_histogram16(keys)[:n_bins]
        parts = []
        for t in range(n_bins // 65536):
            base = t * 65536
            in_range = (keys >= base) & (keys < base + 65536)
            parts.append(mxu_histogram16(torch.where(in_range, keys - base, -1)))
        return torch.cat(parts)
    keys = windows.lo[windows.valid].to(torch.int64)
    return torch.bincount(keys, minlength=n_bins).to(torch.int32)


def match_count(windows: KmerWindows, target_hi, target_lo) -> torch.Tensor:
    """Number of valid windows equal to the packed target (uint32 halves,
    as :func:`pipeline.pack_target` gives them)."""
    hi = u32_bits(torch.tensor(int(target_hi)))
    lo = u32_bits(torch.tensor(int(target_lo)))
    hit = (windows.hi == hi.to(windows.hi.device)) & (
        windows.lo == lo.to(windows.lo.device)
    )
    return (hit & windows.valid).sum()


def valid_count(windows: KmerWindows) -> torch.Tensor:
    """Total number of valid windows (k-mers emitted)."""
    return windows.valid.sum()


def forward_count(windows: KmerWindows) -> torch.Tensor:
    """Number of valid windows kept in forward orientation."""
    return (windows.valid & ~windows.was_rc).sum()


def _pack(hi: Optional[torch.Tensor], lo: torch.Tensor) -> torch.Tensor:
    """int64 sort keys of flat key planes: the unsigned order of (hi, lo),
    or of lo alone when ``hi`` is None."""
    lo_u = lo.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    if hi is None:
        return lo_u
    # hi as signed int32 times 2^32 cannot overflow
    return ((hi.reshape(-1).to(torch.int64) << 32) | lo_u) ^ _SIGN


def _unpack(
    keys: torch.Tensor, wide: bool
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    if not wide:
        return None, u32_bits(keys)
    bits = keys ^ _SIGN
    return (bits >> 32).to(torch.int32), u32_bits(bits)


def unique_counts(
    hi: Optional[torch.Tensor], lo: torch.Tensor
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Exact run counts of flat (hi, lo) key streams (any shape, flattened).

    Invalid keys carry the sentinel already; they sort last and count 0.
    Returns ``(hi_sorted, lo_sorted, counts)``, ``counts[i]`` int32 the run
    length at the first element of each distinct key's run and 0
    elsewhere.  ``hi=None`` is the narrow path (k <= 15 keys fit lo, below
    the sentinel) and returns ``None`` for ``hi_sorted``.  No host sync:
    run lengths come from the distance to the next run head, found by a
    scatter of each lane's position to its run id (``amin``) and a gather
    (JAX takes a suffix ``cummin``, which PyTorch runs as a slow scan with
    indices).
    """
    keys = torch.sort(_pack(hi, lo)).values
    n = keys.shape[0]
    hi_s, lo_s = _unpack(keys, hi is not None)
    if n == 0:
        return hi_s, lo_s, torch.zeros(0, dtype=torch.int32, device=lo.device)
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    pos = torch.arange(n, device=keys.device)
    run_id = first.cumsum(0) - 1
    # heads[r]: position of run r's head; n past the last run
    heads = torch.full((n + 1,), n, dtype=torch.int64, device=keys.device)
    heads.scatter_reduce_(0, run_id, pos, "amin")
    counts = torch.where(first, heads[run_id + 1] - pos, 0)
    sentinel = 0xFFFFFFFF if hi is None else torch.iinfo(torch.int64).max
    counts = torch.where(keys == sentinel, 0, counts).to(torch.int32)
    return hi_s, lo_s, counts


def mask_keys(windows: KmerWindows) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (hi, lo) keys with invalid windows replaced by the sentinel."""
    hi = torch.where(windows.valid, windows.hi, _SENTINEL).reshape(-1)
    lo = torch.where(windows.valid, windows.lo, _SENTINEL).reshape(-1)
    return hi, lo


def sorted_spectrum(
    windows: KmerWindows,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact spectrum for any k: :func:`unique_counts` of the masked keys."""
    hi, lo = mask_keys(windows)
    return unique_counts(hi, lo)


def compact_runs_device(
    hi_s: Optional[torch.Tensor], lo_s: torch.Tensor, counts: torch.Tensor
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move the run heads of :func:`unique_counts` output to the front, in
    order, with a stable partition on ``counts <= 0`` (the rest keep their
    order behind them).  Returns ``(hi_c, lo_c, counts_c, n_distinct)``,
    ``n_distinct`` a 0-d tensor on the device, so a flush pulls only
    ``[:n_distinct]`` to the host."""
    tail = (counts <= 0).to(torch.uint8)
    order = torch.sort(tail, stable=True).indices
    hi_c = None if hi_s is None else hi_s[order]
    n = (counts > 0).sum(dtype=torch.int32)
    return hi_c, lo_s[order], counts[order], n


def compact_runs_cascade(
    hi_s: Optional[torch.Tensor],
    lo_s: torch.Tensor,
    counts: torch.Tensor,
    n_on_overflow: bool = False,
):
    """:func:`compact_runs_device` after two passes of the slot-compaction
    kernel (8x order-preserving reduction each).

    The first pass is valid only if no 1024-lane chunk holds more than 128
    run heads; on its overflow this returns None (the caller compacts the
    full stream) or, with ``n_on_overflow``, ``(None, None, None,
    n_distinct)``.  Overflow of the second pass keeps the first pass's
    output.  Both ``ok`` flags and ``n_distinct`` reach the host in one
    pull.
    """
    from .kernels import mxu_compact_slots

    h1, l1, c1, ok1 = mxu_compact_slots(hi_s, lo_s, counts)
    h2, l2, c2, ok2 = mxu_compact_slots(h1, l1, c1)
    # the passes keep every run, so the distinct total is the input's
    n_distinct = (counts > 0).sum(dtype=torch.int64)
    oks = torch.stack([ok1.to(torch.int64), ok2.to(torch.int64), n_distinct])
    oks = oks.cpu().tolist()
    if not oks[0]:
        return (None, None, None, oks[2]) if n_on_overflow else None
    if oks[1]:
        h1, l1, c1 = h2, l2, c2
    h_c, l_c, c_c, _ = compact_runs_device(h1, l1, c1)
    return h_c, l_c, c_c, oks[2]


def _u32(x) -> np.ndarray:
    """uint32 numpy view of a key plane (tensor or array)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 else x.astype(np.uint32)


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _keys_u64(hi, lo) -> np.ndarray:
    keys = _u32(lo).astype(np.uint64)
    if hi is not None:
        keys |= _u32(hi).astype(np.uint64) << np.uint64(32)
    return keys


def compact_spectrum(hi, lo, counts) -> Tuple[np.ndarray, np.ndarray]:
    """Host compaction of :func:`unique_counts` output: ``(keys uint64,
    counts int64)`` numpy arrays of the distinct valid k-mers.  ``hi=None``
    is the narrow path."""
    counts = _to_numpy(counts)
    keep = counts > 0
    keys = _u32(lo)[keep].astype(np.uint64)
    if hi is not None:
        keys |= _u32(hi)[keep].astype(np.uint64) << np.uint64(32)
    return keys, counts[keep].astype(np.int64)


def _concat_pad_parts(key_parts, pad_multiple: int):
    """Concatenate per-batch masked (hi, lo) key planes and pad them with
    the sentinel to a multiple of ``pad_multiple`` lanes.  Narrow parts
    (hi None) stay narrow; mixing narrow and wide raises."""
    narrow = key_parts[0][0] is None
    if any((h is None) != narrow for h, _ in key_parts):
        raise ValueError("cannot mix narrow and wide key parts in one flush")
    lanes = sum(l.numel() for _, l in key_parts)
    total = lanes + (-lanes) % pad_multiple
    dev = key_parts[0][1].device

    def cat(planes) -> torch.Tensor:
        out = torch.full((total,), _SENTINEL, dtype=torch.int32, device=dev)
        torch.cat([p.reshape(-1) for p in planes], out=out[:lanes])
        return out

    lo = cat([l for _, l in key_parts])
    hi = None if narrow else cat([h for h, _ in key_parts])
    return hi, lo


def finalize_sparse_device(
    key_parts, pad_multiple: int = 1 << 20
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """One flush resolved on the device with no host pull: concatenate and
    pad the key planes, then :func:`unique_counts`.  The distinct count is
    ``(counts > 0).sum()``."""
    if not key_parts:
        z = torch.zeros(0, dtype=torch.int32)
        return None, z, z.clone()
    hi, lo = _concat_pad_parts(key_parts, pad_multiple)
    return unique_counts(hi, lo)


def finalize_sparse(
    key_parts,
    pad_multiple: int = 1 << 20,
    device_compact: Optional[bool] = None,
    cascade: Optional[bool] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate per-batch masked (hi, lo) key planes, pad them with the
    sentinel, and resolve them with one device sort: ``(keys uint64,
    counts int64)`` numpy arrays, keys ascending.

    ``device_compact`` (default: on for CUDA tensors, off on the CPU,
    where the pull is a local copy) moves the run heads to the front on
    the device, so only the distinct entries cross to the host;
    ``cascade`` (same default) does that with the slot-compaction kernel
    first.  When the cascade overflows on a mostly-distinct stream (at
    least half the lanes distinct) the sorted runs are pulled whole and
    filtered on the host, since compaction would barely shrink the pull.
    """
    if not key_parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    on_cuda = _on_cuda(key_parts[0][1])
    if device_compact is None:
        device_compact = on_cuda
    if cascade is None:
        cascade = on_cuda
    hi, lo = _concat_pad_parts(key_parts, pad_multiple)
    lanes = lo.shape[0]
    hi_s, lo_s, counts = unique_counts(hi, lo)
    if not device_compact:
        FLUSH_ROUTES["host"] += 1
        return compact_spectrum(hi_s, lo_s, counts)
    compacted = None
    if cascade:
        compacted = compact_runs_cascade(hi_s, lo_s, counts, n_on_overflow=True)
    # overflow leaves lo None (hi is None on every narrow result)
    if compacted is not None and compacted[1] is None:
        if compacted[3] * 2 >= lanes:
            FLUSH_ROUTES["host_filter"] += 1
            return compact_spectrum(hi_s, lo_s, counts)
        compacted = None
    if compacted is None:
        FLUSH_ROUTES["stable_partition"] += 1
        compacted = compact_runs_device(hi_s, lo_s, counts)
    else:
        FLUSH_ROUTES["cascade"] += 1
    hi_c, lo_c, c_c, n = compacted
    n = int(n)
    keys = _keys_u64(None if hi_c is None else hi_c[:n], lo_c[:n])
    return keys, _to_numpy(c_c[:n]).astype(np.int64)


def merge_sorted_spectra(
    ak: np.ndarray, ac: np.ndarray, bk: np.ndarray, bc: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two key-sorted (keys uint64, counts) spectra on the host,
    summing the counts of equal keys."""
    if not len(ak):
        return bk, bc
    if not len(bk):
        return ak, ac
    keys = np.concatenate([ak, bk])
    cnts = np.concatenate([ac, bc])
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    cnts = cnts[order]
    new = np.empty(len(keys), bool)
    new[0] = True
    np.not_equal(keys[1:], keys[:-1], out=new[1:])
    out = np.add.reduceat(cnts, np.flatnonzero(new))
    return keys[new], out.astype(np.int64, copy=False)


# flush threshold of the streaming sparse count: the key planes held on the
# device between flushes take 8 bytes a lane, so 2^26 lanes ~= 0.5 GiB
SPARSE_FLUSH_LANES = 1 << 26


class SparseSpectrumAccumulator:
    """Streaming exact spectrum with bounded device memory: buffer masked
    (hi, lo) key planes on the device, resolve each flush with one device
    sort, merge the flushes on the host."""

    def __init__(self, flush_lanes: int = SPARSE_FLUSH_LANES) -> None:
        self._parts = []
        self._lanes = 0
        self._flush_lanes = flush_lanes
        self._keys = np.zeros(0, np.uint64)
        self._counts = np.zeros(0, np.int64)

    def add(self, hi: Optional[torch.Tensor], lo: torch.Tensor) -> None:
        """Buffer one batch's masked key planes (``hi=None``: narrow)."""
        self._parts.append((hi, lo))
        self._lanes += lo.numel()
        if self._lanes >= self._flush_lanes:
            self._flush()

    def _flush(self) -> None:
        if not self._parts:
            return
        keys, counts = finalize_sparse(self._parts)
        self._parts = []
        self._lanes = 0
        self._keys, self._counts = merge_sorted_spectra(
            self._keys, self._counts, keys, counts
        )

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """Merged ``(keys, counts)``; the accumulator stays usable (at EOF
        and for checkpoint snapshots)."""
        self._flush()
        return self._keys, self._counts

    def restore(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Re-seed the merged spectrum (checkpoint resume)."""
        if self._parts or self._keys.size:
            raise ValueError("restore() only applies to a fresh accumulator")
        self._keys = np.asarray(keys, dtype=np.uint64)
        self._counts = np.asarray(counts, dtype=np.int64)


def spectrum_arrays_to_dict(keys: np.ndarray, counts: np.ndarray) -> Dict[int, int]:
    """Python-dict view of a (keys, counts) spectrum (slow for large k)."""
    return {int(key): int(c) for key, c in zip(keys, counts)}


def spectrum_to_dict(hi, lo, counts, k: int) -> Dict[int, int]:
    """Host compaction of :func:`sorted_spectrum` output to
    ``{kmer_value: count}``."""
    keys, cnts = compact_spectrum(hi, lo, counts)
    return spectrum_arrays_to_dict(keys, cnts)


def merge_spectra(dicts) -> Dict[int, int]:
    """Merge per-batch spectrum dicts (host-side reduction)."""
    out: Dict[int, int] = {}
    for d in dicts:
        for kmer, c in d.items():
            out[kmer] = out.get(kmer, 0) + c
    return out
