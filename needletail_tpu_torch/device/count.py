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
    keys (k <= 15, ``hi`` None) sort as their unsigned 32-bit values.  The
    run lengths come from ``kernels.run_counts`` (a hand kernel on CUDA).
  * :func:`compact_runs_cascade`: two passes of the slot-compaction
    kernel shrink a flush up to 64x before the stable partition of
    :func:`compact_runs_device` runs on the remainder.
  * :class:`SparseSpectrumAccumulator`: the streaming exact spectrum.  A
    stream that outgrows one flush keeps its spectrum on the device and
    merges each later flush into it with ``kernels.merge_sorted_counts``;
    the JAX package merges every flush on the host.  The sharded exact
    drivers (``parallel.exact``, ``parallel.multik``) run one a rank, so
    this module holds the port's only flush.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span
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
    "MERGE_ROUTES",
    "reset_merge_routes",
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


# SparseSpectrumAccumulator's merges of a flush into the spectrum so far,
# by where they ran: "device" (the spectrum kept on the device, merged by
# kernels.merge_sorted_counts) or "host" (merge_sorted_spectra)
MERGE_ROUTES: Dict[str, int] = {"device": 0, "host": 0}


def reset_merge_routes() -> None:
    for route in MERGE_ROUTES:
        MERGE_ROUTES[route] = 0


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
    one sort, then ``kernels.run_counts`` (the run-count kernel on the
    card) unpacks the planes and writes each run head's distance to the
    next head (JAX takes a suffix ``cummin``).
    """
    from .kernels import run_counts

    return run_counts(torch.sort(_pack(hi, lo)).values, hi is not None)


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


def _nbytes(*planes) -> int:
    return sum(p.numel() * p.element_size() for p in planes if p is not None)


def _resolve_flush(key_parts, pad_multiple, device_compact, cascade,
                   host_filter, meter):
    """The span ``flush.resolve`` of a flush: concatenate, pad, sort, run
    count and the route's compaction, up to the host's read that settles
    the route.  Returns ``(hi, lo, counts, compacted)``: the compacted run
    heads, cut to the distinct count, or (``compacted`` False) the sorted
    runs whole for the host to filter.  ``host_filter`` allows that route
    when the cascade overflows on a mostly-distinct flush."""
    with span("flush.resolve", meter) as resolve:
        hi, lo = _concat_pad_parts(key_parts, pad_multiple)
        lanes = resolve.items = lo.shape[0]
        hi_s, lo_s, counts = unique_counts(hi, lo)
        route = None if device_compact else "host"
        compacted = None
        if device_compact and cascade:
            compacted = compact_runs_cascade(
                hi_s, lo_s, counts, n_on_overflow=True)
            # overflow leaves lo None (hi is None on every narrow result)
            if compacted[1] is None:
                if host_filter and compacted[3] * 2 >= lanes:
                    route = "host_filter"
                compacted = None
            else:
                route = "cascade"
        if route is None:
            route = "stable_partition"
            compacted = compact_runs_device(hi_s, lo_s, counts)
        FLUSH_ROUTES[route] += 1
        if compacted is None:
            return hi_s, lo_s, counts, False
        hi_c, lo_c, c_c, n = compacted
        n = int(n)
        return None if hi_c is None else hi_c[:n], lo_c[:n], c_c[:n], True


def finalize_sparse(
    key_parts,
    pad_multiple: int = 1 << 20,
    device_compact: Optional[bool] = None,
    cascade: Optional[bool] = None,
    meter=None,
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

    Two spans partition the call at the host's read that settles the
    route (``meter=`` takes their stages): ``flush.resolve`` (concatenate,
    pad, sort, run count and the route's compaction, up to the overflow
    test or the read of the distinct count; items: the lanes sorted) and
    ``flush.pull`` (the copy to the host, and the host filter where it
    runs; bytes pulled, items: the distinct keys returned).
    """
    if not key_parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    on_cuda = _on_cuda(key_parts[0][1])
    if device_compact is None:
        device_compact = on_cuda
    if cascade is None:
        cascade = on_cuda
    hi, lo, counts, compacted = _resolve_flush(
        key_parts, pad_multiple, device_compact, cascade, True, meter)
    with span("flush.pull", meter) as pull:
        pull.nbytes = _nbytes(hi, lo, counts)
        if compacted:
            keys = _keys_u64(hi, lo)
            cnts = _to_numpy(counts).astype(np.int64)
        else:  # the sorted runs whole, filtered on the host
            keys, cnts = compact_spectrum(hi, lo, counts)
        pull.items = len(keys)
    return keys, cnts


def merge_sorted_spectra(
    ak: np.ndarray, ac: np.ndarray, bk: np.ndarray, bc: np.ndarray,
    meter=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two key-sorted (keys uint64, counts) spectra on the host,
    summing the counts of equal keys; the span ``flush.merge``."""
    with span("flush.merge", meter):
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

# bytes a key of a spectrum kept on the device: an int64 packed key and an
# int64 count
_KEY_BYTES = 16


def _free_bytes(device: torch.device) -> int:
    """Bytes free on ``device`` now: ``torch.cuda.mem_get_info`` on a GPU, the
    host's available memory for CPU tensors."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):  # no such count here: take it as room
        return 1 << 62


def _packed_to_u64(keys: np.ndarray, wide: bool) -> np.ndarray:
    """uint64 keys of :func:`_pack`'s int64 keys (the sign flip undone)."""
    return (keys ^ np.int64(_SIGN) if wide else keys).view(np.uint64)


def _u64_to_packed(keys: np.ndarray, wide: bool) -> np.ndarray:
    """:func:`_pack`'s int64 keys of uint64 keys."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)
    return keys ^ np.int64(_SIGN) if wide else keys


class SparseSpectrumAccumulator:
    """Streaming exact spectrum with bounded device memory: buffer masked
    (hi, lo) key planes on the device and resolve each flush with one
    device sort.

    A stream that fits one flush (resolved by :meth:`finish`) runs
    :func:`finalize_sparse` and nothing else.  A flush that :meth:`add`
    starts keeps its spectrum on the device as packed int64 keys and
    int64 counts (only its distinct count reaches the host), and each
    later flush merges into that spectrum on the device
    (``kernels.merge_sorted_counts``); :meth:`finish` pulls it in one
    copy.  The spectrum stays there while it and the flush, twice over
    for the merge's output, fit in half of the device's free memory at
    that flush; otherwise it is pulled once and the rest of the stream
    merges on the host (:func:`merge_sorted_spectra`), as a restored
    spectrum does until the first merge on the device uploads it.
    :data:`MERGE_ROUTES` counts the merges by where they ran.

    Each flush is the span ``flush``, its children those of
    :func:`finalize_sparse` (``flush.resolve``, ``flush.pull``) and the
    merge, ``flush.merge`` (items: the distinct keys after it); ``meter``
    (the driver's) takes their stages."""

    def __init__(self, flush_lanes: int = SPARSE_FLUSH_LANES, meter=None) -> None:
        self._parts = []
        self._lanes = 0
        self._flush_lanes = flush_lanes
        self._meter = meter
        # the spectrum so far: the host arrays, unless _resident holds it
        # on the device as (keys, counts) tensors packed as _pack packs
        # them (the host arrays then hold finish()'s last pull)
        self._keys = np.zeros(0, np.uint64)
        self._counts = np.zeros(0, np.int64)
        self._resident: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._wide = True
        # set once the memory rule pulled the spectrum: the stream's later
        # flushes merge on the host
        self._host_only = False

    def add(self, hi: Optional[torch.Tensor], lo: torch.Tensor) -> None:
        """Buffer one batch's masked key planes (``hi=None``: narrow)."""
        self._parts.append((hi, lo))
        self._lanes += lo.numel()
        if self._lanes >= self._flush_lanes:
            self._flush()

    def _flush(self, pull: bool = False) -> None:
        """Resolve the buffered planes into the spectrum; ``pull`` (at
        :meth:`finish`) also brings a spectrum kept on the device to the
        host."""
        if not self._parts and not (pull and self._resident is not None):
            return
        meter = self._meter
        with span("flush", meter):
            parts, self._parts, self._lanes = self._parts, [], 0
            if parts and (self._host_only or (
                    pull and self._resident is None)):
                keys, counts = finalize_sparse(parts, meter=meter)
                self._merge_on_host(keys, counts)
            elif parts:
                self._flush_to_device(parts)
            if pull and self._resident is not None:
                self._keys, self._counts = self._pull_resident()

    def _flush_to_device(self, parts) -> None:
        """Resolve a flush on the device and merge it into the spectrum
        kept there, or pull both where the memory rule says no."""
        meter = self._meter
        wide = parts[0][0] is not None
        on_cuda = _on_cuda(parts[0][1])
        hi, lo, counts, _ = _resolve_flush(
            parts, 1 << 20, True, on_cuda, False, meter)
        keys = _pack(hi, lo)
        counts = counts.to(torch.int64)
        held = (self._keys.size if self._resident is None
                else self._resident[0].numel())
        need = 2 * _KEY_BYTES * (held + keys.numel())
        if need > _free_bytes(keys.device) // 2:
            self._host_only = True
            if self._resident is not None:
                self._keys, self._counts = self._pull_resident()
                self._resident = None
            with span("flush.pull", meter) as p:
                p.nbytes = _nbytes(keys, counts)
                p.items = keys.numel()
                flush_keys = _packed_to_u64(_to_numpy(keys), wide)
                flush_counts = _to_numpy(counts)
            self._merge_on_host(flush_keys, flush_counts)
            return
        self._wide = wide
        if self._resident is None and not self._keys.size:
            self._resident = (keys, counts)
            return
        if self._resident is None:  # a restored spectrum, uploaded now
            self._resident = (
                torch.from_numpy(_u64_to_packed(self._keys, wide)).to(keys.device),
                torch.from_numpy(self._counts).to(keys.device),
            )
            self._keys = np.zeros(0, np.uint64)
            self._counts = np.zeros(0, np.int64)
        from .kernels import merge_sorted_counts

        with span("flush.merge", meter) as merge:
            out_k, out_c, n = merge_sorted_counts(*self._resident, keys, counts)
            merge.items = n = int(n)
            self._resident = (out_k[:n], out_c[:n])
        MERGE_ROUTES["device"] += 1

    def _merge_on_host(self, keys: np.ndarray, counts: np.ndarray) -> None:
        if self._keys.size:
            MERGE_ROUTES["host"] += 1
        self._keys, self._counts = merge_sorted_spectra(
            self._keys, self._counts, keys, counts, meter=self._meter
        )

    def _pull_resident(self) -> Tuple[np.ndarray, np.ndarray]:
        """The spectrum kept on the device, as host arrays, in one copy;
        the device keeps it."""
        with span("flush.pull", self._meter) as pull:
            both = torch.stack(self._resident).cpu().numpy()
            pull.nbytes = both.nbytes
            pull.items = both.shape[1]
        return _packed_to_u64(both[0], self._wide), both[1]

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """Merged ``(keys, counts)``; the accumulator stays usable (at EOF
        and for checkpoint snapshots)."""
        self._flush(pull=True)
        return self._keys, self._counts

    def restore(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Re-seed the merged spectrum (checkpoint resume)."""
        if self._parts or self._keys.size or self._resident is not None:
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
