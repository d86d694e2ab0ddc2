"""Long-sequence tiling with (k-1)-base halos: the whole-genome spectrum.

Counterpart of ``needletail_tpu/device/tiling.py``.  Whole-genome FASTA
records (multi-Mbp) do not fit the short-read batch, so each record is cut
into fixed-shape tiles of ``tile_len`` bases plus a ``k - 1``-base halo:

  * tile i covers bytes ``[i*tile_len, i*tile_len + tile_len + k - 1)``;
  * its windows start at local positions ``[0, tile_len)``, exactly the
    global windows starting in ``[i*tile_len, (i+1)*tile_len)``,

so every window falls in one tile and none is dropped or counted twice at
a seam.  Records stream through the native batched framer and are cut
with strided numpy copies, no per-tile Python.  ``packed`` tiling strides
the 2-bit code planes directly (the tile and its rounded width are
multiples of 8 bases, so byte strides land exactly), a quarter of the
host-to-device bytes of ASCII tiles.

On the card, canonical sparse keys come from the key-plane kernel
(``kernels.canonical_key_planes(_packed)``); elsewhere, and for dense
tables, from :mod:`kmers`.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from numpy.lib.stride_tricks import as_strided

from ..io.fast_batch import fast_read_batches
from ..utils.profiling import metered_iter, span, spanned
from . import count as _count
from . import kmers as _kmers
from .ops import unpack_codes

__all__ = [
    "tile_sequence",
    "tiled_batches",
    "genome_spectrum",
    "make_tile_key_fn",
]


# records the framer hands over at a time (JAX's default frame_batch)
_FRAME_BATCH = 8


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _nbytes(block) -> int:
    """Bytes of a block's planes: what its upload ships."""
    return sum(p.nbytes for p in block if p is not None)


def _tile_plane(
    row: np.ndarray, used: int, t: int, stride: int, width: int
) -> np.ndarray:
    """Cut one record plane into ``t`` overlapping tiles with one strided
    view.  ``used`` = valid leading bytes of ``row``; the scratch is
    zero-padded so the last tile's tail is inert."""
    need = (t - 1) * stride + width
    buf = np.zeros(need, dtype=np.uint8)
    buf[:used] = row[:used]
    return as_strided(buf, (t, width), (stride, 1))


def tile_sequence(
    seq: bytes, k: int, tile_len: int = 8192
) -> Tuple[np.ndarray, np.ndarray]:
    """Split one sequence into halo-overlapped tiles.

    Returns ``(tiles [T, tile_len + k - 1] uint8 zero-padded, lengths
    [T])``; the windows of the tiles are those of ``seq``, each once.
    """
    n = len(seq)
    width = tile_len + k - 1
    if n < k:
        return np.zeros((0, width), dtype=np.uint8), np.zeros(0, dtype=np.int32)
    t = (n - k + 1 + tile_len - 1) // tile_len
    arr = np.frombuffer(seq, dtype=np.uint8)
    tiles = np.ascontiguousarray(_tile_plane(arr, n, t, tile_len, width))
    lengths = np.minimum(
        width, n - np.arange(t, dtype=np.int64) * tile_len
    ).astype(np.int32)
    return tiles, lengths


class _TileStream:
    """Framer-backed halo tiler: records stream through the native batched
    framer, each record's plane(s) are tiled with strided copies, and the
    tiles regroup into fixed ``[batch_tiles, ...]`` blocks (the last block
    zero-padded with empty tiles).

    ASCII mode yields ``(tiles [BT, tile_len+k-1], lengths)``.  Packed mode
    yields ``(codes [BT, W/4], vbits [BT, W/8] | None, lengths)`` with ``W
    = round8(tile_len+k-1)``; lengths cap at the true halo width, so the
    byte-rounded extra lanes never make windows.  A block's validity plane
    is allocated at its first dirty record, with the rows already filled
    all valid.  ``n_bases`` sums record bases (never halo bytes) as the
    iteration goes.
    """

    def __init__(
        self,
        path,
        k: int,
        tile_len: int = 8192,
        batch_tiles: int = 128,
        packed: bool = False,
        normalized: bool = True,
    ) -> None:
        if packed and tile_len % 8:
            raise ValueError("packed tiling needs tile_len % 8 == 0")
        self._path = path
        self._k = k
        self._tile_len = tile_len
        self._bt = batch_tiles
        self._packed = packed
        self._normalized = normalized
        self.n_bases = 0

    def __iter__(self):
        k, tile_len, bt = self._k, self._tile_len, self._bt
        true_width = tile_len + k - 1
        width = _round8(true_width) if self._packed else true_width
        out_c = np.zeros(
            (bt, width // 4 if self._packed else width), dtype=np.uint8
        )
        out_v = None
        out_l = np.zeros(bt, dtype=np.int32)
        fill = 0

        def _seal():
            nonlocal out_c, out_v, out_l, fill
            block = (
                (out_c, out_v, out_l) if self._packed else (out_c, out_l)
            )
            out_c = np.zeros_like(out_c)
            out_v = None
            out_l = np.zeros(bt, dtype=np.int32)
            fill = 0
            return block

        for batch in fast_read_batches(
            self._path,
            batch_size=_FRAME_BATCH,
            with_quals=False,
            packed=self._packed,
            normalized=self._normalized,
        ):
            self.n_bases += batch.num_bases
            dense_v = batch.dense_vbits() if self._packed else None
            for r in range(batch.num_reads):
                n = int(batch.lengths[r])
                if n < k:
                    continue
                t = (n - k + 1 + tile_len - 1) // tile_len
                if self._packed:
                    tc = _tile_plane(
                        batch.codes[r], (n + 3) // 4, t, tile_len // 4,
                        width // 4,
                    )
                    tv = (
                        None
                        if dense_v is None
                        else _tile_plane(
                            dense_v[r], (n + 7) // 8, t, tile_len // 8,
                            width // 8,
                        )
                    )
                else:
                    tc = _tile_plane(batch.seqs[r], n, t, tile_len, width)
                    tv = None
                tl = np.minimum(
                    true_width, n - np.arange(t, dtype=np.int64) * tile_len
                ).astype(np.int32)
                i = 0
                while i < t:
                    take = min(t - i, bt - fill)
                    out_c[fill : fill + take] = tc[i : i + take]
                    if tv is not None:
                        if out_v is None:
                            # rows filled before were clean: all valid
                            # (their lengths mask the tails)
                            out_v = np.full(
                                (bt, width // 8), 0xFF, dtype=np.uint8
                            )
                        out_v[fill : fill + take] = tv[i : i + take]
                    out_l[fill : fill + take] = tl[i : i + take]
                    fill += take
                    i += take
                    if fill == bt:
                        yield _seal()
        if fill:
            yield _seal()


def tiled_batches(
    path,
    k: int,
    tile_len: int = 8192,
    batch_tiles: int = 128,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream a FASTX file as fixed-shape ASCII halo-tiled blocks
    ``(tiles [batch_tiles, tile_len+k-1], lengths)``; the last block of a
    file is zero-padded with empty tiles (length 0: no window).  Records
    are the newline-stripped sequences, so wrapped FASTA tiles right."""
    yield from _TileStream(path, k, tile_len, batch_tiles)


def make_tile_key_fn(
    k: int,
    tile_len: int,
    packed: bool = True,
    canonical: bool = True,
    normalized: bool = True,
    dense: bool = False,
    device: Union[str, torch.device] = "cuda",
):
    """The per-block step of :func:`genome_spectrum`: ``(tiles, lengths,
    vbits) -> (hi | None, lo)``, flat sentinel-masked key planes over the
    tile-owned window starts ``[0, tile_len)``; ``hi`` is None for narrow
    (k <= 15) keys.

    On CUDA, canonical sparse keys come from the key-plane kernel (packed
    or ASCII); elsewhere from :mod:`kmers`.  Feed the outputs to
    ``count.SparseSpectrumAccumulator`` or ``count.finalize_sparse_device``
    as :func:`genome_spectrum` does.  Memoized on its arguments and the
    device type.
    """
    return _tile_key_fn_cached(
        k, tile_len, packed, canonical, normalized, dense,
        torch.device(device).type,
    )


@lru_cache(maxsize=None)
def _tile_key_fn_cached(
    k: int,
    tile_len: int,
    packed: bool,
    canonical: bool,
    normalized: bool,
    dense: bool,
    device_type: str,
):
    from .pipeline import _planes_keys, _window_keys

    use_kernel = canonical and not dense and device_type == "cuda"
    make_windows = _kmers.canonical_kmers if canonical else _kmers.pack_kmers

    def _keys(tiles, lengths, vbits):
        if use_kernel:
            # windows start only at [0, tile_len); the halo lanes hold
            # sentinels anyway, and dropping them shrinks the flush sort
            return _planes_keys(
                k, tiles, lengths, vbits, packed, normalized, tile_len
            )
        seqs = unpack_codes(tiles, vbits) if packed else tiles
        win = make_windows(
            seqs, lengths, k, normalized=normalized, precoded=packed
        )
        w = min(tile_len, win.lo.shape[1])
        return _window_keys(_kmers.KmerWindows(*(p[:, :w] for p in win)), k)

    return _keys


def _dense_tile_spec_fn(k: int, packed: bool, canonical: bool, normalized: bool):
    """The dense per-block step of :func:`genome_spectrum`: the int32
    ``[4^k]`` spectrum of one block (k <= 9 on CUDA: the histogram
    kernel)."""
    make_windows = _kmers.canonical_kmers if canonical else _kmers.pack_kmers

    def _dense_spec(tiles, lengths, vbits):
        seqs = unpack_codes(tiles, vbits) if packed else tiles
        win = make_windows(
            seqs, lengths, k, normalized=normalized, precoded=packed
        )
        return _count.dense_spectrum(win, k)

    return _dense_spec


@spanned("genome_spectrum")
def genome_spectrum(
    path,
    k: int,
    tile_len: int = 8192,
    batch_tiles: int = 64,
    canonical: bool = True,
    normalized: bool = True,
    dense: Optional[bool] = None,
    sparse_format: str = "dict",
    mesh=None,
    packed: Optional[bool] = None,
    device: Union[str, torch.device] = "cuda",
    meter=None,
) -> Tuple[int, Union[np.ndarray, Dict[int, int], tuple]]:
    """Exact k-mer spectrum of a (possibly multi-Mbp) FASTX file by halo
    tiling: the whole-bacterium k=31 spectrum.

    Returns ``(n_bases, spectrum)`` as JAX's ``genome_spectrum`` does: a
    dense int64 ``[4^k]`` array for k <= 12 (or ``dense=True``), else a
    ``{packed_kmer: count}`` dict, ``(keys uint64, counts int64)`` arrays
    with ``sparse_format="arrays"``, or with ``sparse_format="device"`` the
    flush's tensors ``(hi_s | None, lo_s, counts)`` on the device (sorted
    runs; counts 0 off the run heads and at sentinels; the stream must
    fit one flush of ``count.SPARSE_FLUSH_LANES`` lanes).

    ``packed`` (default on) ships 2-bit tiles, else ASCII; results are
    identical.  ``device="cuda"`` runs the hand-written kernels and raises
    when CUDA is absent; ``device="cpu"`` their plain versions.

    ``mesh`` (a ``parallel.make_mesh`` mesh on the device ``device``
    names, else ``ValueError``) shares each block's tiles out over its
    ``data`` dim: every rank streams the same blocks (``batch_tiles``
    rounded up to the dim with inert zero tiles) of ASCII tiles, extracts
    its own rows' keys (the key-plane kernel on the card) into a
    ``parallel.ShardedSpectrumAccumulator``, and every rank returns the
    whole spectrum; ``sparse_format="device"`` raises ``ValueError``.

    ``meter`` (a ``ThroughputMeter``; not with ``mesh``) records the
    stages ``tiling.block`` (reading, framing and tiling each block; the
    bytes of its planes), ``h2d`` (the block's uploads, synchronized, as
    in ``count_file``), ``dispatch``, the flush's, ``drain`` and ``wall``
    (items: the bases).
    """
    from .pipeline import _resolve_device, _uploader

    if dense is None:
        dense = k <= _count.MAX_DENSE_K
    elif dense and k > _count.MAX_DENSE_K:
        raise ValueError(
            f"dense output needs k <= {_count.MAX_DENSE_K}, got {k}; "
            "use dense=False for larger k"
        )
    if mesh is not None:
        from ..parallel.mesh import mesh_device_for

        mesh_device_for(mesh, device)
        return _genome_spectrum_sharded(
            path, k, tile_len, batch_tiles, canonical, normalized, dense,
            sparse_format, mesh,
        )
    if packed is None:
        packed = True
    dev = _resolve_device(device)
    to_device = _uploader(dev)
    keys_fn = make_tile_key_fn(
        k, tile_len, packed=packed, canonical=canonical,
        normalized=normalized, dense=dense, device=dev,
    )
    dense_fn = _dense_tile_spec_fn(k, packed, canonical, normalized)

    on_cuda = dev.type == "cuda"
    t_wall0 = time.perf_counter()
    table = None
    sparse = _count.SparseSpectrumAccumulator(meter=meter)
    device_parts = []  # sparse_format="device": the one flush's key planes
    device_lanes = 0
    stream = _TileStream(
        path, k, tile_len, batch_tiles, packed=packed, normalized=normalized
    )
    blocks = metered_iter(meter, "tiling.block", stream, nbytes_of=_nbytes)
    for block in blocks:
        if meter is not None and on_cuda:
            # the uploads' clock starts on an idle stream, as count_file's
            torch.cuda.current_stream(dev).synchronize()
        with span("h2d", meter, nbytes=_nbytes(block)):
            if packed:
                tiles, vbits, lengths = block
                vb = None if vbits is None else to_device(vbits)
            else:
                tiles, lengths = block
                vb = None
            dt, dl = to_device(tiles), to_device(lengths)
            if meter is not None and on_cuda:
                torch.cuda.current_stream(dev).synchronize()
        with span("dispatch", meter):
            if dense:
                spec = dense_fn(dt, dl, vb)
                if table is None:
                    table = torch.zeros(4**k, dtype=torch.int64, device=dev)
                table += spec
            elif sparse_format == "device":
                hi, lo = keys_fn(dt, dl, vb)
                device_parts.append((hi, lo))
                device_lanes += lo.numel()
                if device_lanes > _count.SPARSE_FLUSH_LANES:
                    raise ValueError(
                        "sparse_format='device' holds the whole stream on "
                        f"device; {device_lanes} lanes exceed the flush bound "
                        f"({_count.SPARSE_FLUSH_LANES}) — use 'arrays' instead"
                    )
            else:
                sparse.add(*keys_fn(dt, dl, vb))
    n_bases = stream.n_bases
    with span("drain", meter):
        if dense:
            result = (
                np.zeros(4**k, np.int64) if table is None
                else table.cpu().numpy()
            )
        elif sparse_format == "device":
            result = _count.finalize_sparse_device(device_parts)
        else:
            keys, counts = sparse.finish()
            result = (
                (keys, counts) if sparse_format == "arrays"
                else _count.spectrum_arrays_to_dict(keys, counts)
            )
    if meter is not None:
        meter.add("wall", time.perf_counter() - t_wall0, items=n_bases)
    return n_bases, result


def _genome_spectrum_sharded(
    path, k, tile_len, batch_tiles, canonical, normalized, dense,
    sparse_format, mesh,
):
    """:func:`genome_spectrum` over a mesh (JAX's ``mesh`` branch)."""
    from ..parallel.exact import ShardedSpectrumAccumulator, _require_data_mesh

    if sparse_format == "device":
        raise ValueError("sparse_format='device' is single-device only")
    n_data = _require_data_mesh(mesh)
    # extra rows are zero tiles, whose windows are all invalid
    batch_tiles = -(-batch_tiles // n_data) * n_data
    acc = ShardedSpectrumAccumulator(
        mesh, k, canonical=canonical, normalized=normalized,
        shard_lanes=_count.SPARSE_FLUSH_LANES,  # the flat path's flush
    )
    stream = _TileStream(path, k, tile_len, batch_tiles)
    for tiles, lengths in stream:
        acc.add(*acc.place(tiles, lengths))
    keys, counts = acc.finish()
    if dense:
        table = np.zeros(4**k, np.int64)
        table[keys.astype(np.int64)] = counts
        return stream.n_bases, table
    if sparse_format == "arrays":
        return stream.n_bases, (keys, counts)
    return stream.n_bases, _count.spectrum_arrays_to_dict(keys, counts)
