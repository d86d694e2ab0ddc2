"""Checkpoint / resume for the port's streaming count drivers.

A numpy-only copy of the stream-checkpoint half of
``needletail_tpu/parallel/checkpoint.py`` (that module cannot be imported
without JAX, because it pulls in the sharded drivers).  Files carry the
same ``.npz`` keys and meta, so either package resumes the other's
checkpoints.  A checkpoint is ``(record-aligned input byte offset, count
table, tallies)``; integer adds commute, so resuming from it reproduces
the uninterrupted table bit for bit.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

__all__ = [
    "counting_meta",
    "check_counting_meta",
    "load_resume_checkpoint",
    "validate_checkpoint_args",
    "checkpoint_source",
    "prepare_checkpoint_stream",
    "checkpointed_batches",
    "save_stream_checkpoint",
    "load_stream_checkpoint",
]


def counting_meta(
    canonical: bool = True,
    normalized: bool = True,
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
) -> dict:
    """Counting semantics recorded in a checkpoint, so that a resume under
    other flags is refused instead of blending two modes in one table."""
    return {
        "canonical": np.int32(bool(canonical)),
        "normalized": np.int32(bool(normalized)),
        "quality_cutoff": np.int32(
            -1 if quality_cutoff is None else int(quality_cutoff)
        ),
        "phred_offset": np.int32(int(phred_offset)),
    }


def check_counting_meta(
    ck: dict,
    resume_from: Union[str, Path],
    canonical: bool = True,
    normalized: bool = True,
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
) -> None:
    """Refuse to resume ``ck`` under different counting semantics.  Keys
    absent from the checkpoint pass unchecked."""
    want = counting_meta(
        canonical=canonical,
        normalized=normalized,
        quality_cutoff=quality_cutoff,
        phred_offset=phred_offset,
    )
    meta = ck.get("meta", {})
    for name, val in want.items():
        if name in meta and int(meta[name]) != int(val):
            raise ValueError(
                f"checkpoint {str(resume_from)!r} was written with "
                f"{name}={int(meta[name])} but this run uses {int(val)}; "
                "resume with the original counting flags"
            )


def load_resume_checkpoint(
    resume_from: Union[str, Path],
    kind: Union[str, Tuple[str, ...]],
    k: Optional[int] = None,
    validate=None,
    **meta_kwargs,
) -> dict:
    """Load a resume checkpoint and check its kind, k, counting semantics
    and, through ``validate(ck)``, anything driver-specific.  ``kind`` may
    be a tuple of kinds whose files interchange (flat and sharded
    multi-k)."""
    kinds = (kind,) if isinstance(kind, str) else tuple(kind)
    ck = load_stream_checkpoint(resume_from)
    if ck["kind"] not in kinds or (k is not None and ck["k"] != k):
        raise ValueError(
            f"checkpoint {str(resume_from)!r} is kind={ck['kind']} "
            f"k={ck['k']}, expected kind={'|'.join(kinds)}"
            + ("" if k is None else f" k={k}")
        )
    check_counting_meta(ck, resume_from, **meta_kwargs)
    if validate is not None:
        validate(ck)
    return ck


def validate_checkpoint_args(
    checkpoint_every, checkpoint_path, host_workers
) -> None:
    """Reject flag combinations that would silently write nothing or
    interleave offsets."""
    if checkpoint_every is not None:
        if checkpoint_path is None:
            raise ValueError("checkpoint_every needs a checkpoint_path")
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1 (batches)")
    elif checkpoint_path is not None:
        raise ValueError(
            "checkpoint_path without checkpoint_every writes no "
            "checkpoints; pass checkpoint_every=N (batches)"
        )
    if host_workers is not None and host_workers > 1:
        raise ValueError(
            "checkpoint/resume is single-stream (offsets must be "
            "monotonic); pass host_workers=1"
        )


def checkpoint_source(
    path, batch_size, max_len, with_quals, packed, normalized, start_offset,
    require_offsets: bool = False,
):
    """Single-stream, offset-reporting batch source for checkpoint/resume:
    re-frames ``[start_offset, EOF)`` of an uncompressed or BGZF file.
    With ``require_offsets`` (checkpoints are being written) a framer that
    reports no offsets is refused up front."""
    from .io.bgzf import is_bgzf
    from .io.compression import sniff_compression
    from .io.fast_batch import (
        _effective_packed_max_len,
        fast_read_batches_bgzf,
        fast_read_batches_range,
    )

    if isinstance(path, (list, tuple)):
        raise ValueError(
            "checkpoint/resume is single-file (offsets are per-file); "
            "run one checkpointed stream per input"
        )
    if str(path) == "-":
        raise ValueError("checkpoint/resume needs a seekable file, not stdin")
    with open(path, "rb") as f:
        magic = f.read(2)
    compressed = len(magic) == 2 and sniff_compression(magic)
    bgzf = compressed and is_bgzf(path)
    if compressed and not bgzf:
        raise ValueError(
            "checkpoint/resume needs a seekable input: an UNCOMPRESSED "
            "file or BGZF (blocked gzip, e.g. bgzip output — "
            "io.bgzf.write_bgzf recompresses); plain gzip/bz2/xz/zstd "
            "streams cannot seek to a decompressed offset"
        )
    if require_offsets:
        from .io import native

        if not native.available():
            raise ValueError(
                "checkpoint_every needs the native framer's record-aligned "
                "byte offsets; rebuild the C extension (and unset "
                "NEEDLETAIL_TPU_NO_NATIVE) or drop checkpoint_every"
            )
    max_len = _effective_packed_max_len(True, max_len)
    if bgzf:
        return fast_read_batches_bgzf(
            path, start_offset, batch_size=batch_size, max_len=max_len,
            with_quals=with_quals, packed=packed, normalized=normalized,
        )
    return fast_read_batches_range(
        path, start_offset, os.path.getsize(path), batch_size=batch_size,
        max_len=max_len, with_quals=with_quals, packed=packed,
        normalized=normalized,
    )


def prepare_checkpoint_stream(
    kind: Union[str, Tuple[str, ...]],
    k: Optional[int] = None,
    *,
    checkpoint_every=None,
    checkpoint_path=None,
    resume_from=None,
    host_workers=None,
    validate=None,
    **meta_kwargs,
) -> "tuple[bool, Optional[dict]]":
    """Validate the checkpoint flags and load any resume checkpoint.

    Returns ``(active, ck)``: whether checkpoint mode is on (the driver
    then frames through :func:`checkpoint_source`), and the loaded resume
    dict or None.
    """
    active = (
        checkpoint_every is not None
        or resume_from is not None
        or checkpoint_path is not None
    )
    if not active:
        return False, None
    validate_checkpoint_args(checkpoint_every, checkpoint_path, host_workers)
    ck = None
    if resume_from is not None:
        ck = load_resume_checkpoint(
            resume_from, kind, k, validate=validate, **meta_kwargs
        )
    return True, ck


def checkpointed_batches(source, checkpoint_every, save_fn, offset_of=None):
    """Yield from ``source``, calling ``save_fn(file_offset)`` after every
    ``checkpoint_every``-th item has been consumed by the driver.

    The save fires when the driver pulls the next item, so the saved state
    holds every batch at or before the saved offset.  Items whose offset
    is None skip their slot; ``checkpoint_every=None`` passes through.
    """
    if checkpoint_every is None:
        yield from source
        return
    if offset_of is None:
        offset_of = lambda b: b.file_offset  # noqa: E731
    done = 0
    for item in source:
        yield item
        done += 1
        offset = offset_of(item)
        if done % checkpoint_every == 0 and offset is not None:
            save_fn(offset)


def save_stream_checkpoint(
    path: Union[str, Path],
    kind: str,
    k: int,
    file_offset: int,
    n_bases: int,
    arrays: dict,
    input_path: Optional[str] = None,
    meta: Optional[dict] = None,
) -> None:
    """Atomically write a mid-stream counting checkpoint (temp file, then
    ``os.replace``, so a kill mid-save keeps the previous one)."""
    path = str(path)
    payload = {
        "kind": np.bytes_(kind.encode()),
        "k": np.int32(k),
        "file_offset": np.int64(file_offset),
        "n_bases": np.int64(n_bases),
        "input_path": np.bytes_(str(input_path or "").encode()),
    }
    for name, arr in arrays.items():
        payload["arr_" + name] = np.asarray(arr)
    for name, val in (meta or {}).items():
        payload["meta_" + name] = np.asarray(val)
    fd, tmp = tempfile.mkstemp(
        suffix=".npz.tmp", dir=os.path.dirname(path) or "."
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_stream_checkpoint(path: Union[str, Path]) -> dict:
    """Load a :func:`save_stream_checkpoint` file as ``{kind, k,
    file_offset, n_bases, input_path, arrays: {...}, meta: {...}}``."""
    out = {"arrays": {}, "meta": {}}
    with np.load(path, allow_pickle=False) as z:
        for name in z.files:
            if name.startswith("arr_"):
                out["arrays"][name[4:]] = z[name]
            elif name.startswith("meta_"):
                out["meta"][name[5:]] = z[name]
        out["kind"] = bytes(z["kind"]).decode()
        out["k"] = int(z["k"])
        out["file_offset"] = int(z["file_offset"])
        out["n_bases"] = int(z["n_bases"])
        out["input_path"] = bytes(z["input_path"]).decode() or None
    return out
