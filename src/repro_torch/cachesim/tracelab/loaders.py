"""Streaming loaders for on-disk request traces.

Every loader yields ``np.ndarray[int64]`` chunks of raw item ids and never
materializes the full trace — ingestion memory is ``O(chunk_size)``
regardless of file length.  Raw ids are whatever the log recorded (sparse,
gappy, 64-bit); densification is a separate streaming pass
(:class:`repro_torch.cachesim.tracelab.catalog.CatalogRemap`).

Supported formats (``TRACE_FORMATS``):

==========  ==================================================================
``csv``     comma-separated key-value trace à la the twitter cache-trace
            (``timestamp,key,...``; the key column is ``id_col``, default 1).
``tsv``     the same with tab separation.
``cdn``     whitespace-separated CDN/storage log lines ``timestamp id size``
            (any >= 2 fields; the id column is ``id_col``, default 1).
``bin32``   raw little-endian uint32 id stream, no header.
``bin64``   raw little-endian uint64 id stream, no header.
==========  ==================================================================

Malformed text lines follow ``on_bad``: ``"raise"`` (default) fails with the
file/line position, ``"skip"`` drops the line.  Ids that don't fit a
non-negative int64 always raise (an overflowed id would silently alias
another item after remapping).  Non-integer keys (hashed/anonymized traces)
are supported via ``key_mode="hash"`` — a stable 64-bit BLAKE2b digest.

Copied from ``repro.cachesim.tracelab.loaders`` (numpy only), with its errors
on malformed, truncated and overflowing input.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterator, Optional

import numpy as np

DEFAULT_CHUNK = 1 << 16

_INT64_MAX = np.iinfo(np.int64).max

#: format name -> (kind, default options) — the loader dispatch table.
#: ``size_col`` is where the object size (bytes) lives: the twitter-style
#: csv puts ``value_size`` fourth (``timestamp,key,key_size,value_size``),
#: the tsv/cdn logs put it right after the id (``timestamp id size``).
TRACE_FORMATS = {
    "csv": {"delimiter": ",", "id_col": 1, "size_col": 3},
    "tsv": {"delimiter": "\t", "id_col": 1, "size_col": 2},
    "cdn": {"delimiter": None, "id_col": 1, "size_col": 2},  # None = any ws
    "bin32": {"dtype": np.uint32},
    "bin64": {"dtype": np.uint64},
}

#: file-extension -> format (``.bin`` is deliberately absent: a bare ``.bin``
#: is ambiguous between u32/u64 and must be named explicitly)
_EXTENSIONS = {
    ".csv": "csv",
    ".tsv": "tsv",
    ".txt": "cdn",
    ".log": "cdn",
    ".trace": "cdn",
    ".u32": "bin32",
    ".bin32": "bin32",
    ".u64": "bin64",
    ".bin64": "bin64",
}


def sniff_format(path: str) -> str:
    """Infer the trace format from the file extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _EXTENSIONS:
        return _EXTENSIONS[ext]
    raise ValueError(
        f"cannot infer trace format from {path!r} (extension {ext!r}); "
        f"pass format= one of {sorted(TRACE_FORMATS)}"
    )


def _hash_key(raw: str) -> int:
    """Stable non-negative int64 digest for anonymized string keys."""
    d = hashlib.blake2b(raw.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(d, "big") >> 1  # keep it in [0, 2**63)


def _parse_id(raw: str, key_mode: str) -> int:
    if key_mode == "hash":
        return _hash_key(raw)
    v = int(raw)  # ValueError on non-integer keys -> handled as a bad line
    if v < 0:
        raise ValueError(f"negative item id {v}")
    if v > _INT64_MAX:
        raise OverflowError(f"item id {v} overflows int64")
    return v


def _iter_text(
    path: str,
    delimiter: Optional[str],
    id_col: int,
    chunk_size: int,
    on_bad: str,
    header: str,
    key_mode: str,
    size_col: Optional[int] = None,
) -> Iterator:
    if on_bad not in ("raise", "skip"):
        raise ValueError(f"on_bad must be 'raise' or 'skip', got {on_bad!r}")
    if header not in ("auto", "none", "skip"):
        raise ValueError(f"header must be 'auto'/'none'/'skip', got {header!r}")
    if key_mode == "hash" and header == "auto":
        # auto-detection works by the header failing to parse — but hash
        # mode parses *every* string, so a header row would be silently
        # ingested as a phantom first-seen item
        raise ValueError(
            "key_mode='hash' hashes any string, so a header row cannot be "
            "auto-detected; pass header='skip' (or 'none' for headerless "
            "files) explicitly"
        )
    buf: list = []
    sbuf: list = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            if lineno == 1 and header == "skip":
                continue
            parts = line.split(delimiter)
            bad = None
            need = id_col if size_col is None else max(id_col, size_col)
            if len(parts) <= need:
                bad = (
                    f"{len(parts)} field(s), id column is {id_col}"
                    if len(parts) <= id_col
                    else f"{len(parts)} field(s), size column is {size_col}"
                )
            else:
                try:
                    v = _parse_id(parts[id_col], key_mode)
                except OverflowError as e:
                    # an overflowed id is never skippable: after remapping it
                    # would silently alias another item
                    raise ValueError(f"{path}:{lineno}: {e}") from None
                except ValueError as e:
                    bad = str(e) or f"unparseable id {parts[id_col]!r}"
                if bad is None and size_col is not None:
                    try:
                        sz = float(parts[size_col])
                    except ValueError:
                        sz = float("nan")
                    if not (sz > 0.0 and np.isfinite(sz)):
                        bad = f"unparseable size {parts[size_col]!r}"
            if bad is not None:
                if lineno == 1 and header == "auto":
                    continue  # a header row is the one expected bad first line
                if on_bad == "raise":
                    raise ValueError(f"{path}:{lineno}: bad trace line ({bad})")
                continue
            buf.append(v)
            if size_col is not None:
                sbuf.append(sz)
            if len(buf) >= chunk_size:
                ids = np.asarray(buf, dtype=np.int64)
                if size_col is not None:
                    yield ids, np.asarray(sbuf, dtype=np.float64)
                    sbuf = []
                else:
                    yield ids
                buf = []
    if buf:
        ids = np.asarray(buf, dtype=np.int64)
        if size_col is not None:
            yield ids, np.asarray(sbuf, dtype=np.float64)
        else:
            yield ids


def _iter_binary(
    path: str, dtype: np.dtype, chunk_size: int
) -> Iterator[np.ndarray]:
    dtype = np.dtype(dtype)
    size = os.path.getsize(path)
    if size % dtype.itemsize:
        raise ValueError(
            f"{path}: truncated binary trace — {size} bytes is not a "
            f"multiple of the {dtype.itemsize}-byte record size"
        )
    with open(path, "rb") as f:
        while True:
            a = np.fromfile(f, dtype=dtype, count=chunk_size)
            if a.size == 0:
                break
            if dtype == np.uint64 and a.max() > np.uint64(_INT64_MAX):
                raise ValueError(
                    f"{path}: item id {int(a.max())} overflows int64"
                )
            yield a.astype(np.int64)


def open_trace(
    path: str,
    format: Optional[str] = None,
    *,
    chunk_size: int = DEFAULT_CHUNK,
    id_col: Optional[int] = None,
    on_bad: str = "raise",
    header: str = "auto",
    key_mode: str = "int",
    with_sizes: bool = False,
    size_col: Optional[int] = None,
) -> Iterator:
    """Open an on-disk trace as a chunk iterator of raw int64 ids.

    ``format`` defaults to :func:`sniff_format` on the extension.  Text
    formats take ``id_col`` (which column holds the item id), ``on_bad``
    (``"raise"``/``"skip"`` for malformed lines), ``header`` (``"auto"``
    tolerates one unparseable first line, ``"skip"`` always drops it,
    ``"none"`` treats it as data) and ``key_mode`` (``"int"`` or ``"hash"``
    for anonymized string keys).  Chunk boundaries never change the loaded
    stream: any ``chunk_size`` concatenates to the same trace.

    ``with_sizes=True`` additionally parses the per-request object size
    (bytes) from each format's size column (``size_col`` overrides; see
    ``TRACE_FORMATS``) and yields ``(ids, sizes)`` pairs — ``sizes`` is
    float64, validated positive and finite, with malformed sizes following
    ``on_bad`` like any other bad line.  The CDN/storage logs carry real
    sizes in exactly this column; dropping it silently was a bug — a
    byte-hit evaluation on a "loaded" CDN trace was actually unit-size.
    Binary formats carry ids only and reject ``with_sizes``.
    """
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    fmt = format or sniff_format(path)
    if fmt not in TRACE_FORMATS:
        raise ValueError(
            f"unknown trace format {fmt!r}; have {sorted(TRACE_FORMATS)}"
        )
    opts = TRACE_FORMATS[fmt]
    if "dtype" in opts:
        if key_mode != "int":
            raise ValueError("key_mode applies to text formats only")
        if with_sizes:
            raise ValueError(
                f"format {fmt!r} is a raw id stream with no size column; "
                "with_sizes needs a text format (csv/tsv/cdn)"
            )
        return _iter_binary(path, opts["dtype"], chunk_size)
    return _iter_text(
        path,
        opts["delimiter"],
        id_col if id_col is not None else opts["id_col"],
        chunk_size,
        on_bad,
        header,
        key_mode,
        size_col=(
            (size_col if size_col is not None else opts["size_col"])
            if with_sizes
            else None
        ),
    )


def load_trace(path: str, format: Optional[str] = None, **kw):
    """One-shot load: :func:`open_trace` chunks concatenated (small files /
    tests; streaming callers should keep the iterator).  With
    ``with_sizes=True`` returns an ``(ids, sizes)`` pair instead of ids."""
    chunks = list(open_trace(path, format, **kw))
    if kw.get("with_sizes"):
        if not chunks:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        return (
            np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]),
        )
    if not chunks:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(chunks)


def write_trace(
    path: str, ids, format: Optional[str] = None, *, sizes=None
) -> str:
    """Write ids to ``path`` in any supported format (fixtures/round-trips).

    Text formats get a synthetic ``timestamp`` column and a ``size`` column
    — per-request ``sizes`` when given (preserved bit-for-float through a
    ``with_sizes=True`` round-trip; integral values are written as
    integers), else the unit-size placeholder ``1``.  Binary formats carry
    ids only and reject ``sizes``.  ``bin32`` rejects ids that don't fit
    uint32 rather than silently wrapping.
    """
    ids = np.asarray(ids, dtype=np.int64)
    if ids.ndim != 1:
        raise ValueError("write_trace expects a 1-D id array")
    if ids.size and ids.min() < 0:
        raise ValueError("negative item ids")
    if sizes is not None:
        sizes = np.asarray(sizes, np.float64)
        if sizes.shape != ids.shape:
            raise ValueError(
                f"sizes shape {sizes.shape} != ids shape {ids.shape}"
            )
        if sizes.size and not (
            np.all(np.isfinite(sizes)) and float(sizes.min()) > 0.0
        ):
            raise ValueError("sizes must be finite and > 0")
    fmt = format or sniff_format(path)
    if fmt in ("bin32", "bin64"):
        if sizes is not None:
            raise ValueError(
                f"format {fmt!r} is a raw id stream and cannot carry sizes"
            )
        if fmt == "bin32":
            if ids.size and ids.max() > np.iinfo(np.uint32).max:
                raise ValueError("id overflows uint32; use bin64")
            ids.astype(np.uint32).tofile(path)
        else:
            ids.astype(np.uint64).tofile(path)
    elif fmt in ("csv", "tsv", "cdn"):
        sep = {"csv": ",", "tsv": "\t", "cdn": " "}[fmt]
        pad = sep + "0" if fmt == "csv" else ""  # csv size col is 4th
        with open(path, "w", encoding="utf-8") as f:
            for t, v in enumerate(ids.tolist()):
                if sizes is None:
                    s = "1"
                else:
                    sz = float(sizes[t])
                    s = str(int(sz)) if sz == int(sz) else repr(sz)
                f.write(f"{t}{sep}{v}{pad}{sep}{s}\n")
    else:
        raise ValueError(
            f"unknown trace format {fmt!r}; have {sorted(TRACE_FORMATS)}"
        )
    return path
