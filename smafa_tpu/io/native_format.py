"""Native sharded db format (mmap-able; this project's own).

The reference's postcard format (reference lib.rs:160-162) is a serial
varint stream — fine for small dbs, hostile to mmap and sharded loading.
The native format stores the channel-index matrix raw so it can be
``np.memmap``'d and row-sliced per host/shard with zero decode cost:

    bytes 0..8    magic  b"SMAFATPU"
    byte  8       format version (1)
    bytes 9..13   u32 little-endian JSON header length H
    bytes 13..13+H  JSON header: {"db_version", "num_windows", "length"}
    pad to 64-byte boundary
    raw uint8 codes, row-major [num_windows, length]

Multi-host loading slices rows [first, last) straight out of the mmap.
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path

import numpy as np

from smafa_tpu.core.windowset import WindowSet

MAGIC = b"SMAFATPU"
FORMAT_VERSION = 1
_ALIGN = 64


def save(ws: WindowSet, path: str | Path) -> None:
    header = json.dumps(
        {"db_version": ws.version, "num_windows": len(ws), "length": ws.length}
    ).encode()
    prefix_len = len(MAGIC) + 1 + 4 + len(header)
    pad = (-prefix_len) % _ALIGN
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(bytes([FORMAT_VERSION]))
        f.write(len(header).to_bytes(4, "little"))
        f.write(header)
        f.write(b"\x00" * pad)
        # tofile writes straight from the array buffer — tobytes() would
        # duplicate the whole payload in RAM (6 GB at 100M x 60 bp).
        np.ascontiguousarray(ws.codes, dtype=np.uint8).tofile(f)


def read_header(path: str | Path) -> dict:
    """Header dict {"db_version", "num_windows", "length"} without touching
    the row payload (multi-host processes size their shard from this)."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 1 + 4)
        if head[: len(MAGIC)] != MAGIC:
            raise ValueError(f"Not a native smafa-tpu db: {path}")
        if head[len(MAGIC)] != FORMAT_VERSION:
            raise ValueError(f"Unsupported native db format version: {head[len(MAGIC)]}")
        hlen = int.from_bytes(head[len(MAGIC) + 1 :], "little")
        return json.loads(f.read(hlen))


def is_native(path: str | Path) -> bool:
    with open(path, "rb") as f:
        return f.read(len(MAGIC)) == MAGIC


def load(path: str | Path, rows: tuple[int, int] | None = None) -> WindowSet:
    """Load (optionally a [first, last) row slice of) a native db."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 1 + 4)
        if head[: len(MAGIC)] != MAGIC:
            raise ValueError(f"Not a native smafa-tpu db: {path}")
        fmt = head[len(MAGIC)]
        if fmt != FORMAT_VERSION:
            raise ValueError(f"Unsupported native db format version: {fmt}")
        hlen = int.from_bytes(head[len(MAGIC) + 1 :], "little")
        header = json.loads(f.read(hlen))
    n = header["num_windows"]
    length = header["length"]
    if n == 0 or length is None:
        ws = WindowSet(header["db_version"])
        ws.length = length
        return ws
    offset = ((len(MAGIC) + 1 + 4 + hlen + _ALIGN - 1) // _ALIGN) * _ALIGN
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=offset, shape=(n, length))
    first, last = rows if rows is not None else (0, n)
    # Keep the memmap (no copy): pages are only read when rows are
    # actually touched, so a multi-host process that slices its shard
    # never faults in the rest of the db.
    return WindowSet.from_matrix(mm[first:last], header["db_version"])
