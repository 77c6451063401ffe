"""Database auto-detecting loader.

``query`` accepts either format: the native sharded format (magic
b"SMAFATPU") or a reference-compatible postcard v2 db. Postcard dbs have a
version varint as their first byte, so the formats are unambiguous; a
postcard db with version != 2 raises the reference's exact error text
(reference lib.rs:214-217).
"""

from __future__ import annotations

from pathlib import Path

from smafa_tpu.core.windowset import WindowSet
from smafa_tpu.io import native_format, postcard


def load_db(path: str | Path) -> WindowSet:
    if native_format.is_native(path):
        return native_format.load(path)
    return postcard.loads(Path(path).read_bytes())
