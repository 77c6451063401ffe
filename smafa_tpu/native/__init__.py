"""Native (C++) host-runtime components and their loader.

The reference's entire runtime is native Rust; its host-side hot paths
get native C++ equivalents here, loaded via ctypes. Build is lazy and
cached: first use compiles ``fastx.cpp`` with g++ into ``_build/`` next to
this file, under a name keyed on the source, the compiler flags and the
host (``-march=native`` code is only valid on the CPU it was built for,
so a tree copied to another machine rebuilds instead of reusing it);
failures degrade gracefully to the pure-Python implementations (same
semantics, slower).

Set ``SMAFA_TPU_NO_NATIVE=1`` to force the Python fallbacks (used by tests
to cover both paths).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path

logger = logging.getLogger("smafa")

_HERE = Path(__file__).parent
_BUILD = _HERE / "_build"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _disabled() -> bool:
    return os.environ.get("SMAFA_TPU_NO_NATIVE", "") not in ("", "0")


_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def build_key(src: bytes, flags: tuple[str, ...] = _FLAGS,
              host: str | None = None) -> str:
    """Name of the built library for this source, flag set and host."""
    if host is None:
        host = f"{platform.node()}|{platform.machine()}|{platform.processor()}"
    h = hashlib.sha256()
    for part in (src, " ".join(flags).encode(), host.encode()):
        h.update(part)
        h.update(b"\0")
    return f"libsmafa_native-{h.hexdigest()[:16]}.so"


def _compile() -> Path | None:
    src = _HERE / "fastx.cpp"
    out = _BUILD / build_key(src.read_bytes())
    if out.exists():
        return out
    _BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.debug("native build failed to run: %s", e)
        return None
    if proc.returncode != 0:
        logger.debug("native build failed:\n%s", proc.stderr)
        tmp.unlink(missing_ok=True)
        return None
    tmp.replace(out)  # atomic: concurrent builders never load a torn file
    return out


def load() -> ctypes.CDLL | None:
    """The native library, building it on first use; None if unavailable."""
    global _LIB, _TRIED
    if _disabled():
        return None
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.debug("native load failed: %s", e)
            return None
        c = ctypes
        i64p = c.POINTER(c.c_int64)
        i32p = c.POINTER(c.c_int32)
        u8p = c.POINTER(c.c_uint8)
        lib.fastx_scan.restype = c.c_int32
        lib.fastx_scan.argtypes = [u8p, c.c_int64, i64p, i64p, i64p, i32p]
        lib.fastx_fill.restype = c.c_int32
        lib.fastx_fill.argtypes = [
            u8p, c.c_int64, u8p, i64p, u8p, i64p, u8p, c.c_int32,
            i64p, i64p, i32p,
        ]
        u64p = c.POINTER(c.c_uint64)
        lib.postcard_encode_codes.restype = c.c_int64
        lib.postcard_encode_codes.argtypes = [u8p, c.c_int64, c.c_int64, u8p]
        lib.postcard_encode_windows.restype = c.c_int64
        lib.postcard_encode_windows.argtypes = [u64p, c.c_int64, c.c_int64, u8p]
        lib.postcard_decode_windows.restype = c.c_int64
        lib.postcard_decode_windows.argtypes = [
            u8p, c.c_int64, c.c_int64, c.c_int64, u64p,
        ]
        lib.unpack_words_codes.restype = c.c_int32
        lib.unpack_words_codes.argtypes = [
            u64p, c.c_int64, c.c_int64, c.c_int64, u8p, i32p,
        ]
        lib.tsv_format_bound.restype = c.c_int64
        lib.tsv_format_bound.argtypes = [c.c_int64, c.c_int64]
        lib.tsv_format.restype = c.c_int64
        lib.tsv_format.argtypes = [
            i64p, i32p, i32p, u8p, i64p, c.c_int64, c.c_int64, c.c_char_p,
        ]
        lib.tsv_format_mt.restype = c.c_int64
        lib.tsv_format_mt.argtypes = [
            i64p, i32p, i32p, u8p, i64p, c.c_int64, c.c_int64, c.c_char_p,
        ]
        lib.tsv_format_codes_mt.restype = c.c_int64
        lib.tsv_format_codes_mt.argtypes = [
            i64p, i32p, i32p, u8p, u8p, c.c_int64, c.c_int64, c.c_char_p,
        ]
        lib.dedup_new.restype = c.c_void_p
        lib.dedup_new.argtypes = []
        lib.dedup_free.restype = None
        lib.dedup_free.argtypes = [c.c_void_p]
        lib.dedup_filter.restype = c.c_int64
        lib.dedup_filter.argtypes = [c.c_void_p, u8p, c.c_int64, c.c_int64, u8p]
        lib.cross_hamming.restype = None
        lib.cross_hamming.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                      c.c_int64, i32p]
        _LIB = lib
        return _LIB
