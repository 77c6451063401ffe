"""Python face of the native FASTX parser: whole-file parse + encode.

Returns numpy-backed batches with zero per-record Python work. Falls back
to None when the native library is unavailable; callers (io.fastx) then
use the pure-Python streaming parser.
"""

from __future__ import annotations

import ctypes
import numpy as np

from smafa_tpu.core.alphabet import InvalidBaseError
from smafa_tpu.native import load

_ERRORS = {
    1: "Empty or invalid FASTX file",
    2: "Not a FASTA or FASTQ file (bad leading byte)",
    3: "Malformed FASTQ record",
    4: "Sequence data before first FASTA header",
}


def format_hits_tsv(
    qnums: np.ndarray,    # int64 [n]
    subjs: np.ndarray,    # int32 [n]
    dists: np.ndarray,    # int32 [n]
    decoded: np.ndarray,  # uint8 blob
    str_off: np.ndarray,  # int64 [n] byte offsets into decoded
    seq_len: int,
) -> bytes | None:
    """Bulk-format hit lines "{q}\\t{s}\\t{d}\\t{decoded}\\n" natively.

    Returns None when the native library is unavailable (callers fall
    back to per-line Python formatting).
    """
    lib = load()
    if lib is None:
        return None
    n = qnums.shape[0]
    qnums = np.ascontiguousarray(qnums, dtype=np.int64)
    subjs = np.ascontiguousarray(subjs, dtype=np.int32)
    dists = np.ascontiguousarray(dists, dtype=np.int32)
    decoded = np.ascontiguousarray(decoded, dtype=np.uint8)
    str_off = np.ascontiguousarray(str_off, dtype=np.int64)
    cap = lib.tsv_format_bound(n, seq_len)
    buf = np.empty(cap, dtype=np.uint8)  # no zero-fill, unlike create_string_buffer
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    # tsv_format_mt threads the fill over row ranges at exact offsets
    # (falls back to one thread for small batches internally) — the
    # single-threaded loop's ~2.2M lines/s ceiling was K-mode's
    # downstream bound.
    written = lib.tsv_format_mt(
        qnums.ctypes.data_as(i64p), subjs.ctypes.data_as(i32p),
        dists.ctypes.data_as(i32p), decoded.ctypes.data_as(u8p),
        str_off.ctypes.data_as(i64p), seq_len, n,
        ctypes.cast(buf.ctypes.data, ctypes.c_char_p),
    )
    return buf[:written].tobytes()


def format_hits_tsv_codes(
    qnums: np.ndarray,     # int64 [n]
    subjs: np.ndarray,     # int32 [n]
    dists: np.ndarray,     # int32 [n]
    db_codes: np.ndarray,  # uint8 [W, L] C-contiguous (memmap-friendly)
    seq_len: int,
) -> bytes | None:
    """Decode-fused bulk TSV formatter: gathers and decodes each hit's
    subject row from the db's channel codes inside the threaded C++
    fill, so no [hits, L] decoded blob is ever materialized in numpy
    (that gather is a large share of the emit path). Returns None when the
    native library is unavailable or the codes view is not contiguous
    (callers fall back to the blob path)."""
    lib = load()
    if lib is None or getattr(lib, "tsv_format_codes_mt", None) is None:
        return None
    if not (isinstance(db_codes, np.ndarray) and db_codes.ndim == 2
            and db_codes.dtype == np.uint8
            and db_codes.flags["C_CONTIGUOUS"]
            and db_codes.shape[1] == seq_len):
        return None
    from smafa_tpu.core.alphabet import DECODE_BYTES

    n = qnums.shape[0]
    qnums = np.ascontiguousarray(qnums, dtype=np.int64)
    subjs = np.ascontiguousarray(subjs, dtype=np.int32)
    dists = np.ascontiguousarray(dists, dtype=np.int32)
    if n and (int(subjs.min()) < 0
              or int(subjs.max()) >= db_codes.shape[0]):
        # The C++ fill indexes db_codes by subj unchecked; keep the
        # clean-IndexError-at-origin safety net the numpy blob gather
        # provided for a corrupt/sentinel subject index.
        raise IndexError(
            f"subject index out of range for {db_codes.shape[0]}-row db"
        )
    lut = np.full(256, ord("N"), np.uint8)
    lut[: DECODE_BYTES.shape[0]] = DECODE_BYTES
    cap = lib.tsv_format_bound(n, seq_len)
    buf = np.empty(cap, dtype=np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    written = lib.tsv_format_codes_mt(
        qnums.ctypes.data_as(i64p), subjs.ctypes.data_as(i32p),
        dists.ctypes.data_as(i32p), db_codes.ctypes.data_as(u8p),
        lut.ctypes.data_as(u8p), seq_len, n,
        ctypes.cast(buf.ctypes.data, ctypes.c_char_p),
    )
    return buf[:written].tobytes()


class ParsedFastx:
    """All records of one file: concatenated arrays + offset indexes.

    ``error``/``error_record``: a deferred InvalidBaseError and the record
    it belongs to. The reference STREAMS records — it emits output for
    every record preceding an invalid base before panicking
    (lib.rs:231-238) — so whole-file parsing must not raise eagerly;
    batch consumers yield records [0, error_record) and then raise.
    """

    __slots__ = ("ids", "id_offs", "seqs", "seq_offs", "codes", "n",
                 "error", "error_record")

    def __init__(self, ids, id_offs, seqs, seq_offs, codes,
                 error=None, error_record=None):
        self.ids = ids
        self.id_offs = id_offs
        self.seqs = seqs
        self.seq_offs = seq_offs
        self.codes = codes
        self.n = len(id_offs) - 1
        self.error = error
        self.error_record = error_record

    def record_id(self, i: int) -> str:
        return self.ids[self.id_offs[i] : self.id_offs[i + 1]].tobytes().decode(
            "utf-8", "replace"
        )

    def raw_seq(self, i: int) -> bytes:
        return self.seqs[self.seq_offs[i] : self.seq_offs[i + 1]].tobytes()

    def seq_lengths(self) -> np.ndarray:
        return np.diff(self.seq_offs)


def parse_buffer(data: bytes, encode: bool = True, path: str = "") -> ParsedFastx | None:
    """Parse (and optionally encode) an in-memory FASTX buffer natively.

    Returns None when the native library is unavailable. Raises the
    reference-parity errors (InvalidBaseError, ValueError) on bad input.
    """
    lib = load()
    if lib is None:
        return None
    from smafa_tpu.io.fastx import FastxError

    buf = np.frombuffer(data, dtype=np.uint8)
    n = np.int64(buf.size)
    n_records = ctypes.c_int64()
    total_seq = ctypes.c_int64()
    total_id = ctypes.c_int64()
    fmt = ctypes.c_int32()

    u8p = ctypes.POINTER(ctypes.c_uint8)
    bufp = buf.ctypes.data_as(u8p)
    rc = lib.fastx_scan(
        bufp, n, ctypes.byref(n_records), ctypes.byref(total_seq),
        ctypes.byref(total_id), ctypes.byref(fmt),
    )
    if rc != 0:
        raise FastxError(f"{_ERRORS.get(rc, 'Parse error')}: {path}")

    nr = n_records.value
    ids = np.empty(total_id.value, dtype=np.uint8)
    id_offs = np.empty(nr + 1, dtype=np.int64)
    seqs = np.empty(total_seq.value, dtype=np.uint8)
    seq_offs = np.empty(nr + 1, dtype=np.int64)
    codes = np.empty(total_seq.value if encode else 0, dtype=np.uint8)
    bad_record = ctypes.c_int64()
    bad_pos = ctypes.c_int64()
    bad_byte = ctypes.c_int32()

    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.fastx_fill(
        bufp, n,
        ids.ctypes.data_as(u8p), id_offs.ctypes.data_as(i64p),
        seqs.ctypes.data_as(u8p), seq_offs.ctypes.data_as(i64p),
        codes.ctypes.data_as(u8p), ctypes.c_int32(1 if encode else 0),
        ctypes.byref(bad_record), ctypes.byref(bad_pos), ctypes.byref(bad_byte),
    )
    parsed = ParsedFastx(ids, id_offs, seqs, seq_offs, codes if encode else None)
    if rc == 5:  # FASTX_BAD_BASE — reference panic params (lib.rs:38-42)
        parsed.error = InvalidBaseError(
            bad_byte.value, parsed.record_id(bad_record.value), bad_pos.value
        )
        parsed.error_record = bad_record.value
    elif rc != 0:
        raise FastxError(f"{_ERRORS.get(rc, 'Parse error')}: {path}")
    return parsed
