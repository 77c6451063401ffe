"""Streaming FASTA/FASTQ reader with transparent gzip, replacing the
reference's needletail dependency (reference lib.rs:143-144, 221;
cluster.rs:28; gz support pinned by the .fq.gz count test,
reference tests/test_cmdline.rs:194-201).

Records are yielded as ``(id, seq)`` where ``id`` is the full header after
the ``>``/``@`` marker (needletail's ``.id()`` semantics) and ``seq`` is the
raw sequence bytes. FASTA sequences may wrap over multiple lines; FASTQ
records are the standard 4-line form.

A batched interface (``read_encoded_batches``) feeds the device pipeline:
it encodes records into dense channel-index matrices off the hot path so
the device never waits on per-record Python work. When the native C++ ingest
extension is built it is used automatically for the parse+encode step.
"""

from __future__ import annotations

import gzip
import io
import os
from pathlib import Path
from typing import Iterator

import numpy as np

from smafa_tpu.core.alphabet import encode_bytes

_GZIP_MAGIC = b"\x1f\x8b"


def _ingest_chunk_bytes() -> int:
    """Bytes per native-parse window (SMAFA_TPU_INGEST_CHUNK overrides).
    The reference streams records one at a time with bounded memory
    (needletail parse_fastx_file, reference lib.rs:143-148, 221, 232);
    the native fast path restores that envelope by parsing fixed-size
    buffer windows continued across record boundaries — peak RSS and
    time-to-first-batch are O(window), not O(file)."""
    return int(os.environ.get("SMAFA_TPU_INGEST_CHUNK", str(64 << 20)))


def _fastq_cut_pos(buf: bytes) -> int | None:
    """Byte offset just past the last COMPLETE 4-line FASTQ record in
    ``buf`` (which starts at a record boundary), or None if no complete
    record fits. Groups newline-terminated lines POSITIONALLY in fours
    — the native parser takes a record's sequence/+/quality lines by
    position (blank sequence or quality lines are legal; only blanks
    BEFORE a header are skipped, fastx_scan) — so grouping stops at the
    first blank line: a blank at a 4-multiple is an inter-record
    separator (the carry strips it), anywhere else the record
    containing it ends up whole in the NEXT window (which grows to
    cover it), matching whole-file parse behavior. Robust against '@'
    at the start of quality lines (the reason a '\\n@' search cannot
    split FASTQ). CRLF-aware."""
    a = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(a == 10)[0]
    if nl.size == 0:
        return None
    starts = np.concatenate([[0], nl[:-1] + 1])
    lens = nl - starts
    nz = lens > 0
    cr = np.zeros(lens.shape, bool)
    cr[nz] = a[nl[nz] - 1] == 13
    lens = lens - cr
    blank = np.nonzero(lens == 0)[0]
    n_lines = int((blank[0] // 4) * 4) if blank.size else int(nl.size)
    m = n_lines // 4
    if m == 0:
        return None
    return int(nl[4 * m - 1]) + 1


def _iter_record_windows(stream, chunk_bytes: int) -> Iterator[bytes]:
    """Split an open (already-gunzipped) FASTX stream into byte windows
    that each start at a record boundary, so every window parses
    independently with the whole-buffer native parser. FASTA windows cut
    at the last header line (``\\n>`` — a sequence line can never start
    with '>'); FASTQ windows cut after the last complete 4-line group.
    A record larger than the window grows it until a boundary fits.
    Blank separator lines left at a cut are stripped from the carry (the
    parser requires the leading byte to be the format marker)."""
    carry = b""
    fmt = None
    while True:
        data = stream.read(chunk_bytes)
        buf = carry + data if carry else data
        if len(data) < chunk_bytes:  # EOF
            if buf:
                yield buf
            return
        if fmt is None:
            fmt = buf[:1]
        if fmt == b">":
            i = buf.rfind(b"\n>")
            cut = i + 1 if i >= 0 else None
        elif fmt == b"@":
            cut = _fastq_cut_pos(buf)
        else:
            # Bad leading byte: hand the buffer to the parser so its
            # error text (and the whole-file behavior) is preserved.
            yield buf
            return
        if not cut:
            carry = buf  # no boundary yet: grow the window
            continue
        yield buf[:cut]
        carry = buf[cut:].lstrip(b"\r\n")


class FastxError(ValueError):
    pass


def open_maybe_gzip(path: str | Path) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == _GZIP_MAGIC:
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=1 << 20)
    return io.BufferedReader(f, buffer_size=1 << 20) if not isinstance(f, io.BufferedReader) else f


def read_file_bytes(path: str | Path) -> bytes:
    """Whole file contents, transparently gunzipped."""
    with open_maybe_gzip(path) as f:
        return f.read()


def parse_native(path: str | Path, encode: bool = True):
    """Parse a whole file with the C++ ingest extension; None if unbuilt."""
    from smafa_tpu.native import ingest

    if ingest.load() is None:
        return None
    return ingest.parse_buffer(read_file_bytes(path), encode=encode, path=str(path))


def read_records(path: str | Path) -> Iterator[tuple[str, bytes]]:
    """Yield (id, seq_bytes) for each record in a FASTA/FASTQ(.gz) file."""
    from smafa_tpu.native import ingest

    if ingest.load() is not None:
        got = False
        with open_maybe_gzip(path) as stream:
            for window in _iter_record_windows(stream, _ingest_chunk_bytes()):
                parsed = ingest.parse_buffer(window, encode=False,
                                             path=str(path))
                got = got or parsed.n > 0
                for i in range(parsed.n):
                    yield parsed.record_id(i), parsed.raw_seq(i)
        if not got:
            raise FastxError(f"Empty or invalid FASTX file: {path}")
        return
    with open_maybe_gzip(path) as f:
        first = f.peek(1)[:1]
        if not first:
            raise FastxError(f"Empty or invalid FASTX file: {path}")
        if first == b">":
            yield from _read_fasta(f)
        elif first == b"@":
            yield from _read_fastq(f)
        else:
            raise FastxError(f"Not a FASTA or FASTQ file (bad leading byte): {path}")


def _read_fasta(f) -> Iterator[tuple[str, bytes]]:
    header: str | None = None
    chunks: list[bytes] = []
    for line in f:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if header is not None:
                yield header, b"".join(chunks)
            header = line[1:].decode("utf-8", "replace")
            chunks = []
        elif line:
            if header is None:
                raise FastxError("Sequence data before first FASTA header")
            chunks.append(line)
    if header is not None:
        yield header, b"".join(chunks)


def _read_fastq(f) -> Iterator[tuple[str, bytes]]:
    while True:
        h = f.readline()
        if not h:
            return
        h = h.rstrip(b"\r\n")
        if not h:
            continue
        if not h.startswith(b"@"):
            raise FastxError("Malformed FASTQ record header")
        seq = f.readline().rstrip(b"\r\n")
        plus = f.readline()
        qual = f.readline()
        if not plus.startswith(b"+") or not qual:
            raise FastxError("Malformed FASTQ record")
        yield h[1:].decode("utf-8", "replace"), seq


def read_encoded_batches(
    path: str | Path,
    batch_size: int,
    expected_length: int | None = None,
    skip_records: int = 0,
) -> Iterator[tuple[list[str], list[bytes], np.ndarray]]:
    """Yield (ids, raw_seqs, codes[B, L]) batches of encoded records.

    Length uniformity inside a batch follows from the db contract; a
    mismatching record raises through the caller's WindowSet length check
    so the error text matches the reference (lib.rs:71-78).
    ``skip_records`` resumes mid-stream (checkpointed query restart).
    """
    from smafa_tpu.native import ingest

    if ingest.load() is not None:
        yield from _chunked_native_batches(
            path, batch_size, expected_length, skip_records
        )
        return

    ids: list[str] = []
    raws: list[bytes] = []
    rows: list[np.ndarray] = []
    length = expected_length
    records = read_records(path)
    for _ in range(skip_records):
        if next(records, None) is None:
            return
    for rid, seq in records:
        try:
            chans = encode_bytes(seq, identifier=rid)
        except Exception:
            # Streaming parity: emit the accumulated records before the
            # offending one, then raise (reference lib.rs:231-238).
            if ids:
                yield ids, raws, np.vstack(rows)
            raise
        if length is None:
            length = len(seq)
        if len(seq) != length or len(ids) == batch_size:
            if ids:
                yield ids, raws, np.vstack(rows) if rows else np.empty((0, length or 0), np.uint8)
            ids, raws, rows = [], [], []
            length = len(seq) if expected_length is None else expected_length
        ids.append(rid)
        raws.append(seq)
        rows.append(chans)
    if ids:
        yield ids, raws, np.vstack(rows)


def _chunked_native_batches(path, batch_size, expected_length, skip_records):
    """Native parse+encode over fixed-size record windows: constant
    memory (the reference's streaming envelope, lib.rs:143-148, 232) at
    native speed. Records carry over between windows so batch sizes
    stay full; batches flush at length changes so the caller's
    WindowSet length check fires on the right record; a deferred
    invalid-base error raises after every preceding record's batch has
    been served (reference streaming parity, lib.rs:231-318)."""
    from smafa_tpu.native import ingest

    p_ids: list[str] = []
    p_raws: list[bytes] = []
    p_codes: list[np.ndarray] = []
    p_have = 0
    # Width of the blocks currently pending — NOT pinned to
    # expected_length: the flush decision must compare against what is
    # actually buffered, or mixed-width blocks concatenate and crash
    # (a run at the expected length arriving after a divergent run).
    pend_len: int | None = None
    seen = 0
    got_any = False

    def drain(force):
        nonlocal p_ids, p_raws, p_codes, p_have
        while p_have >= batch_size or (force and p_have):
            codes = (np.concatenate(p_codes) if len(p_codes) > 1
                     else p_codes[0])
            take = min(batch_size, p_have)
            yield p_ids[:take], p_raws[:take], codes[:take]
            p_ids = p_ids[take:]
            p_raws = p_raws[take:]
            p_codes = [codes[take:]] if p_have > take else []
            p_have -= take

    with open_maybe_gzip(path) as stream:
        for window in _iter_record_windows(stream, _ingest_chunk_bytes()):
            parsed = ingest.parse_buffer(window, encode=True, path=str(path))
            got_any = got_any or parsed.n > 0
            n_ok = parsed.n if parsed.error is None else parsed.error_record
            lengths = parsed.seq_lengths()[:n_ok]
            if n_ok:
                change = np.nonzero(lengths[1:] != lengths[:-1])[0] + 1
                bounds = np.concatenate([[0], change, [n_ok]])
                for s, e in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
                    L = int(lengths[s])
                    lo = max(s, min(e, skip_records - seen))
                    if lo >= e:
                        continue
                    if p_have and L != pend_len:
                        yield from drain(True)
                    pend_len = L
                    blk = parsed.codes[
                        parsed.seq_offs[lo]:parsed.seq_offs[e]
                    ]
                    p_codes.append(blk.reshape(e - lo, L) if L else
                                   np.empty((e - lo, 0), np.uint8))
                    p_ids.extend(parsed.record_id(i) for i in range(lo, e))
                    p_raws.extend(parsed.raw_seq(i) for i in range(lo, e))
                    p_have += e - lo
                    yield from drain(False)
            if parsed.error is not None:
                yield from drain(True)
                raise parsed.error
            seen += parsed.n
    if p_have:
        yield from drain(True)
    if not got_any:
        raise FastxError(f"Empty or invalid FASTX file: {path}")
