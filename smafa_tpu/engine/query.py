"""query op: scan a query FASTX stream against a db on the device.

Semantics are pinned line-by-line to reference ``query`` (reference
lib.rs:198-325):

- K-mode is selected iff ``max_num_hits`` is given and != 1 (lib.rs:224 —
  K=1 is equivalent to best-hit mode).
- K-mode: sort (distance, subject_index) ascending; the cutoff is the Kth
  smallest distance — or the per-query MAX distance when K exceeds the
  window count (lib.rs:253-256) — and every entry with distance <= cutoff
  AND <= max-divergence prints, so ties at the cutoff can exceed K hits
  (lib.rs:261-265).
- ``--limit-per-sequence`` caps CONSECUTIVE runs of identical decoded
  subject strings in sorted order, resetting when a different string
  interleaves (lib.rs:269-289), and panics in best-hit mode (lib.rs:301-303).
- Best-hit mode prints ALL windows at the minimum distance in subject-index
  order (lib.rs:306-313).
- Output line: ``{query_number}\t{subject_idx}\t{distance}\t{decoded}``
  with query_number counting records from 0 (lib.rs:231,292,310).

Device execution: the db lives on device as uint8 codes. Best-hit
mode is two fused passes at most: phase A (dispatched ahead) is a
dual-packed-key min scan fused with an exact tie count — rows with <= 2
ties are fully resolved by it — and batches containing a row with more
ties take ONE compaction pass that enumerates every minimum-distance
window in (row, index) order (ops.distance.compact_scan). K-mode is the
same shape: phase A computes the exact [B, L+1] distance histogram in
one pass (the host reads the reference's cutoff rule off its cumulative
sum), phase B is one compaction pass at the cutoff — cutoff ties
included by construction, sort-free end to end. The chunked top-M
sort-merge (ops.distance.topm_scan) remains only as the exactness
fallback when packed 31-bit keys overflow. When more than one device is
visible the scans shard over the selected layout (row-sharded mesh,
ppermute ring, or column-sharded — parallel.sharded/ring/seqpar, chosen
by db size / window length / SMAFA_TPU_LAYOUT); dbs whose one-hot
exceeds HBM stream through the device as host-resident slabs
(parallel.slab).
"""

from __future__ import annotations

import io
import json
import logging
import sys
import time
from pathlib import Path
from typing import TextIO

import numpy as np

from smafa_tpu.core import alphabet
from smafa_tpu.io.db import load_db
from smafa_tpu.io.fastx import read_encoded_batches
from smafa_tpu.utils.profiling import StageTimers, maybe_trace

logger = logging.getLogger("smafa")

DEFAULT_BATCH = 2048


class QueryError(ValueError):
    pass


class _DbOnDevice:
    """A loaded db, one-hot expanded and resident on device(s)."""

    def __init__(self, windows):
        self.windows = windows
        self.n_windows = len(windows)
        self.seq_len = windows.length
        self._decoded: dict[int, str] = {}
        self._setup()

    def _setup(self):
        from smafa_tpu.parallel.select import make_runner

        codes = self.windows.codes
        self.runner = make_runner(codes, self.seq_len or 1)

    def decoded(self, idx: int) -> str:
        s = self._decoded.get(idx)
        if s is None:
            s = self.windows.get_as_string(idx)
            self._decoded[idx] = s
        return s


def _auto_batch(db: "_DbOnDevice") -> int:
    """Bigger query batches for bigger dbs: per-batch device compute then
    dominates dispatch latency, and the scan's throughput rises with B
    (db reads amortize over more queries). The out-of-core layout goes
    biggest — there the whole db crosses PCIe once per batch, and every
    doubling of B halves that traffic per query. The thresholds are not
    yet measured on the H100."""
    from smafa_tpu.parallel.slab import SlabStreamRunner

    if isinstance(db.runner, SlabStreamRunner):
        return 65536
    n_windows = db.n_windows
    if n_windows >= 1 << 22:
        return 65536
    if n_windows >= 1 << 20:
        return 32768
    if n_windows >= 1 << 19:
        return 16384
    if n_windows >= 1 << 16:
        return 4096
    return DEFAULT_BATCH


def query(
    db_path: str | Path,
    query_fasta: str | Path,
    max_divergence: int | None = None,
    max_num_hits: int | None = None,
    limit_per_sequence: int | None = None,
    out: TextIO | None = None,
    batch_size: int | None = None,
    resume_state: str | Path | None = None,
) -> None:
    """Scan query_fasta against db_path, emitting reference-format TSV.

    ``resume_state``: optional JSON checkpoint path. After each emitted
    batch, output is flushed and then the completed-query count plus the
    output byte offset are recorded (atomic rename); restarting with the
    same state file skips the already-done prefix — the query-stream
    checkpointing the seconds-long reference jobs never needed
    (SURVEY.md §5) but 10M-row runs do. With a seekable output (append a
    file with ``>>``, or pass a file object) resume is exactly-once: a
    torn final batch is truncated away before continuing. Non-seekable
    outputs (a pipe) get at-least-once semantics.
    """
    out = out or sys.stdout
    logger.info("Decoding db file %s", db_path)
    t0 = time.time()
    windows = load_db(db_path)
    db = _DbOnDevice(windows)
    if batch_size is None:
        batch_size = _auto_batch(db)

    # 1 is a special case, equivalent to None (reference lib.rs:224).
    k_mode = max_num_hits if (max_num_hits is not None and max_num_hits != 1) else None
    if k_mode is not None and k_mode < 1:
        raise QueryError("max-num-hits must be >= 1")
    if k_mode is None and limit_per_sequence is not None:
        # Reference panics with this exact text (lib.rs:301-303).
        raise QueryError(
            "limit_per_sequence is implemented unless max_num_hits > 1. "
            "It can be implemented by analogy, just haven't gotten around to it."
        )

    logger.info("Querying ..")
    timers = StageTimers()
    pending: tuple | None = None  # (qnum0, nq, codes, handle)
    if not Path(query_fasta).exists():
        # Reference panic text on open failure (lib.rs:221).
        raise QueryError(f"valid path/file of query fasta: {query_fasta}")
    state = _ResumeState(resume_state, query_fasta, config={
        "database": str(db_path),
        "max_divergence": max_divergence,
        # K=1 ≡ None (lib.rs:224): record the normalized mode so
        # equivalent invocations resume each other.
        "max_num_hits": k_mode,
        "limit_per_sequence": limit_per_sequence,
    })
    state.sync_processes()
    state.restore_output(out)
    query_number = state.done
    if state.done:
        logger.info("Resuming after %d completed queries", state.done)
    with maybe_trace():
        batches = None
        import jax

        import os

        if (jax.process_count() > 1
                and os.environ.get("SMAFA_TPU_QUERYSPLIT", "") != "0"):
            # Multi-host: split the query stream so each process parses
            # and encodes only ~1/P of it (per-process byte ranges, one
            # codes exchange per batch) instead of replicating the host
            # work on every process. Falls back to the replicated parse
            # for non-splittable streams (FASTQ/gz/nonuniform).
            from smafa_tpu.parallel import querysplit

            batches = querysplit.split_encoded_batches(
                query_fasta, batch_size, skip_records=state.done
            )
            if batches is not None:
                logger.info(
                    "Query stream split across %d processes (byte-range "
                    "parse + per-batch exchange)", jax.process_count(),
                )
        if batches is None:
            batches = read_encoded_batches(
                query_fasta, batch_size=batch_size, skip_records=state.done
            )
        while True:
            # Parsing, validating, or dispatching the next batch can raise
            # (invalid base, length mismatch). The already-scanned pending
            # batch must be emitted FIRST, matching the reference's
            # streaming behavior: it prints every record's hits up to the
            # offending one before panicking (lib.rs:231-318).
            try:
                with timers.stage("parse"):
                    item = next(batches, None)
                if item is not None:
                    _ids, _raws, codes = item  # ids None on split streams
                    nq_batch = codes.shape[0]
                    qlen = codes.shape[1] if codes.ndim == 2 else 0
                    windows.check_query_length(qlen)
                    if db.n_windows == 0:
                        raise QueryError("Cannot query an empty database")
                    # Dispatch batch k+1 before draining batch k: the device
                    # scans while the host parses/encodes and formats TSV.
                    with timers.stage("dispatch"):
                        handle = _dispatch_batch(db, codes, k_mode, max_divergence)
                    timers.count("comparisons", nq_batch * db.n_windows)
                    current = (query_number, nq_batch, codes, handle)
                    query_number += nq_batch
                else:
                    current = None
            except Exception:
                if pending is not None:
                    _drain_batch(
                        out, db, pending, k_mode, max_divergence,
                        limit_per_sequence, timers,
                    )
                    state.mark_done(pending[0] + pending[1], out)
                raise
            if pending is not None:
                _drain_batch(
                    out, db, pending, k_mode, max_divergence,
                    limit_per_sequence, timers,
                )
                state.mark_done(pending[0] + pending[1], out)
            pending = current
            if current is None:
                break
    timers.log_report(logging.DEBUG)
    logger.info("Querying complete, took %d seconds", int(time.time() - t0))


def _drain_batch(out, db, pending, k_mode, max_divergence, limit_per_sequence, timers):
    """Resolve one dispatched batch's device work and emit its hits."""
    qnum0, nq, p_codes, p_handle = pending
    if k_mode is None and p_handle is not None:
        # Best-hit mode: phase A (dual packed-key min, already
        # dispatched) resolves rows with a unique minimum outright; one
        # bitmask compaction pass enumerates the rest. Bulk TSV emit.
        with timers.stage("scan"):
            res = db.runner.best_hit(p_codes, max_divergence, handle=p_handle)
        if res is not None:
            dist, _counts, rows, idx = res
            with timers.stage("emit"):
                if rows.size:
                    _emit_bulk(
                        out, qnum0 + rows.astype(np.int64), idx,
                        dist[rows], db,
                    )
            return
    if k_mode is not None:
        # K-mode: cutoff + exact hit counts from the (pre-dispatched)
        # histogram phase, then one compaction pass at the cutoff —
        # exact cutoff-tie semantics, flat (distance, index)-sorted.
        with timers.stage("scan"):
            kres = db.runner.kmode_flat(
                p_codes, k_mode, max_divergence, stats_handle=p_handle
            )
        if kres is not None:
            counts, rows, idx, dv = kres
            with timers.stage("emit"):
                if limit_per_sequence is None:
                    if rows.size:
                        _emit_bulk(out, qnum0 + rows.astype(np.int64), idx, dv, db)
                else:
                    starts = np.cumsum(counts.astype(np.int64)) - counts
                    for row in range(nq):
                        s, n = int(starts[row]), int(counts[row])
                        _emit_kmode_row(
                            out, qnum0 + row, dv[s:s + n], idx[s:s + n],
                            n, db, limit_per_sequence,
                        )
            return
    with timers.stage("scan"):
        results = _scan_batch(db, p_codes, k_mode, max_divergence)
    with timers.stage("emit"):
        for row in range(nq):
            _emit_hits(
                out, qnum0 + row, results, row, db,
                k_mode, max_divergence, limit_per_sequence,
            )


class _ResumeState:
    """JSON query-stream checkpoint: {"query_fasta", "done", "out_pos"}.

    Consistency contract: output is flushed BEFORE the state is renamed
    into place (a flush failure propagates rather than silently recording
    unwritten batches as done). A crash between flush and rename leaves
    ``done`` pointing before the already-written batch; when the output
    stream is seekable, ``restore_output`` truncates it back to the
    recorded offset on resume, making restart exactly-once. Non-seekable
    outputs (a pipe/stdout) get at-least-once semantics — the surviving
    suffix of a torn batch repeats.

    Subclass hooks (cluster resume, engine/cluster.py): ``PATH_KEY`` /
    ``PATH_NOUN`` name the identity field; ``_load_extra`` /
    ``_extra_payload`` round-trip additional JSON fields.
    """

    PATH_KEY = "query_fasta"
    PATH_NOUN = "query file"

    def __init__(self, path: str | Path | None, stream_path,
                 config: dict | None = None):
        self.path = Path(path) if path else None
        self.done = 0
        self.out_pos: int | None = None
        self.write_enabled = True  # multi-host: only process 0 persists
        self._config = config or {}
        self._had_checkpoint = self.path is not None and self.path.exists()
        if self._had_checkpoint:
            data = json.loads(self.path.read_text())
            if data.get(self.PATH_KEY) != str(stream_path):
                raise QueryError(
                    f"Resume state {self.path} is for {self.PATH_NOUN} "
                    f"{data.get(self.PATH_KEY)!r}, not {str(stream_path)!r}"
                )
            # A prefix clustered/queried under one flag set and a suffix
            # under another is not a valid output for either; reject a
            # changed configuration loudly. (States written before config
            # recording — no "config" key — are accepted as-is.)
            saved = data.get("config")
            if saved is not None and saved != self._config:
                diffs = sorted(
                    k for k in set(saved) | set(self._config)
                    if saved.get(k) != self._config.get(k)
                )
                raise QueryError(
                    f"Resume state {self.path} was created with different "
                    f"options ({', '.join(diffs)}); rerun with the original "
                    "options or delete the state file"
                )
            self.done = int(data.get("done", 0))
            self.out_pos = data.get("out_pos")
            self._load_extra(data)
        self._stream_path = str(stream_path)

    def _load_extra(self, data: dict) -> None:
        pass

    def _extra_payload(self) -> dict:
        return {}

    def sync_processes(self) -> None:
        """Multi-host: every process must skip the same prefix (the scan
        programs are SPMD), so process 0's checkpoint is authoritative —
        its ``done`` is broadcast (the state file need not exist on other
        hosts' filesystems) and only process 0 persists/truncates."""
        if self.path is None:
            return
        import jax

        if jax.process_count() <= 1:
            return
        from jax.experimental import multihost_utils

        self.done = int(multihost_utils.broadcast_one_to_all(
            np.int64(self.done)
        ))
        if jax.process_index() != 0:
            self.write_enabled = False
            self.out_pos = None

    def restore_output(self, out) -> None:
        if self.path is None or not self.write_enabled:
            return
        if not self._had_checkpoint:
            # Fresh run: the stream may already hold content the tool
            # did not write (a user appending runs with '>>'), so the
            # current END of the stream — not 0 — is the baseline.
            # Persist it as a done=0 checkpoint BEFORE emitting anything:
            # a crash mid-batch-0 then resumes by truncating the torn
            # prefix back to this baseline (exactly-once) instead of
            # appending after it.
            pos = None
            try:
                pos = out.seek(0, 2)
            except (AttributeError, OSError, io.UnsupportedOperation):
                pass  # non-seekable stream: at-least-once
            self.out_pos = pos
            self._persist(0, pos)
            return
        if self.out_pos is None:
            # A checkpoint exists but no offset was recorded (the
            # original run's output was non-seekable). The surviving
            # output may have been collected into this file out-of-band;
            # truncating would destroy already-emitted queries.
            # At-least-once semantics: leave the file alone.
            return
        target = self.out_pos
        try:
            end = out.seek(0, 2)
            if end >= target:
                out.seek(target)
                out.truncate()
            # else: the output was reset (e.g. shell '>' truncation) —
            # seeking forward would punch a sparse hole; leave it alone.
        except (AttributeError, OSError, io.UnsupportedOperation):
            pass  # non-seekable stream: at-least-once

    def mark_done(self, done: int, out) -> None:
        self.done = done
        if self.path is None or not self.write_enabled:
            return
        out.flush()  # must succeed before the batch is recorded as done
        pos = None
        try:
            pos = out.tell()
        except (AttributeError, OSError, io.UnsupportedOperation):
            pass
        self._persist(done, pos)

    def _persist(self, done: int, pos: int | None) -> None:
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(json.dumps({
            self.PATH_KEY: self._stream_path, "done": done, "out_pos": pos,
            "config": self._config,
            **self._extra_payload(),
        }))
        tmp.replace(self.path)


def _dispatch_batch(db: _DbOnDevice, codes: np.ndarray, k_mode, max_divergence):
    """Start device work for a batch without waiting for it.

    Best-hit mode dispatches the one-wave program (keys + tie count +
    middle enumeration fused — hitops.bestfull_async, which falls back
    to the plain min2 pass when the link latency makes separate passes
    cheaper); K-mode dispatches its phase-1 cutoff search. Either way
    the device computes while the host parses the next batch.
    """
    if k_mode is None:
        return db.runner.bestfull_async(codes, max_divergence)
    return db.runner.kmode_stats_async(codes, k_mode, max_divergence)


def _scan_batch(db: _DbOnDevice, codes: np.ndarray, k_mode, max_divergence):
    """Run the top-M scan, widening M until no query row can overflow."""
    w = db.n_windows
    m = min(w, max(16, k_mode or 1))
    while True:
        dists, idxs, maxd = db.runner.topm(codes, m)
        m_got = dists.shape[1]  # runner may bucket m upward
        if m_got >= w:
            return dists, idxs, maxd
        overflow = _any_overflow(dists, maxd, w, m_got, k_mode, max_divergence)
        if not overflow:
            return dists, idxs, maxd
        m = min(w, m_got * 4)


def _any_overflow(dists, maxd, w, m, k_mode, max_divergence) -> bool:
    last = dists[:, m - 1]
    if k_mode is not None:
        kc = k_mode
        cutoff = np.where(kc > w, maxd, dists[:, min(kc, w) - 1])
        if max_divergence is not None:
            cutoff = np.minimum(cutoff, max_divergence)
        return bool(np.any(last <= cutoff))
    mind = dists[:, 0]
    if max_divergence is not None:
        mind_eff = np.where(mind <= max_divergence, mind, -1)
    else:
        mind_eff = mind
    return bool(np.any(last == mind_eff))


def _write_bytes(out, data: bytes) -> None:
    """Write pre-formatted ASCII bytes to a text stream, bypassing the
    text layer's decode->str->re-encode round trip when the underlying
    binary buffer is reachable (two full passes over the emitted bytes
    — visible at millions of hit lines per batch). The text layer is
    flushed first so interleaved str writes (per-row K-mode paths,
    logging) keep their order; resume's flush/tell discipline is
    unaffected (the byte-exactness suites pin it)."""
    # Exact-type gate: a wrapper/subclass that proxies .write (test
    # instrumentation, user file-likes that transform) must NOT be
    # bypassed by reaching through to an underlying buffer. The stream
    # must also encode ASCII bytes verbatim (no exotic encoding, no
    # newline translation) or bulk lines would differ from the per-row
    # str writes on the same stream. OSError propagates — a fallback
    # retry after a partial binary write would duplicate output.
    import os as _os

    if (type(out) is io.TextIOWrapper
            and (out.encoding or "").lower().replace("-", "")
            in ("utf8", "ascii", "usascii")
            and _os.linesep == "\n"):
        try:
            binary = out.buffer
        except (AttributeError, io.UnsupportedOperation):
            binary = None
        if binary is not None:
            out.flush()
            binary.write(data)
            return
    out.write(data.decode("ascii"))


def _emit_bulk(out, qnums, subj, d, db):
    L = db.seq_len

    from smafa_tpu.native.ingest import format_hits_tsv, format_hits_tsv_codes

    # Decode-fused threaded formatter: subject rows decode from the db
    # channel codes inside the C++ fill threads — no [hits, L] numpy
    # blob (that gather was 52% of the emit path at 2M hits).
    buf = format_hits_tsv_codes(qnums, subj, d, db.windows.codes, L)
    if buf is not None:
        _write_bytes(out, buf)
        return
    blob = alphabet.DECODE_BYTES[db.windows.codes[subj]]
    offs = np.arange(subj.size, dtype=np.int64) * L
    buf = format_hits_tsv(qnums, subj, d, blob.reshape(-1), offs, L)
    if buf is not None:
        _write_bytes(out, buf)
        return
    flat = blob.tobytes().decode("ascii")
    out.write(
        "".join(
            f"{q}\t{s}\t{dd}\t{flat[k * L:(k + 1) * L]}\n"
            for k, (q, s, dd) in enumerate(zip(qnums.tolist(), subj.tolist(), d.tolist()))
        )
    )


def _emit_kmode_row(out, qnum, dists, idxs, hits, db, limit_per_sequence):
    """Emit one row's pre-filtered sorted K-mode hit list.

    The device already applied the cutoff and max-divergence filters; only
    the limit-per-sequence consecutive-run quirk (reference lib.rs:269-289)
    remains.
    """
    last_seq: tuple[str, int] | None = None
    lines = []
    for col in range(hits):
        i = int(idxs[col])
        s = db.decoded(i)
        if limit_per_sequence is not None:
            if last_seq is not None and last_seq[0] == s:
                if last_seq[1] >= limit_per_sequence:
                    continue
                last_seq = (s, last_seq[1] + 1)
            else:
                last_seq = (s, 1)
        lines.append(f"{qnum}\t{i}\t{int(dists[col])}\t{s}\n")
    out.write("".join(lines))


def _emit_hits(out, qnum, results, row, db, k_mode, max_divergence, limit_per_sequence):
    dists, idxs, maxd = results
    drow = dists[row]
    irow = idxs[row]
    w = db.n_windows
    if k_mode is not None:
        cutoff = int(maxd[row]) if k_mode > w else int(drow[min(k_mode, w) - 1])
        eff = cutoff if max_divergence is None else min(cutoff, max_divergence)
        last_seq: tuple[str, int] | None = None
        lines = []
        for d, i in zip(drow.tolist(), irow.tolist()):
            if d > eff:
                break
            s = db.decoded(i)
            if limit_per_sequence is not None:
                # Consecutive-run limit with reset-on-interleave
                # (reference lib.rs:269-289).
                if last_seq is not None and last_seq[0] == s:
                    if last_seq[1] >= limit_per_sequence:
                        continue
                    last_seq = (s, last_seq[1] + 1)
                else:
                    last_seq = (s, 1)
            lines.append(f"{qnum}\t{i}\t{d}\t{s}\n")
        out.write("".join(lines))
    else:
        mind = int(drow[0])
        if max_divergence is not None and mind > max_divergence:
            return
        lines = []
        for d, i in zip(drow.tolist(), irow.tolist()):
            if d != mind:
                break
            lines.append(f"{qnum}\t{i}\t{d}\t{db.decoded(i)}\n")
        out.write("".join(lines))
