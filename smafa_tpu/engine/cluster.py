"""cluster op: greedy online clustering, byte-identical to the reference.

Reference algorithm (reference cluster.rs:13-94): stream records in order;
skip exact duplicates of the packed encoding (cluster.rs:46-48, no output
line); compute distances to all current centroids; assign to the
lowest-index centroid at the minimum distance if min <= max_divergence,
else promote the record to a new centroid; print
``{raw_input_seq}\t{decoded_centroid}`` per unique record.

The algorithm is order-sequential — each record's assignment depends on
centroids created by earlier records — so a device can't just vmap it.
This formulation batches the stream and PIPELINES the device scan:

1. batch t's centroid scan (one packed-key min over the device-resident
   centroid tensor) is dispatched against the centroid snapshot taken
   BEFORE batch t-1 resolves, so the device scans while the host
   resolves/emits the previous batch;
2. at resolve time the few centroids promoted since that snapshot (batch
   t-1's promotions) are accounted exactly with a host-side BLAS Hamming
   block (one small [B, P] distance matrix — new centroids always have
   higher indices, so a strict ``<`` merge preserves the reference's
   lowest-index tie rule, cluster.rs:62-68);
3. intra-batch order dependencies resolve the same way: only rows that
   FAIL against all existing centroids can promote, so one host Hamming
   block against those columns plus a vectorized per-promotion sweep
   reproduces the serial semantics exactly (a promotion can capture any
   later row of the batch).

Exact-duplicate skip runs in one native C++ call per batch
(native/fastx.cpp dedup_filter; reference cluster.rs:46-48 semantics),
with a Python set fallback.

``resume_state`` makes long clustering runs restartable (the BASELINE
1M-sequence config): the checkpoint JSON records the consumed-record
count and output offset (exactly-once on seekable outputs, as for
query), centroids persist in an atomically-replaced ``.centroids.npy``
sidecar, and the dedup set — a pure function of the input prefix — is
rebuilt by re-encoding records [0, done) on restart.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque
from functools import partial
from pathlib import Path
from typing import TextIO

import jax
import jax.numpy as jnp
import numpy as np

from smafa_tpu.core import alphabet
from smafa_tpu.core.windowset import WindowSet
from smafa_tpu.engine.query import _ResumeState
from smafa_tpu.io.fastx import read_encoded_batches
from smafa_tpu.ops import distance as D
from smafa_tpu.utils.profiling import StageTimers

logger = logging.getLogger("smafa")

DEFAULT_BATCH = 2048

# Adaptive dispatch-batch ceiling (auto mode, i.e. no explicit
# batch_size): batches grow geometrically from DEFAULT_BATCH toward
# this, cutting the 1M-row config from ~490 dispatches to ~40, so
# per-dispatch latency stops bounding the run. Output is byte-identical
# at ANY batch schedule: resolution is exact per batch (tested across
# sizes). Not yet measured on the H100.
ADAPTIVE_BATCH_MAX = 32768


def _adaptive_max() -> int:
    return int(os.environ.get("SMAFA_TPU_CLUSTER_BATCH_MAX",
                              str(ADAPTIVE_BATCH_MAX)))


_bucket = D.bucket  # single bucketing policy (ops.distance)


@partial(jax.jit, static_argnames=("seq_len", "chunk", "embed"))
def _scan_min(q_codes, cent_buf, n_centroids, seq_len, chunk, embed):
    """One program per batch: (min dist, first argmin) vs centroids.
    ``embed`` is an explicit static arg — this jit cache is
    module-global, so the env-derived query form must not be baked into
    a shape-keyed entry (same reason as slab._expand_q)."""
    if embed and cent_buf.shape[1] != D.padded_feature_dim(seq_len):
        q_oh = D.expand_embed_query(q_codes, seq_len)
    else:
        q_oh = D.expand_onehot(q_codes, seq_len)
    d, i = D.min_scan(q_oh, cent_buf, n_centroids, seq_len, chunk)
    return jnp.stack([d, i])  # one device->host transfer per batch


def _build_sharded_scan(mesh, seq_len: int, chunk: int, shard_rows: int, span: int):
    """Centroid scan over a ('q','w') mesh: centroid rows sharded over 'w',
    packed keys pmin-merged — the cluster op's tensor-parallel axis
    (centroid tensor distances merged via collectives). Queries stay
    replicated."""
    from jax.sharding import PartitionSpec as P

    shift = D.packing_shift(seq_len, span)

    def shard_fn(q_oh, cent_shard, n_centroids):
        off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
        n_valid = jnp.clip(n_centroids - off, 0, shard_rows)
        lo = D.min1_scan(
            q_oh, cent_shard, n_valid, off, seq_len, shift, chunk
        )
        lo = jax.lax.pmin(lo, "w")
        big = jnp.int32(2**31 - 1)
        d = jnp.where(lo == big, jnp.int32(2**30), lo >> shift)
        i = jnp.where(lo == big, big, lo & ((1 << shift) - 1))
        return jnp.stack([d, i])  # one device->host transfer per batch

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P("w", None), P()),
        out_specs=P(None, None),
        check_vma=False,
    )

    @jax.jit
    def run(q_codes, cent_buf, n_centroids):
        q_oh = D.expand_query(q_codes, seq_len, cent_buf.shape[1])
        return mapped(q_oh, cent_buf, n_centroids)

    return run


def _host_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact Hamming distances between channel-code rows on host.

    Matches the device semantics exactly (a column matches iff the
    channel indices are equal — N-vs-N matches, N-vs-base does not).
    Native C++ byte loop where built (the 5-channel float32 matmul
    fallback is five skinny memory-bound matmuls); used for the
    cluster resolution's [batch, fails] blocks."""
    if b.shape[0] == 0:
        return np.zeros((a.shape[0], 0), np.int32)
    L = a.shape[1]
    from smafa_tpu.native import load

    lib = load()
    if lib is not None:
        import ctypes

        a_c = np.ascontiguousarray(a, dtype=np.uint8)
        b_c = np.ascontiguousarray(b, dtype=np.uint8)
        out = np.empty((a_c.shape[0], b_c.shape[0]), np.int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.cross_hamming(
            a_c.ctypes.data_as(u8p), a_c.shape[0],
            b_c.ctypes.data_as(u8p), b_c.shape[0], L,
            out.ctypes.data_as(i32p),
        )
        return out
    matches = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for c in range(alphabet.N_CHANNELS):
        matches += (a == c).astype(np.float32) @ (b == c).astype(np.float32).T
    return (L - matches).astype(np.int32)


class _CentroidStore:
    """Host WindowSet mirror + growable device buffer.

    The device buffer holds uint8 channel codes (the shipped resident
    form — seq_len bytes/row vs padded one-hot, and the scans use the
    rank-4 query embedding on it when active, like the query db), unless
    SMAFA_TPU_DB_CODES=0 forces one-hot residency."""

    def __init__(self, seq_len: int):
        from smafa_tpu.parallel import sharded
        from smafa_tpu.utils.platform import enable_compilation_cache

        enable_compilation_cache()
        self.seq_len = seq_len
        self.ws = WindowSet(version=0)  # version unused, reference cluster.rs:22
        self.decoded: list[str] = []
        # Generous initial capacity: each doubling changes the device
        # buffer shape and forces a recompile, which costs far more than
        # the few MB it saves.
        self.cap = 16384
        self.chunk = 1024
        self._codes_form = sharded._db_codes_resident()
        # Shard the centroid tensor over the 'w' mesh axis in multi-host
        # runs, or when tests force sharding; single-process runs keep
        # the simpler single-device program. The packed-key scan merges
        # with a pmin collective, like the query db scan.
        self.mesh = None
        if sharded._force_shard() or jax.process_count() > 1:
            self.mesh = sharded.build_mesh()
            if self.mesh.devices.size == 1:
                self.mesh = None
        self._scan_cache: dict[tuple, callable] = {}
        if self.mesh is not None and D.packing_shift(seq_len, self.cap * 64) is None:
            # The sharded scan needs packed 31-bit keys with growth
            # headroom; absurdly long sequences fall back to the
            # single-device path (which has a pair-carry fallback).
            self.mesh = None
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_w = self.mesh.devices.shape[1]
            # Capacity must split evenly into chunk-sized scan steps per
            # shard (stride = chunk * n_w), for any device count.
            self._stride = self.chunk * n_w
            self.cap = ((self.cap + self._stride - 1) // self._stride) * self._stride
            self._buf_sharding = NamedSharding(self.mesh, P("w", None))
            self.buf = jax.device_put(self._empty_buf(self.cap), self._buf_sharding)
        else:
            self._stride = 1
            self._buf_sharding = None
            self.buf = jnp.asarray(self._empty_buf(self.cap))

    def _empty_buf(self, cap: int) -> np.ndarray:
        if self._codes_form:
            return np.zeros((cap, self.seq_len), dtype=np.uint8)
        return np.zeros((cap, D.padded_feature_dim(self.seq_len)), dtype=np.int8)

    def __len__(self) -> int:
        return len(self.ws)

    def append(self, codes_rows: np.ndarray) -> None:
        n0 = len(self.ws)
        k = codes_rows.shape[0]
        if n0 + k > self.cap:
            while self.cap < n0 + k:
                self.cap *= 2
            self.cap = ((self.cap + self._stride - 1) // self._stride) * self._stride
            if self.mesh is not None and D.packing_shift(self.seq_len, self.cap) is None:
                # Growth outran the 31-bit key budget: drop to the
                # single-device pair-carry path (the buffer is being
                # rebuilt anyway, so resharding is free here).
                self.mesh = None
                self._buf_sharding = None
                self._stride = 1
            all_codes = np.zeros((self.cap, self.seq_len), dtype=np.uint8)
            all_codes[:n0] = self.ws.codes
            all_codes[n0 : n0 + k] = codes_rows
            if self._codes_form:
                self.buf = jax.device_put(all_codes, self._buf_sharding)
            else:
                expand = jax.jit(
                    partial(D.expand_onehot, seq_len=self.seq_len),
                    out_shardings=self._buf_sharding,
                )
                self.buf = expand(all_codes)
        else:
            # Pad the appended block to a power-of-two row bucket: the
            # number of promotions varies per batch, and an exact-shape
            # append would compile a fresh device program for every
            # distinct count (ruinous where compiles are expensive).
            # The pad rows land beyond len(ws), are masked out of every
            # scan, and are overwritten by the next append.
            kb = _bucket(k)
            if n0 + kb <= self.cap and kb > k:
                codes_pad = np.zeros((kb, codes_rows.shape[1]), np.uint8)
                codes_pad[:k] = codes_rows
                self.buf = _append_rows(self.buf, codes_pad, n0, self.seq_len)
            else:
                self.buf = _append_rows(self.buf, codes_rows, n0, self.seq_len)
        self.ws.push_batch(codes_rows)
        flat = alphabet.DECODE_BYTES[codes_rows].tobytes().decode("ascii")
        L = self.seq_len
        self.decoded.extend(flat[i * L : (i + 1) * L] for i in range(k))

    def scan_async(self, q_codes: np.ndarray):
        """Dispatch the centroid min scan; returns a handle whose arrays
        resolve asynchronously (fetch with ``scan_fetch``). The snapshot
        semantics are the dispatch-time buffer + count."""
        nq = q_codes.shape[0]
        b = _bucket(nq)
        if nq < b:
            q_codes = np.pad(q_codes, [(0, b - nq), (0, 0)])
        if self.mesh is not None:
            n_w = self.mesh.devices.shape[1]
            key = (b, self.cap)
            fn = self._scan_cache.get(key)
            if fn is None:
                fn = _build_sharded_scan(
                    self.mesh, self.seq_len, min(self.chunk, self.cap // n_w),
                    self.cap // n_w, self.cap,
                )
                self._scan_cache[key] = fn
            di = fn(q_codes, self.buf, jnp.int32(len(self.ws)))
        else:
            di = _scan_min(
                q_codes, self.buf, jnp.int32(len(self.ws)), self.seq_len,
                min(self.chunk, self.cap), D.embed_active(self.seq_len),
            )
        return (di, nq)

    def scan_fetch(self, handle):
        di, nq = handle
        a = np.asarray(di)  # stacked [2, B]: one transfer
        return a[0][:nq], a[1][:nq]


@partial(jax.jit, static_argnames=("seq_len",))
def _append_rows(cent_buf, new_codes, at, seq_len):
    if cent_buf.shape[1] != D.padded_feature_dim(seq_len):
        # codes-resident buffer: the rows land as-is
        return jax.lax.dynamic_update_slice_in_dim(
            cent_buf, new_codes, at, axis=0
        )
    new_oh = D.expand_onehot(new_codes, seq_len)
    return jax.lax.dynamic_update_slice_in_dim(cent_buf, new_oh, at, axis=0)


class _Dedup:
    """Exact-duplicate filter (reference cluster.rs:46-48): native
    unordered_set over channel-code rows, one call per batch; Python
    set-of-bytes fallback."""

    def __init__(self):
        from smafa_tpu.native import load

        self._lib = load()
        self._h = self._lib.dedup_new() if self._lib is not None else None
        self._seen: set[bytes] = set()

    def filter(self, codes: np.ndarray) -> np.ndarray:
        """Boolean keep mask: True for first-ever occurrences (inserted)."""
        n = codes.shape[0]
        if self._h is not None:
            import ctypes

            codes = np.ascontiguousarray(codes, dtype=np.uint8)
            keep = np.empty(n, np.uint8)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            self._lib.dedup_filter(
                self._h, codes.ctypes.data_as(u8p), n, codes.shape[1],
                keep.ctypes.data_as(u8p),
            )
            return keep.astype(bool)
        keep = np.empty(n, bool)
        seen = self._seen
        for j in range(n):
            key = codes[j].tobytes()
            if key in seen:
                keep[j] = False
            else:
                seen.add(key)
                keep[j] = True
        return keep

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.dedup_free(self._h)
            self._h = None


class _ClusterResume(_ResumeState):
    """Cluster-stream checkpoint: the query JSON contract plus the
    greedy state. Centroid channel codes live in an atomically-replaced
    ``<state>.centroids.npy`` sidecar (written BEFORE the JSON rename,
    so the JSON's ``n_centroids`` never points past the sidecar); the
    dedup set is NOT persisted — it is a pure function of the input
    prefix and is rebuilt by re-encoding records [0, done) on resume
    (native parse makes this seconds even at 1M records).
    """

    PATH_KEY = "input_fasta"
    PATH_NOUN = "input file"

    def __init__(self, path, stream_path, config=None):
        self.n_centroids = 0
        self.centroid_codes: np.ndarray | None = None
        self._store = None  # set by cluster() once the store exists
        super().__init__(path, stream_path, config=config)
        if self._had_checkpoint and self.n_centroids > 0:
            side = self._sidecar()
            codes = np.load(side)
            if codes.shape[0] < self.n_centroids:
                raise ValueError(
                    f"Resume state {self.path}: centroid sidecar {side} has "
                    f"{codes.shape[0]} rows, expected >= {self.n_centroids}"
                )
            self.centroid_codes = np.ascontiguousarray(
                codes[: self.n_centroids], dtype=np.uint8
            )

    def _sidecar(self) -> Path:
        return self.path.with_suffix(self.path.suffix + ".centroids.npy")

    def _load_extra(self, data: dict) -> None:
        self.n_centroids = int(data.get("n_centroids", 0))

    def _extra_payload(self) -> dict:
        return {"n_centroids": self.n_centroids}

    def sync_processes(self) -> None:
        """Multi-host: process 0's checkpoint is authoritative — its
        prefix length AND centroid tensor broadcast so every process
        rebuilds the identical greedy state (the state file need not
        exist on other hosts' filesystems)."""
        if self.path is None:
            return
        import jax

        if jax.process_count() <= 1:
            return
        from jax.experimental import multihost_utils

        shape = (self.centroid_codes.shape if self.centroid_codes is not None
                 else (0, 0))
        meta = multihost_utils.broadcast_one_to_all(
            np.array([self.done, shape[0], shape[1]], np.int64)
        )
        self.done = int(meta[0])
        n, L = int(meta[1]), int(meta[2])
        if n > 0:
            local = (self.centroid_codes
                     if jax.process_index() == 0 and self.centroid_codes is not None
                     else np.zeros((n, L), np.uint8))
            self.centroid_codes = np.asarray(
                multihost_utils.broadcast_one_to_all(local), dtype=np.uint8
            )
        self.n_centroids = n
        if jax.process_index() != 0:
            self.write_enabled = False
            self.out_pos = None

    def mark_done(self, done: int, out) -> None:
        if self.path is not None and self.write_enabled:
            store = self._store
            n = len(store) if store is not None else 0
            if n != self.n_centroids:
                codes = np.ascontiguousarray(store.ws.codes[:n], np.uint8)
                side = self._sidecar()
                tmp = side.with_suffix(side.suffix + ".tmp")
                with open(tmp, "wb") as f:
                    np.save(f, codes)
                tmp.replace(side)
                self.n_centroids = n
        super().mark_done(done, out)


def cluster(
    input_fasta: str | Path,
    max_divergence: int,
    out: TextIO | None = None,
    batch_size: int | None = None,
    resume_state: str | Path | None = None,
) -> None:
    out = out if out is not None else sys.stdout
    adaptive = batch_size is None
    batch_size = batch_size or DEFAULT_BATCH
    t0 = time.time()
    max_div = int(max_divergence)
    dedup = _Dedup()
    store: _CentroidStore | None = None

    if not Path(input_fasta).exists():
        # Reference panic text on open failure (cluster.rs:28).
        raise ValueError(f"valid path/file of input fasta: {input_fasta}")
    state = _ClusterResume(resume_state, input_fasta,
                           config={"max_divergence": max_div})
    state.sync_processes()
    state.restore_output(out)
    if state.done:
        logger.info("Resuming after %d consumed records", state.done)
        if state.centroid_codes is not None and state.centroid_codes.shape[0]:
            store = _CentroidStore(state.centroid_codes.shape[1])
            store.append(state.centroid_codes)
            state._store = store
    logger.info("Clustering ..")
    timers = StageTimers()
    query_number = state.done
    # Scans-in-flight: each dispatched batch snapshots the centroid set at
    # dispatch time, and _resolve_emit exactly folds in any centroids
    # promoted since (host Hamming over the delta columns), so several
    # batches can be in flight at once — resolution order alone defines
    # the output (byte-identical at any depth; tested). Depth > 1 hides
    # per-dispatch latency behind host work on locally attached devices;
    # on a slow link deeper pipelines only queue work, so the default
    # follows the measured link latency (round-trip probe,
    # utils.platform.dispatch_latency_ms): 2 on local links, 1 on slow
    # ones. Not yet measured on the H100; SMAFA_TPU_CLUSTER_PIPELINE
    # pins it.
    env_depth = os.environ.get("SMAFA_TPU_CLUSTER_PIPELINE", "")
    if env_depth:
        depth = max(1, int(env_depth))
    else:
        from smafa_tpu.utils.platform import dispatch_latency_ms

        depth = 1 if dispatch_latency_ms() >= 5.0 else 2
    pending: deque = deque()  # of (raws_u, codes_u, handle, snap_n, qnum_end)

    def resolve_next() -> None:
        p = pending.popleft()
        _resolve_emit(store, p, max_div, out, timers)
        # p[4] = records consumed through this batch (dup-only batches
        # parsed since the previous append are covered by it too).
        state.mark_done(p[4], out)

    batches = _resumed_batches(input_fasta, batch_size, state.done, dedup)
    if adaptive:
        batches = _grow_batches(batches, batch_size, _adaptive_max())
    while True:
        # Already-dispatched batches must be resolved/emitted before any
        # parse/encode error propagates (reference streaming behavior:
        # every record before the offending one prints).
        try:
            item = next(batches, None)
            if item is not None:
                ids, raws, codes = item
                query_number += len(ids)
                with timers.stage("dedup"):
                    keep = dedup.filter(codes)
                if keep.any():
                    codes_u = codes[keep]
                    raws_u = [raws[j] for j in np.nonzero(keep)[0]]
                    seq_len = codes_u.shape[1]
                    if store is None:
                        store = _CentroidStore(seq_len)
                        state._store = store
                    else:
                        store.ws.check_query_length(seq_len)
                    timers.count("comparisons", codes_u.shape[0] * len(store))
                    with timers.stage("dispatch"):
                        handle = store.scan_async(codes_u) if len(store) else None
                    pending.append(
                        (raws_u, codes_u, handle, len(store), query_number)
                    )
        except Exception:
            while pending:
                resolve_next()
            raise
        if item is None:
            while pending:
                resolve_next()
            # Cover trailing dup-only batches (they produce no output but
            # must not be re-consumed by a restart).
            if query_number > state.done:
                state.mark_done(query_number, out)
            break
        while len(pending) >= depth:
            resolve_next()
    timers.log_report(logging.DEBUG)

    n_centroids = len(store) if store is not None else 0
    logger.info(
        "Clustering complete, took %d seconds. Clustered %d sequences into %d clusters.",
        int(time.time() - t0), query_number, n_centroids,
    )


def _grow_batches(batches, start: int, cap: int):
    """Re-chunk encoded batches into geometrically growing dispatch
    batches (start, 2*start, ... cap, cap, ...). Greedy resolution is
    exact at any batch size, so the schedule changes only the dispatch
    count — output stays byte-identical. The doubling keeps early
    batches (where a parse error would be discovered late by a huge
    batch, and compiles are still warming) small, while the tail of a
    1M-row run dispatches at the cap.

    A parse/encode error mid-accumulation flushes the rows already
    collected first (the reference streams output before erroring), then
    re-raises after they are consumed."""
    target = start
    ids_buf: list = []
    raws_buf: list = []
    codes_buf: list = []
    have = 0
    err: BaseException | None = None
    it = iter(batches)
    while True:
        try:
            item = next(it, None)
        except Exception as e:  # flush collected rows, then re-raise
            item, err = None, e
        # NB bool(): a bare `and codes_buf` would ALIAS the list (Python
        # `and` returns its operand), turning truthy after the append.
        flush_first = bool(
            item is not None and codes_buf
            and item[2].shape[1] != codes_buf[0].shape[1]
        )
        if item is not None and not flush_first:
            ids, raws, codes = item
            ids_buf.append(ids)
            raws_buf.append(raws)
            codes_buf.append(codes)
            have += codes.shape[0]
            if have < target:
                continue
        if have:
            ids_all = [x for chunk_ in ids_buf for x in chunk_]
            raws_all = [x for chunk_ in raws_buf for x in chunk_]
            yield ids_all, raws_all, np.concatenate(codes_buf)
            ids_buf, raws_buf, codes_buf, have = [], [], [], 0
            target = min(target * 2, cap)
        if flush_first:
            # A different-width run starts its own buffer (the caller's
            # WindowSet length check must fire on the right record).
            ids, raws, codes = item
            ids_buf, raws_buf, codes_buf = [ids], [raws], [codes]
            have = codes.shape[0]
            if have >= target:
                yield ids, raws, codes
                ids_buf, raws_buf, codes_buf, have = [], [], [], 0
                target = min(target * 2, cap)
        if item is None:
            if err is not None:
                raise err
            return


def _resumed_batches(input_fasta, batch_size: int, done: int, dedup):
    """Encoded-batch stream that resumes after ``done`` records.

    The dedup set is a pure function of the input prefix, so a restart
    refilters records [0, done) — no scans, no output — then yields the
    remainder. One parse serves both phases (the native reader decodes
    the file eagerly; a separate skip_records pass would parse it twice),
    and ``done`` need not align with a batch boundary (the straddling
    batch's tail is yielded as a short first work batch).
    """
    batches = read_encoded_batches(input_fasta, batch_size=batch_size)
    rebuilt = 0
    for ids, raws, codes in batches:
        if rebuilt >= done:
            yield ids, raws, codes
            continue
        take = min(codes.shape[0], done - rebuilt)
        dedup.filter(codes[:take])
        rebuilt += take
        if take < codes.shape[0]:
            yield ids[take:], raws[take:], codes[take:]


def _resolve_emit(store, pending, max_div, out, timers):
    """Resolve one dispatched batch exactly and emit its lines.

    The device scan saw the centroid snapshot at dispatch time; centroids
    promoted since (by the previous batch's resolution) and intra-batch
    promotions are merged host-side from small exact Hamming blocks.
    """
    raws_u, codes_u, handle, snap_n, _qnum_end = pending
    nb = codes_u.shape[0]
    sentinel = max_div * 2 + 2  # reference cluster.rs:54-58
    with timers.stage("fetch"):
        if handle is not None:
            d, i = store.scan_fetch(handle)
            d = np.ascontiguousarray(d, dtype=np.int32)
            i = np.ascontiguousarray(i, dtype=np.int32)
        else:
            d = np.full(nb, sentinel, np.int32)
            i = np.zeros(nb, np.int32)
    with timers.stage("resolve"):
        n_now = len(store)
        if n_now > snap_n:
            # Promotions since the snapshot: all have indices >= snap_n
            # (> any index in the scan result), so strict < preserves the
            # lowest-index tie rule; argmin takes the first (lowest) of
            # the delta block.
            with timers.stage("resolve-delta"):
                delta = store.ws.codes[snap_n:n_now]
                cross = _host_hamming(codes_u, delta)  # int32
                parg = cross.argmin(axis=1)
                pmin = cross[np.arange(nb), parg]
                better = pmin < d
                d = np.where(better, pmin, d)
                i = np.where(better, np.int32(snap_n) + parg.astype(np.int32),
                             i)

        assigned = i
        bestd = d
        fail = np.nonzero(bestd > max_div)[0]
        promoted_rows: list[int] = []
        if fail.size:
            # Only failing rows can promote, and a promotion decision
            # depends only on distances to EARLIER promotions — so the
            # sequential sweep runs over the fail subset alone
            # (O(promotions x fails)), and every capture (of failing
            # and non-failing rows alike) resolves afterwards in one
            # vectorized argmin over the promoted columns. The sweep's
            # update-on-strict-< rule makes "first index among equal
            # minima" the winner — exactly np.argmin's tie rule — so
            # the bulk pass reproduces the reference's serial
            # lowest-index semantics (cluster.rs:62-74). The round-3
            # form updated all nb rows per promotion (O(promotions x
            # batch)); at the 1M config that sweep was 87% of the run.
            nf = fail.size
            with timers.stage("resolve-hamming"):
                # the sweep needs fail x fail only; the bulk capture pass
                # needs batch x PROMOTED columns only — computing the full
                # [nb, nf] block wasted (nf - promotions) columns of it
                sub = _host_hamming(codes_u[fail], codes_u[fail])
            bf = bestd[fail].astype(np.int32, copy=True)
            fr = np.arange(nf)
            prom_pos: list[int] = []
            for fpos in range(nf):
                if bf[fpos] <= max_div:
                    continue  # captured by an earlier promotion
                prom_pos.append(fpos)
                col = sub[:, fpos]
                upd = (fr > fpos) & (col < bf)
                bf[upd] = col[upd]
            if prom_pos:
                pp = np.asarray(prom_pos)
                P = fail[pp]
                promoted_rows = P.tolist()
                cids = (n_now + np.arange(P.size)).astype(np.int32)
                with timers.stage("resolve-hamming"):
                    cross = _host_hamming(codes_u, codes_u[P])  # [nb, |P|]
                row_idx = np.arange(nb)
                # a promotion only exists for rows AFTER it in order
                big = np.int32(2**30)
                cross = np.where(P[None, :] < row_idx[:, None], cross, big)
                k = cross.argmin(axis=1)  # first index among ties
                mn = cross[row_idx, k]
                better = mn < bestd
                better[P] = False  # promoted rows assign to themselves
                assigned = np.where(better, cids[k], assigned)
                bestd = np.where(better, mn, bestd)
                assigned[P] = cids
        if promoted_rows:
            with timers.stage("resolve-append"):
                store.append(codes_u[promoted_rows])
    with timers.stage("emit"):
        decoded = store.decoded
        out.write(
            "".join(
                f"{raws_u[j].decode('utf-8')}\t{decoded[assigned[j]]}\n"
                for j in range(nb)
            )
        )
