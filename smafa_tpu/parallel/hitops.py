"""Host-side orchestration of the two-phase hit-selection modes.

Every db layout (row-sharded ``ScanRunner``, ring-scheduled
``RingScanRunner``, column-sharded ``ColumnShardedScanRunner``) runs the
same two phases with layout-specific compiled programs:

- best-hit (reference lib.rs:296-313): phase A = the dual packed-key
  ``min2`` pass (the fastest possible program: matmul + two elementwise
  mins). Rows whose minimum is unique — lowest tied index == highest
  tied index — are fully resolved by phase A alone; the rest take ONE
  ``compact`` pass enumerating every window at the min.
- K-mode (reference lib.rs:241-295): phase A = ONE device program
  binary-searching the cutoff with fused count scans
  (SMAFA_TPU_KMODE_HIST=1 restores the histogram pass), returning the
  exact cutoff and hit counts; phase B = one compaction pass at the
  cutoff, lexsorted into (distance, index)
  order with per-hit distances recomputed on device at scale.

This mixin implements the shared host logic against the layout
primitives a runner provides via ``_build_program(kind, b, ...)``:
``"min2"``, ``"kstats"``, ``"hist"``, ``"tcount"``, ``"compact"`` —
plus the optional ``"miditer"`` (on-device middle-tie enumeration) and
``"hitdist"`` (device per-hit distance recompute) — and ``_pad`` (its
batch padding rule) and ``_key_shift``. Phase programs stack their
outputs into one device array where supported, so resolving a batch
costs one device->host transfer per program; independent programs
(miditer and the heavy-tail compaction; compaction row groups) are
dispatched before any is fetched so they overlap on device.

The compaction device buffers carry only (row, subject index) bit
positions; per-hit distances are implied (best-hit: the row min; K-mode:
recomputed on host from the channel codes for the few thousand emitted
hits) — see ``_host_distances``.
"""

from __future__ import annotations

import os

import numpy as np

from smafa_tpu.ops import distance as D

# One compaction dispatch never allocates hit buffers beyond this many
# entries; batches whose exact hit totals exceed it are split into row
# groups (each group is its own compaction pass over the full db).
COMPACT_MAX = 1 << 22

# The compaction scan carries a [rows, wp/32] uint32 hit mask; at large
# row counts x 10M-window dbs that is gigabytes (and its flat index
# space must stay inside int32 for the rank extraction). Dispatches are
# therefore row-sliced so one program's mask never exceeds this many
# uint32 words (default 2^28 = 1 GiB).
MASK_WORDS_BUDGET = int(os.environ.get("SMAFA_TPU_MASK_WORDS", str(1 << 28)))


def mask_row_cap(span_rows: int) -> int:
    """Max rows per compaction dispatch over a ``span_rows``-row scan:
    keeps the program's [rows, span/32] mask under MASK_WORDS_BUDGET
    (the extraction's saturating rank cumsum is exact at ANY hit
    density, so memory is the only constraint — see
    distance._saturating_word_cumsum). Capped at 2^15 rows (larger
    batches gain nothing per dispatch) and floored to a power of two so
    the bucketed sub-batch never exceeds it."""
    w32 = max(1, span_rows // 32)
    cap = max(16, min(MASK_WORDS_BUDGET // w32, 1 << 15))
    return 1 << (cap.bit_length() - 1)


class _SharedFetch:
    """One device array fetched to host exactly once, shared by several
    row views — phase-A programs stack their per-row outputs into a
    single [k, B] device array so resolving a batch costs ONE
    device->host transfer instead of one per output (each transfer is a
    full host round trip)."""

    def __init__(self, dev):
        self._dev = dev
        self._host = None

    def fetch(self):
        if self._host is None:
            self._host = np.asarray(self._dev)
            self._dev = None
        return self._host


class _Row:
    """numpy-coercible view of one row of a _SharedFetch."""

    def __init__(self, shared, i):
        self._s = shared
        self._i = i

    def __array__(self, dtype=None, copy=None):
        a = self._s.fetch()[self._i]
        if dtype is not None and a.dtype != dtype:
            a = a.astype(dtype)
        return np.array(a) if copy else a


class _FlatView:
    """numpy-coercible slice (optionally reshaped) of a flat-packed
    _SharedFetch buffer — the one-wave programs pack every output into
    one 1-D int32 array so a whole batch resolves in ONE transfer."""

    def __init__(self, shared, start, count, shape=None):
        self._s = shared
        self._start = start
        self._count = count
        self._shape = shape

    def __array__(self, dtype=None, copy=None):
        a = self._s.fetch()[self._start:self._start + self._count]
        if self._shape is not None:
            a = a.reshape(self._shape)
        if dtype is not None and a.dtype != dtype:
            a = a.astype(dtype)
        return np.array(a) if copy else a


class HitModesMixin:
    """Best-hit / K-mode host orchestration over layout primitives."""

    # -- runner-provided primitives ---------------------------------------
    # _pad(q_codes) -> (q_padded, nq)
    # _key_shift() -> int | None
    # _build_program(kind, b, *, shift=None, t_cap=None) -> compiled fn
    # attrs: seq_len, n_windows, wp, n_windows_dev, db_oh, _codes_host

    def _require_windows(self) -> None:
        if self.n_windows == 0:
            raise ValueError("Cannot query an empty database")

    def _program(self, kind: str, b: int, **kw):
        cache = self.__dict__.setdefault("_prog_cache", {})
        key = (kind, b, tuple(sorted(kw.items())))
        if kind in ("compact", "compactd"):
            # The compact builders capture the bit-pack lowering at build
            # time; keying on it keeps SMAFA_TPU_PACK live across flips
            # (an env read inside a cached trace would be inert).
            key = key + (D._pack_mode(),)
        if kind in ("min2", "min2c", "bestfull"):
            # same for the kernel-vs-XLA phase-A choice (and its fused
            # tie count): flipping SMAFA_TPU_PALLAS_MIN2 /
            # SMAFA_TPU_PALLAS_COUNT on a live runner must rebuild
            key = key + (os.environ.get("SMAFA_TPU_PALLAS_MIN2", ""),
                         os.environ.get("SMAFA_TPU_PALLAS_COUNT", ""))
        fn = cache.get(key)
        if fn is None:
            fn = self._build_program(kind, b, **kw)
            cache[key] = fn
        return fn

    # -- best-hit ----------------------------------------------------------

    # Tie-adaptive fused count: at high tie fractions the separate
    # tcount wave scans a nearly-full bucketed batch while the kernel's
    # fused-count epilogue costs a flat share of one pass — so the right
    # phase-A program depends on the workload's tie density, which the
    # previous batch predicts well. best_hit records an EMA of the tie
    # fraction; past this threshold (and when the kernel is eligible) the
    # next dispatch uses the fused-count variant. The cluster path never
    # updates the EMA and keeps the count-free pass.
    TIE_EMA_COUNT_THRESHOLD = 0.3

    def _fused_count_wanted(self, b: int) -> bool:
        if getattr(self, "_tie_ema", 0.0) < self.TIE_EMA_COUNT_THRESHOLD:
            return False
        if not self._pair_count_enabled():
            return False
        gate = getattr(self, "_pallas_min2_eligible", None)
        return gate is not None and gate(b)

    def min_count_async(self, q_codes: np.ndarray):
        """Dispatch best-hit phase A (the dual packed-key min2 pass);
        opaque handle for ``best_hit``, or None when key packing
        overflows 31 bits (callers fall back to exact top-M). Programs
        that fuse the tie count into the pass (the fused kernel) return
        a third output; it rides in the handle and ``best_hit`` then
        skips the separate tcount dispatch entirely."""
        self._require_windows()
        shift = self._key_shift()
        if shift is None:
            return None
        q_padded, nq = self._pad(q_codes)
        kind = ("min2c" if self._fused_count_wanted(q_padded.shape[0])
                and hasattr(self, "_build_min2c") else "min2")
        fn = self._program(kind, q_padded.shape[0], shift=shift)
        out = fn(q_padded, self.db_oh, self.n_windows_dev)
        if isinstance(out, dict):
            # stacked single-fetch form: {"keys": [2|3, B]} (lo, hi[,
            # cnt]) or {"pair": [3|4, B]} (d, il, ih[, cnt])
            kind, arr = next(iter(out.items()))
            sh = _SharedFetch(arr)
            k = arr.shape[0]
            if kind == "keys":
                lo, hi = _Row(sh, 0), _Row(sh, 1)
                cnt = _Row(sh, 2) if k == 3 else None
            else:
                d, il, ih = _Row(sh, 0), _Row(sh, 1), _Row(sh, 2)
                lo, hi = (d, il), (d, ih)
                cnt = _Row(sh, 3) if k == 4 else None
        elif len(out) == 3:
            lo, hi, cnt = out
        else:
            (lo, hi), cnt = out, None
        return ("min2", lo, hi, nq, shift, q_padded, cnt)

    # -- one-wave best-hit (fused keys + count + middle enumeration) -------

    # The one-wave program trades a fixed tax on every batch (the fused
    # count, the in-program middle passes, selection-overflow
    # re-dispatches on tie-heavy data) for 2 saved host round trips, so
    # it only pays when a round trip costs on the order of that tax.
    # Auto mode therefore requires a slow link (dispatch latency at
    # least this many ms) and the fused-kernel pass-1: the XLA
    # fused-count scan's sequential count dependency breaks XLA's
    # fusion. Not yet measured on the H100; SMAFA_TPU_ONEWAVE=1 forces
    # the program.
    ONEWAVE_LATENCY_MS = 100.0

    def _onewave_enabled(self, b: int | None = None) -> bool:
        """The one-wave program taxes EVERY batch (the fused count
        epilogue + the in-program middle passes) to remove two serial
        dispatch+fetch round trips — a win iff round trips are
        expensive. Auto mode decides from the measured link latency
        (platform.dispatch_latency_ms) and requires the fused-kernel pass-1
        (see ONEWAVE_LATENCY_MS above for the measured crossover).
        SMAFA_TPU_ONEWAVE=0/1 overrides."""
        v = os.environ.get("SMAFA_TPU_ONEWAVE", "")
        if v == "0":
            return False
        if v == "1":
            return True
        from smafa_tpu.utils.platform import dispatch_latency_ms

        if dispatch_latency_ms() < self.ONEWAVE_LATENCY_MS:
            return False
        pallas_gate = getattr(self, "_pallas_min2_eligible", None)
        return pallas_gate is not None and b is not None and pallas_gate(b)

    def _bestfull_supported(self) -> bool:
        """One-wave needs the bestfull primitive with GLOBAL packed keys
        (the on-device selection and middle cursors are global-index
        arithmetic); runners without one, and shard-local key mode,
        fall back to the 3-wave path."""
        if type(self)._build_bestfull is HitModesMixin._build_bestfull:
            return False
        shift = self._key_shift()
        return (shift is not None
                and shift == D.packing_shift(self.seq_len, max(self.wp, 2)))

    def _build_bestfull(self, b: int, shift: int,
                        s_cap: int):  # pragma: no cover
        raise KeyError("bestfull")

    # In-program middle passes per one-wave dispatch: 2 (device handles
    # rows with <= 2*2+2 = 6 ties; 7..TIE_ITER_MAX-tie rows fall back
    # to the separate miditer dispatch), which keeps the program's fixed
    # tax small. Not yet measured on the H100.
    ONEWAVE_TSTEPS = 2

    def _onewave_scap(self, b: int) -> int:
        """Static middle-enumeration row capacity per q-group: b/32 by
        default (few-tie rows beyond the cap fall back to a separate
        miditer dispatch — correct, one extra wave).
        SMAFA_TPU_ONEWAVE_SCAP overrides."""
        env = os.environ.get("SMAFA_TPU_ONEWAVE_SCAP")
        n_q = getattr(self, "n_q", 1)
        per_group = max(16, b // max(1, n_q))
        if env:
            return min(per_group, D.bucket(int(env), minimum=16))
        return min(per_group, max(64, per_group // 32))

    def bestfull_async(self, q_codes: np.ndarray,
                       max_divergence: int | None):
        """Dispatch the one-wave best-hit program (falls back to the
        3-wave ``min_count_async`` when unsupported or not worth it on
        this link). Returns a min2-compatible handle whose extra premids
        field carries the device-enumerated middles."""
        self._require_windows()
        shift = self._key_shift()
        if shift is None:
            return None
        # Decide before padding: the fallback path pads inside
        # min_count_async, and padding a 64k-row batch twice is a
        # wasted full copy on the hot path. The padded size is a pure
        # function of nq (D.pad_batch's bucketing), so compute it alone.
        n_q = getattr(self, "n_q", 1)
        mult = max(1, n_q)
        b = ((D.bucket(q_codes.shape[0], minimum=max(16, mult))
              + mult - 1) // mult) * mult
        if not (self._onewave_enabled(b) and self._bestfull_supported()):
            return self.min_count_async(q_codes)
        q_padded, nq = self._pad(q_codes)
        assert q_padded.shape[0] == b, (q_padded.shape[0], b)
        import jax.numpy as jnp
        s_cap = self._onewave_scap(b)
        t_steps = self.ONEWAVE_TSTEPS
        maxdiv = self.seq_len + 1 if max_divergence is None else max_divergence
        fn = self._program("bestfull", b, shift=shift, t_cap=s_cap)
        out = fn(q_padded, self.db_oh, self.n_windows_dev, jnp.int32(maxdiv))
        sh = _SharedFetch(out)
        lo = _FlatView(sh, 0, b)
        hi = _FlatView(sh, b, b)
        cnt = _FlatView(sh, 2 * b, b)
        premids = {
            "sel": _FlatView(sh, 3 * b, n_q * s_cap, (n_q, s_cap)),
            "mids": _FlatView(sh, 3 * b + n_q * s_cap,
                              2 * n_q * s_cap * t_steps,
                              (2, n_q, s_cap, t_steps)),
            "n_need": _FlatView(sh, 3 * b + n_q * s_cap
                                + 2 * n_q * s_cap * t_steps, n_q),
            "n_q": n_q, "s_cap": s_cap, "t_steps": t_steps,
            "b_loc": b // n_q, "b": b,
        }
        return ("min2", lo, hi, nq, shift, q_padded, cnt, premids)

    def _premids_collect(self, premids, eligible_rows, eligible_cnt):
        """Consume the one-wave program's device-enumerated middles.

        ``eligible_rows``/``eligible_cnt``: the rows the HOST decided
        need middle enumeration (2 < cnt <= TIE_ITER_MAX under the
        active max-divergence) and their tie counts — device-selected
        rows outside this set (padded query rows; stale selections) are
        ignored, and rows whose device fill count disagrees with the
        known tie count are left for the fallback paths. Returns
        (mid_rows, mid_idx, completed_row_ids)."""
        n_q, s_cap, t = premids["n_q"], premids["s_cap"], premids["t_steps"]
        b, b_loc = premids["b"], premids["b_loc"]
        sel = np.asarray(premids["sel"])
        nn = np.minimum(np.asarray(premids["n_need"]), s_cap)
        mids = np.asarray(premids["mids"])  # [2, n_q, s_cap, t]
        sel_g = (np.arange(n_q, dtype=np.int64)[:, None] * b_loc
                 + sel).reshape(-1)
        valid = (np.arange(s_cap)[None, :] < nn[:, None]).reshape(-1)
        lut = np.full(b, -1, np.int64)
        lut[eligible_rows] = eligible_cnt - 2
        exp = np.where(valid, lut[sel_g], -1)
        ml = mids[0].reshape(-1, t)
        mh = mids[1].reshape(-1, t)
        got = (ml >= 0).sum(axis=1) + (mh >= 0).sum(axis=1)
        ok = valid & (exp >= 0) & (got == exp)
        rows_t = np.broadcast_to(sel_g[:, None], ml.shape)
        vl = (ml >= 0) & ok[:, None]
        vh = (mh >= 0) & ok[:, None]
        return (
            np.concatenate([rows_t[vl], rows_t[vh]]).astype(np.int32),
            np.concatenate([ml[vl], mh[vh]]).astype(np.int32),
            sel_g[ok].astype(np.int32),
        )

    def _min2_unpack(self, handle):
        """Decode a min2 handle -> (dist, idx_lo, idx_hi, found) per row.

        Sentinels for rows with no valid window: dist = 2^30,
        idx = 2^31-1, found = False. ``idx_lo == idx_hi`` iff the
        minimum is unique (or the row is empty). Two formats: global
        packed keys (lo/hi int32 arrays), or pair tuples
        ((dist, idx_lo), (dist, idx_hi)) already merged to global
        (dist, index) on device — produced by layouts whose index space
        exceeds the 31-bit key budget (stream always; sharded beyond
        ~2^25 rows at 60 bp, where keys pack shard-locally)."""
        _, lo, hi, nq, shift, _q = handle[:6]
        if isinstance(lo, tuple):
            d = np.asarray(lo[0])[:nq]
            il = np.asarray(lo[1])[:nq]
            ih = np.asarray(hi[1])[:nq]
            return d, il, ih, d < np.int32(2**30)
        lo = np.asarray(lo)[:nq]
        hi = np.asarray(hi)[:nq]
        big = np.int32(2**31 - 1)
        dist, idx_lo = D.unpack_key(lo, shift)
        _, idx_rev = D.unpack_key(hi, shift)
        idx_hi = np.where(hi == big, big, self.wp - 1 - idx_rev).astype(np.int32)
        return dist, idx_lo.astype(np.int32), idx_hi, lo != big

    def best_hit(self, q_codes: np.ndarray, max_divergence: int | None = None,
                 handle=None):
        """Exact best-hit result, flat: (min_dist [nq], counts [nq],
        flat_rows, flat_idx) in (row, subject index) order — the
        reference emission order (lib.rs:306-313). ``counts`` is 0 for
        rows filtered by max_divergence. None on packing overflow."""
        if handle is None or not (isinstance(handle, tuple)
                                  and handle[0] == "min2"):
            handle = self.bestfull_async(q_codes, max_divergence)
        if handle is None:
            return None
        nq, q_padded = handle[3], handle[5]
        fused_cnt = handle[6] if len(handle) > 6 else None
        dist, idx_lo, idx_hi, keep = self._min2_unpack(handle)
        if max_divergence is not None:
            keep = keep & (dist <= max_divergence)
        tied = keep & (idx_lo != idx_hi)
        # tie-density EMA drives the adaptive fused-count phase A for
        # the NEXT batch (see _fused_count_wanted)
        self._tie_ema = (0.5 * getattr(self, "_tie_ema", 0.0)
                         + 0.5 * float(tied.sum()) / max(1, nq))
        if not tied.any():
            # Phase A fully resolved the batch: every kept row's minimum
            # is unique and the lo key carries its index.
            counts = keep.astype(np.int32)
            return (dist, counts, np.nonzero(keep)[0].astype(np.int32),
                    idx_lo[keep].astype(np.int32))
        if fused_cnt is not None or self._pair_count_enabled():
            # Tie-count pass first (count at <= min == count at == min):
            # rows with exactly 2 ties are COMPLETE from the dual min2
            # keys (lowest + highest tied index), so only >2-tie rows pay
            # the compaction pass — and with exact counts, exactly sized.
            # Programs that fused the count into phase A (the fused
            # kernel) already delivered it in the handle — zero extra
            # dispatches for the counts in that case.
            tied_ids = np.nonzero(tied)[0].astype(np.int32)
            if fused_cnt is not None:
                tie_cnt = np.asarray(fused_cnt)[:nq][tied_ids].astype(np.int64)
            else:
                tie_cnt = self._tie_counts(q_padded, tied_ids, dist[tied_ids])
            counts = keep.astype(np.int64)
            counts[tied_ids] = tie_cnt
            p_rows = tied_ids[tie_cnt == 2]
            multi = tie_cnt > 2
            it_rows = it_idx = m_rows = m_idx = np.empty(0, np.int32)
            pre_rows = pre_idx = np.empty(0, np.int32)
            premids = handle[7] if len(handle) > 7 else None
            if premids is not None and multi.any():
                # One-wave dispatch: the device already enumerated the
                # middles of (up to s_cap) few-tie rows in the same
                # program — zero extra dispatches for them. Rows the
                # device missed (selection overflow) or whose fill count
                # drifted continue into the fallback paths below.
                few_mask = multi & (tie_cnt <= 2 * self.ONEWAVE_TSTEPS + 2)
                if few_mask.any():
                    pre_rows, pre_idx, done_rows = self._premids_collect(
                        premids, tied_ids[few_mask], tie_cnt[few_mask]
                    )
                    if done_rows.size:
                        done = np.isin(tied_ids, done_rows)
                        p_rows = np.concatenate([p_rows, tied_ids[done]])
                        multi = multi & ~done
            mid_handle = None
            if multi.any() and self._miditer_supported():
                # few-tie rows enumerate their MIDDLE indices in one
                # on-device dual bounded-min program (lo/hi already
                # known) — no compaction mask; the heavy tail still
                # compacts (TIE_ITER_MAX).
                # Dispatch FIRST and collect after the compaction
                # dispatches so the two programs overlap on device
                # (results are independent).
                few = multi & (tie_cnt <= self.TIE_ITER_MAX)
                if few.any():
                    mid_handle = self._iter_middles_async(
                        q_padded, tied_ids[few], dist[tied_ids[few]],
                        idx_lo[tied_ids[few]], idx_hi[tied_ids[few]],
                        tie_cnt[few],
                    )
                    # these rows also emit their lo/hi key indices
                    p_rows = np.concatenate([p_rows, tied_ids[few]])
                    multi = multi & ~few
            if multi.any():
                m_rows, m_idx = self._compact_grouped_rows(
                    q_padded, tied_ids[multi], dist[tied_ids[multi]],
                    tie_cnt[multi],
                )
            if mid_handle is not None:
                it_rows, it_idx = self._iter_middles_collect(mid_handle)
            u_rows = np.nonzero(keep & ~tied)[0].astype(np.int32)
            all_rows = np.concatenate([u_rows, p_rows, p_rows, it_rows,
                                       pre_rows, m_rows])
            all_idx = np.concatenate(
                [idx_lo[u_rows], idx_lo[p_rows], idx_hi[p_rows], it_idx,
                 pre_idx, m_idx]
            )
            order = np.lexsort((all_idx, all_rows))
            return (dist, counts.astype(np.int32),
                    all_rows[order].astype(np.int32),
                    all_idx[order].astype(np.int32))
        thresh = np.full(q_padded.shape[0], -1, np.int32)
        thresh[:nq][tied] = dist[tied]
        t_rows, t_idx, row_counts = self._compact_adaptive(
            q_padded, thresh, int(tied.sum())
        )
        counts = keep.astype(np.int64)
        counts[tied] = row_counts[: nq][tied]
        u_rows = np.nonzero(keep & ~tied)[0].astype(np.int32)
        all_rows = np.concatenate([u_rows, t_rows]).astype(np.int32)
        all_idx = np.concatenate([idx_lo[u_rows], t_idx]).astype(np.int32)
        order = np.lexsort((all_idx, all_rows))
        return (dist, counts.astype(np.int32),
                all_rows[order], all_idx[order])

    def collect_ties(self, q_codes: np.ndarray, handle=None):
        """Per row: (min distance, ALL window indices at the min,
        ascending) — compatibility list-of-lists view over ``best_hit``."""
        res = self.best_hit(q_codes, None, handle=handle)
        if res is None:
            return None
        dist, counts, _rows, idx = res
        bounds = np.cumsum(counts)[:-1]
        return dist, [seg.tolist() for seg in np.split(idx, bounds)]

    # -- min2 (cluster hot path + uniqueness probe) ------------------------

    def min2_async(self, q_codes: np.ndarray):
        """Dispatch the min2 pass; handle for ``min2_result``. Same
        program as best-hit phase A (``min_count_async``) — the async
        split lets callers overlap host work with the device scan
        (SURVEY.md §2.2 PP row)."""
        return self.min_count_async(q_codes)

    def min2_result(self, handle):
        """Fetch + unpack a min2_async handle -> (min dist, first argmin,
        unique-min flag) per row. Empty rows cannot occur in practice
        (n_windows == 0 is guarded host-side); when a scan nonetheless
        covers no valid window its keys carry the sentinel DISTANCE
        seq_len+1, which any max-divergence filter rejects."""
        dist, idx_lo, idx_hi, _found = self._min2_unpack(handle)
        return dist, idx_lo, idx_lo == idx_hi

    def min2(self, q_codes: np.ndarray):
        """Per row: (min distance, first argmin, unique-min flag) — one
        fused packed-key pass, no top-k sort (reference tie rule,
        lib.rs:306-313 / cluster.rs:62-68)."""
        handle = self.min2_async(q_codes)
        if handle is None:
            return None
        return self.min2_result(handle)

    def min_scan(self, q_codes: np.ndarray):
        """(min distance, first argmin) per row — cluster's inner scan."""
        d, i, _ = self.min2(q_codes)
        return d, i

    # -- K-mode ------------------------------------------------------------

    def _kmode_hist_enabled(self) -> bool:
        """K-mode phase A program choice. The [B, L+1] histogram costs
        ~L+1 compare+adds per distance element; the fused binary-search
        count scans cost ~ceil(log2(L+2)) + 2 in-program matmul passes
        with a 2-op epilogue, so binary search is the default everywhere
        (not yet measured on the H100); the histogram stays behind
        SMAFA_TPU_KMODE_HIST=1 (parity-tested). Very long windows
        (>= HIST_MAX) never take the histogram."""
        if self.seq_len >= D.HIST_MAX:
            return False
        return os.environ.get("SMAFA_TPU_KMODE_HIST", "") == "1"

    def kmode_stats_async(self, q_codes: np.ndarray, k: int,
                          max_divergence: int | None):
        """Dispatch K-mode phase A without waiting: the histogram program
        (short windows) or the fused binary-search cutoff scans (long
        windows). Opaque handle for ``kmode_flat``."""
        self._require_windows()
        shift = self._key_shift()
        if shift is None:
            return None
        q_padded, nq = self._pad(q_codes)
        if self._kmode_hist_enabled():
            fn = self._program("hist", q_padded.shape[0])
            hist = fn(q_padded, self.db_oh, self.n_windows_dev)
            return ("hist", hist, nq, shift, q_padded)
        import jax.numpy as jnp

        maxdiv = self.seq_len + 1 if max_divergence is None else max_divergence
        fn = self._program("kstats", q_padded.shape[0], shift=shift)
        out = fn(
            q_padded, self.db_oh, self.n_windows_dev,
            jnp.int32(k), jnp.int32(maxdiv),
        )
        if isinstance(out, tuple):
            eff, hits = out
        else:  # stacked [2, B]: one device->host transfer
            sh = _SharedFetch(out)
            eff, hits = _Row(sh, 0), _Row(sh, 1)
        return ("kstats", eff, hits, nq, shift, q_padded)

    def kmode_flat(self, q_codes: np.ndarray, k: int,
                   max_divergence: int | None, stats_handle=None):
        """Exact K-mode hit lists, flat: (counts [nq], flat_rows, flat_idx,
        flat_dist) with each row's segment sorted by (distance, subject
        index) — the reference's print set and order (lib.rs:241-295
        before limit-per-sequence), cutoff ties included. None on packing
        overflow (callers fall back to top-M)."""
        if stats_handle is None or not (
            isinstance(stats_handle, tuple)
            and stats_handle[0] in ("hist", "kstats")
        ):
            stats_handle = self.kmode_stats_async(q_codes, k, max_divergence)
        if stats_handle is None:
            return None
        if stats_handle[0] == "hist":
            _, hist, nq, shift, q_padded = stats_handle
            eff, hits = D.kmode_cutoffs_from_hist(
                np.asarray(hist)[:nq], k, max_divergence, self.n_windows
            )
        else:
            _, eff_dev, hits_dev, nq, shift, q_padded = stats_handle
            eff = np.asarray(eff_dev)[:nq]
            hits = np.asarray(hits_dev)[:nq]
        counts = hits.astype(np.int64)
        total = int(counts.sum())
        empty = np.empty(0, np.int32)
        if total == 0:
            return counts.astype(np.int32), empty, empty, empty
        thresh = np.where(counts > 0, eff, -1).astype(np.int32)
        if self._compactd_supported():
            # Device-fused distances + packed keys + rows reconstructed
            # from counts: ~3.5x less per-batch hit traffic and one
            # fewer round trip than compact + hitdist (see
            # ScanRunner._build_compactd). Arrives globally
            # (row, dist, idx)-sorted — the device two-key sort replaces
            # the host argsort over millions of hits.
            rows, idx, dv = self._compact_grouped_dist(
                q_padded, thresh, counts
            )
            return (counts.astype(np.int32), rows.astype(np.int32),
                    idx.astype(np.int32), dv.astype(np.int32))
        rows, idx = self._compact_grouped(q_padded, thresh, counts)
        dv = self._host_distances(q_padded, rows, idx)
        # single packed-key argsort instead of a 3-pass lexsort
        # ((row, dist, idx) triples are unique, so sort stability is
        # moot; ~2x at millions of hits); field widths are sized from
        # the actual domains and overflow falls back to lexsort.
        dv_bits = int(self.seq_len + 1).bit_length()
        idx_bits = max(1, int(max(self.wp, 2) - 1).bit_length())
        row_bits = max(1, int(q_padded.shape[0] - 1).bit_length())
        if row_bits + dv_bits + idx_bits <= 63:
            key = (((rows.astype(np.int64) << dv_bits) | dv)
                   << idx_bits) | idx
            order = np.argsort(key)
        else:
            order = np.lexsort((idx, dv, rows))
        return (counts.astype(np.int32), rows[order].astype(np.int32),
                idx[order].astype(np.int32), dv[order].astype(np.int32))

    def kmode(self, q_codes: np.ndarray, k: int, max_divergence: int | None,
              stats_handle=None):
        """Compatibility per-row view over ``kmode_flat``: (dists [B, cap],
        idxs [B, cap], hits [B]) with cap = max hits per row."""
        res = self.kmode_flat(q_codes, k, max_divergence, stats_handle)
        if res is None:
            return None
        counts, rows, idx, dv = res
        nq = counts.shape[0]
        cap = int(counts.max(initial=0))
        dists = np.full((nq, cap), 2**30, np.int32)
        idxs = np.full((nq, cap), np.int32(2**31 - 1), np.int32)
        starts = np.cumsum(counts.astype(np.int64)) - counts
        cols = np.arange(rows.shape[0], dtype=np.int64) - starts[rows]
        dists[rows, cols] = dv
        idxs[rows, cols] = idx
        return dists, idxs, counts

    # -- shared compaction plumbing ----------------------------------------

    # Recompute per-hit distances on DEVICE above this many hits: the
    # paired gather+compare is trivial there (the db codes are already
    # resident), while the host numpy path makes two [hits, L] gathers
    # plus the compare on the host. Not yet measured on the H100.
    HITDIST_DEVICE_MIN = 1 << 16

    def _host_distances(self, q_padded: np.ndarray, rows: np.ndarray,
                        idx: np.ndarray) -> np.ndarray:
        """Exact per-hit distances recomputed from channel codes.

        Matches the device one-hot dot semantics exactly: a column
        matches iff the channel indices are equal (codes are always
        0..4, see core.alphabet.encode_bytes). Large hit lists compute
        on device (codes-resident single-device dbs — one bucketed
        gather+compare program); the host path remains for small lists,
        sharded/multi-host meshes (a device gather there would
        all-gather the db) and non-codes-resident forms. The host db
        view is often a memmap; only the hit rows are paged in."""
        if rows.shape[0] == 0:
            return np.empty(0, np.int32)
        L = self.seq_len
        if (rows.shape[0] >= self.HITDIST_DEVICE_MIN
                and getattr(self, "n_q", 0) == 1
                and getattr(self, "n_w", 0) == 1
                and self.db_oh is not None
                and self.db_oh.shape[1] == L):
            n = rows.shape[0]
            b = D.bucket(n, minimum=1024)
            rp = np.zeros(b, np.int32)
            ip = np.zeros(b, np.int32)
            rp[:n] = rows
            ip[:n] = idx
            fn = self._program("hitdist", b)
            return np.asarray(fn(q_padded, self.db_oh, rp, ip))[:n]
        q = q_padded[rows, :L]
        d = np.asarray(self._codes_host[idx])[:, :L]
        return (L - (q == d).sum(axis=1)).astype(np.int32)

    # -- best-hit tie-count fast path ---------------------------------------

    # Use the tie-count pass when the compaction span is at least this
    # many rows: below it, compaction is a single cheap dispatch and the
    # extra tcount dispatch's latency dominates; above it, the pack
    # epilogue makes compaction several scan-equivalents, and most tied
    # rows (exactly 2 ties on random data) skip it entirely.
    PAIR_COUNT_MIN_SPAN = 1 << 18

    def _pair_count_enabled(self) -> bool:
        v = os.environ.get("SMAFA_TPU_PAIR_COUNT", "")
        if v == "0":
            return False
        if v == "1":
            return True
        return self._compact_span_rows() >= self.PAIR_COUNT_MIN_SPAN

    # Enumerate middle ties on device (one dual bounded-min program,
    # ceil((ties-2)/2) in-program passes) for rows with at most this
    # many ties; heavier rows pay the compaction mask instead.
    TIE_ITER_MAX = 10


    def _miditer_supported(self) -> bool:
        """On-device tie enumeration needs the miditer primitive with
        GLOBAL packed keys; runners without one (ring/col/stream) and
        shard-local key mode fall back to compaction."""
        import os

        if os.environ.get("SMAFA_TPU_TIE_ITER", "") == "0":
            return False
        if type(self)._build_miditer is HitModesMixin._build_miditer:
            return False
        shift = self._key_shift()
        return (shift is not None
                and shift == D.packing_shift(self.seq_len, max(self.wp, 2)))

    def _build_miditer(self, b: int, shift: int,
                       t_steps: int):  # pragma: no cover
        raise KeyError("miditer")

    def _iter_middles_async(self, q_padded: np.ndarray,
                            row_ids: np.ndarray, d_star: np.ndarray,
                            lo_idx: np.ndarray, hi_idx: np.ndarray,
                            counts: np.ndarray):
        """Dispatch the on-device middle-enumeration program; collect
        with ``_iter_middles_collect`` (the split lets the independent
        compaction dispatches overlap it on device)."""
        shift = self._key_shift()
        nsel = int(row_ids.shape[0])
        need = (counts.astype(np.int64) - 2)
        t_steps = D.bucket(int(-(-int(need.max()) // 2)), minimum=1)
        b = D.bucket(nsel, minimum=16)
        q_sub = np.zeros((b, q_padded.shape[1]), q_padded.dtype)
        q_sub[:nsel] = q_padded[row_ids]
        q_sub_p, _ = self._pad(q_sub)
        bp = q_sub_p.shape[0]
        big = np.int32(2**31 - 1)
        fl = np.full(bp, big, np.int32)
        fl[:nsel] = lo_idx
        cl = np.full(bp, -1, np.int32)
        cl[:nsel] = hi_idx
        ds = np.full(bp, -1, np.int32)
        ds[:nsel] = d_star
        fn = self._program("miditer", bp, shift=shift, t_cap=t_steps)
        mids = fn(q_sub_p, self.db_oh, self.n_windows_dev, fl, cl, ds)
        return (mids, q_padded, row_ids, d_star, counts, need, nsel)

    def _iter_middles(self, q_padded: np.ndarray, row_ids: np.ndarray,
                      d_star: np.ndarray, lo_idx: np.ndarray,
                      hi_idx: np.ndarray,
                      counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The counts[i]-2 MIDDLE tied indices of each selected row (the
        lowest and highest ride in the min2 keys already), in ONE device
        dispatch: the program runs ceil(max middles / 2) dual bounded-min
        passes on device, each emitting the next-lowest and next-highest
        remaining tie (distance.miditer_scan) — the round-3 version drove
        one minfloor dispatch per tie from the host, which dominated
        end-to-end best-hit at scale. Rows whose device fill count
        disagrees with the known tie count (kernel drift) fall back to
        exact compaction rather than emitting a wrong index. Returns
        flat (rows, idx) in arbitrary order (callers lexsort)."""
        return self._iter_middles_collect(self._iter_middles_async(
            q_padded, row_ids, d_star, lo_idx, hi_idx, counts,
        ))

    def _iter_middles_collect(self, handle):
        mids, q_padded, row_ids, d_star, counts, need, nsel = handle
        both = np.asarray(mids)  # stacked [2, B, T]: ONE fetch
        ml = both[0][:nsel]
        mh = both[1][:nsel]
        vl = ml >= 0
        vh = mh >= 0
        got = vl.sum(axis=1) + vh.sum(axis=1)
        ok = got == need
        rows_t = np.broadcast_to(row_ids[:, None], ml.shape)
        out_r = [rows_t[vl & ok[:, None]], rows_t[vh & ok[:, None]]]
        out_i = [ml[vl & ok[:, None]], mh[vh & ok[:, None]]]
        if not ok.all():
            # drift: enumerate those rows exactly via compaction, then
            # strip each row's lowest/highest tie (the caller emits the
            # min2 key indices for every iterated row separately)
            bad = ~ok
            drift_r, drift_i = self._compact_grouped_rows(
                q_padded, row_ids[bad], d_star[bad].astype(np.int32),
                counts[bad].astype(np.int64),
            )
            strip = np.ones(drift_r.shape[0], bool)
            for r in row_ids[bad]:
                pos = np.nonzero(drift_r == r)[0]
                if pos.size:  # a drifting row may have no hits at
                    strip[pos[0]] = False   # the claimed threshold
                if pos.size > 1:
                    strip[pos[-1]] = False
            out_r.append(drift_r[strip])
            out_i.append(drift_i[strip])
        return (np.concatenate(out_r).astype(np.int32),
                np.concatenate(out_i).astype(np.int32))

    def _tie_counts(self, q_padded: np.ndarray, row_ids: np.ndarray,
                    dist_vals: np.ndarray) -> np.ndarray:
        """Exact tie count per selected row: one tcount pass (count of
        windows at dist <= row minimum — nothing sits below the minimum,
        so this IS the tie count) over a bucketed gather of exactly the
        tied rows."""
        nsel = int(row_ids.shape[0])
        q_sub_p, _ = self._pad(q_padded[row_ids])
        t = np.full(q_sub_p.shape[0], -1, np.int32)
        t[:nsel] = dist_vals
        fn = self._program("tcount", q_sub_p.shape[0])
        cnt = np.asarray(fn(q_sub_p, self.db_oh, self.n_windows_dev, t))
        return cnt[:nsel].astype(np.int64)

    def _compact_span_rows(self) -> int:
        """Db rows one compact program instance's mask spans (overridden
        by runners that segment or shard the scanned range)."""
        return self.wp

    def _mask_row_cap(self) -> int:
        return mask_row_cap(self._compact_span_rows())

    def _compact_dispatch_async(self, q_padded: np.ndarray,
                                row_ids: np.ndarray,
                                thresh_vals: np.ndarray, t_cap: int):
        """Start one compaction dispatch over exactly the selected rows
        (bucketed sub-batch); collect with ``_compact_collect``. The
        split lets independent row groups overlap on device instead of
        serializing dispatch->fetch per group."""
        nsel = int(row_ids.shape[0])
        b = D.bucket(nsel, minimum=16)
        q_sub = np.zeros((b, q_padded.shape[1]), q_padded.dtype)
        q_sub[:nsel] = q_padded[row_ids]
        q_sub_p, _ = self._pad(q_sub)
        th = np.full(q_sub_p.shape[0], -1, np.int32)
        th[:nsel] = thresh_vals
        fn = self._program("compact", q_sub_p.shape[0], t_cap=t_cap)
        out = fn(q_sub_p, self.db_oh, self.n_windows_dev, th)
        return (out, fn, row_ids, nsel, t_cap)

    def _compact_dispatch(self, q_padded: np.ndarray, row_ids: np.ndarray,
                          thresh_vals: np.ndarray, t_cap: int):
        """One compaction dispatch + collect.

        Returns (global rows, idx, exact per-selected-row counts, valid);
        when ``valid`` is False the buffers were undersized (counts stay
        exact) and the caller re-dispatches with exact sizing."""
        return self._compact_collect(self._compact_dispatch_async(
            q_padded, row_ids, thresh_vals, t_cap
        ))

    def _compact_collect(self, handle):
        out, fn, row_ids, nsel, t_cap = handle
        sizes = getattr(fn, "split_sizes", None)
        if sizes is not None:
            # flat packed output: ONE device->host transfer
            a = np.asarray(out)
            p0, p1 = sizes[0], sizes[0] + sizes[1]
            p2 = p1 + sizes[2]
            rows, idx = a[:p0], a[p0:p1]
            rc, shard_totals = a[p1:p2], a[p2:]
        else:
            rows, idx, rc, shard_totals = out
            rows = np.asarray(rows)
            idx = np.asarray(idx)
            rc = np.asarray(rc)
            shard_totals = np.asarray(shard_totals)
        rc = rc.astype(np.int64)[:nsel]
        valid = bool((shard_totals <= t_cap).all())
        keep = rows >= 0
        return row_ids[rows[keep]], idx[keep], rc, valid

    def _compact_adaptive(self, q_padded, thresh, n_tied: int):
        """Best-hit phase B without prior counts: per row slice, one
        pass with a guessed buffer (ties are nearly always few); the
        exact row_counts that ride along detect an undersized buffer, in
        which case the slice's rows are re-compacted in exactly-sized
        groups. Returns flat (rows, idx) sorted by (row, index) over
        tied rows only, plus exact per-padded-row counts (zero for
        untied rows).

        The probe allows 64 ties per tied row: extraction slots are
        cheap (gathers), so oversizing costs little, while an undersized
        probe costs a whole extra pass over the db — only batches
        averaging >64 ties per tied row pay the second pass."""
        sel = np.nonzero(thresh >= 0)[0].astype(np.int32)
        cap = self._mask_row_cap()
        row_counts = np.zeros(q_padded.shape[0], np.int64)
        out_r, out_i = [], []
        # dispatch every slice before collecting any: the device
        # pipelines them instead of paying one serial dispatch->fetch
        # round trip per slice (the final lexsort makes segment order
        # irrelevant)
        pending = []
        for s in range(0, sel.size, cap):
            ids = sel[s:s + cap]
            t_cap = min(D.bucket(max(1024, 64 * ids.size)), COMPACT_MAX)
            pending.append((ids, self._compact_dispatch_async(
                q_padded, ids, thresh[ids], t_cap
            )))
        retries = []
        for ids, h in pending:
            g_rows, g_idx, rc, valid = self._compact_collect(h)
            row_counts[ids] = rc
            if valid:
                out_r.append(g_rows)
                out_i.append(g_idx)
            else:
                retries.append((ids, rc))
        for ids, rc in retries:
            gr, gi = self._compact_grouped_rows(
                q_padded, ids, thresh[ids], rc
            )
            out_r.append(gr)
            out_i.append(gi)
        rows = np.concatenate(out_r) if out_r else np.empty(0, np.int32)
        idx = np.concatenate(out_i) if out_i else np.empty(0, np.int32)
        order = np.lexsort((idx, rows))
        return rows[order], idx[order], row_counts

    def _compactd_supported(self) -> bool:
        """Gate for the fused-distance compaction: single device,
        codes-resident db, global packed (dist, idx) key, and no segment
        sweep."""
        if getattr(self, "n_q", 0) != 1 or getattr(self, "n_w", 0) != 1:
            return False
        if self.db_oh is None or self.db_oh.shape[1] != self.seq_len:
            return False
        if D.packing_shift(self.seq_len, max(self.wp, 2)) is None:
            return False
        if not hasattr(self, "_build_compactd"):
            return False
        return getattr(self, "_compact_seg", None) is None

    def _compactd_dispatch_async(self, q_padded, row_ids, thresh_vals,
                                 t_cap: int):
        nsel = int(row_ids.shape[0])
        b = D.bucket(nsel, minimum=16)
        q_sub = np.zeros((b, q_padded.shape[1]), q_padded.dtype)
        q_sub[:nsel] = q_padded[row_ids]
        q_sub_p, _ = self._pad(q_sub)
        th = np.full(q_sub_p.shape[0], -1, np.int32)
        th[:nsel] = thresh_vals
        fn = self._program("compactd", q_sub_p.shape[0], t_cap=t_cap)
        out = fn(q_sub_p, self.db_oh, self.n_windows_dev, th)
        return (out, fn, row_ids, nsel, t_cap)

    def _compactd_collect(self, handle):
        out, fn, row_ids, nsel, t_cap = handle
        sizes = fn.split_sizes
        a = np.asarray(out)
        keys = a[:t_cap]
        rc = a[t_cap:t_cap + sizes[1]][:nsel].astype(np.int64)
        total = int(a[-1])
        assert total <= t_cap and total == int(rc.sum()), \
            "exactly-sized fused compaction overflowed"
        shift = D.packing_shift(self.seq_len, max(self.wp, 2))
        keys = keys[:total]
        rows = row_ids[np.repeat(np.arange(nsel), rc)]
        return (rows.astype(np.int32),
                (keys & np.int32((1 << shift) - 1)).astype(np.int32),
                (keys >> shift).astype(np.int32))

    def _compact_grouped_dist(self, q_padded, thresh, counts):
        """K-mode phase B with fused distances: flat (rows, idx, dv)
        over rows with known exact counts, GLOBALLY sorted by
        (row, dist, idx) — same grouping bounds as
        _compact_grouped_rows, all groups dispatched before any is
        collected. Device segments arrive pre-sorted
        (distance.sort_hit_keys inside the compactd program) and cover
        ascending disjoint row ranges; host-enumerated giant rows are
        sorted per row and interleaved in sequence order — so the
        caller needs NO argsort over millions of hits."""
        counts = np.asarray(counts)
        sel = np.nonzero(counts > 0)[0].astype(np.int32)
        row_ids = sel
        thresh_vals = np.asarray(thresh)[sel]
        cnts = counts[sel].astype(np.int64)
        cap = self._mask_row_cap()
        n = int(row_ids.shape[0])
        plan: list = []  # ("host", r, i, d) | ("dev", handle), row order
        L = self.seq_len
        idx_bits = max(1, int(max(self.wp, 2) - 1).bit_length())
        start = 0
        while start < n:
            c0 = int(cnts[start])
            if c0 > COMPACT_MAX:
                gid = int(row_ids[start])
                hit_idx = self._host_enumerate_row(
                    q_padded[gid], int(thresh_vals[start])
                )
                assert hit_idx.shape[0] == c0, (hit_idx.shape[0], c0)
                dvh = (L - (q_padded[gid][:L]
                            == np.asarray(self._codes_host[hit_idx])[:, :L]
                            ).sum(axis=1)).astype(np.int32)
                order = np.argsort(
                    (dvh.astype(np.int64) << idx_bits) | hit_idx
                )
                plan.append(("host", np.full(c0, gid, np.int32),
                             hit_idx[order], dvh[order]))
                start += 1
                continue
            end = start + 1
            acc = c0
            while (end < n and end - start < cap
                   and int(cnts[end]) <= COMPACT_MAX
                   and acc + int(cnts[end]) <= COMPACT_MAX):
                acc += int(cnts[end])
                end += 1
            t_cap = D.bucket(max(acc, 1), minimum=256)
            plan.append(("dev", self._compactd_dispatch_async(
                q_padded, row_ids[start:end], thresh_vals[start:end], t_cap
            )))
            start = end
        out_r, out_i, out_d = [], [], []
        for item in plan:
            if item[0] == "host":
                _, r, i, d = item
            else:
                r, i, d = self._compactd_collect(item[1])
            out_r.append(r)
            out_i.append(i)
            out_d.append(d)
        if not out_r:
            e = np.empty(0, np.int32)
            return e, e, e
        return (np.concatenate(out_r), np.concatenate(out_i),
                np.concatenate(out_d))

    def _compact_grouped(self, q_padded, thresh, counts):
        """Compact rows with known exact counts, grouped so no dispatch
        exceeds COMPACT_MAX buffered hits or the mask-memory row cap."""
        counts = np.asarray(counts)
        sel = np.nonzero(counts > 0)[0].astype(np.int32)
        return self._compact_grouped_rows(
            q_padded, sel, np.asarray(thresh)[sel], counts[sel]
        )

    def _compact_grouped_rows(self, q_padded, row_ids, thresh_vals, counts):
        """Greedy row groups under two bounds: COMPACT_MAX buffered hits
        per dispatch and the mask-memory row cap. A single row whose
        count exceeds COMPACT_MAX never reaches the device (an uncapped
        dispatch would allocate multi-GB buffers next to the resident
        db, or OOM) — its hits are enumerated host-side instead, one
        chunked numpy pass over the channel codes. Returns flat
        (rows, idx) sorted by (row, index).

        When the fused-distance program is available it serves here too
        (its packed single-key buffer halves the fetch): every caller's
        threshold is a row minimum,
        so all buffered hits sit at one distance per row and the
        program's (row, dist, idx) order IS (row, index) order."""
        use_d = self._compactd_supported()
        cap = self._mask_row_cap()
        n = int(row_ids.shape[0])
        out_r, out_i = [], []
        pending: list = []  # dispatch every group, then collect (overlap)
        start = 0
        while start < n:
            c0 = int(counts[start])
            if c0 > COMPACT_MAX:
                gid = int(row_ids[start])
                hit_idx = self._host_enumerate_row(
                    q_padded[gid], int(thresh_vals[start])
                )
                assert hit_idx.shape[0] == c0, (hit_idx.shape[0], c0)
                out_r.append(np.full(c0, gid, np.int32))
                out_i.append(hit_idx)
                start += 1
                continue
            end = start + 1
            acc = c0
            while (end < n and end - start < cap
                   and int(counts[end]) <= COMPACT_MAX
                   and acc + int(counts[end]) <= COMPACT_MAX):
                acc += int(counts[end])
                end += 1
            t_cap = D.bucket(max(acc, 1), minimum=256)
            dispatch = (self._compactd_dispatch_async if use_d
                        else self._compact_dispatch_async)
            pending.append(dispatch(
                q_padded, row_ids[start:end], thresh_vals[start:end], t_cap
            ))
            start = end
        for h in pending:
            if use_d:
                g_rows, g_idx, _dv = self._compactd_collect(h)
            else:
                g_rows, g_idx, _rc, valid = self._compact_collect(h)
                assert valid, "exactly-sized compaction overflowed"
            out_r.append(g_rows)
            out_i.append(g_idx)
        rows = np.concatenate(out_r) if out_r else np.empty(0, np.int32)
        idx = np.concatenate(out_i) if out_i else np.empty(0, np.int32)
        order = np.lexsort((idx, rows))
        return rows[order], idx[order]

    def _host_enumerate_row(self, q_row: np.ndarray, thresh: int) -> np.ndarray:
        """All window indices with distance <= thresh for ONE query row,
        enumerated host-side in ascending order (chunked so a memmap db
        streams through a bounded working set)."""
        if thresh < 0:
            return np.empty(0, np.int32)
        L = self.seq_len
        q = q_row[:L]
        out = []
        step = 1 << 20
        for s in range(0, self.n_windows, step):
            d = np.asarray(self._codes_host[s:s + step])[:, :L]
            dist = L - (q == d).sum(axis=1)
            hit = np.nonzero(dist <= thresh)[0].astype(np.int32)
            out.append(hit + np.int32(s))
        return np.concatenate(out) if out else np.empty(0, np.int32)
