"""Out-of-core db layout: slab-streamed scans for dbs larger than HBM.

The resident layouts (sharded/ring/col) hold the db tensor in device
memory — uint8 codes by default (60 bytes/row at 60 bp), one-hot when
forced (SMAFA_TPU_DB_CODES=0: 384 bytes/row). The
reference, whose db is 40 bytes/row of packed u64 in host RAM
(reference lib.rs:54-60), handles such dbs on any machine with enough
RAM; this layout restores that capability on the device:

- the channel codes stay host-side (usually the native format's memmap,
  io/native_format.py — nothing is ever fully materialized in RAM
  either);
- per batch, fixed-shape row slabs stream through the device: a uint8
  code slab is uploaded (seq_len bytes/row — 6.4x less PCIe traffic
  than one-hot), expanded to one-hot on device, scanned, and folded
  into a small carried accumulator (packed min keys / histogram /
  stats counts), exactly the pmin/psum merges the sharded layout does
  across devices (parallel/sharded.py) applied over time instead of space;
- dispatch is async, so slab k+1's upload overlaps slab k's scan; a
  periodic barrier bounds the number of in-flight slab buffers (the
  whole point is a bounded device working set);
- **codes-resident tier**: uint8 codes are seq_len/padded_feature_dim
  (~6.4x at 60 bp) smaller than their one-hot, so dbs whose ONE-HOT
  overflows HBM often fit as raw codes (~224M rows on a 16 GB chip at
  60 bp). When they do, the slabs are uploaded once and cached on
  device — the same programs run with zero per-batch PCIe traffic;
  only beyond that does the layout truly stream from host.

Arithmetic intensity makes even true streaming fast: one uploaded db
byte feeds 2*batch int-ops of scan work (~32k ops/byte at the default
16384-query batch), so H2D bandwidth is nowhere near the bottleneck
until batches get small. The layout is selected automatically when the
one-hot db would not fit in the visible devices' HBM
(parallel/select.py), or forced with SMAFA_TPU_LAYOUT=stream.

Single-device by design (the out-of-core regime is "db exceeds ALL
resident memory"; devices beyond the first add nothing once every slab
must cross PCIe anyway — multi-host row partitioning via --coordinator
is the way to put more chips on one query stream).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from smafa_tpu.ops import distance as D
from smafa_tpu.parallel.hitops import HitModesMixin

BIG_KEY = 2**31 - 1

# uint8 code bytes per slab (the scan expands one CHUNK at a time via
# distance.block_distances, so no slab-sized one-hot ever exists on
# device). 512 MB default: big enough that the scan over a slab dwarfs
# its dispatch latency, small enough that _INFLIGHT slabs stay far
# under any chip's HBM.
SLAB_BYTES = 1 << 29

# Dispatch at most this many slab programs ahead of execution before
# draining: bounds in-flight uint8 slab buffers (device memory) and
# keeps the upload pipeline ahead of the scan by a couple of slabs.
_INFLIGHT = 4

# Cache the uint8 code slabs on device when they total at most this
# fraction of the device's memory (leaves room for the executing slab's
# one-hot transient, mask buffers, and accumulators).
CODES_RESIDENT_FRACTION = 0.4


def _slab_bytes() -> int:
    return int(os.environ.get("SMAFA_TPU_SLAB_BYTES", str(SLAB_BYTES)))


# The scan kernels take the slab CODES directly: distance.block_distances
# expands one chunk at a time inside the scan loop, so no slab-sized
# one-hot is ever materialized — the device working set per step is the
# uint8 slab plus a [chunk, LP] block. The query batch expands ONCE per
# sweep (_expand_q) and the one-hot rides through every slab step.


BIG_DIST = 2**30


@partial(jax.jit, static_argnames=("seq_len", "embed"))
def _expand_q(q_codes, seq_len, embed):
    # Slabs are always codes-resident, so the query pairs with whatever
    # form embed_active selects for codes dbs. The form is an explicit
    # static arg: this jit cache is module-global and the env-derived
    # choice must not be baked into a shape-keyed entry.
    if embed:
        return D.expand_embed_query(q_codes, seq_len)
    return D.expand_onehot(q_codes, seq_len)


@partial(jax.jit, static_argnames=("seq_len", "shift", "chunk", "span"))
def _min2_step(q_oh, slab_codes, n_valid, slab_off, d, i_lo, i_hi,
               seq_len, shift, chunk, span):
    """Slab-LOCAL packed-key min2, unpacked and pair-merged into global
    (dist, index) carries on device.

    Local indices always fit the 31-bit key (span = slab rows), so the
    stream layout serves dbs beyond the GLOBAL packed-key budget (~33M
    rows at 60 bp) — where the resident layouts drop to the top-M
    fallback — without host round-trips. Cross-slab tie rules: slabs
    ascend in global offset, so the lowest-index side keeps ties
    (strict <) and the highest-index side takes them (<=); empty rows
    carry dist 2^30 and index 2^31-1 — the sentinel convention of
    HitModesMixin._min2_unpack."""
    lo, hi = D.min2_scan(q_oh, slab_codes, n_valid, jnp.int32(0),
                         seq_len, shift, chunk, span)
    big = jnp.int32(2**31 - 1)
    mask = jnp.int32((1 << shift) - 1)
    # slabs with no valid rows yield sentinel-distance keys (dist
    # seq_len+1) — detect by decoded distance (robust under both the
    # legacy BIG_KEY and the sentinel conventions)
    empty = (lo == big) | ((lo >> shift) > seq_len)
    d2 = jnp.where(empty, jnp.int32(BIG_DIST), lo >> shift)
    il2 = jnp.where(empty, big, (lo & mask) + slab_off)
    ih2 = jnp.where(empty, big, (span - 1 - (hi & mask)) + slab_off)
    take_lo = d2 < d
    take_hi = d2 <= d
    return (jnp.minimum(d, d2), jnp.where(take_lo, il2, i_lo),
            jnp.where(take_hi, ih2, i_hi))


@partial(jax.jit, static_argnames=("seq_len", "chunk"))
def _hist_step(q_oh, slab_codes, n_valid, h, seq_len, chunk):
    return h + D.hist_scan(q_oh, slab_codes, n_valid, seq_len, chunk)


@partial(jax.jit, static_argnames=("seq_len", "chunk"))
def _stats_step(q_oh, slab_codes, n_valid, t, cnt, mx, seq_len, chunk):
    c2, m2 = D._stats_pass(q_oh, slab_codes, n_valid, t, seq_len, chunk)
    return cnt + c2, jnp.maximum(mx, m2)


@partial(jax.jit, static_argnames=("seq_len", "chunk", "t_cap", "pack"))
def _compact_step(q_oh, slab_codes, n_valid, off, thresh,
                  seq_len, chunk, t_cap, pack):
    rows, idx, rc, total = D.compact_scan(
        q_oh, slab_codes, n_valid, thresh, off, seq_len, chunk, t_cap, pack
    )
    return rows, idx, rc, total[None]


class SlabStreamRunner(HitModesMixin):
    """Every hit mode of the resident layouts (min2 / best-hit / K-mode,
    identical results), over a db that never resides on device."""

    def __init__(self, codes: np.ndarray, seq_len: int,
                 slab_rows: int | None = None, chunk: int | None = None):
        from smafa_tpu.utils.platform import enable_compilation_cache

        enable_compilation_cache()
        self.seq_len = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        self._codes_host = codes
        row_bytes = max(1, int(codes.shape[1] or 1))
        self.chunk = chunk or D.default_chunk(self.n_windows)
        if slab_rows is None:
            # Slab count from the byte budget, then balance: uniform
            # slab shape (one compiled program) sized so the last slab
            # carries real rows, not a budget's worth of zero padding.
            need = max(self.chunk,
                       -(-self.n_windows // self.chunk) * self.chunk)
            budget_rows = max(self.chunk,
                              _slab_bytes() // row_bytes // self.chunk
                              * self.chunk)
            n_slabs = -(-need // budget_rows)
            slab_rows = -(-need // (n_slabs * self.chunk)) * self.chunk
        if slab_rows % self.chunk:
            raise ValueError(f"slab_rows {slab_rows} not a multiple of "
                             f"chunk {self.chunk}")
        self.slab_rows = slab_rows
        self.n_slabs = max(1, -(-self.n_windows // slab_rows))
        self.wp = self.n_slabs * slab_rows
        # Keys pack SLAB-locally (the min2 step pair-merges globally), so
        # only the slab span must fit 31 bits — any row count works.
        self.shift = D.packing_shift(self.seq_len, max(self.slab_rows, 2))
        if self.shift is None:
            raise ValueError(
                f"Slab streaming requires (seq_len={seq_len}, "
                f"slab_rows={self.slab_rows}) to fit packed 31-bit keys; "
                "use parallel.sharded.ScanRunner (exact top-M fallback) "
                "instead"
            )
        self.db_oh = None  # never one-hot resident; programs ignore the arg
        self.n_windows_dev = jnp.int32(self.n_windows)
        # Codes-resident tier: cache the uint8 slabs on device (uploaded
        # lazily, once) when they fit comfortably; otherwise re-stream
        # them from host every sweep.
        env = os.environ.get("SMAFA_TPU_SLAB_RESIDENT", "")
        if env:
            resident = env not in ("0", "false")
        else:
            # Everything lands on ONE device here, so gate on device
            # 0's share of the (env-overridable, total-across-devices)
            # capacity — select._hbm_capacity is the single HBM probe.
            from smafa_tpu.parallel.select import _hbm_capacity

            cap = _hbm_capacity(per_device=True)
            resident = (cap is not None and
                        self.wp * row_bytes
                        <= CODES_RESIDENT_FRACTION * cap)
        self._slab_cache: list | None = [None] * self.n_slabs if resident else None

    # -- slab plumbing -------------------------------------------------------

    def _slab_codes(self, s: int) -> np.ndarray:
        lo = s * self.slab_rows
        hi = min(lo + self.slab_rows, self.n_windows)
        block = np.asarray(self._codes_host[lo:hi])
        if hi - lo < self.slab_rows:
            block = np.pad(block, [(0, self.slab_rows - (hi - lo)), (0, 0)])
        return block

    def _slab_dev(self, s: int):
        if self._slab_cache is None:
            return jax.device_put(self._slab_codes(s))
        buf = self._slab_cache[s]
        if buf is None:
            buf = jax.device_put(self._slab_codes(s))
            self._slab_cache[s] = buf
        return buf

    def _sweep(self, fold):
        """fold(slab_dev, n_valid, off_rows) -> barrier value; dispatches
        every slab async with a periodic drain so at most ~_INFLIGHT slab
        uploads are ever alive on device (the drain is moot for cached
        resident slabs, but bounding in-flight programs is still tidy)."""
        last = None
        for s in range(self.n_slabs):
            buf = self._slab_dev(s)
            off = s * self.slab_rows
            n_valid = min(self.slab_rows, max(0, self.n_windows - off))
            last = fold(buf, jnp.int32(n_valid), off)
            if (s + 1) % _INFLIGHT == 0:
                jax.block_until_ready(last)
        return last

    # -- HitModesMixin primitives --------------------------------------------

    def _pad(self, q_codes: np.ndarray):
        q_padded, nq, _b = D.pad_batch(q_codes, minimum=16)
        return q_padded, nq

    def _key_shift(self):
        # Slab-local span: fits for ANY row count. (min2 handles are
        # pair tuples; HitModesMixin._min2_unpack decodes them without
        # this shift.)
        return self.shift

    def _compact_span_rows(self) -> int:
        return self.slab_rows

    def _build_program(self, kind: str, b: int, shift: int | None = None,
                       t_cap: int | None = None):
        seq_len, chunk = self.seq_len, self.chunk
        span = self.slab_rows  # keys pack slab-locally

        if kind == "min2":
            def run(q_codes, _db, _n):
                q_oh = _expand_q(np.ascontiguousarray(q_codes), seq_len, D.embed_active(seq_len))
                big = jnp.full((b,), BIG_KEY, jnp.int32)
                carry = [jnp.full((b,), BIG_DIST, jnp.int32), big, big]

                def fold(buf, n_valid, off):
                    carry[:] = _min2_step(
                        q_oh, buf, n_valid, jnp.int32(off), *carry,
                        seq_len=seq_len, shift=shift, chunk=chunk, span=span,
                    )
                    return carry
                self._sweep(fold)
                # stacked single-fetch pair form (d, i_lo, i_hi); empty
                # rows keep the min2_pair_finish sentinel convention
                d, il, ih = carry
                (d2, il2), (_, ih2) = D.min2_pair_finish((d, il, ih))
                return {"pair": jnp.stack([d2, il2, ih2])}
            return run

        if kind == "hist":
            def run(q_codes, _db, _n):
                q_oh = _expand_q(np.ascontiguousarray(q_codes), seq_len, D.embed_active(seq_len))
                h = [jnp.zeros((b, seq_len + 1), jnp.int32)]

                def fold(buf, n_valid, off):
                    h[0] = _hist_step(q_oh, buf, n_valid, h[0], seq_len, chunk)
                    return h
                self._sweep(fold)
                return h[0]
            return run

        if kind == "kstats":
            return self._build_kstats(b)

        if kind == "tcount":
            def run(q_codes, _db, _n, t):
                q_oh = _expand_q(np.ascontiguousarray(q_codes), seq_len,
                                 D.embed_active(seq_len))
                cnt, _ = self._scan_stats(q_oh, b, np.asarray(t))
                return cnt
            return run

        if kind == "compact":
            def run(q_codes, _db, _n, thresh):
                q_oh = _expand_q(np.ascontiguousarray(q_codes), seq_len, D.embed_active(seq_len))
                th_dev = jax.device_put(np.ascontiguousarray(thresh))
                out_r, out_i, totals = [], [], []
                rc_sum = np.zeros(b, np.int64)

                def fold(buf, n_valid, off):
                    r, i, rc, t = _compact_step(
                        q_oh, buf, n_valid, jnp.int32(off), th_dev,
                        seq_len, chunk, t_cap, D._pack_mode(),
                    )
                    # Per-slab host fetch is the natural drain: no extra
                    # throttling needed, and hits concatenate in slab
                    # (= ascending window) order.
                    r = np.asarray(r)
                    keep = r >= 0
                    out_r.append(r[keep])
                    out_i.append(np.asarray(i)[keep])
                    rc_sum[:] += np.asarray(rc)
                    totals.append(np.asarray(t))
                    return None
                self._sweep(fold)
                return (np.concatenate(out_r), np.concatenate(out_i),
                        rc_sum, np.concatenate(totals))
            return run

        raise KeyError(kind)

    def _scan_stats(self, q_oh, b, t_vec):
        """(count of dist <= t[row], max dist) per row over ALL slabs."""
        cnt = jnp.zeros((b,), jnp.int32)
        mx = jnp.full((b,), -1, jnp.int32)
        t_dev = jax.device_put(np.ascontiguousarray(t_vec, dtype=np.int32))
        carry = [cnt, mx]

        def fold(buf, n_valid, off):
            carry[0], carry[1] = _stats_step(
                q_oh, buf, n_valid, t_dev, carry[0], carry[1],
                self.seq_len, self.chunk,
            )
            return carry
        self._sweep(fold)
        return np.asarray(carry[0]), np.asarray(carry[1])

    def _build_kstats(self, b: int):
        """Host-level mirror of ops.distance.kmode_phase1's CONTRACT
        (same K > n_windows and maxdiv rules; this one keeps the simple
        binary search — out-of-core sweeps are PCIe-bound, not
        pass-count-bound), with each count pass a full slab sweep.
        Only reached for seq_len >= HIST_MAX windows, where the histogram
        table would be wider than it is worth."""
        import math

        seq_len, n_windows = self.seq_len, self.n_windows

        def run(q_codes, _db, _n, k, maxdiv):
            k = int(k)
            maxdiv = int(maxdiv)
            q_oh = _expand_q(np.ascontiguousarray(q_codes), seq_len, D.embed_active(seq_len))
            steps = max(1, math.ceil(math.log2(seq_len + 2)))
            _, maxd = self._scan_stats(q_oh, b, np.full(b, seq_len))
            t_lo = np.zeros(b, np.int32)
            t_hi = np.full(b, seq_len, np.int32)
            for _ in range(steps):
                mid = (t_lo + t_hi) // 2
                cnt, _ = self._scan_stats(q_oh, b, mid)
                ge = cnt >= k
                t_lo = np.where(ge, t_lo, mid + 1)
                t_hi = np.where(ge, mid, t_hi)
            cutoff = maxd if k > n_windows else t_hi
            eff = np.minimum(cutoff, maxdiv).astype(np.int32)
            hits, _ = self._scan_stats(q_oh, b, eff)
            return eff, hits
        return run
