"""Ring-scheduled scan: db shards rotate around the device ring.

The ('q', 'w') ScanRunner (parallel.sharded) keeps queries replicated
within a q-group and merges per-shard results over 'w'. This module is
the other canonical multi-device layout (SURVEY.md §2.2 "ring/blockwise"):
BOTH the query batch and the db rows are sharded over one flat 'd' axis,
and every step each device scans its resident query block against the db
shard it currently holds, then forwards that shard to its ring neighbor
with ``lax.ppermute`` (neighbor traffic only — the db is never
all-gathered and no device ever holds more than 1/n of it). After n steps
every query block has met every db row. Running packed-key minima /
histograms / compaction buffers are the only cross-step state.

This is a layout for dbs at the 10M-row scale (BASELINE.json multi-host
config) where per-device memory cannot hold a replicated db and candidate
all-gathers would cross hosts. It is the Hamming-scan analogue of ring
attention: rotate the KV (db) blocks, keep running reductions instead of
softmax accumulators.

Hit-mode orchestration (best-hit min+count then compaction; K-mode
histogram then compaction) is shared with every other layout via
parallel.hitops.HitModesMixin; this module only supplies the
ring-swept compiled programs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from smafa_tpu.ops import distance as D
from smafa_tpu.parallel.hitops import HitModesMixin

BIG_KEY = 2**31 - 1


def build_ring_mesh(n: int | None = None) -> Mesh:
    devices = np.array(jax.devices())
    n = n or len(devices)
    return Mesh(devices[:n], ("d",))


class RingScanRunner(HitModesMixin):
    """Db resident sharded over a 1-D ring; queries sharded over the same
    axis. Supports every hit mode of ScanRunner (min2 / best-hit /
    K-mode) with identical results."""

    def __init__(self, codes: np.ndarray, seq_len: int, mesh: Mesh | None = None,
                 chunk: int | None = None):
        from smafa_tpu.utils.platform import enable_compilation_cache

        enable_compilation_cache()
        self.seq_len = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        self._codes_host = codes  # K-mode host distance recompute
        self.mesh = mesh if mesh is not None else build_ring_mesh()
        self.n_d = self.mesh.devices.shape[0]
        self.chunk = chunk or D.default_chunk(self.n_windows, self.n_d)

        stride = self.chunk * self.n_d
        padded = max(stride, ((self.n_windows + stride - 1) // stride) * stride)
        self.wp = padded
        self.shard_rows = padded // self.n_d
        # Global packed keys when they fit; beyond ~2^25 rows at 60 bp
        # the min2 sweep folds explicit (dist, index) pair carries
        # instead (distance.min2_pair_chunk_update) — same results, no
        # row-count ceiling. _key_shift still reports a (shard-local)
        # shift so the hit-mode mixin proceeds; only astronomical window
        # lengths (no packing at any span) are rejected.
        self.shift = D.packing_shift(self.seq_len, padded)
        self._min2_pairs = self.shift is None
        if self._min2_pairs:
            self.shift = D.packing_shift(self.seq_len, max(2, self.shard_rows))
        if self.shift is None:
            raise ValueError(
                f"Ring scan requires (seq_len={seq_len}, "
                f"shard_rows={self.shard_rows}) to fit packed 31-bit keys; "
                "use parallel.sharded.ScanRunner (exact top-M fallback) "
                "instead"
            )

        codes_p = codes
        if codes_p.shape[0] < padded:
            codes_p = np.pad(codes_p, [(0, padded - codes_p.shape[0]), (0, 0)])
        db_spec = NamedSharding(self.mesh, P("d", None))
        codes_dev = jax.device_put(codes_p, db_spec)
        from smafa_tpu.parallel.sharded import _db_codes_resident

        if _db_codes_resident():
            # Rotating uint8 codes moves 6.4x fewer bytes per ppermute hop
            # than one-hot; the sweep expands per chunk.
            self.db_oh = codes_dev
        else:
            self.db_oh = jax.jit(
                partial(D.expand_onehot, seq_len=self.seq_len),
                out_shardings=db_spec,
            )(codes_dev)
        self.n_windows_dev = jnp.int32(self.n_windows)
        self._cache: dict[int, callable] = {}

    # -- HitModesMixin primitives ------------------------------------------

    def _pad(self, q_codes: np.ndarray):
        q_padded, nq, _b = D.pad_batch(q_codes, multiple=self.n_d,
                                       minimum=self.n_d)
        return q_padded, nq

    def _key_shift(self):
        return self.shift

    def _build_program(self, kind: str, b: int, shift: int | None = None,
                       t_cap: int | None = None):
        if kind == "min2":
            return self._build(b)
        if kind == "hist":
            return self._build_hist(b)
        if kind == "kstats":
            return self._build_kstats(b)
        if kind == "tcount":
            return self._build_tcount(b)
        if kind == "compact":
            return self._build_compact(b, t_cap)
        raise KeyError(kind)

    # -- the ring sweep ----------------------------------------------------

    def _ring_sweep(self, q_oh, db_shard, n_windows, init, fold):
        """One full rotation of the db around the ring, folding every
        resident (shard, chunk) distance block into ``fold``'s carry.
        fold(carry, dist, lidx, n_valid, off) -> carry; ``off`` is the
        global index of the resident shard's row 0 (owner-dependent)."""
        n_d, shard_rows, chunk = self.n_d, self.shard_rows, self.chunk
        seq_len = self.seq_len
        fwd = [(j, (j + 1) % n_d) for j in range(n_d)]
        me = jax.lax.axis_index("d").astype(jnp.int32)
        offsets = jnp.arange(shard_rows // chunk, dtype=jnp.int32) * chunk

        def body(i, state):
            carry, db_cur = state
            # After i forward rotations, we hold the shard originally
            # owned by (me - i) mod n.
            owner = (me - i) % n_d
            off = owner * shard_rows
            n_valid = jnp.clip(n_windows - off, 0, shard_rows)

            def step(c, coff):
                dist = D.block_distances(q_oh, db_cur, coff, chunk, seq_len)
                lidx = coff + jnp.arange(chunk, dtype=jnp.int32)
                return fold(c, dist, lidx, n_valid, off), None

            carry, _ = jax.lax.scan(step, carry, offsets)
            db_nxt = jax.lax.cond(
                i < n_d - 1,  # final rotation would be wasted traffic
                lambda x: jax.lax.ppermute(x, "d", fwd),
                lambda x: x, db_cur,
            )
            return (carry, db_nxt)

        state = jax.lax.fori_loop(0, n_d, body, (init, db_shard))
        return state[0]

    def _jit_mapped(self, shard_fn, in_specs, out_specs):
        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
        seq_len = self.seq_len

        @jax.jit
        def run(q_codes, db_oh, n_windows, *extra):
            q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
            return mapped(q_oh, db_oh, n_windows, *extra)

        return run

    # -- compiled programs ---------------------------------------------------

    def _build_pallas_min2(self, b: int):
        """Fused-kernel min2 ring sweep: rotate the uint8 codes shards
        (6.4x less interconnect traffic than one-hot), embed each
        incoming shard into the poisoned db twin (O(shard_rows * K) work
        per step — negligible against the kernel's O(b_loc * shard_rows
        * K) contraction), and run min2_scan_pallas per step. Per-step
        keys are shard-local; they decode to (dist, index) and fold into
        explicit pair carries with the fused tie count, so the output
        is the pair-handle format regardless of the shift mode."""
        from smafa_tpu.ops import pallas_scan as PS

        seq_len, shift = self.seq_len, self.shift
        n_d, shard_rows = self.n_d, self.shard_rows
        interpret = PS.interpret_requested()
        with_count = PS.min2_count_enabled()
        tiles = PS.pick_min2_tiles(b // n_d, shard_rows, interpret)

        def shard_fn(q_emb, db_shard, n_windows):
            me = jax.lax.axis_index("d").astype(jnp.int32)
            fwd = [(j, (j + 1) % n_d) for j in range(n_d)]
            b_loc = q_emb.shape[0]
            big = jnp.int32(2**31 - 1)
            mask = jnp.int32((1 << shift) - 1)
            init = (jnp.full((b_loc,), D.BIG, jnp.int32),
                    jnp.full((b_loc,), big, jnp.int32),
                    jnp.full((b_loc,), jnp.int32(-1), jnp.int32),
                    jnp.zeros((b_loc,), jnp.int32))

            def body(i, state):
                (d, il, ih, cnt), db_cur = state
                owner = (me - i) % n_d
                off = owner * shard_rows
                emb, base = PS.embed_db_twin(db_cur, seq_len, n_windows - off)
                outs = PS.min2_scan_pallas(
                    q_emb, emb, base, shift, tiles,
                    interpret=interpret, with_count=with_count,
                )
                lo, hi = outs[0], outs[1]
                c = outs[2] if with_count else cnt
                ds = lo >> shift
                empty = ds > seq_len  # all-padding shard: sentinel dist
                ds = jnp.where(empty, D.BIG, ds)
                ils = jnp.where(empty, big, (lo & mask) + off)
                ihs = jnp.where(empty, jnp.int32(-1),
                                (shard_rows - 1 - (hi & mask)) + off)
                better = ds < d
                tie = ds == d
                if with_count:
                    cnt = jnp.where(better, c,
                                    jnp.where(tie, cnt + c, cnt))
                il = jnp.where(better, ils,
                               jnp.where(tie, jnp.minimum(il, ils), il))
                ih = jnp.where(better, ihs,
                               jnp.where(tie, jnp.maximum(ih, ihs), ih))
                d = jnp.minimum(d, ds)
                db_nxt = jax.lax.cond(
                    i < n_d - 1,
                    lambda x: jax.lax.ppermute(x, "d", fwd),
                    lambda x: x, db_cur,
                )
                return ((d, il, ih, cnt), db_nxt)

            (d, il, ih, cnt), _ = jax.lax.fori_loop(
                0, n_d, body, (init, db_shard)
            )
            (d2, il2), (_, ih2) = D.min2_pair_finish((d, il, ih))
            rows = [d2, il2, ih2] + ([cnt] if with_count else [])
            return jnp.stack(rows)  # one fetch

        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P("d", None), P("d", None), P()),
            out_specs=P(None, "d"),
            check_vma=False,
        )
        seq_len_ = self.seq_len

        @jax.jit
        def run(q_codes, db_oh, n_windows):
            return {"pair": mapped(PS.embed_query(q_codes, seq_len_),
                                   db_oh, n_windows)}

        return run

    def _build(self, b: int):
        from smafa_tpu.ops import pallas_scan as PS

        if PS.min2_eligible(self.seq_len, self.db_oh.shape[1],
                            b // self.n_d, self.shard_rows,
                            self.n_windows, b):
            return self._build_pallas_min2(b)

        shift, span = self.shift, self.wp

        if self._min2_pairs:
            def shard_fn(q_oh, db_shard, n_windows):
                carry = self._ring_sweep(
                    q_oh, db_shard, n_windows,
                    D.min2_pair_init(q_oh.shape[0]),
                    lambda c, dist, lidx, n_valid, off:
                        D.min2_pair_chunk_update(
                            c, dist, lidx, n_valid, off + lidx
                        ),
                )
                (d, il), (_, ih) = D.min2_pair_finish(carry)
                return jnp.stack([d, il, ih])  # one fetch

            fn = self._jit_mapped(
                shard_fn, (P("d", None), P("d", None), P()),
                P(None, "d"),
            )

            def run(q_codes, db_oh, n_windows):
                return {"pair": fn(q_codes, db_oh, n_windows)}

            return run

        def shard_fn(q_oh, db_shard, n_windows):
            b_loc = q_oh.shape[0]
            init = (
                jnp.full((b_loc,), BIG_KEY, jnp.int32),
                jnp.full((b_loc,), BIG_KEY, jnp.int32),
            )

            def fold(carry, dist, lidx, n_valid, off):
                return D.min2_chunk_update(
                    carry, dist, lidx, n_valid, off + lidx, shift, span,
                    self.seq_len + 1,
                )

            lo, hi = self._ring_sweep(q_oh, db_shard, n_windows, init, fold)
            return jnp.stack([lo, hi])  # one fetch

        fn = self._jit_mapped(
            shard_fn, (P("d", None), P("d", None), P()), P(None, "d")
        )

        def run(q_codes, db_oh, n_windows):
            return {"keys": fn(q_codes, db_oh, n_windows)}

        return run

    def _build_hist(self, b: int):
        seq_len = self.seq_len

        def shard_fn(q_oh, db_shard, n_windows):
            init = jnp.zeros((q_oh.shape[0], seq_len + 1), jnp.int32)

            def fold(carry, dist, lidx, n_valid, off):
                return D.hist_chunk_update(carry, dist, lidx, n_valid, seq_len)

            return self._ring_sweep(q_oh, db_shard, n_windows, init, fold)

        return self._jit_mapped(
            shard_fn, (P("d", None), P("d", None), P()), P("d", None)
        )

    def _build_tcount(self, b: int):
        """Per-row count at dist <= t[row] over one ring rotation — the
        best-hit tie-count pass (t = row minimum; -1 disables)."""
        def shard_fn(q_oh, db_shard, n_windows, t):
            b_loc = q_oh.shape[0]
            init = (
                jnp.zeros((b_loc,), jnp.int32),
                jnp.full((b_loc,), -1, jnp.int32),
            )

            def fold(carry, dist, lidx, n_valid, off):
                return D.stats_chunk_update(carry, dist, lidx, n_valid, t)

            cnt, _ = self._ring_sweep(q_oh, db_shard, n_windows, init, fold)
            return cnt

        return self._jit_mapped(
            shard_fn, (P("d", None), P("d", None), P(), P("d")), P("d")
        )

    def _build_kstats(self, b: int):
        """Multi-probe partition-search cutoff stats (the shipped
        K-mode phase A; SMAFA_TPU_KMODE_HIST=1 restores the histogram
        for short windows)."""
        seq_len = self.seq_len

        def shard_fn(q_oh, db_shard, n_windows, k, maxdiv):
            b_loc = q_oh.shape[0]

            def scan_statsN(ts):
                init = (
                    jnp.zeros((D.KSTATS_PROBES, b_loc), jnp.int32),
                    jnp.full((b_loc,), -1, jnp.int32),
                )

                def fold(carry, dist, lidx, n_valid, off):
                    return D.statsN_chunk_update(carry, dist, lidx,
                                                 n_valid, ts)

                return self._ring_sweep(q_oh, db_shard, n_windows, init, fold)

            return D.kmode_phase1(scan_statsN, k, maxdiv, n_windows,
                                  seq_len, b_loc)

        return self._jit_mapped(
            shard_fn, (P("d", None), P("d", None), P(), P(), P()),
            (P("d"), P("d")),
        )

    def _build_compact(self, b: int, t_cap: int):
        chunk, wp = self.chunk, self.wp
        pack = D._pack_mode()  # program cache keys on this (hitops._program)

        def shard_fn(q_oh, db_shard, n_windows, thresh):
            b_loc = q_oh.shape[0]
            wpc = D.mask_words_per_chunk(chunk)
            init = jnp.zeros((b_loc, (wp // chunk) * wpc), jnp.uint32)

            def fold(mask, dist, lidx, n_valid, off):
                # The sweep visits db shards in rotated (owner) order,
                # but the mask is laid out by GLOBAL chunk index, so the
                # extracted hits come out in (row, global index) order
                # regardless of rotation phase.
                gci = (off + lidx[0]) // chunk
                return D.mask_fold_chunk(mask, dist, lidx, n_valid, thresh,
                                         gci, pack)

            mask = self._ring_sweep(q_oh, db_shard, n_windows, init, fold)
            rows, idx, rc, total = D.extract_mask_hits(
                mask, jnp.int32(0), chunk, t_cap
            )
            # Global batch-row ids so the host merge is one lexsort.
            d_off = jax.lax.axis_index("d").astype(jnp.int32) * b_loc
            rows = jnp.where(rows >= 0, rows + d_off, -1)
            return rows, idx, rc, total[None]

        return self._jit_mapped(
            shard_fn, (P("d", None), P("d", None), P(), P("d")),
            (P("d"), P("d"), P("d"), P("d")),
        )

