"""Sequence-parallel scan: the window COLUMN axis sharded across devices.

SingleM windows are short (60 bp), but the framework supports arbitrary
uniform lengths; for very long windows a single device may not hold the
one-hot db (or the matmul becomes contraction-bound). This runner
shards the feature axis (L*5 one-hot columns) over a 'c' mesh axis: each
device computes a partial match count over its column slice, a ``psum``
over 'c' reassembles exact distances, and all selection state (packed-key
minima, histograms, compaction buffers) runs replicated — the
Hamming-distance analogue of sequence parallelism (SURVEY.md §2.2 SP row;
partial sums combine exactly because the dot product is linear over
column blocks).

Hit-mode orchestration is shared with the other layouts via
parallel.hitops.HitModesMixin; every device holds all query rows and
sees identical psum-merged distances, so outputs are replicated and no
cross-device merge is needed beyond the psum itself.
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


def build_col_mesh(n: int | None = None) -> Mesh:
    devices = np.array(jax.devices())
    n = n or len(devices)
    return Mesh(devices[:n], ("c",))


class ColumnShardedScanRunner(HitModesMixin):
    """Db resident with its one-hot feature axis sharded over 'c'."""

    def __init__(self, codes: np.ndarray, seq_len: int, mesh: Mesh | None = None,
                 chunk: int | None = None):
        self.seq_len = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        self._codes_host = codes  # K-mode host distance recompute
        self.mesh = mesh if mesh is not None else build_col_mesh()
        self.n_c = self.mesh.devices.shape[0]
        self.chunk = chunk or D.default_chunk(self.n_windows)

        padded = max(self.chunk, ((self.n_windows + self.chunk - 1) // self.chunk) * self.chunk)
        self.wp = padded
        # Long windows shrink the packed key's index budget (more dist
        # bits), so overflow is LIKELIER here than anywhere; the min2
        # sweep then folds explicit (dist, index) pair carries instead
        # of keys — no row-count ceiling. _key_shift still reports a
        # chunk-local shift so the hit-mode mixin proceeds.
        self.shift = D.packing_shift(self.seq_len, padded)
        self._min2_pairs = self.shift is None
        if self._min2_pairs:
            self.shift = D.packing_shift(self.seq_len, max(2, self.chunk))
        if self.shift is None:
            raise ValueError(
                f"seq_len {seq_len} overflows packed 31-bit keys at any "
                "span; use parallel.sharded.ScanRunner (exact top-M "
                "fallback) instead"
            )

        codes_p = codes
        if codes_p.shape[0] < padded:
            codes_p = np.pad(codes_p, [(0, padded - codes_p.shape[0]), (0, 0)])

        # Feature dim padded so it splits evenly over 'c' in 128-lane
        # multiples; zero pad columns are distance-neutral. The rank-4
        # embedding shards 4L+2 columns instead of 5L (a 1.25x cut in
        # sharded width and partial-dot work at long windows — exactly
        # this layout's regime): the db carries its channel-0 count in
        # column 4L and the query a constant 1 there (and vice versa in
        # column 4L+1), so `matches = dot` exactly and the psum over
        # column slices needs no epilogue correction regardless of
        # which shard owns the count columns.
        # channel-0 counts can exceed int8 at this layout's long
        # windows: spread them over ceil(L/127) correction columns
        # (each <= 127; the query carries 1 in each, so their dot
        # contribution sums back to zc exactly)
        self._zc_cols = -(-self.seq_len // 127)
        self._embed = (D.embed_active(self.seq_len)
                       and D.padded_embed_dim(self.seq_len)
                       >= 4 * self.seq_len + self._zc_cols)
        lp = (D.padded_embed_dim(self.seq_len) if self._embed
              else D.padded_feature_dim(self.seq_len))
        lane_groups = lp // D.LANE
        groups_per_dev = (lane_groups + self.n_c - 1) // self.n_c
        self.lp_sharded = groups_per_dev * self.n_c * D.LANE

        spec = NamedSharding(self.mesh, P(None, "c"))
        seq_len = self.seq_len
        pad_to = self.lp_sharded

        if self._embed:
            ncc = self._zc_cols

            @partial(jax.jit, static_argnames="is_db")
            def expand(c, is_db):
                if is_db:
                    emb, zc = D.expand_embed_db(c, seq_len)
                    for j in range(ncc):
                        part = jnp.clip(zc - 127 * j, 0, 127)
                        emb = emb.at[:, 4 * seq_len + j].set(
                            part.astype(jnp.int8)
                        )
                else:
                    emb = D.expand_embed_query(c, seq_len)
                    for j in range(ncc):
                        emb = emb.at[:, 4 * seq_len + j].set(jnp.int8(1))
                return jnp.pad(emb, [(0, 0), (0, pad_to - emb.shape[1])])

            self.db_oh = jax.jit(
                partial(expand, is_db=True), out_shardings=spec
            )(jax.device_put(codes_p))
            self._expand_q = partial(expand, is_db=False)
        else:
            @jax.jit
            def expand_oh(c):
                oh = D.expand_onehot(c, seq_len)
                return jnp.pad(oh, [(0, 0), (0, pad_to - oh.shape[1])])

            self.db_oh = jax.jit(
                expand_oh, out_shardings=spec
            )(jax.device_put(codes_p))
            self._expand_q = expand_oh
        self.n_windows_dev = jnp.int32(self.n_windows)

    # -- HitModesMixin primitives ------------------------------------------

    def _pad(self, q_codes: np.ndarray):
        q_padded, nq, _b = D.pad_batch(q_codes, minimum=8)
        return q_padded, nq

    def _key_shift(self):
        return self.shift

    def _build_program(self, kind: str, b: int, shift: int | None = None,
                       t_cap: int | None = None):
        if kind == "min2":
            return self._build_min2(b)
        if kind == "hist":
            return self._build_hist(b)
        if kind == "kstats":
            return self._build_kstats(b)
        if kind == "tcount":
            return self._build_tcount(b)
        if kind == "compact":
            return self._build_compact(b, t_cap)
        raise KeyError(kind)

    # -- the column-sharded sweep ------------------------------------------

    def _col_sweep(self, q_oh, db_sh, n_windows, init, fold):
        """Chunked scan over db rows; distances are psum-reassembled from
        the per-device column-slice partial matches before folding.
        fold(carry, dist, lidx, n_valid, off=0) -> carry."""
        chunk, seq_len = self.chunk, self.seq_len
        n_chunks = self.wp // chunk

        def step(carry, off):
            block = jax.lax.dynamic_slice_in_dim(db_sh, off, chunk, axis=0)
            part = jax.lax.dot_general(
                q_oh, block,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            dist = seq_len - jax.lax.psum(part, "c")
            lidx = off + jnp.arange(chunk, dtype=jnp.int32)
            return fold(carry, dist, lidx, n_windows, 0), None

        offs = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
        carry, _ = jax.lax.scan(step, init, offs)
        return carry

    def _jit_mapped(self, shard_fn, n_extra: int, out_specs):
        in_specs = (P(None, "c"), P(None, "c"), P()) + (P(),) * n_extra
        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
        expand_q = self._expand_q

        @jax.jit
        def run(q_codes, db_oh, n_windows, *extra):
            q_oh = expand_q(q_codes)
            return mapped(q_oh, db_oh, n_windows, *extra)

        return run

    # -- compiled programs ---------------------------------------------------

    def _build_min2(self, b: int):
        shift, span = self.shift, self.wp

        if self._min2_pairs:
            def shard_fn(q_oh, db_sh, n_windows):
                carry = self._col_sweep(
                    q_oh, db_sh, n_windows,
                    D.min2_pair_init(q_oh.shape[0]),
                    lambda c, dist, lidx, n_valid, off:
                        D.min2_pair_chunk_update(c, dist, lidx, n_valid, lidx),
                )
                (d, il), (_, ih) = D.min2_pair_finish(carry)
                return jnp.stack([d, il, ih])  # one fetch

            fn = self._jit_mapped(shard_fn, 0, P(None, None))

            def run(q_codes, db_oh, n_windows):
                return {"pair": fn(q_codes, db_oh, n_windows)}

            return run

        def shard_fn(q_oh, db_sh, n_windows):
            b_loc = q_oh.shape[0]
            init = (
                jnp.full((b_loc,), BIG_KEY, jnp.int32),
                jnp.full((b_loc,), BIG_KEY, jnp.int32),
            )

            def fold(carry, dist, lidx, n_valid, off):
                return D.min2_chunk_update(
                    carry, dist, lidx, n_valid, lidx, shift, span,
                    self.seq_len + 1,
                )

            lo, hi = self._col_sweep(q_oh, db_sh, n_windows, init, fold)
            return jnp.stack([lo, hi])  # one fetch

        fn = self._jit_mapped(shard_fn, 0, P(None, None))

        def run(q_codes, db_oh, n_windows):
            return {"keys": fn(q_codes, db_oh, n_windows)}

        return run

    def _build_hist(self, b: int):
        seq_len = self.seq_len

        def shard_fn(q_oh, db_sh, n_windows):
            init = jnp.zeros((q_oh.shape[0], seq_len + 1), jnp.int32)

            def fold(carry, dist, lidx, n_valid, off):
                return D.hist_chunk_update(carry, dist, lidx, n_valid, seq_len)

            return self._col_sweep(q_oh, db_sh, n_windows, init, fold)

        return self._jit_mapped(shard_fn, 0, P(None, None))

    def _build_kstats(self, b: int):
        """Multi-probe partition-search cutoff stats — the K-mode
        phase A, and this layout's regime is exactly where the
        histogram alternative is widest (seq_len >= D.HIST_MAX)."""
        seq_len = self.seq_len

        def shard_fn(q_oh, db_sh, n_windows, k, maxdiv):
            b_loc = q_oh.shape[0]

            def scan_statsN(ts):
                init = (
                    jnp.zeros((D.KSTATS_PROBES, b_loc), jnp.int32),
                    jnp.full((b_loc,), -1, jnp.int32),
                )

                def fold(carry, dist, lidx, n_valid, off):
                    return D.statsN_chunk_update(carry, dist, lidx,
                                                 n_valid, ts)

                return self._col_sweep(q_oh, db_sh, n_windows, init, fold)

            return D.kmode_phase1(scan_statsN, k, maxdiv, n_windows,
                                  seq_len, b_loc)

        return self._jit_mapped(shard_fn, 2, (P(), P()))

    def _build_tcount(self, b: int):
        """Per-row count at dist <= t[row] (t = -1 disables) — the
        best-hit tie-count pass on the column-sharded layout."""
        def shard_fn(q_oh, db_sh, n_windows, t):
            b_loc = q_oh.shape[0]
            init = (
                jnp.zeros((b_loc,), jnp.int32),
                jnp.full((b_loc,), -1, jnp.int32),
            )

            def fold(carry, dist, lidx, n_valid, off):
                return D.stats_chunk_update(carry, dist, lidx, n_valid, t)

            cnt, _ = self._col_sweep(q_oh, db_sh, n_windows, init, fold)
            return cnt

        return self._jit_mapped(shard_fn, 1, P())

    def _build_compact(self, b: int, t_cap: int):
        chunk, wp = self.chunk, self.wp
        pack = D._pack_mode()  # program cache keys on this (hitops._program)

        def shard_fn(q_oh, db_sh, n_windows, thresh):
            b_loc = q_oh.shape[0]
            wpc = D.mask_words_per_chunk(chunk)
            init = jnp.zeros((b_loc, (wp // chunk) * wpc), jnp.uint32)

            def fold(mask, dist, lidx, n_valid, off):
                gci = lidx[0] // chunk
                return D.mask_fold_chunk(mask, dist, lidx, n_valid, thresh,
                                         gci, pack)

            mask = self._col_sweep(q_oh, db_sh, n_windows, init, fold)
            rows, idx, rc, total = D.extract_mask_hits(
                mask, jnp.int32(0), chunk, t_cap
            )
            return rows, idx, rc, total[None]

        return self._jit_mapped(shard_fn, 1, (P(), P(), P(), P()))
