"""Sharded query-vs-db scan over a ('q', 'w') device mesh.

The reference is single-threaded (reference lib.rs:232 serial query loop);
this module is the scale-out design it never had (SURVEY.md §2.2):

- 'w' axis = tensor-parallel over db rows: each device owns a contiguous
  row shard, scans it locally (chunked top-M with global indices), then the
  per-shard candidate lists are merged with an ``all_gather`` over 'w' —
  interconnect traffic of O(B * M) pairs instead of all-gathering the db.
- 'q' axis = data-parallel over the query batch: each q-group handles its
  slice of the batch independently.

The merge preserves the reference's exact (distance, subject_index)
ascending tie order: the all_gather stacks shards in mesh order (ascending
global row offset), and ``lax.top_k`` breaks ties toward lower positions.

Everything compiles once per (batch_bucket, M) and is cached.
"""

from __future__ import annotations

import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from smafa_tpu.ops import distance as D
from smafa_tpu.parallel.hitops import HitModesMixin

BIG_DIST = 2**30


# Below this many db rows, sharding + scan machinery costs more (compile
# time, collective latency) than it saves; use the direct single-device
# program. Override with SMAFA_TPU_FORCE_SHARD=1 (used by the sharded
# parity tests) or SMAFA_TPU_SHARD_THRESHOLD.
def _compact_seg_rows() -> int:
    """Db rows per single-device compaction segment. The compaction mask
    spans the whole scanned range, so at 10M+ rows an unsegmented
    program carries a multi-GB [b, wp/32] mask through thousands of scan
    steps — big enough to OOM-kill the AOT compiler, never mind HBM.
    Segmenting makes both the compile-time and runtime footprint
    independent of db size (the segment offset is traced, so ONE program
    serves every segment)."""
    return int(os.environ.get("SMAFA_TPU_COMPACT_SEG", str(1 << 21)))


def _shard_threshold() -> int:
    return int(os.environ.get("SMAFA_TPU_SHARD_THRESHOLD", 65536))


def _force_shard() -> bool:
    return os.environ.get("SMAFA_TPU_FORCE_SHARD", "") not in ("", "0")


def _db_codes_resident() -> bool:
    """Default ON (opt out with SMAFA_TPU_DB_CODES=0): keep the db
    resident as uint8 channel codes instead of one-hot int8 — seq_len vs
    padded-one-hot bytes per row (6.4x more rows per device at 60 bp,
    6.4x less interconnect traffic per ring rotation). Scans expand one
    chunk at a time inside the loop (distance.block_distances); results
    are byte-identical. The speed of the two forms is not yet measured
    on the H100. The column-sharded layout ignores it (it shards the
    one-hot feature axis itself)."""
    return os.environ.get("SMAFA_TPU_DB_CODES", "") != "0"


def _parse_mesh_env(n_devices: int) -> tuple[int, int]:
    spec = os.environ.get("SMAFA_TPU_MESH")
    if spec:
        nq, nw = (int(x) for x in spec.split(","))
        if nq * nw != n_devices:
            raise ValueError(
                f"SMAFA_TPU_MESH={spec} does not match {n_devices} visible devices"
            )
        return nq, nw
    return 1, n_devices


def build_mesh(n_q: int | None = None, n_w: int | None = None) -> Mesh:
    devices = np.array(jax.devices())
    if n_q is None or n_w is None:
        n_q, n_w = _parse_mesh_env(len(devices))
    return Mesh(devices[: n_q * n_w].reshape(n_q, n_w), ("q", "w"))


_bucket = D.bucket  # single bucketing policy (ops.distance)


def _with_split_sizes(fn, sizes):
    """Tag a compact program with the static split points of its flat
    packed output (rows, idx, row_counts, shard_totals) — jitted
    callables don't reliably take attributes, so wrap."""
    def call(*args):
        return fn(*args)

    call.split_sizes = sizes
    call.lower = fn.lower
    return call


def _bind_twin(jitted, runner):
    """``jitted`` with the runner's lazily built db twin appended to its
    operands. ``lower`` exposes the same program for ahead-of-time
    compilation (the twin is built on first use either way)."""
    def call(*args):
        return jitted(*args, *runner._db_emb())

    call.lower = lambda *args: jitted.lower(*args, *runner._db_emb())
    return call


class ScanRunner(HitModesMixin):
    """Holds a db resident on the mesh and runs exact scans in every hit
    mode (best-hit, K-mode, top-M, min2).

    Single-device and multi-device paths share the same code: a 1x1 mesh is
    just the degenerate case. Best-hit and K-mode host orchestration lives
    in HitModesMixin; this class supplies the mesh-specific compiled
    programs.
    """

    def _pad(self, q_codes: np.ndarray):
        q_padded, nq, _b = D.pad_batch(q_codes, multiple=self.n_q,
                                       minimum=max(16, self.n_q))
        return q_padded, nq

    def _key_shift(self):
        """Global packed-key shift, or — when the global index space
        overflows 31 bits on a multi-device mesh — the SHARD-local
        shift: min2 then packs per shard and pair-merges across 'w'
        with collectives (see _build_min2), so giant resident dbs keep
        packed-key speed instead of dropping to the top-M fallback.
        None only when even a shard span cannot pack."""
        shift = D.packing_shift(self.seq_len, max(self.wp, 2))
        if shift is not None or self.n_w <= 1:
            return shift
        return D.packing_shift(self.seq_len, max(self.shard_rows, 2))

    def _min2_pair_mode(self) -> bool:
        return (self.n_w > 1
                and D.packing_shift(self.seq_len, max(self.wp, 2)) is None)

    def _build_program(self, kind: str, b: int, shift: int | None = None,
                       t_cap: int | None = None):
        if kind == "min2":
            return self._build_min2(b, shift)
        if kind == "min2c":
            return self._build_min2c(b, shift)
        if kind == "hist":
            return self._build_hist(b)
        if kind == "kstats":
            return self._build_kstats(b, shift)
        if kind == "tcount":
            return self._build_tcount(b)
        if kind == "miditer":
            return self._build_miditer(b, shift, t_cap)
        if kind == "bestfull":
            return self._build_bestfull(b, shift, t_cap)
        if kind == "compact":
            return self._build_compact(b, t_cap)
        if kind == "compactd":
            return self._build_compactd(b, t_cap)
        if kind == "hitdist":
            return self._build_hitdist(b)
        raise KeyError(kind)

    def __init__(self, codes: np.ndarray, seq_len: int, mesh: Mesh | None = None,
                 chunk: int | None = None):
        from smafa_tpu.utils.platform import enable_compilation_cache

        enable_compilation_cache()
        self.seq_len = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        # Host-side view of the channel codes (often a memmap): K-mode
        # recomputes per-hit distances from it (hitops._host_distances).
        self._codes_host = codes
        if mesh is None:
            if jax.process_count() > 1:
                # Multi-host is SPMD over the full global mesh; a
                # single-device program would strand the other processes.
                mesh = build_mesh()
            elif self.n_windows < _shard_threshold() and not _force_shard():
                mesh = build_mesh(1, 1)
            else:
                mesh = build_mesh()
        self.mesh = mesh
        self.n_q = self.mesh.devices.shape[0]
        self.n_w = self.mesh.devices.shape[1]
        if jax.process_count() > 1 and self.n_q != 1:
            # q-sharded outputs would span processes (not fetchable on any
            # single host); multi-host batches are replicated instead and
            # the db shards over every device.
            raise ValueError(
                "multi-host runs require a (1, n_devices) mesh: the query "
                "batch is replicated and the db shards over 'w' "
                f"(got SMAFA_TPU_MESH={self.n_q},{self.n_w})"
            )
        # chunk: db rows per scan step (D.default_chunk: toward 16384 at
        # scale while keeping >=8 steps per shard so chunk-multiple
        # padding stays bounded).
        self.chunk = chunk or D.default_chunk(self.n_windows, self.n_w)
        if self.n_windows == 0:
            # Empty dbs never reach the device (callers guard); keep the
            # runner constructible so load-then-error paths still work.
            self.wp = 0
            self.shard_rows = 0
            self.db_oh = None
            self.n_windows_dev = jnp.int32(0)
            self._topm_cache = {}
            return
        stride = self.chunk * self.n_w
        padded = ((self.n_windows + stride - 1) // stride) * stride
        self._compact_seg: int | None = None
        if self.n_q == 1 and self.n_w == 1:
            seg = max(self.chunk,
                      (_compact_seg_rows() // self.chunk) * self.chunk)
            if padded > seg:
                # Segmented compaction slices the db with a traced
                # offset; rows must pad to a whole number of segments so
                # no segment's dynamic_slice clamps into its neighbor.
                padded = ((padded + seg - 1) // seg) * seg
                self._compact_seg = seg
        self.wp = padded
        self.shard_rows = padded // self.n_w

        db_spec = NamedSharding(self.mesh, P("w", None))
        if jax.process_count() > 1:
            # Multi-host: each addressable device gets exactly its own
            # w-shard (replicated over 'q'), padded per-shard and assembled
            # per-device so any mesh shape works. Only the row ranges this
            # host's devices own are ever read — with a memmap-backed db
            # (native format) the rest of the file is never paged in.
            local_ids = {d.id for d in jax.local_devices()}
            pieces = []
            for qi in range(self.n_q):
                for wi in range(self.n_w):
                    dev = self.mesh.devices[qi, wi]
                    if dev.id not in local_ids:
                        continue
                    lo = wi * self.shard_rows
                    hi = min((wi + 1) * self.shard_rows, self.n_windows)
                    shard = np.zeros(
                        (self.shard_rows, codes.shape[1]), dtype=np.uint8
                    )
                    if hi > lo:
                        shard[: hi - lo] = codes[lo:hi]
                    pieces.append(jax.device_put(shard, dev))
            codes_dev = jax.make_array_from_single_device_arrays(
                (padded, codes.shape[1]), db_spec, pieces
            )
        else:
            codes_p = codes
            if codes_p.shape[0] < padded:
                codes_p = np.pad(codes_p, [(0, padded - codes_p.shape[0]), (0, 0)])
            codes_dev = jax.device_put(codes_p, db_spec)
        if _db_codes_resident():
            self.db_oh = codes_dev  # scans expand per chunk
        else:
            expand = jax.jit(
                partial(D.expand_onehot, seq_len=self.seq_len),
                out_shardings=db_spec,
            )
            self.db_oh = expand(codes_dev)
        self.n_windows_dev = jnp.int32(self.n_windows)
        self._topm_cache: dict[tuple[int, int], callable] = {}

    # -- compiled program per (B, m) ---------------------------------------

    def _build(self, b: int, m: int):
        seq_len = self.seq_len
        chunk = self.chunk
        shard_rows = self.shard_rows
        n_w = self.n_w
        m_loc = min(m, shard_rows)

        if self.n_q == 1 and self.n_w == 1:
            # Single-device program: no shard_map wrapper (much cheaper to
            # compile, identical semantics).
            @jax.jit
            def run_single(q_codes, db_oh, n_windows):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                return D.topm_scan(q_oh, db_oh, n_windows, seq_len, m, chunk)

            return run_single

        def shard_fn(q_oh, db_shard, n_windows):
            off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
            n_valid_local = jnp.clip(n_windows - off, 0, shard_rows)
            d, i, mx = D.topm_scan(q_oh, db_shard, n_valid_local, seq_len, m_loc, chunk)
            i = jnp.where(d >= D.BIG, jnp.int32(2**31 - 1), i + off)
            if n_w > 1:
                d_all = jax.lax.all_gather(d, "w", axis=1, tiled=True)
                i_all = jax.lax.all_gather(i, "w", axis=1, tiled=True)
                neg, pos = jax.lax.top_k(-d_all, m)
                d = -neg
                i = jnp.take_along_axis(i_all, pos, axis=1)
                mx = jax.lax.pmax(mx, "w")
            return d, i, mx

        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P("q", None), P("w", None), P()),
            out_specs=(P("q", None), P("q", None), P("q")),
            check_vma=False,
        )

        @jax.jit
        def run(q_codes, db_oh, n_windows):
            q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
            return mapped(q_oh, db_oh, n_windows)

        return run

    def topm(self, q_codes: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact smallest-m (distance, index) per query row, plus per-row max.

        Returns host numpy arrays trimmed to the actual batch size.
        """
        self._require_windows()
        # bucket m to powers of two (extra columns are harmless BIG-padded
        # entries) so jit programs are reused across nearby m requests
        m = min(_bucket(min(m, self.n_windows)), self.wp)
        q_codes, nq, b = D.pad_batch(q_codes, multiple=self.n_q,
                                     minimum=max(16, self.n_q))
        key = (b, m)
        fn = self._topm_cache.get(key)
        if fn is None:
            fn = self._build(b, m)
            self._topm_cache[key] = fn
        d, i, mx = fn(q_codes, self.db_oh, self.n_windows_dev)
        d, i, mx = np.asarray(d), np.asarray(i), np.asarray(mx)
        return d[:nq], i[:nq], mx[:nq]

    # -- fused min/count path (best-hit + cluster hot path) ----------------

    def _pallas_min2_eligible(self, b: int) -> bool:
        """Ship the fused phase-A kernel (ops.pallas_scan.min2_scan_pallas)
        where its gate allows. On multi-device meshes each 'w' shard is
        a self-contained single-device sub-problem, so the same kernel
        runs per shard inside shard_map (keys globalize by offset adds;
        counts merge with one conditional psum). Gate shared with the
        ring layout — see ops.pallas_scan.min2_eligible."""
        from smafa_tpu.ops import pallas_scan as PS

        return self.db_oh is not None and PS.min2_eligible(
            self.seq_len, self.db_oh.shape[1], b // self.n_q,
            self.shard_rows, self.n_windows, b,
        )

    def _db_emb(self):
        """Lazily built db twin for the phase-A kernel: (int8 rank-4
        embedding, int32 distance base), padding rows poisoned to the
        sentinel distance (ops.pallas_scan.embed_db_twin) — the codes
        stay resident for every other program. Sharded over 'w' exactly
        like the codes, so each device's shard feeds its local kernel
        call."""
        twin = getattr(self, "_db_emb_cache", None)
        if twin is None:
            from smafa_tpu.ops import pallas_scan as PS

            twin = jax.jit(
                PS.embed_db_twin, static_argnames="seq_len",
                out_shardings=(NamedSharding(self.mesh, P("w", None)),
                               NamedSharding(self.mesh, P("w"))),
            )(self.db_oh, self.seq_len, self.n_windows_dev)
            if self.wp > self.n_windows:
                # The kernel's correctness rests on the twin's padding
                # rows being poisoned (sentinel distance base); an
                # unpoisoned twin would silently return wrong best-hits.
                # One-element check per build.
                base_last = int(np.asarray(twin[1][-1]))
                if base_last != self.seq_len + 1:
                    raise RuntimeError(
                        "db twin padding not poisoned (distance base of "
                        f"the last padding row is {base_last}, expected "
                        f"{self.seq_len + 1})"
                    )
            self._db_emb_cache = twin
        return twin

    def _build_min2_pallas(self, b: int, shift: int,
                           with_count: bool | None = None):
        """Fused phase-A program (any mesh shape). Single device: the
        kernel IS the program. Multi-device: one kernel call per 'w'
        shard inside shard_map; packed keys globalize with offset adds
        (global-shift mode) or decode to (dist, index) pairs and merge
        with pmin/pmax/psum (shard-local-shift mode, same contract as
        the XLA pair path). ``with_count`` None reads the env default;
        True is the tie-adaptive fused-count variant (hitops picks it
        when the recent tie fraction makes the separate tcount wave
        cost more than the fused epilogue)."""
        from smafa_tpu.ops import pallas_scan as PS

        seq_len = self.seq_len
        shard_rows = self.shard_rows
        span = self.wp
        interpret = PS.interpret_requested()
        if with_count is None:
            with_count = PS.min2_count_enabled()
        tiles = PS.pick_min2_tiles(b // self.n_q, shard_rows, interpret)

        if self.n_q == 1 and self.n_w == 1:
            @jax.jit
            def run_fused(q_codes, _db_oh, _n_windows, db_emb, db_base):
                # one program: the query embed fuses into the kernel's
                # input; validity rides in the poisoned twin, not a
                # kernel operand. Outputs stack into ONE array so
                # resolving costs one device->host transfer.
                outs = PS.min2_scan_pallas(
                    PS.embed_query(q_codes, seq_len), db_emb, db_base,
                    shift, tiles, interpret=interpret,
                    with_count=with_count,
                )
                return {"keys": jnp.stack(outs)}

            return _bind_twin(run_fused, self)

        pair_mode = self._min2_pair_mode()
        n_w = self.n_w

        def shard_fn(q_emb, db_emb_shard, db_base_shard):
            off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
            outs = PS.min2_scan_pallas(
                q_emb, db_emb_shard, db_base_shard, shift, tiles,
                interpret=interpret, with_count=with_count,
            )
            lo, hi = outs[0], outs[1]
            cnt = outs[2] if with_count else None
            # Kernel keys are SHARD-LOCAL (span = shard_rows). The
            # distance field decodes with one shift either way; counts
            # merge across shards by conditioning on the global min
            # (empty/padding shards sit at the sentinel distance
            # seq_len + 1 and never match the global min).
            d = lo >> shift
            if not pair_mode:
                # Globalize the index bits: lo + off (no carry — the
                # global index fits the field by the global-shift
                # precondition); hi's reversed index rebases by the
                # complementary offset.
                lo_g = jax.lax.pmin(lo + off, "w")
                hi_g = jax.lax.pmin(hi + (span - shard_rows - off), "w")
                if cnt is None:
                    return jnp.stack([lo_g, hi_g])
                dmin = lo_g >> shift
                cnt_g = jax.lax.psum(
                    jnp.where(d == dmin, cnt, 0), "w"
                )
                return jnp.stack([lo_g, hi_g, cnt_g])
            big = jnp.int32(2**31 - 1)
            mask = jnp.int32((1 << shift) - 1)
            empty = d > seq_len
            d = jnp.where(empty, jnp.int32(BIG_DIST), d)
            il = jnp.where(empty, big, (lo & mask) + off)
            ih = jnp.where(empty, jnp.int32(-1),
                           (shard_rows - 1 - (hi & mask)) + off)
            dmin = jax.lax.pmin(d, "w")
            il_g = jax.lax.pmin(jnp.where(d == dmin, il, big), "w")
            ih_g = jax.lax.pmax(jnp.where(d == dmin, ih, jnp.int32(-1)), "w")
            ih_g = jnp.where(ih_g < 0, big, ih_g)
            if cnt is None:
                return jnp.stack([dmin, il_g, ih_g])
            cnt_g = jax.lax.psum(jnp.where(d == dmin, cnt, 0), "w")
            return jnp.stack([dmin, il_g, ih_g, cnt_g])

        kind = "pair" if pair_mode else "keys"
        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P("q", None), P("w", None), P("w")),
            out_specs=P(None, "q"),
            check_vma=False,
        )

        @jax.jit
        def run_mapped(q_codes, _db_oh, _n_windows, db_emb, db_base):
            return {kind: mapped(PS.embed_query(q_codes, seq_len),
                                 db_emb, db_base)}

        return _bind_twin(run_mapped, self)

    def _build_min2c(self, b: int, shift: int):
        """Tie-adaptive phase A: the fused kernel with the count
        forced on (callers gate on _pallas_min2_eligible)."""
        return self._build_min2_pallas(b, shift, with_count=True)

    def _build_min2(self, b: int, shift: int):
        seq_len = self.seq_len
        chunk = self.chunk
        shard_rows = self.shard_rows
        span = self.wp

        if self._pallas_min2_eligible(b):
            return self._build_min2_pallas(b, shift)

        if self.n_q == 1 and self.n_w == 1:
            @jax.jit
            def run_single(q_codes, db_oh, n_windows):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                lo, hi = D.min2_scan(
                    q_oh, db_oh, n_windows, jnp.int32(0),
                    seq_len, shift, chunk, span,
                )
                return {"keys": jnp.stack([lo, hi])}

            return run_single

        pair_mode = self._min2_pair_mode()

        def shard_fn(q_oh, db_shard, n_windows):
            off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
            n_valid_local = jnp.clip(n_windows - off, 0, shard_rows)
            if not pair_mode:
                lo, hi = D.min2_scan(
                    q_oh, db_shard, n_valid_local, off,
                    seq_len, shift, chunk, span,
                )
                # Packed keys compare globally (the index fields are
                # global), so an elementwise pmin over the db axis is the
                # whole merge — O(B) int32s of traffic per key.
                return jnp.stack([jax.lax.pmin(lo, "w"),
                                  jax.lax.pmin(hi, "w")])
            # Global indices overflow the 31-bit key: pack SHARD-locally
            # (shift here is the shard-local shift from _key_shift),
            # unpack to global (dist, index) pairs, and merge across 'w'
            # with three collectives — pmin of dist, then lowest/highest
            # index among shards holding that min. Same O(B) traffic.
            lo, hi = D.min2_scan(
                q_oh, db_shard, n_valid_local, jnp.int32(0),
                seq_len, shift, chunk, shard_rows,
            )
            big = jnp.int32(2**31 - 1)
            mask = jnp.int32((1 << shift) - 1)
            # shards with no valid rows yield sentinel-distance keys
            # (dist seq_len+1; distance.min2_chunk_update) — detect by
            # decoded distance, robust under both key conventions
            empty = (lo == big) | ((lo >> shift) > seq_len)
            d = jnp.where(empty, jnp.int32(BIG_DIST), lo >> shift)
            il = jnp.where(empty, big, (lo & mask) + off)
            ih = jnp.where(empty, jnp.int32(-1),
                           (shard_rows - 1 - (hi & mask)) + off)
            dmin = jax.lax.pmin(d, "w")
            il_g = jax.lax.pmin(jnp.where(d == dmin, il, big), "w")
            ih_g = jax.lax.pmax(jnp.where(d == dmin, ih, jnp.int32(-1)), "w")
            ih_g = jnp.where(ih_g < 0, big, ih_g)
            return jnp.stack([dmin, il_g, ih_g])

        kind = "pair" if pair_mode else "keys"
        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P("q", None), P("w", None), P()),
            out_specs=P(None, "q"),
            check_vma=False,
        )

        @jax.jit
        def run(q_codes, db_oh, n_windows):
            q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
            return {kind: mapped(q_oh, db_oh, n_windows)}

        return run

    def _build_bestfull(self, b: int, shift: int, s_cap: int):
        """One-wave best-hit program: ONE dispatch computes the dual
        min2 keys, the fused exact tie count, AND the middle-tie
        enumeration for up to ``s_cap`` few-tie rows — everything the
        reference's best-hit print set needs (lib.rs:296-314) short of
        the heavy tail (> TIE_ITER_MAX ties, which still compacts).

        It replaces ~3 serial dispatch+fetch waves per batch (phase A
        -> tcount -> miditer || compact), each a full host round trip.
        Cost of the fusion: the count epilogue (a few extra integer
        ops per distance element) on every batch plus
        t_steps * s_cap / b scan-equivalents of middle enumeration
        (skipped entirely via lax.cond when no row needs it) — the
        trade only pays on high-latency links, so the one-wave path is
        selected by the measured dispatch-latency probe
        (platform.dispatch_latency_ms), not hardcoded.

        Pass 1 is the fused kernel (with_count forced on) when
        eligible, else the fused-count XLA scan (D.min2c_scan). Row
        selection (2 < cnt <= tie_max, under the traced max-divergence)
        is a static-size ``nonzero`` gather; selected rows run the
        dual bounded-min middle enumeration against the SAME resident
        db. Output: one flat int32 buffer
        [keys 3B | sel n_q*s_cap | mids 2*n_q*s_cap*T | n_need n_q] —
        one device->host transfer resolves the whole batch."""
        from smafa_tpu.parallel.hitops import HitModesMixin as HM

        seq_len, chunk, shard_rows = self.seq_len, self.chunk, self.shard_rows
        span = self.wp
        t_steps = HM.ONEWAVE_TSTEPS
        tie_max = 2 * t_steps + 2
        big = jnp.int32(2**31 - 1)
        maskbits = jnp.int32((1 << shift) - 1)
        use_pallas = self._pallas_min2_eligible(b)
        if use_pallas:
            from smafa_tpu.ops import pallas_scan as PS

            interpret = PS.interpret_requested()
            tiles = PS.pick_min2_tiles(b // self.n_q, shard_rows, interpret)

        def select(lo, hi, cnt, maxdiv):
            """Rows needing on-device middle enumeration, from the
            (replicated) global keys: found, within max-divergence,
            tied, 2 < cnt <= tie_max. ``sel`` is the first s_cap such
            rows ascending (q-group-local); slots past n_need carry
            inert cursors (floor = 2^31-1 scans nothing)."""
            d = lo >> shift
            il = lo & maskbits
            ih = span - 1 - (hi & maskbits)
            flag = ((d <= jnp.minimum(maxdiv, jnp.int32(seq_len)))
                    & (il != ih) & (cnt > 2) & (cnt <= tie_max))
            sel = jnp.nonzero(flag, size=s_cap, fill_value=0)[0].astype(jnp.int32)
            n_need = jnp.sum(flag.astype(jnp.int32))
            vsel = jnp.arange(s_cap, dtype=jnp.int32) < n_need
            floor = jnp.where(vsel, jnp.take(il, sel), big)
            ceil = jnp.where(vsel, jnp.take(ih, sel), jnp.int32(-1))
            dstar = jnp.where(vsel, jnp.take(d, sel), jnp.int32(-1))
            return sel, n_need, floor, ceil, dstar

        if self.n_q == 1 and self.n_w == 1:
            def tail(q_oh, db_oh, n_windows, lo, hi, cnt, maxdiv):
                sel, n_need, floor, ceil, dstar = select(lo, hi, cnt, maxdiv)
                q_sub = jnp.take(q_oh, sel, axis=0)

                def do_mid(_):
                    return D.miditer_scan(
                        q_sub, db_oh, n_windows, floor, ceil, dstar,
                        seq_len, shift, chunk, t_steps,
                    )

                def no_mid(_):
                    z = jnp.full((s_cap, t_steps), -1, jnp.int32)
                    return z, z

                ml, mh = jax.lax.cond(n_need > 0, do_mid, no_mid, None)
                return jnp.concatenate([
                    lo, hi, cnt, sel, ml.reshape(-1), mh.reshape(-1),
                    jnp.reshape(n_need, (1,)),
                ])

            if use_pallas:
                @jax.jit
                def run_fused(q_codes, db_oh, n_windows, maxdiv, db_emb,
                              db_base):
                    lo, hi, cnt = PS.min2_scan_pallas(
                        PS.embed_query(q_codes, seq_len), db_emb, db_base,
                        shift, tiles, interpret=interpret, with_count=True,
                    )
                    q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                    return tail(q_oh, db_oh, n_windows, lo, hi, cnt, maxdiv)

                return _with_split_sizes(
                    _bind_twin(run_fused, self),
                    (3 * b, s_cap, 2 * s_cap * t_steps, 1),
                )

            @jax.jit
            def run_single(q_codes, db_oh, n_windows, maxdiv):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                lo, hi, cnt = D.min2c_scan(
                    q_oh, db_oh, n_windows, jnp.int32(0), seq_len, shift,
                    chunk, span,
                )
                return tail(q_oh, db_oh, n_windows, lo, hi, cnt, maxdiv)

            return _with_split_sizes(
                run_single, (3 * b, s_cap, 2 * s_cap * t_steps, 1)
            )

        # Multi-device mesh (global-key mode only; _bestfull_supported
        # gates on the global shift). Pass 1 merges exactly like
        # _build_min2 / _build_min2_pallas; selection runs on the
        # replicated merged keys (every shard computes the identical
        # sel, so the lax.cond branch agrees across the 'w' group and
        # its collectives stay collective); middle passes fold local
        # bounded minima and pmin-merge per step like _build_miditer.
        n_q = self.n_q

        def make_shard_fn(with_emb):
            def shard_fn(*args):
                if with_emb:
                    (q_oh, q_emb, db_shard, n_windows, maxdiv, db_emb_shard,
                     db_base_shard) = args
                else:
                    q_oh, db_shard, n_windows, maxdiv = args
                off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
                n_valid = jnp.clip(n_windows - off, 0, shard_rows)
                if with_emb:
                    lo, hi, cnt = PS.min2_scan_pallas(
                        q_emb, db_emb_shard, db_base_shard, shift, tiles,
                        interpret=interpret, with_count=True,
                    )
                    d_loc = lo >> shift
                    lo_g = jax.lax.pmin(lo + off, "w")
                    hi_g = jax.lax.pmin(hi + (span - shard_rows - off), "w")
                else:
                    lo, hi, cnt = D.min2c_scan(
                        q_oh, db_shard, n_valid, off, seq_len, shift,
                        chunk, span,
                    )
                    d_loc = lo >> shift
                    lo_g = jax.lax.pmin(lo, "w")
                    hi_g = jax.lax.pmin(hi, "w")
                dmin = lo_g >> shift
                cnt_g = jax.lax.psum(jnp.where(d_loc == dmin, cnt, 0), "w")
                sel, n_need, floor, ceil, dstar = select(
                    lo_g, hi_g, cnt_g, maxdiv
                )
                q_sub = jnp.take(q_oh, sel, axis=0)
                offsets = jnp.arange(shard_rows // chunk,
                                     dtype=jnp.int32) * chunk

                def one_pass(fl, cl):
                    lfl = jnp.clip(fl - off, -1, shard_rows)
                    lcl = jnp.clip(cl - off, 0, shard_rows)

                    def step(carry, coff):
                        dist = D.block_distances(q_sub, db_shard, coff,
                                                 chunk, seq_len)
                        lidx = coff + jnp.arange(chunk, dtype=jnp.int32)
                        return D.miditer_chunk_update(
                            carry, dist, lidx, n_valid, lidx, lfl, lcl,
                            shift, shard_rows, seq_len + 1,
                        ), None

                    init = (jnp.full((s_cap,), big, jnp.int32),
                            jnp.full((s_cap,), big, jnp.int32))
                    (lo2, hi2), _ = jax.lax.scan(step, init, offsets)
                    return (jax.lax.pmin(lo2 + off, "w"),
                            jax.lax.pmin(hi2 + (span - shard_rows - off),
                                         "w"))

                def body(t, state):
                    key_lo, key_hi = one_pass(state[0], state[1])
                    return D.miditer_update(state, key_lo, key_hi, dstar,
                                            shift, span, seq_len, t)

                def do_mid(_):
                    init = (floor, ceil,
                            jnp.full((s_cap, t_steps), -1, jnp.int32),
                            jnp.full((s_cap, t_steps), -1, jnp.int32))
                    _f, _c, ml, mh = jax.lax.fori_loop(0, t_steps, body,
                                                       init)
                    return ml, mh

                def no_mid(_):
                    z = jnp.full((s_cap, t_steps), -1, jnp.int32)
                    return z, z

                ml, mh = jax.lax.cond(n_need > 0, do_mid, no_mid, None)
                return (jnp.stack([lo_g, hi_g, cnt_g]),
                        sel[None, :], jnp.stack([ml, mh]),
                        jnp.reshape(n_need, (1, 1)))
            return shard_fn

        if use_pallas:
            mapped = jax.shard_map(
                make_shard_fn(True),
                mesh=self.mesh,
                in_specs=(P("q", None), P("q", None), P("w", None),
                          P(), P(), P("w", None), P("w")),
                out_specs=(P(None, "q"), P(None, "q"), P(None, "q", None),
                           P(None, "q")),
                check_vma=False,
            )

            @jax.jit
            def run_mapped(q_codes, db_oh, n_windows, maxdiv, db_emb,
                           db_base):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                q_emb = PS.embed_query(q_codes, seq_len)
                keys, sel, mids, nn = mapped(q_oh, q_emb, db_oh, n_windows,
                                             maxdiv, db_emb, db_base)
                return jnp.concatenate([
                    keys.reshape(-1), sel.reshape(-1), mids.reshape(-1),
                    nn.reshape(-1),
                ])

            run = _bind_twin(run_mapped, self)
        else:
            mapped = jax.shard_map(
                make_shard_fn(False),
                mesh=self.mesh,
                in_specs=(P("q", None), P("w", None), P(), P()),
                out_specs=(P(None, "q"), P(None, "q"), P(None, "q", None),
                           P(None, "q")),
                check_vma=False,
            )

            @jax.jit
            def run(q_codes, db_oh, n_windows, maxdiv):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                keys, sel, mids, nn = mapped(q_oh, db_oh, n_windows, maxdiv)
                return jnp.concatenate([
                    keys.reshape(-1), sel.reshape(-1), mids.reshape(-1),
                    nn.reshape(-1),
                ])

        return _with_split_sizes(
            run, (3 * b, n_q * s_cap, 2 * n_q * s_cap * t_steps, n_q)
        )

    def min2(self, q_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per row: (min distance, first argmin, unique-min flag).

        One fused packed-key pass — no top-k sort. ``unique`` is True when
        exactly one window attains the min distance (best-hit mode then
        needs no enumeration pass). Falls back to the exact top-M path
        when key packing would overflow 31 bits.
        """
        handle = self.min2_async(q_codes)
        if handle is None:
            d, i, _ = self.topm(q_codes, 1)
            return d[:, 0], i[:, 0], None
        return self.min2_result(handle)

    # -- best-hit phase B: the one-pass bitmask compaction ------------------

    def _compact_span_rows(self) -> int:
        if self._compact_seg is not None:
            # Segment sweep: the row cap budgets one SEGMENT's mask.
            return self._compact_seg
        return self.shard_rows if self.n_w > 1 else self.wp

    def _build_hitdist(self, n: int):
        """Per-hit distance recompute on device: paired gathers from the
        resident codes + one compare-sum. Single-device codes-resident
        only (see hitops._host_distances for the gate)."""
        seq_len = self.seq_len

        @jax.jit
        def run(q_codes, db_codes, rows, idx):
            qg = jnp.take(jnp.asarray(q_codes), rows, axis=0)[:, :seq_len]
            dg = jnp.take(db_codes, idx, axis=0)[:, :seq_len]
            return jnp.sum((qg != dg).astype(jnp.int32), axis=1)

        return run

    def _build_compactd(self, b: int, t_cap: int):
        """Compact with device-fused per-hit distances, packed one int32
        key per slot: (dist << shift) | idx, -1 unused. Output layout
        [keys t_cap | row_counts b | total 1] — the redundant rows array
        (reconstructable as repeat(row_ids, counts): the buffer is
        (row, idx)-major) and the separate hitdist round trip both
        disappear, so K-mode moves about a third of the hit bytes per
        batch in one fewer round trip. Single-device, codes-resident,
        global-shift only, no segment sweep (hitops._compactd_supported
        gates)."""
        seq_len, chunk = self.seq_len, self.chunk
        shift = D.packing_shift(seq_len, max(self.wp, 2))
        pack = D._pack_mode()

        @jax.jit
        def run_single(q_codes, db_oh, n_windows, thresh):
            q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
            keys, rc, total = D.compactd_scan(
                q_oh, q_codes, db_oh, n_windows, thresh, jnp.int32(0),
                seq_len, chunk, t_cap, pack, shift,
            )
            return jnp.concatenate([keys, rc, total[None]])

        return _with_split_sizes(run_single, (t_cap, b, 1))

    def _build_compact(self, b: int, t_cap: int):
        pack = D._pack_mode()  # program cache keys on this (hitops._program)
        seq_len = self.seq_len
        chunk = self.chunk
        shard_rows = self.shard_rows

        if self.n_q == 1 and self.n_w == 1:
            seg = self._compact_seg
            if seg is None:
                @jax.jit
                def run_single(q_codes, db_oh, n_windows, thresh):
                    q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                    rows, idx, rc, total = D.compact_scan(
                        q_oh, db_oh, n_windows, thresh, jnp.int32(0),
                        seq_len, chunk, t_cap, pack,
                    )
                    # one flat int32 buffer: ONE device->host transfer
                    return jnp.concatenate([rows, idx, rc, total[None]])

                return _with_split_sizes(run_single, (t_cap, t_cap, b, 1))

            # Huge db: ONE program per segment shape, swept over the db
            # with a traced row offset. Keeps the [b, seg/32] mask —
            # compile-time and runtime — independent of db size.
            @jax.jit
            def run_seg(q_codes, db_oh, n_windows, thresh, seg_off):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                block = jax.lax.dynamic_slice_in_dim(db_oh, seg_off, seg, 0)
                n_valid = jnp.clip(n_windows - seg_off, 0, seg)
                rows, idx, rc, total = D.compact_scan(
                    q_oh, block, n_valid, thresh, seg_off,
                    seq_len, chunk, t_cap, pack,
                )
                return jnp.concatenate([rows, idx, rc, total[None]])

            wp = self.wp

            def run_swept(q_codes, db_oh, n_windows, thresh):
                out_r, out_i, totals = [], [], []
                rc_sum = None
                # dispatch every segment first (the device pipelines
                # them); fetch each flat buffer once
                flats = [run_seg(q_codes, db_oh, n_windows, thresh,
                                 jnp.int32(off))
                         for off in range(0, wp, seg)]
                for flat in flats:
                    a = np.asarray(flat)
                    r, i = a[:t_cap], a[t_cap:2 * t_cap]
                    rc = a[2 * t_cap:2 * t_cap + b]
                    t = a[2 * t_cap + b:]
                    keep = r >= 0
                    out_r.append(r[keep])
                    out_i.append(i[keep])
                    rc_sum = rc if rc_sum is None else rc_sum + rc
                    totals.append(t)
                return (np.concatenate(out_r), np.concatenate(out_i),
                        rc_sum, np.concatenate(totals))

            # every segment runs the same program: lower one
            run_swept.lower = lambda q, db, n, th: run_seg.lower(
                q, db, n, th, jnp.int32(0))
            return run_swept

        n_w = self.n_w

        def shard_fn(q_oh, db_shard, n_windows, thresh):
            off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
            n_valid = jnp.clip(n_windows - off, 0, shard_rows)
            rows, idx, rc, total = D.compact_scan(
                q_oh, db_shard, n_valid, thresh, off, seq_len, chunk, t_cap,
                pack,
            )
            # Global batch-row ids so the host merge is one lexsort.
            q_off = jax.lax.axis_index("q").astype(jnp.int32) * q_oh.shape[0]
            rows = jnp.where(rows >= 0, rows + q_off, -1)
            total = total[None]
            if n_w > 1:
                # Row counts sum exactly over disjoint db shards; the
                # buffers replicate within the q-group so every process
                # holds the full result (multi-host fetches must be
                # addressable). Per-shard totals stay separate: validity
                # is per-shard (each shard owns its own t_cap buffer).
                rc = jax.lax.psum(rc, "w")
                rows = jax.lax.all_gather(rows, "w", axis=0, tiled=True)
                idx = jax.lax.all_gather(idx, "w", axis=0, tiled=True)
                total = jax.lax.all_gather(total, "w", axis=0, tiled=True)
            return rows, idx, rc, total

        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P("q", None), P("w", None), P(), P("q")),
            out_specs=(P("q"), P("q"), P("q"), P("q")),
            check_vma=False,
        )
        n_q = self.n_q

        @jax.jit
        def run(q_codes, db_oh, n_windows, thresh):
            q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
            rows, idx, rc, total = mapped(q_oh, db_oh, n_windows, thresh)
            return jnp.concatenate([rows, idx, rc, total])

        return _with_split_sizes(
            run, (n_q * n_w * t_cap, n_q * n_w * t_cap, b, n_q * n_w)
        )

    # -- sort-free K-mode (exact top-K with cutoff ties) -------------------
    #
    # Phase A: one histogram pass ([B, L+1] exact distance counts) — the
    # host reads the Kth-smallest distance, the per-row max, and the exact
    # hit count straight off its cumulative sum (reference cutoff rule,
    # lib.rs:253-265). For very long windows (seq_len >= D.HIST_MAX) the
    # histogram would be wider than it is worth and phase A falls back to
    # the fused binary-search count scans. Phase B: the same compaction
    # pass as best-hit, then a host lexsort into (distance, index) order.

    def _build_hist(self, b: int):
        seq_len = self.seq_len
        chunk = self.chunk
        shard_rows = self.shard_rows

        if self.n_q == 1 and self.n_w == 1:
            @jax.jit
            def run_single(q_codes, db_oh, n_windows):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                return D.hist_scan(q_oh, db_oh, n_windows, seq_len, chunk)

            return run_single

        def shard_fn(q_oh, db_shard, n_windows):
            off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
            n_valid = jnp.clip(n_windows - off, 0, shard_rows)
            h = D.hist_scan(q_oh, db_shard, n_valid, seq_len, chunk)
            return jax.lax.psum(h, "w")

        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P("q", None), P("w", None), P()),
            out_specs=P("q", None),
            check_vma=False,
        )

        @jax.jit
        def run(q_codes, db_oh, n_windows):
            q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
            return mapped(q_oh, db_oh, n_windows)

        return run

    def _build_kstats(self, b: int, shift: int):
        seq_len, chunk, shard_rows = self.seq_len, self.chunk, self.shard_rows

        if self.n_q == 1 and self.n_w == 1:
            @jax.jit
            def run_single(q_codes, db_oh, n_windows, k, maxdiv):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                eff, hits = D.kmode_stats_scan(
                    q_oh, db_oh, n_windows, k, maxdiv, seq_len, chunk
                )
                return jnp.stack([eff, hits])  # one fetch

            return run_single

        def shard_fn(q_oh, db_shard, n_windows, k, maxdiv):
            off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
            n_valid = jnp.clip(n_windows - off, 0, shard_rows)

            def scan_statsN(ts):
                cnt, mx = D._statsN_pass(q_oh, db_shard, n_valid, ts,
                                         seq_len, chunk)
                # ONE [P, B] psum merges all probe counts per pass
                return jax.lax.psum(cnt, "w"), jax.lax.pmax(mx, "w")

            return D.kmode_phase1(scan_statsN, k, maxdiv, n_windows,
                                  seq_len, q_oh.shape[0])

        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P("q", None), P("w", None), P(), P(), P()),
            out_specs=(P("q"), P("q")),
            check_vma=False,
        )

        @jax.jit
        def run(q_codes, db_oh, n_windows, k, maxdiv):
            q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
            eff, hits = mapped(q_oh, db_oh, n_windows, k, maxdiv)
            return jnp.stack([eff, hits])  # one fetch

        return run

    def _build_miditer(self, b: int, shift: int, t_steps: int):
        """All middle tied indices in ONE device program: t_steps dual
        bounded-min passes on device (distance.miditer_scan), enumerating
        from both ends of each row's tie range — replaces the round-3
        host-driven minfloor loop (one dispatch per tie). Global packed
        keys only (callers gate on the global shift)."""
        seq_len, chunk, shard_rows = self.seq_len, self.chunk, self.shard_rows
        span = self.wp

        if self.n_q == 1 and self.n_w == 1:
            @jax.jit
            def run_single(q_codes, db_oh, n_windows, floor, ceil, d_star):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                return jnp.stack(D.miditer_scan(
                    q_oh, db_oh, n_windows, floor, ceil, d_star,
                    seq_len, shift, chunk, t_steps,
                ))

            return run_single

        def shard_fn(q_oh, db_shard, n_windows, floor, ceil, d_star):
            off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
            n_valid = jnp.clip(n_windows - off, 0, shard_rows)
            b_loc = q_oh.shape[0]
            big_key = jnp.int32(2**31 - 1)
            offsets = jnp.arange(shard_rows // chunk, dtype=jnp.int32) * chunk

            def one_pass(fl, cl):
                # shard-local cursor rebase; keys carry local indices
                # packed with the GLOBAL shift, globalized by offset
                # adds (lo: +off; hi: reverse-index rebase) before the
                # cross-shard pmin — exactly the min2 mesh convention.
                lfl = jnp.clip(fl - off, -1, shard_rows)
                lcl = jnp.clip(cl - off, 0, shard_rows)

                def step(carry, coff):
                    dist = D.block_distances(q_oh, db_shard, coff, chunk,
                                             seq_len)
                    lidx = coff + jnp.arange(chunk, dtype=jnp.int32)
                    return D.miditer_chunk_update(
                        carry, dist, lidx, n_valid, lidx, lfl, lcl,
                        shift, shard_rows, seq_len + 1,
                    ), None

                init = (jnp.full((b_loc,), big_key, jnp.int32),
                        jnp.full((b_loc,), big_key, jnp.int32))
                (lo, hi), _ = jax.lax.scan(step, init, offsets)
                lo_g = jax.lax.pmin(lo + off, "w")
                hi_g = jax.lax.pmin(hi + (span - shard_rows - off), "w")
                return lo_g, hi_g

            def body(t, state):
                key_lo, key_hi = one_pass(state[0], state[1])
                return D.miditer_update(state, key_lo, key_hi, d_star,
                                        shift, span, seq_len, t)

            init = (floor, ceil,
                    jnp.full((b_loc, t_steps), -1, jnp.int32),
                    jnp.full((b_loc, t_steps), -1, jnp.int32))
            _, _, mids_lo, mids_hi = jax.lax.fori_loop(0, t_steps, body, init)
            return jnp.stack([mids_lo, mids_hi])

        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P("q", None), P("w", None), P(), P("q"), P("q"),
                      P("q")),
            out_specs=P(None, "q", None),
            check_vma=False,
        )
        seq_len_ = seq_len

        @jax.jit
        def run(q_codes, db_oh, n_windows, floor, ceil, d_star):
            q_oh = D.expand_query(q_codes, seq_len_, db_oh.shape[1])
            return mapped(q_oh, db_oh, n_windows, floor, ceil, d_star)

        return run

    def _build_tcount(self, b: int):
        """Per-row count of windows at dist <= t[row] (t = -1 disables a
        row) — one cheap epilogue pass. Best-hit uses it with t = the
        row minimum, where count(<= min) == count(== min): the exact tie
        count, so 2-tie rows resolve from the dual min2 keys alone."""
        seq_len, chunk, shard_rows = self.seq_len, self.chunk, self.shard_rows

        if self.n_q == 1 and self.n_w == 1:
            @jax.jit
            def run_single(q_codes, db_oh, n_windows, t):
                q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
                cnt, _ = D._stats_pass(q_oh, db_oh, n_windows, t, seq_len, chunk)
                return cnt

            return run_single

        def shard_fn(q_oh, db_shard, n_windows, t):
            off = jax.lax.axis_index("w").astype(jnp.int32) * shard_rows
            n_valid = jnp.clip(n_windows - off, 0, shard_rows)
            cnt, _ = D._stats_pass(q_oh, db_shard, n_valid, t, seq_len, chunk)
            return jax.lax.psum(cnt, "w")

        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P("q", None), P("w", None), P(), P("q")),
            out_specs=P("q"),
            check_vma=False,
        )

        @jax.jit
        def run(q_codes, db_oh, n_windows, t):
            q_oh = D.expand_query(q_codes, seq_len, db_oh.shape[1])
            return mapped(q_oh, db_oh, n_windows, t)

        return run

