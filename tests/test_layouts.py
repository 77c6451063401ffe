"""End-to-end engine parity under forced db layouts.

SMAFA_TPU_LAYOUT ∈ {sharded, ring, col} must produce byte-identical query
output on the 8-virtual-device CPU mesh — the determinism-across-layouts
gate (SURVEY.md §5 race-detection analogue), now covering the production
entry point rather than the runner layer only.
"""

import io

import numpy as np
import pytest

from smafa_tpu.engine.makedb import makedb
from smafa_tpu.engine.query import query

BASES = np.array(list("ACGTN-RYU"))


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")


def _random_seqs(rng, n, L, pool=None, dup=1):
    if pool is None:
        arr = BASES[rng.integers(0, len(BASES), size=(n, L))]
        return ["".join(row) for row in arr]
    picks = rng.integers(0, len(pool), size=n * dup)
    return [pool[p] for p in picks]


def _run_query(db, q, layout, monkeypatch, **kw):
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", layout)
    out = io.StringIO()
    query(db, q, out=out, **kw)
    return out.getvalue()


@pytest.mark.parametrize("mode", [
    {},                                        # best-hit
    {"max_divergence": 6},                     # best-hit + filter
    {"max_num_hits": 7},                       # K-mode
    {"max_num_hits": 50, "max_divergence": 10},
    {"max_num_hits": 5, "limit_per_sequence": 2},
])
def test_layouts_byte_identical(tmp_path, monkeypatch, mode):
    rng = np.random.default_rng(sum(map(hash, mode.items())) % 2**31)
    L = 24
    # duplicate-heavy db so best-hit rows carry many ties (> the 2-tie
    # phase-A fast path) and K-mode cutoffs tie across duplicates
    pool = _random_seqs(rng, 40, L)
    db_seqs = _random_seqs(rng, 160, L, pool=pool)
    q_seqs = _random_seqs(rng, 33, L, pool=pool) + _random_seqs(rng, 10, L)
    subj, qf = tmp_path / "s.fa", tmp_path / "q.fa"
    dbf = tmp_path / "d.smafadb"
    _write_fasta(subj, db_seqs)
    _write_fasta(qf, q_seqs)
    makedb(subj, dbf)

    ref = _run_query(dbf, qf, "sharded", monkeypatch, **mode)
    assert ref.count("\n") > 0
    for layout in ("ring", "col", "stream"):
        got = _run_query(dbf, qf, layout, monkeypatch, **mode)
        assert got == ref, f"layout {layout} diverged"


def test_tie_heavy_best_hit(tmp_path, monkeypatch):
    # Every db row is one of 3 sequences -> ~W/3 ties at the min per
    # query; exercises the compaction pass (phase B) on every layout.
    rng = np.random.default_rng(7)
    L = 12
    pool = _random_seqs(rng, 3, L)
    db_seqs = _random_seqs(rng, 300, L, pool=pool)
    q_seqs = pool + _random_seqs(rng, 5, L)
    subj, qf = tmp_path / "s.fa", tmp_path / "q.fa"
    dbf = tmp_path / "d.smafadb"
    _write_fasta(subj, db_seqs)
    _write_fasta(qf, q_seqs)
    makedb(subj, dbf)

    outs = {
        layout: _run_query(dbf, qf, layout, monkeypatch)
        for layout in ("sharded", "ring", "col", "stream")
    }
    ref = outs["sharded"]
    # ~100 ties per pool query -> thousands of lines
    assert ref.count("\n") >= 3 * 90
    assert outs["ring"] == ref
    assert outs["col"] == ref
    assert outs["stream"] == ref

    # literal oracle on one query: every line's subject decodes at min dist
    first_q_lines = [l for l in ref.splitlines() if l.startswith("0\t")]
    dists = {int(l.split("\t")[2]) for l in first_q_lines}
    assert len(dists) == 1
    subjects = [int(l.split("\t")[1]) for l in first_q_lines]
    assert subjects == sorted(subjects)


@pytest.mark.parametrize("layout", ["sharded", "stream"])
@pytest.mark.parametrize("mode", [
    {},                                        # best-hit, every row tied
    {"max_num_hits": 200},                     # K-mode, cutoff spans db
])
def test_monster_row_host_enumeration(tmp_path, monkeypatch, mode, layout):
    # A row whose exact hit count exceeds COMPACT_MAX must never reach a
    # device compaction dispatch (an uncapped t_cap would allocate
    # buffers past the module's own bound); it is enumerated host-side.
    # Shrink the cap so an ordinary test db trips the path, and verify
    # byte-parity against the unclamped run.
    from smafa_tpu.parallel import hitops

    rng = np.random.default_rng(11)
    L = 12
    pool = _random_seqs(rng, 2, L)
    db_seqs = _random_seqs(rng, 120, L, pool=pool)  # ~60 ties per pool row
    q_seqs = pool + _random_seqs(rng, 3, L)
    subj, qf = tmp_path / "s.fa", tmp_path / "q.fa"
    dbf = tmp_path / "d.smafadb"
    _write_fasta(subj, db_seqs)
    _write_fasta(qf, q_seqs)
    makedb(subj, dbf)

    ref = _run_query(dbf, qf, layout, monkeypatch, **mode)
    assert ref.count("\n") >= 100
    monkeypatch.setattr(hitops, "COMPACT_MAX", 16)
    calls = []
    orig = hitops.HitModesMixin._host_enumerate_row

    def spy(self, q_row, thresh):
        calls.append(thresh)
        return orig(self, q_row, thresh)

    monkeypatch.setattr(hitops.HitModesMixin, "_host_enumerate_row", spy)
    got = _run_query(dbf, qf, layout, monkeypatch, **mode)
    assert got == ref
    assert calls, "host enumeration path was not exercised"


@pytest.mark.parametrize("layout", ["sharded", "ring", "col", "stream"])
@pytest.mark.parametrize("mode", [
    {},                                        # best-hit (tie-heavy)
    {"max_num_hits": 40},                      # K-mode
])
def test_mask_budget_row_slicing(tmp_path, monkeypatch, layout, mode):
    # Large-batch compaction against a huge db must row-slice so one
    # dispatch's [rows, wp/32] hit mask stays under MASK_WORDS_BUDGET
    # (at 16384 x 10M the unsliced mask is 20 GB and its flat index
    # space overflows int32). Shrink the budget so a toy db trips the
    # path and verify byte-parity with the unsliced run.
    from smafa_tpu.parallel import hitops

    rng = np.random.default_rng(13)
    L = 10
    pool = _random_seqs(rng, 4, L)
    db_seqs = _random_seqs(rng, 200, L, pool=pool)
    q_seqs = pool + _random_seqs(rng, 20, L)
    subj, qf = tmp_path / "s.fa", tmp_path / "q.fa"
    dbf = tmp_path / "d.smafadb"
    _write_fasta(subj, db_seqs)
    _write_fasta(qf, q_seqs)
    makedb(subj, dbf)

    ref = _run_query(dbf, qf, layout, monkeypatch, **mode)
    assert ref.count("\n") >= 100
    # wp/32 words per row ~ 8-64 here; a 256-word budget forces a row
    # cap of 64 (the floor), slicing the 24-row batch... so drop further
    # via the floor: patch the cap method instead for a deterministic
    # tiny slice size.
    monkeypatch.setattr(hitops.HitModesMixin, "_mask_row_cap",
                        lambda self: 5)
    got = _run_query(dbf, qf, layout, monkeypatch, **mode)
    assert got == ref


@pytest.mark.parametrize("mode", ["best", "kmode"])
def test_segmented_compaction(monkeypatch, mode):
    # Huge dbs sweep ONE compact program (traced segment offset) over
    # the rows so the [b, seg/32] mask — compile-time and runtime — is
    # db-size-independent. Force a tiny segment + chunk so a toy db
    # exercises the sweep, and verify parity with the unsegmented run.
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(17)
    L = 10
    pool = rng.integers(0, 5, size=(5, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 5, 300)]  # tie-heavy
    q = np.concatenate([pool, rng.integers(0, 5, size=(9, L)).astype(np.uint8)])

    plain = sharded.ScanRunner(codes, L, mesh=sharded.build_mesh(1, 1),
                               chunk=16)
    assert plain._compact_seg is None
    monkeypatch.setenv("SMAFA_TPU_COMPACT_SEG", "64")
    segd = sharded.ScanRunner(codes, L, mesh=sharded.build_mesh(1, 1),
                              chunk=16)
    assert segd._compact_seg == 64 and segd.wp % 64 == 0

    if mode == "best":
        a = plain.best_hit(q)
        b = segd.best_hit(q)
    else:
        a = plain.kmode_flat(q, 60, None)
        b = segd.kmode_flat(q, 60, None)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    if mode == "best":
        assert int(a[1].sum()) >= 100  # ties really enumerated


def test_stream_multi_slab_parity():
    # The out-of-core layout (parallel/slab.py) folds per-slab scans into
    # carried accumulators; with several slabs the merges (packed-key
    # min, histogram sum, compaction concat) must reproduce the resident
    # runner exactly — best-hit with heavy ties, K-mode with cutoff
    # ties, and the min2 cluster primitive.
    from smafa_tpu.parallel import sharded, slab

    rng = np.random.default_rng(23)
    L = 10
    pool = rng.integers(0, 5, size=(4, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 4, 300)]
    q = np.concatenate([pool, rng.integers(0, 5, size=(12, L)).astype(np.uint8)])

    ref = sharded.ScanRunner(codes, L, mesh=sharded.build_mesh(1, 1), chunk=16)
    st = slab.SlabStreamRunner(codes, L, slab_rows=48, chunk=16)
    assert st.n_slabs >= 6 and st.db_oh is None

    for a, b in zip(ref.best_hit(q), st.best_hit(q)):
        assert np.array_equal(a, b)
    for a, b in zip(ref.best_hit(q, max_divergence=3),
                    st.best_hit(q, max_divergence=3)):
        assert np.array_equal(a, b)
    for a, b in zip(ref.kmode_flat(q, 25, 4), st.kmode_flat(q, 25, 4)):
        assert np.array_equal(a, b)
    for a, b in zip(ref.kmode_flat(q, 1000, None), st.kmode_flat(q, 1000, None)):
        assert np.array_equal(a, b)  # K > n_windows rule
    for a, b in zip(ref.min2(q), st.min2(q)):
        assert np.array_equal(a, b)


def test_stream_kstats_long_window_parity(monkeypatch):
    # For seq_len >= HIST_MAX the stream layout's K-mode phase A is a
    # host-driven binary search mirroring ops.distance.kmode_phase1;
    # force it on short windows and compare against the (unpatched)
    # histogram result.
    from smafa_tpu.ops import distance as D
    from smafa_tpu.parallel import slab

    rng = np.random.default_rng(29)
    L = 9
    pool = rng.integers(0, 5, size=(3, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 3, 150)]
    q = np.concatenate([pool, rng.integers(0, 5, size=(5, L)).astype(np.uint8)])

    st = slab.SlabStreamRunner(codes, L, slab_rows=64, chunk=32)
    ref_out = st.kmode_flat(q, 13, 5)            # histogram phase A
    ref_unbounded = st.kmode_flat(q, 4, None)
    monkeypatch.setattr(D, "HIST_MAX", 1)        # force the kstats path
    for a, b in zip(ref_out, st.kmode_flat(q, 13, 5)):
        assert np.array_equal(a, b)
    for a, b in zip(ref_unbounded, st.kmode_flat(q, 4, None)):
        assert np.array_equal(a, b)


def test_stream_auto_selection(monkeypatch):
    # choose_layout picks the out-of-core layout exactly when the one-hot
    # db would overflow the reported device memory.
    from smafa_tpu.parallel import select

    monkeypatch.delenv("SMAFA_TPU_LAYOUT", raising=False)
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 20))
    assert select.choose_layout(100_000, 60) == "stream"
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 45))
    assert select.choose_layout(100_000, 60) == "sharded"
    # pathological key-packing regime keeps the exact top-M fallback
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 20))
    assert select.choose_layout(2**30, 2**20) == "sharded"


def test_stream_codes_resident_tier(monkeypatch):
    # When the uint8 code slabs fit on device they are uploaded once and
    # cached (zero per-batch PCIe); results must match the re-streaming
    # tier exactly, and repeated scans must reuse the same cached buffers.
    from smafa_tpu.parallel import slab

    rng = np.random.default_rng(31)
    L = 10
    pool = rng.integers(0, 5, size=(4, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 4, 200)]
    q = np.concatenate([pool, rng.integers(0, 5, size=(8, L)).astype(np.uint8)])

    monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT", "0")
    streaming = slab.SlabStreamRunner(codes, L, slab_rows=64, chunk=32)
    assert streaming._slab_cache is None
    ref = streaming.best_hit(q)

    monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT", "1")
    resident = slab.SlabStreamRunner(codes, L, slab_rows=64, chunk=32)
    assert resident._slab_cache is not None
    got = resident.best_hit(q)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    cached = list(resident._slab_cache)
    assert all(c is not None for c in cached)
    got2 = resident.best_hit(q)
    assert all(c2 is c for c2, c in zip(resident._slab_cache, cached))
    for a, b in zip(ref, got2):
        assert np.array_equal(a, b)

    # auto decision from reported device memory
    monkeypatch.delenv("SMAFA_TPU_SLAB_RESIDENT")
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 30))
    assert slab.SlabStreamRunner(codes, L, slab_rows=64,
                                 chunk=32)._slab_cache is not None
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(256))
    assert slab.SlabStreamRunner(codes, L, slab_rows=64,
                                 chunk=32)._slab_cache is None


@pytest.mark.parametrize("layout", ["sharded", "ring"])
@pytest.mark.parametrize("mode", [
    {},                                        # best-hit (tie-heavy)
    {"max_num_hits": 25, "max_divergence": 6},  # K-mode
])
def test_codes_resident_db_parity(tmp_path, monkeypatch, layout, mode):
    # The db is resident as uint8 channel codes by default (6.4x more
    # rows per device); scans expand per chunk
    # (distance.block_distances) and must stay byte-identical to the
    # one-hot-resident form (SMAFA_TPU_DB_CODES=0).
    rng = np.random.default_rng(37)
    L = 18
    pool = _random_seqs(rng, 5, L)
    db_seqs = _random_seqs(rng, 240, L, pool=pool)
    q_seqs = pool + _random_seqs(rng, 9, L)
    subj, qf = tmp_path / "s.fa", tmp_path / "q.fa"
    dbf = tmp_path / "d.smafadb"
    _write_fasta(subj, db_seqs)
    _write_fasta(qf, q_seqs)
    makedb(subj, dbf)

    monkeypatch.setenv("SMAFA_TPU_FORCE_SHARD", "1")  # real 8-device mesh
    monkeypatch.setenv("SMAFA_TPU_DB_CODES", "0")     # one-hot form
    ref = _run_query(dbf, qf, layout, monkeypatch, **mode)
    assert ref.count("\n") >= 100
    monkeypatch.delenv("SMAFA_TPU_DB_CODES")          # default = codes
    got = _run_query(dbf, qf, layout, monkeypatch, **mode)
    assert got == ref

    # and on the single-device program path
    monkeypatch.delenv("SMAFA_TPU_FORCE_SHARD")
    if layout == "sharded":
        monkeypatch.setenv("SMAFA_TPU_DB_CODES", "0")
        ref1 = _run_query(dbf, qf, layout, monkeypatch, **mode)
        monkeypatch.setenv("SMAFA_TPU_DB_CODES", "1")
        assert _run_query(dbf, qf, layout, monkeypatch, **mode) == ref1


def test_stream_beyond_global_key_budget(monkeypatch):
    # At 60 bp the GLOBAL packed key tops out near 33M rows; the stream
    # layout packs slab-locally and pair-merges, so construction must
    # succeed beyond that and auto-selection must route there (the
    # resident layouts would drop to the slow exact top-M fallback).
    from smafa_tpu.ops import distance as D
    from smafa_tpu.parallel import select, slab

    monkeypatch.delenv("SMAFA_TPU_LAYOUT", raising=False)
    monkeypatch.delenv("SMAFA_TPU_HBM_BYTES", raising=False)
    n, L = 40_000_000, 60
    base = np.zeros((1, L), np.uint8)
    codes = np.lib.stride_tricks.as_strided(base, (n, L), (0, 1))
    r = slab.SlabStreamRunner(codes, L)
    assert D.packing_shift(L, r.wp) is None      # global keys overflow
    assert r.shift is not None                   # slab-local keys fit
    # multi-device + unknown/ample capacity -> resident sharded pair
    # mode (all devices scan); one-hot past reported HBM -> stream.
    assert select.choose_layout(n, L) == "sharded"
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 45))
    assert select.choose_layout(n, L) == "sharded"
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 30))
    assert select.choose_layout(n, L) == "stream"
    monkeypatch.delenv("SMAFA_TPU_HBM_BYTES")
    # astronomical window lengths can't pack even slab-locally
    assert select.choose_layout(2**30, 2**20) == "sharded"


def test_sharded_pair_mode_beyond_key_budget(monkeypatch):
    # When GLOBAL indices overflow the 31-bit key on a multi-device
    # mesh, ScanRunner packs shard-locally and pair-merges across 'w'
    # with collectives. Fake the overflow threshold so a toy db trips
    # the path, and compare every hit mode against the normal run.
    from smafa_tpu.ops import distance as D
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(41)
    L = 10
    pool = rng.integers(0, 5, size=(4, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 4, 300)]
    q = np.concatenate([pool, rng.integers(0, 5, size=(9, L)).astype(np.uint8)])

    mesh = sharded.build_mesh()
    ref = sharded.ScanRunner(codes, L, mesh=mesh, chunk=16)
    assert not ref._min2_pair_mode()
    ref_best = ref.best_hit(q)
    ref_bestd = ref.best_hit(q, max_divergence=3)
    ref_k = ref.kmode_flat(q, 15, 4)
    ref_min2 = ref.min2(q)

    real = D.packing_shift

    def fake(seq_len, wp):
        return None if wp > 64 else real(seq_len, wp)

    monkeypatch.setattr(D, "packing_shift", fake)
    pr = sharded.ScanRunner(codes, L, mesh=mesh, chunk=16)
    assert pr.shard_rows <= 64 < pr.wp
    assert pr._min2_pair_mode() and pr._key_shift() is not None
    for a, b in zip(ref_best, pr.best_hit(q)):
        assert np.array_equal(a, b)
    for a, b in zip(ref_bestd, pr.best_hit(q, max_divergence=3)):
        assert np.array_equal(a, b)
    for a, b in zip(ref_k, pr.kmode_flat(q, 15, 4)):
        assert np.array_equal(a, b)
    for a, b in zip(ref_min2, pr.min2(q)):
        assert np.array_equal(a, b)


def test_ring_pair_mode_beyond_key_budget(monkeypatch):
    # The ring min2 sweep folds explicit (dist, index) pair carries when
    # global keys overflow — owners are visited in rotation (non-
    # monotonic global order), so the lexicographic tie rules matter.
    from smafa_tpu.ops import distance as D
    from smafa_tpu.parallel import ring, sharded

    rng = np.random.default_rng(43)
    L = 10
    pool = rng.integers(0, 5, size=(4, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 4, 300)]
    q = np.concatenate([pool, rng.integers(0, 5, size=(12, L)).astype(np.uint8)])

    oracle = sharded.ScanRunner(codes, L, mesh=sharded.build_mesh(1, 1),
                                chunk=16)
    ref_best = oracle.best_hit(q)
    ref_k = oracle.kmode_flat(q, 15, 4)
    ref_min2 = oracle.min2(q)

    real = D.packing_shift

    def fake(seq_len, wp):
        return None if wp > 64 else real(seq_len, wp)

    monkeypatch.setattr(D, "packing_shift", fake)
    rr = ring.RingScanRunner(codes, L, mesh=ring.build_ring_mesh(8), chunk=16)
    assert rr._min2_pairs and rr.shard_rows <= 64 < rr.wp
    for a, b in zip(ref_best, rr.best_hit(q)):
        assert np.array_equal(a, b)
    for a, b in zip(ref_k, rr.kmode_flat(q, 15, 4)):
        assert np.array_equal(a, b)
    for a, b in zip(ref_min2, rr.min2(q)):
        assert np.array_equal(a, b)


def test_col_pair_mode_beyond_key_budget(monkeypatch):
    # Long windows shrink the key's index budget; the column-sharded
    # min2 sweep must fold pair carries past it, byte-equal.
    from smafa_tpu.ops import distance as D
    from smafa_tpu.parallel import seqpar, sharded

    rng = np.random.default_rng(47)
    L = 10
    pool = rng.integers(0, 5, size=(4, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 4, 300)]
    q = np.concatenate([pool, rng.integers(0, 5, size=(12, L)).astype(np.uint8)])

    oracle = sharded.ScanRunner(codes, L, mesh=sharded.build_mesh(1, 1),
                                chunk=16)
    ref_best = oracle.best_hit(q)
    ref_k = oracle.kmode_flat(q, 15, 4)
    ref_min2 = oracle.min2(q)

    real = D.packing_shift

    def fake(seq_len, wp):
        return None if wp > 64 else real(seq_len, wp)

    monkeypatch.setattr(D, "packing_shift", fake)
    cr = seqpar.ColumnShardedScanRunner(
        codes, L, mesh=seqpar.build_col_mesh(8), chunk=16
    )
    assert cr._min2_pairs and cr.wp > 64
    for a, b in zip(ref_best, cr.best_hit(q)):
        assert np.array_equal(a, b)
    for a, b in zip(ref_k, cr.kmode_flat(q, 15, 4)):
        assert np.array_equal(a, b)
    for a, b in zip(ref_min2, cr.min2(q)):
        assert np.array_equal(a, b)


def test_kmode_hist_vs_stats_parity(monkeypatch):
    """The histogram K-mode phase A (SMAFA_TPU_KMODE_HIST=1) and the
    default binary-search stats phase must produce identical hit lists
    — cutoff ties, maxdiv caps, k > n_windows, all of it."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(71)
    L, n = 24, 500
    db = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    db[50] = db[10]
    q = rng.integers(0, 4, size=(19, L)).astype(np.uint8)
    q[:2] = db[10:12]
    r = sharded.ScanRunner(db, L, mesh=sharded.build_mesh(1, 1), chunk=64)
    for k, maxdiv in ((5, None), (99, 4), (1000, None), (2, 0)):
        a = r.kmode_flat(q, k, maxdiv)
        monkeypatch.setenv("SMAFA_TPU_KMODE_HIST", "1")
        rh = sharded.ScanRunner(db, L, mesh=sharded.build_mesh(1, 1),
                                chunk=64)
        b = rh.kmode_flat(q, k, maxdiv)
        monkeypatch.delenv("SMAFA_TPU_KMODE_HIST")
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"k={k}")
