"""Best-hit tie-count fast path (SMAFA_TPU_PAIR_COUNT).

When enabled, best_hit resolves 2-tie rows straight from the dual min2
keys after one tcount pass (count at <= min == tie count) and compacts
only >2-tie rows, exactly sized. Results must be identical to the
compaction-only path on every layout and every tie shape.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from smafa_tpu.core.alphabet import N_CHANNELS
from smafa_tpu.ops import distance as D


def _mk_db(rng, n, L, dup_spec):
    """db with planted tie structure: dup_spec = list of (row, copies)."""
    db = rng.integers(0, N_CHANNELS, size=(n, L), dtype=np.uint8)
    for src, copies in dup_spec:
        pos = rng.choice(n, size=copies, replace=False)
        db[pos] = db[src]
    return db


def _best_hit(runner_cls, codes, L, q, maxdiv, env, **kw):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        r = runner_cls(codes, L, **kw)
        res = r.best_hit(q, maxdiv)
        ties = r.collect_ties(q)
        return res, ties
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


LAYOUT_ENVS = [
    ("sharded-1x1", {}),
    ("sharded-mesh", {"SMAFA_TPU_FORCE_SHARD": "1"}),
]


@pytest.mark.parametrize("layout,extra_env", LAYOUT_ENVS)
@pytest.mark.parametrize("maxdiv", [None, 10])
def test_pair_count_parity_sharded(layout, extra_env, maxdiv):
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(42)
    L, n = 60, 700
    # tie shapes: exactly-2, exactly-3, and a 40-wide clump
    db = _mk_db(rng, n, L, [(5, 2), (9, 3), (11, 40)])
    q = rng.integers(0, N_CHANNELS, size=(33, L), dtype=np.uint8)
    q[0] = db[5]   # 2-tie exact hit
    q[1] = db[9]   # 3-tie exact hit
    q[2] = db[11]  # 40-tie exact hit
    a = _best_hit(sharded.ScanRunner, db, L, q, maxdiv,
                  {"SMAFA_TPU_PAIR_COUNT": "1", **extra_env})
    b = _best_hit(sharded.ScanRunner, db, L, q, maxdiv,
                  {"SMAFA_TPU_PAIR_COUNT": "0", **extra_env})
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1][1] == b[1][1]  # collect_ties lists


@pytest.mark.parametrize("runner", ["ring", "stream", "col"])
def test_pair_count_parity_other_layouts(runner):
    rng = np.random.default_rng(7)
    L, n = 60, 400
    db = _mk_db(rng, n, L, [(3, 2), (4, 5)])
    q = rng.integers(0, N_CHANNELS, size=(17, L), dtype=np.uint8)
    q[0] = db[3]
    q[1] = db[4]

    if runner == "ring":
        from smafa_tpu.parallel import ring

        cls = ring.RingScanRunner
        kw = {"mesh": ring.build_ring_mesh(4), "chunk": 32}
    elif runner == "stream":
        from smafa_tpu.parallel.slab import SlabStreamRunner

        cls = SlabStreamRunner
        kw = {"slab_rows": 128, "chunk": 32}
    else:
        from smafa_tpu.parallel import seqpar

        cls = seqpar.ColumnShardedScanRunner
        kw = {"chunk": 32}

    a = _best_hit(cls, db, L, q, None, {"SMAFA_TPU_PAIR_COUNT": "1"}, **kw)
    b = _best_hit(cls, db, L, q, None, {"SMAFA_TPU_PAIR_COUNT": "0"}, **kw)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1][1] == b[1][1]


def test_pair_count_gate():
    """Auto mode enables by span; env forces both ways."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(0)
    db = rng.integers(0, N_CHANNELS, size=(64, 60), dtype=np.uint8)
    r = sharded.ScanRunner(db, 60)
    assert r._compact_span_rows() < r.PAIR_COUNT_MIN_SPAN
    old = os.environ.pop("SMAFA_TPU_PAIR_COUNT", None)
    try:
        assert not r._pair_count_enabled()  # small span -> off
        os.environ["SMAFA_TPU_PAIR_COUNT"] = "1"
        assert r._pair_count_enabled()
        os.environ["SMAFA_TPU_PAIR_COUNT"] = "0"
        assert not r._pair_count_enabled()
    finally:
        if old is None:
            os.environ.pop("SMAFA_TPU_PAIR_COUNT", None)
        else:
            os.environ["SMAFA_TPU_PAIR_COUNT"] = old


def test_pair_count_fuzz_vs_oracle():
    """Randomized parity against the literal distance oracle."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(123)
    for trial in range(6):
        L = int(rng.integers(3, 20))
        n = int(rng.integers(5, 120))
        nq = int(rng.integers(1, 24))
        db = rng.integers(0, 3, size=(n, L), dtype=np.uint8)  # small alphabet -> many ties
        q = rng.integers(0, 3, size=(nq, L), dtype=np.uint8)
        maxdiv = int(rng.integers(0, L + 1)) if rng.random() < 0.5 else None

        os.environ["SMAFA_TPU_PAIR_COUNT"] = "1"
        try:
            r = sharded.ScanRunner(db, L)
            dist, counts, rows, idx = r.best_hit(q, maxdiv)
        finally:
            os.environ.pop("SMAFA_TPU_PAIR_COUNT", None)

        # literal oracle
        dmat = (q[:, None, :] != db[None, :, :]).sum(axis=2)
        for b in range(nq):
            dmin = dmat[b].min()
            want = np.nonzero(dmat[b] == dmin)[0]
            if maxdiv is not None and dmin > maxdiv:
                want = np.empty(0, np.int64)
            got = idx[rows == b]
            np.testing.assert_array_equal(got, want, err_msg=f"trial {trial} row {b}")
            assert counts[b] == want.size


def test_runner_pallas_min2_interpret_parity():
    """ScanRunner's fused-kernel phase-A integration (eligibility, db
    twin, key unpacking) — interpret mode so the CPU suite covers it."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(17)
    L, n = 60, 4096  # wp = 4096: a PALLAS_TILE_W multiple
    db = rng.integers(0, N_CHANNELS, size=(n, L), dtype=np.uint8)
    db[100] = db[7]
    db[4000] = db[7]
    q = rng.integers(0, N_CHANNELS, size=(33, L), dtype=np.uint8)
    q[0] = db[7]
    a = _best_hit(sharded.ScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PALLAS_MIN2": "interpret"}, chunk=2048)
    b = _best_hit(sharded.ScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PALLAS_MIN2": "0"}, chunk=2048)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1][1] == b[1][1]


@pytest.mark.parametrize("mesh_env", [
    {"SMAFA_TPU_FORCE_SHARD": "1"},                          # (1, 8)
    {"SMAFA_TPU_FORCE_SHARD": "1", "SMAFA_TPU_MESH": "2,4"},
])
def test_runner_pallas_min2_interpret_sharded_mesh(mesh_env):
    """Multi-device kernel phase A: the kernel runs per 'w'
    shard inside shard_map, keys globalize with offset adds, the fused
    tie count merges with a conditional psum — byte-equal to the XLA
    mesh path on the 8-device CPU mesh."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(57)
    L, n = 60, 4000  # wp pads to 4096 -> shard_rows 512 on (1,8)
    db = _mk_db(rng, n, L, [(5, 2), (9, 3), (11, 7)])
    db[3900] = db[5]  # cross-shard tie (lowest and highest index far apart)
    q = rng.integers(0, N_CHANNELS, size=(33, L), dtype=np.uint8)
    q[0] = db[5]
    q[1] = db[9]
    q[2] = db[11]
    env = {"SMAFA_TPU_PALLAS_MIN2": "interpret",
           "SMAFA_TPU_PALLAS_COUNT": "1", **mesh_env}
    a = _best_hit(sharded.ScanRunner, db, L, q, None, env, chunk=128)
    b = _best_hit(sharded.ScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PALLAS_MIN2": "0", **mesh_env}, chunk=128)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1][1] == b[1][1]
    # the env really selects the kernel on this mesh
    os.environ.update(env)
    try:
        r = sharded.ScanRunner(db, L, chunk=128)
        assert r.n_w > 1 and r._pallas_min2_eligible(64)
        handle = r.min_count_async(q)
        assert handle[6] is not None  # fused count rode along
    finally:
        for k in env:
            os.environ.pop(k, None)


def test_runner_pallas_min2_interpret_pair_mode(monkeypatch):
    """Kernel phase A in shard-local key (pair) mode: fake the packing
    overflow so shard-local keys + pair merge engage, interpret kernel
    vs the XLA pair path and the single-device oracle."""
    from smafa_tpu.ops import distance as D
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(61)
    L, n = 60, 4000
    db = _mk_db(rng, n, L, [(5, 2), (9, 4)])
    db[3900] = db[5]
    q = rng.integers(0, N_CHANNELS, size=(17, L), dtype=np.uint8)
    q[0] = db[5]
    q[1] = db[9]

    oracle = sharded.ScanRunner(db, L, mesh=sharded.build_mesh(1, 1),
                                chunk=128)
    ref = oracle.best_hit(q)
    ref_min2 = oracle.min2(q)

    real = D.packing_shift

    def fake(seq_len, wp):
        return None if wp > 512 else real(seq_len, wp)

    monkeypatch.setattr(D, "packing_shift", fake)
    monkeypatch.setenv("SMAFA_TPU_FORCE_SHARD", "1")
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "interpret")
    pr = sharded.ScanRunner(db, L, mesh=sharded.build_mesh(1, 8), chunk=128)
    assert pr._min2_pair_mode() and pr._pallas_min2_eligible(32)
    for a, b in zip(ref, pr.best_hit(q)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref_min2, pr.min2(q)):
        np.testing.assert_array_equal(a, b)


def test_ring_pallas_min2_interpret():
    """Kernel phase A on the ring layout: codes shards rotate, each step
    embeds + runs the kernel, pair carries fold with the fused count —
    equal to the XLA ring and the single-device oracle."""
    from smafa_tpu.parallel import ring, sharded

    rng = np.random.default_rng(67)
    L, n = 60, 4000
    db = _mk_db(rng, n, L, [(5, 2), (9, 3), (11, 6)])
    db[3900] = db[5]
    q = rng.integers(0, N_CHANNELS, size=(19, L), dtype=np.uint8)
    q[0] = db[5]
    q[1] = db[9]
    q[2] = db[11]
    kw = {"mesh": None, "chunk": 128}

    oracle = sharded.ScanRunner(db, L, mesh=sharded.build_mesh(1, 1),
                                chunk=128)
    ref = oracle.best_hit(q)
    a = _best_hit(ring.RingScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PALLAS_MIN2": "interpret"}, **kw)
    b = _best_hit(ring.RingScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PALLAS_MIN2": "0"}, **kw)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a[0], ref):
        np.testing.assert_array_equal(x, y)
    assert a[1][1] == b[1][1]


@pytest.mark.parametrize("L", [60, 90, 120])
def test_pallas_fused_count_fuzz(L):
    """Randomized tie-shape fuzz of the fused-count kernel path (single
    device AND the 8-device mesh, interpret) against the literal
    oracle, at window lengths where the rank-4 embedding is active."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(L)
    n = 1024
    db = rng.integers(0, 3, size=(n, L), dtype=np.uint8)
    # clumps of duplicates at random sizes
    for _ in range(6):
        src = int(rng.integers(0, n))
        copies = int(rng.integers(2, 12))
        db[rng.choice(n, copies, replace=False)] = db[src]
    q = rng.integers(0, 3, size=(24, L), dtype=np.uint8)
    q[:4] = db[rng.integers(0, n, 4)]
    for extra in ({}, {"SMAFA_TPU_FORCE_SHARD": "1"},
                  {"SMAFA_TPU_PALLAS_COUNT": "1"},
                  {"SMAFA_TPU_FORCE_SHARD": "1",
                   "SMAFA_TPU_PALLAS_COUNT": "1"}):
        res, _ = _best_hit(
            sharded.ScanRunner, db, L, q, None,
            {"SMAFA_TPU_PALLAS_MIN2": "interpret", **extra}, chunk=128,
        )
        dist, counts, rows, idx = res
        dmat = (q[:, None, :] != db[None, :, :]).sum(axis=2)
        for b in range(q.shape[0]):
            want = np.nonzero(dmat[b] == dmat[b].min())[0]
            np.testing.assert_array_equal(idx[rows == b], want)
            assert counts[b] == want.size
            assert dist[b] == dmat[b].min()


def test_iter_middles_vs_compact():
    """Iterative tie enumeration (floored min passes) must equal the
    compaction path exactly across tie shapes straddling TIE_ITER_MAX."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(23)
    L, n = 60, 900
    # counts 3, 5, 10 (== iter max), 11 and 30 (compact tail)
    db = _mk_db(rng, n, L, [(1, 3), (2, 5), (4, 10), (6, 11), (8, 30)])
    q = rng.integers(0, N_CHANNELS, size=(40, L), dtype=np.uint8)
    for k, src in enumerate((1, 2, 4, 6, 8)):
        q[k] = db[src]
    a = _best_hit(sharded.ScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PAIR_COUNT": "1", "SMAFA_TPU_TIE_ITER": ""})
    b = _best_hit(sharded.ScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PAIR_COUNT": "1", "SMAFA_TPU_TIE_ITER": "0"})
    c = _best_hit(sharded.ScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PAIR_COUNT": "0"})
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a[0], c[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1][1] == b[1][1] == c[1][1]


def test_iter_middles_forced_shard():
    """minfloor's mesh path (shard-local floor rebase + pmin) on the
    8-device mesh equals single-device."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(29)
    L, n = 60, 600
    db = _mk_db(rng, n, L, [(5, 4), (7, 6)])
    q = rng.integers(0, N_CHANNELS, size=(19, L), dtype=np.uint8)
    q[0] = db[5]
    q[1] = db[7]
    a = _best_hit(sharded.ScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PAIR_COUNT": "1", "SMAFA_TPU_FORCE_SHARD": "1"})
    b = _best_hit(sharded.ScanRunner, db, L, q, None,
                  {"SMAFA_TPU_PAIR_COUNT": "1"})
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1][1] == b[1][1]


def test_iter_middles_drift_fallback():
    """If the floored min ever disagrees with the claimed minimum (kernel
    drift), the affected rows must fall back to exact compaction rather
    than assert — force it by lying about d_star for one row."""
    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(41)
    L, n = 20, 300
    db = _mk_db(rng, n, L, [(2, 5)])
    q = rng.integers(0, N_CHANNELS, size=(16, L), dtype=np.uint8)
    q[0] = db[2]  # 5 exact ties
    r = sharded.ScanRunner(db, L)
    d, counts, rows, idx = r.best_hit(q, None)
    q_padded, _ = r._pad(q)
    sel = np.array([0], np.int32)
    # truth: middles via the honest path
    want = idx[rows == 0][1:-1]
    lo = np.array([idx[rows == 0][0]], np.int32)
    hi = np.array([idx[rows == 0][-1]], np.int32)
    got_r, got_i = r._iter_middles(q_padded, sel, d[sel], lo, hi,
                                   counts[sel].astype(np.int64))
    np.testing.assert_array_equal(np.sort(got_i), np.sort(want))
    # drift: claim a lower d_star so the device under-fills and the row
    # routes to the exact compaction fallback
    got_r2, got_i2 = r._iter_middles(q_padded, sel, d[sel] - 1, lo, hi,
                                     counts[sel].astype(np.int64))
    # the fallback compacts at thresh d_star-1... which yields counts at
    # the LIED threshold; what matters is no assert and no wrong emit
    assert got_r2.shape == got_i2.shape
