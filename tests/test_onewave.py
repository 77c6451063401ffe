"""One-wave best-hit: the fused keys + tie-count + middle-enumeration
program (parallel.sharded._build_bestfull via hitops.bestfull_async).

The contract: byte-identical best-hit results to the 3-wave path
(min2 -> tcount -> miditer || compact) in every configuration — mesh
shapes, fused-kernel pass-1, selection overflow, heavy tie tails, divergence
filters — since the one-wave program is a latency optimization, never a
semantics change (reference lib.rs:296-314).
"""

from __future__ import annotations

import numpy as np
import pytest

from smafa_tpu.ops import distance as D
from smafa_tpu.parallel.sharded import ScanRunner, build_mesh

L = 17


def _mk(rng, w, n_q, dup_frac=0.3, heavy_rows=0):
    """Tie-heavy db + mutated queries; optionally a block of
    heavily-duplicated rows (> TIE_ITER_MAX ties at the min)."""
    codes = rng.integers(0, 3, (w, L)).astype(np.uint8)
    nd = int(w * dup_frac)
    codes[nd : 2 * nd] = codes[:nd]
    if heavy_rows:
        codes[-heavy_rows * 16 :] = codes[-1]  # 16x-duplicated tail block
    q = codes[rng.integers(0, w, n_q)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    if heavy_rows:
        q[:4] = codes[-1]  # guaranteed heavy-tail queries
    return codes, q


def _assert_same(res_a, res_b):
    assert (res_a is None) == (res_b is None)
    for a, b in zip(res_a, res_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _reference(codes, q, maxdiv, monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "0")
    ref = ScanRunner(codes, L, mesh=build_mesh(1, 1))
    out = ref.best_hit(q, maxdiv)
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "1")
    return out


def test_min2c_scan_matches_min2_plus_count():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    w, chunk = 512, 128
    codes = rng.integers(0, 3, (w, L)).astype(np.uint8)
    codes[100:200] = codes[0:100]
    q = codes[rng.integers(0, w, 64)]
    q_oh = D.expand_onehot(q, L)
    db_oh = D.expand_onehot(codes, L)
    shift = D.packing_shift(L, w)
    lo, hi, cnt = D.min2c_scan(
        q_oh, db_oh, jnp.int32(w), jnp.int32(0), L, shift, chunk, w
    )
    lo2, hi2 = D.min2_scan(
        q_oh, db_oh, jnp.int32(w), jnp.int32(0), L, shift, chunk, w
    )
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(lo2))
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(hi2))
    # count oracle: dense distances
    dist = L - (q[:, None, :] == codes[None, :, :]).sum(axis=2)
    want_cnt = (dist == dist.min(axis=1, keepdims=True)).sum(axis=1)
    np.testing.assert_array_equal(np.asarray(cnt), want_cnt)


def test_onewave_single_device_parity(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "1")
    rng = np.random.default_rng(1)
    codes, q = _mk(rng, 3000, 300)
    want = {md: _reference(codes, q, md, monkeypatch)
            for md in (None, 0, 2, 5)}
    r = ScanRunner(codes, L, mesh=build_mesh(1, 1))
    for md in (None, 0, 2, 5):
        h = r.bestfull_async(q, md)
        assert len(h) > 7 and h[7] is not None, "one-wave path not taken"
        _assert_same(r.best_hit(q, md, handle=h), want[md])


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_onewave_mesh_parity(monkeypatch, mesh_shape):
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "1")
    rng = np.random.default_rng(2)
    codes, q = _mk(rng, 5000, 200)
    want = _reference(codes, q, 3, monkeypatch)
    r = ScanRunner(codes, L, mesh=build_mesh(*mesh_shape))
    h = r.bestfull_async(q, 3)
    assert len(h) > 7 and h[7] is not None
    _assert_same(r.best_hit(q, 3, handle=h), want)


def test_onewave_selection_overflow(monkeypatch):
    """s_cap tiny: most few-tie rows overflow the device selection and
    must take the fallback dispatches — results identical."""
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "1")
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE_SCAP", "16")
    rng = np.random.default_rng(3)
    # 4x-duplicated db -> every exact-copy query has 4 ties (> 2)
    base = rng.integers(0, 4, (800, L)).astype(np.uint8)
    codes = np.concatenate([base] * 4, axis=0)
    q = codes[rng.integers(0, 800, 256)].copy()
    want = _reference(codes, q, None, monkeypatch)
    r = ScanRunner(codes, L, mesh=build_mesh(1, 1))
    h = r.bestfull_async(q, None)
    assert h[7] is not None and h[7]["s_cap"] == 16
    assert int(np.asarray(h[7]["n_need"]).sum()) > 16  # overflow really hit
    _assert_same(r.best_hit(q, None, handle=h), want)


def test_onewave_heavy_tail(monkeypatch):
    """Rows with > TIE_ITER_MAX ties still compact; mixed batches stay
    exact."""
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "1")
    rng = np.random.default_rng(4)
    codes, q = _mk(rng, 4000, 128, heavy_rows=8)
    want = _reference(codes, q, None, monkeypatch)
    r = ScanRunner(codes, L, mesh=build_mesh(1, 1))
    h = r.bestfull_async(q, None)
    assert h[7] is not None
    _assert_same(r.best_hit(q, None, handle=h), want)


def test_onewave_mosaic_pass1(monkeypatch):
    """Fused-kernel (interpret) pass-1 inside the one-wave program."""
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "1")
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "interpret")
    L60 = 60
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 3, (4096, L60)).astype(np.uint8)
    codes[1024:2048] = codes[0:1024]
    q = codes[rng.integers(0, 4096, 128)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "0")
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "0")
    ref = ScanRunner(codes, L60, mesh=build_mesh(1, 1))
    want = {md: ref.best_hit(q, md) for md in (None, 3)}
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "1")
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "interpret")
    for mesh in (build_mesh(1, 1), build_mesh(1, 4)):
        r = ScanRunner(codes, L60, mesh=mesh)
        assert r._pallas_min2_eligible(256)
        for md in (None, 3):
            h = r.bestfull_async(q, md)
            assert h[7] is not None
            _assert_same(r.best_hit(q, md, handle=h), want[md])


def test_onewave_auto_latency_gate(monkeypatch):
    """Auto mode follows the measured dispatch latency AND requires the
    fused-kernel pass-1 (the XLA fused-count scan's sequential count
    breaks fusion, so auto never ships it); env pins both."""
    L60 = 60
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 3, (2048, L60)).astype(np.uint8)
    codes[512:1024] = codes[:512]
    q = codes[rng.integers(0, 2048, 64)].copy()
    monkeypatch.delenv("SMAFA_TPU_ONEWAVE", raising=False)
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "interpret")
    monkeypatch.setenv("SMAFA_TPU_DISPATCH_MS", "150")
    r = ScanRunner(codes, L60, mesh=build_mesh(1, 1))
    h = r.bestfull_async(q, None)
    assert len(h) > 7 and h[7] is not None  # high latency -> one-wave
    monkeypatch.setenv("SMAFA_TPU_DISPATCH_MS", "0.5")
    r2 = ScanRunner(codes, L60, mesh=build_mesh(1, 1))
    h2 = r2.bestfull_async(q, None)
    assert len(h2) <= 7 or h2[7] is None  # low latency -> 3-wave
    # without the kernel pass-1, auto stays 3-wave even at high latency
    monkeypatch.setenv("SMAFA_TPU_DISPATCH_MS", "150")
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "0")
    r3 = ScanRunner(codes, L60, mesh=build_mesh(1, 1))
    h3 = r3.bestfull_async(q, None)
    assert len(h3) <= 7 or h3[7] is None
    _assert_same(r.best_hit(q, None, handle=h),
                 r2.best_hit(q, None, handle=h2))
    _assert_same(r2.best_hit(q, None), r3.best_hit(q, None, handle=h3))


def test_tie_adaptive_fused_count(monkeypatch):
    """Tie-heavy batches flip the NEXT dispatch to the fused-count
    kernel phase A (min2c) — results byte-identical, tcount wave
    skipped (the handle carries the count)."""
    monkeypatch.setenv("SMAFA_TPU_ONEWAVE", "0")
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "interpret")
    monkeypatch.setenv("SMAFA_TPU_PAIR_COUNT", "1")
    L60 = 60
    rng = np.random.default_rng(8)
    base = rng.integers(0, 4, (512, L60)).astype(np.uint8)
    codes = np.concatenate([base] * 4, axis=0)  # everything 4-way tied
    q = base[rng.integers(0, 512, 64)].copy()
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "0")
    ref = ScanRunner(codes, L60, mesh=build_mesh(1, 1))
    want = ref.best_hit(q, None)
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "interpret")
    r = ScanRunner(codes, L60, mesh=build_mesh(1, 1))
    got1 = r.best_hit(q, None)          # first batch: plain pass, EMA learns
    assert r._tie_ema > r.TIE_EMA_COUNT_THRESHOLD
    h = r.min_count_async(q)            # next dispatch: fused count
    assert h[6] is not None, "adaptive fused count did not engage"
    got2 = r.best_hit(q, None, handle=h)
    for a, b in zip(got1, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(got2, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_onewave_cli_end_to_end(monkeypatch, tmp_path, capsys):
    """Full query op through the engine with the one-wave path forced:
    stdout byte-identical to the default path."""
    from smafa_tpu.cli import main

    rng = np.random.default_rng(7)
    codes, q = _mk(rng, 2000, 150)
    alpha = np.array(list("ACGTN"))
    db_fa = tmp_path / "db.fna"
    q_fa = tmp_path / "q.fna"
    with open(db_fa, "w") as f:
        for i, row in enumerate(codes):
            f.write(f">s{i}\n{''.join(alpha[row])}\n")
    with open(q_fa, "w") as f:
        for i, row in enumerate(q):
            f.write(f">q{i}\n{''.join(alpha[row])}\n")
    db = tmp_path / "db.smafadb"
    assert main(["makedb", "-i", str(db_fa), "-d", str(db)]) == 0
    capsys.readouterr()

    outs = {}
    for ow in ("0", "1"):
        monkeypatch.setenv("SMAFA_TPU_ONEWAVE", ow)
        assert main(["query", "-d", str(db), "-q", str(q_fa),
                     "--max-divergence", "4"]) == 0
        outs[ow] = capsys.readouterr().out
    assert outs["0"] == outs["1"]
    assert outs["0"].count("\n") > 100
