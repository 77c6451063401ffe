"""Greedy clustering golden tests — ports of the reference's in-crate
cluster unit tests (reference cluster.rs:96-144), which are the regression
gates for tie/threshold behavior and duplicate handling."""

import io

import numpy as np

from smafa_tpu.engine.cluster import cluster


def run_cluster(path, max_div, **kw):
    buf = io.StringIO()
    cluster(path, max_div, out=buf, **kw)
    return buf.getvalue()


def test_simple():
    # reference cluster.rs:101-112
    assert run_cluster("tests/data/cluster_dummy1.fna", 1) == (
        "ATGC\tATGC\nATGG\tATGC\nAAAA\tAAAA\n"
    )


def test_bug1():
    # reference cluster.rs:114-125 (greedy tie/threshold regression)
    assert run_cluster("tests/data/cluster_bug1.fna", 2) == (
        "ATGCAAAAA\tATGCAAAAA\nATAAAAAAA\tATGCAAAAA\nTTAAAAAAA\tTTAAAAAAA\n"
    )


def test_best_hit_changes_bug():
    # reference cluster.rs:127-143: a duplicate input must be skipped
    # entirely (no output line), so identical sequences can never land in
    # different centroids.
    assert run_cluster("tests/data/cluster_best_hit_changes.fna", 2) == (
        "ATGCAAAAA\tATGCAAAAA\nATAAAAAAA\tATGCAAAAA\nTTAAAAAAA\tTTAAAAAAA\n"
    )


def test_batch_boundary_invariance():
    # The engine batches an inherently sequential algorithm; output must
    # be identical for every batch size (intra-batch promotion resolution).
    ref = run_cluster("tests/data/cluster_best_hit_changes.fna", 2, batch_size=512)
    for bs in (1, 2, 3):
        assert run_cluster("tests/data/cluster_best_hit_changes.fna", 2, batch_size=bs) == ref


def test_adaptive_batches_identical(tmp_path, monkeypatch):
    # Auto mode (no batch_size) grows dispatch batches geometrically;
    # output must equal every fixed batch size byte-for-byte.
    rng = np.random.default_rng(7)
    n, L = 500, 10
    seqs = rng.integers(0, 4, size=(n, L))
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    strings = ["".join(chr(alpha[c]) for c in row) for row in seqs]
    fa = tmp_path / "ad.fna"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(strings)))
    ref = run_cluster(str(fa), 3, batch_size=64)
    # small start/cap so several doublings happen inside 500 records
    monkeypatch.setenv("SMAFA_TPU_CLUSTER_BATCH_MAX", "128")
    import smafa_tpu.engine.cluster as C

    monkeypatch.setattr(C, "DEFAULT_BATCH", 16)
    assert run_cluster(str(fa), 3) == ref
    monkeypatch.setenv("SMAFA_TPU_CLUSTER_BATCH_MAX", "100000")
    assert run_cluster(str(fa), 3) == ref


def test_pipeline_depth_latency_auto(monkeypatch):
    # Round 5: pipeline depth self-corrects from the measured link
    # latency (slow link -> 1, local -> 2); output is byte-identical
    # either way, and an explicit SMAFA_TPU_CLUSTER_PIPELINE pins it.
    ref = run_cluster("tests/data/cluster_best_hit_changes.fna", 2,
                      batch_size=2)
    for ms in ("50", "0.5"):
        monkeypatch.setenv("SMAFA_TPU_DISPATCH_MS", ms)
        assert run_cluster("tests/data/cluster_best_hit_changes.fna", 2,
                           batch_size=2) == ref
    monkeypatch.setenv("SMAFA_TPU_CLUSTER_PIPELINE", "4")
    assert run_cluster("tests/data/cluster_best_hit_changes.fna", 2,
                       batch_size=2) == ref


def test_grow_batches_rechunker():
    from smafa_tpu.engine.cluster import _grow_batches

    def src(widths):
        for k, (n, L) in enumerate(widths):
            ids = [f"s{k}_{j}" for j in range(n)]
            raws = [b"x" * L for _ in range(n)]
            yield ids, raws, np.full((n, L), k % 5, np.uint8)

    # growth schedule: 4, 8, 16, 16, ... and remainder flush
    out = list(_grow_batches(src([(4, 6)] * 12), 4, 16))
    assert [o[2].shape[0] for o in out] == [4, 8, 16, 16, 4]
    assert sum(o[2].shape[0] for o in out) == 48
    # a width change flushes the buffer so the length check fires on the
    # right record (no cross-width concatenation)
    out = list(_grow_batches(src([(4, 6), (4, 6), (4, 9)]), 4, 64))
    assert [o[2].shape[1] for o in out] == [6, 6, 9]
    assert [o[2].shape[0] for o in out] == [4, 4, 4]

    # an error mid-stream flushes collected rows first, then re-raises
    def bad():
        yield ["a"], [b"xxxxxx"], np.zeros((1, 6), np.uint8)
        raise ValueError("boom")

    it = _grow_batches(bad(), 8, 8)
    first = next(it)
    assert first[2].shape == (1, 6)
    import pytest

    with pytest.raises(ValueError, match="boom"):
        next(it)


def _oracle_cluster(seqs, max_div):
    """Direct transliteration of the reference algorithm (cluster.rs:13-94)
    in numpy — the order-sequential oracle for randomized comparison."""
    centroids: list[np.ndarray] = []
    seen = set()
    out = []
    for seq in seqs:
        key = seq.tobytes()
        if key in seen:
            continue
        seen.add(key)
        if centroids:
            dists = [int(np.sum(seq != c)) for c in centroids]
            mind = min(dists)
        else:
            dists, mind = [], max_div * 2 + 2
        if mind <= max_div:
            assigned = dists.index(mind)
        else:
            assigned = len(centroids)
            centroids.append(seq)
        out.append((seq, assigned))
    return out


def test_randomized_against_oracle(tmp_path):
    rng = np.random.default_rng(123)
    n, L = 200, 12
    seqs = rng.integers(0, 4, size=(n, L))
    # inject duplicates
    seqs[50] = seqs[10]
    seqs[51] = seqs[10]
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    strings = ["".join(chr(alpha[c]) for c in row) for row in seqs]
    fa = tmp_path / "rand.fna"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(strings)))

    for max_div in (0, 2, 5):
        expected_pairs = _oracle_cluster([row for row in seqs], max_div)
        # reconstruct expected stdout: raw seq \t decoded centroid
        cent_strings = {}
        exp_lines = []
        for seq, cid in expected_pairs:
            if cid not in cent_strings:
                cent_strings.setdefault(cid, None)
        # decode centroids in promotion order
        cents = []
        for seq, cid in expected_pairs:
            if cid == len(cents):
                cents.append("".join(chr(alpha[c]) for c in seq))
            exp_lines.append(f"{''.join(chr(alpha[c]) for c in seq)}\t{cents[cid]}\n")
        expected = "".join(exp_lines)
        for bs in (7, 512):
            assert run_cluster(str(fa), max_div, batch_size=bs) == expected, (max_div, bs)


def test_randomized_against_oracle_promotion_heavy(tmp_path):
    """Adversarial sweep-vectorization fuzz: small alphabet and tight
    divergence force dense intra-batch promotions, captures of both
    failing and already-assigned rows, and cross-batch dependencies —
    the exact structure the bulk argmin resolution must reproduce."""
    rng = np.random.default_rng(77)
    n, L = 1500, 8
    seqs = rng.integers(0, 2, size=(n, L))  # binary alphabet: dense ties
    seqs[200:220] = seqs[7]
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    strings = ["".join(chr(alpha[c]) for c in row) for row in seqs]
    fa = tmp_path / "hvy.fna"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(strings)))

    for max_div in (0, 1, 2, 3):
        pairs = _oracle_cluster([row for row in seqs], max_div)
        cents = []
        exp = []
        for seq, cid in pairs:
            if cid == len(cents):
                cents.append("".join(chr(alpha[c]) for c in seq))
            exp.append(
                f"{''.join(chr(alpha[c]) for c in seq)}\t{cents[cid]}\n")
        expected = "".join(exp)
        for bs in (64, 700, None):
            kw = {} if bs is None else {"batch_size": bs}
            assert run_cluster(str(fa), max_div, **kw) == expected, (
                max_div, bs)
