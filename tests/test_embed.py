"""Rank-4 match embedding: exact parity with the one-hot formulation.

The embedding (ops/distance.py, "Rank-4 match embedding") computes the
same match counts as the 5-channel one-hot contraction from a 4-channel
one — query side drops channel 0 to the zero vector, db side maps
channel 0 to all -1 and adds its per-row zero count in the epilogue:

    matches = dot + #(db positions with channel 0)

Every test here asserts EXACT integer equality against the one-hot
oracle (reference semantics lib.rs:80-88), including at window lengths
where the padded widths collide and the embedding must deactivate.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest

from smafa_tpu.core.alphabet import N_CHANNELS
from smafa_tpu.ops import distance as D


def _oracle(q, db, L):
    return np.asarray(
        D.pairwise_distances(D.expand_onehot(q, L), D.expand_onehot(db, L), L)
    )


@pytest.mark.parametrize("L", [1, 3, 12, 25, 32, 60, 96, 100, 127, 200])
def test_embed_matches_onehot_exact(L):
    rng = np.random.default_rng(L)
    q = rng.integers(0, N_CHANNELS, size=(13, L), dtype=np.uint8)
    db = rng.integers(0, N_CHANNELS, size=(37, L), dtype=np.uint8)
    q_e = D.expand_embed_query(q, L)
    d_e, zc = D.expand_embed_db(jnp.asarray(db), L)
    dist = L - np.asarray(
        jnp.einsum("bk,wk->bw", q_e.astype(jnp.int32), d_e.astype(jnp.int32))
    ) - np.asarray(zc)[None, :]
    np.testing.assert_array_equal(dist, _oracle(q, db, L))


@pytest.mark.parametrize("L", [32, 60, 96])
def test_block_distances_embed_inference(L):
    """block_distances must pick the embed db expansion from the query's
    width alone (only active where the padded widths differ)."""
    assert D.embed_active(L), "these lengths must activate the embedding"
    rng = np.random.default_rng(L + 1)
    chunk = 16
    db = rng.integers(0, N_CHANNELS, size=(chunk * 3, L), dtype=np.uint8)
    q = rng.integers(0, N_CHANNELS, size=(9, L), dtype=np.uint8)
    q_e = D.expand_embed_query(q, L)
    want = _oracle(q, db, L)
    for off in (0, chunk, 2 * chunk):
        got = np.asarray(
            D.block_distances(q_e, jnp.asarray(db), jnp.int32(off), chunk, L)
        )
        np.testing.assert_array_equal(got, want[:, off : off + chunk])


def test_embed_inactive_when_padding_equal():
    # 5L and 4L pad to the same lane multiple -> no matmul saving, and the
    # query width would be ambiguous: embed_active must be False.
    for L in (25, 100):
        assert D.padded_embed_dim(L) == D.padded_feature_dim(L)
        assert not D.embed_active(L)
    assert D.embed_active(60) == (os.environ.get("SMAFA_TPU_EMBED", "") != "0")


def test_expand_query_follows_db_form():
    L = 60
    q = np.zeros((4, L), dtype=np.uint8)
    onehot_w = D.padded_feature_dim(L)
    # one-hot-resident db -> one-hot query regardless of the env
    assert D.expand_query(q, L, onehot_w).shape[1] == onehot_w
    # codes-resident db -> embed form (when enabled/active)
    w = D.expand_query(q, L, L).shape[1]
    if D.embed_active(L):
        assert w == D.padded_embed_dim(L)
    else:
        assert w == onehot_w


def _runner_outputs(codes, L, q, env):
    """min2/topm/best-hit/K-mode outputs of a fresh ScanRunner under env."""
    from smafa_tpu.parallel import sharded

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        r = sharded.ScanRunner(codes, L)
        d, i, mx = r.topm(q, 5)
        dmin, imin, unique = r.min2(q)
        bh = r.best_hit(q, max_divergence=L // 2)
        km = r.kmode_flat(q, 3, None)
        return (d, i, mx, dmin, imin, unique) + tuple(bh) + tuple(km)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("L", [60, 25])
def test_runner_parity_embed_vs_onehot(L):
    """Full ScanRunner outputs are identical with the embedding on/off —
    fresh runners per setting (the form is baked in at trace time)."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, N_CHANNELS, size=(300, L), dtype=np.uint8)
    # plant exact duplicates so min ties exercise both key directions
    codes[110] = codes[13]
    codes[250] = codes[13]
    q = rng.integers(0, N_CHANNELS, size=(17, L), dtype=np.uint8)
    q[3] = codes[13]
    a = _runner_outputs(codes, L, q, {"SMAFA_TPU_EMBED": "1"})
    b = _runner_outputs(codes, L, q, {"SMAFA_TPU_EMBED": "0"})
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("L", [60, 200, 300])
def test_col_layout_embed_parity(L):
    """Column-sharded layout with the rank-4 embedding: the channel-0
    count spreads over ceil(L/127) int8 correction columns, so the psum
    of partial dots recovers exact matches at long windows too."""
    from smafa_tpu.parallel import seqpar, sharded

    rng = np.random.default_rng(L)
    n = 200
    # N-heavy rows make zc large (past one int8 column at L >= 128)
    codes = rng.integers(0, N_CHANNELS, size=(n, L), dtype=np.uint8)
    codes[5] = 0  # all channel-0: zc == L
    q = rng.integers(0, N_CHANNELS, size=(9, L), dtype=np.uint8)
    q[0] = codes[5]
    q[1] = codes[7]

    col = seqpar.ColumnShardedScanRunner(codes, L, chunk=32)
    assert col._embed, "embedding must engage at these lengths"
    oracle = sharded.ScanRunner(codes, L, mesh=sharded.build_mesh(1, 1))
    for env in ({"SMAFA_TPU_PAIR_COUNT": "1"}, {"SMAFA_TPU_PAIR_COUNT": "0"}):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            a = col.best_hit(q, None)
            b = oracle.best_hit(q, None)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ka = col.kmode_flat(q, 5, None)
    kb = oracle.kmode_flat(q, 5, None)
    for x, y in zip(ka, kb):
        np.testing.assert_array_equal(x, y)
