"""Bit-pack lowerings for the compaction mask (SMAFA_TPU_PACK).

The hit-mask pack epilogue has three exact lowerings (ops/distance.py
``_pack_bits``): the naive 32-wide reduce, a pairwise doubling tree, and
an int8 matmul against a block-diagonal powers-of-two matrix. All
three must produce identical words at any chunk size, and compact_scan
must return identical hit sets under each.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from smafa_tpu.core.alphabet import N_CHANNELS
from smafa_tpu.ops import distance as D

MODES = ("reduce", "tree", "matmul")


@pytest.mark.parametrize("chunk", [32, 64, 512, 1024, 2048])
def test_pack_bits_exact(chunk):
    rng = np.random.default_rng(chunk)
    b = 5
    hit = rng.random((b, chunk)) < 0.37
    want = np.zeros((b, chunk // 32), np.uint32)
    for w in range(chunk // 32):
        for j in range(32):
            want[:, w] |= hit[:, 32 * w + j].astype(np.uint32) << j
    for mode in MODES:
        got = np.asarray(D._pack_bits(jnp.asarray(hit), b, chunk // 32, mode))
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=mode)


def test_pack_weights_structure():
    w = D._pack_weights(512)
    assert w.shape == (512, 80)
    assert w.dtype == np.int8
    # exactly one nonzero per input bit; plane sums <= 127 (int8-exact)
    assert ((w != 0).sum(axis=1) == 1).all()
    assert (w[w != 0] > 0).all()
    assert (w.astype(np.int32).sum(axis=0) <= 127).all()


@pytest.mark.parametrize("mode", MODES)
def test_compact_scan_mode_parity(mode):
    rng = np.random.default_rng(11)
    L, chunk, wp = 60, 512, 2048
    db = rng.integers(0, N_CHANNELS, size=(wp, L), dtype=np.uint8)
    q = rng.integers(0, N_CHANNELS, size=(8, L), dtype=np.uint8)
    thresh = np.full(8, 25, np.int32)
    thresh[0] = -1  # disabled row

    def run(pack):
        return [np.asarray(x) for x in D.compact_scan(
            D.expand_onehot(q, L), jnp.asarray(db), jnp.int32(wp - 13),
            jnp.asarray(thresh), jnp.int32(0), L, chunk, 1 << 12, pack,
        )]

    got = run(mode)
    want = run("reduce")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=mode)
