"""Fused phase-A kernel (ops.pallas_scan, Triton route): parity, launch
shapes and gating.

On the CPU the kernel runs in the Pallas interpreter; the same kernel
compiled for the GPU is covered by the ``gpu``-marked test at the end
(run on the card with ``SMAFA_TEST_DEVICE=gpu python -m pytest -m gpu``).
Oracles: XLA's ``min2_scan`` / ``min2c_scan`` and a NumPy brute force.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from smafa_tpu.ops import distance as D
from smafa_tpu.ops import pallas_scan as PS


def _data(seed, L, wp, nw, b):
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 5, size=(wp, L), dtype=np.uint8)
    src = int(rng.integers(0, nw))
    db[:nw][rng.integers(0, nw, 30)] = db[src]  # tie material
    q = rng.integers(0, 5, size=(b, L), dtype=np.uint8)
    q[:3] = db[src]
    return db, q


def _numpy_min2(q, db, nw, shift, span):
    """Reference keys and tie counts over the valid rows."""
    d = (q[:, None, :] != db[None, :nw, :]).sum(axis=2).astype(np.int64)
    m = d.min(axis=1)
    lo_i = d.argmin(axis=1)
    hi_i = nw - 1 - d[:, ::-1].argmin(axis=1)
    lo = (m << shift) | lo_i
    hi = (m << shift) | (span - 1 - hi_i)
    cnt = (d == m[:, None]).sum(axis=1)
    return lo, hi, cnt


def _xla_min2(q, db, nw, L, shift, wp):
    chunk = min(256, wp)
    return D.min2_scan(D.expand_query(q, L, L), jnp.asarray(db),
                       jnp.int32(nw), jnp.int32(0), L, shift, chunk, wp)


def _kernel(q, db, nw, L, shift, tiles, with_count):
    emb, base = PS.embed_db_twin(jnp.asarray(db), L, nw)
    return PS.min2_scan_pallas(PS.embed_query(jnp.asarray(q), L), emb, base,
                               shift, tiles, interpret=True,
                               with_count=with_count)


def test_packing_shift_limits():
    assert D.packing_shift(60, 1 << 20) is not None
    assert D.packing_shift(60, 16 << 20) is not None  # 10M+ windows
    assert D.packing_shift(2**26, 1 << 20) is None  # absurd length overflows


@pytest.mark.parametrize("with_count", [True, False])
@pytest.mark.parametrize("L", [3, 31, 60, 100])
def test_min2_kernel_vs_xla_and_numpy(L, with_count):
    """Interpret-mode kernel == XLA min2_scan keys == NumPy, with padding
    rows (n_windows not a tile multiple) and the fused count."""
    wp, nw, b = 512, 500, 32
    db, q = _data(L, L, wp, nw, b)
    shift = D.packing_shift(L, wp)
    out = _kernel(q, db, nw, L, shift, PS.Min2Tiles(16, 64, 2, 4, 3),
                  with_count)
    assert len(out) == (3 if with_count else 2)
    lo_x, hi_x = _xla_min2(q, db, nw, L, shift, wp)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(lo_x))
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(hi_x))
    lo_n, hi_n, cnt_n = _numpy_min2(q, db, nw, shift, wp)
    np.testing.assert_array_equal(np.asarray(out[0]), lo_n)
    np.testing.assert_array_equal(np.asarray(out[1]), hi_n)
    if with_count:
        np.testing.assert_array_equal(np.asarray(out[2]), cnt_n)


@pytest.mark.parametrize("nw", [1, 63, 64, 200, 256])
def test_min2_kernel_padding_rows(nw):
    """Any number of poisoned padding rows, including a db of one real
    row and one with none: results equal the XLA fused-count scan."""
    L, wp, b = 60, 256, 16
    db, q = _data(nw, L, wp, nw, b)
    shift = D.packing_shift(L, wp)
    lo, hi, cnt = _kernel(q, db, nw, L, shift, PS.Min2Tiles(16, 32, 4, 4, 3),
                          True)
    lo_x, hi_x, cnt_x = D.min2c_scan(
        D.expand_query(q, L, L), jnp.asarray(db), jnp.int32(nw),
        jnp.int32(0), L, shift, 64, wp)
    for g, w in ((lo, lo_x), (hi, hi_x), (cnt, cnt_x)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_min2_scan_pallas_parity():
    """The kernel equals the XLA min2_scan keys exactly at the default
    launch shape picked for the batch, padding rows included, and the
    fused tie count equals the dense oracle."""
    L, wp, b = 60, 1024, 64
    nw = 1000  # 24 padding rows in the last tile
    db, q = _data(5, L, wp, nw, b)
    shift = D.packing_shift(L, wp)
    tiles = PS.pick_min2_tiles(b, wp, interpret=True)
    lo, hi, cnt = _kernel(q, db, nw, L, shift, tiles, True)
    lo_x, hi_x = _xla_min2(q, db, nw, L, shift, wp)
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(lo_x))
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(hi_x))
    full = np.asarray(D.pairwise_distances(
        D.expand_onehot(q, L), D.expand_onehot(db[:nw], L), L))
    oc = (full == full.min(axis=1, keepdims=True)).sum(axis=1)
    np.testing.assert_array_equal(np.asarray(cnt), oc)


def test_min2_scan_pallas_subtiled_parity():
    """Every launch shape — query tile, db tile, db splits merged by the
    wrapper — gives the same keys and counts."""
    L, wp, b, nw = 60, 2048, 32, 2000
    db, q = _data(6, L, wp, nw, b)
    shift = D.packing_shift(L, wp)
    ref = _kernel(q, db, nw, L, shift, PS.Min2Tiles(32, 128, 1, 4, 3), True)
    for tiles in (PS.Min2Tiles(16, 64, 4, 4, 3), PS.Min2Tiles(32, 16, 8, 8, 2),
                  PS.Min2Tiles(16, 256, 2, 4, 3)):
        got = _kernel(q, db, nw, L, shift, tiles, True)
        for g, w in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_min2_kernel_shard_map(mesh_shape):
    """The kernel per 'w' shard inside shard_map, keys globalized by
    offset adds and pmin, counts merged at the global minimum — equal
    to the single-device kernel."""
    L, wp, b, nw = 60, 1024, 32, 1000
    db, q = _data(7, L, wp, nw, b)
    shift = D.packing_shift(L, wp)
    n_q, n_w = mesh_shape
    rows = wp // n_w
    tiles = PS.Min2Tiles(16, 64, 1, 4, 3)
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:n_q * n_w]).reshape(mesh_shape), ("q", "w"))
    emb, base = PS.embed_db_twin(jnp.asarray(db), L, nw)

    def shard_fn(qe, e, bs):
        off = jax.lax.axis_index("w").astype(jnp.int32) * rows
        lo, hi, cnt = PS.min2_scan_pallas(qe, e, bs, shift, tiles,
                                          interpret=True)
        lo_g = jax.lax.pmin(lo + off, "w")
        hi_g = jax.lax.pmin(hi + (wp - rows - off), "w")
        cnt_g = jax.lax.psum(
            jnp.where((lo >> shift) == (lo_g >> shift), cnt, 0), "w")
        return jnp.stack([lo_g, hi_g, cnt_g])

    got = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P("q", None), P("w", None), P("w")),
        out_specs=P(None, "q"), check_vma=False,
    ))(PS.embed_query(jnp.asarray(q), L), emb, base)
    ref = _kernel(q, db, nw, L, shift, tiles, True)
    for g, w in zip(np.asarray(got), ref):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("L,k", [(1, 16), (3, 16), (4, 16), (5, 32), (60, 256),
                                 (64, 256), (65, 512), (100, 512)])
def test_kernel_embed_dim(L, k):
    assert PS.kernel_embed_dim(L) == k
    emb, base = PS.embed_db_twin(jnp.zeros((4, L), jnp.uint8), L, 3)
    assert emb.shape == (4, k) and base.shape == (4,)
    # code 0 everywhere: embedding all -1 on real rows, base = L - L
    assert np.asarray(base).tolist() == [0, 0, 0, L + 1]
    assert not np.asarray(emb[3]).any()  # poisoned row is all zero
    assert PS.embed_query(jnp.zeros((2, L), jnp.uint8), L).shape == (2, k)


@pytest.mark.parametrize("b_loc,rows,interpret,want", [
    (65536, 1 << 22, False, (128, 64, 1)),
    (512, 1 << 22, False, (128, 64, 128)),
    (16, 1024, False, (16, 64, 1)),
    (8, 1024, False, None),           # below Triton's 16-row dot
    (8, 1024, True, (8, 64, 1)),      # the interpreter takes it
    (96, 1024, False, None),          # no power-of-two query tile
    (128, 96, False, None),           # db rows not a 64-row multiple
    (128, 96, True, (128, 32, 1)),    # the interpreter tiles them
    (64, 32, True, (64, 32, 1)),      # tiny shard: one whole-shard tile
])
def test_pick_min2_tiles(b_loc, rows, interpret, want):
    t = PS.pick_min2_tiles(b_loc, rows, interpret)
    if want is None:
        assert t is None
    else:
        assert (t.tile_b, t.tile_w, t.n_split) == want
        n_tiles = rows // t.tile_w
        assert n_tiles % t.n_split == 0


def test_min2_gate_off_on_cpu_without_env(monkeypatch):
    monkeypatch.delenv("SMAFA_TPU_PALLAS_MIN2", raising=False)
    assert not PS.min2_eligible(60, 60, 65536, 1 << 22, 1 << 22, 65536)
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "1")  # no GPU to compile for
    assert not PS.min2_eligible(60, 60, 65536, 1 << 22, 1 << 22, 65536)
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "interpret")
    assert PS.min2_eligible(60, 60, 64, 1024, 1000, 64)
    assert not PS.min2_eligible(60, 240, 64, 1024, 1000, 64)  # one-hot db
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "0")
    assert not PS.min2_eligible(60, 60, 64, 1024, 1000, 64)


class _FakeDevice:
    def __init__(self, platform, stats=None, kind="fake"):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_min2_gate_on_gpu(monkeypatch):
    """Auto gate on a GPU: by db rows, batch, twin size and the 32-bit
    offset bound; interpret mode is refused there."""
    dev = _FakeDevice("gpu", {"bytes_limit": 80 << 30})
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    monkeypatch.delenv("SMAFA_TPU_HBM_BYTES", raising=False)
    monkeypatch.delenv("SMAFA_TPU_PALLAS_MIN2", raising=False)
    assert PS.min2_eligible(60, 60, 65536, 1 << 22, 1 << 22, 65536)
    assert not PS.min2_eligible(60, 60, 65536, 1 << 19, 1 << 19, 65536)
    assert not PS.min2_eligible(60, 60, 256, 1 << 22, 1 << 22, 256)
    assert not PS.min2_eligible(60, 60, 65536, 1 << 23, 1 << 23, 65536)
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "1")
    assert PS.min2_eligible(60, 60, 64, 1024, 1000, 64)
    monkeypatch.setenv("SMAFA_TPU_PALLAS_MIN2", "interpret")
    with pytest.raises(ValueError, match="CPU backend only"):
        PS.min2_eligible(60, 60, 64, 1024, 1000, 64)


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with SMAFA_TEST_DEVICE=gpu on the card)")
    return dev


@pytest.mark.gpu
def test_min2_kernel_compiled_on_gpu(gpu_device):
    """The kernel as compiled for the card equals XLA's min2c_scan."""
    L, wp, b, nw = 60, 1 << 16, 1024, (1 << 16) - 100
    db, q = _data(11, L, wp, nw, b)
    shift = D.packing_shift(L, wp)
    emb, base = PS.embed_db_twin(jnp.asarray(db), L, nw)
    got = PS.min2_scan_pallas(PS.embed_query(jnp.asarray(q), L), emb, base,
                              shift, PS.pick_min2_tiles(b, wp))
    want = D.min2c_scan(D.expand_query(q, L, L), jnp.asarray(db),
                        jnp.int32(nw), jnp.int32(0), L, shift, 4096, wp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
