"""Fused phase-A scan kernel (Pallas, Triton route): int8 matmul + dual
packed-key min + tie count, with the distance block kept on chip.

The plain XLA path (``ops.distance.min2_scan``) hands each chunk's
[B, chunk] int32 match block from the int8 GEMM to a separate reduction,
so the block travels through device memory between the two. This kernel
keeps it in registers:

    dot   = Q_tile @ D_tile^T                  (int8 -> int32 tensor cores)
    key   = ((base[w] - dot) << shift) + w     (dist = base[w] - dot)
    carry = elementwise min(carry, key)        ([TB, TW] register carry)

and reduces the carry across its TW lanes once, after the last db tile.
The packed key gives the exact reference tie rule — lowest subject index
among minimum-distance windows (reference cluster.rs:62-68,
lib.rs:306-313) — with one integer min; the second key, packed with the
reversed index, yields the highest tied index, so a row's minimum is
unique iff the two indices agree. ``with_count`` adds the exact count of
windows at the row minimum (best-hit prints all of them, reference
lib.rs:296-314).

Layout for the card. Each block owns TB query rows and loops over its
range of db tiles inside the block (blocks run in no order, so nothing
is carried between them). Query tiles are the fastest grid axis, so
the blocks resident at one time walk the same db tiles and share them
through L2. When the batch has too few query tiles to fill the card,
the db range is split over a second grid axis and the splits merge with
a small XLA min afterwards.

The db twin (``embed_db_twin``) is the rank-4 embedding of
``ops.distance`` padded to a power-of-two width, plus one int32 per row:
``base = seq_len - zero_count`` so that ``dist = base - dot`` exactly.
Padding rows are poisoned — all-zero embedding with ``base = seq_len +
1`` — so their distance is the sentinel every real distance beats, and
the hot loop needs no validity mask.

Selection: ``min2_eligible`` (auto on the GPU backend for dbs of at
least 2^20 rows); ``SMAFA_TPU_PALLAS_MIN2=0/1`` overrides, ``=interpret``
runs the kernel in the Pallas interpreter on the CPU backend (tests).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BIG_KEY = 2**31 - 1  # plain int: jnp constants can't be captured by the kernel


class Min2Tiles(NamedTuple):
    """Static launch shape of one ``min2_scan_pallas`` call."""

    tile_b: int      # query rows per block
    tile_w: int      # db rows per inner-loop step
    n_split: int     # db splits (second grid axis)
    num_warps: int
    num_stages: int


# Launch defaults: the fastest of the sweep at 65536 x 2^22 x 60 bp on
# the H100 (tools/kernel_sweep.py; PERF.md, PR 1).
MIN2_TILE_B = 128
MIN2_TILE_W = 64
MIN2_NUM_WARPS = 4
MIN2_NUM_STAGES = 3
# Split the db until the grid holds this many blocks (a few per SM), but
# keep every split at least this many tiles long.
MIN2_TARGET_BLOCKS = 512
MIN2_MIN_SPLIT_TILES = 64
# Auto gate: the kernel ships for dbs of at least this many rows and
# batches of at least this many queries.
MIN2_MIN_ROWS = 1 << 20
MIN2_MIN_BATCH = 512
# Triton's dot needs every operand dimension >= 16.
_MIN_DIM = 16


def kernel_embed_dim(seq_len: int) -> int:
    """Contraction width of the kernel's embedding: 4 channels per base,
    padded to a power of two (Triton block shapes are powers of two)."""
    return max(_MIN_DIM, pl.next_power_of_2(4 * seq_len))


def _fit_width(emb: jax.Array, width: int) -> jax.Array:
    """Pad or trim the zero tail of an embedding to ``width`` columns."""
    cur = emb.shape[-1]
    if cur > width:
        return emb[..., :width]
    if cur < width:
        return jnp.pad(emb, [(0, 0)] * (emb.ndim - 1) + [(0, width - cur)])
    return emb


def embed_db_twin(codes: jax.Array, seq_len: int,
                  n_windows: jax.Array | int) -> tuple[jax.Array, jax.Array]:
    """uint8 codes [Wp, L] -> (int8 [Wp, K] rank-4 db embedding, int32
    [Wp] distance base) with ``dist = base - q_emb @ emb`` exactly.

    Rows >= ``n_windows`` are POISONED: zero embedding and base
    seq_len + 1, the sentinel distance (``packing_shift`` budgets
    seq_len + 2 values), which loses to every real window in both index
    directions."""
    from smafa_tpu.ops import distance as D

    emb, zc = D.expand_embed_db(codes, seq_len)
    emb = _fit_width(emb, kernel_embed_dim(seq_len))
    valid = (jnp.arange(emb.shape[0], dtype=jnp.int32)
             < jnp.asarray(n_windows, jnp.int32).reshape(()))
    emb = jnp.where(valid[:, None], emb, jnp.int8(0))
    base = jnp.where(valid, seq_len - zc, seq_len + 1).astype(jnp.int32)
    return emb, base


def embed_query(codes: jax.Array, seq_len: int) -> jax.Array:
    """uint8 codes [B, L] -> int8 [B, K] query embedding (pairs with
    ``embed_db_twin``)."""
    from smafa_tpu.ops import distance as D

    return _fit_width(D.expand_embed_query(codes, seq_len),
                      kernel_embed_dim(seq_len))


def pick_min2_tiles(b_loc: int, shard_rows: int,
                    interpret: bool = False) -> Min2Tiles | None:
    """Launch shape for one device's [b_loc] query rows x [shard_rows] db
    rows, or None when no power-of-two tiling divides. Interpret mode
    (CPU tests) also tiles tiny shards that are not 64-row multiples."""
    tb = min(MIN2_TILE_B, b_loc)
    tw = MIN2_TILE_W
    if interpret:  # the interpreter has no minimum dot shape
        tw = min(tw, shard_rows & -shard_rows)  # largest 2^k dividing
    elif tb < _MIN_DIM:
        return None
    if (tb <= 0 or tb & (tb - 1) or b_loc % tb
            or tw <= 0 or tw & (tw - 1) or shard_rows % tw):
        return None
    n_tiles = shard_rows // tw
    n_qt = b_loc // tb
    split = 1
    while (n_qt * split < MIN2_TARGET_BLOCKS and n_tiles % (2 * split) == 0
           and n_tiles // (2 * split) >= MIN2_MIN_SPLIT_TILES):
        split *= 2
    return Min2Tiles(tb, tw, split, MIN2_NUM_WARPS, MIN2_NUM_STAGES)


def interpret_requested() -> bool:
    """Whether ``SMAFA_TPU_PALLAS_MIN2=interpret`` asks for the Pallas
    interpreter. Accepted on the CPU backend only: on an accelerator it
    would silently run the kernel on the host."""
    if os.environ.get("SMAFA_TPU_PALLAS_MIN2", "") != "interpret":
        return False
    platform = jax.devices()[0].platform
    if platform != "cpu":
        raise ValueError(
            "SMAFA_TPU_PALLAS_MIN2=interpret is accepted on the CPU backend "
            f"only (this process runs on {platform!r}); use 0 or 1"
        )
    return True


def min2_count_enabled() -> bool:
    """Whether the standalone phase A fuses the tie count
    (SMAFA_TPU_PALLAS_COUNT=1). Off by default: the count taxes every
    distance element (it doubles the kernel's time on the H100; PERF.md,
    PR 1), while the separate tcount pass scans only tied rows."""
    return os.environ.get("SMAFA_TPU_PALLAS_COUNT", "") == "1"


def min2_eligible(seq_len: int, db_width: int, b_loc: int,
                  shard_rows: int, n_windows: int, b_total: int) -> bool:
    """Shared gate for shipping ``min2_scan_pallas``, used by every layout
    (row-sharded, ring). The kernel is 6x faster than XLA's min2_scan
    at 65536 x 2^22 on the H100 (PERF.md, PR 1); the size thresholds
    below are not yet measured there. Auto: GPU backend, a db of at least
    MIN2_MIN_ROWS rows, a batch of at least MIN2_MIN_BATCH queries, and
    a twin that takes at most a quarter of one device's memory.
    SMAFA_TPU_PALLAS_MIN2=0/1 overrides the auto gate; =interpret runs
    the kernel in the interpreter (CPU backend only)."""
    v = os.environ.get("SMAFA_TPU_PALLAS_MIN2", "")
    if v == "0":
        return False
    interpret = interpret_requested()
    k = kernel_embed_dim(seq_len)
    if not ((interpret or jax.devices()[0].platform == "gpu")
            and db_width == seq_len  # the twin is built from resident codes
            # 32-bit pointer offsets into the twin
            and shard_rows * k < 2**31
            and pick_min2_tiles(b_loc, shard_rows, interpret) is not None):
        return False
    if v in ("1", "interpret"):
        return True
    if n_windows < MIN2_MIN_ROWS or b_total < MIN2_MIN_BATCH:
        return False
    from smafa_tpu.parallel import select

    cap = select._hbm_capacity(per_device=True)
    return cap is not None and shard_rows * (k + 4) <= cap // 4


def _min2_kernel(q_ref, db_ref, base_ref, *out_refs, shift: int,
                 tile_w: int, n_steps: int, span: int, with_count: bool):
    split = pl.program_id(1)
    q = q_ref[...]                                    # [TB, K] int8
    lane = jnp.arange(tile_w, dtype=jnp.int32)

    def body(t, carry):
        start = (split * n_steps + t) * tile_w
        db = db_ref[pl.ds(start, tile_w), :]          # [TW, K] int8
        base = base_ref[pl.ds(start, tile_w)] << shift
        dot = jax.lax.dot_general(
            q, db, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        sh = dot << shift
        gidx = start + lane
        # (base - dot) << shift, plus the index field: exact because the
        # index never carries into the distance bits (gidx < 2**shift).
        k_lo = (base + gidx)[None, :] - sh
        k_hi = (base + (span - 1 - gidx))[None, :] - sh
        lo, hi = carry[0], carry[1]
        out = (jnp.minimum(lo, k_lo), jnp.minimum(hi, k_hi))
        if with_count:
            # per lane: windows seen at that lane's current minimum
            d_new = k_lo >> shift
            d_old = lo >> shift
            cnt = (jnp.where(d_new < d_old, 0, carry[2])
                   + (d_new <= d_old).astype(jnp.int32))
            out = out + (cnt,)
        return out

    shape = (q.shape[0], tile_w)
    init = (jnp.full(shape, BIG_KEY, jnp.int32),
            jnp.full(shape, BIG_KEY, jnp.int32))
    if with_count:
        init = init + (jnp.zeros(shape, jnp.int32),)
    acc = jax.lax.fori_loop(0, n_steps, body, init)
    lo = jnp.min(acc[0], axis=1)
    out_refs[0][...] = lo
    out_refs[1][...] = jnp.min(acc[1], axis=1)
    if with_count:
        at_min = (acc[0] >> shift) == (lo >> shift)[:, None]
        out_refs[2][...] = jnp.sum(jnp.where(at_min, acc[2], 0), axis=1)


@functools.partial(
    jax.jit, static_argnames=("shift", "tiles", "interpret", "with_count"),
)
def min2_scan_pallas(
    q_emb: jax.Array,      # int8 [Bp, K] (embed_query)
    db_emb: jax.Array,     # int8 [Wp, K] (embed_db_twin — padding poisoned)
    db_base: jax.Array,    # int32 [Wp]  (embed_db_twin)
    shift: int,
    tiles: Min2Tiles,
    interpret: bool = False,
    with_count: bool = True,
) -> tuple[jax.Array, ...]:
    """Dual packed min keys per row — drop-in twin of
    ``ops.distance.min2_scan`` (index_offset 0, span = Wp) over the
    embedded db twin, plus (``with_count``) the exact per-row count of
    windows at the minimum distance. Returns (lo, hi[, cnt])."""
    bp, k = q_emb.shape
    wp = db_emb.shape[0]
    tb, tw, n_split = tiles.tile_b, tiles.tile_w, tiles.n_split
    n_steps = wp // tw // n_split
    assert bp % tb == 0 and n_steps * tw * n_split == wp, (bp, wp, tiles)
    n_out = 3 if with_count else 2
    kernel = functools.partial(
        _min2_kernel, shift=shift, tile_w=tw, n_steps=n_steps, span=wp,
        with_count=with_count,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(bp // tb, n_split),
        in_specs=[
            pl.BlockSpec((tb, k), lambda i, s: (i, 0)),
            pl.no_block_spec,
            pl.no_block_spec,
        ],
        out_specs=[pl.BlockSpec((None, tb), lambda i, s: (s, i))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n_split, bp), jnp.int32)] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=tiles.num_warps, num_stages=tiles.num_stages),
        interpret=interpret,
        name="min2_scan",
    )(q_emb, db_emb, db_base)
    lo = jnp.min(outs[0], axis=0)
    hi = jnp.min(outs[1], axis=0)
    if not with_count:
        return lo, hi
    at_min = (outs[0] >> shift) == (lo >> shift)[None, :]
    return lo, hi, jnp.sum(jnp.where(at_min, outs[2], 0), axis=0)
