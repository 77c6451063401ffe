"""Device-side Hamming distance engine.

The reference computes per-pair distance as ``popcount(a ^ b) / 2`` over
packed u64 words (reference lib.rs:80-88) — a CPU bit-trick. For one-hot
encodings this identity holds::

    popcount(a ^ b) / 2  ==  L - <onehot(a), onehot(b)>

(each aligned column contributes 1 to the dot product iff both sides carry
the same single one-hot code, else 0), so the whole query-vs-db scan is one
int8 matmul on the tensor cores::

    distance[b, w] = L - Q[b, L*5] @ D[w, L*5]^T

Selection is sort-free. Distances are bounded by the window length, so a
packed key ``(dist << shift) | subject_index`` orders pairs exactly as
the reference's ``(distance, subject_index)`` ascending sort
(lib.rs:243-250), and every selection mode reduces to fused integer-min
scans over those keys:

- ``min2_scan``: dual keys (index ascending + descending) — one pass
  gives the best hit (lowest-index tie, lib.rs:306-313) and the highest
  tied index, so uniqueness of the minimum is known for free. This is
  best-hit phase A: the fastest possible pass (pure matmul + two
  elementwise mins).
- ``compact_scan``: the enumeration pass — every (row, window) pair with
  dist <= thresh[row], in (row, index) order. The scan packs per-chunk
  hit BITS into a [B, W/32] mask (an elementwise epilogue on the matmul,
  so the pass runs at scan speed); one extraction step then ranks the
  set bits with a popcount cumsum + searchsorted over words. Serves
  best-hit tie enumeration (thresh = row min, lib.rs:306-313) and the
  K-mode print set (thresh = effective cutoff, lib.rs:261-265). Exact
  per-row hit counts come back with every call, so an undersized buffer
  is detected and retried with exact sizing (no rescan loop).
- ``hist_scan`` / ``kmode_cutoffs_from_hist``: one pass computing the
  exact [B, L+1] distance histogram; the host reads the Kth-smallest
  distance, row max, and hit counts off its cumulative sum — the K-mode
  cutoff rule (lib.rs:253-265). ``kmode_phase1`` (multi-probe
  partition-search count scans — the shipped K-mode phase A at every
  window length) reads the same rule in ~3 fused passes at 60 bp.
- ``topm_scan``: the exact chunked (distance, index) top-M sort-merge,
  retained as the fallback when key packing overflows 31 bits.

Everything here is shape-static and jit-cached; callers pad B/W/L to the
canonical grid (see ``pad_*`` helpers). Shard-map wrappers in
smafa_tpu.parallel reuse these primitives with pmin/psum merges (packed
keys carry global indices, so elementwise pmin IS the cross-shard merge).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from smafa_tpu.core.alphabet import N_CHANNELS

BIG = np.int32(2**30)  # sentinel distance for padded / masked-out windows
LANE = 128  # pad the contraction axis to a multiple of this (GEMM tile width)


def padded_feature_dim(seq_len: int) -> int:
    l5 = seq_len * N_CHANNELS
    return ((l5 + LANE - 1) // LANE) * LANE


def _lane_pad(flat: jax.Array, width: int) -> jax.Array:
    """Zero-pad the last axis to ``width`` (a lane multiple). Pad columns
    are all-zero on both contraction sides, so they contribute nothing to
    the dot product — the same trick as the reference's zero-padded
    trailing u64 chunk (lib.rs:32-46)."""
    if width != flat.shape[-1]:
        pad = [(0, 0)] * (flat.ndim - 1) + [(0, width - flat.shape[-1])]
        flat = jnp.pad(flat, pad)
    return flat


def expand_onehot(codes: np.ndarray | jax.Array, seq_len: int) -> jax.Array:
    """Channel indices uint8 [..., L] -> one-hot int8 [..., LP] (lane-padded)."""
    codes = jnp.asarray(codes)
    oh = (codes[..., :, None] == jnp.arange(N_CHANNELS, dtype=codes.dtype)).astype(jnp.int8)
    flat = oh.reshape(codes.shape[:-1] + (seq_len * N_CHANNELS,))
    return _lane_pad(flat, padded_feature_dim(seq_len))


def _match_dots(q_oh: jax.Array, d_oh: jax.Array) -> jax.Array:
    """int32 [B, W] count of matching columns — the int8 contraction."""
    return jax.lax.dot_general(
        q_oh, d_oh,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


# ---------------------------------------------------------------------------
# Rank-4 match embedding: the same match counts from a 4-channel (not
# 5-channel) contraction, cutting the matmul work per comparison by the lane
# padding ratio (384 -> 256 at 60 bp, i.e. 1.5x).
#
# A symmetric integer embedding below 5 dims/base provably does not exist
# (the Gram matrix family alpha*I + f*1^T + 1*f^T needs (alpha+sum f)^2 =
# 5*|f|^2, and every PSD rank-4 member fails the square-determinant
# condition on its 4x4 minors — exhaustively checked for |f| <= 6). But
# the two sides of the contraction may use DIFFERENT embeddings, and then
# a one-line construction works — drop channel 0:
#
#   query side   q_l = onehot_{1..4}(code)          (code 0 -> zero vector)
#   db side      d_l = onehot_{1..4}(code)           for code != 0
#                d_l = (-1,-1,-1,-1)                  for code == 0
#
#   <q_l, d_l> = delta(q,d) - [q==0][d==0] - [q!=0][d==0] = delta - [d==0]
#
# so   matches = dot + #(db positions with code 0)   — exact in integers,
# with the per-db-row zero count added in the (already fused) epilogue.
# Entries are {-1, 0, 1} int8; |dot| <= L so int32 accumulation is exact.
#
# Active only where the padded contraction width actually shrinks
# (padded_embed_dim < padded_feature_dim — at 60 bp: 256 < 384), which
# also makes the query form unambiguous from its width alone, so
# ``block_distances`` can infer the right per-chunk db expansion.

EMBED_CHANNELS = N_CHANNELS - 1  # channels 1..4; channel 0 is implicit


def padded_embed_dim(seq_len: int) -> int:
    le = seq_len * EMBED_CHANNELS
    return ((le + LANE - 1) // LANE) * LANE


def _embed_enabled() -> bool:
    import os

    return os.environ.get("SMAFA_TPU_EMBED", "") != "0"


def embed_active(seq_len: int) -> bool:
    """True when codes-resident scans should use the rank-4 embedding:
    it must be enabled AND actually shrink the padded contraction."""
    return _embed_enabled() and padded_embed_dim(seq_len) < padded_feature_dim(seq_len)


def expand_embed_query(codes: np.ndarray | jax.Array, seq_len: int) -> jax.Array:
    """Channel indices uint8 [..., L] -> int8 [..., EP] query-side embedding
    (one-hot over channels 1..4; channel 0 maps to the zero vector)."""
    codes = jnp.asarray(codes)
    oh = (codes[..., :, None]
          == jnp.arange(1, N_CHANNELS, dtype=codes.dtype)).astype(jnp.int8)
    flat = oh.reshape(codes.shape[:-1] + (seq_len * EMBED_CHANNELS,))
    return _lane_pad(flat, padded_embed_dim(seq_len))


def expand_embed_db(codes: jax.Array, seq_len: int) -> tuple[jax.Array, jax.Array]:
    """Db-side embedding: int8 [..., EP] (channel 0 -> all -1) plus the
    per-row int32 count of channel-0 positions (the epilogue correction)."""
    codes = jnp.asarray(codes)
    is0 = (codes[..., :, None] == 0).astype(jnp.int8)
    oh = (codes[..., :, None]
          == jnp.arange(1, N_CHANNELS, dtype=codes.dtype)).astype(jnp.int8)
    emb = oh - is0  # code 0 row: (-1,-1,-1,-1); else one-hot
    flat = emb.reshape(codes.shape[:-1] + (seq_len * EMBED_CHANNELS,))
    zc = jnp.sum((codes == 0).astype(jnp.int32), axis=-1)
    return _lane_pad(flat, padded_embed_dim(seq_len)), zc


def expand_query(codes: np.ndarray | jax.Array, seq_len: int,
                 db_width: int) -> jax.Array:
    """The query-side expansion matching a resident db of width ``db_width``
    (static at trace time): the rank-4 embedding when the db is
    codes-resident and the embedding is active, else one-hot."""
    if db_width != padded_feature_dim(seq_len) and embed_active(seq_len):
        return expand_embed_query(codes, seq_len)
    return expand_onehot(codes, seq_len)


@partial(jax.jit, static_argnames=("seq_len",))
def pairwise_distances(q_oh: jax.Array, d_oh: jax.Array, seq_len: int) -> jax.Array:
    """Full [B, W] distance matrix (small-problem path and test oracle)."""
    return seq_len - _match_dots(q_oh, d_oh)


def block_distances(q_oh, db, off, chunk, seq_len: int):
    """Distances of q_oh vs db rows [off, off+chunk) — the shared scan
    step used by every kernel's chunk loop.

    ``db`` is whatever form is resident: one-hot int8 [Wp, LP]
    (LP = padded_feature_dim), or raw channel codes [Wp, L'] (any other
    width — L' < LP always since LP pads 5x the length). Codes expand
    to one-hot per chunk right here: O(chunk * LP) elementwise work
    against the O(B * chunk * LP) contraction, in exchange for the
    resident db costing seq_len instead of padded-one-hot bytes per row
    (6.4x more rows per device at 60 bp, and 6.4x less interconnect
    traffic per ring rotation / PCIe per streamed slab)."""
    block = jax.lax.dynamic_slice_in_dim(db, off, chunk, axis=0)
    lp = padded_feature_dim(seq_len)
    if db.shape[1] == lp:
        return seq_len - _match_dots(q_oh, block)
    ep = padded_embed_dim(seq_len)
    if q_oh.shape[1] == ep and ep < lp:
        # Rank-4 embedding (the query's width commits the form — see the
        # embedding notes above): matches = dot + per-row zero count.
        d_emb, zc = expand_embed_db(block, seq_len)
        return seq_len - _match_dots(q_oh, d_emb) - zc[None, :]
    return seq_len - _match_dots(q_oh, expand_onehot(block, seq_len))


def _merge_topm(
    d_carry: jax.Array, i_carry: jax.Array, dist: jax.Array, gidx: jax.Array, m: int
) -> tuple[jax.Array, jax.Array]:
    """Merge a new distance block into the running top-M.

    Correct (distance, index)-ascending tie order requires every column of
    the concatenation to be ordered by global index within equal distance:
    the carry is already (d, idx)-sorted and holds indices lower than any
    in the new block, and the block's columns ascend in index.
    """
    cat_d = jnp.concatenate([d_carry, dist], axis=1)
    cat_i = jnp.concatenate([i_carry, gidx], axis=1)
    neg, pos = jax.lax.top_k(-cat_d, m)
    return -neg, jnp.take_along_axis(cat_i, pos, axis=1)


@partial(jax.jit, static_argnames=("seq_len", "m", "chunk"))
def topm_scan(
    q_oh: jax.Array,       # int8 [B, LP]
    db_oh: jax.Array,      # int8 [Wp, LP], Wp a multiple of chunk
    n_windows: jax.Array,  # int32 scalar: number of real (unpadded) windows
    seq_len: int,
    m: int,
    chunk: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Exact smallest-M (distance, index) pairs per query row.

    Returns (dist [B, M] int32 ascending, idx [B, M] int32, max_dist [B]
    int32 — the per-query maximum over all real windows, needed for the
    reference's K > num_windows rule, lib.rs:253-256).
    """
    b = q_oh.shape[0]
    wp = db_oh.shape[0]
    n_chunks = wp // chunk
    m = min(m, wp)

    init = (
        jnp.full((b, m), BIG, dtype=jnp.int32),
        jnp.full((b, m), jnp.int32(2**31 - 1), dtype=jnp.int32),
        jnp.full((b,), -1, dtype=jnp.int32),
    )

    def step(carry, off):
        d_carry, i_carry, max_carry = carry
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        gidx = off + jnp.arange(chunk, dtype=jnp.int32)
        valid = gidx < n_windows
        dist_m = jnp.where(valid[None, :], dist, BIG)
        max_carry = jnp.maximum(
            max_carry, jnp.max(jnp.where(valid[None, :], dist, -1), axis=1)
        )
        gidx_b = jnp.broadcast_to(gidx[None, :], (b, chunk))

        # The top_k merge is the expensive part (a sort); skip it when
        # this chunk cannot change any row's top-M. Strict <: an incoming
        # pair equal to a row's current worst sorts after the carry's
        # entries (which hold lower subject indices), so equality never
        # alters the result. After the first few chunks tighten the
        # cutoffs, most chunks take the cheap branch and the scan runs at
        # matmul+min speed.
        improves = jnp.any(jnp.min(dist_m, axis=1) < d_carry[:, m - 1])
        d_new, i_new = jax.lax.cond(
            improves,
            lambda dc, ic: _merge_topm(dc, ic, dist_m, gidx_b, m),
            lambda dc, ic: (dc, ic),
            d_carry, i_carry,
        )
        return (d_new, i_new, max_carry), None

    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (d, i, mx), _ = jax.lax.scan(step, init, offsets)
    return d, i, mx


def packing_shift(seq_len: int, wp: int) -> int | None:
    """Bits for (dist << shift) | index packing; None if > 31 bits total.

    Distances are bounded by seq_len, so for 60 bp windows even a 10M-row
    db packs into one int32 — a single integer ``min`` then yields the
    minimum distance AND its lowest subject index (the reference tie rule,
    lib.rs:306-313 / cluster.rs:62-68) in one reduction.
    """
    bits_idx = max(1, math.ceil(math.log2(max(2, wp))))
    bits_dist = max(1, math.ceil(math.log2(seq_len + 2)))
    if bits_idx + bits_dist > 31:
        return None
    return bits_idx


def min2_chunk_update(carry, dist, lidx, n_windows, gidx, shift, index_span,
                      sentinel):
    """Fold one distance chunk into the running dual packed-key minima.
    Shared by the single-device/row-sharded scans and the ring/column-
    sharded sweeps.

    Padding-row exclusion costs ONE select on the distance (sentinel =
    seq_len + 1, which always fits the key's distance field —
    ``packing_shift`` budgets seq_len + 2 values) instead of one select
    per key: a sentinel distance strictly exceeds every real distance,
    so pad keys lose in BOTH index directions regardless of their index
    bits. This epilogue is not fused into XLA's GEMM on the H100: the
    int32 match block goes through device memory between the two, which
    is what the fused kernel (ops.pallas_scan) avoids."""
    lo_carry, hi_carry = carry
    valid = (lidx < n_windows)[None, :]
    shifted = jnp.where(valid, dist, sentinel) << shift
    key_lo = shifted | gidx[None, :]
    key_hi = shifted | (index_span - 1 - gidx)[None, :]
    return (
        jnp.minimum(lo_carry, jnp.min(key_lo, axis=1)),
        jnp.minimum(hi_carry, jnp.min(key_hi, axis=1)),
    )


def min2c_chunk_update(carry, dist, lidx, n_windows, gidx, shift, index_span,
                       sentinel):
    """``min2_chunk_update`` plus a fused running tie count — the
    one-wave best-hit pass's chunk step (the XLA twin of the fused
    kernel's ``with_count`` epilogue, pallas_scan._min2_kernel).

    The count invariant: ``cnt`` holds the number of windows seen so far
    at the CURRENT minimum distance. Per chunk: ``ccnt`` counts this
    chunk's windows at the post-merge minimum — when the chunk improved
    the minimum, ccnt counts at the new distance and the carry resets;
    when it matched or lost, ccnt counts the chunk's windows at the old
    minimum (possibly 0) and adds. The epilogue costs one extra
    broadcast compare + row-sum over the distance block (~2 integer
    ops/element on top of min2's ~5)."""
    lo_carry, hi_carry, cnt = carry
    valid = (lidx < n_windows)[None, :]
    dv = jnp.where(valid, dist, sentinel)
    shifted = dv << shift
    new_lo = jnp.minimum(lo_carry, jnp.min(shifted | gidx[None, :], axis=1))
    new_hi = jnp.minimum(
        hi_carry, jnp.min(shifted | (index_span - 1 - gidx)[None, :], axis=1)
    )
    old_d = lo_carry >> shift
    new_d = new_lo >> shift
    ccnt = jnp.sum((dv == new_d[:, None]).astype(jnp.int32), axis=1)
    cnt = jnp.where(new_d < old_d, ccnt, cnt + ccnt)
    return new_lo, new_hi, cnt


@partial(jax.jit, static_argnames=("seq_len", "chunk", "shift", "index_span"))
def min2c_scan(
    q_oh: jax.Array,       # int8 [B, LP]
    db_oh: jax.Array,      # int8 [Wp, LP]
    n_windows: jax.Array,  # int32 scalar
    index_offset: jax.Array,  # int32 scalar
    seq_len: int,
    shift: int,
    chunk: int,
    index_span: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """``min2_scan`` + the exact per-row tie count in the same pass.

    Returns (lo, hi, cnt): the dual packed min keys plus the count of
    windows at the row minimum distance (reference lib.rs:296-314 needs
    ALL windows at the min — the count tells best-hit which rows are
    complete from the keys alone, without a separate tcount dispatch).
    Rows whose span holds no valid window return sentinel-distance keys
    with an arbitrary positive count (consumers gate on the decoded
    distance first)."""
    n_chunks = db_oh.shape[0] // chunk
    b = q_oh.shape[0]
    big_key = jnp.int32(2**31 - 1)

    init = (
        jnp.full((b,), big_key, dtype=jnp.int32),
        jnp.full((b,), big_key, dtype=jnp.int32),
        jnp.zeros((b,), dtype=jnp.int32),
    )

    def step(carry, off):
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        lidx = off + jnp.arange(chunk, dtype=jnp.int32)
        gidx = index_offset + lidx
        return min2c_chunk_update(
            carry, dist, lidx, n_windows, gidx, shift, index_span,
            seq_len + 1,
        ), None

    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (lo, hi, cnt), _ = jax.lax.scan(step, init, offsets)
    return lo, hi, cnt


def min2_pair_chunk_update(carry, dist, lidx, n_windows, gidx):
    """Keyless twin of min2_chunk_update for index spaces beyond the
    31-bit packed-key budget: fold one distance chunk into explicit
    (d, i_lo, i_hi) carries with lexicographic tie rules, so chunks may
    arrive in ANY global order (the ring sweep visits owners
    non-monotonically). Sentinels during the sweep: dist BIG (2^30),
    i_lo 2^31-1, i_hi -1 — finish with ``min2_pair_finish``."""
    d, i_lo, i_hi = carry
    big = jnp.int32(2**31 - 1)
    valid = (lidx < n_windows)[None, :]
    dist_m = jnp.where(valid, dist, BIG)
    dmin_c = jnp.min(dist_m, axis=1)
    at = dist_m == dmin_c[:, None]
    gb = jnp.broadcast_to(gidx[None, :], dist.shape)
    il_c = jnp.min(jnp.where(at & valid, gb, big), axis=1)
    ih_c = jnp.max(jnp.where(at & valid, gb, jnp.int32(-1)), axis=1)
    better = dmin_c < d
    tie = dmin_c == d
    i_lo = jnp.where(better, il_c,
                     jnp.where(tie, jnp.minimum(i_lo, il_c), i_lo))
    i_hi = jnp.where(better, ih_c,
                     jnp.where(tie, jnp.maximum(i_hi, ih_c), i_hi))
    return jnp.minimum(d, dmin_c), i_lo, i_hi


def min2_pair_init(b: int):
    return (jnp.full((b,), BIG, jnp.int32),
            jnp.full((b,), jnp.int32(2**31 - 1), jnp.int32),
            jnp.full((b,), jnp.int32(-1), jnp.int32))


def min2_pair_finish(carry):
    """Sweep carries -> the pair-handle convention of
    HitModesMixin._min2_unpack (empty rows: dist 2^30, idx 2^31-1 on
    BOTH sides, so they read as unique)."""
    d, i_lo, i_hi = carry
    big = jnp.int32(2**31 - 1)
    empty = d >= BIG
    return ((jnp.where(empty, BIG, d), jnp.where(empty, big, i_lo)),
            (jnp.where(empty, BIG, d), jnp.where(empty, big, i_hi)))


@partial(jax.jit, static_argnames=("seq_len", "chunk", "shift"))
def min1_scan(
    q_oh: jax.Array,       # int8 [B, LP]
    db_oh: jax.Array,      # int8 [Wp, LP]
    n_windows: jax.Array,  # int32 scalar: valid rows of this db block
    index_offset: jax.Array,  # int32 scalar: global index of db row 0
    seq_len: int,
    shift: int,
    chunk: int,
) -> jax.Array:
    """Single packed min key per row: min over windows of
    (dist << shift) | global_index. The ascending-index half of
    ``min2_scan`` alone — ~20% faster (one min reduce and key pack
    instead of two) for callers that only need the lowest-index best
    hit (the cluster op; reference cluster.rs:62-68 tie rule).

    Implemented as ``minfloor_scan`` with floor -1 (no floor); the
    global index offset is added to the whole key afterwards — the key
    layout makes that exact (the offset only touches the index bits:
    local index + offset < 2^shift by construction), and a constant
    shift commutes with the min."""
    b = q_oh.shape[0]
    key = minfloor_scan(
        q_oh, db_oh, n_windows, jnp.full((b,), -1, jnp.int32),
        seq_len, shift, chunk,
    )
    return key + index_offset


@partial(jax.jit, static_argnames=("seq_len", "chunk", "shift"))
def minfloor_scan(
    q_oh: jax.Array,       # int8 [B, LP]
    db_oh: jax.Array,      # int8 [Wp, LP]
    n_windows: jax.Array,  # int32 scalar
    floor: jax.Array,      # int32 [B]: only windows with index > floor count
    seq_len: int,
    shift: int,
    chunk: int,
) -> jax.Array:
    """Min packed key over windows with global index strictly above a
    per-row floor — the step of iterative tie enumeration: starting from
    floor = the lowest tied index, each pass returns every active row's
    NEXT tied index (the min over the remaining index range has the
    minimum distance while ties remain; a decoded distance above the
    row's minimum means the row is done). Rows with a handful of ties
    enumerate in (max ties - 2) passes at full scan speed instead of
    paying the compaction mask. Exhausted/disabled rows (floor past the
    last window) return sentinel-distance keys."""
    n_chunks = db_oh.shape[0] // chunk
    b = q_oh.shape[0]
    big_key = jnp.int32(2**31 - 1)

    def step(carry, off):
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        lidx = off + jnp.arange(chunk, dtype=jnp.int32)
        valid = ((lidx < n_windows)[None, :]
                 & (lidx[None, :] > floor[:, None]))
        key = (jnp.where(valid, dist, seq_len + 1) << shift) | lidx[None, :]
        return jnp.minimum(carry, jnp.min(key, axis=1)), None

    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    key, _ = jax.lax.scan(step, jnp.full((b,), big_key, jnp.int32), offsets)
    return key


def miditer_chunk_update(carry, dist, lidx, n_windows, gidx, floor, ceil,
                         shift, index_span, sentinel):
    """Fold one distance chunk into the running dual bounded-range
    minima: key_lo = min over windows with floor < idx < ceil of
    (dist << shift) | idx, and key_hi the reverse-index twin (its min
    is the HIGHEST index in the range). One fused pass serves both
    ends of the tie range — the step of the on-device middle
    enumeration (miditer_scan)."""
    lo_carry, hi_carry = carry
    valid = ((lidx < n_windows)[None, :]
             & (gidx[None, :] > floor[:, None])
             & (gidx[None, :] < ceil[:, None]))
    shifted = jnp.where(valid, dist, sentinel) << shift
    key_lo = shifted | gidx[None, :]
    key_hi = shifted | (index_span - 1 - gidx)[None, :]
    return (
        jnp.minimum(lo_carry, jnp.min(key_lo, axis=1)),
        jnp.minimum(hi_carry, jnp.min(key_hi, axis=1)),
    )


def miditer_update(state, key_lo, key_hi, d_star, shift, index_span,
                   seq_len, t):
    """Advance the middle-enumeration cursors from one dual bounded-min
    pass and record the step's finds. ``state`` = (floor, ceil,
    mids_lo [B, T], mids_hi [B, T]); keys may come straight from
    miditer_chunk_update folds or from a cross-shard pmin of offset-
    rebased local keys — any source with global index semantics.

    Per step: the range minimum from the ascending side is the next
    LOWEST remaining tie, the reverse side the next HIGHEST; both are
    middles while their distance equals the row minimum. When exactly
    one middle remains the two sides coincide — it is emitted on the
    lo side only. Exhausted rows decode the sentinel distance and stop.
    """
    floor, ceil, mids_lo, mids_hi = state
    big = jnp.int32(2**31 - 1)
    d_lo = key_lo >> shift
    i_lo = key_lo & jnp.int32((1 << shift) - 1)
    i_hi = index_span - 1 - (key_hi & jnp.int32((1 << shift) - 1))
    act = (d_lo <= jnp.int32(seq_len)) & (d_lo == d_star)
    same = i_lo == i_hi
    mids_lo = mids_lo.at[:, t].set(jnp.where(act, i_lo, -1))
    mids_hi = mids_hi.at[:, t].set(jnp.where(act & ~same, i_hi, -1))
    floor = jnp.where(act, i_lo, big)       # inactive rows scan nothing
    ceil = jnp.where(act & ~same, i_hi, jnp.int32(-1))
    return floor, ceil, mids_lo, mids_hi


@partial(jax.jit,
         static_argnames=("seq_len", "chunk", "shift", "t_steps"))
def miditer_scan(
    q_oh: jax.Array,       # int8 [B, LP]
    db_oh: jax.Array,      # int8 [Wp, LP]
    n_windows: jax.Array,  # int32 scalar
    floor: jax.Array,      # int32 [B]: lowest tied index (already emitted)
    ceil: jax.Array,       # int32 [B]: highest tied index (already emitted)
    d_star: jax.Array,     # int32 [B]: the row minimum distance
    seq_len: int,
    shift: int,
    chunk: int,
    t_steps: int,
) -> tuple[jax.Array, jax.Array]:
    """ALL middle tied indices of each row in ONE device program.

    The round-3 tie enumeration drove one ``minfloor`` dispatch per
    additional tie from the host — up to TIE_ITER_MAX - 2 round trips
    per batch. This runs the loop on device (one program per batch,
    ``lax`` loops instead of host-driven pass loops) and enumerates
    from BOTH ends per pass —
    the ascending and descending range minima reduce over the same
    fused distance block — so ``t_steps`` passes emit up to
    ``2 * t_steps`` middles. Returns (mids_lo, mids_hi), each
    [B, t_steps] int32 with -1 at unused slots; a row's middles are
    the union of its valid entries (disjoint by construction).

    Rows needing no enumeration pass floor = 2^31-1 (scan nothing, at
    matmul-skip cost only). Exactness: while middles remain, the range
    minimum's distance equals d_star; the first pass where it differs
    (or the range empties) deactivates the row, so a drifting row
    under-fills — callers compare fill counts to expected tie counts
    and fall back to exact compaction on mismatch.
    """
    n_chunks = db_oh.shape[0] // chunk
    b = q_oh.shape[0]
    big_key = jnp.int32(2**31 - 1)
    span = db_oh.shape[0]

    def one_pass(floor, ceil):
        def step(carry, off):
            dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
            lidx = off + jnp.arange(chunk, dtype=jnp.int32)
            return miditer_chunk_update(
                carry, dist, lidx, n_windows, lidx, floor, ceil,
                shift, span, seq_len + 1,
            ), None

        init = (jnp.full((b,), big_key, jnp.int32),
                jnp.full((b,), big_key, jnp.int32))
        offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
        (lo, hi), _ = jax.lax.scan(step, init, offsets)
        return lo, hi

    def body(t, state):
        key_lo, key_hi = one_pass(state[0], state[1])
        return miditer_update(state, key_lo, key_hi, d_star, shift, span,
                              seq_len, t)

    init = (floor, ceil,
            jnp.full((b, t_steps), -1, jnp.int32),
            jnp.full((b, t_steps), -1, jnp.int32))
    _, _, mids_lo, mids_hi = jax.lax.fori_loop(0, t_steps, body, init)
    return mids_lo, mids_hi


@partial(jax.jit, static_argnames=("seq_len", "chunk", "shift", "index_span"))
def min2_scan(
    q_oh: jax.Array,       # int8 [B, LP]
    db_oh: jax.Array,      # int8 [Wp, LP]
    n_windows: jax.Array,  # int32 scalar: valid rows of this db block
    index_offset: jax.Array,  # int32 scalar: global index of db row 0
    seq_len: int,
    shift: int,
    chunk: int,
    index_span: int,       # static: global index domain size (for reversal)
) -> tuple[jax.Array, jax.Array]:
    """Per query row: packed min keys with index ascending AND descending.

    key_lo = min over windows of (dist << shift) | global_index
    key_hi = min over windows of (dist << shift) | (span-1 - global_index)

    Both reduce in the same fused pass over the distance block (no
    sequential dependency, so XLA keeps the block in registers). key_lo
    yields the reference's lowest-index best hit (lib.rs:306-313 tie
    rule); key_hi the highest — equal indices mean the minimum is unique
    and best-hit mode needs no enumeration pass. Spans with no valid
    window return sentinel-DISTANCE keys (dist field = seq_len + 1, see
    min2_chunk_update) — consumers detect emptiness by decoded distance
    > seq_len, not by the legacy BIG_KEY value (n_windows == 0 scans
    are guarded host-side anyway). This is the fastest pass over the db (matmul + two
    elementwise mins) and therefore the best-hit phase-A program (the
    fused kernel in ops.pallas_scan replaces it on the GPU for big
    dbs).
    """
    n_chunks = db_oh.shape[0] // chunk
    b = q_oh.shape[0]
    big_key = jnp.int32(2**31 - 1)

    init = (
        jnp.full((b,), big_key, dtype=jnp.int32),
        jnp.full((b,), big_key, dtype=jnp.int32),
    )

    def step(carry, off):
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        lidx = off + jnp.arange(chunk, dtype=jnp.int32)
        gidx = index_offset + lidx
        return min2_chunk_update(
            carry, dist, lidx, n_windows, gidx, shift, index_span,
            seq_len + 1,
        ), None

    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (lo, hi), _ = jax.lax.scan(step, init, offsets)
    return lo, hi


# ---------------------------------------------------------------------------
# One-pass hit-set compaction (the enumeration phase).
#
# Best-hit mode must print EVERY window at the minimum distance in index
# order (reference lib.rs:306-313); K-mode must print every window at
# <= min(Kth-smallest, max_divergence) in (distance, index) order
# (lib.rs:241-295). Both output sets are enumerated by ONE extra pass over
# the db — ``compact_scan``:
#
#   phase A (dispatch): ``min2_scan`` — the dual packed-key min pass.
#            Rows whose minimum is unique (lowest == highest tied index)
#            are fully resolved by phase A alone; K-mode's phase A is the
#            histogram / binary-search cutoff pass instead.
#   phase B (only when some row's min is tied, or in K-mode): one
#            compaction pass. The scan packs each chunk's hit bits
#            (dist <= thresh[row]) into a carried [B, W/32] uint32 mask —
#            a pure elementwise epilogue on the matmul, so this pass runs
#            at scan speed regardless of how many windows hit. A single
#            extraction step then locates the t-th set bit for every
#            output slot via a popcount cumsum + one searchsorted over
#            words (no sort, no scatter). The buffer comes back in
#            (row, index) order; hosts lexsort the few thousand entries
#            when a cross-shard merge or a (distance, index) K-mode order
#            is needed.
#
# Exact per-row hit counts ride along with every call (a popcount row
# sum over the mask), so a caller that guessed t_cap too small retries
# once with exact sizing; callers with histogram counts never overflow.


def mask_words_per_chunk(chunk: int) -> int:
    return (chunk + 31) // 32


CUM_SAT = 2**30 - 1  # clamp for the hit-rank cumsum; far above any
                     # t_cap (hitops.COMPACT_MAX = 1<<22), so every rank
                     # the extraction searches for sits in the exact region


_CUM_SEG = 1 << 25  # words per flat cumsum segment (see proof below)


def _saturating_cumsum(flat, max_elem: int):
    """Inclusive 1-D cumsum equal to ``min(true_cumsum, CUM_SAT)``
    elementwise, for nonnegative int32 entries bounded by ``max_elem``
    (a power of two). Same construction and exactness argument as
    ``_saturating_word_cumsum`` (which is the max_elem=32 case over a
    flattened word matrix): segments sized so one segment's internal
    cumsum stays <= 2^30, threaded through a saturating lax.scan carry."""
    n = flat.shape[0]
    seg = 1 << max(0, 30 - max(1, int(max_elem - 1).bit_length()))
    seg = max(1, min(seg, _CUM_SEG, bucket(n, minimum=1)))
    if n <= seg:
        return jnp.minimum(jnp.cumsum(flat), jnp.int32(CUM_SAT))
    pad = (-n) % seg
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])

    def step(carry, x):
        c = jnp.cumsum(x)
        out = jnp.minimum(carry + jnp.minimum(c, jnp.int32(CUM_SAT)),
                          jnp.int32(CUM_SAT))
        return out[-1], out

    _, outs = jax.lax.scan(step, jnp.int32(0), flat.reshape(-1, seg))
    return outs.reshape(-1)[:n]


def _saturating_word_cumsum(pcw):
    """Inclusive cumsum over flattened [b, w32] word popcounts, equal to
    ``min(true_cumsum, CUM_SAT)`` elementwise — monotone everywhere and
    exact wherever the true running total is below CUM_SAT. Built ONLY
    from the flat 1-D ``cumsum`` lowering (a saturating-combine
    ``associative_scan`` computes the same thing at a far larger
    compile-time cost, and an unguarded flat ``cumsum`` overflows int32
    once a dispatch can carry > 2^31 hit bits, which would force tiny
    row slices).

    Construction: the flat word array is cut into 2^25-word segments and
    ``lax.scan`` threads a saturating carry through per-segment flat
    cumsums (a handful of sequential steps at the mask-budget maximum).

    Exactness (pure int32; jax x64 is disabled): each word's popcount is
    <= 32, so a segment's internal cumsum is <= 32 * 2^25 = 2^30 — exact.
    By induction the carry equals ``min(true_prefix, CUM_SAT)``: adding
    a clamped segment cumsum (<= 2^30) to a carry (<= CUM_SAT < 2^30)
    stays below 2^31, the outer min restores the clamp, and once the
    carry saturates every later true prefix exceeds CUM_SAT too.
    ``row_counts`` is exact: a row's bits fit its span, which is int32
    by construction.
    """
    b, w32 = pcw.shape
    assert b * w32 < 2**31 and w32 * 32 < 2**31, (b, w32)
    row_counts = jnp.sum(pcw, axis=1)
    flat = pcw.reshape(-1)
    n = flat.shape[0]
    seg = min(_CUM_SEG, n)
    pad = (-n) % seg
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])

    def step(carry, x):
        c = jnp.cumsum(x)
        out = jnp.minimum(carry + jnp.minimum(c, jnp.int32(CUM_SAT)),
                          jnp.int32(CUM_SAT))
        return out[-1], out

    _, outs = jax.lax.scan(step, jnp.int32(0), flat.reshape(-1, seg))
    return outs.reshape(-1)[:n], row_counts


def _pack_mode() -> str:
    import os

    # reduce is the fastest lowering on the H100 at the production
    # compact shape (4096 x 2^22 rows, 60 bp; PERF.md, PR 1).
    return os.environ.get("SMAFA_TPU_PACK", "reduce")


_PACK_GROUP = 512  # hit bits per matmul-pack group: 16 words x 5 planes
                   # = 80 output columns <= one 128-lane N tile


def _pack_weights(group: int) -> np.ndarray:
    """[group, 5*group/32] int8 block-diagonal powers-of-two: bit j of
    the group lands in word j//32, plane (j%32)//7, weight 1<<(j%32%7).
    Plane sums stay <= 127, so int8 x int8 -> int32 is exact."""
    w = np.zeros((group, 5 * (group // 32)), np.int8)
    for j in range(group):
        word, bit = divmod(j, 32)
        plane, pos = divmod(bit, 7)
        w[j, 5 * word + plane] = np.int8(1 << pos)
    return w


def _pack_bits(hit, b: int, wpc: int, mode: str):
    """[B, wpc*32] bool hit matrix -> [B, wpc] uint32 words (bit j of
    word w = hit[:, 32w+j]). Three lowerings — the pack epilogue
    dominated round 2's compaction cost (XLA lowers the naive 32-wide
    word reduction poorly on some backends). ``mode`` is passed
    explicitly (resolved
    from SMAFA_TPU_PACK OUTSIDE any jit trace — an env read in here
    would bake the first-seen choice into shape-keyed jit caches):

    - ``matmul``: contract 512-bit groups with a block-diagonal
      powers-of-two int8 matrix (16 words x 5 seven-bit planes = 80
      output columns per group), then 5 shift-or combines.
    - ``tree``: 5 pairwise doubling steps (x[0::2] | x[1::2] << s) —
      O(2*B*chunk) elementwise ops.
    - ``reduce``: the shift-and-sum over the 32 lanes (the default: one
      reduction fusion on the GPU).
    """
    if mode == "matmul" and (wpc * 32) % _PACK_GROUP == 0:
        g = _PACK_GROUP
        wpg = g // 32  # words per group
        planes = jax.lax.dot_general(
            hit.reshape(b * (wpc * 32) // g, g).astype(jnp.int8),
            jnp.asarray(_pack_weights(g)),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).reshape(b, wpc // wpg, wpg, 5).astype(jnp.uint32)
        shifts = (jnp.arange(5, dtype=jnp.uint32) * 7)[None, None, None, :]
        return jnp.sum(planes << shifts, axis=3, dtype=jnp.uint32).reshape(b, wpc)
    if mode == "tree" or mode == "matmul":
        # (matmul falls back here when the chunk is under one group)
        x = hit.astype(jnp.uint32)
        for s in (1, 2, 4, 8, 16):
            x = x[:, 0::2] | (x[:, 1::2] << jnp.uint32(s))
        return x
    bits = hit.reshape(b, wpc, 32).astype(jnp.uint32)
    return jnp.sum(
        bits << jnp.arange(32, dtype=jnp.uint32)[None, None, :],
        axis=2, dtype=jnp.uint32,
    )


def mask_fold_chunk(mask, dist, lidx, n_windows, thresh, chunk_index,
                    pack: str):
    """Pack one chunk's hit bits (dist <= thresh[row]; thresh -1 disables
    a row) into the carried [B, n_chunks*wpc] uint32 mask at word column
    ``chunk_index * wpc``. Bit j of word (c*wpc + w) of row r encodes
    window c*chunk + w*32 + j (local to the scanned span). Shared by the
    single-device/row-sharded scan, the ring sweep, and the
    column-sharded sweep. ``pack`` (the SMAFA_TPU_PACK lowering) must be
    resolved by the caller outside its jit trace."""
    b, chunk = dist.shape
    wpc = mask_words_per_chunk(chunk)
    valid = (lidx < n_windows)[None, :]
    hit = valid & (dist <= thresh[:, None])
    if wpc * 32 != chunk:
        hit = jnp.pad(hit, [(0, 0), (0, wpc * 32 - chunk)])
    words = _pack_bits(hit, b, wpc, pack)
    return jax.lax.dynamic_update_slice(
        mask, words, (jnp.int32(0), chunk_index * wpc)
    )


def extract_mask_hits(mask, index_offset, chunk, t_cap):
    """[B, n_chunks*wpc] uint32 hit mask -> (rows [t_cap], gidx [t_cap],
    row_counts [B], total), hits in (row, window index) ascending order
    with unused slots at rows == -1.

    Round-5 block-sum design. The previous formulation materialized the
    FULL word-level popcount cumsum (O(B*W/32) words through a
    segmented lax.scan) and binary-searched it per slot — at 2048 x 4M
    that cumsum dominated the whole compact pass. Now only G-word BLOCK
    sums are cumsummed (n_words/G entries, saturating at CUM_SAT — see
    _saturating_cumsum); each slot finds its block in the coarse cumsum
    (cache-resident searchsorted), gathers that block's G word counts
    as one CONTIGUOUS row ([t_cap, G] — contiguous gathers, not
    scattered binary probes), and resolves the in-block word with an
    exact [t_cap, G] cumsum + compare-sum. G is static: the largest
    power of two dividing w32 (so block sums nest inside rows and
    row_counts fall out of them), capped at 1024 and by a 256 MB
    [t_cap, G] gather budget.

    Exactness: searched ranks are <= t_cap << CUM_SAT so every prior
    count the slots read sits in the coarse cumsum's exact region;
    in-block cumsums are exact outright (<= 32*G = 2^15); row_counts
    are exact at ANY hit density (a row's bits fit int32); ``total``
    saturates at CUM_SAT, which callers only compare against
    t_cap-sized bounds.
    """
    b, w32 = mask.shape
    wpc = mask_words_per_chunk(chunk)
    flat = mask.reshape(-1)
    pc = jax.lax.population_count(flat).astype(jnp.int32)
    n_words = b * w32
    assert n_words < 2**31 and w32 * 32 < 2**31, (b, w32)
    # Three levels, all sizes independent of t_cap: G1-word blocks feed
    # the saturating coarse cumsum (n_words/G1 entries — small enough
    # to search cache-resident at any span), G2-word sub-blocks bound
    # every per-slot gather to [t_cap, G1/G2] / [t_cap, G2] contiguous
    # rows. (The earlier two-level form shrank G with growing t_cap to
    # bound gather memory, which re-inflated the coarse table to
    # millions of entries at K-mode's 2^21-slot buffers.)
    G1 = 1
    while G1 < 1024 and w32 % (G1 * 2) == 0:
        G1 *= 2
    G2 = min(32, G1)
    spb = G1 // G2
    nb1 = n_words // G1
    nb2 = n_words // G2
    pcb2 = pc.reshape(nb2, G2)
    sb = jnp.sum(pcb2, axis=1)               # [nb2] sub-block sums <= 32*G2
    bs = jnp.sum(sb.reshape(nb1, spb), axis=1)
    row_counts = jnp.sum(bs.reshape(b, w32 // G1), axis=1)
    coarse = _saturating_cumsum(bs, 32 * G1)
    total = coarse[-1]
    slots = jnp.arange(t_cap, dtype=jnp.int32)
    r = slots + 1
    cb = jnp.minimum(
        jnp.searchsorted(coarse, r, side="left").astype(jnp.int32), nb1 - 1
    )
    prior1 = jnp.where(cb > 0, coarse[jnp.maximum(cb - 1, 0)], 0)
    rr = r - prior1                          # 1-based rank within block

    def _level(counts_2d, sel, rank):
        """One in-block resolution step: gather selected contiguous
        rows of per-unit counts, exact cumsum, position + prior."""
        g = jnp.take(counts_2d, sel, axis=0)
        c = jnp.cumsum(g, axis=1)            # exact: <= 32*G1 = 2^15
        pos = jnp.minimum(
            jnp.sum((c < rank[:, None]).astype(jnp.int32), axis=1),
            counts_2d.shape[1] - 1,
        )
        prior = jnp.where(
            pos > 0,
            jnp.take_along_axis(
                c, jnp.maximum(pos - 1, 0)[:, None], axis=1
            )[:, 0],
            0,
        )
        return pos, prior

    if spb > 1:
        pos2, prior2 = _level(sb.reshape(nb1, spb), cb, rr)
        sbi = cb * spb + pos2
        rr2 = rr - prior2
    else:
        sbi, rr2 = cb, rr
    pos3, prior3 = _level(pcb2, sbi, rr2)
    wsel = sbi * G2 + pos3
    r_word = rr2 - prior3  # 1-based rank of the wanted bit within its word
    word = flat[wsel]
    # r_word-th set bit via a 5-step binary search on prefix popcounts
    # (invariant: the low `bit` bits hold < r_word set bits) — ~7 ops
    # per step on [t_cap] vs the former [t_cap, 32] expansion + 32-lane
    # cumsum, which dominated extraction at millions of slots.
    bit = jnp.zeros_like(r_word)
    for step in (16, 8, 4, 2, 1):
        trial = bit + step  # <= 31 by construction (16+8+4+2+1)
        pc_pref = jax.lax.population_count(
            word & ((jnp.uint32(1) << trial.astype(jnp.uint32)) - 1)
        ).astype(jnp.int32)
        bit = jnp.where(pc_pref < r_word, trial, bit)
    row = wsel // w32
    wr = wsel % w32
    lidx = (wr // wpc) * chunk + (wr % wpc) * 32 + jnp.minimum(bit, 31)
    take = slots < total
    return (
        jnp.where(take, row, -1),
        jnp.where(take, index_offset + lidx, -1),
        row_counts,
        total,
    )


@partial(jax.jit, static_argnames=("seq_len", "chunk", "t_cap", "pack"))
def compact_scan(
    q_oh: jax.Array,       # int8 [B, LP]
    db_oh: jax.Array,      # int8 [Wp, LP]
    n_windows: jax.Array,  # int32 scalar
    thresh: jax.Array,     # int32 [B]: per-row inclusive cutoff (-1 = skip row)
    index_offset: jax.Array,  # int32 scalar
    seq_len: int,
    chunk: int,
    t_cap: int,
    pack: str,             # static: bit-pack lowering (resolve env at call site)
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One pass: every (row, window) with dist <= thresh[row], flattened.

    Returns (rows [t_cap], idx [t_cap], row_counts [B], total) with
    unused slots at rows == -1. Output is ordered by (row, window index)
    — the best-hit emission order; K-mode re-orders per row by
    (dist, index) on the host (per-hit distances are recomputed there
    from the channel codes — see hitops._host_distances). Hits beyond
    t_cap are dropped from the buffer but still counted exactly in
    row_counts/total, so the caller can retry with exact sizing.
    """
    n_chunks = db_oh.shape[0] // chunk
    b = q_oh.shape[0]
    wpc = mask_words_per_chunk(chunk)
    init = jnp.zeros((b, n_chunks * wpc), jnp.uint32)

    def step(mask, ci):
        off = ci * chunk
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        lidx = off + jnp.arange(chunk, dtype=jnp.int32)
        return mask_fold_chunk(mask, dist, lidx, n_windows, thresh, ci,
                               pack), None

    cis = jnp.arange(n_chunks, dtype=jnp.int32)
    mask, _ = jax.lax.scan(step, init, cis)
    return extract_mask_hits(mask, index_offset, chunk, t_cap)


@partial(jax.jit, static_argnames=("seq_len", "chunk", "t_cap", "pack",
                                   "shift"))
def compactd_scan(
    q_oh: jax.Array,       # int8 [B, LP/EP] (expanded query)
    q_codes: jax.Array,    # uint8 [B, L] (raw codes — distance recompute)
    db_codes: jax.Array,   # uint8 [Wp, L] codes-resident db
    n_windows: jax.Array,
    thresh: jax.Array,
    index_offset: jax.Array,
    seq_len: int,
    chunk: int,
    t_cap: int,
    pack: str,
    shift: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """``compact_scan`` with the per-hit DISTANCE recomputed on device
    and packed with the index into one int32 key per slot:
    ``(dist << shift) | idx`` (-1 at unused slots). Returns
    (keys [t_cap], row_counts [B], total).

    Two costs disappear versus compact_scan + the separate hitdist
    program: the redundant rows array (the buffer is (row, idx)-major,
    so rows reconstruct exactly as repeat(row_ids, counts) on host) and
    the whole hitdist round trip (its upload was the idx buffer this
    program just computed): ~3.5x less per-batch hit traffic and one
    fewer dispatch. K-mode semantics unchanged (reference lib.rs:241-295)."""
    rows, idx, rc, total = compact_scan(
        q_oh, db_codes, n_windows, thresh, index_offset, seq_len, chunk,
        t_cap, pack,
    )
    lidx = idx - index_offset
    qg = jnp.take(q_codes, jnp.maximum(rows, 0), axis=0)[:, :seq_len]
    dg = jnp.take(db_codes, jnp.maximum(lidx, 0), axis=0)[:, :seq_len]
    dv = jnp.sum((qg != dg).astype(jnp.int32), axis=1)
    keys = jnp.where(rows >= 0, (dv << shift) | idx, -1)
    return sort_hit_keys(rows, keys), rc, total


def sort_hit_keys(rows: jax.Array, keys: jax.Array) -> jax.Array:
    """Device-side (row, dist, idx) ordering of per-hit packed keys:
    two-key sort on (row, (dist << shift) | idx) with unused slots
    (row -1) pushed to the end. Replaces the host argsort of millions
    of hits; the row grouping survives, so rows still reconstruct as
    repeat(row_ids, counts)."""
    rows_s = jnp.where(rows >= 0, rows, jnp.int32(2**30))
    _, keys_sorted = jax.lax.sort((rows_s, keys), num_keys=2)
    return keys_sorted


HIST_MAX = 1024  # histogram path only for seq_len < HIST_MAX (else binary search)


def hist_chunk_update(carry, dist, lidx, n_windows, seq_len):
    """Fold one distance chunk into the running [B, seq_len+1] histogram."""
    valid = (lidx < n_windows)[None, :, None]
    bins = jnp.arange(seq_len + 1, dtype=jnp.int32)[None, None, :]
    return carry + jnp.sum(
        (dist[:, :, None] == bins) & valid, axis=1, dtype=jnp.int32
    )


@partial(jax.jit, static_argnames=("seq_len", "chunk"))
def hist_scan(
    q_oh: jax.Array, db_oh: jax.Array, n_windows: jax.Array,
    seq_len: int, chunk: int,
) -> jax.Array:
    """[B, seq_len+1] exact distance histogram — the K-mode phase-A program.

    One pass yields everything the reference's cutoff rule needs
    (lib.rs:253-256): the Kth-smallest distance, the per-row max, and the
    exact hit count at any cutoff all read off the host-side cumulative
    sum of a [B, L+1] table, replacing round 1's ~log2(L) binary-search
    count scans.
    """
    b = q_oh.shape[0]
    n_chunks = db_oh.shape[0] // chunk

    def step(carry, off):
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        lidx = off + jnp.arange(chunk, dtype=jnp.int32)
        return hist_chunk_update(carry, dist, lidx, n_windows, seq_len), None

    init = jnp.zeros((b, seq_len + 1), jnp.int32)
    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    hist, _ = jax.lax.scan(step, init, offsets)
    return hist


def kmode_cutoffs_from_hist(hist: np.ndarray, k: int,
                            max_divergence: int | None,
                            n_windows: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side K-mode cutoff rule from the distance histogram.

    Returns (eff [B] effective cutoff, hits [B] exact hit count), with the
    reference semantics: cutoff = Kth-smallest distance, or the per-row
    max when K > number of db windows (lib.rs:253-256); eff = min(cutoff,
    max_divergence); hits = count of windows at <= eff (cutoff ties
    included, lib.rs:261-265).
    """
    seq_len = hist.shape[1] - 1
    cum = hist.cumsum(axis=1)
    kth = (cum < k).sum(axis=1)  # first t with cum[t] >= k; L+1 if none
    nz = hist > 0
    maxd = seq_len - np.argmax(nz[:, ::-1], axis=1)  # last nonzero bin
    cutoff = np.where(k > n_windows, maxd, kth).astype(np.int64)
    if max_divergence is not None:
        cutoff = np.minimum(cutoff, max_divergence)
    eff = np.clip(cutoff, 0, seq_len)
    hits = cum[np.arange(hist.shape[0]), eff]
    return eff.astype(np.int32), hits.astype(np.int32)


# ---------------------------------------------------------------------------
# K-mode (top-K with cutoff ties) without any sort.
#
# The packed key (dist << shift) | index orders pairs exactly by
# (distance, subject_index) — the reference's K-mode output order
# (lib.rs:243-250). The reference cutoff is the Kth smallest distance (or
# the row max when K > W, lib.rs:253-256), and every pair with
# d <= min(cutoff, max_divergence) prints. So K-mode reduces to:
#
#   phase 1: per row, find max distance + binary-search the Kth smallest
#            distance with fused <=-count scans (7 passes), then the exact
#            hit count at the effective cutoff;
#   phase 2: enumerate the hit set in key order from BOTH ends — the min
#            remaining key and the max remaining key per pass (the max via
#            a reverse key ((L - dist) << shift) | (span-1 - index), whose
#            min is the (dist, idx)-max) — writing a front cursor forward
#            and a back cursor backward into a [B, cap] buffer that is
#            therefore already sorted when the cursors meet.
#
# Every pass is matmul + elementwise mask + min/sum reductions — the same
# fused shape as min2_scan; no top_k, no sort, no HBM intermediates.


KSTATS_PROBES = 4  # per-row thresholds probed per kstats pass


def kstats_steps(seq_len: int) -> int:
    """Passes the partition search needs: each pass has
    KSTATS_PROBES - 1 interior probes cutting the candidate range
    [lo, hi] to <= (hi-lo) // KSTATS_PROBES, so ranges shrink
    60 -> 15 -> 3 -> 0 at 60 bp with 4 probes = 3 passes."""
    steps, n = 0, seq_len
    while n > 0:
        n //= KSTATS_PROBES
        steps += 1
    return max(1, steps)


def kmode_phase1(scan_statsN, k, maxdiv, n_windows, seq_len, b):
    """Cutoff search with MULTI-PROBE passes (round 5).

    ``scan_statsN(ts [4, B]) -> (counts [4, B], max [B])``: counts at
    four per-row thresholds in ONE fused db pass (each extra threshold
    is one compare+sum on the distance block, ~6-8% of a pass — far
    cheaper than another full pass). Three probes drive a 4-way
    partition search for the smallest t with count(<= t) >= k; the
    fourth always probes min(maxdiv, L). Tracking the count AT the
    running upper bound removes the final exact-count pass too: at
    60 bp the round-4 binary search paid 8 full passes (6 bisections +
    initial max + final count), this pays 3. k, maxdiv are traced int32
    scalars (maxdiv = seq_len+1 if unused). Returns (eff [B] effective
    cutoff, hits [B] exact count) per the reference cutoff rule
    (lib.rs:253-265).
    """
    steps = kstats_steps(seq_len)
    nw_b = jnp.broadcast_to(jnp.asarray(n_windows, jnp.int32), (b,))
    md_c = jnp.minimum(maxdiv, jnp.int32(seq_len))
    lo = jnp.zeros((b,), jnp.int32)
    hi = jnp.full((b,), seq_len, jnp.int32)
    # count(<= seq_len) == n_windows, so the upper bound's count is
    # known before any pass; it only ever tightens.
    cnt_hi = nw_b
    cnt_md = jnp.zeros((b,), jnp.int32)
    mx = jnp.full((b,), -1, jnp.int32)
    P = KSTATS_PROBES

    def body(_, carry):
        lo, hi, cnt_hi, _cnt_md, _mx = carry
        # P-1 interior probes + the constant maxdiv probe (everything
        # below derives from KSTATS_PROBES so the constant, the probe
        # stack, and kstats_steps' shrink factor cannot drift apart)
        ms = [(lo * (P - i) + hi * i) // P for i in range(1, P)]
        ts = jnp.stack(ms + [jnp.broadcast_to(md_c, lo.shape)])
        cnts, mx = scan_statsN(ts)
        # smallest probe with count >= k bounds the answer from above;
        # fold the cascade from the last interior probe down
        new_hi, new_cnt = hi, cnt_hi
        new_lo = ms[-1] + 1
        for i in range(len(ms) - 1, -1, -1):
            ge = cnts[i] >= k
            new_hi = jnp.where(ge, ms[i], new_hi)
            new_cnt = jnp.where(ge, cnts[i], new_cnt)
            prev_lo = lo if i == 0 else ms[i - 1] + 1
            new_lo = jnp.where(ge, prev_lo, new_lo)
        return (jnp.minimum(new_lo, new_hi), new_hi, new_cnt,
                cnts[P - 1], mx)

    lo, hi, cnt_hi, cnt_md, mx = jax.lax.fori_loop(
        0, steps, body, (lo, hi, cnt_hi, cnt_md, mx)
    )
    kth = hi  # smallest t with count(<= t) >= k (== seq_len if k > count)
    cutoff = jnp.where(k > n_windows, mx, kth)
    eff = jnp.minimum(cutoff, maxdiv)
    # hits at eff, no extra pass: eff is md_c (probed every pass), kth
    # (tracked), or the row max (count(<= max) == n_windows). Collisions
    # agree by monotonicity, so the branch order is free.
    hits = jnp.where(eff == md_c, cnt_md,
                     jnp.where(eff == kth, cnt_hi, nw_b))
    return eff, hits


@partial(jax.jit, static_argnames=("seq_len", "chunk"))
def kmode_stats_scan(q_oh, db_oh, n_windows, k, maxdiv, seq_len, chunk):
    """K-mode phase-A program (single device): (eff cutoff, exact hit
    count) via multi-probe partition-search count scans. No packed keys
    anywhere, so this path is row-count-unbounded."""
    def scan_statsN(ts):
        return _statsN_pass(q_oh, db_oh, n_windows, ts, seq_len, chunk)

    return kmode_phase1(scan_statsN, k, maxdiv, n_windows, seq_len,
                        q_oh.shape[0])


def stats_chunk_update(carry, dist, lidx, n_windows, t):
    """Fold one distance chunk into the running (count <= t, max) stats.

    Shared by the single-device/row-sharded passes (dist from the plain
    matmul) and the column-sharded pass (dist from a psum of partial
    matmuls) — the selection semantics live in exactly one place.
    """
    cnt, mx = carry
    valid = (lidx < n_windows)[None, :]
    cnt = cnt + jnp.sum(valid & (dist <= t[:, None]), axis=1, dtype=jnp.int32)
    mx = jnp.maximum(mx, jnp.max(jnp.where(valid, dist, -1), axis=1))
    return cnt, mx


def _stats_pass(q_oh, db_oh, n_windows, t, seq_len, chunk):
    """One fused pass: (count of dist <= t[row], max dist) per row."""
    b = q_oh.shape[0]
    n_chunks = db_oh.shape[0] // chunk

    def step(carry, off):
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        lidx = off + jnp.arange(chunk, dtype=jnp.int32)
        return stats_chunk_update(carry, dist, lidx, n_windows, t), None

    init = (jnp.zeros((b,), jnp.int32), jnp.full((b,), -1, jnp.int32))
    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (cnt, mx), _ = jax.lax.scan(step, init, offsets)
    return cnt, mx


def statsN_chunk_update(carry, dist, lidx, n_windows, ts):
    """Multi-probe twin of ``stats_chunk_update``: fold one distance
    chunk into running (counts at P per-row thresholds, max) stats —
    each extra threshold costs one compare + sum over the distance
    block, which is how the kstats partition search probes several
    candidates per db pass. ``ts`` is int32 [P, B]."""
    cnt, mx = carry
    valid = (lidx < n_windows)[None, :]
    # UNROLLED per-probe 2-D compare+sums: P separate [B, C] epilogues
    # are the plain fused pattern; a single [P, B, C] broadcast compare
    # is the 3-D shape that made the histogram pass uncompetitive.
    # Not yet measured on the H100.
    per = [
        jnp.sum(valid & (dist <= ts[p][:, None]), axis=1, dtype=jnp.int32)
        for p in range(ts.shape[0])
    ]
    cnt = cnt + jnp.stack(per)
    mx = jnp.maximum(mx, jnp.max(jnp.where(valid, dist, -1), axis=1))
    return cnt, mx


def _statsN_pass(q_oh, db_oh, n_windows, ts, seq_len, chunk):
    """One fused pass: (counts [P, B] at per-row thresholds ts [P, B],
    max dist [B])."""
    b = q_oh.shape[0]
    p = ts.shape[0]
    n_chunks = db_oh.shape[0] // chunk

    def step(carry, off):
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        lidx = off + jnp.arange(chunk, dtype=jnp.int32)
        return statsN_chunk_update(carry, dist, lidx, n_windows, ts), None

    init = (jnp.zeros((p, b), jnp.int32), jnp.full((b,), -1, jnp.int32))
    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (cnt, mx), _ = jax.lax.scan(step, init, offsets)
    return cnt, mx


def unpack_key(key: np.ndarray, shift: int) -> tuple[np.ndarray, np.ndarray]:
    """Packed keys -> (distance, index); BIG/int32-max for empty rows."""
    big = key == np.int32(2**31 - 1)
    dist = np.where(big, np.int32(2**30), key >> shift).astype(np.int32)
    idx = np.where(big, np.int32(2**31 - 1), key & ((1 << shift) - 1)).astype(np.int32)
    return dist, idx


@partial(jax.jit, static_argnames=("seq_len", "chunk"))
def min_scan(
    q_oh: jax.Array,
    db_oh: jax.Array,
    n_windows: jax.Array,
    seq_len: int,
    chunk: int,
) -> tuple[jax.Array, jax.Array]:
    """(min distance, first argmin) per query row — the cluster-op kernel
    (reference cluster.rs:51-68 semantics: lowest index among ties).

    Uses the packed-key reduction when the (seq_len, Wp) pair fits 31 bits
    (always, for this domain); falls back to a (dist, idx) pair carry.
    """
    b = q_oh.shape[0]
    wp = db_oh.shape[0]
    shift = packing_shift(seq_len, wp)
    if shift is not None:
        # Single-key reduction: the dual (ascending+descending) pass
        # pays for a second key this caller discards — cluster only
        # needs the lowest-index min.
        key = min1_scan(
            q_oh, db_oh, n_windows, jnp.int32(0), seq_len, shift, chunk
        )
        big = key == jnp.int32(2**31 - 1)
        return (
            jnp.where(big, BIG, key >> shift),
            jnp.where(big, jnp.int32(2**31 - 1), key & ((1 << shift) - 1)),
        )

    n_chunks = wp // chunk
    init = (
        jnp.full((b,), BIG, dtype=jnp.int32),
        jnp.full((b,), jnp.int32(2**31 - 1), dtype=jnp.int32),
    )

    def step(carry, off):
        d_carry, i_carry = carry
        dist = block_distances(q_oh, db_oh, off, chunk, seq_len)
        gidx = off + jnp.arange(chunk, dtype=jnp.int32)
        dist = jnp.where((gidx < n_windows)[None, :], dist, BIG)
        blk_min = jnp.min(dist, axis=1)
        blk_arg = jnp.argmin(dist, axis=1).astype(jnp.int32) + off
        better = blk_min < d_carry  # strict: earlier chunks keep ties (lower idx)
        return (
            jnp.where(better, blk_min, d_carry),
            jnp.where(better, blk_arg, i_carry),
        ), None

    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (d, i), _ = jax.lax.scan(step, init, offsets)
    return d, i


def bucket(n: int, minimum: int = 16) -> int:
    """Power-of-two size bucketing — the single shape-bucketing policy
    (jit program shapes, top-M widths, capacity growth)."""
    return max(minimum, 1 << math.ceil(math.log2(max(1, n))))


# Ceiling of the auto chunk size (db rows per scan step). Bigger chunks
# mean fewer lax.scan steps and better XLA scheduling, and a bigger
# [B, chunk] match block per step. Not yet measured on the H100.
CHUNK_MAX = 16384


def default_chunk(n_windows: int, n_shards: int = 1) -> int:
    """Auto chunk: db rows per scan step on one shard.

    Two regimes, take the max: the small-db rule (one step for anything
    up to 2048 rows — a tiny db should not pay multi-step scan overhead)
    and the big-db rule (grow toward CHUNK_MAX but keep at least ~8 scan
    steps per shard, so rounding the shard up to a chunk multiple wastes
    at most ~1/8 of its rows on padding)."""
    small = min(2048, bucket(n_windows, 128))
    big = min(CHUNK_MAX, bucket(max(1, n_windows // (8 * max(1, n_shards))), 128))
    return max(small, big)


def pad_batch(
    q_codes: np.ndarray, multiple: int = 1, minimum: int = 16
) -> tuple[np.ndarray, int, int]:
    """Pad a query batch to a power-of-two bucket rounded up to a multiple
    of the mesh axis size. Returns (padded, nq, b).

    The single batch-padding rule for every runner: power-of-two
    bucketing caps the number of distinct jit program shapes; rounding to
    ``multiple`` keeps shard_map splits even. Padded rows produce garbage
    results that callers trim with nq.
    """
    nq = q_codes.shape[0]
    b = ((bucket(nq, minimum) + multiple - 1) // multiple) * multiple
    if nq < b:
        q_codes = np.pad(q_codes, [(0, b - nq), (0, 0)])
    return q_codes, nq, b
