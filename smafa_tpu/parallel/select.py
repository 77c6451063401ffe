"""Db layout selection: which sharded runner the engine instantiates.

Three layouts implement the same exact hit-mode contract
(parallel.hitops.HitModesMixin):

- ``sharded`` — ScanRunner, ('q', 'w') mesh: db rows sharded over 'w',
  queries replicated per q-group; shard merges are elementwise pmin/psum
  over O(B) packed keys. Merge traffic is tiny and every device reads its
  db shard from local HBM, so this is the default at every row count —
  including the 10M-row scale (per-device HBM holds rows/n_devices).
- ``ring`` — RingScanRunner, 1-D 'd' ring: queries AND rows sharded over
  the same axis; db shards rotate via ppermute. Rotation streams the
  whole db through the interconnect once per batch, so it only wins
  when the query side is too large to replicate (huge resident
  batches) or when all-to-device merge traffic must stay
  neighbor-local; it is selected via SMAFA_TPU_LAYOUT=ring, not auto.
- ``col`` — ColumnShardedScanRunner, 1-D 'c' axis: the one-hot FEATURE
  axis is sharded and distances are psum-reassembled — the sequence-
  parallel layout for very long windows, auto-selected when the window
  is so long that a single device's matmul is contraction-bound
  (seq_len >= SMAFA_TPU_COL_SEQ_THRESHOLD, default 8192).

A fourth layout handles dbs the resident three cannot:

- ``stream`` — SlabStreamRunner (parallel/slab.py): the db never
  resides on device; fixed-shape row slabs stream through HBM per
  batch and fold into carried accumulators. Auto-selected when the
  resident db form (uint8 codes by default, one-hot under
  SMAFA_TPU_DB_CODES=0) would overflow the visible devices' HBM (the
  reference, at 40 packed bytes/row in host RAM, handles such dbs on
  any big-RAM box — reference lib.rs:54-60 — so this build must too).

``SMAFA_TPU_LAYOUT`` ∈ {auto, sharded, ring, col, stream} overrides the
choice (the forced values are exercised by the golden/fuzz suites).
Multi-host runs always use ``sharded``: its process path assembles
per-device db shards from a memmap so no host reads rows it does not
own.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from smafa_tpu.ops import distance as D

logger = logging.getLogger("smafa")

COL_SEQ_THRESHOLD = 8192

# Auto-select the streaming layout when the one-hot db needs more than
# this fraction of the visible devices' total HBM (programs need working
# space next to the resident tensor).
HBM_FRACTION = 0.75


def _hbm_capacity(per_device: bool = False) -> int | None:
    """Device memory in bytes — TOTAL across visible devices by default,
    or one device's share with ``per_device=True`` — as the backend
    reports it (``memory_stats()["bytes_limit"]``). None on CPU meshes,
    which report no capacity. An accelerator that reports none is an
    error, not a guess. SMAFA_TPU_HBM_BYTES overrides and ALWAYS means
    the total across visible devices (also how tests force the
    out-of-core decisions)."""
    import jax

    env = os.environ.get("SMAFA_TPU_HBM_BYTES")
    if env:
        total = int(env)
    else:
        total = 0
        for d in jax.devices():
            stats = d.memory_stats()
            if stats and "bytes_limit" in stats:
                total += int(stats["bytes_limit"])
                continue
            if d.platform == "cpu":
                return None
            raise RuntimeError(
                f"device {d.device_kind!r} ({d.platform}) reports no memory "
                "capacity (memory_stats() has no bytes_limit); set "
                "SMAFA_TPU_HBM_BYTES to the total device memory in bytes"
            )
    if not total:
        return None
    return total // len(jax.devices()) if per_device else total


def _resident_row_bytes(seq_len: int) -> int:
    """Bytes per db row in the form the resident layouts would hold: raw
    uint8 codes by default (sharded/ring expand per chunk), padded
    one-hot when SMAFA_TPU_DB_CODES=0 forces the one-hot form."""
    from smafa_tpu.parallel.sharded import _db_codes_resident

    return seq_len if _db_codes_resident() else D.padded_feature_dim(seq_len)


def choose_layout(n_windows: int, seq_len: int) -> str:
    import jax

    env = os.environ.get("SMAFA_TPU_LAYOUT", "auto").lower()
    if env in ("sharded", "ring", "col", "stream"):
        return env
    if env not in ("", "auto"):
        raise ValueError(
            f"SMAFA_TPU_LAYOUT={env!r}: expected auto, sharded, ring, col, "
            "or stream"
        )
    if jax.process_count() > 1:
        return "sharded"
    if D.packing_shift(seq_len, max(2, 2 * n_windows)) is None:
        # GLOBAL packed keys overflow 31 bits (giant row counts, or very
        # long windows). Both big-db layouts keep packed-key speed by
        # packing locally and pair-merging: sharded per SHARD (resident,
        # preferred when the one-hot fits the devices' HBM), stream per
        # SLAB (out-of-core). Only when even a local span cannot pack
        # (astronomical window lengths) does ScanRunner's exact top-M
        # fallback serve.
        if D.packing_shift(seq_len, 1 << 24) is None:
            return "sharded"
        n_dev = len(jax.devices())
        cap = _hbm_capacity()
        # Multi-device meshes keep the resident sharded layout (pair
        # mode) when the one-hot fits — and when capacity is unreported,
        # assume it fits, exactly as the non-overflow default does. A
        # single device has no pair-merge axis, so stream (slab-local
        # keys) is the exact fast path there.
        if (n_dev > 1
                and (cap is None
                     or _resident_row_bytes(seq_len) * n_windows
                     <= HBM_FRACTION * cap)
                and D.packing_shift(
                    seq_len, max(2, 2 * (n_windows // n_dev))) is not None):
            return "sharded"
        return "stream"
    cap = _hbm_capacity()
    if cap is not None:
        need = _resident_row_bytes(seq_len) * n_windows
        if need > HBM_FRACTION * cap:
            return "stream"
    if len(jax.devices()) <= 1:
        return "sharded"
    threshold = int(os.environ.get("SMAFA_TPU_COL_SEQ_THRESHOLD",
                                   COL_SEQ_THRESHOLD))
    if seq_len >= threshold:
        return "col"
    return "sharded"


def make_runner(codes: np.ndarray, seq_len: int):
    """Instantiate the selected layout's runner over the visible devices."""
    layout = choose_layout(int(codes.shape[0]), seq_len)
    logger.debug("db layout: %s (%d windows, length %d)",
                 layout, codes.shape[0], seq_len)
    if layout == "ring":
        from smafa_tpu.parallel import ring

        return ring.RingScanRunner(codes, seq_len)
    if layout == "col":
        from smafa_tpu.parallel import seqpar

        return seqpar.ColumnShardedScanRunner(codes, seq_len)
    if layout == "stream":
        from smafa_tpu.parallel import slab

        return slab.SlabStreamRunner(codes, seq_len)
    from smafa_tpu.parallel import sharded

    return sharded.ScanRunner(codes, seq_len)
