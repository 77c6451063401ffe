"""Throughput benchmark: query x db sequence comparisons/sec on one GPU.

Measures the SHIPPED best-hit phase-A program — the dual packed-key
Hamming min scan, built exactly as `smafa_tpu query` builds it per batch
in its default mode (the fused Pallas/Triton kernel where its gate
allows, else ops.distance.min2_scan) — the replacement for the
reference's serial popcount loop (reference lib.rs:80-88, 232-238):
60 bp windows, a 2^22-row codes-resident db, one 65,536-query batch.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"} where vs_baseline is value / 1e9 (the north-star >= 1e9
comparisons/sec/chip) and device names the platform, kind and count.

Without a GPU the script fails; ``--smoke`` runs it at CPU-sized shapes
on whatever backend JAX has (the CI/test smoke — its numbers are not
device metrics). ``--kernel {min2,compact,hist}`` benches a specific
pass; SMAFA_TPU_PALLAS_MIN2=0/1 and SMAFA_TPU_PACK pick the variants.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from smafa_tpu.core.alphabet import N_CHANNELS
from smafa_tpu.ops import distance as D

NORTH_STAR = 1.0e9  # comparisons/sec/chip (BASELINE.json north_star)


def build_kernel(name: str, seq_len: int, n_windows: int, chunk: int,
                 db_codes=None, batch: int | None = None):
    shift = D.packing_shift(seq_len, n_windows)
    nw = jnp.int32(n_windows)
    zero = jnp.int32(0)

    if name == "min2":
        # The SHIPPED phase-A program, built exactly as `smafa_tpu query`
        # builds it (ScanRunner._build_min2): the fused kernel over the
        # embedded db twin where eligible, the XLA min2_scan elsewhere
        # (CPU smoke included). The runner holds the db; the scan's db
        # argument is ignored.
        from smafa_tpu.parallel import sharded

        runner = sharded.ScanRunner(
            db_codes, seq_len, mesh=sharded.build_mesh(1, 1), chunk=chunk,
        )
        fn = runner._program("min2", batch, shift=runner._key_shift())

        def scan(q, _db=None):
            return fn(q, runner.db_oh, runner.n_windows_dev)
    elif name == "compact":
        # The SHIPPED compact program, built as the runner builds it:
        # the XLA mask scan with the SMAFA_TPU_PACK lowering.
        from smafa_tpu.parallel import sharded

        runner = sharded.ScanRunner(
            db_codes, seq_len, mesh=sharded.build_mesh(1, 1), chunk=chunk,
        )
        fn = runner._program("compact", batch, t_cap=4096)
        thresh = np.full((batch,), seq_len // 8, np.int32)

        def scan(q, _db=None):
            return fn(q, runner.db_oh, runner.n_windows_dev, thresh)
    elif name == "hist":
        @jax.jit
        def scan(q, db):
            return D.hist_scan(
                D.expand_query(q, seq_len, db.shape[1]), db, nw, seq_len, chunk
            )
    else:
        raise SystemExit(f"unknown kernel {name}")
    return scan


def main() -> int:
    from smafa_tpu.utils.platform import apply_platform_env, enable_compilation_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="min2",
                    choices=["min2", "compact", "hist"])
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-sized shapes on any backend (not a device "
                         "measurement)")
    args = ap.parse_args()

    apply_platform_env()  # honor an explicit JAX_PLATFORMS=cpu (CI smoke)
    dev = jax.devices()[0]
    if not args.smoke and dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX runs on {dev.platform!r}); use --smoke "
              "for the CPU-sized smoke", file=sys.stderr)
        return 2
    enable_compilation_cache()

    seq_len = 60
    if args.smoke:
        n_windows, batch, chunk = 1 << 14, 512, 2048
        iters, warmup = 3, 1
    else:
        # chunk matches D.default_chunk at this shape and batch matches
        # engine._auto_batch for a >= 2^22-row resident db.
        n_windows, batch, chunk = 1 << 22, 65536, 16384
        iters, warmup = 5, 2
    if args.kernel == "compact":
        # Compaction dispatches are row-sliced in production so the hit
        # mask's rank cumsum stays exact (hitops.mask_row_cap); bench the
        # shipped dispatch shape, not one the engine never runs.
        from smafa_tpu.parallel.hitops import mask_row_cap

        batch = min(batch, mask_row_cap(n_windows))

    rng = np.random.default_rng(42)
    db_codes = rng.integers(0, N_CHANNELS, size=(n_windows, seq_len), dtype=np.uint8)
    q_codes = rng.integers(0, N_CHANNELS, size=(batch, seq_len), dtype=np.uint8)

    # Shipped resident form: uint8 channel codes (seq_len bytes/row);
    # every kernel's chunk loop expands one chunk at a time on device
    # (distance.block_distances dispatches on the db's width).
    db_dev = jax.device_put(db_codes)
    db_dev.block_until_ready()
    scan = build_kernel(args.kernel, seq_len, n_windows, chunk,
                        db_codes=db_codes, batch=batch)

    q_dev = jax.device_put(q_codes)
    for _ in range(warmup):
        jax.block_until_ready(scan(q_dev, db_dev))

    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(scan(q_dev, db_dev))
        best = min(best, time.perf_counter() - t0)

    comparisons = batch * n_windows
    cps = comparisons / best
    print(
        json.dumps(
            {
                "metric": "query_db_comparisons_per_sec_per_chip",
                "value": cps,
                "unit": "comparisons/sec (60bp windows)",
                "vs_baseline": cps / NORTH_STAR,
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
