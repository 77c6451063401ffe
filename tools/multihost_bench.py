#!/usr/bin/env python3
"""Multi-host scaling benchmark (run on every host of a multi-host run).

Measures aggregate query x db comparisons/sec across N processes against
the single-process number — the >85%-at-2-hosts scaling-efficiency north
star (BASELINE.json). Usage, on EVERY host of the slice:

    python tools/multihost_bench.py --coordinator HOST:PORT \
        --num-processes N --process-id I [--rows 10000000] [--batch 16384]

The db is synthesized identically on every process (seeded), sharded over
the global mesh by ScanRunner's multi-host path; the scan is the
production phase-A program. Process 0 prints one JSON line:
{"metric": "multihost_comparisons_per_sec", "value": ..., "num_processes": N}.

Single-chip baseline for the efficiency ratio: `python bench.py`.
"""

from __future__ import annotations

import argparse
import json
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--seq-len", type=int, default=60)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    from smafa_tpu.parallel import multihost

    multihost.initialize(args.coordinator, args.num_processes, args.process_id)

    import jax
    import numpy as np

    from smafa_tpu.parallel import sharded

    rng = np.random.default_rng(42)
    db = rng.integers(0, 5, size=(args.rows, args.seq_len), dtype=np.uint8)
    q = rng.integers(0, 5, size=(args.batch, args.seq_len), dtype=np.uint8)

    runner = sharded.ScanRunner(db, args.seq_len)
    runner.min2(q)  # compile + warm

    best = float("inf")
    for _ in range(args.iters):
        t0 = time.perf_counter()
        runner.min2(q)
        best = min(best, time.perf_counter() - t0)

    if multihost.is_emitter():
        cps = args.batch * args.rows / best
        print(json.dumps({
            "metric": "multihost_comparisons_per_sec",
            "value": cps,
            "num_processes": args.num_processes,
            "num_devices": jax.device_count(),
            "rows": args.rows,
            "batch": args.batch,
        }))


if __name__ == "__main__":
    main()
