"""Steady-state query throughput at the BASELINE 10M-row config.

Builds a native-format db of N 60 bp windows (mmap-sliceable; zero
decode cost), loads it once, then streams K query batches through the
engine's runner measuring per-batch marginal time — separating the
one-time costs (one-hot expand, host-to-device upload, compile) from
the sustained scan rate a cold end-to-end number hides.

    python tools/query_scale_bench.py [--rows 10000000] [--batch 16384]
                                      [--batches 8] [--mode best|kmode]

Prints one JSON line with cold and steady-state comparisons/sec.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))


def main() -> None:
    from smafa_tpu.utils.platform import apply_platform_env

    apply_platform_env()

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seq-len", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--mode", choices=["best", "kmode"], default="best")
    ap.add_argument("--k", type=int, default=99)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from smafa_tpu.parallel import select

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 5, size=(args.rows, args.seq_len), dtype=np.uint8)

    t0 = time.time()
    runner = select.make_runner(codes, args.seq_len)
    per_batch = []
    total_hits = 0
    for b in range(args.batches):
        q = rng.integers(0, 5, size=(args.batch, args.seq_len), dtype=np.uint8)
        # plant exact hits so correctness rides along
        plant = rng.integers(0, args.rows, 8)
        q[:8] = codes[plant]
        t = time.time()
        if args.mode == "best":
            dist, counts, rows_f, idx_f = runner.best_hit(q)
            total_hits += int(counts.sum())
            assert (dist[:8] == 0).all(), "planted hits not found"
        else:
            counts, rows_f, idx_f, dv = runner.kmode_flat(q, args.k, None)
            total_hits += int(counts.sum())
            assert (dv[: int(counts[0])] >= 0).all()
        per_batch.append(time.time() - t)
    wall = time.time() - t0

    cmp_per_batch = args.batch * args.rows
    steady = sorted(per_batch[1:])[: max(1, (args.batches - 1) // 2)]
    steady_s = sum(steady) / len(steady)
    print(json.dumps({
        "metric": "query_steady_state_comparisons_per_sec",
        "value": round(cmp_per_batch / steady_s, 1),
        "unit": "comparisons/sec (60bp, end-to-end best-hit batches)",
        "rows": args.rows,
        "batch": args.batch,
        "mode": args.mode,
        "cold_first_batch_s": round(per_batch[0], 2),
        "steady_batch_s": round(steady_s, 3),
        "batches_s": [round(x, 2) for x in per_batch],
        "total_wall_s": round(wall, 1),
        "total_hits": total_hits,
    }))


if __name__ == "__main__":
    main()
