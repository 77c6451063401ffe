#!/usr/bin/env python3
"""End-to-end wall-clock on the BASELINE.json query configs.

BASELINE.json names five configs; this tool measures the two query ones
end to end:

- config 2: "SingleM 60bp marker-window db, 10k sequences, 10k queries,
  single chip"
- config 3: "1M-sequence db, 1M queries, divergence sweep {2,5,10},
  single host data-parallel"

Everything `smafa_tpu query` does is on the clock: FASTX parse + encode
(native C++ path), device scans (best-hit mode: min2 phase A + bitmask
compaction phase B for tied rows), host merge, TSV formatting, file
write. Queries are mutated copies of random db rows (per-base mutation
rate ~3%, so the {2,5,10} sweep actually separates hit sets) plus a
slice of exact copies.

    python tools/baseline_e2e.py [--rows 1000000] [--queries 1000000]
                                 [--sweep 2,5,10] [--keep DIR]

Prints one JSON line per (config, divergence) with wall seconds,
queries/sec, comparisons/sec, and emitted hit lines.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _write_fasta(path: pathlib.Path, codes: np.ndarray, tag: str) -> None:
    rows = BASES[codes]
    with open(path, "wb") as f:
        for i in range(rows.shape[0]):
            f.write(b">" + f"{tag}{i}".encode() + b"\n")
            f.write(rows[i].tobytes() + b"\n")


def _gen(rows: int, queries: int, seq_len: int, seed: int, d: pathlib.Path):
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 4, size=(rows, seq_len), dtype=np.uint8)  # ACGT
    src = rng.integers(0, rows, size=queries)
    q = db[src].copy()
    # ~3% per-base mutations -> mean divergence ~1.8 at 60 bp, with a
    # tail past 10; keep 10% exact so every sweep point has exact hits
    mut = rng.random(q.shape) < 0.03
    mut[: queries // 10] = False
    q[mut] = rng.integers(0, 5, size=int(mut.sum()), dtype=np.uint8)
    t0 = time.time()
    _write_fasta(d / "subjects.fna", db, "s")
    _write_fasta(d / "queries.fna", q, "q")
    return time.time() - t0


def run_config(name: str, rows: int, queries: int, sweep, seq_len: int,
               seed: int, workdir: pathlib.Path) -> None:
    from smafa_tpu.engine.makedb import makedb
    from smafa_tpu.engine.query import query

    d = workdir / name
    d.mkdir(parents=True, exist_ok=True)
    gen_s = _gen(rows, queries, seq_len, seed, d)
    t0 = time.time()
    makedb(d / "subjects.fna", d / "db.smafadb.native", fmt="native")
    makedb_s = time.time() - t0
    print(json.dumps({"config": name, "rows": rows, "queries": queries,
                      "gen_s": round(gen_s, 1),
                      "makedb_s": round(makedb_s, 1)}), flush=True)
    for div in sweep:
        out = d / f"hits_d{div}.tsv"
        t0 = time.time()
        with open(out, "w") as f:
            query(d / "db.smafadb.native", d / "queries.fna",
                  max_divergence=div, out=f)
        wall = time.time() - t0
        with open(out, "rb") as f:
            n_hits = sum(1 for _ in f)
        print(json.dumps({
            "config": name, "max_divergence": div,
            "wall_s": round(wall, 1),
            "queries_per_s": round(queries / wall, 1),
            "cmp_per_s_e9": round(rows * queries / wall / 1e9, 2),
            "hit_lines": n_hits,
        }), flush=True)


def main() -> None:
    from smafa_tpu.utils.platform import apply_platform_env

    apply_platform_env()

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1_000_000)
    ap.add_argument("--sweep", default="2,5,10")
    ap.add_argument("--seq-len", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep", default=None,
                    help="work dir to keep (default: temp, deleted)")
    ap.add_argument("--skip-small", action="store_true",
                    help="skip the 10k x 10k config")
    args = ap.parse_args()
    sweep = [int(x) for x in args.sweep.split(",")]

    if args.keep:
        workdir = pathlib.Path(args.keep)
        ctx = None
    else:
        ctx = tempfile.TemporaryDirectory()
        workdir = pathlib.Path(ctx.name)
    try:
        if not args.skip_small:
            run_config("10kx10k", 10_000, 10_000, sweep, args.seq_len,
                       args.seed, workdir)
        run_config(f"{args.rows}x{args.queries}", args.rows, args.queries,
                   sweep, args.seq_len, args.seed + 1, workdir)
    finally:
        if ctx is not None:
            ctx.cleanup()


if __name__ == "__main__":
    main()
