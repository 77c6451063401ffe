"""Phase-A kernel sweep on one GPU: compile, check and time the fused
Pallas/Triton min2 kernel against XLA's min2_scan, and time the XLA
compaction pass under each bit-pack lowering.

    python tools/kernel_sweep.py [--rows 4194304] [--batch 65536] [--e2e]

Shapes default to one production batch against a 2^22-row db of 60 bp
windows. Prints one line per measurement and writes everything to
chiprun_out/kernel_sweep.json (plus the XLA min2 program's optimized HLO
and a per-kernel device-time table from a profiler trace). ``--e2e``
instead times best-hit end to end through the CLI on chip_smoke.py's
data, kernel off and on in turns (off, on, on, off), and writes
chiprun_out/kernel_e2e.json. Requires a GPU: exits non-zero on any other
backend.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))
OUT = _ROOT / "chiprun_out"

# (tile_b, tile_w, num_warps, num_stages)
CONFIGS = [
    (128, 64, 4, 3), (128, 64, 8, 3), (128, 128, 8, 3), (128, 32, 4, 3),
    (256, 64, 8, 3), (256, 32, 8, 3), (64, 64, 4, 3), (64, 128, 4, 3),
    (128, 64, 4, 2), (128, 64, 4, 4),
]


def _time(fn, iters: int = 3) -> tuple[float, list[float]]:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


def _device_table(trace_dir: str) -> dict:
    """Per kernel name: summed device nanoseconds over GPU planes."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb"))
    table: dict[str, float] = {}
    for path in paths:
        pd = ProfileData.from_file(path)
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    table[ev.name] = table.get(ev.name, 0.0) + ev.duration_ns
    top = sorted(table.items(), key=lambda kv: -kv[1])[:15]
    return {k: v for k, v in top}


def _e2e(args, res, save) -> int:
    """Best-hit through the CLI, kernel off/on alternating."""
    import chip_smoke as C

    work = _ROOT / "chip_smoke_work"
    work.mkdir(exist_ok=True)
    try:
        db, qs = C.make_query_data(np.random.default_rng(args.seed),
                                   args.rows, args.batch)
        C.write_fasta(work / "db.fna", db, b"s")
        C.write_fasta(work / "q.fna", qs, b"q")
        C.cli("makedb", "-i", str(work / "db.fna"), "-d",
              str(work / "db.smafadb"), "--quiet")
        outs = {}
        res["runs"] = []
        for mode in ("0", "", "", "0", "0", ""):
            os.environ["SMAFA_TPU_PALLAS_MIN2"] = mode
            out = work / f"best_{mode or 'auto'}.tsv"
            t0 = time.perf_counter()
            C.cli("query", "-d", str(work / "db.smafadb"), "-q",
                  str(work / "q.fna"), "--max-divergence", "5", "-o",
                  str(out), "--quiet")
            dt = time.perf_counter() - t0
            name = "xla" if mode == "0" else "kernel"
            res["runs"].append([name, dt])
            outs[name] = out.read_bytes()
            print(f"CLI best-hit {args.batch} x {args.rows} [{name}]: "
                  f"{dt:.3f} s", flush=True)
            save()
        res["identical"] = outs["xla"] == outs["kernel"]
        print("outputs identical:", res["identical"], flush=True)
        save()
        return 0 if res["identical"] else 1
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from smafa_tpu.ops import distance as D
    from smafa_tpu.ops import pallas_scan as PS
    from smafa_tpu.parallel import sharded
    from smafa_tpu.parallel.hitops import mask_row_cap

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX runs on {dev.platform!r}", file=sys.stderr)
        return 2
    OUT.mkdir(exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    res: dict = {"card": card, "jax": jax.__version__,
                 "device_kind": dev.device_kind, "rows": args.rows,
                 "batch": args.batch}
    print("card:", card, "| jax", jax.__version__, "|", dev.device_kind,
          flush=True)

    def save():
        name = "kernel_e2e.json" if args.e2e else "kernel_sweep.json"
        (OUT / name).write_text(json.dumps(res, indent=1))

    if args.e2e:
        return _e2e(args, res, save)

    L, n, b = 60, args.rows, args.batch
    rng = np.random.default_rng(args.seed)
    db = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    q = db[rng.integers(0, n, size=b)].copy()
    mut = rng.random(q.shape) < 0.03
    mut[: b // 10] = False
    q[mut] = rng.integers(0, 5, size=int(mut.sum()), dtype=np.uint8)

    os.environ["SMAFA_TPU_PALLAS_MIN2"] = "0"
    runner = sharded.ScanRunner(db, L, mesh=sharded.build_mesh(1, 1))
    shift = runner._key_shift()
    xla_fn = runner._program("min2", b, shift=shift)
    q_dev = jax.device_put(q)

    # 1. correctness at real widths on a sample of the batch
    nchk = min(4096, b)
    q_chk = q[:nchk]
    lo_x, hi_x, cnt_x = jax.jit(
        D.min2c_scan, static_argnames=("seq_len", "shift", "chunk",
                                       "index_span"),
    )(D.expand_query(q_chk, L, L), runner.db_oh, runner.n_windows_dev,
      jnp.int32(0), seq_len=L, shift=shift, chunk=runner.chunk,
      index_span=runner.wp)
    emb, base = runner._db_emb()
    tiles0 = PS.pick_min2_tiles(b, runner.wp)
    res["default_tiles"] = list(tiles0)
    t0 = time.perf_counter()
    got = PS.min2_scan_pallas(PS.embed_query(jnp.asarray(q_chk), L), emb,
                              base, shift,
                              PS.pick_min2_tiles(nchk, runner.wp))
    jax.block_until_ready(got)
    res["kernel_first_call_s"] = time.perf_counter() - t0
    ok = all(np.array_equal(np.asarray(g), np.asarray(w))
             for g, w in zip(got, (lo_x, hi_x, cnt_x)))
    res["kernel_matches_xla"] = ok
    print("kernel == XLA min2c on", nchk, "queries:", ok,
          f"(first call {res['kernel_first_call_s']:.2f} s)", flush=True)
    save()
    if not ok:
        return 1

    # 2. XLA min2 program (what the runner ships without the kernel)
    lowered = xla_fn.lower(q, runner.db_oh, runner.n_windows_dev)
    compiled = lowered.compile()
    (OUT / "min2_xla_hlo.txt").write_text(compiled.as_text())
    res["xla_memory"] = str(compiled.memory_analysis())
    best, ts = _time(lambda: xla_fn(q_dev, runner.db_oh,
                                    runner.n_windows_dev))
    res["xla_min2_s"] = ts
    print(f"XLA min2 {b}x{n}: best {best:.4f} s  "
          f"({b * n / best:.4e} cmp/s)  runs {ts}", flush=True)
    save()

    # 3. kernel launch-shape sweep (direct call, query pre-embedded)
    qe = jax.block_until_ready(PS.embed_query(q_dev, L))
    res["sweep"] = []
    for tb, tw, warps, stages in CONFIGS:
        t = PS.pick_min2_tiles(b, runner.wp)
        t = t._replace(tile_b=tb, tile_w=tw, num_warps=warps,
                       num_stages=stages)
        entry = {"tiles": list(t)}
        try:
            best, ts = _time(lambda: PS.min2_scan_pallas(
                qe, emb, base, shift, t, with_count=False))
            entry.update(s=ts, cmp_per_s=b * n / best)
            print(f"kernel {t}: best {best:.4f} s ({b * n / best:.4e} "
                  f"cmp/s)", flush=True)
        except Exception as e:  # record refusals, keep sweeping
            entry["error"] = f"{type(e).__name__}: {str(e)[:300]}"
            print(f"kernel {t}: FAILED {entry['error']}", flush=True)
        res["sweep"].append(entry)
        save()
    for with_count in (True,):
        best, ts = _time(lambda: PS.min2_scan_pallas(
            qe, emb, base, shift, tiles0, with_count=with_count))
        res["kernel_with_count_s"] = ts
        print(f"kernel {tiles0} with_count: best {best:.4f} s", flush=True)

    # 4. shipped runner programs, kernel on vs off, alternating
    os.environ["SMAFA_TPU_PALLAS_MIN2"] = "1"
    k_fn = runner._program("min2", b, shift=shift)
    res["runner_ab"] = []
    for name, fn in (("xla", xla_fn), ("kernel", k_fn), ("kernel", k_fn),
                     ("xla", xla_fn)):
        best, ts = _time(lambda: fn(q_dev, runner.db_oh,
                                    runner.n_windows_dev), iters=2)
        res["runner_ab"].append([name, ts])
        print(f"runner min2 [{name}]: {ts}", flush=True)
    res["kernel_memory"] = str(
        k_fn.lower(q, runner.db_oh, runner.n_windows_dev)
        .compile().memory_analysis())
    save()

    # 5. device-time tables from one traced call each
    for name, fn in (("xla", xla_fn), ("kernel", k_fn)):
        d = str(OUT / f"trace_min2_{name}")
        jax.profiler.start_trace(d)
        jax.block_until_ready(fn(q_dev, runner.db_oh, runner.n_windows_dev))
        jax.profiler.stop_trace()
        res[f"device_ns_{name}"] = _device_table(d)
        print(f"device time [{name}]:",
              json.dumps(res[f"device_ns_{name}"])[:600], flush=True)
    save()

    # 6. XLA compaction pass under each bit-pack lowering
    os.environ["SMAFA_TPU_PALLAS_MIN2"] = "0"
    cb = min(mask_row_cap(runner._compact_span_rows()), b)
    lo = np.asarray(lo_x)
    thresh = np.full(cb, -1, np.int32)
    thresh[: min(cb, nchk)] = (lo >> shift)[: min(cb, nchk)]
    t_cap = 64 * cb
    res["compact"] = {"batch": cb, "t_cap": t_cap}
    for mode in ("matmul", "reduce", "tree", "tree", "reduce", "matmul"):
        os.environ["SMAFA_TPU_PACK"] = mode
        fn = runner._program("compact", cb, t_cap=t_cap)
        qc = np.asarray(q[:cb])
        best, ts = _time(lambda: fn(qc, runner.db_oh, runner.n_windows_dev,
                                    thresh), iters=2)
        res["compact"].setdefault(mode, []).extend(ts)
        print(f"compact pack={mode} {cb}x{n}: {ts}", flush=True)
        save()
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
