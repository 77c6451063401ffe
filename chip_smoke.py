"""End-to-end smoke of smafa's main path on one GPU, through the CLI.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # the sharded path on four GPUs

Everything runs in this one process (``smafa_tpu.cli.main``), so one JAX
process holds the card. Data is generated from ``--seed``; nothing is
downloaded. Phases:

0. environment: card name and power limit (nvidia-smi), JAX version,
   device kind and count, whether the native ingest library loaded;
   fails unless JAX runs on a GPU;
1. compile check: every device program at real widths (60 bp windows, a
   2^22-row db, a 65,536-query batch), with its memory analysis;
2. makedb of a 2^22-row db, then one best-hit query batch of 65,536
   queries at --max-divergence 5;
3. K-mode (--max-num-hits 99 --max-divergence 5) on 4,096 queries;
4. cluster -d 5 of 262,144 windows, and of a separate 16,384-window set;
5. checks, all exact (byte-identical lines): sampled best-hit and K-mode
   rows against a NumPy brute force over the whole db, and the 16,384-
   window clustering against a transcription of the reference's greedy
   rule. The 262,144-window clustering is checked for its invariants.

Per-phase wall times are smoke timings, not benchmark figures. The last
line of stdout is one JSON object naming the device; any failure exits
non-zero without it.

``--four`` runs only the four-GPU path: a 10,000,000-row db on the
default (1, 4) mesh, best-hit and K-mode through the CLI, the same
queries under SMAFA_TPU_LAYOUT=ring and on a 1x1 mesh, all compared
byte for byte with each other and with the NumPy sample.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
WORK = HERE / "chip_smoke_work"
BASES = np.frombuffer(b"ACGTN", np.uint8)

SEQ_LEN = 60
DB_ROWS = 1 << 22
BATCH = 65536
KMODE_QUERIES = 4096
CLUSTER_BIG = 262144
CLUSTER_SMALL = 16384
FOUR_DB_ROWS = 10_000_000
MAX_DIV = 5
K = 99
SAMPLE = 128


class SmokeError(RuntimeError):
    pass


def log(*a) -> None:
    print(*a, flush=True)


# -- independent NumPy references (no engine code) ---------------------------

def _dists(db: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Hamming distance of one query row to every db row (ASCII bytes;
    the alphabet's encoding is injective on ACGTN, so byte inequality is
    the reference's mismatch rule)."""
    d = np.zeros(db.shape[0], np.int32)
    step = 1 << 20
    for s in range(0, db.shape[0], step):
        d[s:s + step] = (db[s:s + step] != q).sum(axis=1, dtype=np.int32)
    return d


def ref_best_hit(db: np.ndarray, q: np.ndarray, qnum: int,
                 max_div: int | None) -> list[str]:
    """Best-hit lines of one query (reference lib.rs:296-314): every
    window at the minimum distance, in index order, unless the minimum
    exceeds max_div."""
    d = _dists(db, q)
    m = int(d.min())
    if max_div is not None and m > max_div:
        return []
    return [f"{qnum}\t{i}\t{m}\t{db[i].tobytes().decode()}"
            for i in np.nonzero(d == m)[0]]


def ref_kmode(db: np.ndarray, q: np.ndarray, qnum: int, k: int,
              max_div: int | None) -> list[str]:
    """K-mode lines of one query (reference lib.rs:241-295): all windows
    at distance <= the k-th smallest distance (ties at the cutoff
    included) and <= max_div, in (distance, index) order."""
    d = _dists(db, q)
    if k > d.shape[0]:
        cutoff = int(d.max())
    else:
        cutoff = int(np.partition(d, k - 1)[k - 1])
    if max_div is not None:
        cutoff = min(cutoff, max_div)
    idx = np.nonzero(d <= cutoff)[0]
    idx = idx[np.lexsort((idx, d[idx]))]
    return [f"{qnum}\t{i}\t{d[i]}\t{db[i].tobytes().decode()}" for i in idx]


def ref_cluster(seqs: np.ndarray, max_div: int) -> list[str]:
    """Greedy clustering (reference cluster.rs:13-94): skip exact
    duplicates; assign each record to the lowest-index centroid at the
    minimum distance if that minimum is <= max_div, else make it a new
    centroid; one line "record<TAB>centroid" per unique record."""
    n, L = seqs.shape
    cents = np.empty((n, L), np.uint8)
    nc = 0
    seen: set[bytes] = set()
    out = []
    for r in seqs:
        key = r.tobytes()
        if key in seen:
            continue
        seen.add(key)
        c = -1
        if nc:
            d = (cents[:nc] != r).sum(axis=1)
            c = int(d.argmin())  # first index at the minimum
            if d[c] > max_div:
                c = -1
        if c < 0:
            cents[nc] = r
            c = nc
            nc += 1
        out.append(f"{key.decode()}\t{cents[c].tobytes().decode()}")
    return out


# -- data --------------------------------------------------------------------

def write_fasta(path: Path, letters: np.ndarray, tag: bytes) -> None:
    """Records ">{tag}{index:09d}" of equal-length ASCII rows."""
    n, L = letters.shape
    nd = 9
    head = 1 + len(tag) + nd + 1
    rec = np.empty((n, head + L + 1), np.uint8)
    rec[:, 0] = ord(">")
    rec[:, 1:1 + len(tag)] = np.frombuffer(tag, np.uint8)
    x = np.arange(n, dtype=np.int64)
    for j in range(nd - 1, -1, -1):
        rec[:, 1 + len(tag) + j] = 48 + x % 10
        x //= 10
    rec[:, head - 1] = ord("\n")
    rec[:, head:head + L] = letters
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def make_query_data(rng, rows: int, batch: int):
    """A random ACGT db with clumps of exact duplicate rows (2..40
    copies), and queries drawn from it: the first tenth are unmutated
    copies of clump sources (best-hit ties, light and heavy), the rest
    carry ~3% point mutations (N included)."""
    db = rng.integers(0, 4, size=(rows, SEQ_LEN), dtype=np.uint8)
    n_clumps = max(1, rows // 2048)
    sources = rng.choice(rows, n_clumps, replace=False)
    sizes = rng.integers(2, 41, n_clumps)
    pos = rng.choice(rows, int(sizes.sum()), replace=False)
    db[pos] = db[np.repeat(sources, sizes)]
    src = rng.integers(0, rows, size=batch)
    n_tie = batch // 10
    src[:n_tie] = rng.choice(sources, n_tie)
    q = db[src].copy()
    mut = rng.random(q.shape) < 0.03
    mut[:n_tie] = False
    q[mut] = rng.integers(0, 5, size=int(mut.sum()), dtype=np.uint8)
    return BASES[db], BASES[q]


def make_cluster_data(rng, n: int, ancestors: int = 1000,
                      mut_max: int = 4) -> np.ndarray:
    """Windows derived from a few ancestors with 0..mut_max point
    mutations each (tools/cluster_bench.py's generator)."""
    anc = rng.integers(0, 4, size=(ancestors, SEQ_LEN), dtype=np.uint8)
    rows = anc[rng.integers(0, ancestors, n)]
    nmut = rng.integers(0, mut_max + 1, n)
    ridx = np.repeat(np.arange(n), nmut)
    rows[ridx, rng.integers(0, SEQ_LEN, ridx.size)] = rng.integers(
        0, 4, ridx.size, dtype=np.uint8)
    return BASES[rows]


# -- CLI driving and checks ---------------------------------------------

def cli(*argv: str) -> None:
    from smafa_tpu import cli as smafa_cli

    rc = smafa_cli.main(list(argv))
    if rc != 0:
        raise SmokeError(f"smafa {' '.join(argv)} exited {rc}")


def read_by_query(path: Path) -> dict[int, list[str]]:
    out: dict[int, list[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            out.setdefault(int(line.split("\t", 1)[0]), []).append(line)
    return out


def check_sample(out_path: Path, db: np.ndarray, qs: np.ndarray,
                 qnums: np.ndarray, ref, label: str) -> None:
    got = read_by_query(out_path)
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as ex:
        want = list(ex.map(lambda i: ref(db, qs[i], int(i)), qnums))
    bad = [int(i) for i, w in zip(qnums, want) if got.get(int(i), []) != w]
    n_lines = sum(len(w) for w in want)
    log(f"check {label}: {len(qnums)} sampled queries, {n_lines} lines, "
        f"{len(bad)} differ (tolerance 0)")
    if bad:
        i = bad[0]
        raise SmokeError(f"{label}: query {i} differs: got {got.get(i)} "
                         f"want {ref(db, qs[i], i)}")


def check_cluster_invariants(out_path: Path, seqs: np.ndarray) -> None:
    """Every unique record printed once, in input order; each centroid is
    itself a record printed earlier (or the record itself) and lies
    within MAX_DIV of the record."""
    uniq = list(dict.fromkeys(r.tobytes().decode() for r in seqs))
    lines = out_path.read_text().splitlines()
    if len(lines) != len(uniq):
        raise SmokeError(f"cluster: {len(lines)} lines for {len(uniq)} "
                         "unique records")
    seen: set[str] = set()
    for line, want in zip(lines, uniq):
        rec, cent = line.split("\t")
        if rec != want:
            raise SmokeError(f"cluster: record out of order: {rec}")
        seen.add(rec)
        if cent not in seen:
            raise SmokeError(f"cluster: centroid {cent} not an earlier record")
        d = sum(a != b for a, b in zip(rec, cent))
        if d > MAX_DIV:
            raise SmokeError(f"cluster: {rec} assigned at distance {d}")
    n_cent = len({line.split("\t")[1] for line in lines})
    log(f"check cluster {seqs.shape[0]}: {len(lines)} lines, {n_cent} "
        "centroids, invariants hold")


# -- phases -------------------------------------------------------------

def card_line() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeError(f"nvidia-smi failed: {e}") from e
    if proc.returncode != 0 or not proc.stdout.strip():
        raise SmokeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def require_gpu(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeError(f"no GPU: JAX runs on {devs[0].platform!r}")
    if len(devs) < count:
        raise SmokeError(f"{count} GPUs needed, {len(devs)} visible")
    return devs


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def compile_check(db_codes: np.ndarray) -> str:
    """Compile every device program at real widths; print each one's
    memory analysis. Returns the phase-A implementation the runner
    ships at the production batch."""
    import jax
    import jax.numpy as jnp

    from smafa_tpu.engine import cluster as C
    from smafa_tpu.ops import distance as D
    from smafa_tpu.parallel import sharded
    from smafa_tpu.parallel.hitops import mask_row_cap

    runner = sharded.ScanRunner(db_codes, SEQ_LEN)
    shift = runner._key_shift()
    impl = ("pallas/triton kernel" if runner._pallas_min2_eligible(BATCH)
            else "XLA min2_scan")
    L, nw = SEQ_LEN, runner.n_windows_dev
    q = lambda b: np.zeros((b, L), np.uint8)  # noqa: E731
    i32 = lambda b, v=0: np.full((b,), v, np.int32)  # noqa: E731
    bc = mask_row_cap(runner._compact_span_rows())
    progs = {
        "min2": (runner._program("min2", BATCH, shift=shift),
                 (q(BATCH), runner.db_oh, nw)),
        "tcount": (runner._program("tcount", 4096),
                   (q(4096), runner.db_oh, nw, i32(4096))),
        "miditer": (runner._program("miditer", 1024, shift=shift, t_cap=4),
                    (q(1024), runner.db_oh, nw, i32(1024), i32(1024),
                     i32(1024))),
        "compact": (runner._program("compact", bc, t_cap=64 * bc),
                    (q(bc), runner.db_oh, nw, i32(bc))),
        "kstats": (runner._program("kstats", BATCH, shift=shift),
                   (q(BATCH), runner.db_oh, nw, jnp.int32(K),
                    jnp.int32(MAX_DIV))),
        "hitdist": (runner._program("hitdist", 1 << 17),
                    (q(BATCH), runner.db_oh, i32(1 << 17), i32(1 << 17))),
    }
    if runner._compactd_supported():
        progs["compactd"] = (runner._program("compactd", bc, t_cap=64 * bc),
                             (q(bc), runner.db_oh, nw, i32(bc)))
    else:
        log("compactd: not used at this db size (the compaction is "
            "segmented; K-mode takes compact + hitdist)")
    for name, (fn, args) in progs.items():
        t0 = time.perf_counter()
        mem = fn.lower(*args).compile().memory_analysis()
        log(f"compile {name}: {time.perf_counter() - t0:.1f} s  {mem}")
    t0 = time.perf_counter()
    cap = 16384
    mem = C._scan_min.lower(
        q(32768), jnp.zeros((cap, L), jnp.uint8), jnp.int32(cap),
        seq_len=L, chunk=1024, embed=D.embed_active(L),
    ).compile().memory_analysis()
    log(f"compile cluster scan: {time.perf_counter() - t0:.1f} s  {mem}")
    del runner
    jax.clear_caches()
    return impl


def run_one(args) -> dict:
    import jax

    timings: dict[str, float] = {}
    rng = np.random.default_rng(args.seed)
    dev = jax.devices()[0]

    t0 = time.perf_counter()
    db, qs = make_query_data(rng, DB_ROWS, BATCH)
    db_f, q_f, qk_f = WORK / "db.fna", WORK / "q.fna", WORK / "qk.fna"
    write_fasta(db_f, db, b"s")
    write_fasta(q_f, qs, b"q")
    qk = qs[:: BATCH // KMODE_QUERIES]
    write_fasta(qk_f, qk, b"k")
    timings["generate"] = time.perf_counter() - t0

    from smafa_tpu.core.alphabet import BYTE_LUT

    t0 = time.perf_counter()
    impl = compile_check(BYTE_LUT[db])
    timings["compile_check"] = time.perf_counter() - t0
    log("phase A implementation at the production batch:", impl)

    dbp = WORK / "db.smafadb"
    t0 = time.perf_counter()
    cli("makedb", "-i", str(db_f), "-d", str(dbp), "--quiet")
    timings["makedb"] = time.perf_counter() - t0
    out_b = WORK / "best.tsv"
    t0 = time.perf_counter()
    cli("query", "-d", str(dbp), "-q", str(q_f), "--max-divergence",
        str(MAX_DIV), "-o", str(out_b), "--quiet")
    timings["query_best_hit"] = time.perf_counter() - t0
    log(f"peak_bytes_in_use after best-hit: {peak_bytes(dev)}")

    out_k = WORK / "kmode.tsv"
    t0 = time.perf_counter()
    cli("query", "-d", str(dbp), "-q", str(qk_f), "--max-num-hits", str(K),
        "--max-divergence", str(MAX_DIV), "-o", str(out_k), "--quiet")
    timings["query_kmode"] = time.perf_counter() - t0

    cl_big = make_cluster_data(rng, CLUSTER_BIG)
    cl_small = make_cluster_data(np.random.default_rng(args.seed + 1),
                                 CLUSTER_SMALL)
    cb_f, cs_f = WORK / "cl_big.fna", WORK / "cl_small.fna"
    write_fasta(cb_f, cl_big, b"c")
    write_fasta(cs_f, cl_small, b"c")
    out_cb, out_cs = WORK / "cl_big.tsv", WORK / "cl_small.tsv"
    t0 = time.perf_counter()
    cli("cluster", "-i", str(cb_f), "-d", str(MAX_DIV), "-o", str(out_cb),
        "--quiet")
    timings["cluster_262144"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli("cluster", "-i", str(cs_f), "-d", str(MAX_DIV), "-o", str(out_cs),
        "--quiet")
    timings["cluster_16384"] = time.perf_counter() - t0
    log(f"peak_bytes_in_use: {peak_bytes(dev)}")

    t0 = time.perf_counter()
    srng = np.random.default_rng(args.seed + 2)
    n_tie = BATCH // 10
    sample = np.sort(np.concatenate([
        srng.choice(n_tie, SAMPLE // 2, replace=False),
        n_tie + srng.choice(BATCH - n_tie, SAMPLE // 2, replace=False)]))
    check_sample(out_b, db, qs, sample,
                 lambda d, q, i: ref_best_hit(d, q, i, MAX_DIV), "best-hit")
    ks = np.sort(srng.choice(qk.shape[0], SAMPLE, replace=False))
    check_sample(out_k, db, qk, ks,
                 lambda d, q, i: ref_kmode(d, q, i, K, MAX_DIV), "K-mode")
    want = ref_cluster(cl_small, MAX_DIV)
    got = out_cs.read_text().splitlines()
    n_bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    log(f"check cluster {CLUSTER_SMALL}: {len(want)} lines vs the greedy "
        f"transcription, {n_bad} differ (tolerance 0)")
    if n_bad:
        raise SmokeError("cluster output differs from the greedy rule")
    check_cluster_invariants(out_cb, cl_big)
    timings["checks"] = time.perf_counter() - t0
    log("smoke timings in seconds (wall, not benchmark figures): "
        + json.dumps({k: round(v, 3) for k, v in timings.items()}))
    return {"count": 1}


def run_four(args) -> dict:
    import jax

    devs = jax.devices()[:4]
    timings: dict[str, float] = {}
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    db, qs = make_query_data(rng, FOUR_DB_ROWS, BATCH)
    db_f, q_f, qk_f = WORK / "db.fna", WORK / "q.fna", WORK / "qk.fna"
    write_fasta(db_f, db, b"s")
    write_fasta(q_f, qs, b"q")
    qk = qs[:: BATCH // KMODE_QUERIES]
    write_fasta(qk_f, qk, b"k")
    dbp = WORK / "db.smafadb"
    cli("makedb", "-i", str(db_f), "-d", str(dbp), "--quiet")
    timings["generate_makedb"] = time.perf_counter() - t0

    def both(tag: str) -> tuple[str, str]:
        ob, ok = WORK / f"best_{tag}.tsv", WORK / f"kmode_{tag}.tsv"
        t0 = time.perf_counter()
        cli("query", "-d", str(dbp), "-q", str(q_f), "--max-divergence",
            str(MAX_DIV), "-o", str(ob), "--quiet")
        timings[f"best_hit_{tag}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli("query", "-d", str(dbp), "-q", str(qk_f), "--max-num-hits",
            str(K), "--max-divergence", str(MAX_DIV), "-o", str(ok), "--quiet")
        timings[f"kmode_{tag}"] = time.perf_counter() - t0
        return ob.read_text(), ok.read_text()

    os.environ["SMAFA_TPU_LAYOUT"] = "sharded"
    sharded_out = both("mesh_1x4")
    log("peak_bytes_in_use per device after the (1, 4) mesh run: "
        + json.dumps([peak_bytes(d) for d in devs]))
    os.environ["SMAFA_TPU_LAYOUT"] = "ring"
    ring_out = both("ring")
    os.environ["SMAFA_TPU_LAYOUT"] = "sharded"
    os.environ["SMAFA_TPU_SHARD_THRESHOLD"] = str(1 << 40)
    single_out = both("mesh_1x1")
    del os.environ["SMAFA_TPU_SHARD_THRESHOLD"], os.environ["SMAFA_TPU_LAYOUT"]
    log("peak_bytes_in_use per device at the end: "
        + json.dumps([peak_bytes(d) for d in devs]))
    for name, out in (("ring", ring_out), ("mesh_1x1", single_out)):
        same = [a == b for a, b in zip(out, sharded_out)]
        log(f"check {name} vs mesh_1x4: best-hit "
            f"{'identical' if same[0] else 'DIFFERS'}, K-mode "
            f"{'identical' if same[1] else 'DIFFERS'}")
        if not all(same):
            raise SmokeError(f"{name} output differs from the (1, 4) mesh")
    t0 = time.perf_counter()
    srng = np.random.default_rng(args.seed + 2)
    n_tie = BATCH // 10
    sample = np.sort(np.concatenate([
        srng.choice(n_tie, SAMPLE // 2, replace=False),
        n_tie + srng.choice(BATCH - n_tie, SAMPLE // 2, replace=False)]))
    check_sample(WORK / "best_mesh_1x4.tsv", db, qs, sample,
                 lambda d, q, i: ref_best_hit(d, q, i, MAX_DIV), "best-hit")
    ks = np.sort(srng.choice(qk.shape[0], SAMPLE, replace=False))
    check_sample(WORK / "kmode_mesh_1x4.tsv", db, qk, ks,
                 lambda d, q, i: ref_kmode(d, q, i, K, MAX_DIV), "K-mode")
    timings["checks"] = time.perf_counter() - t0
    log("smoke timings in seconds (wall, not benchmark figures): "
        + json.dumps({k: round(v, 3) for k, v in timings.items()}))
    return {"count": 4}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path")
    args = ap.parse_args(argv)
    try:
        import smafa_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the smafa_tpu package is not importable: {e}",
              file=sys.stderr)
        return 2
    n_dev = 4 if args.four else 1
    try:
        card = card_line()
        import jax

        devs = require_gpu(n_dev)
        from smafa_tpu.native import load

        log("card (nvidia-smi name, power.limit):")
        log(card)
        log(f"jax {jax.__version__}; device {devs[0].device_kind}; "
            f"count {len(devs)}; native ingest "
            f"{'loaded' if load() is not None else 'NOT loaded'}")
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            res = run_four(args) if args.four else run_one(args)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": res["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
