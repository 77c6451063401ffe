"""Extended randomized parity campaign for the round-2 compaction paths.

Runs the repo's literal-transcription oracles against the CLI across
random configs, cycling db layouts / forced sharding, with tie-heavy and
cutoff-boundary generators overrepresented. CPU 8-device mesh.
"""
import io
import os
import pathlib
import sys
import tempfile
import traceback

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
jax.config.update("jax_platforms", "cpu")

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))
sys.path.insert(0, str(_ROOT / "tests"))

import numpy as np
from test_fuzz_parity import _run_query, _write_fasta, oracle_cluster, oracle_query
from smafa_tpu.engine.cluster import cluster
from smafa_tpu.ops import distance as _dist
from smafa_tpu.parallel import hitops

_real_packing_shift = _dist.packing_shift

_orig_row_cap = hitops.HitModesMixin._mask_row_cap

import smafa_tpu.parallel.slab as slab_mod

_orig_slab_init = slab_mod.SlabStreamRunner.__init__

START = int(sys.argv[1]) if len(sys.argv) > 1 else 100000
COUNT = int(sys.argv[2]) if len(sys.argv) > 2 else 300

fails = 0
for n in range(START, START + COUNT):
    rng = np.random.default_rng(n)
    layout = ["auto", "sharded", "ring", "col", "stream"][n % 5]
    os.environ["SMAFA_TPU_LAYOUT"] = layout
    os.environ["SMAFA_TPU_FORCE_SHARD"] = "1" if (n // 4) % 2 else ""
    # Codes-resident db form (expand-per-chunk) on a rotating subset.
    # Cycle both resident forms (default is now codes; "0" = one-hot).
    os.environ["SMAFA_TPU_DB_CODES"] = "1" if (n // 2) % 2 else "0"
    # Round-3 surfaces: the rank-4 embedding, the pack lowerings, and
    # the best-hit tie-count fast path all cycle through the campaign.
    os.environ["SMAFA_TPU_EMBED"] = "1" if (n // 5) % 2 else "0"
    os.environ["SMAFA_TPU_PACK"] = ["reduce", "tree", "matmul"][(n // 11) % 3]
    os.environ["SMAFA_TPU_PAIR_COUNT"] = ["", "0", "1"][(n // 13) % 3]
    os.environ["SMAFA_TPU_TIE_ITER"] = ["", "0"][(n // 17) % 2]
    # Round-5 surfaces: the one-wave best-hit program and chunked-ingest
    # window sizes small enough to split toy inputs across windows.
    os.environ["SMAFA_TPU_ONEWAVE"] = ["0", "1", "0"][(n // 3) % 3]
    _chunk = ["", "97", "331"][(n // 23) % 3]
    if _chunk:
        os.environ["SMAFA_TPU_INGEST_CHUNK"] = _chunk
    else:
        os.environ.pop("SMAFA_TPU_INGEST_CHUNK", None)
    # Fake a 31-bit key overflow on some configs so the local-pack +
    # pair-merge paths (and the top-M fallback on 1x1 meshes) get
    # fuzzed at toy scale. The threshold sits between the layout's
    # local span (shard rows / ring shard) and its global padded span:
    # 257 for sharded (global >= chunk*8 under FORCE_SHARD), 2048 for
    # ring (shard 1024, global 8192).
    if n % 7 == 0 and layout in ("sharded", "auto", "ring"):
        lim = 2048 if layout == "ring" else 257
        _dist.packing_shift = (
            lambda s, w, _l=lim: None if w > _l else _real_packing_shift(s, w)
        )
    else:
        _dist.packing_shift = _real_packing_shift
    if layout == "stream":
        # Toy dbs fit one slab at production sizing; force small random
        # slab shapes so the per-slab fold merges get fuzzed too.
        ch = 16
        sr = ch * int(rng.integers(1, 6))
        slab_mod.SlabStreamRunner.__init__ = (
            lambda self, codes, seq_len, slab_rows=None, chunk=None,
            _sr=sr, _ch=ch:
                _orig_slab_init(self, codes, seq_len, slab_rows=_sr, chunk=_ch)
        )
    else:
        slab_mod.SlabStreamRunner.__init__ = _orig_slab_init
    # Every third config forces tiny compaction row slices so the
    # mask-budget path (built for 10M-row dbs) sees toy-scale fuzzing.
    if n % 3 == 0:
        hitops.HitModesMixin._mask_row_cap = lambda self: int(rng.integers(1, 9))
    else:
        hitops.HitModesMixin._mask_row_cap = _orig_row_cap
    gen = n % 3
    L = int(rng.integers(1, 90))
    alpha = int(rng.integers(2, 6))
    if gen == 0:  # random
        nd, nq = int(rng.integers(1, 150)), int(rng.integers(1, 60))
        mk = lambda k: ["".join("ACGTN"[c] for c in rng.integers(0, alpha, L))
                        for _ in range(k)]
        db, qs = mk(nd), mk(nq)
    elif gen == 1:  # tie-heavy: small pool, many duplicates
        pool_n = int(rng.integers(1, 8))
        dup = int(rng.integers(2, 120))
        pool = ["".join("ACGTN"[c] for c in rng.integers(0, alpha, L))
                for _ in range(pool_n)]
        db = [pool[int(rng.integers(0, pool_n))] for _ in range(pool_n * dup)]
        qs = [pool[int(rng.integers(0, pool_n))] for _ in range(int(rng.integers(1, 30)))]
    else:  # mutation clusters: distances concentrate at the cutoff
        pool_n = int(rng.integers(2, 10))
        anc = rng.integers(0, alpha, size=(pool_n, L))
        def mut():
            s = anc[int(rng.integers(0, pool_n))].copy()
            for _ in range(int(rng.integers(0, max(1, L // 8)))):
                s[int(rng.integers(0, L))] = int(rng.integers(0, alpha))
            return "".join("ACGTN"[c] for c in s)
        db = [mut() for _ in range(int(rng.integers(1, 200)))]
        qs = [mut() for _ in range(int(rng.integers(1, 40)))]

    mode = (n // 3) % 3
    if mode == 0:
        kw = dict(max_divergence=[None, int(rng.integers(0, L + 1))][n % 2])
    elif mode == 1:
        kw = dict(max_num_hits=int(rng.integers(1, 300)),
                  max_divergence=[None, int(rng.integers(0, L + 1))][(n // 9) % 2])
    else:
        kw = dict(max_num_hits=int(rng.integers(2, 60)),
                  limit_per_sequence=int(rng.integers(1, 6)))

    try:
        with tempfile.TemporaryDirectory() as td:
            tdp = pathlib.Path(td)
            got = _run_query(tdp, db, qs, **kw)
            want = oracle_query(db, qs, **kw)
            assert got == want, "query mismatch"
            f = tdp / "c.fna"
            _write_fasta(f, db)
            maxd = int(rng.integers(0, max(1, L)))
            buf = io.StringIO()
            cluster(f, maxd, out=buf, batch_size=int(rng.integers(1, 50)))
            assert buf.getvalue() == oracle_cluster(db, maxd), "cluster mismatch"
    except Exception:
        fails += 1
        print(f"FAIL seed={n} layout={layout} gen={gen} mode={mode} "
              f"L={L} kw={kw}", flush=True)
        traceback.print_exc()
        if fails >= 5:
            break
    if (n - START + 1) % 25 == 0:
        print(f"{n - START + 1}/{COUNT} done ({fails} fails)", flush=True)

print(f"CAMPAIGN DONE: {COUNT} configs, {fails} failures", flush=True)
