"""Multi-host (multi-process) scan: 2 CPU processes x 4 virtual devices.

The reference has no distributed mode to mirror; this validates the
SURVEY.md §2.2 design — db rows sharded across processes (each memmaps
only its own rows from the native format), pmin merge across the global
mesh — produces results identical to the single-process oracle.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from smafa_tpu.core.windowset import WindowSet
from smafa_tpu.io import native_format
from smafa_tpu.ops import distance as D

WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from smafa_tpu.parallel import multihost

    coord, pid, db_path, q_path, out_path = sys.argv[1:6]
    multihost.initialize(coord, 2, int(pid))
    assert jax.device_count() == 8, jax.device_count()
    runner = multihost.load_runner(db_path, chunk=128)
    q = np.load(q_path)
    d, i, u = runner.min2(q)
    if multihost.is_emitter():
        np.savez(out_path, d=d, i=i, u=u)
    """
)


def _strip_gloo(s: str) -> str:
    """Drop CPU-Gloo stdout artifacts: "[Gloo]" banners, bare
    "<rank> is connected to N peer ranks" lines (sometimes unprefixed),
    and stray blank lines — TSV output never contains any of these.
    Real multi-host runs emit nothing."""
    return "".join(
        l for l in s.splitlines(keepends=True)
        if l.strip() and not l.startswith("[Gloo]") and "peer ranks" not in l
    )


def _retry_flaky(fn):
    """Multi-process tests depend on OS ports and Gloo startup; retry once
    so a transient bind/race cannot abort a -x CI run."""
    import functools

    @functools.wraps(fn)
    def wrapper(tmp_path):
        try:
            return fn(tmp_path)
        except (AssertionError, subprocess.TimeoutExpired):
            return fn(tmp_path)

    return wrapper


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
@_retry_flaky
def test_two_process_cli_query_golden(tmp_path):
    """Full CLI `query` across 2 processes x 4 virtual devices: process 0's
    stdout must be byte-identical to a single-process run."""
    rng = np.random.default_rng(11)
    W, B, L = 500, 23, 60
    db = rng.integers(0, 5, size=(W, L)).astype(np.uint8)
    db[50] = db[10]  # tie material
    q = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    q[:4] = db[10:14]

    db_path = tmp_path / "db.smafatpu"
    native_format.save(WindowSet.from_matrix(db, 2), db_path)
    q_path = tmp_path / "q.fna"
    q_path.write_text(
        "".join(
            ">r%d\n%s\n" % (i, "".join("ACGTN"[c] for c in row))
            for i, row in enumerate(q)
        )
    )

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # Force the tie-count fast path (auto-gated off at toy spans) so its
    # multi-device tcount program + SPMD gather run under real processes.
    env["SMAFA_TPU_PAIR_COUNT"] = "1"

    single = subprocess.run(
        [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
         "-q", str(q_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert single.returncode == 0, single.stderr[-2000:]

    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
             "-q", str(q_path), "--coordinator", coord,
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert _strip_gloo(outs[0][0]) == single.stdout  # process 0 emits everything
    assert _strip_gloo(outs[1][0]) == ""             # process 1 is silent

    # K-mode through the same split stream (kstats + compaction SPMD)
    single_k = subprocess.run(
        [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
         "-q", str(q_path), "--max-num-hits", "7", "--max-divergence", "40"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert single_k.returncode == 0, single_k.stderr[-2000:]
    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
             "-q", str(q_path), "--max-num-hits", "7",
             "--max-divergence", "40", "--coordinator", coord,
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert _strip_gloo(outs[0][0]) == single_k.stdout


@pytest.mark.slow
@_retry_flaky
def test_two_process_cli_query_onewave_golden(tmp_path):
    """Round 5: the one-wave best-hit program (fused keys + count +
    middle enumeration) dispatched SPMD across 2 real processes —
    process 0's stdout must equal the single-process (3-wave) run."""
    rng = np.random.default_rng(41)
    W, B, L = 600, 29, 40
    db = rng.integers(0, 3, size=(W, L)).astype(np.uint8)
    db[200:400] = db[0:200]  # tie material incl. >2-tie rows
    q = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    q[:6] = db[10:16]

    db_path = tmp_path / "db.smafatpu"
    native_format.save(WindowSet.from_matrix(db, 2), db_path)
    q_path = tmp_path / "q.fna"
    q_path.write_text(
        "".join(
            ">r%d\n%s\n" % (i, "".join("ACGTN"[c] for c in row))
            for i, row in enumerate(q)
        )
    )

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    single = subprocess.run(
        [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
         "-q", str(q_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert single.returncode == 0, single.stderr[-2000:]

    env["SMAFA_TPU_ONEWAVE"] = "1"
    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
             "-q", str(q_path), "--coordinator", coord,
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert _strip_gloo(outs[0][0]) == single.stdout
    assert _strip_gloo(outs[1][0]) == ""


@pytest.mark.slow
@_retry_flaky
def test_two_process_cli_query_fastq_split_golden(tmp_path):
    """Round 5: the split query stream handles plain FASTQ (validated
    '\\n@' record boundaries — quality lines here deliberately start
    with '@'). Process 0's stdout must equal the single-process run."""
    rng = np.random.default_rng(17)
    W, B, L = 400, 37, 48
    db = rng.integers(0, 5, size=(W, L)).astype(np.uint8)
    q = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    q[:4] = db[10:14]

    db_path = tmp_path / "db.smafatpu"
    native_format.save(WindowSet.from_matrix(db, 2), db_path)
    q_path = tmp_path / "q.fq"
    q_path.write_text(
        "".join(
            "@r%d\n%s\n+\n%s\n" % (
                i, "".join("ACGTN"[c] for c in row),
                ("@" if i % 2 == 0 else "I") + "I" * (L - 1),
            )
            for i, row in enumerate(q)
        )
    )

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    single = subprocess.run(
        [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
         "-q", str(q_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert single.returncode == 0, single.stderr[-2000:]

    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
             "-q", str(q_path), "--coordinator", coord,
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
        # the split path (not the replicated fallback) must have engaged
        assert "Query stream split across 2 processes" in se, se[-2000:]
    assert _strip_gloo(outs[0][0]) == single.stdout
    assert _strip_gloo(outs[1][0]) == ""


@pytest.mark.slow
@_retry_flaky
def test_two_process_cli_cluster_golden(tmp_path):
    """Full CLI `cluster` across 2 processes: process 0's stdout matches a
    single-process run (the centroid tensor shards over the global mesh)."""
    rng = np.random.default_rng(5)
    n, L = 1300, 30  # > 2 batches at the default 512 batch size
    cent = rng.integers(0, 4, size=(30, L)).astype(np.uint8)
    seqs = cent[rng.integers(0, 30, n)].copy()
    mut = rng.integers(0, L, n)
    seqs[np.arange(n), mut] = rng.integers(0, 4, n)
    in_path = tmp_path / "in.fna"
    in_path.write_text(
        "".join(
            ">s%d\n%s\n" % (i, "".join("ACGTN"[c] for c in row))
            for i, row in enumerate(seqs)
        )
    )

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    single = subprocess.run(
        [sys.executable, "-m", "smafa_tpu", "cluster", "-i", str(in_path), "-d", "3"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert single.returncode == 0, single.stderr[-2000:]

    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "smafa_tpu", "cluster", "-i", str(in_path),
             "-d", "3", "--coordinator", coord,
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]

    assert _strip_gloo(outs[0][0]) == single.stdout
    assert _strip_gloo(outs[1][0]) == ""


@pytest.mark.slow
@_retry_flaky
def test_two_process_resume_mid_stream(tmp_path):
    """Multi-host --resume-state: a run over a prefix of the stream, then a
    restart with the full stream, must produce byte-identical output to a
    straight single run (process 0's checkpoint is authoritative; its
    ``done`` broadcasts so every process skips the same prefix)."""
    rng = np.random.default_rng(23)
    W, B, L = 300, 19, 40
    db = rng.integers(0, 5, size=(W, L)).astype(np.uint8)
    q = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    q[:3] = db[7:10]
    db_path = tmp_path / "db.smafatpu"
    native_format.save(WindowSet.from_matrix(db, 2), db_path)

    def fasta(rows):
        return "".join(
            ">r%d\n%s\n" % (i, "".join("ACGTN"[c] for c in row))
            for i, row in enumerate(rows)
        )

    q_path = tmp_path / "q.fna"
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    q_path.write_text(fasta(q))
    single = subprocess.run(
        [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
         "-q", str(q_path), "--batch-size", "8"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert single.returncode == 0, single.stderr[-2000:]

    out_file = tmp_path / "out.tsv"
    state = tmp_path / "state.json"

    def run_pair(n_records):
        q_path.write_text(fasta(q[:n_records]))
        coord = f"localhost:{_free_port()}"
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "smafa_tpu", "query", "-d", str(db_path),
                 "-q", str(q_path), "--batch-size", "8",
                 "-o", str(out_file), "--resume-state", str(state),
                 "--coordinator", coord, "--num-processes", "2",
                 "--process-id", str(pid)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for pid in (0, 1)
        ]
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (_so, se) in zip(procs, outs):
            assert p.returncode == 0, se[-2000:]

    run_pair(11)   # first run covers a prefix, checkpoints done=11
    assert state.exists()
    run_pair(B)    # restart with the full stream resumes after the prefix
    assert out_file.read_text() == single.stdout


@pytest.mark.slow
@_retry_flaky
def test_multihost_bench_smoke(tmp_path):
    """tools/multihost_bench.py's code path on a tiny 2-process CPU run:
    it must complete and process 0 must emit its one JSON line."""
    import json

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "tools/multihost_bench.py", "--coordinator", coord,
             "--num-processes", "2", "--process-id", str(pid),
             "--rows", "512", "--batch", "16", "--iters", "1"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    lines = [l for l in _strip_gloo(outs[0][0]).splitlines() if l.startswith("{")]
    assert len(lines) == 1, outs[0][0]
    rec = json.loads(lines[0])
    assert rec["metric"] == "multihost_comparisons_per_sec"
    assert rec["num_processes"] == 2 and rec["value"] > 0
    assert _strip_gloo(outs[1][0]).strip() in ("", )


@pytest.mark.slow
@_retry_flaky
def test_two_process_scan_matches_oracle(tmp_path):
    rng = np.random.default_rng(7)
    W, B, L = 1000, 37, 60
    db = rng.integers(0, 5, size=(W, L)).astype(np.uint8)
    q = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    q[:5] = db[200:205]

    db_path = tmp_path / "db.smafatpu"
    native_format.save(WindowSet.from_matrix(db, 2), db_path)
    q_path = tmp_path / "q.npy"
    np.save(q_path, q)
    out_path = tmp_path / "out.npz"
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)

    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.getcwd()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), coord, str(pid), str(db_path),
             str(q_path), str(out_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    got = np.load(out_path)
    full = np.asarray(
        D.pairwise_distances(D.expand_onehot(q, L), D.expand_onehot(db, L), L)
    )
    assert np.array_equal(got["d"], full.min(axis=1))
    assert np.array_equal(got["i"], full.argmin(axis=1))
    ties = (full == full.min(axis=1)[:, None]).sum(axis=1)
    assert np.array_equal(got["u"], ties == 1)


def test_two_process_cluster_resume_mid_stream(tmp_path):
    """Multi-host cluster --resume-state: a run over a prefix, then a
    restart with the full stream, must match a straight single run byte
    for byte (process 0's done AND centroid tensor broadcast so every
    process rebuilds the identical greedy state)."""
    rng = np.random.default_rng(29)
    n, L = 60, 24
    cent = rng.integers(0, 4, size=(8, L)).astype(np.uint8)
    seqs = cent[rng.integers(0, 8, n)].copy()
    mut = rng.integers(0, L, n)
    seqs[np.arange(n), mut] = rng.integers(0, 4, n)
    seqs[n - 2] = seqs[3]  # exact dup across the resume boundary

    def fasta(rows):
        return "".join(
            ">s%d\n%s\n" % (i, "".join("ACGTN"[c] for c in row))
            for i, row in enumerate(rows)
        )

    in_path = tmp_path / "in.fna"
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    in_path.write_text(fasta(seqs))
    single = subprocess.run(
        [sys.executable, "-m", "smafa_tpu", "cluster", "-i", str(in_path),
         "-d", "3", "--batch-size", "16"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert single.returncode == 0, single.stderr[-2000:]

    out_file = tmp_path / "out.tsv"
    state = tmp_path / "cstate.json"

    def run_pair(n_records):
        in_path.write_text(fasta(seqs[:n_records]))
        coord = f"localhost:{_free_port()}"
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "smafa_tpu", "cluster",
                 "-i", str(in_path), "-d", "3", "--batch-size", "16",
                 "-o", str(out_file), "--resume-state", str(state),
                 "--coordinator", coord, "--num-processes", "2",
                 "--process-id", str(pid)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for pid in (0, 1)
        ]
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (_so, se) in zip(procs, outs):
            assert p.returncode == 0, se[-2000:]

    run_pair(33)   # prefix run checkpoints done=33 + its centroids
    assert state.exists()
    data = json.loads(state.read_text())
    assert data["done"] == 33 and data["n_centroids"] > 0
    run_pair(n)    # restart resumes after the prefix
    assert out_file.read_text() == single.stdout
