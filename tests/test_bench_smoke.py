"""Smoke test for bench.py. Runs it in a subprocess on the CPU backend
with --smoke (its CPU sizing) and validates the one-JSON-line output
contract, so schema or import rot is caught in the suite; without
--smoke and without a GPU it must fail."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).parent.parent


def _bench_proc(*extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # single CPU device is enough, faster startup
    return subprocess.run(
        [sys.executable, str(REPO / "bench.py"), *extra],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )


def _run_bench(*extra):
    proc = _bench_proc("--smoke", *extra)
    assert proc.returncode == 0, proc.stderr
    lines = [l for l in proc.stdout.strip().splitlines() if l.startswith("{")]
    assert len(lines) == 1, f"expected exactly one JSON line, got: {proc.stdout!r}"
    return json.loads(lines[0])


def test_bench_default_contract():
    rec = _run_bench()
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert rec["metric"] == "query_db_comparisons_per_sec_per_chip"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 1.0e9)


@pytest.mark.parametrize("kernel", ["compact", "hist"])
def test_bench_kernel_variants(kernel):
    rec = _run_bench("--kernel", kernel)
    assert rec["value"] > 0


def test_bench_fails_without_gpu():
    proc = _bench_proc()
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert not [l for l in proc.stdout.splitlines() if l.startswith("{")]
