"""chip_smoke.py: its refusal without a GPU, and its NumPy references
against the repo's literal-transcription oracles."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tests.test_fuzz_parity import oracle_cluster, oracle_query  # noqa: E402


def _run(script_dir, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script_dir / "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=script_dir, env=env,
    )


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_fails_without_gpu(args):
    proc = _run(REPO, *args)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr or "nvidia-smi" in proc.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _seqs(rng, n, L, alphabet=3):
    return chip_smoke.BASES[rng.integers(0, alphabet, (n, L)).astype(np.uint8)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_query_references_match_oracle(seed):
    rng = np.random.default_rng(seed)
    L = int(rng.integers(3, 12))
    db = _seqs(rng, 40, L)
    db[5] = db[7] = db[30] = db[0]
    qs = _seqs(rng, 12, L, alphabet=5)
    qs[0] = db[0]
    db_s = [r.tobytes().decode() for r in db]
    q_s = [r.tobytes().decode() for r in qs]
    for max_div in (None, 1, L // 2):
        want = oracle_query(db_s, q_s, max_divergence=max_div)
        got = [line for i in range(len(qs))
               for line in chip_smoke.ref_best_hit(db, qs[i], i, max_div)]
        assert "".join(x + "\n" for x in got) == want
        for k in (1, 3, 50):
            want = oracle_query(db_s, q_s, max_divergence=max_div,
                                max_num_hits=k) if k != 1 else None
            if want is None:
                continue
            got = [line for i in range(len(qs))
                   for line in chip_smoke.ref_kmode(db, qs[i], i, k, max_div)]
            assert "".join(x + "\n" for x in got) == want


@pytest.mark.parametrize("max_div", [0, 2, 4])
def test_cluster_reference_matches_oracle(max_div):
    rng = np.random.default_rng(max_div)
    seqs = chip_smoke.make_cluster_data(rng, 300, ancestors=12, mut_max=3)
    seqs = seqs[:, :chip_smoke.SEQ_LEN]
    seqs[50] = seqs[3]  # exact duplicate: no output line
    want = oracle_cluster([r.tobytes().decode() for r in seqs], max_div)
    got = chip_smoke.ref_cluster(seqs, max_div)
    assert "".join(x + "\n" for x in got) == want


def test_write_fasta_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    rows = _seqs(rng, 1001, 7, alphabet=5)
    chip_smoke.write_fasta(tmp_path / "x.fna", rows, b"q")
    lines = (tmp_path / "x.fna").read_text().splitlines()
    assert lines[0] == ">q000000000" and lines[-2] == ">q000001000"
    assert lines[1::2] == [r.tobytes().decode() for r in rows]
