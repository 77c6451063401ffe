"""Streaming error parity: output precedes the panic.

The reference processes records one at a time, so hits for every record
BEFORE an invalid base / length mismatch are printed before it dies
(reference lib.rs:231-318). The batched engine must preserve that:
the pending (already-scanned) batch drains before the error propagates,
on both ingest paths.
"""

import io

import numpy as np
import pytest

from smafa_tpu.core.alphabet import BYTE_LUT, InvalidBaseError
from smafa_tpu.core.windowset import WindowSet, LengthMismatchError
from smafa_tpu.engine.query import query
from smafa_tpu.io import postcard


def _db(tmp_path, seqs):
    ws = WindowSet(version=2)
    for s in seqs:
        ws.push(BYTE_LUT[np.frombuffer(s.encode(), np.uint8)])
    p = tmp_path / "db"
    p.write_bytes(postcard.dumps(ws))
    return p


@pytest.mark.parametrize("native", [True, False])
def test_invalid_base_emits_prior_hits(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    dbp = _db(tmp_path, ["ACG", "TTT"])
    qf = tmp_path / "q.fna"
    qf.write_text(">a\nACG\n>b\nTTT\n>c\nTTT\n>bad\nAXG\n>later\nACG\n")
    buf = io.StringIO()
    with pytest.raises(InvalidBaseError, match='Byte 88.*"bad".*position 1'):
        query(dbp, qf, out=buf, batch_size=2)
    lines = buf.getvalue().splitlines()
    # Records a, b, c (before the bad record) must all have been emitted.
    assert [l.split("\t")[0] for l in lines] == ["0", "1", "2"]


@pytest.mark.parametrize("native", [True, False])
def test_length_mismatch_emits_prior_hits(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    dbp = _db(tmp_path, ["ACG", "TTT"])
    qf = tmp_path / "q.fna"
    qf.write_text(">a\nACG\n>b\nTTT\n>c\nGGGG\n")
    buf = io.StringIO()
    with pytest.raises(LengthMismatchError):
        query(dbp, qf, out=buf, batch_size=2)
    lines = buf.getvalue().splitlines()
    assert [l.split("\t")[0] for l in lines] == ["0", "1"]


def test_invalid_base_as_first_record_emits_nothing(tmp_path):
    dbp = _db(tmp_path, ["ACG"])
    qf = tmp_path / "q.fna"
    qf.write_text(">bad\nXCG\n>later\nACG\n")
    buf = io.StringIO()
    with pytest.raises(InvalidBaseError):
        query(dbp, qf, out=buf, batch_size=2)
    assert buf.getvalue() == ""


def test_empty_db_runner_raises_domain_error():
    from smafa_tpu.parallel import sharded

    runner = sharded.ScanRunner(np.empty((0, 0), np.uint8), 1)
    with pytest.raises(ValueError, match="empty database"):
        runner.min2(np.zeros((3, 1), np.uint8))
    with pytest.raises(ValueError, match="empty database"):
        runner.topm(np.zeros((3, 1), np.uint8), 5)


def test_auto_batch_scaling():
    from smafa_tpu.engine.query import DEFAULT_BATCH, _auto_batch
    from smafa_tpu.parallel.slab import SlabStreamRunner

    class _Db:
        def __init__(self, n, runner=None):
            self.n_windows = n
            self.runner = runner

    assert _auto_batch(_Db(100)) == DEFAULT_BATCH
    assert _auto_batch(_Db((1 << 16) - 1)) == DEFAULT_BATCH
    assert _auto_batch(_Db(1 << 16)) == 4096
    assert _auto_batch(_Db(1 << 19)) == 16384
    assert _auto_batch(_Db(1 << 21)) == 32768
    assert _auto_batch(_Db(10_000_000)) == 65536
    # out-of-core: the whole db crosses PCIe per batch -> go biggest
    st = SlabStreamRunner.__new__(SlabStreamRunner)
    assert _auto_batch(_Db(100, runner=st)) == 65536
