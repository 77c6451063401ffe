"""Multi-host bring-up + per-process db loading.

The reference is one OS thread on one machine (SURVEY.md §2.2); this is
the scale-out the BASELINE.json multi-GPU config asks for (a 10M-row db
sharded over several devices and hosts). Design:

- ``initialize()`` wraps ``jax.distributed.initialize`` (NCCL/MPI-free:
  the only backend is XLA's own coordination service + compiled
  collectives).
- The db lives in the native format (io.native_format), which is
  row-sliceable with zero decode cost: ``load_runner`` memmaps the file
  and hands it to ScanRunner, whose process-aware path device_puts ONLY
  the row ranges this host's devices own (memmap pages outside them are
  never faulted in) and assembles the global sharded array with
  ``jax.make_array_from_single_device_arrays``.
- Every hit mode (min2 / best-hit / K-mode / top-M) then runs through
  the single ScanRunner implementation: packed-key pmin + psum merges
  compile to collectives within a host (NVLink) and between hosts, and
  results come back replicated so process 0 can emit the ordered TSV
  (output order contract: reference lib.rs:250, 261).

Every process must run the same program with the same query stream (the
standard SPMD contract); only process 0 writes output.
"""

from __future__ import annotations

import logging
from pathlib import Path

import jax

logger = logging.getLogger("smafa")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the cross-host coordination service (idempotent).

    Must run before anything initializes the XLA backend — so no jax
    queries happen here before the initialize call itself.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e):
            raise
        logger.debug("distributed already initialized: %s", e)
    logger.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )


def is_emitter() -> bool:
    return jax.process_index() == 0


def load_runner(db_path: str | Path, chunk: int | None = None):
    """Per-process db load + the unified multi-host scan runner.

    Memmaps the native-format db (zero decode cost) and constructs a
    ScanRunner over the global (1, n_devices) mesh; the runner's
    process-aware setup device_puts only the row ranges this host's
    devices own, so memmap pages outside them never fault in. The
    returned runner serves every hit mode (min2 / best-hit / K-mode /
    top-M) through the same implementation single-host runs use.
    """
    from smafa_tpu.io.db import load_db
    from smafa_tpu.parallel import sharded

    ws = load_db(db_path)
    return sharded.ScanRunner(ws.codes, max(1, ws.length or 1), chunk=chunk)
