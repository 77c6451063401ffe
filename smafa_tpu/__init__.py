"""smafa_tpu: a JAX engine for searching and greedy-clustering databases
of pre-aligned, equal-length nucleotide sequences.

Capability-parity rebuild of the reference tool smafa (wwood/smafa, see
/root/reference/src/{main.rs,lib.rs,cluster.rs}) designed for the GPU:

- Sequences are encoded as compact int8 tensors in device memory.
- The reference's per-pair ``popcount(a ^ b) / 2`` Hamming scan
  (reference lib.rs:80-88) becomes a single batched int8 matmul on the
  tensor cores:
  ``distance[b, w] = L - Q[b, L*5] @ D[w, L*5]^T``.
- Hit selection is sort-free: packed ``(distance << shift) | index``
  keys reduce with integer ``min`` (the reference's lowest-index tie
  rule by construction); best-hit tie sets and K-mode hit lists are
  enumerated by on-device ``while_loop``s of range-masked dual-key
  scans. Greedy clustering runs as batched distance+argmin rounds with
  host-side order resolution.
- Scale-out via ``jax.sharding`` over a ('q', 'w') device mesh (query
  batches data-parallel on 'q', database rows tensor-parallel on 'w'),
  a ppermute ring schedule, column sharding for long windows, and
  multi-host meshes (``--coordinator``; process 0 emits).

Public API mirrors the reference ops layer (lib.rs:137,198,378; cluster.rs:13):
``makedb``, ``query``, ``cluster``, ``count``.
"""

__version__ = "0.1.0"

CURRENT_DB_VERSION = 2  # reference lib.rs:18

from smafa_tpu.engine.makedb import makedb
from smafa_tpu.engine.query import query
from smafa_tpu.engine.cluster import cluster
from smafa_tpu.engine.count import count

__all__ = ["makedb", "query", "cluster", "count", "CURRENT_DB_VERSION", "__version__"]
