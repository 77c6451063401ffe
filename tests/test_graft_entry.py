"""Driver contract: __graft_entry__.entry() jits single-chip and
dryrun_multichip() compiles+runs the full sharded step on the CPU mesh."""

import sys
import pathlib

import jax

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import __graft_entry__ as graft  # noqa: E402


def test_entry_is_jittable():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    dist, idx, maxd = out
    assert dist.shape == idx.shape
    assert maxd.shape[0] == dist.shape[0]


def test_dryrun_multichip_eight_devices():
    graft.dryrun_multichip(8)


def test_dryrun_multichip_odd_factorization():
    # 6 factorizes to a (2, 3) mesh — exercises the non-square branch.
    graft.dryrun_multichip(6)


def test_dryrun_multichip_four_devices():
    # the four-card layout: a (1, 4) mesh, as on one four-GPU host
    graft.dryrun_multichip(4)
