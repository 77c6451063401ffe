"""Command-line interface, flag-for-flag compatible with the reference
(reference main.rs:64-116 build_cli):

- ``makedb -i/--input FILE -d/--database FILE`` (both required)
- ``query -d/--database FILE -q/--query FILE [--max-divergence INT]
  [--max-num-hits INT] [--limit-per-sequence INT]``
- ``cluster -i/--input FILE -d/--max-divergence INT`` — note the quirk
  pinned by the reference: in cluster, ``-d`` means max-divergence, NOT
  database (main.rs:100-107), and it is required in practice
  (.unwrap() at main.rs:43) despite help text saying "default: not used".
- ``count -i/--input FILE...`` (multiple files)
- global and per-subcommand ``-v/--verbose`` and ``--quiet`` flags
  (main.rs:67-69; the reference's bird_tool_utils adds these per
  subcommand)
- no subcommand -> print help, exit 0 (main.rs:52-56)

Errors print their message to stderr and exit 101, matching the visible
behavior of the reference's panics (the version-gate test only asserts
stderr contains the message and a nonzero exit, tests/test_cmdline.rs:28-41).

Extensions beyond the reference surface:
``makedb --format {postcard,native}`` and ``query --batch-size``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _u32(text: str) -> int:
    """clap's value_parser!(u32) twin: the reference rejects negative or
    non-integer values as a usage error (exit 2) before any op runs
    (main.rs:87-97, 104-107)."""
    try:
        v = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid digit found in string: {text!r}")
    if not (0 <= v <= 0xFFFFFFFF):
        raise argparse.ArgumentTypeError(f"{v} is out of range for u32")
    return v


def _add_verbosity(p: argparse.ArgumentParser, short_q: bool = True) -> None:
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print extra debug logging information")
    quiet_flags = ["-q", "--quiet"] if short_q else ["--quiet"]
    p.add_argument(*quiet_flags, dest="quiet", action="store_true",
                   help="Unless there is an error, do not print logging information")


# Reference lib.rs:15-16 AUTHOR_AND_EMAIL, shown by --help (main.rs:66).
AUTHOR_AND_EMAIL = (
    "Ben J. Woodcroft, Centre for Microbiome Research, School of Biomedical "
    "Sciences, Faculty of Health, Queensland University of Technology "
    "<benjwoodcroft near gmail.com>"
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="smafa",
        description="Read aligner for small pre-aligned sequences (JAX engine)",
        epilog=AUTHOR_AND_EMAIL,
    )
    from smafa_tpu import __version__

    # clap's command!() provides -V/--version (reference main.rs:65)
    parser.add_argument("-V", "--version", action="version", version=__version__)
    _add_verbosity(parser)
    sub = parser.add_subparsers(dest="subcommand")

    p = sub.add_parser("makedb", help="Generate a searchable database")
    p.add_argument("-i", "--input", required=True,
                   help="Subject sequences to search against [required]")
    p.add_argument("-d", "--database", required=True,
                   help="Output DB filename [required]")
    p.add_argument("--format", choices=["postcard", "native"], default="postcard",
                   help="DB file format: reference-compatible 'postcard' (default) "
                        "or the mmap-able sharded 'native'")
    _add_verbosity(p)

    # long_about text and numbered-list formatting per reference
    # main.rs:78-83.
    p = sub.add_parser(
        "query",
        help="Search a database. See query --help for more information about output format.",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description=(
            "This command searches a database for query sequences. The database "
            "must be generated with the `makedb` command. The query sequences can "
            "be in FASTA or FASTQ format. The output is a tab-separated file with "
            "the following columns:\n"
            "\n"
            "1. Query sequence number (0-indexed)\n"
            "2. Subject sequence number (0-indexed)\n"
            "3. Divergence (number of nucleotides different between the two sequences\n"
            "4. Subject sequence (with dashes and degenerate base symbols shown as Ns)"
        ),
    )
    p.add_argument("-d", "--database", required=True, help="Output from makedb [required]")
    p.add_argument("-q", "--query", required=True,
                   help="Query sequences to search with in FASTX format [required]")
    p.add_argument("--max-divergence", type=_u32, default=None,
                   help="Maximum divergence to report hits for, for each sequence "
                        "[default: not used]")
    p.add_argument("--max-num-hits", type=_u32, default=None,
                   help="Maximum number of hits to report [default: 1]")
    p.add_argument("--limit-per-sequence", type=_u32, default=None,
                   help="Maximum number of hits to report per sequence. Requires "
                        "--max-num-hits > 1 for now. [default: not used]")
    p.add_argument("--batch-size", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("-o", "--output", default=None,
                   help="Write hits to FILE instead of stdout (with "
                        "--resume-state, reopens and truncates a torn tail "
                        "for exactly-once resume)")
    p.add_argument("--resume-state", default=None,
                   help="JSON checkpoint file enabling resumable query streaming "
                        "(restart skips already-emitted queries; append output with >>)")
    p.add_argument("--coordinator", default=None,
                   help="Multi-host: coordinator address host:port (run the same "
                        "command on every host; process 0 emits)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-host: total number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="Multi-host: this process's id (0-based)")
    _add_verbosity(p, short_q=False)

    p = sub.add_parser("cluster", help="Cluster sequences by similarity")
    p.add_argument("-i", "--input", required=True, help="FASTA file to cluster [required]")
    # Not argparse-required: the reference's clap accepts a missing -d and
    # dies on .unwrap() with exit 101 (main.rs:43,104); we reproduce that
    # exit code (and panic text) in main() rather than argparse's exit 2.
    p.add_argument("-d", "--max-divergence", type=_u32, default=None,
                   help="Maximum divergence to report hits for, for each sequence "
                        "[default: not used]")
    p.add_argument("--batch-size", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("-o", "--output", default=None,
                   help="Write cluster assignments to FILE instead of stdout "
                        "(with --resume-state, reopens and truncates a torn "
                        "tail for exactly-once resume)")
    p.add_argument("--resume-state", default=None,
                   help="JSON checkpoint file enabling resumable clustering "
                        "(centroids persist in a .centroids.npy sidecar; "
                        "restart skips already-clustered records)")
    p.add_argument("--coordinator", default=None,
                   help="Multi-host: coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-host: total number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="Multi-host: this process's id (0-based)")
    _add_verbosity(p)

    p = sub.add_parser("count",
                       help="Print the number of reads/bases in a possibly gzipped FASTX file")
    # num_args(0..) in the reference (main.rs:113): zero files is legal
    # and prints an empty JSON array. Unlike cluster's -d, the flag
    # itself IS clap-required (.required(true), main.rs:111), so an
    # entirely absent -i is a usage error (exit 2) — clap rejects it
    # before main.rs:49's unwrap can run.
    p.add_argument("-i", "--input", nargs="*", required=True,
                   help="FASTQ file to count [required]")
    _add_verbosity(p)

    return parser


def set_log_level(verbose: bool, quiet: bool) -> None:
    level = logging.DEBUG if verbose else (logging.ERROR if quiet else logging.INFO)
    logging.basicConfig(
        level=level,
        stream=sys.stderr,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%SZ",
        force=True,
    )


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.subcommand is None:
        parser.print_help()
        print()
        return 0
    set_log_level(args.verbose, args.quiet)

    # Platform re-assertion first (config only, no backend init), THEN
    # multi-host bring-up (which does initialize the backend), then ops.
    from smafa_tpu.utils.platform import apply_platform_env

    apply_platform_env()
    emitter = True
    if getattr(args, "coordinator", None) or getattr(args, "num_processes", None):
        from smafa_tpu.parallel import multihost

        multihost.initialize(args.coordinator, args.num_processes, args.process_id)
        emitter = multihost.is_emitter()
    out_stream = None
    if not emitter:
        # Non-emitting processes never touch the real output file (a late
        # starter must not truncate the emitter's file on a shared fs).
        out_stream = open(os.devnull, "w")
    elif getattr(args, "output", None):
        # a+ keeps existing bytes (resume truncates any torn tail itself)
        # and permits the seek/truncate that exactly-once resume needs.
        mode = "a+" if getattr(args, "resume_state", None) else "w"
        out_stream = open(args.output, mode)

    try:
        if args.subcommand == "makedb":
            from smafa_tpu.engine.makedb import makedb

            makedb(args.input, args.database, fmt=args.format)
        elif args.subcommand == "query":
            from smafa_tpu.engine.query import query

            query(
                args.database, args.query,
                max_divergence=args.max_divergence,
                max_num_hits=args.max_num_hits,
                limit_per_sequence=args.limit_per_sequence,
                batch_size=args.batch_size,
                resume_state=args.resume_state,
                out=out_stream,
            )
        elif args.subcommand == "cluster":
            if args.max_divergence is None:
                # Reference: .unwrap() on the absent flag (main.rs:43).
                print("called `Option::unwrap()` on a `None` value",
                      file=sys.stderr)
                return 101
            from smafa_tpu.engine.cluster import cluster

            cluster(args.input, args.max_divergence, out=out_stream,
                    batch_size=args.batch_size,
                    resume_state=args.resume_state)
        elif args.subcommand == "count":
            from smafa_tpu.engine.count import count

            count(args.input)
    except BrokenPipeError:
        return 0
    except Exception as exc:  # parity: reference panics print message + die
        print(str(exc), file=sys.stderr)
        return 101
    return 0


if __name__ == "__main__":
    sys.exit(main())
