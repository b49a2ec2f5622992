#!/usr/bin/env python3
"""Multi-host correction launcher — the Nextflow pipeline's role
(Ratatosk_nf/Ratatosk.nf), on jax.distributed.

Every host runs this same script with its process id; inputs are chunk-
scattered across hosts, the index is built (or loaded) per host, outputs are
gathered on host 0. Single-host invocation degrades to the plain pipeline.

Example (2 hosts):
  host0: python scripts/distributed_correct.py --coordinator host0:1234 \
             --num-processes 2 --process-id 0 -- \
             -s short.fq.gz -l long.fq.gz -o out
  host1: same with --process-id 1

Env-var alternative: RATATOSK_COORDINATOR / RATATOSK_NUM_PROCESSES /
RATATOSK_PROCESS_ID.
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- followed by `correct` CLI flags")
    args = ap.parse_args()
    rest = [a for a in args.rest if a != "--"]

    from ratatosk_tpu import cli
    from ratatosk_tpu.parallel import distributed as D

    # reuse the CLI parser to build the option struct
    sub = cli.argparse.ArgumentParser()
    s2 = sub.add_subparsers(dest="command")
    pc = s2.add_parser("correct")
    cli._add_common(pc, correct_mode=True)
    parsed = sub.parse_args(["correct"] + rest)
    opt = cli._build_opt(parsed, index_mode=False)
    D.run_distributed_correct(opt, coordinator=args.coordinator,
                              num_processes=args.num_processes,
                              process_id=args.process_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
