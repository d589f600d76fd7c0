"""The control of a cell: the cell's own segments at its own sizes, decoded
by the program with its loop filters switched off (`apply_filters=False`,
the program's own path), which breaks the configuration's guarantee that
deblocking and SAO are applied.  The comparison must find it: `correct`
false on every seed.  The benchmark's own runs never run this.

    python3 decode_bench/tools/control.py --workload NAME --seeds 1,2,3
        [--seconds S]

One process on one card (a cell of several cards runs its segments
through the one-process entry), a short window a seed, one JSON line a
seed with the numbers compared.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def control_cell(cell: dict) -> dict:
    """The cell on one process through the "decoder" entry, its loop
    filters off."""
    cfg = dict(cell["config"], entry="decoder",
               decoder=dict(cell["config"].get("decoder", {}),
                            apply_filters=False))
    return dict(cell, config=cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    from decode_bench.harness import spec
    from decode_bench.harness.cell import run_rank
    from decode_bench.harness.result import checks
    cell = control_cell(spec.cell(args.workload))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        r = run_rank(cell, seed, args.seconds, False, "cuda")
        compared = checks([r], 1)
        print(json.dumps(dict(
            workload=args.workload, seed=seed,
            correct=all(v <= lim for v, lim in compared.values()),
            segments=len(r["segments"]),
            pictures=sum(s[3] or 0 for s in r["segments"]),
            seconds=time.monotonic() - t0,
            check={k: v for k, (v, _) in compared.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
