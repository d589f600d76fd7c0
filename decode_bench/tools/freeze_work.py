"""Freeze the work of pool items: decode_bench/work/<item>.json.

    python3 decode_bench/tools/freeze_work.py ITEM [ITEM ...] [--jobs N]

For each item (harness/streams.py), the census of its segment (the
program's `p265_tpu_torch.roofline.census`: native parse, no
reconstruction) is summed by the benchmark's frozen copy of the work
arithmetic (harness/work.py) into the bytes and multiply-adds of each
stage and kernel of one decode.  Runs on the CPU; timed and traced runs
only read the files it writes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from decode_bench.harness.streams import segment_bytes  # noqa: E402
from decode_bench.harness.work import WORK_DIR, to_json, work  # noqa: E402


def write(item: str, out_dir: str = WORK_DIR) -> str:
    from p265_tpu_torch.roofline import census
    pictures = census(segment_bytes(item))
    rec = dict(item=item, pictures=len(pictures),
               inter=sum(p["inter"] for p in pictures),
               **to_json(work(pictures)))
    with open(os.path.join(out_dir, item + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return f"{item}: {len(pictures)} pictures"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("items", nargs="+")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=WORK_DIR)
    args = ap.parse_args(argv)
    with ProcessPoolExecutor(args.jobs) as ex:
        for line in ex.map(write, args.items, [args.out] * len(args.items)):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
