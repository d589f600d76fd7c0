"""Write the reference's digests of pool items: decode_bench/expected/<item>.json.

    python3 decode_bench/tools/make_expected.py ITEM [ITEM ...] [--jobs N]

An item is a stream with a file under `sums/` or `<stream>.<cut>`
(harness/streams.py).
Each is decoded by the benchmark's plain reference (`reference/`, pure
Python: about 15 s a 1080p picture on one CPU core) and its pictures'
plane digests are written in output order.  Runs on the CPU; imports
nothing of the program.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from decode_bench.harness.check import EXPECTED_DIR, frame_digests  # noqa: E402
from decode_bench.harness.streams import segment_bytes  # noqa: E402


def expected(item: str) -> dict:
    from decode_bench import reference
    data = segment_bytes(item)
    t0 = time.perf_counter()
    frames = reference.decode(data)
    return dict(item=item, segment_sha256=hashlib.sha256(data).hexdigest(),
                reference_s=round(time.perf_counter() - t0, 1),
                pictures=frame_digests(frames))


def write(item: str, out_dir: str = EXPECTED_DIR) -> str:
    rec = expected(item)
    path = os.path.join(out_dir, item + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return f"{item}: {len(rec['pictures'])} pictures, {rec['reference_s']} s"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("items", nargs="+")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=EXPECTED_DIR)
    args = ap.parse_args(argv)
    with ProcessPoolExecutor(args.jobs) as ex:
        for line in ex.map(write, args.items, [args.out] * len(args.items)):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
