"""The benchmark of p265_tpu_torch, the PyTorch and CUDA port of the HEVC
decoder: one run of one cell of BENCHMARK.json.

    python3 decode_bench/run.py --workload NAME --seed N --seconds S
        --trace 0|1

The cell's configuration (configs/), traffic mix (traffic/) and per-layer
metrics (metrics/) are found by name.  Set-up decodes the mix's warm
segments; then a closed loop decodes the seed's segment sequence until
the window closes (harness/window.py); once it has closed, every plane of
every picture is compared with the reference's digests (harness/check.py).
A cell of N chips runs one process a card (harness/launch.py).  The last
line of standard output is one JSON object (correct, attempted, failed,
metrics, device, with --trace 1 a breakdown, `setup`: parts of setup_s,
whether this run built the kernel or the native parse library and how long
the build or load and the warm segments took, and last `check`: each
number compared with its limit); the numbers compared are also the last
lines of standard error.  Exits non-zero with no result where there is no
CUDA card or too few, where set-up or a rank fails, and where JAX or the
JAX package was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, "decode_bench", ".cache")
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
# a run exits within 360 s: the ranks' results are due before this
DEADLINE_S = 330


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from decode_bench.harness import spec
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"decode_bench: the cell needs {chips} CUDA card(s); this "
            f"machine has {torch.cuda.device_count()}")
        return 2
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    from decode_bench.harness.imports import forbidden_modules
    from decode_bench.harness.result import result
    try:
        if chips == 1:
            from decode_bench.harness.cell import run_rank
            ranks = [run_rank(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda")]
        else:
            from decode_bench.harness.launch import run_ranks
            ranks = run_ranks(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", chips,
                              T_START + DEADLINE_S)
    except RuntimeError as e:
        log(f"decode_bench: the run failed: {e}")
        return 1
    bad = sorted({m for r in ranks for m in r["forbidden_modules"]}
                 | set(forbidden_modules()))
    if bad:
        log(f"decode_bench: forbidden modules loaded: {bad}")
        return 3
    for r in ranks:
        for item, t0, t1, n in r["segments"]:
            log(f"segment rank {r['rank']} {item} at {t0 - r['t_open']:.4f} "
                f"s: {t1 - t0:.4f} s, {n} frames")
        for err in r["errors"]:
            log(f"rank {r['rank']}: {err}")
    out = result(cell, ranks, chips, T_START, bool(args.trace), units)
    if out["setup"]:
        log("setup (inside setup_s): " + ", ".join(
            f"{k} {v}" for k, v in out["setup"].items()))
    for name, c in out["check"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
