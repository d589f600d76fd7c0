"""The comparison that decides `correct`: every plane (Y, Cb, Cr) of every
picture a segment output, against the reference's digests of that
segment (`expected/<item>.json`, written by tools/make_expected.py from
the benchmark's own copy of the plain NumPy decoder, `reference/`).

Each plane is compared by its shape and the SHA-256 of its samples as
uint8, row-major; a sample outside 0..255 makes the plane wrong.  The
comparison is exact, so every limit is 0.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from decode_bench.harness.streams import BENCH_DIR

EXPECTED_DIR = os.path.join(BENCH_DIR, "expected")
# the numbers compared, each with its limit (an exact comparison)
LIMITS = {"planes_wrong": 0, "pictures_missing": 0, "segments_failed": 0,
          "segments_misdealt": 0, "ranks_missing": 0}


def plane_digest(plane) -> tuple:
    """(shape, sha256 hex of the samples as uint8) of one plane; None for
    the digest where a sample lies outside 0..255."""
    a = np.asarray(plane)
    shape = list(a.shape)
    if a.size and (a.min() < 0 or a.max() > 255):
        return shape, None
    return shape, hashlib.sha256(
        np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def frame_digests(frames) -> list:
    """[{"poc", "shape": [3 shapes], "sha256": [3 digests]}] of decoded
    frames (objects with .poc and .planes [y, cb, cr]), in output order."""
    out = []
    for f in frames:
        ds = [plane_digest(p) for p in f.planes]
        out.append(dict(poc=int(f.poc), shape=[d[0] for d in ds],
                        sha256=[d[1] for d in ds]))
    return out


def load_expected(item: str) -> dict:
    """<EXPECTED_DIR>/<item>.json; EXPECTED_DIR is read at each call, so a
    test can point it elsewhere."""
    with open(os.path.join(EXPECTED_DIR, item + ".json")) as f:
        return json.load(f)


def compare(got: list, want: list) -> tuple:
    """(planes wrong, pictures missing) of one segment's frame_digests
    against the reference's.  A picture output in the wrong place, or
    with the wrong POC, counts as missing; so does one output too many."""
    wrong = 0
    missing = abs(len(want) - len(got))
    for g, w in zip(got, want):
        if g["poc"] != w["poc"]:
            missing += 1
            continue
        for gs, gd, ws, wd in zip(g["shape"], g["sha256"], w["shape"],
                                  w["sha256"]):
            wrong += gs != ws or gd is None or gd != wd
    return wrong, missing
