"""The plain reference of the benchmark: a frozen copy of the port's NumPy
golden decoder (spec-first, sequential; `p265_tpu_torch/golden/decoder.py`
and the host modules it reaches), kept here so that the yardstick does
not move with the program.

Deviations from the copied modules: imports point into this package; the
CABAC engine is the pure-Python one only (the native C lanes, the
tile-parallel and WPP-parallel native parses and their imports are
removed), so nothing here imports the program.  `decode(data)` returns
the decoded frames in output order.
"""
from __future__ import annotations


def decode(data: bytes) -> list:
    from decode_bench.reference.golden.decoder import GoldenDecoder
    return GoldenDecoder(use_native_cabac=False).decode_stream(data)
