"""The port must run where JAX is not installed.

A fresh interpreter imports every p265_tpu_torch module and decodes a tiny
stream on CPU tensors; jax, jaxlib and ml_dtypes must stay out of
sys.modules (on the GPU machine any of them would be an import crash).
Also: no source line of the package imports them, and chip_smoke.py exits
nonzero with no result line when no CUDA device is present.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "p265_tpu_torch")

_CHILD = r"""
import importlib, pkgutil, sys
import numpy as np
import p265_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(p265_tpu_torch.__path__,
                                              "p265_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
sps = SPS(pic_width=64, pic_height=32)
pps = PPS(init_qp=32)
data = Encoder(sps, pps, qp=32, seed=1).encode_sequence(
    make_moving_sequence(64, 32, 2, seed=1))[0]
gold = GoldenDecoder().decode_stream(data)
got = PipelinedTorchDecoder("cpu").decode_stream(data)
assert len(got) == len(gold) == 2
for f, g in zip(got, gold):
    for c in range(3):
        assert np.array_equal(f.planes[c], g.planes[c])
bad = sorted(m for m in ("jax", "jaxlib", "ml_dtypes") if m in sys.modules)
print("MODULES", len(mods), "JAX", ",".join(bad) or "none")
"""


def test_port_imports_and_decodes_without_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = r.stdout.strip().splitlines()[-1]
    n_mods = int(line.split()[1])
    assert n_mods >= 10, line
    assert line.endswith("JAX none"), line


def test_no_source_line_imports_jax():
    pat = re.compile(r"^\s*(import|from) (jax|jaxlib|ml_dtypes)\b")
    hits = []
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    hits += [f"{path}:{i}" for i, ln in enumerate(f, 1)
                             if pat.match(ln)]
    assert not hits, hits


def test_chip_smoke_refuses_without_cuda():
    """Run only where torch sees no CUDA device: chip_smoke must fail and
    print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
