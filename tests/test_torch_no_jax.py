"""The port must run where JAX is not installed, on its own.

A fresh interpreter imports every p265_tpu_torch module (the sharded
paths of p265_tpu_torch.shard among them) and decodes the
committed 96x64 LDP stream on CPU tensors against the port's own golden
decoder; jax, jaxlib and ml_dtypes (on the GPU machine any of them would be
an import crash) and every module of the JAX package p265_tpu must stay out
of sys.modules.  Also: no source line of the package or of chip_smoke.py
imports them, and chip_smoke.py exits nonzero with no result line when no
CUDA device is present or when it stands alone, without the repo.
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
shard = {"p265_tpu_torch.shard." + m for m in ("mesh", "filters", "spatial",
                                               "decoder", "distributed")}
assert shard <= set(mods), sorted(shard - set(mods))
from p265_tpu_torch.golden.decoder import GoldenDecoder
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
with open("p265_tpu_torch/data/s96x64_ldp5.265", "rb") as f:
    data = f.read()
gold = GoldenDecoder().decode_stream(data)
got = PipelinedTorchDecoder("cpu").decode_stream(data)
assert len(got) == len(gold) == 5
for f, g in zip(got, gold):
    for c in range(3):
        assert np.array_equal(f.planes[c], g.planes[c])
bad = sorted(m for m in ("jax", "jaxlib", "ml_dtypes") if m in sys.modules)
ref = sorted(m for m in sys.modules
             if m == "p265_tpu" or m.startswith("p265_tpu."))
print("MODULES", len(mods), "REF", ",".join(ref) or "none",
      "JAX", ",".join(bad) or "none")
"""


def _py_sources():
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_and_decodes_without_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = r.stdout.strip().splitlines()[-1]
    n_mods = int(line.split()[1])
    assert n_mods >= 30, line
    assert " REF none " in line, line
    assert line.endswith("JAX none"), line


def test_no_source_line_imports_jax():
    pat = re.compile(r"^\s*(import|from) (jax|jaxlib|ml_dtypes)\b")
    hits = []
    for path in _py_sources():
        with open(path) as f:
            hits += [f"{path}:{i}" for i, ln in enumerate(f, 1)
                     if pat.match(ln)]
    assert not hits, hits


def test_no_source_line_imports_the_jax_package():
    pat = re.compile(r"^\s*(from|import) p265_tpu(\.|\s|$)")
    hits = []
    for path in _py_sources():
        with open(path) as f:
            hits += [f"{path}:{i}" for i, ln in enumerate(f, 1)
                     if pat.match(ln)]
    assert not hits, hits


def test_chip_smoke_alone_refuses(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo
    must fail and print no result line, card or no card."""
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_cuda():
    """Run only where torch sees no CUDA device: chip_smoke must fail and
    print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
