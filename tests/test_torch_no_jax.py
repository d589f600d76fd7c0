"""The port must run where JAX is not installed, on its own.

A fresh interpreter imports every p265_tpu_torch module (the sharded
paths of p265_tpu_torch.shard, the test encoder, the stream set, run_config
and the CLI among them), loads the per-stage entry points and decodes the
committed 96x64 LDP stream on CPU tensors (fused, unfused and with
frame-DAG batching) against the port's own golden decoder, through
run_config's gate too, and reads a committed stream of the stream set; a
second one runs every CLI subcommand; jax, jaxlib and ml_dtypes (on the
GPU machine any of them would be an import crash) and every module of the
JAX package p265_tpu must stay out of sys.modules.  Also: no source line of
the package or of chip_smoke.py imports them, and chip_smoke.py exits
nonzero with no result line when no CUDA device is present or when it
stands alone, without the repo.
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
new = {"p265_tpu_torch." + m for m in ("testgen.encoder", "golden.trace",
                                       "cli", "testgen.streams",
                                       "run_config")}
assert new <= set(mods), sorted(new - set(mods))
from p265_tpu_torch.kernels.intra import predict_batch
from p265_tpu_torch.kernels.loopfilter import (deblock, loop_filters,
                                               loop_filters_frames, sao)
from p265_tpu_torch.pipeline.batch_decode import decode_batch
from p265_tpu_torch.pipeline.decoder import plan_frame_groups
from p265_tpu_torch.pipeline.wavefront import (reconstruct_scan,
                                               reconstruct_scan_frames,
                                               reconstruct_scan_plane)
from p265_tpu_torch.golden.decoder import GoldenDecoder
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.run_config import gate
from p265_tpu_torch.testgen.streams import get_stream, stream_info
with open("p265_tpu_torch/data/s96x64_ldp5.265", "rb") as f:
    data = f.read()
gold = GoldenDecoder().decode_stream(data)
for kw in ({}, dict(fused=False), dict(frame_dag_max=4)):
    got = PipelinedTorchDecoder("cpu", **kw).decode_stream(data)
    assert len(got) == len(gold) == 5
    for f, g in zip(got, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c])
    gate(got, gold, str(kw))
assert stream_info(get_stream("s4k"))["width"] == 3840
bad = sorted(m for m in ("jax", "jaxlib", "ml_dtypes") if m in sys.modules)
ref = sorted(m for m in sys.modules
             if m == "p265_tpu" or m.startswith("p265_tpu."))
print("MODULES", len(mods), "REF", ",".join(ref) or "none",
      "JAX", ",".join(bad) or "none")
"""

# every CLI subcommand, in one interpreter: encode, info, decode with both
# backends, pipelined, resilient, with metrics
_CLI_CHILD = r"""
import contextlib, io, json, os, sys, tempfile
from p265_tpu_torch.cli import main
with tempfile.TemporaryDirectory() as d:
    bit, out, met = (os.path.join(d, n) for n in ("t.265", "t.yuv", "m.jsonl"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["encode", "-o", bit, "--size", "64x64", "--qp", "34",
                     "--gop", "RA", "--frames", "3"]) == 0
        assert main(["info", "-i", bit]) == 0
        assert main(["decode", "-i", bit, "--backend", "golden",
                     "--md5"]) == 0
        assert main(["decode", "-i", bit, "-o", out, "--device", "cpu",
                     "--md5", "--pipelined", "--resilient", "--metrics",
                     met]) == 0
        assert main(["decode", "-i", bit, "--device", "cpu", "--md5"]) == 0
    md5 = [ln for ln in buf.getvalue().splitlines() if ln.startswith("MD5:")]
    assert len(md5) == 3 and len(set(md5)) == 1, md5
    assert os.path.getsize(out) == 64 * 64 * 3 // 2 * 3
    assert json.loads(open(met).read())["frames"] == 3
bad = sorted(m for m in ("jax", "jaxlib", "ml_dtypes") if m in sys.modules)
ref = sorted(m for m in sys.modules
             if m == "p265_tpu" or m.startswith("p265_tpu."))
print("REF", ",".join(ref) or "none", "JAX", ",".join(bad) or "none")
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


def test_cli_subcommands_run_without_jax():
    r = subprocess.run([sys.executable, "-c", _CLI_CHILD], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "REF none JAX none"


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
