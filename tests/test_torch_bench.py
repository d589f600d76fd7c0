"""The port's measuring code on CPU tensors: p265_tpu_torch.bench (the
end-to-end metric and its gate), bench_kernels (the kernel rates) and
graft_entry (the batched intra step against __graft_entry__.entry()'s JAX
forward, and the sharded dry run over gloo).  Zero tolerance.
"""
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p265_tpu_torch import bench, bench_kernels, graft_entry
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE_KEYS = ["metric", "value", "unit", "vs_baseline"]


def _jax_graft():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_run_passes_its_gate():
    out = bench.run("s96x64_ldp5", 1, "cpu")
    assert list(out["line"]) == LINE_KEYS
    line = out["line"]
    assert line["unit"] == "fps" and line["value"] > 0
    assert line["vs_baseline"] > 0
    assert "frames/s/cpu" in line["metric"] and "gpu" not in line["metric"]
    assert out["cold"]["frames"] == 5 and len(out["warm"]) == 1
    assert out["fps"] == 5 / out["warm"][0]["seconds"]
    # no card: no kernel launched, no profile, no steady-state companion
    assert out["warm"][0]["launches"] == dict(itransform=0, mc=0, scan=0,
                                              deblock=0, sao=0)
    assert "profile" not in out and "steady" not in out


def test_bench_refuses_a_sample_off_by_one(monkeypatch):
    orig = PipelinedTorchDecoder.decode_stream

    def off_by_one(self, data):
        frames = orig(self, data)
        p = frames[-1].planes[0]
        p[3, 5] += 1 if p[3, 5] < 255 else -1
        return frames

    monkeypatch.setattr(PipelinedTorchDecoder, "decode_stream", off_by_one)
    with pytest.raises(RuntimeError, match="differs from golden"):
        bench.run("s96x64_ldp5", 1, "cpu")


def test_bench_main_prints_one_line(capsys):
    assert bench.main(["--device", "cpu", "--stream", "s96x64_ldp5",
                       "--warm", "1"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == LINE_KEYS and rec["value"] > 0
    # stderr: one JSON record a line
    assert all(json.loads(ln) for ln in err.splitlines())


def test_bench_reads_saved_goldens(tmp_path, capsys):
    """--golden DIR: golden planes and seconds from run_config.save_golden's
    file, the gate as strict."""
    from p265_tpu_torch.run_config import save_golden
    path, seconds = save_golden("s96x64_ldp5",
                                str(tmp_path / "s96x64_ldp5.npz"))
    out = bench.run("s96x64_ldp5", 1, "cpu", str(tmp_path))
    assert out["golden_s"] == seconds
    assert out["line"]["vs_baseline"] == round(seconds / out["warm_s"][0], 3)
    assert bench.main(["--device", "cpu", "--stream", "s96x64_ldp5",
                       "--warm", "1", "--golden", str(tmp_path)]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 1
    with np.load(path) as z:
        bad = dict(z)
    bad["q4_0"] = bad["q4_0"] ^ 1
    np.savez(path, **bad)
    with pytest.raises(RuntimeError, match="differs from golden"):
        bench.run("s96x64_ldp5", 1, "cpu", str(tmp_path))


def test_bench_refuses_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main(["--stream", "s96x64_ldp5"]) == 1
    assert capsys.readouterr().out == ""


def test_busy_in_spans():
    """Device work inside each stage's spans, and the spans' lengths; work
    outside every span, or crossing a span's end, counts for no stage."""
    spans = [("mc", 10, 20), ("scan", 30, 50), ("mc", 60, 70)]
    work = [(10, 12), (15, 20), (20, 30), (31, 40), (45, 55), (61, 62)]
    busy, total = bench.busy_in_spans(spans, work)
    assert busy == {"mc": 2 + 5 + 1, "scan": 9}
    assert total == {"mc": 20, "scan": 20}


def test_bench_refuses_a_share_above_one():
    from p265_tpu_torch import roofline
    w = dict(kernels={"scan": roofline.Work(3_350_000_000, 0)},
             stages={"scan": roofline.Work(3_350_000_000, 0)})
    card = "NVIDIA H100 80GB HBM3"
    out = bench.shares(w, card, {"scan": 1.05}, {"scan": 2.0})
    assert out["stages"]["scan"]["bound_share"] == 0.5
    assert out["kernels"]["scan"]["bound_share"] == 1 / 1.05
    with pytest.raises(RuntimeError, match="above 1.05"):
        bench.shares(w, card, {"scan": 2.0}, {"scan": 0.9})


def test_bench_kernels_rows():
    rows = bench_kernels.run("cpu", n_tu=32, n_blocks=64, reps=2)
    assert [r["kernel"] for r in rows] == [
        "idct4x4", "idct8x8", "idct16x16", "idct32x32", "mc-luma-8tap"]
    for r in rows:
        assert r["route"] == "plain" and r["device"] == "cpu"
        assert r["ms"] > 0 and r["ctu_per_s"] > 0
        assert r["bound_ms"] is None and r["bound_share"] is None
        rate = "blocks_per_s" if r["kernel"].startswith("mc") else "tu_per_s"
        assert r[rate] > 0
        assert r["ctu_per_s"] == pytest.approx(
            r[rate] / (256 if r["kernel"] in ("idct4x4", "mc-luma-8tap")
                       else {"idct8x8": 64, "idct16x16": 16,
                             "idct32x32": 4}[r["kernel"]]), rel=1e-12)


def test_bench_kernels_k2_work_counts_window_union():
    """Two blocks on one reference whose 11x11 windows overlap in 3x11
    samples, and one block on the other reference."""
    from p265_tpu_torch import roofline
    ref = np.zeros((2, 64, 64), np.uint8)
    pos = np.array([[10, 10], [18, 10], [30, 30]], np.int32)
    ridx = np.array([0, 0, 1], np.int32)
    mv = np.zeros((3, 2), np.int32)
    w = bench_kernels.k2_work(ref, pos, ridx, mv)
    assert w == roofline.Work(121 * 3 - 33, 0) + roofline.mc_block_work(
        4, 8, 3)


def test_graft_entry_equals_jax_entry():
    jg = _jax_graft()
    jfwd, jargs = jg.entry()
    fwd, args = graft_entry.entry("cpu")
    assert len(args) == len(jargs) == 8
    for a, b in zip(args, jg._example_batch(size=8)):
        assert np.array_equal(a.numpy(), b)
    got = fwd(*args)
    want = jfwd(*[jnp.asarray(a) for a in jargs])
    assert got.shape == (96, 64) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(args[0].numpy(), np.zeros((96, 64), np.int32))
    assert got.numpy().any()


def test_graft_entry_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.entry()


def test_dryrun_multichip_two_ranks_over_gloo():
    out = graft_entry.dryrun_multichip(2)
    assert out["backend"] == "gloo" and len(out["launches"]) == 2


def test_run_config_run_returns_its_record(capsys):
    """bench.run wraps run_config.run: the record of every gated pass,
    printed as text only by report()."""
    from p265_tpu_torch import run_config
    rec = run_config.run("s96x64_ldp5", 1, "cpu")
    assert rec["frames"] == 5 and len(rec["passes"]) == 2
    assert [p["frames"] for p in rec["passes"]] == [5, 5]
    assert rec["fps"] == 5 / rec["warm_s"][0]
    assert capsys.readouterr().err == ""
    run_config.report(rec)
    err = capsys.readouterr().err
    assert "cold pass" in err and "warm pass" in err and "fps (best)" in err
