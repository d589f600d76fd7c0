"""The port's measuring code on CPU tensors: run_config's saved goldens,
its refusal without a card and its stage sums (busy_in_spans),
bench_kernels (the kernel rates) and graft_entry (the batched intra step
against __graft_entry__.entry()'s JAX forward, and the sharded dry run
over gloo).  Zero tolerance.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p265_tpu_torch import bench_kernels, graft_entry, run_config
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.testgen.streams import get_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_graft():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_reads_saved_goldens(tmp_path):
    """run_config.save_golden's file holds golden's planes and the
    decode's seconds; load_golden reads them back, gate holds a decode to
    them and refuses one flipped sample."""
    path, seconds = run_config.save_golden(
        "s96x64_ldp5", str(tmp_path / "s96x64_ldp5.npz"))
    with np.load(path) as z:
        assert float(z["seconds"]) == seconds > 0
        bad = dict(z)
    frames = PipelinedTorchDecoder("cpu").decode_stream(
        get_stream("s96x64_ldp5"))
    run_config.gate(frames, run_config.load_golden(path), "saved")
    bad["q4_0"] = bad["q4_0"] ^ 1
    np.savez(path, **bad)
    with pytest.raises(RuntimeError, match="differs from golden"):
        run_config.gate(frames, run_config.load_golden(path), "flipped")


def test_bench_refuses_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run_config.main(["s96x64_ldp5"]) == 1
    assert capsys.readouterr().out == ""


def test_busy_in_spans():
    """Device work inside each stage's spans, and the spans' lengths; work
    outside every span, or crossing a span's end, counts for no stage."""
    spans = [("mc", 10, 20), ("scan", 30, 50), ("mc", 60, 70)]
    work = [(10, 12), (15, 20), (20, 30), (31, 40), (45, 55), (61, 62)]
    busy, total = run_config.busy_in_spans(spans, work)
    assert busy == {"mc": 2 + 5 + 1, "scan": 9}
    assert total == {"mc": 20, "scan": 20}


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
    """run_config.run returns the record of every gated pass, printed as
    text only by report()."""
    rec = run_config.run("s96x64_ldp5", 1, "cpu")
    assert rec["frames"] == 5 and len(rec["passes"]) == 2
    assert [p["frames"] for p in rec["passes"]] == [5, 5]
    assert rec["fps"] == 5 / rec["warm_s"][0]
    assert capsys.readouterr().err == ""
    run_config.report(rec)
    err = capsys.readouterr().err
    assert "cold pass" in err and "warm pass" in err and "fps (best)" in err
