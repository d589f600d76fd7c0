"""The port's command line against the JAX package's, on the CPU.

`encode` writes the bytes that `p265_tpu.cli encode` writes (one LDP and
one tiles+WPP setting, and the all-intra branch); `decode --backend golden`
and `--backend torch --device cpu` (plain and pipelined) print the MD5 that
`p265_tpu.cli decode` prints; `info` prints the same lines; `--metrics`
writes the JSONL record with the reference's keys; `--resilient` decodes a
stream with a truncated slice; without `--device` the torch backend
reconstructs on cuda, as both torch decoders do by default.
"""
import json
import os

import pytest
import torch
from test_torch_aux import _truncate_slice, _two_gop_stream

from p265_tpu.cli import main as jax_main
from p265_tpu_torch.cli import build_parser, main
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder

ENCODE = {
    "LDP": ["--size", "64x64", "--qp", "34", "--gop", "LDP", "--frames", "3"],
    "tiles_wpp": ["--size", "128x128", "--qp", "33", "--gop", "LDP",
                  "--frames", "2", "--tiles", "2x2", "--wpp", "--seed", "3"],
    "AI": ["--size", "64x64", "--gop", "AI", "--frames", "2", "--seed", "1"],
}


def _encode(fn, path, name):
    assert fn(["encode", "-i", "synthetic", "-o", str(path)]
              + ENCODE[name]) == 0
    return path.read_bytes()


def _md5(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith("MD5:")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("name", sorted(ENCODE))
def test_encode_writes_the_reference_bytes(name, tmp_path, capsys):
    want = _encode(jax_main, tmp_path / "j.265", name)
    ref_out = capsys.readouterr().out
    got = _encode(main, tmp_path / "t.265", name)
    assert got == want and len(got) > 100
    assert capsys.readouterr().out == ref_out


@pytest.fixture(scope="module")
def ldp(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "ldp.265"
    _encode(main, path, "LDP")
    return path


def test_decode_md5_matches_reference(ldp, tmp_path, capsys):
    assert jax_main(["decode", "-i", str(ldp), "--backend", "golden",
                     "--md5"]) == 0
    want = _md5(capsys.readouterr().out)
    assert jax_main(["decode", "-i", str(ldp), "--backend", "tpu",
                     "--md5"]) == 0
    assert _md5(capsys.readouterr().out) == want
    out = tmp_path / "t.yuv"
    for extra in (["--backend", "golden"],
                  ["--backend", "torch", "--device", "cpu"],
                  ["--device", "cpu", "--pipelined", "-o", str(out)]):
        assert main(["decode", "-i", str(ldp), "--md5"] + extra) == 0
        text = capsys.readouterr().out
        assert _md5(text) == want, extra
        assert "decoded 3 frames (" in text
    assert os.path.getsize(out) == 64 * 64 * 3 // 2 * 3


def test_info_prints_the_reference_lines(ldp, capsys):
    assert jax_main(["info", "-i", str(ldp)]) == 0
    want = capsys.readouterr().out
    assert main(["info", "-i", str(ldp)]) == 0
    assert capsys.readouterr().out == want
    assert "SPS: 64x64" in want and "NAL units:" in want


@pytest.mark.parametrize("pipelined", [False, True])
def test_decode_metrics(ldp, tmp_path, pipelined):
    met = tmp_path / "m.jsonl"
    assert main(["decode", "-i", str(ldp), "--device", "cpu", "--metrics",
                 str(met)] + (["--pipelined"] if pipelined else [])) == 0
    rec = json.loads(met.read_text())
    assert rec["frames"] == 3
    for key in ("parse_s", "pack_s", "upload_s", "dispatch_s", "recon_s",
                "slice_bytes", "tus", "ctbs", "parse_mb_s"):
        assert rec[key] > 0, key


def test_decode_resilient(tmp_path, capsys):
    """A truncated slice in the first of two GOPs: the same frames, and
    the same MD5, as the reference's resilient golden decode."""
    bad = tmp_path / "bad.265"
    bad.write_bytes(_truncate_slice(_two_gop_stream()[0], 1))
    with pytest.raises(Exception):
        main(["decode", "-i", str(bad), "--device", "cpu"])
    capsys.readouterr()
    assert jax_main(["decode", "-i", str(bad), "--backend", "golden",
                     "--resilient", "--md5"]) == 0
    want = capsys.readouterr()
    n_frames = want.out.split("decoded ")[1].split()[0]
    for extra in (["--backend", "golden"], ["--device", "cpu"],
                  ["--device", "cpu", "--pipelined"]):
        assert main(["decode", "-i", str(bad), "--resilient", "--md5"]
                    + extra) == 0
        cap = capsys.readouterr()
        assert cap.err == want.err and "corrupt slices skipped" in cap.err
        assert _md5(cap.out) == _md5(want.out)
        assert f"decoded {n_frames} frames" in cap.out


def test_torch_backend_needs_a_device(ldp):
    """Without --device the torch backend takes cuda; a machine without a
    card then fails in torch, and nothing falls back to the CPU."""
    args = build_parser().parse_args(["decode", "-i", str(ldp)])
    assert torch.device(args.device) == torch.device("cuda")
    if not torch.cuda.is_available():
        for extra in ([], ["--pipelined"]):
            with pytest.raises((AssertionError, RuntimeError),
                               match="CUDA"):
                main(["decode", "-i", str(ldp)] + extra)


def test_default_device_is_cuda():
    """The CLI's --device and both decoders' device default to cuda; no
    decode is made."""
    args = build_parser().parse_args(["decode", "-i", "x.265"])
    assert torch.device(args.device) == torch.device("cuda")
    assert build_parser().parse_args(
        ["decode", "-i", "x.265", "--device", "cpu"]).device == "cpu"
    for cls in (TorchDecoder, PipelinedTorchDecoder):
        assert cls().device == torch.device("cuda")
        assert cls("cpu").device == torch.device("cpu")
