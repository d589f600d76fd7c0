"""Port's decoders on CPU tensors vs GoldenDecoder (and TpuDecoder), bit-exact.

TorchDecoder and PipelinedTorchDecoder decode I, LDP, LDP2, RA (bi-pred)
and weighted-prediction streams, a size that is not a multiple of the CTB,
transquant-bypass CUs, scaling lists with transform skip, and tiles with
WPP, and PCM CUs in an I picture and in P pictures; every plane of every
frame, before and after the loop filters, must equal the golden decoder's.
Also: the same as TpuDecoder on one LDP stream and on both PCM streams,
and the CLI's MD5.
"""
import functools
import subprocess
import sys

import numpy as np
import pytest

from p265_tpu import yuv
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.testgen.encoder import (Encoder, IntraEncoder,
                                      make_moving_sequence, make_test_image)
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder


def _intra(w, h, qp, seed, sps_kw=None, pps_kw=None):
    sps = SPS(pic_width=w, pic_height=h, **(sps_kw or {}))
    pps = PPS(init_qp=qp, sign_data_hiding=True, **(pps_kw or {}))
    return IntraEncoder(sps, pps, qp=qp, seed=seed).encode_frame(
        make_test_image(w, h, seed))[0]


def _gop(structure, seed, n=5, w=96, h=64, sps_kw=None, **pps_kw):
    sps = SPS(pic_width=w, pic_height=h, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5, **(sps_kw or {}))
    pps = PPS(init_qp=32, sign_data_hiding=True, **pps_kw)
    frames = make_moving_sequence(w, h, n, seed=seed)
    return Encoder(sps, pps, qp=32, seed=seed).encode_sequence(
        frames, structure=structure)[0]


_PCM = dict(pcm_enabled=True, pcm_loop_filter_disabled=True)

STREAMS = {
    "I_128x64": lambda: _intra(128, 64, 30, 11),
    "I_104x56": lambda: _intra(104, 56, 26, 21),
    "LDP": lambda: _gop("LDP", 41),
    "LDP2": lambda: _gop("LDP2", 5),
    "RA": lambda: _gop("RA", 50),
    "WP_RA": lambda: _gop("RA", 14, weighted_pred=True, weighted_bipred=True),
    "tiles_wpp_LDP": lambda: _gop("LDP", 15, n=3, w=128, h=128,
                                  tiles_enabled=True, num_tile_columns=2,
                                  num_tile_rows=2,
                                  entropy_coding_sync_enabled=True),
    "bypass": lambda: _intra(96, 64, 30, 3,
                             pps_kw=dict(transquant_bypass_enabled=True)),
    "scaling_tskip": lambda: _intra(96, 64, 30, 5,
                                    sps_kw=dict(scaling_list_enabled=True),
                                    pps_kw=dict(transform_skip_enabled=True)),
    # as tests/test_pcm_bypass_wp.py test_pcm_roundtrip (no sign hiding)
    "PCM_I": lambda: IntraEncoder(
        SPS(pic_width=96, pic_height=64, pcm_enabled=True,
            pcm_loop_filter_disabled=True), PPS(init_qp=30), qp=30,
        seed=4).encode_frame(make_test_image(96, 64, 4))[0],
    # every P picture holds both inter PUs and PCM CUs
    "PCM_LDP": lambda: _gop("LDP", 43, sps_kw=_PCM),
}


@functools.lru_cache(maxsize=None)
def _golden(name):
    data = STREAMS[name]()
    return data, GoldenDecoder().decode_stream(data)


def _assert_same(frames, gold):
    assert [f.poc for f in frames] == [g.poc for g in gold]
    for f, g in zip(frames, gold):
        for c in range(3):
            assert np.array_equal(f.prefilter[c].cpu().numpy(),
                                  g.prefilter[c]), (f.poc, c)
            assert f.planes[c].dtype == np.int32
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)


@pytest.mark.parametrize("cls", [TorchDecoder, PipelinedTorchDecoder])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_matches_golden(name, cls):
    data, gold = _golden(name)
    if name == "RA":
        assert any(p.motion.uses(0) and p.motion.uses(1)
                   for g in gold for p in g.plan.pus)
    if name == "PCM_LDP":
        assert all(g.plan.pus and any(t.pcm for t in g.plan.tus)
                   for g in gold[1:])
    _assert_same(cls("cpu").decode_stream(data), gold)


def _assert_same_as_tpu_decoder(name):
    from p265_tpu.pipeline.decoder import TpuDecoder
    data, _ = _golden(name)
    want = TpuDecoder().decode_stream(data)
    got = PipelinedTorchDecoder("cpu").decode_stream(data)
    assert [f.poc for f in got] == [f.poc for f in want]
    for f, w in zip(got, want):
        for c in range(3):
            assert np.array_equal(f.planes[c], np.asarray(w.planes[c]))
            assert np.array_equal(f.prefilter[c].numpy(),
                                  np.asarray(w.prefilter[c]))


def test_matches_tpu_decoder():
    _assert_same_as_tpu_decoder("LDP")


def writable_stamp_pcm(monkeypatch):
    """TpuDecoder fails on PCM P pictures: its stamp_pcm writes into the
    read-only np.asarray views of its device MC planes.  Give it writable
    copies; the samples it computes are unchanged."""
    import p265_tpu.kernels.mc as jmc
    orig = jmc.stamp_pcm

    def stamp(plan, out):
        out[:] = [np.array(p) for p in out]
        orig(plan, out)
    monkeypatch.setattr(jmc, "stamp_pcm", stamp)


@pytest.mark.parametrize("name", ["PCM_I", "PCM_LDP"])
def test_pcm_matches_tpu_decoder(name, monkeypatch):
    """PCM samples stamped over the device prediction, as TpuDecoder does
    (its device MC and stamp_pcm)."""
    writable_stamp_pcm(monkeypatch)
    _assert_same_as_tpu_decoder(name)


def test_cli_decode_md5(tmp_path):
    data, gold = _golden("LDP")
    src = tmp_path / "t.265"
    src.write_bytes(data)
    out = tmp_path / "out.yuv"
    r = subprocess.run([sys.executable, "-m", "p265_tpu_torch.cli", "decode",
                        "-i", str(src), "-o", str(out), "--md5",
                        "--device", "cpu"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = [g.cropped_planes() for g in gold]
    assert f"MD5: {yuv.sequence_md5(want)}" in r.stdout
    assert out.read_bytes() == b"".join(
        np.asarray(p, np.uint8).tobytes() for f in want for p in f)
