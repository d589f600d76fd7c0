"""Auxiliary subsystems of the port's decoders on CPU tensors: error
resilience, checkpoint/resume and metrics, after tests/test_aux.py, for
TorchDecoder and PipelinedTorchDecoder, each held against golden.  Also a
corrupt WPP stream whose row ends before the row below can sync: the
port's WPP row lanes raise a ValueError that names the row, and under
error_resilient the picture is dropped as for other parse errors.
"""
import functools
import json

import numpy as np
import pytest

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu_torch.hls import nal
from p265_tpu_torch.hls.params import PPS, SPS
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.syntax import ctu
from p265_tpu_torch.testgen import encoder as port_encoder
from p265_tpu_torch.testgen.encoder import Encoder, make_moving_sequence

DECODERS = [TorchDecoder, PipelinedTorchDecoder]


@functools.lru_cache(maxsize=None)
def _two_gop_stream(w=96, h=64, qp=33, seed=8):
    """IDR P P | IDR P P: two coded video sequences, so that the resync at
    the second IRAP can be seen."""
    sps = SPS(pic_width=w, pic_height=h, temporal_mvp_enabled=True)
    pps = PPS(init_qp=qp, sign_data_hiding=True)
    frames = make_moving_sequence(w, h, 6, seed=seed)
    s1, r1 = Encoder(sps, pps, qp=qp, seed=seed).encode_sequence(
        frames[:3], structure="LDP")
    s2, r2 = Encoder(sps, pps, qp=qp, seed=seed + 1).encode_sequence(
        frames[3:], structure="LDP")
    tail = b"".join(nal.make_nal(u.nal_type, u.rbsp)
                    for u in nal.split_nal_units(s2)
                    if nal.is_slice_nal(u.nal_type))
    return s1 + tail, r1 + r2


def _truncate_slice(stream: bytes, which: int) -> bytes:
    """Cut the payload of the `which`-th slice NAL to a third, so that the
    CABAC engine starves."""
    units = nal.split_nal_units(stream)
    idx = [i for i, u in enumerate(units) if nal.is_slice_nal(u.nal_type)]
    return b"".join(
        nal.make_nal(u.nal_type,
                     u.rbsp[:max(8, len(u.rbsp) // 3)] if i == idx[which]
                     else u.rbsp)
        for i, u in enumerate(units))


def _same_frames(got, want):
    assert [f.poc for f in got] == [f.poc for f in want]
    for f, g in zip(got, want):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)


@pytest.mark.parametrize("cls", DECODERS)
def test_error_resilience_resync_at_irap(cls):
    stream, recons = _two_gop_stream()
    bad = _truncate_slice(stream, 1)        # the first GOP's first P
    gold = GoldenDecoder(error_resilient=True)
    want = gold.decode_stream(bad)
    assert gold.errors
    dec = cls("cpu", error_resilient=True)
    frames = dec.decode_stream(bad)
    assert dec.errors, "corruption should be detected"
    assert len(dec.errors) == len(gold.errors)
    # the same pictures as golden, and the second GOP bit-exact
    _same_frames(frames, want)
    for i, f in enumerate(frames[-3:]):
        for c in range(3):
            assert np.array_equal(f.planes[c], recons[3 + i][c]), (i, c)
    # without resilience the same stream raises
    with pytest.raises(Exception):
        cls("cpu").decode_stream(bad)


@pytest.mark.parametrize("cls", DECODERS)
def test_error_resilience_set_after_construction(cls):
    """The CLI sets the attribute, as the reference's does."""
    stream, _ = _two_gop_stream()
    dec = cls("cpu")
    dec.error_resilient = True
    frames = dec.decode_stream(_truncate_slice(stream, 2))
    assert dec.errors and len(frames) >= 3


@pytest.mark.parametrize("dag", [1, 4])
@pytest.mark.parametrize("cls", DECODERS)
def test_checkpoint_resume_bit_exact(cls, dag):
    stream, _ = _two_gop_stream(seed=9)
    units = nal.split_nal_units(stream)
    full = cls("cpu").decode_stream(stream)
    _same_frames(full, GoldenDecoder().decode_stream(stream))

    d1 = cls("cpu", frame_dag_max=dag)
    half = len(units) // 2
    for u in units[:half]:
        d1.decode_nal(u)
    state = d1.save_state()
    # the state holds finished pictures only
    for pic in state["dpb"].pics:
        assert pic.planes is not None and pic.user.planes is not None

    d2 = cls("cpu", frame_dag_max=dag)
    d2.load_state(state)
    for u in units[half:]:
        d2.decode_nal(u)
    resumed = d2.flush()
    assert len(resumed) >= 1
    _same_frames(resumed, full[len(full) - len(resumed):])
    # the decoder the state was taken from goes on decoding
    for u in units[half:]:
        d1.decode_nal(u)
    _same_frames(d1.flush(), full)


@pytest.mark.parametrize("cls", DECODERS)
def test_metrics_jsonl(cls, tmp_path):
    stream, _ = _two_gop_stream(seed=10)
    dec = cls("cpu")
    dec.decode_stream(stream)
    p = str(tmp_path / "m.jsonl")
    dec.write_metrics(p)
    rec = json.loads(open(p).read().strip())
    assert rec["frames"] == 6
    assert rec["parse_s"] > 0 and rec["tus"] > 0 and rec["parse_mb_s"] > 0
    for key in ("pack_s", "upload_s", "dispatch_s", "recon_s", "fetch_s"):
        assert rec[key] > 0, key


def _wpp_intra(monkeypatch, cut: bool, w=128, h=256, seed=7) -> bytes:
    """One WPP intra picture of 2 x 4 CTBs by the port's encoder.  cut:
    its one slice ends after the first CTU of row 1 (end_of_slice_segment_
    flag), while its header still carries an entry point for every row, the
    missing rows' substreams filler bytes: row 2 then finds no post-CTU-1
    context of row 1 to sync from."""
    sps = SPS(pic_width=w, pic_height=h)
    pps = PPS(init_qp=32, entropy_coding_sync_enabled=True)
    img = port_encoder.make_test_image(w, h, seed)
    enc = port_encoder.IntraEncoder(sps, pps, qp=32, seed=seed)
    if not cut:
        return enc.encode_frame(img)[0]
    rows = h // sps.ctb_size
    serialize, finalize = Encoder._serialize, ctu.EncodeSubstreams.finalize

    def cut_serialize(self, plan, sh, *a):
        wc = self.sps.pic_width_ctbs
        scan = self.tile_info.ctb_scan
        self.slice_chunks = [scan[:wc + 1], scan[wc + 1:]]
        return serialize(self, plan, sh, *a)

    def padded_finalize(self):
        data, sizes = finalize(self)
        if len(sizes) == 1:          # the cut slice: row 0 and one CTU
            sizes = sizes + [len(data) - sizes[0]] + [8] * (rows - 3)
            data += b"\xa5" * (8 * (rows - 2))
        return data, sizes

    monkeypatch.setattr(Encoder, "_serialize", cut_serialize)
    monkeypatch.setattr(ctu.EncodeSubstreams, "finalize", padded_finalize)
    stream = enc.encode_frame(img)[0]
    monkeypatch.undo()
    units = nal.split_nal_units(stream)
    first = next(u for u in units if nal.is_slice_nal(u.nal_type))
    return b"".join(nal.make_nal(u.nal_type, u.rbsp) for u in units
                    if not nal.is_slice_nal(u.nal_type) or u is first)


@pytest.mark.parametrize("cls", DECODERS)
def test_wpp_row_above_cut_short_raises(cls, monkeypatch):
    bad = _wpp_intra(monkeypatch, cut=True)
    good = _wpp_intra(monkeypatch, cut=False)
    monkeypatch.setenv("P265_TPU_PARSE_WORKERS", "4")
    lanes = []
    monkeypatch.setattr(ctu.CtuCoder, "_code_wpp_parallel", (
        lambda orig: lambda self: lanes.append(1) or orig(self))(
            ctu.CtuCoder._code_wpp_parallel))
    _same_frames(cls("cpu").decode_stream(good),
                 GoldenDecoder().decode_stream(good))
    assert lanes == [1]           # the WPP row lanes parsed it
    with pytest.raises(ValueError, match="WPP row 2: row 1 ended before "
                       "its second CTU"):
        cls("cpu").decode_stream(bad)
    assert lanes == [1, 1]


@pytest.mark.parametrize("cls", DECODERS)
def test_wpp_row_above_cut_short_concealed(cls, monkeypatch):
    """Under error_resilient the corrupt picture is dropped and the next
    IDR picture decodes, as golden does for the same stream."""
    bad = _wpp_intra(monkeypatch, cut=True)
    good = _wpp_intra(monkeypatch, cut=False)
    monkeypatch.setenv("P265_TPU_PARSE_WORKERS", "4")
    want = GoldenDecoder(error_resilient=True).decode_stream(bad + good)
    dec = cls("cpu", error_resilient=True)
    frames = dec.decode_stream(bad + good)
    assert "ValueError('WPP row 2" in dec.errors[0], dec.errors
    _same_frames(frames, want)
    _same_frames(frames[-1:], GoldenDecoder().decode_stream(good))
