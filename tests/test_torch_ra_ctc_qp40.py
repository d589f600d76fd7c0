"""The CTC's random access (p265_tpu_torch/testgen/ctc.py "RA-CTC") at QP
40, its parallel encode, and the plain encoder's structures, on the CPU.

- The committed 96x64 stream s96x64_ractc17q40 (an IDR and two GOPs of 8
  B pictures, seed 7, QP 40, offsets up to QP 44), written by the serial
  encode of its recipe: the encode with three worker processes writes the
  same bytes, and TorchDecoder("cpu"), the benchmark's plain reference and
  that encode's reconstruction give the same planes, in ascending POC,
  with bi-predicted PUs and TMVP on in every B slice.
- The port's plain `Encoder` still writes the committed s96x64_ra5 byte
  for byte: CtcEncoder changed no existing structure.

QP 32, coverage and the reference lists: test_torch_ra_ctc.py.
"""
import functools
import hashlib

import numpy as np

from decode_bench import reference
from p265_tpu_torch.hls.params import PPS, SPS
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.testgen import streams
from p265_tpu_torch.testgen.ctc import CtcEncoder, ra_ctc_sps
from p265_tpu_torch.testgen.encoder import Encoder, make_moving_sequence

NAME = "s96x64_ractc17q40"


@functools.lru_cache(maxsize=None)
def _parallel():
    """The recipe of s96x64_ractc17q40 in three worker processes ->
    (stream, encoder recon in POC order)."""
    sps = ra_ctc_sps(96, 64)
    pps = PPS(init_qp=40, sign_data_hiding=True, num_ref_idx_l0_default=2,
              num_ref_idx_l1_default=2)
    return CtcEncoder(sps, pps, qp=40, seed=7).encode_sequence(
        make_moving_sequence(96, 64, 17, seed=7), "RA-CTC", jobs=3)


def test_qp40_port_reference_and_encoder_agree():
    data = streams.get_stream(NAME)
    frames = TorchDecoder("cpu").decode_stream(data)
    ref = reference.decode(data)
    recon = _parallel()[1]
    assert [f.poc for f in frames] == [f.poc for f in ref] == list(range(17))
    for f, r, e in zip(frames, ref, recon):
        for c in range(3):
            assert np.array_equal(f.planes[c], r.planes[c]), (f.poc, c)
            assert np.array_equal(f.planes[c], e[c]), (f.poc, c)
    plans = [f.plan for f in frames]
    assert {p.sh.slice_qp for p in plans} == {40, 41, 42, 43, 44}
    assert all(p.sh.temporal_mvp_enabled for p in plans[1:])
    assert any(min(pu.motion.ref_idx) >= 0 for p in plans for pu in p.pus)


def test_parallel_encode_writes_the_serial_bytes():
    data = streams.get_stream(NAME)
    assert hashlib.sha256(data).hexdigest() == streams.committed_sums()[
        NAME + ".265"]
    assert streams.stream_info(data) == dict(
        width=96, height=64, frames=17, tiles=(1, 1), wpp=False)
    assert _parallel()[0] == data


def test_plain_encoder_writes_the_committed_ra5():
    """s96x64_ra5: the plain encoder's RA structure (seed 50, QP 32, TMVP
    on)."""
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5)
    pps = PPS(init_qp=32, sign_data_hiding=True)
    data, _ = Encoder(sps, pps, qp=32, seed=50).encode_sequence(
        make_moving_sequence(96, 64, 5, seed=50), "RA")
    assert data == streams.get_stream("s96x64_ra5")
    assert hashlib.sha256(data).hexdigest() == streams.committed_sums()[
        "s96x64_ra5.265"]
