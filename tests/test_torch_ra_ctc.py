"""The CTC's random access (p265_tpu_torch/testgen/ctc.py "RA-CTC") on the
CPU, at QP 32, and the benchmark cell that decodes it at 1080p.

- The committed 96x64 stream s96x64_ractc17 (an IDR and two GOPs of 8 B
  pictures, QP 32) is what the encoder writes for its recipe, and
  TorchDecoder("cpu"), the benchmark's plain reference
  (decode_bench/reference) and the encoder's own reconstruction give the
  same planes, in ascending POC.
- It covers what the configuration main1080_ra_1card exists for: B
  pictures, bi-predicted PUs, each of the four AMP shapes, AMVP PUs that
  code ref_idx 1, TMVP on in every B slice and more than one slice QP.
- Each picture's L0 and L1, as the port's DPB builds them, equal the
  lists of the GOP table below, written out by hand from
  encoder_randomaccess_main.cfg (a witness apart from dpb/ and from the
  encoder's own list derivation).
- With its SPS and VPS rewritten to a DPB of five, the size HM signals
  for this GOP, the same stream still comes out of TorchDecoder("cpu") in
  the order 0..16 (spec C.5.2.2 does not count the current picture when
  it checks the DPB for fullness).
- The cell main1080_ra_1card.ra_segments resolves, with all its files:
  the stream's sum, the reference's digests of 17 pictures in POC order,
  the frozen work.

The QP 40 stream and the parallel encode: test_torch_ra_ctc_qp40.py.
"""
import dataclasses
import functools
import hashlib
import json
import os

import numpy as np
import pytest

from decode_bench import reference
from decode_bench.harness import check, spec, streams as bench_streams
from p265_tpu_torch.hls.params import PPS
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.testgen import streams
from p265_tpu_torch.testgen.ctc import (CtcEncoder, parameter_sets,
                                        ra_ctc_sps)
from p265_tpu_torch.testgen.encoder import make_moving_sequence

NAME = "s96x64_ractc17"
CELL = "main1080_ra_1card.ra_segments"
# POC -> (L0, L1) of the GOP table (references before POC 0 dropped, two
# active a list: L0 the nearest before then after, L1 after then before)
LISTS = {
    8: ([0], [0]), 4: ([0, 8], [8, 0]), 2: ([0, 4], [4, 8]),
    1: ([0, 2], [2, 4]), 3: ([2, 0], [4, 8]), 6: ([4, 2], [8, 4]),
    5: ([4, 0], [6, 8]), 7: ([6, 4], [8, 6]), 16: ([8, 6], [8, 6]),
    12: ([8, 6], [16, 8]), 10: ([8, 6], [12, 16]), 9: ([8, 10], [10, 12]),
    11: ([10, 8], [12, 16]), 14: ([12, 10], [16, 12]),
    13: ([12, 8], [14, 16]), 15: ([14, 12], [16, 14]),
}
AMP = {"2NxnU", "2NxnD", "nLx2N", "nRx2N"}


def _pps() -> PPS:
    return PPS(init_qp=32, sign_data_hiding=True, num_ref_idx_l0_default=2,
               num_ref_idx_l1_default=2)


@functools.lru_cache(maxsize=None)
def _encoded():
    """The recipe of s96x64_ractc17 (streams._ra_ctc(96, 64, 17)), in three
    worker processes -> (stream, encoder recon in POC order)."""
    enc = CtcEncoder(ra_ctc_sps(96, 64), _pps(), qp=32, seed=5)
    return enc.encode_sequence(make_moving_sequence(96, 64, 17, 5), "RA-CTC",
                               jobs=3)


@functools.lru_cache(maxsize=None)
def _port():
    return TorchDecoder("cpu").decode_stream(streams.get_stream(NAME))


def _parts(plan) -> list:
    """The partition of each 2-PU CU, from the PU records in parse order:
    AMP shapes by their first PU."""
    out, pus = [], plan.pus
    for a, b in zip(pus, pus[1:]):
        if a.w == b.w and a.x == b.x and b.y == a.y + a.h and a.w == a.h + b.h:
            out.append("2NxnU" if 4 * a.h == a.w else
                       "2NxnD" if 4 * b.h == a.w else "2NxN")
        elif (a.h == b.h and a.y == b.y and b.x == a.x + a.w
              and a.h == a.w + b.w):
            out.append("nLx2N" if 4 * a.w == a.h else
                       "nRx2N" if 4 * b.w == a.h else "Nx2N")
    return out


def test_committed_stream_is_the_recipe():
    data = streams.get_stream(NAME)
    assert hashlib.sha256(data).hexdigest() == streams.committed_sums()[
        NAME + ".265"]
    assert _encoded()[0] == data
    assert streams.stream_info(data) == dict(
        width=96, height=64, frames=17, tiles=(1, 1), wpp=False)


def test_port_reference_and_encoder_agree():
    frames = _port()
    ref = reference.decode(streams.get_stream(NAME))
    recon = _encoded()[1]
    assert [f.poc for f in frames] == list(range(17))     # POC order
    assert [f.poc for f in ref] == list(range(17))
    for f, r, e in zip(frames, ref, recon):
        for c in range(3):
            assert np.array_equal(f.planes[c], r.planes[c]), (f.poc, c)
            assert np.array_equal(f.planes[c], e[c]), (f.poc, c)


def test_coverage():
    plans = [f.plan for f in _port()]
    kinds = [p.sh.slice_type for p in plans]
    assert kinds.count(2) == 1 and kinds.count(0) == 16      # I, B
    pus = [pu for p in plans for pu in p.pus]
    bi = [pu for pu in pus if min(pu.motion.ref_idx) >= 0]
    assert len(bi) > len(pus) // 5
    assert AMP <= {s for p in plans for s in _parts(p)}
    # AMVP PUs that code ref_idx 1, from the native parse's PU syntax
    # events ([1, x, y, w, h, part, part_idx, merge, merge_idx, idc, ref0,
    # ref1, ...], native/ctu.c EV_PU)
    ev = np.concatenate([p.nstate.ev[:int(p.nstate._ev.count)]
                         for p in plans[1:]])
    pu = ev[ev[:, 0] == 1]
    assert np.any((pu[:, 7] == 0) & ((pu[:, 10] == 1) | (pu[:, 11] == 1)))
    assert all(p.sh.temporal_mvp_enabled for p in plans if p.sh.slice_type
               != 2)
    assert all(not p.sh.collocated_from_l0 for p in plans
               if p.sh.slice_type == 0)
    assert len({p.sh.slice_qp for p in plans}) == 5      # 32 and +1..+4


def test_lists_are_the_gop_tables():
    got = {f.poc: (f.plan.l0_pocs, f.plan.l1_pocs) for f in _port()
           if f.poc}
    assert got == LISTS


def test_a_dpb_of_five_outputs_in_poc_order():
    data = streams.get_stream(NAME)
    head = parameter_sets(ra_ctc_sps(96, 64), _pps())
    assert data.startswith(head)      # a DPB of six, as committed
    sps = dataclasses.replace(ra_ctc_sps(96, 64), max_dec_pic_buffering=5)
    five = parameter_sets(sps, _pps()) + data[len(head):]
    frames = TorchDecoder("cpu").decode_stream(five)
    assert [f.poc for f in frames] == list(range(17))


def test_the_cell_resolves_with_all_its_files():
    c = spec.cell(CELL)
    assert c["workload"]["chips"] == 1 and c["config"]["chips"] == 1
    assert c["traffic"]["pool"] == {"s1080_ra17": 1}
    assert c["config"]["decoder"]["frame_dag_max"] == 1
    assert "recon.mc_pack_us_per_block" in c["per_layer"]
    assert len(c["per_layer"]) == 11
    for name in c["per_layer"]:
        assert callable(spec.metric(name).read)
    assert bench_streams.read_sum("s1080_ra17") == streams.committed_sums()[
        "s1080_ra17.265"]
    exp = check.load_expected("s1080_ra17")
    assert [p["poc"] for p in exp["pictures"]] == list(range(17))
    with open(os.path.join(bench_streams.BENCH_DIR, "work",
                           "s1080_ra17.json")) as f:
        work = json.load(f)
    assert (work["pictures"], work["inter"]) == (17, 16)


@pytest.mark.parametrize("n", [0, 2, 16, 18])
def test_other_lengths_are_refused(n):
    from p265_tpu_torch.testgen.ctc import ra_ctc_schedule
    with pytest.raises(ValueError, match="1 \\+ 8k"):
        ra_ctc_schedule(n)
