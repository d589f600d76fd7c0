"""Conformance streams beyond the committed set, made by the port's encoder:
the stream kinds that the JAX package's tests hold TpuDecoder and
GoldenDecoder to (long-term references, cu_qp_delta in intra and inter
pictures, reference-list modification, several slices, dependent slice
segments, slices with tiles and with WPP, weighted prediction over short-
and long-term references, and the CRA / RASL / BLA / EOS splices), at
96x64 to 192x128.

`STREAMS` maps a name to (make, holds): make() returns the stream's bytes,
holds(golden frames) whether the golden decode shows what the case is
about.  The recipes are those of tests/test_torch_conformance.py, which
decodes them on CPU tensors; tests/test_torch_gpu.py decodes them on the
card.  `param_nals` and `splice_from_cra` are the port's copies of the
helpers `_param_nals` (tests/test_multislice.py) and `_splice_from_cra`
(tests/test_rasl.py) of the JAX package's tests, on the port's hls.
"""
from __future__ import annotations

import functools

from p265_tpu_torch.hls import nal
from p265_tpu_torch.hls.bitio import BitWriter
from p265_tpu_torch.hls.params import (PPS, SPS, write_pps, write_sps,
                                       write_vps)
from p265_tpu_torch.hls.slice_header import SLICE_I
from p265_tpu_torch.testgen.encoder import (Encoder, IntraEncoder,
                                            make_moving_sequence,
                                            make_test_image)


def param_nals(sps, pps) -> bytes:
    """VPS, SPS and PPS NAL units of a stream."""
    out = b""
    for t, wfn, arg in ((nal.NAL_VPS, write_vps, None),
                        (nal.NAL_SPS, write_sps, sps),
                        (nal.NAL_PPS, write_pps, pps)):
        w = BitWriter()
        (wfn(w) if arg is None else wfn(w, arg))
        out += nal.make_nal(t, w.get_bytes())
    return out


def splice_from_cra(stream: bytes) -> bytes:
    """The parameter sets of `stream`, then its NAL units from the first
    CRA on (a stream spliced in at a CRA: its RASL pictures are
    dropped)."""
    out = b""
    seen_cra = False
    for u in nal.split_nal_units(stream):
        if u.nal_type in (nal.NAL_VPS, nal.NAL_SPS, nal.NAL_PPS):
            out += nal.make_nal(u.nal_type, u.rbsp)
        elif u.nal_type == nal.NAL_CRA:
            seen_cra = True
            out += nal.make_nal(u.nal_type, u.rbsp)
        elif seen_cra:
            out += nal.make_nal(u.nal_type, u.rbsp)
    return out


def _gop(structure, n, seed, qp=32, w=96, h=64, sps_kw=None, num_slices=1,
         **pps_kw):
    sps = SPS(pic_width=w, pic_height=h, temporal_mvp_enabled=True,
              **(sps_kw or {}))
    pps = PPS(init_qp=qp, **pps_kw)
    return Encoder(sps, pps, qp=qp, seed=seed).encode_sequence(
        make_moving_sequence(w, h, n, seed=seed), structure=structure,
        num_slices=num_slices)[0]


def _sliced_intra(seed, num_slices, dependent=False, w=128, h=128, qp=31,
                  **pps_kw):
    sps = SPS(pic_width=w, pic_height=h)
    pps = PPS(init_qp=qp, sign_data_hiding=True, **pps_kw)
    nb = Encoder(sps, pps, qp=qp, seed=seed).encode_frame(
        make_test_image(w, h, seed), poc=0, slice_type=SLICE_I,
        num_slices=num_slices, dependent_slices=dependent)[0]
    return param_nals(sps, pps) + nb


_LT = dict(long_term_ref_pics_present=True, num_reorder_pics=2,
           max_dec_pic_buffering=6)


@functools.lru_cache(maxsize=None)
def _cra():
    sps = SPS(pic_width=96, pic_height=64, num_reorder_pics=2,
              max_dec_pic_buffering=6)
    return Encoder(sps, PPS(init_qp=30), qp=30, seed=7).encode_sequence(
        make_moving_sequence(96, 64, 8, seed=11), structure="CRA-RASL")[0]


def _cra_as_bla():
    return b"".join(
        nal.make_nal(nal.NAL_BLA_W_LP if u.nal_type == nal.NAL_CRA
                     else u.nal_type, u.rbsp)
        for u in nal.split_nal_units(_cra()))


def _eos_before_cra():
    return b"".join(
        (nal.make_nal(nal.NAL_EOS, b"") if u.nal_type == nal.NAL_CRA
         else b"") + nal.make_nal(u.nal_type, u.rbsp)
        for u in nal.split_nal_units(_cra()))


def _qp_delta_intra():
    sps = SPS(pic_width=128, pic_height=64)
    pps = PPS(init_qp=30, cu_qp_delta_enabled=True, diff_cu_qp_delta_depth=2,
              sign_data_hiding=True)
    return IntraEncoder(sps, pps, qp=30, seed=9).encode_frame(
        make_test_image(128, 64, 9))[0]


# name -> (function that makes the stream, check that the golden decode holds
# what the case is about)
STREAMS = {
    "longterm": (
        lambda: _gop("LDP-LT", 4, 4, qp=30, sps_kw=_LT,
                     sign_data_hiding=True),
        lambda g: any(f.plan.sh.lt_entries for f in g)),
    "cu_qp_delta_intra": (
        _qp_delta_intra,
        lambda g: len(set(g[0].plan.qp_map.ravel().tolist())) > 1),
    "cu_qp_delta_inter": (
        lambda: _gop("LDP", 3, 19, cu_qp_delta_enabled=True,
                     diff_cu_qp_delta_depth=1),
        lambda g: any(len(set(f.plan.qp_map.ravel().tolist())) > 1
                      for f in g if f.plan.pus)),
    "ref_list_modification": (
        lambda: _gop("LDP2", 4, 21, lists_modification_present=True),
        lambda g: any(f.plan.sh.ref_pic_list_modification_l0 for f in g)),
    "multislice_intra": (
        lambda: _sliced_intra(30, 3, w=192),
        lambda g: len(set(g[0].plan.slice_of_ctb.tolist())) == 3),
    "multislice_p_gop": (
        lambda: _gop("LDP", 3, 31, qp=33, w=128, h=128, num_slices=2,
                     sign_data_hiding=True),
        lambda g: all(len(set(f.plan.slice_of_ctb.tolist())) == 2
                      for f in g)),
    "dependent_slices": (
        lambda: _sliced_intra(33, 3, dependent=True, w=192,
                              dependent_slice_segments_enabled=True),
        lambda g: True),
    "multislice_tiles": (
        lambda: _sliced_intra(40, 2, tiles_enabled=True, num_tile_columns=2,
                              num_tile_rows=2),
        lambda g: len(set(g[0].plan.slice_of_ctb.tolist())) == 2),
    "multislice_wpp": (
        lambda: _sliced_intra(41, 2, entropy_coding_sync_enabled=True),
        lambda g: len(set(g[0].plan.slice_of_ctb.tolist())) == 2),
    "dependent_slices_wpp": (
        lambda: _sliced_intra(43, 2, dependent=True,
                              entropy_coding_sync_enabled=True,
                              dependent_slice_segments_enabled=True),
        lambda g: True),
    "weighted_pred_longterm": (
        lambda: _gop("LDP-LT", 5, 21, qp=30, sps_kw=_LT,
                     sign_data_hiding=True, weighted_pred=True,
                     weighted_bipred=True),
        lambda g: [f.poc for f in g] == list(range(5))),
    "cra_rasl_full": (
        _cra, lambda g: [f.poc for f in g] == list(range(8))),
    "cra_splice": (
        lambda: splice_from_cra(_cra()),
        lambda g: [f.poc for f in g] == [3, 4, 5, 6, 7]),
    "bla_rewrite": (
        _cra_as_bla, lambda g: [f.poc for f in g] == [0, 1, 3, 4, 5, 6, 7]),
    "eos_before_cra": (
        _eos_before_cra,
        lambda g: [f.poc for f in g] == [0, 1, 3, 4, 5, 6, 7]),
}
