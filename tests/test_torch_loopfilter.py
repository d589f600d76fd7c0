"""Port's loop filters vs the JAX reference, bit-exact.

The NumPy copies of the edge-parameter and SAO-map builders against the
originals, then deblocking (vertical, then horizontal on the transposes)
and SAO (band and edge classes) against the JAX device functions, stage by
stage, on golden pre-filter planes of small intra and P pictures; the end
of the chain must also equal the golden decoder's output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p265_tpu.kernels.loopfilter as jlf
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.syntax.ctu import SAO_BAND, SAO_EDGE
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence
from p265_tpu_torch.kernels import loopfilter as lf


@pytest.fixture(scope="module")
def frames():
    """Golden decode of a 128x64 LDP stream: one I and two P pictures."""
    sps = SPS(pic_width=128, pic_height=64, temporal_mvp_enabled=True)
    pps = PPS(init_qp=34, sign_data_hiding=True)
    seq = make_moving_sequence(128, 64, 3, seed=23)
    stream, _ = Encoder(sps, pps, qp=34, seed=23).encode_sequence(seq)
    gold = GoldenDecoder().decode_stream(stream)
    assert any(g.plan.pus for g in gold)
    types = {t for g in gold for r in g.plan.sao for t in r.type}
    assert {SAO_BAND, SAO_EDGE} <= types
    return gold


def test_host_params_match_jax(frames):
    for g in frames:
        p = g.plan
        for vertical in (True, False):
            for a, b in zip(lf.luma_edge_params(p, vertical),
                            jlf.luma_edge_params(p, vertical)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(lf.chroma_edge_params(p, vertical),
                            jlf.chroma_edge_params(p, vertical)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        for c in range(3):
            for a, b in zip(lf.sao_maps(p, c), jlf._sao_maps(p, c)):
                assert np.array_equal(a, b)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_deblock_and_sao_match_jax(frames):
    for g in frames:
        p = g.plan
        jy, jcb, jcr = (jnp.asarray(x) for x in g.prefilter)
        ty = _t(g.prefilter[0])[None]
        tc = torch.stack([_t(g.prefilter[1]), _t(g.prefilter[2])])
        for vertical in (True, False):
            bs, beta, tcv = jlf.luma_edge_params(p, vertical)
            tcb, tcr = jlf.chroma_edge_params(p, vertical)
            if not vertical:
                jy, jcb, jcr = jy.T, jcb.T, jcr.T
                ty, tc = ty.transpose(1, 2), tc.transpose(1, 2)
            jy = jlf._deblock_luma_vertical(jy, bs, beta, tcv)
            jcb = jlf._deblock_chroma_vertical(jcb, tcb)
            jcr = jlf._deblock_chroma_vertical(jcr, tcr)
            ty = lf.deblock_luma_vertical(ty, _t(bs)[None], _t(beta)[None],
                                          _t(tcv)[None])
            tc = lf.deblock_chroma_vertical(tc, torch.stack([_t(tcb),
                                                             _t(tcr)]))
            if not vertical:
                jy, jcb, jcr = jy.T, jcb.T, jcr.T
                ty, tc = ty.transpose(1, 2), tc.transpose(1, 2)
            assert np.array_equal(ty[0].numpy(), np.asarray(jy)), vertical
            assert np.array_equal(tc[0].numpy(), np.asarray(jcb)), vertical
            assert np.array_equal(tc[1].numpy(), np.asarray(jcr)), vertical
        ctb = p.sps.ctb_size
        out = []
        for c, (jx, tx) in enumerate(((jy, ty[0]), (jcb, tc[0]),
                                      (jcr, tc[1]))):
            ty_g, cls_g, offs_g = jlf._sao_maps(p, c)
            cs = ctb if c == 0 else ctb >> 1
            want = np.asarray(jlf._sao_apply(jx, ty_g, cls_g, offs_g, cs))
            got = lf.sao_apply(tx[None], _t(ty_g)[None], _t(cls_g)[None],
                               _t(offs_g)[None], cs)[0]
            assert np.array_equal(got.numpy(), want), (g.poc, c)
            out.append(got.numpy())
        for c in range(3):
            assert np.array_equal(out[c], g.planes[c]), (g.poc, c)
