"""Port's loop filters vs the JAX reference, bit-exact.

The NumPy copies of the edge-parameter and SAO-map builders against the
originals, then deblocking (vertical, then horizontal on the transposes)
and SAO (band and edge classes) against the JAX device functions, stage by
stage, on golden pre-filter planes of small intra and P pictures; the end
of the chain must also equal the golden decoder's output.  Then the chain
as the batch path runs it (filter_planes on the int16 and int8 wire grids
of pack_filter_params, staged, with bypass masks: SAO's uint8 store with
the restore, or the torch route where a component has no SAO) against the
reference's deblocking, SAO, jnp.where and astype(uint8)
(p265_tpu/pipeline/batch_decode.py:449-480) on pictures with lossless CUs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p265_tpu.kernels.loopfilter as jlf
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.syntax.ctu import SAO_BAND, SAO_EDGE
from p265_tpu.testgen.encoder import (Encoder, IntraEncoder,
                                      make_moving_sequence, make_test_image)
from p265_tpu_torch.kernels import loopfilter as lf
from p265_tpu_torch.kernels.staging import stage


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


def _lossless(name: str):
    """Golden decode of a 96x64 intra picture with lossless CUs: CUs coded
    with cu_transquant_bypass, or PCM CUs with the loop filters off for
    them; each has bypass masks."""
    sps_kw, pps_kw, seed = {}, {}, 3
    if name == "bypass":
        pps_kw = dict(transquant_bypass_enabled=True)
    else:
        sps_kw, seed = dict(pcm_enabled=True,
                            pcm_loop_filter_disabled=True), 4
    sps = SPS(pic_width=96, pic_height=64, **sps_kw)
    pps = PPS(init_qp=30, sign_data_hiding=True, **pps_kw)
    data = IntraEncoder(sps, pps, qp=30, seed=seed).encode_frame(
        make_test_image(96, 64, seed))[0]
    return GoldenDecoder().decode_stream(data)


def _jax_chain(luma, chroma, fp: dict, ctb: int, flags) -> tuple:
    """The reference's filter chain of a batch
    (p265_tpu/pipeline/batch_decode.py:449-480): the wire grids widened
    to int32, deblocking V then H, SAO, the bypass restore, uint8."""
    i32 = {k: jnp.asarray(v).astype(jnp.int32) for k, v in fp.items()
           if not k.startswith("mask")}
    pre_luma, pre_chroma = jnp.asarray(luma), jnp.asarray(chroma)
    luma, chroma = pre_luma, pre_chroma
    deblock_on, sao_luma, sao_chroma = flags
    if deblock_on:
        for key in ("v", "h"):
            if key == "h":
                luma = jnp.swapaxes(luma, 1, 2)
                chroma = jnp.swapaxes(chroma, 1, 2)
            if i32[f"bs_{key}"].shape[2]:
                luma = jax.vmap(jlf._deblock_luma_vertical.__wrapped__)(
                    luma, i32[f"bs_{key}"], i32[f"beta_{key}"],
                    i32[f"tc_{key}"])
            if i32[f"tcc_{key}"].shape[2]:
                chroma = jax.vmap(jlf._deblock_chroma_vertical.__wrapped__)(
                    chroma, i32[f"tcc_{key}"])
            if key == "h":
                luma = jnp.swapaxes(luma, 1, 2)
                chroma = jnp.swapaxes(chroma, 1, 2)
    sao = jax.vmap(jlf._sao_apply.__wrapped__, in_axes=(0, 0, 0, 0, None))
    if sao_luma:
        luma = sao(luma, i32["sao_ty_0"], i32["sao_cls_0"],
                   i32["sao_off_0"], ctb)
    if sao_chroma:
        chroma = sao(chroma, i32["sao_ty_1"], i32["sao_cls_1"],
                     i32["sao_off_1"], ctb >> 1)
    if "mask_y" in fp:
        luma = jnp.where(fp["mask_y"], pre_luma, luma)
        chroma = jnp.where(fp["mask_c"], pre_chroma, chroma)
    return np.asarray(luma.astype(jnp.uint8)), np.asarray(
        chroma.astype(jnp.uint8))


@pytest.mark.parametrize("flags", [None, (True, True, False),
                                   (False, False, True)],
                         ids=["own", "no_sao_chroma", "sao_chroma_only"])
@pytest.mark.parametrize("name", ["bypass", "pcm"])
def test_filter_planes_wire_grids_with_bypass_match_jax(name, flags):
    """filter_planes on CPU tensors over the staged wire grids (int16
    deblocking, int8 SAO) and bypass masks: the uint8 outputs equal the
    reference chain's with the picture's own flags (and golden's planes),
    and with flags that leave a component without SAO (the torch route)
    or without deblocking."""
    gold = _lossless(name)
    plans = [g.plan for g in gold]
    own = lf.filter_flags(plans[0])
    assert own == (True, True, True)
    fp = lf.pack_filter_params(plans, flags)
    assert "mask_y" in fp and fp["mask_y"].any()
    for k, v in fp.items():
        want_dt = (np.bool_ if k.startswith("mask") else np.int8
                   if k.startswith("sao") else np.int16)
        assert v.dtype == want_dt, k
    luma = np.stack([g.prefilter[0] for g in gold]).astype(np.int32)
    chroma = np.stack([g.prefilter[c] for c in (1, 2) for g in gold]
                      ).astype(np.int32)
    ctb = plans[0].sps.ctb_size
    got = lf.filter_planes(torch.from_numpy(luma), torch.from_numpy(chroma),
                           stage(fp, "cpu"), ctb)
    want = _jax_chain(luma, chroma, fp, ctb, flags or own)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), w)
    if flags is None:
        for c in range(3):
            plane = got[0][0] if c == 0 else got[1][c - 1]
            assert np.array_equal(plane.numpy(), gold[0].planes[c]), c
