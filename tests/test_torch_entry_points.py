"""The port's per-stage entry points vs their JAX counterparts, bit-exact.

reconstruct_scan / reconstruct_scan_frames (reconstruct_tpu_scan*),
decode_batch, loop_filters / loop_filters_frames / deblock / sao
(loop_filters_tpu / ..._frames / deblock_tpu / sao_tpu) and predict_batch
(predict_batch and predict_batch_mxu): the same inputs, made from numpy
seeds (random arrays, or golden decodes of streams the seeded test encoder
makes), go through both packages on the CPU; tolerance zero.  Then the
TorchDecoder option matrix (fused, filters_on_device, apply_filters,
use_native_parse) against golden on one I and one LDP stream, for both
torch decoders.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p265_tpu.kernels.loopfilter as jlf
import p265_tpu.pipeline.batch_decode as jbd
import p265_tpu.pipeline.wavefront as jwf
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.kernels.intra import predict_batch as jax_predict_batch
from p265_tpu.kernels.intra_mxu import predict_batch_mxu
from p265_tpu.plan.frame_plan import build_tensor_plan as jax_tensor_plan
from p265_tpu_torch.hls.params import PPS, SPS
from p265_tpu_torch.kernels import intra
from p265_tpu_torch.kernels import loopfilter as lf
from p265_tpu_torch.pipeline import batch_decode as bd
from p265_tpu_torch.pipeline import wavefront as wf
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.testgen.encoder import (Encoder, IntraEncoder,
                                            make_moving_sequence,
                                            make_test_image)


def _intra_stream(w, h, seed, qp=30, sps_kw=None, pps_kw=None):
    sps = SPS(pic_width=w, pic_height=h, **(sps_kw or {}))
    pps = PPS(init_qp=qp, sign_data_hiding=True, **(pps_kw or {}))
    return IntraEncoder(sps, pps, qp=qp, seed=seed).encode_frame(
        make_test_image(w, h, seed))[0]


@functools.lru_cache(maxsize=None)
def _stream(name):
    if name == "I":
        return _intra_stream(96, 64, 1)
    if name == "I_small":
        return _intra_stream(64, 64, 2)
    if name == "bypass":
        return _intra_stream(96, 64, 3,
                             pps_kw=dict(transquant_bypass_enabled=True))
    if name == "pcm":
        return _intra_stream(96, 64, 4, sps_kw=dict(
            pcm_enabled=True, pcm_loop_filter_disabled=True))
    assert name == "LDP"
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True)
    pps = PPS(init_qp=33, sign_data_hiding=True)
    return Encoder(sps, pps, qp=33, seed=23).encode_sequence(
        make_moving_sequence(96, 64, 3, seed=23), structure="LDP")[0]


@functools.lru_cache(maxsize=None)
def _golden(name):
    return GoldenDecoder().decode_stream(_stream(name))


def _same(got, want):
    """Lists (of lists) of planes: torch tensors vs JAX/numpy arrays."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, (list, tuple)):
            _same(g, w)
        else:
            assert np.array_equal(g.cpu().numpy(), np.asarray(w))


def _refs(gold, g):
    return {f.poc: f.planes for f in gold if f.poc != g.poc}


# -- reconstruction ----------------------------------------------------------

@pytest.mark.parametrize("name", ["I", "LDP", "pcm"])
def test_reconstruct_scan_matches_jax(name):
    """Every picture of the stream; the P pictures carry the host MC
    prediction planes, the PCM picture its stamped samples."""
    gold = _golden(name)
    for g in gold:
        tplan = jax_tensor_plan(g.plan, _refs(gold, g))
        want = jwf.reconstruct_tpu_scan(tplan)
        got = wf.reconstruct_scan(tplan, "cpu")
        _same(got, want)
        _same(got, g.prefilter)
        _same([wf.reconstruct_scan_plane(tplan.planes[0], "cpu")],
              [jwf.reconstruct_tpu_scan_plane(tplan.planes[0])])
    if name == "LDP":
        assert any(g.plan.pus for g in gold)


def test_reconstruct_scan_frames_matches_jax():
    """Three pictures of two resolutions, one of them inter, in one scan."""
    ldp = _golden("LDP")
    golds = [_golden("I")[0], _golden("I_small")[0], ldp[1]]
    tplans = [jax_tensor_plan(g.plan, _refs(ldp, g)) for g in golds]
    want = jwf.reconstruct_tpu_scan_frames(tplans)
    got = wf.reconstruct_scan_frames(tplans, "cpu")
    _same(got, want)
    _same(got, [g.prefilter for g in golds])


@pytest.mark.parametrize("kind", ["intra", "inter"])
def test_decode_batch_matches_jax(kind):
    """Two I pictures (one with bypass masks), or the two P pictures of
    the LDP stream with their prediction planes attached."""
    ldp = _golden("LDP")
    golds = ([_golden("I")[0], _golden("bypass")[0]] if kind == "intra"
             else [g for g in ldp if g.plan.pus])
    assert len(golds) == 2
    plans = [g.plan for g in golds]
    # one batch is filtered with one set of flags
    assert len({lf.filter_flags(p) for p in plans}) == 1
    tplans = [jax_tensor_plan(g.plan, _refs(ldp, g)) for g in golds]
    want = jbd.decode_batch(tplans, plans)
    got = bd.decode_batch(tplans, plans, "cpu")
    _same(got, want)
    _same(got[0], [g.prefilter for g in golds])
    _same(got[1], [g.planes for g in golds])


# -- loop filters ------------------------------------------------------------

@pytest.mark.parametrize("name", ["LDP", "bypass", "pcm"])
def test_loop_filter_entry_points_match_jax(name):
    gold = _golden(name)
    if name != "LDP":
        assert lf.bypass_pixel_masks(gold[0].plan) is not None
    for g in gold:
        p, pre = g.plan, g.prefilter
        _same(lf.deblock(p, pre, "cpu"), jlf.deblock_tpu(p, pre))
        _same(lf.sao(p, pre, "cpu"), jlf.sao_tpu(p, pre))
        got = lf.loop_filters(p, pre, "cpu")
        _same(got, jlf.loop_filters_tpu(p, pre))
        _same(got, g.planes)
        # the chain is its stages, and takes tensors as well as arrays
        staged = lf.sao(p, lf.deblock(p, [torch.from_numpy(x) for x in pre],
                                      "cpu"), "cpu")
        if lf.bypass_pixel_masks(p) is None:
            _same(staged, g.planes)


def test_loop_filters_frames_matches_jax():
    gold = _golden("LDP")
    plans = [g.plan for g in gold]
    pres = [g.prefilter for g in gold]
    got = lf.loop_filters_frames(plans, pres, "cpu")
    _same(got, jlf.loop_filters_tpu_frames(
        plans, [[jnp.asarray(x) for x in pl] for pl in pres]))
    _same(got, [g.planes for g in gold])
    # with bypass masks in one of the pictures
    mixed = [_golden("I")[0], _golden("bypass")[0]]
    got = lf.loop_filters_frames([g.plan for g in mixed],
                                 [g.prefilter for g in mixed], "cpu")
    _same(got, jlf.loop_filters_tpu_frames(
        [g.plan for g in mixed],
        [[jnp.asarray(x) for x in g.prefilter] for g in mixed]))
    _same(got, [g.planes for g in mixed])


def test_loop_filters_frames_with_different_flags():
    """Pictures whose flags differ go one by one (and a batch of them is
    refused by pack_filter_params)."""
    import copy
    gold = _golden("LDP")
    off = copy.copy(gold[1].plan)
    off.sh = copy.copy(off.sh)
    off.sh.deblocking_filter_disabled = True
    plans = [gold[0].plan, off]
    pres = [gold[0].prefilter, gold[1].prefilter]
    with pytest.raises(ValueError):
        lf.pack_filter_params(plans)
    got = lf.loop_filters_frames(plans, pres, "cpu")
    _same(got, jlf.loop_filters_tpu_frames(
        plans, [[jnp.asarray(x) for x in pl] for pl in pres]))
    _same(got[0], gold[0].planes)


# -- intra prediction --------------------------------------------------------

PH, PW = 192, 256


@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_predict_batch_matches_both_jax_routes(size, c_idx):
    rng = np.random.default_rng(1000 + size * 2 + c_idx)
    n, s = 35, size
    nref2 = 2 * (2 * s + 1)
    plane = rng.integers(0, 256, (PH, PW)).astype(np.int32)
    # disjoint TUs, as the TUs of one wavefront step are
    cells = rng.choice((PH // s) * (PW // s), n, replace=False)
    pos = np.stack([cells // (PW // s) * s, cells % (PW // s) * s],
                   1).astype(np.int32)
    args = (pos, rng.integers(0, PH, (n, nref2)).astype(np.int32),
            rng.integers(0, PW, (n, nref2)).astype(np.int32),
            rng.integers(0, 2, (n, nref2)).astype(bool),
            rng.permutation(35).astype(np.int32))
    mode = args[4]
    ff = np.array([m not in (0, 1, 10, 26) and s != 4 and c_idx == 0
                   for m in mode])
    sa = np.full(n, s == 32 and c_idx == 0)
    res = rng.integers(-64, 64, (n, s, s)).astype(np.int32)
    kw = dict(dc_edge=rng.random(n) < 0.7,
              inter=rng.random(n) < 0.3,
              pred_plane=rng.integers(0, 256, (PH, PW)).astype(np.int32))
    full = args + (ff, sa, res)
    got = intra.predict_batch(
        torch.from_numpy(plane), *[torch.from_numpy(a) for a in full], s,
        c_idx, **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert not np.array_equal(got.numpy(), plane)
    for fn in (jax_predict_batch, predict_batch_mxu):
        want = fn(jnp.asarray(plane), *[jnp.asarray(a) for a in full], s,
                  c_idx, **{k: jnp.asarray(v) for k, v in kw.items()})
        assert np.array_equal(got.numpy(), np.asarray(want)), fn.__name__


# -- the decoder's options ---------------------------------------------------

OPTIONS = {
    "default": {},
    "unfused": dict(fused=False),
    "host_filters": dict(filters_on_device=False),
    "unfused_host_filters": dict(fused=False, filters_on_device=False),
    "no_filters": dict(apply_filters=False),
    "python_parse": dict(use_native_parse=False),
    "python_parse_unfused": dict(use_native_parse=False, fused=False),
}


@pytest.mark.parametrize("cls", [TorchDecoder, PipelinedTorchDecoder])
@pytest.mark.parametrize("opts", sorted(OPTIONS))
@pytest.mark.parametrize("name", ["I", "LDP"])
def test_decoder_options_match_golden(name, opts, cls):
    kw = OPTIONS[opts]
    gold = _golden(name)
    if not kw.get("apply_filters", True):
        gold = GoldenDecoder(apply_filters=False).decode_stream(_stream(name))
    dec = cls("cpu", **kw)
    assert dec.fused == (opts in ("default", "python_parse"))
    frames = dec.decode_stream(_stream(name))
    assert [f.poc for f in frames] == [g.poc for g in gold]
    native = [getattr(f.plan, "nstate", None) is not None for f in frames]
    assert all(native) == kw.get("use_native_parse", True)
    for f, g in zip(frames, gold):
        for c in range(3):
            assert f.planes[c].dtype == np.int32
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
            assert np.array_equal(f.prefilter[c].cpu().numpy(),
                                  g.prefilter[c]), (f.poc, c)
    if not dec.fused:
        assert "pack_s" not in dec.stats
    else:
        assert dec.stats["pack_s"] > 0 and dec.stats["dispatch_s"] > 0


def test_reference_only_options_are_refused():
    for kw in (dict(use_mxu=True), dict(shape_policy=None),
               dict(calibrate_frames=8)):
        with pytest.raises(TypeError):
            TorchDecoder("cpu", **kw)
