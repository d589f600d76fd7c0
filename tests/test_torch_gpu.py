"""CUDA kernels of the port against their plain torch versions, on the card.

These tests need a CUDA device (and nvcc to build csrc/*.cu); without one
each test skips.  Run them on a machine with a card (the conftest imports
JAX, which the port does not need):

    python -m pytest tests/test_torch_gpu.py -q --noconftest

The decision is taken inside the fixture, never at import, so that every
test process collects the same tests.
"""
import os

import numpy as np
import pytest
import torch

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.testgen.encoder import (Encoder, IntraEncoder,
                                      make_moving_sequence, make_test_image)
from p265_tpu_torch.golden.decoder import GoldenDecoder as PortGolden
from p265_tpu_torch.kernels import _build, itransform, mc, upload
from p265_tpu_torch.pipeline import wavefront as wf
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.plan.frame_plan import build_tensor_plan
from p265_tpu_torch.testgen.scan_cases import (random_scan, wide_scan,
                                               work_items)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_itransform_kernel_matches_plain(cuda, log2, scale):
    rng = np.random.default_rng(log2 + 10 * scale)
    s, n = 1 << log2, 300
    lv = ((rng.random((n, s, s)) < 0.3)
          * rng.integers(-300, 300, (n, s, s))).astype(np.int32)
    lv[:8] = rng.integers(-32768, 32768, (8, s, s))
    args = [torch.from_numpy(a).to(cuda) for a in (
        lv, np.arange(n, dtype=np.int32) % 52, rng.random(n) < 0.4,
        rng.random(n) < 0.3, rng.random(n) < 0.1)]
    sm = (torch.from_numpy(rng.integers(1, 256, (n, s, s)).astype(np.int32))
          .to(cuda) if scale else None)
    lvt, qp, dst, tsk, byp = args
    before = _build.LAUNCHES["itransform"]
    got = itransform.batch_residual(lvt, qp, dst, tsk, log2, bypass=byp,
                                    scale_m=sm)
    assert _build.LAUNCHES["itransform"] == before + 1
    want = itransform.batch_residual_ref(lvt, qp, dst, tsk, log2,
                                         bypass=byp, scale_m=sm)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("block,taps", [(16, 8), (8, 8), (4, 8), (8, 4),
                                        (4, 4), (2, 4)])
def test_mc_kernel_matches_plain(cuda, block, taps):
    rng = np.random.default_rng(block + taps)
    H, W, R, n = 120, 200, 3, 1000
    refs = torch.from_numpy(rng.integers(0, 256, (R, H, W)).astype(
        np.uint8)).to(cuda)
    unit = 4 if taps == 8 else 8
    pos = np.stack([rng.integers(0, H // block, n) * block,
                    rng.integers(0, W // block, n) * block], 1)
    args = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (
        pos, rng.integers(0, R, n),
        rng.integers(-250 * unit, 250 * unit, (n, 2)))]
    got = mc.mc_blocks(refs, *args, block, taps)
    want = mc.mc_blocks_ref(refs, *args, block, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _mc_group(rng, refs, block, taps, n, far):
    R, H, W = refs.shape
    unit = 4 if taps == 8 else 8
    pos = np.stack([rng.integers(0, H // block, n) * block,
                    rng.integers(0, W // block, n) * block], 1)
    mv = rng.integers(-far * unit, far * unit, (n, 2))
    return (refs, *[torch.from_numpy(a.astype(np.int32)).to(refs.device)
                    for a in (pos, rng.integers(0, R, n), mv)], block, taps)


@pytest.mark.parametrize("far", [3, 300])
def test_mc_grouped_kernel_matches_plain(cuda, far):
    """One launch for every geometry, both lists and an empty group, on
    planes whose width allows word loads (luma 200, chroma 100) and on
    planes that do not (a width of 98, and a stack that starts one byte
    into its storage); MVs of a few pixels keep most windows inside the
    picture, MVs to 300 px put most outside."""
    rng = np.random.default_rng(far)
    u8 = lambda *shape: torch.from_numpy(rng.integers(  # noqa: E731
        0, 256, shape).astype(np.uint8)).to(cuda)
    luma, chroma = u8(3, 120, 200), u8(3, 60, 100)
    odd = u8(2 * 60 * 98 + 1)[1:].view(2, 60, 98)
    groups = []
    for block, taps in mc.GEOMETRIES:
        for refs in ((luma,) if taps == 8 else (chroma, odd)):
            for lx in range(2):
                n = 0 if (block, lx) == (8, 1) else 700
                groups.append(_mc_group(rng, refs, block, taps, n, far))
    before = _build.LAUNCHES["mc"]
    got = mc.mc_blocks_grouped(groups)
    assert _build.LAUNCHES["mc"] == before + 1
    want = mc.mc_blocks_grouped_ref(groups)
    torch.cuda.synchronize()
    for g, w, grp in zip(got, want, groups):
        assert torch.equal(g, w), grp[4:]


def test_itransform_grouped_kernel_matches_plain(cuda):
    """All four sizes in one launch, int16 and int32 levels, with and
    without is_dst, bypass and scale_m."""
    rng = np.random.default_rng(99)
    groups = {}
    for log2, dt, opt in ((2, np.int16, True), (3, np.int32, False),
                          (4, np.int16, True), (5, np.int16, False)):
        s, n = 1 << log2, 200
        lv = ((rng.random((n, s, s)) < 0.3)
              * rng.integers(-300, 300, (n, s, s))).astype(dt)
        lv[:8] = rng.integers(-32768, 32768, (8, s, s))
        t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
        f = dict(coeffs=t(lv), qp=t(np.arange(n, dtype=np.int32) % 52),
                 tskip=t(rng.random(n) < 0.3))
        if opt:
            f.update(is_dst=t(rng.random(n) < 0.4),
                     bypass=t(rng.random(n) < 0.1),
                     scale_m=t(rng.integers(1, 256, (n, s, s)).astype(
                         np.int32)))
        groups[log2] = f
    before = _build.LAUNCHES["itransform"]
    got = itransform.batch_residual_grouped(groups)
    assert _build.LAUNCHES["itransform"] == before + 1
    want = itransform.batch_residual_grouped_ref(groups)
    torch.cuda.synchronize()
    for log2 in groups:
        assert torch.equal(got[log2], want[log2]), log2


def _gop(structure, seed, n=4, w=96, h=64, sps_kw=None, **pps_kw):
    sps = SPS(pic_width=w, pic_height=h, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5, **(sps_kw or {}))
    pps = PPS(init_qp=32, sign_data_hiding=True, **pps_kw)
    frames = make_moving_sequence(w, h, n, seed=seed)
    return Encoder(sps, pps, qp=32, seed=seed).encode_sequence(
        frames, structure=structure)[0]


def _intra(w, h, seed, sps_kw=None, pps_kw=None):
    sps = SPS(pic_width=w, pic_height=h, **(sps_kw or {}))
    pps = PPS(init_qp=30, sign_data_hiding=True, **(pps_kw or {}))
    return IntraEncoder(sps, pps, qp=30, seed=seed).encode_frame(
        make_test_image(w, h, seed))[0]


STREAMS = {
    "RA": lambda: _gop("RA", 50, n=5),
    "WP_RA": lambda: _gop("RA", 14, n=5, weighted_pred=True,
                          weighted_bipred=True),
    "tiles_wpp_LDP": lambda: _gop("LDP", 15, n=3, w=128, h=128,
                                  tiles_enabled=True, num_tile_columns=2,
                                  num_tile_rows=2,
                                  entropy_coding_sync_enabled=True),
    "I_104x56": lambda: _intra(104, 56, 21),
    # PCM CUs in the I picture and in every P picture (with inter PUs)
    "PCM_LDP": lambda: _gop("LDP", 43, n=5, sps_kw=dict(
        pcm_enabled=True, pcm_loop_filter_disabled=True)),
    "bypass": lambda: _intra(96, 64, 3,
                             pps_kw=dict(transquant_bypass_enabled=True)),
    "scaling_tskip": lambda: _intra(96, 64, 5,
                                    sps_kw=dict(scaling_list_enabled=True),
                                    pps_kw=dict(transform_skip_enabled=True)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_pipelined_decoder_on_cuda_matches_golden(cuda, name):
    data = STREAMS[name]()
    gold = GoldenDecoder().decode_stream(data)
    _build.reset_launch_counts()
    got = PipelinedTorchDecoder(cuda).decode_stream(data)
    assert _build.LAUNCHES["itransform"] > 0
    assert _build.LAUNCHES["mc"] > 0 or not any(g.plan.pus for g in gold)
    assert [f.poc for f in got] == [g.poc for g in gold]
    for f, g in zip(got, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
            assert np.array_equal(f.prefilter[c].cpu().numpy(),
                                  g.prefilter[c]), (f.poc, c)


def test_frame_dag_on_cuda_matches_golden(cuda):
    """frame_dag_max=4 on the card: sibling B pictures share one pass, K1
    and K2 run, every plane equals golden."""
    sps = SPS(pic_width=192, pic_height=128, temporal_mvp_enabled=True)
    pps = PPS(init_qp=32, sign_data_hiding=True)
    data = Encoder(sps, pps, qp=32, seed=11).encode_sequence(
        make_moving_sequence(192, 128, 8, seed=11), "RA")[0]
    gold = GoldenDecoder().decode_stream(data)
    _build.reset_launch_counts()
    dec = PipelinedTorchDecoder(cuda, frame_dag_max=4)
    got = dec.decode_stream(data)
    assert dec.stats.get("dag_batched", 0) >= 2
    assert _build.LAUNCHES["itransform"] > 0 and _build.LAUNCHES["mc"] > 0
    assert [f.poc for f in got] == [g.poc for g in gold]
    for f, g in zip(got, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
            assert np.array_equal(f.prefilter[c].cpu().numpy(),
                                  g.prefilter[c]), (f.poc, c)


def test_scan_kernel_matches_plain(cuda):
    """Every plane of every picture of the committed 96x64 LDP stream in
    one tall plane: the scan kernel, in one launch and in one launch a
    step (after_step), against scan_packed_ref on the same packed record;
    barrier_only leaves the plane as it was.  Then a random scan whose
    steps are wider than the kernel's warps and read what earlier steps
    wrote, against scan_packed_ref."""
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "p265_tpu_torch", "data",
            "s96x64_ldp5.265"), "rb") as f:
        gold = PortGolden().decode_stream(f.read())
    pps = [pp for g in gold for pp in build_tensor_plan(
        g.plan, {o.poc: o.planes for o in gold if o.poc != g.poc}).planes]
    merged = wf.merge_segments(pps)
    total_h, pw = merged.shape
    shape = (total_h + wf.GUARD, pw)
    pred = wf.attached_pred(pps, wf.segment_offsets(pps), shape, cuda)
    itu = upload(wf.hoist_inter(merged), cuda)
    fields, starts = wf.scan_fields(wf.stack_plane(merged))
    plane = wf.init_plane(itu, pred, shape, cuda)
    stacked = wf.expand(upload(fields, cuda), pw)
    n = merged.n_steps
    before = _build.LAUNCHES["scan"]
    got = wf.scan_plane(stacked, starts, n, plane.clone())
    assert _build.LAUNCHES["scan"] == before + 1
    steps = wf.scan_plane(stacked, starts, n, plane.clone(),
                          after_step=lambda p: None)
    assert _build.LAUNCHES["scan"] == before + 1 + n
    want = wf.scan_packed_ref(wf.pack_scan(stacked, starts, n, cuda),
                              plane.clone(), 0, n)
    idle = wf.scan_packed(wf.pack_scan(stacked, starts, n, cuda),
                          plane.clone(), 0, n, barrier_only=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(steps, want)
    assert torch.equal(idle, plane)
    for o, pp, c in zip(wf.segment_offsets(pps), pps,
                        [c for _ in gold for c in range(3)]):
        g = gold[pps.index(pp) // 3]
        assert np.array_equal(
            got[o:o + pp.shape[0], :pp.shape[1]].cpu().numpy(),
            g.prefilter[c])

    st, sd, n, plane = random_scan(np.random.default_rng(6), cuda,
                                   n_steps=4, per_size=560)
    packed = wf.pack_scan(st, sd, n, cuda)
    ctas, warps = wf.SCAN_SHAPE
    assert int(packed.step_tus.min()) > ctas * warps
    got = wf.scan_packed(packed, plane.clone(), 0, n)
    want = wf.scan_packed_ref(packed, plane.clone(), 0, n)
    torch.cuda.synchronize()
    assert not torch.equal(want, plane)
    assert torch.equal(got, want)


def test_scan_kernel_loops_over_steps_wider_than_its_cluster(cuda):
    """A scan at 4K plane width whose every step has 430 work items (40
    32x32 TUs of 8 items each among them) against the cluster's 256 warps,
    each step reading the tiles that earlier steps wrote: one launch, and
    a split run, equal to scan_packed_ref."""
    st, sd, n, plane = wide_scan(np.random.default_rng(11), cuda)
    packed = wf.pack_scan(st, sd, n, cuda)
    ctas, warps = wf.SCAN_SHAPE
    assert plane.shape[1] == 3840
    assert int(work_items(sd, n).min()) > ctas * warps
    before = _build.LAUNCHES["scan"]
    got = wf.scan_packed(packed, plane.clone(), 0, n)
    split = wf.scan_packed(packed, wf.scan_packed(packed, plane.clone(), 0,
                                                  2), 2, n)
    assert _build.LAUNCHES["scan"] == before + 3
    want = wf.scan_packed_ref(packed, plane.clone(), 0, n)
    torch.cuda.synchronize()
    assert not torch.equal(want, plane)
    assert torch.equal(got, want)
    assert torch.equal(split, want)
