"""CUDA kernels of the port against their plain torch versions, on the card.

These tests need a CUDA device (and nvcc to build csrc/*.cu); without one
each test skips.  Run them on a machine with a card (the conftest imports
JAX, which the port does not need):

    python -m pytest tests/test_torch_gpu.py -q --noconftest

The decision is taken inside the fixture, never at import, so that every
test process collects the same tests.
"""
import functools
import os
import socket
import sys

import numpy as np
import pytest
import torch

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.testgen.encoder import (Encoder, IntraEncoder,
                                      make_moving_sequence, make_test_image)
from p265_tpu_torch.golden.decoder import GoldenDecoder as PortGolden
from p265_tpu_torch.kernels import _build, itransform, mc
from p265_tpu_torch.kernels import loopfilter as lf
from p265_tpu_torch.kernels.staging import stage
from p265_tpu_torch.pipeline import wavefront as wf
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.plan.frame_plan import build_tensor_plan
from p265_tpu_torch.shard.filters import sao_rows
from p265_tpu_torch.testgen import conformance
from p265_tpu_torch.testgen import filter_cases as fc
from p265_tpu_torch.testgen import kernel_cases as kc
from p265_tpu_torch.testgen.scan_cases import (coord_plane, random_scan,
                                               wide_scan, work_items)


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
        lv, (np.arange(n) % 52).astype(np.uint8), rng.random(n) < 0.4,
        rng.random(n) < 0.3, rng.random(n) < 0.1)]
    sm = (torch.from_numpy(rng.integers(1, 256, (n, s, s)).astype(np.uint8))
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
        f = dict(coeffs=t(lv), qp=t((np.arange(n) % 52).astype(np.uint8)),
                 tskip=t(rng.random(n) < 0.3))
        if opt:
            f.update(is_dst=t(rng.random(n) < 0.4),
                     bypass=t(rng.random(n) < 0.1),
                     scale_m=t(rng.integers(1, 256, (n, s, s)).astype(
                         np.uint8)))
        groups[log2] = f
    before = _build.LAUNCHES["itransform"]
    got = itransform.batch_residual_grouped(groups)
    assert _build.LAUNCHES["itransform"] == before + 1
    want = itransform.batch_residual_grouped_ref(groups)
    torch.cuda.synchronize()
    for log2 in groups:
        assert torch.equal(got[log2], want[log2]), log2


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("scale", [False, True])
def test_itransform_kernel_partial_tiles_match_plain(cuda, dtype, scale):
    """Every size in one launch with DST, transform skip, bypass, qp 0..51
    (the dequant's left-shift branch included), saturating levels and
    scale_m, at TU counts that leave a partial last tile
    (testgen/kernel_cases.py residual_groups), and once more with
    levels and scale_m that start off the 16-byte grid."""
    rng = np.random.default_rng(int(scale) + 2 * (dtype == np.int32))
    for n in (150, 9):
        groups = stage(kc.residual_groups(rng, n, scale, dtype), cuda)
        before = _build.LAUNCHES["itransform"]
        got = itransform.batch_residual_grouped(groups)
        assert _build.LAUNCHES["itransform"] == before + 1
        want = itransform.batch_residual_grouped_ref(groups)
        torch.cuda.synchronize()
        for log2 in groups:
            assert torch.equal(got[log2], want[log2]), (n, log2)
    f = groups[3]
    for k in ("coeffs", "scale_m"):
        if k in f:
            t = f[k]
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
            f[k] = flat[1:].view(t.shape).copy_(t)
    got = itransform.batch_residual_grouped({3: f})[3]
    assert torch.equal(got, itransform.batch_residual_grouped_ref({3: f})[3])


@pytest.mark.parametrize("kind", ["uni", "bi", "weighted_uni", "weighted_bi"])
def test_mc_pred_planes_kernel_matches_plain(cuda, kind):
    """The MC kernel with its samples epilogue (interpolation, combine and
    placement in one launch) against mc_pred_planes_ref on 1080p pictures
    (testgen/kernel_cases.py pred_case: every bucket, pad rows, MVs to
    300 px past the picture; uni, bi, explicit weights with log2_wd 0..7
    and negative weights and offsets): into fresh planes, and two frames
    into their segments of one tall plane laid out as batch_decode does,
    whose other samples hold an earlier prediction that must stay."""
    from p265_tpu_torch.pipeline.batch_decode import segment_rows
    rng = np.random.default_rng(len(kind))
    has_bi, weighted = kind.endswith("bi"), kind.startswith("weighted")
    frames = []
    for _ in range(2):
        stacks, arrays, shapes = kc.pred_case(rng, 1080, 1920, has_bi,
                                              weighted)
        frames.append((stage(stacks, cuda), stage(arrays, cuda), shapes))
    stacks, arrays, shapes = frames[0]
    before = _build.LAUNCHES["mc"]
    got = mc.mc_pred_planes(stacks, arrays, shapes, has_bi)
    assert _build.LAUNCHES["mc"] == before + 1
    want = mc.mc_pred_planes_ref(stacks, arrays, shapes, has_bi)
    torch.cuda.synchronize()
    for c in range(3):
        assert torch.equal(got[c], want[c]), c
    seg_h, seg_hc = 1080 + wf.GUARD, 540 + wf.GUARD
    tall = torch.from_numpy(rng.integers(-5, 300, (
        2 * seg_h + 4 * seg_hc, 1920)).astype(np.int32)).to(cuda)
    a, b = tall.clone(), tall.clone()
    for f, (stacks, arrays, shapes) in enumerate(frames):
        rows = segment_rows(2, f, seg_h, seg_hc)
        mc.mc_pred_planes(stacks, arrays, shapes, has_bi, out=(a, rows))
        mc.mc_pred_planes_ref(stacks, arrays, shapes, has_bi, out=(b, rows))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert not torch.equal(a, tall)


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
    # one MC launch a picture with inter PUs (a dispatch a picture)
    assert _build.LAUNCHES["mc"] == sum(1 for g in gold if g.plan.pus)
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
    itu = stage(wf.hoist_inter(merged), cuda)
    fields, starts = wf.scan_fields(wf.stack_plane(merged))
    plane = wf.init_plane(itu, pred, shape, cuda)
    stacked = wf.expand(stage(fields, cuda))
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


LAYOUTS = ["contiguous", "transposed", "rows of a taller plane"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("seed", [0, 1])
def test_deblock_kernels_match_plain(cuda, seed, plane, layout):
    """One launch a call, torch.equal to the plain version, the input
    unchanged, the output in the input's layout where it is dense; then
    the same at 1080p widths (B = 2) in both directions."""
    chroma = plane == "chroma"
    fn = lf.deblock_chroma_vertical if chroma else lf.deblock_luma_vertical
    ref = (lf.deblock_chroma_vertical_ref if chroma
           else lf.deblock_luma_vertical_ref)
    keys = ("tc",) if chroma else ("bs", "beta", "tc")
    rng = np.random.default_rng(seed)
    full = (2, 540, 960) if chroma else (2, 1080, 1920)
    for shape in (fc.SHAPES[plane], full, full[:1] + full[:0:-1]):
        c = fc.deblock_case(rng, *shape, chroma=chroma)
        planes = fc.layouts(c["planes"], cuda)[layout]
        args = [torch.from_numpy(c[k]).to(cuda) for k in keys]
        before = _build.LAUNCHES["deblock"]
        got = fn(planes, *args)
        assert _build.LAUNCHES["deblock"] == before + 1
        want = ref(planes, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape
        assert not torch.equal(got, planes)
        assert np.array_equal(planes.cpu().numpy(), c["planes"])
        if layout != "rows of a taller plane":
            assert got.stride() == planes.stride()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 72, 136), (1, 40, 8), (1, 8, 40),
                                   (2, 1080, 1920), (1, 2160, 3840)])
def test_deblock_planes_kernel_matches_plain(cuda, shape, layout):
    """Both directions of a batch's luma [F,H,W] and chroma [2F,H/2,W/2]
    in ONE launch, torch.equal to deblock_planes_ref on the same tensors,
    the inputs unchanged: small planes with partial tiles, planes with no
    edge in one direction, 1080p (chroma 540 rows) and 4K."""
    c = fc.deblock_planes_case(np.random.default_rng(shape[1]), *shape)
    luma, chroma = (fc.layouts(c[k], cuda)[layout]
                    for k in ("luma", "chroma"))
    fp = {k: torch.from_numpy(v).to(cuda) for k, v in c.items()
          if k not in ("luma", "chroma")}
    before = _build.LAUNCHES["deblock"]
    got = lf.deblock_planes(luma, chroma, fp)
    assert _build.LAUNCHES["deblock"] == before + 1
    want = lf.deblock_planes_ref(luma, chroma, fp)
    torch.cuda.synchronize()
    for g, w, k in zip(got, want, ("luma", "chroma")):
        assert torch.equal(g, w), k
        assert not torch.equal(w, fc.layouts(c[k], cuda)[layout]), k
    assert np.array_equal(luma.cpu().numpy(), c["luma"])
    assert np.array_equal(chroma.cpu().numpy(), c["chroma"])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("ctb", [64, 32, 16])
def test_sao_kernel_matches_plain(cuda, ctb, plane, layout):
    """Every type and class, CTB 64/32/16 (chroma ctb >> 1), heights no
    multiple of the CTB; then 1080p widths."""
    rng = np.random.default_rng(ctb)
    size = ctb if plane == "luma" else ctb >> 1
    full = (2, 1080, 1920) if plane == "luma" else (4, 540, 960)
    for shape in (fc.SHAPES[plane], full):
        c = fc.sao_case(rng, *shape, size)
        src = fc.layouts(c["src"], cuda)[layout]
        maps = [torch.from_numpy(c[k]).to(cuda) for k in ("ty", "cls",
                                                          "offs")]
        before = _build.LAUNCHES["sao"]
        got = lf.sao_apply(src, *maps, size)
        assert _build.LAUNCHES["sao"] == before + 1
        want = lf.sao_apply_ref(src, *maps, size)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape
        assert not torch.equal(got, src)


@pytest.mark.parametrize("ctb", [64, 16])
def test_sao_rows_kernel_matches_plain(cuda, ctb):
    """The row-sharded SAO's blocks with their halo rows (the last block
    past the picture) through the kernel, equal to the plain _sao_local
    on the same block, and to the rows of the unsharded SAO."""
    c = fc.sao_case(np.random.default_rng(ctb), 1, 1080, 1920, ctb)
    maps = [torch.from_numpy(c[k][0]) for k in ("ty", "cls", "offs")]
    whole = lf.sao_apply_ref(torch.from_numpy(c["src"]),
                             *(m[None] for m in maps), ctb)[0]
    # 4 blocks of 272 rows, the last 8 past the picture
    for r0, *blk in fc.row_blocks(torch.from_numpy(c["src"][0]), 4, 272):
        want = sao_rows(*blk, *maps, ctb, r0, 1080)
        before = _build.LAUNCHES["sao"]
        got = sao_rows(*(t.to(cuda) for t in blk),
                       *(m.to(cuda) for m in maps), ctb, r0, 1080)
        assert _build.LAUNCHES["sao"] == before + 1
        assert torch.equal(got.cpu(), want), r0
        n = min(272, 1080 - r0)
        assert torch.equal(want[:n], whole[r0:r0 + n]), r0


@pytest.mark.parametrize("name", sorted(conformance.STREAMS))
def test_conformance_streams_on_cuda_match_golden(cuda, name):
    """The stream kinds of tests/test_torch_conformance.py (several
    slices, dependent slices, slices with tiles and with WPP, cu_qp_delta,
    long-term references, CRA/RASL/BLA) on the card, every plane before
    and after the filters equal to golden's; the filter kernels launched
    wherever the stream's flags turn the filters on."""
    make, holds = conformance.STREAMS[name]
    data = make()
    gold = GoldenDecoder().decode_stream(data)
    assert holds(gold), "the stream does not hold the case"
    _build.reset_launch_counts()
    got = PipelinedTorchDecoder(cuda).decode_stream(data)
    launches = dict(_build.LAUNCHES)
    assert launches["itransform"] > 0 and launches["scan"] > 0, launches
    plans = [g.plan for g in gold]
    assert (launches["deblock"] > 0) == any(
        not p.sh.deblocking_filter_disabled for p in plans), launches
    assert (launches["sao"] > 0) == any(
        p.sps.sao_enabled and (p.sh.sao_luma or p.sh.sao_chroma)
        for p in plans), launches
    assert [f.poc for f in got] == [g.poc for g in gold]
    for f, g in zip(got, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
            assert np.array_equal(f.prefilter[c].cpu().numpy(),
                                  g.prefilter[c]), (f.poc, c)


def test_staged_dispatches_with_a_two_slot_ring(cuda, monkeypatch):
    """s1080_ldp16 (16 frames) through PipelinedTorchDecoder with the
    staging ring at its least depth, two slots, so the worker refills a
    slot right behind the copy that read it: every plane bit-exact vs the
    port's golden; every staged leaf starts on 16 bytes; K1 copies no
    operand to align it (_aligned); one h2d copy a dispatch."""
    from p265_tpu_torch.kernels import staging
    from p265_tpu_torch.pipeline import batch_decode as bd
    from p265_tpu_torch.run_config import Dispatches
    from p265_tpu_torch.testgen.streams import get_stream
    data = get_stream("s1080_ldp16")
    odd, clones = [], []
    stage, aligned = bd.stage, itransform._aligned

    def spy_stage(tree, device, stats=None):
        out = stage(tree, device, stats)
        odd.extend(t.data_ptr() % 16 for t in staging.leaves(out)
                   if t.data_ptr() % 16)
        return out

    def spy_aligned(t):
        if t is not None and t.data_ptr() % 16:
            clones.append(tuple(t.shape))
        return aligned(t)

    monkeypatch.setattr(bd, "stage", spy_stage)
    monkeypatch.setattr(itransform, "_aligned", spy_aligned)
    staging.ring(cuda, slots=2)
    try:
        with Dispatches() as dispatches:
            dec = PipelinedTorchDecoder(cuda)
            got = dec.decode_stream(data)
    finally:
        staging.ring(cuda, slots=staging.RING_SLOTS)
    gold = PortGolden().decode_stream(data)
    assert [f.poc for f in got] == [g.poc for g in gold] and len(got) == 16
    for f, g in zip(got, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
            assert np.array_equal(f.prefilter[c].cpu().numpy(),
                                  g.prefilter[c]), (f.poc, c)
    assert not odd and not clones
    assert dec.stats["h2d_copies"] == len(dispatches) == 16


@pytest.mark.parametrize("shape", [(256, 1920), (128, 40_000),
                                   (128, 70_000)])
@pytest.mark.parametrize("pred", ["prediction", "zeros"])
def test_itransform_plane_epilogue_matches_plain(cuda, pred, shape):
    """K1's plane epilogue (the hoisted inter TUs): every size in one
    launch, at the wire dtypes, each TU alone in a 32x32 tile of the plane
    (positions uint16 past 32767 at 40000 columns, int32 at 70000), added
    in place to a random prediction plane or to zeros and clipped;
    torch.equal to the plain version, the samples outside the TUs as they
    were."""
    rng = np.random.default_rng(shape[1] + len(pred))
    for scale in (False, True):
        groups = stage(kc.residual_groups(rng, 100, scale, plane=shape),
                       cuda)
        base = (rng.integers(0, 256, shape) if pred == "prediction"
                else np.zeros(shape)).astype(np.int32)
        plane = torch.from_numpy(base).to(cuda)
        before = _build.LAUNCHES["itransform"]
        got = itransform.batch_residual_grouped(groups, plane=plane.clone())
        assert _build.LAUNCHES["itransform"] == before + 1
        want = itransform.batch_residual_grouped_ref(groups,
                                                     plane=plane.clone())
        torch.cuda.synchronize()
        assert torch.equal(got, want), scale
        assert not torch.equal(got, plane)


@pytest.mark.parametrize("with_pred", [True, False])
def test_init_plane_kernel_matches_plain(cuda, with_pred):
    """init_plane on the card (one K1 launch with the plane epilogue) over
    the prediction plane of the committed 96x64 LDP stream's P pictures,
    or over none, against init_plane_ref on the same staged fields."""
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "p265_tpu_torch", "data",
            "s96x64_ldp5.265"), "rb") as f:
        gold = PortGolden().decode_stream(f.read())
    seen = 0
    for g in gold:
        pps = build_tensor_plan(g.plan, {o.poc: o.planes for o in gold
                                         if o.poc != g.poc}).planes
        merged = wf.merge_segments(pps)
        shape = (merged.shape[0] + wf.GUARD, merged.shape[1])
        pred = (wf.attached_pred(pps, wf.segment_offsets(pps), shape, cuda)
                if with_pred else None)
        itu = wf.hoist_inter(merged)
        if itu is None:
            continue
        seen += 1
        dev = stage(itu, cuda)
        want = wf.init_plane_ref(dev, None if pred is None else pred.clone(),
                                 shape, cuda)
        before = _build.LAUNCHES["itransform"]
        got = wf.init_plane(dev, pred, shape, cuda)
        assert _build.LAUNCHES["itransform"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), g.poc
    assert seen >= 2


@pytest.mark.parametrize("cols", [40_000, 70_000])
def test_scan_kernel_wire_coordinates_match_plain(cuda, cols):
    """The whole scan path of a 64-row plane 40000 columns wide (uint16
    coordinates past 32767) and of one 70000 wide (int32),
    testgen/scan_cases.py coord_plane with every TU alone in its tile and
    a prediction under the inter TUs: reconstruct_scan_plane on the card
    (K1's epilogue, K1, one scan launch) equals it on the CPU; then random
    scans at int32 coordinates against the plain version."""
    rng = np.random.default_rng(cols + 1)
    pp = coord_plane(rng, (64, cols), exclusive=True, inter_pred=True)
    before = dict(_build.LAUNCHES)
    got = wf.reconstruct_scan_plane(pp, cuda)
    assert _build.LAUNCHES["scan"] == before["scan"] + 1
    assert _build.LAUNCHES["itransform"] == before["itransform"] + 2
    want = wf.reconstruct_scan_plane(pp, "cpu")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for kw in ({}, dict(n_steps=4, per_size=560)):
        st, sd, n, plane = random_scan(rng, cuda, coord=np.int32, **kw)
        packed = wf.pack_scan(st, sd, n, cuda)
        assert packed.coord_wide
        got = wf.scan_packed(packed, plane.clone(), 0, n)
        want = wf.scan_packed_ref(packed, plane.clone(), 0, n)
        torch.cuda.synchronize()
        assert not torch.equal(want, plane)
        assert torch.equal(got, want)


def test_kernels_refuse_widened_fields(cuda):
    """No kernel wrapper casts: K1 refuses int32 qp, the scan int64
    coordinates, the deblocking int32 grids, SAO int32 maps."""
    rng = np.random.default_rng(1)
    groups = stage(kc.residual_groups(rng, 9, True), cuda)
    groups[3] = dict(groups[3], qp=groups[3]["qp"].to(torch.int32))
    with pytest.raises(ValueError, match="qp must be"):
        itransform.batch_residual_grouped(groups)
    st, sd, n, _ = random_scan(rng, cuda, n_steps=4, per_size=8)
    st[2] = dict(st[2], pos=st[2]["pos"].to(torch.int64))
    with pytest.raises(ValueError, match="pack_scan"):
        wf.pack_scan(st, sd, n, cuda)
    c = fc.deblock_case(rng, *fc.SHAPES["chroma"], chroma=True)
    with pytest.raises(ValueError, match="int16"):
        lf.deblock_chroma_vertical(torch.from_numpy(c["planes"]).to(cuda),
                                   torch.from_numpy(c["tc"]).to(cuda).to(
                                       torch.int32))
    c = fc.sao_case(rng, *fc.SHAPES["luma"], 16)
    maps = [torch.from_numpy(c[k]).to(cuda).to(torch.int32)
            for k in ("ty", "cls", "offs")]
    with pytest.raises(ValueError, match="int8"):
        lf.sao_apply(torch.from_numpy(c["src"]).to(cuda), *maps, 16)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_sao_uint8_epilogue_matches_plain(cuda, plane, masks, layout):
    """SAO's store as the batch path calls it: uint8 out, and with bypass
    masks the prefilter sample (a strided plane) where a mask is set, at
    1080p widths; torch.equal to sao_apply_ref with the same keep and
    dtype, and to the int32 kernel output restored and cast."""
    rng = np.random.default_rng(len(layout) + masks)
    shape, size = (((2, 1080, 1920), 64) if plane == "luma"
                   else ((4, 540, 960), 32))
    c = fc.sao_case(rng, *shape, size)
    src = fc.layouts(c["src"], cuda)[layout]
    pre = fc.layouts(fc.planes(rng, *shape), cuda)[layout]
    maps = [torch.from_numpy(c[k]).to(cuda) for k in ("ty", "cls", "offs")]
    keep = None
    if masks:
        keep = (pre, torch.from_numpy(fc.bypass_masks(rng, *shape)).to(cuda))
    before = _build.LAUNCHES["sao"]
    got = lf.sao_apply(src, *maps, size, keep, torch.uint8)
    assert _build.LAUNCHES["sao"] == before + 1
    want = lf.sao_apply_ref(src, *maps, size, keep, torch.uint8)
    wide = lf.sao_apply(src, *maps, size)
    if keep is not None:
        wide = torch.where(keep[1], keep[0], wide)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(got, wide.to(torch.uint8))


@functools.lru_cache(maxsize=None)
def _stream_and_golden(name: str):
    from p265_tpu_torch.testgen.streams import get_stream
    data = get_stream(name)
    return data, PortGolden().decode_stream(data)


def _bit_exact(got, gold):
    assert [f.poc for f in got] == [g.poc for g in gold]
    for f, g in zip(got, gold):
        for c in range(3):
            assert np.array_equal(np.asarray(f.planes[c]), g.planes[c]), (
                f.poc, c)
            pre = f.prefilter[c]
            pre = pre.cpu().numpy() if isinstance(pre, torch.Tensor) else pre
            assert np.array_equal(pre, g.prefilter[c]), (f.poc, c)


def _wire_spies(monkeypatch) -> dict:
    """Record, for CUDA tensors only: every staging.widen call (patched
    in every module of the port that bound it), every .to() from a narrow
    integer dtype to int32 or int64, every .to() from int32 to uint8, and
    every init_plane_ref call."""
    from p265_tpu_torch.kernels import staging
    seen = {"widen": [], "widening_to": [], "to_u8": [], "init_plane_ref": []}
    widen, to, ref = staging.widen, torch.Tensor.to, wf.init_plane_ref
    narrow = (torch.uint8, torch.int8, torch.int16, torch.uint16, torch.bool)

    def widen_spy(t, dtype):
        if t.is_cuda:
            seen["widen"].append((tuple(t.shape), t.dtype))
        return widen(t, dtype)

    def to_spy(self, *a, **k):
        out = to(self, *a, **k)
        if self.is_cuda and out.dtype != self.dtype:
            if self.dtype in narrow and out.dtype in (torch.int32,
                                                      torch.int64):
                seen["widening_to"].append((tuple(self.shape), self.dtype,
                                            out.dtype))
            elif self.dtype == torch.int32 and out.dtype == torch.uint8:
                seen["to_u8"].append(tuple(self.shape))
        return out

    def ref_spy(itu, pred, shape, device):
        if torch.device(device).type == "cuda":
            seen["init_plane_ref"].append(shape)
        return ref(itu, pred, shape, device)

    for name, mod in list(sys.modules.items()):
        if name.startswith("p265_tpu_torch") and getattr(
                mod, "widen", None) is widen:
            monkeypatch.setattr(mod, "widen", widen_spy)
    monkeypatch.setattr(torch.Tensor, "to", to_spy)
    monkeypatch.setattr(wf, "init_plane_ref", ref_spy)
    return seen


def test_main_paths_read_the_wire_dtypes(cuda, monkeypatch):
    """s1080_ldp4 through PipelinedTorchDecoder, and s96x64_ldp5 on the
    space axis (one gloo rank): bit-exact against golden, and no CUDA
    tensor goes through staging.widen, a widening .to() or
    init_plane_ref; on the decoder's path the only int32 -> uint8 casts
    are the prefilter planes' two a dispatch (SAO's launches write the
    filtered planes as uint8)."""
    import torch.distributed as dist
    from p265_tpu_torch.shard.spatial import SpatialDecoder
    data, gold = _stream_and_golden("s1080_ldp4")
    small, small_gold = _stream_and_golden("s96x64_ldp5")
    seen = _wire_spies(monkeypatch)
    _build.reset_launch_counts()
    dec = PipelinedTorchDecoder(cuda)
    _bit_exact(dec.decode_stream(data), gold)
    assert _build.LAUNCHES["sao"] == 8, dict(_build.LAUNCHES)
    assert len(seen["to_u8"]) == 2 * len(gold), seen["to_u8"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        _bit_exact(SpatialDecoder(dist.group.WORLD, cuda).decode_stream(
            small), small_gold)
    finally:
        dist.destroy_process_group()
    assert not seen["widen"], seen["widen"][:10]
    assert not seen["widening_to"], seen["widening_to"][:10]
    assert not seen["init_plane_ref"], seen["init_plane_ref"]


@pytest.mark.parametrize("dag", [1, 4])
def test_config5_stream_on_cuda_matches_golden_md5(cuda, dag):
    """A BASELINE configuration 5 stream (s4k_ra5_s5: 3840x2160, IDR, P,
    three B) through PipelinedTorchDecoder on the card, every plane of
    every picture against data/GOLDEN_MD5; at frame_dag_max 4 the B
    pictures at POC 1 and 3, which read only pictures decoded before
    them, form one group."""
    from p265_tpu_torch.run_config import Dispatches
    from p265_tpu_torch.testgen.streams import (check_md5, get_stream,
                                                golden_md5_of)
    name = "s4k_ra5_s5"
    _build.reset_launch_counts()
    with Dispatches() as seen:
        frames = PipelinedTorchDecoder(
            "cuda", frame_dag_max=dag).decode_stream(get_stream(name))
    check_md5(frames, golden_md5_of(name), f"{name} frame_dag_max={dag}")
    assert [pocs for pocs, _ in seen] == (
        [[0], [4], [2], [1], [3]] if dag == 1 else [[0], [4], [2], [1, 3]])
    assert all(v > 0 for v in _build.LAUNCHES.values())


def test_config5_stream_axis_on_the_card(cuda):
    """The stream axis on two configuration-5 streams over 2 ranks (gloo
    sharing the card, or NCCL with two cards), each picture checked
    against data/GOLDEN_MD5 inside its rank; every kernel launched on
    both ranks."""
    from p265_tpu_torch.profile_shard import (config5_streams, run_ranks,
                                              stream_axis)
    _build.library()
    two = config5_streams()[:2]
    _, res = run_ranks([(stream_axis, ([d for _, d, _ in two],
                                       [m for _, _, m in two]))], 2)
    assert sorted(si for (r,) in res for si, _, _ in r["segments"]) == [0, 1]
    for (r,) in res:
        assert all(v > 0 for v in r["launches"].values())
