"""Port's motion compensation vs the JAX reference, bit-exact.

Interpolation (mc_blocks_ref, and the CPU paths of mc_blocks and of the
grouped mc_blocks_grouped) against p265_tpu.kernels.mc._mc_blocks on its
per-element clamped gather, the uni/bi/weighted combination against
_combine, the prediction planes (with pad rows) against mc_pred_plane, and
the NumPy copies of the host packing against the originals on a weighted
RA plan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p265_tpu.kernels.mc as jmc
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.tables import CHROMA_FILTER, LUMA_FILTER
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence
from p265_tpu_torch.kernels import mc

GEOMETRIES = ((16, 8), (8, 8), (4, 8), (8, 4), (4, 4), (2, 4))


@pytest.mark.parametrize("block,taps", GEOMETRIES)
def test_mc_blocks_matches_jax_far_mvs(block, taps):
    """MVs reach up to 200 px past every edge: the spec's edge clamp."""
    rng = np.random.default_rng(block * 10 + taps)
    H, W, R, n = 64, 96, 3, 48
    refs = rng.integers(0, 256, (R, H, W)).astype(np.uint8)
    pos = np.stack([rng.integers(0, H // block, n) * block,
                    rng.integers(0, W // block, n) * block], 1)
    unit = 4 if taps == 8 else 8
    mv = rng.integers(-200 * unit, 200 * unit, (n, 2))
    ridx = rng.integers(0, R, n)
    pos, mv, ridx = (a.astype(np.int32) for a in (pos, mv, ridx))
    filt = np.asarray(LUMA_FILTER if taps == 8 else CHROMA_FILTER, np.int32)
    fmask = 3 if taps == 8 else 7
    ff = np.stack([filt[mv[:, 0] & fmask], filt[mv[:, 1] & fmask]], 1)
    want = np.asarray(jmc._mc_blocks(
        jnp.asarray(refs.astype(np.int32)), jnp.asarray(pos),
        jnp.asarray(ridx), jnp.asarray(mv), jnp.asarray(ff), block, taps, R))
    args = [torch.from_numpy(a) for a in (refs, pos, ridx, mv)]
    got = mc.mc_blocks_ref(*args, block, taps)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(mc.mc_blocks(*args, block, taps), got)


@pytest.mark.parametrize("kind", ["uni", "bi", "wp_uni", "wp_bi"])
def test_combine_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    n, b = 40, 4
    p0 = rng.integers(-2000, 18000, (n, b, b)).astype(np.int32)
    p1 = (rng.integers(-2000, 18000, (n, b, b)).astype(np.int32)
          if kind.endswith("bi") else None)
    has1 = rng.random(n) < 0.6
    wp = None
    if kind.startswith("wp"):
        log2_wd = rng.integers(0, 8, n)
        wp = tuple(a.astype(np.int32) for a in (
            rng.integers(-128, 128, n), rng.integers(-128, 128, n),
            rng.integers(-128, 128, n), rng.integers(-128, 128, n),
            log2_wd))
    want = np.asarray(jmc._combine(
        jnp.asarray(p0), None if p1 is None else jnp.asarray(p1),
        jnp.asarray(has1),
        None if wp is None else tuple(jnp.asarray(a) for a in wp)))
    got = mc.combine(
        torch.from_numpy(p0), None if p1 is None else torch.from_numpy(p1),
        torch.from_numpy(has1),
        None if wp is None else tuple(torch.from_numpy(a) for a in wp))
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def ra_wp():
    """Golden decode of a weighted-prediction RA stream with bi PUs."""
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5)
    pps = PPS(init_qp=32, sign_data_hiding=True, weighted_pred=True,
              weighted_bipred=True)
    frames = make_moving_sequence(96, 64, 5, seed=40)
    stream, _ = Encoder(sps, pps, qp=32, seed=40).encode_sequence(
        frames, structure="RA")
    gold = GoldenDecoder().decode_stream(stream)
    inter = [g for g in gold if g.plan.pus]
    assert any(p.motion.uses(0) and p.motion.uses(1)
               for g in inter for p in g.plan.pus)
    return gold, inter


def _poc_index(plan):
    pocs = sorted({p.motion.ref_poc[lx] for p in plan.pus
                   for lx in range(2) if p.motion.uses(lx)})
    return {p: i for i, p in enumerate(pocs)}


def test_host_packing_matches_jax(ra_wp):
    _, inter = ra_wp
    for g in inter:
        plan = g.plan
        cnt = mc.mc_block_counts(plan)
        assert cnt == jmc.mc_block_counts(plan)
        for x, y, w, h in ((0, 0, 24, 40), (8, 4, 12, 12), (16, 0, 64, 8)):
            for sizes in (mc.LUMA_BUCKETS, mc.CHROMA_BUCKETS):
                assert (mc.tile_pu(x, y, w, h, sizes)
                        == jmc._tile_pu(x, y, w, h, sizes))
        pad = {k: v + 3 for k, v in cnt.items()}   # with pad rows
        for rows in (cnt, pad):
            got = mc.mc_arrays_padded(plan, _poc_index(plan), rows)
            want = jmc.mc_arrays_padded(plan, _poc_index(plan), rows)
            assert got.keys() == want.keys()
            for grp in want:
                assert got[grp].keys() == want[grp].keys()
                for b in want[grp]:
                    for f, a in want[grp][b].items():
                        assert got[grp][b][f].dtype == a.dtype, (grp, b, f)
                        assert np.array_equal(got[grp][b][f], a), (grp, b, f)


def test_mc_pred_plane_matches_jax_with_pad_rows(ra_wp):
    gold, inter = ra_wp
    by_poc = {g.poc: g.planes for g in gold}
    jax_plane = jax.jit(jmc.mc_pred_plane,
                        static_argnames=("shape", "taps", "has_bi", "wp_key"))
    # the B picture with the most bi-predicted PUs, all three planes from
    # one mc_pred_planes call
    g = max(inter, key=lambda g: sum(p.motion.uses(0) and p.motion.uses(1)
                                     for p in g.plan.pus))
    plan = g.plan
    pidx = _poc_index(plan)
    pocs = sorted(pidx)
    cnt = mc.mc_block_counts(plan)
    arrs = mc.mc_arrays_padded(plan, pidx, {k: v + 5 for k, v in
                                            cnt.items()})
    has_bi = any(p.motion.uses(0) and p.motion.uses(1)
                 for p in plan.pus)
    H, W = plan.sps.pic_height, plan.sps.pic_width
    shapes = ((H, W), (H >> 1, W >> 1), (H >> 1, W >> 1))
    stacks = [np.stack([by_poc[p][c] for p in pocs]).astype(np.uint8)
              for c in range(3)]
    got = mc.mc_pred_planes(
        [torch.from_numpy(s) for s in stacks],
        {grp: {b: {f: torch.from_numpy(a) for f, a in d.items()}
               for b, d in arrs[grp].items()} for grp in arrs},
        shapes, has_bi)
    for c, grp, taps in ((0, "y", 8), (1, "c", 4), (2, "c", 4)):
        want = np.asarray(jax_plane(
            jnp.asarray(stacks[c]),
            {b: {f: jnp.asarray(a) for f, a in d.items()}
             for b, d in arrs[grp].items()}, shape=shapes[c], taps=taps,
            has_bi=has_bi, wp_key=f"wp_{c}"))
        assert np.array_equal(got[c].numpy(), want), (g.poc, c)


def _group_inputs(rng, block, taps, n, refs, far=200):
    R, H, W = refs.shape
    pos = np.stack([rng.integers(0, H // block, n) * block,
                    rng.integers(0, W // block, n) * block], 1)
    unit = 4 if taps == 8 else 8
    mv = rng.integers(-far * unit, far * unit, (n, 2))
    ridx = rng.integers(0, R, n)
    return [torch.from_numpy(a.astype(np.int32)) for a in (pos, ridx, mv)]


def test_mc_blocks_grouped_equals_per_call_plain():
    """Mixed geometries on two reference stacks (luma- and chroma-sized),
    an empty group and second-list groups, as one mc_pred_planes call packs
    them: the grouped plain path equals one mc_blocks_ref call per group,
    and JAX's _mc_blocks."""
    rng = np.random.default_rng(7)
    luma = torch.from_numpy(rng.integers(0, 256, (2, 64, 96)).astype(
        np.uint8))
    chroma = torch.from_numpy(rng.integers(0, 256, (2, 32, 48)).astype(
        np.uint8))
    groups = []
    for block, taps in GEOMETRIES:
        refs = luma if taps == 8 else chroma
        for lx in range(2):   # list 0 and the bi-pred second list
            n = 0 if (block, lx) == (4, 1) else int(rng.integers(1, 40))
            groups.append((refs, *_group_inputs(rng, block, taps, n, refs),
                           block, taps))
    got = mc.mc_blocks_grouped(groups)
    assert len(got) == len(groups)
    for (refs, pos, ridx, mv, block, taps), g in zip(groups, got):
        n = pos.shape[0]
        assert g.dtype == torch.int32 and g.shape == (n, block, block)
        assert torch.equal(g, mc.mc_blocks_ref(refs, pos, ridx, mv, block,
                                               taps))
        if n:
            filt = np.asarray(LUMA_FILTER if taps == 8 else CHROMA_FILTER,
                              np.int32)
            fm = 3 if taps == 8 else 7
            m = mv.numpy()
            ff = np.stack([filt[m[:, 0] & fm], filt[m[:, 1] & fm]], 1)
            want = np.asarray(jmc._mc_blocks(
                jnp.asarray(refs.numpy().astype(np.int32)),
                jnp.asarray(pos.numpy()), jnp.asarray(ridx.numpy()),
                jnp.asarray(m), jnp.asarray(ff), block, taps,
                refs.shape[0]))
            assert np.array_equal(g.numpy(), want), (block, taps)
    assert mc.mc_blocks_grouped([]) == []


def test_mc_blocks_grouped_refuses_devices_without_a_kernel():
    refs = torch.zeros((1, 16, 16), dtype=torch.uint8, device="meta")
    z = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        mc.mc_blocks_grouped([(refs, z, z[:, 0], z, 4, 8)])


@pytest.fixture(scope="module")
def pcm_ldp():
    """Golden decode of an LDP stream whose P pictures hold both inter PUs
    and PCM CUs (the committed s96x64_pcm_ldp5)."""
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5, pcm_enabled=True,
              pcm_loop_filter_disabled=True)
    pps = PPS(init_qp=32, sign_data_hiding=True)
    stream, _ = Encoder(sps, pps, qp=32, seed=43).encode_sequence(
        make_moving_sequence(96, 64, 5, seed=43), structure="LDP")
    return GoldenDecoder().decode_stream(stream)


def _writable_stamp_pcm(monkeypatch):
    """The JAX build_inter_pred_device stamps PCM into read-only
    np.asarray views of its device planes, which fails on a picture with
    PUs; give its stamp_pcm writable copies (same samples)."""
    orig = jmc.stamp_pcm

    def stamp(plan, out):
        out[:] = [np.array(p) for p in out]
        orig(plan, out)
    monkeypatch.setattr(jmc, "stamp_pcm", stamp)


@pytest.mark.parametrize("poc", [0, 1, 4])
def test_build_inter_pred_device_matches_jax_with_pcm(pcm_ldp, poc,
                                                      monkeypatch):
    """MC through the grouped path, then the PCM stamp: equal to the JAX
    package's device MC + stamp and to the golden host MC, on the I picture
    (zero planes under the stamp) and on P pictures with PUs and PCM CUs;
    attach_pred_planes attaches the same planes."""
    from p265_tpu_torch.golden.recon import build_inter_pred
    from p265_tpu_torch.plan.frame_plan import (attach_pred_planes,
                                                build_tensor_plan)
    _writable_stamp_pcm(monkeypatch)
    by_poc = {g.poc: g.planes for g in pcm_ldp}
    g = next(g for g in pcm_ldp if g.poc == poc)
    plan = g.plan
    assert any(t.pcm for t in plan.tus) and bool(plan.pus) == (poc > 0)
    refs = {p: by_poc[p] for p in plan.l0_pocs + plan.l1_pocs}
    got = mc.build_inter_pred_device(plan, refs, "cpu")
    want = jmc.build_inter_pred_device(plan, refs)
    host = build_inter_pred(plan, refs)
    tplan = build_tensor_plan(plan, skip_pred=True)
    attach_pred_planes(tplan, refs, "cpu")
    for c in range(3):
        assert got[c].dtype == torch.int32
        assert np.array_equal(got[c].numpy(), want[c]), c
        assert np.array_equal(got[c].numpy(), host[c]), c
        assert torch.equal(tplan.planes[c].inter_pred, got[c]), c


def test_build_inter_pred_device_none_without_pus_or_pcm(ra_wp):
    gold, _ = ra_wp
    intra = next(g for g in gold if not g.plan.pus)
    assert mc.build_inter_pred_device(intra.plan, {}, "cpu") is None
    assert jmc.build_inter_pred_device(intra.plan, {}) is None
