"""Port's motion compensation vs the JAX reference, bit-exact.

Interpolation (mc_blocks_ref, and the CPU paths of mc_blocks and of the
grouped mc_blocks_grouped) against p265_tpu.kernels.mc._mc_blocks on its
per-element clamped gather, the uni/bi/weighted combination against
_combine, the prediction planes (with pad rows; fresh planes, and the
segments of a tall plane as the batch path lays them out) against
mc_pred_plane, the samples no block covers, and the NumPy copies of the
host packing against the originals on a weighted RA plan.
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


def _gop_inter(structure, seed, **pps_kw):
    """Golden decode of a 96x64 GOP: (frames by poc, inter frames)."""
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5)
    pps = PPS(init_qp=32, sign_data_hiding=True, **pps_kw)
    stream, _ = Encoder(sps, pps, qp=32, seed=seed).encode_sequence(
        make_moving_sequence(96, 64, 5, seed=seed), structure=structure)
    gold = GoldenDecoder().decode_stream(stream)
    return {g.poc: g.planes for g in gold}, [g for g in gold if g.plan.pus]


_JAX_PLANE = jax.jit(jmc.mc_pred_plane,
                     static_argnames=("shape", "taps", "has_bi", "wp_key"))


def _jax_planes(stacks, arrays, shapes, has_bi) -> list:
    """The JAX package's mc_pred_plane of each component (numpy in)."""
    return [np.asarray(_JAX_PLANE(
        jnp.asarray(stacks[c]),
        {b: {f: jnp.asarray(a) for f, a in d.items()}
         for b, d in arrays[grp].items()}, shape=shapes[c], taps=taps,
        has_bi=has_bi, wp_key=f"wp_{c}"))
        for c, grp, taps in ((0, "y", 8), (1, "c", 4), (2, "c", 4))]


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["LDP", "RA", "WP_RA"])
def test_mc_pred_planes_tall_plane_matches_jax(kind):
    """The plain fused path (mc_pred_planes on CPU tensors with a tall
    destination) writes every inter picture of a GOP into its segments of
    one tall plane, laid out as batch_decode does: np.array_equal to the
    JAX package's mc_pred_plane of each component placed at the same rows,
    on uni (LDP), bi (RA) and weighted (WP_RA: weighted uni and bi)
    pictures, with three pad rows a bucket; the rows between segments stay
    as they were."""
    from p265_tpu_torch.pipeline.batch_decode import segment_rows
    from p265_tpu_torch.pipeline.wavefront import GUARD
    seed, kw = {"LDP": (41, {}), "RA": (50, {}),
                "WP_RA": (14, dict(weighted_pred=True,
                                   weighted_bipred=True))}[kind]
    by_poc, inter = _gop_inter(kind.removeprefix("WP_"), seed, **kw)
    H, W = 64, 96
    shapes = ((H, W), (H >> 1, W >> 1), (H >> 1, W >> 1))
    F, seg_h, seg_hc = len(inter), H + GUARD, (H >> 1) + GUARD
    tall = torch.full((F * seg_h + 2 * F * seg_hc, W), 7, dtype=torch.int32)
    want = tall.numpy().copy()
    for f, g in enumerate(inter):
        pidx = _poc_index(g.plan)
        pocs = sorted(pidx)
        arrs = mc.mc_arrays_padded(g.plan, pidx, {
            k: v + 3 for k, v in mc.mc_block_counts(g.plan).items()})
        has_bi = mc.uses_l1(arrs)
        stacks = [np.stack([by_poc[p][c] for p in pocs]).astype(np.uint8)
                  for c in range(3)]
        rows = segment_rows(F, f, seg_h, seg_hc)
        for r, (h, w) in zip(rows, shapes):
            tall[r:r + h, :w] = 0
            want[r:r + h, :w] = 0
        got = mc.mc_pred_planes([torch.from_numpy(s) for s in stacks],
                                _torch_tree(arrs), shapes, has_bi,
                                out=(tall, rows))
        for r, (h, w), p, j in zip(rows, shapes, got,
                                   _jax_planes(stacks, arrs, shapes, has_bi)):
            want[r:r + h, :w] = j
            assert p.data_ptr() == tall[r:r + h, :w].data_ptr()
    assert kind == "LDP" or any(mc.uses_l1(mc.mc_arrays_padded(
        g.plan, _poc_index(g.plan), mc.mc_block_counts(g.plan)))
        for g in inter)
    assert np.array_equal(tall.numpy(), want)


@pytest.mark.parametrize("kind", ["uni", "bi", "weighted_uni",
                                  "weighted_bi"])
def test_mc_pred_planes_random_cases_match_jax(kind):
    """testgen/kernel_cases.py pred_case pictures (every bucket, five pad
    rows each, MVs to 300 px past the picture, explicit weights with
    negative weights and offsets and log2_wd 0..7): the plain fused path
    into fresh planes equals the JAX package's mc_pred_plane; no block
    writes outside its own samples."""
    from p265_tpu_torch.testgen.kernel_cases import pred_case
    rng = np.random.default_rng(len(kind) + 100)
    has_bi, weighted = kind.endswith("bi"), kind.startswith("weighted")
    stacks, arrays, shapes = pred_case(rng, 64, 96, has_bi, weighted)
    got = mc.mc_pred_planes([torch.from_numpy(s) for s in stacks],
                            _torch_tree(arrays), shapes, has_bi)
    for c, (p, j) in enumerate(zip(got, _jax_planes(stacks, arrays, shapes,
                                                    has_bi))):
        assert p.dtype == torch.int32 and p.shape == shapes[c]
        assert np.array_equal(p.numpy(), j), c


def test_mc_uncovered_samples_as_before(ra_wp, monkeypatch):
    """Samples that no MC block covers come out as before MC wrote into
    the tall plane: 0 in fresh planes, and in the batch path the MC
    segments of a frame whose tensor plan carries an attached prediction
    (a path no decoder takes) hold the MC planes alone, as when the old
    path copied its zero-based planes over them: the prediction plane the
    scan starts from, and the whole decode, equal those without the
    attached prediction."""
    from p265_tpu_torch.pipeline import batch_decode as bd
    from p265_tpu_torch.pipeline.wavefront import GUARD
    from p265_tpu_torch.plan.frame_plan import build_tensor_plan
    gold, inter = ra_wp
    by_poc = {g.poc: g.planes for g in gold}
    # the picture with the most intra samples
    g = min(inter, key=lambda g: sum(p.w * p.h for p in g.plan.pus))
    plan = g.plan
    pidx = _poc_index(plan)
    pocs = sorted(pidx)
    arrs = mc.mc_arrays_padded(plan, pidx, mc.mc_block_counts(plan))
    stacks = tuple(torch.from_numpy(np.stack(
        [by_poc[p][c] for p in pocs]).astype(np.uint8)) for c in range(3))
    H, W = plan.sps.pic_height, plan.sps.pic_width
    shapes = ((H, W), (H >> 1, W >> 1), (H >> 1, W >> 1))
    fresh = mc.mc_pred_planes(stacks, _torch_tree(arrs), shapes,
                              mc.uses_l1(arrs))
    for c, p in enumerate(fresh):
        cover = np.zeros(shapes[c], bool)
        for b, d in arrs["y" if c == 0 else "c"].items():
            for y, x in d["pos"]:
                cover[y:y + b, x:x + b] = True
        assert (~cover).any() and (p.numpy()[~cover] == 0).all(), c
    rng = np.random.default_rng(5)
    attached = [rng.integers(1, 256, s).astype(np.int32) for s in shapes]
    runs, preds = [], []
    run_scan = bd.run_scan

    def spy(itu, fields, starts, n_steps, pred, *a, **k):
        preds.append(pred.clone())
        return run_scan(itu, fields, starts, n_steps, pred, *a, **k)

    monkeypatch.setattr(bd, "run_scan", spy)
    for pred in (None, attached):
        tplan = build_tensor_plan(plan, skip_pred=pred is None,
                                  pred_planes=pred)
        assert (tplan.planes[0].inter_pred is None) == (pred is None)
        batch = bd.build_batch([tplan], [plan], mc=[arrs])
        runs.append(bd.decode_batch_planes(batch, [stacks], "cpu"))
    assert torch.equal(preds[0], preds[1])
    seg_h, seg_hc = H + GUARD, (H >> 1) + GUARD
    for r, (h, w), p in zip(bd.segment_rows(1, 0, seg_h, seg_hc), shapes,
                            fresh):
        assert torch.equal(preds[0][r:r + h, :w], p)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert np.array_equal(runs[0][2][0].numpy(), g.planes[0])
