"""Port's batch packing and per-batch device program vs the JAX reference.

build_batch against the JAX _build_batch(policy=None) -- the port keeps
exact shapes, so each JAX array is compared on its real rows and its pad
rows are checked to be padding; every field at the reference's wire dtype,
also on synthetic tall planes whose coordinates pass 32767 -- and all
four outputs of
decode_batch_planes against the JAX decode_batch_planes, for a 2-frame
intra batch, for intra pictures with lossless CUs (bypass masks: SAO's
store restores their samples) and for a fused-MC P picture whose
reference stacks are the golden planes as uint8 (the hoisted inter TUs
through K1's plane epilogue).  Bit-exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p265_tpu.kernels.mc as jmc
import p265_tpu.pipeline.batch_decode as jbd
import p265_tpu.pipeline.wavefront as jwf
import p265_tpu.plan.frame_plan as jfp
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.plan.frame_plan import build_tensor_plan
from p265_tpu.testgen.encoder import (Encoder, IntraEncoder,
                                      make_moving_sequence, make_test_image)
from p265_tpu_torch.kernels import mc
from p265_tpu_torch.pipeline import batch_decode as bd
from p265_tpu_torch.pipeline import wavefront as wf
from p265_tpu_torch.pipeline.wavefront import SCAN_FIELDS
from p265_tpu_torch.testgen.scan_cases import coord_plane


def _intra(seed, w=128, h=64, qp=30, sps_kw=None, pps_kw=None):
    sps = SPS(pic_width=w, pic_height=h, **(sps_kw or {}))
    pps = PPS(init_qp=qp, sign_data_hiding=True, **(pps_kw or {}))
    stream, _, _ = IntraEncoder(sps, pps, qp=qp, seed=seed).encode_frame(
        make_test_image(w, h, seed))
    return GoldenDecoder().decode_stream(stream)[0]


@pytest.fixture(scope="module")
def intra_pair():
    golds = [_intra(s) for s in (0, 1)]
    return golds, [build_tensor_plan(g.plan) for g in golds]


@pytest.fixture(scope="module")
def p_picture():
    """A P picture of a 96x64 LDP stream, its refs and MC block arrays."""
    sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True)
    pps = PPS(init_qp=32, sign_data_hiding=True)
    seq = make_moving_sequence(96, 64, 3, seed=41)
    stream, _ = Encoder(sps, pps, qp=32, seed=41).encode_sequence(seq)
    gold = GoldenDecoder().decode_stream(stream)
    g = next(f for f in gold if f.plan.pus)
    pocs = sorted(set(g.plan.l0_pocs) | set(g.plan.l1_pocs))
    pidx = {p: i for i, p in enumerate(pocs)}
    cnt = mc.mc_block_counts(g.plan)
    by_poc = {f.poc: f.planes for f in gold}
    return dict(g=g, pocs=pocs, by_poc=by_poc,
                tplan=build_tensor_plan(g.plan, skip_pred=True),
                mc_jax=jmc.mc_arrays_padded(g.plan, pidx, cnt),
                mc=mc.mc_arrays_padded(g.plan, pidx, cnt))


def _unpack(bufs, specs):
    out = []
    for bi, off, dt, shape in specs:
        n = int(np.prod(shape, dtype=np.int64))
        raw = np.asarray(bufs[bi])[off:off + n]
        out.append((raw != 0 if np.dtype(dt) == np.bool_ else raw)
                   .reshape(shape))
    return out


def _check_scan_bucket(log2, d, want, ph, steps):
    """One scan bucket: the port's fields equal the JAX ones' real rows,
    at the same dtypes; the JAX pad rows are padding."""
    n = d["pos"].shape[0]
    assert np.all(want["pos"][n:] == (ph, 0))
    assert not want["inter"][:n].any()
    for f in SCAN_FIELDS:
        if f in d or f in want:
            assert np.array_equal(d[f], want[f][:n]), (log2, f)
            assert d[f].dtype == want[f].dtype, (log2, f)
    starts = d["starts"]
    counts = want["counts"]
    assert np.array_equal(np.diff(starts), counts[:steps])
    assert not counts[steps:].any()
    for k in range(steps):
        row = want["idx_map"][k]
        c = counts[k]
        assert np.array_equal(row[:c], np.arange(starts[k], starts[k + 1]))
        assert np.all(row[c:] == n)


def _check_itu_bucket(log2, d, want, ph, wire):
    """One hoisted-inter bucket: real rows equal, the JAX pad rows at (ph,
    0).  The reference hoists its TUs at the tensor plan's dtypes (int32);
    the port's travel at the scan's wire dtypes `wire` ({field: dtype} of
    the reference's _stack_plane)."""
    n = d["pos"].shape[0]
    assert n and np.all(want["pos"][n:] == (ph, 0))
    for f, a in d.items():
        assert np.array_equal(a, want[f][:n]), (log2, f)
        assert a.dtype == wire[f], (log2, f)


def _check_build(tplans, plans, mc_jax=None, mc_port=None):
    bufs, meta = jbd._build_batch(tplans, plans, policy=None, mc=mc_jax)
    m = dict(meta)
    arrays = _unpack(bufs, m["specs"])
    got = bd.build_batch(tplans, plans, mc=mc_port)
    gm = got["meta"]
    for k in ("F", "shape", "seg_h", "seg_hc", "H", "W", "Hc", "Wc",
              "deblock", "sao_luma", "sao_chroma", "ctb", "has_masks"):
        assert gm[k] == m[k], k
    # scan buckets: real rows equal, the JAX pad rows are padding
    assert sorted(got["tu"]) == sorted(log2 for log2, _ in m["tu"])
    wire = {}
    for log2, fields in m["tu"]:
        want = {f: arrays[i] for f, i in fields}
        wire.update((f, a.dtype) for f, a in want.items())
        _check_scan_bucket(log2, got["tu"][log2], want, m["shape"][0],
                           got["n_steps"])
    # hoisted inter TUs
    if m["itu"] is None:
        assert got["itu"] is None
    else:
        assert sorted(got["itu"]) == [log2 for log2, _ in m["itu"]]
        for log2, fields in m["itu"]:
            _check_itu_bucket(log2, got["itu"][log2],
                              {f: arrays[i] for f, i in fields},
                              m["shape"][0], wire)
    # filter grids and masks
    fp = dict(m["fp"])
    assert sorted(got["fp"]) == sorted(fp)
    for k, i in fp.items():
        assert np.array_equal(got["fp"][k], arrays[i]), k
        assert got["fp"][k].dtype == arrays[i].dtype, k
    return got


def test_build_batch_intra_matches_jax(intra_pair):
    golds, tplans = intra_pair
    _check_build(tplans, [g.plan for g in golds])


def test_build_batch_mc_matches_jax(p_picture):
    d = p_picture
    got = _check_build([d["tplan"]], [d["g"].plan], mc_jax=[d["mc_jax"]],
                       mc_port=[d["mc"]])
    assert got["itu"] is not None


@pytest.mark.parametrize("rows", (40_000, 70_000))
def test_build_tall_plane_matches_jax(rows):
    """A synthetic plane whose rows pass 32767 (uint16 coordinates) and
    65000 (int32): merge, hoist and stack against the JAX
    _merge_segments, _hoist_inter and _stack_plane, values and dtypes."""
    pp = coord_plane(np.random.default_rng(rows), (rows, 64))
    jpp = jfp.PlanePlan(pp.plane_idx, pp.shape, pp.n_steps, {
        log2: jfp.TuBatch(**{f.name: getattr(b, f.name)
                             for f in dataclasses.fields(b)})
        for log2, b in pp.batches.items()})
    jmerged, _ = jwf._merge_segments([jpp], policy=None, host_pred=False)
    jitu = jbd._hoist_inter(jmerged, None)
    _, jtu = jwf._stack_plane(jmerged, policy=None)
    merged = wf.merge_segments([pp])
    itu = wf.hoist_inter(merged)
    tu = wf.stack_plane(merged)
    assert merged.shape == jmerged.shape
    ph = merged.shape[0]
    wire = {f: a.dtype for d in jtu.values() for f, a in d.items()}
    assert wire["pos"] == (np.uint16 if rows < 65000 else np.int32)
    assert sorted(tu) == sorted(jtu) and sorted(itu) == sorted(jitu)
    for log2, d in tu.items():
        assert int(d["pos"][:, 0].max()) > 32767
        _check_scan_bucket(log2, d, jtu[log2], ph, merged.n_steps)
    for log2, d in itu.items():
        _check_itu_bucket(log2, d, jitu[log2], ph, wire)


def _compare_outputs(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_decode_batch_planes_intra_pair_matches_jax(intra_pair):
    golds, tplans = intra_pair
    plans = [g.plan for g in golds]
    want = jbd.decode_batch_planes(tplans, plans)
    got = bd.decode_batch_planes(bd.build_batch(tplans, plans), None, "cpu")
    _compare_outputs(got, want)
    F = len(golds)
    for f, g in enumerate(golds):   # chroma: F cb planes, then F cr
        for i, (y, cb, cr) in enumerate(((got[0][f], got[1][f],
                                          got[1][F + f]),
                                         (got[2][f], got[3][f],
                                          got[3][F + f]))):
            ref = g.prefilter if i == 0 else g.planes
            for c, p in enumerate((y, cb, cr)):
                assert np.array_equal(p.numpy(), ref[c]), (f, i, c)


def test_decode_batch_planes_fused_mc_matches_jax(p_picture):
    d = p_picture
    plan, pocs, by_poc = d["g"].plan, d["pocs"], d["by_poc"]
    refs_jax = tuple(tuple(jnp.asarray(by_poc[p][c].astype(np.uint8))
                           for p in pocs) for c in range(3))
    want = jbd.decode_batch_planes([d["tplan"]], [plan], mc=[d["mc_jax"]],
                                   refs=(refs_jax,))
    stacks = tuple(torch.from_numpy(np.stack(
        [by_poc[p][c] for p in pocs]).astype(np.uint8)) for c in range(3))
    batch = bd.build_batch([d["tplan"]], [plan], mc=[d["mc"]])
    got = bd.decode_batch_planes(batch, [stacks], "cpu")
    _compare_outputs(got, want)
    g = d["g"]
    assert np.array_equal(got[2][0].numpy(), g.planes[0])
    assert np.array_equal(got[3][0].numpy(), g.planes[1])
    assert np.array_equal(got[3][1].numpy(), g.planes[2])


@pytest.mark.parametrize("kw", [
    dict(pps_kw=dict(transquant_bypass_enabled=True)),
    dict(sps_kw=dict(pcm_enabled=True, pcm_loop_filter_disabled=True))],
    ids=["bypass", "pcm"])
def test_decode_batch_planes_lossless_matches_jax(kw):
    """Two intra pictures with lossless CUs in one batch (bypass masks in
    the batch's filter arrays): all four uint8 outputs equal the JAX
    decode_batch_planes' and golden's."""
    golds = [_intra(s, w=96, h=64, **kw) for s in (3, 4)]
    tplans = [build_tensor_plan(g.plan) for g in golds]
    plans = [g.plan for g in golds]
    batch = bd.build_batch(tplans, plans)
    assert batch["meta"]["has_masks"]
    want = jbd.decode_batch_planes(tplans, plans)
    got = bd.decode_batch_planes(batch, None, "cpu")
    _compare_outputs(got, want)
    F = len(golds)
    for f, g in enumerate(golds):
        for c, p in enumerate((got[2][f], got[3][f], got[3][F + f])):
            assert np.array_equal(p.numpy(), g.planes[c]), (f, c)
