"""The wavefront scan's packed record and its plain version against the
JAX package's device-resident scan, on the CPU.

Each case folds every plane of every picture of a stream into one tall
plane and runs it through `pack_scan` + `scan_packed_ref` (the plain
version of csrc/scan.cu, which `scan_plane` takes on a CPU plane) and
through the JAX `reconstruct_tpu_scan_plane` (whose `_scan_plane` is one
`lax.scan`) on the same tensor plans; tolerance zero.  The streams: the
committed 96x64 LDP, RA and PCM streams, and one intra picture from the
port's encoder whose 32x32 luma TUs take the strong smoothing.  Then a
split run [0, k) + [k, n) against one run, after_step once a step, and the
devices the scan refuses.  The record is the staged wire format
(coordinates uint16 or int32, mode uint8): planes 40000 and 70000 columns
wide (uint16 coordinates past 32767, int32 ones) against the JAX
`_scan_plane`, random scans at both coordinate dtypes against each other.
The kernel itself runs on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import p265_tpu.pipeline.wavefront as jwf
import p265_tpu.plan.frame_plan as jfp
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.plan.frame_plan import build_tensor_plan as jax_tensor_plan
from p265_tpu_torch.hls.params import PPS, SPS
from p265_tpu_torch.kernels.staging import stage
from p265_tpu_torch.pipeline import wavefront as wf
from p265_tpu_torch.testgen.encoder import IntraEncoder
from p265_tpu_torch.testgen.scan_cases import (WIDE_TUS, coord_plane,
                                               random_scan, wide_scan,
                                               work_items)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "p265_tpu_torch", "data")
STREAMS = ["s96x64_ldp5", "s96x64_ra5", "s96x64_pcm_ldp5", "intra32"]


def _intra32() -> bytes:
    """128x64 smooth gradients at QP 30: the luma has 32x32 TUs, some of
    whose edges pass the strong-smoothing flatness test."""
    w, h = 128, 64
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(40 + xx + yy // 2).astype(np.int32),
              (120 + xx[::2, ::2] // 4).astype(np.int32),
              (130 + yy[::2, ::2] // 4).astype(np.int32)]
    return IntraEncoder(SPS(pic_width=w, pic_height=h), PPS(init_qp=30),
                        qp=30, seed=7).encode_frame(planes)[0]


@functools.lru_cache(maxsize=None)
def _plans(name):
    """(every PlanePlan of every picture, in decode order; golden frames)."""
    if name == "intra32":
        data = _intra32()
    else:
        with open(os.path.join(DATA, name + ".265"), "rb") as f:
            data = f.read()
    gold = GoldenDecoder().decode_stream(data)
    pps = []
    for g in gold:
        refs = {f.poc: f.planes for f in gold if f.poc != g.poc}
        pps += jax_tensor_plan(g.plan, refs).planes
    return pps, gold


@functools.lru_cache(maxsize=None)
def _packed(name):
    """The port's scan of the stream's merged plane, up to the scan:
    (packed record, stacked, host starts, n_steps, plane before the scan,
    merged height)."""
    pps, _ = _plans(name)
    merged = wf.merge_segments(pps)
    total_h, pw = merged.shape
    shape = (total_h + wf.GUARD, pw)
    pred = wf.attached_pred(pps, wf.segment_offsets(pps), shape, "cpu")
    itu = stage(wf.hoist_inter(merged), "cpu")
    fields, starts = wf.scan_fields(wf.stack_plane(merged))
    plane = wf.init_plane(itu, pred, shape, "cpu")
    stacked = wf.expand(stage(fields, "cpu"))
    n = merged.n_steps
    return (wf.pack_scan(stacked, starts, n, "cpu"), stacked, starts, n,
            plane, total_h)


def _run(name, ranges):
    packed, _, _, _, plane, _ = _packed(name)
    plane = plane.clone()
    for k0, k1 in ranges:
        wf.scan_packed_ref(packed, plane, k0, k1)
    return plane


@pytest.mark.parametrize("name", STREAMS)
def test_scan_matches_jax(name):
    pps, gold = _plans(name)
    packed, _, _, n, _, total_h = _packed(name)
    got = _run(name, [(0, n)])
    merged, offs = jwf._merge_segments(pps)
    want = np.asarray(jwf.reconstruct_tpu_scan_plane(merged))
    assert want.shape == (total_h, got.shape[1])
    assert np.array_equal(got[:total_h].numpy(), want)
    # and each picture's planes are golden's prefilter planes
    planes = [got[o:o + pp.shape[0], :pp.shape[1]].numpy()
              for pp, o in zip(pps, wf.segment_offsets(pps))]
    assert len(planes) == 3 * len(gold)
    for i, g in enumerate(gold):
        for c in range(3):
            assert np.array_equal(planes[3 * i + c], g.prefilter[c])
    if name == "intra32":   # the strong smoothing really runs
        d = packed.buckets[5]
        assert bool((d["filter_flag"] & d["strong_allowed"]).any())


@pytest.mark.parametrize("name", STREAMS)
def test_split_run_matches_one_run(name):
    n = _packed(name)[3]
    one = _run(name, [(0, n)])
    assert n > 2
    for k in (1, n // 2, n - 1):
        assert torch.equal(_run(name, [(0, k), (k, n)]), one), k


@pytest.mark.parametrize("name", STREAMS)
def test_after_step_once_a_step(name):
    _, stacked, starts, n, plane, _ = _packed(name)
    seen = []
    out = wf.scan_plane(stacked, starts, n, plane.clone(),
                        after_step=lambda p: seen.append(p.clone()))
    assert len(seen) == n
    assert torch.equal(out, _run(name, [(0, n)]))
    for k in (0, n // 2):
        assert torch.equal(seen[k], _run(name, [(0, k + 1)])), k


def test_scan_refuses_other_devices():
    """A meta plane has no scan; the kernel's wrapper takes no CPU plane
    (it launches on the card or raises, and never runs the plain loop)."""
    _, stacked, starts, n, plane, _ = _packed(STREAMS[0])
    with pytest.raises(ValueError, match="meta"):
        wf.scan_plane(stacked, starts, n, plane.to("meta"))
    with pytest.raises(ValueError, match="scan"):
        wf.scan_packed(_packed(STREAMS[0])[0], plane.clone(), 0, n)


@pytest.mark.parametrize("kw", [dict(n_steps=4, per_size=560),
                                dict(n_steps=16, one_a_step=True)],
                         ids=["wide_steps", "one_tu_a_step"])
def test_random_scan_cases(kw):
    """The random scans that the GPU tests and chip_smoke.py hold the scan
    kernel to: steps wider than the kernel's warps, or one TU a step; no
    TU writes a tile that another TU of its step writes or reads, and
    later steps read what earlier steps wrote; a split run of the plain
    version equals one run."""
    stacked, starts, n, plane = random_scan(np.random.default_rng(7),
                                            "cpu", **kw)
    packed = wf.pack_scan(stacked, starts, n, "cpu")
    live = packed.step_tus[packed.step_tus > 0]
    if kw.get("one_a_step"):
        assert live.tolist() == [1] * n
    else:
        assert int(live.min()) > int(np.prod(wf.SCAN_SHAPE))
    step_of, tile_of, refs = [], [], []
    for log2, d in stacked.items():
        step_of.append(np.repeat(np.arange(n), np.diff(starts[log2])))
        pos = d["pos"].numpy().astype(np.int64)
        tile_of.append((pos[:, 0] // 32 - 1) * 32 + pos[:, 1] // 32)
        idx, ok = wf.ref_index(d, 1024).numpy(), d["ref_ok"].numpy()
        y, x = idx // 1024, idx % 1024
        refs.append([set(((y[u] // 32 - 1) * 32 + x[u] // 32)
                         [ok[u] & (y[u] >= 32)].tolist())
                     for u in range(len(idx))])
    step_of, tile_of = np.concatenate(step_of), np.concatenate(tile_of)
    refs = sum(refs, [])
    written, read_back = set(), 0
    for k in range(n):
        mine = tile_of[step_of == k]
        assert len(set(mine.tolist())) == len(mine)
        for u in np.flatnonzero(step_of == k):
            assert not refs[u] & set(mine.tolist())
            read_back += len(refs[u] & written)
        written |= set(mine.tolist())
    assert read_back > 0
    one = wf.scan_packed_ref(packed, plane.clone(), 0, n)
    assert not torch.equal(one, plane)
    split = wf.scan_packed_ref(packed, wf.scan_packed_ref(
        packed, plane.clone(), 0, n // 2), n // 2, n)
    assert torch.equal(split, one)


def test_wide_scan_case():
    """The 4K-wide random scan the GPU tests and chip_smoke.py loop the
    scan kernel with: every step has more work items than the kernel's
    cluster has warps, its TUs sit in distinct tiles of its own tile row,
    every available in-plane reference of a step after the first lies in
    the tile rows that earlier steps wrote; a split run of the plain
    version equals one run."""
    stacked, starts, n, plane = wide_scan(np.random.default_rng(7), "cpu")
    cols = plane.shape[1]
    assert cols == 3840
    items = work_items(starts, n)
    assert items.tolist() == [430] * n
    assert int(items.min()) > int(np.prod(wf.SCAN_SHAPE))
    read_back = 0
    for log2, d in stacked.items():
        step_of = np.repeat(np.arange(n), np.diff(starts[log2]))
        assert np.bincount(step_of, minlength=n).tolist() == (
            [WIDE_TUS[log2]] * n)
        pos = d["pos"].numpy().astype(np.int64)
        assert (pos[:, 0] // 32 == step_of + 1).all()
        idx, ok = wf.ref_index(d, cols).numpy(), d["ref_ok"].numpy()
        inside = ok & (idx >= 0) & (idx < plane.numel())
        band = idx // cols // 32
        for u in range(len(idx)):
            b = band[u][inside[u]]
            if step_of[u]:
                assert ((b >= 1) & (b <= step_of[u])).all()
                read_back += len(b)
            else:
                assert (b == 0).all()
    assert read_back > 0
    tiles = np.concatenate([d["pos"].numpy().astype(np.int64) // 32
                            for d in stacked.values()])
    assert len({tuple(t) for t in tiles}) == len(tiles)
    packed = wf.pack_scan(stacked, starts, n, "cpu")
    one = wf.scan_packed_ref(packed, plane.clone(), 0, n)
    assert not torch.equal(one, plane)
    split = wf.scan_packed_ref(packed, wf.scan_packed_ref(
        packed, plane.clone(), 0, 1), 1, n)
    assert torch.equal(split, one)


@pytest.mark.parametrize("cols", [40_000, 70_000])
def test_wire_coordinates_match_jax(cols):
    """A 64-row plane 40000 columns wide (uint16 coordinates past 32767)
    and one 70000 wide (int32): testgen/scan_cases.py coord_plane, every
    TU alone in its tile, with a prediction plane that, as MC's, holds
    samples under the inter TUs only; the whole scan path on CPU tensors
    (hoist, stage, init_plane, expand at the wire dtypes, pack_scan,
    scan_packed_ref) equals the JAX reconstruct_tpu_scan_plane (inter TUs
    at step 1 of its lax.scan) on the same plan."""
    rng = np.random.default_rng(cols + 1)
    pp = coord_plane(rng, (64, cols), exclusive=True, inter_pred=True)
    merged = wf.merge_segments([pp])
    fields, _ = wf.scan_fields(wf.stack_plane(merged))
    wire = torch.uint16 if cols < 65000 else torch.int32
    staged = wf.expand(stage(fields, "cpu"))
    for d in staged.values():
        assert d["pos"].dtype == d["ref_ys"].dtype == wire
        assert d["mode"].dtype == torch.uint8
    assert max(int(wf.ref_index(d, cols).max() % cols)
               for d in staged.values()) > 32767
    got = wf.reconstruct_scan_plane(pp, "cpu")
    jpp = jfp.PlanePlan(pp.plane_idx, pp.shape, pp.n_steps, {
        log2: jfp.TuBatch(**{f.name: getattr(b, f.name)
                             for f in dataclasses.fields(b)})
        for log2, b in pp.batches.items()}, pp.inter_pred)
    want = np.asarray(jwf.reconstruct_tpu_scan_plane(jpp))
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, pp.inter_pred)


@pytest.mark.parametrize("kw", [{}, dict(n_steps=4, per_size=560)],
                         ids=["random", "wide_steps"])
def test_random_scan_coordinate_dtypes_agree(kw):
    """The same random scan with uint16 and with int32 coordinates (they
    differ only in the unavailable references past the plane, which are
    never read): the plain version gives one plane."""
    out = []
    for coord in (np.uint16, np.int32):
        stacked, starts, n, plane = random_scan(np.random.default_rng(9),
                                                "cpu", coord=coord, **kw)
        assert stacked[2]["ref_xs"].dtype == stage(
            np.zeros(1, coord), "cpu").dtype
        out.append(wf.scan_packed_ref(wf.pack_scan(stacked, starts, n,
                                                   "cpu"), plane, 0, n))
    assert torch.equal(out[0], out[1])
