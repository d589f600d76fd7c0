"""Port's dequant + inverse transform vs the JAX reference, bit-exact.

p265_tpu_torch.kernels.itransform.batch_residual and the grouped
batch_residual_grouped (on CPU tensors: their plain torch versions) against
p265_tpu.kernels.itransform.batch_residual and the Pallas kernel in
interpret mode, on the same seeded inputs, with int32 and int16 levels and
with the wire dtypes (uint8 qp and scale_m).  Then the plane epilogue of
the hoisted inter TUs (init_plane_ref, init_plane and
batch_residual_grouped(plane=...) on CPU tensors) against the reference's
batch_residual_auto, flat scatter and clip
(p265_tpu/pipeline/batch_decode.py:397-431) on the inter pictures of the
96x64 LDP, RA and WP_RA streams and on testgen/kernel_cases.py
residual_groups placed in planes up to 70000 columns wide.
Zero tolerance: an HEVC residual has one right answer.
"""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.kernels.itransform import batch_residual as jax_residual
from p265_tpu.kernels.itransform import batch_residual_auto
from p265_tpu.kernels.pallas_itransform import pallas_batch_residual
from p265_tpu.plan.frame_plan import build_tensor_plan as jax_tensor_plan
from p265_tpu.testgen.encoder import Encoder, make_moving_sequence
from p265_tpu_torch.kernels import itransform
from p265_tpu_torch.kernels.itransform import (batch_residual,
                                               batch_residual_grouped,
                                               batch_residual_ref)
from p265_tpu_torch.kernels.staging import stage
from p265_tpu_torch.pipeline import wavefront as wf
from p265_tpu_torch.testgen import kernel_cases as kc

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "p265_tpu_torch", "data")


def _inputs(log2, seed, scale=False, every_qp=True):
    """The inputs of tests/test_pallas_kernels.py (n=150 pads past the
    Pallas block; levels at +-2^15), with every qp 0..51 present unless
    every_qp is False, plus (scale) scaling matrices with 255-valued
    entries that reach the +-2^27 clamp of the left shift."""
    rng = np.random.default_rng(seed)
    s = 1 << log2
    n = 150
    lv = ((rng.random((n, s, s)) < 0.2)
          * rng.integers(-200, 200, (n, s, s))).astype(np.int32)
    lv[:5] = rng.integers(-32768, 32768, (5, s, s))
    qp = rng.integers(0, 52, n).astype(np.int32)
    if every_qp:
        qp[:52] = np.arange(52)
    dst = (rng.random(n) < 0.4) if log2 == 2 else np.zeros(n, bool)
    tsk = ((rng.random(n) < 0.3) & ~dst) if log2 == 2 else np.zeros(n, bool)
    byp = rng.random(n) < 0.15
    sm = None
    if scale:
        sm = rng.integers(1, 256, (n, s, s)).astype(np.int32)
        sm[:10] = 255
        lv[5:10] = 32767
    return lv, qp, dst, tsk, byp, sm


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_batch_residual_matches_jax(log2, scale):
    lv, qp, dst, tsk, byp, sm = _inputs(log2, log2, scale)
    want = np.asarray(jax_residual(lv, qp, dst, tsk, log2, True, bypass=byp,
                                   scale_m=sm))
    tl, tq, td, tt, tb, ts = _torch(lv, qp, dst, tsk, byp, sm)
    got = batch_residual(tl, tq, td, tt, log2, bypass=tb, scale_m=ts)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("log2", [3, 4, 5])
def test_batch_residual_matches_pallas_interpret(log2):
    lv, qp, dst, tsk, byp, _ = _inputs(log2, log2, every_qp=False)
    want = np.asarray(pallas_batch_residual(lv, qp, dst, tsk, byp, log2,
                                            interpret=True))
    tl, tq, td, tt, tb = _torch(lv, qp, dst, tsk, byp)
    got = batch_residual(tl, tq, td, tt, log2, bypass=tb)
    assert np.array_equal(got.numpy(), want)


def test_batch_residual_refuses_devices_without_a_kernel():
    n, s = 4, 8
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        batch_residual(torch.zeros((n, s, s), dtype=torch.int32, **meta),
                       torch.zeros(n, dtype=torch.int32, **meta),
                       torch.zeros(n, dtype=torch.bool, **meta),
                       torch.zeros(n, dtype=torch.bool, **meta), 3)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_int16_levels_equal_int32(log2):
    """The host packs levels as int16; the plain version widens them."""
    lv, qp, dst, tsk, byp, sm = _inputs(log2, 20 + log2, scale=True)
    lv = np.clip(lv, -32768, 32767)
    tq, td, tt, tb, ts = _torch(qp, dst, tsk, byp, sm)
    want = np.asarray(jax_residual(lv, qp, dst, tsk, log2, True, bypass=byp,
                                   scale_m=sm))
    for dt in (np.int16, np.int32):
        got = batch_residual(torch.from_numpy(lv.astype(dt)), tq, td, tt,
                             log2, bypass=tb, scale_m=ts)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), dt


def test_batch_residual_grouped_equals_per_call_plain():
    """All four sizes in one call, as the call sites pack them: int16 and
    int32 levels, is_dst given or absent, with and without bypass and
    scale_m, and an empty size.  Equal to one batch_residual_ref call per
    size, and to JAX."""
    groups, want = {}, {}
    for log2, dt, with_dst, with_byp, scale in (
            (2, np.int16, True, True, True), (3, np.int32, False, True, False),
            (4, np.int16, False, False, True), (5, np.int16, True, True,
                                                False)):
        lv, qp, dst, tsk, byp, sm = _inputs(log2, 30 + log2, scale)
        lv = np.clip(lv, -32768, 32767)
        f = dict(coeffs=torch.from_numpy(lv.astype(dt)),
                 qp=torch.from_numpy(qp), tskip=torch.from_numpy(tsk),
                 pos=torch.zeros((len(qp), 2), dtype=torch.int64))
        if with_dst:
            f["is_dst"] = torch.from_numpy(dst)
        if with_byp:
            f["bypass"] = torch.from_numpy(byp)
        if sm is not None:
            f["scale_m"] = torch.from_numpy(sm)
        groups[log2] = f
        want[log2] = np.asarray(jax_residual(
            lv, qp, dst if with_dst else np.zeros_like(dst), tsk, log2, True,
            bypass=byp if with_byp else None, scale_m=sm))
    got = batch_residual_grouped(groups)
    assert list(got) == list(groups)
    for log2, f in groups.items():
        ref = batch_residual_ref(f["coeffs"], f["qp"], f.get("is_dst"),
                                 f["tskip"], log2, bypass=f.get("bypass"),
                                 scale_m=f.get("scale_m"))
        assert torch.equal(got[log2], ref), log2
        assert np.array_equal(got[log2].numpy(), want[log2]), log2
    empty = dict(coeffs=torch.zeros((0, 8, 8), dtype=torch.int16),
                 qp=torch.zeros(0, dtype=torch.int32),
                 tskip=torch.zeros(0, dtype=torch.bool))
    out = batch_residual_grouped({3: empty})
    assert out[3].shape == (0, 8, 8) and out[3].dtype == torch.int32
    assert batch_residual_grouped({}) == {}


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_wire_dtypes_equal_int32(log2):
    """uint8 qp and scale_m (the wire dtypes the kernel reads) give the
    residuals of int32 ones, and JAX's."""
    lv, qp, dst, tsk, byp, sm = _inputs(log2, 40 + log2, scale=True)
    lv = np.clip(lv, -32768, 32767).astype(np.int16)
    want = np.asarray(jax_residual(lv.astype(np.int32), qp, dst, tsk, log2,
                                   True, bypass=byp, scale_m=sm))
    td, tt, tb = _torch(dst, tsk, byp)
    for q, m in ((qp, sm), (qp.astype(np.uint8), sm.astype(np.uint8))):
        got = batch_residual(torch.from_numpy(lv), torch.from_numpy(q), td,
                             tt, log2, bypass=tb, scale_m=torch.from_numpy(m))
        assert np.array_equal(got.numpy(), want), q.dtype


def _jax_hoisted(itu: dict, pred: np.ndarray) -> np.ndarray:
    """The reference's hoisted inter TUs on a prediction plane
    (p265_tpu/pipeline/batch_decode.py:397-431): batch_residual_auto per
    size on the fields widened to int32, one flat scatter of the
    residuals into a zero plane, then clip(pred + residuals)."""
    rows, pw = pred.shape
    flat_idx, flat_val = [], []
    for log2, d in itu.items():
        n = d["qp"].shape[0]
        sm = d.get("scale_m")
        res = batch_residual_auto(
            jnp.asarray(d["coeffs"]).astype(jnp.int32),
            jnp.asarray(d["qp"]).astype(jnp.int32),
            jnp.asarray(d.get("is_dst", np.zeros(n, bool))),
            jnp.asarray(d["tskip"]), log2, True,
            bypass=jnp.asarray(d["bypass"]),
            scale_m=None if sm is None else jnp.asarray(sm).astype(
                jnp.int32))
        s = 1 << log2
        p = jnp.asarray(d["pos"].astype(np.int32))
        r = p[:, 0][:, None, None] + jnp.arange(s)[None, :, None]
        c = p[:, 1][:, None, None] + jnp.arange(s)[None, None, :]
        flat_idx.append((r * pw + c).reshape(-1))
        flat_val.append(res.reshape(-1))
    res_plane = jnp.zeros(rows * pw, jnp.int32).at[
        jnp.concatenate(flat_idx)].set(jnp.concatenate(flat_val),
                                        mode="drop")
    return np.asarray(jnp.clip(jnp.asarray(pred) + res_plane.reshape(
        rows, pw), 0, 255))


@functools.lru_cache(maxsize=None)
def _gop(name):
    """Golden decode of a 96x64 GOP: the committed LDP and RA streams, and
    a weighted-prediction RA stream with bi-predicted PUs."""
    if name == "WP_RA":
        sps = SPS(pic_width=96, pic_height=64, temporal_mvp_enabled=True,
                  num_reorder_pics=2, max_dec_pic_buffering=5)
        pps = PPS(init_qp=32, sign_data_hiding=True, weighted_pred=True,
                  weighted_bipred=True)
        data = Encoder(sps, pps, qp=32, seed=40).encode_sequence(
            make_moving_sequence(96, 64, 5, seed=40), structure="RA")[0]
    else:
        with open(os.path.join(DATA, name + ".265"), "rb") as f:
            data = f.read()
    return GoldenDecoder().decode_stream(data)


@pytest.mark.parametrize("name", ["s96x64_ldp5", "s96x64_ra5", "WP_RA"])
def test_hoisted_plane_epilogue_matches_jax(name):
    """Every inter picture of the stream: its three planes merged, the
    inter TUs hoisted at their wire dtypes and staged; init_plane_ref,
    init_plane (its CPU route) and the plain K1 plane epilogue over the
    prediction plane equal the reference's scatter and clip, and the
    epilogue leaves every sample outside the inter TUs as the prediction
    held it."""
    gold = _gop(name)
    seen = 0
    for g in gold:
        refs = {f.poc: f.planes for f in gold if f.poc != g.poc}
        pps = jax_tensor_plan(g.plan, refs).planes
        merged = wf.merge_segments(pps)
        shape = (merged.shape[0] + wf.GUARD, merged.shape[1])
        pred = wf.attached_pred(pps, wf.segment_offsets(pps), shape, "cpu")
        itu = wf.hoist_inter(merged)
        if itu is None:
            continue
        seen += 1
        assert {d["qp"].dtype for d in itu.values()} == {np.dtype(np.uint8)}
        want = _jax_hoisted(itu, pred.numpy())
        dev = stage(itu, "cpu")
        got = wf.init_plane_ref(dev, pred.clone(), shape, "cpu")
        assert np.array_equal(got.numpy(), want), g.poc
        assert torch.equal(wf.init_plane(dev, pred.clone(), shape, "cpu"),
                           got)
        epi = batch_residual_grouped(dev, plane=pred.clone())
        assert torch.equal(epi, got), g.poc
        assert not torch.equal(epi, pred)
    assert seen >= 2


@pytest.mark.parametrize("shape", [(256, 1920), (128, 40_000),
                                   (128, 70_000)])
@pytest.mark.parametrize("scale", [False, True])
def test_plane_epilogue_residual_groups_match_jax(shape, scale):
    """kernel_cases.residual_groups at the wire dtypes, every TU alone in a
    32x32 tile of a random prediction plane (positions uint16 past 32767
    at 40000 columns, int32 at 70000): the plain epilogue equals the
    reference's scatter and clip, and the residuals it adds are
    batch_residual_grouped's."""
    rng = np.random.default_rng(shape[1] + scale)
    groups = kc.residual_groups(rng, 100, scale, plane=shape)
    wire = np.uint16 if shape[1] < 65000 else np.int32
    assert all(f["pos"].dtype == wire for f in groups.values())
    if shape[1] > 32768:
        assert max(int(f["pos"][:, 1].max()) for f in groups.values()) > 32767
    pred = rng.integers(0, 256, shape).astype(np.int32)
    want = _jax_hoisted(groups, pred)
    dev = stage(groups, "cpu")
    got = batch_residual_grouped(dev, plane=torch.from_numpy(pred.copy()))
    assert np.array_equal(got.numpy(), want)
    res = batch_residual_grouped(dev)
    log2, f = 3, dev[3]
    y, x = (int(v) for v in f["pos"][0].to(torch.int64))
    assert torch.equal(got[y:y + 8, x:x + 8], (torch.from_numpy(
        pred[y:y + 8, x:x + 8]) + res[log2][0]).clamp(0, 255))


def test_kernel_wrapper_checks_wire_dtypes():
    """The CPU route takes any integer width; the kernel's own checks
    (run here on meta tensors, which reach no kernel) name the wire
    dtypes: qp and scale_m uint8, positions uint16 or int32, the plane
    contiguous int32."""
    dev = torch.device("meta")
    n, s = 4, 8
    f = dict(coeffs=torch.zeros((n, s, s), dtype=torch.int16, device=dev),
             qp=torch.zeros(n, dtype=torch.int32, device=dev),
             tskip=torch.zeros(n, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="qp must be .*uint8"):
        itransform._grouped_kernel({3: f}, dev)
    f["qp"] = torch.zeros(n, dtype=torch.uint8, device=dev)
    f["scale_m"] = torch.zeros((n, s, s), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="scale_m must be .*uint8"):
        itransform._grouped_kernel({3: f}, dev)
    del f["scale_m"]
    f["pos"] = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    plane = torch.zeros((64, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="pos must be"):
        itransform._grouped_kernel({3: f}, dev, plane)
    with pytest.raises(ValueError, match="plane must be contiguous int32"):
        itransform._grouped_kernel({3: f}, dev, plane.to(torch.int64))
