"""Port's dequant + inverse transform vs the JAX reference, bit-exact.

p265_tpu_torch.kernels.itransform.batch_residual and the grouped
batch_residual_grouped (on CPU tensors: their plain torch versions) against
p265_tpu.kernels.itransform.batch_residual and the Pallas kernel in
interpret mode, on the same seeded inputs, with int32 and int16 levels.
Zero tolerance: an HEVC residual has one right answer.
"""
import numpy as np
import pytest
import torch

from p265_tpu.kernels.itransform import batch_residual as jax_residual
from p265_tpu.kernels.pallas_itransform import pallas_batch_residual
from p265_tpu_torch.kernels.itransform import (batch_residual,
                                               batch_residual_grouped,
                                               batch_residual_ref)


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
