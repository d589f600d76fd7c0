"""Port's dequant + inverse transform vs the JAX reference, bit-exact.

p265_tpu_torch.kernels.itransform.batch_residual (on CPU tensors: its plain
torch version) against p265_tpu.kernels.itransform.batch_residual and the
Pallas kernel in interpret mode, on the same seeded inputs.  Zero
tolerance: an HEVC residual has one right answer.
"""
import numpy as np
import pytest
import torch

from p265_tpu.kernels.itransform import batch_residual as jax_residual
from p265_tpu.kernels.pallas_itransform import pallas_batch_residual
from p265_tpu_torch.kernels.itransform import batch_residual


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
