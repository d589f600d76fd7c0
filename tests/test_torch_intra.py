"""Port's intra prediction vs the JAX reference, bit-exact.

a_table against intra_mxu._a_table, filter_refs against intra._filter_refs,
and predict_values (float32 A-table product on CPU tensors) against
predict_values_mxu for all 35 modes, luma and chroma, with dc_edge, inter
substitution from a prediction plane, and the inputs of
tests/test_intra_mxu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p265_tpu.kernels.intra import _filter_refs
from p265_tpu.kernels.intra_mxu import _a_table, predict_values_mxu
from p265_tpu_torch.kernels import intra

PH, PW = 160, 192


def _mk_inputs(rng, s, n, all_ok=False):
    nref2 = 2 * (2 * s + 1)
    pos = np.stack([rng.integers(0, (PH - s) // 4, n) * 4,
                    rng.integers(0, (PW - s) // 4, n) * 4], 1).astype(np.int32)
    ref_ys = rng.integers(0, PH, (n, nref2)).astype(np.int32)
    ref_xs = rng.integers(0, PW, (n, nref2)).astype(np.int32)
    ok = (np.ones((n, nref2), bool) if all_ok
          else rng.integers(0, 2, (n, nref2)).astype(bool))
    residual = rng.integers(-64, 64, (n, s, s)).astype(np.int32)
    return pos, ref_ys, ref_xs, ok, residual


def _compare(plane, args, size, c_idx, **kw):
    want = predict_values_mxu(jnp.asarray(plane),
                              *[jnp.asarray(a) for a in args], size, c_idx,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got = intra.predict_values(torch.from_numpy(plane),
                               *[torch.from_numpy(a) for a in args], size,
                               c_idx,
                               **{k: torch.from_numpy(v)
                                  for k, v in kw.items()})
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_a_table_matches_jax(size):
    a = intra.a_table(size)
    assert a.dtype == np.int16
    assert np.array_equal(a, _a_table(size))


@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_all_modes_match_jax(size, c_idx):
    rng = np.random.default_rng(size * 7 + c_idx)
    plane = rng.integers(0, 256, (PH, PW)).astype(np.int32)
    n = 35
    pos, ys, xs, ok, res = _mk_inputs(rng, size, n)
    mode = np.arange(35, dtype=np.int32)
    ff = np.array([m not in (0, 1, 10, 26) and size != 4 and c_idx == 0
                   for m in mode])
    sa = (np.ones(n, bool) if size == 32 and c_idx == 0
          else np.zeros(n, bool))
    dc_edge = rng.random(n) < 0.7
    _compare(plane, (pos, ys, xs, ok, mode, ff, sa, res), size, c_idx,
             dc_edge=dc_edge)


@pytest.mark.parametrize("size", [8, 32])
def test_random_batches_with_inter_match_jax(size):
    rng = np.random.default_rng(100 + size)
    plane = rng.integers(0, 256, (PH, PW)).astype(np.int32)
    n = 16
    pos, ys, xs, ok, res = _mk_inputs(rng, size, n, all_ok=True)
    mode = rng.integers(0, 35, n).astype(np.int32)
    ff = np.array([m not in (0, 1, 10, 26) for m in mode]) & (size > 4)
    sa = rng.integers(0, 2, n).astype(bool) & (size == 32)
    inter = rng.integers(0, 2, n).astype(bool)
    predp = rng.integers(0, 256, (PH, PW)).astype(np.int32)
    _compare(plane, (pos, ys, xs, ok, mode, ff, sa, res), size, 0,
             inter=inter, pred_plane=predp)


@pytest.mark.parametrize("size", [8, 32])
def test_filter_refs_matches_jax(size):
    rng = np.random.default_rng(size)
    n = 64
    nref = 2 * size + 1
    left = rng.integers(0, 256, (n, nref)).astype(np.int32)
    top = rng.integers(0, 256, (n, nref)).astype(np.int32)
    left[:16] = 100 + np.arange(nref) // 8       # flat: strong smoothing
    top[:16] = 90 + np.arange(nref) // 8
    ff = rng.random(n) < 0.8
    sa = rng.random(n) < 0.8
    want = _filter_refs(jnp.asarray(left), jnp.asarray(top), size,
                        jnp.asarray(ff), jnp.asarray(sa))
    got = intra.filter_refs(torch.from_numpy(left), torch.from_numpy(top),
                            size, torch.from_numpy(ff), torch.from_numpy(sa))
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
