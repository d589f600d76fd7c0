"""The deblocking edge parameters in C (native/deblock.c, one call a picture)
against the NumPy derivation they replace on the main path, on the CPU.

`luma_edge_params` and `chroma_edge_params` (kernels/loopfilter.py) are the
plain reference, and through them the JAX package's: every grid of both
directions (bS, beta, tc, the chroma tc of cb and cr) must be equal, on
every picture of the committed 96x64 streams (I, LDP P, RA B with
bi-prediction, the CTC random access with TMVP and AMP, PCM, QP 40), on
pictures whose slice header and PPS set the beta, tc and chroma QP offsets
(to the ends of their ranges, so the clips are reached), and on random maps
at widths and heights with no inner edge.  Then `pack_filter_params` as
the batch pack calls it: the same keys, dtypes, shapes and values with the
C derivation and with the NumPy one (the native library unavailable), for
batches of one, the frame-DAG batches and a batch of four B pictures, and
the decoders' counter `edge_params_c_pictures` and span `edge_params`.
"""
import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest

import p265_tpu.kernels.loopfilter as jlf
from p265_tpu_torch import native
from p265_tpu_torch.golden.decoder import GoldenDecoder
from p265_tpu_torch.kernels import loopfilter as lf
from p265_tpu_torch.native import deblock
from p265_tpu_torch.native.parse import native_parse_available
from p265_tpu_torch.pipeline import decoder as dm
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.testgen.streams import get_stream

needs_c = pytest.mark.skipif(not native_parse_available(),
                             reason="no C compiler for the native library")

STREAMS = ("s96x64_ldp5", "s96x64_ra5", "s96x64_ractc17",
           "s96x64_pcm_ldp5", "s96x64_ractc17q40")


@functools.lru_cache(maxsize=None)
def _plans(name):
    return [f.plan for f in GoldenDecoder(use_native_parse=True)
            .decode_stream(get_stream(name))]


def _c_grids(plan) -> list:
    """One picture's grids from the C call: per direction [bS, beta, tc,
    tc_cb, tc_cr]."""
    out = []
    for luma, chroma in deblock.grid_shapes(plan.sps.pic_width,
                                            plan.sps.pic_height).values():
        out.append([np.full(luma, -1, np.int16) for _ in range(3)]
                   + [np.full(chroma, -1, np.int16) for _ in range(2)])
    deblock.edge_params(plan, out)
    return out


def _assert_equal_to_numpy_and_jax(plan, jax=True):
    got = _c_grids(plan)
    for i, vertical in enumerate((True, False)):
        refs = [(lf.luma_edge_params(plan, vertical),
                 lf.chroma_edge_params(plan, vertical))]
        if jax:
            refs.append((jlf.luma_edge_params(plan, vertical),
                         jlf.chroma_edge_params(plan, vertical)))
        for luma, chroma in refs:
            for g, want in zip(got[i], [*luma, *chroma]):
                want = np.asarray(want)
                assert g.dtype == np.int16 and want.dtype == np.int32
                assert g.shape == want.shape, (vertical, g.shape, want.shape)
                assert np.array_equal(g, want), vertical
    return got


@needs_c
@pytest.mark.parametrize("name", STREAMS)
def test_every_picture_of_the_streams(name):
    plans = _plans(name)
    kinds = {p.sh.slice_type for p in plans}
    assert 2 in kinds and len(kinds) > 1      # an I picture and P or B ones
    filtered = 0
    for p in plans:
        got = _assert_equal_to_numpy_and_jax(p)
        filtered += int(np.count_nonzero(got[0][0]))
    assert filtered > 0
    if name in ("s96x64_ra5", "s96x64_ractc17"):
        # bi-predicted units on both sides of some edge: the second compare
        assert any(((p.ref_map != lf.NO_REF).sum(-1) == 2).any()
                   for p in plans if p.ref_map is not None)


@needs_c
@pytest.mark.parametrize("offsets", [(6, 6, 12, -12), (-6, -6, -12, 12),
                                     (3, -2, 5, 7)],
                         ids=["high", "low", "mixed"])
def test_slice_and_pps_offsets(offsets):
    """beta_offset_div2, tc_offset_div2, cb_qp_offset, cr_qp_offset set on
    every picture of the CTC random access (a copy of each plan)."""
    beta, tc, cb, cr = offsets
    for p in _plans("s96x64_ractc17"):
        q = copy.copy(p)
        q.sh, q.pps = copy.copy(p.sh), copy.copy(p.pps)
        q.sh.beta_offset_div2, q.sh.tc_offset_div2 = beta, tc
        q.pps.cb_qp_offset, q.pps.cr_qp_offset = cb, cr
        _assert_equal_to_numpy_and_jax(q)


def _random_plan(rng, w, h, inter=True):
    """A plan of random maps: intra and coded units, QPs 0..51, both edge
    bits, and (inter) MVs within a few quarter samples of each other over
    references that repeat and go unused (NO_REF)."""
    h4, w4 = (h + 3) >> 2, (w + 3) >> 2
    pocs = np.array([lf.NO_REF, 0, 4, 8, -3], np.int32)
    plan = SimpleNamespace(
        sps=SimpleNamespace(pic_width=w, pic_height=h),
        sh=SimpleNamespace(beta_offset_div2=int(rng.integers(-6, 7)),
                           tc_offset_div2=int(rng.integers(-6, 7))),
        pps=SimpleNamespace(cb_qp_offset=int(rng.integers(-12, 13)),
                            cr_qp_offset=int(rng.integers(-12, 13))),
        intra_map=(rng.random((h4, w4)) < 0.1).astype(np.int32),
        cbf_map=(rng.random((h4, w4)) < 0.2).astype(np.int32),
        qp_map=rng.integers(0, 52, (h4, w4)).astype(np.int32),
        edge_flags=rng.integers(0, 4, (h4, w4)).astype(np.int32),
        mv_map=None, ref_map=None)
    if inter:
        plan.mv_map = rng.integers(-6, 7, (h4, w4, 2, 2)).astype(np.int32)
        plan.ref_map = pocs[rng.integers(0, len(pocs), (h4, w4, 2))]
    return plan


@needs_c
@pytest.mark.parametrize("w,h", [(8, 64), (16, 64), (64, 8), (64, 16),
                                 (8, 8), (24, 40), (136, 72)])
def test_random_maps_and_sizes_without_inner_edges(w, h):
    """A width (or height) of at most 8 has no luma edge, of at most 16 no
    chroma edge: the grids are [n_seg, 0], as the NumPy code returns."""
    rng = np.random.default_rng(w * 1000 + h)
    for trial in range(20):
        got = _assert_equal_to_numpy_and_jax(
            _random_plan(rng, w, h, inter=trial % 4 != 0), jax=trial < 2)
    if w <= 16:
        assert got[0][3].shape[1] == 0
    if w <= 8:
        assert got[0][0].shape[1] == 0


# ---------------------------------------------------------------------------
# pack_filter_params and the decoders
# ---------------------------------------------------------------------------


def _batches(name, frame_dag_max, monkeypatch, **kw):
    """Decode `name` with TorchDecoder("cpu") and record each build_batch
    call: (its plans, the counter before, the counter after)."""
    seen = []
    real = dm.build_batch

    def spy(tplans, plans, mc=None, stats=None, filters=True):
        before = stats["edge_params_c_pictures"]
        out = real(tplans, plans, mc=mc, stats=stats, filters=filters)
        seen.append((plans, before, stats["edge_params_c_pictures"]))
        return out
    monkeypatch.setattr(dm, "build_batch", spy)
    dec = TorchDecoder("cpu", frame_dag_max=frame_dag_max, **kw)
    frames = dec.decode_stream(get_stream(name))
    return dec, frames, seen


def _same_fp(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@needs_c
@pytest.mark.parametrize("frame_dag_max", [1, 4])
def test_pack_filter_params_c_and_numpy_agree(frame_dag_max, monkeypatch):
    """The batches the decoder packed (one picture each, or the CTC's odd B
    pictures up to three at a time), and four B pictures in one batch:
    the same arrays with the C derivation as with native.available()
    False; edge_params_c_pictures grows by F a batch."""
    dec, frames, seen = _batches("s96x64_ractc17", frame_dag_max,
                                 monkeypatch)
    sizes = [len(plans) for plans, _, _ in seen]
    assert (max(sizes) > 1) == (frame_dag_max == 4), sizes
    for plans, before, after in seen:
        assert after - before == len(plans)
    four = [f.plan for f in frames if f.plan.pus][:4]
    seen.append((four, None, None))
    c_fps = [lf.pack_filter_params(plans) for plans, _, _ in seen]
    monkeypatch.setattr(native, "available", lambda: False)
    for (plans, _, _), c_fp in zip(seen, c_fps):
        st = {}
        fp = lf.pack_filter_params(plans, stats=st)
        _same_fp(c_fp, fp)
        assert "edge_params_c_pictures" not in st
        assert st["edge_params_s"] > 0
        for k in ("bs_v", "beta_v", "tc_v", "bs_h", "beta_h", "tc_h"):
            assert fp[k].dtype == np.int16 and len(fp[k]) == len(plans)
        assert fp["tcc_v"].dtype == np.int16
        assert len(fp["tcc_v"]) == 2 * len(plans)
    assert dec.stats["edge_params_c_pictures"] == len(frames) == 17


@needs_c
def test_numpy_path_when_the_library_is_unavailable(monkeypatch):
    """With no native library the decoder packs by the NumPy derivation:
    the same planes, and no picture counted."""
    want = [f.planes for f in TorchDecoder("cpu").decode_stream(
        get_stream("s96x64_ra5"))]
    monkeypatch.setattr(native, "available", lambda: False)
    dec = TorchDecoder("cpu")
    got = dec.decode_stream(get_stream("s96x64_ra5"))
    assert dec.stats["edge_params_c_pictures"] == 0
    assert dec.stats["edge_params_s"] > 0
    for g, w in zip(got, want):
        for c in range(3):
            assert np.array_equal(g.planes[c], w[c])


@needs_c
def test_no_deblocking_packed_with_filters_off(monkeypatch):
    dec, frames, seen = _batches("s96x64_ldp5", 1, monkeypatch,
                                 apply_filters=False)
    assert len(frames) == 5 and len(seen) == 5
    assert dec.stats["edge_params_c_pictures"] == 0
    assert dec.stats["edge_params_s"] == 0.0


@needs_c
@pytest.mark.parametrize("cls", [TorchDecoder, PipelinedTorchDecoder])
def test_edge_params_span_inside_pack(cls):
    """The decoders time the derivation inside the batch pack, and count
    every picture they deblocked (an I picture too)."""
    dec = cls("cpu")
    assert dec.stats["edge_params_c_pictures"] == 0
    assert dec.stats["edge_params_s"] == dec.stats["edge_params_cpu_s"] == 0
    frames = dec.decode_stream(get_stream("s96x64_ldp5"))
    st = dec.stats
    assert st["edge_params_c_pictures"] == len(frames) == 5
    assert 0 < st["edge_params_cpu_s"] <= st["edge_params_s"] <= st["pack_s"]


def test_the_library_is_built_from_deblock_c():
    """The native library's sources chain ends in deblock.c (which includes
    replay.c); where it loads, it exports the derivation."""
    import inspect
    import os
    srcs = inspect.signature(native._build).parameters["srcs"].default
    assert [os.path.basename(p) for p in srcs] == [
        "cabac.c", "ctu.c", "replay.c", "deblock.c"]
    if native.available():
        assert hasattr(native._load(), "deblock_params")


@needs_c
def test_a_grid_of_another_shape_is_refused():
    plan = _plans("s96x64_ldp5")[1]
    out = _c_grids(plan)
    out[1][2] = np.zeros((1, 1), np.int16)
    with pytest.raises(ValueError):
        deblock.edge_params(plan, out)
    out = _c_grids(plan)
    out[0][0] = out[0][0].astype(np.int32)
    with pytest.raises(ValueError):
        deblock.edge_params(plan, out)
    other = copy.copy(plan)                 # a batch of two sizes
    other.sps = copy.copy(plan.sps)
    other.sps.pic_width -= 8
    with pytest.raises(ValueError):
        lf.pack_filter_params([plan, other])
